// Band block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v4
// (launched by _call_kernel_v4): C = alpha * A @ B for banded operands,
// whose B rows are arithmetically contiguous (col(t) = base + t), with
// the output in offset form: output slot t of row r holds block-column
// occ0[r] + t, and the product of A slot s lands at offset gg0[r, s].
// Slots t < span = min(k_out, KA + KB - 1) are computed; slots t >= span
// are written as zero blocks with zero norm.  Prune epilogue: alpha, the
// threshold flush, per-slot L1 norm.  Addressing is arithmetic: for each
// valid A slot s the B row is acols[r, s] and the B slot t - gg0[r, s],
// and the product counts when that slot lies in [0, KB) and is not EMPTY.
//
// Tiers, as _kernel_v4 computes them:
//   'high' on float32: the TPU's hand-made bf16x3 split (:557-580),
//       alpha (A_hi B_hi + A_lo B_hi + A_hi B_lo), on the tensor cores
//       (tc.cuh): the split pass below writes the planes once per operand
//       storage (X @ X splits X once), then wgmma fed by TMA.
//   'bf16' and 'default' on float32: A_hi B_hi, the same product without
//       lo planes ('default' is the TPU's one bf16 pass).
//   'highest' (and every tier of float64, which the reference keeps
//       exact): exact FMA products on the three-stage cp.async ring of
//       tile.cuh (pipelined_outputs), products in turn, k ascending, one
//       fma per k, as the general, stream and window kernels add them.
//
// What bounds it on the H100 at the 2^20-row flagship X @ X (8192 rows, KA
// = KB = 5, full span 9, bs 128; 859 GFLOP, X 2.68 GB in float32, C 4.83
// GB): 'highest' the FP32 pipes, 12.8 ms at 67 TFLOP/s; 'high' its three
// bf16 products, 2.61 ms at 989 TFLOP/s, over the 2.24 ms its bytes take
// at 3.35 TB/s (the split pass adds 5.4 GB of its own, ~1.6 ms); 'bf16'
// the bytes, 2.24 ms.
//
// `run` (every entry): a device int, or null.  When it holds 0, every
// block returns before any load and out and norms keep what they held:
// inside a chunked solve (solvers/common.py) the band and general
// kernels both launch on one output, and the predicate, computed on the
// device, picks the one that writes it, with no host read.
//
// Design: output-stationary, no atomics, grid order slot-fastest (tile =
// r * k_out + t) so that the blocks sharing A[r, .] run together and A
// comes from L2, not once per slot from HBM.  'highest': one thread block
// per tile.  The tensor cores: a persistent grid, warp-specialised
// (tc.cuh).  The TPU kernel's window DMAs and VMEM panels have no
// counterpart: neighbouring rows read overlapping B rows, which the 50 MB
// L2 serves.
#include "tc.cuh"
#include "tile.cuh"

namespace ntp {

// The band kernel's indices.  A pair (A slot s, B slot tb) of row r feeds
// output slot t < span when gg0[r, s] + tb = t and neither A slot s nor B
// slot (acols[r, s], tb) is EMPTY.  The two tiers find these pairs in two
// ways (tile.cuh's pair interface), each the faster for its tier on the
// H100 (PERF.md): the candidate walk made the exact ring 13% slower at
// the low-K X @ X, and the A-slot walk the tensor-core product ~35%
// slower at the flagship X @ X, with the same pairs and the same bits.
struct BandShape {
  const int* a_cols;
  const int* b_cols;
  const int* gg0;
  int ka, kb, span;

  __device__ int b_col(int) const { return 0; }  // B is block planes
};

// The exact ring: the A slots s, B slot tb = t - gg0[r, s], the three
// index loads issued together (no branch between them).
struct BandSlots : BandShape {
  __device__ int slots() const { return ka; }
  __device__ int a_slot(int s) const { return s; }
  __device__ int64_t b_block(int64_t r, int t, int s) const {
    const int ac = a_cols[r * ka + s];
    const int tb = t - gg0[r * ka + s];
    const bool ok = t < span && ac != kEmpty && tb >= 0 && tb < kb;
    const int64_t blk = int64_t(ac) * kb + tb;
    return ok && b_cols[blk] != kEmpty ? blk : -1;
  }
  __device__ int64_t b_taken(int64_t r, int t, int s) const {
    return int64_t(a_cols[r * ka + s]) * kb + t - gg0[r * ka + s];
  }
};

// The tensor-core product's producer: the candidates p = s * KB + tb,
// each tested on gg0 first, as the general kernel tests its plan entry.
struct BandCandidates : BandShape {
  __device__ int slots() const { return ka * kb; }
  __device__ int a_slot(int p) const { return p / kb; }
  __device__ int64_t b_block(int64_t r, int t, int p) const {
    const int s = p / kb, tb = p % kb;
    if (t >= span || gg0[r * ka + s] + tb != t) return -1;
    const int ac = a_cols[r * ka + s];
    if (ac == kEmpty) return -1;
    const int64_t blk = int64_t(ac) * kb + tb;
    return b_cols[blk] == kEmpty ? -1 : blk;
  }
};

inline BandShape band_shape(const void* a_cols, const void* b_cols,
                            const void* gg0, int ka, int kb, int span) {
  return {static_cast<const int*>(a_cols), static_cast<const int*>(b_cols),
          static_cast<const int*>(gg0), ka, kb, span};
}

// ---------------------------------------------------------------------------
// the split pass (also run before the general, window and uniform
// kernels' 'high')
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint2 pack(const __nv_bfloat162 (&v)[2]) {
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&v[0]);
  u.y = *reinterpret_cast<const unsigned*>(&v[1]);
  return u;
}

// hi[i] = bf16(x[i]) and, where lo is not null, lo[i] = bf16(x[i] -
// hi[i]), four values a step.  What bounds it: the bytes, 4 read and 4
// (or 2) written per value.
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ x, uint2* __restrict__ hi,
             uint2* __restrict__ lo, int64_t n4) {
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += step) {
    __nv_bfloat162 h[2], l[2];
    tc::split_bf16(x[i], h, l);
    hi[i] = pack(h);
    if (lo) lo[i] = pack(l);
  }
}

}  // namespace ntp

extern "C" {

int ntp_spgemm_band_f32(const void* a_cols, const void* a_blocks,
                        const void* b_cols, const void* b_blocks,
                        const void* gg0, void* out, void* norms,
                        const void* run, int rows,
                        int ka, int kb, int k_out, int span, int bs,
                        double alpha, double threshold, void* stream) {
  return ntp::launch_pairs<float>(
      ntp::BandSlots{ntp::band_shape(a_cols, b_cols, gg0, ka, kb, span)},
      a_blocks, b_blocks, out, norms, rows, k_out, bs, alpha, threshold,
      run, stream);
}

int ntp_spgemm_band_f64(const void* a_cols, const void* a_blocks,
                        const void* b_cols, const void* b_blocks,
                        const void* gg0, void* out, void* norms,
                        const void* run, int rows,
                        int ka, int kb, int k_out, int span, int bs,
                        double alpha, double threshold, void* stream) {
  return ntp::launch_pairs<double>(
      ntp::BandSlots{ntp::band_shape(a_cols, b_cols, gg0, ka, kb, span)},
      a_blocks, b_blocks, out, norms, rows, k_out, bs, alpha, threshold,
      run, stream);
}

// 'high' (a_lo and b_lo given) or 'bf16' (both null) on the bfloat16
// planes of A [rows, ka, bs, bs] and B [nbk, kb, bs, bs]; float32 out.
int ntp_spgemm_band_tc(const void* a_cols, const void* a_hi,
                       const void* a_lo, const void* b_cols,
                       const void* b_hi, const void* b_lo, const void* gg0,
                       void* out, void* norms, const void* run, int rows,
                       int ka, int kb, int nbk, int k_out, int span, int bs,
                       double alpha, double threshold, void* stream) {
  const ntp::tc::Pairs<ntp::BandCandidates> src{
      {ntp::band_shape(a_cols, b_cols, gg0, ka, kb, span)}, k_out};
  const ntp::tc::Params p{static_cast<float*>(out),
                          static_cast<float*>(norms),
                          int64_t(rows) * k_out, bs, float(alpha),
                          float(threshold),
                          static_cast<const int*>(run)};
  return ntp::tc::launch(a_hi, a_lo, int64_t(rows) * ka, b_hi, b_lo,
                         int64_t(nbk) * kb, bs, src, p, stream);
}

// The split pass over n floats (n a multiple of 4, x 16-byte aligned):
// hi, and lo unless it is null.
int ntp_split_bf16(const void* x, void* hi, void* lo, long long n,
                   void* stream) {
  const int64_t n4 = n / 4;
  if (n4 == 0) return 0;
  const int blocks = static_cast<int>(
      std::min<int64_t>((n4 + 255) / 256, 8 * ntp::tc::sm_count()));
  ntp::split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint2*>(hi),
      static_cast<uint2*>(lo), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
