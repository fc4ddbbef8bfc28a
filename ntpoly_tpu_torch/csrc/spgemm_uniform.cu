// Uniform-band block SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the four TPU kernels of the JAX package's round-5 low-K
// experiments, which compute one function and differ only in how they
// schedule the TPU:
//   profile_lowk_r5.py:_kernel_v6  (:189, call :282) -- col-addressed;
//   profile_lowk_r5.py:_kernel_v7  (:310, call :405) -- positional, dots
//                                   batched over the group;
//   profile_lowk_r5.py:_kernel_v9  (:455, call :560) -- positional,
//                                   B-stationary, 'high' folded into one
//                                   K-concatenated dot;
//   profile_lowk_r5.py:_kernel_v10 (:605, call :738) -- v9 with both
//                                   operands double-buffered.
// The function: rows come in groups of G, whose B rows are read from one
// window of W = KA + G - 1 raw B rows [NBK, KB, bs, bs] starting at lo =
// min(wlo[group], NBK - W).  Output slot t < span of row r sums A[r, s] @
// B[row(r, s), t - s] over the slots s with 0 <= t - s < KB -- a STATIC
// offset s, where the band kernel reads a per-slot gg0 -- then alpha,
// the threshold flush and the L1 norm of every column; slots t >= span
// are zero.  row(r, s) = lo + clip(acol - lo, 0, W - 1) ('col', v6) or lo
// + i + s for row i of the group whatever its col id says ('position',
// v7, v9, v10).  No slot is skipped for its col id: the format's EMPTY
// slots hold zero blocks.  v9's B-stationary stacking (an MXU weight tile
// of KA * bs rows) would mean accumulating across thread blocks here, and
// v10's prep-under-dot is what the cp.async ring below already does, so
// neither schedule is carried over.
//
// Tiers (float32 operands, or bfloat16 at 'bf16'; float32 out):
//   'highest': the exact FMA core of tile.cuh on the three-stage cp.async
//       ring (pipelined_outputs), as the stream and window kernels run
//       it; the TPU's HIGHEST is f32-accurate.  The plain version also
//       takes double; no profile path needs it here.
//   'high': the TPU's bf16x3 split, which v9 and v10 fold into one
//       K-concatenated dot, as the band kernel runs it: the split pass
//       (spgemm_band.cu) writes the planes once per operand storage (X @
//       X splits X once), then the tensor-core product of tc.cuh, with
//       its column-norm epilogue.
//   'bf16' (bfloat16 operands): the same product on the operands
//       themselves as the hi planes, with no split.
//
// What bounds it on the H100: at the 2^19-row low-K shape (bs 128, KA = KB
// = 3, k_out = span = 5) one product is 36,864 block products, 154.6
// GFLOP.  'highest' is bound by the FP32 pipes (2.31 ms at 67 TFLOP/s);
// 'high' by HBM (X and C in float, 0.644 ms at 3.35 TB/s; its 464 GFLOP
// of bf16 tensor-core work is 0.47 ms at 989 TFLOP/s), plus the split
// pass's own bytes; 'bf16' by HBM too (0.524 ms).
//
// Design: output-stationary, like the port's other kernels, no atomics.
// 'highest': one thread block per (group, output slot t), on a 1-D grid
// in group order, walks the group's G rows, each through its static
// products s in [max(0, t - KB + 1), min(KA - 1, t)], the accumulators in
// registers; rows i and i + 1 share KA - 1 window rows and a group's
// k_out blocks run side by side, so L2 serves the reuse that the TPU's
// VMEM window gives.  The tensor cores: tc.cuh's persistent grid over
// tiles (row r, slot t), slot-fastest, with the same static pairs, s
// ascending (UniformIndex); on the interior rows these are the band
// kernel's pairs in its order, so the two agree bit for bit there.
#include "tc.cuh"
#include "tile.cuh"

namespace ntp {

struct UniformArgs {
  const void* a_cols;
  const void* a_blocks;
  const void* b_blocks;
  const void* wlo;
  void* out;
  void* norms;
  int rows, ka, kb, nbk, k_out, span, bs, g_rows, w, positional;
  double alpha, threshold;
};

// The work of (group, slot t) on the ring: output o is row r0 + o of the
// group, the product slot p is the A slot s.
template <typename T>
struct UniformWork {
  const int* a_cols;
  const T* a_blocks;
  const T* b_blocks;
  T* c_blocks;
  T* c_norms;
  int64_t r0;
  int t, lo, ka, kb, k_out, bs, w, positional;

  __device__ UniformWork(const UniformArgs& p)
      : a_cols(static_cast<const int*>(p.a_cols)),
        a_blocks(static_cast<const T*>(p.a_blocks)),
        b_blocks(static_cast<const T*>(p.b_blocks)),
        c_blocks(static_cast<T*>(p.out)),
        c_norms(static_cast<T*>(p.norms)),
        r0(int64_t(blockIdx.x / p.k_out) * p.g_rows),
        t(blockIdx.x % p.k_out),
        // wlo >= 0 from _v3_window; the clamp at 0 only keeps a bad
        // caller's reads in bounds
        lo(max(min(static_cast<const int*>(p.wlo)[blockIdx.x / p.k_out],
                   p.nbk - p.w),
               0)),
        ka(p.ka),
        kb(p.kb),
        k_out(p.k_out),
        bs(p.bs),
        w(p.w),
        positional(p.positional) {}

  __device__ bool use(int, int s) const { return t - s >= 0 && t - s < kb; }
  __device__ const T* a(int o, int s) const {
    return a_blocks + ((r0 + o) * ka + s) * int64_t(bs) * bs;
  }
  __device__ const T* b(int o, int s) const {
    const int64_t row =
        positional ? lo + o + s
                   : lo + min(max(a_cols[(r0 + o) * ka + s] - lo, 0), w - 1);
    return b_blocks + (row * kb + (t - s)) * int64_t(bs) * bs;
  }
  __device__ T* out(int o) const {
    return c_blocks + ((r0 + o) * k_out + t) * int64_t(bs) * bs;
  }
  __device__ T* norm(int o) const {
    return c_norms + ((r0 + o) * k_out + t) * int64_t(bs);
  }
};

// ---------------------------------------------------------------------------
// 'highest': the FMA core
// ---------------------------------------------------------------------------

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads, (Tile<T, TS>::kMinBlocks))
uniform_fma_kernel(const UniformArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads / 32 * TS];
  const UniformWork<T> work(p);
  if (work.t >= p.span) {
    for (int o = 0; o < p.g_rows; ++o)
      store_zero_cols(work.out(o), work.norm(o), p.bs);
    return;
  }
  pipelined_outputs<T, TS, UniformWork<T>, true>(
      work, p.g_rows, p.ka, p.bs, p.bs, T(p.alpha), T(p.threshold),
      reinterpret_cast<Stage<T, TS>*>(smem), red);
}

// ---------------------------------------------------------------------------
// 'high' and 'bf16': the tensor cores (tc.cuh)
// ---------------------------------------------------------------------------

// The tensor-core product's pairs, as an index of tile.cuh's pair
// interface walked by tc::Pairs: output tile r * k_out + t takes, for t
// < span, the candidates p = s * KB + tb with s + tb = t, s ascending:
// A block r * KA + s and B block row(r, s) * KB + tb, row as
// UniformWork::b reads it.  Tiles t >= span have none and are stored as
// zeros.
struct UniformIndex {
  const int* a_cols;
  const int* wlo;
  int ka, kb, nbk, span, g_rows, w, positional;

  __device__ int slots() const { return ka * kb; }
  __device__ int a_slot(int p) const { return p / kb; }
  __device__ int b_col(int) const { return 0; }  // B is block planes
  __device__ int64_t b_block(int64_t r, int t, int p) const {
    const int s = p / kb, tb = p % kb;
    if (t >= span || s + tb != t) return -1;
    // wlo >= 0 from _v3_window; the clamp at 0 only keeps a bad caller's
    // reads in bounds
    const int lo = max(min(wlo[r / g_rows], nbk - w), 0);
    const int64_t row =
        positional ? lo + r % g_rows + s
                   : lo + min(max(a_cols[r * ka + s] - lo, 0), w - 1);
    return row * kb + tb;
  }
};

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// 'highest' on float32 operands: the FMA core.  -> cudaError_t
int launch_fma(const UniformArgs& p, void* stream) {
  if (p.rows == 0 || p.k_out == 0) return 0;
  const int blocks = p.rows / p.g_rows * p.k_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_UNIFORM_FMA(TS)                                                \
  {                                                                        \
    const int smem = ring_bytes<float, TS>();                              \
    auto* kernel = uniform_fma_kernel<float, TS>;                          \
    if (int err = allow_smem(kernel, smem)) return err;                    \
    kernel<<<blocks, kThreads, smem, st>>>(p);                             \
  }
  switch (tile_for(p.bs)) {
    case 16: NTP_UNIFORM_FMA(16); break;
    case 32: NTP_UNIFORM_FMA(32); break;
    case 64: NTP_UNIFORM_FMA(64); break;
    default: NTP_UNIFORM_FMA(128); break;
  }
#undef NTP_UNIFORM_FMA
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ntp

extern "C" {

int ntp_spgemm_uniform_f32(const void* a_cols, const void* a_blocks,
                           const void* b_blocks, const void* wlo, void* out,
                           void* norms, int rows, int ka, int kb, int nbk,
                           int k_out, int span, int bs, int g_rows, int w,
                           int positional, double alpha, double threshold,
                           void* stream) {
  const ntp::UniformArgs p{a_cols, a_blocks, b_blocks, wlo,    out,
                           norms,  rows,     ka,       kb,     nbk,
                           k_out,  span,     bs,       g_rows, w,
                           positional,       alpha,    threshold};
  return ntp::launch_fma(p, stream);
}

// 'high' (a_lo and b_lo given: the split planes of float32 operands) or
// 'bf16' (both null: the bfloat16 operands themselves) on A [rows, ka,
// bs, bs] and B [nbk, kb, bs, bs]; float32 out, column norms [rows,
// k_out, bs].
int ntp_spgemm_uniform_tc(const void* a_cols, const void* a_hi,
                          const void* a_lo, const void* b_hi,
                          const void* b_lo, const void* wlo, void* out,
                          void* norms, int rows, int ka, int kb, int nbk,
                          int k_out, int span, int bs, int g_rows, int w,
                          int positional, double alpha, double threshold,
                          void* stream) {
  const ntp::tc::Pairs<ntp::UniformIndex> src{
      {static_cast<const int*>(a_cols), static_cast<const int*>(wlo), ka,
       kb, nbk, span, g_rows, w, positional},
      k_out};
  const ntp::tc::Params p{static_cast<float*>(out),
                          static_cast<float*>(norms),
                          int64_t(rows) * k_out, bs, float(alpha),
                          float(threshold)};
  return ntp::tc::launch<ntp::tc::Pairs<ntp::UniformIndex>, true>(
      a_hi, a_lo, int64_t(rows) * ka, b_hi, b_lo, int64_t(nbk) * kb, bs,
      src, p, stream);
}

}  // extern "C"
