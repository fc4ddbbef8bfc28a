// Band block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v4
// (launched by _call_kernel_v4): C = alpha * A @ B for banded operands,
// whose B rows are arithmetically contiguous (col(t) = base + t), with
// the output in offset form: output slot t of row r holds block-column
// occ0[r] + t, and the product of A slot s lands at offset gg0[r, s].
// Slots t < span = min(k_out, KA + KB - 1) are computed; slots t >= span
// are written as zero blocks with zero norm.  Same prune epilogue as the
// general kernel (alpha, threshold flush, per-slot L1 norm).
//
// What bounds it on the H100: as for the general kernel, the bs x bs
// block products on the FP32 (or FP64) pipes; at the 2^20-row flagship
// one full-span X @ X is 8192 x 9 output blocks of up to 5 products.
//
// Design: one thread block per (block-row r, output slot t).  The TPU
// kernel DMAs a window of KA + G - 1 B rows per group of G rows and
// packs panels in VMEM; here the addressing is arithmetic instead: for
// each valid A slot s the B row is acols[r, s] and the B slot is t -
// gg0[r, s], and the product counts when that slot lies in [0, KB) and
// is not EMPTY.  No pair list and no window copy: neighbouring rows
// read overlapping B rows, which the 50 MB L2 serves.  Later work:
// wgmma tiles fed by TMA, and TF32x3 for the 'high' tier.
#include "tile.cuh"

namespace ntp {

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
band_kernel(const int* __restrict__ a_cols, const T* __restrict__ a_blocks,
            const int* __restrict__ b_cols, const T* __restrict__ b_blocks,
            const int* __restrict__ gg0, T* __restrict__ out,
            T* __restrict__ norms, int ka, int kb, int k_out, int span,
            int bs, T alpha, T threshold) {
  __shared__ Smem<T, TS> sm;
  __shared__ T red[kThreads / 32];
  const int64_t r = blockIdx.x;
  const int t = blockIdx.y;
  const int64_t bb = int64_t(bs) * bs;
  const int64_t o = r * k_out + t;
  if (t >= span) {
    store_zero(out + o * bb, norms + o, bs);
    return;
  }
  Acc<T, TS> acc;
  acc.zero();
  for (int s = 0; s < ka; ++s) {
    const int ac = a_cols[r * ka + s];
    if (ac == kEmpty) continue;
    const int tb = t - gg0[r * ka + s];
    if (tb < 0 || tb >= kb) continue;
    if (b_cols[int64_t(ac) * kb + tb] == kEmpty) continue;
    acc.mac(a_blocks + (r * ka + s) * bb,
            b_blocks + (int64_t(ac) * kb + tb) * bb, bs, sm);
  }
  store_pruned(acc, out + o * bb, norms + o, bs, alpha, threshold, red);
}

template <typename T>
int launch_band(const void* a_cols, const void* a_blocks,
                const void* b_cols, const void* b_blocks, const void* gg0,
                void* out, void* norms, int rows, int ka, int kb,
                int k_out, int span, int bs, double alpha,
                double threshold, void* stream) {
  if (rows == 0 || k_out == 0) return 0;
  const dim3 grid(rows, k_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_BAND(TS)                                                       \
  band_kernel<T, TS><<<grid, kThreads, 0, st>>>(                           \
      static_cast<const int*>(a_cols), static_cast<const T*>(a_blocks),    \
      static_cast<const int*>(b_cols), static_cast<const T*>(b_blocks),    \
      static_cast<const int*>(gg0), static_cast<T*>(out),                  \
      static_cast<T*>(norms), ka, kb, k_out, span, bs, T(alpha),           \
      T(threshold))
  switch (tile_for(bs)) {
    case 16: NTP_BAND(16); break;
    case 32: NTP_BAND(32); break;
    case 64: NTP_BAND(64); break;
    default: NTP_BAND(128); break;
  }
#undef NTP_BAND
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ntp

extern "C" {

int ntp_spgemm_band_f32(const void* a_cols, const void* a_blocks,
                        const void* b_cols, const void* b_blocks,
                        const void* gg0, void* out, void* norms, int rows,
                        int ka, int kb, int k_out, int span, int bs,
                        double alpha, double threshold, void* stream) {
  return ntp::launch_band<float>(a_cols, a_blocks, b_cols, b_blocks, gg0,
                                 out, norms, rows, ka, kb, k_out, span, bs,
                                 alpha, threshold, stream);
}

int ntp_spgemm_band_f64(const void* a_cols, const void* a_blocks,
                        const void* b_cols, const void* b_blocks,
                        const void* gg0, void* out, void* norms, int rows,
                        int ka, int kb, int k_out, int span, int bs,
                        double alpha, double threshold, void* stream) {
  return ntp::launch_band<double>(a_cols, a_blocks, b_cols, b_blocks, gg0,
                                  out, norms, rows, ka, kb, k_out, span, bs,
                                  alpha, threshold, stream);
}

}  // extern "C"
