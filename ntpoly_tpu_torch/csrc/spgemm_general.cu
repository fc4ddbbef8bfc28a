// General block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel
// (launched by _call_kernel, with its row chunking _row_chunk): C =
// alpha * A @ B in block-ELL, each candidate product A[r, s] @ B[acols[r,
// s], t] landing in the output slot plan[r, s * KB + t] that the
// structure pass assigned (dropped when >= k_out), followed by the
// threshold flush and per-slot L1 norms.
//
// What bounds it on the H100: the bs x bs block products on the FP32
// (or FP64) pipes.  Each product reads 2 bs^2 values and does 2 bs^3
// operations, 64 operations per byte at bs = 128 in f32, so the kernel
// sits above the memory roofline and is limited by how well the
// register tile hides shared-memory traffic.
//
// Design: output-stationary.  One thread block per (block-row r, output
// slot g); the block walks the row's KA x KB plan entries, accumulates
// every product whose entry equals g in registers (tile.cuh), and runs
// the prune epilogue once.  No atomics, no second pass, and no row
// chunking: the TPU's chunking existed for its scalar-memory limits.
// B is read in its native [NBK, KB, bs, bs] layout with EMPTY slots
// skipped, so no panel copy of B is built.  Later work: wgmma tiles fed
// by TMA, and TF32x3 for the 'high' tier.
#include "tile.cuh"

namespace ntp {

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
general_kernel(const int* __restrict__ a_cols, const T* __restrict__ a_blocks,
               const int* __restrict__ b_cols, const T* __restrict__ b_blocks,
               const int* __restrict__ plan, T* __restrict__ out,
               T* __restrict__ norms, int ka, int kb, int k_out, int bs,
               T alpha, T threshold) {
  __shared__ Smem<T, TS> sm;
  __shared__ T red[kThreads / 32];
  const int64_t r = blockIdx.x;
  const int g = blockIdx.y;
  const int64_t bb = int64_t(bs) * bs;
  Acc<T, TS> acc;
  acc.zero();
  const int* prow = plan + r * ka * kb;
  for (int s = 0; s < ka; ++s) {
    const int ac = a_cols[r * ka + s];
    if (ac == kEmpty) continue;
    for (int t = 0; t < kb; ++t) {
      if (prow[s * kb + t] != g) continue;
      if (b_cols[int64_t(ac) * kb + t] == kEmpty) continue;
      acc.mac(a_blocks + (r * ka + s) * bb,
              b_blocks + (int64_t(ac) * kb + t) * bb, bs, sm);
    }
  }
  const int64_t o = r * k_out + g;
  store_pruned(acc, out + o * bb, norms + o, bs, alpha, threshold, red);
}

template <typename T>
int launch_general(const void* a_cols, const void* a_blocks,
                   const void* b_cols, const void* b_blocks,
                   const void* plan, void* out, void* norms, int rows,
                   int ka, int kb, int k_out, int bs, double alpha,
                   double threshold, void* stream) {
  if (rows == 0 || k_out == 0) return 0;
  const dim3 grid(rows, k_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_GENERAL(TS)                                                    \
  general_kernel<T, TS><<<grid, kThreads, 0, st>>>(                        \
      static_cast<const int*>(a_cols), static_cast<const T*>(a_blocks),    \
      static_cast<const int*>(b_cols), static_cast<const T*>(b_blocks),    \
      static_cast<const int*>(plan), static_cast<T*>(out),                 \
      static_cast<T*>(norms), ka, kb, k_out, bs, T(alpha), T(threshold))
  switch (tile_for(bs)) {
    case 16: NTP_GENERAL(16); break;
    case 32: NTP_GENERAL(32); break;
    case 64: NTP_GENERAL(64); break;
    default: NTP_GENERAL(128); break;
  }
#undef NTP_GENERAL
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ntp

extern "C" {

int ntp_spgemm_general_f32(const void* a_cols, const void* a_blocks,
                           const void* b_cols, const void* b_blocks,
                           const void* plan, void* out, void* norms,
                           int rows, int ka, int kb, int k_out, int bs,
                           double alpha, double threshold, void* stream) {
  return ntp::launch_general<float>(a_cols, a_blocks, b_cols, b_blocks,
                                    plan, out, norms, rows, ka, kb, k_out,
                                    bs, alpha, threshold, stream);
}

int ntp_spgemm_general_f64(const void* a_cols, const void* a_blocks,
                           const void* b_cols, const void* b_blocks,
                           const void* plan, void* out, void* norms,
                           int rows, int ka, int kb, int k_out, int bs,
                           double alpha, double threshold, void* stream) {
  return ntp::launch_general<double>(a_cols, a_blocks, b_cols, b_blocks,
                                     plan, out, norms, rows, ka, kb, k_out,
                                     bs, alpha, threshold, stream);
}

const char* ntp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
