// Streamed block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v2
// (launched by _call_kernel_v2): what _kernel computes -- each candidate
// product A[r, s] @ B[acols[r, s], t] lands in output slot plan[r, s * KB
// + t] (dropped when >= k_out), then alpha, the threshold flush and
// per-slot L1 norms -- with B read from the panel layout [NBK, bs, KB *
// bs] (EMPTY slots zeroed, block t of a row at columns t*bs..(t+1)*bs),
// one row per grid step, and the operand stream overlapped with the
// products.  Output type = input type (float or double), exact products
// (the TPU's HIGHEST).
//
// What bounds it on the H100: the bs x bs block products on the FP32
// (or FP64) CUDA-core pipes, 64 operations per operand byte at bs 128 in
// float32 (at the 2^19-row low-K X @ X, 154.6 GFLOP: 2.31 ms at 67
// TFLOP/s, against ~0.6 ms of bytes).  So what counts is how many of the
// SM's issue slots and shared-memory wavefronts go to anything but FMAs,
// and how often operand latency is exposed at a barrier.
//
// Design: one thread block per block-row r walks the row's k_out output
// slots in turn, as the TPU kernel walks one row per grid step; for each
// slot it accumulates, in registers, every product whose plan entry
// names it.  The TPU kernel double-buffers whole B panel rows with
// make_async_copy and semaphores; here the unit is a 32-deep k-chunk of A
// and of the panel, and the buffer is tile.cuh's three-stage cp.async
// ring (pipelined_outputs), so the next two chunks -- including the next
// slot's first ones -- load while the current one is multiplied, at one
// barrier a chunk.  The multiply is tile.cuh's exact core: each thread an
// 8 x 8 tile at bs 128, A and B read from shared memory as 16-byte
// vectors, 4 loads per 64 FMAs.  No atomics.
#include "tile.cuh"

namespace ntp {

// The work of block-row r: output o is slot o, product slot p = s*KB + t.
template <typename T>
struct StreamWork {
  const int* a_cols;
  const T* a_blocks;
  const T* panel;
  const int* plan;
  T* c_blocks;
  T* c_norms;
  int64_t r;
  int ka, kb, nbk, k_out, bs;

  __device__ int acol(int p) const { return a_cols[r * ka + p / kb]; }
  __device__ bool use(int o, int p) const {
    return acol(p) != kEmpty && plan[r * ka * kb + p] == o;
  }
  __device__ const T* a(int, int p) const {
    return a_blocks + (r * ka + p / kb) * int64_t(bs) * bs;
  }
  __device__ const T* b(int, int p) const {
    const int64_t k = min(acol(p), nbk - 1);
    return panel + k * bs * int64_t(kb) * bs + (p % kb) * bs;
  }
  __device__ T* out(int o) const {
    return c_blocks + (r * k_out + o) * int64_t(bs) * bs;
  }
  __device__ T* norm(int o) const { return c_norms + r * k_out + o; }
};

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads, (Tile<T, TS>::kMinBlocks))
stream_kernel(const int* __restrict__ a_cols, const T* __restrict__ a_blocks,
              const T* __restrict__ panel, const int* __restrict__ plan,
              T* __restrict__ out, T* __restrict__ norms, int ka, int kb,
              int nbk, int k_out, int bs, T alpha, T threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads / 32];
  const StreamWork<T> work{a_cols, a_blocks, panel, plan, out, norms,
                           blockIdx.x, ka, kb, nbk, k_out, bs};
  pipelined_outputs<T, TS>(work, k_out, ka * kb, bs, kb * bs, alpha,
                           threshold, reinterpret_cast<Stage<T, TS>*>(smem),
                           red);
}

template <typename T>
int launch_stream(const void* a_cols, const void* a_blocks,
                  const void* panel, const void* plan, void* out,
                  void* norms, int rows, int ka, int kb, int nbk,
                  int k_out, int bs, double alpha, double threshold,
                  void* stream) {
  if (rows == 0 || k_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_STREAM(TS)                                                      \
  {                                                                         \
    const int smem = ring_bytes<T, TS>();                                   \
    if (int err = allow_smem(stream_kernel<T, TS>, smem)) return err;       \
    stream_kernel<T, TS><<<rows, kThreads, smem, st>>>(                     \
        static_cast<const int*>(a_cols), static_cast<const T*>(a_blocks),   \
        static_cast<const T*>(panel), static_cast<const int*>(plan),        \
        static_cast<T*>(out), static_cast<T*>(norms), ka, kb, nbk, k_out,   \
        bs, T(alpha), T(threshold));                                        \
  }
  switch (tile_for(bs)) {
    case 16: NTP_STREAM(16); break;
    case 32: NTP_STREAM(32); break;
    case 64: NTP_STREAM(64); break;
    default: NTP_STREAM(128); break;
  }
#undef NTP_STREAM
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ntp

extern "C" {

int ntp_spgemm_stream_f32(const void* a_cols, const void* a_blocks,
                          const void* panel, const void* plan, void* out,
                          void* norms, int rows, int ka, int kb, int nbk,
                          int k_out, int bs, double alpha, double threshold,
                          void* stream) {
  return ntp::launch_stream<float>(a_cols, a_blocks, panel, plan, out,
                                   norms, rows, ka, kb, nbk, k_out, bs,
                                   alpha, threshold, stream);
}

int ntp_spgemm_stream_f64(const void* a_cols, const void* a_blocks,
                          const void* panel, const void* plan, void* out,
                          void* norms, int rows, int ka, int kb, int nbk,
                          int k_out, int bs, double alpha, double threshold,
                          void* stream) {
  return ntp::launch_stream<double>(a_cols, a_blocks, panel, plan, out,
                                    norms, rows, ka, kb, nbk, k_out, bs,
                                    alpha, threshold, stream);
}

}  // extern "C"
