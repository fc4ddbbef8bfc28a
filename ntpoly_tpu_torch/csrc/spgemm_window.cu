// Windowed block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v3
// (launched by _call_kernel_v3): what _kernel computes (plan-addressed
// products, alpha, threshold flush, per-slot L1 norms) for a group of G
// rows at a time, whose B rows are read from one window of W = KA + G - 1
// panel rows starting at lo = min(wlo[group], NBK - W).  A col id is
// addressed inside its group's window: B row = lo + clip(acol - lo, 0,
// W - 1), so a col id outside the window reads the clamped edge row, as
// on the TPU, and never out of bounds.  Three instances: float, double,
// and bfloat16 operands with float output (the 'bf16' tier, which reads
// half the operand bytes and accumulates in float).  Every other tier
// runs exact products: 'high' on float is exact float here, where the
// TPU splits it into three bf16 passes.
//
// What bounds it on the H100: the block products on the FP32 (or FP64)
// CUDA-core pipes.  At the 2^19-row low-K shape (bs 128, KA = KB = 3,
// k_out 5) one X @ X is ~155 GFLOP against ~3 GB of operand and output
// traffic, ~0.9 ms at 3.35 TB/s, far below the products' time.
//
// Design: the TPU keeps the group's whole window resident in VMEM; at bs
// 128, KB 3 and W 10 that is 1.9 MB in float, and a block has 227 KB of
// shared memory.  Of the ways to get the G rows' reuse of B back --
// stage each k-chunk strip of a window row once for every product that
// needs it (several output blocks per thread block: G blocks of 64 KB do
// not fit the registers), share the window across a thread-block cluster
// (the plan's rank form makes the cluster rank of an output column data
// dependent), or schedule the group's blocks together so that L2 serves
// the reuse -- this kernel takes the third.  One thread block per
// (group, output slot j), on a 1-D grid in group order, walks the
// group's G rows as the TPU's grid step does.  The k_out blocks of a
// group run side by side and read the same A row and window rows at
// about the same time; row i + 1 reads KA - 1 of row i's window rows
// again shortly after.  At the low-K shape the ~264 resident blocks
// cover ~53 groups, whose live rows (~0.8 MB a group) fit the 50 MB
// L2, so a window row should come from HBM about once (L2 hit rate not
// measured).  Within the block the two-stage
// cp.async ring of tile.cuh keeps the next chunk, across row
// boundaries too, in flight while the current one is multiplied.  No
// atomics.  Later work: wgmma tiles fed by TMA.
#include "tile.cuh"

namespace ntp {

// The work of (group, slot j): output o is row r0 + o of the group,
// product slot p = s*KB + t.
template <typename Tin, typename T>
struct WindowWork {
  const int* a_cols;
  const Tin* a_blocks;
  const Tin* panel;
  const int* plan;
  T* c_blocks;
  T* c_norms;
  int64_t r0;
  int j, lo, ka, kb, k_out, bs, w;

  __device__ int acol(int o, int p) const {
    return a_cols[(r0 + o) * ka + p / kb];
  }
  __device__ bool use(int o, int p) const {
    return acol(o, p) != kEmpty && plan[(r0 + o) * ka * kb + p] == j;
  }
  __device__ const Tin* a(int o, int p) const {
    return a_blocks + ((r0 + o) * ka + p / kb) * int64_t(bs) * bs;
  }
  __device__ const Tin* b(int o, int p) const {
    const int64_t row = lo + min(max(acol(o, p) - lo, 0), w - 1);
    return panel + row * bs * int64_t(kb) * bs + (p % kb) * bs;
  }
  __device__ T* out(int o) const {
    return c_blocks + ((r0 + o) * k_out + j) * int64_t(bs) * bs;
  }
  __device__ T* norm(int o) const { return c_norms + (r0 + o) * k_out + j; }
};

template <typename Tin, typename T, int TS>
__global__ void __launch_bounds__(kThreads)
window_kernel(const int* __restrict__ a_cols,
              const Tin* __restrict__ a_blocks,
              const Tin* __restrict__ panel, const int* __restrict__ plan,
              const int* __restrict__ wlo, T* __restrict__ out,
              T* __restrict__ norms, int ka, int kb, int nbk, int k_out,
              int bs, int g_rows, int w, T alpha, T threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads / 32];
  const int grp = blockIdx.x / k_out;
  const int j = blockIdx.x % k_out;
  // wlo >= 0 from _v3_window; the clamp at 0 only keeps a bad caller's
  // reads in bounds
  const int lo = max(min(wlo[grp], nbk - w), 0);
  const WindowWork<Tin, T> work{a_cols, a_blocks, panel, plan, out, norms,
                                int64_t(grp) * g_rows, j, lo, ka, kb,
                                k_out, bs, w};
  pipelined_outputs<Tin, T, TS>(work, g_rows, ka * kb, bs, kb * bs, alpha,
                                threshold,
                                reinterpret_cast<Stage<Tin, TS>*>(smem),
                                red);
}

template <typename Tin, typename T>
int launch_window(const void* a_cols, const void* a_blocks,
                  const void* panel, const void* plan, const void* wlo,
                  void* out, void* norms, int rows, int ka, int kb,
                  int nbk, int k_out, int bs, int g_rows, int w,
                  double alpha, double threshold, void* stream) {
  if (rows == 0 || k_out == 0) return 0;
  const int blocks = rows / g_rows * k_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_WINDOW(TS)                                                      \
  {                                                                         \
    const int smem = ring_bytes<Tin, TS>();                                 \
    if (int err = allow_smem(window_kernel<Tin, T, TS>, smem)) return err;  \
    window_kernel<Tin, T, TS><<<blocks, kThreads, smem, st>>>(              \
        static_cast<const int*>(a_cols), static_cast<const Tin*>(a_blocks), \
        static_cast<const Tin*>(panel), static_cast<const int*>(plan),      \
        static_cast<const int*>(wlo), static_cast<T*>(out),                 \
        static_cast<T*>(norms), ka, kb, nbk, k_out, bs, g_rows, w,          \
        T(alpha), T(threshold));                                            \
  }
  switch (tile_for(bs)) {
    case 16: NTP_WINDOW(16); break;
    case 32: NTP_WINDOW(32); break;
    case 64: NTP_WINDOW(64); break;
    default: NTP_WINDOW(128); break;
  }
#undef NTP_WINDOW
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ntp

#define NTP_WINDOW_ENTRY(NAME, TIN, T)                                      \
  int NAME(const void* a_cols, const void* a_blocks, const void* panel,     \
           const void* plan, const void* wlo, void* out, void* norms,       \
           int rows, int ka, int kb, int nbk, int k_out, int bs,            \
           int g_rows, int w, double alpha, double threshold,               \
           void* stream) {                                                  \
    return ntp::launch_window<TIN, T>(a_cols, a_blocks, panel, plan, wlo,   \
                                      out, norms, rows, ka, kb, nbk, k_out, \
                                      bs, g_rows, w, alpha, threshold,      \
                                      stream);                              \
  }

extern "C" {
NTP_WINDOW_ENTRY(ntp_spgemm_window_f32, float, float)
NTP_WINDOW_ENTRY(ntp_spgemm_window_f64, double, double)
NTP_WINDOW_ENTRY(ntp_spgemm_window_bf16, __nv_bfloat16, float)
}  // extern "C"

#undef NTP_WINDOW_ENTRY
