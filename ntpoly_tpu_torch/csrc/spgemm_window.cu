// Windowed block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel_v3
// (launched by _call_kernel_v3): what _kernel computes (plan-addressed
// products, alpha, threshold flush, per-slot L1 norms) for a group of G
// rows at a time, whose B rows are read from one window of W = KA + G - 1
// panel rows starting at lo = min(wlo[group], NBK - W).  A col id is
// addressed inside its group's window: B row = lo + clip(acol - lo, 0,
// W - 1), so a col id outside the window reads the clamped edge row, as
// on the TPU, and never out of bounds.
//
// Tiers, as _kernel_v3 computes them:
//   'high' on float32: the TPU's hand-made bf16x3 split (:341-354),
//       alpha (A_hi B_hi + A_lo B_hi + A_hi B_lo), on the tensor cores
//       (tc.cuh): the split pass (spgemm_band.cu) writes the planes of A
//       and of the panel, then wgmma fed by TMA.
//   'bf16' (bfloat16 operands, float32 out): A B on the same product,
//       the operands being the hi planes, with no split.
//   'default' on float32 (the TPU's one bf16 pass): the same product on
//       the hi planes that the split pass writes, float32 out.
//   'highest' on float32 and every tier of float64: exact FMA products
//       on the three-stage cp.async ring of tile.cuh, products in turn
//       (s, then t), k ascending, as the general and stream kernels add
//       them.
//
// What bounds it on the H100 at the 2^19-row low-K shape (bs 128, KA =
// KB = 3, k_out 5; one X @ X is ~155 GFLOP against ~2.1 GB of float32
// operands and output): exact, the FP32 pipes (2.31 ms at 67 TFLOP/s);
// 'high', its three bf16 products (0.47 ms at 989 TFLOP/s) under the
// bytes (~0.64 ms at 3.35 TB/s), plus the split pass's own bytes.
//
// Design: the TPU keeps the group's whole window resident in VMEM; at bs
// 128, KB 3 and W 10 that is 1.9 MB in float, and a block has 227 KB of
// shared memory.  Both tiers take the reuse of B from L2 instead.  The
// ring: one thread block per (group, output slot j), on a 1-D grid in
// group order, walks the group's G rows as the TPU's grid step does; the
// k_out blocks of a group run side by side and read the same A row and
// window rows at about the same time, and row i + 1 reads KA - 1 of row
// i's window rows again shortly after.  The tensor cores: tc.cuh's
// persistent grid over tiles (row r, slot j), slot-fastest, the pairs
// (s, t) of row r whose plan entry is j, s ascending then t -- the
// general kernel's pairs and order, so that on the same planes the two
// give the same bits; a B box is block t of a window row of the panel,
// at column t * bs.  No atomics.
#include "tc.cuh"
#include "tile.cuh"

namespace ntp {

// The work of (group, slot j) on the ring: output o is row r0 + o of the
// group, product slot p = s*KB + t.
template <typename T>
struct WindowWork {
  const int* a_cols;
  const T* a_blocks;
  const T* panel;
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
  __device__ const T* a(int o, int p) const {
    return a_blocks + ((r0 + o) * ka + p / kb) * int64_t(bs) * bs;
  }
  __device__ const T* b(int o, int p) const {
    const int64_t row = lo + min(max(acol(o, p) - lo, 0), w - 1);
    return panel + row * bs * int64_t(kb) * bs + (p % kb) * bs;
  }
  __device__ T* out(int o) const {
    return c_blocks + ((r0 + o) * k_out + j) * int64_t(bs) * bs;
  }
  __device__ T* norm(int o) const { return c_norms + (r0 + o) * k_out + j; }
};

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads, (Tile<T, TS>::kMinBlocks))
window_kernel(const int* __restrict__ a_cols,
              const T* __restrict__ a_blocks,
              const T* __restrict__ panel, const int* __restrict__ plan,
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
  const WindowWork<T> work{a_cols, a_blocks, panel, plan, out, norms,
                           int64_t(grp) * g_rows, j, lo, ka, kb,
                           k_out, bs, w};
  pipelined_outputs<T, TS>(work, g_rows, ka * kb, bs, kb * bs, alpha,
                           threshold, reinterpret_cast<Stage<T, TS>*>(smem),
                           red);
}

// The tensor-core product's pairs, as an index of tile.cuh's pair
// interface walked by tc::Pairs: output tile r * k_out + j takes the
// candidates p = s * KB + t of row r with acol[r, s] != EMPTY and plan[r,
// p] == j, in order (s ascending, then t), A block r * KA + s and block t
// of the window row of acol[r, s]: panel row b_block, from column b_col.
struct WindowIndex {
  const int* a_cols;
  const int* plan;
  const int* wlo;
  int ka, kb, nbk, bs, g_rows, w;

  __device__ int slots() const { return ka * kb; }
  __device__ int a_slot(int p) const { return p / kb; }
  __device__ int b_col(int p) const { return (p % kb) * bs; }
  __device__ int64_t b_block(int64_t r, int j, int p) const {
    if (plan[r * ka * kb + p] != j) return -1;
    const int ac = a_cols[r * ka + p / kb];
    if (ac == kEmpty) return -1;
    // wlo >= 0 from _v3_window; the clamp at 0 only keeps a bad caller's
    // reads in bounds
    const int lo = max(min(wlo[r / g_rows], nbk - w), 0);
    return lo + min(max(ac - lo, 0), w - 1);
  }
};

template <typename T>
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
    const int smem = ring_bytes<T, TS>();                                   \
    if (int err = allow_smem(window_kernel<T, TS>, smem)) return err;       \
    window_kernel<T, TS><<<blocks, kThreads, smem, st>>>(                   \
        static_cast<const int*>(a_cols), static_cast<const T*>(a_blocks),   \
        static_cast<const T*>(panel), static_cast<const int*>(plan),        \
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

#define NTP_WINDOW_ENTRY(NAME, T)                                          \
  int NAME(const void* a_cols, const void* a_blocks, const void* panel,     \
           const void* plan, const void* wlo, void* out, void* norms,       \
           int rows, int ka, int kb, int nbk, int k_out, int bs,            \
           int g_rows, int w, double alpha, double threshold,               \
           void* stream) {                                                  \
    return ntp::launch_window<T>(a_cols, a_blocks, panel, plan, wlo, out,   \
                                 norms, rows, ka, kb, nbk, k_out, bs,       \
                                 g_rows, w, alpha, threshold, stream);      \
  }

extern "C" {
NTP_WINDOW_ENTRY(ntp_spgemm_window_f32, float)
NTP_WINDOW_ENTRY(ntp_spgemm_window_f64, double)

// 'high' (a_lo and panel_lo given: the split planes of float32 operands)
// or 'bf16' (both null: the bfloat16 operands themselves) on A [rows, ka,
// bs, bs] and the panel [nbk, bs, kb * bs]; float32 out.
int ntp_spgemm_window_tc(const void* a_cols, const void* a_hi,
                         const void* a_lo, const void* panel_hi,
                         const void* panel_lo, const void* plan,
                         const void* wlo, void* out, void* norms, int rows,
                         int ka, int kb, int nbk, int k_out, int bs,
                         int g_rows, int w, double alpha, double threshold,
                         void* stream) {
  const ntp::tc::Pairs<ntp::WindowIndex> src{
      {static_cast<const int*>(a_cols), static_cast<const int*>(plan),
       static_cast<const int*>(wlo), ka, kb, nbk, bs, g_rows, w},
      k_out};
  const ntp::tc::Params p{static_cast<float*>(out),
                          static_cast<float*>(norms),
                          int64_t(rows) * k_out, bs, float(alpha),
                          float(threshold)};
  return ntp::tc::launch(a_hi, a_lo, int64_t(rows) * ka, panel_hi,
                         panel_lo, nbk, kb * bs, src, p, stream);
}
}  // extern "C"

#undef NTP_WINDOW_ENTRY
