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
// Tiers and instances:
//   'highest' (float): the exact FMA core of tile.cuh on the two-stage
//       cp.async ring (pipelined_outputs), as the stream and window
//       kernels run it; the TPU's HIGHEST is f32-accurate.  The plain
//       version also takes double; no profile path needs it here.
//   'high' (float in, float out): the TPU's bf16x3 split on the tensor
//       cores.  Each float k-chunk of depth 16 is staged by cp.async, then
//       split in shared memory into [a_hi | a_lo | a_hi] and [b_hi ; b_hi ;
//       b_lo] (split_chunk), and one mma.sync chain of depth 48 sums the
//       three terms, as v9 and v10 fold them into one dot.
//   'bf16' (bfloat16 in, float out): bf16 k-chunks of depth 32 go by
//       cp.async straight into the mma stage.
//
// What bounds it on the H100: at the 2^19-row low-K shape (bs 128, KA = KB
// = 3, k_out = span = 5) one product is 36,864 block products, 154.6
// GFLOP.  'highest' is bound by the FP32 pipes (2.31 ms at 67 TFLOP/s);
// 'high' by HBM (2.96 GB in float, 0.88 ms at 3.35 TB/s; its 464 GFLOP
// of bf16 tensor-core work is 0.47 ms at 989 TFLOP/s); 'bf16' by HBM too
// (2.15 GB, 0.64 ms).  The tensor-core path's own limit is shared memory:
// each 16-deep float chunk is read once and written three times as bf16
// by the split, then read by ldmatrix, with three barriers a chunk.
//
// Design: output-stationary, like the port's other kernels.  One thread
// block per (group, output slot t), on a 1-D grid in group order, walks
// the group's G rows, each through its static products s in [max(0, t -
// KB + 1), min(KA - 1, t)], the accumulators in registers (64 floats a
// thread on the tensor cores).  Rows i and i + 1 share KA - 1 window rows
// and a group's k_out blocks run side by side, so L2 serves the reuse
// that the TPU's VMEM window gives.  No atomics.  mma.sync with ldmatrix,
// not wgmma: wgmma wants both operands in shared memory in swizzled
// layouts behind descriptors (and K-major operands for tf32), and B is
// N-major here; wgmma, TMA and swizzled stages are later work.
#include <type_traits>

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

// The work of (group, slot t): output o is row r0 + o of the group, the
// product slot p is the A slot s.
template <typename Tin, typename T>
struct UniformWork {
  const int* a_cols;
  const Tin* a_blocks;
  const Tin* b_blocks;
  T* c_blocks;
  T* c_norms;
  int64_t r0;
  int t, lo, ka, kb, k_out, bs, w, positional;

  __device__ UniformWork(const UniformArgs& p)
      : a_cols(static_cast<const int*>(p.a_cols)),
        a_blocks(static_cast<const Tin*>(p.a_blocks)),
        b_blocks(static_cast<const Tin*>(p.b_blocks)),
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
  __device__ const Tin* a(int o, int s) const {
    return a_blocks + ((r0 + o) * ka + s) * int64_t(bs) * bs;
  }
  __device__ const Tin* b(int o, int s) const {
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
__global__ void __launch_bounds__(kThreads)
uniform_fma_kernel(const UniformArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads / 32 * TS];
  const UniformWork<T, T> work(p);
  if (work.t >= p.span) {
    for (int o = 0; o < p.g_rows; ++o)
      store_zero_cols(work.out(o), work.norm(o), p.bs);
    return;
  }
  pipelined_outputs<T, T, TS, UniformWork<T, T>, true>(
      work, p.g_rows, p.ka, p.bs, p.bs, T(p.alpha), T(p.threshold),
      reinterpret_cast<Stage<T, TS>*>(smem), red);
}

// ---------------------------------------------------------------------------
// 'high' and 'bf16': the tensor cores
// ---------------------------------------------------------------------------

// The ring stage of each input type: float chunks of depth kChunk,
// split after they land; bfloat16 chunks of depth 2 * kChunk, used as
// they land.
template <typename Tin>
struct MmaRing {
  using St = Stage<float, kMmaTile>;
  static constexpr int kDepth = kChunk;
  static constexpr int kSmem = 2 * sizeof(St) + sizeof(MmaStage<3 * kChunk>);
};
template <>
struct MmaRing<__nv_bfloat16> {
  using St = MmaStage<2 * kChunk>;
  static constexpr int kDepth = 2 * kChunk;
  static constexpr int kSmem = 2 * sizeof(St);
};

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
uniform_mma_kernel(const UniformArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kMmaTile];
  using St = typename MmaRing<Tin>::St;
  constexpr int KC = MmaRing<Tin>::kDepth;
  St* ring = reinterpret_cast<St*>(smem);
  auto* split =
      reinterpret_cast<MmaStage<3 * kChunk>*>(smem + 2 * sizeof(St));

  const UniformWork<Tin, float> work(p);
  const int bs = p.bs, t = work.t;
  const int s_lo = max(0, t - p.kb + 1), s_hi = min(p.ka - 1, t);
  if (t >= p.span || s_hi < s_lo) {
    for (int o = 0; o < p.g_rows; ++o)
      store_zero_cols(work.out(o), work.norm(o), bs);
    return;
  }
  // steps q = (row o, product s, k-chunk c) in that order; step q + 1 is
  // in flight while step q is multiplied
  const int n_chunks = (bs + KC - 1) / KC;
  const int per = (s_hi - s_lo + 1) * n_chunks;  // steps of one row
  const int total = p.g_rows * per;
  auto fetch = [&](int stage, int q) {
    const int o = q / per, s = s_lo + q % per / n_chunks;
    const int k0 = q % n_chunks * KC;
    if constexpr (std::is_same<Tin, float>::value)
      stage_chunk(ring[stage], work.a(o, s), work.b(o, s), bs, bs, k0);
    else
      stage_chunk_mma(ring[stage], work.a(o, s), work.b(o, s), bs, k0);
    cp_async_commit();
  };

  MmaAcc acc;
  int stage = 0;
  fetch(0, 0);
  for (int q = 0; q < total; ++q) {
    if (q % per == 0) acc.zero();
    if (q + 1 < total) {
      fetch(stage ^ 1, q + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (std::is_same<Tin, float>::value) {
      split_chunk(ring[stage], *split);
      __syncthreads();
      acc.mac(*split);
    } else {
      acc.mac(ring[stage]);
    }
    __syncthreads();  // the stage (and the split) is refilled next
    stage ^= 1;
    if ((q + 1) % per == 0) {
      const int o = q / per;
      store_mma(acc, work.out(o), work.norm(o), bs, float(p.alpha),
                float(p.threshold), red);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
int launch_fma(const UniformArgs& p, int blocks, cudaStream_t st) {
#define NTP_UNIFORM_FMA(TS)                                                \
  {                                                                        \
    const int smem = ring_bytes<T, TS>();                                  \
    if (int err = allow_smem(uniform_fma_kernel<T, TS>, smem)) return err; \
    uniform_fma_kernel<T, TS><<<blocks, kThreads, smem, st>>>(p);          \
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

template <typename Tin>
int launch_mma(const UniformArgs& p, int blocks, cudaStream_t st) {
  constexpr int smem = MmaRing<Tin>::kSmem;
  if (int err = allow_smem(uniform_mma_kernel<Tin>, smem)) return err;
  uniform_mma_kernel<Tin><<<blocks, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// split: the 'high' tier of float operands (the tensor cores); float at
// 'highest' runs the FMA core, bfloat16 the tensor cores.
template <typename Tin>
int launch_uniform(const UniformArgs& p, int split, void* stream) {
  if (p.rows == 0 || p.k_out == 0) return 0;
  const int blocks = p.rows / p.g_rows * p.k_out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<Tin, __nv_bfloat16>::value) {
    return launch_mma<Tin>(p, blocks, st);
  } else {
    return split ? launch_mma<float>(p, blocks, st)
                 : launch_fma<float>(p, blocks, st);
  }
}

}  // namespace ntp

#define NTP_UNIFORM_ENTRY(NAME, TIN)                                          \
  int NAME(const void* a_cols, const void* a_blocks, const void* b_blocks,    \
           const void* wlo, void* out, void* norms, int rows, int ka, int kb, \
           int nbk, int k_out, int span, int bs, int g_rows, int w,           \
           int positional, int split, double alpha, double threshold,         \
           void* stream) {                                                    \
    const ntp::UniformArgs p{a_cols, a_blocks, b_blocks, wlo,    out,         \
                             norms,  rows,     ka,       kb,     nbk,         \
                             k_out,  span,     bs,       g_rows, w,           \
                             positional,       alpha,    threshold};          \
    return ntp::launch_uniform<TIN>(p, split, stream);                        \
  }

extern "C" {
NTP_UNIFORM_ENTRY(ntp_spgemm_uniform_f32, float)
NTP_UNIFORM_ENTRY(ntp_spgemm_uniform_bf16, __nv_bfloat16)
}  // extern "C"

#undef NTP_UNIFORM_ENTRY
