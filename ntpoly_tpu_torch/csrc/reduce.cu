// Slot-aligned reductions of block-ELL operands for Hopper (sm_90a): the
// dot sum_ij A_ij B_ij over the blocks two operands hold at the same
// (block row, col id), and the trace of each block row's diagonal block,
// each as a (hi, lo) two-float pair, or as the pair's value in float64.
//
// Replaces no TPU kernel: the reference's reductions are plain jnp in
// ntpoly_tpu/core/bell.py (align, align_mul, dot, trace_blocks, trace and
// comp_sum), which XLA fuses on the TPU.
//
// Why it was added: their plain PyTorch versions (core/bell.py) took 355
// ms of a 2^20-row TRS4 call on an NVIDIA H100 80GB HBM3 at 700 W
// (reduce_ms_per_call, 43% of the device's busy time): the one-hot
// product that aligns B to A's slots writes and reads an operand-sized
// copy, and the compensated sum's pairwise tree runs about eight
// tensor-wide torch operations per level, some 125 GB a TRS4 iteration
// for 11 GB of blocks.
//
// What bounds it on the H100: bytes, at 3.35 TB/s.  A dot reads each
// matched block of A and of B once (one operand once where A is B); a
// trace reads the bs diagonal elements of at most one block a row.  The
// arithmetic, one rounded product and one two-sum per element pair, is
// some 8 operations per 8 bytes in float32, far below the FP32 and FP64
// rates.
//
// Design: one pass over device memory, then one small combine.  Pass 1
// (slot_dot_rows, slot_trace_rows) runs a grid of a few CTAs per SM that
// walk the block rows.  For a dot row, one warp matches 32 of A's slot ids
// at a time against B's row (EMPTY anywhere, holes, ids in one operand
// only, any K), writes the matched (A slot, B slot) pairs to shared
// memory in slot order, and the CTA's threads stream those block pairs
// in 16-byte vectors, four in flight per operand and thread, through the
// streaming cache path.  Each product is rounded as PyTorch rounds it
// (__fmul_rn: no FMA contraction changes the summed values) and added to
// the thread's (hi, lo) by a two-sum.  For a trace row, a warp finds the
// slot whose id is the row's global index and sums its diagonal; no
// off-diagonal element is read.  Each CTA combines its threads' pairs by
// shuffles with two-sums and writes one pair to a scratch row.  Pass 2
// (finish_pairs, one CTA) combines the scratch rows in a fixed order into
// the result: the pair, or its value hi + lo in float64 (what TRS4's sigma
// needs: differences of sums near the electron count, which a float32
// rounding of each would blur).  No atomics, and the grid depends only on
// the row count and the SM count (the caller's scratch bound), so the bits
// are the same on every run, captured in a CUDA graph or not; the kernels
// allocate nothing and read no launch setting from the device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntp {
namespace red {

constexpr int kEmpty = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kAll = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// (hi, lo) += x: Knuth's two-sum puts the rounding error of hi + x in lo.
template <typename T>
__device__ __forceinline__ void two_sum_add(T& hi, T& lo, T x) {
  const T s = add_rn(hi, x);
  const T b = sub_rn(s, hi);
  const T e = add_rn(sub_rn(hi, sub_rn(s, b)), sub_rn(x, b));
  hi = s;
  lo = add_rn(lo, e);
}

// (hi, lo) += (h2, l2)
template <typename T>
__device__ __forceinline__ void pair_add(T& hi, T& lo, T h2, T l2) {
  two_sum_add(hi, lo, h2);
  lo = add_rn(lo, l2);
}

template <typename T>
__device__ __forceinline__ void warp_pair(T& hi, T& lo) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T h2 = __shfl_down_sync(kAll, hi, off);
    const T l2 = __shfl_down_sync(kAll, lo, off);
    pair_add(hi, lo, h2, l2);
  }
}

// The CTA's pairs combined in a fixed order; the total in thread 0.
template <typename T>
__device__ void block_pair(T& hi, T& lo) {
  __shared__ T part[2 * kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_pair(hi, lo);
  if (lane == 0) {
    part[2 * warp] = hi;
    part[2 * warp + 1] = lo;
  }
  __syncthreads();
  if (warp == 0) {
    hi = lane < kWarps ? part[2 * lane] : T(0);
    lo = lane < kWarps ? part[2 * lane + 1] : T(0);
    warp_pair(hi, lo);
  }
}

template <typename V, typename T>
__device__ __forceinline__ void add_products(T& hi, T& lo, const V& a,
                                             const V& b);
template <>
__device__ __forceinline__ void add_products(float& hi, float& lo,
                                             const float4& a,
                                             const float4& b) {
  two_sum_add(hi, lo, mul_rn(a.x, b.x));
  two_sum_add(hi, lo, mul_rn(a.y, b.y));
  two_sum_add(hi, lo, mul_rn(a.z, b.z));
  two_sum_add(hi, lo, mul_rn(a.w, b.w));
}
template <>
__device__ __forceinline__ void add_products(double& hi, double& lo,
                                             const double2& a,
                                             const double2& b) {
  two_sum_add(hi, lo, mul_rn(a.x, b.x));
  two_sum_add(hi, lo, mul_rn(a.y, b.y));
}

// Pass 1 of the dot: CTA c walks block rows c, c + grid, ...; rows with
// no matched pair cost one compare of their slot ids.  kSame: B is A
// (same storage, col ids and strides), every occupied slot matches
// itself and each block is loaded once.  Row strides a_cs, b_cs (ids)
// and a_bs, b_bs (elements); slots of a row lie bs * bs elements apart.
template <typename T, bool kSame>
__global__ void __launch_bounds__(kThreads)
    slot_dot_rows(const int* __restrict__ a_cols,
                  const T* __restrict__ a_blocks,
                  const int* __restrict__ b_cols,
                  const T* __restrict__ b_blocks, T* __restrict__ partial,
                  int64_t a_cs, int64_t a_bs, int64_t b_cs, int64_t b_bs,
                  int rows, int ka, int kb, int bs) {
  using V = typename Vec<T>::type;
  __shared__ int2 pairs[32];
  __shared__ int npairs;
  const int64_t blk = int64_t(bs) * bs;
  const int vecs = int(blk / Vec<T>::n);
  T hi = T(0), lo = T(0);
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int* ac = a_cols + r * a_cs;
    const int* bc = b_cols + r * b_cs;
    const T* ar = a_blocks + r * a_bs;
    const T* br = b_blocks + r * b_bs;
    for (int s0 = 0; s0 < ka; s0 += 32) {
      if (threadIdx.x < 32) {
        const int s = s0 + threadIdx.x;
        const int id = s < ka ? ac[s] : kEmpty;
        int t = -1;
        if (id != kEmpty) {
          if (kSame) {
            t = s;
          } else {
            for (int j = 0; j < kb; ++j) {
              if (bc[j] == id) {
                t = j;
                break;
              }
            }
          }
        }
        const unsigned hit = __ballot_sync(kAll, t >= 0);
        if (t >= 0)
          pairs[__popc(hit & ((1u << threadIdx.x) - 1u))] = make_int2(s, t);
        if (threadIdx.x == 0) npairs = __popc(hit);
      }
      __syncthreads();
      const int n = npairs * vecs;
      for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
        V av[kUnroll], bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n) {
            const int p = i / vecs;
            const int v = i - p * vecs;
            const int2 st = pairs[p];
            av[u] = __ldcs(reinterpret_cast<const V*>(ar + st.x * blk) + v);
            if (!kSame)
              bv[u] =
                  __ldcs(reinterpret_cast<const V*>(br + st.y * blk) + v);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u * kThreads < n)
            add_products(hi, lo, av[u], kSame ? av[u] : bv[u]);
        }
      }
      __syncthreads();
    }
  }
  block_pair(hi, lo);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = hi;
    partial[2 * blockIdx.x + 1] = lo;
  }
}

// Pass 1 of the trace: each warp takes block rows in turn; row r is the
// global block row row_offset + r % period, and only the diagonal of its
// diagonal block is read.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    slot_trace_rows(const int* __restrict__ cols,
                    const T* __restrict__ blocks, T* __restrict__ partial,
                    int64_t cs, int64_t bstride, int rows, int period,
                    int row_offset, int k, int bs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T hi = T(0), lo = T(0);
  for (int r = blockIdx.x * kWarps + warp; r < rows;
       r += gridDim.x * kWarps) {
    const int want = row_offset + r % period;
    const int* c = cols + r * cs;
    int slot = -1;
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int s = s0 + lane;
      const unsigned hit = __ballot_sync(kAll, s < k && c[s] == want);
      if (hit) {
        slot = s0 + __ffs(hit) - 1;
        break;
      }
    }
    if (slot >= 0) {
      const T* d = blocks + r * bstride + int64_t(slot) * bs * bs;
      for (int i = lane; i < bs; i += 32)
        two_sum_add(hi, lo, d[int64_t(i) * (bs + 1)]);
    }
  }
  block_pair(hi, lo);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = hi;
    partial[2 * blockIdx.x + 1] = lo;
  }
}

// Pass 2: the n scratch pairs combined in a fixed order; out gets the
// pair (hi, lo) as two T with hi the rounded sum (compensated), else its
// value hi + lo as one double.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    finish_pairs(const T* __restrict__ partial, int n, void* __restrict__ out,
                 int compensated) {
  T hi = T(0), lo = T(0);
  for (int i = threadIdx.x; i < n; i += kThreads)
    pair_add(hi, lo, partial[2 * i], partial[2 * i + 1]);
  block_pair(hi, lo);
  if (threadIdx.x == 0) {
    T sum = T(0), rest = T(0);
    two_sum_add(sum, rest, hi);
    two_sum_add(sum, rest, lo);
    if (compensated) {
      static_cast<T*>(out)[0] = sum;
      static_cast<T*>(out)[1] = rest;
    } else {
      *static_cast<double*>(out) = double(sum) + double(rest);
    }
  }
}

// CTAs of a first pass: one a unit of work, at most max_grid (the rows
// of the caller's scratch)
inline int grid_of(int units, int max_grid) {
  return units < max_grid ? (units > 0 ? units : 1) : max_grid;
}

template <typename T>
int dot(const void* a_cols, const void* a_blocks, const void* b_cols,
        const void* b_blocks, void* partial, void* out, int64_t a_cs,
        int64_t a_bs, int64_t b_cs, int64_t b_bs, int rows, int ka, int kb,
        int bs, int max_grid, int compensated, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(rows, max_grid);
  const auto* ac = static_cast<const int*>(a_cols);
  const auto* ab = static_cast<const T*>(a_blocks);
  const auto* bc = static_cast<const int*>(b_cols);
  const auto* bb = static_cast<const T*>(b_blocks);
  auto* part = static_cast<T*>(partial);
  const bool same = ab == bb && ac == bc && a_cs == b_cs && a_bs == b_bs &&
                    ka == kb;
  if (same)
    slot_dot_rows<T, true><<<grid, kThreads, 0, st>>>(
        ac, ab, bc, bb, part, a_cs, a_bs, b_cs, b_bs, rows, ka, kb, bs);
  else
    slot_dot_rows<T, false><<<grid, kThreads, 0, st>>>(
        ac, ab, bc, bb, part, a_cs, a_bs, b_cs, b_bs, rows, ka, kb, bs);
  finish_pairs<T><<<1, kThreads, 0, st>>>(part, grid, out, compensated);
  return int(cudaGetLastError());
}

template <typename T>
int trace(const void* cols, const void* blocks, void* partial, void* out,
          int64_t cs, int64_t bstride, int rows, int period, int row_offset,
          int k, int bs, int max_grid, int compensated, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = grid_of((rows + kWarps - 1) / kWarps, max_grid);
  auto* part = static_cast<T*>(partial);
  slot_trace_rows<T><<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(cols), static_cast<const T*>(blocks), part, cs,
      bstride, rows, period, row_offset, k, bs);
  finish_pairs<T><<<1, kThreads, 0, st>>>(part, grid, out, compensated);
  return int(cudaGetLastError());
}

}  // namespace red
}  // namespace ntp

extern "C" {

// sum over matched slots of A [rows, ka, bs, bs] * B [rows, kb, bs, bs]
// (rows of col ids and blocks ``*_cs`` and ``*_bs`` elements apart):
// pass 1 writes one pair a CTA, at most ``max_grid``, to ``partial``
// [max_grid, 2]; pass 2 writes ``out``: [2] (hi, lo) of the blocks' type
// when ``compensated``, else one double, hi + lo.
int ntp_slot_dot_f32(const void* a_cols, const void* a_blocks,
                     const void* b_cols, const void* b_blocks, void* partial,
                     void* out, long long a_cs, long long a_bs,
                     long long b_cs, long long b_bs, int rows, int ka,
                     int kb, int bs, int max_grid, int compensated,
                     void* stream) {
  return ntp::red::dot<float>(a_cols, a_blocks, b_cols, b_blocks, partial,
                              out, a_cs, a_bs, b_cs, b_bs, rows, ka, kb, bs,
                              max_grid, compensated, stream);
}

int ntp_slot_dot_f64(const void* a_cols, const void* a_blocks,
                     const void* b_cols, const void* b_blocks, void* partial,
                     void* out, long long a_cs, long long a_bs,
                     long long b_cs, long long b_bs, int rows, int ka,
                     int kb, int bs, int max_grid, int compensated,
                     void* stream) {
  return ntp::red::dot<double>(a_cols, a_blocks, b_cols, b_blocks, partial,
                               out, a_cs, a_bs, b_cs, b_bs, rows, ka, kb,
                               bs, max_grid, compensated, stream);
}

// the diagonal of the slot whose col id is row_offset + r % period, for
// each block row r of [rows, k, bs, bs]; ``out`` as for the dot.
int ntp_slot_trace_f32(const void* cols, const void* blocks, void* partial,
                       void* out, long long cs, long long bstride, int rows,
                       int period, int row_offset, int k, int bs,
                       int max_grid, int compensated, void* stream) {
  return ntp::red::trace<float>(cols, blocks, partial, out, cs, bstride,
                                rows, period, row_offset, k, bs, max_grid,
                                compensated, stream);
}

int ntp_slot_trace_f64(const void* cols, const void* blocks, void* partial,
                       void* out, long long cs, long long bstride, int rows,
                       int period, int row_offset, int k, int bs,
                       int max_grid, int compensated, void* stream) {
  return ntp::red::trace<double>(cols, blocks, partial, out, cs, bstride,
                                 rows, period, row_offset, k, bs, max_grid,
                                 compensated, stream);
}

}  // extern "C"
