// The compact of a block-ELL product for Hopper (sm_90a): each block row's
// M candidate slots cut to k_out, as core/bell.py's ``compact`` does.
// Entries with |v| <= threshold flush to +0; a slot is occupied when its
// flushed L1 norm is > 0 and its col id is not EMPTY; the k_out occupied
// slots of largest norm are kept (a tie keeps the lower slot), then
// unoccupied slots in slot order where fewer are occupied, each such
// block multiplied by 0 (EMPTY, its zeros signed as the plain product's);
// the kept slots are ordered by col id, EMPTY last.  M < k_out pads with
// EMPTY zero blocks.
//
// Replaces no TPU kernel: the reference's compact is plain jnp in
// ntpoly_tpu/core/bell.py (``compact``), which XLA fuses on the TPU.
//
// Why it was added: the full-span band multiply's compact to k_out
// (parallel/algebra.py ``_summa``) took 279 ms of a 2^20-row TRS4 call on
// an NVIDIA H100 80GB HBM3 at 700 W (compact_ms_per_call), 45% of the
// call: its plain PyTorch version moves the candidates about eight times
// (abs, compare, where, abs and sum for the norms, the slot gather, the
// occupancy product), some 57 GB a compact for 4.83 GB of candidates.
//
// What bounds it on the H100: bytes, at 3.35 TB/s.  The candidates are
// read once for their norms, the kept blocks read again and written once:
// at 8192 block rows, 9 slots, bs 128 and float32, 4.83 + 2.68 + 2.68 GB,
// 3.04 ms (one pass that kept a row's blocks until they were written
// would need 2.24 ms; a cluster of CTAs a row holding them in shared
// memory took 2.90 ms against these kernels' 3.42 ms on an NVIDIA H100
// 80GB HBM3 at 700 W, 7 ms of a 2^20-row TRS4 call of some 370, for a
// limit on M and a cluster shape to tune).  The arithmetic, a compare and an add an element, is far below
// the FP32 rate.
//
// Design: three launches, a warp a unit of work, no limit on M or k_out.
//   1. block_norms: a warp a candidate block streams it in 16-byte
//      vectors, flushes and sums |v| in float64 (29 bits beyond float32's,
//      so the order of the sum hardly moves a float32 block's norm);
//      blocks under EMPTY col ids are not read.
//   2. rank_rows: a warp a block row ranks its max(M, k_out) slots by
//      (-norm, slot), occupied first, keeps k_out, orders them by (col id,
//      rank) and writes the col ids and, for each output slot, its source
//      slot and whether it is occupied.
//   3. gather_rows: a warp an output block copies its source, flushed and
//      multiplied by its occupancy (1 or 0, as the plain version does), or
//      writes zeros for the padding.
// The kept blocks are read twice from device memory: the norms of a whole
// product are needed before any row is ranked, and the first pass streams
// far more than the 50 MB L2.  The sums run in a fixed order, so the bits
// are the same on every run, captured in a CUDA graph or not.  The
// kernels allocate nothing: the caller passes the scratch (norms, places,
// sources).
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntp {
namespace cmp {

constexpr int kEmpty = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;
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

__device__ __forceinline__ float flush(float v, float t) {
  return fabsf(v) > t ? v : 0.0f;
}
__device__ __forceinline__ double flush(double v, double t) {
  return fabs(v) > t ? v : 0.0;
}

// v flushed in place; -> the sum of its |v| in float64
__device__ __forceinline__ double flush_sum(float4& v, float t) {
  v.x = flush(v.x, t);
  v.y = flush(v.y, t);
  v.z = flush(v.z, t);
  v.w = flush(v.w, t);
  return (double(fabsf(v.x)) + double(fabsf(v.y))) +
         (double(fabsf(v.z)) + double(fabsf(v.w)));
}
__device__ __forceinline__ double flush_sum(double2& v, double t) {
  v.x = flush(v.x, t);
  v.y = flush(v.y, t);
  return fabs(v.x) + fabs(v.y);
}

// v flushed, then multiplied by f (1 or 0) rounding to nearest
__device__ __forceinline__ float4 flush_scale(float4 v, float t, float f) {
  return make_float4(
      __fmul_rn(flush(v.x, t), f), __fmul_rn(flush(v.y, t), f),
      __fmul_rn(flush(v.z, t), f), __fmul_rn(flush(v.w, t), f));
}
__device__ __forceinline__ double2 flush_scale(double2 v, double t,
                                               double f) {
  return make_double2(__dmul_rn(flush(v.x, t), f),
                      __dmul_rn(flush(v.y, t), f));
}

template <typename V>
__device__ __forceinline__ V zeros();
template <>
__device__ __forceinline__ float4 zeros<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ double2 zeros<double2>() {
  return make_double2(0.0, 0.0);
}

// The global warp index of this thread.
__device__ __forceinline__ int64_t warp_id() {
  return (int64_t(blockIdx.x) * kThreads + threadIdx.x) / 32;
}

// 1. norms[r * m + s]: the flushed L1 norm of block s of row r, in float64
// (col ids of row r start ``cs`` apart, its blocks ``bstride`` elements
// apart, slots bs * bs apart); 0 under an EMPTY col id, whose block is
// never read: such a slot is unoccupied whatever its norm.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_norms(const int* __restrict__ cols, const T* __restrict__ blocks,
                double* __restrict__ norms, int64_t cs, int64_t bstride,
                int rows, int m, int bs, double threshold) {
  using V = typename Vec<T>::type;
  const int64_t w = warp_id();
  if (w >= int64_t(rows) * m) return;
  const int lane = threadIdx.x % 32;
  const int64_t row = w / m;
  const int s = int(w % m);
  if (cols[row * cs + s] == kEmpty) {
    if (lane == 0) norms[w] = 0.0;
    return;
  }
  const int vecs = bs * bs / Vec<T>::n;
  const T t = T(threshold);
  const V* src = reinterpret_cast<const V*>(blocks + row * bstride +
                                            int64_t(s) * bs * bs);
  double acc = 0.0;
  for (int i0 = lane; i0 < vecs; i0 += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < vecs) v[u] = __ldcs(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * 32 < vecs) acc += flush_sum(v[u], t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(kAll, acc, off);
  if (lane == 0) norms[w] = acc;
}

// 2. A warp a row: place[r * mp + s] the slot's place in the order
// (occupied by -norm, then the rest; ties by slot), mp = max(m, k_out)
// (slots from m on are the padding's EMPTY zero blocks); for each kept
// slot (place < k_out) its output slot o by (col id, place): out_cols[r *
// k_out + o] its col id (EMPTY unless occupied), source[r * k_out + o] the
// slot s if occupied, else -1 - s.
__global__ void __launch_bounds__(kThreads)
    rank_rows(const int* __restrict__ cols, const double* __restrict__ norms,
              int* place, int* __restrict__ source,
              int* __restrict__ out_cols, int64_t cs, int rows, int m,
              int k_out) {
  const int64_t row = warp_id();
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int mp = m > k_out ? m : k_out;
  const int* c = cols + row * cs;
  const double* nrm = norms + row * m;
  int* pl = place + row * mp;
  auto norm = [&](int s) { return s < m ? nrm[s] : 0.0; };
  auto occupied = [&](int s) {
    return s < m && nrm[s] > 0.0 && c[s] != kEmpty;
  };
  for (int s = lane; s < mp; s += 32) {
    const double ns = norm(s);
    const bool os = occupied(s);
    int p = 0;
    for (int q = 0; q < mp; ++q) {
      const double nq = norm(q);
      p += occupied(q) ? (!os || nq > ns || (nq == ns && q < s))
                       : (!os && q < s);
    }
    pl[s] = p;
  }
  __syncwarp();
  for (int s = lane; s < mp; s += 32) {
    const int p = pl[s];
    if (p >= k_out) continue;
    const bool os = occupied(s);
    const int key = os ? c[s] : kEmpty;
    int o = 0;
    for (int q = 0; q < mp; ++q) {
      const int pq = pl[q];
      const int kq = occupied(q) ? c[q] : kEmpty;
      o += pq < k_out && (kq < key || (kq == key && pq < p));
    }
    out_cols[row * k_out + o] = key;
    source[row * k_out + o] = os ? s : -1 - s;
  }
}

// 3. A warp an output block (r, o) of the dense [rows, k_out, bs, bs]
// output: its source block flushed and multiplied by its occupancy, or
// zeros for a padding slot (s >= m).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const T* __restrict__ blocks, const int* __restrict__ source,
                T* __restrict__ out_blocks, int64_t bstride, int rows, int m,
                int k_out, int bs, double threshold) {
  using V = typename Vec<T>::type;
  const int64_t w = warp_id();
  if (w >= int64_t(rows) * k_out) return;
  const int lane = threadIdx.x % 32;
  const int64_t row = w / k_out;
  const int e = source[w];
  const int s = e >= 0 ? e : -1 - e;
  const T f = e >= 0 ? T(1) : T(0);
  const int vecs = bs * bs / Vec<T>::n;
  const T t = T(threshold);
  V* out = reinterpret_cast<V*>(out_blocks + w * bs * bs);
  if (s >= m) {
    for (int i = lane; i < vecs; i += 32) out[i] = zeros<V>();
    return;
  }
  const V* src = reinterpret_cast<const V*>(blocks + row * bstride +
                                            int64_t(s) * bs * bs);
  for (int i0 = lane; i0 < vecs; i0 += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < vecs) v[u] = __ldcs(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * 32;
      if (i < vecs) out[i] = flush_scale(v[u], t, f);
    }
  }
}

inline unsigned grid_for(int64_t warps) {
  return unsigned((warps + kWarps - 1) / kWarps);
}

template <typename T>
int compact(const void* cols, const void* blocks, void* out_cols,
            void* out_blocks, void* norms, void* place, void* source,
            int64_t cs, int64_t bstride, int rows, int m, int k_out, int bs,
            double threshold, void* stream) {
  if (rows <= 0 || k_out <= 0) return 0;
  if (m < 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > 0)
    block_norms<T><<<grid_for(int64_t(rows) * m), kThreads, 0, st>>>(
        static_cast<const int*>(cols), static_cast<const T*>(blocks),
        static_cast<double*>(norms), cs, bstride, rows, m, bs, threshold);
  rank_rows<<<grid_for(rows), kThreads, 0, st>>>(
      static_cast<const int*>(cols), static_cast<const double*>(norms),
      static_cast<int*>(place), static_cast<int*>(source),
      static_cast<int*>(out_cols), cs, rows, m, k_out);
  gather_rows<T><<<grid_for(int64_t(rows) * k_out), kThreads, 0, st>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(source),
      static_cast<T*>(out_blocks), bstride, rows, m, k_out, bs, threshold);
  return int(cudaGetLastError());
}

}  // namespace cmp
}  // namespace ntp

extern "C" {

// [rows, m] col ids and [rows, m, bs, bs] blocks (rows ``cs`` and
// ``bstride`` elements apart, 16-byte aligned) compacted to ``k_out``
// slots into dense [rows, k_out] and [rows, k_out, bs, bs]; scratch:
// ``norms`` float64 [rows, m], ``place`` int32 [rows, max(m, k_out)],
// ``source`` int32 [rows, k_out].  Three launches on ``stream``.
int ntp_slot_compact_f32(const void* cols, const void* blocks,
                         void* out_cols, void* out_blocks, void* norms,
                         void* place, void* source, long long cs,
                         long long bstride, int rows, int m, int k_out,
                         int bs, double threshold, void* stream) {
  return ntp::cmp::compact<float>(cols, blocks, out_cols, out_blocks, norms,
                                  place, source, cs, bstride, rows, m, k_out,
                                  bs, threshold, stream);
}

int ntp_slot_compact_f64(const void* cols, const void* blocks,
                         void* out_cols, void* out_blocks, void* norms,
                         void* place, void* source, long long cs,
                         long long bstride, int rows, int m, int k_out,
                         int bs, double threshold, void* stream) {
  return ntp::cmp::compact<double>(cols, blocks, out_cols, out_blocks, norms,
                                   place, source, cs, bstride, rows, m,
                                   k_out, bs, threshold, stream);
}

}  // extern "C"
