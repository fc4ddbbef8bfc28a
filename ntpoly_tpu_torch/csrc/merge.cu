// The k-way merge of block-ELL operands for Hopper (sm_90a): sum_i c_i *
// M_i over at most four operands into k_out slots, as core/bell.py's
// ``add_n`` gives it.  The candidates of a block row are every operand's
// slots side by side (holes and ids held by several operands included);
// output slot j takes the j-th smallest distinct non-EMPTY candidate id
// (on overflow the lowest k_out ids are kept), and its block is the sum of
// c_i * block over the candidates that carry that id, each product
// rounded to the result dtype.  Entries with -threshold <= v <= threshold
// flush to +0; a slot whose flushed block has no L1 norm > 0 turns EMPTY
// in place; slots past the distinct count are EMPTY with zero blocks.  An
// operand whose coefficient is 0 still enters the union.
//
// Replaces no TPU kernel: the reference's k-way merge is plain jnp in
// ntpoly_tpu/core/bell.py (``merge`` and ``add_n``), which XLA fuses on
// the TPU.
//
// Why it was added: the plain PyTorch merge (core/bell.py) took 190 ms of
// a 2^20-row TRS4 call on an NVIDIA H100 80GB HBM3 at 700 W
// (increment_ms_per_call, about half the call): every operand scaled into
// a concatenated copy, the ranks as [R, M, M] comparisons, the sum as a
// one-hot batched product, three elementwise passes for the flush and an
// L1 norm, then a sort for the fill, in row passes of 1 GiB.
//
// What bounds it on the H100: bytes, at 3.35 TB/s.  The merge reads each
// occupied candidate block once and writes each output block once: at
// 8192 block rows of 5 + 5 + 1 candidates to 5 slots, bs 128, float32,
// at most 16 blocks of 64 KiB a row, 8.6 GB, 2.56 ms.  The arithmetic, a
// product, a sum and a compare an element, is far below the FP32 rate.
//
// Design: one launch, a CTA an output block (block row, output slot), no
// temporary.  The CTA loads its row's W candidate ids into shared memory
// (any W), marks each id's first occurrence and ranks the distinct ids by
// W^2 compares, so that it knows its slot's id, or that the slot is
// padding.  Its threads then stream the candidates that carry the id, in
// candidate order, in 16-byte vectors, four in flight a thread, through
// the streaming cache path; each product is rounded as PyTorch rounds it
// (__fmul_rn, __fadd_rn: no FMA contraction) and summed in registers
// from +0, then flushed and stored once.  One block-wide vote on the
// flushed values (any NaN, any nonzero) decides the slot's col id, as
// vector_norm(block, 1) > 0 does.  The CTA of slot 0 also folds its row's
// distinct count (the structural fill) into stats[0], and every occupied
// slot its index + 1 into stats[1], by atomicMax (a maximum: the same on
// every run).  Each operand keeps its own row strides, so a capacity
// trim's view is read in place, and each coefficient is a kernel argument
// or a device scalar in the result dtype read by the kernel, so a merge
// whose coefficients live on the device needs no host read and is
// captured in a CUDA graph.  The sums run in a fixed order, so the bits
// are the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntp {
namespace mrg {

constexpr int kEmpty = 1 << 30;
constexpr int kMaxOps = 4;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// dynamic shared memory a CTA takes without opting in
constexpr int kDefaultSmem = 48 * 1024;

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

// The operands of one merge: operand i's col ids of row r start at
// cols[i] + r * cs[i], its blocks at blocks[i] + r * bstride[i] (slots bs *
// bs elements apart); its coefficient is *coef_at[i] where that is not
// null, else coef[i] rounded to T.
template <typename T>
struct Operands {
  const int* cols[kMaxOps];
  const T* blocks[kMaxOps];
  const T* coef_at[kMaxOps];
  long long cs[kMaxOps];
  long long bstride[kMaxOps];
  double coef[kMaxOps];
  int m[kMaxOps];
  int n;
};

__device__ __forceinline__ void add_scaled(float4& acc, float4 v, float c) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, c));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, c));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, c));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, c));
}
__device__ __forceinline__ void add_scaled(double2& acc, double2 v,
                                           double c) {
  acc.x = __dadd_rn(acc.x, __dmul_rn(v.x, c));
  acc.y = __dadd_rn(acc.y, __dmul_rn(v.y, c));
}

// v flushed to +0 where -t <= v <= t; nan and nonzero note what is left
template <typename T>
__device__ __forceinline__ T flush(T v, T t, bool& nan, bool& nonzero) {
  const T f = (v <= t && v >= -t) ? T(0) : v;
  nan |= f != f;
  nonzero |= f != T(0);
  return f;
}
__device__ __forceinline__ void flush(float4& v, float t, bool& nan,
                                      bool& nonzero) {
  v.x = flush(v.x, t, nan, nonzero);
  v.y = flush(v.y, t, nan, nonzero);
  v.z = flush(v.z, t, nan, nonzero);
  v.w = flush(v.w, t, nan, nonzero);
}
__device__ __forceinline__ void flush(double2& v, double t, bool& nan,
                                      bool& nonzero) {
  v.x = flush(v.x, t, nan, nonzero);
  v.y = flush(v.y, t, nan, nonzero);
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

// candidate t of a row -> its operand (op) and slot (s), by the operands'
// widths m
__device__ __forceinline__ void locate(const int* m, int t, int& op,
                                       int& s) {
  op = 0;
  s = t;
  while (s >= m[op]) s -= m[op++];
}

// The maximum of *at and v, where v may raise it (a plain read first:
// most CTAs find the maximum already there and skip the atomic).
__device__ __forceinline__ void raise_to(int* at, int v) {
  if (v > *reinterpret_cast<volatile int*>(at)) atomicMax(at, v);
}

// A CTA an output block: unit = row * k_out + j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_rows(Operands<T> a, int* __restrict__ out_cols,
               T* __restrict__ out_blocks, int* __restrict__ stats, int w,
               int k_out, int bs, double threshold) {
  using V = typename Vec<T>::type;
  extern __shared__ int smem[];
  int* ids = smem;      // [w] the row's candidate ids
  int* key = smem + w;  // [w] an id at its first occurrence, else EMPTY
  // operand i of this row: its col ids, blocks, width and coefficient
  __shared__ const int* cols[kMaxOps];
  __shared__ const T* blocks[kMaxOps];
  __shared__ int m[kMaxOps];
  __shared__ T coef[kMaxOps];
  __shared__ int target, fill;
  const int64_t unit = blockIdx.x;
  const int64_t row = unit / k_out;
  const int j = int(unit % k_out);
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kMaxOps; ++i) {
      const bool in = i < a.n;
      cols[i] = in ? a.cols[i] + row * a.cs[i] : nullptr;
      blocks[i] = in ? a.blocks[i] + row * a.bstride[i] : nullptr;
      m[i] = in ? a.m[i] : 0;
      coef[i] = !in ? T(0) : a.coef_at[i] ? *a.coef_at[i] : T(a.coef[i]);
    }
    target = kEmpty;
    fill = 0;
  }
  __syncthreads();
  for (int t = tid; t < w; t += kThreads) {
    int op, s;
    locate(m, t, op, s);
    ids[t] = cols[op][s];
  }
  __syncthreads();
  for (int t = tid; t < w; t += kThreads) {
    const int c = ids[t];
    bool first = c != kEmpty;
    for (int q = 0; q < t && first; ++q) first = ids[q] != c;
    key[t] = first ? c : kEmpty;
  }
  __syncthreads();
  int distinct = 0;
  for (int t = tid; t < w; t += kThreads) {
    const int c = key[t];
    if (c == kEmpty) continue;
    ++distinct;
    int rank = 0;
    for (int q = 0; q < w; ++q) rank += key[q] != kEmpty && key[q] < c;
    if (rank == j) target = c;
  }
  if (j == 0 && distinct) atomicAdd(&fill, distinct);
  __syncthreads();
  if (j == 0 && tid == 0 && fill) raise_to(stats, fill);

  const int id = target;
  const int vecs = bs * bs / Vec<T>::n;
  V* out = reinterpret_cast<V*>(out_blocks + unit * bs * bs);
  if (id == kEmpty) {
    for (int i = tid; i < vecs; i += kThreads) out[i] = zeros<V>();
    if (tid == 0) out_cols[unit] = kEmpty;
    return;
  }
  const T t = T(threshold);
  bool nan = false, nonzero = false;
  for (int i0 = tid; i0 < vecs; i0 += kThreads * kUnroll) {
    V acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = zeros<V>();
    for (int c = 0; c < w; ++c) {
      if (ids[c] != id) continue;
      int op, s;
      locate(m, c, op, s);
      const V* src =
          reinterpret_cast<const V*>(blocks[op] + int64_t(s) * bs * bs);
      const T f = coef[op];
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < vecs) v[u] = __ldcs(src + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kThreads < vecs) add_scaled(acc[u], v[u], f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < vecs) {
        flush(acc[u], t, nan, nonzero);
        out[i] = acc[u];
      }
    }
  }
  nan = __syncthreads_or(nan);
  nonzero = __syncthreads_or(nonzero);
  if (tid == 0) {
    const bool occupied = nonzero && !nan;
    out_cols[unit] = occupied ? id : kEmpty;
    if (occupied) raise_to(stats + 1, j + 1);
  }
}

template <typename T>
int merge(const Operands<T>& a, void* out_cols, void* out_blocks,
          void* stats, int rows, int k_out, int bs, double threshold,
          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = int(cudaMemsetAsync(stats, 0, 2 * sizeof(int), st));
  if (err || rows <= 0) return err;
  if (a.n < 1 || a.n > kMaxOps || k_out <= 0)
    return int(cudaErrorInvalidValue);
  int64_t w = 0;
  for (int i = 0; i < a.n; ++i) {
    if (a.m[i] < 0) return int(cudaErrorInvalidValue);
    w += a.m[i];
  }
  const int64_t units = int64_t(rows) * k_out;
  const size_t smem = size_t(2 * w) * sizeof(int);
  if (units > 0x7fffffff || w > (1 << 24))
    return int(cudaErrorInvalidValue);
  if (smem > size_t(kDefaultSmem)) {
    err = int(cudaFuncSetAttribute(
        merge_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem)));
    if (err) return err;
  }
  merge_rows<T><<<unsigned(units), kThreads, smem, st>>>(
      a, static_cast<int*>(out_cols), static_cast<T*>(out_blocks),
      static_cast<int*>(stats), int(w), k_out, bs, threshold);
  return int(cudaGetLastError());
}

template <typename T>
int merge_entry(const void* c0, const void* c1, const void* c2,
                const void* c3, const void* b0, const void* b1,
                const void* b2, const void* b3, const void* f0,
                const void* f1, const void* f2, const void* f3,
                void* out_cols, void* out_blocks, void* stats, long long cs0,
                long long cs1, long long cs2, long long cs3, long long bt0,
                long long bt1, long long bt2, long long bt3, int m0, int m1,
                int m2, int m3, int n, int rows, int k_out, int bs,
                double a0, double a1, double a2, double a3,
                double threshold, void* stream) {
  Operands<T> a = {
      {static_cast<const int*>(c0), static_cast<const int*>(c1),
       static_cast<const int*>(c2), static_cast<const int*>(c3)},
      {static_cast<const T*>(b0), static_cast<const T*>(b1),
       static_cast<const T*>(b2), static_cast<const T*>(b3)},
      {static_cast<const T*>(f0), static_cast<const T*>(f1),
       static_cast<const T*>(f2), static_cast<const T*>(f3)},
      {cs0, cs1, cs2, cs3},
      {bt0, bt1, bt2, bt3},
      {a0, a1, a2, a3},
      {m0, m1, m2, m3},
      n};
  return merge<T>(a, out_cols, out_blocks, stats, rows, k_out, bs,
                  threshold, stream);
}

}  // namespace mrg
}  // namespace ntp

extern "C" {

// n (1 to 4) operands, operand i [rows, m_i] col ids at c_i (rows cs_i
// elements apart) and [rows, m_i, bs, bs] blocks at b_i (rows bt_i
// elements apart, 16-byte aligned), its coefficient the device scalar at
// f_i or, where f_i is null, a_i; merged into dense [rows, k_out] col ids
// and [rows, k_out, bs, bs] blocks, and int32[2] stats (the largest fill
// and used slot count of a row).  A memset and one launch on ``stream``.
int ntp_slot_add_n_f32(const void* c0, const void* c1, const void* c2,
                       const void* c3, const void* b0, const void* b1,
                       const void* b2, const void* b3, const void* f0,
                       const void* f1, const void* f2, const void* f3,
                       void* out_cols, void* out_blocks, void* stats,
                       long long cs0, long long cs1, long long cs2,
                       long long cs3, long long bt0, long long bt1,
                       long long bt2, long long bt3, int m0, int m1, int m2,
                       int m3, int n, int rows, int k_out, int bs, double a0,
                       double a1, double a2, double a3, double threshold,
                       void* stream) {
  return ntp::mrg::merge_entry<float>(
      c0, c1, c2, c3, b0, b1, b2, b3, f0, f1, f2, f3, out_cols, out_blocks,
      stats, cs0, cs1, cs2, cs3, bt0, bt1, bt2, bt3, m0, m1, m2, m3, n, rows,
      k_out, bs, a0, a1, a2, a3, threshold, stream);
}

int ntp_slot_add_n_f64(const void* c0, const void* c1, const void* c2,
                       const void* c3, const void* b0, const void* b1,
                       const void* b2, const void* b3, const void* f0,
                       const void* f1, const void* f2, const void* f3,
                       void* out_cols, void* out_blocks, void* stats,
                       long long cs0, long long cs1, long long cs2,
                       long long cs3, long long bt0, long long bt1,
                       long long bt2, long long bt3, int m0, int m1, int m2,
                       int m3, int n, int rows, int k_out, int bs, double a0,
                       double a1, double a2, double a3, double threshold,
                       void* stream) {
  return ntp::mrg::merge_entry<double>(
      c0, c1, c2, c3, b0, b1, b2, b3, f0, f1, f2, f3, out_cols, out_blocks,
      stats, cs0, cs1, cs2, cs3, bt0, bt1, bt2, bt3, m0, m1, m2, m3, n, rows,
      k_out, bs, a0, a1, a2, a3, threshold, stream);
}

}  // extern "C"
