// Shared pieces of the block SpGEMM kernels: the exact tier of all of
// them (spgemm_general.cu, spgemm_band.cu, spgemm_stream.cu,
// spgemm_window.cu, spgemm_uniform.cu), and at the end of the file the
// mma.sync pieces of the uniform kernel's tensor-core tiers (the band and
// general kernels' tensor-core product is in tc.cuh).  A thread block
// accumulates products of bs x bs blocks (bs a multiple of 8, at most
// 128) into one output block held in registers, staging k-chunks of
// both operands through shared memory.  The epilogue is the reference's
// prune step: scale by alpha, flush |v| <= threshold to zero, store,
// and write the block's L1 norm.
//
// Layout: TS x TS output tile (TS = 16, 32, 64 or 128, the smallest
// that covers bs), 256 threads as a 16 x 16 grid, each thread holding a
// TM x TM micro-tile (TM = TS / 16) at rows ty + 16 i and columns
// tx + 16 j.  That strided assignment keeps the shared-memory reads of
// a warp conflict-free (B) or broadcast (A), and the output stores
// coalesced.  Rows and columns at or beyond bs are masked: their
// staged operands are zero and they are never stored.
//
// Staging: pipelined_outputs runs a two-stage cp.async ring so that the
// next chunk is in flight while the current one is multiplied.  Every
// kernel adds the products of an output block in the same order
// (products in turn, k ascending, one fma per k), so they give the same
// bits for the same products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntp {

constexpr int kEmpty = 1 << 30;
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // depth of one staged k-chunk

template <typename T, int TS>
struct Acc {
  static constexpr int TM = TS / 16;
  T v[TM][TM];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) v[i][j] = T(0);
  }
};

// Block-wide sum of one value per thread; every thread gets the total.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    red[0] = total;
  }
  __syncthreads();
  return red[0];
}

// The prune epilogue: out = flush(alpha * acc), *norm = sum |out|.
template <typename T, int TS>
__device__ __forceinline__ void store_pruned(const Acc<T, TS>& acc,
                                             T* __restrict__ out,
                                             T* __restrict__ norm, int bs,
                                             T alpha, T threshold, T* red) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T part = T(0);
#pragma unroll
  for (int i = 0; i < Acc<T, TS>::TM; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < Acc<T, TS>::TM; ++j) {
      const int col = tx + 16 * j;
      if (row < bs && col < bs) {
        T x = acc.v[i][j] * alpha;
        x = fabs(x) > threshold ? x : T(0);
        out[row * bs + col] = x;
        part += fabs(x);
      }
    }
  }
  const T total = block_sum(part, red);
  if (threadIdx.x == 0) *norm = total;
}

// Zero output block with zero norm.
template <typename T>
__device__ __forceinline__ void store_zero(T* __restrict__ out,
                                           T* __restrict__ norm, int bs) {
  for (int i = threadIdx.x; i < bs * bs; i += kThreads) out[i] = T(0);
  if (threadIdx.x == 0) *norm = T(0);
}

// The prune epilogue with per-column norms (spgemm_uniform.cu): out =
// flush(alpha * acc), norms[c] = sum over rows of |out[row][c]|, c < bs.
// red holds kThreads / 32 * TS values.
template <typename T, int TS>
__device__ __forceinline__ void store_pruned_cols(const Acc<T, TS>& acc,
                                                  T* __restrict__ out,
                                                  T* __restrict__ norms,
                                                  int bs, T alpha,
                                                  T threshold, T* red) {
  constexpr int TM = Acc<T, TS>::TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T part[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) part[j] = T(0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int col = tx + 16 * j;
      if (row < bs && col < bs) {
        T x = acc.v[i][j] * alpha;
        x = fabs(x) > threshold ? x : T(0);
        out[row * bs + col] = x;
        part[j] += fabs(x);
      }
    }
  }
  // a warp holds rows ty = 2 warp and 2 warp + 1: lanes l and l ^ 16
  // share a column
#pragma unroll
  for (int j = 0; j < TM; ++j)
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 16);
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < TM; ++j) red[warp * TS + tx + 16 * j] = part[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < bs; c += kThreads) {
    T sum = T(0);
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w * TS + c];
    norms[c] = sum;
  }
  __syncthreads();  // red is reused by the next output
}

// Zero output block with zero column norms.
template <typename T>
__device__ __forceinline__ void store_zero_cols(T* __restrict__ out,
                                                T* __restrict__ norms,
                                                int bs) {
  for (int i = threadIdx.x; i < bs * bs; i += kThreads) out[i] = T(0);
  for (int c = threadIdx.x; c < bs; c += kThreads) norms[c] = T(0);
}

// Largest tile that a bs x bs block needs: 16, 32, 64 or 128.
inline int tile_for(int bs) {
  return bs <= 16 ? 16 : bs <= 32 ? 32 : bs <= 64 ? 64 : 128;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (needed
// above 48 KB) -> cudaError_t.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// ---------------------------------------------------------------------------
// the cp.async ring
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, asynchronously; !valid writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One staged k-chunk of both operands, in the operands' own type.  A is
// kept row-major (cp.async cannot transpose), each row padded by one
// 16-byte vector; a warp reads two of its rows at a time, which the
// padding puts in different banks.
template <typename Tin, int TS>
struct Stage {
  static constexpr int kVec = 16 / sizeof(Tin);  // elements per copy
  static constexpr int kLdA = kChunk + kVec;
  Tin a[TS][kLdA];    // a[m][k] = A[m][k0 + k]
  Tin b[kChunk][TS];  // b[k][n] = B[k0 + k][n]
};

// Start the copies of k-chunk k0 of A (bs x bs, row stride bs) and of B
// (bs x bs, row stride ldb) into st.  bs is a multiple of 8 and each
// copy is 16 bytes of at most 8 elements, so a copy lies wholly inside
// or wholly outside the block; outside ones are zero-filled.
template <typename Tin, int TS>
__device__ __forceinline__ void stage_chunk(Stage<Tin, TS>& st,
                                            const Tin* __restrict__ a,
                                            const Tin* __restrict__ b,
                                            int ldb, int bs, int k0) {
  constexpr int V = Stage<Tin, TS>::kVec;
  constexpr int kRowA = kChunk / V;  // copies per row of the A chunk
  for (int i = threadIdx.x; i < TS * kRowA; i += kThreads) {
    const int m = i / kRowA, k = (i % kRowA) * V;
    const bool ok = m < bs && k0 + k < bs;
    cp_async16(&st.a[m][k], ok ? a + m * bs + k0 + k : a, ok);
  }
  constexpr int kRowB = TS / V;      // copies per row of the B chunk
  for (int i = threadIdx.x; i < kChunk * kRowB; i += kThreads) {
    const int k = i / kRowB, n = (i % kRowB) * V;
    const bool ok = n < bs && k0 + k < bs;
    cp_async16(&st.b[k][n], ok ? b + int64_t(k0 + k) * ldb + n : b, ok);
  }
}

// acc += the staged chunk's product, widened to the accumulator type.
template <typename Tin, typename T, int TS>
__device__ __forceinline__ void mac_staged(Acc<T, TS>& acc,
                                           const Stage<Tin, TS>& st) {
  constexpr int TM = Acc<T, TS>::TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    T ra[TM], rb[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ra[i] = widen(st.a[ty + 16 * i][k]);
#pragma unroll
    for (int j = 0; j < TM; ++j) rb[j] = widen(st.b[k][tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        acc.v[i][j] = fma(ra[i], rb[j], acc.v[i][j]);
  }
}

// Dynamic shared memory of the ring: two stages.
template <typename Tin, int TS>
constexpr int ring_bytes() {
  return 2 * static_cast<int>(sizeof(Stage<Tin, TS>));
}

// Compute n_out output blocks in turn through the two-stage ring: the
// chunk after the current one, of the same product, of the next
// product, or of the next output block's first product, is in flight
// while the current chunk is multiplied.  Src names the work:
// use(o, p) says whether product slot p < n_slots feeds output o;
// a(o, p) and b(o, p) are its A block (row stride bs) and B block (row
// stride ldb); out(o) and norm(o) are where the pruned block and its
// L1 norm go (with kColNorms, the bs norms of its columns: red then
// holds kThreads / 32 * TS values).  An output with no product is
// stored as zeros.
template <typename Tin, typename T, int TS, class Src,
          bool kColNorms = false>
__device__ __forceinline__ void pipelined_outputs(const Src& src, int n_out,
                                                  int n_slots, int bs,
                                                  int ldb, T alpha,
                                                  T threshold,
                                                  Stage<Tin, TS>* ring,
                                                  T* red) {
  struct Pos {
    int o, p, c;  // output, product slot, k-chunk
  };
  const int n_chunks = (bs + kChunk - 1) / kChunk;
  auto find = [&](int o, int p) {
    for (; p < n_slots; ++p)
      if (src.use(o, p)) return p;
    return -1;
  };
  auto first_from = [&](int o) {
    for (; o < n_out; ++o) {
      const int p = find(o, 0);
      if (p >= 0) return Pos{o, p, 0};
    }
    return Pos{n_out, 0, 0};
  };
  auto next = [&](Pos x) {
    if (++x.c < n_chunks) return x;
    const int p = find(x.o, x.p + 1);
    return p >= 0 ? Pos{x.o, p, 0} : first_from(x.o + 1);
  };
  auto issue = [&](int stage, Pos x) {
    stage_chunk(ring[stage], src.a(x.o, x.p), src.b(x.o, x.p), ldb, bs,
                x.c * kChunk);
    cp_async_commit();
  };

  Pos ld = first_from(0);  // the step staged (or in flight) in `stage`
  int stage = 0;
  if (ld.o < n_out) issue(0, ld);
  Acc<T, TS> acc;
  for (int o = 0; o < n_out; ++o) {
    acc.zero();
    while (ld.o == o) {
      const Pos nx = next(ld);
      if (nx.o < n_out) {
        issue(stage ^ 1, nx);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mac_staged(acc, ring[stage]);
      __syncthreads();  // the stage is refilled by the next issue
      stage ^= 1;
      ld = nx;
    }
    if constexpr (kColNorms)
      store_pruned_cols(acc, src.out(o), src.norm(o), bs, alpha, threshold,
                        red);
    else
      store_pruned(acc, src.out(o), src.norm(o), bs, alpha, threshold, red);
  }
}

// ---------------------------------------------------------------------------
// the band and general kernels' exact tier: one thread block per output
// tile, walking the row's pairs
// ---------------------------------------------------------------------------
//
// Index names the pairs of output tile r * k_out + g, A slots ascending
// (the tensor-core product of tc.cuh takes the same interface): a tile
// walks positions p < slots(); b_block(r, g, p) is the B block that
// position p reads when it feeds slot g, else -1; a_slot(p) is its A
// slot (of KA); b_taken(r, g, p) is the same B block for a position that
// b_block took, from fewer loads.

// The work of one tile for pipelined_outputs.
template <typename T, class Index>
struct PairWork {
  Index idx;
  const T* a_blocks;
  const T* b_blocks;
  T* c_blocks;
  T* c_norms;
  int64_t r, tile;
  int g, bs;

  __device__ bool use(int, int p) const { return idx.b_block(r, g, p) >= 0; }
  __device__ const T* a(int, int p) const {
    return a_blocks + (r * idx.ka + idx.a_slot(p)) * int64_t(bs) * bs;
  }
  __device__ const T* b(int, int p) const {  // p was taken by use()
    return b_blocks + idx.b_taken(r, g, p) * int64_t(bs) * bs;
  }
  __device__ T* out(int) const { return c_blocks + tile * int64_t(bs) * bs; }
  __device__ T* norm(int) const { return c_norms + tile; }
};

// Grid order slot-fastest (tile = r * k_out + g), so that the tiles
// sharing A[r, .] run together and A comes from L2.
template <typename T, int TS, class Index>
__global__ void __launch_bounds__(kThreads)
pair_kernel(Index idx, const T* __restrict__ a_blocks,
            const T* __restrict__ b_blocks, T* __restrict__ out,
            T* __restrict__ norms, int k_out, int bs, T alpha, T threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads / 32];
  const int64_t tile = blockIdx.x;
  const PairWork<T, Index> work{idx,  a_blocks, b_blocks,
                                out,  norms,    tile / k_out,
                                tile, int(tile % k_out), bs};
  pipelined_outputs<T, T, TS>(work, 1, idx.slots(), bs, bs, alpha,
                              threshold,
                              reinterpret_cast<Stage<T, TS>*>(smem), red);
}

// -> cudaError_t
template <typename T, class Index>
int launch_pairs(const Index& idx, const void* a_blocks,
                 const void* b_blocks, void* out, void* norms, int rows,
                 int k_out, int bs, double alpha, double threshold,
                 void* stream) {
  if (rows == 0 || k_out == 0) return 0;
  const unsigned tiles = unsigned(rows) * unsigned(k_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_PAIRS(TS)                                                      \
  {                                                                        \
    const int smem = ring_bytes<T, TS>();                                  \
    auto* kernel = pair_kernel<T, TS, Index>;                              \
    if (int err = allow_smem(kernel, smem)) return err;                    \
    kernel<<<tiles, kThreads, smem, st>>>(                                 \
        idx, static_cast<const T*>(a_blocks),                              \
        static_cast<const T*>(b_blocks), static_cast<T*>(out),             \
        static_cast<T*>(norms), k_out, bs, T(alpha), T(threshold));        \
  }
  switch (tile_for(bs)) {
    case 16: NTP_PAIRS(16); break;
    case 32: NTP_PAIRS(32); break;
    case 64: NTP_PAIRS(64); break;
    default: NTP_PAIRS(128); break;
  }
#undef NTP_PAIRS
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the tensor cores (spgemm_uniform.cu): mma.sync m16n8k16, bf16 operands,
// float sums
// ---------------------------------------------------------------------------
//
// One 128 x 128 output tile per thread block (rows and columns at or
// beyond bs are masked), its 8 warps as 2 (rows) x 4 (columns), each
// warp a 64 x 32 sub-tile of 4 x 4 m16n8 tiles: 64 float accumulators a
// thread.  Operands are staged k-chunk by k-chunk as bfloat16 in shared
// memory (MmaStage) and read with ldmatrix: A row-major [m][k], B
// row-major [k][n] through ldmatrix .trans.  Each row is padded by 16
// bytes, which puts the 8 rows of an 8 x 8 ldmatrix in different banks.

constexpr int kMmaTile = 128;

template <int K>
struct MmaStage {
  static_assert(K % 16 == 0, "the mma k step is 16");
  __nv_bfloat16 a[kMmaTile][K + 8];  // a[m][k] = A[m][k0 + k]
  __nv_bfloat16 b[K][kMmaTile + 8];  // b[k][n] = B[k0 + k][n]
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a @ b for one m16n8k16 tile: a four registers of bf16 pairs (row
// major), b two (column major), c four floats.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copies of k-chunk k0 (depth K) of two row-major bs x bs
// bfloat16 blocks into st; copies outside the blocks are zero-filled.
template <int K>
__device__ __forceinline__ void stage_chunk_mma(
    MmaStage<K>& st, const __nv_bfloat16* __restrict__ a,
    const __nv_bfloat16* __restrict__ b, int bs, int k0) {
  constexpr int V = 8;  // bf16 per 16-byte copy
  constexpr int kRowA = K / V;
  for (int i = threadIdx.x; i < kMmaTile * kRowA; i += kThreads) {
    const int m = i / kRowA, k = (i % kRowA) * V;
    const bool ok = m < bs && k0 + k < bs;
    cp_async16(&st.a[m][k], ok ? a + m * bs + k0 + k : a, ok);
  }
  constexpr int kRowB = kMmaTile / V;
  for (int i = threadIdx.x; i < K * kRowB; i += kThreads) {
    const int k = i / kRowB, n = (i % kRowB) * V;
    const bool ok = n < bs && k0 + k < bs;
    cp_async16(&st.b[k][n], ok ? b + (k0 + k) * bs + n : b, ok);
  }
}

// hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even: the
// TPU's bf16x3 split (a_hi b_hi + a_lo b_hi + a_hi b_lo).
__device__ __forceinline__ void split_bf16(float4 x, __nv_bfloat162 (&hi)[2],
                                           __nv_bfloat162 (&lo)[2]) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  __nv_bfloat16 h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __float2bfloat16_rn(v[i]);
    l[i] = __float2bfloat16_rn(v[i] - __bfloat162float(h[i]));
  }
  hi[0] = __halves2bfloat162(h[0], h[1]);
  hi[1] = __halves2bfloat162(h[2], h[3]);
  lo[0] = __halves2bfloat162(l[0], l[1]);
  lo[1] = __halves2bfloat162(l[2], l[3]);
}

__device__ __forceinline__ void put4(__nv_bfloat16* p,
                                     const __nv_bfloat162 (&v)[2]) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = v[0];
  reinterpret_cast<__nv_bfloat162*>(p)[1] = v[1];
}

// The split pass of one staged float k-chunk (depth kChunk, tile 128):
// sp.a = [a_hi | a_lo | a_hi] and sp.b = [b_hi ; b_hi ; b_lo] along k,
// so that one mma chain of depth 3 * kChunk sums the three terms.
__device__ __forceinline__ void split_chunk(const Stage<float, kMmaTile>& st,
                                            MmaStage<3 * kChunk>& sp) {
  constexpr int kRowA = kChunk / 4;  // float4 per row of the A chunk
  for (int i = threadIdx.x; i < kMmaTile * kRowA; i += kThreads) {
    const int m = i / kRowA, k = (i % kRowA) * 4;
    __nv_bfloat162 hi[2], lo[2];
    split_bf16(*reinterpret_cast<const float4*>(&st.a[m][k]), hi, lo);
    put4(&sp.a[m][k], hi);
    put4(&sp.a[m][kChunk + k], lo);
    put4(&sp.a[m][2 * kChunk + k], hi);
  }
  constexpr int kRowB = kMmaTile / 4;
  for (int i = threadIdx.x; i < kChunk * kRowB; i += kThreads) {
    const int k = i / kRowB, n = (i % kRowB) * 4;
    __nv_bfloat162 hi[2], lo[2];
    split_bf16(*reinterpret_cast<const float4*>(&st.b[k][n]), hi, lo);
    put4(&sp.b[k][n], hi);
    put4(&sp.b[kChunk + k][n], hi);
    put4(&sp.b[2 * kChunk + k][n], lo);
  }
}

struct MmaAcc {
  float v[4][4][4];  // [m tile][n tile][fragment]

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[i][j][c] = 0.f;
  }

  // v += the staged chunk's product (depth K).
  template <int K>
  __device__ __forceinline__ void mac(const MmaStage<K>& st) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int m0 = (warp / 4) * 64, n0 = (warp % 4) * 32;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      unsigned a[4][4], b[4][2];
      // lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at
      // k + 8: the four 8 x 8 matrices of an m16k16 A fragment
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &st.a[m0 + 16 * i + lane % 16][kk + 8 * (lane / 16)]);
      // rows k..k+15 of two n8 tiles: (k lo, n), (k hi, n), (k lo, n + 8),
      // (k hi, n + 8), transposed into column-major fragments
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        ldmatrix_x4_trans(
            r, &st.b[kk + lane % 16][n0 + 16 * j + 8 * (lane / 16)]);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(v[i][j], a[i], b[j][0], b[j][1]);
    }
  }
};

// The prune epilogue of an MmaAcc with per-column norms: out =
// flush(alpha * acc), norms[c] = sum over rows of |out[row][c]|, c < bs.
// red holds 2 * kMmaTile floats.
__device__ __forceinline__ void store_mma(const MmaAcc& acc,
                                          float* __restrict__ out,
                                          float* __restrict__ norms, int bs,
                                          float alpha, float threshold,
                                          float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m0 = (warp / 4) * 64, n0 = (warp % 4) * 32;
  const int g = lane / 4, q = lane % 4;
  float part[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // fragment c0, c1: row g, columns 2q, 2q + 1; c2, c3: row g + 8
        const int row = m0 + 16 * i + 8 * h + g;
        const int col = n0 + 8 * j + 2 * q;
        float x0 = acc.v[i][j][2 * h] * alpha;
        float x1 = acc.v[i][j][2 * h + 1] * alpha;
        x0 = fabsf(x0) > threshold ? x0 : 0.f;
        x1 = fabsf(x1) > threshold ? x1 : 0.f;
        if (row < bs && col < bs) {  // bs is even: col + 1 < bs too
          *reinterpret_cast<float2*>(out + row * bs + col) =
              make_float2(x0, x1);
          part[j][0] += fabsf(x0);
          part[j][1] += fabsf(x1);
        }
      }
  // the 8 lanes of one q hold the same columns
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        part[j][e] += __shfl_xor_sync(0xffffffffu, part[j][e], off);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[(warp / 4) * kMmaTile + n0 + 8 * j + 2 * lane] = part[j][0];
      red[(warp / 4) * kMmaTile + n0 + 8 * j + 2 * lane + 1] = part[j][1];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < bs; c += kThreads)
    norms[c] = red[c] + red[kMmaTile + c];
  __syncthreads();  // red is reused by the next output
}

}  // namespace ntp
