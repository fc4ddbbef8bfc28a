// Shared pieces of the block SpGEMM kernels: the exact tier of all of
// them (spgemm_general.cu, spgemm_band.cu, spgemm_stream.cu,
// spgemm_window.cu, spgemm_uniform.cu).  Their tensor-core tiers share
// the product of tc.cuh.  A thread block accumulates products of bs x bs
// blocks (bs a multiple of 8, at most 128) into one output block held in
// registers, staging k-chunks of both operands through shared memory.
// The epilogue is the reference's prune step: scale by alpha, flush |v|
// <= threshold to zero, store, and write the block's L1 norm.
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

// One staged k-chunk of both operands.  A is kept row-major (cp.async
// cannot transpose), each row padded by one 16-byte vector; a warp
// reads two of its rows at a time, which the padding puts in different
// banks.
template <typename T, int TS>
struct Stage {
  static constexpr int kVec = 16 / sizeof(T);  // elements per copy
  static constexpr int kLdA = kChunk + kVec;
  T a[TS][kLdA];    // a[m][k] = A[m][k0 + k]
  T b[kChunk][TS];  // b[k][n] = B[k0 + k][n]
};

// Start the copies of k-chunk k0 of A (bs x bs, row stride bs) and of B
// (bs x bs, row stride ldb) into st.  bs is a multiple of 8 and each
// copy is 16 bytes of at most 8 elements, so a copy lies wholly inside
// or wholly outside the block; outside ones are zero-filled.
template <typename T, int TS>
__device__ __forceinline__ void stage_chunk(Stage<T, TS>& st,
                                            const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            int ldb, int bs, int k0) {
  constexpr int V = Stage<T, TS>::kVec;
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

// acc += the staged chunk's product.
template <typename T, int TS>
__device__ __forceinline__ void mac_staged(Acc<T, TS>& acc,
                                           const Stage<T, TS>& st) {
  constexpr int TM = Acc<T, TS>::TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    T ra[TM], rb[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ra[i] = st.a[ty + 16 * i][k];
#pragma unroll
    for (int j = 0; j < TM; ++j) rb[j] = st.b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        acc.v[i][j] = fma(ra[i], rb[j], acc.v[i][j]);
  }
}

// Dynamic shared memory of the ring: two stages.
template <typename T, int TS>
constexpr int ring_bytes() {
  return 2 * static_cast<int>(sizeof(Stage<T, TS>));
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
template <typename T, int TS, class Src, bool kColNorms = false>
__device__ __forceinline__ void pipelined_outputs(const Src& src, int n_out,
                                                  int n_slots, int bs,
                                                  int ldb, T alpha,
                                                  T threshold,
                                                  Stage<T, TS>* ring,
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
// (tc.cuh's tensor-core product walks the same interface, and asks
// b_col(p) for the column of the B row where a pair's box starts): a tile
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
  pipelined_outputs<T, TS>(work, 1, idx.slots(), bs, bs, alpha, threshold,
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

}  // namespace ntp
