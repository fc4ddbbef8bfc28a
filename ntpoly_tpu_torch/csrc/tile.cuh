// Shared pieces of the block SpGEMM kernels (spgemm_general.cu,
// spgemm_band.cu, spgemm_stream.cu, spgemm_window.cu): a thread block
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
// Two ways to stage: Acc::mac loads each chunk synchronously (general
// and band kernels); pipelined_outputs runs a two-stage cp.async ring
// so that the next chunk is in flight while the current one is
// multiplied (stream and window kernels).  Both add the products of an
// output block in the same order (products in turn, k ascending, one
// fma per k), so they give the same bits for the same products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ntp {

constexpr int kEmpty = 1 << 30;
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // depth of one staged k-chunk

template <typename T, int TS>
struct Smem {
  T a[kChunk][TS + 1];  // A chunk, transposed: a[k][m] = A[m][k0 + k]
  T b[kChunk][TS];      // B chunk: b[k][n] = B[k0 + k][n]
};

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

  // v += A @ B for two row-major bs x bs blocks.  Every thread of the
  // block must call this (it synchronises).
  __device__ __forceinline__ void mac(const T* __restrict__ a,
                                      const T* __restrict__ b, int bs,
                                      Smem<T, TS>& sm) {
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    for (int k0 = 0; k0 < bs; k0 += kChunk) {
      for (int i = tid; i < TS * kChunk; i += kThreads) {
        const int m = i / kChunk, k = i % kChunk;
        sm.a[k][m] = (m < bs && k0 + k < bs) ? a[m * bs + k0 + k] : T(0);
      }
      for (int i = tid; i < TS * kChunk; i += kThreads) {
        const int k = i / TS, n = i % TS;
        sm.b[k][n] = (n < bs && k0 + k < bs) ? b[(k0 + k) * bs + n] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        T ra[TM], rb[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = sm.a[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TM; ++j) rb[j] = sm.b[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) v[i][j] = fma(ra[i], rb[j], v[i][j]);
      }
      __syncthreads();
    }
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

// Largest tile that a bs x bs block needs: 16, 32, 64 or 128.
inline int tile_for(int bs) {
  return bs <= 16 ? 16 : bs <= 32 ? 32 : bs <= 64 ? 64 : 128;
}

// ---------------------------------------------------------------------------
// the cp.async ring (spgemm_stream.cu, spgemm_window.cu)
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
// L1 norm go.  An output with no product is stored as zeros.
template <typename Tin, typename T, int TS, class Src>
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
    store_pruned(acc, src.out(o), src.norm(o), bs, alpha, threshold, red);
  }
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (needed
// above 48 KB) -> cudaError_t.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace ntp
