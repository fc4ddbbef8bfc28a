// Shared pieces of the block SpGEMM kernels (spgemm_general.cu,
// spgemm_band.cu): one thread block owns one bs x bs output block
// (bs a multiple of 8, at most 128) and accumulates products of
// bs x bs blocks into registers, staging k-chunks of both operands
// through shared memory.  The epilogue is the reference's prune step:
// scale by alpha, flush |v| <= threshold to zero, store, and write the
// block's L1 norm.
//
// Layout: TS x TS output tile (TS = 16, 32, 64 or 128, the smallest
// that covers bs), 256 threads as a 16 x 16 grid, each thread holding a
// TM x TM micro-tile (TM = TS / 16) at rows ty + 16 i and columns
// tx + 16 j.  That strided assignment keeps the shared-memory reads of
// a warp conflict-free (B) or broadcast (A), and the output stores
// coalesced.  Rows and columns at or beyond bs are masked: their
// staged operands are zero and they are never stored.
#pragma once

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

}  // namespace ntp
