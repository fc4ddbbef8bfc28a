// Shared pieces of the block SpGEMM kernels: the exact tier of all of
// them (spgemm_general.cu, spgemm_band.cu, spgemm_stream.cu,
// spgemm_window.cu, spgemm_uniform.cu).  Their tensor-core tiers share
// the product of tc.cuh.  A thread block accumulates products of bs x bs
// blocks (bs a multiple of 8, at most 128) into one output block held in
// registers, staging k-chunks of both operands through shared memory.
// The epilogue is the reference's prune step: scale by alpha, flush |v|
// <= threshold to zero, store, and write the block's L1 norm (or the
// norms of its columns).
//
// What bounds it on the H100: FP32 (or FP64) FMAs on the CUDA cores, 64
// operations per operand byte at bs 128 in float32, far above the memory
// roofline.  An SM sub-partition issues one instruction a clock and
// retires one warp's 32 FP32 FMAs a clock, so the FP32 peak needs an FMA
// in every issue slot: each load from shared memory, barrier, address
// computation or stall is an FMA not issued.  A core that read one scalar
// of A and one of B per row, column and k (16 loads per 64 FMAs at TS
// 128) and met two barriers per 16-deep chunk reached 43-51% of the FP32
// bound.
//
// Layout: TS x TS output tile (TS = 16, 32, 64 or 128, the smallest that
// covers bs), 256 threads as a 16 x 16 grid (y, x), each holding a TM x
// TM micro-tile (TM = TS / 16): rows y + 16 i, and columns in groups of
// CV = min(TM, 16 bytes) contiguous ones, group g at g * 16 CV + CV x.  A
// warp is a 4 x 8 patch of the grid (place()), so that
//   - its reads of B, one 16-byte vector of a staged B row per column
//     group and k, cover 128 contiguous bytes, each vector read by four
//     threads;
//   - its reads of A, vectors of consecutive k of a staged A row, touch 4
//     adjacent rows, which the row padding puts in distinct bank quads,
//     each vector read by eight threads.
// mac_staged asks for A two k-steps at a time, so that the next k-steps'
// fragments of A and B sit in registers beside the current ones while
// their FMAs run (float32 at TS 128: 64 accumulators, 2 x 16 A and 2 x 8
// B registers); nvcc merges the float32 pairs into 16-byte loads, 4 per
// 64 FMAs.  The output is stored in vectors of CV elements.  Rows and
// columns at or beyond bs are masked: their staged operands are zero and
// they are never stored.
//
// Staging: pipelined_outputs runs a three-stage cp.async ring of 32-deep
// k-chunks (16 at TS 16): two chunks are in flight while one is
// multiplied, at one wait and one barrier a chunk.  The copies' places
// are computed once per thread (Copies), a product's block addresses once
// per product, and a full block (bs = TS) is copied without masks.  At TS
// 128 a stage is 34 KB in float32, so two blocks of 256 threads share an
// SM, and the float32 kernels are built for two (128 registers a thread,
// no spills); float64 holds twice the accumulator bytes and is built for
// one.  Smaller tiles run more blocks an SM (Tile::kMinBlocks), which the
// small kernels, bound by the latency of their few chunks, need.
//
// Bits: every output element takes its FMAs in one order, products in
// turn, k ascending, one fma per k (zero-padded k included: they add
// exact zeros), whichever thread holds it, so the kernels give the same
// bits for the same products, as the scalar core before this one did.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ntp {

constexpr int kEmpty = 1 << 30;
constexpr int kThreads = 256;
constexpr int kRing = 3;  // stages of the cp.async ring

// The exact tier's tile at TS x TS for elements T.
template <typename T, int TS>
struct Tile {
  static constexpr int TM = TS / 16;              // rows (columns) a thread
  static constexpr int V = 16 / int(sizeof(T));   // elements in 16 bytes
  static constexpr int CV = TM < V ? TM : V;      // columns of a group
  static constexpr int kChunk = TS < 32 ? 16 : 32;  // depth of a stage
  static constexpr int kLdA = kChunk + V;         // A row stride, staged
  // blocks an SM the kernels are built for (__launch_bounds__): as many
  // as the ring's shared memory lets in, where the registers that leaves
  // hold the micro-tile without spills (nvcc -Xptxas -v); float64 at TS
  // 128 needs more than 128 registers a thread and runs alone
  static constexpr int kMinBlocks =
      TS == 128 ? (sizeof(T) == 4 ? 2 : 1)
                : TS == 64 ? (sizeof(T) == 4 ? 3 : 2) : TS == 32 ? 4 : 6;

  // column of the thread's j-th column, at grid column x
  __device__ static int col(int x, int j) {
    return j / CV * 16 * CV + CV * x + j % CV;
  }
};

// The thread's place in the 16 x 16 grid: the 8 warps as 4 x 2 patches
// of 4 rows y by 8 columns x.
struct Place {
  int y, x;
};

__device__ __forceinline__ Place place() {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  return {warp / 2 * 4 + lane / 8, warp % 2 * 8 + lane % 8};
}

// N elements read or written as one vector access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <int N, typename T>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int TS>
struct Acc {
  static constexpr int TM = Tile<T, TS>::TM;
  T v[TM][TM];  // v[i][j]: row y + 16 i, column Tile::col(x, j)

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) v[i][j] = T(0);
  }
};

// Block-wide sum of one value per thread -> the total, for thread 0 (the
// epilogues use it there only: once past the last barrier, red[0] may
// already hold a partial sum of the next output's).
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

// out = flush(alpha * acc) on the block's rows and columns < bs, stored
// in vectors of CV columns; add(j, |x|) sees each stored value x of the
// thread's column j.
template <typename T, int TS, class Add>
__device__ __forceinline__ void store_flushed(const Acc<T, TS>& acc,
                                              T* __restrict__ out, int bs,
                                              T alpha, T threshold,
                                              Place me, Add add) {
  using L = Tile<T, TS>;
  constexpr int CV = L::CV;
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
    const int row = me.y + 16 * i;
#pragma unroll
    for (int g = 0; g < L::TM / CV; ++g) {
      const int col = L::col(me.x, g * CV);
      // bs is a multiple of 8: a group lies wholly inside or outside
      if (row < bs && col < bs) {
        Pack<T, CV> x;
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          T v = acc.v[i][g * CV + c] * alpha;
          v = fabs(v) > threshold ? v : T(0);
          x.v[c] = v;
          add(g * CV + c, fabs(v));
        }
        *reinterpret_cast<Pack<T, CV>*>(out + row * bs + col) = x;
      }
    }
  }
}

// The prune epilogue: out = flush(alpha * acc), *norm = sum |out|.
template <typename T, int TS>
__device__ __forceinline__ void store_pruned(const Acc<T, TS>& acc,
                                             T* __restrict__ out,
                                             T* __restrict__ norm, int bs,
                                             T alpha, T threshold, T* red) {
  T part = T(0);
  store_flushed(acc, out, bs, alpha, threshold, place(),
                [&](int, T a) { part += a; });
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
  using L = Tile<T, TS>;
  constexpr int TM = L::TM;
  const Place me = place();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T part[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) part[j] = T(0);
  store_flushed(acc, out, bs, alpha, threshold, me,
                [&](int j, T a) { part[j] += a; });
  // a column's threads share x: in a warp, lanes l, l ^ 8, l ^ 16 and
  // l ^ 24 (its four rows y); across warps, the four warps of one x half
  // (warp % 2), one for each quarter of y (warp / 2)
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 8);
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 16);
  }
  if (lane < 8) {
#pragma unroll
    for (int j = 0; j < TM; ++j) red[warp / 2 * TS + L::col(me.x, j)] = part[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < bs; c += kThreads) {
    T sum = T(0);
    for (int q = 0; q < 4; ++q) sum += red[q * TS + c];
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
// above 48 KB), with all of the SM's unified memory that L1 can give up
// going to shared memory, so that the ring's blocks share an SM ->
// cudaError_t.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  if (int err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          int(cudaSharedmemCarveoutMaxShared))))
    return err;
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
// cannot transpose), each row padded by one 16-byte vector, which puts
// four adjacent rows in distinct bank quads.
template <typename T, int TS>
struct Stage {
  using L = Tile<T, TS>;
  T a[TS][L::kLdA];     // a[m][k] = A[m][k0 + k]
  T b[L::kChunk][TS];   // b[k][n] = B[k0 + k][n]
};

// A thread's share of the copies that fill a stage: in passes it = 0, 1,
// ..., the 16-byte vector at columns ka.. of A rows ma + it * kStepA, and
// the one at columns nb.. of B rows kb + it * kStepB.
template <typename T, int TS>
struct Copies {
  using L = Tile<T, TS>;
  static constexpr int kRowA = L::kChunk / L::V;   // copies per A row
  static constexpr int kStepA = kThreads / kRowA;  // A rows per pass
  static constexpr int kRowB = TS / L::V;          // copies per B row
  static constexpr int kStepB = kThreads / kRowB;  // B rows per pass
  int ma, ka, kb, nb;

  __device__ Copies()
      : ma(threadIdx.x / kRowA),
        ka(threadIdx.x % kRowA * L::V),
        kb(threadIdx.x / kRowB),
        nb(threadIdx.x % kRowB * L::V) {}
};

// Start the copies of k-chunk k0 of A (bs x bs, row stride bs) and of B
// (bs x bs, row stride ldb) into st.  bs is a multiple of 8 and each
// copy is 16 bytes of at most 8 elements, so a copy lies wholly inside
// or wholly outside the block; outside ones are zero-filled.  A block
// that fills the tile (bs = TS, the main path's bs 128) needs no mask.
template <typename T, int TS>
__device__ __forceinline__ void stage_chunk(Stage<T, TS>& st,
                                            const Copies<T, TS>& cp,
                                            const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            int ldb, int bs, int k0) {
  using C = Copies<T, TS>;
  constexpr int kChunk = Tile<T, TS>::kChunk;
  if (bs == TS) {  // every copy lies inside the block (TS % kChunk == 0)
    const T* pa = a + cp.ma * TS + k0 + cp.ka;
#pragma unroll
    for (int it = 0; it < (TS + C::kStepA - 1) / C::kStepA; ++it)
      if (TS % C::kStepA == 0 || cp.ma + it * C::kStepA < TS)
        cp_async16(&st.a[cp.ma + it * C::kStepA][cp.ka],
                   pa + it * C::kStepA * TS, true);
    const T* pb = b + int64_t(k0 + cp.kb) * ldb + cp.nb;
    const int64_t step = int64_t(C::kStepB) * ldb;
#pragma unroll
    for (int it = 0; it < (kChunk + C::kStepB - 1) / C::kStepB; ++it)
      if (kChunk % C::kStepB == 0 || cp.kb + it * C::kStepB < kChunk)
        cp_async16(&st.b[cp.kb + it * C::kStepB][cp.nb], pb + it * step,
                   true);
    return;
  }
  const bool ka_ok = k0 + cp.ka < bs;
  const T* pa = a + cp.ma * bs + k0 + cp.ka;
#pragma unroll
  for (int it = 0; it < (TS + C::kStepA - 1) / C::kStepA; ++it) {
    const int m = cp.ma + it * C::kStepA;
    if (TS % C::kStepA == 0 || m < TS) {
      const bool ok = ka_ok && m < bs;
      cp_async16(&st.a[m][cp.ka], ok ? pa + it * C::kStepA * bs : a, ok);
    }
  }
  const bool nb_ok = cp.nb < bs;
  const T* pb = b + int64_t(k0 + cp.kb) * ldb + cp.nb;
#pragma unroll
  for (int it = 0; it < (kChunk + C::kStepB - 1) / C::kStepB; ++it) {
    const int k = cp.kb + it * C::kStepB;
    if (kChunk % C::kStepB == 0 || k < kChunk) {
      const bool ok = nb_ok && k0 + k < bs;
      cp_async16(&st.b[k][cp.nb],
                 ok ? pb + int64_t(it * C::kStepB) * ldb : b, ok);
    }
  }
}

// acc += the staged chunk's product, k ascending: at each k, TM x TM
// fmas on the thread's TM rows of A (read two k-steps at a time) and TM
// columns of B (TM / CV vectors), while the next k-step's fragments load.
template <typename T, int TS>
__device__ __forceinline__ void mac_staged(Acc<T, TS>& acc,
                                           const Stage<T, TS>& st,
                                           Place me) {
  using L = Tile<T, TS>;
  constexpr int TM = L::TM, CV = L::CV, G = TM / CV, VA = 2;
  Pack<T, VA> ra[2][TM];
  Pack<T, CV> rb[2][G];
  auto load_a = [&](Pack<T, VA>(&r)[TM], int k) {
#pragma unroll
    for (int i = 0; i < TM; ++i) r[i] = load_pack<VA>(&st.a[me.y + 16 * i][k]);
  };
  auto load_b = [&](Pack<T, CV>(&r)[G], int k) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      r[g] = load_pack<CV>(&st.b[k][L::col(me.x, g * CV)]);
  };
  load_a(ra[0], 0);
  load_b(rb[0], 0);
#pragma unroll
  for (int k = 0; k < L::kChunk; ++k) {
    if (k + 1 < L::kChunk) {
      if ((k + 1) % VA == 0) load_a(ra[(k + 1) / VA % 2], k + 1);
      load_b(rb[(k + 1) % 2], k + 1);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        acc.v[i][j] = fma(ra[k / VA % 2][i].v[k % VA],
                          rb[k % 2][j / CV].v[j % CV], acc.v[i][j]);
  }
}

// Dynamic shared memory of the ring.
template <typename T, int TS>
constexpr int ring_bytes() {
  return kRing * static_cast<int>(sizeof(Stage<T, TS>));
}

// Compute n_out output blocks in turn through the ring: the two chunks
// after the current one (of the same product, of the next product, or of
// the next output blocks' first products) are in flight while it is
// multiplied.  Src names the work: use(o, p) says whether product slot p
// < n_slots feeds output o; a(o, p) and b(o, p) are its A block (row
// stride bs) and B block (row stride ldb); out(o) and norm(o) are where
// the pruned block and its L1 norm go (with kColNorms, the bs norms of
// its columns: red then holds kThreads / 32 * TS values).  An output with
// no product is stored as zeros.
template <typename T, int TS, class Src, bool kColNorms = false>
__device__ __forceinline__ void pipelined_outputs(const Src& src, int n_out,
                                                  int n_slots, int bs,
                                                  int ldb, T alpha,
                                                  T threshold,
                                                  Stage<T, TS>* ring,
                                                  T* red) {
  struct Pos {
    int o, p, c;       // output, product slot, k-chunk
    const T *a, *b;    // the product's blocks
  };
  constexpr int kChunk = Tile<T, TS>::kChunk;
  const int n_chunks = (bs + kChunk - 1) / kChunk;
  auto find = [&](int o, int p) {
    for (; p < n_slots; ++p)
      if (src.use(o, p)) return p;
    return -1;
  };
  auto first_from = [&](int o) {
    for (; o < n_out; ++o) {
      const int p = find(o, 0);
      if (p >= 0) return Pos{o, p, 0, src.a(o, p), src.b(o, p)};
    }
    return Pos{n_out, 0, 0, nullptr, nullptr};
  };
  auto next = [&](Pos x) {
    if (++x.c < n_chunks) return x;
    const int p = find(x.o, x.p + 1);
    return p >= 0 ? Pos{x.o, p, 0, src.a(x.o, p), src.b(x.o, p)}
                  : first_from(x.o + 1);
  };
  // stage step ld, if any is left, into ring[s], and close one group of
  // copies either way (the waits count groups) -> the step's output
  // (n_out for none)
  const Copies<T, TS> copies;
  Pos ld = first_from(0);  // the next step to stage
  auto issue = [&](int s) {
    const int o = ld.o;
    if (o < n_out) {
      stage_chunk(ring[s], copies, ld.a, ld.b, ldb, bs, ld.c * kChunk);
      ld = next(ld);
    }
    cp_async_commit();
    return o;
  };

  static_assert(kRing == 3, "the ring keeps two staged steps' outputs");
  int now = issue(0), then = issue(1);  // outputs of the staged steps
  int stage = 0;                        // ring[stage] holds step `now`
  const Place me = place();
  Acc<T, TS> acc;
  for (int o = 0; o < n_out; ++o) {
    acc.zero();
    while (now == o) {
      cp_async_wait<kRing - 2>();
      // ring[stage] has landed for every thread, and every thread is done
      // with the stage before it, which takes the next copies
      __syncthreads();
      const int last = issue(stage == 0 ? kRing - 1 : stage - 1);
      mac_staged(acc, ring[stage], me);
      stage = stage == kRing - 1 ? 0 : stage + 1;
      now = then;
      then = last;
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
__global__ void __launch_bounds__(kThreads, (Tile<T, TS>::kMinBlocks))
pair_kernel(Index idx, const T* __restrict__ a_blocks,
            const T* __restrict__ b_blocks, T* __restrict__ out,
            T* __restrict__ norms, int k_out, int bs, T alpha, T threshold,
            const int* __restrict__ run) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads / 32];
  if (run != nullptr && *run == 0) return;
  const int64_t tile = blockIdx.x;
  const PairWork<T, Index> work{idx,  a_blocks, b_blocks,
                                out,  norms,    tile / k_out,
                                tile, int(tile % k_out), bs};
  pipelined_outputs<T, TS>(work, 1, idx.slots(), bs, bs, alpha, threshold,
                           reinterpret_cast<Stage<T, TS>*>(smem), red);
}

// `run`: a device predicate, or null; when it holds 0 every block returns
// before any load and out and norms are left as they were.
// -> cudaError_t
template <typename T, class Index>
int launch_pairs(const Index& idx, const void* a_blocks,
                 const void* b_blocks, void* out, void* norms, int rows,
                 int k_out, int bs, double alpha, double threshold,
                 const void* run, void* stream) {
  if (rows == 0 || k_out == 0) return 0;
  const unsigned tiles = unsigned(rows) * unsigned(k_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NTP_PAIRS(TS)                                                      \
  {                                                                        \
    const int smem = ring_bytes<T, TS>();                                  \
    auto* kernel = pair_kernel<T, TS, Index>;                              \
    static const int smem_err = allow_smem(kernel, smem);                  \
    if (smem_err) return smem_err;                                         \
    kernel<<<tiles, kThreads, smem, st>>>(                                 \
        idx, static_cast<const T*>(a_blocks),                              \
        static_cast<const T*>(b_blocks), static_cast<T*>(out),             \
        static_cast<T*>(norms), k_out, bs, T(alpha), T(threshold),         \
        static_cast<const int*>(run));                                     \
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
