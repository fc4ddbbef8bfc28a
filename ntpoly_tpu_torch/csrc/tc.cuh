// The tensor-core product of the block SpGEMM kernels at the 'high' and
// 'bf16' tiers: band and general (spgemm_band.cu, spgemm_general.cu),
// window (spgemm_window.cu) and uniform (spgemm_uniform.cu).
//
// It reads bfloat16 planes: those that the split pass (spgemm_band.cu,
// launched once per operand storage before the product) writes from
// float32 operands, hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest even, as the TPU kernels split by hand; or, at 'bf16', the
// bfloat16 operands themselves, hi only.  The product is a pure bfloat16
// GEMM over a list of block pairs, float32 sums:
//   'high': C = alpha (A_hi B_hi + A_lo B_hi + A_hi B_lo)
//   'bf16': C = alpha A_hi B_hi
// then the prune epilogue (threshold flush, the L1 norm of the block or,
// for the uniform kernel, of each of its columns).
//
// Layout: one 128 x 128 output tile per output block (rows and columns at
// or beyond bs are masked), a persistent grid of at most one thread block
// per SM walking tiles blockIdx.x, + gridDim.x, ... in the callers' order.
// A block has three warpgroups: two consumers (rows 0-63 and 64-127,
// wgmma.m64n128k16, 64 float accumulators a thread) and one producer
// warp that keeps a three-stage shared-memory ring full with TMA copies
// under mbarriers.  One stage is the (A block, B block, 64-deep k step)
// of one pair: the A planes as 128 x 64 (K-major) and the B planes as 64 x
// 128 (N-major, B's own row-major layout, so no transpose), all four
// planes (64 KB) at 'high', so that a_hi and b_hi are read once for two of
// the three terms.  The TMA maps are 3-D over each plane, (columns, bs
// rows, blocks), with a 128-byte swizzle; a box reaching past a block's
// rows or a plane's columns reads zeros, so bs 8-128 need no masking on
// the way in.  A's planes are blocks (bs columns); B's are blocks or the
// window kernel's panel rows (KB * bs columns, block t at column t * bs),
// where a box wider than bs also reads the next block's columns: they
// land only in output columns >= bs, which the epilogue masks.  Only the
// producer reads the pair indices: it flags the slot that ends a tile,
// so the consumers never wait on an index load, and it runs ahead into
// the next tile while the consumers store the last one.
//
// Sums: the tensor cores add in float32 but truncate, which shrinks a
// long chain of additions toward zero (a bias, not noise: at the 2^20-row
// flagship it moved TRS4's electron count).  So each stage's twelve
// products (four k16 steps, three terms) start a fresh sum, and the
// stage sums are added to the tile's in registers, rounding to nearest.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tile.cuh"

namespace ntp {
namespace tc {

constexpr int kTile = 128;    // output tile rows and columns
constexpr int kDepth = 64;    // k of one stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreadsTc = kConsumers + 128;  // + the producer warpgroup
constexpr int kPlane = kTile * kDepth * 2;    // bytes of one plane's tile
constexpr int kStage = 4 * kPlane;            // a_hi, a_lo, b_hi, b_lo
constexpr int kSmem = kStages * kStage + 1024;  // + 1024-byte alignment

struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

struct Params {
  float* out;     // [tiles, bs, bs]
  float* norms;   // [tiles], or [tiles, bs] with column norms
  int64_t tiles;
  int bs;
  float alpha, threshold;
  // a device predicate: when given and 0, every block returns before
  // any load and the outputs are left as they were
  const int* run = nullptr;
};

// ---------------------------------------------------------------------------
// the split, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

// hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even: the
// TPU's bf16x3 split (a_hi b_hi + a_lo b_hi + a_hi b_lo), four values.
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One box of a 3-D map (coordinates innermost first) into shared memory,
// its bytes reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lead,
                                         unsigned stride) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t(lead >> 4) << 16) | (uint64_t(stride >> 4) << 32) |
         (uint64_t(1) << 62);
}

// A (K-major): 128-byte rows of 64 k, 8-row swizzle atoms 1024 bytes
// apart; a k16 step is 32 bytes into the row.
__device__ __forceinline__ uint64_t desc_a(const unsigned char* tile,
                                           int kk) {
  return desc(tile + 32 * kk, 16, 1024);
}

// B (N-major): 128-byte rows of 64 n per k, 8-k atoms 1024 bytes apart,
// columns 64-127 in a second box kPlane / 2 bytes on; a k16 step is 16
// rows.
__device__ __forceinline__ uint64_t desc_b(const unsigned char* tile,
                                           int kk) {
  return desc(tile + 2048 * kk, kPlane / 2, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the accumulators in place across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, K-major) @ B (16 x 128, N-major) (+ d when add),
// bfloat16 in, float sums.  Thread t of the warpgroup holds rows 16 (t /
// 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1): d[4 j + 2 h
// + e].
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(add));
}

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------

// The pairs of output tile r * k_out + g in the order of an Index
// (tile.cuh's pair interface); a pair's B box starts at column
// idx.b_col(p) of its B row (0 for block planes; t * bs in the window
// kernel's panel rows).  Every kernel walks its pairs through this one
// loop: on the H100 the window and uniform kernels' products ran slower
// with loops of their own over the same pairs in the same order
// (PERF.md).
template <class Index>
struct Pairs {
  Index idx;
  int k_out;

  template <class F>
  __device__ void for_each(int64_t tile, F&& f) const {
    const int64_t r = tile / k_out;
    const int g = static_cast<int>(tile % k_out);
    for (int p = 0; p < idx.slots(); ++p) {
      const int64_t b = idx.b_block(r, g, p);
      if (b >= 0)
        f(static_cast<int>(r * idx.ka + idx.a_slot(p)),
          static_cast<int>(b), idx.b_col(p));
    }
  }
};

// What a ring slot holds, written by the producer before it arrives on
// the slot's full barrier: operands (kData), and whether it ends its
// tile (kLast).  A tile without pairs is one slot with kLast alone, so
// the consumers read no index of their own.
constexpr int kData = 1, kLast = 2;

// Src names the work (Pairs over a kernel's index): for_each(tile, f)
// calls f(A block, B block, B column) for every pair of output tile
// `tile`, in order; the pair's B box starts at that column of the B
// block's rows.  kColNorms: the epilogue writes the L1 norm of
// each of the tile's bs columns, norms[tile * bs + c], instead of the
// block's.
template <class Src, bool kSplit, bool kColNorms>
__global__ void __launch_bounds__(kThreadsTc, 1)
product_kernel(const __grid_constant__ Maps maps, const Src src,
               const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int info[kStages];
  if (p.run != nullptr && *p.run == 0) return;
  // per consumer warp: its block sum, or its sums of each column
  __shared__ float red[2][kConsumers / 32][kColNorms ? kTile : 1];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int k_steps = (p.bs + kDepth - 1) / kDepth;

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread issues every copy; its warpgroup hands
    // its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kConsumers) return;
    const CUtensorMap* a_hi = &maps.a_hi;
    const CUtensorMap* a_lo = &maps.a_lo;
    const CUtensorMap* b_hi = &maps.b_hi;
    const CUtensorMap* b_lo = &maps.b_lo;
    int stage = 0, phase = 0;
    // the k steps of one pair, one slot each
    auto issue = [&](int a_blk, int b_blk, int b_col, bool last) {
      for (int k = 0; k < k_steps; ++k) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * kStage;
        uint64_t* bar = &full[stage];
        info[stage] = kData | (last && k == k_steps - 1 ? kLast : 0);
        mbar_expect(bar, (kSplit ? 4 : 2) * kPlane);
        const int k0 = k * kDepth;
        tma_load(st, a_hi, k0, 0, a_blk, bar);
        tma_load(st + 2 * kPlane, b_hi, b_col, k0, b_blk, bar);
        tma_load(st + 2 * kPlane + kPlane / 2, b_hi, b_col + kTile / 2, k0,
                 b_blk, bar);
        if (kSplit) {
          tma_load(st + kPlane, a_lo, k0, 0, a_blk, bar);
          tma_load(st + 3 * kPlane, b_lo, b_col, k0, b_blk, bar);
          tma_load(st + 3 * kPlane + kPlane / 2, b_lo, b_col + kTile / 2,
                   k0, b_blk, bar);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    };
    for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      // each pair is issued once the next is known, so that the last
      // one carries kLast
      int a_prev = -1, b_prev = 0, c_prev = 0;
      src.for_each(tile, [&](int a_blk, int b_blk, int b_col) {
        if (a_prev >= 0) issue(a_prev, b_prev, c_prev, false);
        a_prev = a_blk;
        b_prev = b_blk;
        c_prev = b_col;
      });
      if (a_prev >= 0) {
        issue(a_prev, b_prev, c_prev, true);
      } else {
        mbar_wait(&empty[stage], phase ^ 1);
        info[stage] = kLast;
        mbar_arrive(&full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63.  The
  // tensor cores' float sums truncate, which biases a long chain toward
  // zero, so each stage's products start a fresh sum (part) that is
  // added to the tile's (acc) rounding to nearest.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bs = p.bs;
  float acc[64], part[64];
  int stage = 0, phase = 0, par = 0;
  for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int flags = 0; !(flags & kLast);) {
      mbar_wait(&full[stage], phase);
      flags = info[stage];
      if (flags & kData) {
        const unsigned char* st = ring + stage * kStage;
        const unsigned char* a_hi = st + wg * (kPlane / 2);
        const unsigned char* b_hi = st + 2 * kPlane;
        fence_acc(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          const uint64_t ah = desc_a(a_hi, kk), bh = desc_b(b_hi, kk);
          wgmma_bf16(part, ah, bh, kk > 0);
          if (kSplit) {
            wgmma_bf16(part, desc_a(a_hi + kPlane, kk), bh, 1);
            wgmma_bf16(part, ah, desc_b(b_hi + kPlane, kk), 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(part);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (flags & kData) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    }

    // the prune epilogue, straight from the fragments
    float* out = p.out + tile * int64_t(bs) * bs;
    const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
    float l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float n0 = 0.f, n1 = 0.f;  // |out| in columns col0 + 8 j (+ 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = col0 + 8 * j;
        float x0 = acc[4 * j + 2 * h] * p.alpha;
        float x1 = acc[4 * j + 2 * h + 1] * p.alpha;
        x0 = fabsf(x0) > p.threshold ? x0 : 0.f;
        x1 = fabsf(x1) > p.threshold ? x1 : 0.f;
        if (row < bs && col < bs) {  // bs is even: col + 1 < bs too
          *reinterpret_cast<float2*>(out + row * bs + col) =
              make_float2(x0, x1);
          if (kColNorms) {
            n0 += fabsf(x0);
            n1 += fabsf(x1);
          } else {
            l1 += fabsf(x0) + fabsf(x1);
          }
        }
      }
      if (kColNorms) {
        // the 8 lanes of one lane % 4 hold the same columns
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          n0 += __shfl_xor_sync(0xffffffffu, n0, off);
          n1 += __shfl_xor_sync(0xffffffffu, n1, off);
        }
        if (lane < 4) {
          red[par][warp][col0 + 8 * j] = n0;
          red[par][warp][col0 + 8 * j + 1] = n1;
        }
      }
    }
    if (!kColNorms) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      if (lane == 0) red[par][warp][0] = l1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    const int c = threadIdx.x;
    if (kColNorms) {
      if (c < bs) {
        float total = 0.f;
        for (int w = 0; w < kConsumers / 32; ++w) total += red[par][w][c];
        p.norms[tile * bs + c] = total;
      }
    } else if (c == 0) {
      float total = 0.f;
      for (int w = 0; w < kConsumers / 32; ++w) total += red[par][w][0];
      p.norms[tile] = total;
    }
    par ^= 1;  // red[par] is read once more before it is written again
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query so that the library links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map over n_blocks row-major blocks of bs rows of `cols` bfloat16
// values, dims (column, row, block), boxes of box_cols x box_rows x 1,
// 128-byte swizzle; what lies past a block's edge reads as zero.
// -> cudaError_t.
inline int encode(CUtensorMap* map, const void* plane, int cols, int bs,
                  int64_t n_blocks, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(bs),
                              cuuint64_t(std::max<int64_t>(n_blocks, 1))};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2,
                                 cuuint64_t(cols) * bs * 2};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(plane),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <class Src, bool kSplit, bool kColNorms>
int launch_kernel(const Maps& maps, const Src& src, const Params& p,
                  cudaStream_t st) {
  auto* kernel = product_kernel<Src, kSplit, kColNorms>;
  // once per instance, so that a launch inside a CUDA graph capture
  // makes no attribute call
  static const int smem_err = allow_smem(kernel, kSmem);
  if (smem_err) return smem_err;
  const int grid =
      static_cast<int>(std::min<int64_t>(p.tiles, sm_count()));
  kernel<<<grid, kThreadsTc, kSmem, st>>>(maps, src, p);
  return static_cast<int>(cudaGetLastError());
}

// The product over the planes of A (n_a blocks of bs x bs) and B (n_b
// rows of bs x b_cols: bs for blocks, KB * bs for panel rows): the 'high'
// tier when a_lo is not null (then b_lo is not null either), else
// 'bf16'.  -> cudaError_t.
template <class Src, bool kColNorms = false>
int launch(const void* a_hi, const void* a_lo, int64_t n_a,
           const void* b_hi, const void* b_lo, int64_t n_b, int b_cols,
           const Src& src, const Params& p, void* stream) {
  if (p.tiles == 0) return 0;
  if (n_b == 0) {  // no pair reads B: any valid map will do
    b_hi = a_hi;
    b_lo = a_lo;
    n_b = n_a;
    b_cols = p.bs;
  }
  const bool split = a_lo != nullptr;
  const int bs = p.bs;
  Maps maps;
  int err = encode(&maps.a_hi, a_hi, bs, bs, n_a, kDepth, kTile);
  if (!err) err = encode(&maps.b_hi, b_hi, b_cols, bs, n_b, kTile / 2, kDepth);
  if (!err)
    err = encode(&maps.a_lo, split ? a_lo : a_hi, bs, bs, n_a, kDepth, kTile);
  if (!err)
    err = encode(&maps.b_lo, split ? b_lo : b_hi, b_cols, bs, n_b, kTile / 2,
                 kDepth);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return split ? launch_kernel<Src, true, kColNorms>(maps, src, p, st)
               : launch_kernel<Src, false, kColNorms>(maps, src, p, st);
}

}  // namespace tc
}  // namespace ntp
