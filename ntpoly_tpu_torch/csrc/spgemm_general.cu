// General block-sparse SpGEMM kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ntpoly_tpu/ops/spgemm_pallas.py:_kernel
// (launched by _call_kernel, with its row chunking _row_chunk): C =
// alpha * A @ B in block-ELL, each candidate product A[r, s] @ B[acols[r,
// s], t] landing in the output slot plan[r, s * KB + t] that the
// structure pass assigned (dropped when >= k_out), followed by the
// threshold flush and per-slot L1 norms.
//
// Tiers, as _kernel computes them:
//   'high' on float32: the TPU's hand-made bf16x3 split (:169-180) on the
//       tensor cores, through the band kernel's pieces: its split pass
//       (spgemm_band.cu) writes the bfloat16 planes, and the product of
//       tc.cuh walks the pairs whose plan entry names the tile.
//   'bf16' and 'default' on float32: the hi planes alone ('default' is
//       the TPU's one bf16 pass).
//   'highest' (and every tier of float64, which the reference keeps
//       exact): exact FMA products on the three-stage cp.async ring of
//       tile.cuh, products in turn (s, then t), k ascending, one fma per
//       k, as the stream and window kernels add them, so the three agree
//       bit for bit.
//
// What bounds it on the H100: exact, the FP32 (or FP64) operations, 64
// per byte at bs = 128 in float32, so the kernel sits above the memory
// roofline and is limited by how well the register tile hides
// shared-memory traffic; on the tensor cores, the bytes of A, B and C or
// the three bf16 products, whichever is larger, plus the split pass's
// bytes.
//
// `run` (every entry): a device int, or null; when it holds 0 every block
// returns before any load (the band kernel's `run`, spgemm_band.cu).
//
// Design: output-stationary, no atomics, no second pass, no row chunking
// (the TPU's chunking existed for its scalar-memory limits).  Grid order
// slot-fastest (tile = r * k_out + g), so the blocks of one row run
// together and A[r, .] comes from L2.  B is read in its native [NBK, KB,
// bs, bs] layout with EMPTY slots skipped, so no panel copy is built.
#include "tc.cuh"
#include "tile.cuh"

namespace ntp {

// The pair index (tile.cuh) of the general kernel, for both tiers: the
// candidates p = s * KB + t; one feeds output slot g when its plan entry
// is g and neither A slot s nor B slot (acols[r, s], t) is EMPTY.
struct GeneralIndex {
  const int* a_cols;
  const int* b_cols;
  const int* plan;
  int ka, kb;

  __device__ int slots() const { return ka * kb; }
  __device__ int a_slot(int p) const { return p / kb; }
  __device__ int b_col(int) const { return 0; }  // B is block planes
  __device__ int64_t b_taken(int64_t r, int, int p) const {
    return int64_t(a_cols[r * ka + p / kb]) * kb + p % kb;
  }
  __device__ int64_t b_block(int64_t r, int g, int p) const {
    if (plan[r * ka * kb + p] != g) return -1;
    const int ac = a_cols[r * ka + p / kb];
    if (ac == kEmpty) return -1;
    const int64_t blk = int64_t(ac) * kb + p % kb;
    return b_cols[blk] == kEmpty ? -1 : blk;
  }
};

inline GeneralIndex general_index(const void* a_cols, const void* b_cols,
                                  const void* plan, int ka, int kb) {
  return {static_cast<const int*>(a_cols), static_cast<const int*>(b_cols),
          static_cast<const int*>(plan), ka, kb};
}

}  // namespace ntp

extern "C" {

int ntp_spgemm_general_f32(const void* a_cols, const void* a_blocks,
                           const void* b_cols, const void* b_blocks,
                           const void* plan, void* out, void* norms,
                           const void* run, int rows, int ka, int kb,
                           int k_out, int bs, double alpha,
                           double threshold, void* stream) {
  return ntp::launch_pairs<float>(
      ntp::general_index(a_cols, b_cols, plan, ka, kb), a_blocks, b_blocks,
      out, norms, rows, k_out, bs, alpha, threshold, run, stream);
}

int ntp_spgemm_general_f64(const void* a_cols, const void* a_blocks,
                           const void* b_cols, const void* b_blocks,
                           const void* plan, void* out, void* norms,
                           const void* run, int rows, int ka, int kb,
                           int k_out, int bs, double alpha,
                           double threshold, void* stream) {
  return ntp::launch_pairs<double>(
      ntp::general_index(a_cols, b_cols, plan, ka, kb), a_blocks, b_blocks,
      out, norms, rows, k_out, bs, alpha, threshold, run, stream);
}

// 'high' (a_lo and b_lo given) or 'bf16' (both null) on the bfloat16
// planes of A [rows, ka, bs, bs] and B [nbk, kb, bs, bs]; float32 out.
int ntp_spgemm_general_tc(const void* a_cols, const void* a_hi,
                          const void* a_lo, const void* b_cols,
                          const void* b_hi, const void* b_lo,
                          const void* plan, void* out, void* norms,
                          const void* run, int rows, int ka, int kb,
                          int nbk, int k_out, int bs, double alpha,
                          double threshold, void* stream) {
  const ntp::tc::Pairs<ntp::GeneralIndex> src{
      ntp::general_index(a_cols, b_cols, plan, ka, kb), k_out};
  const ntp::tc::Params p{static_cast<float*>(out),
                          static_cast<float*>(norms),
                          int64_t(rows) * k_out, bs, float(alpha),
                          float(threshold),
                          static_cast<const int*>(run)};
  return ntp::tc::launch(a_hi, a_lo, int64_t(rows) * ka, b_hi, b_lo,
                         int64_t(nbk) * kb, bs, src, p, stream);
}

const char* ntp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
