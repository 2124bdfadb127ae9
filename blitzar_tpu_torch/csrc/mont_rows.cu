// mont_from_rows: the proofs' uint8 ABI rows to the canonical Montgomery
// limb table, zero-padded, in one launch (schedule and body in
// mont_rows.cuh).
//
// Replaces no Pallas kernel: blitzar_tpu converts the rows on its device
// under jit (blitzar_tpu/proof/inner_product.py:88-104 `_from_bytes_jit`,
// `_mont_from_rows`; blitzar_tpu/proof/sumcheck.py:63-87
// `_from_bytes_field_jit`, `mles_to_device`), where the port split them
// into limbs with numpy on the host, copied int32 limbs (twice the rows'
// bytes) to the card and launched mont_mul_ew. Here the rows cross as they
// are and the split, the multiply and the padding are one launch.
//
// Bound: integer multiplies. At the sumcheck's 3 x 2^20 rows of 32 bytes,
// 100.7 MB read and 201.3 MB written (~0.09 ms at 3.35 TB/s) against one
// K = 8 Montgomery multiply an element (4K^2 + K = 264 32-bit multiplies).
// Design: a block's rows are staged through shared memory by 16-byte loads
// so the reads are coalesced, one thread an element, its limbs stored a
// limb row apart so the writes are coalesced; the padding is written by the
// same threads.
#include <cuda_runtime.h>

#include "mont_rows.cuh"

using namespace btt;

template <class F>
__global__ void __launch_bounds__(kRowsThreads)
mont_rows_kernel(const uint8_t* rows, int64_t total_bytes, int64_t n, int nbytes, int64_t n_pad, int64_t col_blocks,
                 int64_t out_stride, const int32_t* scale, int32_t* out) {
  __shared__ uint4 stage[kRowsStageBytes / 16];
  uint8_t* staged = (uint8_t*)stage;
  const rows_span s = rows_span_of(blockIdx.x, col_blocks, n, nbytes);
  for (int64_t o = 16 * (int64_t)threadIdx.x; s.a0 + o < s.a1; o += 16 * kRowsThreads) {
    const int64_t at = s.a0 + o;
    if (at + 16 <= total_bytes) {
      stage[o / 16] = __ldg((const uint4*)(rows + at));
    } else {
      for (int64_t b = at; b < total_bytes; ++b) staged[o + b - at] = rows[b];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int64_t col = s.first + t;
  if (col >= n_pad) return;
  const mfe<F> c = mf_load<F>(scale, 1);
  const uint8_t* row = t < s.live ? staged + s.skew + (int64_t)t * nbytes : nullptr;
  mf_store<F>(out + s.mle * n_pad + col, out_stride, mont_row_element<F>(row, nbytes, c));
}

template <class F>
void launch(const uint8_t* rows, int64_t num_mles, int64_t n, int nbytes, int64_t n_pad, const int32_t* scale,
            int32_t* out, cudaStream_t stream) {
  const int64_t col_blocks = (n_pad + kRowsThreads - 1) / kRowsThreads;
  mont_rows_kernel<F><<<(unsigned)(num_mles * col_blocks), kRowsThreads, 0, stream>>>(
      rows, num_mles * n * nbytes, n, nbytes, n_pad, col_blocks, num_mles * n_pad, scale, out);
}

// field: 0 SXT_FIELD_SCALAR255, 1 SXT_FIELD_GRUMPKIN. rows: (num_mles * n,
// nbytes) uint8, C-contiguous, 16-byte aligned, nbytes in 1..32; scale: 2K
// canonical limbs (R^2 or R mod m); out: (2K, num_mles, n_pad) int32,
// n_pad >= n. Returns cudaErrorInvalidValue for another field or shape.
extern "C" int btt_mont_from_rows(int field, const void* rows, int64_t num_mles, int64_t n, int nbytes, int64_t n_pad,
                                  const void* scale, void* out, void* stream) {
  if (nbytes < 1 || nbytes > kRowsMaxBytes || n < 0 || n_pad < n || num_mles < 0 || (((uintptr_t)rows) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_mles > 0 && n_pad > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const uint8_t* r = (const uint8_t*)rows;
    const int32_t* c = (const int32_t*)scale;
    switch (field) {
      case kFieldScalar255: launch<Scalar25519>(r, num_mles, n, nbytes, n_pad, c, (int32_t*)out, s); break;
      case kFieldGrumpkin: launch<Bn254Fr>(r, num_mles, n, nbytes, n_pad, c, (int32_t*)out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
