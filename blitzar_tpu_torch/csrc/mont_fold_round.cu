// mont_fold_round: the sumcheck fold, out[t, i] = (1 - r) lo[t, i] + r hi[t, i]
// for the m MLEs t and the mid lanes i of an (2K, m, 2 mid) table (lo the
// first half of each MLE, hi the second), r broadcast.
//
// Replaces blitzar_tpu/ops/pallas_point.py:mont_fold_round (:1172, body
// _mont_fold_body_factory :1110) for the curve25519 scalar field and the
// Grumpkin base field, picked by the field's C ABI id. It computes
// lo + r (hi - lo) (sumcheck.cuh:fold_lane): the same field element with one
// multiply instead of two.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring lanes of one MLE, so every limb row is read and written
// coalesced; the output is a fresh (2K, m, mid) table, half the input. Bound:
// bytes at every round of a proof (64 bytes read twice and written once per
// output element against one 264-multiply field multiply).
#include <cuda_runtime.h>

#include "sumcheck.cuh"

using namespace btt;

namespace {

template <class F>
__global__ void __launch_bounds__(256)
mont_fold_round_kernel(mle_ptrs mles, int64_t m, int64_t mid, const int32_t* r_limbs, int64_t r_stride,
                       int32_t* out) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * mid) return;
  const int t = (int)(idx / mid);
  const int64_t i = idx - t * mid;
  const mfe<F> r = mf_load<F>(r_limbs, r_stride);
  mf_store<F>(out + idx, m * mid, fold_lane<F>(mle_load<F>(mles, t, i), mle_load<F>(mles, t, mid + i), r));
}

template <class F>
void launch(mle_ptrs mles, int64_t m, int64_t mid, const int32_t* r, int64_t r_stride, int32_t* out,
            cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (m * mid + threads - 1) / threads;
  mont_fold_round_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(mles, m, mid, r, r_stride, out);
}

}  // namespace

// field: 0 SXT_FIELD_SCALAR255, 1 SXT_FIELD_GRUMPKIN. mles: (2K, m, 2 mid)
// int32 limbs at (limb_stride, row_stride, 1); r: 2K limbs at r_stride;
// out: (2K, m, mid) contiguous.
extern "C" int btt_mont_fold_round(int field, const void* mles, int64_t limb_stride, int64_t row_stride, int64_t m,
                                   int64_t mid, const void* r, int64_t r_stride, void* out, void* stream) {
  mle_ptrs t = {(const int32_t*)mles, limb_stride, row_stride};
  if (m * mid > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (field) {
      case kFieldScalar255: launch<Scalar25519>(t, m, mid, (const int32_t*)r, r_stride, (int32_t*)out, s); break;
      case kFieldGrumpkin: launch<Bn254Fr>(t, m, mid, (const int32_t*)r, r_stride, (int32_t*)out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
