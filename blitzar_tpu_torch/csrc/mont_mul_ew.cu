// mont_mul_ew: the elementwise Montgomery product out[i] = a[i] b[i] R^-1,
// b either a full batch or one element broadcast over a.
//
// Replaces blitzar_tpu/ops/pallas_point.py:mont_mul_ew (:1139, body
// _mont_mul_body_factory :1128) for the curve25519 scalar field (every
// full-width scalar multiply of the IPA) and the Grumpkin base field, picked
// by the field's C ABI id, and for the base fields of bn254 G1 and bls12-381
// G1 (ids 2 and 3: the scans of a Weierstrass table's batch inversion, which
// blitzar_tpu/msm/interop.py:_w_affine_xy runs in plain jnp). The TPU version pads to 1024-lane blocks
// (MONT_SUM_BLK); this one computes the function on any count.
//
// b must be canonical (below m); a may be any K-word value below R
// (mont.cuh:mf_mul): so a raw 256-bit row times R^2 mod m is its reduced
// Montgomery form, and times R mod m its reduced residue, in one launch.
//
// Design: one thread per element, neighbouring threads on neighbouring
// elements of each limb row (coalesced); a broadcast b is read by every
// thread from the same 2K words (cached). Bound: bytes (64 bytes read twice
// and written once per element against one 264-multiply field multiply).
#include <cuda_runtime.h>

#include "mont.cuh"

using namespace btt;

namespace {

template <class F>
__global__ void __launch_bounds__(256)
mont_mul_ew_kernel(const int32_t* a, int64_t a_stride, const int32_t* b, int64_t b_stride, int64_t b_step,
                   int64_t count, int32_t* out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  mf_store<F>(out + i, count, mf_mul<F>(mf_load<F>(a + i, a_stride), mf_load<F>(b + i * b_step, b_stride)));
}

template <class F>
void launch(const int32_t* a, int64_t a_stride, const int32_t* b, int64_t b_stride, int64_t b_step, int64_t count,
            int32_t* out, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (count + threads - 1) / threads;
  mont_mul_ew_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(a, a_stride, b, b_stride, b_step, count, out);
}

}  // namespace

// field: 0 SXT_FIELD_SCALAR255, 1 SXT_FIELD_GRUMPKIN (the Grumpkin base
// field), 2 the bn254 base field, 3 the bls12-381 base field. a: (2K, count) int32
// limbs at a_stride; b: 2K limbs at b_stride, element i at b + i * b_step
// (b_step 0: broadcast); out: (2K, count) contiguous.
extern "C" int btt_mont_mul_ew(int field, const void* a, int64_t a_stride, const void* b, int64_t b_stride,
                               int64_t b_step, int64_t count, void* out, void* stream) {
  if (count > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* pa = (const int32_t*)a;
    const int32_t* pb = (const int32_t*)b;
    switch (field) {
      case kFieldScalar255: launch<Scalar25519>(pa, a_stride, pb, b_stride, b_step, count, (int32_t*)out, s); break;
      case kFieldGrumpkin: launch<Bn254Fr>(pa, a_stride, pb, b_stride, b_step, count, (int32_t*)out, s); break;
      case kFieldBn254Fp: launch<Bn254Fp>(pa, a_stride, pb, b_stride, b_step, count, (int32_t*)out, s); break;
      case kFieldBls12381Fp: launch<Bls12381Fp>(pa, a_stride, pb, b_stride, b_step, count, (int32_t*)out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
