// mont_sum_round: one sumcheck round polynomial,
// out[k] = sum_i sum_p mult_p * coeff_k(prod_j (lo_j[i] + (hi_j[i] - lo_j[i]) X)),
// k = 0..degree, over the mid lanes of an (2K, m, 2 mid) MLE table.
//
// Replaces blitzar_tpu/ops/pallas_point.py:mont_sum_round (:1077, body
// _mont_sum_body_factory :1026) for the curve25519 scalar field and the
// Grumpkin base field, picked by the field's C ABI id; the degree (1..5)
// picks one of five instantiations, so the accumulators are registers. The
// product table is data (three small device arrays), not a template: one
// build serves every proof shape.
//
// Design: pass 1, thread per lane (grid-stride), expands its lanes' products
// (sumcheck.cuh:sum_lane) into degree + 1 accumulators; each block then sums
// its threads' accumulators by modular adds in shared memory, one
// coefficient at a time, and writes one partial per coefficient. Pass 2, one
// block, sums the partials the same way. There is no atomic add on field
// elements, and every sum is exact mod m, so the order of additions does not
// change the result. Work: (len - 1)(len + 2) field multiplies a lane per
// product of len factors (2 more for the multiplier), 264 32-bit multiplies
// each, and 64 bytes read per MLE element. The function needs fewer
// multiplies (evaluation form, identical products once): chip_smoke.py's
// bound counts those.
#include <cuda_runtime.h>

#include "sumcheck.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 256;

// The sum of v over the block's threads, stored by thread 0 at out (limb
// stride ``stride``). v comes by value and the function is inlined, so the
// callers' accumulators stay in registers.
template <class F>
__device__ __forceinline__ void block_sum_store(mfe<F>* sh, mfe<F> v, int32_t* out, int64_t stride) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = mf_add<F>(sh[tid], sh[tid + s]);
    __syncthreads();
  }
  if (tid == 0) mf_store<F>(out, stride, sh[0]);
  __syncthreads();
}

// partials: (2K, D + 1, gridDim.x) int32 limbs
template <class F, int D>
__global__ void __launch_bounds__(kThreads)
mont_sum_round_kernel(mle_ptrs mles, int64_t mid, product_ptrs prods, int32_t* partials) {
  __shared__ mfe<F> sh[kThreads];
  mfe<F> acc[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) acc[k] = mf_zero<F>();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < mid; i += (int64_t)gridDim.x * kThreads) {
    sum_lane<F, D>(mles, mid, i, prods, acc);
  }
  const int64_t nblocks = gridDim.x;
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    block_sum_store<F>(sh, acc[k], partials + k * nblocks + blockIdx.x, (D + 1) * nblocks);
  }
}

// one block: out (2K, ncoeffs) = the sums over nblocks of partials
// (2K, ncoeffs, nblocks)
template <class F>
__global__ void __launch_bounds__(kThreads)
mont_sum_partials_kernel(const int32_t* partials, int ncoeffs, int64_t nblocks, int32_t* out) {
  __shared__ mfe<F> sh[kThreads];
  for (int k = 0; k < ncoeffs; ++k) {
    mfe<F> acc = mf_zero<F>();
    for (int64_t j = threadIdx.x; j < nblocks; j += kThreads) {
      acc = mf_add<F>(acc, mf_load<F>(partials + k * nblocks + j, ncoeffs * nblocks));
    }
    block_sum_store<F>(sh, acc, out + k, ncoeffs);
  }
}

template <class F, int D>
void launch(mle_ptrs mles, int64_t mid, product_ptrs prods, int64_t nblocks, int32_t* partials, int32_t* out,
            cudaStream_t stream) {
  mont_sum_round_kernel<F, D><<<(unsigned)nblocks, kThreads, 0, stream>>>(mles, mid, prods, partials);
  mont_sum_partials_kernel<F><<<1, kThreads, 0, stream>>>(partials, D + 1, nblocks, out);
}

template <class F>
int launch_degree(int degree, mle_ptrs mles, int64_t mid, product_ptrs prods, int64_t nblocks, int32_t* partials,
                  int32_t* out, cudaStream_t stream) {
  switch (degree) {
    case 1: launch<F, 1>(mles, mid, prods, nblocks, partials, out, stream); return 0;
    case 2: launch<F, 2>(mles, mid, prods, nblocks, partials, out, stream); return 0;
    case 3: launch<F, 3>(mles, mid, prods, nblocks, partials, out, stream); return 0;
    case 4: launch<F, 4>(mles, mid, prods, nblocks, partials, out, stream); return 0;
    case 5: launch<F, 5>(mles, mid, prods, nblocks, partials, out, stream); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// field: 0 SXT_FIELD_SCALAR255, 1 SXT_FIELD_GRUMPKIN. mles: (2K, m, 2 mid)
// int32 limbs at (limb_stride, row_stride, 1); mults: (2K, num_products)
// contiguous; lengths (num_products,) and terms (sum of lengths,) int32;
// nblocks: pass 1's blocks, at least 1 (the wrapper takes one per 256 lanes,
// at most 1024); partials: (2K, degree + 1, nblocks) scratch; out:
// (2K, degree + 1) contiguous.
extern "C" int btt_mont_sum_round(int field, int degree, const void* mles, int64_t limb_stride, int64_t row_stride,
                                  int64_t mid, const void* mults, int num_products, const void* lengths,
                                  const void* terms, int64_t nblocks, void* partials, void* out, void* stream) {
  mle_ptrs m = {(const int32_t*)mles, limb_stride, row_stride};
  product_ptrs p = {(const int32_t*)mults, (const int32_t*)lengths, (const int32_t*)terms, num_products};
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (field) {
    case kFieldScalar255:
      rc = launch_degree<Scalar25519>(degree, m, mid, p, nblocks, (int32_t*)partials, (int32_t*)out, s);
      break;
    case kFieldGrumpkin:
      rc = launch_degree<Bn254Fr>(degree, m, mid, p, nblocks, (int32_t*)partials, (int32_t*)out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}
