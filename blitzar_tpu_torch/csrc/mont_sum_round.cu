// mont_sum_round: one sumcheck round polynomial,
// out[k] = sum_i sum_p mult_p * coeff_k(prod_j (lo_j[i] + (hi_j[i] - lo_j[i]) X)),
// k = 0..degree, over the mid lanes of an (2K, m, 2 mid) MLE table.
//
// Replaces blitzar_tpu/ops/pallas_point.py:mont_sum_round (:1077, body
// _mont_sum_body_factory :1026) for the curve25519 scalar field and the
// Grumpkin base field, picked by the field's C ABI id; the degree (1..5)
// picks one of five instantiations. The product table is data (three small
// device arrays), not a template: one build serves every proof shape.
//
// Design, one launch a round: a grid of 128-thread blocks, as many as the
// card holds at once (the occupancy of the instantiation times the SMs),
// grid-stride over the lanes. For each product, every thread adds its
// lanes' values at X = 0..L (sumcheck.cuh: evaluation form,
// Huffman-ordered merges, 7 multiplies a lane for 3 factors) into L + 1
// accumulators in registers; the block sums them by warp shuffles and one
// shared-memory stage and writes one partial per (product, point). The
// last block to finish (an atomic ticket in a word the wrapper keeps for
// the stream, reset by that block) sums each column's partials into the
// column sums, a global slice after the partials, applies each product's
// multiplier once, carries the sums to the round's D + 1 points and
// interpolates to the coefficients, with constants from the wrapper; a
// round of one block writes the column sums straight and skips the ticket.
// Nothing is sized by the number of products but the scratch. The prover
// merges products of the same MLEs before the rounds
// (proof/sumcheck.py:product_arrays). Every multiply of the lanes calls one
// non-inlined Montgomery body (mf_mul_call: inlined, the degree-5 kernel
// took 1.9x as long). Sums mod m are exact, so the result is the
// coefficient form's limb for limb. Bound: bytes (64 bytes read per MLE
// element) or the multiplies, whichever is larger.
#include <cuda_runtime.h>

#include "sumcheck.cuh"

using namespace btt;

namespace {

// threads a block: at the degree-3 instantiation's ~150 registers, three
// blocks an SM (two of 256 would not fit); PERF.md §6 has 256 against 128
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The sum of v over the warp, in lane 0.
template <class F>
__device__ __forceinline__ mfe<F> warp_sum(mfe<F> v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mfe<F> o;
#pragma unroll
    for (int w = 0; w < F::K; ++w) o.v[w] = __shfl_down_sync(0xffffffffu, v.v[w], d);
    v = mf_add<F>(v, o);
  }
  return v;
}

// partials: (column, block) elements of K words
template <class F>
__device__ __forceinline__ uint32_t* partial_at(uint32_t* partials, int col, int64_t block) {
  return partials + ((int64_t)col * gridDim.x + block) * F::K;
}

// The block's sums of acc[0..N-1] to columns col..col+N-1: of the partials,
// or, when the block is the whole grid, straight to the column sums.
template <class F, int N>
__device__ __forceinline__ void block_sums(const mfe<F>* acc, mfe<F>* sh, uint32_t* partials, mfe<F>* colsums,
                                           int col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const mfe<F> s = warp_sum<F>(acc[k]);
    if (lane == 0) sh[warp * N + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    mfe<F> s = sh[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s = mf_add<F>(s, sh[w * N + threadIdx.x]);
    if (gridDim.x == 1) {
      colsums[col + threadIdx.x] = s;
    } else {
      uint32_t* dst = partial_at<F>(partials, col + threadIdx.x, blockIdx.x);
#pragma unroll
      for (int w = 0; w < F::K; ++w) dst[w] = s.v[w];
      __threadfence();
    }
  }
  __syncthreads();
}

// One product of L factors (its MLEs at terms) over the thread's lanes,
// summed to columns col..col+L.
template <class F, int L>
__device__ __forceinline__ void sum_product(const mle_ptrs& mles, int64_t mid, const int32_t* terms, mfe<F>* sh,
                                            uint32_t* partials, mfe<F>* colsums, int col) {
  mfe<F> acc[L + 1];
#pragma unroll
  for (int k = 0; k <= L; ++k) acc[k] = mf_zero<F>();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < mid; i += stride) {
    add_product_points<F, L, mf_mul_call_op<F>>(mles, mid, i, terms, acc);
  }
  block_sums<F, L + 1>(acc, sh, partials, colsums, col);
}

// Product p's sums at its points 0..L are columns p (D + 1) + 0..L of the
// partials and of the column sums (global, written and read by one block).
template <class F, int D>
__global__ void __launch_bounds__(kThreads)
mont_sum_round_kernel(mle_ptrs mles, int64_t mid, product_ptrs prods, const int32_t* interp, uint32_t* partials,
                      mfe<F>* colsums, unsigned* ticket, int32_t* out) {
  constexpr int kTerms = (D + 1) * (D + 1);
  __shared__ mfe<F> sh[kWarps * (D + 1) > kTerms ? kWarps * (D + 1) : kTerms];
  __shared__ mfe<F> values[D + 1];
  __shared__ bool last;
  const int num = prods.num_products;

  int first = 0;
  for (int p = 0; p < num; first += prods.lengths[p], ++p) {
    const int32_t* terms = prods.terms + first;
    const int col = p * (D + 1);
    switch (prods.lengths[p]) {
      case 1: sum_product<F, 1>(mles, mid, terms, sh, partials, colsums, col); break;
      case 2: if constexpr (D >= 2) sum_product<F, 2>(mles, mid, terms, sh, partials, colsums, col); break;
      case 3: if constexpr (D >= 3) sum_product<F, 3>(mles, mid, terms, sh, partials, colsums, col); break;
      case 4: if constexpr (D >= 4) sum_product<F, 4>(mles, mid, terms, sh, partials, colsums, col); break;
      case 5: if constexpr (D >= 5) sum_product<F, 5>(mles, mid, terms, sh, partials, colsums, col); break;
      default: break;
    }
  }

  if (gridDim.x > 1) {
    // the last block to finish sums the partials
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p = 0; p < num; ++p) {
      const int col = p * (D + 1);
      for (int c = col + warp; c <= col + prods.lengths[p]; c += kWarps) {
        mfe<F> s = mf_zero<F>();
        for (int64_t b = lane; b < gridDim.x; b += 32) {
          const uint32_t* src = partial_at<F>(partials, c, b);
          mfe<F> v;
#pragma unroll
          for (int w = 0; w < F::K; ++w) v.v[w] = __ldcg(src + w);
          s = mf_add<F>(s, v);
        }
        s = warp_sum<F>(s);
        if (lane == 0) colsums[c] = s;
      }
    }
    if (threadIdx.x == 0) *ticket = 0;
    __syncthreads();
  }
  // the round's values at 0..D, then its coefficients, a term a thread
  if (threadIdx.x <= D) values[threadIdx.x] = round_point<F, D>(prods, colsums, threadIdx.x);
  __syncthreads();
  if (threadIdx.x < kTerms) {
    sh[threadIdx.x] = interp_term<F, D>(interp, values, threadIdx.x / (D + 1), threadIdx.x % (D + 1));
  }
  __syncthreads();
  if (threadIdx.x <= D) {
    mfe<F> c = sh[threadIdx.x * (D + 1)];
    for (int k = 1; k <= D; ++k) c = mf_add<F>(c, sh[threadIdx.x * (D + 1) + k]);
    mf_store<F>(out + threadIdx.x, D + 1, c);
  }
}

template <class F, int D>
void launch(mle_ptrs mles, int64_t mid, product_ptrs prods, const int32_t* interp, int64_t max_blocks,
            uint32_t* partials, unsigned* ticket, int32_t* out, cudaStream_t stream) {
  // the blocks the card holds at once, by the instantiation's occupancy
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mont_sum_round_kernel<F, D>, kThreads, 0);
    resident = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  int64_t blocks = (mid + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  // the column sums follow the partials
  mfe<F>* colsums = reinterpret_cast<mfe<F>*>(partials + (int64_t)prods.num_products * (D + 1) * max_blocks * F::K);
  mont_sum_round_kernel<F, D><<<(unsigned)blocks, kThreads, 0, stream>>>(mles, mid, prods, interp, partials,
                                                                          colsums, ticket, out);
}

template <class F>
int launch_degree(int degree, mle_ptrs mles, int64_t mid, product_ptrs prods, const int32_t* interp,
                  int64_t max_blocks, uint32_t* partials, unsigned* ticket, int32_t* out, cudaStream_t s) {
  switch (degree) {
    case 1: launch<F, 1>(mles, mid, prods, interp, max_blocks, partials, ticket, out, s); return 0;
    case 2: launch<F, 2>(mles, mid, prods, interp, max_blocks, partials, ticket, out, s); return 0;
    case 3: launch<F, 3>(mles, mid, prods, interp, max_blocks, partials, ticket, out, s); return 0;
    case 4: launch<F, 4>(mles, mid, prods, interp, max_blocks, partials, ticket, out, s); return 0;
    case 5: launch<F, 5>(mles, mid, prods, interp, max_blocks, partials, ticket, out, s); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// field: 0 SXT_FIELD_SCALAR255, 1 SXT_FIELD_GRUMPKIN. mles: (2K, m, 2 mid)
// int32 limbs at (limb_stride, row_stride, 1); mults: (2K, num_products)
// contiguous; lengths (num_products,) and terms (sum of lengths,) int32,
// every length in 1..degree; interp: (2K, (degree + 1)^2) the inverse
// Vandermonde matrix of the points 0..degree; max_blocks: the blocks
// partials holds, at least 1; partials: num_products (degree + 1)
// (max_blocks + 1) K words of scratch, the partials ((column, block) K
// words each) then the column sums (a column K words); ticket: one word, 0 between launches on the stream (each launch
// leaves it 0); out: (2K, degree + 1) contiguous.
extern "C" int btt_mont_sum_round(int field, int degree, const void* mles, int64_t limb_stride, int64_t row_stride,
                                  int64_t mid, const void* mults, int num_products, const void* lengths,
                                  const void* terms, const void* interp, int64_t max_blocks, void* partials,
                                  void* ticket, void* out, void* stream) {
  if (num_products < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  mle_ptrs m = {(const int32_t*)mles, limb_stride, row_stride};
  product_ptrs p = {(const int32_t*)mults, (const int32_t*)lengths, (const int32_t*)terms, num_products};
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)interp;
  uint32_t* part = (uint32_t*)partials;
  unsigned* t = (unsigned*)ticket;
  int rc;
  switch (field) {
    case kFieldScalar255:
      rc = launch_degree<Scalar25519>(degree, m, mid, p, c, max_blocks, part, t, (int32_t*)out, s);
      break;
    case kFieldGrumpkin:
      rc = launch_degree<Bn254Fr>(degree, m, mid, p, c, max_blocks, part, t, (int32_t*)out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return rc ? rc : (int)cudaGetLastError();
}
