// The per-lane arithmetic of the sumcheck round kernels (mont_sum_round.cu,
// mont_fold_round.cu) over mont.cuh, for the curve25519 scalar field and the
// Grumpkin base field. BTT_HD like mont.cuh, so the host harness runs the
// very code of the kernels on the CPU.
//
// A round's MLE table is (2K limbs, m, 2 mid) int32 Montgomery limbs, the
// public layout: element (t, i) has limb l at
// base[l * limb_stride + t * row_stride + i]. Lane i < mid pairs the low
// half's element i with the high half's element mid + i (reference
// sumcheck's lo/hi split, blitzar_tpu/proof/sumcheck.py:186-213).
#pragma once

#include "mont.cuh"

namespace btt {

// reference proof/sumcheck/constant.h:25
constexpr int kMaxDegree = 5;

struct mle_ptrs {
  const int32_t* base;
  int64_t limb_stride;
  int64_t row_stride;
};

// The product table of a proof: product p has lengths[p] MLE indices at
// terms[first_p ..], its multiplier mults (2K limbs, num_products) at limb
// stride num_products.
struct product_ptrs {
  const int32_t* mults;
  const int32_t* lengths;
  const int32_t* terms;
  int num_products;
};

template <class F>
BTT_HD mfe<F> mle_load(const mle_ptrs& m, int t, int64_t i) {
  return mf_load<F>(m.base + t * m.row_stride + i, m.limb_stride);
}

// Lane i's share of the round polynomial, added into acc[0..D]: for each
// product p, mult_p * prod_j (a_j + b_j X) with a_j = lo_j[i] and
// b_j = hi_j[i] - a_j, expanded by the incremental convolution of
// blitzar_tpu/ops/pallas_point.py:1037-1062. The multiplier enters with
// the first factor (mult a_0 + mult b_0 X): the same field element as
// blitzar_tpu's multiply after the lane sum, for 2 multiplies a lane.
// D is the proof's degree (the longest product); a shorter product fills
// coefficients 0..len only. Every index of c is a constant after
// unrolling, so c stays in registers.
template <class F, int D>
BTT_HD void sum_lane(const mle_ptrs& mles, int64_t mid, int64_t i, const product_ptrs& prods, mfe<F>* acc) {
  int first = 0;
  for (int p = 0; p < prods.num_products; ++p) {
    const int len = prods.lengths[p];
    const mfe<F> mult = mf_load<F>(prods.mults + p, prods.num_products);
    const int t0 = prods.terms[first];
    mfe<F> a = mle_load<F>(mles, t0, i);
    mfe<F> b = mf_sub<F>(mle_load<F>(mles, t0, mid + i), a);
    mfe<F> c[D + 1];
    c[0] = mf_mul<F>(mult, a);
    c[1] = mf_mul<F>(mult, b);
    for (int j = 1; j < len; ++j) {
      const int t = prods.terms[first + j];
      a = mle_load<F>(mles, t, i);
      b = mf_sub<F>(mle_load<F>(mles, t, mid + i), a);
      // c (degree j) times (a + b X): c'[j+1] = c[j] b, c'[k] = c[k] a +
      // c[k-1] b for 1 <= k <= j, c'[0] = c[0] a; from the top down, so
      // each c[k-1] is read before it is overwritten
#pragma unroll
      for (int k = D; k >= 1; --k) {
        if (k == j + 1) {
          c[k] = mf_mul<F>(c[k - 1], b);
        } else if (k <= j) {
          c[k] = mf_add<F>(mf_mul<F>(c[k], a), mf_mul<F>(c[k - 1], b));
        }
      }
      c[0] = mf_mul<F>(c[0], a);
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      if (k <= len) acc[k] = mf_add<F>(acc[k], c[k]);
    }
    first += len;
  }
}

// (1 - r) lo + r hi as lo + r (hi - lo): the same field element, one
// multiply.
template <class F>
BTT_HD mfe<F> fold_lane(const mfe<F>& lo, const mfe<F>& hi, const mfe<F>& r) {
  return mf_add<F>(lo, mf_mul<F>(r, mf_sub<F>(hi, lo)));
}

}  // namespace btt
