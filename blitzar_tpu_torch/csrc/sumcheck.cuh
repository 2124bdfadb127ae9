// The per-lane arithmetic of the sumcheck round kernels (mont_sum_round.cu,
// mont_fold_round.cu) over mont.cuh, for the curve25519 scalar field and the
// Grumpkin base field, and the once-a-round finish of mont_sum_round.
// BTT_HD like mont.cuh, so the host harness runs the very code of the
// kernels on the CPU.
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

// A round works in evaluation form. Lane i's product of L factors
// prod_j (lo_j[i] + (hi_j[i] - lo_j[i]) X) is a polynomial of degree L,
// evaluated at X = 0..L; a factor's values there come by additions
// (lo, hi, hi + b, ...), and factors merge pairwise, the two of lowest
// degree first (Huffman order), a merge of degrees a and b at a + b + 1
// points: 0, 3, 7, 11, 16 multiplies for L = 1..5 (chip_smoke.py's
// merge_muls, the least it counts), where the coefficient form took
// (L - 1)(L + 2) + 2. A partial product is carried to more points by its
// finite differences, additions only. The lanes' values are summed per
// product; the multiplier, the carry to the round's D + 1 points and one
// interpolation to coefficients come once a round, after the sums
// (round_point, interp_term).

// lo + (hi - lo) X of MLE t at lane i, walked over X = 0, 1, 2, ...: v
// its value at the current point, next() one point on (one addition).
template <class F>
struct factor_walk {
  mfe<F> v, b;
  BTT_HD factor_walk(const mle_ptrs& m, int64_t mid, int64_t i, int t) {
    v = mle_load<F>(m, t, i);
    b = mf_sub<F>(mle_load<F>(m, t, mid + i), v);
  }
  BTT_HD void next() { v = mf_add<F>(v, b); }
};

// v[0..D] the values at 0..D of a polynomial of degree D -> v[D+1..N-1]
// its values at D+1..N-1, by additions: e[j] holds the j-th difference
// ending at the last known point; the D-th is constant, and each new point
// updates the differences from the top down.
template <class F, int D, int N>
BTT_HD void extend_points(mfe<F>* v) {
  if constexpr (N > D + 1) {
    mfe<F> w[D + 1], e[D + 1];
#pragma unroll
    for (int k = 0; k <= D; ++k) w[k] = v[k];
    e[0] = v[D];
#pragma unroll
    for (int j = 1; j <= D; ++j) {
#pragma unroll
      for (int k = 0; k + j <= D; ++k) w[k] = mf_sub<F>(w[k + 1], w[k]);
      e[j] = w[D - j];
    }
#pragma unroll
    for (int k = D + 1; k < N; ++k) {
#pragma unroll
      for (int j = D - 1; j >= 0; --j) e[j] = mf_add<F>(e[j], e[j + 1]);
      v[k] = e[0];
    }
  }
}

// The product of MLEs s and t at lane i, at X = 0..N-1 (3 multiplies, then
// additions).
template <class F, int N, class Mul>
BTT_HD void pair_points(const mle_ptrs& m, int64_t mid, int64_t i, int s, int t, mfe<F>* q) {
  Mul mul;
  factor_walk<F> f(m, mid, i, s), g(m, mid, i, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[k] = mul(f.v, g.v);
    if (k < 2) {
      f.next();
      g.next();
    }
  }
  extend_points<F, 2, N>(q);
}

// Lane i's product of the L MLEs at terms[0..L-1], at X = 0..L, added into
// acc[0..L]; values are consumed as they are made, so few stay live.
template <class F, int L, class Mul>
BTT_HD void add_product_points(const mle_ptrs& m, int64_t mid, int64_t i, const int32_t* terms, mfe<F>* acc) {
  Mul mul;
  if constexpr (L == 1) {
    factor_walk<F> f(m, mid, i, terms[0]);
    acc[0] = mf_add<F>(acc[0], f.v);
    f.next();
    acc[1] = mf_add<F>(acc[1], f.v);
  } else if constexpr (L == 2) {
    factor_walk<F> f(m, mid, i, terms[0]), g(m, mid, i, terms[1]);
#pragma unroll
    for (int k = 0; k <= 2; ++k) {
      acc[k] = mf_add<F>(acc[k], mul(f.v, g.v));
      if (k < 2) {
        f.next();
        g.next();
      }
    }
  } else if constexpr (L == 3) {
    mfe<F> q[4];
    pair_points<F, 4, Mul>(m, mid, i, terms[0], terms[1], q);
    factor_walk<F> f(m, mid, i, terms[2]);
#pragma unroll
    for (int k = 0; k <= 3; ++k) {
      acc[k] = mf_add<F>(acc[k], mul(q[k], f.v));
      if (k < 3) f.next();
    }
  } else if constexpr (L == 4) {
    mfe<F> q[5], r[5];
    pair_points<F, 5, Mul>(m, mid, i, terms[0], terms[1], q);
    pair_points<F, 5, Mul>(m, mid, i, terms[2], terms[3], r);
#pragma unroll
    for (int k = 0; k <= 4; ++k) acc[k] = mf_add<F>(acc[k], mul(q[k], r[k]));
  } else {
    static_assert(L == 5, "products of 1..5 factors");
    mfe<F> q[6], r[6];
    pair_points<F, 6, Mul>(m, mid, i, terms[2], terms[3], q);
    pair_points<F, 4, Mul>(m, mid, i, terms[0], terms[1], r);
    factor_walk<F> f(m, mid, i, terms[4]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = mul(r[k], f.v);
      if (k < 3) f.next();
    }
    extend_points<F, 3, 6>(r);
#pragma unroll
    for (int k = 0; k <= 5; ++k) acc[k] = mf_add<F>(acc[k], mul(r[k], q[k]));
  }
}

// The round polynomial at X = k (0 <= k <= D): sum over the products of
// multiplier times the product's lane sum at k. sums holds, for each
// product p, its lane sums at 0..L from column p (D + 1) on; a shorter
// product is carried to k by its differences.
template <class F, int D>
BTT_HD mfe<F> round_point(const product_ptrs& prods, const mfe<F>* sums, int k) {
  mfe<F> total = mf_zero<F>();
  for (int p = 0; p < prods.num_products; ++p) {
    const int col = p * (D + 1);
    const mfe<F> mult = mf_load<F>(prods.mults + p, prods.num_products);
    const int len = prods.lengths[p];
    mfe<F> v[D + 1];
#pragma unroll
    for (int j = 0; j <= D; ++j) {
      if (j <= len) v[j] = sums[col + j];
    }
    switch (len) {
      case 1: extend_points<F, 1, D + 1>(v); break;
      case 2: extend_points<F, 2, D + 1>(v); break;
      case 3: extend_points<F, 3, D + 1>(v); break;
      case 4: extend_points<F, 4, D + 1>(v); break;
      default: break;
    }
    mfe<F> at = v[0];
#pragma unroll
    for (int j = 1; j <= D; ++j) {
      if (j == k) at = v[j];
    }
    total = mf_add<F>(total, mf_mul<F>(mult, at));
  }
  return total;
}

// Term k of coefficient j of the round polynomial, whose values at 0..D
// are values[0..D]: entry (j, k) of the inverse Vandermonde matrix of the
// points 0..D (interp, (2K limbs, (D + 1)^2) canonical Montgomery
// constants, ops/cuda_mont.py:interpolation) times values[k]; coefficient j
// is the sum of its D + 1 terms.
template <class F, int D>
BTT_HD mfe<F> interp_term(const int32_t* interp, const mfe<F>* values, int j, int k) {
  return mf_mul<F>(mf_load<F>(interp + j * (D + 1) + k, (D + 1) * (D + 1)), values[k]);
}

// (1 - r) lo + r hi as lo + r (hi - lo): the same field element, one
// multiply.
template <class F>
BTT_HD mfe<F> fold_lane(const mfe<F>& lo, const mfe<F>& hi, const mfe<F>& r) {
  return mf_add<F>(lo, mf_mul<F>(r, mf_sub<F>(hi, lo)));
}

}  // namespace btt
