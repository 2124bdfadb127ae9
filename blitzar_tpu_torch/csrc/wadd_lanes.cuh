// wadd.cu's complete Weierstrass add at eight lanes a pair: the stages of
// one w_add (weierstrass.cuh, Renes-Costello-Batina Algorithm 7, a = 0)
// spread over a group of eight lanes of a warp, lane j computing product j
// of each stage (lanes 6 and 7 repeat product 5, whose copies are never
// read).
//
// Stage 1, product k (0..5): X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2),
// (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2); a lane loads only the
// coordinates of its own products. The six products are exchanged within
// the group (__shfl_sync on the card; the host harness runs the lanes'
// stages in turn over an array). Stage 2, on every lane: w_add's sums and
// its two mul_b3 chains. Stage 3, product k: t3 t1, t4 y3, t1 z3, y3 t0,
// z3 t4, t0 t3; products 2c and 2c + 1 sit on neighbouring lanes, are
// summed across them (X3 = Q0 - Q1, Y3 = Q2 + Q3, Z3 = Q4 + Q5) and
// stored by the even lane. The formulas and the order of every modular
// operation are w_add's, so the canonical outputs equal the one-thread
// add's (and blitzar_tpu/curves/weierstrass.py _add_impl's) limb for limb.
// A lane's dependent chain is 2 multiplies where one thread's is 12. (Four
// lanes, two products a lane a stage, ran 17-58% slower at the paths'
// batches on the H100: PERF.md §6.)
//
// With negate_q, q is read as (X, -Y, Z): the lanes whose products read
// q's Y load it as p - Y (a modular subtraction), and no multiply is
// added. Operands are picked by selects, not branches, so the lanes of a
// warp do not diverge on the multiplies; only a lane's loads depend on its
// products.
#pragma once

#include "weierstrass.cuh"

namespace btt {

constexpr int kWaddProducts = 6;  // independent products a stage of w_add
constexpr int kWaddLanes = 8;     // lanes a pair: the products' count rounded up to a power of two
constexpr int kWaddThreads = 64;  // a block: 8 pairs, so a small batch spreads over many SMs

template <class F>
BTT_HD mfe<F> mf_select(const mfe<F>& a, const mfe<F>& b, bool take_b) {
  mfe<F> r;
#pragma unroll
  for (int w = 0; w < F::K; ++w) r.v[w] = take_b ? b.v[w] : a.v[w];
  return r;
}

BTT_HD const int32_t* w_coord(const wpoint_ptrs& p, int c) { return c == 0 ? p.c[0] : c == 1 ? p.c[1] : p.c[2]; }

BTT_HD int32_t* w_coord(const wpoint_out_ptrs& p, int c) { return c == 0 ? p.c[0] : c == 1 ? p.c[1] : p.c[2]; }

// Lane j's product of each stage: j, lanes past the sixth product
// repeating the last.
BTT_HD int w_lanes_product(int lane) { return lane < kWaddProducts ? lane : kWaddProducts - 1; }

// One side's operand of stage-1 product k at pair i: its coordinate a_k,
// plus b_k for the sums (k >= 3); Y read negated with negate_y.
template <class C>
BTT_HD mfe<typename C::F> w_lanes_operand(const wpoint_ptrs& p, int64_t i, int k, bool negate_y) {
  using F = typename C::F;
  const int a = k == 1 || k == 4 ? 1 : (k == 2 ? 2 : 0);  // X, Y, Z, X, Y, X
  const int b = k == 3 ? 1 : 2;                           // the sums' second: Y, Z, Z
  mfe<F> u = mf_load<F>(w_coord(p, a) + i, p.limb_stride);
  mfe<F> v = mf_zero<F>();
  if (k >= 3) v = mf_load<F>(w_coord(p, b) + i, p.limb_stride);
  u = mf_select<F>(u, mf_neg<F>(u), negate_y && a == 1);
  v = mf_select<F>(v, mf_neg<F>(v), negate_y && k == 3);
  return mf_select<F>(u, mf_add<F>(u, v), k >= 3);
}

// Stage 1, product k of pair i.
template <class C, class Mul>
BTT_HD mfe<typename C::F> w_lanes_first(int k, const wpoint_ptrs& p, const wpoint_ptrs& q, int64_t i, bool negate_q,
                                        Mul mul) {
  return mul(w_lanes_operand<C>(p, i, k, false), w_lanes_operand<C>(q, i, k, negate_q));
}

// Stages 2 and 3, product k, from the group's six stage-1 products s.
template <class C, class Mul>
BTT_HD mfe<typename C::F> w_lanes_last(int k, const mfe<typename C::F>* s, Mul mul) {
  using F = typename C::F;
  mfe<F> t0 = s[0], t1 = s[1], t2 = s[2];
  const mfe<F> t3 = mf_sub<F>(s[3], mf_add<F>(t0, t1));  // x1y2 + x2y1
  const mfe<F> t4 = mf_sub<F>(s[4], mf_add<F>(t1, t2));  // y1z2 + y2z1
  mfe<F> y3 = mf_sub<F>(s[5], mf_add<F>(t0, t2));        // x1z2 + x2z1
  t0 = mf_add<F>(mf_add<F>(t0, t0), t0);                 // 3 x1x2
  t2 = C::mul_b3(t2);
  const mfe<F> z3 = mf_add<F>(t1, t2);
  t1 = mf_sub<F>(t1, t2);
  y3 = C::mul_b3(y3);
  // (u, v) of product k: (t3, t1), (t4, y3), (t1, z3), (y3, t0), (z3, t4), (t0, t3)
  const mfe<F> u = mf_select<F>(
      mf_select<F>(mf_select<F>(t3, t4, k == 1), mf_select<F>(t1, y3, k == 3), k >= 2),
      mf_select<F>(z3, t0, k == 5), k >= 4);
  const mfe<F> v = mf_select<F>(
      mf_select<F>(mf_select<F>(t1, y3, k == 1), mf_select<F>(z3, t0, k == 3), k >= 2),
      mf_select<F>(t4, t3, k == 5), k >= 4);
  return mul(u, v);
}

// Coordinate k / 2 of the sum from the stage-3 products k (even) and k + 1.
template <class F>
BTT_HD mfe<F> w_lanes_coord(int k, const mfe<F>& even, const mfe<F>& odd) {
  return mf_select<F>(mf_add<F>(even, odd), mf_sub<F>(even, odd), k == 0);
}

#if defined(__CUDACC__)
// Every lane of a group gets the group's six stage-1 products, product k
// from lane k.
template <class F>
__device__ __forceinline__ void w_lanes_exchange(const mfe<F>& mine, mfe<F>* s) {
#pragma unroll
  for (int k = 0; k < kWaddProducts; ++k) {
#pragma unroll
    for (int w = 0; w < F::K; ++w) s[k].v[w] = __shfl_sync(0xffffffffu, mine.v[w], k, kWaddLanes);
  }
}

// The neighbouring lane's value (lane j ^ 1 of the group).
template <class F>
__device__ __forceinline__ mfe<F> w_lanes_partner(const mfe<F>& a) {
  mfe<F> r;
#pragma unroll
  for (int w = 0; w < F::K; ++w) r.v[w] = __shfl_xor_sync(0xffffffffu, a.v[w], 1, kWaddLanes);
  return r;
}
#endif

}  // namespace btt
