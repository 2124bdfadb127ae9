// The Weierstrass double-and-add ladder of w_doubling_combine.cu:
// out[o] = sum_b 2^b * products[o, b] over an output's nbits bit-row
// products, cut into segments of seg_bits bits (the last one shorter).
// w_doubling_combine.cu runs it on the card; host_harness.cpp runs the
// same code one lane after another, so the CPU tests
// (tests/test_torch_wladder.py) hold the kernel's order and arithmetic
// against the plain version limb for limb.
//
// Order: lane j folds its segment [j L, j L + len) by Horner from its top
// bit, h = 2 h + P[b] (blitzar_tpu/msm/fixed.py:611-623 on the segment);
// then lane 0 folds the segments from the top one down, acc = 2^L acc +
// h_j. With one segment (seg_bits = nbits) that is blitzar_tpu's ladder
// and its coordinates.
//
// Why segments: each output is a serial chain, and one thread runs it alone
// on the card. The doublings of the top bit are a chain no split shortens
// (nbits - 1 doublings of 8 dependent multiplies), but the adds can be
// shared: with S segments of L bits the lanes' Horner runs take L - 1 steps
// at once, and the fold L (S - 1) doublings and S - 1 adds, in place of
// nbits - 1 of each.
//
// The double and the add are one non-inlined body each, shared by the two
// phases, and each of their multiplies calls one non-inlined Montgomery
// body (mf_mul_call_op). With the multiplies inlined (20 copies of the
// Montgomery body in one warp's instruction stream) the ladder ran slower
// on the H100: 2.53 against 1.95 ms for a bn254 G1 256-bit output, 9.26 against
// 4.22 ms for bls12-381 G1 (kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6).
#pragma once

#include "weierstrass.cuh"

namespace btt {

template <class C>
BTT_CALL wpoint<C> w_ladder_double(wpoint<C> p) {
  return w_double<C>(p, mf_mul_call_op<typename C::F>());
}

template <class C>
BTT_CALL wpoint<C> w_ladder_add(wpoint<C> p, wpoint<C> q) {
  return w_add<C>(p, q, mf_mul_call_op<typename C::F>());
}

// Segments of an nbits ladder: ceil(nbits / seg_bits).
BTT_HD int w_ladder_segments(int nbits, int seg_bits) { return (nbits + seg_bits - 1) / seg_bits; }

// Lane j's Horner sum of products [base + lo, base + lo + len), lo = j L.
template <class C>
BTT_HD wpoint<C> w_ladder_segment(const wpoint_ptrs& products, int64_t base, int nbits, int seg_bits, int j) {
  const int lo = j * seg_bits;
  const int hi = lo + seg_bits < nbits ? lo + seg_bits : nbits;
  wpoint<C> h = w_load<C>(products, base + hi - 1);
  for (int b = hi - 2; b >= lo; --b) h = w_ladder_add<C>(w_ladder_double<C>(h), w_load<C>(products, base + b));
  return h;
}

// sum_j 2^(j L) seg[j] over nseg segments, from the top one down.
template <class C>
BTT_HD wpoint<C> w_ladder_fold(const wpoint<C>* seg, int nseg, int seg_bits) {
  wpoint<C> acc = seg[nseg - 1];
  for (int j = nseg - 2; j >= 0; --j) {
    for (int i = 0; i < seg_bits; ++i) acc = w_ladder_double<C>(acc);
    acc = w_ladder_add<C>(acc, seg[j]);
  }
  return acc;
}

}  // namespace btt
