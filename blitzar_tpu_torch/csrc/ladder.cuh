// The double-and-add ladder of doubling_combine.cu (ristretto255) and
// w_doubling_combine.cu (bls12-381 G1, bn254 G1, Grumpkin): out[o] =
// sum_b 2^b * products[o, b] over an output's nbits bit-row products, cut
// into segments of seg_bits bits (the last one shorter), one template over
// a point policy (its load, store, double and add). Both kernels are
// launchers of ladder_kernel; host_harness.cpp runs the same code one lane
// after another, so the CPU tests (tests/test_torch_wladder.py) hold the
// kernels' order and arithmetic against the plain versions limb for limb.
//
// The same ladder with step_bits doublings a step is the bucket engine's
// Horner over its windows, out[o] = sum_w 2^(step_bits w) windows[o, w]
// (ed_horner.cu, w_horner.cu: step_bits = 8, one 8-bit window a step;
// tests/test_torch_horner.py). The query ladders take step_bits = 1.
//
// Order: lane j folds its segment [j L, j L + len) by Horner from its top
// bit, h = 2^step_bits h + P[b] (blitzar_tpu/msm/fixed.py:611-623 on the
// segment; blitzar_tpu/msm/engine.py:118-140 for the windows); then lane 0
// folds the segments from the top one down, acc = 2^(L step_bits) acc +
// h_j. With one segment (seg_bits = nbits) that is blitzar_tpu's ladder
// and its coordinates (blitzar_tpu/ops/pallas_point.py:_combine_tiled :982
// for ristretto255), and the engine's Horner loop.
//
// Why segments: each output is a serial chain, and one thread runs it alone
// on the card. The doublings of the top bit are a chain no split shortens
// ((nbits - 1) step_bits doublings), but the adds can be shared: with S
// segments of L bits the lanes' Horner runs take L - 1 steps at once, and
// the fold L (S - 1) steps of doublings and S - 1 adds, in place of nbits -
// 1 of each. At 256 bits (16 segments of 16) the critical path is 255
// doublings and 30 adds; a 32-window Horner (6 segments of 6) 248
// doublings and 6 adds where one segment takes 248 and 31.
//
// The double and the add are one non-inlined body each, shared by the two
// phases. Weierstrass: each multiply calls one non-inlined Montgomery body
// (mf_mul_call_op); with the multiplies inlined the ladder ran slower on the
// H100, 2.53 against 1.95 ms for a bn254 G1 256-bit output, 9.26 against
// 4.22 ms for bls12-381 G1 (kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6). Edwards: each stage of independent multiplies one
// non-inlined body (fe_mul_stage_op: the doubling's four squares, then its
// four products, interleave in one body), 142 registers: 0.905 ms for a
// ristretto255 256-bit output and 0.909-0.910 ms for 2-10 outputs, against
// 1.063 with one body a product and 0.894 / 0.918 with the multiplies
// inlined (kernel_ab.py, the three in turns, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md §6).
#pragma once

#include "edwards25519.cuh"
#include "weierstrass.cuh"

namespace btt {

// ristretto255: extended Edwards points, unified add and dbl-2008-hwcd.
template <class Mul>
struct EdLadderT {
  using P = ge_p3;
  using In = point_ptrs;
  using Out = point_out_ptrs;
  BTT_HD static P load(const In& p, int64_t i) { return ge_load(p, i); }
  BTT_HD static void store(const Out& p, int64_t i, const P& q) { ge_store(p, i, q); }
  BTT_HD static P dbl(const P& p) { return ge_double(p, Mul()); }
  BTT_HD static P add(const P& p, const P& q) { return ge_add(p, q, Mul()); }
};
using EdLadder = EdLadderT<fe_mul_stage_op>;

// bls12-381 G1, bn254 G1, Grumpkin: the complete RCB add and doubling.
template <class C>
struct WLadder {
  using P = wpoint<C>;
  using In = wpoint_ptrs;
  using Out = wpoint_out_ptrs;
  BTT_HD static P load(const In& p, int64_t i) { return w_load<C>(p, i); }
  BTT_HD static void store(const Out& p, int64_t i, const P& q) { w_store<C>(p, i, q); }
  BTT_HD static P dbl(const P& p) { return w_double<C>(p, mf_mul_call_op<typename C::F>()); }
  BTT_HD static P add(const P& p, const P& q) { return w_add<C>(p, q, mf_mul_call_op<typename C::F>()); }
};

template <class G>
BTT_CALL typename G::P ladder_double(typename G::P p) {
  return G::dbl(p);
}

template <class G>
BTT_CALL typename G::P ladder_add(typename G::P p, typename G::P q) {
  return G::add(p, q);
}

constexpr int kLadderMaxSegments = 32;  // one lane a segment, one warp an output

// Segments of an nbits ladder: ceil(nbits / seg_bits).
BTT_HD int ladder_segments(int nbits, int seg_bits) { return (nbits + seg_bits - 1) / seg_bits; }

// The arguments a launcher takes: at least one bit, at most 32 segments.
BTT_HD bool ladder_args_ok(int nbits, int seg_bits) {
  return nbits >= 1 && seg_bits >= 1 && ladder_segments(nbits, seg_bits) <= kLadderMaxSegments;
}

// 2^k p: k doublings.
template <class G>
BTT_HD typename G::P ladder_doubles(typename G::P p, int k) {
  for (int i = 0; i < k; ++i) p = ladder_double<G>(p);
  return p;
}

// Lane j's Horner sum of products [base + lo, base + lo + len), lo = j L,
// step_bits doublings a step.
template <class G>
BTT_HD typename G::P ladder_segment(const typename G::In& products, int64_t base, int nbits, int seg_bits, int j,
                                    int step_bits = 1) {
  const int lo = j * seg_bits;
  const int hi = lo + seg_bits < nbits ? lo + seg_bits : nbits;
  typename G::P h = G::load(products, base + hi - 1);
  for (int b = hi - 2; b >= lo; --b) h = ladder_add<G>(ladder_doubles<G>(h, step_bits), G::load(products, base + b));
  return h;
}

// sum_j 2^(j L step_bits) seg[j] over nseg segments, from the top one down.
template <class G>
BTT_HD typename G::P ladder_fold(const typename G::P* seg, int nseg, int seg_bits, int step_bits = 1) {
  typename G::P acc = seg[nseg - 1];
  for (int j = nseg - 2; j >= 0; --j) acc = ladder_add<G>(ladder_doubles<G>(acc, seg_bits * step_bits), seg[j]);
  return acc;
}

#if defined(__CUDACC__)
// One warp an output (block o): lane j < S runs segment j, lane 0 folds.
// The products are read in place, (nlimbs, O, nbits) limb-major. The step
// a template argument: the query ladders' kernels (1) and the Horner
// kernels (8) are separate instantiations.
template <class G, int kStepBits>
__global__ void __launch_bounds__(32)
ladder_kernel(typename G::In products, int nbits, int seg_bits, typename G::Out out) {
  __shared__ typename G::P seg[kLadderMaxSegments];
  const int64_t o = blockIdx.x;
  const int lane = threadIdx.x;
  const int nseg = ladder_segments(nbits, seg_bits);
  if (lane < nseg) seg[lane] = ladder_segment<G>(products, o * nbits, nbits, seg_bits, lane, kStepBits);
  __syncwarp();
  if (lane == 0) G::store(out, o, ladder_fold<G>(seg, nseg, seg_bits, kStepBits));
}

template <class G, int kStepBits = 1>
void launch_ladder(const typename G::In& products, int64_t num_outputs, int nbits, int seg_bits,
                   const typename G::Out& out, cudaStream_t stream) {
  ladder_kernel<G, kStepBits><<<(unsigned)num_outputs, 32, 0, stream>>>(products, nbits, seg_bits, out);
}
#endif

}  // namespace btt
