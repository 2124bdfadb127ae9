// The elementwise Edwards adds (ed_add.cu, niels_add.cu) at four lanes a
// pair: the stages of one add spread over a quad of a warp, lane j (0..3)
// computing the j-th independent product of each stage.
//
// Stage 1, lane j: A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2),
// C = T1 T2 2d, D = 2 Z1 Z2 (ed_add; niels_add: A = b1 b2, B = a1 a2,
// C = t1 t2 / (2d), D = 2), each its lane's product times a constant
// (1, 1, 2d or 1/(2d), 2), so the four lanes run the same two multiplies.
// The four products are exchanged within the quad (__shfl_sync on the card;
// the host harness runs the lanes' stages in turn over an array). Stage 2:
// E = B - A, F = D - C, G = D + C, H = B + A, on every lane. Stage 3,
// lane j: X3 = E F, Y3 = G H, Z3 = F G, T3 = E H, coordinate j stored by
// lane j. The formulas and values are ge_add's and ge_niels_add's
// (edwards25519.cuh; blitzar_tpu/curves/edwards25519.py _add_impl,
// _niels_add_impl): canonical outputs equal the one-thread adds'. A lane's
// dependent chain is 3 multiplies where one thread's was 10 (ed_add) or 8
// (niels_add). Operands are picked by selects, not branches, so the lanes
// of a warp do not diverge on the multiplies; only a lane's loads depend on
// its j.
#pragma once

#include "edwards25519.cuh"

namespace btt {

constexpr int kQuadLanes = 4;
constexpr int kQuadThreads = 64;  // a block: 16 pairs, so a small batch spreads over many SMs

BTT_HD const int32_t* quad_coord(const point_ptrs& p, int c) {
  return c == 0 ? p.c[0] : c == 1 ? p.c[1] : c == 2 ? p.c[2] : p.c[3];
}

BTT_HD const int32_t* quad_coord(const niels_ptrs& p, int c) { return c == 0 ? p.c[0] : c == 1 ? p.c[1] : p.c[2]; }

BTT_HD int32_t* quad_coord(const point_out_ptrs& p, int c) {
  return c == 0 ? p.c[0] : c == 1 ? p.c[1] : c == 2 ? p.c[2] : p.c[3];
}

// Stage 1 of ed_add, lane j, pair i: its product of A, B, C, D. With
// negate_q, q is read as (-X, Y, Z, -T): lane 0 and 1 swap q's sum and
// difference, lane 2 takes -2d for 2d, and no multiply is added.
template <class Mul>
BTT_HD fe ed_add_quad_first(int j, const point_ptrs& p, const point_ptrs& q, int64_t i, bool negate_q, Mul mul) {
  const int c = j < 2 ? 1 : (j == 2 ? 3 : 2);  // Y, Y, T, Z
  const fe y1 = fe_load(quad_coord(p, c) + i, p.limb_stride);
  const fe y2 = fe_load(quad_coord(q, c) + i, q.limb_stride);
  fe x1 = fe_zero(), x2 = fe_zero();
  if (j < 2) {
    x1 = fe_load(p.c[0] + i, p.limb_stride);
    x2 = fe_load(q.c[0] + i, q.limb_stride);
  }
  const bool minus1 = j == 0, minus2 = (j == 0) != negate_q;
  const fe a = fe_select(fe_add(y1, x1), fe_sub(y1, x1), minus1);
  const fe b = fe_select(fe_add(y2, x2), fe_sub(y2, x2), minus2);
  const fe d2 = fe_select(fe_d2(), fe_neg(fe_d2()), negate_q);
  const fe k = fe_select(fe_select(fe_one(), d2, j == 2), fe_small(2), j == 3);
  return mul(mul(a, b), k);
}

// Stage 1 of niels_add, lane j, pair i: its product of A, B, C, D (lane 3
// forms D = 2 as 1 * 1 * 2).
template <class Mul>
BTT_HD fe niels_add_quad_first(int j, const niels_ptrs& p, const niels_ptrs& q, int64_t i, Mul mul) {
  fe a = fe_one(), b = fe_one();
  if (j < 3) {
    const int c = j == 0 ? 1 : (j == 1 ? 0 : 2);  // b, a, t
    a = fe_load(quad_coord(p, c) + i, p.limb_stride);
    b = fe_load(quad_coord(q, c) + i, q.limb_stride);
  }
  const fe k = fe_select(fe_select(fe_one(), fe_inv_d2(), j == 2), fe_small(2), j == 3);
  return mul(mul(a, b), k);
}

// Stages 2 and 3, lane j: from the quad's four products s = (A, B, C, D),
// coordinate j of the sum (X3, Y3, Z3, T3).
template <class Mul>
BTT_HD fe quad_last(int j, const fe* s, Mul mul) {
  const fe e = fe_sub(s[1], s[0]), f = fe_sub(s[3], s[2]), g = fe_add(s[3], s[2]), h = fe_add(s[1], s[0]);
  const fe u = fe_select(fe_select(e, g, j == 1), f, j == 2);                   // e, g, f, e
  const fe v = fe_select(fe_select(fe_select(f, h, j == 1), g, j == 2), h, j == 3);  // f, h, g, h
  return mul(u, v);
}

#if defined(__CUDACC__)
// Lane j of each quad gets the quad's four stage-1 products, in lane order.
__device__ __forceinline__ void quad_exchange(const fe& mine, fe* s) {
#pragma unroll
  for (int l = 0; l < kQuadLanes; ++l) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s[l].v[k] = __shfl_sync(0xffffffffu, mine.v[k], l, kQuadLanes);
  }
}
#endif

}  // namespace btt
