// curve25519 in twisted-Edwards form (a = -1), extended coordinates, and the
// ristretto255 elligator map: the group law every kernel of
// blitzar_tpu_torch runs. Formulas and their order are those of
// blitzar_tpu/curves/edwards25519.py (_add_impl, _double_impl, _madd_impl)
// and blitzar_tpu/curves/ristretto.py (sqrt_ratio_m1, elligator), so a kernel
// and its plain PyTorch version give the same canonical coordinates.
#pragma once

#include "fp25519.cuh"

namespace btt {

// Extended coordinates: x = X/Z, y = Y/Z, X*Y = Z*T.
struct ge_p3 {
  fe X, Y, Z, T;
};

// Affine precomputed table entry: (y + x, y - x, 2d*x*y), z = 1 implied.
struct ge_niels {
  fe a, b, t;
};

// Projective precomputed table entry (libsodium's ge25519_cached): (Y + X,
// Y - X, Z, 2d*T). It needs no inversion to build, so it is the form of the
// tables a streamed query builds and drops (blitzar_tpu/curves/
// edwards25519.py:119-157).
struct ge_cached {
  fe a, b, z, t;
};

BTT_HD fe fe_d() {
  return fe_const(0x135978a3u, 0x75eb4dcau, 0x4141d8abu, 0x00700a4du,
                  0x7779e898u, 0x8cc74079u, 0x2b6ffe73u, 0x52036ceeu);
}

BTT_HD fe fe_d2() {
  return fe_const(0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
                  0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu);
}

BTT_HD fe fe_sqrt_m1() {
  return fe_const(0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u,
                  0x3dfbd7a7u, 0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u);
}

BTT_HD fe fe_one_minus_d_sq() {
  return fe_const(0x945fc176u, 0xe27c09c1u, 0xcd5e350fu, 0x2c81a138u,
                  0xbe70dfe4u, 0x9994abddu, 0xb2b3e0d7u, 0x029072a8u);
}

BTT_HD fe fe_d_minus_one_sq() {
  return fe_const(0x44ed4d20u, 0x31ad5aaau, 0xb01e1999u, 0xd29e4a2cu,
                  0x529b4eebu, 0x4cdcd32fu, 0xf66c2241u, 0x5968b37au);
}

BTT_HD fe fe_sqrt_ad_minus_one() {
  return fe_const(0x497b2e1bu, 0x7e97f6a0u, 0x1b7854bdu, 0xaf9d8e0cu,
                  0x31f5d1fdu, 0x0f3cfcc9u, 0x2b8348acu, 0x376931bfu);
}

BTT_HD ge_p3 ge_identity() {
  ge_p3 r;
  r.X = fe_zero();
  r.Y = fe_one();
  r.Z = fe_one();
  r.T = fe_zero();
  return r;
}

// Unified addition add-2008-hwcd-3 (complete: identity and doubling too).
BTT_HD ge_p3 ge_add(const ge_p3& p, const ge_p3& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe c = fe_mul(fe_mul(p.T, q.T), fe_d2());
  fe d = fe_mul_small(fe_mul(p.Z, q.Z), 2);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge_p3 r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// Mixed addition of an extended point and a niels entry: 7 multiplies.
BTT_HD ge_p3 ge_madd(const ge_p3& p, const ge_niels& n) {
  fe a = fe_mul(fe_sub(p.Y, p.X), n.b);
  fe b = fe_mul(fe_add(p.Y, p.X), n.a);
  fe c = fe_mul(p.T, n.t);
  fe d = fe_mul_small(p.Z, 2);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge_p3 r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// 1/(2d): a niels + niels add divides the product of the two stored 2d*t.
BTT_HD fe fe_inv_d2() {
  return fe_const(0x66e4fc18u, 0x12f0793bu, 0x213caa17u, 0x05aeeb4cu,
                  0x66dce7b3u, 0x958b108au, 0x0a6ae721u, 0x60483f69u);
}

// Addition of two niels entries (z1 = z2 = 1), extended result: the unified
// law with C = t1*t2/(2d) (both stored t carry 2d) and D = 2, 7 multiplies
// and one by 1/(2d) (blitzar_tpu/curves/edwards25519.py:_niels_add_impl).
BTT_HD ge_p3 ge_niels_add(const ge_niels& p, const ge_niels& q) {
  fe a = fe_mul(p.b, q.b);
  fe b = fe_mul(p.a, q.a);
  fe c = fe_mul(fe_mul(p.t, q.t), fe_inv_d2());
  fe two = fe_small(2);
  fe e = fe_sub(b, a);
  fe f = fe_sub(two, c);
  fe g = fe_add(c, two);
  fe h = fe_add(b, a);
  ge_p3 r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// Addition of an extended point and a cached entry: 8 multiplies.
BTT_HD ge_p3 ge_cadd(const ge_p3& p, const ge_cached& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), q.b);
  fe b = fe_mul(fe_add(p.Y, p.X), q.a);
  fe c = fe_mul(p.T, q.t);
  fe d = fe_mul_small(fe_mul(p.Z, q.z), 2);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge_p3 r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

BTT_HD ge_p3 ge_double(const ge_p3& p) {
  fe a = fe_sq(p.X);
  fe b = fe_sq(p.Y);
  fe c = fe_mul_small(fe_sq(p.Z), 2);
  fe h = fe_add(a, b);
  fe e = fe_sub(h, fe_sq(fe_add(p.X, p.Y)));
  fe g = fe_sub(a, b);
  fe f = fe_add(c, g);
  ge_p3 r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// Extended -> affine niels, with one inversion of Z.
BTT_HD ge_niels ge_to_niels(const ge_p3& p) {
  fe zinv = fe_invert(p.Z);
  fe x = fe_mul(p.X, zinv);
  fe y = fe_mul(p.Y, zinv);
  ge_niels n;
  n.a = fe_add(y, x);
  n.b = fe_sub(y, x);
  n.t = fe_mul(fe_mul(x, y), fe_d2());
  return n;
}

// Extended -> cached: two additions and one multiply by 2d.
BTT_HD ge_cached ge_to_cached(const ge_p3& p) {
  ge_cached c;
  c.a = fe_add(p.Y, p.X);
  c.b = fe_sub(p.Y, p.X);
  c.z = p.Z;
  c.t = fe_mul(p.T, fe_d2());
  return c;
}

// SQRT_RATIO_M1 of ristretto255: x = sqrt(u/v) if u/v is square, else
// sqrt(sqrt(-1) * u/v); x is non-negative. Returns whether u/v was square.
BTT_HD bool sqrt_ratio_m1(const fe& u, const fe& v, fe& x_out) {
  fe sqrtm1 = fe_sqrt_m1();
  fe v3 = fe_mul(fe_sq(v), v);
  fe x = fe_mul(fe_mul(fe_sq(v3), v), u);  // u * v^7
  x = fe_pow22523(x);
  x = fe_mul(fe_mul(x, v3), u);
  fe vxx = fe_mul(fe_sq(x), v);
  bool has_m = fe_is_zero(fe_sub(vxx, u));
  bool has_p = fe_is_zero(fe_add(vxx, u));
  bool has_f = fe_is_zero(fe_add(vxx, fe_mul(u, sqrtm1)));
  x = fe_select(x, fe_mul(x, sqrtm1), has_p || has_f);
  x_out = fe_abs(x);
  return has_m || has_p;
}

// ristretto255 one-way map of a field element to a point (libsodium's
// ristretto255_elligator; blitzar_tpu/curves/ristretto.py:elligator).
BTT_HD ge_p3 elligator(const fe& t) {
  fe one = fe_one();
  fe r = fe_mul(fe_mul(fe_sqrt_m1(), t), t);
  fe u = fe_mul(fe_add(r, one), fe_one_minus_d_sq());
  fe neg_one = fe_neg(one);
  fe rpd = fe_add(r, fe_d());
  fe v = fe_mul(fe_sub(neg_one, fe_mul(r, fe_d())), rpd);
  fe s;
  bool was_square = sqrt_ratio_m1(u, v, s);
  fe s_prime = fe_neg(fe_abs(fe_mul(s, t)));
  s = fe_select(s, s_prime, !was_square);
  fe c = fe_select(neg_one, r, !was_square);
  fe n = fe_mul(fe_mul(c, fe_sub(r, one)), fe_d_minus_one_sq());
  n = fe_sub(n, v);
  fe w0 = fe_mul(fe_mul_small(s, 2), v);
  fe w1 = fe_mul(n, fe_sqrt_ad_minus_one());
  fe ss = fe_sq(s);
  fe w2 = fe_sub(one, ss);
  fe w3 = fe_add(one, ss);
  ge_p3 out;
  out.X = fe_mul(w0, w3);
  out.Y = fe_mul(w2, w1);
  out.Z = fe_mul(w1, w3);
  out.T = fe_mul(w0, w2);
  return out;
}

// A point batch in the public layout: four (16, *batch) int32 coordinate
// tensors; limb l of element i of coordinate c at c[l * limb_stride + i].
struct point_ptrs {
  const int32_t* c[4];
  int64_t limb_stride;
};

struct point_out_ptrs {
  int32_t* c[4];
  int64_t limb_stride;
};

// A niels batch in the public layout: three (16, *batch) int32 coordinate
// tensors (y + x, y - x, 2d*x*y) with one limb stride.
struct niels_ptrs {
  const int32_t* c[3];
  int64_t limb_stride;
};

BTT_HD ge_niels niels_limbs_load(const niels_ptrs& p, int64_t i) {
  ge_niels r;
  r.a = fe_load(p.c[0] + i, p.limb_stride);
  r.b = fe_load(p.c[1] + i, p.limb_stride);
  r.t = fe_load(p.c[2] + i, p.limb_stride);
  return r;
}

BTT_HD ge_p3 ge_load(const point_ptrs& p, int64_t i) {
  ge_p3 r;
  r.X = fe_load(p.c[0] + i, p.limb_stride);
  r.Y = fe_load(p.c[1] + i, p.limb_stride);
  r.Z = fe_load(p.c[2] + i, p.limb_stride);
  r.T = fe_load(p.c[3] + i, p.limb_stride);
  return r;
}

BTT_HD void ge_store(const point_out_ptrs& p, int64_t i, const ge_p3& q) {
  fe_store(p.c[0] + i, p.limb_stride, q.X);
  fe_store(p.c[1] + i, p.limb_stride, q.Y);
  fe_store(p.c[2] + i, p.limb_stride, q.Z);
  fe_store(p.c[3] + i, p.limb_stride, q.T);
}

// A niels table entry is 24 consecutive words: a, b, t, each canonical.
BTT_HD void niels_store(uint32_t* entry, const ge_niels& n) {
  fe a = fe_canonical(n.a), b = fe_canonical(n.b), t = fe_canonical(n.t);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    entry[k] = a.v[k];
    entry[8 + k] = b.v[k];
    entry[16 + k] = t.v[k];
  }
}

BTT_HD ge_niels niels_load(const uint32_t* entry) {
  ge_niels n;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    n.a.v[k] = entry[k];
    n.b.v[k] = entry[8 + k];
    n.t.v[k] = entry[16 + k];
  }
  return n;
}

// A cached table entry is 32 consecutive words: a, b, z, t, each canonical.
BTT_HD void cached_store(uint32_t* entry, const ge_cached& c) {
  fe a = fe_canonical(c.a), b = fe_canonical(c.b), z = fe_canonical(c.z), t = fe_canonical(c.t);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    entry[k] = a.v[k];
    entry[8 + k] = b.v[k];
    entry[16 + k] = z.v[k];
    entry[24 + k] = t.v[k];
  }
}

BTT_HD ge_cached cached_load(const uint32_t* entry) {
  ge_cached c;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c.a.v[k] = entry[k];
    c.b.v[k] = entry[8 + k];
    c.z.v[k] = entry[16 + k];
    c.t.v[k] = entry[24 + k];
  }
  return c;
}

}  // namespace btt
