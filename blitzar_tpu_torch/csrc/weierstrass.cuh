// Short-Weierstrass curves with a = 0 (bls12-381 G1, bn254 G1, Grumpkin)
// over mont.cuh: the group law of the Weierstrass kernels, one template over
// the curve. Homogeneous projective coordinates (x/z, y/z), identity
// (0, 1, 0). w_add and w_double are the complete formulas of
// Renes-Costello-Batina 2016 for a = 0 (Algorithms 7 and 9) in the order of
// blitzar_tpu/curves/weierstrass.py (_add_impl, _double_impl), so a kernel
// and its plain PyTorch version give the same canonical coordinates.
//
// Field multiplies: w_add 12, w_double 8. Their multiplies by the constant
// 3b (two in w_add, one in w_double) are short chains of modular additions
// (mul_b3: 3b is 9, 12 or -51), whose canonical result equals a Montgomery
// multiply by 3b in Montgomery form: the coordinates stay equal to the
// plain version's limb for limb.
#pragma once

#include "mont.cuh"

namespace btt {

// The index of c's top bit, c > 0.
template <int c>
struct const_top_bit {
  static constexpr int value = 1 + const_top_bit<(c >> 1)>::value;
};
template <>
struct const_top_bit<1> {
  static constexpr int value = 0;
};

// x * c for a constant c > 0 by a double-and-add chain of modular additions
// from c's top bit (the loop unrolls and its tests fold at compile time).
template <class F, int c>
BTT_HD mfe<F> mf_mul_small(const mfe<F>& x) {
  static_assert(c > 0 && c < (1 << 16), "a small positive constant");
  constexpr int top = const_top_bit<c>::value;
  mfe<F> r = x;
#pragma unroll
  for (int bit = top - 1; bit >= 0; --bit) {
    r = mf_add<F>(r, r);
    if ((c >> bit) & 1) r = mf_add<F>(r, x);
  }
  return r;
}

// Curve traits: the base field, 3b in Montgomery form (b3, the reference of
// the host tests) and mul_b3, x * 3b by additions. `id` is the curve's id
// in the reference C ABI (blitzar_api.h:28-31), by which the C launchers
// pick an instantiation.
struct Bls12381G1 {
  using F = Bls12381Fp;
  static constexpr int id = 1;
  // 3b = 12: x2, x3, x6, x12 (4 additions)
  BTT_HD static mfe<F> mul_b3(const mfe<F>& x) { return mf_mul_small<F, 12>(x); }
  BTT_HD static mfe<F> b3() {
    const uint32_t w[12] = {0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au,
                            0x4a6e8b59u, 0x6f7ee9ceu, 0xc0a95bc6u, 0xb10330b7u,
                            0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u};
    mfe<F> r;
#pragma unroll
    for (int i = 0; i < 12; ++i) r.v[i] = w[i];
    return r;
  }
};

struct Bn254G1 {
  using F = Bn254Fp;
  static constexpr int id = 2;
  // 3b = 9: x2, x4, x8, x9 (4 additions)
  BTT_HD static mfe<F> mul_b3(const mfe<F>& x) { return mf_mul_small<F, 9>(x); }
  BTT_HD static mfe<F> b3() {
    const uint32_t w[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
                           0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
    mfe<F> r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = w[i];
    return r;
  }
};

struct Grumpkin {
  using F = Bn254Fr;
  static constexpr int id = 3;
  // 3b = -51: 51x by 8 additions (x2, x3, x6, x12, x24, x25, x50, x51),
  // then its negation
  BTT_HD static mfe<F> mul_b3(const mfe<F>& x) { return mf_neg<F>(mf_mul_small<F, 51>(x)); }
  BTT_HD static mfe<F> b3() {
    const uint32_t w[8] = {0x2000010eu, 0x98510207u, 0x6194b935u, 0x66befc70u,
                           0x966b3240u, 0x64a9867cu, 0x8256ec00u, 0x09cabd29u};
    mfe<F> r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = w[i];
    return r;
  }
};

template <class C>
struct wpoint {
  mfe<typename C::F> X, Y, Z;
};

template <class C>
BTT_HD wpoint<C> w_identity() {
  using F = typename C::F;
  wpoint<C> r;
  r.X = mf_zero<F>();
  r.Y = mf_one<F>();
  r.Z = mf_zero<F>();
  return r;
}

// Complete addition, a = 0 (Renes-Costello-Batina Algorithm 7). Mul is the
// multiply policy of mont.cuh: mf_mul inlined (the default) or one
// non-inlined body called a product (mf_mul_call_op).
template <class C, class Mul = mf_mul_op<typename C::F>>
BTT_HD wpoint<C> w_add(const wpoint<C>& p, const wpoint<C>& q, Mul mul = Mul()) {
  using F = typename C::F;
  mfe<F> t0 = mul(p.X, q.X);
  mfe<F> t1 = mul(p.Y, q.Y);
  mfe<F> t2 = mul(p.Z, q.Z);
  mfe<F> t3 = mul(mf_add<F>(p.X, p.Y), mf_add<F>(q.X, q.Y));
  t3 = mf_sub<F>(t3, mf_add<F>(t0, t1));  // x1y2 + x2y1
  mfe<F> t4 = mul(mf_add<F>(p.Y, p.Z), mf_add<F>(q.Y, q.Z));
  t4 = mf_sub<F>(t4, mf_add<F>(t1, t2));  // y1z2 + y2z1
  mfe<F> x3 = mul(mf_add<F>(p.X, p.Z), mf_add<F>(q.X, q.Z));
  mfe<F> y3 = mf_sub<F>(x3, mf_add<F>(t0, t2));  // x1z2 + x2z1
  t0 = mf_add<F>(mf_add<F>(t0, t0), t0);  // 3 x1x2
  t2 = C::mul_b3(t2);
  mfe<F> z3 = mf_add<F>(t1, t2);
  t1 = mf_sub<F>(t1, t2);
  y3 = C::mul_b3(y3);
  wpoint<C> r;
  r.X = mf_sub<F>(mul(t3, t1), mul(t4, y3));
  r.Y = mf_add<F>(mul(t1, z3), mul(y3, t0));
  r.Z = mf_add<F>(mul(z3, t4), mul(t0, t3));
  return r;
}

// Complete doubling, a = 0 (Renes-Costello-Batina Algorithm 9), with the
// multiply policy of w_add.
template <class C, class Mul = mf_mul_op<typename C::F>>
BTT_HD wpoint<C> w_double(const wpoint<C>& p, Mul mul = Mul()) {
  using F = typename C::F;
  mfe<F> t0 = mul(p.Y, p.Y);
  mfe<F> z3 = mf_add<F>(t0, t0);
  z3 = mf_add<F>(z3, z3);
  z3 = mf_add<F>(z3, z3);  // 8 y^2
  mfe<F> t1 = mul(p.Y, p.Z);
  mfe<F> t2 = C::mul_b3(mul(p.Z, p.Z));
  mfe<F> x3 = mul(t2, z3);
  mfe<F> y3 = mf_add<F>(t0, t2);
  z3 = mul(t1, z3);
  t1 = mf_add<F>(t2, t2);
  t2 = mf_add<F>(t1, t2);
  t0 = mf_sub<F>(t0, t2);
  y3 = mf_add<F>(x3, mul(t0, y3));
  x3 = mul(t0, mul(p.X, p.Y));
  wpoint<C> r;
  r.X = mf_add<F>(x3, x3);
  r.Y = y3;
  r.Z = z3;
  return r;
}

// A point batch in the public layout: three (2K, *batch) int32 coordinate
// tensors; limb l of element i of coordinate c at c[l * limb_stride + i].
struct wpoint_ptrs {
  const int32_t* c[3];
  int64_t limb_stride;
};

struct wpoint_out_ptrs {
  int32_t* c[3];
  int64_t limb_stride;
};

template <class C>
BTT_HD wpoint<C> w_load(const wpoint_ptrs& p, int64_t i) {
  using F = typename C::F;
  wpoint<C> r;
  r.X = mf_load<F>(p.c[0] + i, p.limb_stride);
  r.Y = mf_load<F>(p.c[1] + i, p.limb_stride);
  r.Z = mf_load<F>(p.c[2] + i, p.limb_stride);
  return r;
}

template <class C>
BTT_HD void w_store(const wpoint_out_ptrs& p, int64_t i, const wpoint<C>& q) {
  using F = typename C::F;
  mf_store<F>(p.c[0] + i, p.limb_stride, q.X);
  mf_store<F>(p.c[1] + i, p.limb_stride, q.Y);
  mf_store<F>(p.c[2] + i, p.limb_stride, q.Z);
}

}  // namespace btt
