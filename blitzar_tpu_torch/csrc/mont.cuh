// Montgomery-form prime-field arithmetic for the Weierstrass and proof
// kernels of blitzar_tpu_torch: bn254 Fp, bn254 Fr (the Grumpkin base field),
// bls12-381 Fp and the curve25519 scalar field, one template over the
// field's word count.
//
// An element is K 32-bit little-endian words (K = 8 for the 254-bit fields,
// 12 for bls12-381) holding a canonical value in [0, m) in Montgomery form,
// R = 2^(32 K): the same R as the public layout's 2^(16 * nlimbs), so the
// kernels' values are the plain PyTorch version's (fields/mont.py) limb for
// limb. Every operation takes and returns canonical values, so a kernel and
// its plain version give equal canonical limbs.
//
// mf_mul is CIOS (coarsely integrated operand scanning): per word i of b,
// K word products a[j] * b[i] (32 x 32 -> 64 bits: a multiply for the low
// and one for the high half), one multiply for u = t[0] * (-m^-1 mod 2^32)
// and K word products u * m[j]. That is 4K^2 + K 32-bit multiplies per
// field multiply: 264 for K = 8, 588 for K = 12. (A device body of PTX
// carry chains, mad.lo.cc / madc.hi.cc, ran every Weierstrass kernel slower
// than this C body on the H100: PERF.md §6.)
//
// Everything is BTT_HD: __host__ __device__ under nvcc, plain inline code
// under a host compiler (tests/test_torch_native_arith.py compiles it with
// g++ through csrc/host_harness.cpp).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BTT_HD __host__ __device__ __forceinline__
#else
#define BTT_HD inline
#endif

namespace btt {

// Field traits: word count, -m^-1 mod 2^32, the modulus and R mod m (the
// Montgomery form of 1), as little-endian words.
struct Bn254Fp {
  static constexpr int K = 8;
  static constexpr uint32_t N0 = 0xe4866389u;
  BTT_HD static void modulus(uint32_t* m) {
    const uint32_t w[K] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
#pragma unroll
    for (int i = 0; i < K; ++i) m[i] = w[i];
  }
  BTT_HD static void one(uint32_t* r) {
    const uint32_t w[K] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = w[i];
  }
};

struct Bn254Fr {
  static constexpr int K = 8;
  static constexpr uint32_t N0 = 0xefffffffu;
  BTT_HD static void modulus(uint32_t* m) {
    const uint32_t w[K] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
#pragma unroll
    for (int i = 0; i < K; ++i) m[i] = w[i];
  }
  BTT_HD static void one(uint32_t* r) {
    const uint32_t w[K] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = w[i];
  }
};

// The curve25519 scalar field (mod l = 2^252 + 27742...8493), R = 2^256: the
// field of the IPA and of the sumcheck's SXT_FIELD_SCALAR255.
struct Scalar25519 {
  static constexpr int K = 8;
  static constexpr uint32_t N0 = 0x12547e1bu;
  BTT_HD static void modulus(uint32_t* m) {
    const uint32_t w[K] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                           0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
#pragma unroll
    for (int i = 0; i < K; ++i) m[i] = w[i];
  }
  BTT_HD static void one(uint32_t* r) {
    const uint32_t w[K] = {0x8d98951du, 0xd6ec3174u, 0x737dcf70u, 0xc6ef5bf4u,
                           0xfffffffeu, 0xffffffffu, 0xffffffffu, 0x0fffffffu};
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = w[i];
  }
};

// The proof kernels' fields by their id in the reference C ABI
// (blitzar_api.h:33-34), by which their launchers pick an instantiation:
// SXT_FIELD_SCALAR255 is Scalar25519, SXT_FIELD_GRUMPKIN the Grumpkin base
// field Bn254Fr.
constexpr int kFieldScalar255 = 0;
constexpr int kFieldGrumpkin = 1;
// mont_mul_ew also serves the base fields of bn254 G1 and bls12-381 G1 (the
// batch inversion that puts a Weierstrass table in affine form), by ids of
// the port's own after the C ABI's; Grumpkin's base field is Bn254Fr.
constexpr int kFieldBn254Fp = 2;
constexpr int kFieldBls12381Fp = 3;

struct Bls12381Fp {
  static constexpr int K = 12;
  static constexpr uint32_t N0 = 0xfffcfffdu;
  BTT_HD static void modulus(uint32_t* m) {
    const uint32_t w[K] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                           0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                           0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
#pragma unroll
    for (int i = 0; i < K; ++i) m[i] = w[i];
  }
  BTT_HD static void one(uint32_t* r) {
    const uint32_t w[K] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                           0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                           0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = w[i];
  }
};

template <class F>
struct mfe {
  uint32_t v[F::K];
};

template <class F>
BTT_HD mfe<F> mf_zero() {
  mfe<F> r;
#pragma unroll
  for (int i = 0; i < F::K; ++i) r.v[i] = 0;
  return r;
}

template <class F>
BTT_HD mfe<F> mf_one() {
  mfe<F> r;
  F::one(r.v);
  return r;
}

// t (K words) + top * 2^(32K), a value in [0, 2m) -> t - m if it is >= m.
template <class F>
BTT_HD mfe<F> mf_reduce_once(const uint32_t* t, uint32_t top) {
  constexpr int K = F::K;
  uint32_t m[K];
  F::modulus(m);
  mfe<F> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t x = (uint64_t)t[i] - m[i] - borrow;
    d.v[i] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  bool take_d = top != 0 || borrow == 0;
  mfe<F> r;
#pragma unroll
  for (int i = 0; i < K; ++i) r.v[i] = take_d ? d.v[i] : t[i];
  return r;
}

template <class F>
BTT_HD mfe<F> mf_add(const mfe<F>& a, const mfe<F>& b) {
  constexpr int K = F::K;
  uint32_t t[K];
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    acc += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)acc;
    acc >>= 32;
  }
  return mf_reduce_once<F>(t, (uint32_t)acc);
}

// a - b; a borrow out of the top word means a < b, and m is added back.
template <class F>
BTT_HD mfe<F> mf_sub(const mfe<F>& a, const mfe<F>& b) {
  constexpr int K = F::K;
  mfe<F> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  uint32_t m[K];
  F::modulus(m);
  uint32_t mask = 0u - borrow;
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    acc += (uint64_t)d.v[i] + (m[i] & mask);
    d.v[i] = (uint32_t)acc;
    acc >>= 32;
  }
  return d;
}

template <class F>
BTT_HD mfe<F> mf_neg(const mfe<F>& a) {
  return mf_sub<F>(mf_zero<F>(), a);
}

// a * b * R^-1 mod m (CIOS). The result before the last step is
// (a b + U m) / R with U < R, below 2m whenever a b < m R: so one
// conditional subtraction ends it for a, b < m, and also for b < m with a
// any K-word value below R (how the proof kernels reduce raw 256-bit rows).
template <class F>
BTT_HD mfe<F> mf_mul(const mfe<F>& a, const mfe<F>& b) {
  constexpr int K = F::K;
  uint32_t m[K];
  F::modulus(m);
  uint32_t t[K + 2];
#pragma unroll
  for (int i = 0; i < K + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: never overflows
      uint64_t uv = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t s = (uint64_t)t[K] + c;
    t[K] = (uint32_t)s;
    t[K + 1] = (uint32_t)(s >> 32);
    uint32_t u = t[0] * F::N0;
    uint64_t uv = (uint64_t)u * m[0] + t[0];  // low word is 0 by the choice of u
    c = uv >> 32;
#pragma unroll
    for (int j = 1; j < K; ++j) {
      uv = (uint64_t)u * m[j] + t[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    s = (uint64_t)t[K] + c;
    t[K - 1] = (uint32_t)s;
    t[K] = t[K + 1] + (uint32_t)(s >> 32);
  }
  return mf_reduce_once<F>(t, t[K]);
}

template <class F>
BTT_HD mfe<F> mf_sq(const mfe<F>& a) {
  return mf_mul<F>(a, a);
}

// The multiply weierstrass.cuh's w_add takes as a template argument:
// mf_mul inlined (mf_mul_op), or one non-inlined body called a product
// (mf_mul_call_op: the tree reduce), as fp25519.cuh's fe_mul_op and
// fe_mul_call_op.
template <class F>
struct mf_mul_op {
  BTT_HD mfe<F> operator()(const mfe<F>& a, const mfe<F>& b) const { return mf_mul<F>(a, b); }
};

#if defined(__CUDACC__)
#define BTT_CALL static __host__ __device__ __noinline__
#else
#define BTT_CALL static inline
#endif

template <class F>
BTT_CALL mfe<F> mf_mul_call(mfe<F> a, mfe<F> b) {
  return mf_mul<F>(a, b);
}

template <class F>
struct mf_mul_call_op {
  BTT_HD mfe<F> operator()(const mfe<F>& a, const mfe<F>& b) const { return mf_mul_call<F>(a, b); }
};

// a^(m - 2) by square-and-multiply over the bits of m - 2; 0 maps to 0.
// Only the host harness calls it (the kernels need no inversion).
template <class F>
BTT_HD mfe<F> mf_inv(const mfe<F>& a) {
  constexpr int K = F::K;
  uint32_t e[K];
  F::modulus(e);
  e[0] -= 2;  // m is odd and above 2: no borrow
  mfe<F> acc = mf_one<F>();
  for (int i = 32 * K - 1; i >= 0; --i) {
    acc = mf_sq<F>(acc);
    if ((e[i / 32] >> (i % 32)) & 1u) acc = mf_mul<F>(acc, a);
  }
  return acc;
}

template <class F>
BTT_HD bool mf_is_zero(const mfe<F>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < F::K; ++i) acc |= a.v[i];
  return acc == 0;
}

// 2K canonical radix-2^16 limbs at base[l * stride] -> element.
template <class F>
BTT_HD mfe<F> mf_load(const int32_t* base, int64_t stride) {
  mfe<F> r;
#pragma unroll
  for (int k = 0; k < F::K; ++k) {
    r.v[k] = ((uint32_t)base[(2 * k) * stride] & 0xffffu) |
             ((uint32_t)base[(2 * k + 1) * stride] << 16);
  }
  return r;
}

// Element -> 2K radix-2^16 limbs at base[l * stride].
template <class F>
BTT_HD void mf_store(int32_t* base, int64_t stride, const mfe<F>& a) {
#pragma unroll
  for (int k = 0; k < F::K; ++k) {
    base[(2 * k) * stride] = (int32_t)(a.v[k] & 0xffffu);
    base[(2 * k + 1) * stride] = (int32_t)(a.v[k] >> 16);
  }
}

}  // namespace btt
