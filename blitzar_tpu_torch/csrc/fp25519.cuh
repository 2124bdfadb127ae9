// GF(2^255 - 19) arithmetic shared by every kernel of blitzar_tpu_torch.
//
// An element is eight 32-bit little-endian words whose value is below 2^256
// and congruent to the element mod p: neither reduced nor canonical (the
// invariant of blitzar_tpu/fields/fp25519.py, in a wider radix). Products
// are formed word by word in 64-bit accumulators and folded with
// 2^256 = 38 (mod p). Canonical values come from fe_canonical.
//
// Everything here is BTT_HD: compiled by nvcc it is __host__ __device__ and
// feeds the kernels in the .cu files; compiled by a host C++ compiler it is
// plain inline code, which is how the CPU tests check this arithmetic
// (tests/test_torch_native_arith.py through csrc/host_harness.cpp).
//
// Public tensors hold an element as 16 radix-2^16 limbs in int32, limb axis
// leading: limb l of element i at base[l * limb_stride + i]. fe_load and
// fe_store convert; fe_load accepts limbs up to 2^17 (the plain PyTorch
// invariant), fe_store writes canonical 16-bit limbs.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BTT_HD __host__ __device__ __forceinline__
#else
#define BTT_HD inline
#endif

namespace btt {

struct fe {
  uint32_t v[8];
};

BTT_HD fe fe_const(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                   uint32_t a4, uint32_t a5, uint32_t a6, uint32_t a7) {
  fe r;
  r.v[0] = a0; r.v[1] = a1; r.v[2] = a2; r.v[3] = a3;
  r.v[4] = a4; r.v[5] = a5; r.v[6] = a6; r.v[7] = a7;
  return r;
}

BTT_HD fe fe_small(uint32_t x) { return fe_const(x, 0, 0, 0, 0, 0, 0, 0); }

BTT_HD fe fe_zero() { return fe_small(0); }

BTT_HD fe fe_one() { return fe_small(1); }

// r + c * 2^256 with c < 2^16: fold c * 38 into the low word. If that carries
// out of the top word again, r is now below c * 38, so one more 38 cannot.
BTT_HD void fe_fold(fe& r, uint32_t c) {
  uint64_t acc = (uint64_t)r.v[0] + (uint64_t)c * 38u;
  r.v[0] = (uint32_t)acc;
  acc >>= 32;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    acc += r.v[i];
    r.v[i] = (uint32_t)acc;
    acc >>= 32;
  }
  r.v[0] += (uint32_t)acc * 38u;
}

BTT_HD fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)acc;
    acc >>= 32;
  }
  fe_fold(r, (uint32_t)acc);
  return r;
}

// Subtract k (< 2^16) from the word vector with a borrow chain; returns the
// borrow out of the top word.
BTT_HD uint32_t fe_sub_small(fe& r, uint32_t k) {
  uint64_t d = (uint64_t)r.v[0] - k;
  r.v[0] = (uint32_t)d;
  uint32_t borrow = (uint32_t)(d >> 63);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    d = (uint64_t)r.v[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// a - b. A borrow out of the top word left a - b + 2^256 = a - b + 38 (mod
// p), so 38 is taken off; if that borrows too (the value was below 38), the
// word vector wrapped by 2^256 once more and 38 is taken off again, which
// cannot borrow.
BTT_HD fe fe_sub(const fe& a, const fe& b) {
  fe r;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  borrow = fe_sub_small(r, borrow * 38u);
  fe_sub_small(r, borrow * 38u);
  return r;
}

BTT_HD fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

// Schoolbook 8 x 8 words into 16, then the upper half folded by 38.
BTT_HD fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: never overflows
      uint64_t uv = (uint64_t)a.v[i] * b.v[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)uv;
      carry = uv >> 32;
    }
    t[i + 8] = (uint32_t)carry;
  }
  fe r;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t uv = (uint64_t)t[i + 8] * 38u + t[i] + carry;
    r.v[i] = (uint32_t)uv;
    carry = uv >> 32;  // < 39
  }
  fe_fold(r, (uint32_t)carry);
  return r;
}

BTT_HD fe fe_sq(const fe& a) { return fe_mul(a, a); }

// a * k for a small constant k < 2^16.
BTT_HD fe fe_mul_small(const fe& a, uint32_t k) {
  fe r;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t uv = (uint64_t)a.v[i] * k + carry;
    r.v[i] = (uint32_t)uv;
    carry = uv >> 32;
  }
  fe_fold(r, (uint32_t)carry);
  return r;
}

BTT_HD fe fe_pow2k(fe a, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) a = fe_sq(a);
  return a;
}

// z^(2^250 - 1) and z^11: the shared prefix of fe_invert and fe_pow22523
// (the chain of blitzar_tpu/fields/fp25519.py:_pow_chain_250).
BTT_HD void fe_pow_chain_250(const fe& z, fe& z2_250_0, fe& z11) {
  fe z2 = fe_sq(z);
  fe z9 = fe_mul(fe_pow2k(z2, 2), z);
  z11 = fe_mul(z9, z2);
  fe z2_5_0 = fe_mul(fe_sq(z11), z9);
  fe z2_10_0 = fe_mul(fe_pow2k(z2_5_0, 5), z2_5_0);
  fe z2_20_0 = fe_mul(fe_pow2k(z2_10_0, 10), z2_10_0);
  fe z2_40_0 = fe_mul(fe_pow2k(z2_20_0, 20), z2_20_0);
  fe z2_50_0 = fe_mul(fe_pow2k(z2_40_0, 10), z2_10_0);
  fe z2_100_0 = fe_mul(fe_pow2k(z2_50_0, 50), z2_50_0);
  fe z2_200_0 = fe_mul(fe_pow2k(z2_100_0, 100), z2_100_0);
  z2_250_0 = fe_mul(fe_pow2k(z2_200_0, 50), z2_50_0);
}

// a^(p - 2); 0 maps to 0.
BTT_HD fe fe_invert(const fe& a) {
  fe z2_250_0, z11;
  fe_pow_chain_250(a, z2_250_0, z11);
  return fe_mul(fe_pow2k(z2_250_0, 5), z11);
}

// a^((p - 5) / 8) = a^(2^252 - 3).
BTT_HD fe fe_pow22523(const fe& a) {
  fe z2_250_0, z11;
  fe_pow_chain_250(a, z2_250_0, z11);
  return fe_mul(fe_pow2k(z2_250_0, 2), a);
}

// Full reduction to [0, p). A stored value is below 2^256 = 2p + 38, so at
// most two subtractions of p are needed.
BTT_HD fe fe_canonical(const fe& a) {
  const uint32_t p[8] = {0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                         0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
  fe r = a;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t x = (uint64_t)r.v[i] - p[i] - borrow;
      d.v[i] = (uint32_t)x;
      borrow = (uint32_t)(x >> 63);
    }
    if (!borrow) r = d;
  }
  return r;
}

BTT_HD bool fe_is_zero(const fe& a) {
  fe c = fe_canonical(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= c.v[i];
  return acc == 0;
}

// Sign bit: the parity of the canonical value.
BTT_HD bool fe_is_negative(const fe& a) { return fe_canonical(a).v[0] & 1u; }

BTT_HD fe fe_select(const fe& a, const fe& b, bool take_b) { return take_b ? b : a; }

BTT_HD fe fe_abs(const fe& a) { return fe_select(a, fe_neg(a), fe_is_negative(a)); }

// 16 radix-2^16 limbs (each below 2^31) at base[l * stride] -> element.
BTT_HD fe fe_load(const int32_t* base, int64_t stride) {
  fe r;
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc += (uint64_t)(uint32_t)base[(2 * k) * stride] +
           ((uint64_t)(uint32_t)base[(2 * k + 1) * stride] << 16);
    r.v[k] = (uint32_t)acc;
    acc >>= 32;
  }
  fe_fold(r, (uint32_t)acc);
  return r;
}

// Element -> 16 canonical 16-bit limbs at base[l * stride].
BTT_HD void fe_store(int32_t* base, int64_t stride, const fe& a) {
  fe c = fe_canonical(a);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    base[(2 * k) * stride] = (int32_t)(c.v[k] & 0xffffu);
    base[(2 * k + 1) * stride] = (int32_t)(c.v[k] >> 16);
  }
}

}  // namespace btt
