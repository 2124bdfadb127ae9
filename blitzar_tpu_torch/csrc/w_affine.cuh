// The per-thread body of w_affine.cu: a Weierstrass table chunk's projective
// entries to the affine rows of the reference's raw file
// (blitzar_tpu/msm/interop.py:_w_affine_xy and the row format of :100-113).
// BTT_HD like mont.cuh, so the host harness runs the very code of the kernel
// on the CPU.
//
// A chunk is (E, 3, K) 32-bit words, entry e's x, y, z consecutive (the
// table's layout, ops/cuda_wpoint.py:unpack_points); its rows are (E, 2K)
// words, x then y: as little-endian u64 words, the file's {x, y}. Affine
// coordinates are Montgomery and canonical; an identity entry (z = 0) gets
// x = 0 but its last u64 word 2^64 - 1, and y the Montgomery one.
//
// A thread inverts the z of its own entries first + j * step, j < n, by
// Montgomery's trick: the forward sweep parks the product of the earlier z
// in the x words of each row (zeros stand as one) and returns the product
// of all; given that product's inverse, the backward sweep peels one entry
// off at a time, zinv = inv * parked, inv = inv * z, and writes x zinv,
// y zinv. Any split of the entries gives the same inverses, so the order
// of the entries and who inverts the product do not change the rows.
#pragma once

#include "fp25519.cuh"
#include "weierstrass.cuh"

namespace btt {

template <class F>
BTT_HD mfe<F> affine_load(const uint32_t* p) {
  mfe<F> r;
#pragma unroll
  for (int i = 0; i < F::K / 4; ++i) {
    const word4 u = reinterpret_cast<const word4*>(p)[i];
    r.v[4 * i] = u.x;
    r.v[4 * i + 1] = u.y;
    r.v[4 * i + 2] = u.z;
    r.v[4 * i + 3] = u.w;
  }
  return r;
}

// The chunk is read-only for the kernel's lifetime: through the read-only
// cache on the card.
template <class F>
BTT_HD mfe<F> affine_load_entry(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  mfe<F> r;
#pragma unroll
  for (int i = 0; i < F::K / 4; ++i) {
    const word4 u = __ldg(reinterpret_cast<const word4*>(p) + i);
    r.v[4 * i] = u.x;
    r.v[4 * i + 1] = u.y;
    r.v[4 * i + 2] = u.z;
    r.v[4 * i + 3] = u.w;
  }
  return r;
#else
  return affine_load<F>(p);
#endif
}

template <class F>
BTT_HD void affine_store(uint32_t* p, const mfe<F>& a) {
#pragma unroll
  for (int i = 0; i < F::K / 4; ++i) {
    reinterpret_cast<word4*>(p)[i] = make_word4(a.v[4 * i], a.v[4 * i + 1], a.v[4 * i + 2], a.v[4 * i + 3]);
  }
}

// z of entry e, one where it is zero
template <class F>
BTT_HD mfe<F> affine_z(const uint32_t* entries, int64_t e) {
  const mfe<F> z = affine_load_entry<F>(entries + (3 * e + 2) * F::K);
  return mf_is_zero<F>(z) ? mf_one<F>() : z;
}

// The forward sweep over entries first + j * step, j < n: row e's x words
// get the product of the earlier entries' z; returns the product of all
// (one for n = 0).
template <class F, class Mul>
BTT_HD mfe<F> affine_forward(const uint32_t* entries, uint32_t* rows, int64_t first, int64_t step, int n) {
  Mul mul;
  mfe<F> acc = mf_one<F>();
  for (int j = 0; j < n; ++j) {
    const int64_t e = first + j * step;
    affine_store<F>(rows + 2 * F::K * e, acc);
    const mfe<F> z = affine_z<F>(entries, e);
    acc = j == 0 ? z : mul(acc, z);
  }
  return acc;
}

// The backward sweep, inv the inverse of affine_forward's product: each
// row's x and y, from the last entry to the first.
template <class F, class Mul>
BTT_HD void affine_backward(const uint32_t* entries, uint32_t* rows, int64_t first, int64_t step, int n,
                            mfe<F> inv) {
  constexpr int K = F::K;
  Mul mul;
  for (int j = n - 1; j >= 0; --j) {
    const int64_t e = first + j * step;
    uint32_t* row = rows + 2 * K * e;
    const uint32_t* entry = entries + 3 * K * e;
    mfe<F> zinv = inv;
    if (j > 0) {
      zinv = mul(inv, affine_load<F>(row));
      inv = mul(inv, affine_z<F>(entries, e));
    }
    mfe<F> x = mul(affine_load_entry<F>(entry), zinv);
    mfe<F> y = mul(affine_load_entry<F>(entry + K), zinv);
    if (mf_is_zero<F>(affine_load_entry<F>(entry + 2 * K))) {
      x = mf_zero<F>();
      x.v[K - 2] = x.v[K - 1] = 0xffffffffu;
      y = mf_one<F>();
    }
    affine_store<F>(row, x);
    affine_store<F>(row + K, y);
  }
}

// One thread's entries with its own inversion: the harness's row, and the
// kernel's body.
template <class F, class Mul>
BTT_HD void affine_entries(const uint32_t* entries, uint32_t* rows, int64_t first, int64_t step, int n) {
  const mfe<F> total = affine_forward<F, Mul>(entries, rows, first, step, n);
  affine_backward<F, Mul>(entries, rows, first, step, n, mf_inv<F>(total));
}

}  // namespace btt
