// The per-thread bodies of ed_convert.cu: a ristretto255 table's conversions
// between its forms, one entry format to another in one pass.
//
// - ed_to_niels: extended points (X, Y, Z) of a table chunk to the handle's
//   niels words (y + x, y - x, 2d x y) (blitzar_tpu/msm/fixed.py:197-220,
//   its z inverted by _batch_invert_lanes :184-194);
// - ed_file_rows: niels words to the reference's raw-file rows {X, Y, X Y}
//   as canonical radix-2^51 field51 limbs (blitzar_tpu/msm/interop.py's
//   writer);
// - ed_file_entries: raw-file rows, any field51 representation, back to
//   niels words; the file's X Y is not read, 2d x y is recomputed.
//
// BTT_HD like fp25519.cuh, so the host harness runs the very code of the
// kernels on the CPU (tests/test_torch_edconvert.py).
//
// Layouts. A point chunk is the public layout (16 radix-2^16 int32 limbs at
// a limb stride, entry e at c[l * limb_stride + e]); a niels entry is 24
// 32-bit words, a | b | t, each canonical (edwards25519.cuh:niels_store); a
// file row is 15 little-endian u64 words, X, Y, X Y, five 51-bit limbs each.
//
// ed_to_niels inverts the z of a thread's own entries first + j * step,
// j < n, by Montgomery's trick, as w_affine.cuh does for the Weierstrass
// curves: the forward sweep parks the product of the earlier z in word
// slot a of each entry it will write and returns the product of all; given
// that product's inverse, the backward sweep peels one entry off at a time,
// zinv = inv * parked, inv = inv * z, and writes the entry. Inverses are
// unique, so any split of the entries gives the same words. An extended z
// is never 0.
#pragma once

#include "edwards25519.cuh"

namespace btt {

// 8 words at p, 16-byte aligned, as two 16-byte accesses.
BTT_HD fe fe_load_words(const uint32_t* p) {
  const word4 lo = reinterpret_cast<const word4*>(p)[0], hi = reinterpret_cast<const word4*>(p)[1];
  return fe_const(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w);
}

// The same through the read-only cache on the card: for inputs no thread
// writes during the kernel.
BTT_HD fe fe_load_words_ro(const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  const word4 lo = __ldg(reinterpret_cast<const word4*>(p)), hi = __ldg(reinterpret_cast<const word4*>(p) + 1);
  return fe_const(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w);
#else
  return fe_load_words(p);
#endif
}

BTT_HD void fe_store_words(uint32_t* p, const fe& a) {
  reinterpret_cast<word4*>(p)[0] = make_word4(a.v[0], a.v[1], a.v[2], a.v[3]);
  reinterpret_cast<word4*>(p)[1] = make_word4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

constexpr int kNielsWords = 24;
constexpr int kFileWords = 15;

// Affine (x, y) -> the niels entry (y + x, y - x, 2d x y): two multiplies.
// a and b are stored before the multiplies, so that with a non-inlined
// multiply they need not live across its calls.
template <class Mul>
BTT_HD void affine_niels_store(uint32_t* entry, const fe& x, const fe& y, Mul mul) {
  fe_store_words(entry, fe_canonical(fe_add(y, x)));
  fe_store_words(entry + 8, fe_canonical(fe_sub(y, x)));
  fe_store_words(entry + 16, fe_canonical(mul(mul(x, y), fe_d2())));
}

// ---------------------------------------------------------------------------
// ed_to_niels
// ---------------------------------------------------------------------------

// The forward sweep over entries first + j * step, j < n: entry e's slot a
// gets the product of the earlier entries' z; returns the product of all
// (one for n = 0).
template <class Mul>
BTT_HD fe niels_forward(const point_ptrs& p, uint32_t* out, int64_t first, int64_t step, int n) {
  Mul mul;
  fe acc = fe_one();
  for (int j = 0; j < n; ++j) {
    const int64_t e = first + j * step;
    fe_store_words(out + kNielsWords * e, acc);
    const fe z = fe_load(p.c[2] + e, p.limb_stride);
    acc = j == 0 ? z : mul(acc, z);
  }
  return acc;
}

// The backward sweep, inv the inverse of niels_forward's product: each
// entry's x = X zinv and y = Y zinv, then its niels words, from the last
// entry to the first. 6 multiplies an entry.
template <class Mul>
BTT_HD void niels_backward(const point_ptrs& p, uint32_t* out, int64_t first, int64_t step, int n, fe inv) {
  Mul mul;
  for (int j = n - 1; j >= 0; --j) {
    const int64_t e = first + j * step;
    uint32_t* entry = out + kNielsWords * e;
    fe zinv = inv;
    if (j > 0) {
      zinv = mul(inv, fe_load_words(entry));
      inv = mul(inv, fe_load(p.c[2] + e, p.limb_stride));
    }
    const fe x = mul(fe_load(p.c[0] + e, p.limb_stride), zinv);
    const fe y = mul(fe_load(p.c[1] + e, p.limb_stride), zinv);
    affine_niels_store(entry, x, y, mul);
  }
}

// One thread's entries with its own inversion (fe_invert: the
// fe_pow_chain_250 chain, ~265 multiplies): the kernel's body, and the
// harness's lane.
template <class Mul>
BTT_HD void niels_entries(const point_ptrs& p, uint32_t* out, int64_t first, int64_t step, int n) {
  const fe total = niels_forward<Mul>(p, out, first, step, n);
  niels_backward<Mul>(p, out, first, step, n, fe_invert(total, Mul()));
}

// ---------------------------------------------------------------------------
// the raw file's field51 rows
// ---------------------------------------------------------------------------

// Bits [51 j, 51 j + 51) of a canonical element.
BTT_HD uint64_t fe_limb51(const fe& c, int j) {
  const int lo = 51 * j, q = lo >> 5, r = lo & 31;
  const uint64_t w0 = c.v[q], w1 = q + 1 < 8 ? c.v[q + 1] : 0u, w2 = q + 2 < 8 ? c.v[q + 2] : 0u;
  uint64_t v = (w0 | (w1 << 32)) >> r;
  if (r) v |= w2 << (64 - r);
  return v & ((1ull << 51) - 1);
}

// Five field51 limbs of any magnitude (the value is below 2^269) -> an
// element: the limbs added into nine 32-bit columns at bits 51 i, carried,
// and the part above 2^256 folded by 38.
BTT_HD fe fe_from_limbs51(const uint64_t* l) {
  uint64_t col[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int q = (51 * i) >> 5, r = (51 * i) & 31;
    const uint64_t lo = (l[i] & 0xffffffffull) << r, hi = (l[i] >> 32) << r;  // each below 2^63
    col[q] += lo & 0xffffffffull;
    col[q + 1] += (lo >> 32) + (hi & 0xffffffffull);
    col[q + 2] += hi >> 32;
  }
  fe r;
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc += col[k];
    r.v[k] = (uint32_t)acc;
    acc >>= 32;
  }
  fe_fold(r, (uint32_t)(acc + col[8]));  // below 2^13
  return r;
}

// Niels entry -> its file row: x = (a - b) / 2, y = (a + b) / 2 and x y,
// three multiplies, canonical field51 limbs. t is not read. The kernel
// writes the row to shared memory.
template <class Mul>
BTT_HD void niels_file_row(const uint32_t* entry, uint64_t* row, Mul mul) {
  const fe a = fe_load_words_ro(entry), b = fe_load_words_ro(entry + 8);
  const fe inv2 = fe_const(0xfffffff7u, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                           0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu);
  const fe x = fe_canonical(mul(fe_sub(a, b), inv2));
  const fe y = fe_canonical(mul(fe_add(a, b), inv2));
  const fe xy = fe_canonical(mul(x, y));
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    row[j] = fe_limb51(x, j);
    row[5 + j] = fe_limb51(y, j);
    row[10 + j] = fe_limb51(xy, j);
  }
}

// File row -> its niels entry: x and y from the row's first ten limbs, 2d
// x y recomputed; two multiplies. The kernel reads the row from, and writes
// the entry to, shared memory (16-byte aligned).
template <class Mul>
BTT_HD void file_row_niels(const uint64_t* row, uint32_t* entry, Mul mul) {
  affine_niels_store(entry, fe_from_limbs51(row), fe_from_limbs51(row + 5), mul);
}

}  // namespace btt
