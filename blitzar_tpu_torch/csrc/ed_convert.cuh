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
//   niels words; the file's X Y is not read, 2d x y is recomputed;
// - ed_niels_points: niels words back to canonical extended points (x, y,
//   1, x y) in the public layout (blitzar_tpu/msm/fixed.py:397-414, the npz
//   write's point table);
// - ed_affine: extended points, z never 0, to canonical (x/z, y/z, 1,
//   x y/z^2) (blitzar_tpu/generators.py:132-144, the disk cache's affine
//   generators; a legacy extended file's z normalised to 1);
// - ed_from_affine_rows: the disk cache's affine rows, x and y as 16-bit
//   limbs, to canonical (x, y, 1, x y) (blitzar_tpu/generators.py:62-72,
//   _affine_to_p3_chunk, the cache's load).
//
// BTT_HD like fp25519.cuh, so the host harness runs the very code of the
// kernels on the CPU (tests/test_torch_edconvert.py).
//
// Layouts. A point chunk is the public layout (16 radix-2^16 int32 limbs at
// a limb stride, entry e at c[l * limb_stride + e]); a niels entry is 24
// 32-bit words, a | b | t, each canonical (edwards25519.cuh:niels_store); a
// file row is 15 little-endian u64 words, X, Y, X Y, five 51-bit limbs each.
//
// ed_to_niels and ed_affine invert the z of a thread's own entries first +
// j * step, j < n, by Montgomery's trick (field_batch.cuh, shared with
// finvert.cu), as w_affine.cuh does for the Weierstrass curves: the forward
// sweep parks the product of the earlier z in a slot of each entry's output
// (ed_to_niels: word slot a; ed_affine: coordinate t); the backward sweep
// peels one entry off at a time and writes the entry.
#pragma once

#include "edwards25519.cuh"
#include "field_batch.cuh"

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

// A thread's entries first + j * step as field_batch.cuh's batch of z: each
// prefix parked in slot a of the entry's words, x = X zinv and y = Y zinv
// then its niels words; 6 multiplies an entry with the sweep's 3. Only x,
// y and the sweep's inverse live across the multiplies of put.
template <class Mul>
struct NielsBatch {
  point_ptrs p;
  uint32_t* out;
  int64_t first, step;

  BTT_HD int64_t at(int j) const { return first + j * step; }
  BTT_HD bool counts(int) const { return true; }  // an extended z is never 0
  BTT_HD fe value(int j) const { return fe_load(p.c[2] + at(j), p.limb_stride); }
  BTT_HD void park(int j, const fe& prefix) { fe_store_words(out + kNielsWords * at(j), prefix); }
  BTT_HD fe parked(int j) const { return fe_load_words(out + kNielsWords * at(j)); }
  BTT_HD void put(int j, const fe& zinv) {
    Mul mul;
    const int64_t e = at(j);
    const fe x = mul(fe_load(p.c[0] + e, p.limb_stride), zinv);
    const fe y = mul(fe_load(p.c[1] + e, p.limb_stride), zinv);
    affine_niels_store(out + kNielsWords * e, x, y, mul);
  }
  BTT_HD void skip(int) {}
};

// One thread's entries with its own inversion: the kernel's body, and the
// harness's lane.
template <class Mul>
BTT_HD void niels_entries(const point_ptrs& p, uint32_t* out, int64_t first, int64_t step, int n) {
  NielsBatch<Mul> b = {p, out, first, step};
  batch_invert_sweep<Mul>(b, n);
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

// Niels entry -> its affine x = (a - b) / 2 and y = (a + b) / 2, canonical:
// two multiplies. t is not read.
template <class Mul>
BTT_HD void niels_affine(const uint32_t* entry, fe& x, fe& y, Mul mul) {
  const fe a = fe_load_words_ro(entry), b = fe_load_words_ro(entry + 8);
  const fe inv2 = fe_const(0xfffffff7u, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                           0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu);
  x = fe_canonical(mul(fe_sub(a, b), inv2));
  y = fe_canonical(mul(fe_add(a, b), inv2));
}

// Niels entry -> its file row: x, y and x y, three multiplies, canonical
// field51 limbs. The kernel writes the row to shared memory.
template <class Mul>
BTT_HD void niels_file_row(const uint32_t* entry, uint64_t* row, Mul mul) {
  fe x, y;
  niels_affine(entry, x, y, mul);
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

// ---------------------------------------------------------------------------
// back to extended points: ed_niels_points, ed_affine, ed_from_affine_rows
// ---------------------------------------------------------------------------

// Niels entry -> entry e of the extended output, canonical (x, y, 1, x y):
// three multiplies. x y has the canonical value of the entry's 2d t /
// (2d), at one multiply where that takes two.
template <class Mul>
BTT_HD void niels_point_store(const uint32_t* entry, const point_out_ptrs& out, int64_t e, Mul mul) {
  fe x, y;
  niels_affine(entry, x, y, mul);
  fe_store(out.c[0] + e, out.limb_stride, x);
  fe_store(out.c[1] + e, out.limb_stride, y);
  fe_store(out.c[2] + e, out.limb_stride, fe_one());
  fe_store(out.c[3] + e, out.limb_stride, mul(x, y));
}

// A thread's entries first + j * step of ed_affine as field_batch.cuh's
// batch of z: each prefix parked in the entry's output t, then x = X zinv,
// y = Y zinv and x y; 6 multiplies an entry with the sweep's 3. x and y are
// stored as soon as they are made and read back for x y, so that besides
// the batch's pointers only the sweep's inverse and zinv live across a call
// of the non-inlined multiply (with x and y live too, the kernel spilled
// 24 bytes).
template <class Mul>
struct AffineBatch {
  const int32_t *x, *y, *z;
  int64_t in_stride;
  point_out_ptrs out;
  int64_t first, step;

  BTT_HD int64_t at(int j) const { return first + j * step; }
  BTT_HD bool counts(int) const { return true; }  // z is never 0
  BTT_HD fe value(int j) const { return fe_load(z + at(j), in_stride); }
  BTT_HD void park(int j, const fe& prefix) { fe_store(out.c[3] + at(j), out.limb_stride, prefix); }
  BTT_HD fe parked(int j) const { return fe_load(out.c[3] + at(j), out.limb_stride); }
  BTT_HD void put(int j, const fe& zinv) {
    Mul mul;
    const int64_t e = at(j);
    fe_store(out.c[0] + e, out.limb_stride, mul(fe_load(x + e, in_stride), zinv));
    fe_store(out.c[1] + e, out.limb_stride, mul(fe_load(y + e, in_stride), zinv));
    fe_store(out.c[2] + e, out.limb_stride, fe_one());
    const fe t = mul(fe_load(out.c[0] + e, out.limb_stride), fe_load(out.c[1] + e, out.limb_stride));
    fe_store(out.c[3] + e, out.limb_stride, t);
  }
  BTT_HD void skip(int) {}
};

// 16 radix-2^16 limbs (uint16, each below 2^16) at base[l * stride] ->
// element (value below 2^256).
BTT_HD fe fe_load_u16(const uint16_t* base, int64_t stride) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = (uint32_t)base[(2 * k) * stride] | ((uint32_t)base[(2 * k + 1) * stride] << 16);
  return r;
}

// Entry e of the cache file's affine rows (x limbs at rows[l * stride + e],
// y limbs at rows[(16 + l) * stride + e]) -> entry e of the extended
// output, canonical (x, y, 1, x y): one multiply.
template <class Mul>
BTT_HD void affine_row_point_store(const uint16_t* rows, int64_t stride, const point_out_ptrs& out, int64_t e,
                                   Mul mul) {
  const fe x = fe_load_u16(rows + e, stride), y = fe_load_u16(rows + 16 * stride + e, stride);
  fe_store(out.c[0] + e, out.limb_stride, x);
  fe_store(out.c[1] + e, out.limb_stride, y);
  fe_store(out.c[2] + e, out.limb_stride, fe_one());
  fe_store(out.c[3] + e, out.limb_stride, mul(x, y));
}

// One thread's entries of ed_affine with its own inversion: the kernel's
// body, and the harness's lane. The output must not overlap the input.
template <class Mul>
BTT_HD void ed_affine_entries(const point_ptrs& p, const point_out_ptrs& out, int64_t first, int64_t step, int n) {
  AffineBatch<Mul> b = {p.c[0], p.c[1], p.c[2], p.limb_stride, out, first, step};
  batch_invert_sweep<Mul>(b, n);
}

}  // namespace btt
