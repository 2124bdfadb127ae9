// The per-thread schedule of the two lookups, ed_lookup_msm.cu and
// w_lookup_msm.cu: how thread (k, r) forms its table indices, reads the
// entries they pick and adds them, in which order, one template over the
// entry form. The kernels run it on the card; host_harness.cpp runs the
// same code thread by thread, so the CPU tests
// (tests/test_torch_lookup_body.py) hold the kernels' indices, order and
// arithmetic against the plain versions limb for limb.
//
// For bit-row r (output o, scalar bit b) and group g, idx[r, g] = sum_j
// bit_b(scalar[o, g*w + j]) << j picks table entry (g, idx); row r's product
// is the sum over g of those entries. Thread (k, r) owns row r and chunk k,
// the groups [k * chunk_groups, (k + 1) * chunk_groups) cut at the group
// count, and adds their nonzero entries in increasing g (entry 0 is the
// identity and is skipped): a 7-multiply mixed add for a niels entry, an
// 8-multiply add for a cached one, each stage of independent multiplies one
// non-inlined body (edwards25519.cuh); a 12-multiply complete add for a
// Weierstrass entry, each multiply one call of one non-inlined Montgomery
// body (weierstrass.cuh, mont.cuh). An entry is read with 16-byte loads
// through the read-only cache straight into the add's operands; the other
// warps of the SM cover the wait (the adds bound the lookup, not the
// gathers).
//
// The scalars of output o start at scalars + o * row_stride * nbytes, so a
// streamed chunk reads its slice of the whole upload in place (row_stride
// is the upload's length, not the chunk's). Signed queries run two halves
// of rows against the same table: a bit counts in the first half where the
// element's sign is 0 and in the second where it is 1
// (blitzar_tpu/msm/fixed.py:667-676).
#pragma once

#include "edwards25519.cuh"
#include "weierstrass.cuh"

namespace btt {

struct lookup_query {
  const word4* table;     // (groups, 2^w, coords, words) words
  const uint8_t* scalars; // output o at o * row_stride * nbytes
  const uint8_t* signs;   // output o at o * row_stride, or null
  int64_t row_stride;
  int nbytes, w;
  int64_t groups, rows_per_half;
  int halves;
  int64_t chunk_groups;
};

// Where row r reads its bits: its output's byte column, the bit in the
// byte, its output's signs and its half.
struct lookup_row {
  const uint8_t* bytes;
  const uint8_t* signs;
  uint32_t shift;
  int half;
};

BTT_HD uint8_t load_byte(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

BTT_HD word4 load_word4(const word4* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

BTT_HD lookup_row lookup_row_of(const lookup_query& q, int64_t r) {
  const int nbits = 8 * q.nbytes;
  const int64_t rem = r % q.rows_per_half;
  const int64_t o = rem / nbits;
  const int b = (int)(rem % nbits);
  lookup_row row;
  row.bytes = q.scalars + o * q.row_stride * q.nbytes + (b >> 3);
  row.signs = q.signs ? q.signs + o * q.row_stride : nullptr;
  row.shift = (uint32_t)(b & 7);
  row.half = (int)(r / q.rows_per_half);
  return row;
}

BTT_HD uint32_t lookup_index(const lookup_query& q, const lookup_row& row, int64_t g) {
  uint32_t idx = 0;
  for (int j = 0; j < q.w; ++j) {
    const int64_t i = g * q.w + j;
    uint32_t bit = ((uint32_t)load_byte(row.bytes + i * q.nbytes) >> row.shift) & 1u;
    if (row.signs) bit &= (uint32_t)((load_byte(row.signs + i) == 1) == (row.half == 1));
    idx |= bit << j;
  }
  return idx;
}

// Coordinate c of the entry at e: two 16-byte words.
BTT_HD fe entry_coord(const word4* e, int c) {
  const word4 lo = load_word4(e + 2 * c), hi = load_word4(e + 2 * c + 1);
  return fe_const(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w);
}

// An entry form: its accumulator (Point, identity()), its 16-byte words an
// entry (kChunks) and the add of an accumulator and an entry.
struct NielsForm {
  using Point = ge_p3;
  static constexpr int kChunks = 6;  // 16-byte words an entry: (y + x, y - x, 2d*x*y)
  BTT_HD static ge_p3 identity() { return ge_identity(); }
  BTT_HD static ge_p3 add(const ge_p3& acc, const word4* e) {
    ge_niels n;
    n.a = entry_coord(e, 0);
    n.b = entry_coord(e, 1);
    n.t = entry_coord(e, 2);
    return ge_madd(acc, n);
  }
};

struct CachedForm {
  using Point = ge_p3;
  static constexpr int kChunks = 8;  // (y + x, y - x, z, 2d*t)
  BTT_HD static ge_p3 identity() { return ge_identity(); }
  BTT_HD static ge_p3 add(const ge_p3& acc, const word4* e) {
    ge_cached c;
    c.a = entry_coord(e, 0);
    c.b = entry_coord(e, 1);
    c.z = entry_coord(e, 2);
    c.t = entry_coord(e, 3);
    return ge_cadd(acc, c);
  }
};

// A projective Weierstrass entry of curve C: (X, Y, Z), K words each
// (K / 4 16-byte words), added with the complete formula, one call of the
// Montgomery body a multiply.
template <class C>
struct WForm {
  using F = typename C::F;
  using Point = wpoint<C>;
  static constexpr int kCoordChunks = F::K / 4;
  static constexpr int kChunks = 3 * kCoordChunks;  // 6 (K = 8) or 9 (K = 12)
  BTT_HD static wpoint<C> identity() { return w_identity<C>(); }
  BTT_HD static mfe<F> coord(const word4* e) {
    mfe<F> r;
#pragma unroll
    for (int i = 0; i < kCoordChunks; ++i) {
      const word4 u = load_word4(e + i);
      r.v[4 * i] = u.x;
      r.v[4 * i + 1] = u.y;
      r.v[4 * i + 2] = u.z;
      r.v[4 * i + 3] = u.w;
    }
    return r;
  }
  BTT_HD static wpoint<C> add(const wpoint<C>& acc, const word4* e) {
    wpoint<C> p;
    p.X = coord(e);
    p.Y = coord(e + kCoordChunks);
    p.Z = coord(e + 2 * kCoordChunks);
    return w_add<C>(acc, p, mf_mul_call_op<F>());
  }
};

// Thread (k, r)'s product.
template <class Form>
BTT_HD typename Form::Point lookup_thread(const lookup_query& q, int64_t k, int64_t r) {
  const lookup_row row = lookup_row_of(q, r);
  const int64_t g0 = k * q.chunk_groups;
  const int64_t g1 = g0 + q.chunk_groups < q.groups ? g0 + q.chunk_groups : q.groups;
  typename Form::Point acc = Form::identity();
  for (int64_t g = g0; g < g1; ++g) {
    const uint32_t idx = lookup_index(q, row, g);
    if (idx) acc = Form::add(acc, q.table + ((g << q.w) + idx) * Form::kChunks);
  }
  return acc;
}

}  // namespace btt
