// The partition-table builds of build_niels_table.cu, build_cached_table.cu
// and w_build_table.cu: the order in which a lane forms its entries and, for
// the niels form, one batch inversion per run of entries. All three replace
// blitzar_tpu/ops/pallas_point.py:_build_split_tiled (:806); the subset sums
// are its _subset_double_concat (:745-759), the niels inversion its
// _lane_batch_invert (:709-735).
//
// Entry v of a group is the sum of the group's points j over the set bits j
// of v. blitzar_tpu adds them in increasing j from the identity: entry v =
// entry(v - 2^top) + P_top. The cached and the Weierstrass forms are
// projective, so that order is part of their contract; the niels form is
// affine and canonical, so no order of additions can change it.
//
// A run is up to 2^8 consecutive entries of one group (a whole group for
// w <= 8), spread over 2^L lanes (L = min(w, 2), 32 >> L runs a warp):
// lane t owns the run's entries t + 2^L k, rows k < 2^H (L + H = the run's
// bits). A lane forms its row 0, entry t, by adding the points j < L over
// the set bits of t (L steps, the lanes in step, some idle), then its other
// rows one add each, every lane at work: at w = 8, 65 steps a lane for 8
// runs a warp, 8.1 a run against 8 for 255 adds over 32 lanes. Each lane
// runs one loop with one add in its body, and every multiply calls one
// body (fe_mul_call, fp25519.cuh's fe_mul_call_op; mont.cuh's mf_mul_call
// for the Weierstrass form), so the kernels stay small enough for the
// instruction cache and few registers are live.
//
// The cached and the Weierstrass forms share one schedule and one kernel
// (lane_entries, lane_build_kernel), templated over the entry form
// (CachedBuild, WBuild<C>): each row is one add to its parent row, which
// the same lane stored earlier and reads back from the table, and each
// entry is stored as 16-byte words. A Weierstrass group wider than 8 keeps
// 64 rows a lane and takes 2^(w - 6) lanes (lane_shape_of), so every
// parent is still the lane's own row.
//
// Everything here but the kernel is BTT_HD: the kernels run it a lane at a
// time, and host_harness.cpp runs the same code over every lane in turn
// for the CPU tests (tests/test_torch_table_build.py,
// tests/test_torch_wbuild.py).
#pragma once

#include "edwards25519.cuh"
#include "weierstrass.cuh"

namespace btt {

constexpr int kRunBits = 8;   // at most 2^8 entries a run
constexpr int kLaneBits = 2;  // at most 4 lanes a run
// the most points a warp's runs hold, (32 >> L) * bits: 64 from w = 8 on,
// at most 16 below w = kLaneBits; a Weierstrass warp of lane_shape_of(w)
// lanes holds (32 >> L) * w <= 36 points for 8 < w < 11, w above (w <= 30,
// kMaxLaneWindow)
constexpr int kWarpPoints = (32 >> kLaneBits) * kRunBits > 16 ? (32 >> kLaneBits) * kRunBits : 16;

// The split of a run's bits into lane bits L and row bits H, and the run's
// bits (w, or 8 for a wider window).
struct run_shape {
  int bits, L, H;
};

BTT_HD run_shape run_shape_of(int w) {
  run_shape s;
  s.bits = w < kRunBits ? w : kRunBits;
  s.L = s.bits < kLaneBits ? s.bits : kLaneBits;
  s.H = s.bits - s.L;
  return s;
}

BTT_HD int top_bit(int k) {
  int j = 0;
  while (k >> (j + 1)) ++j;
  return j;
}

BTT_HD int low_bit(int k) {
  int j = 0;
  while (!((k >> j) & 1)) ++j;
  return j;
}

// ---------------------------------------------------------------------------
// table entries: 16-byte words (one vector access each on the card)
// ---------------------------------------------------------------------------

BTT_HD void store_raw(word4* dst, const fe& a) {
  dst[0] = make_word4(a.v[0], a.v[1], a.v[2], a.v[3]);
  dst[1] = make_word4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

BTT_HD void store_canonical(word4* dst, const fe& a) { store_raw(dst, fe_canonical(a)); }

BTT_HD fe load_raw(const word4* src) {
  word4 lo = src[0], hi = src[1];
  return fe_const(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w);
}

// ---------------------------------------------------------------------------
// the cached and the Weierstrass forms: blitzar_tpu's order, each row from
// its parent in the table
// ---------------------------------------------------------------------------

// A point as (Y + X, Y - X, Z, T): the second operand of cached_sum.
BTT_HD ge_cached ge_to_sum_form(const ge_p3& p) {
  ge_cached c;
  c.a = fe_add(p.Y, p.X);
  c.b = fe_sub(p.Y, p.X);
  c.z = p.Z;
  c.t = p.T;
  return c;
}

// (Y + X, Y - X, Z, 2d*T) of the identity
BTT_HD ge_cached cached_identity() {
  ge_cached c;
  c.a = fe_one();
  c.b = fe_one();
  c.z = fe_one();
  c.t = fe_zero();
  return c;
}

// A cached entry p plus a point q in sum form, in cached form: the field
// values of the unified add (C = 2d*T_p*T_q with the 2d on p's side) and
// one multiply for the sum's 2d*T; 9 multiplies.
BTT_HD ge_cached cached_sum(const ge_cached& p, const ge_cached& q) {
  fe a = fe_mul_call(p.b, q.b);
  fe b = fe_mul_call(p.a, q.a);
  fe c = fe_mul_call(p.t, q.t);
  fe d = fe_mul_small(fe_mul_call(p.z, q.z), 2);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  fe X = fe_mul_call(e, f);
  fe Y = fe_mul_call(g, h);
  ge_cached r;
  r.a = fe_add(Y, X);
  r.b = fe_sub(Y, X);
  r.z = fe_mul_call(f, g);
  r.t = fe_mul_call(fe_mul_call(e, h), fe_d2());
  return r;
}

// An entry form of the lane schedule: its points (Point: the running sum,
// an entry, and each of the group's points as the add takes them), the
// public batch the points come from (In, point), the identity, the add, and
// an entry's 16-byte words (kChunks) with their store and load. The load
// reads words this thread stored in the same launch, so it goes through
// plain loads, not the read-only cache.

// ristretto255's cached entries: (Y + X, Y - X, Z, 2d*T), 8 words4,
// canonical; the group's points in sum form.
struct CachedBuild {
  using Point = ge_cached;
  using In = point_ptrs;
  static constexpr int kChunks = 8;
  BTT_HD static Point point(const In& p, int64_t i) { return ge_to_sum_form(ge_load(p, i)); }
  BTT_HD static Point identity() { return cached_identity(); }
  BTT_HD static Point add(const Point& acc, const Point& q) { return cached_sum(acc, q); }
  BTT_HD static void store(word4* dst, const Point& c) {
    store_canonical(dst, c.a);
    store_canonical(dst + 2, c.b);
    store_canonical(dst + 4, c.z);
    store_canonical(dst + 6, c.t);
  }
  BTT_HD static Point load(const word4* src) {
    ge_cached c;
    c.a = load_raw(src);
    c.b = load_raw(src + 2);
    c.z = load_raw(src + 4);
    c.t = load_raw(src + 6);
    return c;
  }
};

// A Weierstrass curve's projective entries (X, Y, Z): K words each, K / 4
// words4 (6 an entry for bn254 G1 and Grumpkin, 9 for bls12-381 G1), as
// lookup.cuh's WForm reads them; the complete add with one call of the
// Montgomery body a multiply (mf_mul_call_op), 12 multiplies.
template <class C>
struct WBuild {
  using F = typename C::F;
  using Point = wpoint<C>;
  using In = wpoint_ptrs;
  static constexpr int kCoordChunks = F::K / 4;
  static constexpr int kChunks = 3 * kCoordChunks;
  BTT_HD static Point point(const In& p, int64_t i) { return w_load<C>(p, i); }
  BTT_HD static Point identity() { return w_identity<C>(); }
  BTT_HD static Point add(const Point& acc, const Point& q) { return w_add<C>(acc, q, mf_mul_call_op<F>()); }
  BTT_HD static void store_coord(word4* dst, const mfe<F>& a) {
#pragma unroll
    for (int i = 0; i < kCoordChunks; ++i) dst[i] = make_word4(a.v[4 * i], a.v[4 * i + 1], a.v[4 * i + 2], a.v[4 * i + 3]);
  }
  BTT_HD static mfe<F> load_coord(const word4* src) {
    mfe<F> r;
#pragma unroll
    for (int i = 0; i < kCoordChunks; ++i) {
      const word4 u = src[i];
      r.v[4 * i] = u.x;
      r.v[4 * i + 1] = u.y;
      r.v[4 * i + 2] = u.z;
      r.v[4 * i + 3] = u.w;
    }
    return r;
  }
  BTT_HD static void store(word4* dst, const Point& p) {
    store_coord(dst, p.X);
    store_coord(dst + kCoordChunks, p.Y);
    store_coord(dst + 2 * kCoordChunks, p.Z);
  }
  BTT_HD static Point load(const word4* src) {
    Point p;
    p.X = load_coord(src);
    p.Y = load_coord(src + kCoordChunks);
    p.Z = load_coord(src + 2 * kCoordChunks);
    return p;
  }
};

// The lanes of a group's subset sums: 2^L lanes of 2^H rows (L + H = w).
// Up to w = 8, L = min(w, 2) (run_shape_of); above, H stays 6 and L grows,
// so a lane's work stays that of w = 8 and a wide group spreads over more
// lanes (a warp, or several, for L >= 5). Lane t's row k is entry t + 2^L k,
// whose parent (k minus its top bit) is that lane's own row.
BTT_HD run_shape lane_shape_of(int w) {
  if (w <= kRunBits) return run_shape_of(w);
  run_shape s;
  s.bits = w;
  s.H = kRunBits - kLaneBits;
  s.L = w - s.H;
  return s;
}

// the widest Weierstrass window w_build_table takes (a group of 2^31
// entries would not fit the card)
constexpr int kMaxLaneWindow = 30;

// Lane t's rows of a group of an entry form's table.
template <class Form>
struct lane_rows {
  word4* group;  // the group's first entry
  int L, t;
  BTT_HD word4* at(int k) const { return group + ((int64_t)t + ((int64_t)k << L)) * Form::kChunks; }
  BTT_HD void store(int k, const typename Form::Point& p) const { Form::store(at(k), p); }
  BTT_HD typename Form::Point load(int k) const { return Form::load(at(k)); }
};

// Lane t's entries of a group in blitzar_tpu's order: step s < L adds
// point s if bit s of t is set (row 0 is the last of them); step L - 1 + k
// forms row k from its parent row k - 2^j (j = k's top bit), read back from
// the table where this lane stored it, plus point L + j. pts: the group's
// points as the form's add takes them.
template <class Form>
BTT_HD void lane_entries(const typename Form::Point* pts, int L, int H, const lane_rows<Form>& rows) {
  typename Form::Point acc = Form::identity();
  const int steps = L + (1 << H) - 1;
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int s = 0; s < steps; ++s) {
    int j = s, row = 0;
    bool add = true;
    if (s < L) {
      add = (rows.t >> s) & 1;
    } else {
      row = s - L + 1;
      const int top = top_bit(row);
      j = L + top;
      acc = rows.load(row ^ (1 << top));
    }
    if (add) acc = Form::add(acc, pts[j]);
    if (s >= L - 1) rows.store(row, acc);
  }
}

#if defined(__CUDACC__)
constexpr int kBuildWarps = 4;  // warps a block of lane_build_kernel

// One lane a thread, lanes of a group side by side: the warp's groups'
// points (at most kWarpPoints) are read once into shared memory in the
// form's own representation, then each lane runs lane_entries. No block
// barrier: a warp reads the points it uses.
template <class Form>
__global__ void __launch_bounds__(32 * kBuildWarps)
lane_build_kernel(typename Form::In pts, int w, int64_t groups, word4* table) {
  __shared__ typename Form::Point gens[kBuildWarps][kWarpPoints];
  const run_shape shape = lane_shape_of(w);
  const int L = shape.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t first_lane = ((int64_t)blockIdx.x * kBuildWarps + warp) * 32;
  const int64_t first = first_lane >> L;  // the warp's first group
  const int per_warp = L <= 5 ? 32 >> L : 1;
  for (int i = lane; i < per_warp * w; i += 32) {
    const int64_t g = first + i / w;
    if (g < groups) gens[warp][i] = Form::point(pts, g * w + i % w);
  }
  __syncwarp();
  const int64_t g = (first_lane + lane) >> L;
  if (g >= groups) return;
  const lane_rows<Form> rows{table + (g << w) * Form::kChunks, L, (int)((first_lane + lane) & ((1 << L) - 1))};
  lane_entries<Form>(gens[warp] + (g - first) * w, L, shape.H, rows);
}

template <class Form>
void launch_lane_build(const typename Form::In& pts, int w, int64_t groups, word4* table, cudaStream_t stream) {
  const int64_t lanes = groups << lane_shape_of(w).L;
  const int64_t threads = 32 * kBuildWarps;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  lane_build_kernel<Form><<<blocks, (unsigned)threads, 0, stream>>>(pts, w, groups, table);
}
#endif

// ---------------------------------------------------------------------------
// the niels form: a Gray-code walk and one batch inversion a run
// ---------------------------------------------------------------------------
//
// A lane walks its rows in Gray-code order (row_i = i ^ (i >> 1)), each the
// last plus or minus one point, so only the running sum is live. Its slots
// park the walk for Montgomery's batch inversion: row_i's slot gets
// (X c, Y c, Z), c the product of the Z of the rows walked before it. The
// run's lanes then scan their products c_all across the run (E_t: the
// product of the lanes before t, S_t: of those after; the kernel scans with
// shuffles, the host in a loop), the run's product T is inverted once, and
// lane t's walk starts back at inv = 1/c_all = E_t S_t / T: row_i's
// x = (X c) inv, y = (Y c) inv, then inv *= Z. Two multiplies an entry to
// 1/Z and one inversion a run, where one inversion an entry takes 265.

BTT_HD int gray_row(int i) { return i ^ (i >> 1); }

// -q for q in cached form (Y + X, Y - X, Z, 2d*T)
BTT_HD ge_cached cached_neg(const ge_cached& q) {
  ge_cached r;
  r.a = q.b;
  r.b = q.a;
  r.z = q.z;
  r.t = fe_neg(q.t);
  return r;
}

// Lane t's rows of a run in a niels table: 6 words4 an entry, (X c, Y c, Z)
// while parked, then the canonical niels entry.
struct niels_rows {
  word4* run;  // the run's first entry
  int L, t;
  BTT_HD word4* at(int k) const { return run + (int64_t)(t + (k << L)) * 6; }
};

// Walks lane t's rows from `acc` (the run's start) and parks them; returns
// the product of their Z. pts: the run's points in cached form. Step s < L
// adds point s if bit s of t is set (row 0 is the last of them); step
// L - 1 + i goes from row_{i-1} to row_i, adding or taking away point
// L + j for the bit j they differ in.
BTT_HD fe niels_lane_park(const ge_cached* pts, int L, int H, ge_p3 acc, const niels_rows& rows) {
  fe c = fe_one();
  const int steps = L + (1 << H) - 1;
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int s = 0; s < steps; ++s) {
    int j = s, row = 0;
    bool add = (rows.t >> s) & 1, neg = false;
    if (s >= L) {
      const int i = s - L + 1, b = low_bit(i);
      row = gray_row(i);
      j = L + b;
      neg = !((row >> b) & 1);
      add = true;
    }
    if (add) acc = ge_cadd(acc, neg ? cached_neg(pts[j]) : pts[j], fe_mul_call_op());
    if (s >= L - 1) {
      word4* slot = rows.at(row);
      store_raw(slot, fe_mul_call(acc.X, c));
      store_raw(slot + 2, fe_mul_call(acc.Y, c));
      store_raw(slot + 4, acc.Z);
      c = fe_mul_call(c, acc.Z);
    }
  }
  return c;
}

// Walks lane t's rows back from inv = 1/(the product niels_lane_park
// returned) and overwrites each parked slot with its niels entry.
BTT_HD void niels_lane_store(int H, fe inv, const niels_rows& rows) {
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int i = (1 << H) - 1; i >= 0; --i) {
    word4* slot = rows.at(gray_row(i));
    const fe x = fe_mul_call(load_raw(slot), inv);
    const fe y = fe_mul_call(load_raw(slot + 2), inv);
    inv = fe_mul_call(inv, load_raw(slot + 4));
    store_canonical(slot, fe_add(y, x));
    store_canonical(slot + 2, fe_sub(y, x));
    store_canonical(slot + 4, fe_mul_call(fe_mul_call(x, y), fe_d2()));
  }
}

// point j of a group (first point base)
struct group_point {
  point_ptrs p;
  int64_t base;
  BTT_HD ge_p3 operator()(int j) const { return ge_load(p, base + j); }
};

// The start of run r of a group wider than 8: the sum of its points 8 + j
// over the set bits j of r (the identity for r = 0).
template <class LoadPoint>
BTT_HD ge_p3 run_start(LoadPoint& point, int w, int64_t r) {
  ge_p3 acc = ge_identity();
  for (int j = kRunBits; j < w; ++j) {
    if ((r >> (j - kRunBits)) & 1) acc = ge_cadd(acc, ge_to_cached(point(j), fe_mul_call_op()), fe_mul_call_op());
  }
  return acc;
}

}  // namespace btt
