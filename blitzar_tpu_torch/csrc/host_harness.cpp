// Host build of the kernels' arithmetic, for the CPU tests.
//
// fp25519.cuh, field_batch.cuh, edwards25519.cuh, niels_tree.cuh,
// table_build.cuh, lookup.cuh, mont.cuh, weierstrass.cuh, ladder.cuh,
// sumcheck.cuh, tree_reduce.cuh, w_affine.cuh, ed_convert.cuh and
// window_sums.cuh (edwards25519.cuh with ristretto.cu's codec bodies),
// mont_rows.cuh and quad_add.cuh are compiled here by a host C++ compiler (BTT_HD is plain inline then), so
// tests/test_torch_native_arith.py can hold the very code the CUDA kernels
// run against blitzar_tpu and the plain versions without a card. Each
// function loops over n elements in the public layout: a field batch is a
// (nlimbs, n) int32 array, an Edwards point batch (4, 16, n), a niels batch
// (3, 16, n), a cached batch (4, 16, n), a Weierstrass point batch (3,
// nlimbs, n), a sumcheck MLE table (16, m, 2 mid), a Weierstrass table
// chunk (count, 3, K) words, a ristretto255 one (count, 3, 8) words, a raw
// file's rows (count, 15) u64 words, ristretto255 encodings (32, n) bytes,
// the proofs' ABI rows (num_mles * n, nbytes) bytes.
#include "ed_convert.cuh"
#include "edwards25519.cuh"
#include "field_batch.cuh"
#include "ladder.cuh"
#include "lookup.cuh"
#include "mont_rows.cuh"
#include "niels_tree.cuh"
#include "quad_add.cuh"
#include "sumcheck.cuh"
#include "table_build.cuh"
#include "tree_reduce.cuh"
#include "w_affine.cuh"
#include "weierstrass.cuh"
#include "window_sums.cuh"

#include <vector>

using namespace btt;

namespace {

point_ptrs in_points(const int32_t* base, int64_t n) {
  point_ptrs p;
  for (int k = 0; k < 4; ++k) p.c[k] = base + k * 16 * n;
  p.limb_stride = n;
  return p;
}

point_out_ptrs out_points(int32_t* base, int64_t n) {
  point_out_ptrs p;
  for (int k = 0; k < 4; ++k) p.c[k] = base + k * 16 * n;
  p.limb_stride = n;
  return p;
}

// fewrow_lane_sum's stack of waiting sums (shared memory on the card)
struct HostStack {
  ge_p3 p[16];
  void push(int level, const ge_p3& q) { p[level] = q; }
  ge_p3 pop(int level) const { return p[level]; }
};

ge_niels load_niels(const int32_t* base, int64_t n, int64_t i) {
  ge_niels r;
  r.a = fe_load(base + i, n);
  r.b = fe_load(base + 16 * n + i, n);
  r.t = fe_load(base + 32 * n + i, n);
  return r;
}

// op: 0 mul, 1 sq, 2 add, 3 sub, 4 neg, 5 inv over the field F
template <class F>
void host_mont_field(int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    mfe<F> x = mf_load<F>(a + i, n);
    mfe<F> y = mf_load<F>(b + i, n);
    mfe<F> r;
    switch (op) {
      case 0: r = mf_mul<F>(x, y); break;
      case 1: r = mf_sq<F>(x); break;
      case 2: r = mf_add<F>(x, y); break;
      case 3: r = mf_sub<F>(x, y); break;
      case 4: r = mf_neg<F>(x); break;
      default: r = mf_inv<F>(x); break;
    }
    mf_store<F>(out + i, n, r);
  }
}

// the same over the base field of the curve C
template <class C>
void host_mont(int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  host_mont_field<typename C::F>(op, a, b, out, n);
}

// mont_rows.cu's launcher on the host, its blocks one after another: each
// block's run of bytes staged as the kernel stages it (16 bytes at a time
// from a0, bytes past the input's end left out), then its columns.
template <class F>
void host_mont_from_rows(const uint8_t* rows, int64_t num_mles, int64_t n, int nbytes, int64_t n_pad,
                         const int32_t* scale, int32_t* out) {
  const int64_t col_blocks = (n_pad + kRowsThreads - 1) / kRowsThreads;
  const int64_t total = num_mles * n * nbytes;
  const mfe<F> c = mf_load<F>(scale, 1);
  alignas(16) uint8_t staged[kRowsStageBytes];
  for (int64_t block = 0; block < num_mles * col_blocks; ++block) {
    const rows_span s = rows_span_of(block, col_blocks, n, nbytes);
    for (int64_t o = 0; s.a0 + o < s.a1; o += 16) {
      for (int64_t b = s.a0 + o; b < s.a0 + o + 16 && b < total; ++b) staged[b - s.a0] = rows[b];
    }
    for (int t = 0; t < kRowsThreads; ++t) {
      const int64_t col = s.first + t;
      if (col >= n_pad) break;
      const uint8_t* row = t < s.live ? staged + s.skew + (int64_t)t * nbytes : nullptr;
      mf_store<F>(out + s.mle * n_pad + col, num_mles * n_pad, mont_row_element<F>(row, nbytes, c));
    }
  }
}

// The sumcheck round of mont_sum_round.cu, its grid simulated: nblocks
// blocks of `threads` threads, thread t of block b adding lanes
// b * threads + t + k * nblocks * threads; each block's per-(product,
// point) partials, their sums over the blocks and the last block's finish
// (round_point, round_coefficient); out (16, D + 1).
template <class F, int L>
void host_sum_product(const mle_ptrs& t, int64_t mid, const int32_t* terms, int64_t nblocks, int64_t threads,
                      std::vector<mfe<F>>& colsums, int col) {
  for (int k = 0; k <= L; ++k) colsums[col + k] = mf_zero<F>();
  for (int64_t b = 0; b < nblocks; ++b) {
    mfe<F> part[L + 1];
    for (int k = 0; k <= L; ++k) part[k] = mf_zero<F>();
    for (int64_t th = 0; th < threads; ++th) {
      mfe<F> acc[L + 1];
      for (int k = 0; k <= L; ++k) acc[k] = mf_zero<F>();
      for (int64_t i = b * threads + th; i < mid; i += nblocks * threads) {
        add_product_points<F, L, mf_mul_op<F>>(t, mid, i, terms, acc);
      }
      for (int k = 0; k <= L; ++k) part[k] = mf_add<F>(part[k], acc[k]);
    }
    for (int k = 0; k <= L; ++k) colsums[col + k] = mf_add<F>(colsums[col + k], part[k]);
  }
}

template <class F, int D>
void host_sum_round(const int32_t* mles, int64_t m, int64_t mid, const int32_t* mults, int num_products,
                    const int32_t* lengths, const int32_t* terms, const int32_t* interp, int64_t nblocks,
                    int64_t threads, int32_t* out) {
  mle_ptrs t = {mles, m * 2 * mid, 2 * mid};
  product_ptrs p = {mults, lengths, terms, num_products};
  std::vector<mfe<F>> colsums(num_products * (D + 1));
  int first = 0;
  for (int q = 0; q < num_products; first += lengths[q], ++q) {
    const int col = q * (D + 1);
    switch (lengths[q]) {
      case 1: host_sum_product<F, 1>(t, mid, terms + first, nblocks, threads, colsums, col); break;
      case 2: host_sum_product<F, 2>(t, mid, terms + first, nblocks, threads, colsums, col); break;
      case 3: host_sum_product<F, 3>(t, mid, terms + first, nblocks, threads, colsums, col); break;
      case 4: host_sum_product<F, 4>(t, mid, terms + first, nblocks, threads, colsums, col); break;
      default: host_sum_product<F, 5>(t, mid, terms + first, nblocks, threads, colsums, col); break;
    }
  }
  mfe<F> values[D + 1];
  for (int k = 0; k <= D; ++k) values[k] = round_point<F, D>(p, colsums.data(), k);
  for (int j = 0; j <= D; ++j) {
    mfe<F> c = mf_zero<F>();
    for (int k = 0; k <= D; ++k) c = mf_add<F>(c, interp_term<F, D>(interp, values, j, k));
    mf_store<F>(out + j, D + 1, c);
  }
}

template <class F>
int host_sum_round_degree(int degree, const int32_t* mles, int64_t m, int64_t mid, const int32_t* mults,
                          int num_products, const int32_t* lengths, const int32_t* terms, const int32_t* interp,
                          int64_t nblocks, int64_t threads, int32_t* out) {
  for (int q = 0; q < num_products; ++q) {
    if (lengths[q] < 1 || lengths[q] > degree) return -1;
  }
  if (nblocks < 1 || threads < 1) return -1;
#define BTT_SUM_ROUND(D) \
  host_sum_round<F, D>(mles, m, mid, mults, num_products, lengths, terms, interp, nblocks, threads, out)
  switch (degree) {
    case 1: BTT_SUM_ROUND(1); return 0;
    case 2: BTT_SUM_ROUND(2); return 0;
    case 3: BTT_SUM_ROUND(3); return 0;
    case 4: BTT_SUM_ROUND(4); return 0;
    case 5: BTT_SUM_ROUND(5); return 0;
    default: return -1;
  }
#undef BTT_SUM_ROUND
}

// the fold of mont_fold_round.cu: out (16, m, mid) from mles (16, m, 2 mid)
template <class F>
void host_fold_round(const int32_t* mles, int64_t m, int64_t mid, const int32_t* r, int32_t* out) {
  mle_ptrs t = {mles, m * 2 * mid, 2 * mid};
  const mfe<F> rr = mf_load<F>(r, 1);
  for (int64_t tt = 0; tt < m; ++tt) {
    for (int64_t i = 0; i < mid; ++i) {
      mfe<F> v = fold_lane<F>(mle_load<F>(t, (int)tt, i), mle_load<F>(t, (int)tt, mid + i), rr);
      mf_store<F>(out + tt * mid + i, m * mid, v);
    }
  }
}

// op: 0 complete add, 1 complete double on C
template <class C>
void host_w(int op, const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  const int64_t nl = 2 * C::F::K;
  wpoint_ptrs pp = {{p, p + nl * n, p + 2 * nl * n}, n};
  wpoint_ptrs qq = {{q, q + nl * n, q + 2 * nl * n}, n};
  wpoint_out_ptrs oo = {{out, out + nl * n, out + 2 * nl * n}, n};
  for (int64_t i = 0; i < n; ++i) {
    wpoint<C> a = w_load<C>(pp, i);
    w_store<C>(oo, i, op == 0 ? w_add<C>(a, w_load<C>(qq, i)) : w_double<C>(a));
  }
}

// which: 0 mul_b3 (additions), 1 mf_mul by 3b in Montgomery form, over the
// base field of C: a (nlimbs, n) -> out (nlimbs, n)
template <class C>
void host_mul_b3(int which, const int32_t* a, int32_t* out, int64_t n) {
  using F = typename C::F;
  for (int64_t i = 0; i < n; ++i) {
    const mfe<F> x = mf_load<F>(a + i, n);
    mf_store<F>(out + i, n, which == 0 ? C::mul_b3(x) : mf_mul<F>(x, C::b3()));
  }
}

// w_lookup_msm.cu's threads, one after another
template <class C>
void host_w_lookup(const lookup_query& q, int64_t rows, int64_t nchunks, const wpoint_out_ptrs& out) {
  for (int64_t k = 0; k < nchunks; ++k) {
    for (int64_t r = 0; r < rows; ++r) w_store<C>(out, k * rows + r, lookup_thread<WForm<C>>(q, k, r));
  }
}

// ladder.cuh's ladder_kernel (doubling_combine.cu, w_doubling_combine.cu;
// ed_horner.cu, w_horner.cu with step_bits = 8): each output's lanes one
// after another, then lane 0's fold
template <class G>
void host_ladder(const typename G::In& products, int64_t num_outputs, int nbits, int seg_bits,
                 const typename G::Out& out, int step_bits) {
  const int nseg = ladder_segments(nbits, seg_bits);
  std::vector<typename G::P> seg(nseg);
  for (int64_t o = 0; o < num_outputs; ++o) {
    for (int j = 0; j < nseg; ++j) seg[j] = ladder_segment<G>(products, o * nbits, nbits, seg_bits, j, step_bits);
    G::store(out, o, ladder_fold<G>(seg.data(), nseg, seg_bits, step_bits));
  }
}

int host_ladder_steps(int curve, const int32_t* products, int64_t num_outputs, int nbits, int seg_bits,
                      int step_bits, int32_t* out) {
  if (!ladder_args_ok(nbits, seg_bits) || step_bits < 1) return -1;
  const int64_t m = num_outputs * nbits;
  if (curve == 0) {
    host_ladder<EdLadder>(in_points(products, m), num_outputs, nbits, seg_bits, out_points(out, num_outputs),
                          step_bits);
    return 0;
  }
  auto run = [&](auto curve_tag, int64_t nl) {
    using C = decltype(curve_tag);
    const wpoint_ptrs pp = {{products, products + nl * m, products + 2 * nl * m}, m};
    const wpoint_out_ptrs oo = {{out, out + nl * num_outputs, out + 2 * nl * num_outputs}, num_outputs};
    host_ladder<WLadder<C>>(pp, num_outputs, nbits, seg_bits, oo, step_bits);
  };
  switch (curve) {
    case Bls12381G1::id: run(Bls12381G1(), 24); return 0;
    case Bn254G1::id: run(Bn254G1(), 16); return 0;
    case Grumpkin::id: run(Grumpkin(), 16); return 0;
    default: return -1;
  }
}

ge_cached load_cached(const int32_t* base, int64_t n, int64_t i) {
  ge_cached r;
  r.a = fe_load(base + i, n);
  r.b = fe_load(base + 16 * n + i, n);
  r.z = fe_load(base + 32 * n + i, n);
  r.t = fe_load(base + 48 * n + i, n);
  return r;
}

// tree_reduce_lanes.cu's order for each column in turn: the T threads'
// strided serial sums, each block's halving levels, then the halving of the
// blocks' sums; a sum at or past the column's end (the identity) is never
// added.
template <class G>
void host_tree(const typename G::In& in, int64_t size, int64_t cols, const typename G::Out& out) {
  const tree_shape sh = tree_shape_of(size, cols);
  std::vector<typename G::P> sums(sh.T);
  for (int64_t c = 0; c < cols; ++c) {
    for (int64_t t = 0; t < sh.T; ++t) sums[t] = tree_thread_sum<G>(in, size, cols, c, t, sh.T);
    for (int64_t b = 0; b < sh.T; b += sh.slots) {
      for (int64_t h = sh.slots >> 1; h > 0; h >>= 1) {
        for (int64_t t = b; t < b + h && t + h < size; ++t) sums[t] = G::add(sums[t], sums[t + h]);
      }
    }
    for (int64_t h = sh.splits >> 1; h > 0; h >>= 1) {
      for (int64_t m = 0; m < h && sh.slots * (m + h) < size; ++m) {
        sums[sh.slots * m] = G::add(sums[sh.slots * m], sums[sh.slots * (m + h)]);
      }
    }
    G::store(out, c, sums[0]);
  }
}

// ed_lookup_msm.cu's threads, one after another
template <class Form>
void host_lookup(const lookup_query& q, int64_t rows, int64_t nchunks, const point_out_ptrs& out) {
  for (int64_t k = 0; k < nchunks; ++k) {
    for (int64_t r = 0; r < rows; ++r) ge_store(out, k * rows + r, lookup_thread<Form>(q, k, r));
  }
}

// lane_build_kernel (build_cached_table.cu, w_build_table.cu): one group
// and one lane after another.
template <class Form>
void host_lane_groups(const typename Form::In& pts, int w, int64_t groups, word4* table) {
  const run_shape s = lane_shape_of(w);
  std::vector<typename Form::Point> gens(w);
  for (int64_t g = 0; g < groups; ++g) {
    for (int j = 0; j < w; ++j) gens[j] = Form::point(pts, g * w + j);
    for (int64_t t = 0; t < (int64_t(1) << s.L); ++t) {
      lane_entries<Form>(gens.data(), s.L, s.H, lane_rows<Form>{table + (g << w) * Form::kChunks, s.L, (int)t});
    }
  }
}

// The runs of build_niels_table.cu, one lane after another: the lanes park
// their rows, a loop scans the lanes' Z products where the kernel shuffles,
// one inversion a run, then each lane walks its rows back.
void host_niels_runs(const point_ptrs& pts, int w, int64_t runs, word4* table) {
  const run_shape s = run_shape_of(w);
  const int width = 1 << s.L, wide = w - s.bits;
  std::vector<ge_cached> gens(s.bits);
  std::vector<fe> c(width), E(width), S(width);
  for (int64_t r = 0; r < runs; ++r) {
    const int64_t g = r >> wide;
    for (int j = 0; j < s.bits; ++j) gens[j] = ge_to_cached(ge_load(pts, g * w + j));
    group_point point{pts, g * w};
    const ge_p3 start = run_start(point, w, r & ((1 << wide) - 1));
    for (int t = 0; t < width; ++t) {
      c[t] = niels_lane_park(gens.data(), s.L, s.H, start, niels_rows{table + (r << s.bits) * 6, s.L, t});
    }
    E[0] = fe_one();
    for (int t = 1; t < width; ++t) E[t] = fe_mul(E[t - 1], c[t - 1]);
    S[width - 1] = fe_one();
    for (int t = width - 2; t >= 0; --t) S[t] = fe_mul(S[t + 1], c[t + 1]);
    const fe inv_total = fe_invert(fe_mul(E[width - 1], c[width - 1]));
    for (int t = 0; t < width; ++t) {
      niels_lane_store(s.H, fe_mul(fe_mul(inv_total, S[t]), E[t]), niels_rows{table + (r << s.bits) * 6, s.L, t});
    }
  }
}

// window_sums.cu's warp on the host: each row's 32 lanes one after
// another at every step, each step reading the lanes' values from before it
// (as the shuffles do); only lane 0's halving sums are kept (the kernel's
// other lanes add sums no lane reads).
template <class G>
void host_window_sums(const typename G::In& buckets, int64_t rows, const typename G::Out& out) {
  using P = typename G::P;
  for (int64_t row = 0; row < rows; ++row) {
    P s[kWindowLanes], u[kWindowLanes], next[kWindowLanes];
    for (int t = 0; t < kWindowLanes; ++t) window_lane_run<G>(buckets, row, t, s[t], u[t]);
    for (int d = 1; d < kWindowLanes; d <<= 1) {
      for (int t = 0; t < kWindowLanes; ++t) next[t] = window_scan_step<G>(s[t], s[(t + d) % kWindowLanes], t, d);
      for (int t = 0; t < kWindowLanes; ++t) s[t] = next[t];
    }
    P v[kWindowLanes];
    for (int t = 0; t < kWindowLanes; ++t) v[t] = window_lane_share<G>(s[t], u[t]);
    for (int d = kWindowLanes / 2; d > 0; d >>= 1) {
      for (int t = 0; t < d; ++t) v[t] = ladder_add<G>(v[t], v[t + d]);
    }
    G::store(out, row, v[0]);
  }
}

}  // namespace

extern "C" {

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin (its base field for
// btt_host_mont); returns -1 for another id
int btt_host_mont(int curve, int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  switch (curve) {
    case Bls12381G1::id: host_mont<Bls12381G1>(op, a, b, out, n); return 0;
    case Bn254G1::id: host_mont<Bn254G1>(op, a, b, out, n); return 0;
    case Grumpkin::id: host_mont<Grumpkin>(op, a, b, out, n); return 0;
    default: return -1;
  }
}

// field: 0 the curve25519 scalar field, 1 the Grumpkin base field (their
// SXT_FIELD_* ids); ops as btt_host_mont; returns -1 for another id
int btt_host_field_mont(int field, int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  switch (field) {
    case kFieldScalar255: host_mont_field<Scalar25519>(op, a, b, out, n); return 0;
    case kFieldGrumpkin: host_mont_field<Bn254Fr>(op, a, b, out, n); return 0;
    default: return -1;
  }
}

// rows (num_mles * n, nbytes) bytes, scale 16 limbs (R^2 or R mod m), out
// (16, num_mles, n_pad); returns -1 for another field or a shape the
// launcher rejects
int btt_host_mont_from_rows(int field, const uint8_t* rows, int64_t num_mles, int64_t n, int nbytes, int64_t n_pad,
                            const int32_t* scale, int32_t* out) {
  if (nbytes < 1 || nbytes > kRowsMaxBytes || n < 0 || n_pad < n || num_mles < 0) return -1;
  switch (field) {
    case kFieldScalar255: host_mont_from_rows<Scalar25519>(rows, num_mles, n, nbytes, n_pad, scale, out); return 0;
    case kFieldGrumpkin: host_mont_from_rows<Bn254Fr>(rows, num_mles, n, nbytes, n_pad, scale, out); return 0;
    default: return -1;
  }
}

// mles (16, m, 2 mid); interp (16, (degree + 1)^2), cuda_mont.interpolation;
// nblocks x threads the simulated grid; returns -1 for another field, a
// product length outside 1..degree or an empty grid
int btt_host_sum_round(int field, int degree, const int32_t* mles, int64_t m, int64_t mid, const int32_t* mults,
                       int num_products, const int32_t* lengths, const int32_t* terms, const int32_t* interp,
                       int64_t nblocks, int64_t threads, int32_t* out) {
  switch (field) {
    case kFieldScalar255:
      return host_sum_round_degree<Scalar25519>(degree, mles, m, mid, mults, num_products, lengths, terms, interp,
                                                nblocks, threads, out);
    case kFieldGrumpkin:
      return host_sum_round_degree<Bn254Fr>(degree, mles, m, mid, mults, num_products, lengths, terms, interp,
                                            nblocks, threads, out);
    default: return -1;
  }
}

int btt_host_fold_round(int field, const int32_t* mles, int64_t m, int64_t mid, const int32_t* r, int32_t* out) {
  switch (field) {
    case kFieldScalar255: host_fold_round<Scalar25519>(mles, m, mid, r, out); return 0;
    case kFieldGrumpkin: host_fold_round<Bn254Fr>(mles, m, mid, r, out); return 0;
    default: return -1;
  }
}

int btt_host_w(int curve, int op, const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  switch (curve) {
    case Bls12381G1::id: host_w<Bls12381G1>(op, p, q, out, n); return 0;
    case Bn254G1::id: host_w<Bn254G1>(op, p, q, out, n); return 0;
    case Grumpkin::id: host_w<Grumpkin>(op, p, q, out, n); return 0;
    default: return -1;
  }
}

int btt_host_mul_b3(int curve, int which, const int32_t* a, int32_t* out, int64_t n) {
  switch (curve) {
    case Bls12381G1::id: host_mul_b3<Bls12381G1>(which, a, out, n); return 0;
    case Bn254G1::id: host_mul_b3<Bn254G1>(which, a, out, n); return 0;
    case Grumpkin::id: host_mul_b3<Grumpkin>(which, a, out, n); return 0;
    default: return -1;
  }
}

// w_lookup_msm.cu's launcher on the host: the same arguments (the table
// (groups, 2^w, 3, K) words; signs null for an unsigned query); out (3,
// nlimbs, nchunks * rows) with rows = halves * num_outputs * 8 * nbytes.
// Returns -1 for another curve id.
int btt_host_w_lookup(int curve, const int32_t* table, const uint8_t* scalars, const uint8_t* signs,
                      int64_t num_outputs, int64_t n_pad, int64_t row_stride, int nbytes, int w,
                      int64_t chunk_groups, int64_t nchunks, int32_t* out) {
  lookup_query q;
  q.table = reinterpret_cast<const word4*>(table);
  q.scalars = scalars;
  q.signs = signs;
  q.row_stride = row_stride;
  q.nbytes = nbytes;
  q.w = w;
  q.groups = n_pad / w;
  q.halves = signs ? 2 : 1;
  q.rows_per_half = num_outputs * 8 * nbytes;
  q.chunk_groups = chunk_groups;
  const int64_t rows = q.rows_per_half * q.halves;
  const int64_t m = nchunks * rows;
  auto run = [&](auto curve_tag, int64_t nl) {
    using C = decltype(curve_tag);
    const wpoint_out_ptrs oo = {{out, out + nl * m, out + 2 * nl * m}, m};
    host_w_lookup<C>(q, rows, nchunks, oo);
  };
  switch (curve) {
    case Bls12381G1::id: run(Bls12381G1(), 24); return 0;
    case Bn254G1::id: run(Bn254G1(), 16); return 0;
    case Grumpkin::id: run(Grumpkin(), 16); return 0;
    default: return -1;
  }
}

// doubling_combine.cu and w_doubling_combine.cu on the host: curve 0
// ristretto255, products (4, 16, O * nbits), out (4, 16, O); 1-3 as
// btt_host_w, products (3, nlimbs, O * nbits), out (3, nlimbs, O). Returns
// -1 for another curve id or arguments the launchers reject.
int btt_host_ladder(int curve, const int32_t* products, int64_t num_outputs, int nbits, int seg_bits,
                    int32_t* out) {
  return host_ladder_steps(curve, products, num_outputs, nbits, seg_bits, 1, out);
}

// ed_horner.cu and w_horner.cu on the host: the ladder over (O, W) window
// sums with step_bits doublings a step (8 on the card); curves and layouts
// as btt_host_ladder's, nbits = W.
int btt_host_horner(int curve, const int32_t* windows, int64_t num_outputs, int num_windows, int seg_bits,
                    int step_bits, int32_t* out) {
  return host_ladder_steps(curve, windows, num_outputs, num_windows, seg_bits, step_bits, out);
}

// op: 0 mul, 1 sq, 2 invert, 3 add, 4 sub, 5 pow22523
void btt_host_field(int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    fe x = fe_load(a + i, n);
    fe y = fe_load(b + i, n);
    fe r;
    switch (op) {
      case 0: r = fe_mul(x, y); break;
      case 1: r = fe_sq(x); break;
      case 2: r = fe_invert(x); break;
      case 3: r = fe_add(x, y); break;
      case 4: r = fe_sub(x, y); break;
      default: r = fe_pow22523(x); break;
    }
    fe_store(out + i, n, r);
  }
}

void btt_host_ed_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  point_ptrs pp = in_points(p, n), qq = in_points(q, n);
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) ge_store(oo, i, ge_add(ge_load(pp, i), ge_load(qq, i)));
}

// ed_add.cu's quads: each pair's four lanes' stage 1 in turn, their
// products exchanged through an array, then each lane's stages 2 and 3;
// p, q, out (4, 16, n)
void btt_host_ed_add_quad(const int32_t* p, const int32_t* q, int negate_q, int32_t* out, int64_t n) {
  point_ptrs pp = in_points(p, n), qq = in_points(q, n);
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) {
    fe s[kQuadLanes];
    for (int j = 0; j < kQuadLanes; ++j) s[j] = ed_add_quad_first(j, pp, qq, i, negate_q != 0, fe_mul_op());
    for (int j = 0; j < kQuadLanes; ++j) fe_store(quad_coord(oo, j) + i, n, quad_last(j, s, fe_mul_op()));
  }
}

void btt_host_ed_double(const int32_t* p, int32_t* out, int64_t n) {
  point_ptrs pp = in_points(p, n);
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) ge_store(oo, i, ge_double(ge_load(pp, i)));
}

void btt_host_ed_madd(const int32_t* p, const int32_t* niels, int32_t* out, int64_t n) {
  point_ptrs pp = in_points(p, n);
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) ge_store(oo, i, ge_madd(ge_load(pp, i), load_niels(niels, n, i)));
}

// p, q: (3, 16, n) niels batches; out: (4, 16, n) extended points
void btt_host_niels_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) ge_store(oo, i, ge_niels_add(load_niels(p, n, i), load_niels(q, n, i)));
}

// niels_add.cu's quads, as btt_host_ed_add_quad; p, q (3, 16, n), out (4,
// 16, n)
void btt_host_niels_add_quad(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  niels_ptrs pp = {{p, p + 16 * n, p + 32 * n}, n}, qq = {{q, q + 16 * n, q + 32 * n}, n};
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) {
    fe s[kQuadLanes];
    for (int j = 0; j < kQuadLanes; ++j) s[j] = niels_add_quad_first(j, pp, qq, i, fe_mul_op());
    for (int j = 0; j < kQuadLanes; ++j) fe_store(quad_coord(oo, j) + i, n, quad_last(j, s, fe_mul_op()));
  }
}

// fewrow_niels.cu's launcher on the host, its warps one column after
// another: the table (groups, 2^w, 3, 8) words, scalars (num_outputs,
// n_pad, nbytes) at row stride n_pad, signs (num_outputs, n_pad) or null;
// out (4, 16, cols), cols = groups / chunk_groups * rows, column
// k * rows + r. Returns -1 for a shape no launch takes.
int btt_host_fewrow_niels(const int32_t* table, const uint8_t* scalars, const uint8_t* signs, int64_t num_outputs,
                          int64_t n_pad, int nbytes, int w, int64_t chunk_groups, int32_t* out) {
  const int64_t groups = n_pad / w;
  if (!niels_tree_size_ok(chunk_groups) || n_pad % w || groups % chunk_groups) return -1;
  lookup_query q;
  q.table = reinterpret_cast<const word4*>(table);
  q.scalars = scalars;
  q.signs = signs;
  q.row_stride = n_pad;
  q.nbytes = nbytes;
  q.w = w;
  q.groups = groups;
  q.halves = signs ? 2 : 1;
  q.rows_per_half = num_outputs * 8 * nbytes;
  q.chunk_groups = chunk_groups;
  const int64_t rows = q.rows_per_half * q.halves, cols = groups / chunk_groups * rows;
  const point_out_ptrs oo = out_points(out, cols);
  HostStack stack;
  ge_p3 sums[kFewrowLanes];
  for (int64_t c = 0; c < cols; ++c) {
    const lookup_row row = lookup_row_of(q, c % rows);
    for (int t = 0; t < kFewrowLanes; ++t) sums[t] = fewrow_lane_sum(q, row, c / rows, t, stack);
    for (int h = kFewrowLanes / 2; h > 0; h >>= 1) {
      for (int t = 0; t < h; ++t) sums[t] = ge_add(sums[t], sums[t + h]);
    }
    ge_store(oo, c, sums[0]);
  }
  return 0;
}

// finvert.cu on the host: a (16, count) at limb stride count -> out (16,
// count), the kernel's tiles of 32 x per elements one lane after another.
int btt_host_finvert(const int32_t* a, int64_t count, int per, int32_t* out) {
  if (per < 1) return -1;
  for (int64_t tile = 0; tile < count; tile += 32LL * per) {
    for (int lane = 0; lane < 32; ++lane) {
      const int64_t left = count - tile - lane;
      const int n = left <= 0 ? 0 : (int)(left < 32LL * per ? (left + 31) / 32 : per);
      invert_elements<fe_mul_op>(a, count, out, count, tile + lane, 32, n);
    }
  }
  return 0;
}

void btt_host_to_niels(const int32_t* p, int32_t* niels, int64_t n) {
  point_ptrs pp = in_points(p, n);
  for (int64_t i = 0; i < n; ++i) {
    ge_niels r = ge_to_niels(ge_load(pp, i));
    fe_store(niels + i, n, r.a);
    fe_store(niels + 16 * n + i, n, r.b);
    fe_store(niels + 32 * n + i, n, r.t);
  }
}

void btt_host_to_cached(const int32_t* p, int32_t* cached, int64_t n) {
  point_ptrs pp = in_points(p, n);
  for (int64_t i = 0; i < n; ++i) {
    ge_cached r = ge_to_cached(ge_load(pp, i));
    fe_store(cached + i, n, r.a);
    fe_store(cached + 16 * n + i, n, r.b);
    fe_store(cached + 32 * n + i, n, r.z);
    fe_store(cached + 48 * n + i, n, r.t);
  }
}

void btt_host_ed_cadd(const int32_t* p, const int32_t* cached, int32_t* out, int64_t n) {
  point_ptrs pp = in_points(p, n);
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) ge_store(oo, i, ge_cadd(ge_load(pp, i), load_cached(cached, n, i)));
}

// curve: the reference C ABI id (0 ristretto255, 1-3 as btt_host_w); in:
// (coords, nlimbs, size * cols) with element (s, c) at s * cols + c; out:
// (coords, nlimbs, cols). Returns -1 for another id.
int btt_host_tree_reduce(int curve, const int32_t* in, int64_t size, int64_t cols, int32_t* out) {
  const int64_t m = size * cols;
  if (curve == 0) {
    host_tree<EdGroup>(in_points(in, m), size, cols, out_points(out, cols));
    return 0;
  }
  auto run = [&](auto group, int64_t nl) {
    using G = decltype(group);
    wpoint_ptrs pp = {{in, in + nl * m, in + 2 * nl * m}, m};
    wpoint_out_ptrs oo = {{out, out + nl * cols, out + 2 * nl * cols}, cols};
    host_tree<G>(pp, size, cols, oo);
  };
  switch (curve) {
    case Bls12381G1::id: run(WGroup<Bls12381G1>(), 24); return 0;
    case Bn254G1::id: run(WGroup<Bn254G1>(), 16); return 0;
    case Grumpkin::id: run(WGroup<Grumpkin>(), 16); return 0;
    default: return -1;
  }
}

// ed_lookup_msm.cu's launcher on the host: the same arguments (the table
// (groups, 2^w, 3 or 4, 8) words; signs null for an unsigned query); out
// (4, 16, nchunks * rows) with rows = halves * num_outputs * 8 * nbytes.
void btt_host_lookup(const int32_t* table, const uint8_t* scalars, const uint8_t* signs, int64_t num_outputs,
                     int64_t n_pad, int64_t row_stride, int nbytes, int w, int cached, int64_t chunk_groups,
                     int64_t nchunks, int32_t* out) {
  lookup_query q;
  q.table = reinterpret_cast<const word4*>(table);
  q.scalars = scalars;
  q.signs = signs;
  q.row_stride = row_stride;
  q.nbytes = nbytes;
  q.w = w;
  q.groups = n_pad / w;
  q.halves = signs ? 2 : 1;
  q.rows_per_half = num_outputs * 8 * nbytes;
  q.chunk_groups = chunk_groups;
  const int64_t rows = q.rows_per_half * q.halves;
  const point_out_ptrs oo = out_points(out, nchunks * rows);
  if (cached) {
    host_lookup<CachedForm>(q, rows, nchunks, oo);
  } else {
    host_lookup<NielsForm>(q, rows, nchunks, oo);
  }
}

// points (4, 16, n) -> table (n / w, 2^w, 4, 8) words of
// build_cached_table.cu; returns -1 for a window it does not take.
int btt_host_build_cached_table(const int32_t* points, int64_t n, int w, int32_t* table) {
  if (w < 1 || w > 8 || n % w) return -1;
  host_lane_groups<CachedBuild>(in_points(points, n), w, n / w, reinterpret_cast<word4*>(table));
  return 0;
}

// points (3, nlimbs, n) -> table (n / w, 2^w, 3, K) words of
// w_build_table.cu; returns -1 for another curve id or a window it does not
// take.
int btt_host_w_build_table(int curve, const int32_t* points, int64_t n, int w, int32_t* table) {
  if (w < 1 || w > kMaxLaneWindow || n % w) return -1;
  word4* t = reinterpret_cast<word4*>(table);
  auto run = [&](auto curve_tag, int64_t nl) {
    using C = decltype(curve_tag);
    const wpoint_ptrs pp = {{points, points + nl * n, points + 2 * nl * n}, n};
    host_lane_groups<WBuild<C>>(pp, w, n / w, t);
  };
  switch (curve) {
    case Bls12381G1::id: run(Bls12381G1(), 24); return 0;
    case Bn254G1::id: run(Bn254G1(), 16); return 0;
    case Grumpkin::id: run(Grumpkin(), 16); return 0;
    default: return -1;
  }
}

// entries (count, 3, K) words of a Weierstrass table chunk -> rows (count,
// 2K) words, w_affine.cu's tiles of 32 x per entries (the kernel's per is
// 32, 64 or 128, by the chunk's size) one lane after another; returns -1
// for another curve.
int btt_host_w_affine(int curve, const int32_t* entries, int64_t count, int per, int32_t* rows) {
  if (per < 1) return -1;
  auto run = [&](auto field_tag) {
    using F = decltype(field_tag);
    const uint32_t* e = reinterpret_cast<const uint32_t*>(entries);
    uint32_t* r = reinterpret_cast<uint32_t*>(rows);
    for (int64_t tile = 0; tile < count; tile += 32LL * per) {
      for (int lane = 0; lane < 32; ++lane) {
        const int64_t left = count - tile - lane;
        const int n = left <= 0 ? 0 : (int)(left < 32LL * per ? (left + 31) / 32 : per);
        affine_entries<F, mf_mul_op<F>>(e, r, tile + lane, 32, n);
      }
    }
  };
  switch (curve) {
    case Bls12381G1::id: run(Bls12381Fp()); return 0;
    case Bn254G1::id: run(Bn254Fp()); return 0;
    case Grumpkin::id: run(Bn254Fr()); return 0;
    default: return -1;
  }
}

// points (4, 16, n) -> table (n / w, 2^w, 3, 8) words of
// build_niels_table.cu; returns -1 for a window it does not take.
int btt_host_build_niels_table(const int32_t* points, int64_t n, int w, int32_t* table) {
  if (w < 1 || w > 16 || n % w) return -1;
  const point_ptrs pts = in_points(points, n);
  host_niels_runs(pts, w, (n / w) << (w - run_shape_of(w).bits), reinterpret_cast<word4*>(table));
  return 0;
}

void btt_host_elligator_form(const int32_t* r0, const int32_t* r1, int32_t* out, int64_t n) {
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) {
    ge_store(oo, i, ge_add(elligator(fe_load(r1 + i, n)), elligator(fe_load(r0 + i, n))));
  }
}

// points (3, 16, count): a chunk's X, Y, Z -> (count, 3, 8) niels words
// of ed_convert.cu's ed_to_niels, its tiles of 32 x per entries (the
// kernel's per is 32, 64 or 128, by the chunk's size) one lane after
// another; returns -1 for per < 1.
int btt_host_ed_to_niels(const int32_t* points, int64_t count, int per, int32_t* out) {
  if (per < 1) return -1;
  const point_ptrs p = {{points, points + 16 * count, points + 32 * count, nullptr}, count};
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  for (int64_t tile = 0; tile < count; tile += 32LL * per) {
    for (int lane = 0; lane < 32; ++lane) {
      const int64_t left = count - tile - lane;
      const int n = left <= 0 ? 0 : (int)(left < 32LL * per ? (left + 31) / 32 : per);
      niels_entries<fe_mul_op>(p, o, tile + lane, 32, n);
    }
  }
  return 0;
}

// (count, 3, 8) niels words -> (count, 15) file rows, ed_convert.cu's
// ed_file_rows.
void btt_host_ed_file_rows(const int32_t* words, int64_t count, int64_t* rows) {
  for (int64_t e = 0; e < count; ++e) {
    niels_file_row(reinterpret_cast<const uint32_t*>(words) + kNielsWords * e,
                   reinterpret_cast<uint64_t*>(rows) + kFileWords * e, fe_mul_op());
  }
}

// (count, 15) file rows -> (count, 3, 8) niels words, ed_file_entries.
void btt_host_ed_file_entries(const int64_t* rows, int64_t count, int32_t* words) {
  for (int64_t e = 0; e < count; ++e) {
    file_row_niels(reinterpret_cast<const uint64_t*>(rows) + kFileWords * e,
                   reinterpret_cast<uint32_t*>(words) + kNielsWords * e, fe_mul_op());
  }
}

// (count, 3, 8) niels words -> (4, 16, count) extended points,
// ed_convert.cu's ed_niels_points.
void btt_host_ed_niels_points(const int32_t* words, int64_t count, int32_t* out) {
  const point_out_ptrs oo = out_points(out, count);
  for (int64_t e = 0; e < count; ++e) {
    niels_point_store(reinterpret_cast<const uint32_t*>(words) + kNielsWords * e, oo, e, fe_mul_op());
  }
}

// points (3, 16, count): X, Y, Z -> (4, 16, count) (x, y, 1, x y),
// ed_convert.cu's ed_affine, its tiles of 32 x per entries (the kernel's
// per is 16, 32 or 64, by the count) one lane after another; returns -1 for
// per < 1.
int btt_host_ed_affine(const int32_t* points, int64_t count, int per, int32_t* out) {
  if (per < 1) return -1;
  const point_ptrs p = {{points, points + 16 * count, points + 32 * count, nullptr}, count};
  const point_out_ptrs oo = out_points(out, count);
  for (int64_t tile = 0; tile < count; tile += 32LL * per) {
    for (int lane = 0; lane < 32; ++lane) {
      const int64_t left = count - tile - lane;
      const int n = left <= 0 ? 0 : (int)(left < 32LL * per ? (left + 31) / 32 : per);
      ed_affine_entries<fe_mul_op>(p, oo, tile + lane, 32, n);
    }
  }
  return 0;
}

// window_sums.cu on the host: curve 0 ristretto255, buckets (4, 16, rows *
// 255), out (4, 16, rows); 1-3 as btt_host_w, buckets (3, nlimbs, rows *
// 255), out (3, nlimbs, rows). Returns -1 for another curve id.
int btt_host_window_sums(int curve, const int32_t* buckets, int64_t rows, int32_t* out) {
  const int64_t m = rows * kWindowBuckets;
  if (curve == 0) {
    host_window_sums<EdLadder>(in_points(buckets, m), rows, out_points(out, rows));
    return 0;
  }
  auto run = [&](auto curve_tag, int64_t nl) {
    using C = decltype(curve_tag);
    const wpoint_ptrs pp = {{buckets, buckets + nl * m, buckets + 2 * nl * m}, m};
    const wpoint_out_ptrs oo = {{out, out + nl * rows, out + 2 * nl * rows}, rows};
    host_window_sums<WLadder<C>>(pp, rows, oo);
  };
  switch (curve) {
    case Bls12381G1::id: run(Bls12381G1(), 24); return 0;
    case Bn254G1::id: run(Bn254G1(), 16); return 0;
    case Grumpkin::id: run(Grumpkin(), 16); return 0;
    default: return -1;
  }
}

// points (4, 16, n) -> (32, n) uint8 encodings, ristretto.cu's
// ristretto_encode (every multiply one call of fe_mul_call, as there).
void btt_host_ristretto_encode(const int32_t* points, int64_t n, uint8_t* out) {
  const point_ptrs p = in_points(points, n);
  for (int64_t i = 0; i < n; ++i) {
    const fe s = ristretto_encode_s(ge_load(p, i), fe_mul_call_op());
    for (int k = 0; k < 32; ++k) out[k * n + i] = (uint8_t)(s.v[k >> 2] >> (8 * (k & 3)));
  }
}

// (32, n) uint8 encodings -> (4, 16, n) points and n valid bytes,
// ristretto.cu's ristretto_decode.
void btt_host_ristretto_decode(const uint8_t* data, int64_t n, int32_t* out, uint8_t* valid) {
  const point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) {
    fe bytes;
    for (int w = 0; w < 8; ++w) {
      bytes.v[w] = 0;
      for (int j = 0; j < 4; ++j) bytes.v[w] |= (uint32_t)data[(4 * w + j) * n + i] << (8 * j);
    }
    ge_p3 q;
    valid[i] = ristretto_decode_s(bytes, q, fe_mul_call_op());
    ge_store(oo, i, q);
  }
}

}  // extern "C"
