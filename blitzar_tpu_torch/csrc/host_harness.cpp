// Host build of the kernels' arithmetic, for the CPU tests.
//
// fp25519.cuh, edwards25519.cuh, niels_tree.cuh, mont.cuh, weierstrass.cuh,
// sumcheck.cuh and tree_reduce.cuh are compiled here by a host C++ compiler (BTT_HD is plain inline then), so
// tests/test_torch_native_arith.py can hold the very code the CUDA kernels
// run against blitzar_tpu and the plain versions without a card. Each
// function loops over n elements in the public layout: a field batch is a
// (nlimbs, n) int32 array, an Edwards point batch (4, 16, n), a niels batch
// (3, 16, n), a cached batch (4, 16, n), a Weierstrass point batch (3,
// nlimbs, n), a sumcheck MLE table (16, m, 2 mid).
#include "edwards25519.cuh"
#include "niels_tree.cuh"
#include "sumcheck.cuh"
#include "tree_reduce.cuh"
#include "weierstrass.cuh"

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

// The sumcheck round of mont_sum_round.cu with one lane after another: the
// lanes' shares summed in order into out (16, D + 1).
template <class F, int D>
void host_sum_round(const int32_t* mles, int64_t m, int64_t mid, const int32_t* mults, int num_products,
                    const int32_t* lengths, const int32_t* terms, int32_t* out) {
  mle_ptrs t = {mles, m * 2 * mid, 2 * mid};
  product_ptrs p = {mults, lengths, terms, num_products};
  mfe<F> acc[D + 1];
  for (int k = 0; k <= D; ++k) acc[k] = mf_zero<F>();
  for (int64_t i = 0; i < mid; ++i) sum_lane<F, D>(t, mid, i, p, acc);
  for (int k = 0; k <= D; ++k) mf_store<F>(out + k, D + 1, acc[k]);
}

template <class F>
int host_sum_round_degree(int degree, const int32_t* mles, int64_t m, int64_t mid, const int32_t* mults,
                          int num_products, const int32_t* lengths, const int32_t* terms, int32_t* out) {
  switch (degree) {
    case 1: host_sum_round<F, 1>(mles, m, mid, mults, num_products, lengths, terms, out); return 0;
    case 2: host_sum_round<F, 2>(mles, m, mid, mults, num_products, lengths, terms, out); return 0;
    case 3: host_sum_round<F, 3>(mles, m, mid, mults, num_products, lengths, terms, out); return 0;
    case 4: host_sum_round<F, 4>(mles, m, mid, mults, num_products, lengths, terms, out); return 0;
    case 5: host_sum_round<F, 5>(mles, m, mid, mults, num_products, lengths, terms, out); return 0;
    default: return -1;
  }
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

ge_cached load_cached(const int32_t* base, int64_t n, int64_t i) {
  ge_cached r;
  r.a = fe_load(base + i, n);
  r.b = fe_load(base + 16 * n + i, n);
  r.z = fe_load(base + 32 * n + i, n);
  r.t = fe_load(base + 48 * n + i, n);
  return r;
}

// The block of tree_reduce_lanes.cu for each column in turn: the threads'
// serial sums, then the same halving levels in shared memory.
template <class G>
void host_tree(const typename G::In& in, int64_t size, int64_t cols, const typename G::Out& out) {
  const int T = tree_threads(size);
  typename G::P sums[128];
  for (int64_t c = 0; c < cols; ++c) {
    for (int t = 0; t < T; ++t) sums[t] = tree_thread_sum<G>(in, size, cols, c, t, T);
    for (int h = T >> 1; h > 0; h >>= 1) {
      for (int t = 0; t < h; ++t) sums[t] = G::add(sums[t], sums[t + h]);
    }
    G::store(out, c, sums[0]);
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

int btt_host_sum_round(int field, int degree, const int32_t* mles, int64_t m, int64_t mid, const int32_t* mults,
                       int num_products, const int32_t* lengths, const int32_t* terms, int32_t* out) {
  switch (field) {
    case kFieldScalar255:
      return host_sum_round_degree<Scalar25519>(degree, mles, m, mid, mults, num_products, lengths, terms, out);
    case kFieldGrumpkin:
      return host_sum_round_degree<Bn254Fr>(degree, mles, m, mid, mults, num_products, lengths, terms, out);
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

// The blocks of niels_tree_reduce_lanes.cu, one column after another:
// entries (size, cols, 24) words, out (4, 16, cols). Returns -1 for a size
// no block takes.
int btt_host_niels_tree(const int32_t* entries, int64_t size, int64_t cols, int32_t* out) {
  const uint32_t* e = (const uint32_t*)entries;
  point_out_ptrs oo = out_points(out, cols);
  const int leaves = niels_tree_leaves(size);
  if (leaves == 0) return -1;
  ge_p3 sums[kNielsTreeLanes];
  for (int64_t c = 0; c < cols; ++c) {
    for (int t = 0; t < kNielsTreeLanes; ++t) {
      switch (leaves) {
        case 1: sums[t] = niels_lane_sum<1>(e, cols, c, t); break;
        case 2: sums[t] = niels_lane_sum<2>(e, cols, c, t); break;
        case 4: sums[t] = niels_lane_sum<4>(e, cols, c, t); break;
        default: sums[t] = niels_lane_sum<8>(e, cols, c, t); break;
      }
    }
    for (int h = kNielsTreeLanes >> 1; h > 0; h >>= 1) {
      for (int t = 0; t < h; ++t) sums[t] = ge_add(sums[t], sums[t + h]);
    }
    ge_store(oo, c, sums[0]);
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

void btt_host_elligator_form(const int32_t* r0, const int32_t* r1, int32_t* out, int64_t n) {
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) {
    ge_store(oo, i, ge_add(elligator(fe_load(r1 + i, n)), elligator(fe_load(r0 + i, n))));
  }
}

}  // extern "C"
