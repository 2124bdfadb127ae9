// Host build of the kernels' arithmetic, for the CPU tests.
//
// fp25519.cuh and edwards25519.cuh are compiled here by a host C++ compiler
// (BTT_HD is plain inline then), so tests/test_torch_native_arith.py can
// hold the very code the CUDA kernels run against blitzar_tpu without a
// card. Each function loops over n elements in the public layout: a field
// batch is a (16, n) int32 array, a point batch (4, 16, n), a niels batch
// (3, 16, n).
#include "edwards25519.cuh"

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

}  // namespace

extern "C" {

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

void btt_host_to_niels(const int32_t* p, int32_t* niels, int64_t n) {
  point_ptrs pp = in_points(p, n);
  for (int64_t i = 0; i < n; ++i) {
    ge_niels r = ge_to_niels(ge_load(pp, i));
    fe_store(niels + i, n, r.a);
    fe_store(niels + 16 * n + i, n, r.b);
    fe_store(niels + 32 * n + i, n, r.t);
  }
}

void btt_host_elligator_form(const int32_t* r0, const int32_t* r1, int32_t* out, int64_t n) {
  point_out_ptrs oo = out_points(out, n);
  for (int64_t i = 0; i < n; ++i) {
    ge_store(oo, i, ge_add(elligator(fe_load(r1 + i, n)), elligator(fe_load(r0 + i, n))));
  }
}

}  // extern "C"
