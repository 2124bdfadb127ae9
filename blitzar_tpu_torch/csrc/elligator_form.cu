// elligator_form: canonical generator i = elligator(r1[i]) + elligator(r0[i]).
//
// Replaces blitzar_tpu/ops/pallas_point.py:_elligator_form_tiled (:212) /
// elligator_form (:228). (r0, r1) are the two field elements that
// xorshift128+ draws for row index i (blitzar_tpu/generators.py:178-203,
// run on the host), given as (16, n) limbs.
//
// Design: one thread per generator; both elligator maps and the add stay in
// registers. Bound: integer multiplies, dominated by the two pow22523
// chains (~2 x 265 field multiplies per generator).
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

__global__ void __launch_bounds__(128)
elligator_form_kernel(const int32_t* r0, int64_t s0, const int32_t* r1, int64_t s1,
                      int64_t count, point_out_ptrs out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  fe t0 = fe_load(r0 + i, s0);
  fe t1 = fe_load(r1 + i, s1);
  ge_store(out, i, ge_add(elligator(t1), elligator(t0)));
}

extern "C" int btt_elligator_form(const void* r0, int64_t s0, const void* r1, int64_t s1,
                                  int64_t count, void* ox, void* oy, void* oz, void* ot,
                                  void* stream) {
  point_out_ptrs out;
  out.c[0] = (int32_t*)ox;
  out.c[1] = (int32_t*)oy;
  out.c[2] = (int32_t*)oz;
  out.c[3] = (int32_t*)ot;
  out.limb_stride = count;
  if (count > 0) {
    const int threads = 128;
    int64_t blocks = (count + threads - 1) / threads;
    elligator_form_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)r0, s0, (const int32_t*)r1, s1, count, out);
  }
  return (int)cudaGetLastError();
}
