// niels_add: elementwise sum of two batches of affine niels entries, out[i] =
// p[i] + q[i] in extended coordinates.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_niels_add_tiled (:79) /
// niels_add (:95), body _niels_add_kernel_body (:68): the unified law with
// z1 = z2 = 1 (7 multiplies and one by 1/(2d); ge_niels_add in
// edwards25519.cuh). It is the first level of the few-row partition query's
// reduce where a table chunk's group count is even but no power of two above
// 128 (msm/fixed.py: the two halves of each row's selected entries).
//
// Design: one thread per element, as ed_add.cu, inputs in the public layout
// (three (16, *batch) coordinates each). Bound: integer multiplies (8 field
// multiplies per element) at large batches; 640 bytes move per element.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

__global__ void __launch_bounds__(128)
niels_add_kernel(niels_ptrs p, niels_ptrs q, int64_t count, point_out_ptrs out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  ge_store(out, i, ge_niels_add(niels_limbs_load(p, i), niels_limbs_load(q, i)));
}

extern "C" int btt_niels_add(const void* pa, const void* pb, const void* pt, int64_t p_stride, const void* qa,
                             const void* qb, const void* qt, int64_t q_stride, int64_t count, void* ox, void* oy,
                             void* oz, void* ot, void* stream) {
  niels_ptrs p = {{(const int32_t*)pa, (const int32_t*)pb, (const int32_t*)pt}, p_stride};
  niels_ptrs q = {{(const int32_t*)qa, (const int32_t*)qb, (const int32_t*)qt}, q_stride};
  point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, count};
  if (count > 0) {
    const int threads = 128;
    int64_t blocks = (count + threads - 1) / threads;
    niels_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p, q, count, out);
  }
  return (int)cudaGetLastError();
}
