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
// Design: four lanes a pair (quad_add.cuh), as ed_add.cu: a lane's chain is
// 3 dependent multiplies where one thread's was 8; inputs in the public
// layout (three (16, *batch) coordinates each). Bound: the launch and one
// lane's chain at the path's 64 x 8 pairs; integer multiplies (8 field
// multiplies a pair) at large batches; 640 bytes move a pair.
#include <cuda_runtime.h>

#include "quad_add.cuh"

using namespace btt;

__global__ void __launch_bounds__(kQuadThreads)
niels_add_kernel(niels_ptrs p, niels_ptrs q, int64_t count, point_out_ptrs out) {
  const int64_t pair = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kQuadLanes;
  const int j = threadIdx.x % kQuadLanes;
  const int64_t i = pair < count ? pair : count - 1;  // as ed_add.cu: every lane shuffles
  fe s[kQuadLanes];
  quad_exchange(niels_add_quad_first(j, p, q, i, fe_mul_op()), s);
  const fe r = quad_last(j, s, fe_mul_op());
  if (pair < count) fe_store(quad_coord(out, j) + i, out.limb_stride, r);
}

extern "C" int btt_niels_add(const void* pa, const void* pb, const void* pt, int64_t p_stride, const void* qa,
                             const void* qb, const void* qt, int64_t q_stride, int64_t count, void* ox, void* oy,
                             void* oz, void* ot, void* stream) {
  niels_ptrs p = {{(const int32_t*)pa, (const int32_t*)pb, (const int32_t*)pt}, p_stride};
  niels_ptrs q = {{(const int32_t*)qa, (const int32_t*)qb, (const int32_t*)qt}, q_stride};
  point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, count};
  if (count > 0) {
    int64_t blocks = (kQuadLanes * count + kQuadThreads - 1) / kQuadThreads;
    niels_add_kernel<<<(unsigned)blocks, kQuadThreads, 0, (cudaStream_t)stream>>>(p, q, count, out);
  }
  return (int)cudaGetLastError();
}
