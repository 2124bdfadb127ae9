// ed_add: elementwise unified Edwards addition, out[i] = p[i] + q[i].
//
// Replaces blitzar_tpu/ops/pallas_point.py:_add_tiled (:237) / add (:291):
// add-2008-hwcd-3 with a = -1. It backs ed.tree_reduce (the sum of the
// lookup's partials per row, one_commitment) and the signed Q_pos - Q_neg.
//
// Design: one thread per element; limb l of element i of a coordinate sits
// at base[l * limb_stride + i], so neighbouring threads read neighbouring
// words. Bound: integer multiplies (10 field multiplies per element) at
// large batches; 768 bytes move per element, far below the multiply time.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

__global__ void __launch_bounds__(128)
ed_add_kernel(point_ptrs p, point_ptrs q, int64_t count, point_out_ptrs out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  ge_store(out, i, ge_add(ge_load(p, i), ge_load(q, i)));
}

extern "C" int btt_ed_add(const void* px, const void* py, const void* pz, const void* pt,
                          int64_t p_stride, const void* qx, const void* qy, const void* qz,
                          const void* qt, int64_t q_stride, int64_t count, void* ox,
                          void* oy, void* oz, void* ot, void* stream) {
  point_ptrs p;
  p.c[0] = (const int32_t*)px;
  p.c[1] = (const int32_t*)py;
  p.c[2] = (const int32_t*)pz;
  p.c[3] = (const int32_t*)pt;
  p.limb_stride = p_stride;
  point_ptrs q;
  q.c[0] = (const int32_t*)qx;
  q.c[1] = (const int32_t*)qy;
  q.c[2] = (const int32_t*)qz;
  q.c[3] = (const int32_t*)qt;
  q.limb_stride = q_stride;
  point_out_ptrs out;
  out.c[0] = (int32_t*)ox;
  out.c[1] = (int32_t*)oy;
  out.c[2] = (int32_t*)oz;
  out.c[3] = (int32_t*)ot;
  out.limb_stride = count;
  if (count > 0) {
    const int threads = 128;
    int64_t blocks = (count + threads - 1) / threads;
    ed_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p, q, count, out);
  }
  return (int)cudaGetLastError();
}
