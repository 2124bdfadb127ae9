// ed_double: elementwise Edwards doubling, out[i] = 2 p[i].
//
// Replaces blitzar_tpu/ops/pallas_point.py:_double_tiled (:254) / double
// (:298), body _double_body (:59): dbl-2008-hwcd with a = -1 (4 squarings,
// 4 multiplies; blitzar_tpu/curves/edwards25519.py:_double_impl). It backs
// ed.double, the bucket engine's Horner step (8 doublings of the outputs a
// window, msm/engine.py:combine_buckets).
//
// Design: one thread per element, as ed_add.cu; limb l of element i of a
// coordinate sits at base[l * limb_stride + i], so neighbouring threads read
// neighbouring words. Bound: integer multiplies (8 field multiplies per
// element) at large batches; a Horner step doubles a handful of outputs, so
// there the launch's latency sets the time.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

__global__ void __launch_bounds__(128)
ed_double_kernel(point_ptrs p, int64_t count, point_out_ptrs out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  ge_store(out, i, ge_double(ge_load(p, i)));
}

extern "C" int btt_ed_double(const void* px, const void* py, const void* pz, const void* pt, int64_t p_stride,
                             int64_t count, void* ox, void* oy, void* oz, void* ot, void* stream) {
  point_ptrs p = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)pt}, p_stride};
  point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, count};
  if (count > 0) {
    const int threads = 128;
    int64_t blocks = (count + threads - 1) / threads;
    ed_double_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p, count, out);
  }
  return (int)cudaGetLastError();
}
