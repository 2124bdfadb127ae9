// wdouble: elementwise complete Weierstrass doubling, out[i] = 2 p[i].
//
// Replaces blitzar_tpu/ops/pallas_point.py:_wdouble_tiled (:907) / wdouble
// (:948): Renes-Costello-Batina Algorithm 9 with a = 0, one template over
// bls12-381 G1, bn254 G1 and Grumpkin. On the commitment path it runs in
// the double-and-add ladder of a query (blitzar_tpu/msm/fixed.py:611-623).
//
// Design: one thread per element on the limb-major layout, as wadd.cu.
// Bound: integer multiplies at large batches (9 field multiplies per
// element); in the ladder the batch is the query's few outputs, and the
// launch is the cost.
#include <cuda_runtime.h>

#include "weierstrass.cuh"

using namespace btt;

template <class C>
__global__ void __launch_bounds__(128)
wdouble_kernel(wpoint_ptrs p, int64_t count, wpoint_out_ptrs out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  w_store<C>(out, i, w_double<C>(w_load<C>(p, i)));
}

template <class C>
static void launch_wdouble(wpoint_ptrs p, int64_t count, wpoint_out_ptrs out, cudaStream_t stream) {
  const int threads = 128;
  int64_t blocks = (count + threads - 1) / threads;
  wdouble_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(p, count, out);
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. p, out: three (2K, count)
// int32 coordinate arrays each (out contiguous: limb stride = count).
extern "C" int btt_wdouble(int curve, const void* px, const void* py, const void* pz,
                           int64_t p_stride, int64_t count, void* ox, void* oy, void* oz,
                           void* stream) {
  wpoint_ptrs p = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz}, p_stride};
  wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, count};
  if (count > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id: launch_wdouble<Bls12381G1>(p, count, out, s); break;
      case Bn254G1::id: launch_wdouble<Bn254G1>(p, count, out, s); break;
      case Grumpkin::id: launch_wdouble<Grumpkin>(p, count, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
