// wadd: elementwise complete Weierstrass addition, out[i] = p[i] + q[i].
//
// Replaces blitzar_tpu/ops/pallas_point.py:_wadd_tiled (:891) / wadd (:943):
// Renes-Costello-Batina Algorithm 7 with a = 0, for bls12-381 G1, bn254 G1
// and Grumpkin (one template, picked by the curve id). It backs the tree
// reduce over the lookup's partials, the double-and-add ladder of a query
// and the signed Q_pos - Q_neg.
//
// Design: one thread per element; limb l of element i of a coordinate sits
// at base[l * limb_stride + i], so neighbouring threads read neighbouring
// words and a tree-reduce half is passed as a view. Bound: integer
// multiplies at large batches (14 field multiplies per element, 264 or 588
// 32-bit multiplies each, against 9 x 2K x 4 bytes moved per element). In
// the ladder the batch is the query's few outputs: there the launch is the
// cost.
#include <cuda_runtime.h>

#include "weierstrass.cuh"

using namespace btt;

template <class C>
__global__ void __launch_bounds__(128)
wadd_kernel(wpoint_ptrs p, wpoint_ptrs q, int64_t count, wpoint_out_ptrs out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  w_store<C>(out, i, w_add<C>(w_load<C>(p, i), w_load<C>(q, i)));
}

template <class C>
static void launch_wadd(wpoint_ptrs p, wpoint_ptrs q, int64_t count, wpoint_out_ptrs out,
                        cudaStream_t stream) {
  const int threads = 128;
  int64_t blocks = (count + threads - 1) / threads;
  wadd_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(p, q, count, out);
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. p, q, out: three (2K, count)
// int32 coordinate arrays each (out contiguous: limb stride = count).
extern "C" int btt_wadd(int curve, const void* px, const void* py, const void* pz,
                        int64_t p_stride, const void* qx, const void* qy, const void* qz,
                        int64_t q_stride, int64_t count, void* ox, void* oy, void* oz,
                        void* stream) {
  wpoint_ptrs p = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz}, p_stride};
  wpoint_ptrs q = {{(const int32_t*)qx, (const int32_t*)qy, (const int32_t*)qz}, q_stride};
  wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, count};
  if (count > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id: launch_wadd<Bls12381G1>(p, q, count, out, s); break;
      case Bn254G1::id: launch_wadd<Bn254G1>(p, q, count, out, s); break;
      case Grumpkin::id: launch_wadd<Grumpkin>(p, q, count, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
