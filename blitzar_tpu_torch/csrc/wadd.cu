// wadd: elementwise complete Weierstrass addition, out[i] = p[i] + q[i], or
// p[i] - q[i] with negate_q.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_wadd_tiled (:891) / wadd (:943):
// Renes-Costello-Batina Algorithm 7 with a = 0, for bls12-381 G1, bn254 G1
// and Grumpkin (one template, picked by the curve id). It backs the signed
// Q_pos - Q_neg (q read negated, msm/fixed.py:combine_signed) and the
// bucket engine's round adds.
//
// Design: eight lanes a pair (wadd_lanes.cuh). A group of a warp runs one
// add's two stages of six independent products, one product a lane a
// stage (six lanes busy), exchanging the stage-1 products by shuffles and
// summing the stage-3 products of neighbouring lanes by one more, so a
// lane's chain is 2 dependent Montgomery multiplies where one thread's is
// 12; 64-thread blocks spread a small batch over many SMs. Limb l of pair
// i of a coordinate sits at base[l * limb_stride + i]: a group's lanes
// load the coordinates their products need and lanes 0, 2 and 4 store X3,
// Y3 and Z3. Bound: at the paths' batches (1-10 pairs), the launch and one
// lane's chain; at large batches integer multiplies (12 field multiplies,
// 264 or 588 32-bit multiplies each, a pair; the lanes spend 16).
#include <cuda_runtime.h>

#include "wadd_lanes.cuh"

using namespace btt;

template <class C>
__global__ void __launch_bounds__(kWaddThreads)
wadd_kernel(wpoint_ptrs p, wpoint_ptrs q, int negate_q, int64_t count, wpoint_out_ptrs out) {
  using F = typename C::F;
  const int64_t pair = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kWaddLanes;
  const int j = threadIdx.x % kWaddLanes;
  // a group past the end adds the last pair again: every lane takes part
  // in the shuffles
  const int64_t i = pair < count ? pair : count - 1;
  const int k = w_lanes_product(j);
  mfe<F> s[kWaddProducts];
  w_lanes_exchange<F>(w_lanes_first<C>(k, p, q, i, negate_q != 0, mf_mul_op<F>()), s);
  const mfe<F> r = w_lanes_last<C>(k, s, mf_mul_op<F>());
  const mfe<F> other = w_lanes_partner<F>(r);
  if (j < kWaddProducts && (j & 1) == 0 && pair < count) {
    mf_store<F>(w_coord(out, j / 2) + i, out.limb_stride, w_lanes_coord<F>(j, r, other));
  }
}

template <class C>
static void launch_wadd(wpoint_ptrs p, wpoint_ptrs q, int negate_q, int64_t count, wpoint_out_ptrs out,
                        cudaStream_t stream) {
  const int64_t blocks = (kWaddLanes * count + kWaddThreads - 1) / kWaddThreads;
  wadd_kernel<C><<<(unsigned)blocks, kWaddThreads, 0, stream>>>(p, q, negate_q, count, out);
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. p, q, out: three (2K, count)
// int32 coordinate arrays each (out contiguous: limb stride = count);
// negate_q != 0 adds -q.
extern "C" int btt_wadd(int curve, const void* px, const void* py, const void* pz, int64_t p_stride,
                        const void* qx, const void* qy, const void* qz, int64_t q_stride, int negate_q,
                        int64_t count, void* ox, void* oy, void* oz, void* stream) {
  wpoint_ptrs p = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz}, p_stride};
  wpoint_ptrs q = {{(const int32_t*)qx, (const int32_t*)qy, (const int32_t*)qz}, q_stride};
  wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, count};
  if (count > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id: launch_wadd<Bls12381G1>(p, q, negate_q, count, out, s); break;
      case Bn254G1::id: launch_wadd<Bn254G1>(p, q, negate_q, count, out, s); break;
      case Grumpkin::id: launch_wadd<Grumpkin>(p, q, negate_q, count, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
