// ed_add: elementwise unified Edwards addition, out[i] = p[i] + q[i], or
// p[i] - q[i] with negate_q.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_add_tiled (:237) / add (:291):
// add-2008-hwcd-3 with a = -1. It backs the signed Q_pos - Q_neg (q read
// negated, msm/fixed.py:combine_signed), the IPA's and the large-n path's
// sums of partials and the bucket engine's round adds.
//
// Design: four lanes a pair (quad_add.cuh). A quad of a warp runs one
// add's three stages, one product a lane a stage, exchanging the four
// stage-1 products by shuffles, so a lane's chain is 3 dependent
// multiplies (one thread's is 10) and a batch puts four times the threads
// on the card; 64-thread blocks spread a small batch over many SMs. Limb l
// of pair i of a coordinate sits at base[l * limb_stride + i]: a quad's
// lanes load the coordinates their products need and lane j stores
// coordinate j, so neighbouring quads read and write neighbouring words.
// Bound: at the paths' batches (1-5610 pairs), the launch and one lane's
// chain; at large batches integer multiplies (12 field multiplies a pair
// where one thread spends 10).
#include <cuda_runtime.h>

#include "quad_add.cuh"

using namespace btt;

__global__ void __launch_bounds__(kQuadThreads)
ed_add_kernel(point_ptrs p, point_ptrs q, int negate_q, int64_t count, point_out_ptrs out) {
  const int64_t pair = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kQuadLanes;
  const int j = threadIdx.x % kQuadLanes;
  // a quad past the end adds the last pair again: every lane takes part in
  // the shuffles
  const int64_t i = pair < count ? pair : count - 1;
  fe s[kQuadLanes];
  quad_exchange(ed_add_quad_first(j, p, q, i, negate_q != 0, fe_mul_op()), s);
  const fe r = quad_last(j, s, fe_mul_op());
  if (pair < count) fe_store(quad_coord(out, j) + i, out.limb_stride, r);
}

extern "C" int btt_ed_add(const void* px, const void* py, const void* pz, const void* pt,
                          int64_t p_stride, const void* qx, const void* qy, const void* qz,
                          const void* qt, int64_t q_stride, int negate_q, int64_t count,
                          void* ox, void* oy, void* oz, void* ot, void* stream) {
  point_ptrs p = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)pt}, p_stride};
  point_ptrs q = {{(const int32_t*)qx, (const int32_t*)qy, (const int32_t*)qz, (const int32_t*)qt}, q_stride};
  point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, count};
  if (count > 0) {
    int64_t blocks = (kQuadLanes * count + kQuadThreads - 1) / kQuadThreads;
    ed_add_kernel<<<(unsigned)blocks, kQuadThreads, 0, (cudaStream_t)stream>>>(p, q, negate_q, count, out);
  }
  return (int)cudaGetLastError();
}
