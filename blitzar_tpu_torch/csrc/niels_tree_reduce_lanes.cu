// niels_tree_reduce_lanes: each column of a (size, cols) batch of niels table
// entries summed to one extended point, in one launch.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_niels_tree_tiled (:426) /
// niels_tree_reduce_lanes (:447), body _niels_tree_body_factory (:402): the
// reduce stage of the few-row partition query (msm/fixed.py), which sums the
// table entries a row selects in each table chunk. The TPU kernel halves a
// lane axis inside VMEM down to 128 lanes (first level niels + niels, later
// levels the extended add) and leaves the last 128 to ed.tree_reduce; here
// one block of 128 threads owns one column: lane t sums the entries t + 128 j
// in registers (niels_tree.cuh), then the block halves its 128 lanes in
// shared memory, one level per __syncthreads(). The order of additions is
// the plain version's, so the coordinates equal it limb for limb.
//
// Entries arrive as the table stores them (24 words each, a | b | 2d*t), so
// the gathered entries need no conversion to limbs first. Bound: integer
// multiplies (size/2 niels adds of 8 field multiplies and size/2 - 1
// extended adds of 9 per column); 96 bytes are read per entry.
#include <cuda_runtime.h>

#include "niels_tree.cuh"

using namespace btt;

template <int L>
__global__ void __launch_bounds__(kNielsTreeLanes)
niels_tree_kernel(const uint32_t* entries, int64_t cols, point_out_ptrs out) {
  __shared__ ge_p3 sums[kNielsTreeLanes];
  const int64_t c = blockIdx.x;
  const int t = threadIdx.x;
  sums[t] = niels_lane_sum<L>(entries, cols, c, t);
  for (int h = kNielsTreeLanes >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (t < h) sums[t] = ge_add(sums[t], sums[t + h]);
  }
  if (t == 0) ge_store(out, c, sums[0]);
}

// entries: (size, cols) niels entries of 24 words; size 256, 512, 1024 or
// 2048; out: (16, cols) coordinate arrays.
extern "C" int btt_niels_tree_reduce_lanes(const void* entries, int64_t size, int64_t cols, void* ox, void* oy,
                                           void* oz, void* ot, void* stream) {
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* e = (const uint32_t*)entries;
  point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, cols};
  cudaStream_t s = (cudaStream_t)stream;
  switch (niels_tree_leaves(size)) {
    case 1: niels_tree_kernel<1><<<(unsigned)cols, kNielsTreeLanes, 0, s>>>(e, cols, out); break;
    case 2: niels_tree_kernel<2><<<(unsigned)cols, kNielsTreeLanes, 0, s>>>(e, cols, out); break;
    case 4: niels_tree_kernel<4><<<(unsigned)cols, kNielsTreeLanes, 0, s>>>(e, cols, out); break;
    case 8: niels_tree_kernel<8><<<(unsigned)cols, kNielsTreeLanes, 0, s>>>(e, cols, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
