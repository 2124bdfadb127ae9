// build_cached_table: the partition table of one chunk of a streamed query.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_build_split_tiled (:806) /
// build_split_table (:843), cached form (body :781-783). Entry v of group g
// is the sum of the points g*w + j over the set bits j of v (entry 0 is the
// identity), stored as (Y + X, Y - X, Z, 2d*T): 32 canonical words, 128
// bytes. No inversion: a streamed query builds each chunk's table once and
// drops it, where the niels form's inversions would cost more than the
// query (blitzar_tpu/msm/fixed.py:729-735).
//
// Bound: integer multiplies at w = 8 (a group's least work: w multiplies by
// 2d to put its points in cached form, then (2^w - 1 - w) adds of 8
// multiplies and as many multiplies by 2d); the bytes written (128 a
// entry, 1 GiB for a 2^18-point chunk) are half of it.
//
// Design (table_build.cuh): a group's 2^w entries over 2^L lanes (L =
// min(w, 2); 32 >> L groups a warp), no block barrier. The warp's groups'
// points sit in shared memory in sum form (128 bytes each, 8 KB a warp at
// w = 8). Lane t forms entry t from the identity (at most L adds, the lanes
// in step, in blitzar_tpu's order), then each of its rows k, entries
// t + 2^L k, from its parent row read back from the table, where the lane
// has just stored it (an L2 hit), plus one point: at w = 8, 65 adds a lane
// for 8 groups a warp, every lane at work in all but the first 2. One add
// in one loop, and one multiply body for all the multiplies, keep the
// kernel small for the instruction cache and the registers few. Each entry goes to its 128 bytes as eight 16-byte stores,
// so the 4 lanes of a group's row cover 512 bytes of the table without a
// gap.
#include <cuda_runtime.h>

#include "table_build.cuh"

using namespace btt;

namespace {

constexpr int kMaxWindow = 8;
constexpr int kWarps = 4;        // warps a block

__global__ void __launch_bounds__(32 * kWarps)
build_cached_table_kernel(point_ptrs pts, int w, int64_t groups, uint32_t* table) {
  __shared__ ge_cached gens[kWarps][kWarpPoints];
  const run_shape shape = run_shape_of(w);
  const int L = shape.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 >> L;
  const int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * per_warp;
  for (int i = lane; i < per_warp * w; i += 32) {
    int64_t g = first + i / w;
    if (g < groups) gens[warp][i] = ge_to_sum_form(ge_load(pts, g * w + i % w));
  }
  __syncwarp();
  const int seg = lane >> L;
  const int64_t g = first + seg;
  if (g >= groups) return;
  const cached_rows rows{reinterpret_cast<word4*>(table) + (g << w) * 8, L, lane & ((1 << L) - 1)};
  cached_lane_entries(gens[warp] + seg * w, L, shape.H, rows);
}

}  // namespace

// points: four (16, groups * w) int32 coordinate arrays with the given limb
// stride; table: (groups, 2^w, 4, 8) 32-bit words; 1 <= w <= 8.
extern "C" int btt_build_cached_table(const void* x, const void* y, const void* z, const void* t,
                                      int64_t limb_stride, int w, int64_t groups, void* table,
                                      void* stream) {
  if (w < 1 || w > kMaxWindow) return (int)cudaErrorInvalidValue;
  point_ptrs pts;
  pts.c[0] = (const int32_t*)x;
  pts.c[1] = (const int32_t*)y;
  pts.c[2] = (const int32_t*)z;
  pts.c[3] = (const int32_t*)t;
  pts.limb_stride = limb_stride;
  if (groups > 0) {
    run_shape s = run_shape_of(w);
    int64_t per_block = (int64_t)kWarps * (32 >> s.L);
    unsigned blocks = (unsigned)((groups + per_block - 1) / per_block);
    build_cached_table_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(pts, w, groups,
                                                                              (uint32_t*)table);
  }
  return (int)cudaGetLastError();
}
