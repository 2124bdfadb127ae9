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
// Design (table_build.cuh, shared with w_build_table.cu): a group's 2^w
// entries over 2^L lanes (L = min(w, 2); 32 >> L groups a warp), no block
// barrier. The warp's groups' points sit in shared memory in sum form (128
// bytes each, 8 KB a warp at w = 8). Lane t forms entry t from the identity
// (at most L adds, the lanes in step, in blitzar_tpu's order), then each of
// its rows k, entries t + 2^L k, from its parent row read back from the
// table, where the lane has just stored it (an L2 hit), plus one point: at
// w = 8, 65 adds a lane for 8 groups a warp, every lane at work in all but
// the first 2. One add in one loop, and one multiply body for all the
// multiplies, keep the kernel small for the instruction cache and the
// registers few. Each entry goes to its 128 bytes as eight 16-byte stores,
// so the 4 lanes of a group's row cover 512 bytes of the table without a
// gap.
#include <cuda_runtime.h>

#include "table_build.cuh"

using namespace btt;

// points: four (16, groups * w) int32 coordinate arrays with the given limb
// stride; table: (groups, 2^w, 4, 8) 32-bit words; 1 <= w <= 8.
extern "C" int btt_build_cached_table(const void* x, const void* y, const void* z, const void* t,
                                      int64_t limb_stride, int w, int64_t groups, void* table,
                                      void* stream) {
  if (w < 1 || w > kRunBits) return (int)cudaErrorInvalidValue;
  point_ptrs pts;
  pts.c[0] = (const int32_t*)x;
  pts.c[1] = (const int32_t*)y;
  pts.c[2] = (const int32_t*)z;
  pts.c[3] = (const int32_t*)t;
  pts.limb_stride = limb_stride;
  if (groups > 0) launch_lane_build<CachedBuild>(pts, w, groups, (word4*)table, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
