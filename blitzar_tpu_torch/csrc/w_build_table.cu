// w_build_table: the partition table of a Weierstrass fixed-generator handle.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_build_split_tiled (:806) /
// build_split_table (:843), Weierstrass form (_w_build_body_factory :789).
// Entry v of group g is the sum of the generators g*w + j over the set bits
// j of v, in projective coordinates, not normalised: the identity entry
// (v = 0) has z = 0, which the complete formulas need and an affine entry
// cannot hold (blitzar_tpu/msm/fixed.py:239-242). An entry is 3K canonical
// Montgomery words (X, Y, Z): 96 bytes for bn254 and Grumpkin, 144 for
// bls12-381. There is no byte split: that only fed the TPU's matrix unit.
//
// Order of the sums: blitzar_tpu builds a group by w subset-doubling steps,
// table_{j+1} = [table_j | table_j + G_j], so entry v = entry(v - 2^t) + G_t
// with t the top bit of v, entry 0 = the identity. This kernel adds in that
// same order, so its projective values equal blitzar_tpu's bit for bit.
//
// Design: table_build.cuh's lane schedule, the one build_cached_table.cu
// runs, with the Weierstrass entry form (WBuild<C>). Up to w = 8 a group's
// entries go over 4 lanes (L = min(w, 2)), lane t owns entries t + 4k; a
// wider group over 2^(w - 6) lanes of 64 rows. The warp's groups' points
// are converted from 16-bit limbs to Montgomery words once, into shared
// memory; each lane forms its row 0 (at most L adds), then each row by one
// complete add to its parent row, read back from the table where the lane
// stored it, plus one point: at w = 8, 65 steps a lane, 256 adds a group against
// the 255 the function needs. Every multiply calls one non-inlined
// Montgomery body (mf_mul_call_op: inlined copies overflow the instruction
// cache), and an entry moves as 16-byte words (6 for K = 8, 9 for K = 12),
// so the 4 lanes of a group's row write 384 or 576 contiguous bytes.
// Bound: integer multiplies (12 field multiplies an add), not the table's
// bytes (3.2 GB for bn254 G1 at 2^20 against ~6.3 ms of multiplies at the
// H100's peak).
#include <cuda_runtime.h>

#include "table_build.cuh"

using namespace btt;

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. points: three
// (2K, groups * w) int32 coordinate arrays with the given limb stride;
// table: (groups, 2^w, 3, K) 32-bit words; 1 <= w <= 30.
extern "C" int btt_w_build_table(int curve, const void* x, const void* y, const void* z,
                                 int64_t limb_stride, int w, int64_t groups, void* table,
                                 void* stream) {
  if (w < 1 || w > kMaxLaneWindow) return (int)cudaErrorInvalidValue;
  const wpoint_ptrs pts = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z}, limb_stride};
  if (groups > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    word4* t = (word4*)table;
    switch (curve) {
      case Bls12381G1::id: launch_lane_build<WBuild<Bls12381G1>>(pts, w, groups, t, s); break;
      case Bn254G1::id: launch_lane_build<WBuild<Bn254G1>>(pts, w, groups, t, s); break;
      case Grumpkin::id: launch_lane_build<WBuild<Grumpkin>>(pts, w, groups, t, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
