// doubling_combine: out[o] = sum_b 2^b * products[o, b] on ristretto255,
// one launch for all outputs.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_combine_tiled (:982) /
// doubling_combine (:1000): a double-and-add ladder from bit nbits - 1 down
// (blitzar_tpu/msm/fixed.py:611-623).
//
// Design: ladder.cuh's ladder with the Edwards policy (EdLadder), as
// w_doubling_combine.cu runs it for the Weierstrass curves: one warp per
// output, lane j < S sums its segment of seg_bits bit rows by Horner, lane
// 0 folds the S segments. With seg_bits = nbits (one segment) the
// coordinates are blitzar_tpu's; with the wrapper's segments the outputs
// are the same points.
//
// Bound: latency, not throughput. Each output is a serial chain (the top
// bit's nbits - 1 doublings), and a query has only O outputs, so the card
// is nearly idle while it runs: at 256 bits one lane ran 255 doublings and
// adds, 16 segments leave 255 doublings and 30 adds on the critical path.
#include <cuda_runtime.h>

#include "ladder.cuh"

using namespace btt;

// products: four (16, O, nbits) int32 coordinate arrays with the given limb
// stride; out: four (16, O) arrays. seg_bits: bits a segment, with at most
// 32 segments.
extern "C" int btt_doubling_combine(const void* x, const void* y, const void* z, const void* t,
                                    int64_t limb_stride, int64_t num_outputs, int nbits, int seg_bits,
                                    void* ox, void* oy, void* oz, void* ot, void* stream) {
  if (!ladder_args_ok(nbits, seg_bits) || num_outputs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  point_ptrs in;
  in.c[0] = (const int32_t*)x;
  in.c[1] = (const int32_t*)y;
  in.c[2] = (const int32_t*)z;
  in.c[3] = (const int32_t*)t;
  in.limb_stride = limb_stride;
  point_out_ptrs out;
  out.c[0] = (int32_t*)ox;
  out.c[1] = (int32_t*)oy;
  out.c[2] = (int32_t*)oz;
  out.c[3] = (int32_t*)ot;
  out.limb_stride = num_outputs;
  if (num_outputs > 0) launch_ladder<EdLadder>(in, num_outputs, nbits, seg_bits, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
