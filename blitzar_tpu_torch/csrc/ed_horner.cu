// ed_horner: the bucket engine's Horner over a ristretto255 commitment's
// 8-bit windows, out[o] = sum_w 2^(8 w) windows[o, w], one launch for all
// outputs.
//
// Replaces blitzar_tpu_torch/msm/engine.py's Horner loop, which ran on
// blitzar_tpu/ops/pallas_point.py:_double_tiled (:254) and _add_tiled (:237)
// as in blitzar_tpu/msm/engine.py:118-140 (combine_buckets): 8 one-point
// ed_double launches and one ed_add a window, 248 + 31 launches for a
// 32-byte column.
//
// Design: ladder.cuh's ladder with the Edwards policy (EdLadder) and 8
// doublings a step, the ladder of doubling_combine.cu: one warp an output,
// lane j < S runs Horner over its segment of seg_bits windows, lane 0 folds
// the S segments. The window sums are read in place, (16, O, W)
// limb-major. With seg_bits = W the coordinates are the engine's loop's;
// with the wrapper's segments the outputs are the same points.
//
// Bound: latency. An output's 8 (W - 1) doublings are a chain no split
// shortens, and a commitment has O <= a few dozen outputs: the card is
// nearly idle while it runs.
#include <cuda_runtime.h>

#include "ladder.cuh"

using namespace btt;

// windows: four (16, O, W) int32 coordinate arrays with the given limb
// stride; out: four (16, O) arrays. seg_bits: windows a segment, with at
// most 32 segments.
extern "C" int btt_ed_horner(const void* x, const void* y, const void* z, const void* t, int64_t limb_stride,
                             int64_t num_outputs, int num_windows, int seg_bits, void* ox, void* oy, void* oz,
                             void* ot, void* stream) {
  if (!ladder_args_ok(num_windows, seg_bits) || num_outputs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const point_ptrs in = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t}, limb_stride};
  const point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, num_outputs};
  if (num_outputs > 0) {
    launch_ladder<EdLadder, 8>(in, num_outputs, num_windows, seg_bits, out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
