// w_horner: the bucket engine's Horner over a Weierstrass commitment's
// 8-bit windows (bls12-381 G1, bn254 G1, Grumpkin), out[o] = sum_w 2^(8 w)
// windows[o, w], one launch for all outputs.
//
// Replaces blitzar_tpu_torch/msm/engine.py's Horner loop, which ran on
// blitzar_tpu/ops/pallas_point.py:_wdouble_tiled (:907) and _wadd_tiled
// (:891) as in blitzar_tpu/msm/engine.py:118-140 (combine_buckets): 8
// one-point wdouble launches and one wadd a window, 248 + 31 launches for
// a 32-byte column.
//
// Design: ladder.cuh's ladder with the Weierstrass policy (WLadder<C>) and
// 8 doublings a step, the ladder of w_doubling_combine.cu: one warp an
// output, lanes on segments of seg_bits windows by Horner, lane 0 folds
// them. The window sums are read in place, (nlimbs, O, W) limb-major.
//
// Bound: latency, the 8 (W - 1) dependent doublings of an output (8
// dependent Montgomery multiplies each on the critical path).
#include <cuda_runtime.h>

#include "ladder.cuh"

using namespace btt;

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. windows: three (2K, O, W)
// int32 coordinate arrays with the given limb stride; out: three (2K, O)
// arrays. seg_bits: windows a segment, with at most 32 segments.
extern "C" int btt_w_horner(int curve, const void* px, const void* py, const void* pz, int64_t limb_stride,
                            int64_t num_outputs, int num_windows, int seg_bits, void* ox, void* oy, void* oz,
                            void* stream) {
  if (!ladder_args_ok(num_windows, seg_bits) || num_outputs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const wpoint_ptrs in = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz}, limb_stride};
  const wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, num_outputs};
  if (num_outputs > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id: launch_ladder<WLadder<Bls12381G1>, 8>(in, num_outputs, num_windows, seg_bits, out, s); break;
      case Bn254G1::id: launch_ladder<WLadder<Bn254G1>, 8>(in, num_outputs, num_windows, seg_bits, out, s); break;
      case Grumpkin::id: launch_ladder<WLadder<Grumpkin>, 8>(in, num_outputs, num_windows, seg_bits, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
