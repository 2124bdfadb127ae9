// w_doubling_combine: out[o] = sum_b 2^b * products[o, b] on a Weierstrass
// curve (bls12-381 G1, bn254 G1, Grumpkin), one launch for all outputs.
//
// Replaces the Weierstrass ladder of blitzar_tpu/msm/fixed.py:596-623
// (_doubling_combine: a fori_loop over the Pallas wdouble and wadd,
// pallas_point.py:_wdouble_tiled :907 and _wadd_tiled :891, one launch of
// each per bit), which the port ran as 2 (nbits - 1) one-point launches
// from Python.
//
// Design: ladder.cuh's ladder with the Weierstrass policy (WLadder<C>), as
// doubling_combine.cu runs it for ristretto255: one warp per output, lane
// j < S sums its segment of seg_bits bit rows by Horner, lane 0 folds the
// S segments. The products are read in place, (nlimbs, O, nbits)
// limb-major.
//
// Bound: latency, not throughput. A query has few outputs, so the card is
// nearly idle; the critical path of a 256-bit output is 255 doublings of
// 8 dependent multiplies plus the adds on it (L - 1 in a segment, S - 1 in
// the fold).
#include <cuda_runtime.h>

#include "ladder.cuh"

using namespace btt;

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. products: three (2K, O,
// nbits) int32 coordinate arrays with the given limb stride; out: three
// (2K, O) arrays. seg_bits: bits a segment, with at most 32 segments.
extern "C" int btt_w_doubling_combine(int curve, const void* px, const void* py, const void* pz,
                                      int64_t limb_stride, int64_t num_outputs, int nbits, int seg_bits,
                                      void* ox, void* oy, void* oz, void* stream) {
  if (!ladder_args_ok(nbits, seg_bits) || num_outputs > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const wpoint_ptrs in = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz}, limb_stride};
  const wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, num_outputs};
  if (num_outputs > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id: launch_ladder<WLadder<Bls12381G1>>(in, num_outputs, nbits, seg_bits, out, s); break;
      case Bn254G1::id: launch_ladder<WLadder<Bn254G1>>(in, num_outputs, nbits, seg_bits, out, s); break;
      case Grumpkin::id: launch_ladder<WLadder<Grumpkin>>(in, num_outputs, nbits, seg_bits, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
