// ed_window_sums, w_window_sums: the bucket engine's window sums, out[r] =
// sum_k k S[r, k - 1] over a row's 255 bucket sums, one launch for all rows
// (window_sums.cuh holds the order and the steps).
//
// Replaces blitzar_tpu_torch/msm/engine.py's window sums, which ran on
// blitzar_tpu/ops/pallas_point.py:_add_tiled (:237) / _wadd_tiled (:891) as
// blitzar_tpu/msm/engine.py:118-126 does (lax.associative_scan(curve.add,
// ..., reverse=True), then curve.tree_reduce): 8 Hillis-Steele steps, each an
// ed_add / wadd launch over an (R, 255 - shift) batch and a plain cat of the
// coordinates, then a transpose and a tree_reduce_lanes launch.
//
// Design: one warp a row (4 rows a block). Lane t reads buckets t + 32 j, so
// a warp's loads of each limb row are consecutive words, and sums its run
// of 8 (13 adds); a suffix scan of the runs by shuffles (5 adds), a lane's
// 5 doublings and one add, and a halving of the 32 shares by shuffles (5
// adds) leave the row's sum in lane 0. A point moves between lanes as its
// 32 (Edwards) or 3K (Weierstrass) words. The add and the doubling are
// ladder.cuh's non-inlined bodies, each multiply a call of the policy's
// non-inlined body (inlined multiplies overflow the instruction cache).
//
// Bound: latency. A row's 29 dependent point operations are its critical
// path, and a commitment has R = outputs x windows rows (32 for one 32-byte
// column, 320 for ten): the card holds every row at once and idles. The
// function's least work, 508 adds a row (the running-sum method), is
// microseconds of the card's multiply rate.
#include <cuda_runtime.h>

#include "window_sums.cuh"

using namespace btt;

namespace {

constexpr int kWarps = 4;  // rows a block

template <class P>
__device__ P shfl_down_point(const P& p, int d) {
  static_assert(sizeof(P) % 4 == 0, "a point is 32-bit words");
  P r;
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&p);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(P) / 4); ++i) o[i] = __shfl_down_sync(0xffffffffu, a[i], d);
  return r;
}

template <class G>
__global__ void __launch_bounds__(kWarps * 32)
window_sums_kernel(typename G::In buckets, int64_t rows, typename G::Out out) {
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp: a row is one warp
  typename G::P s, u;
  window_lane_run<G>(buckets, row, t, s, u);
  for (int d = 1; d < kWindowLanes; d <<= 1) s = window_scan_step<G>(s, shfl_down_point(s, d), t, d);
  typename G::P v = window_lane_share<G>(s, u);
  for (int d = kWindowLanes / 2; d > 0; d >>= 1) v = ladder_add<G>(v, shfl_down_point(v, d));
  if (t == 0) G::store(out, row, v);
}

template <class G>
void launch(const typename G::In& buckets, int64_t rows, const typename G::Out& out, cudaStream_t stream) {
  window_sums_kernel<G><<<(unsigned)((rows + kWarps - 1) / kWarps), kWarps * 32, 0, stream>>>(buckets, rows, out);
}

}  // namespace

// buckets: four (16, rows, 255) int32 coordinate arrays at limb_stride; out:
// four (16, rows) arrays.
extern "C" int btt_ed_window_sums(const void* x, const void* y, const void* z, const void* t, int64_t limb_stride,
                                  int64_t rows, void* ox, void* oy, void* oz, void* ot, void* stream) {
  const point_ptrs in = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t}, limb_stride};
  const point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, rows};
  if (rows > 0) launch<EdLadder>(in, rows, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. buckets: three (2K, rows,
// 255) int32 coordinate arrays at limb_stride; out: three (2K, rows) arrays.
extern "C" int btt_w_window_sums(int curve, const void* px, const void* py, const void* pz, int64_t limb_stride,
                                 int64_t rows, void* ox, void* oy, void* oz, void* stream) {
  const wpoint_ptrs in = {{(const int32_t*)px, (const int32_t*)py, (const int32_t*)pz}, limb_stride};
  const wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, rows};
  if (rows > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id: launch<WLadder<Bls12381G1>>(in, rows, out, s); break;
      case Bn254G1::id: launch<WLadder<Bn254G1>>(in, rows, out, s); break;
      case Grumpkin::id: launch<WLadder<Grumpkin>>(in, rows, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
