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
// Design: thread (g, lo) owns the 2^(w - L) entries of group g whose low
// L = w/2 bits are lo. It builds entry lo from the identity (popcount(lo)
// adds over the group's points, read from global memory and shared through
// L1 by the group's 2^L threads), then each entry (hi, lo) in increasing hi
// with one add to entry (hi minus its top bit, lo), which it wrote itself
// earlier and reads back. Per group of w = 8 that is 272 complete adds
// against the 255 the function needs; no thread waits for another.
// Bound: integer multiplies (14 field multiplies per add), not the table's
// bytes (3.2 GB for bn254 at 2^20 against ~30 ms of multiplies at peak).
#include <cuda_runtime.h>

#include "weierstrass.cuh"

using namespace btt;

template <class C>
__global__ void __launch_bounds__(128)
w_build_table_kernel(wpoint_ptrs pts, int w, int64_t groups, uint32_t* table) {
  constexpr int E = 3 * C::F::K;  // words per entry
  int lo_bits = w >> 1;
  uint32_t hi_count = 1u << (w - lo_bits);
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (groups << lo_bits)) return;
  int64_t g = tid >> lo_bits;
  uint32_t lo = (uint32_t)(tid & ((1 << lo_bits) - 1));
  uint32_t* group = table + (g << w) * E;
  wpoint<C> acc = w_identity<C>();
  for (int j = 0; j < lo_bits; ++j) {
    if ((lo >> j) & 1u) acc = w_add<C>(acc, w_load<C>(pts, g * w + j));
  }
  w_entry_store<C>(group + (int64_t)lo * E, acc);
  for (uint32_t hi = 1; hi < hi_count; ++hi) {
    int top = 31 - __clz((int)hi);
    uint32_t prev = ((hi ^ (1u << top)) << lo_bits) | lo;
    wpoint<C> sum = w_add<C>(w_entry_load<C>(group + (int64_t)prev * E),
                             w_load<C>(pts, g * w + lo_bits + top));
    w_entry_store<C>(group + (int64_t)((hi << lo_bits) | lo) * E, sum);
  }
}

template <class C>
static void launch_build(wpoint_ptrs pts, int w, int64_t groups, uint32_t* table,
                         cudaStream_t stream) {
  const int threads = 128;
  int64_t total = groups << (w >> 1);
  int64_t blocks = (total + threads - 1) / threads;
  w_build_table_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(pts, w, groups, table);
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. points: three
// (2K, groups * w) int32 coordinate arrays with the given limb stride;
// table: (groups, 2^w, 3, K) 32-bit words.
extern "C" int btt_w_build_table(int curve, const void* x, const void* y, const void* z,
                                 int64_t limb_stride, int w, int64_t groups, void* table,
                                 void* stream) {
  wpoint_ptrs pts = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z}, limb_stride};
  if (groups > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t* t = (uint32_t*)table;
    switch (curve) {
      case Bls12381G1::id: launch_build<Bls12381G1>(pts, w, groups, t, s); break;
      case Bn254G1::id: launch_build<Bn254G1>(pts, w, groups, t, s); break;
      case Grumpkin::id: launch_build<Grumpkin>(pts, w, groups, t, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
