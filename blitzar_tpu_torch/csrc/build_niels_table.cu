// build_niels_table: the partition table of a fixed-generator handle.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_build_split_tiled (:806) /
// build_split_table (:843), niels form. Entry v of group g is the sum of the
// generators g*w + j over the set bits j of v (entry 0 is the identity),
// stored affine as (y + x, y - x, 2d*x*y): 24 canonical words, 96 bytes.
// There is no byte split: that only fed the TPU's matrix unit.
//
// Design: one thread per entry. It sums its at most w generators with the
// unified add (read from global memory; the w points of a group are shared
// by the 2^w threads of that group and stay in L1), then normalises with
// its own inversion chain (~265 multiplies). Bound: integer multiplies. The
// function needs ~4.3k field multiplies per group of 256 entries (247 adds,
// one Montgomery batch inversion, 4 multiplies per entry); this kernel does
// ~76k, ~90% of them in the per-entry inversions. A batch inversion per
// group is left for a later change.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

__global__ void __launch_bounds__(128)
build_niels_table_kernel(point_ptrs pts, int w, int64_t entries, uint32_t* table) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= entries) return;
  int64_t g = e >> w;
  uint32_t v = (uint32_t)(e & ((1 << w) - 1));
  ge_p3 acc = ge_identity();
  bool first = true;
  for (int j = 0; j < w; ++j) {
    if ((v >> j) & 1u) {
      ge_p3 q = ge_load(pts, g * w + j);
      acc = first ? q : ge_add(acc, q);
      first = false;
    }
  }
  niels_store(table + e * 24, ge_to_niels(acc));
}

// points: four (16, groups * w) int32 coordinate arrays with the given limb
// stride; table: (groups, 2^w, 3, 8) 32-bit words.
extern "C" int btt_build_niels_table(const void* x, const void* y, const void* z,
                                     const void* t, int64_t limb_stride, int w,
                                     int64_t groups, void* table, void* stream) {
  point_ptrs pts;
  pts.c[0] = (const int32_t*)x;
  pts.c[1] = (const int32_t*)y;
  pts.c[2] = (const int32_t*)z;
  pts.c[3] = (const int32_t*)t;
  pts.limb_stride = limb_stride;
  int64_t entries = groups << w;
  if (entries > 0) {
    const int threads = 128;
    int64_t blocks = (entries + threads - 1) / threads;
    build_niels_table_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        pts, w, entries, (uint32_t*)table);
  }
  return (int)cudaGetLastError();
}
