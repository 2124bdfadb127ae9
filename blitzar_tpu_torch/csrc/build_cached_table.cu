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
// Design: one block per group, one thread per entry (2^w threads, w <= 8).
// The group's w points, in cached form, and its 2^w extended entries live
// in shared memory (1 KB + 32 KB at w = 8). Step j of the doubling
// concatenation (the order of blitzar_tpu's table, table_{j+1} = [table_j |
// table_j + P_j]) has threads [2^j, 2^{j+1}) add cached P_j to entry v - 2^j
// (8 multiplies), one __syncthreads() a step. The cached add computes the
// unified add's field values, so the table equals the plain version's limb
// for limb. Then each thread converts its entry to the cached form, the
// block stages the canonical words in shared memory and stores the 8 KB or
// 32 KB group with consecutive threads on consecutive words.
//
// Bound: integer multiplies at w = 8 (a group's least work: w multiplies by
// 2d to put its points in cached form, then (2^w - 1 - w) adds of 8
// multiplies and as many multiplies by 2d; the kernel also forms the w
// one-point entries by an add to the identity and converts entry 0); the
// bytes written (128 a entry, 1 GiB for a 2^18-point chunk) are the second
// bound.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

constexpr int kMaxWindow = 8;

__global__ void __launch_bounds__(1 << kMaxWindow)
build_cached_table_kernel(point_ptrs pts, int w, uint32_t* table) {
  __shared__ ge_p3 entries[1 << kMaxWindow];
  __shared__ ge_cached gens[kMaxWindow];
  int64_t g = blockIdx.x;
  int v = threadIdx.x;
  int count = 1 << w;
  if (v < w) gens[v] = ge_to_cached(ge_load(pts, g * w + v));
  if (v == 0) entries[0] = ge_identity();
  for (int j = 0; j < w; ++j) {
    __syncthreads();
    int lo = 1 << j;
    if (v >= lo && v < 2 * lo) entries[v] = ge_cadd(entries[v - lo], gens[j]);
  }
  __syncthreads();
  ge_cached c = ge_to_cached(entries[v]);
  __syncthreads();
  uint32_t* words = reinterpret_cast<uint32_t*>(entries);  // 32 words an entry
  cached_store(words + v * 32, c);
  __syncthreads();
  uint32_t* dst = table + ((g << w) * 32);
  for (int k = v; k < count * 32; k += count) dst[k] = words[k];
}

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
    build_cached_table_kernel<<<(unsigned)groups, 1 << w, 0, (cudaStream_t)stream>>>(pts, w,
                                                                                    (uint32_t*)table);
  }
  return (int)cudaGetLastError();
}
