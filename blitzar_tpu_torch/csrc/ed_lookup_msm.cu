// ed_lookup_msm: the partition products of a fixed-generator query.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_lookup_tiled (:533) /
// ed_lookup_msm (:570), both of its entry forms: niels (a handle's table)
// and cached (the `ncoord == 4` branch, :519-526: a streamed chunk's table).
// For bit-row r (output o, scalar bit b) and group g, idx[r, g] = sum_j
// bit_b(scalar[o, g*w + j]) << j picks table entry (g, idx); row r's product
// is the sum over g of those entries.
//
// The TPU kernel walks groups on a sequential grid and carries the sums in
// scratch across grid steps; Hopper has no sequential grid. Here thread
// (k, r) owns row r and the k-th chunk of chunk_groups groups: it forms each
// idx itself from the raw scalar bytes (no bit matrix in memory), gathers
// the entry straight from global memory with 16-byte loads (96 bytes niels,
// 128 bytes cached) and accumulates in registers, skipping entry 0 (the
// identity): a 7-multiply mixed add for a niels entry, an 8-multiply add
// for a cached one. A template parameter picks the form. It writes one
// partial per (k, r); the caller sums the partials of a row with
// tree_reduce_lanes (the tree reduce that follows the TPU kernel too).
//
// The scalars of output o start at scalars + o * row_stride * nbytes, so a
// streamed chunk reads its slice of the whole upload in place (row_stride
// is the upload's length, not the chunk's).
//
// Signed queries run two halves of rows against the same table: a bit counts
// in the first half where the element's sign is 0 and in the second where
// it is 1 (blitzar_tpu/msm/fixed.py:667-676).
//
// Bound: integer multiplies (7 or 8 field multiplies per nonzero idx). The
// table gather reads at most the whole table once per query.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

template <int kWords>
__device__ __forceinline__ void entry_gather(const uint32_t* entry, uint32_t* buf) {
  const uint4* q = reinterpret_cast<const uint4*>(entry);
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    uint4 u = __ldg(q + i);
    buf[4 * i] = u.x;
    buf[4 * i + 1] = u.y;
    buf[4 * i + 2] = u.z;
    buf[4 * i + 3] = u.w;
  }
}

struct NielsForm {
  static constexpr int kWords = 24;
  __device__ static ge_p3 add(const ge_p3& acc, const uint32_t* buf) { return ge_madd(acc, niels_load(buf)); }
};

struct CachedForm {
  static constexpr int kWords = 32;
  __device__ static ge_p3 add(const ge_p3& acc, const uint32_t* buf) { return ge_cadd(acc, cached_load(buf)); }
};

template <class Form>
__global__ void __launch_bounds__(128)
ed_lookup_kernel(const uint32_t* table, const uint8_t* scalars, const uint8_t* signs,
                 int64_t row_stride, int nbytes, int w, int64_t groups,
                 int64_t rows_per_half, int halves, int64_t chunk_groups,
                 int64_t nchunks, point_out_ptrs out) {
  int64_t rows = rows_per_half * halves;
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= rows * nchunks) return;
  int64_t r = tid % rows;
  int64_t k = tid / rows;
  int half = (int)(r / rows_per_half);
  int64_t rem = r % rows_per_half;
  int nbits = 8 * nbytes;
  int64_t o = rem / nbits;
  int b = (int)(rem % nbits);
  const uint8_t* srow = scalars + o * row_stride * nbytes + (b >> 3);
  const uint8_t* sg = signs ? signs + o * row_stride : nullptr;
  uint32_t shift = (uint32_t)(b & 7);
  int64_t g0 = k * chunk_groups;
  int64_t g1 = g0 + chunk_groups < groups ? g0 + chunk_groups : groups;
  ge_p3 acc = ge_identity();
  uint32_t buf[Form::kWords];
  for (int64_t g = g0; g < g1; ++g) {
    uint32_t idx = 0;
    for (int j = 0; j < w; ++j) {
      int64_t i = g * w + j;
      uint32_t bit = ((uint32_t)__ldg(srow + i * nbytes) >> shift) & 1u;
      if (sg) bit &= (uint32_t)((__ldg(sg + i) == 1) == (half == 1));
      idx |= bit << j;
    }
    if (idx) {
      entry_gather<Form::kWords>(table + ((g << w) + idx) * Form::kWords, buf);
      acc = Form::add(acc, buf);
    }
  }
  ge_store(out, k * rows + r, acc);
}

// table: (groups, 2^w, 3, 8) niels words or, with cached != 0, (groups, 2^w,
// 4, 8) cached words, 16-byte aligned; scalars: O rows of n_pad elements of
// nbytes bytes, row o at o * row_stride elements; signs: O rows of n_pad
// bytes at the same row stride, or null (unsigned); out: four (16, nchunks,
// rows) int32 coordinate arrays, rows = halves * O * 8 * nbytes.
extern "C" int btt_ed_lookup_msm(const void* table, const void* scalars, const void* signs,
                                 int64_t num_outputs, int64_t n_pad, int64_t row_stride, int nbytes,
                                 int w, int cached, int64_t chunk_groups, int64_t nchunks, void* ox,
                                 void* oy, void* oz, void* ot, void* stream) {
  int halves = signs ? 2 : 1;
  int64_t rows_per_half = num_outputs * 8 * nbytes;
  int64_t threads_total = rows_per_half * halves * nchunks;
  point_out_ptrs out;
  out.c[0] = (int32_t*)ox;
  out.c[1] = (int32_t*)oy;
  out.c[2] = (int32_t*)oz;
  out.c[3] = (int32_t*)ot;
  out.limb_stride = threads_total;
  if (threads_total > 0) {
    const int threads = 128;
    int64_t blocks = (threads_total + threads - 1) / threads;
    const uint32_t* t = (const uint32_t*)table;
    const uint8_t* sc = (const uint8_t*)scalars;
    const uint8_t* sg = (const uint8_t*)signs;
    cudaStream_t s = (cudaStream_t)stream;
    if (cached) {
      ed_lookup_kernel<CachedForm><<<(unsigned)blocks, threads, 0, s>>>(
          t, sc, sg, row_stride, nbytes, w, n_pad / w, rows_per_half, halves, chunk_groups, nchunks, out);
    } else {
      ed_lookup_kernel<NielsForm><<<(unsigned)blocks, threads, 0, s>>>(
          t, sc, sg, row_stride, nbytes, w, n_pad / w, rows_per_half, halves, chunk_groups, nchunks, out);
    }
  }
  return (int)cudaGetLastError();
}
