// ed_lookup_msm: the partition products of a fixed-generator query.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_lookup_tiled (:533) /
// ed_lookup_msm (:570), both of its entry forms: niels (a handle's table)
// and cached (the `ncoord == 4` branch, :519-526: a streamed chunk's table).
//
// The TPU kernel walks groups on a sequential grid and carries the sums in
// scratch across grid steps; Hopper has no sequential grid. Here block (x,
// k) owns a run of bit rows and chunk k of the groups, and each of its
// threads runs lookup.cuh's schedule for one row: it forms each index
// itself from the raw scalar bytes (no bit matrix in memory), and gathers
// only the entries its indices pick. It writes one partial per (k, r); the
// caller sums the partials of a row with tree_reduce_lanes (the tree
// reduce that follows the TPU kernel too).
//
// Gathers against staging whole slabs: a group's entries are 24 KB
// (niels) or 32 KB (cached), and a query's rows touch about 63% of them
// (256 rows of random bytes), so a slab copy would read every table byte
// where the gathers read the touched ones; the gathers need no
// __syncthreads, so a row whose indices are zero (the high bytes of small
// scalars) does not hold up the others.
//
// The chunk count K is the wrapper's (ops/cuda_point.py lookup_chunks):
// two waves of blocks, each walking a long chunk (K = 528 for 256 rows),
// where a chunk of 32 to 128 groups gave K = 1024; one wave ran slower.
//
// Bound: integer multiplies (7 or 8 field multiplies per nonzero index);
// the gathers read at most the whole table once per query.
#include <cuda_runtime.h>

#include "lookup.cuh"

using namespace btt;

// Threads a block and blocks an SM, at 128 registers a thread (about 16
// warps an SM either way), as measured on the H100: the niels query of small
// scalars has whole warps of zero rows (their high bytes), and with 256-row
// blocks every block holds its share of them, where with 128-row blocks
// some blocks idle while others work; the cached query of a streamed chunk
// ran fastest in blocks of 128.
template <class Form>
struct block_shape;
template <>
struct block_shape<NielsForm> {
  static constexpr int kThreads = 256, kMinBlocks = 2;
};
template <>
struct block_shape<CachedForm> {
  static constexpr int kThreads = 128, kMinBlocks = 4;
};

template <class Form>
__global__ void __launch_bounds__(block_shape<Form>::kThreads, block_shape<Form>::kMinBlocks)
ed_lookup_kernel(lookup_query q, int64_t rows, point_out_ptrs out) {
  const int64_t r = (int64_t)blockIdx.x * block_shape<Form>::kThreads + threadIdx.x;
  const int64_t k = blockIdx.y;
  if (r < rows) ge_store(out, k * rows + r, lookup_thread<Form>(q, k, r));
}

template <class Form>
static int launch_lookup(const lookup_query& q, int64_t rows, int64_t nchunks, const point_out_ptrs& out,
                         cudaStream_t stream) {
  constexpr int threads = block_shape<Form>::kThreads;
  dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)nchunks);
  ed_lookup_kernel<Form><<<grid, threads, 0, stream>>>(q, rows, out);
  return (int)cudaGetLastError();
}

// table: (groups, 2^w, 3, 8) niels words or, with cached != 0, (groups, 2^w,
// 4, 8) cached words, 16-byte aligned; scalars: O rows of n_pad elements of
// nbytes bytes, row o at o * row_stride elements; signs: O rows of n_pad
// bytes at the same row stride, or null (unsigned); out: four (16, nchunks,
// rows) int32 coordinate arrays, rows = halves * O * 8 * nbytes; nchunks at
// most 65535.
extern "C" int btt_ed_lookup_msm(const void* table, const void* scalars, const void* signs,
                                 int64_t num_outputs, int64_t n_pad, int64_t row_stride, int nbytes,
                                 int w, int cached, int64_t chunk_groups, int64_t nchunks, void* ox,
                                 void* oy, void* oz, void* ot, void* stream) {
  lookup_query q;
  q.table = (const word4*)table;
  q.scalars = (const uint8_t*)scalars;
  q.signs = (const uint8_t*)signs;
  q.row_stride = row_stride;
  q.nbytes = nbytes;
  q.w = w;
  q.groups = n_pad / w;
  q.halves = signs ? 2 : 1;
  q.rows_per_half = num_outputs * 8 * nbytes;
  q.chunk_groups = chunk_groups;
  const int64_t rows = q.rows_per_half * q.halves;
  if (nchunks > 65535) return (int)cudaErrorInvalidValue;
  point_out_ptrs out;
  out.c[0] = (int32_t*)ox;
  out.c[1] = (int32_t*)oy;
  out.c[2] = (int32_t*)oz;
  out.c[3] = (int32_t*)ot;
  out.limb_stride = rows * nchunks;
  if (rows * nchunks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return cached ? launch_lookup<CachedForm>(q, rows, nchunks, out, s)
                : launch_lookup<NielsForm>(q, rows, nchunks, out, s);
}
