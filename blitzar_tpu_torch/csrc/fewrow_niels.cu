// fewrow_niels: a few-row query's column sums on a niels table, one launch a
// query, each entry read straight from the table.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_niels_tree_tiled (:426) /
// niels_tree_reduce_lanes (:447), body _niels_tree_body_factory (:402), and
// the one-hot gather before it (blitzar_tpu/msm/fixed.py:522-592): the TPU
// query selects each (row, group)'s entry into a (chunk groups, chunks x
// rows) batch, then halves its lane axis inside VMEM. Here nothing is
// gathered first: column (k, r), row r's sum over the gc groups of table
// chunk k, forms its indices from the scalar bytes (lookup.cuh) and reads
// its entries with 16-byte __ldg loads as its adds need them.
//
// Design. A column is one warp of 32 lanes, a block of 128 threads four
// neighbouring columns (rows of one chunk, which read the same scalar
// bytes). Lane t sums its L = gc / 64 first-level sums depth first
// (niels_tree.cuh), its finished sums parked on a stack in shared memory
// (log2(L) points a thread, word-major, so a warp's accesses hit 32 banks),
// so that its registers hold one add's operands; then the warp's lanes are
// halved by shuffles of the point's 32 words. Every multiply of an add is
// one stage of the non-inlined body (fe_mul_stage_op). The order is the
// plain version's, so the sums equal it limb for limb. On the H100, 32
// lanes a column beat 64 and 128 at each 2^20 query's shape, and capping
// the kernel at 128 registers (4 blocks an SM; it takes 144) spilled and
// lost (PERF.md §6). A 2048-group chunk takes 5 stack levels, 80 KB a block.
// Bound: integer multiplies (gc/2 niels adds of 8 field multiplies and gc/2
// - 1 extended adds of 9 a column); 96 bytes read an entry.
#include <cuda_runtime.h>

#include "niels_tree.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 128;

// thread tid's stack in a block's shared memory: word i of level l at
// smem[(l * 32 + i) * kThreads + tid]
struct SharedStack {
  uint32_t* base;
  BTT_HD void put_fe(int word, const fe& a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) base[(word + i) * kThreads] = a.v[i];
  }
  BTT_HD fe get_fe(int word) const {
    fe a;
#pragma unroll
    for (int i = 0; i < 8; ++i) a.v[i] = base[(word + i) * kThreads];
    return a;
  }
  BTT_HD void push(int level, const ge_p3& p) {
    put_fe(32 * level, p.X);
    put_fe(32 * level + 8, p.Y);
    put_fe(32 * level + 16, p.Z);
    put_fe(32 * level + 24, p.T);
  }
  BTT_HD ge_p3 pop(int level) const {
    ge_p3 p;
    p.X = get_fe(32 * level);
    p.Y = get_fe(32 * level + 8);
    p.Z = get_fe(32 * level + 16);
    p.T = get_fe(32 * level + 24);
    return p;
  }
};

__device__ fe shfl_down_fe(const fe& a, int h) {
  fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_down_sync(0xffffffffu, a.v[i], h);
  return r;
}

__device__ ge_p3 shfl_down_point(const ge_p3& p, int h) {
  ge_p3 r;
  r.X = shfl_down_fe(p.X, h);
  r.Y = shfl_down_fe(p.Y, h);
  r.Z = shfl_down_fe(p.Z, h);
  r.T = shfl_down_fe(p.T, h);
  return r;
}

__global__ void __launch_bounds__(kThreads) fewrow_niels_kernel(lookup_query q, int64_t cols, point_out_ptrs out) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int t = tid % kFewrowLanes;
  const int64_t c = (int64_t)blockIdx.x * (kThreads / kFewrowLanes) + tid / kFewrowLanes;
  if (c >= cols) return;  // a whole warp: a column is one warp
  const int64_t rows = q.rows_per_half * q.halves;
  SharedStack stack = {smem + tid};
  ge_p3 cur = fewrow_lane_sum(q, lookup_row_of(q, c % rows), c / rows, t, stack);
  for (int h = kFewrowLanes / 2; h > 0; h >>= 1) {
    const ge_p3 other = shfl_down_point(cur, h);
    cur = ge_add(cur, other);
  }
  if (t == 0) ge_store(out, c, cur);
}

}  // namespace

// table: (groups, 2^w, 3, 8) niels words, 16-byte aligned; scalars:
// (num_outputs, n_pad, nbytes) uint8, output o at o * row_stride * nbytes;
// signs: (num_outputs, n_pad) uint8 at o * row_stride, or null;
// chunk_groups: a power of two in [256, 2048] dividing the group count;
// out: (16, chunks * rows) coordinate arrays, column k * rows + r.
extern "C" int btt_fewrow_niels(const void* table, const void* scalars, const void* signs, int64_t num_outputs,
                                int64_t n_pad, int64_t row_stride, int nbytes, int w, int64_t chunk_groups, void* ox,
                                void* oy, void* oz, void* ot, void* stream) {
  const int64_t groups = n_pad / w;
  if (!niels_tree_size_ok(chunk_groups) || groups % chunk_groups || n_pad % w) {
    return (int)cudaErrorInvalidValue;
  }
  lookup_query q;
  q.table = (const word4*)table;
  q.scalars = (const uint8_t*)scalars;
  q.signs = (const uint8_t*)signs;
  q.row_stride = row_stride;
  q.nbytes = nbytes;
  q.w = w;
  q.groups = groups;
  q.rows_per_half = num_outputs * 8 * nbytes;
  q.halves = signs ? 2 : 1;
  q.chunk_groups = chunk_groups;
  const int64_t cols = groups / chunk_groups * q.rows_per_half * q.halves;
  if (cols <= 0) return (int)cudaErrorInvalidValue;
  point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, cols};
  const int levels = log2_exact(chunk_groups / (2 * kFewrowLanes));
  const size_t smem = (size_t)(levels > 0 ? levels : 1) * 32 * kThreads * sizeof(uint32_t);
  const cudaError_t rc =
      cudaFuncSetAttribute(fewrow_niels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t blocks = (cols + kThreads / kFewrowLanes - 1) / (kThreads / kFewrowLanes);
  fewrow_niels_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(q, cols, out);
  return (int)cudaGetLastError();
}
