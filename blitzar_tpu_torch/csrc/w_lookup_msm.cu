// w_lookup_msm: the partition products of a Weierstrass fixed-generator query.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_w_lookup_tiled (:636) /
// w_lookup_msm (:669). For bit-row r (output o, scalar bit b) and group g,
// idx[r, g] = sum_j bit_b(scalar[o, g*w + j]) << j picks table entry
// (g, idx); row r's product is the sum over g of those entries, with the
// complete addition.
//
// The TPU kernel streams table tiles through VMEM on a sequential grid,
// selects entries with a one-hot product on the matrix unit from a bf16
// byte-split table and carries sums in scratch. Hopper has no sequential
// grid, and a gather needs no matrix unit. Block (x, k) owns a run of bit
// rows and chunk k of the groups, and each of its threads runs lookup.cuh's
// schedule for one row with the Weierstrass entry form (WForm): it forms
// each index from the raw scalar bytes, gathers the 3K-word projective
// entry with 16-byte loads and accumulates with the complete add, skipping
// entry 0 (the identity; the rows of a counter scalar's zero upper bytes
// select nothing else). It writes one partial per (k, r); the caller sums
// the partials of a row with tree_reduce_lanes. Output o's scalars start at
// o * row_stride elements, so a streamed chunk reads its slice of the whole
// upload in place. Signed queries run two halves of rows against the same
// table (blitzar_tpu/msm/fixed.py:667-676).
//
// What the design does about its bound, integer multiplies (12 field
// multiplies per nonzero index; the gather reads at most the whole table
// once per query):
// - the two multiplies by 3b in each add are additions (weierstrass.cuh);
// - every multiply calls one non-inlined Montgomery body (mf_mul_call_op),
//   where fourteen inlined bodies overflowed the registers (146-150);
// - the chunk count K is the wrapper's (ops/cuda_point.py lookup_chunks,
//   the rule of ed_lookup_msm): two waves of (chunk, row) threads, each
//   walking a long chunk, so the tree reduce after it reads few partials;
// - rows in 256-thread blocks: a counter scalar's zero upper bytes leave
//   whole warps of rows with nothing to add, and every block holds its
//   share of them.
#include <cuda_runtime.h>

#include "lookup.cuh"

using namespace btt;

// Threads a block, and blocks an SM the registers must leave room for: two
// at 8 words a field element (126 registers on the H100's compiler, no
// spill), one at 12 (190). Blocks of 128 rows (four an SM at 8 words, two
// at 12) ran the bn254 G1 2^20 query slower (PERF.md §6).
template <class C>
struct w_block_shape {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = C::F::K == 8 ? 2 : 1;
};

template <class C>
__global__ void __launch_bounds__(w_block_shape<C>::kThreads, w_block_shape<C>::kMinBlocks)
w_lookup_kernel(lookup_query q, int64_t rows, wpoint_out_ptrs out) {
  const int64_t r = (int64_t)blockIdx.x * w_block_shape<C>::kThreads + threadIdx.x;
  const int64_t k = blockIdx.y;
  if (r < rows) w_store<C>(out, k * rows + r, lookup_thread<WForm<C>>(q, k, r));
}

template <class C>
static int launch_lookup(const lookup_query& q, int64_t rows, int64_t nchunks, const wpoint_out_ptrs& out,
                         cudaStream_t stream) {
  constexpr int threads = w_block_shape<C>::kThreads;
  dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)nchunks);
  w_lookup_kernel<C><<<grid, threads, 0, stream>>>(q, rows, out);
  return (int)cudaGetLastError();
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. table: (groups, 2^w, 3, K)
// words, 16-byte aligned; scalars: O rows of n_pad elements of nbytes bytes,
// row o at o * row_stride elements; signs: O rows of n_pad bytes at the same
// row stride, or null (unsigned); out: three (2K, nchunks, rows) int32
// coordinate arrays, rows = halves * O * 8 * nbytes; nchunks at most 65535.
extern "C" int btt_w_lookup_msm(int curve, const void* table, const void* scalars,
                                const void* signs, int64_t num_outputs, int64_t n_pad,
                                int64_t row_stride, int nbytes, int w, int64_t chunk_groups,
                                int64_t nchunks, void* ox, void* oy, void* oz, void* stream) {
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
  const wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, rows * nchunks};
  if (rows * nchunks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (curve) {
    case Bls12381G1::id: return launch_lookup<Bls12381G1>(q, rows, nchunks, out, s);
    case Bn254G1::id: return launch_lookup<Bn254G1>(q, rows, nchunks, out, s);
    case Grumpkin::id: return launch_lookup<Grumpkin>(q, rows, nchunks, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
