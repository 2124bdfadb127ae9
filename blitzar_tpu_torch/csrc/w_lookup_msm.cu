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
// grid, and a gather needs no matrix unit. The design of ed_lookup_msm.cu
// carries over: thread (k, r) owns row r and the k-th chunk of chunk_groups
// groups; it forms each idx from the raw scalar bytes, gathers the 3K-word
// projective entry with 16-byte loads and accumulates with w_add in
// registers, skipping entry 0 (the identity; the rows of a counter scalar's
// zero upper bytes select nothing else). It writes one partial per (k, r);
// the caller sums the partials of a row with tree_reduce_lanes. Output o's
// scalars start at o * row_stride elements, so a streamed chunk reads its
// slice of the whole upload in place.
//
// Signed queries run two halves of rows against the same table: a bit counts
// in the first half where the element's sign is 0 and in the second where
// it is 1 (blitzar_tpu/msm/fixed.py:667-676).
//
// Bound: integer multiplies (14 field multiplies per nonzero idx). The
// gather reads at most the whole table once per query.
#include <cuda_runtime.h>

#include "weierstrass.cuh"

using namespace btt;

template <class C>
__device__ __forceinline__ wpoint<C> w_gather(const uint32_t* entry) {
  constexpr int E = 3 * C::F::K;  // 24 or 36 words: 6 or 9 16-byte loads
  const uint4* q = reinterpret_cast<const uint4*>(entry);
  uint32_t buf[E];
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    uint4 u = __ldg(q + i);
    buf[4 * i] = u.x;
    buf[4 * i + 1] = u.y;
    buf[4 * i + 2] = u.z;
    buf[4 * i + 3] = u.w;
  }
  return w_entry_load<C>(buf);
}

template <class C>
__global__ void __launch_bounds__(128)
w_lookup_kernel(const uint32_t* table, const uint8_t* scalars, const uint8_t* signs,
                int64_t row_stride, int nbytes, int w, int64_t groups, int64_t rows_per_half,
                int halves, int64_t chunk_groups, int64_t nchunks, wpoint_out_ptrs out) {
  constexpr int E = 3 * C::F::K;
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
  wpoint<C> acc = w_identity<C>();
  for (int64_t g = g0; g < g1; ++g) {
    uint32_t idx = 0;
    for (int j = 0; j < w; ++j) {
      int64_t i = g * w + j;
      uint32_t bit = ((uint32_t)__ldg(srow + i * nbytes) >> shift) & 1u;
      if (sg) bit &= (uint32_t)((__ldg(sg + i) == 1) == (half == 1));
      idx |= bit << j;
    }
    if (idx) acc = w_add<C>(acc, w_gather<C>(table + ((g << w) + idx) * E));
  }
  w_store<C>(out, k * rows + r, acc);
}

template <class C>
static void launch_lookup(const uint32_t* table, const uint8_t* scalars, const uint8_t* signs,
                          int64_t n_pad, int64_t row_stride, int nbytes, int w, int64_t rows_per_half,
                          int halves, int64_t chunk_groups, int64_t nchunks, wpoint_out_ptrs out,
                          cudaStream_t stream) {
  const int threads = 128;
  int64_t total = rows_per_half * halves * nchunks;
  int64_t blocks = (total + threads - 1) / threads;
  w_lookup_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(
      table, scalars, signs, row_stride, nbytes, w, n_pad / w, rows_per_half, halves, chunk_groups,
      nchunks, out);
}

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. table: (groups, 2^w, 3, K)
// words, 16-byte aligned; scalars: O rows of n_pad elements of nbytes bytes,
// row o at o * row_stride elements; signs: O rows of n_pad bytes at the same
// row stride, or null (unsigned); out: three (2K, nchunks, rows) int32
// coordinate arrays, rows = halves * O * 8 * nbytes.
extern "C" int btt_w_lookup_msm(int curve, const void* table, const void* scalars,
                                const void* signs, int64_t num_outputs, int64_t n_pad,
                                int64_t row_stride, int nbytes, int w, int64_t chunk_groups,
                                int64_t nchunks, void* ox, void* oy, void* oz, void* stream) {
  int halves = signs ? 2 : 1;
  int64_t rows_per_half = num_outputs * 8 * nbytes;
  int64_t total = rows_per_half * halves * nchunks;
  wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, total};
  if (total > 0) {
    const uint32_t* t = (const uint32_t*)table;
    const uint8_t* sc = (const uint8_t*)scalars;
    const uint8_t* sg = (const uint8_t*)signs;
    cudaStream_t s = (cudaStream_t)stream;
    switch (curve) {
      case Bls12381G1::id:
        launch_lookup<Bls12381G1>(t, sc, sg, n_pad, row_stride, nbytes, w, rows_per_half, halves, chunk_groups,
                                  nchunks, out, s);
        break;
      case Bn254G1::id:
        launch_lookup<Bn254G1>(t, sc, sg, n_pad, row_stride, nbytes, w, rows_per_half, halves, chunk_groups,
                               nchunks, out, s);
        break;
      case Grumpkin::id:
        launch_lookup<Grumpkin>(t, sc, sg, n_pad, row_stride, nbytes, w, rows_per_half, halves, chunk_groups,
                                nchunks, out, s);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
