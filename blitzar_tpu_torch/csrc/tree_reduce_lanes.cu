// tree_reduce_lanes: the sum of a point batch over its leading axis, in one
// launch.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_tree_tiled (:344) /
// tree_reduce_lanes (:370), Edwards and Weierstrass. A (size, cols) batch
// goes in, its cols column sums come out. The TPU kernel halves a lane axis
// level by level inside VMEM; Hopper has no VMEM that holds a column, and
// its blocks run side by side, so here:
//
// - lanes of a warp take neighbouring columns (tree_reduce.cuh's
//   tree_shape): a warp reads each limb row of 32 points as one 128-byte
//   line, where a block a column read a 4-byte word a 32-byte sector;
// - warps, and with few columns several blocks of a column tile, take
//   shares of the leading axis, so a launch fills the card at every shape
//   the paths give it (a query's (K, R) partials, a streamed query's
//   (chunks, R) products, the bucket engine's slabs, a one-column sum);
//   a small batch instead narrows its warps to fewer columns, so that one
//   block holds a whole column and no block waits on another;
// - each thread adds its strided share serially, then the block halves
//   its threads' sums in shared memory (word-major, no bank conflicts), one
//   level a __syncthreads(), the level's adds in its lowest warps; where
//   blocks share a tile, each parks its sum in scratch and the last block
//   of the tile to finish (a counter per tile; the order of the additions
//   does not depend on which block that is) halves the blocks' sums, in
//   the order tree_reduce.cuh gives;
// - the adds call non-inlined multiply bodies, but for a small batch's
//   ristretto255 adds (tree_reduce.cuh's EdGroup::Small).
//
// Bound: operations (one add of 9 or 14 field multiplies a point) and
// bytes (each point read once) are close at a query's (K, R) partials; the
// last levels of the tree run on few threads, so a small batch costs the
// latency of ~log2(size) dependent adds.
#include <cuda_runtime.h>

#include "tree_reduce.cuh"

using namespace btt;

template <class G>
__device__ __forceinline__ void park(uint32_t* base, int64_t stride, int64_t i, typename G::P v) {
  const uint32_t* w = point_words<G>(v);
#pragma unroll
  for (int k = 0; k < G::kWords; ++k) base[k * stride + i] = w[k];
}

// L2: a sum another block parked in scratch is read past the SM's L1
template <class G, bool L2 = false>
__device__ __forceinline__ typename G::P unpark(const uint32_t* base, int64_t stride, int64_t i) {
  typename G::P v;
  uint32_t* w = point_words<G>(v);
#pragma unroll
  for (int k = 0; k < G::kWords; ++k) w[k] = L2 ? __ldcg(base + k * stride + i) : base[k * stride + i];
  return v;
}

// scratch: the tiles' counters, then (splits, kWords, cols) words
template <class G>
__global__ void __launch_bounds__(kTreeMaxWarps * 32, G::kMinBlocks)
tree_reduce_kernel(typename G::In in, int64_t size, int64_t cols, tree_shape sh, unsigned* counters,
                   uint32_t* sums, typename G::Out out) {
  using P = typename G::P;
  extern __shared__ __align__(16) uint32_t parked[];  // kWords x blockDim.x
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = lane / sh.cw + sh.rw * (tid >> 5);
  const int64_t tile = blockIdx.x;
  const int64_t split = blockIdx.y;
  const int64_t c = tile * sh.cw + lane % sh.cw;
  const bool live = c < cols;

  const int64_t t = j + sh.slots * split;
  P v = live ? tree_thread_sum<G>(in, size, cols, c, t, sh.T) : G::identity();
  // the block's levels: thread j parks at the level h with h <= j < 2h,
  // once, so no slot is written twice
  for (int h = sh.slots >> 1; h > 0; h >>= 1) {
    if (live && j >= h && j < 2 * h) park<G>(parked, blockDim.x, tid, v);
    __syncthreads();
    if (live && j < h && t + h < size) v = G::add(v, unpark<G>(parked, blockDim.x, tid + sh.cw * h));
  }
  if (sh.splits == 1) {
    if (live && j == 0) G::store(out, c, v);
    return;
  }

  // the tile's blocks: park this block's sum; the last block adds them
  const int64_t stride = (int64_t)G::kWords * cols;
  if (live && j == 0) park<G>(sums + split * stride, cols, c, v);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[tile], 1u) == (unsigned)(sh.splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int64_t h = sh.splits >> 1; h > 0; h >>= 1) {
    for (int64_t m = j; m < h && live && sh.slots * (m + h) < size; m += sh.slots) {
      uint32_t* lo = sums + m * stride;
      const P a = unpark<G, true>(lo, cols, c);
      const P b = unpark<G, true>(lo + h * stride, cols, c);
      park<G>(lo, cols, c, G::add(a, b));
    }
    __syncthreads();
  }
  if (live && j == 0) G::store(out, c, unpark<G, true>(sums, cols, c));
}

// bytes of scratch a launch needs: 0 when each column tile has one block
template <class G>
static int64_t scratch_bytes(int64_t size, int64_t cols) {
  const tree_shape sh = tree_shape_of(size, cols);
  if (sh.splits == 1) return 0;
  return 16 * ((4 * sh.tiles + 15) / 16) + 4 * sh.splits * G::kWords * cols;
}

// a small batch runs G::Small (tree_reduce.cuh)
template <class G>
static int launch_tree(const typename G::In& in, int64_t size, int64_t cols, const typename G::Out& out,
                       void* scratch, int64_t scratch_size, cudaStream_t stream) {
  const tree_shape sh = tree_shape_of(size, cols);
  const int64_t need = scratch_bytes<G>(size, cols);
  if (scratch_size < need || (need && !scratch)) return (int)cudaErrorInvalidValue;
  unsigned* counters = (unsigned*)scratch;
  uint32_t* sums = need ? (uint32_t*)((char*)scratch + 16 * ((4 * sh.tiles + 15) / 16)) : nullptr;
  if (need) {
    cudaError_t err = cudaMemsetAsync(counters, 0, 4 * sh.tiles, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned threads = 32u * sh.warps;
  const size_t shared = (size_t)threads * 4 * G::kWords;
  dim3 grid((unsigned)sh.tiles, (unsigned)sh.splits);
  if (tree_small(size, cols)) {
    tree_reduce_kernel<typename G::Small><<<grid, threads, shared, stream>>>(in, size, cols, sh, counters, sums, out);
  } else {
    tree_reduce_kernel<G><<<grid, threads, shared, stream>>>(in, size, cols, sh, counters, sums, out);
  }
  return (int)cudaGetLastError();
}

static int64_t curve_scratch_bytes(int curve, int64_t size, int64_t cols) {
  switch (curve) {
    case 0: return scratch_bytes<EdGroup>(size, cols);
    case Bls12381G1::id: return scratch_bytes<WGroup<Bls12381G1>>(size, cols);
    case Bn254G1::id: return scratch_bytes<WGroup<Bn254G1>>(size, cols);
    case Grumpkin::id: return scratch_bytes<WGroup<Grumpkin>>(size, cols);
    default: return -1;
  }
}

// Writes to *bytes the scratch btt_tree_reduce_lanes needs for this curve
// and shape; returns cudaErrorInvalidValue for an unknown curve.
extern "C" int btt_tree_reduce_scratch(int curve, int64_t size, int64_t cols, int64_t* bytes) {
  const int64_t need = size <= 0 || cols <= 0 ? 0 : curve_scratch_bytes(curve, size, cols);
  if (need < 0) return (int)cudaErrorInvalidValue;
  *bytes = need;
  return 0;
}

// curve: 0 ristretto255, 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin (the
// reference C ABI ids). in: the coordinate arrays (four for ristretto255,
// three otherwise; t is ignored for a Weierstrass curve) of a (size, cols)
// batch with the given limb stride; out: (nlimbs, cols) coordinate arrays;
// scratch: btt_tree_reduce_scratch(curve, size, cols) bytes, 16-byte
// aligned (null when that is 0).
extern "C" int btt_tree_reduce_lanes(int curve, const void* x, const void* y, const void* z, const void* t,
                                     int64_t limb_stride, int64_t size, int64_t cols, void* ox, void* oy,
                                     void* oz, void* ot, void* scratch, int64_t scratch_size, void* stream) {
  if (size <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 0) {
    point_ptrs in = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t},
                     limb_stride};
    point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, cols};
    return launch_tree<EdGroup>(in, size, cols, out, scratch, scratch_size, s);
  }
  wpoint_ptrs in = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z}, limb_stride};
  wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, cols};
  switch (curve) {
    case Bls12381G1::id: return launch_tree<WGroup<Bls12381G1>>(in, size, cols, out, scratch, scratch_size, s);
    case Bn254G1::id: return launch_tree<WGroup<Bn254G1>>(in, size, cols, out, scratch, scratch_size, s);
    case Grumpkin::id: return launch_tree<WGroup<Grumpkin>>(in, size, cols, out, scratch, scratch_size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
