// tree_reduce_lanes: the sum of a point batch over its leading axis, in one
// launch.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_tree_tiled (:344) /
// tree_reduce_lanes (:370), Edwards and Weierstrass. A (size, cols) batch
// goes in, its cols column sums come out. The TPU kernel halves a lane axis
// level by level inside VMEM; here one block owns one column: each of its T
// threads sums a strided share of the column serially in registers
// (tree_reduce.cuh), then the block halves its T sums in shared memory, one
// level per __syncthreads(). So a query's (K, R) lookup partials and a
// streamed query's (chunks, R) products each take one launch where a tree
// of ed_add / wadd launches took ceil(log2 K).
//
// Bound: bytes at large size (each point read once; one add of 9 or 14
// field multiplies a point); with few columns (a query's 256 rows) the
// serial depth, size / T + log2 T adds, sets the time.
#include <cuda_runtime.h>

#include "tree_reduce.cuh"

using namespace btt;

template <class G>
__global__ void __launch_bounds__(128)
tree_reduce_kernel(typename G::In in, int64_t size, int64_t cols, typename G::Out out) {
  using P = typename G::P;
  extern __shared__ __align__(16) unsigned char smem[];
  P* sums = reinterpret_cast<P*>(smem);
  int64_t c = blockIdx.x;
  int t = threadIdx.x;
  int T = blockDim.x;
  sums[t] = tree_thread_sum<G>(in, size, cols, c, t, T);
  for (int h = T >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (t < h) sums[t] = G::add(sums[t], sums[t + h]);
  }
  if (t == 0) G::store(out, c, sums[0]);
}

template <class G>
static void launch_tree(const typename G::In& in, int64_t size, int64_t cols, const typename G::Out& out,
                        cudaStream_t stream) {
  int threads = tree_threads(size);
  size_t shared = (size_t)threads * sizeof(typename G::P);
  tree_reduce_kernel<G><<<(unsigned)cols, threads, shared, stream>>>(in, size, cols, out);
}

// curve: 0 ristretto255, 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin (the
// reference C ABI ids). in: the coordinate arrays (four for ristretto255,
// three otherwise; t is ignored for a Weierstrass curve) of a (size, cols)
// batch with the given limb stride; out: (nlimbs, cols) coordinate arrays.
extern "C" int btt_tree_reduce_lanes(int curve, const void* x, const void* y, const void* z, const void* t,
                                     int64_t limb_stride, int64_t size, int64_t cols, void* ox, void* oy,
                                     void* oz, void* ot, void* stream) {
  if (size <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 0) {
    point_ptrs in = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t},
                     limb_stride};
    point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, cols};
    launch_tree<EdGroup>(in, size, cols, out, s);
    return (int)cudaGetLastError();
  }
  wpoint_ptrs in = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z}, limb_stride};
  wpoint_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz}, cols};
  switch (curve) {
    case Bls12381G1::id: launch_tree<WGroup<Bls12381G1>>(in, size, cols, out, s); break;
    case Bn254G1::id: launch_tree<WGroup<Bn254G1>>(in, size, cols, out, s); break;
    case Grumpkin::id: launch_tree<WGroup<Grumpkin>>(in, size, cols, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
