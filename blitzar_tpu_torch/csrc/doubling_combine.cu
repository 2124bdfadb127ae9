// doubling_combine: out[o] = sum_b 2^b * products[o, b].
//
// Replaces blitzar_tpu/ops/pallas_point.py:_combine_tiled (:982) /
// doubling_combine (:1000). A double-and-add ladder from bit nbits - 1 down
// (blitzar_tpu/msm/fixed.py:611-623), one thread per output.
//
// Bound: latency, not throughput. Each output is a serial chain of
// nbits - 1 doublings and additions (~20 dependent field multiplies per
// bit), and a query has only O outputs, so the card is nearly idle while it
// runs. Splitting the ladder across threads is left for a later change.
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

__global__ void doubling_combine_kernel(point_ptrs products, int64_t num_outputs, int nbits,
                                        point_out_ptrs out) {
  int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= num_outputs) return;
  int64_t base = o * nbits;
  ge_p3 acc = ge_load(products, base + nbits - 1);
  for (int b = nbits - 2; b >= 0; --b) {
    acc = ge_double(acc);
    acc = ge_add(acc, ge_load(products, base + b));
  }
  ge_store(out, o, acc);
}

// products: four (16, O, nbits) int32 coordinate arrays with the given limb
// stride; out: four (16, O) arrays.
extern "C" int btt_doubling_combine(const void* x, const void* y, const void* z, const void* t,
                                    int64_t limb_stride, int64_t num_outputs, int nbits,
                                    void* ox, void* oy, void* oz, void* ot, void* stream) {
  point_ptrs in;
  in.c[0] = (const int32_t*)x;
  in.c[1] = (const int32_t*)y;
  in.c[2] = (const int32_t*)z;
  in.c[3] = (const int32_t*)t;
  in.limb_stride = limb_stride;
  point_out_ptrs out;
  out.c[0] = (int32_t*)ox;
  out.c[1] = (int32_t*)oy;
  out.c[2] = (int32_t*)oz;
  out.c[3] = (int32_t*)ot;
  out.limb_stride = num_outputs;
  if (num_outputs > 0) {
    const int threads = 32;
    int64_t blocks = (num_outputs + threads - 1) / threads;
    doubling_combine_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        in, num_outputs, nbits, out);
  }
  return (int)cudaGetLastError();
}
