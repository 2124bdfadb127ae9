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

// edwards25519.cuh's unified add with every multiply inlined in the
// formula's own order. On this chain of dependent adds it compiles to 128
// registers and runs faster than ge_add's staged form with fe_mul_op (106
// registers): 1.673-1.686 ms against 1.757 ms at one output's 256 products
// (kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W).
__device__ __forceinline__ ge_p3 ladder_add(const ge_p3& p, const ge_p3& q) {
  fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe c = fe_mul(fe_mul(p.T, q.T), fe_d2());
  fe d = fe_mul_small(fe_mul(p.Z, q.Z), 2);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge_p3 r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

__global__ void doubling_combine_kernel(point_ptrs products, int64_t num_outputs, int nbits,
                                        point_out_ptrs out) {
  int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= num_outputs) return;
  int64_t base = o * nbits;
  ge_p3 acc = ge_load(products, base + nbits - 1);
  for (int b = nbits - 2; b >= 0; --b) {
    acc = ge_double(acc);
    acc = ladder_add(acc, ge_load(products, base + b));
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
