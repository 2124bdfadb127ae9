// ristretto_encode, ristretto_decode: the ristretto255 encoding of a point
// batch and its decoding, one launch each (the bodies are
// edwards25519.cuh's ristretto_encode_s and ristretto_decode_s).
//
// No TPU kernel holds them: blitzar_tpu/curves/ristretto.py:43-99 runs them
// as plain jnp, which XLA fuses. They are the chains of field multiplies and
// squares of blitzar_tpu/ops/pallas_point.py:_fmul_tiled (:130) and
// _fsq_tiled (:144): one pow22523 (262 dependent multiplies) and 22-25 more
// a point (287 for the encode, 284 for the decode), which the plain PyTorch
// version ran as ~280 x 50 small launches.
//
// Design: one thread a point, its whole chain in registers, every multiply
// one call of the one non-inlined body fe_mul_call (fe_mul_call_op; an
// inlined chain overflows the instruction cache). Encode reads the four
// coordinates in the public layout (limbs below 2^17, any limb stride, the
// query's and the ladder's outputs as they are) and writes the 32 bytes of
// point i at out[k * count + i], so a warp's stores of byte k are
// consecutive. Decode reads the bytes the same way and writes canonical
// (x, y, 1, x y) and one valid byte a point. Bound: operations (287 or 284
// field multiplies of 144 int32 multiplies a point) at a large batch; a
// small one is the latency of one thread's chain (0.123 ms at 1-42 points
// on an H100, 0.35 ms at 2^16, 2.2x the bound: PERF.md §6).
#include <cuda_runtime.h>

#include "edwards25519.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 128;

unsigned blocks_for(int64_t count) { return (unsigned)((count + kThreads - 1) / kThreads); }

}  // namespace

// at file scope: a profiler names them so (the commitment's encode stage
// is checked to run this kernel and no other)
__global__ void __launch_bounds__(kThreads)
ristretto_encode_kernel(point_ptrs p, int64_t count, uint8_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const fe s = ristretto_encode_s(ge_load(p, i), fe_mul_call_op());
#pragma unroll
  for (int k = 0; k < 32; ++k) out[k * count + i] = (uint8_t)(s.v[k >> 2] >> (8 * (k & 3)));
}

__global__ void __launch_bounds__(kThreads)
ristretto_decode_kernel(const uint8_t* data, int64_t count, point_out_ptrs out, uint8_t* valid) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  fe bytes;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint8_t* b = data + 4 * w * count + i;
    bytes.v[w] = (uint32_t)b[0] | ((uint32_t)b[count] << 8) | ((uint32_t)b[2 * count] << 16) |
                 ((uint32_t)b[3 * count] << 24);
  }
  ge_p3 q;
  valid[i] = ristretto_decode_s(bytes, q, fe_mul_call_op());
  ge_store(out, i, q);
}

// x, y, z, t: (16, count) int32 limbs at one limb stride; out: (32, count)
// uint8, contiguous.
extern "C" int btt_ristretto_encode(const void* x, const void* y, const void* z, const void* t, int64_t limb_stride,
                                    int64_t count, void* out, void* stream) {
  if (count > 0) {
    point_ptrs p = {{(const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t}, limb_stride};
    ristretto_encode_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(p, count, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// data: (32, count) uint8, contiguous; ox, oy, oz, ot: (16, count) int32,
// contiguous; valid: count bytes (0 or 1).
extern "C" int btt_ristretto_decode(const void* data, int64_t count, void* ox, void* oy, void* oz, void* ot,
                                    void* valid, void* stream) {
  if (count > 0) {
    point_out_ptrs out = {{(int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot}, count};
    ristretto_decode_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, count, out, (uint8_t*)valid);
  }
  return (int)cudaGetLastError();
}
