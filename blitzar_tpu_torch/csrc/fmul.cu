// fmul and fsq: elementwise products in GF(2^255 - 19).
//
// Replace blitzar_tpu/ops/pallas_point.py:_fmul_tiled (:130) / fmul (:157)
// and _fsq_tiled (:144) / fsq (:162). The TPU versions take (16, m, 128)
// uint32 tiles of equal shapes; here a is any count of elements in the
// public layout (16 int32 limbs at a limb stride, csrc/fp25519.cuh:fe_load)
// and b is either as many elements or one element broadcast over a (the
// curve constants 2d, 1/2, 1/(2d) of a table conversion), as mont_mul_ew
// allows. The products are canonical 16-bit limbs, (16, count) contiguous.
//
// Design: one thread per element in a grid-stride loop over int64_t indices
// (a 2^20-point ristretto255 table has 2^25 entries, and its limb rows span
// more than 2^31 bytes); neighbouring threads read neighbouring elements of
// each limb row (coalesced); the product stays in registers (fe_mul: 64 word
// products and 8 folds, 144 int32 multiplies). Bound: bytes. The function
// moves 96 bytes an element (two 32-byte operands and a 32-byte product, 64
// for fsq); the public layout holds one 16-bit limb in each 32-bit word, so
// the kernel moves twice that.
#include <cuda_runtime.h>

#include "fp25519.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 256;
// the grid-stride loop's blocks: enough to fill 132 SMs several times over
constexpr int64_t kMaxBlocks = 132 * 32;

unsigned blocks_for(int64_t count) {
  int64_t blocks = (count + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
fmul_kernel(const int32_t* a, int64_t a_stride, const int32_t* b, int64_t b_stride, int64_t b_step,
            int64_t count, int32_t* out) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += step) {
    fe_store(out + i, count, fe_mul(fe_load(a + i, a_stride), fe_load(b + i * b_step, b_stride)));
  }
}

__global__ void __launch_bounds__(kThreads)
fsq_kernel(const int32_t* a, int64_t a_stride, int64_t count, int32_t* out) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += step) {
    fe_store(out + i, count, fe_sq(fe_load(a + i, a_stride)));
  }
}

}  // namespace

// a: (16, count) int32 limbs at a_stride; b: 16 limbs at b_stride, element i
// at b + i * b_step (b_step 0: broadcast); out: (16, count) contiguous.
extern "C" int btt_fmul(const void* a, int64_t a_stride, const void* b, int64_t b_stride, int64_t b_step,
                        int64_t count, void* out, void* stream) {
  if (count > 0) {
    fmul_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, b_step, count, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int btt_fsq(const void* a, int64_t a_stride, int64_t count, void* out, void* stream) {
  if (count > 0) {
    fsq_kernel<<<blocks_for(count), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, a_stride, count, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
