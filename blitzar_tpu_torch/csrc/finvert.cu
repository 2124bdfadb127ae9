// finvert: elementwise inversion a^(p - 2) in GF(2^255 - 19), 0 -> 0.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_finvert_tiled (:172) / finvert
// (:185), which takes (16, m, 128) uint32 tiles; here any count of elements
// in the public layout (16 int32 limbs at a limb stride), canonical 16-bit
// limbs out, (16, count) contiguous.
//
// Design: one thread per element in a grid-stride loop over int64_t
// indices; the whole chain (csrc/fp25519.cuh:fe_invert: 254 squarings and 11
// multiplies, blitzar_tpu's _pow_chain_250) runs in registers, so an element
// is read once and written once. Bound: operations. The least work that
// inverts a batch is Montgomery's trick (three multiplies an element and one
// inversion for the whole batch), so this kernel, 265 multiplies an element,
// sits about 90x above that bound: it serves the inversions that are
// elementwise by nature (a generator cache's z, a batch inversion's row
// totals).
#include <cuda_runtime.h>

#include "fp25519.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__global__ void __launch_bounds__(kThreads)
finvert_kernel(const int32_t* a, int64_t a_stride, int64_t count, int32_t* out) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += step) {
    fe_store(out + i, count, fe_invert(fe_load(a + i, a_stride)));
  }
}

}  // namespace

// a: (16, count) int32 limbs at a_stride; out: (16, count) contiguous.
extern "C" int btt_finvert(const void* a, int64_t a_stride, int64_t count, void* out, void* stream) {
  if (count > 0) {
    int64_t blocks = (count + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    finvert_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, a_stride, count, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
