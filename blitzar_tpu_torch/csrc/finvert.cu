// finvert: elementwise inversion a^(p - 2) in GF(2^255 - 19), 0 -> 0, by a
// batch inversion.
//
// Replaces blitzar_tpu/ops/pallas_point.py:_finvert_tiled (:172) / finvert
// (:185), which takes (16, m, 128) uint32 tiles and runs the whole chain on
// every element; here any count of elements in the public layout (16 int32
// limbs at a limb stride), canonical 16-bit limbs out, (16, count)
// contiguous.
//
// Design. Thread t of a warp inverts elements t + 32 j of the warp's tile
// of 32 x per by Montgomery's trick (field_batch.cuh, the sweep ed_to_niels
// runs): the prefixes parked in the output, one fe_invert a thread, three
// multiplies an element, every multiply a call of the one non-inlined body
// fe_mul_call. An element whose canonical value is 0 (p, 2p and any limbs
// that reduce to 0) is left out of the product and written as 0. per is a
// compile-time 16, 32 or 64 (a run-time count spilled in w_affine), picked
// by the count to keep the card full: 16 up to 2^19 elements, 32 up to
// 2^20, 64 above (PERF.md §6). Bound: operations at the function's least
// work, three multiplies an element and one inversion.
#include <cuda_runtime.h>

#include "field_batch.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 256;
// threads the counts per aims for: about 2^15, a wave of the card
constexpr int64_t kTargetThreads = 1 << 15;

template <int kPer>
__global__ void __launch_bounds__(kThreads)
finvert_kernel(const int32_t* a, int64_t a_stride, int64_t count, int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * 32 * kPer;
  const int64_t left = count - tile - lane;
  if (left <= 0) return;
  const int n = (int)(left < 32LL * kPer ? (left + 31) / 32 : kPer);
  invert_elements<fe_mul_call_op>(a, a_stride, out, count, tile + lane, 32, n);
}

template <int kPer>
void launch(const int32_t* a, int64_t a_stride, int64_t count, int32_t* out, cudaStream_t stream) {
  const int64_t threads = (count + 32LL * kPer - 1) / (32LL * kPer) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  finvert_kernel<kPer><<<(unsigned)blocks, kThreads, 0, stream>>>(a, a_stride, count, out);
}

}  // namespace

// a: (16, count) int32 limbs at a_stride; out: (16, count) contiguous.
extern "C" int btt_finvert(const void* a, int64_t a_stride, int64_t count, void* out, void* stream) {
  if (count > 0) {
    const int32_t* in = (const int32_t*)a;
    int32_t* o = (int32_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (count <= 16 * kTargetThreads) {
      launch<16>(in, a_stride, count, o, s);
    } else if (count <= 32 * kTargetThreads) {
      launch<32>(in, a_stride, count, o, s);
    } else {
      launch<64>(in, a_stride, count, o, s);
    }
  }
  return (int)cudaGetLastError();
}
