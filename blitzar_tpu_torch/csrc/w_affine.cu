// w_affine: a chunk of a Weierstrass table (bn254 G1, Grumpkin, bls12-381
// G1) to the affine rows of the reference's raw file, in one launch.
//
// Replaces, on the files path, the batch inversion that ran on
// blitzar_tpu/ops/pallas_point.py:mont_mul_ew (:1139, body :1128): 3 x 255
// scan launches over rows of 256 entries a chunk, each row's total inverted
// in plain PyTorch, then x / z and y / z (two more launches) and the word
// conversions. It computes blitzar_tpu/msm/interop.py:_w_affine_xy (two
// associative scans in plain jnp) and the row format of :100-113
// (w_affine.cuh).
//
// Design: one thread inverts the z of its own `per` entries, thread t of a
// warp entries t + 32 j of the warp's tile of 32 x per, so every step of a
// sweep reads 32 neighbouring entries. w_affine.cuh's forward sweep parks
// the prefixes in the rows the thread writes later; one inversion of the
// thread's product (mf_inv, ~380 multiplies for the 254-bit fields, ~570
// for bls12-381) and the backward sweep write the rows. The inversions
// weigh less the more entries a thread takes, the card fills less: per is
// the chunk over 2^15 threads, a power of two in 32..128 (128 for the
// 2^22-entry chunks of a table's conversion, 32 for the 2^18 of a w = 16
// file of 64 generators). Every multiply calls one non-inlined Montgomery
// body (mf_mul_call). Bound: operations, 5 field multiplies an entry and
// one inversion a chunk (the bytes, 3K words read and 2K written an entry,
// take less at the card's rate).
//
// Measured against the other layouts (PERF.md §6), at a bn254 G1 2^22
// chunk: 128 entries a thread 12% less than 64; in another run, 64 entries
// a thread 1.4x less than 32 and 1.6x and 4.9x less than warps of 32- or
// 8-entry lanes sharing one inversion by a shuffle scan (which runs on
// every lane). At a 2^18 chunk 32 entries a thread beat 64 by 1.3x, 64
// beat 128 by 1.5x. Inlined multiplies tied at 64 on bn254 G1 and lost
// 16% on bls12-381 G1.
#include <cuda_runtime.h>

#include "w_affine.cuh"

using namespace btt;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetThreads = 1 << 15;

// kPer a compile-time constant: with a run-time count the bls12-381
// instantiation spilled
template <class F, int kPer>
__global__ void __launch_bounds__(kThreads) w_affine_kernel(const uint32_t* entries, int64_t count, uint32_t* rows) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * 32 * kPer;
  const int64_t left = count - tile - lane;
  if (left <= 0) return;
  const int n = (int)(left < 32LL * kPer ? (left + 31) / 32 : kPer);
  affine_entries<F, mf_mul_call_op<F>>(entries, rows, tile + lane, 32, n);
}

template <class F, int kPer>
void launch_per(const uint32_t* entries, int64_t count, uint32_t* rows, cudaStream_t stream) {
  const int64_t threads = (count + 32LL * kPer - 1) / (32LL * kPer) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  w_affine_kernel<F, kPer><<<(unsigned)blocks, kThreads, 0, stream>>>(entries, count, rows);
}

template <class F>
void launch(const uint32_t* entries, int64_t count, uint32_t* rows, cudaStream_t stream) {
  if (count <= 32 * kTargetThreads) {
    launch_per<F, 32>(entries, count, rows, stream);
  } else if (count <= 64 * kTargetThreads) {
    launch_per<F, 64>(entries, count, rows, stream);
  } else {
    launch_per<F, 128>(entries, count, rows, stream);
  }
}

}  // namespace

// curve: 1 bls12-381 G1, 2 bn254 G1, 3 Grumpkin. entries: (count, 3, K)
// 32-bit words, 16-byte aligned; rows: (count, 2K) words.
extern "C" int btt_w_affine(int curve, const void* entries, int64_t count, void* rows, void* stream) {
  if (count > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* e = (const uint32_t*)entries;
    uint32_t* r = (uint32_t*)rows;
    switch (curve) {
      case Bls12381G1::id: launch<Bls12381Fp>(e, count, r, s); break;
      case Bn254G1::id: launch<Bn254Fp>(e, count, r, s); break;
      case Grumpkin::id: launch<Bn254Fr>(e, count, r, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
