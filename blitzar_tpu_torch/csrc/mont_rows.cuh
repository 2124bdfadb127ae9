// The proofs' ABI rows to Montgomery limbs (mont_rows.cu): the block
// schedule and the body of one element, __host__ __device__ so that the
// host harness runs the very code the kernel runs.
//
// Input: (num_mles * n, nbytes) uint8 little-endian rows, C-contiguous,
// nbytes <= 4K, MLE k's rows k n .. k n + n - 1. Output: the (2K, num_mles,
// n_pad) int32 radix-2^16 table, canonical, element (k, c) at
// out[l * num_mles * n_pad + k * n_pad + c] for limb l, zero in every
// column c >= n. Each element is its row's value (below 2^(8 nbytes) <= R)
// times a canonical constant, then R^-1 (mont.cuh:mf_mul takes any K-word
// a below R): R^2 mod m turns a standard-form value into its reduced
// Montgomery form, R mod m a Montgomery residue into the same element,
// canonical.
//
// A block takes kRowsThreads columns of one MLE. Their rows are one run of
// bytes [g0, g1) of the input; the block stages it into shared memory from
// a0 = g0 rounded down to 16, 16 bytes a thread at a time (neighbouring
// threads on neighbouring 16 bytes: coalesced), and each thread then reads
// its own row there. Each thread writes its element's 2K limbs, one limb
// row apart: a warp's store of a limb is 32 consecutive words.
#pragma once

#include "mont.cuh"

namespace btt {

constexpr int kRowsThreads = 256;  // columns (elements) a block
constexpr int kRowsMaxBytes = 32;  // the widest row the kernel takes (4K for K = 8)
// the staged bytes of a block at most: its rows and the 15 bytes before g0
constexpr int kRowsStageBytes = kRowsThreads * kRowsMaxBytes + 16;

// The run of input bytes block `block` stages, and which columns it takes.
struct rows_span {
  int64_t mle;    // the block's MLE
  int64_t first;  // its first column
  int64_t live;   // its columns that have a row (below n): 0..kRowsThreads
  int64_t a0;     // staged bytes [a0, a1) of the input; a0 a multiple of 16
  int64_t a1;
  int skew;       // the first row's byte in the staged run: g0 - a0
};

BTT_HD rows_span rows_span_of(int64_t block, int64_t col_blocks, int64_t n, int nbytes) {
  rows_span s;
  s.mle = block / col_blocks;
  s.first = (block % col_blocks) * kRowsThreads;
  const int64_t last = s.first + kRowsThreads < n ? s.first + kRowsThreads : n;
  s.live = last > s.first ? last - s.first : 0;
  const int64_t g0 = (s.mle * n + s.first) * nbytes;
  s.a0 = g0 & ~(int64_t)15;
  s.a1 = g0 + s.live * nbytes;
  s.skew = (int)(g0 - s.a0);
  return s;
}

// A row's nbytes little-endian bytes -> K words, the missing high bytes
// zero; four bytes a load where the row and its width allow.
template <class F>
BTT_HD mfe<F> mf_from_row(const uint8_t* row, int nbytes) {
  mfe<F> r;
  if ((((uintptr_t)row) & 3) == 0 && (nbytes & 3) == 0) {
    const uint32_t* words = (const uint32_t*)row;
#pragma unroll
    for (int k = 0; k < F::K; ++k) r.v[k] = 4 * k < nbytes ? words[k] : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < F::K; ++k) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * k + b < nbytes) w |= (uint32_t)row[4 * k + b] << (8 * b);
      }
      r.v[k] = w;
    }
  }
  return r;
}

// Column `col` of the table from its row (null past n): the row's value
// times scale times R^-1, or 0.
template <class F>
BTT_HD mfe<F> mont_row_element(const uint8_t* row, int nbytes, const mfe<F>& scale) {
  return row ? mf_mul<F>(mf_from_row<F>(row, nbytes), scale) : mf_zero<F>();
}

}  // namespace btt
