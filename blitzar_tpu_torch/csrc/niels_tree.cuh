// The per-thread part of niels_tree_reduce_lanes.cu: the sum of a column of
// niels table entries down to one of 128 lanes, in the order of the plain
// version (ops/cuda_point.py:niels_tree_reduce_lanes_plain), which the host
// harness (host_harness.cpp) runs too, so the CPU tests check the kernel's
// arithmetic and its order of additions.
//
// A (size, cols) batch of entries, size a power of two above 128: entry
// (s, c) is 24 consecutive words (a | b | 2d*t, as a table stores them) at
// (s * cols + c) * 24. The first level adds entries s and s + size/2 by
// ge_niels_add; each later level adds extended points s and s + half, until
// 128 lanes are left. Lane t gathers the entries t + 128 j: its leaves j =
// 0 .. L - 1 (L = size / 256) are the first level's sums, and its halving
// levels pair leaf j with leaf j + h, which tree_sum<J, D> forms depth first,
// so that at most log2(L) + 1 points are live in registers.
#pragma once

#include "edwards25519.cuh"

namespace btt {

constexpr int kNielsTreeLanes = 128;
// the largest size a block takes: 8 leaves a lane
constexpr int64_t kNielsTreeMaxSize = 2048;

// The sum of the leaves J, J + D, J + 2D, ... (of L) of lane t, halving.
template <int L, int J, int D>
BTT_HD ge_p3 niels_tree_sum(const uint32_t* entries, int64_t cols, int64_t c, int t) {
  if constexpr (D >= L) {
    const int64_t s = (int64_t)t + (int64_t)kNielsTreeLanes * J;
    const int64_t half = (int64_t)kNielsTreeLanes * L;
    return ge_niels_add(niels_load(entries + (s * cols + c) * 24), niels_load(entries + ((s + half) * cols + c) * 24));
  } else {
    return ge_add(niels_tree_sum<L, J, 2 * D>(entries, cols, c, t), niels_tree_sum<L, J + D, 2 * D>(entries, cols, c, t));
  }
}

// Lane t's point of column c, for L = size / 256 leaves a lane.
template <int L>
BTT_HD ge_p3 niels_lane_sum(const uint32_t* entries, int64_t cols, int64_t c, int t) {
  return niels_tree_sum<L, 0, 1>(entries, cols, c, t);
}

// Leaves a lane for a column of size entries, or 0 if no block takes it.
BTT_HD int niels_tree_leaves(int64_t size) {
  switch (size) {
    case 256: return 1;
    case 512: return 2;
    case 1024: return 4;
    case 2048: return 8;
    default: return 0;
  }
}

}  // namespace btt
