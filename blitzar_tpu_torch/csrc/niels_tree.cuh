// The per-lane schedule of fewrow_niels.cu: a few-row query's column sums
// straight from a niels table, in the order of the plain version
// (ops/cuda_point.py:fewrow_niels_plain), which the host harness
// (host_harness.cpp) runs too, so the CPU tests check the kernel's indices,
// its order of additions and its arithmetic.
//
// Column (k, r) is row r's sum over the gc = chunk_groups groups of table
// chunk k: entry (g, idx[r, g]) for g = k gc + s, s < gc, idx formed from
// the scalar bytes as the lookups form it (lookup.cuh:lookup_index; entry 0,
// the identity, is added like any other). Its plain order is the halving
// tree of the TPU kernel: the first level adds entries s and s + gc/2 by
// ge_niels_add, each later level the extended sums s and s + half, down to
// one. Lane t of a column's kFewrowLanes = 32 owns the s = t + 32 j: its
// leaves j < L = gc / 64 are first-level sums, and the levels whose pairs
// stay inside the lane pair leaf j with j + L/2. It forms them depth first,
// leaves in bit-reversed order, a binary counter merging the sums: leaves
// 0 and L/2 are siblings, then L/4 and 3L/4, whose sum joins theirs, and so
// on. At most log2(L) finished sums wait on a stack (Stack: shared memory
// on the card, an array in the harness). The last 5 levels pair lanes t
// and t + h across the column's lanes (a warp's shuffles on the card).
#pragma once

#include "lookup.cuh"

namespace btt {

// the chunk sizes a column takes: powers of two in (128, 2048], as the TPU
// kernel's tree_fits (a power of two above its 128 lanes)
constexpr int64_t kNielsTreeMinSize = 256;
constexpr int64_t kNielsTreeMaxSize = 2048;
// the lanes of a column: one warp
constexpr int kFewrowLanes = 32;

BTT_HD bool niels_tree_size_ok(int64_t size) {
  return size >= kNielsTreeMinSize && size <= kNielsTreeMaxSize && (size & (size - 1)) == 0;
}

BTT_HD int log2_exact(int64_t v) {
  int b = 0;
  while ((int64_t)1 << b < v) ++b;
  return b;
}

BTT_HD int bit_reverse(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// The niels entry row r picks in group g, read through the read-only cache.
BTT_HD ge_niels fewrow_entry(const lookup_query& q, const lookup_row& row, int64_t g) {
  const word4* e = q.table + ((g << q.w) + lookup_index(q, row, g)) * NielsForm::kChunks;
  ge_niels n;
  n.a = entry_coord(e, 0);
  n.b = entry_coord(e, 1);
  n.t = entry_coord(e, 2);
  return n;
}

// Lane t's sum of column (k, r), row the lookup_row of r: its L leaves
// over a stack of log2(L) points (push(level, p), pop(level) -> p).
template <class Stack>
BTT_HD ge_p3 fewrow_lane_sum(const lookup_query& q, const lookup_row& row, int64_t k, int t, Stack& stack) {
  const int64_t half = q.chunk_groups >> 1;
  const int leaves = (int)(half / kFewrowLanes);
  const int bits = log2_exact(leaves);
  const int64_t g0 = k * q.chunk_groups + t;
  ge_p3 cur;
  for (int i = 0; i < leaves; ++i) {
    const int64_t g = g0 + (int64_t)kFewrowLanes * bit_reverse(i, bits);
    cur = ge_niels_add(fewrow_entry(q, row, g), fewrow_entry(q, row, g + half), fe_mul_stage_op());
    int depth = 0;  // the sums waiting before this leaf: popcount(i)
    for (int m = i; m; m >>= 1) depth += m & 1;
    for (int m = i; m & 1; m >>= 1) cur = ge_add(stack.pop(--depth), cur);
    if (i + 1 < leaves) stack.push(depth, cur);
  }
  return cur;
}

}  // namespace btt
