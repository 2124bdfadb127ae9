// The group-generic pieces of tree_reduce_lanes.cu: one trait per point
// form (ristretto255's extended Edwards points, the three Weierstrass curves'
// projective points), the launch shape, each thread's serial share of a
// column and the order in which the column's thread sums are combined. The
// host harness (host_harness.cpp) runs the same pieces in the same order,
// so the CPU tests check the kernel's arithmetic and its order of
// additions.
//
// The order, for a column of `size` points and T = slots * splits threads
// (tree_shape_of: `splits` blocks of `slots` threads on the column, both
// powers of two): thread t sums the points t, t + T, t + 2T, ... in that
// order (a thread at or past `size` holds the identity). Each block then
// halves its threads' sums: at level h = slots/2, ..., 2, 1, its thread t <
// h (counted within the block) adds the sum of thread t + h, unless that
// thread is at or past `size` (its sum is the identity). Then the blocks'
// sums are halved the same way, h = splits/2, ..., 1, block m + h into
// block m, unless block m + h starts at or past `size`. Halving keeps a
// level's adds in the block's lowest warps, so the others drop out instead
// of sharing the schedulers with them.
#pragma once

#include "edwards25519.cuh"
#include "weierstrass.cuh"

namespace btt {

// ristretto255 (curve id 0 of the reference C ABI): unified Edwards add.
// A batch that fills the card runs EdGroup: each stage of multiplies one
// non-inlined body, at most 128 registers, two blocks an SM; a small batch
// (tree_small) runs EdGroup::Small: the multiplies inlined, up to 255
// registers, since there each level waits on one add's latency.
template <class Mul, int MinBlocks>
struct EdGroupT {
  using P = ge_p3;
  using In = point_ptrs;
  using Out = point_out_ptrs;
  using Small = EdGroupT<fe_mul_op, 1>;
  static constexpr int kWords = 32;
  static constexpr int kMinBlocks = MinBlocks;
  BTT_HD static P identity() { return ge_identity(); }
  BTT_HD static P add(const P& a, const P& b) { return ge_add(a, b, Mul()); }
  BTT_HD static P load(const In& p, int64_t i) { return ge_load(p, i); }
  BTT_HD static void store(const Out& p, int64_t i, const P& q) { ge_store(p, i, q); }
};
using EdGroup = EdGroupT<fe_mul_stage_op, 2>;

// bls12-381 G1, bn254 G1, Grumpkin: complete RCB add, one non-inlined
// Montgomery multiply called a product (mf_mul_call_op; bodies of six
// products a stage passed their operands through the stack and ran slower
// on the H100).
template <class C>
struct WGroup {
  using P = wpoint<C>;
  using In = wpoint_ptrs;
  using Out = wpoint_out_ptrs;
  using Small = WGroup;
  static constexpr int kWords = 3 * C::F::K;
  static constexpr int kMinBlocks = 1;  // capped at 128 registers, the adds spilled hundreds of bytes
  BTT_HD static P identity() { return w_identity<C>(); }
  BTT_HD static P add(const P& a, const P& b) { return w_add<C>(a, b, mf_mul_call_op<typename C::F>()); }
  BTT_HD static P load(const In& p, int64_t i) { return w_load<C>(p, i); }
  BTT_HD static void store(const Out& p, int64_t i, const P& q) { w_store<C>(p, i, q); }
};

// A point's words (its struct holds nothing but 32-bit words), to park it
// in shared memory or scratch.
template <class G>
BTT_HD uint32_t* point_words(typename G::P& p) {
  static_assert(sizeof(typename G::P) == 4 * G::kWords, "a point is kWords 32-bit words");
  return reinterpret_cast<uint32_t*>(&p);
}

constexpr int kTreeMaxWarps = 8;  // warps of a block, at most
// threads a launch aims for: about two waves of 256-thread blocks over the
// H100's 132 SMs at the kernel's ~200 registers (one block an SM); twice as
// many ran no faster
constexpr int64_t kTreeTargetThreads = 1 << 16;

// How a launch covers a (size, cols) batch. A warp spans cw neighbouring
// columns (lane l on column l mod cw) and rw = 32 / cw rows; a block of
// `warps` warps spans cw columns and slots = rw * warps threads of each;
// `splits` blocks share a column tile, so a column has T = slots * splits
// threads, and a block's threads on it are t = j + slots * split for its
// slots j = l / cw + rw * warp. Lanes on neighbouring columns read
// neighbouring words of each limb row.
struct tree_shape {
  int cw, rw, warps, slots;
  int64_t tiles, splits, T;
};

BTT_HD int64_t pow2_at_least(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// A batch of at most kTreeTargetThreads points is small: short of work,
// its time is the depth of its tree.
BTT_HD bool tree_small(int64_t size, int64_t cols) { return size * cols <= kTreeTargetThreads; }

// cw: the columns, up to 32. A small batch narrows cw until a block holds
// a whole column, one point a thread (rw = 32 / cw rows a warp, up to 8
// warps: 256 rows at cw = 1), so that no block shares a column (a
// cross-block step, with its counter, fence and sums through L2, costs more
// there than the levels it saves). warps: up to 8, no more than the rows
// fill. Then more blocks a column tile while the launch is under its
// thread target and every thread keeps at least 4 points.
BTT_HD tree_shape tree_shape_of(int64_t size, int64_t cols) {
  tree_shape s;
  s.cw = (int)(cols < 32 ? pow2_at_least(cols) : 32);
  if (tree_small(size, cols)) {
    while (s.cw > 1 && (32 / s.cw) * kTreeMaxWarps < size) s.cw >>= 1;
  }
  s.rw = 32 / s.cw;
  const int64_t rows_warps = (size + s.rw - 1) / s.rw;
  s.warps = (int)(rows_warps < kTreeMaxWarps ? pow2_at_least(rows_warps) : kTreeMaxWarps);
  s.slots = s.rw * s.warps;
  s.tiles = (cols + s.cw - 1) / s.cw;
  s.splits = 1;
  while (2 * s.tiles * s.splits * 32 * s.warps <= kTreeTargetThreads && 8 * s.slots * s.splits <= size) {
    s.splits <<= 1;
  }
  s.T = s.slots * s.splits;
  return s;
}

// Thread t of T sums the elements t, t + T, t + 2T, ... of column c of a
// (size, cols) batch (element (s, c) at index s * cols + c), in that order;
// a thread past the column's end holds the identity.
template <class G>
BTT_HD typename G::P tree_thread_sum(const typename G::In& in, int64_t size, int64_t cols, int64_t c, int64_t t,
                                     int64_t T) {
  if (t >= size) return G::identity();
  typename G::P acc = G::load(in, t * cols + c);
  for (int64_t s = t + T; s < size; s += T) acc = G::add(acc, G::load(in, s * cols + c));
  return acc;
}

}  // namespace btt
