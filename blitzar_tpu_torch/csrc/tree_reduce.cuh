// The group-generic pieces of tree_reduce_lanes.cu: one trait per point
// form (ristretto255's extended Edwards points, the three Weierstrass curves'
// projective points), the block size, each thread's serial share of a column
// and the halving order in which a block combines its threads' sums. The
// host harness (host_harness.cpp) runs the same pieces in the same order, so
// the CPU tests check the kernel's arithmetic and its order of additions.
#pragma once

#include "edwards25519.cuh"
#include "weierstrass.cuh"

namespace btt {

// ristretto255 (curve id 0 of the reference C ABI): unified Edwards add.
struct EdGroup {
  using P = ge_p3;
  using In = point_ptrs;
  using Out = point_out_ptrs;
  BTT_HD static P identity() { return ge_identity(); }
  BTT_HD static P add(const P& a, const P& b) { return ge_add(a, b); }
  BTT_HD static P load(const In& p, int64_t i) { return ge_load(p, i); }
  BTT_HD static void store(const Out& p, int64_t i, const P& q) { ge_store(p, i, q); }
};

// bls12-381 G1, bn254 G1, Grumpkin: complete RCB add.
template <class C>
struct WGroup {
  using P = wpoint<C>;
  using In = wpoint_ptrs;
  using Out = wpoint_out_ptrs;
  BTT_HD static P identity() { return w_identity<C>(); }
  BTT_HD static P add(const P& a, const P& b) { return w_add<C>(a, b); }
  BTT_HD static P load(const In& p, int64_t i) { return w_load<C>(p, i); }
  BTT_HD static void store(const Out& p, int64_t i, const P& q) { w_store<C>(p, i, q); }
};

// Threads of a block: the least power of two that covers the column, at
// most 128 (a 1024-row column: 8 serial adds a thread, then 7 levels).
BTT_HD int tree_threads(int64_t size) {
  int t = 1;
  while (t < size && t < 128) t <<= 1;
  return t;
}

// Thread t of T sums the elements t, t + T, t + 2T, ... of column c of a
// (size, cols) batch (element (s, c) at index s * cols + c), in that order;
// a thread past the column's end holds the identity.
template <class G>
BTT_HD typename G::P tree_thread_sum(const typename G::In& in, int64_t size, int64_t cols, int64_t c,
                                     int t, int T) {
  if (t >= size) return G::identity();
  typename G::P acc = G::load(in, (int64_t)t * cols + c);
  for (int64_t s = t + T; s < size; s += T) acc = G::add(acc, G::load(in, s * cols + c));
  return acc;
}

}  // namespace btt
