// The bucket engine's window sums: for each (output, window) row of 255
// bucket sums S_1 .. S_255, the row's sum_k k S_k, one warp a row. One
// template over ladder.cuh's point policies (EdLadder for ristretto255,
// WLadder<C> for bls12-381 G1, bn254 G1 and Grumpkin), run by
// window_sums.cu; host_harness.cpp runs the same steps one lane after
// another (tests/test_torch_window_sums.py).
//
// Order. Bucket b (digit b + 1, b < 255; slot 255 is the identity) belongs to
// lane t = b mod 32, as its j = b / 32: consecutive lanes read consecutive
// buckets of each limb row. The digit is t + 1 + 32 j, so
//   sum_k k S_k = sum_t [(t + 1) s_t + 32 u_t],
// s_t = sum_j S_(t + 32 j), u_t = sum_j j S_(t + 32 j). A lane's run from
// j = 7 down keeps s and u by "s += S; u += s" (13 adds). The inclusive
// suffix sums I_t = sum_(t' >= t) s_t' over the lanes (5 shuffle steps)
// give sum_t I_t = sum_t (t + 1) s_t. Each lane adds I_t and 2^5 u_t (5
// doublings and an add), and the warp halves those 32 shares to lane 0 (5
// shuffle steps). 29 dependent point operations a row, where the plain
// scan (cuda_point.window_sums_plain, blitzar_tpu's order) takes 8 steps
// over the row and a 255-point tree: the sums are the same points, their
// coordinates differ.
//
// Identities: empty buckets are common and whole rows may be empty (a
// window whose digits are all 0). The Edwards add is unified and the
// Weierstrass one complete, so neither needs a case of its own.
#pragma once

#include "ladder.cuh"

namespace btt {

constexpr int kWindowBuckets = 255;  // a row's buckets, digits 1 .. 255
constexpr int kWindowLanes = 32;     // a row is one warp
constexpr int kWindowRun = 8;        // buckets a lane: t + 32 j, j < 8
constexpr int kWindowUBits = 5;      // 32 = 2^5: u's weight

// Bucket b of the row starting at base; the identity in slot 255.
template <class G>
BTT_HD typename G::P window_bucket(const typename G::In& buckets, int64_t base, int b) {
  return b < kWindowBuckets ? G::load(buckets, base + b) : G::identity();
}

// Lane t's run of row `row`: s = sum_j S_(t + 32 j), u = sum_j j S_(t + 32 j).
template <class G>
BTT_HD void window_lane_run(const typename G::In& buckets, int64_t row, int t, typename G::P& s,
                            typename G::P& u) {
  const int64_t base = row * kWindowBuckets;
  s = window_bucket<G>(buckets, base, t + kWindowLanes * (kWindowRun - 1));
  u = s;
  for (int j = kWindowRun - 2; j >= 1; --j) {
    s = ladder_add<G>(s, window_bucket<G>(buckets, base, t + kWindowLanes * j));
    u = ladder_add<G>(u, s);
  }
  s = ladder_add<G>(s, window_bucket<G>(buckets, base, t));
}

// Step d of the suffix scan at lane t: s_t + s_(t + d) while t + d is a
// lane of the row; `other` is lane t + d's s.
template <class G>
BTT_HD typename G::P window_scan_step(const typename G::P& s, const typename G::P& other, int t, int d) {
  return t + d < kWindowLanes ? ladder_add<G>(s, other) : s;
}

// A lane's share of its row's sum: I_t + 2^5 u_t.
template <class G>
BTT_HD typename G::P window_lane_share(const typename G::P& incl, const typename G::P& u) {
  return ladder_add<G>(incl, ladder_doubles<G>(u, kWindowUBits));
}

}  // namespace btt
