// Montgomery's trick over one thread's elements of GF(2^255 - 19): the batch
// inversion that ed_convert.cuh's ed_to_niels (a table chunk's z) and
// finvert.cu (any batch, zeros among it) share.
//
// A Batch names a thread's n elements j < n and where their results go:
// - counts(j): whether element j takes part (finvert leaves out an element
//   whose canonical value is 0; an extended z is never 0);
// - value(j): its value (after counts(j), for the same j);
// - park(j, prefix) and parked(j): a slot of element j's own output that
//   holds the product of the earlier elements until the backward sweep;
// - put(j, inverse): writes element j's output from its inverse;
// - skip(j): writes the output of an element left out.
// The forward sweep parks the running product beside each element and
// multiplies the element in; one fe_invert (~265 multiplies) inverts the
// product; the backward sweep peels one element off at a time, inverse_j =
// inv * parked_j, inv = inv * value_j. Three multiplies an element. Inverses
// are unique, so any split of a batch into threads gives the same outputs.
//
// BTT_HD like fp25519.cuh: the host harness runs the kernels' very code.
#pragma once

#include "fp25519.cuh"

namespace btt {

template <class Mul, class Batch>
BTT_HD void batch_invert_sweep(Batch& b, int n) {
  Mul mul;
  fe acc = fe_one();
  for (int j = 0; j < n; ++j) {
    if (!b.counts(j)) continue;
    b.park(j, acc);
    acc = mul(acc, b.value(j));
  }
  fe inv = fe_invert(acc, mul);
  for (int j = n - 1; j >= 0; --j) {
    if (!b.counts(j)) {
      b.skip(j);
      continue;
    }
    const fe inverse = mul(inv, b.parked(j));
    inv = mul(inv, b.value(j));
    b.put(j, inverse);
  }
}

// finvert's batch: elements first + j * step of a (16, count) limb array at
// a limb stride; the output (16, count) contiguous holds the parked
// prefixes, then each element's inverse as canonical 16-bit limbs (0 for 0).
struct InvertBatch {
  const int32_t* a;
  int64_t a_stride;
  int32_t* out;
  int64_t count, first, step;
  fe last;  // counts(j)'s load, which value(j) returns

  BTT_HD int64_t at(int j) const { return first + j * step; }
  BTT_HD bool counts(int j) {
    last = fe_load(a + at(j), a_stride);
    return !fe_is_zero(last);
  }
  BTT_HD fe value(int) const { return last; }
  BTT_HD void park(int j, const fe& prefix) { fe_store(out + at(j), count, prefix); }
  BTT_HD fe parked(int j) const { return fe_load(out + at(j), count); }
  BTT_HD void put(int j, const fe& inverse) { fe_store(out + at(j), count, inverse); }
  BTT_HD void skip(int j) { fe_store(out + at(j), count, fe_zero()); }
};

// One thread's elements of finvert: the kernel's body and the harness's lane.
template <class Mul>
BTT_HD void invert_elements(const int32_t* a, int64_t a_stride, int32_t* out, int64_t count, int64_t first,
                            int64_t step, int n) {
  InvertBatch b = {a, a_stride, out, count, first, step, fe_zero()};
  batch_invert_sweep<Mul>(b, n);
}

}  // namespace btt
