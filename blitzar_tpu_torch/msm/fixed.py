"""Fixed-generator MSM with precomputed partition tables, for ristretto255
and the short-Weierstrass curves (bls12-381 G1, bn254 G1, Grumpkin).

The port of blitzar_tpu/msm/fixed.py's handle path: a handle holds, for each
group of ``window_width`` generators, all 2^w subset sums; a query forms
each bit-row's table indices from the raw scalar bytes and sums the selected
entries, then a double-and-add ladder folds the bit-rows of each output.

- ristretto255 (``curve`` is the ``curves.edwards25519`` module): affine
  niels entries (kernel ``build_niels_table``), the lookup ``ed_lookup_msm``
  then ``ed_add`` over its per-chunk partials, the ladder
  ``doubling_combine``.
- a Weierstrass curve (a ``curves.weierstrass.WCurve``): projective entries
  (kernel ``w_build_table``; the identity entry has z = 0, so no affine
  form), the lookup ``w_lookup_msm`` then ``wadd`` over its partials, and
  the ladder as blitzar_tpu/msm/fixed.py:611-623 runs it, one ``wdouble``
  and one ``wadd`` launch per bit over the outputs.

Scalar bits are LSB-first; row r = o * nbits + b; group g covers points
g*w .. g*w + w - 1. Signed queries run the positive and the negative rows in
one table pass and return Q_pos - Q_neg. Handles hold at most 2^20 points;
above that blitzar_tpu streams build and query per chunk, which this port
does not have yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..ops import cuda_point, cuda_wpoint

MAX_HANDLE_POINTS = 1 << 20

STREAMING_TODO = (
    "MSMs over more than 2^20 generators need the streamed build+query path "
    "(blitzar_tpu/msm/fixed.py:716-854), which blitzar_tpu_torch does not "
    "port yet: see ROADMAP.md, section 1, 'streaming above 2^20'"
)


# the default of blitzar_tpu/msm/fixed.py:51-54: 2^8 entries per group of 8
DEFAULT_WINDOW_WIDTH = 8


class MultiexpHandle:
    """A fixed generator sequence with its partition table on the points'
    device: ``table`` is (G, 2^w, 3, 8) int32 niels words for ristretto255
    (ops/cuda_point.py), (G, 2^w, 3, K) projective words for a Weierstrass
    curve (ops/cuda_wpoint.py)."""

    def __init__(self, points, window_width: int | None = None, curve=ed, n: int | None = None):
        self.curve = curve
        self.n = int(n if n is not None else points.x.shape[1])
        if self.n > MAX_HANDLE_POINTS:
            raise NotImplementedError(STREAMING_TODO)
        self.window_width = w = int(window_width or DEFAULT_WINDOW_WIDTH)
        if points.x.shape[1] > self.n:
            points = curve.index_batch(points, slice(0, self.n))
        # identity padding to a multiple of w is free at query time: padded
        # scalars are zero and select entry 0, the identity
        n_pad = -(-max(self.n, 1) // w) * w
        if points.x.shape[1] < n_pad:
            pad = curve.identity((n_pad - points.x.shape[1],), points.x.device)
            points = curve.cat([points, pad])
        self.num_groups = n_pad // w
        if curve is ed:
            self.table = cuda_point.build_niels_table(points, w)
        else:
            self.table = cuda_wpoint.w_build_table(curve, points, w)

    @property
    def device(self) -> torch.device:
        return self.table.device

    @classmethod
    def from_point_table(cls, table, n: int | None = None, curve=ed) -> "MultiexpHandle":
        """Handle from a (nlimbs, G, V) point table of subset sums (the form
        blitzar_tpu saves): extended points, re-encoded as niels entries, for
        ristretto255; projective points, packed as they are, for a
        Weierstrass curve."""
        groups, entries = table.x.shape[1], table.x.shape[2]
        w = entries.bit_length() - 1
        if entries != 1 << w:
            raise ValueError(f"table has {entries} entries per group, not a power of two")
        obj = cls.__new__(cls)
        obj.curve = curve
        obj.window_width = w
        obj.num_groups = groups
        obj.n = int(n if n is not None else groups * w)
        if curve is ed:
            obj.table = cuda_point.pack_niels(ed.to_niels(table))
        else:
            obj.table = cuda_wpoint.pack_points(table)
        return obj

    def point_table(self):
        """The table as (nlimbs, G, V) points: extended (z = 1) for
        ristretto255, projective as stored for a Weierstrass curve."""
        if self.curve is ed:
            return ed.niels_to_p3(cuda_point.unpack_niels(self.table))
        return cuda_wpoint.unpack_points(self.table)


def _scalars_tensor(handle: MultiexpHandle, scalars) -> torch.Tensor:
    """Host (O, n, ...) bytes -> device tensor padded with zeros to the
    handle's G*w points."""
    scalars = np.asarray(scalars, np.uint8)
    n_table = handle.num_groups * handle.window_width
    if scalars.shape[1] > handle.n:
        raise ValueError(f"scalar length {scalars.shape[1]} exceeds handle size {handle.n}")
    pad = [(0, 0), (0, n_table - scalars.shape[1])] + [(0, 0)] * (scalars.ndim - 2)
    return torch.from_numpy(np.ascontiguousarray(np.pad(scalars, pad))).to(handle.device)


def partition_products(handle: MultiexpHandle, scalars: torch.Tensor, signs=None):
    """(R,) bit-row products (rows as in cuda_point.query_index)."""
    curve = handle.curve
    if curve is ed:
        partials = cuda_point.ed_lookup_msm(handle.table, scalars, signs, handle.window_width)
    else:
        partials = cuda_wpoint.w_lookup_msm(curve, handle.table, scalars, signs, handle.window_width)
    return curve.tree_reduce(partials, partials.x.shape[1])


def doubling_combine(products, num_outputs: int, nbits: int, curve=ed):
    """(R,) = (num_outputs * nbits,) products -> (num_outputs,) outputs:
    sum_b 2^b * products[o * nbits + b]."""
    rows = curve.reshape_batch(products, (num_outputs, nbits))
    if curve is ed:
        return cuda_point.doubling_combine(rows)
    # bit-major copy, so each step's (O,) row is a limb-major view
    by_bit = type(rows)(*(c.transpose(1, 2).contiguous() for c in rows))
    acc = curve.index_batch(by_bit, nbits - 1)
    for b in range(nbits - 2, -1, -1):
        acc = curve.add(curve.double(acc), curve.index_batch(by_bit, b))
    return acc


def fixed_multiexponentiation(handle: MultiexpHandle, scalars):
    """scalars: (O, n, nbytes) uint8 -> (O,) points (reference
    sxt_fixed_multiexponentiation)."""
    num_outputs, _, nbytes = np.shape(scalars)
    if num_outputs == 0:
        return handle.curve.identity((0,), handle.device)
    dev_scalars = _scalars_tensor(handle, scalars)
    return doubling_combine(partition_products(handle, dev_scalars), num_outputs, 8 * nbytes, handle.curve)


def fixed_multiexponentiation_signed(handle: MultiexpHandle, scalars, signs):
    """scalars: (O, n, nbytes) uint8 magnitudes; signs: (O, n) uint8, 1 =
    negate that element's contribution. One table pass over positive and
    negative rows, result Q_pos - Q_neg (blitzar_tpu/msm/fixed.py:655-707)."""
    curve = handle.curve
    num_outputs, _, nbytes = np.shape(scalars)
    if num_outputs == 0:
        return curve.identity((0,), handle.device)
    dev_scalars = _scalars_tensor(handle, scalars)
    dev_signs = _scalars_tensor(handle, signs)
    products = partition_products(handle, dev_scalars, dev_signs)
    both = doubling_combine(products, 2 * num_outputs, 8 * nbytes, curve)
    q_pos = curve.index_batch(both, slice(0, num_outputs))
    q_neg = curve.index_batch(both, slice(num_outputs, 2 * num_outputs))
    return curve.add(q_pos, curve.neg(q_neg))
