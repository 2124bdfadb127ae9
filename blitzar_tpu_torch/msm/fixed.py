"""Fixed-generator MSM with precomputed partition tables, for ristretto255
and the short-Weierstrass curves (bls12-381 G1, bn254 G1, Grumpkin): the
port of blitzar_tpu/msm/fixed.py's handle path and its streamed path.

A table holds, for each group of ``window_width`` generators, all 2^w
subset sums; a query forms each bit-row's table indices from the raw scalar
bytes and sums the selected entries, then a double-and-add ladder folds the
bit-rows of each output.

- A handle (:class:`MultiexpHandle`) keeps its table: ristretto255 affine
  niels entries (kernel ``build_niels_table``), a Weierstrass curve
  projective ones (``w_build_table``; the identity entry has z = 0, so no
  affine form). It holds any n the card's memory does (3.2 GB of niels
  entries per 2^20 ristretto255 points at w = 8).
- A streamed query (:func:`streaming_multiexponentiation`) builds, queries
  and drops one chunk's table at a time, ``STREAM_CHUNK_POINTS`` points a
  chunk and a short last one: ristretto255 cached entries
  (``build_cached_table``: no inversion), a Weierstrass curve the
  projective table of ``w_build_table``.

The lookups (``ed_lookup_msm`` on niels or cached entries, ``w_lookup_msm``)
give (K, R) partials per table; ``tree_reduce_lanes`` sums them in one
launch, and sums a streamed query's (chunks, R) products once more. The
ladder is ``doubling_combine`` for ristretto255 and, as
blitzar_tpu/msm/fixed.py:611-623 runs it, one ``wdouble`` and one ``wadd``
launch per bit over the outputs for a Weierstrass curve.

Scalar bits are LSB-first; row r = o * nbits + b; group g covers points
g*w .. g*w + w - 1. Signed queries run the positive and the negative rows in
one table pass and return Q_pos - Q_neg. Identity points and zero scalars
pad a table to whole groups: they select entry 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..ops import cuda_point, cuda_wpoint

# the default of blitzar_tpu/msm/fixed.py:51-54: 2^8 entries per group of 8
DEFAULT_WINDOW_WIDTH = 8

# points per streamed chunk: a chunk's table at w = 8 is 2^15 groups x 256
# entries, 1 GiB of cached ristretto255 entries (128 bytes each), 768 MiB of
# bn254 G1 / Grumpkin and 1.125 GiB of bls12-381 G1 projective ones; its
# lookup fills the card (2^15 groups split over 1024 chunks of 32 for a
# 256-row query)
STREAM_CHUNK_POINTS = 1 << 18


class MultiexpHandle:
    """A fixed generator sequence with its partition table on the points'
    device: ``table`` is (G, 2^w, 3, 8) int32 niels words for ristretto255
    (ops/cuda_point.py), (G, 2^w, 3, K) projective words for a Weierstrass
    curve (ops/cuda_wpoint.py)."""

    def __init__(self, points, window_width: int | None = None, curve=ed, n: int | None = None):
        self.curve = curve
        self.n = int(n if n is not None else points.x.shape[1])
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


def _device_rows(array, n_pad: int, device) -> torch.Tensor:
    """Host (O, n, ...) bytes -> a device tensor padded with zeros to
    n_pad elements along axis 1."""
    array = np.asarray(array, np.uint8)
    if array.shape[1] > n_pad:
        raise ValueError(f"{array.shape[1]} scalars exceed the {n_pad} points of the table")
    if array.shape[1] < n_pad:
        array = np.pad(array, [(0, 0), (0, n_pad - array.shape[1])] + [(0, 0)] * (array.ndim - 2))
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _scalars_tensor(handle: MultiexpHandle, scalars) -> torch.Tensor:
    """Host (O, n, ...) bytes -> device tensor padded with zeros to the
    handle's G*w points."""
    if np.shape(scalars)[1] > handle.n:
        raise ValueError(f"scalar length {np.shape(scalars)[1]} exceeds handle size {handle.n}")
    return _device_rows(scalars, handle.num_groups * handle.window_width, handle.device)


def sum_leading(p, curve=ed):
    """The sum of a (size, *rest) point batch over its leading axis: one
    ``tree_reduce_lanes`` launch."""
    if curve is ed:
        return cuda_point.tree_reduce_lanes(p)
    return cuda_wpoint.w_tree_reduce_lanes(curve, p)


def partition_products(handle: MultiexpHandle, scalars: torch.Tensor, signs=None):
    """(R,) bit-row products (rows as in cuda_point.query_index)."""
    curve = handle.curve
    if curve is ed:
        partials = cuda_point.ed_lookup_msm(handle.table, scalars, signs, handle.window_width)
    else:
        partials = cuda_wpoint.w_lookup_msm(curve, handle.table, scalars, signs, handle.window_width)
    return sum_leading(partials, curve)


def stream_products(points, scalars: torch.Tensor, signs=None, window_width: int = DEFAULT_WINDOW_WIDTH, curve=ed):
    """(R,) bit-row products of a streamed query: scalars (O, n_pad, nbytes)
    and signs (O, n_pad) (or None) on the points' device, n_pad a multiple
    of the window; points (nlimbs, >= 0), identities standing in for any
    past their end. Chunk by chunk of ``STREAM_CHUNK_POINTS`` (rounded down
    to whole groups, the last one short): the chunk's table is built,
    queried with its slice of the scalars (read in place) and dropped, and
    its partials summed to (R,); the chunks' products are summed at the end.
    The point is the same however the chunks fall."""
    w = window_width
    n_pad = scalars.shape[1]
    if n_pad % w:
        raise ValueError(f"scalar length {n_pad} is not a multiple of the window {w}")
    npts = points.x.shape[1]
    dev = points.x.device
    step = max(w, STREAM_CHUNK_POINTS // w * w)
    per_chunk = []
    for lo in range(0, n_pad, step):
        hi = min(lo + step, n_pad)
        if hi <= npts:
            pts = curve.index_batch(points, slice(lo, hi))
        else:
            pad = curve.identity((hi - max(lo, npts),), dev)
            pts = curve.cat([curve.index_batch(points, slice(lo, npts)), pad]) if lo < npts else pad
        sc = scalars[:, lo:hi]
        sg = None if signs is None else signs[:, lo:hi]
        if curve is ed:
            table = cuda_point.build_cached_table(pts, w)
            partials = cuda_point.ed_lookup_msm(table, sc, sg, w)
        else:
            table = cuda_wpoint.w_build_table(curve, pts, w)
            partials = cuda_wpoint.w_lookup_msm(curve, table, sc, sg, w)
        del table
        per_chunk.append(sum_leading(partials, curve))
    if len(per_chunk) == 1:
        return per_chunk[0]
    return sum_leading(curve.cat([curve.reshape_batch(p, (1, -1)) for p in per_chunk]), curve)


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


def combine_signed(products, num_outputs: int, nbits: int, curve=ed):
    """(2 * num_outputs * nbits,) products of positive then negative rows
    -> (num_outputs,) outputs Q_pos - Q_neg (blitzar_tpu/msm/fixed.py:655-707)."""
    both = doubling_combine(products, 2 * num_outputs, nbits, curve)
    q_pos = curve.index_batch(both, slice(0, num_outputs))
    q_neg = curve.index_batch(both, slice(num_outputs, 2 * num_outputs))
    return curve.add(q_pos, curve.neg(q_neg))


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
    negative rows, result Q_pos - Q_neg."""
    num_outputs, _, nbytes = np.shape(scalars)
    if num_outputs == 0:
        return handle.curve.identity((0,), handle.device)
    products = partition_products(handle, _scalars_tensor(handle, scalars), _scalars_tensor(handle, signs))
    return combine_signed(products, num_outputs, 8 * nbytes, handle.curve)


def streaming_multiexponentiation(points, scalars, curve=ed, window_width=DEFAULT_WINDOW_WIDTH, signs=None):
    """Dynamic MSM with no persistent table (blitzar_tpu/msm/fixed.py:820-854):
    scalars (O, n, nbytes) uint8 magnitudes, optional signs (O, n) uint8 (1 =
    negate that element), points (nlimbs, >= n) of ``curve`` (identities
    stand in for missing ones) -> (O,) points on the points' device. Each
    chunk's table is built, queried and dropped (:func:`stream_products`)."""
    num_outputs, n, nbytes = np.shape(scalars)
    dev = points.x.device
    if num_outputs == 0:
        return curve.identity((0,), dev)
    n_pad = -(-max(n, 1) // window_width) * window_width
    dev_scalars = _device_rows(scalars, n_pad, dev)
    dev_signs = None if signs is None else _device_rows(signs, n_pad, dev)
    products = stream_products(points, dev_scalars, dev_signs, window_width, curve)
    if signs is None:
        return doubling_combine(products, num_outputs, 8 * nbytes, curve)
    return combine_signed(products, num_outputs, 8 * nbytes, curve)
