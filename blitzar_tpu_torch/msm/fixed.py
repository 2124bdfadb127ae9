"""Fixed-generator MSM with precomputed partition tables (ristretto255).

The port of blitzar_tpu/msm/fixed.py's handle path: a handle holds, for each
group of ``window_width`` generators, all 2^w subset sums as affine niels
entries (kernel ``build_niels_table``); a query forms each bit-row's table
indices from the raw scalar bytes and sums the selected entries (kernel
``ed_lookup_msm``, then ``ed_add`` over its per-chunk partials), and a
double-and-add ladder folds the bit-rows of each output (kernel
``doubling_combine``).

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
from ..ops import cuda_point

MAX_HANDLE_POINTS = 1 << 20

STREAMING_TODO = (
    "MSMs over more than 2^20 generators need the streamed build+query path "
    "(blitzar_tpu/msm/fixed.py:716-854), which blitzar_tpu_torch does not "
    "port yet: see ROADMAP.md, section 1, 'streaming above 2^20'"
)


# the default of blitzar_tpu/msm/fixed.py:51-54: 2^8 entries per group of 8
DEFAULT_WINDOW_WIDTH = 8


class MultiexpHandle:
    """A fixed generator sequence with its partition table: ``table`` is
    (G, 2^w, 3, 8) int32 niels words (ops/cuda_point.py) on the points'
    device."""

    def __init__(self, points: ed.PointP3, window_width: int | None = None, n: int | None = None):
        self.n = int(n if n is not None else points.x.shape[1])
        if self.n > MAX_HANDLE_POINTS:
            raise NotImplementedError(STREAMING_TODO)
        self.window_width = w = int(window_width or DEFAULT_WINDOW_WIDTH)
        if points.x.shape[1] > self.n:
            points = ed.index_batch(points, slice(0, self.n))
        # identity padding to a multiple of w is free at query time: padded
        # scalars are zero and select entry 0, the identity
        n_pad = -(-max(self.n, 1) // w) * w
        if points.x.shape[1] < n_pad:
            pad = ed.identity((n_pad - points.x.shape[1],), points.x.device)
            points = ed.cat([points, pad])
        self.num_groups = n_pad // w
        self.table = cuda_point.build_niels_table(points, w)

    @property
    def device(self) -> torch.device:
        return self.table.device

    @classmethod
    def from_point_table(cls, table: ed.PointP3, n: int | None = None) -> "MultiexpHandle":
        """Handle from an extended (16, G, V) table of subset sums (the form
        blitzar_tpu saves), re-encoded as niels entries."""
        groups, entries = table.x.shape[1], table.x.shape[2]
        w = entries.bit_length() - 1
        if entries != 1 << w:
            raise ValueError(f"table has {entries} entries per group, not a power of two")
        obj = cls.__new__(cls)
        obj.window_width = w
        obj.num_groups = groups
        obj.n = int(n if n is not None else groups * w)
        obj.table = cuda_point.pack_niels(ed.to_niels(table))
        return obj

    def point_table(self) -> ed.PointP3:
        """The table as extended (16, G, V) points (z = 1)."""
        return ed.niels_to_p3(cuda_point.unpack_niels(self.table))


def _scalars_tensor(handle: MultiexpHandle, scalars) -> torch.Tensor:
    """Host (O, n, ...) bytes -> device tensor padded with zeros to the
    handle's G*w points."""
    scalars = np.asarray(scalars, np.uint8)
    n_table = handle.num_groups * handle.window_width
    if scalars.shape[1] > handle.n:
        raise ValueError(f"scalar length {scalars.shape[1]} exceeds handle size {handle.n}")
    pad = [(0, 0), (0, n_table - scalars.shape[1])] + [(0, 0)] * (scalars.ndim - 2)
    return torch.from_numpy(np.ascontiguousarray(np.pad(scalars, pad))).to(handle.device)


def partition_products(handle: MultiexpHandle, scalars: torch.Tensor, signs=None) -> ed.PointP3:
    """(R,) bit-row products (rows as in cuda_point.query_index)."""
    partials = cuda_point.ed_lookup_msm(handle.table, scalars, signs, handle.window_width)
    return ed.tree_reduce(partials, partials.x.shape[1])


def doubling_combine(products: ed.PointP3, num_outputs: int, nbits: int) -> ed.PointP3:
    """(R,) = (num_outputs * nbits,) products -> (num_outputs,) outputs."""
    return cuda_point.doubling_combine(ed.reshape_batch(products, (num_outputs, nbits)))


def fixed_multiexponentiation(handle: MultiexpHandle, scalars) -> ed.PointP3:
    """scalars: (O, n, nbytes) uint8 -> (O,) points (reference
    sxt_fixed_multiexponentiation)."""
    num_outputs, _, nbytes = np.shape(scalars)
    if num_outputs == 0:
        return ed.identity((0,), handle.device)
    dev_scalars = _scalars_tensor(handle, scalars)
    return doubling_combine(partition_products(handle, dev_scalars), num_outputs, 8 * nbytes)


def fixed_multiexponentiation_signed(handle: MultiexpHandle, scalars, signs) -> ed.PointP3:
    """scalars: (O, n, nbytes) uint8 magnitudes; signs: (O, n) uint8, 1 =
    negate that element's contribution. One table pass over positive and
    negative rows, result Q_pos - Q_neg (blitzar_tpu/msm/fixed.py:655-707)."""
    num_outputs, _, nbytes = np.shape(scalars)
    if num_outputs == 0:
        return ed.identity((0,), handle.device)
    dev_scalars = _scalars_tensor(handle, scalars)
    dev_signs = _scalars_tensor(handle, signs)
    products = partition_products(handle, dev_scalars, dev_signs)
    both = doubling_combine(products, 2 * num_outputs, 8 * nbytes)
    q_pos = ed.index_batch(both, slice(0, num_outputs))
    q_neg = ed.index_batch(both, slice(num_outputs, 2 * num_outputs))
    return ed.add(q_pos, ed.neg(q_neg))
