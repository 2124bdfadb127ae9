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
launch, and sums a streamed query's (chunks, R) products once more. A query
the lookups do not take as blitzar_tpu routes it (fewer than 128 bit rows,
as one column of 1 to 15 bytes has; another window than 8; a group count
off the lookup's tile) goes to the few-row query (:func:`fewrow_products`):
on a niels table one ``fewrow_niels`` launch sums each row's entries of
each table chunk straight from the table (where the chunk size fits it;
else the entries are gathered per chunk and summed by ``niels_add`` and
``tree_reduce_lanes``, as on cached and Weierstrass tables). The
ladder is one launch over all outputs of a query: ``doubling_combine`` for
ristretto255, ``w_doubling_combine`` for a Weierstrass curve (where
blitzar_tpu/msm/fixed.py:611-623 launches ``wdouble`` and ``wadd`` once
each per bit).

Scalar bits are LSB-first; row r = o * nbits + b; group g covers points
g*w .. g*w + w - 1. Signed queries run the positive and the negative rows in
one table pass and return Q_pos - Q_neg, one ``ed_add`` or ``wadd`` launch
that reads Q_neg negated. Identity points and zero scalars
pad a table to whole groups: they select entry 0.

A handle goes to and comes from files (:meth:`MultiexpHandle.write_to_file`,
:meth:`MultiexpHandle.new_from_file`): blitzar_tpu's npz of the point table,
or the reference's raw format (``msm/interop.py``). A ristretto255 point
table becomes niels entries by one ``ed_to_niels`` launch a chunk of
``TABLE_CHUNK_ENTRIES`` entries (a batch inversion of z on the card,
``ops/cuda_point.py``); niels entries go back to points by one
``ed_niels_points`` launch a chunk. Packed and vlen queries
(:func:`fixed_packed_multiexponentiation`,
:func:`fixed_vlen_multiexponentiation`) run as one query of the packed
bytes, whose bit-row products are then picked per output.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..fields import fp25519 as F
from ..ops import cuda_point, cuda_wpoint

# the default of blitzar_tpu/msm/fixed.py:51-54: 2^8 entries per group of 8
DEFAULT_WINDOW_WIDTH = 8

# points per streamed chunk: a chunk's table at w = 8 is 2^15 groups x 256
# entries, 1 GiB of cached ristretto255 entries (128 bytes each), 768 MiB of
# bn254 G1 / Grumpkin and 1.125 GiB of bls12-381 G1 projective ones; its
# lookup fills the card (2^15 groups split over 521 chunks of 63 for a
# 256-row query, cuda_point.lookup_chunks)
STREAM_CHUNK_POINTS = 1 << 18

# table entries a conversion (points to niels entries and back, files) holds
# at once: whole groups, 2^14 of them at w = 8; each (16, entries) int32
# coordinate is 256 MiB, the plain adds' int64 temporaries twice that
TABLE_CHUNK_ENTRIES = 1 << 22
# entries a row of a table's batch inversion holds at most
INVERT_LANES = 256


def table_chunks(groups: int, entries: int):
    """Slices of whole groups of ``entries`` entries each, at most
    ``TABLE_CHUNK_ENTRIES`` entries a slice (at least one group)."""
    step = max(1, TABLE_CHUNK_ENTRIES // max(entries, 1))
    return [slice(lo, min(lo + step, groups)) for lo in range(0, groups, step)]


def lane_rows(t: torch.Tensor) -> torch.Tensor:
    """A (nlimbs, g, V) table coordinate as (nlimbs, rows, L) rows of L =
    min(V, ``INVERT_LANES``) entries, the rows of a plain batch inversion
    (``cuda_wpoint.w_affine_plain``): any split of the entries gives the same
    inverses, and rows of 256 keep its row totals few however large V (2^16
    in the reference's default files)."""
    return t.reshape(t.shape[0], -1, min(t.shape[-1], INVERT_LANES))


def niels_table(table: ed.PointP3) -> torch.Tensor:
    """(16, G, V) extended points -> (G, V, 3, 8) niels words
    (blitzar_tpu/msm/fixed.py:197-220), one ``ed_to_niels`` launch a chunk
    (a batch inversion of z, then x/z, y/z and (y + x, y - x, 2d*x*y); its
    plain version on the CPU)."""
    groups, entries = table.x.shape[1], table.x.shape[2]
    out = torch.empty((groups, entries, 3, 8), dtype=torch.int32, device=table.x.device)
    for sl in table_chunks(groups, entries):
        out[sl] = cuda_point.ed_to_niels(ed.index_batch(table, sl))
    return out


def niels_point_table(words: torch.Tensor) -> ed.PointP3:
    """(G, V, 3, 8) niels words -> (16, G, V) canonical extended points
    (x, y, 1, t) (blitzar_tpu/msm/fixed.py:397-414), one ``ed_niels_points``
    launch a chunk, each writing its slice of the table in place (its plain
    version on the CPU)."""
    groups, entries = words.shape[0], words.shape[1]
    out = ed.PointP3(*(torch.empty((F.NLIMBS, groups, entries), dtype=torch.int32, device=words.device)
                       for _ in range(4)))
    for sl in table_chunks(groups, entries):
        cuda_point.ed_niels_points(words[sl], out=ed.index_batch(out, sl))
    return out


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
    def from_table(cls, table: torch.Tensor, curve=ed, n: int | None = None) -> "MultiexpHandle":
        """Handle around a (G, 2^w, coords, words) table in the port's entry
        layout (niels words for ristretto255, projective words for a
        Weierstrass curve); n defaults to G * w."""
        groups, entries = table.shape[0], table.shape[1]
        w = entries.bit_length() - 1
        if entries != 1 << w:
            raise ValueError(f"table has {entries} entries per group, not a power of two")
        obj = cls.__new__(cls)
        obj.curve = curve
        obj.window_width = w
        obj.num_groups = groups
        obj.n = int(n if n is not None else groups * w)
        obj.table = table
        return obj

    @classmethod
    def from_point_table(cls, table, n: int | None = None, curve=ed) -> "MultiexpHandle":
        """Handle from a (nlimbs, G, V) point table of subset sums (the form
        blitzar_tpu saves): extended points, re-encoded as niels entries
        (:func:`niels_table`), for ristretto255; projective points, packed as
        they are, for a Weierstrass curve."""
        words = niels_table(table) if curve is ed else cuda_wpoint.pack_points(table)
        return cls.from_table(words, curve, n)

    def point_table(self):
        """The table as (nlimbs, G, V) points: canonical extended (z = 1) for
        ristretto255, projective as stored for a Weierstrass curve."""
        if self.curve is ed:
            return niels_point_table(self.table)
        return cuda_wpoint.unpack_points(self.table)

    # -- files (blitzar_tpu/msm/fixed.py:397-456) ---------------------------

    def write_to_file(self, path: str) -> None:
        """blitzar_tpu's npz: ``curve`` (the curve's name), ``window_width``,
        ``n`` and ``coord{i}``, the point table's (nlimbs, G, V) uint32
        limbs (canonical), so blitzar_tpu reads it too. ".npz" is appended
        to a path without it, as np.savez does."""
        table = self.point_table()
        np.savez(
            path if path.endswith(".npz") else path + ".npz",
            curve=self.curve.name,
            window_width=self.window_width,
            n=self.n,
            **{f"coord{i}": c.cpu().numpy().astype(np.uint32) for i, c in enumerate(table)},
        )

    @classmethod
    def new_from_file(cls, path: str, curve=ed, device="cuda") -> "MultiexpHandle":
        """A handle from a file: blitzar_tpu's npz (a path ending in ".npz",
        or one whose file starts with the zip magic "PK", or that exists only
        with ".npz" appended), or else the reference's raw format
        (``msm/interop.py``). The table goes to ``device`` (the card unless
        the caller asks for the CPU)."""
        if os.path.exists(path) and not path.endswith(".npz"):
            with open(path, "rb") as f:
                if f.read(2) != b"PK":
                    from . import interop

                    return interop.read_reference_file(path, curve, device)
        with np.load(path if path.endswith(".npz") or os.path.exists(path) else path + ".npz") as data:
            if str(data["curve"]) != curve.name:
                raise ValueError(f"file holds a {data['curve']} table, not {curve.name}")
            point = type(curve.identity((0,)))
            coords = [torch.from_numpy(data[f"coord{i}"].astype(np.int32)).to(device)
                      for i in range(len(point._fields))]
            window_width, n = int(data["window_width"]), int(data["n"])
        if coords[0].shape[2] != 1 << window_width:
            raise ValueError(f"table of {coords[0].shape[2]} entries a group for window width {window_width}")
        return cls.from_point_table(point(*coords), n=n, curve=curve)


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


# ---------------------------------------------------------------------------
# the few-row partition query (blitzar_tpu/msm/fixed.py:522-592)
# ---------------------------------------------------------------------------

# groups a lookup launch takes a step, blitzar_tpu's LOOKUP_GT and
# W_LOOKUP_GT (ops/pallas_point.py:482, :600): the routing below keeps them
LOOKUP_GT = 16
W_LOOKUP_GT = 8
# groups of a table chunk of the few-row query (blitzar_tpu/msm/fixed.py:93-97)
TABLE_CHUNK_GROUPS = 1 << 10


def lookup_msm_fits(groups: int, v_dim: int, r_rows: int) -> bool:
    """Whether a ristretto255 query goes to ``ed_lookup_msm``
    (blitzar_tpu/ops/pallas_point.py:559-567): 2^8 entries a group, whole
    group tiles, at least 128 bit rows. Else the few-row query."""
    return v_dim == 256 and groups >= LOOKUP_GT and groups % LOOKUP_GT == 0 and r_rows >= 128


def w_lookup_msm_fits(groups: int, v_dim: int, r_rows: int) -> bool:
    """Whether a Weierstrass query goes to ``w_lookup_msm``
    (blitzar_tpu/ops/pallas_point.py:660-666)."""
    return v_dim == 256 and groups >= W_LOOKUP_GT and groups % W_LOOKUP_GT == 0 and r_rows >= 128


def table_chunk_groups(groups: int) -> int:
    """Groups per table chunk (blitzar_tpu's _table_chunk_groups): the
    largest power of two up to ``TABLE_CHUNK_GROUPS`` that divides the
    group count, else its largest divisor up to that."""
    gc = min(TABLE_CHUNK_GROUPS, groups)
    p2 = 1 << (gc.bit_length() - 1)
    while p2 > 1 and groups % p2:
        p2 //= 2
    if p2 > 1:
        return p2
    while groups % gc:
        gc -= 1
    return gc


def _chunk_sums(sel: torch.Tensor, curve):
    """(size, cols, coords, words) selected table entries -> (cols,) sums
    over the leading axis, by the table's entry form: niels entries by
    ``niels_add`` on the two halves (even size) or the extended form (odd),
    then ``tree_reduce_lanes``; cached entries and Weierstrass points in
    their coordinates, then ``tree_reduce_lanes``."""
    size = sel.shape[0]
    if curve is not ed:
        return sum_leading(cuda_wpoint.unpack_points(sel), curve)
    if sel.shape[2] == 4:
        return sum_leading(ed.cached_to_p3(cuda_point.unpack_cached(sel)))
    niels = cuda_point.unpack_niels(sel)
    if size % 2:
        return sum_leading(ed.niels_to_p3(niels))
    half = size // 2
    lo = ed.Niels(*(c[:, :half] for c in niels))
    hi = ed.Niels(*(c[:, half:] for c in niels))
    return sum_leading(cuda_point.niels_add(lo, hi))


def fewrow_products(table: torch.Tensor, scalars: torch.Tensor, signs, w: int, curve=ed):
    """(R,) bit-row products of a query that no lookup kernel takes
    (:func:`lookup_msm_fits`): blitzar_tpu's one-hot einsum branch, over
    table chunks of gc = :func:`table_chunk_groups` groups. On a niels table
    whose gc fits ``fewrow_niels`` (a power of two in (128, 2048]) one launch
    forms the (chunks, R) column sums from the table and the scalar bytes.
    Otherwise, for each block of rows (its selected entries under
    ``cuda_point.FEWROW_BUDGET_BYTES``), the entry each (row, group) selects is
    gathered from the table as (gc, chunks x rows) entries and each chunk's
    column summed (:func:`_chunk_sums`); the gathers are plain torch, as the
    einsum is XLA in blitzar_tpu. Then one ``tree_reduce_lanes`` sums the
    chunks of each row."""
    gc = table_chunk_groups(table.shape[0])
    nc = table.shape[0] // gc
    if curve is ed and table.shape[2] == 3 and cuda_point.niels_tree_fits(gc):
        return sum_leading(cuda_point.fewrow_niels(table, scalars, signs, w, gc))
    idx = cuda_point.query_index(scalars, signs, w)  # (R, G)
    out = []
    for rows in cuda_point.fewrow_blocks(table, idx.shape[0]):
        sums = curve.reshape_batch(_chunk_sums(chunk_entries(table, idx[rows], w), curve), (nc, -1))
        out.append(sum_leading(sums, curve))
    return out[0] if len(out) == 1 else curve.cat(out)


def chunk_entries(table: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    """The entries that (rows, G) table indices select, as (gc, chunks x
    rows, coords, words): column (k, r) holds row r's entries of chunk k's
    gc = :func:`table_chunk_groups` groups."""
    groups = table.shape[0]
    gc = table_chunk_groups(groups)
    nc = groups // gc
    flat = table.reshape((groups << w,) + tuple(table.shape[2:]))
    base = (torch.arange(groups, device=table.device) << w).reshape(nc, gc).T  # (gc, nc): group j of chunk k
    ix = idx.T.reshape(nc, gc, -1).permute(1, 0, 2)  # (gc, nc, rows)
    return flat[(base[:, :, None] + ix).reshape(gc, -1)]


def table_products(table: torch.Tensor, scalars: torch.Tensor, signs, w: int, curve=ed):
    """(R,) bit-row products of one table (rows as in cuda_point.query_index):
    the lookup kernel where blitzar_tpu takes its lookup kernel, else the
    few-row query. Both give the same points."""
    groups, v_dim = table.shape[0], table.shape[1]
    rows = (1 if signs is None else 2) * scalars.shape[0] * 8 * scalars.shape[2]
    if curve is ed and lookup_msm_fits(groups, v_dim, rows):
        return sum_leading(cuda_point.ed_lookup_msm(table, scalars, signs, w))
    if curve is not ed and w_lookup_msm_fits(groups, v_dim, rows):
        return sum_leading(cuda_wpoint.w_lookup_msm(curve, table, scalars, signs, w), curve)
    return fewrow_products(table, scalars, signs, w, curve)


def partition_products(handle: MultiexpHandle, scalars: torch.Tensor, signs=None):
    """(R,) bit-row products of a handle's query (:func:`table_products`)."""
    return table_products(handle.table, scalars, signs, handle.window_width, handle.curve)


def stream_products(points, scalars: torch.Tensor, signs=None, window_width: int = DEFAULT_WINDOW_WIDTH, curve=ed):
    """(R,) bit-row products of a streamed query: scalars (O, n_pad, nbytes)
    and signs (O, n_pad) (or None) on the points' device, n_pad a multiple
    of the window; points (nlimbs, >= 0), identities standing in for any
    past their end. Chunk by chunk of ``STREAM_CHUNK_POINTS`` (rounded down
    to whole groups, the last one short): the chunk's table is built,
    queried with its slice of the scalars (read in place;
    :func:`table_products`) and dropped; the chunks' (R,) products are
    summed at the end.
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
        else:
            table = cuda_wpoint.w_build_table(curve, pts, w)
        per_chunk.append(table_products(table, sc, sg, w, curve))
        del table
    if len(per_chunk) == 1:
        return per_chunk[0]
    return sum_leading(curve.cat([curve.reshape_batch(p, (1, -1)) for p in per_chunk]), curve)


def doubling_combine(products, num_outputs: int, nbits: int, curve=ed):
    """(R,) = (num_outputs * nbits,) products -> (num_outputs,) outputs:
    sum_b 2^b * products[o * nbits + b]."""
    rows = curve.reshape_batch(products, (num_outputs, nbits))
    if curve is ed:
        return cuda_point.doubling_combine(rows)
    return cuda_wpoint.w_doubling_combine(curve, rows)


def combine_signed(products, num_outputs: int, nbits: int, curve=ed):
    """(2 * num_outputs * nbits,) products of positive then negative rows
    -> (num_outputs,) outputs Q_pos - Q_neg (blitzar_tpu/msm/fixed.py:655-707):
    one ``ed_add`` or ``wadd`` launch that reads Q_neg negated."""
    both = doubling_combine(products, 2 * num_outputs, nbits, curve)
    q_pos = curve.index_batch(both, slice(0, num_outputs))
    q_neg = curve.index_batch(both, slice(num_outputs, 2 * num_outputs))
    if curve is ed:
        return cuda_point.ed_add(q_pos, q_neg, negate_q=True)
    return cuda_wpoint.wadd(curve, q_pos, q_neg, negate_q=True)


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


# ---------------------------------------------------------------------------
# packed and vlen queries (blitzar_tpu/msm/fixed.py:898-1018)
# ---------------------------------------------------------------------------


def _mask_lengths(packed: torch.Tensor, bit_table: list[int], lengths: list[int]) -> None:
    """Zero, in place, bit b of generator g's packed row wherever g is at or
    past the length of the output that owns bit b (bits past the table's
    sum own length 0). Per bit, not per byte: a byte may hold bits of two
    outputs of different lengths. The kept bits of a byte column change only
    at the lengths, so each span between two consecutive lengths takes one
    byte mask."""
    n_pad, num_bytes = packed.shape
    per_bit = np.zeros(8 * num_bytes, np.int64)
    start = 0
    for nb, length in zip(bit_table, lengths):
        per_bit[start : start + nb] = length
        start += nb
    bounds = sorted({0, n_pad, *(min(length, n_pad) for length in lengths)})
    for lo, hi in zip(bounds, bounds[1:]):
        # every g in [lo, hi) is below a bit's length iff the length is >= hi
        mask = np.packbits(per_bit >= hi, bitorder="little")
        if (mask != 0xFF).any():
            packed[lo:hi] &= torch.from_numpy(mask).to(packed.device)


def _packed_query(handle: MultiexpHandle, output_bit_table, n: int, scalars, output_lengths=None):
    """(O,) outputs of a packed query: scalars (n, num_bytes) uint8, bits
    LSB-first across a generator's row, output o taking the bit_table[o]
    bits after those of outputs 0..o-1. The packed rows go through one
    query as one output of num_bytes bytes (8 num_bytes bit-row products);
    each output's rows are picked from those and padded with identities to
    max(bit_table) bits (zero rows at high bits add nothing), so one ladder
    combines every output. With ``output_lengths``, the bits of output o at
    generators >= lengths[o] are zeroed first. An output of width 0 has no
    bit rows: all its picks are the identity, and so is the output
    (blitzar_tpu/msm/fixed.py:902-945); when every width is 0, every output
    is the identity (blitzar_tpu divides by zero there)."""
    curve = handle.curve
    bit_table = [int(b) for b in output_bit_table]
    if min(bit_table, default=0) < 0:
        raise ValueError(f"output bit widths must be non-negative, got {bit_table}")
    maxb = max(bit_table, default=0)
    if maxb == 0:
        return curve.identity((len(bit_table),), handle.device)
    num_bytes = -(-sum(bit_table) // 8)
    packed = np.asarray(scalars, np.uint8).reshape(n, num_bytes)
    dev_scalars = _scalars_tensor(handle, packed[None])  # (1, n_pad, num_bytes)
    if output_lengths is not None:
        # a copy: on the CPU the tensor may share the caller's array
        dev_scalars = dev_scalars.clone()
        _mask_lengths(dev_scalars[0], bit_table, output_lengths)
    products = partition_products(handle, dev_scalars)  # (8 num_bytes,)
    pad = 8 * num_bytes  # the identity appended below
    picks, start = [], 0
    for nb in bit_table:
        picks += list(range(start, start + nb)) + [pad] * (maxb - nb)
        start += nb
    rows = curve.cat([products, curve.identity((1,), handle.device)])
    rows = curve.index_batch(rows, torch.tensor(picks, device=handle.device))
    return doubling_combine(rows, len(bit_table), maxb, curve)


def fixed_packed_multiexponentiation(handle: MultiexpHandle, output_bit_table, n: int, scalars):
    """Reference sxt_fixed_packed_multiexponentiation (blitzar_api.h:712):
    scalars (n * num_bytes,) or (n, num_bytes) uint8, num_bytes =
    ceil(sum(output_bit_table) / 8) -> (len(output_bit_table),) points."""
    return _packed_query(handle, output_bit_table, int(n), scalars)


def fixed_vlen_multiexponentiation(handle: MultiexpHandle, output_bit_table, output_lengths, scalars):
    """Reference sxt_fixed_vlen_multiexponentiation (blitzar_api.h:741): as
    the packed query over n = max(output_lengths) generators, output o using
    only its first output_lengths[o]; the lengths must be ascending."""
    lengths = [int(v) for v in output_lengths]
    if len(lengths) != len(output_bit_table):
        raise ValueError(f"{len(lengths)} lengths for {len(output_bit_table)} outputs")
    if any(a > b for a, b in zip(lengths, lengths[1:])) or (lengths and lengths[0] < 0):
        raise ValueError(f"output_lengths must be non-negative and ascending, got {lengths}")
    return _packed_query(handle, output_bit_table, max(lengths, default=0), scalars, lengths)
