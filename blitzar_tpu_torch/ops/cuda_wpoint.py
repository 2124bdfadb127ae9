"""The CUDA kernels of the short-Weierstrass commitment path (bls12-381 G1,
bn254 G1, Grumpkin): wrappers, plain versions, counts.

Each wrapper takes the curve (``curves/weierstrass.py``) and tensors in the
public layout (field batches (nlimbs, *batch) int32 Montgomery limbs, point
batches ``PointP2`` of three of them, limb axis leading). On a tensor that
lies on the CPU it runs the plain PyTorch version beside it; on a CUDA
tensor it checks device, dtype, shape and layout, allocates the outputs,
launches its kernel from ``csrc/`` on the current stream and adds one to
``cuda_point.LAUNCHES[name]``, or raises. The plain versions serve the CPU
tests and the comparisons of ``chip_smoke.py``; nothing on the card's main
path calls them. One template per kernel covers the three curves; the
launcher picks the instantiation by ``curve.kernel_id``.

The kernels and the TPU kernels they replace (all in
``blitzar_tpu/ops/pallas_point.py``):

=======================  =================================================  ======================
wrapper                  replaces                                           source
=======================  =================================================  ======================
``w_build_table``        ``_build_split_tiled`` :806 (Weierstrass, :789)     w_build_table.cu
``w_lookup_msm``         ``_w_lookup_tiled`` :636                           w_lookup_msm.cu
``wadd``                 ``_wadd_tiled`` :891                               wadd.cu
``wdouble``              ``_wdouble_tiled`` :907                            wdouble.cu
``w_tree_reduce_lanes``  ``_tree_tiled`` :344 (Weierstrass)                 tree_reduce_lanes.cu
``w_doubling_combine``   ``_wdouble_tiled`` :907 + ``_wadd_tiled`` :891 in   w_doubling_combine.cu
                         blitzar_tpu/msm/fixed.py:596-623's ladder
``w_affine``             the files path's batch inversion on ``mont_mul_ew``   w_affine.cu
                         :1139 (blitzar_tpu/msm/interop.py:_w_affine_xy)
``w_horner``             ``_wdouble_tiled`` :907 + ``_wadd_tiled`` :891 in   w_horner.cu
                         the bucket engine's Horner
``w_window_sums``        ``_wadd_tiled`` :891 (the bucket engine's scan) +  window_sums.cu
                         ``_tree_tiled`` :344
=======================  =================================================  ======================

``w_doubling_combine`` is the double-and-add ladder of a query as one
launch over all its outputs, where blitzar_tpu launches ``wdouble`` and
``wadd`` once each per bit. ``w_affine`` puts a chunk of a table in the
affine form of the reference's raw file in one launch, where the files
path ran a batch inversion of 3 x 255 ``mont_mul_ew`` launches a chunk.
``w_horner`` is the bucket engine's Horner over a commitment's 8-bit
windows as one launch (the ladder with 8 doublings a step), where the
engine launched ``wdouble`` 8 times and ``wadd`` once a window.

Launches count under the kernel's name in ``cuda_point.LAUNCHES`` and per
curve in ``cuda_point.INSTANCE_LAUNCHES`` (``w_tree_reduce_lanes`` as
``tree_reduce_lanes``, whose ristretto255 instantiation is in
``ops/cuda_point.py``).

A handle's table is (G, 2^w, 3, K) int32 words: entry v of group g holds the
projective (X, Y, Z) of its subset sum as K = nlimbs / 2 canonical 32-bit
Montgomery words each (96 bytes an entry for bn254 and Grumpkin, 144 for
bls12-381).
"""

from __future__ import annotations

import torch

from ..curves.weierstrass import PointP2, WCurve
from ..utils.limbs import limbs16_to_u64
from . import build
from .cuda_point import (
    HORNER_STEP_BITS, WINDOW_BUCKETS, _check_query, _empty_point, _launch, _on_card, _point_arg, _ptrs, _stream,
    check_buckets, ladder_plain, ladder_segment_bits, limbs_to_words, lookup_chunks, lookup_walk, query_args,
    tree_launch, window_sums_plain, words_to_limbs,
)

# ---------------------------------------------------------------------------
# table entries
# ---------------------------------------------------------------------------


def pack_points(p: PointP2) -> torch.Tensor:
    """PointP2 (nlimbs, *batch) -> (*batch, 3, K) int32 table entries."""
    return torch.stack([limbs_to_words(c) for c in p], dim=-2)


def unpack_points(entries: torch.Tensor) -> PointP2:
    """(*batch, 3, K) table entries -> PointP2 (2K, *batch)."""
    return PointP2(*(words_to_limbs(entries[..., k, :]) for k in range(3)))


# ---------------------------------------------------------------------------
# wadd  (replaces pallas_point.py:_wadd_tiled :891 / wadd :943)
# ---------------------------------------------------------------------------


def wadd_plain(curve: WCurve, p: PointP2, q: PointP2, negate_q: bool = False) -> PointP2:
    return curve._add_impl(p, curve.neg(q) if negate_q else q)


def wadd(curve: WCurve, p: PointP2, q: PointP2, negate_q: bool = False) -> PointP2:
    """Elementwise complete p + q over equal batch shapes, or p - q with
    ``negate_q`` (q read as (X, -Y, Z), no pass first).

    Kernel csrc/wadd.cu: eight lanes of a warp a pair (csrc/wadd_lanes.cuh).
    Bound: the launch and one lane's 2 dependent multiplies at the paths'
    batches (the signed query's Q_pos - Q_neg); integer multiplies (12 field
    multiplies a pair) at large ones (the bucket engine's round adds)."""
    if not _on_card(p.x):
        return wadd_plain(curve, p, q, negate_q)
    batch = tuple(p.x.shape[1:])
    pc, ps = _point_arg(p, p.x.device, batch, curve.nlimbs)
    qc, qs = _point_arg(q, p.x.device, batch, curve.nlimbs)
    out = _empty_point(batch, p.x.device, PointP2, curve.nlimbs)
    _launch(
        "wadd", build.library().btt_wadd,
        curve.kernel_id, *_ptrs(pc), ps, *_ptrs(qc), qs, int(negate_q), p.x[0].numel(), *_ptrs(out),
        _stream(p.x.device), instance=curve.name,
    )
    return out


# ---------------------------------------------------------------------------
# wdouble  (replaces pallas_point.py:_wdouble_tiled :907 / wdouble :948)
# ---------------------------------------------------------------------------


def wdouble_plain(curve: WCurve, p: PointP2) -> PointP2:
    return curve._double_impl(p)


def wdouble(curve: WCurve, p: PointP2) -> PointP2:
    """Elementwise complete 2p.

    Kernel csrc/wdouble.cu, one thread per element. Bound: integer
    multiplies at large batches (8 field multiplies per element); launch
    latency for one point (the bucket engine's Horner steps)."""
    if not _on_card(p.x):
        return wdouble_plain(curve, p)
    batch = tuple(p.x.shape[1:])
    pc, ps = _point_arg(p, p.x.device, batch, curve.nlimbs)
    out = _empty_point(batch, p.x.device, PointP2, curve.nlimbs)
    _launch(
        "wdouble", build.library().btt_wdouble,
        curve.kernel_id, *_ptrs(pc), ps, p.x[0].numel(), *_ptrs(out), _stream(p.x.device),
        instance=curve.name,
    )
    return out


# ---------------------------------------------------------------------------
# w_build_table  (replaces pallas_point.py:_build_split_tiled :806, W form)
# ---------------------------------------------------------------------------


def w_build_table_plain(curve: WCurve, points: PointP2, w: int) -> torch.Tensor:
    """Subset sums by w doubling concatenations (table_{j+1} = [table_j |
    table_j + G_j], blitzar_tpu's order), projective, packed."""
    groups = points.x.shape[1] // w
    pts = curve.reshape_batch(points, (groups, w))
    table = curve.identity((groups, 1), points.x.device)
    for j in range(w):
        gj = PointP2(*(c[:, :, j : j + 1].expand_as(tc) for c, tc in zip(pts, table)))
        table = curve.cat([table, curve._add_impl(table, gj)], dim=2)
    return pack_points(table)


def w_build_table(curve: WCurve, points: PointP2, w: int) -> torch.Tensor:
    """Partition table of points (nlimbs, G*w): (G, 2^w, 3, K) int32 words,
    entry v of group g = the sum of points g*w + j over the set bits j of v,
    projective and in blitzar_tpu's order of additions (so equal to its
    table bit for bit); entry 0 is the identity (0, 1, 0).

    Kernel csrc/w_build_table.cu on csrc/table_build.cuh's lane schedule
    (``build_cached_table``'s): lane t of a group builds entries t + 2^L k
    (4 lanes up to w = 8, 2^(w - 6) above), each by one complete add to
    its parent entry, which the lane stored earlier. Bound: integer
    multiplies (2^w - 1 adds of 12 field multiplies per group); w <= 30."""
    n_pad = points.x.shape[1]
    if n_pad % w:
        raise ValueError(f"point count {n_pad} is not a multiple of the window {w}")
    groups = n_pad // w
    if not _on_card(points.x):
        return w_build_table_plain(curve, points, w)
    if w > 30:
        raise ValueError(f"w_build_table takes windows of 1..30 bits, not {w}")
    coords, stride = _point_arg(points, points.x.device, (n_pad,), curve.nlimbs)
    table = torch.empty((groups, 1 << w, 3, curve.nlimbs // 2), dtype=torch.int32, device=points.x.device)
    _launch(
        "w_build_table", build.library().btt_w_build_table,
        curve.kernel_id, *_ptrs(coords), stride, w, groups, table.data_ptr(), _stream(points.x.device),
        instance=curve.name,
    )
    return table


# ---------------------------------------------------------------------------
# w_lookup_msm  (replaces pallas_point.py:_w_lookup_tiled :636)
# ---------------------------------------------------------------------------


def w_lookup_msm_plain(curve: WCurve, table, scalars, signs, w: int, chunks=None) -> PointP2:
    """The partials of :func:`w_lookup_msm`, in the kernel's order of
    additions. ``chunks`` (a 1-D index tensor) computes only those chunks,
    (nlimbs, len(chunks), R): the comparison of a full-size run on a sample."""
    shape, steps = lookup_walk(table, scalars, signs, w, chunks)
    acc = curve.identity(shape, table.device)
    for ix, entries in steps:
        acc = curve.select(acc, curve._add_impl(acc, unpack_points(entries)), ix != 0)
    return acc


def w_lookup_msm(curve: WCurve, table: torch.Tensor, scalars: torch.Tensor, signs, w: int) -> PointP2:
    """Per-chunk partition products of a query: (nlimbs, K, R) partials
    whose sum over K is row r's sum over groups g of table[g, idx[r, g]]
    (rows and indices as ``cuda_point.query_index``; ``cuda_point.lookup_chunks``,
    the rule of ``ed_lookup_msm``, gives K). scalars: (O, G*w, nbytes) uint8
    magnitudes; signs: (O, G*w) uint8 (1 = negative) or None.

    Scalars and signs may be column slices of longer rows
    (``cuda_point.query_args``).

    Kernel csrc/w_lookup_msm.cu, thread (k, r) runs csrc/lookup.cuh's
    schedule with the Weierstrass entry form: it gathers projective entries
    and accumulates with complete adds, skipping entry 0. Bound: integer
    multiplies, 12 field multiplies per nonzero index."""
    groups = _check_query(table, scalars, signs, w, {(3, curve.nlimbs // 2)})
    if not _on_card(table):
        return w_lookup_msm_plain(curve, table, scalars, signs, w)
    device = table.device
    table, scalars, signs, row = query_args(table, scalars, signs)
    num_outputs, n_pad, nbytes = scalars.shape
    rows = (2 if signs is not None else 1) * num_outputs * 8 * nbytes
    chunk_groups, nchunks = lookup_chunks(groups, rows)
    out = _empty_point((nchunks, rows), device, PointP2, curve.nlimbs)
    _launch(
        "w_lookup_msm", build.library().btt_w_lookup_msm,
        curve.kernel_id, table.data_ptr(), scalars.data_ptr(), None if signs is None else signs.data_ptr(),
        num_outputs, n_pad, row, nbytes, w, chunk_groups, nchunks, *_ptrs(out), _stream(device),
        instance=curve.name,
    )
    return out


# ---------------------------------------------------------------------------
# w_tree_reduce_lanes  (replaces pallas_point.py:_tree_tiled :344, Weierstrass)
# ---------------------------------------------------------------------------


def w_tree_reduce_lanes_plain(curve: WCurve, p: PointP2) -> PointP2:
    return curve.tree_reduce(p, p.x.shape[1])


def w_tree_reduce_lanes(curve: WCurve, p: PointP2) -> PointP2:
    """(nlimbs, size, *rest) -> (nlimbs, *rest): the sum over the leading
    batch axis in one launch, the same point as the plain halving tree (its
    projective coordinates differ: another order of additions).

    Kernel csrc/tree_reduce_lanes.cu (one template with ristretto255's):
    lanes on neighbouring columns, warps and blocks on shares of the leading
    axis. Bound: operations and bytes (each point read once) at large size;
    the depth of the tree with few points."""
    if p.x.shape[1] == 0 or not _on_card(p.x):
        return w_tree_reduce_lanes_plain(curve, p)
    return tree_launch(curve.kernel_id, curve.name, p, curve.nlimbs, PointP2)


# ---------------------------------------------------------------------------
# w_doubling_combine  (replaces blitzar_tpu/msm/fixed.py:596-623's ladder on
# pallas_point.py:_wdouble_tiled :907 and _wadd_tiled :891)
# ---------------------------------------------------------------------------


def w_doubling_combine_plain(curve: WCurve, products: PointP2, seg_bits: int | None = None) -> PointP2:
    """:func:`w_doubling_combine` by ``wdouble_plain`` and ``wadd_plain`` in
    the kernel's order (csrc/ladder.cuh, ``cuda_point.ladder_plain``).
    ``seg_bits = nbits`` is blitzar_tpu's ladder."""
    return ladder_plain(curve, products, seg_bits or ladder_segment_bits(products.x.shape[2]))


def w_doubling_combine(curve: WCurve, products: PointP2, seg_bits: int | None = None) -> PointP2:
    """(nlimbs, O, nbits) bit-row products -> (nlimbs, O) outputs:
    sum_b 2^b * products[:, o, b], read in place (limb-major).

    Kernel csrc/w_doubling_combine.cu, one launch for all outputs: one warp
    an output, lanes on segments of ``seg_bits`` bits (default
    ``ladder_segment_bits``) by Horner, lane 0 folds them
    (csrc/ladder.cuh, the ladder of ``doubling_combine``). Its coordinates
    equal :func:`w_doubling_combine_plain`'s with the same ``seg_bits`` and
    are the same points as blitzar_tpu's ladder. Bound: latency (the top
    bit's nbits - 1 doublings are a serial chain)."""
    if not _on_card(products.x):
        return w_doubling_combine_plain(curve, products, seg_bits)
    num_outputs, nbits = products.x.shape[1], products.x.shape[2]
    if nbits < 1:
        raise ValueError("a ladder needs at least one bit")
    device = products.x.device
    coords, stride = _point_arg(products, device, (num_outputs, nbits), curve.nlimbs)
    out = _empty_point((num_outputs,), device, PointP2, curve.nlimbs)
    _launch(
        "w_doubling_combine", build.library().btt_w_doubling_combine,
        curve.kernel_id, *_ptrs(coords), stride, num_outputs, nbits, seg_bits or ladder_segment_bits(nbits),
        *_ptrs(out), _stream(device), instance=curve.name,
    )
    return out


# ---------------------------------------------------------------------------
# w_affine  (the files path's batch inversion, which ran on
# pallas_point.py:mont_mul_ew :1139; blitzar_tpu/msm/interop.py:_w_affine_xy)
# ---------------------------------------------------------------------------

def _check_entries(curve: WCurve, entries: torch.Tensor) -> None:
    k = curve.nlimbs // 2
    if entries.dim() != 4 or tuple(entries.shape[2:]) != (3, k) or entries.dtype != torch.int32:
        raise ValueError(f"table chunk {tuple(entries.shape)} {entries.dtype}: expected (g, V, 3, {k}) int32")


def w_affine_plain(curve: WCurve, entries: torch.Tensor) -> torch.Tensor:
    """:func:`w_affine` in plain PyTorch: Montgomery's trick over a table's
    inversion rows (``msm/fixed.py:lane_rows``; ``MontField``'s
    ``batch_invert_lanes``: zeros stand as one, each row's total inverted by
    exponentiation), then x / z and y / z and the file's words."""
    from ..msm.fixed import lane_rows  # msm.fixed imports this module

    _check_entries(curve, entries)
    f = curve.field
    p = unpack_points(entries)
    zinv = f.batch_invert_lanes(lane_rows(p.z)).reshape(f.nlimbs, -1)
    x = f.mul(p.x.reshape(f.nlimbs, -1), zinv)
    y = f.mul(p.y.reshape(f.nlimbs, -1), zinv)
    xw, yw = limbs16_to_u64(x), limbs16_to_u64(y)
    inf = f.is_zero(p.z.reshape(f.nlimbs, -1))
    xw[inf] = 0
    xw[inf, -1] = -1  # 2^64 - 1
    yw[inf] = limbs16_to_u64(f.one((1,), entries.device))
    return torch.cat([xw, yw], dim=1)


def w_affine(curve: WCurve, entries: torch.Tensor) -> torch.Tensor:
    """A (g, V, 3, K) chunk of a table -> (g V, nlimbs / 2) int64 rows of the
    reference's raw file: affine {x, y} as canonical Montgomery u64 words,
    an identity entry (z = 0) as x = 0 with its last word 2^64 - 1 and y the
    Montgomery one (blitzar_tpu/msm/interop.py:_w_affine_xy and :100-113).

    Kernel csrc/w_affine.cu, one launch: each thread runs Montgomery's
    trick over 32, 64 or 128 entries of the chunk (a power of two, the
    chunk over 2^15 threads; 5 field multiplies an entry) and inverts their
    product on the card. Bound: integer multiplies."""
    _check_entries(curve, entries)
    if not _on_card(entries):
        return w_affine_plain(curve, entries)
    if not entries.is_contiguous():
        entries = entries.contiguous()
    count = entries.shape[0] * entries.shape[1]
    rows = torch.empty((count, curve.nlimbs // 2), dtype=torch.int64, device=entries.device)
    _launch(
        "w_affine", build.library().btt_w_affine,
        curve.kernel_id, entries.data_ptr(), count, rows.data_ptr(), _stream(entries.device),
        instance=curve.name,
    )
    return rows


# ---------------------------------------------------------------------------
# w_horner  (replaces the bucket engine's Horner on pallas_point.py:
# _wdouble_tiled :907 and _wadd_tiled :891)
# ---------------------------------------------------------------------------


def w_horner_plain(curve: WCurve, windows: PointP2, seg_bits: int | None = None) -> PointP2:
    """:func:`w_horner` by ``wdouble_plain`` and ``wadd_plain`` in the
    kernel's order (``cuda_point.ladder_plain``, 8 doublings a step). By
    default in one segment: the engine's loop
    (``msm/engine.py:horner_plain``), limb for limb."""
    return ladder_plain(curve, windows, seg_bits or windows.x.shape[2], HORNER_STEP_BITS)


def w_horner(curve: WCurve, windows: PointP2, seg_bits: int | None = None) -> PointP2:
    """(nlimbs, O, W) window sums -> (nlimbs, O) outputs: sum_w 2^(8 w)
    windows[:, o, w], the bucket engine's Horner (8 doublings and an add a
    window), read in place (limb-major).

    Kernel csrc/w_horner.cu, one launch for all outputs: csrc/ladder.cuh's
    ladder with 8 doublings a step (that of ``w_doubling_combine``), one warp
    an output, lanes on segments of ``seg_bits`` windows (default
    ``ladder_segment_bits``). Its coordinates equal :func:`w_horner_plain`'s
    with the same ``seg_bits``, which a CPU tensor gets (one segment by
    default). Bound: latency (8 (W - 1) dependent doublings)."""
    num_outputs, num_windows = windows.x.shape[1], windows.x.shape[2]
    if num_windows < 1:
        raise ValueError("a Horner sum needs at least one window")
    if not _on_card(windows.x):
        return w_horner_plain(curve, windows, seg_bits)
    device = windows.x.device
    coords, stride = _point_arg(windows, device, (num_outputs, num_windows), curve.nlimbs)
    out = _empty_point((num_outputs,), device, PointP2, curve.nlimbs)
    _launch(
        "w_horner", build.library().btt_w_horner,
        curve.kernel_id, *_ptrs(coords), stride, num_outputs, num_windows,
        seg_bits or ladder_segment_bits(num_windows), *_ptrs(out), _stream(device), instance=curve.name,
    )
    return out


# ---------------------------------------------------------------------------
# w_window_sums  (replaces the bucket engine's scan on pallas_point.py:
# _wadd_tiled :891 and its sum on _tree_tiled :344)
# ---------------------------------------------------------------------------


def w_window_sums_plain(curve: WCurve, buckets: PointP2) -> PointP2:
    return window_sums_plain(curve, buckets)


def w_window_sums(curve: WCurve, buckets: PointP2) -> PointP2:
    """(nlimbs, R, 255) bucket sums -> (nlimbs, R): each row's sum_k k S_k,
    the same points as :func:`w_window_sums_plain` (which a CPU tensor gets:
    blitzar_tpu's order).

    Kernel csrc/window_sums.cu (one template with ristretto255's), one
    launch for all rows: one warp a row, lanes on strided runs of buckets, a
    suffix scan and a halving by shuffles. Bound: latency (29 dependent
    complete adds and doublings a row)."""
    rows = check_buckets(buckets)
    if not _on_card(buckets.x):
        return w_window_sums_plain(curve, buckets)
    device = buckets.x.device
    coords, stride = _point_arg(buckets, device, (rows, WINDOW_BUCKETS), curve.nlimbs)
    out = _empty_point((rows,), device, PointP2, curve.nlimbs)
    if rows:
        _launch(
            "w_window_sums", build.library().btt_w_window_sums,
            curve.kernel_id, *_ptrs(coords), stride, rows, *_ptrs(out), _stream(device), instance=curve.name,
        )
    return out
