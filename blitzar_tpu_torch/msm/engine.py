"""Pedersen-commitment MSM entry of the port (blitzar_tpu/msm/engine.py),
curve-generic: ristretto255 (the ``curves.edwards25519`` module) or a
short-Weierstrass curve (``curves.weierstrass.WCurve``).

The dispatch of blitzar_tpu/msm/engine.py:359-455 on its accelerator:

- with ``BLITZAR_TPU_TORCH_MSM_ENGINE=bucket`` (read at each call; blitzar_tpu's
  ``BLITZAR_TPU_MSM_ENGINE``), the bucket engine below, at any n;
- over more than ``STREAM_ABOVE`` (2^20) generators, the streamed
  build+query of ``msm/fixed.py`` (no persistent table);
- everything else: the handle path of ``msm/fixed.py``, through a small
  cache of handles keyed by the curve, tensor identity and version, and a
  content digest confirmed by a full compare.

blitzar_tpu also streams the first MSM over a fresh set of at most 4096
points (its engine.py:285-303). On an H100 that first commitment took as
long through a new handle as streamed (the encode dominates both), so the
port keeps the one path below 2^20 and builds the handle at once.

The bucket engine (blitzar_tpu/msm/engine.py:41-207) splits each scalar
into 8-bit windows; per (output, window) row it sorts the point indices by
digit, finds each of the 255 buckets' runs by ``searchsorted``, gathers them
into (C, rows, 255) slabs (identities in the unused slots, points negated
where a sign is set) and sums each slab on ``tree_reduce_lanes``, a round
more while a bucket holds more than C points; then each row's window sum
sum_b b S_b is one ``ed_window_sums`` / ``w_window_sums`` launch for all
rows (where blitzar_tpu runs a reverse scan over the buckets and their
tree), and Horner combines the windows with 8 doublings a step, one
``ed_horner`` / ``w_horner`` launch for all outputs (the ladder of the
queries, where blitzar_tpu launches its double and add kernels once each a
step). The sort, the search and the gathers are plain torch, as
blitzar_tpu leaves them to XLA.

The point that comes out is the same on every path.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..fields import fp25519 as F
from ..ops import cuda_point, cuda_wpoint
from . import fixed


def prepare_scalars(data_list, nbytes_list, signed_list, n_max=None):
    """Exponent sequences -> (scalars (O, n, max_nbytes) uint8 magnitudes,
    signs (O, n) uint8, n). Signed rows are two's complement: a negative
    row is negated bytewise and its sign set (the reference's
    exponent_sequence contract)."""
    num_outputs = len(data_list)
    n = n_max if n_max is not None else max((d.shape[0] for d in data_list), default=0)
    max_nbytes = max(nbytes_list, default=1)
    scalars = np.zeros((num_outputs, n, max_nbytes), dtype=np.uint8)
    signs = np.zeros((num_outputs, n), dtype=np.uint8)
    for o, (data, nbytes, is_signed) in enumerate(zip(data_list, nbytes_list, signed_list)):
        rows = np.asarray(data, dtype=np.uint8).reshape(-1, nbytes)
        ni = rows.shape[0]
        if ni == 0:
            continue
        if is_signed:
            neg = rows[:, -1] >= 0x80
            comp = (~rows).astype(np.uint16)
            carry = np.ones(ni, dtype=np.uint16)
            out = np.zeros_like(rows)
            for b in range(nbytes):
                t = comp[:, b] + carry
                out[:, b] = (t & 0xFF).astype(np.uint8)
                carry = t >> 8
            rows = np.where(neg[:, None], out, rows)
            signs[o, :ni] = neg.astype(np.uint8)
        scalars[o, :ni, :nbytes] = rows
    return scalars, signs, n


# MSMs over more generators than this stream (blitzar_tpu/msm/engine.py:372)
STREAM_ABOVE = 1 << 20

# handles over recently used generator sets: [curve, coordinate tensors, n,
# digest, handle, their version counters, a copy of their x, y and z]
_HANDLE_CACHE: list = []
_HANDLE_CACHE_SLOTS = 4


def _curve_name(curve) -> str:
    return "ristretto255" if curve is ed else curve.name


def _content_digest(points, n: int, curve=ed) -> bytes:
    """Digest of the curve, n and the x and y limbs of the first and last
    four and 64 evenly spaced points: logically equal generators in a fresh
    tensor (a slice, a copy) find their handle, and equal limbs on two
    curves do not share one. A digest hit is only a candidate: the full
    content is compared next (:func:`cached_handle`)."""
    k = min(64, n)
    idx = np.unique(
        np.concatenate(
            [np.arange(min(4, n)), np.arange(max(n - 4, 0), n), np.linspace(0, n - 1, num=k, dtype=np.int64)]
        )
    )
    h = hashlib.blake2b(digest_size=16)
    h.update(_curve_name(curve).encode())
    h.update(n.to_bytes(8, "little"))
    sample = torch.as_tensor(idx, device=points.x.device)
    for c in (points.x, points.y):
        c = c[:, sample]
        # ristretto255 limbs need not be canonical; Montgomery limbs are
        h.update((F.canonicalize(c) if curve is ed else c).cpu().numpy().tobytes())
    return h.digest()


def _content(points, n: int, curve) -> tuple:
    """The first n points' x, y and z as the handle cache compares them:
    canonical limbs for ristretto255 (the same point in other limbs is the
    same content), the Montgomery limbs as they are otherwise. An extended
    point's t is x y / z, so it adds nothing to the compare."""
    coords = (c[:, :n] for c in (points.x, points.y, points.z))
    return tuple(F.canonicalize(c) if curve is ed else c.clone() for c in coords)


def cached_handle(points, n: int, curve=ed) -> fixed.MultiexpHandle:
    """The handle of the first n of ``points``, from the cache when it holds
    one of the same content. The same coordinate tensors, not written since
    (their ``_version`` counters), hit at once; other tensors whose digest
    matches hit only if their whole content equals the copy kept with the
    handle (one compare pass on the card). Anything else builds a handle."""
    versions = tuple(c._version for c in points)
    for entry in _HANDLE_CACHE:
        if (entry[0] is curve and entry[2] == n and entry[5] == versions
                and all(a is b for a, b in zip(entry[1], points))):
            return entry[4]
    digest = _content_digest(points, n, curve)
    content = None
    for entry in _HANDLE_CACHE:
        if entry[0] is curve and entry[2] == n and entry[3] == digest and entry[4].device == points.x.device:
            content = _content(points, n, curve) if content is None else content
            if all(torch.equal(a, b) for a, b in zip(entry[6], content)):
                entry[1], entry[5] = tuple(points), versions
                return entry[4]
    handle = fixed.MultiexpHandle(points, curve=curve, n=n)
    content = _content(points, n, curve) if content is None else content
    _HANDLE_CACHE.append([curve, tuple(points), n, digest, handle, versions, content])
    if len(_HANDLE_CACHE) > _HANDLE_CACHE_SLOTS:
        _HANDLE_CACHE.pop(0)
    return handle


def clear_handle_cache() -> None:
    _HANDLE_CACHE.clear()


# ---------------------------------------------------------------------------
# the bucket engine (blitzar_tpu/msm/engine.py:41-207)
# ---------------------------------------------------------------------------

ENGINE_VAR = "BLITZAR_TPU_TORCH_MSM_ENGINE"
NUM_BUCKETS = cuda_point.WINDOW_BUCKETS  # digits 1..255; digit 0 contributes nothing
# the gathered slab of a row block stays under this many bytes (its
# temporaries counted twice), as blitzar_tpu's GATHER_BUDGET_BYTES
GATHER_BUDGET_BYTES = 1 << 30


def choose_capacity(n: int) -> int:
    """Slots C per bucket in one round: random data fit in one round (mean
    + 6 sigma); skewed data take more rounds."""
    mean = max(n / NUM_BUCKETS, 1.0)
    c = int(mean + 6.0 * mean**0.5 + 8)
    c = min(c, n)
    return max(8, -(-c // 8) * 8)


def digit_decompose(scalars: torch.Tensor) -> torch.Tensor:
    """(O, n, nbytes) uint8 -> (O, nbytes, n) int64 digits (8-bit windows)."""
    return scalars.permute(0, 2, 1).to(torch.int64).contiguous()


def _point_bytes(curve) -> int:
    """Bytes of one point in the port's limb layout (int32 limbs)."""
    return 4 * sum(c.shape[0] for c in curve.identity((0,)))


def sort_digits(digits: torch.Tensor):
    """Each row's point indices sorted by digit (stable), and each bucket's
    run in them: (sorted indices (R, n), starts (R, 255), ends (R, 255))."""
    sorted_digits, sorted_idx = torch.sort(digits, dim=1, stable=True)
    boundaries = torch.arange(1, NUM_BUCKETS + 2, device=digits.device).expand(digits.shape[0], -1).contiguous()
    bounds = torch.searchsorted(sorted_digits, boundaries)  # (R, 256): first index with digit >= b
    return sorted_idx, bounds[:, :NUM_BUCKETS], bounds[:, 1:]


def gather_slab(points, sorted_idx, starts, ends, signs, rnd: int, capacity: int, curve=ed):
    """Round ``rnd``'s slab: slot j of bucket k of row r holds point
    sorted_idx[r, starts + rnd C + j] (negated where its sign is set) while
    that lies before the bucket's end, else the identity; laid out (C, R,
    255), so that its sum runs over the leading axis."""
    r_rows = sorted_idx.shape[0]
    dev = sorted_idx.device
    pos = starts[:, :, None] + rnd * capacity + torch.arange(capacity, device=dev)  # (R, 255, C)
    valid = pos < ends[:, :, None]
    src = torch.gather(sorted_idx, 1, torch.where(valid, pos, 0).reshape(r_rows, -1))
    src_t = src.reshape(r_rows, NUM_BUCKETS, capacity).permute(2, 0, 1).clamp(max=points.x.shape[1] - 1)
    slab = type(points)(*(c[:, src_t] for c in points))
    if signs is not None:
        neg = torch.gather(signs, 1, src).reshape(r_rows, NUM_BUCKETS, capacity).permute(2, 0, 1) == 1
        slab = curve.cneg(slab, neg)
    valid_t = valid.permute(2, 0, 1)
    return curve.select(curve.identity(tuple(valid_t.shape), dev), slab, valid_t)


def bucket_accumulate(points, digits: torch.Tensor, signs, capacity: int, curve=ed):
    """(R, 255) bucket sums: S[r, k] = the sum over {i : digits[r, i] = k + 1}
    of points[i], negated where signs[r, i] = 1. digits: (R, n) int64 in
    [0, 255], n at least the points' count (indices past the points carry
    digit 0); signs: (R, n) uint8 or None. Each round's slab is summed on
    ``tree_reduce_lanes``; rounds repeat while a bucket has more than C
    points left."""
    sorted_idx, starts, ends = sort_digits(digits)
    num_rounds = max(1, -(-int((ends - starts).max()) // capacity))
    acc = None
    for rnd in range(num_rounds):
        slab = gather_slab(points, sorted_idx, starts, ends, signs, rnd, capacity, curve)
        partial = fixed.sum_leading(slab, curve)
        acc = partial if acc is None else curve.add(acc, partial)
    return acc


def window_sums(bucket_sums, curve=ed):
    """(R, 255) bucket sums -> (R,) window sums sum_b b S_b: one
    ``ed_window_sums`` / ``w_window_sums`` launch for all rows (the points
    of ``cuda_point.window_sums_plain``, blitzar_tpu's reverse scan and
    tree, which a CPU tensor gets)."""
    if curve is ed:
        return cuda_point.ed_window_sums(bucket_sums)
    return cuda_wpoint.w_window_sums(curve, bucket_sums)


def horner_plain(windows, curve=ed):
    """(O, W) window sums -> (O,): from the top window down, 8 doublings
    and an add a step, on the plain group law (blitzar_tpu/msm/engine.py:
    118-140's loop)."""
    num_windows = windows.x.shape[2]
    acc = curve.index_batch(windows, (slice(None), num_windows - 1))
    for idx in range(num_windows - 2, -1, -1):
        for _ in range(8):
            acc = curve._double_impl(acc)
        acc = curve._add_impl(acc, curve.index_batch(windows, (slice(None), idx)))
    return acc


def horner(windows, curve=ed):
    """(O, W) window sums -> (O,): sum_w 2^(8 w) windows[:, w], one
    ``ed_horner`` / ``w_horner`` launch (in the kernel's segments: the
    points of :func:`horner_plain`); on the CPU their plain versions, in
    :func:`horner_plain`'s order."""
    if curve is ed:
        return cuda_point.ed_horner(windows)
    return cuda_wpoint.w_horner(curve, windows)


def combine_buckets(bucket_sums, num_outputs: int, num_windows: int, curve=ed):
    """(O * W, 255) bucket sums -> (O,) results: the window sums, then
    Horner over the windows, one launch each."""
    return horner(curve.reshape_batch(window_sums(bucket_sums, curve), (num_outputs, num_windows)), curve)


def _row_block(capacity: int, r_rows: int, curve=ed) -> int:
    per_row = NUM_BUCKETS * capacity * _point_bytes(curve) * 2  # x2: the select's and negation's temporaries
    return min(max(1, GATHER_BUDGET_BYTES // per_row), r_rows)


def bucket_accumulate_chunked(points, digits: torch.Tensor, signs, capacity: int, curve=ed):
    """:func:`bucket_accumulate` over blocks of rows, so that a block's slab
    stays under ``GATHER_BUDGET_BYTES``."""
    r_rows = digits.shape[0]
    blk = _row_block(capacity, r_rows, curve)
    parts = [
        bucket_accumulate(points, digits[lo : lo + blk], None if signs is None else signs[lo : lo + blk],
                          capacity, curve)
        for lo in range(0, r_rows, blk)
    ]
    return parts[0] if len(parts) == 1 else curve.cat(parts)


def msm_digits(points, digits: torch.Tensor, signs, num_outputs: int, num_windows: int, capacity: int, curve=ed):
    """The bucket engine (blitzar_tpu's msm_jit): digits (O, W, n) int64,
    signs (O, n) uint8 or None -> (O,) points."""
    r_rows = num_outputs * num_windows
    n = digits.shape[-1]
    digits = digits.reshape(r_rows, n)
    if signs is not None:
        signs = signs[:, None, :].expand(num_outputs, num_windows, n).reshape(r_rows, n)
    buckets = bucket_accumulate_chunked(points, digits, signs, capacity, curve)
    return combine_buckets(buckets, num_outputs, num_windows, curve)


def bucket_msm(points, scalars: np.ndarray, signs, n: int, curve=ed):
    """Host (O, n, nbytes) magnitudes and (O, n) signs (or None) through the
    bucket engine: n padded to a power of two of at least 8 (zero digits
    fall into the excluded bucket 0), C from the unpadded n."""
    n_pad = 8
    while n_pad < n:
        n_pad *= 2
    dev = points.x.device
    pad = ((0, 0), (0, n_pad - scalars.shape[1]))
    dev_scalars = torch.from_numpy(np.pad(scalars, pad + ((0, 0),))).to(dev)
    dev_signs = None if signs is None else torch.from_numpy(np.pad(signs, pad)).to(dev)
    return msm_digits(points, digit_decompose(dev_scalars), dev_signs, scalars.shape[0], scalars.shape[2],
                      choose_capacity(n), curve)


def msm(points, data_list, nbytes_list, signed_list, curve=ed):
    """Generalized Pedersen MSM over shared generators of ``curve`` -> (O,)
    points on the generators' device."""
    scalars, signs, n = prepare_scalars(data_list, nbytes_list, signed_list)
    num_outputs = scalars.shape[0]
    if n == 0 or num_outputs == 0:
        return curve.identity((num_outputs,), points.x.device)
    if points.x.shape[1] < n:
        raise ValueError(f"{n} scalars but only {points.x.shape[1]} generators")
    signs = signs if any(signed_list) else None
    if os.environ.get(ENGINE_VAR) == "bucket":
        return bucket_msm(points, scalars, signs, n, curve)
    if n > STREAM_ABOVE:
        return fixed.streaming_multiexponentiation(points, scalars, curve, signs=signs)
    handle = cached_handle(points, n, curve)
    if signs is not None:
        return fixed.fixed_multiexponentiation_signed(handle, scalars, signs)
    return fixed.fixed_multiexponentiation(handle, scalars)
