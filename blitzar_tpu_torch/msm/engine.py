"""Pedersen-commitment MSM entry of the port (blitzar_tpu/msm/engine.py).

Every MSM over at most 2^20 generators takes the handle path of
``msm/fixed.py``, through a small cache of handles keyed by tensor identity
and a content digest. blitzar_tpu sends a fresh small generator set
through a streamed build+query instead (engine.py:380-412), a TPU latency
device; the point that comes out is the same.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..fields import fp25519 as F
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


# handles over recently used generator sets: [coordinate x, n, digest, handle]
_HANDLE_CACHE: list = []
_HANDLE_CACHE_SLOTS = 4


def _content_digest(points: ed.PointP3, n: int) -> bytes:
    """Digest of n and the x and y limbs of the first and last four and 64
    evenly spaced points: logically equal generators in a fresh tensor
    (a slice, a copy) find their handle."""
    k = min(64, n)
    idx = np.unique(
        np.concatenate(
            [np.arange(min(4, n)), np.arange(max(n - 4, 0), n), np.linspace(0, n - 1, num=k, dtype=np.int64)]
        )
    )
    h = hashlib.blake2b(digest_size=16)
    h.update(n.to_bytes(8, "little"))
    sample = torch.as_tensor(idx, device=points.x.device)
    for c in (points.x, points.y):
        h.update(F.canonicalize(c[:, sample]).cpu().numpy().tobytes())
    return h.digest()


def cached_handle(points: ed.PointP3, n: int) -> fixed.MultiexpHandle:
    for entry in _HANDLE_CACHE:
        if entry[0] is points.x and entry[1] == n:
            return entry[3]
    digest = _content_digest(points, n)
    for entry in _HANDLE_CACHE:
        if entry[1] == n and entry[2] == digest and entry[3].device == points.x.device:
            entry[0] = points.x
            return entry[3]
    handle = fixed.MultiexpHandle(points, n=n)
    _HANDLE_CACHE.append([points.x, n, digest, handle])
    if len(_HANDLE_CACHE) > _HANDLE_CACHE_SLOTS:
        _HANDLE_CACHE.pop(0)
    return handle


def clear_handle_cache() -> None:
    _HANDLE_CACHE.clear()


def msm(points: ed.PointP3, data_list, nbytes_list, signed_list) -> ed.PointP3:
    """Generalized Pedersen MSM over shared generators -> (O,) points on the
    generators' device."""
    scalars, signs, n = prepare_scalars(data_list, nbytes_list, signed_list)
    num_outputs = scalars.shape[0]
    if n == 0 or num_outputs == 0:
        return ed.identity((num_outputs,), points.x.device)
    if n > fixed.MAX_HANDLE_POINTS:
        raise NotImplementedError(fixed.STREAMING_TODO)
    if points.x.shape[1] < n:
        raise ValueError(f"{n} scalars but only {points.x.shape[1]} generators")
    handle = cached_handle(points, n)
    if any(signed_list):
        return fixed.fixed_multiexponentiation_signed(handle, scalars, signs)
    return fixed.fixed_multiexponentiation(handle, scalars)
