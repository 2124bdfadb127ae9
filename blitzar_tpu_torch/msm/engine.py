"""Pedersen-commitment MSM entry of the port (blitzar_tpu/msm/engine.py),
curve-generic: ristretto255 (the ``curves.edwards25519`` module) or a
short-Weierstrass curve (``curves.weierstrass.WCurve``).

The dispatch of blitzar_tpu/msm/engine.py:359-416 on its accelerator:

- over more than ``STREAM_ABOVE`` (2^20) generators, the streamed
  build+query of ``msm/fixed.py`` (no persistent table);
- everything else: the handle path of ``msm/fixed.py``, through a small
  cache of handles keyed by the curve, tensor identity and a content digest.

blitzar_tpu also streams the first MSM over a fresh set of at most 4096
points (its engine.py:285-303). On an H100 that first commitment took as
long through a new handle as streamed (the encode dominates both), so the
port keeps the one path below 2^20 and builds the handle at once.

The point that comes out is the same on every path.
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


# MSMs over more generators than this stream (blitzar_tpu/msm/engine.py:372)
STREAM_ABOVE = 1 << 20

# handles over recently used generator sets: [curve, coordinate x, n, digest, handle]
_HANDLE_CACHE: list = []
_HANDLE_CACHE_SLOTS = 4


def _curve_name(curve) -> str:
    return "ristretto255" if curve is ed else curve.name


def _content_digest(points, n: int, curve=ed) -> bytes:
    """Digest of the curve, n and the x and y limbs of the first and last
    four and 64 evenly spaced points: logically equal generators in a fresh
    tensor (a slice, a copy) find their handle, and equal limbs on two
    curves do not share one."""
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


def cached_handle(points, n: int, curve=ed) -> fixed.MultiexpHandle:
    for entry in _HANDLE_CACHE:
        if entry[0] is curve and entry[1] is points.x and entry[2] == n:
            return entry[4]
    digest = _content_digest(points, n, curve)
    for entry in _HANDLE_CACHE:
        if entry[0] is curve and entry[2] == n and entry[3] == digest and entry[4].device == points.x.device:
            entry[1] = points.x
            return entry[4]
    handle = fixed.MultiexpHandle(points, curve=curve, n=n)
    _HANDLE_CACHE.append([curve, points.x, n, digest, handle])
    if len(_HANDLE_CACHE) > _HANDLE_CACHE_SLOTS:
        _HANDLE_CACHE.pop(0)
    return handle


def clear_handle_cache() -> None:
    _HANDLE_CACHE.clear()


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
    if n > STREAM_ABOVE:
        return fixed.streaming_multiexponentiation(points, scalars, curve, signs=signs)
    handle = cached_handle(points, n, curve)
    if signs is not None:
        return fixed.fixed_multiexponentiation_signed(handle, scalars, signs)
    return fixed.fixed_multiexponentiation(handle, scalars)
