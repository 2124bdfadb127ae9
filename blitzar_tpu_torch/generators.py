"""Canonical ristretto255 generators and their process-global prefix cache.

Generator i is elligator(r1) + elligator(r0), where (r0, r1) are the two
field elements xorshift128+ draws when seeded with (i + 1, i + 2): the
derivation of blitzar_tpu/generators.py:178-214 (and of the reference's
seqcommit base elements). The generator runs on the host in numpy uint64;
the elligator maps and the add run in the ``elligator_form`` kernel on the
card (its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .curves import edwards25519 as ed
from .ops import cuda_point
from .utils.limbs import to_tensor


def _xorshift_limbs(indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """xorshift128+ per index -> two (16, n) uint32 limb arrays, bit 255
    masked (blitzar_tpu/generators.py:178-203)."""
    indices = np.asarray(indices, dtype=np.uint64)
    a = indices + np.uint64(1)
    b = indices + np.uint64(2)
    outs = []
    for _ in range(8):
        t, s = a, b
        a = s
        t = t ^ (t << np.uint64(23))
        t = t ^ (t >> np.uint64(17))
        t = t ^ s ^ (s >> np.uint64(26))
        b = t
        outs.append(t + s)

    def to_limbs(words):  # 4 x (n,) uint64 -> (16, n) uint32
        rows = [
            ((w >> np.uint64(16 * j)) & np.uint64(0xFFFF)).astype(np.uint32)
            for w in words
            for j in range(4)
        ]
        limbs = np.stack(rows)
        limbs[15] &= np.uint32(0x7FFF)
        return limbs

    return to_limbs(outs[0:4]), to_limbs(outs[4:8])


def ristretto_generators(n: int, offset: int = 0, device="cuda") -> ed.PointP3:
    """The canonical generators [offset, offset + n) as a (16, n) batch."""
    if n == 0:
        return ed.identity((0,), device)
    r0, r1 = _xorshift_limbs(np.arange(offset, offset + n, dtype=np.uint64))
    return cuda_point.elligator_form(to_tensor(r0, device), to_tensor(r1, device))


class _GeneratorCache:
    """Process-global prefix of derived generators per device (the
    reference's precomputed_generators). Identical (offset, n) requests
    return the SAME tensors, so the handle cache of ``msm/engine.py`` hits
    on identity."""

    def __init__(self):
        self._points: dict[str, ed.PointP3] = {}
        self._slices: dict[tuple[str, int, int], ed.PointP3] = {}

    def get(self, n: int, offset: int = 0, device="cuda") -> ed.PointP3:
        if n == 0:
            return ed.identity((0,), device)
        key_dev = str(torch.device(device))
        end = offset + n
        have = self._points.get(key_dev)
        count = 0 if have is None else have.x.shape[1]
        if end > count:
            grow_to = max(end, 2 * count)
            self._points[key_dev] = ristretto_generators(grow_to, 0, device)
            self._slices = {k: v for k, v in self._slices.items() if k[0] != key_dev}
        key = (key_dev, offset, end)
        sl = self._slices.get(key)
        if sl is None:
            sl = ed.index_batch(self._points[key_dev], slice(offset, end))
            if len(self._slices) > 16:
                self._slices.clear()
            self._slices[key] = sl
        return sl

    def reset(self):
        self._points.clear()
        self._slices.clear()


CACHE = _GeneratorCache()


def get_precomputed_generators(n: int, offset: int = 0, device="cuda") -> ed.PointP3:
    return CACHE.get(n, offset, device)


def one_commitment(n: int, device="cuda") -> ed.PointP3:
    """Sum of the first n generators (a single point, batch shape ())."""
    if n == 0:
        return ed.identity((), device)
    return ed.tree_reduce(get_precomputed_generators(n, 0, device), n)
