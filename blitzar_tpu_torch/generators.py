"""Canonical ristretto255 generators and their process-global prefix cache.

Generator i is elligator(r1) + elligator(r0), where (r0, r1) are the two
field elements xorshift128+ draws when seeded with (i + 1, i + 2): the
derivation of blitzar_tpu/generators.py:178-214 (and of the reference's
seqcommit base elements). The generator runs where the generators go, in
plain PyTorch integer ops (as blitzar_tpu/generators.py:217-289 derives
large batches on its device), so 2^24 generators need no host arrays; the
elligator maps and the add run in the ``elligator_form`` kernel on the card
(its plain version on the CPU).
"""

from __future__ import annotations

import torch

from .curves import edwards25519 as ed
from .ops import cuda_point

_M32 = 0xFFFFFFFF


def _xorshift_limbs(indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xorshift128+ per index -> two (16, n) int32 limb tensors on the
    indices' device, bit 255 masked. ``indices`` is an int64 tensor read as
    the uint64 bit patterns of the indices; every 64-bit word is carried as
    a (hi, lo) pair of 32-bit halves in int64, so no op overflows."""

    def add64(a, b):
        lo = a[1] + b[1]
        return ((a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32)

    def shl(a, k):
        return (((a[0] << k) | (a[1] >> (32 - k))) & _M32, (a[1] << k) & _M32)

    def shr(a, k):
        return (a[0] >> k, ((a[1] >> k) | (a[0] << (32 - k))) & _M32)

    def xor(a, b):
        return (a[0] ^ b[0], a[1] ^ b[1])

    idx = (indices.to(torch.int64) >> 32) & _M32, indices.to(torch.int64) & _M32
    zero = torch.zeros_like(idx[1])
    a = add64(idx, (zero, zero + 1))
    b = add64(idx, (zero, zero + 2))
    outs = []
    for _ in range(8):
        t, s = a, b
        a = s
        t = xor(t, shl(t, 23))
        t = xor(t, shr(t, 17))
        t = xor(t, xor(s, shr(s, 26)))
        b = t
        outs.append(add64(t, s))

    def to_limbs(words):  # 4 x (hi, lo) -> (16, n) int32 16-bit limbs
        rows = []
        for hi, lo in words:
            rows += [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
        rows[15] = rows[15] & 0x7FFF
        return torch.stack(rows).to(torch.int32)

    return to_limbs(outs[0:4]), to_limbs(outs[4:8])


def ristretto_generators(n: int, offset: int = 0, device="cuda") -> ed.PointP3:
    """The canonical generators [offset, offset + n) as a (16, n) batch."""
    if n == 0:
        return ed.identity((0,), device)
    r0, r1 = _xorshift_limbs(torch.arange(offset, offset + n, dtype=torch.int64, device=device))
    return cuda_point.elligator_form(r0, r1)


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
            # derive only the new generators; the prefix stays as it is
            grow_to = max(end, 2 * count)
            more = ristretto_generators(grow_to - count, count, device)
            self._points[key_dev] = more if have is None else ed.cat([have, more])
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


# columns of one_commitment's first lane reduce
_ONE_COMMIT_LANES = 1024


def one_commitment(n: int, device="cuda") -> ed.PointP3:
    """Sum of the first n generators (a single point, batch shape ()): the
    generators, padded with identities to rows of ``_ONE_COMMIT_LANES``, are
    summed down each column and then across the columns, two
    ``tree_reduce_lanes`` launches on the card."""
    if n == 0:
        return ed.identity((), device)
    points = get_precomputed_generators(n, 0, device)
    lanes = min(n, _ONE_COMMIT_LANES)
    if n % lanes:
        points = ed.cat([points, ed.identity((lanes - n % lanes,), device)])
    columns = cuda_point.tree_reduce_lanes(ed.reshape_batch(points, (-1, lanes)))
    return cuda_point.tree_reduce_lanes(columns)
