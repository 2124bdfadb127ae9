"""Canonical ristretto255 generators and their process-global prefix cache.

Generator i is elligator(r1) + elligator(r0), where (r0, r1) are the two
field elements xorshift128+ draws when seeded with (i + 1, i + 2): the
derivation of blitzar_tpu/generators.py:178-214 (and of the reference's
seqcommit base elements). The generator runs where the generators go, in
plain PyTorch integer ops (as blitzar_tpu/generators.py:217-289 derives
large batches on its device), so 2^24 generators need no host arrays; the
elligator maps and the add run in the ``elligator_form`` kernel on the card
(its plain version on the CPU).

Derived generators are constants, so a prefix of them can be kept on disk
(blitzar_tpu/generators.py:30-178, in the same files): under ``DISK_DIR``
(``BLITZAR_TPU_TORCH_GENERATOR_CACHE_DIR``; unset or "" leaves the cache
off, since on the H100 a derivation is faster than a load, PERF.md),
``ristretto_gen_a_<n>.npy`` holds the affine x and y of the first n
generators as (2, 16, n) uint16 canonical limbs. A derivation from offset 0
of a multiple of ``DISK_CHUNK`` generators saves one (the affine form by one
``ed_affine`` launch); one from offset 0 loads the smallest saved prefix
that covers it (one ``ed_from_affine_rows`` launch on the file's uint16
rows: z = 1, t = x y), or derives if none does.
blitzar_tpu's legacy extended files (``ristretto_gen_<n>.npy``, (4, 16, n)
uint32) are read too, their z normalised to 1 (one ``ed_affine`` launch).
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from .curves import edwards25519 as ed
from .ops import cuda_point

_M32 = 0xFFFFFFFF

DISK_DIR = os.environ.get("BLITZAR_TPU_TORCH_GENERATOR_CACHE_DIR", "")
# saves happen for multiples of this count (blitzar_tpu/generators.py:301)
DISK_CHUNK = 1 << 16


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


_CACHE_FILE = re.compile(r"ristretto_gen_(a_)?(\d+)\.npy")


def _disk_files(n: int):
    """(count, affine, path) of the smallest cached prefix with count >= n
    (an affine file before a legacy one of the same count), or None."""
    if not DISK_DIR or not os.path.isdir(DISK_DIR):
        return None
    found = []
    for name in os.listdir(DISK_DIR):
        m = _CACHE_FILE.fullmatch(name)
        if m and int(m[2]) >= n:
            found.append((int(m[2]), m[1] is None, name))
    if not found:
        return None
    count, legacy, name = min(found)
    return count, not legacy, os.path.join(DISK_DIR, name)


def _disk_load(n: int, device) -> ed.PointP3 | None:
    """The first n generators from the smallest cached prefix that covers
    them, as (x, y, 1, x y) on ``device``; None if there is none or it does
    not read."""
    found = _disk_files(n)
    if found is None:
        return None
    count, affine, path = found
    try:
        arr = np.load(path, mmap_mode="r")
    except (OSError, ValueError):
        return None
    shape, dtype = ((2, 16, count), np.uint16) if affine else ((4, 16, count), np.uint32)
    if arr.shape != shape or arr.dtype != dtype:
        return None
    if affine:  # one contiguous host copy of the prefix, widened on the device
        return cuda_point.ed_from_affine_rows(torch.from_numpy(np.array(arr[:, :, :n], order="C")).to(device))
    # a legacy extended file: normalise z to 1
    coords = [torch.from_numpy(arr[k, :, :n].astype(np.int32)).to(device) for k in range(shape[0])]
    return cuda_point.ed_affine(ed.PointP3(*coords))


def _disk_save(points: ed.PointP3, n: int) -> None:
    """Save the affine x, y of the first n generators (blitzar_tpu's
    _disk_save, generators.py:162-174): one ``ed_affine`` launch, a
    temporary file and ``os.replace``; an OSError skips the save."""
    if not DISK_DIR:
        return
    path = os.path.join(DISK_DIR, f"ristretto_gen_a_{n}.npy")
    if os.path.exists(path):
        return
    affine = cuda_point.ed_affine(points)
    xy = [c.cpu().numpy().astype(np.uint16) for c in (affine.x, affine.y)]
    tmp = None
    try:
        os.makedirs(DISK_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=DISK_DIR, suffix=".npy")
        with os.fdopen(fd, "wb") as f:
            np.save(f, np.stack(xy))
        os.replace(tmp, path)
    except OSError:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)


def ristretto_generators(n: int, offset: int = 0, device="cuda") -> ed.PointP3:
    """The canonical generators [offset, offset + n) as a (16, n) batch; from
    offset 0 through the disk cache (module docstring)."""
    if n == 0:
        return ed.identity((0,), device)
    if offset == 0:
        cached = _disk_load(n, device)
        if cached is not None:
            return cached
    r0, r1 = _xorshift_limbs(torch.arange(offset, offset + n, dtype=torch.int64, device=device))
    points = cuda_point.elligator_form(r0, r1)
    if offset == 0 and n % DISK_CHUNK == 0:
        _disk_save(points, n)
    return points


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
