"""The reference's raw partition-table files (blitzar_tpu/msm/interop.py;
reference in_memory_partition_table_accessor.h:42-64, written at :95-104).

A file is a 4-byte little-endian window width w, then the table's entries,
group-major: 2^w entries per group of w generators, entry v of group g the
sum of the generators g*w + j over the set bits j of v. An entry is
little-endian u64 words:

- ristretto255: affine {X, Y, X*Y}, each five radix-2^51 field51 limbs (15
  words); the identity is {0, 1, 0}. Written canonical; any field51
  representation is read.
- bls12-381 G1, bn254 G1, Grumpkin: affine {x, y} as Montgomery words (6 or
  4 each); the identity has x's last word 2^64 - 1 and y the Montgomery one.

Both directions run chunk by chunk (``fixed.TABLE_CHUNK_ENTRIES`` entries),
the field work and the word conversions on the table's device: ristretto255
niels entries to affine x, y and x*y by ``fmul`` (``ops/cuda_field.py``) and
back; a Weierstrass table's projective points to the file's affine rows by
one ``w_affine`` launch a chunk (``ops/cuda_wpoint.py``: a batch inversion
of z and x / z, y / z on the card), read back by ``mont_mul_ew``
(``ops/cuda_mont.py``). The file goes through the host once, a chunk at a
time. A file with w a multiple of 8
above 8 (the reference's default is 16) is re-windowed to w = 8 as it is
read: a w table already holds every w = 8 entry (the subset u of sub-slot
s's generators sits at index u << 8 s), so this is indexing, no group
arithmetic (blitzar_tpu/msm/interop.py:158-176).
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..curves.weierstrass import PointP2
from ..ops import cuda_field, cuda_mont, cuda_point, cuda_wpoint
from ..utils import limbs as limb_util
from . import fixed

HEADER = struct.Struct("<I")
F51_WORDS = 5
REWINDOW = 8


def entry_words(curve) -> int:
    """u64 words an entry: 15 for ristretto255, 2 x nlimbs / 4 for a
    Weierstrass curve."""
    return 3 * F51_WORDS if curve is ed else curve.nlimbs // 2


def _ed_rows(words: torch.Tensor) -> torch.Tensor:
    """(g, V, 3, 8) niels words -> (g V, 15) int64 rows {X, Y, X*Y}."""
    x, y = ed.niels_to_affine(cuda_point.unpack_niels(words), cuda_field.fmul)
    xy = cuda_field.fmul(x, y)
    return torch.cat([limb_util.limbs16_to_f51_u64(c.reshape(c.shape[0], -1)) for c in (x, y, xy)], dim=1)


def write_reference_file(handle: "fixed.MultiexpHandle", path: str) -> None:
    """Write ``handle`` in the reference's raw format, byte for byte what
    blitzar_tpu's ``write_reference_file`` writes for the same table."""
    table = handle.table
    with open(path, "wb") as out:
        out.write(HEADER.pack(handle.window_width))
        for sl in fixed.table_chunks(table.shape[0], table.shape[1]):
            rows = _ed_rows(table[sl]) if handle.curve is ed else cuda_wpoint.w_affine(handle.curve, table[sl])
            rows.cpu().numpy().tofile(out)


def _ed_entries(rows: torch.Tensor) -> torch.Tensor:
    """(E, 15) int64 rows -> (E, 3, 8) niels words: x and y from the file,
    2d*x*y recomputed (the file's X*Y is not read)."""
    x = limb_util.f51_u64_to_limbs16(rows[:, 0:F51_WORDS])
    y = limb_util.f51_u64_to_limbs16(rows[:, F51_WORDS : 2 * F51_WORDS])
    return cuda_point.pack_niels(ed.affine_to_niels(x, y, cuda_field.fmul))


def _w_entries(curve, rows: torch.Tensor) -> torch.Tensor:
    """(E, 2k) int64 rows -> (E, 3, K) projective words (x, y, 1), the
    identity (0, 1, 0). Coordinates are reduced below the modulus (one
    ``mont_mul_ew`` by R mod m), the form the kernels take."""
    f = curve.field
    k = entry_words(curve) // 2
    inf = rows[:, k - 1] == -1
    x = cuda_mont.reduce_residues(f, limb_util.u64_to_limbs16(rows[:, :k]))
    y = cuda_mont.reduce_residues(f, limb_util.u64_to_limbs16(rows[:, k:]))
    one = f.one((1,), rows.device)
    keep = ~inf
    x = torch.where(keep, x, 0)
    y = torch.where(keep, y, one)
    z = torch.where(keep, one, 0)
    return cuda_wpoint.pack_points(PointP2(x, y, z))


def read_reference_file(path: str, curve=ed, device="cuda") -> "fixed.MultiexpHandle":
    """A handle from a reference-format file; its table goes to ``device``
    (the card unless the caller asks for the CPU), re-windowed to w = 8
    where w is a multiple of 8 above 8."""
    words = entry_words(curve)
    with open(path, "rb") as f:
        head = f.read(HEADER.size)
    if len(head) < HEADER.size:
        raise ValueError(f"{path}: no window-width header")
    (w,) = HEADER.unpack(head)
    body_bytes = os.path.getsize(path) - HEADER.size
    entries = 1 << w
    if w < 1 or body_bytes <= 0 or body_bytes % (8 * words * entries):
        raise ValueError(f"{path}: {body_bytes} bytes are no whole groups of 2^{w} {curve.name} entries")
    groups = body_bytes // (8 * words * entries)
    body = np.memmap(path, dtype="<u8", mode="r", offset=HEADER.size).reshape(groups, entries, words)
    cols, split = None, 1
    if w > REWINDOW and w % REWINDOW == 0:
        split = w // REWINDOW
        idx = np.arange(1 << REWINDOW, dtype=np.int64)
        cols = np.concatenate([idx << (REWINDOW * s) for s in range(split)])
        entries = 1 << REWINDOW
    coords, nwords = (3, 8) if curve is ed else (3, curve.nlimbs // 2)
    table = torch.empty((groups * split, entries, coords, nwords), dtype=torch.int32, device=device)
    for sl in fixed.table_chunks(groups, split * entries):
        part = np.array(body[sl] if cols is None else body[sl][:, cols])  # read from the file
        rows = torch.from_numpy(part.view(np.int64).reshape(-1, words)).to(device)
        got = _ed_entries(rows) if curve is ed else _w_entries(curve, rows)
        table[sl.start * split : sl.stop * split] = got.reshape(-1, entries, coords, nwords)
    del body
    return fixed.MultiexpHandle.from_table(table, curve)
