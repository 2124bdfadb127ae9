"""Conversions between Python ints, numpy limb arrays and the port's tensors.

The port keeps ``blitzar_tpu``'s public field layout: ``(16, *batch)``
radix-2^16 limbs, limb axis leading, held in int32. So a ``blitzar_tpu``
point batch ((16, n) uint32 per coordinate) crosses over by a dtype change;
:func:`from_jax_points` and :func:`to_jax_points` do that for point batches
stacked as ``(4, 16, n)`` arrays, and :func:`handle_from_jax_table` turns the
arrays that ``blitzar_tpu.msm.fixed.MultiexpHandle.write_to_file`` saves into
the port's handle. Nothing here imports ``blitzar_tpu``: the arrays are
plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 16


def int_to_limbs(value: int, nlimbs: int = NLIMBS) -> np.ndarray:
    value %= 1 << (16 * nlimbs)
    return np.array([(value >> (16 * i)) & 0xFFFF for i in range(nlimbs)], dtype=np.int64)


def limbs_to_int(limbs) -> int:
    """Value of one limb vector (any limb magnitude)."""
    return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(limbs)))


def ints_to_limbs(values, nlimbs: int = NLIMBS) -> np.ndarray:
    """(n,) Python ints -> (nlimbs, n) int64."""
    out = np.zeros((nlimbs, len(values)), dtype=np.int64)
    for j, v in enumerate(values):
        out[:, j] = int_to_limbs(int(v), nlimbs)
    return out


def limbs_to_ints(arr) -> list[int]:
    """(nlimbs, n) array or tensor -> list of Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    return [limbs_to_int(arr[:, j]) for j in range(arr.shape[1])]


def to_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy limbs (any integer dtype, values < 2^31) -> int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr).astype(np.int32))).to(device)


def from_jax_points(coords: np.ndarray, device="cuda"):
    """(4, 16, n) uint32 limbs (a ``blitzar_tpu`` PointP3 stacked) -> the
    port's PointP3 on ``device`` (the card unless the caller asks for the CPU)."""
    from ..curves.edwards25519 import PointP3

    coords = np.asarray(coords)
    return PointP3(*(to_tensor(coords[k], device) for k in range(4)))


def to_jax_points(p) -> np.ndarray:
    """The port's PointP3 -> (4, 16, *batch) uint32 with canonical limbs,
    ready for ``jnp.asarray`` and ``blitzar_tpu``'s PointP3."""
    from ..fields import fp25519 as F

    return np.stack([F.canonicalize(c).cpu().numpy().astype(np.uint32) for c in p])


def handle_from_jax_table(coord0, coord1, coord2, coord3, n: int | None = None, device="cuda"):
    """A ``blitzar_tpu`` handle's saved table -> the port's handle.

    ``coord0..coord3`` are the extended (16, G, V) uint32 arrays that
    ``MultiexpHandle.write_to_file`` stores (blitzar_tpu/msm/fixed.py:422-429);
    V = 2^w gives the window width. The entries are re-encoded in the port's
    niels layout on ``device``."""
    from ..curves.edwards25519 import PointP3
    from ..msm.fixed import MultiexpHandle

    table = PointP3(*(to_tensor(c, device) for c in (coord0, coord1, coord2, coord3)))
    return MultiexpHandle.from_point_table(table, n=n)
