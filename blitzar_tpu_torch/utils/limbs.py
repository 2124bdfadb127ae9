"""Conversions between Python ints, numpy limb arrays and the port's tensors.

The port keeps ``blitzar_tpu``'s public field layout: ``(nlimbs, *batch)``
radix-2^16 limbs, limb axis leading, held in int32 (16 limbs for curve25519,
bn254 and Grumpkin, 24 for bls12-381; Montgomery form on the Weierstrass
curves). So a ``blitzar_tpu`` point batch ((nlimbs, n) uint32 per
coordinate) crosses over by a dtype change; :func:`from_jax_mont` and
:func:`to_jax_mont` do that for Montgomery field arrays (the proofs' MLE
tables and scalar vectors), :func:`from_jax_points` and
:func:`to_jax_points` for point batches stacked as
``(coords, nlimbs, n)`` arrays (4 coordinates for ristretto255, 3 for a
Weierstrass curve), and :func:`handle_from_jax_table` turns the arrays that
``blitzar_tpu.msm.fixed.MultiexpHandle.write_to_file`` saves into the port's
handle. Nothing here imports ``blitzar_tpu``: the arrays are plain numpy.

The reference's files hold little-endian u64 words: fp25519 values as
radix-2^51 field51 limbs, Montgomery values as their 64-bit words.
:func:`f51_u64_to_limbs16`, :func:`limbs16_to_f51_u64`,
:func:`u64_to_limbs16` and :func:`limbs16_to_u64` convert (after
blitzar_tpu/utils/limbs.py:47-141) in torch int64 on the tensors' own device,
so a 2^25-entry table converts on the card and crosses to the host once, as
int64 tensors holding the u64 words' bit patterns.
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


def from_jax_mont(arr, device="cuda") -> torch.Tensor:
    """A ``blitzar_tpu`` Montgomery array ((nlimbs, *batch) uint32 16-bit
    limbs, as numpy: a field batch, an MLE table, round coefficients) ->
    the port's (nlimbs, *batch) int32 tensor on ``device`` (the card unless
    the caller asks for the CPU). Limbs must be below 2^16."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limbs above 2^16: not a radix-2^16 Montgomery array")
    return to_tensor(arr, device)


def to_jax_mont(t: torch.Tensor) -> np.ndarray:
    """The port's (nlimbs, *batch) Montgomery limbs -> (nlimbs, *batch)
    uint32 numpy, ready for ``jnp.asarray`` and ``blitzar_tpu``'s fields."""
    return t.cpu().numpy().astype(np.uint32)


def from_jax_points(coords: np.ndarray, device="cuda"):
    """(4, 16, n) uint32 limbs (a ``blitzar_tpu`` PointP3 stacked) -> the
    port's PointP3, or (3, nlimbs, n) (a ``blitzar_tpu`` PointP2 stacked,
    Montgomery form) -> the port's PointP2, on ``device`` (the card unless
    the caller asks for the CPU)."""
    from ..curves.edwards25519 import PointP3
    from ..curves.weierstrass import PointP2

    coords = np.asarray(coords)
    point = {4: PointP3, 3: PointP2}[coords.shape[0]]
    return point(*(to_tensor(c, device) for c in coords))


def to_jax_points(p) -> np.ndarray:
    """The port's PointP3 -> (4, 16, *batch) uint32 with canonical limbs, or
    PointP2 -> (3, nlimbs, *batch) uint32 Montgomery limbs (canonical
    already), ready for ``jnp.asarray`` and ``blitzar_tpu``'s points."""
    from ..curves.weierstrass import PointP2
    from ..fields import fp25519 as F

    if isinstance(p, PointP2):
        return np.stack([c.cpu().numpy().astype(np.uint32) for c in p])
    return np.stack([F.canonicalize(c).cpu().numpy().astype(np.uint32) for c in p])


def handle_from_jax_table(*coords, n: int | None = None, curve=None, device="cuda"):
    """A ``blitzar_tpu`` handle's saved table -> the port's handle.

    ``coords`` are the (nlimbs, G, V) uint32 arrays ``coord0..`` that
    ``MultiexpHandle.write_to_file`` stores (blitzar_tpu/msm/fixed.py:422-429);
    V = 2^w gives the window width. Four extended coordinates with no
    ``curve`` are a ristretto255 table, re-encoded in the port's niels
    layout; three projective ones need their ``curve``
    (``curves.weierstrass.WCurve``, named by the file's ``curve`` entry) and
    are packed as they are. The table goes to ``device``."""
    from ..curves import edwards25519 as ed
    from ..curves.weierstrass import PointP2
    from ..msm.fixed import MultiexpHandle

    if curve is None:
        if len(coords) != 4:
            raise ValueError(f"a ristretto255 table has 4 coordinates, got {len(coords)}; pass the curve")
        table, curve = ed.PointP3(*(to_tensor(c, device) for c in coords)), ed
    else:
        if len(coords) != 3 or np.shape(coords[0])[0] != curve.nlimbs:
            raise ValueError(f"a {curve.name} table has 3 coordinates of {curve.nlimbs} limbs")
        table = PointP2(*(to_tensor(c, device) for c in coords))
    return MultiexpHandle.from_point_table(table, n=n, curve=curve)


# ---------------------------------------------------------------------------
# the reference's u64 word layouts, in torch int64 (bit patterns of u64)
# ---------------------------------------------------------------------------

_MASK16 = 0xFFFF


def f51_u64_to_limbs16(raw: torch.Tensor) -> torch.Tensor:
    """(n, 5) int64 radix-2^51 field51 limbs (u64 bit patterns, any
    magnitude) -> (16, n) int32 canonical radix-2^16 limbs mod 2^255 - 19.
    Each u64 limb is cut into 16-bit pieces placed at bit 51 i + 16 k, the
    pieces carried into 17 exact limbs (the value is below 2^268), the top
    limb folded by 2^256 = 38 (mod p), and the rest reduced by
    ``fp25519.canonicalize``."""
    from ..fields import fp25519 as F

    raw = raw.to(torch.int64)
    acc = torch.zeros((17, raw.shape[0]), dtype=torch.int64, device=raw.device)
    for i in range(5):
        q, r = divmod(51 * i, 16)
        for k in range(4):
            piece = ((raw[:, i] >> (16 * k)) & _MASK16) << r  # < 2^31
            acc[q + k] += piece & _MASK16
            acc[q + k + 1] += piece >> 16
    carry = torch.zeros_like(acc[0])
    for j in range(17):
        t = acc[j] + carry
        acc[j] = t & _MASK16
        carry = t >> 16
    acc[0] += 38 * acc[16]
    return F.canonicalize(acc[:16].to(torch.int32))


def limbs16_to_f51_u64(limbs: torch.Tensor) -> torch.Tensor:
    """(16, n) fp25519 limbs (any below 2^17, the plain invariant) -> (n, 5)
    int64 canonical radix-2^51 field51 limbs: bits [51 j, 51 j + 51) of the
    canonical value, gathered from the 16-bit limbs that cover them."""
    from ..fields import fp25519 as F

    c = F.canonicalize(limbs).to(torch.int64)
    cols = []
    for j in range(5):
        lo = 51 * j
        acc = torch.zeros_like(c[0])
        for limb in range(lo // 16, min(16, -(-(lo + 51) // 16))):
            base = 16 * limb
            if base >= lo:
                acc |= (c[limb] & ((1 << min(16, lo + 51 - base)) - 1)) << (base - lo)
            else:
                acc |= c[limb] >> (lo - base)
        cols.append(acc)
    return torch.stack(cols, dim=1)


def u64_to_limbs16(raw: torch.Tensor) -> torch.Tensor:
    """(n, k) int64 u64 words (little-endian word order) -> (4k, n) int32
    radix-2^16 limbs: a reinterpretation of the bits, no reduction
    (Montgomery residues stay Montgomery)."""
    n = raw.shape[0]
    halves = raw.to(torch.int64).contiguous().reshape(-1).view(torch.int16).to(torch.int32) & _MASK16
    return halves.reshape(n, -1).T.contiguous()


def limbs16_to_u64(limbs: torch.Tensor) -> torch.Tensor:
    """(4k, n) radix-2^16 limbs (each below 2^16) -> (n, k) int64 u64 words,
    a reinterpretation of the bits."""
    t = limbs.to(torch.int32)
    halves = torch.where(t >= 1 << 15, t - (1 << 16), t).to(torch.int16)
    return halves.T.contiguous().reshape(-1).view(torch.int64).reshape(t.shape[1], -1)
