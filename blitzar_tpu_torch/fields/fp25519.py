"""GF(2^255 - 19) arithmetic in plain PyTorch.

Representation: a field element batch is one ``int32`` tensor of shape
``(16, *batch)``: sixteen radix-2^16 little-endian limbs, limb axis leading
(the layout of ``blitzar_tpu.fields.fp25519``, held in int32 because CPU
``uint32`` tensors lack add, shift and compare).

Invariant for stored elements: every limb lies in [0, 2^17) and the value is
congruent to the element mod p; it is neither reduced nor canonical.
Canonical values come from :func:`canonicalize`. Every op widens to int64,
works there and carries back to the invariant with three parallel carry
passes (bounds at :func:`_carry`).

This is the plain version behind the CUDA kernels of ``ops/cuda_point.py``
(whose own arithmetic is ``csrc/fp25519.cuh``, 8 x 32-bit limbs); the CPU
path and the tests run it.
"""

from __future__ import annotations

import torch

from . import batch_invert

NLIMBS = 16
LIMB_BITS = 16
MASK = 0xFFFF
P = 2**255 - 19

# 32p as limbs that each lie in [2^19, 2^20): a + C - b stays non-negative
# limb by limb for any b with limbs < 2^17 (32p = 2^260 - 608, borrowed
# down from the top limb 16 at a time).
_C32P = (2**20 - 608,) + (2**20 - 16,) * 15
assert sum(c << (16 * i) for i, c in enumerate(_C32P)) == 32 * P


def int_limbs(value: int) -> list[int]:
    """Canonical radix-2^16 limbs of ``value mod p``."""
    value %= P
    return [(value >> (16 * i)) & MASK for i in range(NLIMBS)]


def _column(values, ndim: int, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device).reshape(
        (NLIMBS,) + (1,) * ndim
    )


def from_int(value: int, batch_shape=(), device="cpu") -> torch.Tensor:
    """Broadcast a field constant to a (16, *batch) int32 tensor."""
    c = torch.tensor(int_limbs(value), dtype=torch.int32, device=device)
    c = c.reshape((NLIMBS,) + (1,) * len(batch_shape))
    return c.expand((NLIMBS,) + tuple(batch_shape)).contiguous()


def zeros(batch_shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=torch.int32, device=device)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """int64 rows with 0 <= limb < 2^44 -> int32 limbs < 2^17, same value
    mod p. Each pass moves every limb's high part one limb up and folds the
    top limb's carry into limb 0 as 2^256 = 38 (mod p). Bounds: after pass
    1 every limb is < 2^34 (limb 0 gets 38 * 2^28), after pass 2 < 2^16 +
    2^18, after pass 3 < 2^16 + 38 * 4."""
    for _ in range(3):
        c = x >> LIMB_BITS
        x = (x & MASK) + torch.cat([c[-1:] * 38, c[:-1]])
    return x.to(torch.int32)


def _wide(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int64)


def add(a, b):
    return _carry(_wide(a) + _wide(b))


def sub(a, b):
    c = _column(_C32P, a.dim() - 1, a.device)
    return _carry(_wide(a) + c - _wide(b))


def neg(a):
    c = _column(_C32P, a.dim() - 1, a.device)
    return _carry(c - _wide(a))


def mul(a, b):
    """Schoolbook product: 31 column sums (each < 16 * 2^34 = 2^38), the
    upper 15 folded down by 38 (< 2^44), then carried."""
    a = _wide(a)
    b = _wide(b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = torch.zeros((2 * NLIMBS - 1,) + tuple(batch), dtype=torch.int64, device=a.device)
    for i in range(NLIMBS):
        acc[i : i + NLIMBS] += a[i] * b
    lo = acc[:NLIMBS].clone()
    lo[: NLIMBS - 1] += 38 * acc[NLIMBS:]
    return _carry(lo)


def sq(a):
    return mul(a, a)


def mul_const(a, value: int):
    return mul(a, from_int(value, (1,) * (a.dim() - 1), a.device))


def mul_small(a, k: int):
    """Multiply by a small non-negative constant (k < 2^15)."""
    return _carry(_wide(a) * k)


def add_const(a, value: int):
    return _carry(_wide(a) + _column(int_limbs(value), a.dim() - 1, a.device))


def sub_from_const(value: int, a):
    c = _column([v + c for v, c in zip(int_limbs(value), _C32P)], a.dim() - 1, a.device)
    return _carry(c - _wide(a))


def pow2k(a, k: int):
    for _ in range(k):
        a = sq(a)
    return a


def _pow_chain_250(z):
    """z^(2^250 - 1) and z^11, the shared prefix of invert and pow22523."""
    z2 = sq(z)
    z9 = mul(pow2k(z2, 2), z)
    z11 = mul(z9, z2)
    z2_5_0 = mul(sq(z11), z9)
    z2_10_0 = mul(pow2k(z2_5_0, 5), z2_5_0)
    z2_20_0 = mul(pow2k(z2_10_0, 10), z2_10_0)
    z2_40_0 = mul(pow2k(z2_20_0, 20), z2_20_0)
    z2_50_0 = mul(pow2k(z2_40_0, 10), z2_10_0)
    z2_100_0 = mul(pow2k(z2_50_0, 50), z2_50_0)
    z2_200_0 = mul(pow2k(z2_100_0, 100), z2_100_0)
    z2_250_0 = mul(pow2k(z2_200_0, 50), z2_50_0)
    return z2_250_0, z11


def invert(a):
    """a^(p-2); 0 maps to 0."""
    z2_250_0, z11 = _pow_chain_250(a)
    return mul(pow2k(z2_250_0, 5), z11)


def pow22523(a):
    """a^((p-5)/8) = a^(2^252 - 3)."""
    z2_250_0, _ = _pow_chain_250(a)
    return mul(pow2k(z2_250_0, 2), a)


def batch_invert_lanes(z, mul=mul, invert=invert):
    """1/z for a (16, *rows, V) batch of nonzero elements by Montgomery's
    trick along the last axis (``fields/batch_invert.py``), on this field's
    plain ops by default; ``ops/cuda_field.py`` passes its kernels."""
    return batch_invert.batch_invert_lanes(z, mul, invert)


def _carry_exact(rows: list) -> tuple[list, torch.Tensor]:
    """Sequential carry: list of 16 int64 rows -> exact 16-bit rows + carry."""
    out = []
    c = torch.zeros_like(rows[0])
    for r in rows:
        t = r + c
        out.append(t & MASK)
        c = t >> LIMB_BITS
    return out, c


def canonicalize(a):
    """Fully reduce to [0, p): (16, *batch) int32 limbs < 2^16."""
    rows = list(_wide(a))
    # value < 2^258: three sweeps with the 2^256 = 38 fold leave it < 2^256
    for _ in range(3):
        rows, c = _carry_exact(rows)
        rows[0] = rows[0] + 38 * c
    rows, _ = _carry_exact(rows)
    # fold bit 255 (2^255 = 19): now value < 2^255 + 19
    q = rows[15] >> 15
    rows[15] = rows[15] & 0x7FFF
    rows[0] = rows[0] + 19 * q
    rows, _ = _carry_exact(rows)
    # value >= p  <=>  value + 19 has bit 255 set; then value - p = that sum
    # with bit 255 cleared
    plus = list(rows)
    plus[0] = plus[0] + 19
    plus, _ = _carry_exact(plus)
    ge = (plus[15] >> 15) == 1
    plus[15] = plus[15] & 0x7FFF
    out = torch.stack([torch.where(ge, p_, r) for p_, r in zip(plus, rows)])
    return out.to(torch.int32)


def is_negative(a):
    """Canonical-parity sign bit (lsb of the canonical encoding), int32."""
    return canonicalize(a)[0] & 1


def is_zero(a):
    return (canonicalize(a) == 0).all(dim=0)


def eq(a, b):
    return is_zero(sub(a, b))


def cmov(a, b, cond):
    """Select b where cond (broadcast over the limb axis)."""
    return torch.where(cond.unsqueeze(0).to(torch.bool), b, a)


def abs_(a):
    return cmov(a, neg(a), is_negative(a) == 1)


def cneg(a, cond):
    return cmov(a, neg(a), cond)


def to_bytes(a):
    """Canonical 32-byte little-endian encoding: (32, *batch) uint8."""
    c = canonicalize(a)
    lo = c & 0xFF
    hi = c >> 8
    return torch.stack([lo, hi], dim=1).reshape((32,) + tuple(a.shape[1:])).to(torch.uint8)


def from_bytes(b):
    """(32, *batch) uint8 little-endian -> element; bit 255 is masked."""
    b = b.to(torch.int32)
    pairs = b.reshape((NLIMBS, 2) + tuple(b.shape[1:]))
    limbs = pairs[:, 0] | (pairs[:, 1] << 8)
    limbs[NLIMBS - 1] &= 0x7FFF
    return limbs
