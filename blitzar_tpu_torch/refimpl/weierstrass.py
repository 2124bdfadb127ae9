"""Pure-Python short-Weierstrass oracle (ints only): the port's own copy of
blitzar_tpu/refimpl/weierstrass.py.

The oracle for bls12-381 G1, bn254 G1 and Grumpkin that the tests and
``chip_smoke.py`` hold the port against (the role of the reference's naive
CPU sums, reference sxt/multiexp/test/curve21_arithmetic.cc:40-64). The
commitment path never calls it. Points are affine (x, y) int tuples, or None
for the identity.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

BLS12381_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BN254_P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks; a root of a mod p, or None if a is not a square."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


@dataclass(frozen=True)
class WCurveRef:
    name: str
    p: int
    b: int
    gen: tuple[int, int]

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.b)) % self.p == 0

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        p = self.p
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.p)

    def mul(self, k: int, pt):
        if k < 0:
            return self.mul(-k, self.neg(pt))
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.add(pt, pt)
            k >>= 1
        return acc

    def msm(self, scalars, points):
        acc = None
        for k, pt in zip(scalars, points):
            acc = self.add(acc, self.mul(k, pt))
        return acc

    def random_points(self, n: int, seed: int = 0):
        """Deterministic pseudo-random points: hash the index to x, lift to
        the curve (the smaller root as y). Not in the prime-order subgroup
        where the curve has a cofactor (bls12-381 G1)."""
        out = []
        i = 0
        while len(out) < n:
            h = hashlib.sha256(f"{self.name}:{seed}:{i}".encode()).digest()
            x = int.from_bytes(h, "little") % self.p
            y = _sqrt_mod(x * x * x + self.b, self.p)
            i += 1
            if y is None:
                continue
            out.append((x, min(y, self.p - y)))
        return out


BLS12381_G1 = WCurveRef(
    "bls12_381_g1",
    BLS12381_P,
    4,
    (
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ),
)

BN254_G1 = WCurveRef("bn254_g1", BN254_P, 3, (1, 2))

_GRUMPKIN_GY = _sqrt_mod(-16, BN254_R)
assert _GRUMPKIN_GY is not None
GRUMPKIN = WCurveRef("grumpkin", BN254_R, (-17) % BN254_R, (1, _GRUMPKIN_GY))


def compress_bls12_381(pt) -> bytes:
    """zcash-format 48-byte compressed encoding (reference
    curve_g1/operation/compression.cc:34-60): big-endian x with bit 7 = the
    compressed flag, bit 6 = infinity, bit 5 = y lexicographically largest."""
    if pt is None:
        out = bytearray(48)
        out[0] = 0b1100_0000
        return bytes(out)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0b1000_0000
    if y > (BLS12381_P - 1) // 2:
        out[0] |= 0b0010_0000
    return bytes(out)
