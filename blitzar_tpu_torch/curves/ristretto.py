"""ristretto255 over the Edwards curve, in plain PyTorch: canonical 32-byte
encode/decode and the elligator one-way map of the generator derivation
(libsodium's ristretto255; the semantics of ``blitzar_tpu.curves.ristretto``).
"""

from __future__ import annotations

import torch

from ..fields import fp25519 as F
from .edwards25519 import D_INT, PointP3

P = F.P


def _fe_abs_int(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def _fixed_root(x: int) -> int:
    """The non-negative square root of x mod p (x must be a square)."""
    r = pow(x, (P + 3) // 8, P)
    if (r * r - x) % P:
        r = r * SQRT_M1 % P
    assert (r * r - x) % P == 0
    return _fe_abs_int(r)


# sqrt(-1), the even root (the libsodium constant)
SQRT_M1 = _fe_abs_int(pow(2, (P - 1) // 4, P))
ONE_MINUS_D_SQ = (1 - D_INT * D_INT) % P
D_MINUS_ONE_SQ = ((D_INT - 1) * (D_INT - 1)) % P
# sqrt(a*d - 1) with a = -1: the negative (odd) root, the libsodium convention
SQRT_AD_MINUS_ONE = (-_fixed_root((-D_INT - 1) % P)) % P
# 1/sqrt(a - d) with a = -1
INVSQRT_A_MINUS_D = pow(_fixed_root((-1 - D_INT) % P), P - 2, P)


def _c(value: int, like: torch.Tensor) -> torch.Tensor:
    return F.from_int(value, (1,) * (like.dim() - 1), like.device)


def sqrt_ratio_m1(u, v):
    """(was_square, x): x = sqrt(u/v) if u/v is square, else
    sqrt(sqrt(-1)*u/v); x is non-negative."""
    sqrtm1 = _c(SQRT_M1, v)
    v3 = F.mul(F.sq(v), v)
    x = F.mul(F.mul(F.sq(v3), v), u)  # u * v^7
    x = F.pow22523(x)
    x = F.mul(F.mul(x, v3), u)
    vxx = F.mul(F.sq(x), v)
    has_m = F.is_zero(F.sub(vxx, u))
    has_p = F.is_zero(F.add(vxx, u))
    has_f = F.is_zero(F.add(vxx, F.mul(u, sqrtm1)))
    x = F.cmov(x, F.mul(x, sqrtm1), has_p | has_f)
    return has_m | has_p, F.abs_(x)


def encode(p: PointP3):
    """Canonical ristretto255 encoding -> (32, *batch) uint8."""
    one = _c(1, p.x)
    u1 = F.mul(F.add(p.z, p.y), F.sub(p.z, p.y))
    u2 = F.mul(p.x, p.y)
    _, inv_sqrt = sqrt_ratio_m1(one, F.mul(u1, F.sq(u2)))
    den1 = F.mul(inv_sqrt, u1)
    den2 = F.mul(inv_sqrt, u2)
    z_inv = F.mul(F.mul(den1, den2), p.t)
    ix = F.mul_const(p.x, SQRT_M1)
    iy = F.mul_const(p.y, SQRT_M1)
    eden = F.mul_const(den1, INVSQRT_A_MINUS_D)
    rotate = F.is_negative(F.mul(p.t, z_inv)) == 1
    x_ = F.cmov(p.x, iy, rotate)
    y_ = F.cmov(p.y, ix, rotate)
    den_inv = F.cmov(den2, eden, rotate)
    y_ = F.cneg(y_, F.is_negative(F.mul(x_, z_inv)) == 1)
    s = F.abs_(F.mul(den_inv, F.sub(p.z, y_)))
    return F.to_bytes(s)


def decode(data):
    """(32, *batch) uint8 -> (PointP3, valid mask). Invalid slots hold junk."""
    one = _c(1, data)
    s = F.from_bytes(data)
    canonical = (
        ((data[31] >> 7) == 0)
        & ((data[0] & 1) == 0)
        & (F.canonicalize(s) == s).all(dim=0)
    )
    ss = F.sq(s)
    u1 = F.sub(one, ss)
    u2 = F.add(one, ss)
    u1u1 = F.sq(u1)
    u2u2 = F.sq(u2)
    v = F.sub(F.neg(F.mul_const(u1u1, D_INT)), u2u2)
    was_square, inv_sqrt = sqrt_ratio_m1(one, F.mul(v, u2u2))
    den_x = F.mul(inv_sqrt, u2)
    den_y = F.mul(F.mul(inv_sqrt, den_x), v)
    x = F.abs_(F.mul_small(F.mul(s, den_x), 2))
    y = F.mul(u1, den_y)
    z = F.from_int(1, x.shape[1:], x.device)
    t = F.mul(x, y)
    valid = canonical & was_square & (F.is_negative(t) == 0) & ~F.is_zero(y)
    return PointP3(x, y, z, t), valid


def elligator(t):
    """ristretto255 one-way map of a field element batch to points."""
    one = _c(1, t)
    r = F.mul(F.mul_const(t, SQRT_M1), t)
    u = F.mul_const(F.add(r, one), ONE_MINUS_D_SQ)
    neg_one = F.neg(one).expand_as(r)
    rpd = F.add_const(r, D_INT)
    v = F.mul(F.sub(neg_one, F.mul_const(r, D_INT)), rpd)
    was_square, s = sqrt_ratio_m1(u, v)
    wasnt = ~was_square
    s_prime = F.neg(F.abs_(F.mul(s, t)))
    s = F.cmov(s, s_prime, wasnt)
    c = F.cmov(neg_one, r, wasnt)
    n = F.mul_const(F.mul(c, F.sub(r, one)), D_MINUS_ONE_SQ)
    n = F.sub(n, v)
    w0 = F.mul(F.mul_small(s, 2), v)
    w1 = F.mul_const(n, SQRT_AD_MINUS_ONE)
    ss = F.sq(s)
    w2 = F.sub(one, ss)
    w3 = F.add(one, ss)
    return PointP3(F.mul(w0, w3), F.mul(w2, w1), F.mul(w1, w3), F.mul(w0, w2))
