"""curve25519 in twisted-Edwards form (a = -1), extended coordinates, in
plain PyTorch.

Point batches are NamedTuples of (16, *batch) int32 field tensors
(``fields/fp25519.py``). The unified addition is complete (it handles the
identity and doubling), so sums pad with the identity instead of masking.
The ``_*_impl`` functions are the plain group law; :func:`add` and
:func:`double` dispatch a batch to the ``ed_add`` and ``ed_double`` CUDA
kernels when it lies on the card (``ops/cuda_point.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import fp25519 as F

# the curve's name in handle files (blitzar_tpu/curves/edwards25519.py:63)
name = "curve25519"
P = F.P
D_INT = (-121665 * pow(121666, P - 2, P)) % P
D2_INT = (2 * D_INT) % P
# 1/2 mod p (x, y from a niels triple) and (2d)^-1 (t from the stored 2d*t)
INV2_INT = (P + 1) // 2
INV_D2_INT = pow(D2_INT, P - 2, P)


class PointP3(NamedTuple):
    """Extended coordinates: x*y = t*z, point = (x/z, y/z)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])


class Niels(NamedTuple):
    """Affine precomputed form (y + x, y - x, 2d*x*y), z = 1 implied: the
    storage form of partition-table entries. The 2d pre-scale makes the
    mixed add of an extended accumulator and an entry 7 multiplies."""

    a: torch.Tensor
    b: torch.Tensor
    t: torch.Tensor


class Cached(NamedTuple):
    """Projective precomputed form (y + x, y - x, z, 2d*t), the
    z-unnormalised niels (libsodium's ge25519_cached): built from extended
    coordinates with two adds and one multiply, no inversion, so it is the
    storage form of the tables a streamed query builds and drops."""

    a: torch.Tensor
    b: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(batch_shape=(), device="cpu") -> PointP3:
    zero = F.zeros(batch_shape, device)
    one = F.from_int(1, batch_shape, device)
    return PointP3(zero, one, one.clone(), zero.clone())


def _add_impl(p: PointP3, q: PointP3) -> PointP3:
    """Unified twisted-Edwards addition (add-2008-hwcd-3, a = -1)."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q.y, q.x))
    b = F.mul(F.add(p.y, p.x), F.add(q.y, q.x))
    c = F.mul_const(F.mul(p.t, q.t), D2_INT)
    d = F.mul_small(F.mul(p.z, q.z), 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return PointP3(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def _niels_add_impl(n1: Niels, n2: Niels) -> PointP3:
    """niels + niels -> extended: the unified law with z1 = z2 = 1. Both
    stored t's carry a 2d factor, so C = t1*t2/(2d) and D = 2."""
    a = F.mul(n1.b, n2.b)
    b = F.mul(n1.a, n2.a)
    c = F.mul_const(F.mul(n1.t, n2.t), INV_D2_INT)
    e = F.sub(b, a)
    f = F.sub_from_const(2, c)
    g = F.add_const(c, 2)
    h = F.add(b, a)
    return PointP3(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def _madd_impl(p: PointP3, n: Niels) -> PointP3:
    """Mixed add: extended + niels entry (z2 = 1, t2 pre-scaled by 2d)."""
    a = F.mul(F.sub(p.y, p.x), n.b)
    b = F.mul(F.add(p.y, p.x), n.a)
    c = F.mul(p.t, n.t)
    d = F.mul_small(p.z, 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return PointP3(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def _cadd_impl(p: PointP3, c: Cached) -> PointP3:
    """Extended + cached entry: 8 multiplies (t2 pre-scaled by 2d)."""
    a = F.mul(F.sub(p.y, p.x), c.b)
    b = F.mul(F.add(p.y, p.x), c.a)
    cc = F.mul(p.t, c.t)
    d = F.mul_small(F.mul(p.z, c.z), 2)
    e = F.sub(b, a)
    f = F.sub(d, cc)
    g = F.add(d, cc)
    h = F.add(b, a)
    return PointP3(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def _double_impl(p: PointP3) -> PointP3:
    a = F.sq(p.x)
    b = F.sq(p.y)
    c = F.mul_small(F.sq(p.z), 2)
    h = F.add(a, b)
    e = F.sub(h, F.sq(F.add(p.x, p.y)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return PointP3(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """A field constant as (16, 1, ..), broadcast over ``like``'s batch."""
    return F.from_int(value, (1,) * (like.dim() - 1), like.device)


# The table conversions below are the plain versions of the card's
# (``ops/cuda_point.py``: ``ed_to_niels``, ``ed_file_rows``,
# ``ed_file_entries``). ``to_niels`` takes the inversion as an argument, and
# the niels-to-point direction the multiply: ``msm/fixed.py`` passes the
# ``fmul`` kernel there for a table on the card.


def affine_to_niels(x, y) -> Niels:
    """Affine (x, y) -> niels (y + x, y - x, 2d*x*y)."""
    return Niels(F.add(y, x), F.sub(y, x), F.mul(F.mul(x, y), _const(D2_INT, x)))


def to_niels(p: PointP3, invert=F.invert) -> Niels:
    """Extended -> affine niels: z^-1 by ``invert`` (plain: one inversion per
    element; a batch inversion along the last axis gives the same values),
    then x/z, y/z and :func:`affine_to_niels`."""
    zinv = invert(p.z)
    return affine_to_niels(F.mul(p.x, zinv), F.mul(p.y, zinv))


def niels_to_affine(n: Niels, mul=F.mul):
    """(a, b, 2d*t) -> affine (x, y) with x = (a-b)/2, y = (a+b)/2."""
    inv2 = _const(INV2_INT, n.a)
    return mul(F.sub(n.a, n.b), inv2), mul(F.add(n.a, n.b), inv2)


def niels_to_p3(n: Niels, mul=F.mul) -> PointP3:
    """(a, b, 2d*t) -> extended (x, y, 1, t)."""
    x, y = niels_to_affine(n, mul)
    one = F.from_int(1, x.shape[1:], x.device)
    return PointP3(x, y, one, mul(n.t, _const(INV_D2_INT, n.t)))


def to_cached(p: PointP3) -> Cached:
    return Cached(F.add(p.y, p.x), F.sub(p.y, p.x), p.z, F.mul_const(p.t, D2_INT))


def cached_to_p3(c: Cached) -> PointP3:
    """(a, b, z, 2d*t) -> extended (x, y, z, t) with x*y = t*z."""
    x = F.mul_const(F.sub(c.a, c.b), INV2_INT)
    y = F.mul_const(F.add(c.a, c.b), INV2_INT)
    return PointP3(x, y, c.z, F.mul_const(c.t, INV_D2_INT))


def add(p: PointP3, q: PointP3) -> PointP3:
    """p + q for equal-shape batches: the ``ed_add`` kernel on the card,
    the plain law on the CPU."""
    from ..ops import cuda_point

    return cuda_point.ed_add(p, q)


def double(p: PointP3) -> PointP3:
    """2p: the ``ed_double`` kernel on the card (any batch, one point
    included), the plain law on the CPU."""
    from ..ops import cuda_point

    return cuda_point.ed_double(p)


def neg(p: PointP3) -> PointP3:
    return PointP3(F.neg(p.x), p.y, p.z, F.neg(p.t))


def cneg(p: PointP3, cond) -> PointP3:
    """Negate where cond (broadcast over the batch shape)."""
    return PointP3(F.cneg(p.x, cond), p.y, p.z, F.cneg(p.t, cond))


def select(p: PointP3, q: PointP3, cond) -> PointP3:
    """Pointwise select: q where cond else p."""
    return PointP3(*(F.cmov(a, b, cond) for a, b in zip(p, q)))


def is_identity(p: PointP3):
    return F.is_zero(p.x) & F.eq(p.y, p.z)


def is_on_curve(p: PointP3):
    """(Y^2 - X^2) Z^2 == Z^4 + d X^2 Y^2 and X*Y == Z*T, per element."""
    x2, y2, z2 = F.sq(p.x), F.sq(p.y), F.sq(p.z)
    lhs = F.mul(F.sub(y2, x2), z2)
    rhs = F.add(F.sq(z2), F.mul_const(F.mul(x2, y2), D_INT))
    t_ok = F.eq(F.mul(p.x, p.y), F.mul(p.z, p.t))
    return F.eq(lhs, rhs) & t_ok


def index_batch(p: PointP3, idx) -> PointP3:
    """Index or slice the batch axes (the limb axis stays)."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    return PointP3(*(c[(slice(None),) + idx] for c in p))


def reshape_batch(p: PointP3, shape) -> PointP3:
    return PointP3(*(c.reshape((F.NLIMBS,) + tuple(shape)) for c in p))


def cat(points, dim: int = 1) -> PointP3:
    """Concatenate point batches along a batch axis (dim counts the limb axis)."""
    return PointP3(*(torch.cat(cs, dim=dim) for cs in zip(*points)))


def points_equal(p: PointP3, q: PointP3):
    """Per-element equality of the points (not of their coordinates):
    X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1."""
    return F.eq(F.mul(p.x, q.z), F.mul(q.x, p.z)) & F.eq(F.mul(p.y, q.z), F.mul(q.y, p.z))


def tree_reduce(p: PointP3, axis_size: int) -> PointP3:
    """Sum along the FIRST batch axis by halving plain adds: (size, *rest)
    -> (*rest), the plain version of ``tree_reduce_lanes`` on every device.
    For a 1-D batch this is ``blitzar_tpu``'s ``tree_reduce``."""
    cur = p
    size = axis_size
    if size == 0:
        return identity(p.batch_shape[1:], p.x.device)
    while size > 1:
        half = size // 2
        lo = index_batch(cur, slice(0, half))
        hi = index_batch(cur, slice(half, 2 * half))
        s = _add_impl(lo, hi)
        if size % 2:
            s = cat([s, index_batch(cur, slice(2 * half, size))])
        cur = s
        size = half + size % 2
    return index_batch(cur, 0)
