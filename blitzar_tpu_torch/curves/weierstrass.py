"""Short-Weierstrass curves with a = 0 (bls12-381 G1, bn254 G1, Grumpkin) in
plain PyTorch, over the Montgomery fields of ``fields/mont.py``.

Points are ``PointP2(x, y, z)``, homogeneous projective coordinates (the
point is (x/z, y/z)), each a (nlimbs, *batch) int32 Montgomery-form tensor;
the identity is (0, 1, 0). Addition and doubling are the complete formulas
of Renes-Costello-Batina 2016 for a = 0 (Algorithms 7 and 9), in the order
of blitzar_tpu/curves/weierstrass.py, so identity and doubling need no
branch and sums pad with the identity. The ``_*_impl`` methods are the plain
group law; :meth:`WCurve.add` and :meth:`WCurve.double` dispatch a batch to
the ``wadd`` / ``wdouble`` CUDA kernels when it lies on the card
(``ops/cuda_wpoint.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields import params
from ..fields.mont import MontField
from ..refimpl import weierstrass as ref


class PointP2(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])


class WCurve:
    """One curve y^2 = x^3 + b. ``kernel_id`` names it to the CUDA kernels;
    it is the curve's id in the reference C ABI (blitzar_api.h:28-31)."""

    def __init__(self, name: str, field: MontField, b: int, oracle: ref.WCurveRef, kernel_id: int):
        self.name = name
        self.field = field
        self.b = b % field.modulus
        self.b3 = 3 * b % field.modulus
        self.oracle = oracle
        self.nlimbs = field.nlimbs
        self.kernel_id = kernel_id

    def __repr__(self):
        return f"WCurve({self.name})"

    def identity(self, batch_shape=(), device="cpu") -> PointP2:
        F = self.field
        return PointP2(F.zeros(batch_shape, device), F.one(batch_shape, device), F.zeros(batch_shape, device))

    # -- group law -----------------------------------------------------------

    def _add_impl(self, p: PointP2, q: PointP2) -> PointP2:
        """Complete addition, a = 0 (Renes-Costello-Batina Algorithm 7):
        12 multiplies and 2 by the constant 3b."""
        F = self.field
        t0 = F.mul(p.x, q.x)
        t1 = F.mul(p.y, q.y)
        t2 = F.mul(p.z, q.z)
        t3 = F.mul(F.add(p.x, p.y), F.add(q.x, q.y))
        t3 = F.sub(t3, F.add(t0, t1))  # x1y2 + x2y1
        t4 = F.mul(F.add(p.y, p.z), F.add(q.y, q.z))
        t4 = F.sub(t4, F.add(t1, t2))  # y1z2 + y2z1
        x3 = F.mul(F.add(p.x, p.z), F.add(q.x, q.z))
        y3 = F.sub(x3, F.add(t0, t2))  # x1z2 + x2z1
        t0 = F.add(F.add(t0, t0), t0)  # 3 x1x2
        t2 = F.mul_const(t2, self.b3)
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = F.mul_const(y3, self.b3)
        x3 = F.sub(F.mul(t3, t1), F.mul(t4, y3))
        y3 = F.add(F.mul(t1, z3), F.mul(y3, t0))
        z3 = F.add(F.mul(z3, t4), F.mul(t0, t3))
        return PointP2(x3, y3, z3)

    def _double_impl(self, p: PointP2) -> PointP2:
        """Complete doubling, a = 0 (Renes-Costello-Batina Algorithm 9):
        8 multiplies and 1 by the constant 3b."""
        F = self.field
        t0 = F.mul(p.y, p.y)
        z3 = F.add(t0, t0)
        z3 = F.add(z3, z3)
        z3 = F.add(z3, z3)  # 8 y^2
        t1 = F.mul(p.y, p.z)
        t2 = F.mul_const(F.mul(p.z, p.z), self.b3)
        x3 = F.mul(t2, z3)
        y3 = F.add(t0, t2)
        z3 = F.mul(t1, z3)
        t1 = F.add(t2, t2)
        t2 = F.add(t1, t2)
        t0 = F.sub(t0, t2)
        y3 = F.add(x3, F.mul(t0, y3))
        x3 = F.mul(t0, F.mul(p.x, p.y))
        x3 = F.add(x3, x3)
        return PointP2(x3, y3, z3)

    def add(self, p: PointP2, q: PointP2) -> PointP2:
        """p + q for equal-shape batches: the ``wadd`` kernel on the card,
        the plain law on the CPU."""
        from ..ops import cuda_wpoint

        return cuda_wpoint.wadd(self, p, q)

    def double(self, p: PointP2) -> PointP2:
        """2p: the ``wdouble`` kernel on the card, the plain law on the CPU."""
        from ..ops import cuda_wpoint

        return cuda_wpoint.wdouble(self, p)

    def neg(self, p: PointP2) -> PointP2:
        return PointP2(p.x, self.field.neg(p.y), p.z)

    def cneg(self, p: PointP2, cond) -> PointP2:
        F = self.field
        return PointP2(p.x, F.cmov(p.y, F.neg(p.y), cond), p.z)

    def select(self, p: PointP2, q: PointP2, cond) -> PointP2:
        """Pointwise select: q where cond else p."""
        F = self.field
        return PointP2(*(F.cmov(a, b, cond) for a, b in zip(p, q)))

    # -- batch plumbing (as curves/edwards25519.py) --------------------------

    def index_batch(self, p: PointP2, idx) -> PointP2:
        """Index or slice the batch axes (the limb axis stays)."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        return PointP2(*(c[(slice(None),) + idx] for c in p))

    def reshape_batch(self, p: PointP2, shape) -> PointP2:
        return PointP2(*(c.reshape((self.nlimbs,) + tuple(shape)) for c in p))

    def cat(self, points, dim: int = 1) -> PointP2:
        """Concatenate point batches along a batch axis (dim counts the limb axis)."""
        return PointP2(*(torch.cat(cs, dim=dim) for cs in zip(*points)))

    def tree_reduce(self, p: PointP2, axis_size: int) -> PointP2:
        """Sum along the FIRST batch axis by halving plain adds: (size, *rest)
        -> (*rest), the plain version of ``tree_reduce_lanes`` on every
        device. (blitzar_tpu pairs neighbours along the last axis instead;
        the sum is the same point, its coordinates may differ.)"""
        cur = p
        size = axis_size
        if size == 0:
            return self.identity(p.batch_shape[1:], p.x.device)
        while size > 1:
            half = size // 2
            s = self._add_impl(self.index_batch(cur, slice(0, half)), self.index_batch(cur, slice(half, 2 * half)))
            if size % 2:
                s = self.cat([s, self.index_batch(cur, slice(2 * half, size))])
            cur = s
            size = half + size % 2
        return self.index_batch(cur, 0)

    # -- conversion ----------------------------------------------------------

    def from_affine_ints(self, pts, device="cuda") -> PointP2:
        """Affine (x, y) int tuples or None (the identity) -> (n,) batch on
        ``device`` (the card unless the caller asks for the CPU)."""
        F = self.field
        xs = [0 if pt is None else pt[0] for pt in pts]
        ys = [1 if pt is None else pt[1] for pt in pts]
        zs = [0 if pt is None else 1 for pt in pts]
        return PointP2(F.from_ints(xs, device), F.from_ints(ys, device), F.from_ints(zs, device))

    def to_affine_ints(self, p: PointP2):
        """Batch -> list of affine (x, y) int tuples or None (identity), the
        batch flattened. The inversions run on the host in Python integers:
        one per point, for the few result points of a commitment."""
        F = self.field
        m = F.modulus
        xs, ys, zs = (F.to_ints(c) for c in p)
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(None)
                continue
            zinv = pow(z, -1, m)
            out.append((x * zinv % m, y * zinv % m))
        return out

    def points_equal(self, p: PointP2, q: PointP2) -> torch.Tensor:
        """Per-element equality of the points (not of their coordinates):
        X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1."""
        F = self.field
        return F.eq(F.mul(p.x, q.z), F.mul(q.x, p.z)) & F.eq(F.mul(p.y, q.z), F.mul(q.y, p.z))

    def is_on_curve(self, p: PointP2) -> torch.Tensor:
        """y^2 z = x^3 + b z^3 per element (the projective curve equation)."""
        F = self.field
        lhs = F.mul(F.mul(p.y, p.y), p.z)
        rhs = F.add(F.mul(F.mul(p.x, p.x), p.x), F.mul_const(F.mul(F.mul(p.z, p.z), p.z), self.b))
        return F.eq(lhs, rhs)


BLS12381_G1 = WCurve("bls12_381_g1", params.BLS12381_FP, 4, ref.BLS12381_G1, kernel_id=1)
BN254_G1 = WCurve("bn254_g1", params.BN254_FP, 3, ref.BN254_G1, kernel_id=2)
GRUMPKIN = WCurve("grumpkin", params.BN254_FR, -17, ref.GRUMPKIN, kernel_id=3)
CURVES = (BLS12381_G1, BN254_G1, GRUMPKIN)


def compress_bls12_381(p: PointP2) -> np.ndarray:
    """(n,) bls12-381 G1 batch -> (n, 48) uint8 zcash-format compressed
    encodings (reference curve_g1/operation/compression.cc:34-60)."""
    pts = BLS12381_G1.to_affine_ints(p)
    half = (BLS12381_G1.field.modulus - 1) // 2
    out = np.zeros((len(pts), 48), np.uint8)
    for j, pt in enumerate(pts):
        if pt is None:
            out[j, 0] = 0b1100_0000  # compressed, infinity
            continue
        x, y = pt
        out[j] = np.frombuffer(x.to_bytes(48, "big"), np.uint8)
        out[j, 0] |= 0b1000_0000  # compressed
        if y > half:
            out[j, 0] |= 0b0010_0000  # y lexicographically largest
    return out
