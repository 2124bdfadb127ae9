"""blitzar_tpu_torch.curves.weierstrass (plain PyTorch) against
blitzar_tpu.curves.weierstrass and the oracle on bls12-381 G1, bn254 G1 and
Grumpkin: the complete add and double (bit for bit in projective
coordinates: the same formulas in the same order), neg, cneg, select,
tree_reduce (as points: the port halves the leading axis, blitzar_tpu pairs
neighbours), the affine conversions, the curve equation and zcash
compression. Cases include the identity, P + P and P + (-P).

The JAX side runs one jitted program per curve for the group law."""

import jax
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.refimpl import weierstrass as jref
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.refimpl import weierstrass as tref
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points

CURVES = [(j, t) for j in (jwc.BLS12381_G1, jwc.BN254_G1, jwc.GRUMPKIN) for t in twc.CURVES if t.name == j.name]


@pytest.fixture(scope="module", params=CURVES, ids=[j.name for j, _ in CURVES])
def case(request):
    """Batches p and q (the identity, P + P and P + (-P) among the pairs) on
    both sides, and blitzar_tpu's add, double and neg of them."""
    jc, tc = request.param
    orc = tc.oracle
    p, q = orc.random_points(6, seed=1), orc.random_points(4, seed=2)
    pairs = list(zip(p[:4], q)) + [(p[4], p[4]), (p[5], orc.neg(p[5])), (None, p[0]), (p[0], None), (None, None)]
    ps, qs = [a for a, _ in pairs], [b for _, b in pairs]
    jp, jq = jc.from_affine_ints(ps), jc.from_affine_ints(qs)
    want = jax.jit(lambda p, q: (jc._add_impl(p, q), jc._double_impl(p), jc.neg(p)))(jp, jq)
    return {
        "jc": jc, "tc": tc, "ps": ps, "qs": qs, "jp": jp,
        "tp": tc.from_affine_ints(ps, "cpu"), "tq": tc.from_affine_ints(qs, "cpu"),
        "want": [np.stack([np.asarray(c) for c in pt]) for pt in want],
    }


def test_oracle_copy_matches_blitzar_tpu():
    for j, t in [(jref.BLS12381_G1, tref.BLS12381_G1), (jref.BN254_G1, tref.BN254_G1), (jref.GRUMPKIN, tref.GRUMPKIN)]:
        assert (j.name, j.p, j.b, j.gen) == (t.name, t.p, t.b, t.gen)
        assert j.random_points(5, seed=3) == t.random_points(5, seed=3)


def test_affine_conversions_match(case):
    tc, tp = case["tc"], case["tp"]
    assert np.array_equal(to_jax_points(tp), np.stack([np.asarray(c) for c in case["jp"]]))
    assert tc.to_affine_ints(tp) == case["ps"]
    assert tc.to_affine_ints(from_jax_points(to_jax_points(tp), device="cpu")) == case["ps"]
    assert bool(tc.is_on_curve(tp).all())
    off = twc.PointP2(tp.x, tc.field.add(tp.y, tc.field.one((tp.x.shape[1],))), tp.z)
    assert not bool(tc.is_on_curve(off)[:6].any())  # the first six are no identity


def test_add_matches_bit_for_bit(case):
    tc = case["tc"]
    got = tc._add_impl(case["tp"], case["tq"])
    assert np.array_equal(to_jax_points(got), case["want"][0])
    orc = tc.oracle
    assert tc.to_affine_ints(got) == [orc.add(a, b) for a, b in zip(case["ps"], case["qs"])]
    p4 = case["ps"][4]
    assert tc.to_affine_ints(got)[4:6] == [orc.add(p4, p4), None]  # P + P, P + (-P)


def test_double_and_neg_match_bit_for_bit(case):
    tc, tp = case["tc"], case["tp"]
    assert np.array_equal(to_jax_points(tc._double_impl(tp)), case["want"][1])
    assert np.array_equal(to_jax_points(tc.neg(tp)), case["want"][2])
    orc = tc.oracle
    assert tc.to_affine_ints(tc.double(tp)) == [orc.add(a, a) for a in case["ps"]]
    assert tc.to_affine_ints(tc.add(tp, tc.neg(tp))) == [None] * len(case["ps"])


def test_cneg_select_and_tree_reduce(case):
    tc, tp, tq, orc = case["tc"], case["tp"], case["tq"], case["tc"].oracle
    cond = torch.arange(len(case["ps"])) % 3 == 0
    got = tc.to_affine_ints(tc.cneg(tp, cond))
    assert got == [orc.neg(a) if c else a for a, c in zip(case["ps"], cond.tolist())]
    got = tc.to_affine_ints(tc.select(tp, tq, cond))
    assert got == [b if c else a for a, b, c in zip(case["ps"], case["qs"], cond.tolist())]
    total = None
    for a in case["ps"]:
        total = orc.add(total, a)
    assert tc.to_affine_ints(tc.tree_reduce(tp, len(case["ps"]))) == [total]
    grid = tc.reshape_batch(tc.cat([tp, tq]), (2, len(case["ps"])))
    want = [orc.add(a, b) for a, b in zip(case["ps"], case["qs"])]
    assert tc.to_affine_ints(tc.tree_reduce(grid, 2)) == want
    assert tc.to_affine_ints(tc.tree_reduce(tc.index_batch(tp, slice(0, 0)), 0)) == [None]


def test_bls12_381_compression_matches():
    jc, tc = jwc.BLS12381_G1, twc.BLS12381_G1
    pts = tc.oracle.random_points(3, seed=4)
    pts = pts + [tc.oracle.neg(pts[0]), None]
    # projective inputs (z != 1): doubles, compressed as 2P
    doubled = tc._double_impl(tc.from_affine_ints(pts, "cpu"))
    got = twc.compress_bls12_381(doubled)
    assert [bytes(g) for g in got] == [tref.compress_bls12_381(tc.oracle.add(p, p)) for p in pts]
    want = jwc.compress_bls12_381(jc._double_impl(jc.from_affine_ints(pts)))
    assert np.array_equal(got, want)
    assert {g[0] & 0b0010_0000 for g in got[:4]} == {0, 0b0010_0000}  # both y signs occur
