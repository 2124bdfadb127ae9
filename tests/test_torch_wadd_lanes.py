"""The Weierstrass add at several lanes a pair (csrc/wadd_lanes.cuh:
wadd.cu), run by the host harness lane by lane through an exchange array,
against blitzar_tpu's curves/weierstrass.py add (its plain path) on
bls12-381 G1, bn254 G1 and Grumpkin: seeded pairs with z != 1, the
identity on either side and on both, P + P and P + (-P); with negate_q
against add(p, neg(q)). Tolerance 0 on the affine integers and on the
canonical Montgomery limbs. Also the port's CPU wrapper both ways, and
signed bn254 G1 columns through the port's CPU handle and streamed queries
(their Q_pos - Q_neg: ``wadd`` reading Q_neg negated) against
blitzar_tpu's pure-Python oracle."""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_harness
from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.refimpl import weierstrass as jref
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.msm import fixed
from blitzar_tpu_torch.ops import cuda_wpoint

JAX_CURVES = {"bls12_381_g1": jwc.BLS12381_G1, "bn254_g1": jwc.BN254_G1, "grumpkin": jwc.GRUMPKIN}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _pairs(curve):
    """p, q (3, nlimbs, 16) Montgomery limbs with z != 1 (the doubles of the
    affine ps, qs): ten seeded pairs, then identity + Q, P + identity,
    identity + identity, P + P, P + (-P) and -P + P."""
    orc = curve.oracle
    a, b = orc.random_points(12, seed=31), orc.random_points(10, seed=32)
    ps = a[:10] + [None, a[10], None, a[11], a[0], orc.neg(a[1])]
    qs = b + [b[0], None, None, a[11], orc.neg(a[0]), a[1]]
    p, q = (curve._double_impl(curve.from_affine_ints(x, "cpu")) for x in (ps, qs))
    return p, q, ps, qs


def _stack(p) -> np.ndarray:
    return np.ascontiguousarray(np.stack([c.numpy() for c in p]), dtype=np.int32)


def _lanes(harness, curve, p, q, negate_q: bool) -> wc.PointP2:
    a, b = _stack(p), _stack(q)
    out = np.zeros_like(a)
    rc = harness.btt_host_wadd_lanes(ctypes.c_int(curve.kernel_id), ctypes.c_void_p(a.ctypes.data),
                                     ctypes.c_void_p(b.ctypes.data), ctypes.c_int(int(negate_q)),
                                     ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(a.shape[-1]))
    assert rc == 0
    return wc.PointP2(*(torch.from_numpy(c.copy()) for c in out))


@functools.lru_cache(maxsize=None)
def _blitzar_tpu_sums(name: str) -> tuple:
    """blitzar_tpu's p + q and p + neg(q) over a curve's pairs, as (3,
    nlimbs, 16) int32 limbs each: one jitted _add_impl over both halves, so
    each curve compiles once."""
    curve = next(c for c in wc.CURVES if c.name == name)
    jcurve = JAX_CURVES[name]
    p, q, _, _ = _pairs(curve)
    jp, jq = (jwc.PointP2(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in x)) for x in (p, q))
    both = jwc.PointP2(*(jnp.concatenate([a, b], axis=1) for a, b in zip(jq, jcurve.neg(jq))))
    twice = jwc.PointP2(*(jnp.concatenate([a, a], axis=1) for a in jp))
    sums = np.stack([np.asarray(c) for c in jax.jit(jcurve._add_impl)(twice, both)]).astype(np.int32)
    half = sums.shape[-1] // 2
    return sums[..., :half], sums[..., half:]


@pytest.mark.parametrize("negate_q", [False, True], ids=["add", "negate_q"])
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_wadd_lanes_match_blitzar_tpu(harness, curve, negate_q):
    p, q, ps, qs = _pairs(curve)
    got = _lanes(harness, curve, p, q, negate_q)
    assert np.array_equal(_stack(got), _blitzar_tpu_sums(curve.name)[int(negate_q)])
    orc = curve.oracle
    sums = [orc.add(orc.add(a, a), orc.neg(orc.add(b, b)) if negate_q else orc.add(b, b)) for a, b in zip(ps, qs)]
    assert curve.to_affine_ints(got) == sums
    assert sums[12] is None and sums[13 if negate_q else 14] is None
    # the port's wrapper on the CPU: its plain version, the same limbs
    assert np.array_equal(_stack(cuda_wpoint.wadd(curve, p, q, negate_q=negate_q)), _stack(got))


@pytest.mark.parametrize("path", ["handle", "streamed"])
def test_signed_w_commitment_matches_oracle(path):
    """Signed 8-byte bn254 G1 columns with their extremes through the
    port's CPU handle query and streamed query (each ends in
    ``combine_signed``), against blitzar_tpu's oracle sum of signed
    multiples."""
    curve = wc.BN254_G1
    vals = [[-(1 << 63), (1 << 63) - 1, -1, 0, 1, 12345, -987654321, 7],
            [5, -5, 1 << 62, -(1 << 62), -2, 0, 3, -7]]
    n = len(vals[0])
    mags = np.array([[np.frombuffer(abs(v).to_bytes(8, "little"), np.uint8) for v in row] for row in vals])
    signs = np.array([[v < 0 for v in row] for row in vals], np.uint8)
    pts = jref.BN254_G1.random_points(n, seed=33)
    points = curve.from_affine_ints(pts, "cpu")
    if path == "handle":
        got = fixed.fixed_multiexponentiation_signed(fixed.MultiexpHandle(points, curve=curve), mags, signs)
    else:
        got = fixed.streaming_multiexponentiation(points, mags, curve, signs=signs)
    assert curve.to_affine_ints(got) == [jref.BN254_G1.msm(row, pts) for row in vals]
