"""The Weierstrass ladder of one launch (csrc/w_ladder.cuh, run by
csrc/w_doubling_combine.cu): out[o] = sum_b 2^b * products[o, b], compiled
for the host with g++ through csrc/host_harness.cpp, which runs each
output's lanes one after another and then lane 0's fold.

With one segment (seg_bits = nbits) the ladder is blitzar_tpu's order, and
its coordinates equal blitzar_tpu's ``_doubling_combine``
(blitzar_tpu/msm/fixed.py:596) limb for limb; with the kernel's segments
(``ladder_segment_bits``) they equal the port's plain version in the same
order (``w_doubling_combine_plain``) limb for limb, and blitzar_tpu's as
points. All three curves, one and three outputs, 1, 8 and 256 bits, and
bit rows that are the identity."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import weierstrass as jw
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_wpoint
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points

import torch_host_harness

JAX_CURVES = {"bls12_381_g1": jw.BLS12381_G1, "bn254_g1": jw.BN254_G1, "grumpkin": jw.GRUMPKIN}
# (outputs, nbits) held against the plain version; blitzar_tpu's ladder
# (a compile per shape) takes one of each width beside them
SHAPES = [(1, 1), (3, 1), (1, 8), (3, 8), (1, 256)]
JAX_SHAPES = [(3, 1), (3, 256)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _products(curve, outputs: int, nbits: int):
    """(nlimbs, O, nbits) bit-row products from 24 seeded oracle points:
    output 0's upper half the identity (a counter scalar's zero high bytes),
    output 2 the identity but at bit 0, and every seventh row the identity."""
    pts = curve.oracle.random_points(24, seed=nbits + curve.kernel_id)
    rows = []
    for o in range(outputs):
        for b in range(nbits):
            ident = (o == 0 and nbits > 1 and b >= nbits // 2) or (o == 2 and b > 0) or (o * nbits + b) % 7 == 5
            rows.append(None if ident else pts[(5 * o + 3 * b) % 24])
    return curve.reshape_batch(curve.from_affine_ints(rows, "cpu"), (outputs, nbits))


def _host_ladder(harness, curve, products, seg_bits: int) -> np.ndarray:
    _, outputs, nbits = products.x.shape
    p = np.ascontiguousarray(np.stack([c.reshape(curve.nlimbs, -1).numpy() for c in products]))
    out = np.zeros((3, curve.nlimbs, outputs), np.int32)
    rc = harness.btt_host_w_ladder(ctypes.c_int(curve.kernel_id), ctypes.c_void_p(p.ctypes.data),
                                   ctypes.c_int64(outputs), ctypes.c_int(nbits), ctypes.c_int(seg_bits),
                                   ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return out


def _stack(p) -> np.ndarray:
    return np.stack([c.numpy() for c in p])


def test_segment_rule():
    """L = ceil(sqrt(nbits)), at most 32 segments."""
    assert [cuda_wpoint.ladder_segment_bits(n) for n in (1, 2, 8, 64, 255, 256, 257, 2000)] == \
        [1, 2, 3, 8, 16, 16, 17, 63]
    for n in range(1, 1100):
        seg = cuda_wpoint.ladder_segment_bits(n)
        assert -(-n // seg) <= 32


@pytest.mark.parametrize("outputs, nbits", SHAPES)
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_ladder_body_matches_plain(harness, curve, outputs, nbits):
    """The header's ladder in the kernel's segments equals the plain
    version in the same order limb for limb, and so does the one-segment
    ladder at up to 8 bits (at 256 bits test_ladder_matches_blitzar_tpu
    holds it limb for limb); the two orders give the same points."""
    products = _products(curve, outputs, nbits)
    seg = _host_ladder(harness, curve, products, cuda_wpoint.ladder_segment_bits(nbits))
    # the query's ladder, (R,) products of O outputs, on the plain version
    # (w_doubling_combine on a CPU tensor)
    flat = curve.reshape_batch(products, (outputs * nbits,))
    assert np.array_equal(seg, _stack(tfixed.doubling_combine(flat, outputs, nbits, curve)))
    one = _host_ladder(harness, curve, products, nbits)
    if nbits <= 8:
        assert np.array_equal(one, _stack(cuda_wpoint.w_doubling_combine_plain(curve, products, nbits)))
    got = wc.PointP2(*(torch.from_numpy(c) for c in seg))
    assert bool(curve.points_equal(got, wc.PointP2(*(torch.from_numpy(c) for c in one))).all())


@pytest.mark.parametrize("outputs, nbits", JAX_SHAPES)
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_ladder_matches_blitzar_tpu(harness, curve, outputs, nbits):
    """blitzar_tpu's _doubling_combine on the same products: limb for limb
    against the one-segment ladder, the same points as the kernel's
    segments."""
    products = _products(curve, outputs, nbits)
    jp = jw.PointP2(*(jnp.asarray(c) for c in to_jax_points(products)))
    want = np.stack([np.asarray(c) for c in jfixed._doubling_combine(jp, nbits, JAX_CURVES[curve.name])])
    one = _host_ladder(harness, curve, products, nbits)
    assert np.array_equal(one.astype(np.uint32), want)
    seg = _host_ladder(harness, curve, products, cuda_wpoint.ladder_segment_bits(nbits))
    got = wc.PointP2(*(torch.from_numpy(c) for c in seg))
    assert bool(curve.points_equal(got, from_jax_points(want, device="cpu")).all())
    if outputs == 3:  # output 2's only point is bit 0's
        assert curve.to_affine_ints(curve.index_batch(got, slice(2, 3))) == \
            curve.to_affine_ints(curve.index_batch(products, (slice(2, 3), 0)))
