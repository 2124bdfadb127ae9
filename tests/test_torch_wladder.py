"""The ladder of one launch (csrc/ladder.cuh, run by
csrc/w_doubling_combine.cu for the Weierstrass curves and by
csrc/doubling_combine.cu for ristretto255): out[o] = sum_b 2^b *
products[o, b], compiled for the host with g++ through
csrc/host_harness.cpp, which runs each output's lanes one after another and
then lane 0's fold.

With one segment (seg_bits = nbits) the ladder is blitzar_tpu's order, and
its coordinates equal blitzar_tpu's ``_doubling_combine``
(blitzar_tpu/msm/fixed.py:596) limb for limb; with the kernel's segments
(``ladder_segment_bits``) they equal the port's plain version in the same
order (``w_doubling_combine_plain``, ``doubling_combine_plain(products,
seg_bits)``) limb for limb, and blitzar_tpu's as points. All four curves,
one and three outputs (ten for ristretto255), 1, 8 and 256 bits, and bit
rows that are the identity."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.curves import weierstrass as jw
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points, to_tensor

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
    """The harness's ladder; curve None: ristretto255 (curve id 0)."""
    _, outputs, nbits = products.x.shape
    p = np.ascontiguousarray(np.stack([c.reshape(c.shape[0], -1).numpy() for c in products]))
    out = np.zeros((len(products), p.shape[1], outputs), np.int32)
    rc = harness.btt_host_ladder(ctypes.c_int(curve.kernel_id if curve else 0), ctypes.c_void_p(p.ctypes.data),
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


# ---------------------------------------------------------------------------
# ristretto255: the same ladder on extended Edwards points
# ---------------------------------------------------------------------------

ED_SHAPES = [(1, 1), (3, 1), (1, 8), (3, 8), (1, 256), (10, 256)]


def _ed_products(outputs: int, nbits: int) -> ted.PointP3:
    """(16, O, nbits) bit-row products: 24 seeded points (the plain
    elligator form of seeded field elements, doubled so z != 1) with the
    identity rows of _products."""
    rng = np.random.default_rng(nbits + outputs)
    r = rng.integers(0, 1 << 16, size=(2, 16, 24)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    pts = ted._double_impl(cuda_point.elligator_form_plain(to_tensor(r[0], "cpu"), to_tensor(r[1], "cpu")))
    idx, ident = [], []
    for o in range(outputs):
        for b in range(nbits):
            idx.append((5 * o + 3 * b) % 24)
            ident.append((o == 0 and nbits > 1 and b >= nbits // 2) or (o == 2 and b > 0) or (o * nbits + b) % 7 == 5)
    rows = ted.index_batch(pts, torch.tensor(idx))
    keep = ~torch.tensor(ident)
    rows = ted.PointP3(*(torch.where(keep, c, ic) for c, ic in zip(rows, ted.identity((len(idx),)))))
    return ted.reshape_batch(rows, (outputs, nbits))


def _ed_canon(p) -> np.ndarray:
    return np.stack([TF.canonicalize(c).numpy() for c in p])


def _ed_points(a: np.ndarray) -> ted.PointP3:
    return ted.PointP3(*(torch.from_numpy(c) for c in a))


def test_ed_segment_rule_is_shared():
    """One rule for both kernels' segments."""
    assert cuda_point.ladder_segment_bits is cuda_wpoint.ladder_segment_bits


@pytest.mark.parametrize("outputs, nbits", ED_SHAPES)
def test_ed_ladder_body_matches_plain(harness, outputs, nbits):
    """The header's Edwards ladder in the kernel's segments equals
    doubling_combine_plain in the same segments limb for limb; in one
    segment it equals the default plain version (blitzar_tpu's order) limb
    for limb; the two orders give the same points."""
    products = _ed_products(outputs, nbits)
    seg_bits = cuda_point.ladder_segment_bits(nbits)
    seg = _host_ladder(harness, None, products, seg_bits)
    assert np.array_equal(seg, _ed_canon(cuda_point.doubling_combine_plain(products, seg_bits)))
    one = _host_ladder(harness, None, products, nbits)
    # the query's ladder on the plain version (doubling_combine on a CPU tensor)
    flat = ted.reshape_batch(products, (outputs * nbits,))
    assert np.array_equal(one, _ed_canon(tfixed.doubling_combine(flat, outputs, nbits)))
    assert bool(ted.points_equal(_ed_points(seg), _ed_points(one)).all())


def test_ed_ladder_matches_blitzar_tpu(harness):
    """blitzar_tpu's _doubling_combine on three outputs' 256 bit-row
    products: limb for limb against the one-segment ladder, the same points
    as the kernel's segments; output 2's only point is bit 0's."""
    outputs, nbits = 3, 256
    products = _ed_products(outputs, nbits)
    jp = jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(products)))
    want = np.stack([np.asarray(JF.canonicalize(c)) for c in jfixed._doubling_combine(jp, nbits)])
    one = _host_ladder(harness, None, products, nbits)
    assert np.array_equal(one.astype(np.uint32), want.astype(np.uint32))
    seg = _ed_points(_host_ladder(harness, None, products, cuda_point.ladder_segment_bits(nbits)))
    assert bool(ted.points_equal(seg, from_jax_points(want, device="cpu")).all())
    assert bool(ted.points_equal(ted.index_batch(seg, slice(2, 3)),
                                 ted.index_batch(products, (slice(2, 3), 0))).all())


def test_harness_rejects_ladders_the_kernels_reject(harness):
    """More than 32 segments, or no bit, as the launchers."""
    p = np.zeros(4 * 16 * 40, np.int32)
    out = np.zeros(4 * 16, np.int32)
    for nbits, seg_bits in ((40, 1), (0, 1), (8, 0)):
        assert harness.btt_host_ladder(ctypes.c_int(0), ctypes.c_void_p(p.ctypes.data), ctypes.c_int64(1),
                                       ctypes.c_int(nbits), ctypes.c_int(seg_bits),
                                       ctypes.c_void_p(out.ctypes.data)) == -1
