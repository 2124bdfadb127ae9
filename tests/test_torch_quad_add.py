"""The four-lane adds (csrc/quad_add.cuh: ed_add.cu and niels_add.cu), run
by the host harness lane by lane through an exchange array, against
blitzar_tpu's curves/edwards25519.py add (and add of neg, the negate_q
flag) and its Pallas niels_add in interpret mode: the identity, P + P,
P + (-P) and values at the top of the limbs' range among seeded points;
and a signed ristretto255 commitment (its Q_pos - Q_neg one ed_add that
reads Q_neg negated) through the port's API against blitzar_tpu's
pure-Python oracle (refimpl/core.py)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_harness
from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.ops import pallas_point
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch import api
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints, to_jax_points, to_tensor

P = 2**255 - 19
COUNT = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _points(seed: int) -> np.ndarray:
    """(4, 16, COUNT) points (the plain elligator_form of seeded field
    elements), canonical limbs."""
    r = np.random.default_rng(seed).integers(0, 1 << 16, size=(2, 16, COUNT)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    return np.asarray(to_jax_points(cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1])))).astype(np.int64)


def _pairs() -> tuple[np.ndarray, np.ndarray]:
    """p, q with pair 0 the identity twice, 1 P + identity, 2 P + P, 3 P + (-P),
    and pairs 4-11 P + Q with every coordinate written as value + p or + 2p
    (below 2^256: the top of the 16-bit limbs' range)."""
    p, q = _points(21), _points(22)
    ident = np.array([ints_to_limbs([v])[:, 0] for v in (0, 1, 1, 0)])
    p[:, :, 0] = q[:, :, 0] = q[:, :, 1] = ident
    q[:, :, 2] = p[:, :, 2]
    q[:, :, 3] = p[:, :, 3]
    for c in (0, 3):
        q[c, :, 3] = ints_to_limbs([(P - limbs_to_ints(p[c, :, 3:4])[0]) % P])[:, 0]
    for pts in (p, q):
        for c in range(4):
            vals = limbs_to_ints(pts[c, :, 4:12])
            pts[c, :, 4:12] = ints_to_limbs([v + P if v + 2 * P >= 2**256 else v + 2 * P for v in vals])
    return p, q


def _canon(coords) -> np.ndarray:
    return np.stack([np.asarray(JF.canonicalize(jnp.asarray(np.asarray(c, np.uint32)))) for c in coords]
                    ).astype(np.int64)


def _call(fn, *arrays, flag=None, out_shape):
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    out = np.zeros(out_shape, np.int32)
    args = [ctypes.c_void_p(a.ctypes.data) for a in arrays]
    if flag is not None:
        args.append(ctypes.c_int(flag))
    fn(*args, ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(out_shape[-1]))
    return out.astype(np.int64)


def _jax(points):
    return jed.PointP3(*(jnp.asarray(np.asarray(c, np.uint32)) for c in points))


@pytest.mark.parametrize("negate_q", [False, True])
def test_quad_ed_add_matches_jax(harness, negate_q):
    p, q = _pairs()
    got = _call(harness.btt_host_ed_add_quad, p, q, flag=int(negate_q), out_shape=p.shape)
    jq = jed.neg(_jax(q)) if negate_q else _jax(q)
    assert np.array_equal(got, _canon(jed.add(_jax(p), jq)))
    tp, tq = (ted.PointP3(*(to_tensor(c) for c in x)) for x in (p, q))
    plain = cuda_point.ed_add(tp, tq, negate_q=negate_q)
    assert np.array_equal(got, _canon([c.numpy() for c in plain]))
    sums = ted.PointP3(*(to_tensor(c) for c in got))
    zero = 2 if negate_q else 3  # P - P, or P + (-P); and the identity doubled
    assert bool(ted.points_equal(ted.index_batch(sums, [0, zero]), ted.identity((2,))).all())


def _niels(points: np.ndarray) -> np.ndarray:
    tp = ted.PointP3(*(to_tensor(c) for c in points))
    niels = cuda_point.unpack_niels(cuda_point.pack_niels(ted.to_niels(tp)))
    return np.stack([c.numpy() for c in niels]).astype(np.int64)


def test_quad_niels_add_matches_pallas_interpret(harness):
    p, q = _points(23), _points(24)
    q[:, :, :2] = p[:, :, :2]  # doublings
    q[0, :, 2:4] = ints_to_limbs([(P - v) % P for v in limbs_to_ints(p[0, :, 2:4])])  # P + (-P)
    q[1:, :, 2:4] = p[1:, :, 2:4]
    q[3, :, 2:4] = ints_to_limbs([(P - v) % P for v in limbs_to_ints(p[3, :, 2:4])])
    n1, n2 = _niels(p), _niels(q)
    top = n1.copy()  # the same entries as value + p or + 2p
    for c in range(3):
        top[c] = ints_to_limbs([v + P if v + 2 * P >= 2**256 else v + 2 * P for v in limbs_to_ints(n1[c])])
    jn2 = jed.Niels(*(jnp.asarray(c.astype(np.uint32)) for c in n2))
    want = None
    for first in (n1, top):
        got = _call(harness.btt_host_niels_add_quad, first, n2, out_shape=(4, 16, COUNT))
        if want is None:
            jn1 = jed.Niels(*(jnp.asarray(c.astype(np.uint32)) for c in first))
            want = _canon(pallas_point.niels_add(jn1, jn2, interpret=True))
        assert np.array_equal(got, want)
    sums = ted.PointP3(*(to_tensor(c) for c in got))
    assert bool(ted.points_equal(ted.index_batch(sums, slice(2, 4)), ted.identity((2,))).all())


def test_signed_commitment_matches_blitzar_tpu():
    """One-byte extremes and a signed 8-byte column through the port's API
    on the CPU (its Q_pos - Q_neg: ed_add with negate_q), against
    blitzar_tpu's oracle sum of signed multiples of the same generators."""
    columns = [([-128, 127, -1, 0, 1, -128], 1), ([-(1 << 63), (1 << 63) - 1, -1, 12345, -987654321, 1], 8)]
    rows = [[v % (1 << (8 * nb)) for v in vals] for vals, nb in columns]
    descriptors = [api.SequenceDescriptor(nb, len(r), np.array([np.frombuffer(v.to_bytes(nb, "little"), np.uint8)
                                                                 for v in r]), True)
                   for r, (_, nb) in zip(rows, columns)]
    api.reset_backend_for_testing()
    try:
        api.init("cpu")
        got = api.compute_curve25519_commitments(descriptors)
    finally:
        api.reset_backend_for_testing()
    gens = R.get_generators(max(len(r) for r in rows))
    want = [R.ristretto_encode(R.pedersen_commitment(r, nb, True, gens)) for r, (_, nb) in zip(rows, columns)]
    assert [bytes(g) for g in got] == want
