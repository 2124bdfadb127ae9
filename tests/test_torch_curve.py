"""blitzar_tpu_torch's Edwards group law and ristretto255 layer (plain
PyTorch) against blitzar_tpu's on the same points, the RFC 9496 vectors and
the pure-Python oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.curves import ristretto as jrst
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import from_jax_points, ints_to_limbs, to_jax_points, to_tensor
from vectors import RISTRETTO_BASEPOINT_MULTIPLES

P = R.P
ORACLE = [R.compute_base_element(i) for i in range(12)]
ORACLE = ORACLE + [R.pt_scalar_mul(3 + i, p) for i, p in enumerate(ORACLE[:4])]  # 16 points


def _coords(points) -> np.ndarray:
    """Oracle (X, Y, Z, T) tuples -> (4, 16, n) uint32 limbs."""
    return np.stack([ints_to_limbs([p[k] for p in points]) for k in range(4)]).astype(np.uint32)


def _niels(points) -> np.ndarray:
    """Oracle points -> (3, 16, n) affine niels limbs (y + x, y - x, 2d*x*y)."""
    rows = [[], [], []]
    for X, Y, Z, _ in points:
        zi = pow(Z, P - 2, P)
        x, y = X * zi % P, Y * zi % P
        rows[0].append((y + x) % P)
        rows[1].append((y - x) % P)
        rows[2].append(R.D2 * x * y % P)
    return np.stack([ints_to_limbs(r) for r in rows]).astype(np.uint32)


def _jax_point(coords):
    return jed.PointP3(*(jnp.asarray(c) for c in coords))


def _canon_jax(p) -> np.ndarray:
    from blitzar_tpu.fields import fp25519 as JF

    return np.stack([np.asarray(JF.canonicalize(c)) for c in p]).astype(np.uint32)


def _encodings(raw) -> list[bytes]:
    raw = np.asarray(raw.cpu() if isinstance(raw, torch.Tensor) else raw)
    return [bytes(raw[:, j]) for j in range(raw.shape[1])]


PTS = _coords(ORACLE[:8])
QTS = _coords(ORACLE[8:])
NIELS = _niels(ORACLE[8:])
NIELS2 = _niels(ORACLE[:8])


def test_add_double_match_jax():
    p, q = from_jax_points(PTS, device="cpu"), from_jax_points(QTS, device="cpu")
    jp, jq = _jax_point(PTS), _jax_point(QTS)
    assert np.array_equal(to_jax_points(ted._add_impl(p, q)), _canon_jax(jed._add_impl(jp, jq)))
    assert np.array_equal(to_jax_points(ted._double_impl(p)), _canon_jax(jed._double_impl(jp)))


def test_madd_niels_add_match_jax():
    p = from_jax_points(PTS, device="cpu")
    n1 = ted.Niels(*(to_tensor(c) for c in NIELS))
    n2 = ted.Niels(*(to_tensor(c) for c in NIELS2))
    jn1 = jed.Niels(*(jnp.asarray(c) for c in NIELS))
    jn2 = jed.Niels(*(jnp.asarray(c) for c in NIELS2))
    got = ted._madd_impl(p, n1)
    assert np.array_equal(to_jax_points(got), _canon_jax(jed._madd_impl(_jax_point(PTS), jn1)))
    assert np.array_equal(to_jax_points(ted._niels_add_impl(n1, n2)), _canon_jax(jed._niels_add_impl(jn1, jn2)))
    # and madd is the group law: p + q
    want = [R.ristretto_encode(R.pt_add(a, b)) for a, b in zip(ORACLE[:8], ORACLE[8:])]
    assert _encodings(trst.encode(got)) == want


def test_encode_matches_jax_and_oracle():
    got = _encodings(trst.encode(from_jax_points(_coords(ORACLE), device="cpu")))
    assert got == _encodings(jrst.encode(_jax_point(_coords(ORACLE))))
    assert got == [R.ristretto_encode(p) for p in ORACLE]


def test_decode_matches_jax_and_rejects():
    enc = np.stack([np.frombuffer(R.ristretto_encode(p), np.uint8) for p in ORACLE], axis=1)
    bad = np.zeros((32, 3), np.uint8)
    bad[0, 0] = 1  # odd s
    bad[:, 1] = 0xFF  # >= p, top bit set
    bad[0, 2] = 0xEE  # p + 1: not canonical
    bad[1:31, 2] = 0xFF
    bad[31, 2] = 0x7F
    data = np.concatenate([enc, bad], axis=1)
    pts, valid = trst.decode(torch.from_numpy(data))
    jpts, jvalid = jrst.decode(jnp.asarray(data))
    assert valid.tolist() == np.asarray(jvalid).tolist() == [True] * len(ORACLE) + [False] * 3
    n = len(ORACLE)
    got = to_jax_points(pts)[:, :, :n]
    assert np.array_equal(got, _canon_jax(jpts)[:, :, :n])
    assert _encodings(trst.encode(ted.index_batch(pts, slice(0, n)))) == _encodings(enc)


def test_rfc9496_basepoint_multiples():
    raw = np.stack([np.frombuffer(bytes.fromhex(h), np.uint8) for h in RISTRETTO_BASEPOINT_MULTIPLES], axis=1)
    pts, valid = trst.decode(torch.from_numpy(raw))
    assert valid.all()
    b = ted.index_batch(pts, slice(1, 2))
    two = ted._add_impl(b, b)
    three = ted._add_impl(two, b)
    multiples = ted.cat([ted.identity((1,)), b, two, three])
    assert [e.hex() for e in _encodings(trst.encode(multiples))] == RISTRETTO_BASEPOINT_MULTIPLES


def test_elligator_form_plain_matches_jax():
    rng = np.random.default_rng(11)
    r0 = rng.integers(0, 1 << 16, size=(16, 12), dtype=np.uint32)
    r1 = rng.integers(0, 1 << 16, size=(16, 12), dtype=np.uint32)
    r0[15] &= 0x7FFF
    r1[15] &= 0x7FFF
    r0[:, 0] = 0  # the map of 0
    got = cuda_point.elligator_form_plain(to_tensor(r0), to_tensor(r1))
    # one jitted program: run op by op, blitzar_tpu's map took ~60 s of dispatches
    want = jax.jit(lambda a, b: jed.add(jrst.elligator(b), jrst.elligator(a)))(jnp.asarray(r0), jnp.asarray(r1))
    assert np.array_equal(to_jax_points(got), _canon_jax(want))


@pytest.mark.parametrize("size", [1, 5, 16])
def test_tree_reduce_matches_oracle(size):
    pts = from_jax_points(_coords(ORACLE[:size]), device="cpu")
    total = ted.tree_reduce(pts, size)
    acc = R.IDENTITY
    for p in ORACLE[:size]:
        acc = R.pt_add(acc, p)
    one = ted.PointP3(*(c[:, None] for c in total))
    assert _encodings(trst.encode(one)) == [R.ristretto_encode(acc)]


def test_neg_on_curve_and_equality():
    p = from_jax_points(_coords(ORACLE), device="cpu")
    assert bool(ted.is_on_curve(p).all())
    assert not bool(ted.is_identity(p).any())
    s = ted._add_impl(p, ted.neg(p))
    assert bool(ted.is_identity(s).all())
    # same points, other projective coordinates
    scaled = ted.PointP3(*(TF.mul_small(c, 7) for c in p))
    assert bool(ted.points_equal(p, scaled).all())
    off = ted.PointP3(TF.add_const(p.x, 1), p.y, p.z, p.t)
    assert not bool(ted.is_on_curve(off).any())
