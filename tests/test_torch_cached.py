"""The cached entry form and the lane tree reduce of blitzar_tpu_torch
against blitzar_tpu: ``to_cached``, ``cached_to_p3`` and ``_cadd_impl``
(curves/edwards25519.py:119-157), the plain cached table build against
blitzar_tpu's ``_ed_cached_split`` (msm/fixed.py:222-236) decoded from its
byte-split table, and the plain versions of ``tree_reduce_lanes`` against
blitzar_tpu's ``tree_reduce`` (ristretto255 and a Weierstrass curve)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points, to_tensor


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _points(seed: int, count: int) -> ted.PointP3:
    """count distinct points (the plain elligator form of seeded field
    elements), extended with z != 1 (doubled), on the CPU."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1 << 16, size=(2, 16, count)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    return ted._double_impl(cuda_point.elligator_form_plain(to_tensor(r[0], "cpu"), to_tensor(r[1], "cpu")))


def _canon_jax(coords) -> np.ndarray:
    return np.stack([np.asarray(JF.canonicalize(jnp.asarray(c))) for c in coords]).astype(np.uint32)


def _canon(coords) -> np.ndarray:
    return np.stack([TF.canonicalize(c).numpy() for c in coords]).astype(np.uint32)


def _jpoint(p: ted.PointP3) -> jed.PointP3:
    return jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(p)))


def test_to_cached_and_back_match_jax():
    p = _points(1, 40)
    got = ted.to_cached(p)
    want = jed.to_cached(_jpoint(p))
    assert np.array_equal(_canon(got), _canon_jax(want))
    back = ted.cached_to_p3(got)
    assert np.array_equal(_canon(back), _canon_jax(jed.cached_to_p3(want)))
    assert bool(ted.points_equal(back, p).all())


def test_cadd_matches_jax_and_the_unified_add():
    p, q = _points(2, 40), _points(3, 40)
    q = ted.PointP3(*(torch.cat([c[:, :36], pc[:, :4]], dim=1) for c, pc in zip(q, p)))  # doublings
    got = ted._cadd_impl(p, ted.to_cached(q))
    want = jed._cadd_impl(_jpoint(p), jed.to_cached(_jpoint(q)))
    assert np.array_equal(_canon(got), _canon_jax(want))
    assert bool(ted.points_equal(got, ted._add_impl(p, q)).all())
    ident = ted._cadd_impl(p, ted.to_cached(ted.identity((40,))))
    assert bool(ted.points_equal(ident, p).all())


@pytest.mark.parametrize("w", [4, 8])
def test_cached_table_matches_jax_split(w):
    """Three groups' tables: the port's packed words against blitzar_tpu's
    byte-split cached storage, decoded (low byte | high byte << 8), limb for
    limb (the same sums in the same order)."""
    groups = 3
    pts = _points(4 + w, groups * w)
    table = cuda_point.build_cached_table_plain(pts, w)
    assert table.shape == (groups, 1 << w, 4, 8)
    sums = cuda_point.subset_sums_plain(pts, w)  # (16, G, V)
    split = np.asarray(jfixed._ed_cached_split(_jpoint(sums)))  # (G, 128, V)
    full = split[:, :64].astype(np.uint32) | (split[:, 64:].astype(np.uint32) << 8)  # (G, 64, V)
    want = np.stack([np.moveaxis(full[:, 16 * k : 16 * (k + 1)], 1, 0) for k in range(4)])  # (4, 16, G, V)
    got = np.stack([c.numpy() for c in cuda_point.unpack_cached(table)]).astype(np.uint32)
    assert np.array_equal(got, _canon_jax(want))
    # entry 0 is the identity (1, 1, 1, 0), entry 2^j the point P_j
    assert np.array_equal(got[:, :, :, 0], _canon_jax(jed.to_cached(jed.identity((groups,)))))
    one_point = ted.cached_to_p3(cuda_point.unpack_cached(table[:, 1 << (w - 1)]))
    assert bool(ted.points_equal(one_point, ted.index_batch(pts, slice(w - 1, None, w))).all())


def _enc(p) -> np.ndarray:
    return trst.encode(p).numpy().T


def test_tree_reduce_plain_matches_jax():
    """The ristretto255 tree over a (4, 3) batch against blitzar_tpu's tree
    over the last axis of the transposed batch (whose eager levels compile
    per shape on this host), as encodings."""
    size = 4
    pts = ted.reshape_batch(_points(10, size * 3), (size, 3))
    got = cuda_point.tree_reduce_lanes(pts)  # the CPU runs the plain version
    assert got.x.shape == (16, 3)
    jp = jed.PointP3(*(jnp.asarray(np.ascontiguousarray(c)) for c in to_jax_points(pts).transpose(0, 1, 3, 2)))
    want = jed.tree_reduce(jp, size)
    assert np.array_equal(_enc(got), _enc(from_jax_points(np.stack([np.asarray(c) for c in want]), device="cpu")))


@pytest.mark.parametrize("shape", [(1, 3), (5, 2), (64,), (7, 2, 3)])
def test_tree_reduce_plain_sums_the_leading_axis(shape):
    """Any leading size (odd levels carry their last element) and any
    trailing batch shape: the same point as a serial sum."""
    size, rest = shape[0], shape[1:]
    count = int(np.prod(shape))
    pts = ted.reshape_batch(_points(20 + count, count), shape)
    got = cuda_point.tree_reduce_lanes(pts)
    assert got.x.shape == (16,) + rest
    acc = ted.index_batch(pts, 0)
    for s in range(1, size):
        acc = ted._add_impl(acc, ted.index_batch(pts, s))
    assert bool(ted.points_equal(got, acc).all())


def test_w_tree_reduce_plain_matches_jax():
    """bn254 G1 over a (4, 2) batch (the identity among the points),
    against blitzar_tpu's tree (whose eager levels compile per shape on
    this host), as affine points, and against the oracle."""
    tc, jc = twc.BN254_G1, jwc.BN254_G1
    size = 4
    pts = tc.oracle.random_points(2 * size - 1, seed=5) + [None]
    batch = tc.reshape_batch(tc.from_affine_ints(pts, "cpu"), (size, 2))
    got = cuda_wpoint.w_tree_reduce_lanes(tc, batch)
    jp = jc.from_affine_ints([pts[2 * s + c] for c in range(2) for s in range(size)])
    jp = jwc.PointP2(*(c.reshape(c.shape[0], 2, size) for c in jp))
    want = jc.tree_reduce(jp, size)
    want_t = from_jax_points(np.stack([np.asarray(c) for c in want]), device="cpu")
    assert tc.to_affine_ints(got) == tc.to_affine_ints(want_t)
    assert tc.to_affine_ints(got) == [tc.oracle.msm([1] * size, pts[c::2]) for c in range(2)]
