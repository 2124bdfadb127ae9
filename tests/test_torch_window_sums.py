"""The bucket engine's window sums as one launch (csrc/window_sums.cuh, run
by csrc/window_sums.cu for all four curves), compiled for the host with g++
through csrc/host_harness.cpp, which runs each row's 32 lanes one after
another at every shuffle step.

The kernel adds in another order than the plain reverse scan and tree
(``cuda_point.window_sums_plain``, blitzar_tpu/msm/engine.py:118-126's
order), so the two give the same points, not the same coordinates: rows of
seeded points with identities among them, a row of identities alone (a
window whose digits are all 0), a row with only bucket 255 set and one with
only the top of each lane's run set, on ristretto255 and the three
Weierstrass curves (whose sums also equal the oracle's). The bucket engine's
commitment through them equals blitzar_tpu's ``msm_jit`` at w = 8 (one
compile here, about a minute alone)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import engine as jengine
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.msm import engine
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_tensor

import torch_host_harness

CURVES = [ted] + list(wc.CURVES)
BUCKETS = cuda_point.WINDOW_BUCKETS
POOL = 40  # distinct points the rows draw from


def _name(curve) -> str:
    return "ristretto255" if curve is ted else curve.name


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _pool(curve):
    """POOL seeded points and, for a Weierstrass curve, their affine ints."""
    if curve is ted:
        rng = np.random.default_rng(91)
        r = rng.integers(0, 1 << 16, size=(2, 16, POOL)).astype(np.int64)
        r[:, 15] &= 0x7FFF
        return ted._double_impl(cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1]))), None
    pts = curve.oracle.random_points(POOL, seed=92)
    return curve.from_affine_ints(pts, "cpu"), pts


# rows: seeded points with every fifth bucket empty; all empty; bucket 255
# alone; the top bucket of each lane's run (buckets 225 .. 255, digits
# t + 1 + 32 * 7, lane 31's the identity slot) alone
ROWS = 4


def _picks() -> np.ndarray:
    """(ROWS, 255) pool indices, -1 for an empty bucket."""
    k = np.arange(BUCKETS)
    rows = np.full((ROWS, BUCKETS), -1)
    rows[0] = np.where(k % 5 == 3, -1, (7 * k + 3) % POOL)
    rows[2, 254] = 11
    rows[3, 224:] = (k[224:] * 3) % POOL
    return rows


def _buckets(curve, pool):
    picks = torch.from_numpy(_picks())
    flat = curve.index_batch(pool, picks.clamp(min=0).reshape(-1))
    empty = curve.identity((ROWS * BUCKETS,))
    return curve.reshape_batch(curve.select(flat, empty, (picks < 0).reshape(-1)), (ROWS, BUCKETS))


def _host(harness, curve, buckets):
    b = np.ascontiguousarray(np.stack([c.reshape(c.shape[0], -1).numpy() for c in buckets]))
    out = np.zeros((len(buckets), b.shape[1], ROWS), np.int32)
    rc = harness.btt_host_window_sums(ctypes.c_int(0 if curve is ted else curve.kernel_id),
                                      ctypes.c_void_p(b.ctypes.data), ctypes.c_int64(ROWS),
                                      ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    point = ted.PointP3 if curve is ted else wc.PointP2
    return point(*(torch.from_numpy(c) for c in out))


@pytest.mark.parametrize("curve", CURVES, ids=_name)
def test_window_sums_body_matches_plain(harness, curve):
    """The harness's rows equal the plain scan and tree as points; the
    engine's window sums on a CPU tensor are the plain version limb for
    limb; the empty row is the identity; a Weierstrass row equals the
    oracle's sum_k k P_k."""
    pool, affine = _pool(curve)
    buckets = _buckets(curve, pool)
    plain = cuda_point.window_sums_plain(curve, buckets)
    host = _host(harness, curve, buckets)
    assert bool(curve.points_equal(host, plain).all())
    wrapper = engine.window_sums(buckets, curve)
    assert all(torch.equal(a, b) for a, b in zip(wrapper, plain))
    assert bool(curve.points_equal(curve.index_batch(host, slice(1, 2)), curve.identity((1,))).all())
    if affine is not None:
        picks = _picks()
        for r in range(ROWS):
            ks = [k + 1 for k in range(BUCKETS) if picks[r, k] >= 0]
            want = curve.oracle.msm(ks, [affine[picks[r, k - 1]] for k in ks]) if ks else None
            assert curve.to_affine_ints(curve.index_batch(host, slice(r, r + 1))) == [want], r


def test_window_sums_of_255_buckets_only():
    with pytest.raises(ValueError, match="255"):
        cuda_point.ed_window_sums(ted.identity((2, 254)))
    with pytest.raises(ValueError, match="255"):
        cuda_wpoint.w_window_sums(wc.BN254_G1, wc.BN254_G1.identity((2, 256)))


def test_bucket_engine_matches_jax_msm_jit():
    """The port's bucket engine and blitzar_tpu's ``msm_jit`` on the same
    digits at w = 8, n = 16: two 2-byte outputs, the first unsigned with only
    digit 255 in its low window and nothing in its high one (a row of bucket
    255 alone, a row of identities), the second signed and random."""
    n = 16
    rng = np.random.default_rng(93)
    scalars = np.zeros((2, n, 2), np.uint8)
    scalars[0, [2, 9], 0] = 255
    scalars[1] = rng.integers(0, 256, size=(n, 2), dtype=np.uint8)
    signs = np.zeros((2, n), np.uint8)
    signs[1] = rng.integers(0, 2, size=n, dtype=np.uint8)
    jg = jgen.ristretto_generators(n)
    want = jengine.msm_jit(jg, jengine.digit_decompose(jnp.asarray(scalars)), jnp.asarray(signs),
                           num_outputs=2, num_windows=2, capacity=jengine.choose_capacity(n))
    tg = from_jax_points(np.stack([np.asarray(c) for c in jg]), device="cpu")
    got = engine.msm_digits(tg, engine.digit_decompose(torch.from_numpy(scalars)), torch.from_numpy(signs), 2, 2,
                            engine.choose_capacity(n))
    want_t = from_jax_points(np.stack([np.asarray(JF.canonicalize(c)) for c in want]), device="cpu")
    assert np.array_equal(trst.encode(got).numpy(), trst.encode(want_t).numpy())
    # output 0's rows: bucket 255 alone holds G_2 + G_9; the high window is empty
    buckets = engine.bucket_accumulate(tg, engine.digit_decompose(torch.from_numpy(scalars[:1]))[0], None, 8)
    two = ted._add_impl(ted.index_batch(tg, slice(2, 3)), ted.index_batch(tg, slice(9, 10)))
    assert bool(ted.points_equal(ted.index_batch(buckets, (slice(0, 1), 254)), two).all())
    assert bool(ted.points_equal(ted.index_batch(buckets, (slice(1, 2), slice(None))),
                                 ted.identity((1, BUCKETS))).all())
