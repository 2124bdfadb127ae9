"""The bucket engine's Horner over its 8-bit windows as one launch
(csrc/ladder.cuh with 8 doublings a step, run by csrc/ed_horner.cu for
ristretto255 and csrc/w_horner.cu for the Weierstrass curves), compiled for
the host with g++ through csrc/host_harness.cpp, which runs each output's
lanes one after another and then lane 0's fold.

In one segment (seg_bits = W) the ladder is the engine's loop
(``msm/engine.py:horner_plain``, blitzar_tpu/msm/engine.py:118-140): limb
for limb that loop and blitzar_tpu's; in the kernels' segments
(``ladder_segment_bits``) limb for limb the plain versions in the same order
(``ed_horner_plain``, ``w_horner_plain`` with ``seg_bits``), and the same
points as the loop. ristretto255 and bn254 G1; one to three outputs; 1, 4,
9 and 32 windows (a 32-byte column), some of them the identity."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.curves import weierstrass as jw
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import engine
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import to_jax_points, to_tensor

import torch_host_harness

# (outputs, windows): W = 1 returns the top window; 32 windows is a 32-byte
# column (6 segments of 6 on the card); 9 windows 3 segments of 3
SHAPES = [(1, 1), (3, 4), (2, 9), (1, 32)]
CURVES = [ted, wc.BN254_G1]


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


def _ident(o: int, w: int, windows: int) -> bool:
    """Output 1's windows but its top one, and every fifth, the identity
    (an empty window's sum)."""
    return (o == 1 and w < windows - 1) or (o * windows + w) % 5 == 3


def _windows(curve, outputs: int, windows: int):
    """(nlimbs, O, W) window sums from 12 seeded points, some identities."""
    if curve is ted:
        rng = np.random.default_rng(windows + 7 * outputs)
        r = rng.integers(0, 1 << 16, size=(2, 16, 12)).astype(np.int64)
        r[:, 15] &= 0x7FFF
        pts = ted._double_impl(cuda_point.elligator_form_plain(to_tensor(r[0], "cpu"), to_tensor(r[1], "cpu")))
        idx = torch.tensor([(3 * o + 5 * w) % 12 for o in range(outputs) for w in range(windows)])
        keep = ~torch.tensor([_ident(o, w, windows) for o in range(outputs) for w in range(windows)])
        rows = ted.index_batch(pts, idx)
        rows = ted.PointP3(*(torch.where(keep, c, ic) for c, ic in zip(rows, ted.identity((len(idx),)))))
        return ted.reshape_batch(rows, (outputs, windows))
    pts = curve.oracle.random_points(12, seed=windows + 7 * outputs)
    rows = [None if _ident(o, w, windows) else pts[(3 * o + 5 * w) % 12]
            for o in range(outputs) for w in range(windows)]
    return curve.reshape_batch(curve.from_affine_ints(rows, "cpu"), (outputs, windows))


def _stack(curve, p) -> np.ndarray:
    """Coordinates as (coords, nlimbs, O): canonical limbs for ristretto255,
    the Montgomery limbs (canonical already) for a Weierstrass curve."""
    return np.stack([(TF.canonicalize(c) if curve is ted else c).numpy() for c in p])


def _host_horner(harness, curve, windows, seg_bits: int, step_bits: int = 8) -> np.ndarray:
    _, outputs, num_windows = windows.x.shape
    w = np.ascontiguousarray(np.stack([c.reshape(c.shape[0], -1).numpy() for c in windows]))
    out = np.zeros((len(windows), w.shape[1], outputs), np.int32)
    rc = harness.btt_host_horner(ctypes.c_int(0 if curve is ted else curve.kernel_id), ctypes.c_void_p(w.ctypes.data),
                                 ctypes.c_int64(outputs), ctypes.c_int(num_windows), ctypes.c_int(seg_bits),
                                 ctypes.c_int(step_bits), ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return out


def _points(curve, a: np.ndarray):
    point = ted.PointP3 if curve is ted else wc.PointP2
    return point(*(torch.from_numpy(c) for c in a))


def _plain_in_segments(curve, windows, seg_bits: int):
    if curve is ted:
        return cuda_point.ed_horner_plain(windows, seg_bits)
    return cuda_wpoint.w_horner_plain(curve, windows, seg_bits)


@pytest.mark.parametrize("outputs, num_windows", SHAPES)
@pytest.mark.parametrize("curve", CURVES, ids=_name)
def test_horner_body_matches_plain(harness, curve, outputs, num_windows):
    """One segment: limb for limb the engine's loop (and the engine's
    Horner on a CPU tensor, which takes it); the kernels' segments: limb for
    limb the plain version in the same segments; both the same points."""
    windows = _windows(curve, outputs, num_windows)
    loop = _stack(curve, engine.horner_plain(windows, curve))
    one = _host_horner(harness, curve, windows, num_windows)
    assert np.array_equal(one, loop)
    assert np.array_equal(_stack(curve, engine.horner(windows, curve)), loop)
    seg_bits = cuda_point.ladder_segment_bits(num_windows)
    seg = _host_horner(harness, curve, windows, seg_bits)
    assert np.array_equal(seg, _stack(curve, _plain_in_segments(curve, windows, seg_bits)))
    assert bool(curve.points_equal(_points(curve, seg), _points(curve, one)).all())
    if num_windows == 1:
        assert np.array_equal(one, _stack(curve, curve.index_batch(windows, (slice(None), 0))))


@pytest.mark.parametrize("curve", CURVES, ids=_name)
def test_horner_in_every_segment_length(harness, curve):
    """Segments of 1, 2, 4, 5 and 8 windows of a 9-window sum (short top
    segments among them) give the same points; step 1 is the query
    ladder's (``btt_host_ladder``)."""
    windows = _windows(curve, 2, 9)
    want = _points(curve, _host_horner(harness, curve, windows, 9))
    for seg_bits in (1, 2, 4, 5, 8):
        got = _host_horner(harness, curve, windows, seg_bits)
        assert np.array_equal(got, _stack(curve, _plain_in_segments(curve, windows, seg_bits))), seg_bits
        assert bool(curve.points_equal(_points(curve, got), want).all()), seg_bits
    w = np.ascontiguousarray(np.stack([c.reshape(c.shape[0], -1).numpy() for c in windows]))
    ladder = np.zeros((len(windows), w.shape[1], 2), np.int32)
    rc = harness.btt_host_ladder(ctypes.c_int(0 if curve is ted else curve.kernel_id), ctypes.c_void_p(w.ctypes.data),
                                 ctypes.c_int64(2), ctypes.c_int(9), ctypes.c_int(3),
                                 ctypes.c_void_p(ladder.ctypes.data))
    assert rc == 0
    assert np.array_equal(ladder, _host_horner(harness, curve, windows, 3, step_bits=1))


def test_horner_matches_blitzar_tpu(harness):
    """blitzar_tpu's Horner (its combine_buckets' loop: 8 doublings and an
    add a window, blitzar_tpu/msm/engine.py:131-140) on the same window
    sums, limb for limb against the one-segment ladder, ristretto255 and
    bn254 G1."""
    for curve, jcurve in ((ted, None), (wc.BN254_G1, jw.BN254_G1)):
        windows = _windows(curve, 3, 4)
        if jcurve is None:
            jw_ = jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(windows)))
            dbl, add, pick = jax.jit(jed._double_impl), jax.jit(jed._add_impl), jed.PointP3
        else:
            jw_ = jw.PointP2(*(jnp.asarray(c) for c in to_jax_points(windows)))
            dbl, add, pick = jax.jit(jcurve._double_impl), jax.jit(jcurve._add_impl), jw.PointP2
        acc = pick(*(c[:, :, 3] for c in jw_))
        for idx in (2, 1, 0):
            for _ in range(8):
                acc = dbl(acc)
            acc = add(acc, pick(*(c[:, :, idx] for c in jw_)))
        want = np.stack([np.asarray(JF.canonicalize(c) if jcurve is None else c) for c in acc])
        assert np.array_equal(_host_horner(harness, curve, windows, 4).astype(np.uint32), want.astype(np.uint32))


def test_horner_wrappers_check_windows():
    with pytest.raises(ValueError, match="at least one window"):
        cuda_point.ed_horner(ted.identity((1, 0)))
    with pytest.raises(ValueError, match="at least one window"):
        cuda_wpoint.w_horner(wc.BN254_G1, wc.BN254_G1.identity((1, 0)))
