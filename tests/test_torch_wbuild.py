"""The Weierstrass table build's own arithmetic and order (csrc/table_build.cuh's
lane schedule with the Weierstrass entry form, ``WBuild<C>``, which
csrc/w_build_table.cu launches), compiled for the host with g++ through
csrc/host_harness.cpp, which builds whole tables with it one group and one
lane after another. The tables are projective, so their words depend on the
order of the adds: they are held limb for limb against the plain version
(``w_build_table_plain``, blitzar_tpu's order) on all three curves at every
window up to 8 (4 lanes a group) and at 10 and 12 (16 and 64 lanes a group,
64 rows each), and the plain version against blitzar_tpu's own table build
as it runs on the CPU (``_build_split_table_xla``; its Pallas kernel in
interpret mode is too slow there), decoded from the byte split. The cached
form of the same schedule is held in tests/test_torch_table_build.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import weierstrass as jw
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.ops import cuda_wpoint
from blitzar_tpu_torch.utils.limbs import to_jax_points

import torch_host_harness

JAX_CURVES = {"bls12_381_g1": jw.BLS12381_G1, "bn254_g1": jw.BN254_G1, "grumpkin": jw.GRUMPKIN}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _points(curve, count: int, seed: int):
    """count of the oracle's seeded points, every fifth one and the last the
    identity (a handle pads with identities)."""
    pts = curve.oracle.random_points(count, seed=seed)
    return curve.from_affine_ints([None if i % 5 == 3 or i == count - 1 else p for i, p in enumerate(pts)], "cpu")


def _host_table(harness, curve, pts, w: int) -> torch.Tensor:
    """The (G, 2^w, 3, K) table the harness builds."""
    a = np.ascontiguousarray(np.stack([c.numpy() for c in pts]).astype(np.int32))
    n = a.shape[-1]
    out = np.zeros((n // w, 1 << w, 3, curve.nlimbs // 2), np.int32)
    rc = harness.btt_host_w_build_table(ctypes.c_int(curve.kernel_id), ctypes.c_void_p(a.ctypes.data),
                                        ctypes.c_int64(n), ctypes.c_int(w), ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("w, groups", [(w, 3) for w in range(1, 9)] + [(10, 2), (12, 1)])
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_table_matches_plain(harness, curve, w, groups):
    pts = _points(curve, groups * w, 10 * w + groups + curve.kernel_id)
    got = _host_table(harness, curve, pts, w)
    want = cuda_wpoint.w_build_table_plain(curve, pts, w)
    assert torch.equal(got, want)
    # entry 0 is the identity (0, 1, 0) and entry 1 the first point plus it
    ident = cuda_wpoint.pack_points(curve.identity((1,)))[0]
    assert torch.equal(got[:, 0], ident.expand_as(got[:, 0]))
    first = cuda_wpoint.unpack_points(got[:, 1])
    assert bool(curve.points_equal(first, curve.index_batch(pts, slice(0, None, w))).all())


def test_w_table_matches_blitzar_tpu(harness):
    """bn254 G1, four groups at w = 3: the harness's table equals the plain
    one, and both blitzar_tpu's, its byte split decoded (low byte | high byte
    << 8 on each 16-bit Montgomery limb)."""
    curve, w, groups = wc.BN254_G1, 3, 4
    pts = _points(curve, groups * w, 77)
    plain = cuda_wpoint.w_build_table_plain(curve, pts, w)
    assert torch.equal(_host_table(harness, curve, pts, w), plain)
    jpts = jw.PointP2(*(jnp.asarray(c) for c in to_jax_points(pts)))
    nl = curve.nlimbs
    split = np.asarray(jfixed._build_split_table_xla(jpts, w, JAX_CURVES[curve.name], "cached"))
    split = split.reshape(groups, 2 * 3 * nl, 1 << w)
    full = split[:, : 3 * nl].astype(np.uint32) | (split[:, 3 * nl :].astype(np.uint32) << 8)  # (G, 3 nl, V)
    want = np.moveaxis(full.reshape(groups, 3, nl, 1 << w), 2, 0)  # (nl, G, 3, V)
    got = np.stack([c.numpy() for c in cuda_wpoint.unpack_points(plain)], axis=2)  # (nl, G, 3, V)
    assert np.array_equal(got.astype(np.uint32), want)


def test_harness_rejects_windows_the_kernel_rejects(harness):
    curve = wc.BN254_G1
    a = np.zeros((3, curve.nlimbs, 62), np.int32)
    out = np.zeros(1 << 12, np.int32)
    for w, n in ((0, 62), (31, 62), (4, 62)):
        assert harness.btt_host_w_build_table(ctypes.c_int(curve.kernel_id), ctypes.c_void_p(a.ctypes.data),
                                              ctypes.c_int64(n), ctypes.c_int(w),
                                              ctypes.c_void_p(out.ctypes.data)) == -1
    assert harness.btt_host_w_build_table(ctypes.c_int(0), ctypes.c_void_p(a.ctypes.data), ctypes.c_int64(62),
                                          ctypes.c_int(2), ctypes.c_void_p(out.ctypes.data)) == -1
