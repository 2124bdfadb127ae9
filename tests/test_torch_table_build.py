"""The two table builds' own arithmetic (csrc/table_build.cuh: the
subset-sum schedule of a run's lanes and the niels form's batch-inversion
chain), compiled for the host with g++ through csrc/host_harness.cpp, which
builds whole tables with it one lane after another. Those tables are held
limb for limb against the plain versions (``build_cached_table_plain``,
``build_niels_table_plain``) and these against blitzar_tpu's table build as
it runs on the CPU (``_build_split_table_xla``, where its
``msm/fixed.py:_build_split_table`` routes there; the Pallas
``build_split_table`` in interpret mode is too slow on the CPU), decoded
from the byte split."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import to_jax_points, to_tensor

import torch_host_harness


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _points(count: int, seed: int) -> ted.PointP3:
    """count points (the plain elligator form of seeded field elements,
    doubled so z != 1), every fifth one and the last the identity (a handle
    pads with identities)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1 << 16, size=(2, 16, count)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    pts = ted._double_impl(cuda_point.elligator_form_plain(to_tensor(r[0], "cpu"), to_tensor(r[1], "cpu")))
    keep = torch.tensor([i % 5 != 3 and i != count - 1 for i in range(count)])
    return ted.PointP3(*(torch.where(keep, c, ic) for c, ic in zip(pts, ted.identity((count,)))))


def _host_table(fn, pts: ted.PointP3, w: int, coords: int) -> torch.Tensor:
    """A (G, 2^w, coords, 8) table built by the harness."""
    a = np.ascontiguousarray(np.stack([c.numpy() for c in pts]).astype(np.int32))
    n = a.shape[-1]
    out = np.zeros((n // w, 1 << w, coords, 8), np.int32)
    rc = fn(ctypes.c_void_p(a.ctypes.data), ctypes.c_int64(n), ctypes.c_int(w), ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return torch.from_numpy(out)


@pytest.mark.parametrize("groups", [1, 7, 33])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_cached_table_matches_plain(harness, w, groups):
    pts = _points(groups * w, 10 * w + groups)
    got = _host_table(harness.btt_host_build_cached_table, pts, w, 4)
    assert torch.equal(got, cuda_point.build_cached_table_plain(pts, w))


@pytest.mark.parametrize("w, groups", [(w, g) for w in (1, 3, 8) for g in (1, 7, 33)] + [(16, 2)])
def test_niels_table_matches_plain(harness, w, groups):
    """w = 16: 256 runs of 256 entries a group, each from its own start."""
    pts = _points(groups * w, 20 * w + groups)
    got = _host_table(harness.btt_host_build_niels_table, pts, w, 3)
    assert torch.equal(got, cuda_point.build_niels_table_plain(pts, w))


def test_harness_rejects_windows_the_kernels_reject(harness):
    pts = _points(18, 1)
    a = np.ascontiguousarray(np.stack([c.numpy() for c in pts]).astype(np.int32))
    out = np.zeros(1 << 12, np.int32)
    args = (ctypes.c_void_p(a.ctypes.data), ctypes.c_int64(18))
    assert harness.btt_host_build_cached_table(*args, ctypes.c_int(9), ctypes.c_void_p(out.ctypes.data)) == -1
    assert harness.btt_host_build_niels_table(*args, ctypes.c_int(17), ctypes.c_void_p(out.ctypes.data)) == -1


@pytest.mark.parametrize("form, w", [("cached", 8), ("niels", 3)])
def test_plain_tables_match_blitzar_tpu(harness, form, w):
    """Eight groups: the harness's table equals the plain one, and both
    blitzar_tpu's, its byte split decoded (low byte | high byte << 8) and
    its values made canonical."""
    groups, coords = 8, (4 if form == "cached" else 3)
    pts = _points(groups * w, 30 * w)
    plain = (cuda_point.build_cached_table_plain if form == "cached" else cuda_point.build_niels_table_plain)(pts, w)
    fn = harness.btt_host_build_cached_table if form == "cached" else harness.btt_host_build_niels_table
    assert torch.equal(_host_table(fn, pts, w, coords), plain)
    jpts = jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(pts)))
    split = np.asarray(jfixed._build_split_table_xla(jpts, w, jed, form)).reshape(groups, 2 * 16 * coords, 1 << w)
    full = split[:, : 16 * coords].astype(np.uint32) | (split[:, 16 * coords :].astype(np.uint32) << 8)
    want = np.stack([np.asarray(JF.canonicalize(jnp.asarray(np.moveaxis(full[:, 16 * k : 16 * (k + 1)], 1, 0))))
                     for k in range(coords)])  # (coords, 16, G, V)
    unpack = cuda_point.unpack_cached if form == "cached" else cuda_point.unpack_niels
    got = np.stack([c.numpy() for c in unpack(plain)]).astype(np.uint32)
    assert np.array_equal(got, want.astype(np.uint32))
