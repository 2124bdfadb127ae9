"""csrc/ed_convert.cuh's conversions back to extended points
(``ed_niels_points``: a handle's niels words to the npz write's point table;
``ed_affine``: extended points to the generator disk cache's canonical
affine form), run by csrc/host_harness.cpp, against their plain versions
limb for limb and against blitzar_tpu: its handle's ``_point_table`` (the
npz write's conversion) and the disk cache's ``_to_affine_xy_chunk``. The
table holds identity entries (entry 0 of every group); ``ed_affine`` runs in
tiles of 32 x per entries, the last one short. A small npz write -> read
round trip gives blitzar_tpu's table."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points, to_tensor

import torch_host_harness

N, W = 24, 4  # 6 groups of 16 entries
COUNT = 100  # ed_affine's entries: tiles of 32 x 3 leave a short one


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


@pytest.fixture(scope="module")
def handles():
    """blitzar_tpu's handle over its own table build and the port's, over
    the same canonical generators (equal tables, tests/test_torch_fixed.py)."""
    jg = jgen.ristretto_generators(N)
    tg = from_jax_points(np.stack([np.asarray(c) for c in jg]), device="cpu")
    return jfixed.MultiexpHandle(jg, window_width=W), tfixed.MultiexpHandle(tg, window_width=W)


@pytest.fixture(scope="module")
def points() -> ted.PointP3:
    """COUNT seeded elligator points scaled by random factors (z far from 1)."""
    rng = np.random.default_rng(81)
    r = rng.integers(0, 1 << 16, size=(2, 16, COUNT)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    pts = cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1]))
    k = to_tensor(rng.integers(1, 1 << 16, size=(16, COUNT)))
    return ted.PointP3(*(TF.mul(c, k) for c in pts))


def _stack(p) -> np.ndarray:
    return np.stack([TF.canonicalize(c).numpy() for c in p])


def _host_niels_points(harness, words) -> np.ndarray:
    words = words.reshape(-1, 3, 8).contiguous()
    count = words.shape[0]
    out = np.zeros((4, 16, count), np.int32)
    harness.btt_host_ed_niels_points(ctypes.c_void_p(words.data_ptr()), ctypes.c_int64(count),
                                     ctypes.c_void_p(out.ctypes.data))
    return out


def _host_affine(harness, pts, per: int) -> np.ndarray:
    count = pts.x.shape[1]
    xyz = np.ascontiguousarray(np.stack([c.numpy() for c in pts[:3]]))
    out = np.zeros((4, 16, count), np.int32)
    rc = harness.btt_host_ed_affine(ctypes.c_void_p(xyz.ctypes.data), ctypes.c_int64(count), ctypes.c_int(per),
                                    ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return out


def test_niels_points_body_matches_jax_and_plain(harness, handles):
    """blitzar_tpu's point table of its handle (``_point_table``: niels_to_p3
    of its split words), the plain version, the wrapper, the npz write's
    table and the harness's body: the same canonical limbs, identity
    entries included. The kernel's t is x*y, the plain version's 2d*t /
    (2d): equal on a table's entries."""
    jh, th = handles
    want = np.stack([np.asarray(JF.canonicalize(c)) for c in jh._point_table()]).astype(np.int64)
    plain = cuda_point.ed_niels_points_plain(th.table)
    assert np.array_equal(_stack(plain), want)
    assert np.array_equal(_stack(cuda_point.ed_niels_points(th.table)), want)  # the wrapper on a CPU tensor
    assert np.array_equal(_stack(tfixed.niels_point_table(th.table)), want)
    host = _host_niels_points(harness, th.table)
    assert np.array_equal(host, _stack(plain).reshape(4, 16, -1))
    assert np.array_equal(host[:, :, 0], _stack(ted.identity((1,)))[:, :, 0])  # entry 0: (0, 1, 1, 0)


def test_niels_points_in_place(handles):
    """``out``: a chunk's points written into its slice of a larger table's
    coordinates, the rest left as it was."""
    _, th = handles
    groups, entries = th.table.shape[:2]
    out = ted.PointP3(*(torch.full((16, groups + 2, entries), -7, dtype=torch.int32) for _ in range(4)))
    got = cuda_point.ed_niels_points(th.table[1:4], out=ted.index_batch(out, slice(2, 5)))
    want = cuda_point.ed_niels_points_plain(th.table[1:4])
    assert all(torch.equal(c[:, 2:5], w) for c, w in zip(out, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(bool((torch.cat([c[:, :2], c[:, 5:]], dim=1) == -7).all()) for c in out)
    with pytest.raises(ValueError, match="expected"):
        cuda_point.ed_niels_points(torch.zeros((4, 4, 8), dtype=torch.int32))


def test_npz_write_and_read_give_jax_table(handles, tmp_path):
    """The port's npz (its point table by ``ed_niels_points``) holds
    blitzar_tpu's point table limb for limb; the port reads it back to its
    own table, and blitzar_tpu to a split table whose point table is its
    own (its split limbs need not be canonical)."""
    jh, th = handles
    th.write_to_file(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as data:
        coords = np.stack([data[f"coord{i}"] for i in range(4)])
    want = np.stack([np.asarray(JF.canonicalize(c)) for c in jh._point_table()])
    assert coords.dtype == np.uint32 and np.array_equal(coords, want)
    back = tfixed.MultiexpHandle.new_from_file(str(tmp_path / "port.npz"), ted, "cpu")
    assert (back.window_width, back.n) == (W, N) and torch.equal(back.table, th.table)
    jback = jfixed.MultiexpHandle.new_from_file(str(tmp_path / "port.npz"))
    jback.table = None  # the point table again, from the split table it read
    assert np.array_equal(np.stack([np.asarray(JF.canonicalize(c)) for c in jback._point_table()]), want)


def test_affine_body_matches_jax_and_plain(harness, points):
    """blitzar_tpu's disk-cache conversion (``_to_affine_xy_chunk``: z
    inverted, x/z and y/z as uint16 limbs, canonicalized), the plain version and the
    harness's tiles at per = 1, 3 (a short last tile), 8 and 16 (the
    kernel's up to 2^18 and 2^19 entries: one short tile): the same
    canonical limbs; z = 1, t = x*y."""
    plain = cuda_point.ed_affine_plain(points)
    jx, jy = jax.jit(jgen._to_affine_xy_chunk)(*(jnp.asarray(to_jax_points(points)[k]) for k in range(3)))
    assert torch.equal(plain.x, TF.canonicalize(to_tensor(np.asarray(jx))))  # blitzar_tpu's limbs: any value < 2^256
    assert torch.equal(plain.y, TF.canonicalize(to_tensor(np.asarray(jy))))
    assert torch.equal(plain.z, TF.from_int(1, (COUNT,)))
    assert torch.equal(plain.t, TF.canonicalize(TF.mul(plain.x, plain.y)))
    assert bool(ted.points_equal(plain, points).all())
    assert np.array_equal(_stack(cuda_point.ed_affine(points)), _stack(plain))  # the wrapper on a CPU tensor
    for per in (1, 3, 8, 16):
        assert np.array_equal(_host_affine(harness, points, per), _stack(plain)), f"per = {per}"


P_LIMBS = [0xFFED] + [0xFFFF] * 14 + [0x7FFF]  # p = 2^255 - 19
TWO_P_LIMBS = [0xFFDA] + [0xFFFF] * 15  # 2p = 2^256 - 38


def test_affine_body_ignores_t_and_takes_wide_limbs(harness, points):
    """t is not read; x + p, y + p and z + 2p, limbs up to 2^17 (the plain
    invariant), give the same words, in the harness and the plain version."""
    want = _host_affine(harness, points, 2)
    p, two_p = (torch.tensor(v, dtype=torch.int32)[:, None] for v in (P_LIMBS, TWO_P_LIMBS))
    canon = [TF.canonicalize(c) for c in points[:3]]
    wide = ted.PointP3(canon[0] + p, canon[1] + p, canon[2] + two_p, torch.zeros_like(points.t))
    assert int(max(c.max() for c in wide)) >= 1 << 16
    assert np.array_equal(_host_affine(harness, wide, 2), want)
    assert np.array_equal(_stack(cuda_point.ed_affine_plain(wide)), want)
