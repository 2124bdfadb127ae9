"""The lookups' per-thread schedule (csrc/lookup.cuh: the indices formed
from the raw scalar bytes, the entries they pick read and added in
increasing group order), compiled for the host with g++ through
csrc/host_harness.cpp, which runs every (chunk, row) thread of a launch one
after another. Its partials are held limb for limb against the plain
versions that follow the kernels' chunks (``lookup_chunks``):
``ed_lookup_msm_plain``, which tests/test_torch_fixed.py holds against
blitzar_tpu, on both Edwards entry forms, and ``w_lookup_msm_plain`` on the
Weierstrass form of all three curves; w = 4 and 8, signed and unsigned
queries, a chunk's slice of a longer three-output upload, and a chunk rule
that leaves the last chunk short."""

import ctypes

import numpy as np
import pytest
import torch

from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import to_tensor

import torch_host_harness


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many tiny ops, where torch's intra-op threads
    only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _points(count: int, seed: int) -> ted.PointP3:
    """count points (the plain elligator form of seeded field elements),
    every fifth one the identity (a handle pads with identities)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1 << 16, size=(2, 16, count)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    pts = cuda_point.elligator_form_plain(to_tensor(r[0], "cpu"), to_tensor(r[1], "cpu"))
    keep = torch.tensor([i % 5 != 3 for i in range(count)])
    return ted.PointP3(*(torch.where(keep, c, ic) for c, ic in zip(pts, ted.identity((count,)))))


def _ptr(a: np.ndarray, offset: int = 0) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data + offset)


def _host_lookup(harness, table, upload, signs, lo: int, n: int, w: int):
    """The harness's partials of the query of columns [lo, lo + n) of the
    (O, N, nbytes) upload (signs (O, N) or None), read in place with the
    upload's row stride, as the kernel reads a streamed chunk's slice."""
    num_outputs, length, nbytes = upload.shape
    rows = (1 if signs is None else 2) * num_outputs * 8 * nbytes
    chunk_groups, nchunks = cuda_point.lookup_chunks(n // w, rows)
    out = np.zeros((4, 16, nchunks * rows), np.int32)
    t = np.ascontiguousarray(table.numpy())
    harness.btt_host_lookup(
        _ptr(t), _ptr(upload, lo * nbytes), None if signs is None else _ptr(signs, lo), ctypes.c_int64(num_outputs),
        ctypes.c_int64(n), ctypes.c_int64(length), ctypes.c_int(nbytes), ctypes.c_int(w),
        ctypes.c_int(table.shape[2] == 4), ctypes.c_int64(chunk_groups), ctypes.c_int64(nchunks), _ptr(out))
    return out.reshape(4, 16, nchunks, rows)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("form", ["niels", "cached"])
@pytest.mark.parametrize("short", [False, True], ids=["card_rule", "short_last_chunk"])
def test_lookup_body_matches_plain(harness, monkeypatch, form, w, signed, short):
    """11 groups, the middle third of a three-output 2-byte upload: under
    the card's chunk rule every chunk is one group; with LOOKUP_THREADS cut
    to four chunks' worth of rows, chunks of 3, 3, 3 and 2 groups. The
    partials equal the plain version's limb for limb."""
    groups = 11
    n = groups * w
    rows = (2 if signed else 1) * 3 * 16
    if short:
        monkeypatch.setattr(cuda_point, "LOOKUP_THREADS", 4 * rows)
    pts = _points(n, 7 * w + (form == "cached"))
    build = cuda_point.build_cached_table_plain if form == "cached" else cuda_point.build_niels_table_plain
    table = build(pts, w)
    rng = np.random.default_rng(w + 2 * signed)
    upload = rng.integers(0, 256, size=(3, 3 * n, 2), dtype=np.uint8)
    upload[1, n : n + 5] = 0  # zero indices at the start of the query
    signs = rng.integers(0, 2, size=(3, 3 * n), dtype=np.uint8) if signed else None
    got = _host_lookup(harness, table, upload, signs, n, n, w)
    sc = torch.from_numpy(upload)[:, n : 2 * n]
    sg = None if signs is None else torch.from_numpy(signs)[:, n : 2 * n]
    want = cuda_point.ed_lookup_msm_plain(table, sc, sg, w)
    assert want.x.shape[1:] == (4 if short else 11, rows)
    assert np.array_equal(got, np.stack([TF.canonicalize(c).numpy() for c in want]))


def test_lookup_body_one_output_full_width_rows(harness):
    """One 32-byte output (256 rows) over 24 niels groups at w = 8: every
    row's chunks."""
    w, groups = 8, 24
    pts = _points(groups * w, 5)
    table = cuda_point.build_niels_table_plain(pts, w)
    upload = np.random.default_rng(9).integers(0, 256, size=(1, groups * w, 32), dtype=np.uint8)
    got = _host_lookup(harness, table, upload, None, 0, groups * w, w)
    want = cuda_point.ed_lookup_msm_plain(table, torch.from_numpy(upload), None, w)
    assert np.array_equal(got, np.stack([TF.canonicalize(c).numpy() for c in want]))


def _w_points(curve, count: int, seed: int):
    """count of the oracle's seeded points, every fifth one the identity."""
    pts = curve.oracle.random_points(count, seed=seed)
    return curve.from_affine_ints([None if i % 5 == 3 else p for i, p in enumerate(pts)], "cpu")


def _host_w_lookup(harness, curve, table, upload, signs, lo: int, n: int, w: int):
    """The harness's w_lookup_msm partials of columns [lo, lo + n) of the
    upload, read in place as _host_lookup reads them."""
    num_outputs, length, nbytes = upload.shape
    rows = (1 if signs is None else 2) * num_outputs * 8 * nbytes
    chunk_groups, nchunks = cuda_point.lookup_chunks(n // w, rows)
    out = np.zeros((3, curve.nlimbs, nchunks * rows), np.int32)
    t = np.ascontiguousarray(table.numpy())
    rc = harness.btt_host_w_lookup(
        ctypes.c_int(curve.kernel_id), _ptr(t), _ptr(upload, lo * nbytes), None if signs is None else _ptr(signs, lo),
        ctypes.c_int64(num_outputs), ctypes.c_int64(n), ctypes.c_int64(length), ctypes.c_int(nbytes), ctypes.c_int(w),
        ctypes.c_int64(chunk_groups), ctypes.c_int64(nchunks), _ptr(out))
    assert rc == 0
    return out.reshape(3, curve.nlimbs, nchunks, rows)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
@pytest.mark.parametrize("short", [False, True], ids=["card_rule", "short_last_chunk"])
def test_w_lookup_body_matches_plain(harness, monkeypatch, curve, w, signed, short):
    """The Weierstrass entry form (WForm, w_lookup_msm.cu) on the cases of
    test_lookup_body_matches_plain: 11 groups, the middle third of a
    three-output 2-byte upload, one group a chunk under the card's rule or
    chunks of 3, 3, 3 and 2 groups. The partials equal
    w_lookup_msm_plain's limb for limb."""
    groups = 11
    n = groups * w
    rows = (2 if signed else 1) * 3 * 16
    if short:
        monkeypatch.setattr(cuda_point, "LOOKUP_THREADS", 4 * rows)
    table = cuda_wpoint.w_build_table_plain(curve, _w_points(curve, n, 7 * w + curve.kernel_id), w)
    rng = np.random.default_rng(w + 2 * signed + 4 * curve.kernel_id)
    upload = rng.integers(0, 256, size=(3, 3 * n, 2), dtype=np.uint8)
    upload[1, n : n + 5] = 0  # zero indices at the start of the query
    signs = rng.integers(0, 2, size=(3, 3 * n), dtype=np.uint8) if signed else None
    got = _host_w_lookup(harness, curve, table, upload, signs, n, n, w)
    sc = torch.from_numpy(upload)[:, n : 2 * n]
    sg = None if signs is None else torch.from_numpy(signs)[:, n : 2 * n]
    want = cuda_wpoint.w_lookup_msm_plain(curve, table, sc, sg, w)
    assert want.x.shape[1:] == (4 if short else 11, rows)
    assert np.array_equal(got, np.stack([c.numpy() for c in want]))
