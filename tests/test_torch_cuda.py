"""blitzar_tpu_torch's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device. The file imports neither jax nor blitzar_tpu, so it also runs where
those are not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from blitzar_tpu_torch import api, generators
from blitzar_tpu_torch.curves import edwards25519 as ed
from blitzar_tpu_torch.curves import ristretto as rst
from blitzar_tpu_torch.fields import fp25519 as F
from blitzar_tpu_torch.msm import engine
from blitzar_tpu_torch.ops import cuda_point as cp
from blitzar_tpu_torch.utils.limbs import to_tensor

pytestmark = pytest.mark.cuda

RUST_EXPECTED_0 = "04693a833b45966a788920e1aff45273d8b4ce9615faf062fbc092f436a9c761"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a: ed.PointP3, b: ed.PointP3) -> bool:
    return all(torch.equal(F.canonicalize(x).cpu(), F.canonicalize(y).cpu()) for x, y in zip(a, b))


def _r(count: int, seed: int):
    r0, r1 = generators._xorshift_limbs(np.arange(seed, seed + count, dtype=np.uint64))
    return to_tensor(r0), to_tensor(r1)


def test_elligator_form_kernel(dev):
    r0, r1 = _r(300, 7)
    assert _same(cp.elligator_form(r0.to(dev), r1.to(dev)), cp.elligator_form_plain(r0, r1))


def test_ed_add_kernel_on_slices(dev):
    r0, r1 = _r(64, 1)
    pts = cp.elligator_form_plain(r0, r1)
    grid = ed.reshape_batch(pts, (8, 8))
    lo, hi = ed.index_batch(grid, slice(0, 4)), ed.index_batch(grid, slice(4, 8))
    got = cp.ed_add(ed.PointP3(*(c.to(dev) for c in lo)), ed.PointP3(*(c.to(dev) for c in hi)))
    assert _same(got, cp.ed_add_plain(lo, hi))


@pytest.mark.parametrize("signed", [False, True])
def test_table_lookup_combine_kernels(dev, signed):
    w, n = 4, 40
    r0, r1 = _r(n, 0)
    pts = cp.elligator_form_plain(r0, r1)
    table = cp.build_niels_table_plain(pts, w)
    got_table = cp.build_niels_table(ed.PointP3(*(c.to(dev) for c in pts)), w)
    assert torch.equal(got_table.cpu(), table)
    rng = np.random.default_rng(3)
    scalars = torch.from_numpy(rng.integers(0, 256, size=(3, n, 2), dtype=np.uint8))
    signs = torch.from_numpy(rng.integers(0, 2, size=(3, n), dtype=np.uint8)) if signed else None
    want = cp.ed_lookup_msm_plain(table, scalars, signs, w)
    got = cp.ed_lookup_msm(got_table, scalars.to(dev), None if signs is None else signs.to(dev), w)
    assert _same(got, want)
    products = ed.reshape_batch(ed.tree_reduce(want, want.x.shape[1]), (-1, 16))
    assert _same(cp.doubling_combine(ed.PointP3(*(c.to(dev) for c in products))), cp.doubling_combine_plain(products))


def test_wrappers_reject_bad_inputs(dev):
    table = torch.zeros((2, 16, 3, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cp.ed_lookup_msm(table, torch.zeros((1, 7, 1), dtype=torch.uint8, device=dev), None, 4)
    with pytest.raises(TypeError):
        p = ed.identity((3,), dev)
        cp.ed_add(p, ed.PointP3(*(c.to(torch.int64) for c in p)))


def test_api_on_cuda_matches_cpu(dev):
    api.reset_backend_for_testing()
    api.init("gpu")
    data = np.concatenate([np.frombuffer(int(v).to_bytes(4, "little"), np.uint8) for v in (2000, 7500, 5000, 1500)])
    got = api.compute_curve25519_commitments([api.SequenceDescriptor(4, 4, data)])
    assert bytes(got[0]).hex() == RUST_EXPECTED_0
    rows = np.random.default_rng(5).integers(0, 256, size=(50, 16), dtype=np.uint8)
    desc = api.SequenceDescriptor(16, 50, rows, True)
    got = api.compute_curve25519_commitments([desc, desc])
    cpu = engine.msm(generators.ristretto_generators(50, 0, "cpu"), [rows, rows], [16, 16], [True, True])
    assert np.array_equal(got, rst.encode(cpu).numpy().T)
    api.reset_backend_for_testing()


# ---------------------------------------------------------------------------
# the Weierstrass kernels (bls12-381 G1, bn254 G1, Grumpkin)
# ---------------------------------------------------------------------------

from blitzar_tpu_torch.curves import weierstrass as wc  # noqa: E402
from blitzar_tpu_torch.ops import cuda_wpoint as cw  # noqa: E402


def _on(p, device):
    return type(p)(*(c.to(device) for c in p))


def _w_same(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_wadd_wdouble_kernels_on_views(dev, curve):
    pts = curve.oracle.random_points(22, seed=11) + [None, None]
    grid = curve.reshape_batch(curve.from_affine_ints(pts, "cpu"), (4, 6))
    lo, hi = curve.index_batch(grid, slice(0, 2)), curve.index_batch(grid, slice(2, 4))
    glo, ghi = curve.index_batch(_on(grid, dev), slice(0, 2)), curve.index_batch(_on(grid, dev), slice(2, 4))
    assert _w_same(cw.wadd(curve, glo, ghi), cw.wadd_plain(curve, lo, hi))
    assert _w_same(cw.wadd(curve, glo, glo), cw.wadd_plain(curve, lo, lo))
    assert _w_same(cw.wdouble(curve, ghi), cw.wdouble_plain(curve, hi))


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
@pytest.mark.parametrize("signed", [False, True])
def test_w_table_and_lookup_kernels(dev, curve, signed):
    w, n = 4, 40
    pts = curve.from_affine_ints(curve.oracle.random_points(n - 3, seed=12) + [None] * 3, "cpu")
    table = cw.w_build_table_plain(curve, pts, w)
    got_table = cw.w_build_table(curve, _on(pts, dev), w)
    assert torch.equal(got_table.cpu(), table)
    rng = np.random.default_rng(13)
    scalars = torch.from_numpy(rng.integers(0, 256, size=(3, n, 2), dtype=np.uint8))
    signs = torch.from_numpy(rng.integers(0, 2, size=(3, n), dtype=np.uint8)) if signed else None
    want = cw.w_lookup_msm_plain(curve, table, scalars, signs, w)
    got = cw.w_lookup_msm(curve, got_table, scalars.to(dev), None if signs is None else signs.to(dev), w)
    assert _w_same(got, want)


def test_w_wrappers_reject_bad_inputs(dev):
    curve = wc.BN254_G1
    table = torch.zeros((2, 16, 3, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cw.w_lookup_msm(curve, table, torch.zeros((1, 7, 1), dtype=torch.uint8, device=dev), None, 4)
    with pytest.raises(ValueError):
        cw.w_lookup_msm(wc.BLS12381_G1, table, torch.zeros((1, 8, 1), dtype=torch.uint8, device=dev), None, 4)
    p = curve.identity((3,), dev)
    with pytest.raises(TypeError):
        cw.wadd(curve, p, wc.PointP2(*(c.to(torch.int64) for c in p)))


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_commitments_on_cuda_match_oracle(dev, curve):
    api.reset_backend_for_testing()
    api.init("gpu")
    n = 37
    orc = curve.oracle
    pts = orc.random_points(n, seed=14)
    rng = np.random.default_rng(15)
    raw = rng.integers(-(2**62), 2**62, size=(2, n), dtype=np.int64)
    descs = [api.SequenceDescriptor(8, n, raw[o].astype("<i8").view(np.uint8).reshape(n, 8), True) for o in range(2)]
    got = api.COMMITMENT_ENTRIES[curve](descs, curve.from_affine_ints(pts))
    want = [orc.msm([int(v) for v in raw[o]], pts) for o in range(2)]
    for o, pt in enumerate(want):
        if curve is wc.BLS12381_G1:
            from blitzar_tpu_torch.refimpl.weierstrass import compress_bls12_381

            assert bytes(got[o]) == compress_bls12_381(pt)
        else:
            assert pt is not None and not got["infinity"][o]
            assert bytes(got["x"][o]) == pt[0].to_bytes(32, "little") and bytes(got["y"][o]) == pt[1].to_bytes(32, "little")
    api.reset_backend_for_testing()
