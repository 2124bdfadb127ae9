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
    return generators._xorshift_limbs(torch.arange(seed, seed + count))


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


# ---------------------------------------------------------------------------
# the proof kernels (curve25519 scalar field, Grumpkin base field) and the
# proofs on the card
# ---------------------------------------------------------------------------

from blitzar_tpu_torch.ops import cuda_mont as cm  # noqa: E402
from blitzar_tpu_torch.proof import sumcheck as tsc  # noqa: E402
from blitzar_tpu_torch.proof.transcript import Transcript  # noqa: E402

PROOF_FIELDS = list(cm.FIELDS.values())


def _field_batch(field, shape, seed):
    rng = np.random.default_rng(seed)
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(count)]
    return field.from_ints(vals, "cpu").reshape((field.nlimbs,) + tuple(shape))


@pytest.mark.parametrize("field", PROOF_FIELDS, ids=lambda f: f.name)
def test_mont_mul_ew_kernel(dev, field):
    a, b = _field_batch(field, (1000,), 1), _field_batch(field, (1000,), 2)
    assert torch.equal(cm.mont_mul_ew(field, a.to(dev), b.to(dev)).cpu(), cm.mont_mul_ew_plain(field, a, b))
    s = b[:, 7:8]
    assert torch.equal(cm.mont_mul_ew(field, a.to(dev), s.to(dev)).cpu(), cm.mont_mul_ew_plain(field, a, s))
    # a strided view of a, and raw limbs below R reduced by to_mont
    view = _field_batch(field, (3, 64), 3)[:, 1]
    assert torch.equal(cm.mont_mul_ew(field, view.to(dev), b[:, :64].to(dev)).cpu(),
                       cm.mont_mul_ew_plain(field, view, b[:, :64]))
    raw = torch.from_numpy(np.random.default_rng(4).integers(0, 1 << 16, size=(16, 300)).astype(np.int32))
    assert torch.equal(cm.to_mont(field, raw.to(dev)).cpu(), cm.to_mont(field, raw))


@pytest.mark.parametrize("field", PROOF_FIELDS, ids=lambda f: f.name)
def test_mont_fold_and_sum_round_kernels(dev, field):
    m, mid = 3, 700
    mles = _field_batch(field, (m, 2 * mid), 5)
    r = _field_batch(field, (1,), 6)
    assert torch.equal(cm.mont_fold_round(field, mles.to(dev), r.to(dev)).cpu(), cm.mont_fold_round_plain(field, mles, r))
    for degree in range(1, 6):
        lengths = torch.tensor(list(range(1, degree + 1)), dtype=torch.int32)
        terms = torch.from_numpy(np.random.default_rng(degree).integers(0, m, size=int(lengths.sum())).astype(np.int32))
        mults = _field_batch(field, (degree,), 7 + degree)
        got = cm.mont_sum_round(field, mles.to(dev), mults.to(dev), lengths.to(dev), terms.to(dev), degree)
        assert torch.equal(got.cpu(), cm.mont_sum_round_plain(field, mles, mults, lengths, terms, degree)), degree


@pytest.mark.parametrize("field_id", sorted(cm.FIELDS))
def test_prove_sumcheck_on_cuda_matches_cpu(dev, field_id):
    n = 37
    rng = np.random.default_rng(8)
    rows = np.zeros((3, n, 32), np.uint8)
    rows[:, :, :8] = rng.integers(0, 2**62, size=(3, n), dtype=np.uint64).view(np.uint8).reshape(3, n, 8)
    table, terms = [(3, 5), (1, 2)], [0, 1, 2, 0, 1, 2, 2]
    codec = api.FIELD_CODECS[field_id]
    want = tsc.prove_sum(tsc.ReferenceSumcheckTranscript(Transcript(b"t"), codec), rows, table, terms, n, codec, "cpu")
    api.reset_backend_for_testing()
    api.init("gpu")
    assert api.prove_sumcheck(field_id, rows, table, terms, n, transcript=Transcript(b"t")) == want
    api.reset_backend_for_testing()


def test_inner_product_on_cuda_matches_cpu(dev):
    from blitzar_tpu_torch.proof import inner_product as tipa

    n = 7
    a, b = [3 * i + 1 for i in range(n)], [5 * i + 2 for i in range(n)]
    g, q = generators.ristretto_generators(8, 0, "cpu"), generators.ristretto_generators(1, 8, "cpu")
    want = tipa.prove_inner_product(Transcript(b"ipa-vec"), a, b, g, q)
    api.reset_backend_for_testing()
    api.init("gpu")
    got = api.prove_inner_product(Transcript(b"ipa-vec"), n, 0, a, b)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]) and got[2] == want[2]
    data = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in a])
    a_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, data)]))
    product = sum(x * y for x, y in zip(a, b)) % tipa.ORDER
    assert api.verify_inner_product(Transcript(b"ipa-vec"), n, 0, b, product, a_commit, *got)
    assert not api.verify_inner_product(Transcript(b"ipa-vec"), n, 0, b, product, a_commit, got[0], got[1], got[2] + 1)
    api.reset_backend_for_testing()


# ---------------------------------------------------------------------------
# the streamed path's kernels: the cached table build, the cached lookup and
# the lane tree reduce (all four curves)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("signed", [False, True])
def test_cached_table_and_lookup_kernels(dev, w, signed):
    """The cached table limb for limb; the cached lookup on a chunk's slice
    of a longer three-output upload (the row stride of a streamed query)."""
    n = 6 * w
    pts = cp.elligator_form_plain(*_r(n, 3))
    table = cp.build_cached_table_plain(pts, w)
    got_table = cp.build_cached_table(_on(pts, dev), w)
    assert torch.equal(got_table.cpu(), table)
    rng = np.random.default_rng(w)
    upload = torch.from_numpy(rng.integers(0, 256, size=(3, 3 * n, 2), dtype=np.uint8))
    signs = torch.from_numpy(rng.integers(0, 2, size=(3, 3 * n), dtype=np.uint8)) if signed else None
    chunk = slice(n, 2 * n)
    want = cp.ed_lookup_msm_plain(table, upload[:, chunk], None if signs is None else signs[:, chunk], w)
    before = cp.LAUNCHES["ed_lookup_msm_cached"]
    got = cp.ed_lookup_msm(got_table, upload.to(dev)[:, chunk], None if signs is None else signs.to(dev)[:, chunk], w)
    assert _same(got, want) and cp.LAUNCHES["ed_lookup_msm_cached"] == before + 1


@pytest.mark.parametrize("size", [1, 3, 300])
def test_tree_reduce_lanes_kernel(dev, size):
    pts = ed.reshape_batch(cp.elligator_form_plain(*_r(size * 5, 11)), (size, 5))
    got = cp.tree_reduce_lanes(_on(pts, dev))
    assert bool(ed.points_equal(_on(got, "cpu"), cp.tree_reduce_lanes_plain(pts)).all())


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
@pytest.mark.parametrize("size", [1, 300])
def test_w_tree_reduce_lanes_kernel(dev, curve, size):
    pts = curve.from_affine_ints(curve.oracle.random_points(size * 4 - 1, seed=size) + [None], "cpu")
    batch = curve.reshape_batch(pts, (size, 4))
    got = cw.w_tree_reduce_lanes(curve, _on(batch, dev))
    assert curve.to_affine_ints(_on(got, "cpu")) == curve.to_affine_ints(cw.w_tree_reduce_lanes_plain(curve, batch))


@pytest.mark.parametrize("curve", [ed] + list(wc.CURVES), ids=lambda c: getattr(c, "name", "ristretto255"))
def test_streaming_on_cuda_matches_cpu(dev, monkeypatch, curve):
    """A streamed MSM in 64-point chunks (the last one short), signed, on
    the card and on the CPU."""
    from blitzar_tpu_torch.msm import fixed

    monkeypatch.setattr(fixed, "STREAM_CHUNK_POINTS", 64)
    n = 150
    if curve is ed:
        pts = cp.elligator_form_plain(*_r(n, 5))
    else:
        pts = curve.from_affine_ints(curve.oracle.random_points(n, seed=9), "cpu")
    rng = np.random.default_rng(10)
    scalars = rng.integers(0, 256, size=(2, n, 4), dtype=np.uint8)
    signs = rng.integers(0, 2, size=(2, n), dtype=np.uint8)
    got = fixed.streaming_multiexponentiation(_on(pts, dev), scalars, curve, signs=signs)
    want = fixed.streaming_multiexponentiation(pts, scalars, curve, signs=signs)
    if curve is ed:
        assert np.array_equal(rst.encode(_on(got, "cpu")).numpy(), rst.encode(want).numpy())
    else:
        assert curve.to_affine_ints(_on(got, "cpu")) == curve.to_affine_ints(want)


def test_one_commitment_on_cuda_matches_cpu(dev):
    """2500 generators: two lane reduces on the card over rows of 1024
    padded with identities, against the plain halving tree on the CPU."""
    generators.CACHE.reset()
    before = cp.LAUNCHES["tree_reduce_lanes"]
    got = generators.one_commitment(2500, dev)
    assert cp.LAUNCHES["tree_reduce_lanes"] == before + 2
    want = generators.one_commitment(2500, "cpu")
    generators.CACHE.reset()
    assert bytes(rst.encode(_on(ed.PointP3(*(c[:, None] for c in got)), "cpu")).numpy()) == bytes(
        rst.encode(ed.PointP3(*(c[:, None] for c in want))).numpy())


# ---------------------------------------------------------------------------
# the field kernels (fmul, fsq, finvert) and the paths they carry: handle
# files, the generator disk cache; packed and vlen queries
# ---------------------------------------------------------------------------

from blitzar_tpu_torch.fields import params as tparams  # noqa: E402
from blitzar_tpu_torch.msm import fixed as tfixed  # noqa: E402
from blitzar_tpu_torch.msm import interop as tinterop  # noqa: E402
from blitzar_tpu_torch.ops import cuda_field as cf  # noqa: E402


def _fe(shape, seed: int) -> torch.Tensor:
    """Limbs below 2^17 (the plain invariant), values past 2^256 included."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 17, size=(16,) + tuple(shape)).astype(np.int32))


def _canon_equal(got, want) -> bool:
    return torch.equal(got.cpu(), F.canonicalize(want))


def test_field_kernels(dev):
    a, b = _fe((3, 700), 21), _fe((3, 700), 22)
    a[:, 0, :3] = 0  # 0 inverts to 0
    before = {k: cp.LAUNCHES[k] for k in ("fmul", "fsq", "finvert")}
    assert _canon_equal(cf.fmul(a.to(dev), b.to(dev)), cf.fmul_plain(a, b))
    assert _canon_equal(cf.fmul(a.to(dev), b[:, :1, :1].to(dev)), cf.fmul_plain(a, b[:, :1, :1]))  # broadcast
    assert _canon_equal(cf.fmul(a.to(dev)[:, 1], b.to(dev)[:, 2]), cf.fmul_plain(a[:, 1], b[:, 2]))  # views
    assert _canon_equal(cf.fsq(a.to(dev)), cf.fsq_plain(a))
    assert _canon_equal(cf.finvert(a.to(dev)), cf.finvert_plain(a))
    assert {k: cp.LAUNCHES[k] - before[k] for k in before} == {"fmul": 3, "fsq": 1, "finvert": 1}
    z = _fe((5, 256), 23)
    assert _canon_equal(cf.batch_invert_lanes(z.to(dev)), F.batch_invert_lanes(z))
    with pytest.raises(ValueError):
        cf.fmul(a.to(dev), b[:, :2].to(dev))


@pytest.mark.parametrize("field", [tparams.BN254_FP, tparams.BLS12381_FP], ids=lambda f: f.name)
def test_mont_mul_ew_base_fields(dev, field):
    a, b = _field_batch(field, (1000,), 24), _field_batch(field, (1000,), 25)
    assert torch.equal(cm.mont_mul_ew(field, a.to(dev), b.to(dev)).cpu(), cm.mont_mul_ew_plain(field, a, b))
    z = _field_batch(field, (4, 256), 26)
    z[:, 1, 7] = 0
    mul = lambda x, y: cm.mont_mul_ew(field, x, y)  # noqa: E731
    assert torch.equal(field.batch_invert_lanes(z.to(dev), mul).cpu(), field.batch_invert_lanes(z))


@pytest.mark.parametrize("curve", [ed] + list(wc.CURVES), ids=lambda c: getattr(c, "name", "ristretto255"))
def test_handle_files_on_cuda_match_cpu(dev, tmp_path, curve):
    """The raw file of a 40-point handle written on the card equals the one
    written on the CPU, byte for byte; read back on the card (raw and npz,
    and a w = 16 file re-windowed) the queries equal the CPU's."""
    n = 40
    pts = cp.elligator_form_plain(*_r(n, 12)) if curve is ed else curve.from_affine_ints(
        curve.oracle.random_points(n - 1, seed=12) + [None], "cpu")
    cpu = tfixed.MultiexpHandle(pts, curve=curve)
    card = tfixed.MultiexpHandle(_on(pts, dev), curve=curve)
    tinterop.write_reference_file(cpu, tmp_path / "cpu.raw")
    tinterop.write_reference_file(card, tmp_path / "card.raw")
    assert (tmp_path / "cpu.raw").read_bytes() == (tmp_path / "card.raw").read_bytes()
    card.write_to_file(str(tmp_path / "card.npz"))
    wide = tfixed.MultiexpHandle(_on(curve.index_batch(pts, slice(0, 32)), dev), window_width=16, curve=curve)
    tinterop.write_reference_file(wide, tmp_path / "w16.raw")
    scalars = np.random.default_rng(13).integers(0, 256, size=(2, n, 3), dtype=np.uint8)
    want = tfixed.fixed_multiexponentiation(cpu, scalars)
    for name in ("card.raw", "card.npz", "w16.raw"):
        got = tfixed.MultiexpHandle.new_from_file(str(tmp_path / name), curve, dev)
        assert got.device.type == "cuda" and got.window_width == 8
        sc = scalars[:, : got.n]
        ref = want if got.n == n else tfixed.fixed_multiexponentiation(cpu, sc)
        res = _on(tfixed.fixed_multiexponentiation(got, sc), "cpu")
        if curve is ed:
            assert np.array_equal(rst.encode(res).numpy(), rst.encode(ref).numpy()), name
        else:
            assert curve.to_affine_ints(res) == curve.to_affine_ints(ref), name


@pytest.mark.parametrize("curve", [ed, wc.BN254_G1], ids=lambda c: getattr(c, "name", "ristretto255"))
def test_packed_and_vlen_on_cuda_match_cpu(dev, curve):
    n = 40
    pts = cp.elligator_form_plain(*_r(n, 14)) if curve is ed else curve.from_affine_ints(
        curve.oracle.random_points(n, seed=14), "cpu")
    cpu = tfixed.MultiexpHandle(pts, curve=curve)
    card = tfixed.MultiexpHandle(_on(pts, dev), curve=curve)
    bits, lengths = [1, 8, 13, 64], [0, 17, 17, n]
    packed = np.random.default_rng(15).integers(0, 256, size=(n, 11), dtype=np.uint8)
    for run in (lambda h: tfixed.fixed_packed_multiexponentiation(h, bits, n, packed),
                lambda h: tfixed.fixed_vlen_multiexponentiation(h, bits, lengths, packed)):
        got, want = _on(run(card), "cpu"), run(cpu)
        if curve is ed:
            assert np.array_equal(rst.encode(got).numpy(), rst.encode(want).numpy())
        else:
            assert curve.to_affine_ints(got) == curve.to_affine_ints(want)


def test_generator_cache_on_cuda(dev, tmp_path, monkeypatch):
    """Saved from the card (finvert, fmul), loaded on the card (fmul): the
    same points as the CPU derivation."""
    monkeypatch.setattr(generators, "DISK_CHUNK", 64)
    monkeypatch.setattr(generators, "DISK_DIR", str(tmp_path))
    want = generators.ristretto_generators(128, 0, "cpu")
    before = {k: cp.LAUNCHES[k] for k in ("fmul", "fsq", "finvert", "elligator_form")}
    made = generators.ristretto_generators(128, 0, dev)  # loads the CPU's save
    loaded = generators.ristretto_generators(100, 0, dev)
    assert cp.LAUNCHES["elligator_form"] == before["elligator_form"]
    assert cp.LAUNCHES["fmul"] > before["fmul"]
    assert bool(ed.points_equal(_on(made, "cpu"), want).all())
    assert bool(ed.points_equal(_on(loaded, "cpu"), ed.index_batch(want, slice(0, 100))).all())
    monkeypatch.setattr(generators, "DISK_DIR", str(tmp_path / "card"))
    generators.ristretto_generators(64, 0, dev)  # derived and saved on the card
    assert cp.LAUNCHES["finvert"] > before["finvert"]
    monkeypatch.setattr(generators, "DISK_DIR", str(tmp_path / "card"))
    assert bool(ed.points_equal(generators.ristretto_generators(64, 0, "cpu"), ed.index_batch(want, slice(0, 64))).all())


# ---------------------------------------------------------------------------
# ed_double, niels_add, niels_tree_reduce_lanes; the bucket engine and the
# few-row partition query on the card
# ---------------------------------------------------------------------------


def test_ed_double_kernel(dev):
    """Any batch: one point (a Horner step of one output), and 300 with the
    identity among them, on a strided view."""
    r0, r1 = _r(300, 11)
    pts = cp.elligator_form_plain(r0, r1)
    pts = ed.cat([ed.identity((1,)), ed.index_batch(pts, slice(1, None))])
    for batch in (ed.index_batch(pts, slice(0, 1)), ed.reshape_batch(pts, (20, 15))):
        card = ed.PointP3(*(c.to(dev) for c in batch))
        assert _same(cp.ed_double(card), cp.ed_double_plain(batch))
    view = ed.index_batch(ed.reshape_batch(ed.PointP3(*(c.to(dev) for c in pts)), (20, 15)), (slice(None), 3))
    assert _same(cp.ed_double(view), cp.ed_double_plain(ed.index_batch(ed.reshape_batch(pts, (20, 15)), (slice(None), 3))))
    assert cp.LAUNCHES["ed_double"] > 0


def _niels_entries(count: int, seed: int) -> torch.Tensor:
    r0, r1 = _r(count, seed)
    pts = cp.elligator_form_plain(r0, r1)
    pts = ed.cat([ed.identity((1,)), ed.index_batch(pts, slice(1, None))])
    return cp.pack_niels(ed.to_niels(pts))  # (count, 3, 8)


def test_niels_add_kernel(dev):
    a, b = _niels_entries(257, 2), _niels_entries(257, 3)
    b[:5] = a[:5]  # doublings
    n1, n2 = cp.unpack_niels(a), cp.unpack_niels(b)
    got = cp.niels_add(ed.Niels(*(c.to(dev) for c in n1)), ed.Niels(*(c.to(dev) for c in n2)))
    assert _same(got, cp.niels_add_plain(n1, n2))


@pytest.mark.parametrize("size", [256, 1024, 2048])
def test_niels_tree_reduce_lanes_kernel(dev, size):
    """Limb for limb: the kernel adds in the plain version's order."""
    cols = 3
    entries = _niels_entries(size * cols, 5).reshape(size, cols, 3, 8)
    got = cp.niels_tree_reduce_lanes(entries.to(dev))
    assert _same(got, cp.niels_tree_reduce_lanes_plain(entries))
    with pytest.raises(ValueError):
        cp.niels_tree_reduce_lanes(entries[:200].to(dev))


def test_bucket_engine_on_cuda_matches_cpu(dev, monkeypatch):
    """The bucket engine through the API on the card (signed and unsigned,
    mixed widths, one skewed column) equals the default engine on the CPU."""
    n = 300
    rng = np.random.default_rng(12)
    data = [rng.integers(0, 256, size=(n, 8), dtype=np.uint8), rng.integers(0, 256, size=(200, 2), dtype=np.uint8),
            np.full((n, 1), 9, np.uint8)]
    args = (data, [8, 2, 1], [True, False, False])
    want = rst.encode(engine.msm(generators.ristretto_generators(n, 0, "cpu"), *args)).numpy()
    monkeypatch.setenv(engine.ENGINE_VAR, "bucket")
    before = cp.LAUNCHES["ed_double"]
    got = engine.msm(generators.ristretto_generators(n, 0, dev), *args)
    assert np.array_equal(rst.encode(got).cpu().numpy(), want)
    assert cp.LAUNCHES["ed_double"] - before == 7 * 8


@pytest.mark.parametrize("n, w", [(1000, 8), (1024, 8), (2048, 8), (1024, 4)])
def test_fewrow_query_on_cuda_matches_lookup(dev, n, w):
    """The few-row query on the card equals ed_lookup_msm's products on
    the same handle: an odd chunk of 125 groups (n = 1000), niels_add on
    the halves of a 128-group chunk (1024), niels_tree_reduce_lanes on
    256-group chunks (2048, and w = 4 at 1024)."""
    from blitzar_tpu_torch.msm import fixed

    handle = fixed.MultiexpHandle(generators.ristretto_generators(n, 0, dev), window_width=w)
    scalars = torch.from_numpy(np.random.default_rng(n).integers(0, 256, size=(1, n, 2), dtype=np.uint8)).to(dev)
    scalars = torch.nn.functional.pad(scalars, (0, 0, 0, handle.num_groups * w - n))
    got = fixed.fewrow_products(handle.table, scalars, None, w)
    want = fixed.sum_leading(cp.ed_lookup_msm(handle.table, scalars, None, w))
    assert bool(ed.points_equal(got, want).all())
