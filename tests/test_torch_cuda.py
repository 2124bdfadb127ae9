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


# even canonical s whose decode fails for one reason each: no square root,
# a negative t (the first of each from s = 2 up, by
# tests/test_torch_ristretto_codec.py's search), and p - 1 (y = 0)
CODEC_NOT_SQUARE, CODEC_NEGATIVE_T = 8, 2
CODEC_Y_ZERO = F.P - 1


def codec_invalid() -> torch.Tensor:
    """(32, 7) uint8: s = p + 1 (not canonical), 1 (odd), a valid encoding
    with bit 255 set, no square root, a negative t, y = 0, all ones."""
    cols = [F.P + 1, 1, CODEC_NOT_SQUARE, CODEC_NEGATIVE_T, CODEC_Y_ZERO]
    data = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in cols], axis=1)
    top = np.frombuffer(bytes.fromhex(RUST_EXPECTED_0), np.uint8).copy()
    top[31] |= 0x80
    return torch.from_numpy(np.concatenate([data, top[:, None], np.full((32, 1), 0xFF, np.uint8)], axis=1))


@pytest.mark.parametrize("n", [1, 2, 40, 300])
def test_ristretto_codec_kernels(dev, n):
    """ristretto_encode on sums of generators (z far from 1; the identity
    first) equals the plain encode byte for byte; ristretto_decode of those
    bytes with invalid ones among them gives the plain version's valid
    flags and its canonical points in the valid slots."""
    pts = cp.ed_add_plain(*(ed.index_batch(cp.elligator_form_plain(*_r(2 * n, 21)), s)
                            for s in (slice(0, n), slice(n, 2 * n))))
    pts = ed.cat([ed.identity((1,)), ed.index_batch(pts, slice(1, n))])
    enc = cp.ristretto_encode(ed.PointP3(*(c.to(dev) for c in pts)))
    want = cp.ristretto_encode_plain(pts)
    assert enc.dtype == torch.uint8 and torch.equal(enc.cpu(), want)
    assert not bool(want[:, 0].any())
    data = torch.cat([want, codec_invalid()], dim=1)
    got, valid = cp.ristretto_decode(data.to(dev))
    plain, plain_valid = cp.ristretto_decode_plain(data)
    assert valid.tolist() == plain_valid.tolist() == [True] * n + [False] * 7
    assert all(torch.equal(g.cpu()[:, :n], F.canonicalize(p)[:, :n]) for g, p in zip(got, plain))
    assert torch.equal(cp.ristretto_encode(ed.index_batch(got, slice(0, n))).cpu(), want)


def test_compress_and_decompress_launch_the_codec(dev):
    api.init("gpu")
    before = {k: cp.LAUNCHES[k] for k in ("ristretto_encode", "ristretto_decode")}
    enc = api.compress_ristretto255(api.get_ristretto255_generators(6))
    pts, valid = api.decompress_ristretto255(enc)
    assert valid.all() and np.array_equal(api.compress_ristretto255(pts), enc)
    assert cp.LAUNCHES["ristretto_encode"] - before["ristretto_encode"] == 2
    assert cp.LAUNCHES["ristretto_decode"] - before["ristretto_decode"] == 1


def test_ed_add_kernel_on_slices(dev):
    r0, r1 = _r(64, 1)
    pts = cp.elligator_form_plain(r0, r1)
    grid = ed.reshape_batch(pts, (8, 8))
    lo, hi = ed.index_batch(grid, slice(0, 4)), ed.index_batch(grid, slice(4, 8))
    got = cp.ed_add(ed.PointP3(*(c.to(dev) for c in lo)), ed.PointP3(*(c.to(dev) for c in hi)))
    assert _same(got, cp.ed_add_plain(lo, hi))


@pytest.mark.parametrize("negate_q", [False, True])
@pytest.mark.parametrize("shape", [(1,), (7,), (33,), (32, 255), (3, 17)])
def test_ed_add_quad_kernel(dev, negate_q, shape):
    """Four lanes a pair: batches off a warp's eight pairs, a window-sum
    shape and a two-axis batch, the identity, P + P and P - P among them,
    q read negated."""
    count = int(np.prod(shape))
    pts = cp.elligator_form_plain(*_r(2 * count, 3))
    p, q = (ed.reshape_batch(ed.index_batch(pts, s), shape) for s in (slice(0, count), slice(count, 2 * count)))
    flat = [ed.reshape_batch(x, (count,)) for x in (p, q)]
    q = ed.reshape_batch(ed.select(flat[1], flat[0], torch.arange(count) % 3 == 1), shape)
    p = ed.reshape_batch(ed.select(flat[0], ed.identity((count,)), torch.arange(count) % 5 == 2), shape)
    got = cp.ed_add(ed.PointP3(*(c.to(dev) for c in p)), ed.PointP3(*(c.to(dev) for c in q)), negate_q=negate_q)
    assert _same(got, cp.ed_add_plain(p, q, negate_q))


def test_signed_commitment_is_one_ed_add_and_no_neg(dev, monkeypatch):
    """A signed ristretto255 commitment's Q_pos - Q_neg is one ed_add launch
    that reads Q_neg negated: no plain neg runs."""
    negs = []
    plain_neg = ed.neg
    monkeypatch.setattr(ed, "neg", lambda p: negs.append(1) or plain_neg(p))
    vals = [-128, 127, -1, 0, 1, 5]
    data = np.array([v % 256 for v in vals], np.uint8)
    got = {}
    for backend in ("cpu", "gpu"):
        api.reset_backend_for_testing()
        api.init(backend)
        negs.clear()
        before = dict(cp.LAUNCHES)
        got[backend] = api.compute_curve25519_commitments([api.SequenceDescriptor(1, len(vals), data, True)])
    api.reset_backend_for_testing()
    assert np.array_equal(got["gpu"], got["cpu"])
    assert cp.LAUNCHES["ed_add"] - before["ed_add"] == 1 and not negs


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
    got = cp.doubling_combine(ed.PointP3(*(c.to(dev) for c in products)))
    assert _same(got, cp.doubling_combine_plain(products, cp.ladder_segment_bits(16)))
    assert bool(ed.points_equal(ed.PointP3(*(c.cpu() for c in got)), cp.doubling_combine_plain(products)).all())


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


@pytest.mark.parametrize("negate_q", [False, True])
@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (10,), (33,), (3, 17)])
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_wadd_lanes_kernel(dev, curve, shape, negate_q):
    """Eight lanes a pair: the signed combine's 1-10 outputs, a batch off a
    block's eight pairs and a two-axis batch, with z != 1, the identity,
    P + P and P - P among them, q read negated; limb for limb the plain
    version (Montgomery limbs are canonical)."""
    count = int(np.prod(shape))
    orc = curve.oracle
    a, b = orc.random_points(count, seed=51), orc.random_points(count, seed=52)
    ps = [None if i % 5 == 2 else a[i] for i in range(count)]
    qs = [a[i] if i % 3 == 1 else orc.neg(a[i]) if i % 7 == 3 else b[i] for i in range(count)]
    p, q = (curve.reshape_batch(curve._double_impl(curve.from_affine_ints(x, "cpu")), shape) for x in (ps, qs))
    before = cp.LAUNCHES["wadd"]
    got = cw.wadd(curve, _on(p, dev), _on(q, dev), negate_q=negate_q)
    assert cp.LAUNCHES["wadd"] == before + 1
    assert _w_same(got, cw.wadd_plain(curve, p, q, negate_q))


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_signed_commitment_is_one_wadd_and_no_neg(dev, curve, monkeypatch):
    """A signed Weierstrass query's Q_pos - Q_neg, on a handle and streamed,
    is one wadd launch that reads Q_neg negated: no plain neg runs; the
    outputs equal the oracle's."""
    negs = []
    plain_neg = wc.WCurve.neg
    monkeypatch.setattr(wc.WCurve, "neg", lambda self, p: negs.append(1) or plain_neg(self, p))
    n = 40
    pts = curve.oracle.random_points(n, seed=53)
    rng = np.random.default_rng(54)
    mags = rng.integers(0, 256, size=(3, n, 8), dtype=np.uint8)
    signs = rng.integers(0, 2, size=(3, n), dtype=np.uint8)
    want = [curve.oracle.msm([-int.from_bytes(bytes(m), "little") if s else int.from_bytes(bytes(m), "little")
                              for m, s in zip(mrow, srow)], pts) for mrow, srow in zip(mags, signs)]
    points = curve.from_affine_ints(pts, dev)
    for run in (lambda: fixed.fixed_multiexponentiation_signed(fixed.MultiexpHandle(points, curve=curve), mags, signs),
                lambda: fixed.streaming_multiexponentiation(points, mags, curve, signs=signs)):
        before = dict(cp.LAUNCHES)
        negs.clear()
        got = run()
        assert (cp.LAUNCHES["wadd"] - before["wadd"], cp.LAUNCHES["w_doubling_combine"]
                - before["w_doubling_combine"]) == (1, 1) and not negs
        assert curve.to_affine_ints(_on(got, "cpu")) == want


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
@pytest.mark.parametrize("num_mles, n, nbytes, n_pad", [(3, 300, 32, 512), (1, 1000, 32, 1000), (2, 37, 13, 64),
                                                        (3, 5, 8, 300), (1, 1, 31, 1)])
def test_mont_from_rows_kernel(dev, field, num_mles, n, nbytes, n_pad):
    """Random rows (values above m, 2^255 and all 0xFF among them), the
    byte and 4-byte reads, padding-only blocks, a view at an odd offset:
    limb for limb the plain version, one launch each."""
    mode = "standard" if field is cm.FIELDS[cm.SXT_FIELD_SCALAR255] else "residues"
    rows = np.random.default_rng(n).integers(0, 256, size=(num_mles * n + 1, nbytes), dtype=np.uint8)
    rows[1] = 0xFF
    host = torch.from_numpy(rows)
    want = cm.mont_from_rows_plain(field, host[1:], num_mles, n_pad, mode)
    before = cp.LAUNCHES["mont_from_rows"]
    got = cm.mont_from_rows(field, host.to(dev)[1:], num_mles, n_pad, mode)
    assert torch.equal(got.cpu(), want)
    assert cp.LAUNCHES["mont_from_rows"] - before == 1


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
    assert _canon_equal(F.batch_invert_lanes(z.to(dev), cf.fmul, cf.finvert), F.batch_invert_lanes(z))
    with pytest.raises(ValueError):
        cf.fmul(a.to(dev), b[:, :2].to(dev))


@pytest.mark.parametrize("count", [5, 1000, 3 * 2**15 + 7, 2**20, 2**20 + 33])
def test_finvert_batch_kernel(dev, count):
    """The batch inversion at counts that take each of the kernel's 16, 32
    and 64 elements a thread (up to 2^19, 2^20, above), on a strided view: 0, p, 2p and limbs that reduce
    to 0 give 0, values above 2^255 and limbs up to 2^17 their inverse; a
    whole run of zeros at the end; one launch a call."""
    P_LIMBS = [0xFFED] + [0xFFFF] * 14 + [0x7FFF]
    forms = torch.tensor([[0] * 16, P_LIMBS, [0xFFDA] + [0xFFFF] * 15, [0x1FFED, 0xFFFE] + [0xFFFF] * 13 + [0x7FFF]],
                         dtype=torch.int32).T
    a = _fe((2, count), 24)
    zeros = torch.arange(0, count, 7)
    a[:, 0, zeros] = forms[:, torch.arange(len(zeros)) % 4]
    a[:, 0, -min(count, 4096):] = 0
    a = a.to(dev)
    want = F.canonicalize(cf.finvert_plain(a[:, 0])).cpu()  # the plain version on the card
    before = cp.LAUNCHES["finvert"]
    assert _canon_equal(cf.finvert(a[:, 0]), want)
    assert cp.LAUNCHES["finvert"] - before == 1


@pytest.mark.parametrize("field", [tparams.BN254_FP, tparams.BLS12381_FP], ids=lambda f: f.name)
def test_mont_mul_ew_base_fields(dev, field):
    a, b = _field_batch(field, (1000,), 24), _field_batch(field, (1000,), 25)
    assert torch.equal(cm.mont_mul_ew(field, a.to(dev), b.to(dev)).cpu(), cm.mont_mul_ew_plain(field, a, b))


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
    """Saved from the card (one ed_affine launch), loaded on the card (one
    ed_from_affine_rows launch a load, no fmul): the same points as the CPU
    derivation; a legacy extended file loads with one ed_affine launch and
    no finvert or fmul."""
    monkeypatch.setattr(generators, "DISK_CHUNK", 64)
    monkeypatch.setattr(generators, "DISK_DIR", str(tmp_path))
    want = generators.ristretto_generators(128, 0, "cpu")
    before = {k: cp.LAUNCHES[k] for k in ("fmul", "fsq", "finvert", "elligator_form", "ed_affine",
                                          "ed_from_affine_rows")}
    made = generators.ristretto_generators(128, 0, dev)  # loads the CPU's save
    loaded = generators.ristretto_generators(100, 0, dev)
    assert cp.LAUNCHES["elligator_form"] == before["elligator_form"]
    assert (cp.LAUNCHES["ed_from_affine_rows"] - before["ed_from_affine_rows"], cp.LAUNCHES["fmul"]) == \
        (2, before["fmul"])
    assert bool(ed.points_equal(_on(made, "cpu"), want).all())
    assert bool(ed.points_equal(_on(loaded, "cpu"), ed.index_batch(want, slice(0, 100))).all())
    monkeypatch.setattr(generators, "DISK_DIR", str(tmp_path / "card"))
    generators.ristretto_generators(64, 0, dev)  # derived and saved on the card
    assert cp.LAUNCHES["ed_affine"] == before["ed_affine"] + 1 and cp.LAUNCHES["finvert"] == before["finvert"]
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    np.save(legacy / "ristretto_gen_64.npy", np.stack([F.canonicalize(c[:, :64]).numpy().astype(np.uint32)
                                                       for c in want]))
    monkeypatch.setattr(generators, "DISK_DIR", str(legacy))
    fmul = cp.LAUNCHES["fmul"]
    got = generators.ristretto_generators(64, 0, dev)
    assert (cp.LAUNCHES["ed_affine"], cp.LAUNCHES["fmul"]) == (before["ed_affine"] + 2, fmul)
    assert _same(got, cp.ed_affine_plain(ed.index_batch(want, slice(0, 64))))
    monkeypatch.setattr(generators, "DISK_DIR", str(tmp_path / "card"))
    assert bool(ed.points_equal(generators.ristretto_generators(64, 0, "cpu"), ed.index_batch(want, slice(0, 64))).all())


@pytest.mark.parametrize("count", [1, 33, 1000, 70000])
def test_ed_from_affine_rows_kernel(dev, count):
    """The cache file's uint16 rows to (x, y, 1, x y): random limbs (values
    up to 2^256 - 1, most not canonical) and the rows of canonical affine
    generators, against the plain version limb for limb."""
    rng = np.random.default_rng(count)
    rows = torch.from_numpy(rng.integers(0, 1 << 16, size=(2, 16, count), dtype=np.uint16))
    gens = cp.ed_affine_plain(generators.ristretto_generators(min(count, 64), 0, "cpu"))
    rows[:, :, : gens.x.shape[1]] = torch.from_numpy(np.stack([gens.x.numpy(), gens.y.numpy()]).astype(np.uint16))
    before = cp.LAUNCHES["ed_from_affine_rows"]
    got = cp.ed_from_affine_rows(rows.to(dev))
    assert cp.LAUNCHES["ed_from_affine_rows"] == before + 1
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, cp.ed_from_affine_rows_plain(rows)))


# ---------------------------------------------------------------------------
# ed_double, niels_add, fewrow_niels; the bucket engine and the
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


@pytest.mark.parametrize("groups, w, nbytes, signed", [(256, 8, 1, False), (512, 4, 3, True), (1024, 8, 2, False),
                                                      (3072, 4, 1, True)])
def test_fewrow_niels_kernel(dev, groups, w, nbytes, signed):
    """Limb for limb the plain version, one launch a call; chunks of 256,
    512 and 1024 groups (three of them at 3072)."""
    from blitzar_tpu_torch.msm import fixed

    n = groups * w
    table = cp.build_niels_table(generators.ristretto_generators(n, 0, dev), w)
    rng = np.random.default_rng(groups + nbytes)
    scalars = torch.from_numpy(rng.integers(0, 256, size=(2, n, nbytes), dtype=np.uint8)).to(dev)
    signs = torch.from_numpy(rng.integers(0, 2, size=(2, n), dtype=np.uint8)).to(dev) if signed else None
    gc = fixed.table_chunk_groups(groups)
    want = cp.fewrow_niels_plain(table, scalars, signs, w, gc)  # the plain version on the card
    before = cp.LAUNCHES["fewrow_niels"]
    got = cp.fewrow_niels(table, scalars, signs, w, gc)
    assert cp.LAUNCHES["fewrow_niels"] - before == 1
    assert _same(got, want)


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
    before = dict(cp.LAUNCHES)
    got = engine.msm(generators.ristretto_generators(n, 0, dev), *args)
    assert np.array_equal(rst.encode(got).cpu().numpy(), want)
    # the Horner over the 8 windows: one launch, no one-point doublings
    assert (cp.LAUNCHES["ed_horner"] - before["ed_horner"], cp.LAUNCHES["ed_double"] - before["ed_double"]) == (1, 0)


@pytest.mark.parametrize("n, w", [(1000, 8), (1024, 8), (2048, 8), (1024, 4)])
def test_fewrow_query_on_cuda_matches_lookup(dev, n, w):
    """The few-row query on the card equals ed_lookup_msm's products on
    the same handle: an odd chunk of 125 groups (n = 1000), niels_add on
    the halves of a 128-group chunk (1024), one fewrow_niels launch on
    256-group chunks (2048, and w = 4 at 1024) and no entry gathered."""
    from blitzar_tpu_torch.msm import fixed

    handle = fixed.MultiexpHandle(generators.ristretto_generators(n, 0, dev), window_width=w)
    scalars = torch.from_numpy(np.random.default_rng(n).integers(0, 256, size=(1, n, 2), dtype=np.uint8)).to(dev)
    scalars = torch.nn.functional.pad(scalars, (0, 0, 0, handle.num_groups * w - n))
    gathers = []
    inner = fixed.chunk_entries
    fixed.chunk_entries = lambda *a: gathers.append(1) or inner(*a)
    try:
        before = cp.LAUNCHES["fewrow_niels"]
        got = fixed.fewrow_products(handle.table, scalars, None, w)
        launched = cp.LAUNCHES["fewrow_niels"] - before
    finally:
        fixed.chunk_entries = inner
    fits = cp.niels_tree_fits(fixed.table_chunk_groups(handle.num_groups))
    assert (launched, bool(gathers)) == ((1, False) if fits else (0, True))
    want = fixed.sum_leading(cp.ed_lookup_msm(handle.table, scalars, None, w))
    assert bool(ed.points_equal(got, want).all())


# ---------------------------------------------------------------------------
# the two table builds over every window they take and group counts 1, 7, 33
# ---------------------------------------------------------------------------

NIELS_TABLE_CASES = [(w, 7 if w <= 8 else 2) for w in range(1, 17)] + [(w, g) for w in (1, 3, 8) for g in (1, 33)]
CACHED_TABLE_CASES = [(w, 7) for w in range(1, 9)] + [(w, g) for w in (1, 2, 3, 8) for g in (1, 33)]


def _table_points(count: int, seed: int) -> ed.PointP3:
    """count points, every fifth one and the last the identity (a handle
    pads with identities)."""
    pts = cp.elligator_form_plain(*_r(count, seed))
    keep = torch.tensor([i % 5 != 3 and i != count - 1 for i in range(count)])
    return ed.PointP3(*(torch.where(keep, c, ic) for c, ic in zip(pts, ed.identity((count,)))))


@pytest.mark.parametrize("w, groups", NIELS_TABLE_CASES)
def test_niels_table_kernel(dev, w, groups):
    pts = _table_points(groups * w, 100 * w + groups)
    before = cp.LAUNCHES["build_niels_table"]
    got = cp.build_niels_table(_on(pts, dev), w)
    assert torch.equal(got.cpu(), cp.build_niels_table_plain(pts, w))
    assert cp.LAUNCHES["build_niels_table"] == before + 1


@pytest.mark.parametrize("w, groups", CACHED_TABLE_CASES)
def test_cached_table_kernel(dev, w, groups):
    pts = _table_points(groups * w, 200 * w + groups)
    before = cp.LAUNCHES["build_cached_table"]
    got = cp.build_cached_table(_on(pts, dev), w)
    assert torch.equal(got.cpu(), cp.build_cached_table_plain(pts, w))
    assert cp.LAUNCHES["build_cached_table"] == before + 1


# ---------------------------------------------------------------------------
# the redesigned lookup (csrc/lookup.cuh) and tree reduce: the edges of their
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("short", [False, True], ids=["card_rule", "short_last_chunk"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("form", ["niels", "cached"])
def test_lookup_kernel_edges(dev, monkeypatch, form, w, signed, short):
    """Both forms on the middle third of a three-output 2-byte upload over
    11 groups (48 or 96 rows: partial warps and blocks), with the card's
    chunk rule and with one that leaves the last chunk short (3, 3, 3 and 2
    groups): limb for limb the plain partials."""
    rows = (2 if signed else 1) * 3 * 16
    if short:
        monkeypatch.setattr(cp, "LOOKUP_THREADS", 4 * rows)
    n = 11 * w
    pts = _table_points(n, 300 * w + signed)
    build = cp.build_cached_table_plain if form == "cached" else cp.build_niels_table_plain
    table = build(pts, w)
    rng = np.random.default_rng(w + 2 * signed)
    upload = torch.from_numpy(rng.integers(0, 256, size=(3, 3 * n, 2), dtype=np.uint8))
    signs = torch.from_numpy(rng.integers(0, 2, size=(3, 3 * n), dtype=np.uint8)) if signed else None
    chunk = slice(n, 2 * n)
    want = cp.ed_lookup_msm_plain(table, upload[:, chunk], None if signs is None else signs[:, chunk], w)
    got = cp.ed_lookup_msm(table.to(dev), upload.to(dev)[:, chunk],
                           None if signs is None else signs.to(dev)[:, chunk], w)
    assert want.x.shape[1:] == (4 if short else 11, rows)
    assert _same(got, want)


def test_lookup_kernel_many_row_blocks(dev):
    """Three 32-byte outputs (768 rows: three blocks of 256 niels rows)
    over 301 niels groups at w = 8: chunks of 2 groups, the last of 1."""
    w, groups = 8, 301
    pts = _table_points(groups * w, 17)
    table = cp.build_niels_table(_on(pts, dev), w)
    scalars = torch.from_numpy(np.random.default_rng(5).integers(0, 256, size=(3, groups * w, 32), dtype=np.uint8))
    got = cp.ed_lookup_msm(table, scalars.to(dev), None, w)
    assert got.x.shape[1:] == (cp.lookup_chunks(groups, 768)[1], 768)
    assert _same(got, cp.ed_lookup_msm_plain(table.cpu(), scalars, None, w))


# (size, cols): one column, 37 columns (a last tile half idle), the narrow
# (1024, 8) (a small batch: one block a column), a lookup's (K, R) partials
# (several blocks a column tile, summed by the last to finish)
TREE_KERNEL_SHAPES = [(1000, 1), (70, 37), (1024, 8), (263, 256)]


@pytest.mark.parametrize("size, cols", TREE_KERNEL_SHAPES)
def test_tree_reduce_lanes_kernel_shapes(dev, size, cols):
    pts = ed.reshape_batch(cp.elligator_form_plain(*_r(size * cols, 13)), (size, cols))
    got = cp.tree_reduce_lanes(_on(pts, dev))
    assert bool(ed.points_equal(_on(got, "cpu"), cp.tree_reduce_lanes_plain(pts)).all())


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
@pytest.mark.parametrize("size, cols", TREE_KERNEL_SHAPES)
def test_w_tree_reduce_lanes_kernel_shapes(dev, curve, size, cols):
    """The oracle's 599 points tiled to the batch (a prime period)."""
    pts = curve.oracle.random_points(599, seed=size)
    batch = curve.reshape_batch(curve.from_affine_ints([pts[i % 599] for i in range(size * cols)], "cpu"),
                                (size, cols))
    got = cw.w_tree_reduce_lanes(curve, _on(batch, dev))
    assert curve.to_affine_ints(_on(got, "cpu")) == curve.to_affine_ints(cw.w_tree_reduce_lanes_plain(curve, batch))


# ---------------------------------------------------------------------------
# the Weierstrass query redesigned: w_lookup_msm on lookup.cuh's schedule,
# the ladder in one launch (w_doubling_combine), the device multiply
# ---------------------------------------------------------------------------

from blitzar_tpu_torch.msm import fixed  # noqa: E402


def _w_points(curve, count: int, seed: int):
    pts = curve.oracle.random_points(count, seed=seed)
    return curve.from_affine_ints([None if i % 5 == 3 else p for i, p in enumerate(pts)], "cpu")


@pytest.mark.parametrize("short", [False, True], ids=["card_rule", "short_last_chunk"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_lookup_kernel_edges(dev, monkeypatch, curve, w, signed, short):
    """The cases of test_lookup_kernel_edges on the Weierstrass form: the
    middle third of a three-output 2-byte upload over 11 groups, the card's
    chunk rule and a short last chunk; limb for limb the plain partials."""
    rows = (2 if signed else 1) * 3 * 16
    if short:
        monkeypatch.setattr(cp, "LOOKUP_THREADS", 4 * rows)
    n = 11 * w
    table = cw.w_build_table_plain(curve, _w_points(curve, n, 40 * w + signed), w)
    rng = np.random.default_rng(w + 2 * signed)
    upload = torch.from_numpy(rng.integers(0, 256, size=(3, 3 * n, 2), dtype=np.uint8))
    signs = torch.from_numpy(rng.integers(0, 2, size=(3, 3 * n), dtype=np.uint8)) if signed else None
    chunk = slice(n, 2 * n)
    want = cw.w_lookup_msm_plain(curve, table, upload[:, chunk], None if signs is None else signs[:, chunk], w)
    got = cw.w_lookup_msm(curve, table.to(dev), upload.to(dev)[:, chunk],
                          None if signs is None else signs.to(dev)[:, chunk], w)
    assert want.x.shape[1:] == (4 if short else 11, rows)
    assert _w_same(got, want)


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_lookup_kernel_many_row_blocks(dev, curve):
    """Three 32-byte outputs (768 rows: three blocks of 256) over 37 groups
    at w = 8 built on the card, counter-like scalars whose upper 16 bytes are
    zero: every partial equals the plain one."""
    w, groups = 8, 37
    table = cw.w_build_table(curve, _on(_w_points(curve, groups * w, 41), dev), w)
    scalars = np.random.default_rng(6).integers(0, 256, size=(3, groups * w, 32), dtype=np.uint8)
    scalars[:, :, 16:] = 0
    scalars = torch.from_numpy(scalars)
    got = cw.w_lookup_msm(curve, table, scalars.to(dev), None, w)
    assert got.x.shape[1:] == (cp.lookup_chunks(groups, 768)[1], 768)
    assert _w_same(got, cw.w_lookup_msm_plain(curve, table.cpu(), scalars, None, w))


def _ladder_products(curve, outputs: int, nbits: int):
    pts = curve.oracle.random_points(24, seed=nbits)
    rows = [None if (o == 0 and b >= nbits // 2 and nbits > 1) or (o * nbits + b) % 7 == 5
            else pts[(5 * o + 3 * b) % 24] for o in range(outputs) for b in range(nbits)]
    return curve.reshape_batch(curve.from_affine_ints(rows, "cpu"), (outputs, nbits))


@pytest.mark.parametrize("outputs, nbits", [(1, 1), (3, 8), (2, 9), (1, 256), (7, 256), (14, 64)])
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_doubling_combine_kernel(dev, curve, outputs, nbits):
    """The ladder kernel on (nlimbs, O, nbits) products (identity rows among
    them) against its plain version limb for limb, read in place from the
    (R,) products of a query; the same points as blitzar_tpu's one-segment
    order."""
    products = _ladder_products(curve, outputs, nbits)
    want = cw.w_doubling_combine_plain(curve, products)
    flat = _on(curve.reshape_batch(products, (outputs * nbits,)), dev)
    before = dict(cp.LAUNCHES)
    got = fixed.doubling_combine(flat, outputs, nbits, curve)
    assert cp.LAUNCHES["w_doubling_combine"] == before["w_doubling_combine"] + 1
    assert (cp.LAUNCHES["wadd"], cp.LAUNCHES["wdouble"]) == (before["wadd"], before["wdouble"])
    assert _w_same(got, want)
    if nbits <= 64:
        one = cw.w_doubling_combine_plain(curve, products, nbits)
        assert bool(curve.points_equal(_on(got, "cpu"), one).all())


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_query_ladder_is_one_launch(dev, curve):
    """A handle's unsigned query runs the ladder once and no wadd or
    wdouble; a signed one runs it once over both halves and one wadd (Q_pos
    - Q_neg); both equal the oracle."""
    n = 64
    pts = curve.oracle.random_points(n, seed=42)
    handle = fixed.MultiexpHandle(curve.from_affine_ints(pts, dev), curve=curve)
    rng = np.random.default_rng(43)
    mags = rng.integers(0, 256, size=(2, n, 16), dtype=np.uint8)
    signs = rng.integers(0, 2, size=(2, n), dtype=np.uint8)
    vals = [[int.from_bytes(bytes(mags[o, i]), "little") for i in range(n)] for o in range(2)]
    cp.reset_launches()
    got = fixed.fixed_multiexponentiation(handle, mags)
    assert (cp.LAUNCHES["w_doubling_combine"], cp.LAUNCHES["wadd"], cp.LAUNCHES["wdouble"]) == (1, 0, 0)
    assert curve.to_affine_ints(_on(got, "cpu")) == [curve.oracle.msm(v, pts) for v in vals]
    cp.reset_launches()
    got = fixed.fixed_multiexponentiation_signed(handle, mags, signs)
    assert (cp.LAUNCHES["w_doubling_combine"], cp.LAUNCHES["wadd"], cp.LAUNCHES["wdouble"]) == (1, 1, 0)
    signed = [[-v if s else v for v, s in zip(row, srow)] for row, srow in zip(vals, signs)]
    assert curve.to_affine_ints(_on(got, "cpu")) == [curve.oracle.msm(v, pts) for v in signed]


@pytest.mark.parametrize("fid", [0, 1, 2, 3])
def test_mont_mul_ew_edge_words(dev, fid):
    """mf_mul's device body in every field of mont_mul_ew: the words 0, 1,
    2, m - 1, m - 2 and R mod m against each other, all-ones words and other
    raw rows below R (not m) times canonical b (mont.cuh allows a < R), and
    seeded pairs: exactly a b R^-1 mod m, canonical."""
    field = cm.MUL_FIELDS[fid]
    m, big_r = field.modulus, 1 << field.radix_bits
    canon = [0, 1, 2, m - 1, m - 2, (m - 1) // 2, field.r]
    raw = canon + [big_r - 1, m, m + 1, big_r - 2]
    rng = np.random.default_rng(fid)
    rand = [int.from_bytes(rng.bytes(field.nbytes), "little") % m for _ in range(128)]
    pairs = [(a, b) for a in raw for b in canon] + list(zip(rand, rand[1:] + rand[:1]))
    limbs = lambda vals: torch.tensor([field.int_limbs(v) for v in vals], dtype=torch.int32).T.contiguous()  # noqa: E731
    a, b = limbs([p[0] for p in pairs]), limbs([p[1] for p in pairs])
    r_inv = pow(big_r, -1, m)
    assert torch.equal(cm.mont_mul_ew(field, a.to(dev), b.to(dev)).cpu(), limbs([x * y * r_inv % m for x, y in pairs]))


# ---------------------------------------------------------------------------
# w_build_table on table_build.cuh's lane schedule; the ristretto255 ladder
# on ladder.cuh's segments
# ---------------------------------------------------------------------------

# every window up to 8 (4 lanes a group, 32 groups a block: 33 spill into a
# second block), then 8, 16, 32 lanes a group, one warp (w = 11), two and
# four warps a group (w = 12, 13)
W_TABLE_CASES = [(w, 33) for w in range(1, 9)] + [(9, 5), (10, 3), (11, 3), (12, 3), (13, 2)]


@pytest.mark.parametrize("w, groups", W_TABLE_CASES)
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_table_kernel(dev, curve, w, groups):
    """The table of the card equals the plain version's limb for limb
    (blitzar_tpu's order of adds; identity points among the generators)."""
    pts = _w_points(curve, groups * w, 50 * w + groups)
    before = cp.LAUNCHES["w_build_table"]
    got = cw.w_build_table(curve, _on(pts, dev), w)
    assert cp.LAUNCHES["w_build_table"] == before + 1
    assert torch.equal(got.cpu(), cw.w_build_table_plain(curve, pts, w))


def _ed_ladder_products(outputs: int, nbits: int) -> ed.PointP3:
    r0, r1 = _r(24, nbits)
    pts = ed._double_impl(cp.elligator_form_plain(r0, r1))
    idx = torch.tensor([(5 * o + 3 * b) % 24 for o in range(outputs) for b in range(nbits)])
    ident = torch.tensor([(o == 0 and b >= nbits // 2 and nbits > 1) or (o * nbits + b) % 7 == 5
                          for o in range(outputs) for b in range(nbits)])
    rows = ed.select(ed.index_batch(pts, idx), ed.identity((len(idx),)), ident)
    return ed.reshape_batch(rows, (outputs, nbits))


@pytest.mark.parametrize("outputs, nbits", [(1, 1), (3, 8), (2, 9), (1, 256), (2, 256), (7, 256), (10, 256),
                                            (14, 64)])
def test_doubling_combine_kernel(dev, outputs, nbits):
    """One launch a query; in the kernel's segments limb for limb the plain
    version in the same segments, in one segment limb for limb blitzar_tpu's
    order (the default plain version); the two the same points."""
    products = _ed_ladder_products(outputs, nbits)
    flat = _on(ed.reshape_batch(products, (outputs * nbits,)), dev)
    before = cp.LAUNCHES["doubling_combine"]
    got = fixed.doubling_combine(flat, outputs, nbits)
    assert cp.LAUNCHES["doubling_combine"] == before + 1
    assert _same(got, cp.doubling_combine_plain(products, cp.ladder_segment_bits(nbits)))
    want = cp.doubling_combine_plain(products)
    assert _same(cp.doubling_combine(_on(products, dev), seg_bits=nbits), want)
    assert bool(ed.points_equal(_on(got, "cpu"), want).all())


@pytest.mark.parametrize("curve", list(wc.CURVES), ids=lambda c: c.name)
def test_w_affine_kernel(dev, curve):
    """A table chunk's affine rows on the card equal the plain version's,
    word for word: groups of 8, 256 and 4096 entries (tiles of 32 x 32
    entries a warp, the last short; 40 x 4096 takes 64 a thread), entry 0
    of each group and some others identities."""
    from blitzar_tpu_torch.curves.weierstrass import PointP2

    for groups, entries in ((5, 8), (3, 256), (3, 4096), (40, 4096)):
        x, y, z = (_field_batch(curve.field, (groups, entries), 60 + k) for k in range(3))
        z[:, :, 0] = 0
        z[:, -1, 3::7] = 0
        chunk = cw.pack_points(PointP2(x, y, z))
        before = cp.LAUNCHES["w_affine"]
        got = cw.w_affine(curve, chunk.to(dev))
        assert cp.LAUNCHES["w_affine"] == before + 1
        assert torch.equal(got.cpu(), cw.w_affine_plain(curve, chunk)), (groups, entries)


@pytest.mark.parametrize("field", PROOF_FIELDS, ids=lambda f: f.name)
def test_mont_sum_round_kernel_shapes(dev, field):
    """One launch a round at mid = 1, 2, 5, 300 and 70000 (one block to many),
    degrees 1-5 with repeated MLEs, short products and a product of the same
    MLEs as an earlier one; the stream's ticket is back to 0 after each
    launch."""
    tables = {1: ((0,), (2,), (0,)), 2: ((1, 2), (0,), (2, 1)), 3: ((0, 1, 2), (2, 0), (2, 1, 0)),
              4: ((2, 0, 1, 1), (1,), (1, 2, 1, 0)), 5: ((0, 1, 2, 0, 1), (2, 1, 0), (1, 0, 1, 0, 2), (3, 3))}
    for mid in (1, 2, 5, 300, 70000):
        mles = _field_batch(field, (4, 2 * mid), mid)
        for degree, struct in tables.items():
            lengths = torch.tensor([len(t) for t in struct], dtype=torch.int32)
            terms = torch.tensor([t for ts in struct for t in ts], dtype=torch.int32)
            mults = _field_batch(field, (len(struct),), 30 + degree)
            before = cp.LAUNCHES["mont_sum_round"]
            got = cm.mont_sum_round(field, mles.to(dev), mults.to(dev), lengths.to(dev), terms.to(dev), degree)
            assert cp.LAUNCHES["mont_sum_round"] == before + 1
            want = cm.mont_sum_round_plain(field, mles, mults, lengths, terms, degree)
            assert torch.equal(got.cpu(), want), (mid, degree)
            assert int(cm._ticket(dev, cp._stream(dev)).item()) == 0


@pytest.mark.parametrize("field", PROOF_FIELDS, ids=lambda f: f.name)
def test_mont_sum_round_many_products(dev, field):
    """300 products (more than a block's shared memory would hold D + 1 sums
    of) at degrees 2 and 5, over one block and five."""
    for mid, degree in ((3, 2), (600, 5)):
        mles = _field_batch(field, (6, 2 * mid), 40 + degree)
        struct = [tuple((p + j) % 6 for j in range(1 + p % degree)) for p in range(300)]
        lengths = torch.tensor([len(t) for t in struct], dtype=torch.int32)
        terms = torch.tensor([t for ts in struct for t in ts], dtype=torch.int32)
        mults = _field_batch(field, (len(struct),), 50 + degree)
        got = cm.mont_sum_round(field, mles.to(dev), mults.to(dev), lengths.to(dev), terms.to(dev), degree)
        assert torch.equal(got.cpu(), cm.mont_sum_round_plain(field, mles, mults, lengths, terms, degree)), mid


@pytest.mark.parametrize("field", PROOF_FIELDS, ids=lambda f: f.name)
def test_mont_sum_round_two_streams(dev, field):
    """Rounds of two tables launched in turns on two streams of one card, in
    flight together, each equal to plain: each stream has its own ticket."""
    struct = ((0, 1, 2), (2, 0), (3,))
    lengths = torch.tensor([len(t) for t in struct], dtype=torch.int32)
    terms = torch.tensor([t for ts in struct for t in ts], dtype=torch.int32)
    mults = _field_batch(field, (len(struct),), 70)
    tables = [_field_batch(field, (4, 2 * 70000), 71 + k) for k in range(2)]
    args = [(t.to(dev), mults.to(dev), lengths.to(dev), terms.to(dev)) for t in tables]
    streams = [torch.cuda.Stream(dev) for _ in tables]
    torch.cuda.synchronize(dev)
    outs: list = [[], []]
    for _ in range(8):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[k].append(cm.mont_sum_round(field, *args[k], 3))
    torch.cuda.synchronize(dev)
    for k, table in enumerate(tables):
        want = cm.mont_sum_round_plain(field, table, mults, lengths, terms, 3)
        assert all(torch.equal(o.cpu(), want) for o in outs[k]), k


# ---------------------------------------------------------------------------
# the ristretto255 table conversions (ed_to_niels, ed_file_rows,
# ed_file_entries) and the bucket engine's Horner (ed_horner, w_horner)
# ---------------------------------------------------------------------------


def _ed_chunk(dev, groups: int, entries: int, seed: int) -> ed.PointP3:
    """(16, groups, entries) extended points on the card, each scaled by a
    random factor (z != 1)."""
    count = groups * entries
    r0, r1 = _r(count, seed)
    pts = cp.elligator_form(r0.to(dev), r1.to(dev))
    k = np.random.default_rng(seed).integers(1, 1 << 16, size=(16, count)).astype(np.int32)
    k = torch.from_numpy(k).to(dev)
    return ed.reshape_batch(ed.PointP3(*(F.mul(c, k) for c in pts)), (groups, entries))


@pytest.mark.parametrize("groups, entries", [(5, 8), (3, 256), (4096, 256), (5000, 256)])
def test_ed_to_niels_kernel(dev, groups, entries):
    """One launch a chunk, word for word the plain version: tiles of 32 x 32
    entries (the first two shapes: one short tile), 32 a thread at 2^20
    entries and 64 at 5000 x 256; and on a view of the chunk (another limb
    stride)."""
    chunk = _ed_chunk(dev, groups, entries, groups)
    before = cp.LAUNCHES["ed_to_niels"]
    got = cp.ed_to_niels(chunk)
    assert cp.LAUNCHES["ed_to_niels"] == before + 1
    assert torch.equal(got, cp.ed_to_niels_plain(chunk))
    view = ed.index_batch(chunk, slice(1, None))
    assert torch.equal(cp.ed_to_niels(view), got[1:])


def test_ed_file_rows_and_entries_kernels(dev):
    """Rows of niels words (random words: any 256-bit values) and entries of
    rows (random u64 field51 limbs of any magnitude, and the rows written),
    one launch each, word for word the plain versions; 2^20 + 3 entries
    take the grid-stride loop past one pass."""
    rng = np.random.default_rng(33)
    count = (1 << 20) + 3
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(count, 3, 8), dtype=np.int64).astype(np.int32))
    words = words.to(dev)
    before = dict(cp.LAUNCHES)
    rows = cp.ed_file_rows(words)
    assert torch.equal(rows, cp.ed_file_rows_plain(words))
    niels = cp.ed_to_niels_plain(ed.reshape_batch(_ed_chunk(dev, 3, 256, 34), (768,)))
    assert torch.equal(cp.ed_file_entries(cp.ed_file_rows(niels)), niels)
    odd = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=(count, 15), dtype=np.int64)).to(dev)
    assert torch.equal(cp.ed_file_entries(odd), cp.ed_file_entries_plain(odd))
    assert {k: cp.LAUNCHES[k] - before[k] for k in ("ed_file_rows", "ed_file_entries", "fmul")} == \
        {"ed_file_rows": 2, "ed_file_entries": 2, "fmul": 0}


def test_ristretto_files_paths_launch_one_conversion_a_chunk(dev, tmp_path):
    """A 40-point handle's npz write, raw write, raw read and npz read on the
    card: one ed_niels_points, ed_file_rows, ed_file_entries and ed_to_niels
    launch each, and no fmul or finvert."""
    card = tfixed.MultiexpHandle(_on(cp.elligator_form_plain(*_r(40, 35)), dev))
    cp.reset_launches()
    card.write_to_file(str(tmp_path / "h.npz"))
    tinterop.write_reference_file(card, tmp_path / "h.raw")
    raw = tfixed.MultiexpHandle.new_from_file(str(tmp_path / "h.raw"), ed, dev)
    npz = tfixed.MultiexpHandle.new_from_file(str(tmp_path / "h.npz"), ed, dev)
    made = {k: cp.LAUNCHES[k] for k in ("ed_niels_points", "ed_file_rows", "ed_file_entries", "ed_to_niels", "fmul",
                                        "finvert")}
    assert made == {"ed_niels_points": 1, "ed_file_rows": 1, "ed_file_entries": 1, "ed_to_niels": 1, "fmul": 0,
                    "finvert": 0}
    assert torch.equal(raw.table, card.table) and torch.equal(npz.table, card.table)


@pytest.mark.parametrize("groups, entries", [(1, 16), (3, 256), (4096, 256), (16385, 256)])
def test_ed_niels_points_kernel(dev, groups, entries):
    """One launch a call, limb for limb the plain version on a table's words
    (identity entries among them); 2^22 + 256 entries take the grid-stride
    loop past one pass; a chunk written in place into its slice of a larger
    table, the rest untouched."""
    w = entries.bit_length() - 1
    table = cp.build_niels_table(generators.ristretto_generators(groups * w, 0, dev), w)
    before = cp.LAUNCHES["ed_niels_points"]
    got = cp.ed_niels_points(table)
    assert cp.LAUNCHES["ed_niels_points"] == before + 1
    assert _same(got, cp.ed_niels_points_plain(table))
    out = ed.PointP3(*(torch.full((16, groups + 1, entries), -1, dtype=torch.int32, device=dev) for _ in range(4)))
    cp.ed_niels_points(table, out=ed.index_batch(out, slice(1, None)))
    assert all(torch.equal(o[:, 1:], g) for o, g in zip(out, got))
    assert all(bool((o[:, 0] == -1).all()) for o in out)


@pytest.mark.parametrize("count", [5, 1000, 2**18 + 5, 2**19 + 7, 2**20, 2**20 + 33])
def test_ed_affine_kernel(dev, count):
    """One launch, limb for limb the plain version: 8 entries a thread up
    to 2^18, 16 up to 2^19, 32 up to 2^20, 64 above (short last tiles), z
    far from 1, t not read; and on a strided view."""
    pts = _ed_chunk(dev, 1, count, 7)
    pts = ed.PointP3(pts.x[:, 0], pts.y[:, 0], pts.z[:, 0], torch.zeros_like(pts.t[:, 0]))
    before = cp.LAUNCHES["ed_affine"]
    got = cp.ed_affine(pts)
    assert cp.LAUNCHES["ed_affine"] == before + 1
    want = cp.ed_affine_plain(pts)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    view = ed.index_batch(pts, slice(1, None, 2))
    assert all(torch.equal(g, w) for g, w in zip(cp.ed_affine(view), ed.index_batch(want, slice(1, None, 2))))


HORNER_SHAPES = [(1, 1), (3, 4), (2, 9), (1, 32), (10, 32)]


@pytest.mark.parametrize("outputs, windows", HORNER_SHAPES)
def test_ed_horner_kernel(dev, outputs, windows):
    """One launch; in the kernel's segments limb for limb the plain version
    in the same segments, in one segment limb for limb the engine's loop
    (horner_plain); the two the same points."""
    pts = ed.reshape_batch(_ed_ladder_products(1, outputs * windows), (outputs, windows))
    card = _on(pts, dev)
    before = cp.LAUNCHES["ed_horner"]
    got = engine.horner(card)
    assert cp.LAUNCHES["ed_horner"] == before + 1
    assert _same(got, cp.ed_horner_plain(pts, cp.ladder_segment_bits(windows)))
    loop = engine.horner_plain(pts)
    assert _same(cp.ed_horner(card, seg_bits=windows), loop)
    assert bool(ed.points_equal(_on(got, "cpu"), loop).all())


@pytest.mark.parametrize("outputs, windows", HORNER_SHAPES)
@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_w_horner_kernel(dev, curve, outputs, windows):
    """As test_ed_horner_kernel on the three Weierstrass curves."""
    pts = curve.reshape_batch(_ladder_products(curve, 1, outputs * windows), (outputs, windows))
    card = _on(pts, dev)
    before = cp.LAUNCHES["w_horner"]
    got = engine.horner(card, curve)
    assert cp.LAUNCHES["w_horner"] == before + 1
    assert _w_same(got, cw.w_horner_plain(curve, pts, cp.ladder_segment_bits(windows)))
    loop = engine.horner_plain(pts, curve)
    assert _w_same(cw.w_horner(curve, card, seg_bits=windows), loop)
    assert bool(curve.points_equal(_on(got, "cpu"), loop).all())


def _window_buckets(curve, rows: int, seed: int):
    """(rows, 255) bucket sums: seeded points, every seventh bucket empty,
    row 1 all empty, row 2 bucket 255 alone."""
    k = torch.arange(rows * 255)
    pick = (k * 13 + seed) % 97
    empty = (k % 7 == 3) | ((k // 255 == 1) & (rows > 1)) | ((k // 255 == 2) & (k % 255 != 254))
    if curve is ed:
        pool = cp.elligator_form_plain(*_r(97, seed))
        ident = ed.identity((rows * 255,))
    else:
        pool = curve.from_affine_ints(curve.oracle.random_points(97, seed=seed), "cpu")
        ident = curve.identity((rows * 255,))
    pts = curve.select(curve.index_batch(pool, pick), ident, empty)
    return curve.reshape_batch(pts, (rows, 255))


@pytest.mark.parametrize("rows", [1, 3, 8, 32, 320])
@pytest.mark.parametrize("curve", [ed] + list(wc.CURVES), ids=lambda c: getattr(c, "name", "ristretto255"))
def test_window_sums_kernel(dev, curve, rows):
    """One launch for all rows (8: a signed 8-byte column; 32: a 32-byte
    one; 320: ten of them), the same points as the plain scan and tree; the
    empty row the identity; on a view of every other row."""
    buckets = _window_buckets(curve, rows, rows)
    name = "ed_window_sums" if curve is ed else "w_window_sums"
    card = _on(buckets, dev)
    before = cp.LAUNCHES[name]
    got = engine.window_sums(card, curve)
    assert cp.LAUNCHES[name] == before + 1
    want = cp.window_sums_plain(curve, buckets)
    assert bool(curve.points_equal(_on(got, "cpu"), want).all())
    if rows > 1:
        assert bool(curve.points_equal(curve.index_batch(_on(got, "cpu"), slice(1, 2)), curve.identity((1,))).all())
        half = engine.window_sums(curve.index_batch(card, (slice(0, None, 2), slice(None))), curve)
        assert bool(curve.points_equal(_on(half, "cpu"), curve.index_batch(want, slice(0, None, 2))).all())


def test_bucket_engine_combine_is_two_launches(dev, monkeypatch):
    """The bucket engine's combine on the card: one ed_window_sums and one
    ed_horner launch, no ed_add and no tree_reduce_lanes launch, the same
    commitment as on the CPU."""
    n = 100
    rng = np.random.default_rng(38)
    data = [rng.integers(0, 256, size=(n, 4), dtype=np.uint8), rng.integers(0, 256, size=(n, 4), dtype=np.uint8)]
    args = (data, [4, 4], [False, True])
    want = rst.encode(engine.msm(generators.ristretto_generators(n, 0, "cpu"), *args)).numpy()
    monkeypatch.setenv(engine.ENGINE_VAR, "bucket")
    inner, made = engine.combine_buckets, []

    def counting(*a, **k):
        before = dict(cp.LAUNCHES)
        out = inner(*a, **k)
        made.append({name: v - before[name] for name, v in cp.LAUNCHES.items() if v != before[name]})
        return out

    monkeypatch.setattr(engine, "combine_buckets", counting)
    got = engine.msm(generators.ristretto_generators(n, 0, dev), *args)
    assert np.array_equal(rst.encode(got).cpu().numpy(), want)
    assert made == [{"ed_window_sums": 1, "ed_horner": 1}]


def test_w_bucket_engine_horner_is_one_launch(dev, monkeypatch):
    """The bucket engine on bn254 G1 (two 3-byte outputs, one signed) equals
    the oracle, with one w_horner and one w_window_sums launch and no
    wdouble or wadd."""
    curve, n = wc.BN254_G1, 40
    pts = curve.oracle.random_points(n, seed=36)
    rng = np.random.default_rng(37)
    data = [rng.integers(0, 256, size=(n, 3), dtype=np.uint8), rng.integers(0, 256, size=(n, 3), dtype=np.uint8)]
    monkeypatch.setenv(engine.ENGINE_VAR, "bucket")
    before = dict(cp.LAUNCHES)
    got = engine.msm(curve.from_affine_ints(pts, dev), data, [3, 3], [False, True], curve)
    assert (cp.LAUNCHES["w_horner"] - before["w_horner"], cp.LAUNCHES["wdouble"] - before["wdouble"]) == (1, 0)
    assert (cp.LAUNCHES["w_window_sums"] - before["w_window_sums"], cp.LAUNCHES["wadd"] - before["wadd"]) == (1, 0)
    vals = [[int.from_bytes(bytes(r), "little") for r in data[0]],
            [int.from_bytes(bytes(r), "little") - (1 << 24) * (r[2] >= 0x80) for r in data[1]]]
    assert curve.to_affine_ints(_on(got, "cpu")) == [curve.oracle.msm(v, pts) for v in vals]


# ---------------------------------------------------------------------------
# the C ABI with the GPU backend (tests/torch_capi_card_driver.py, in its
# own process: the shim aborts on misuse and sxt_init is one-shot)
# ---------------------------------------------------------------------------

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CAPI_CARD_DRIVER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_capi_card_driver.py")


@pytest.fixture(scope="module")
def capi_lib(dev):
    from blitzar_tpu_torch.cbindings import build

    return build.build()


def _capi_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_capi_gpu_backend_matches_the_api(capi_lib, tmp_path):
    """Every entry through the ABI with SXT_GPU_BACKEND at 2^12 (the
    Weierstrass commitments and handle file at 2^12 too): its bytes equal
    the API's, and its commitment launches the API's kernels and no plain
    version."""
    proc = subprocess.run([sys.executable, CAPI_CARD_DRIVER, str(capi_lib), str(tmp_path), "--log2-n", "12"],
                          capture_output=True, text=True, env=_capi_env(), timeout=900)
    assert proc.returncode == 0 and "CAPI_CARD " in proc.stdout, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_capi_gpu_backend_without_a_card_is_refused(capi_lib, tmp_path):
    """With no visible card sxt_init(SXT_GPU_BACKEND) returns 1, and a
    commitment after it aborts: there is no CPU fallback."""
    proc = subprocess.run([sys.executable, CAPI_CARD_DRIVER, str(capi_lib), str(tmp_path), "--no-card"],
                          capture_output=True, text=True, env=_capi_env(CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0 and "REFUSED" in proc.stdout and "NOT REACHED" not in proc.stdout
    assert "blitzar_tpu panic" in proc.stderr
