"""Cases shared by tests/test_torch_wcommit_*.py: one curve's commitment
entry, handle and table in blitzar_tpu_torch (CPU backend, plain versions)
against blitzar_tpu, bytes for bytes.

Each test_torch_wcommit_<curve>.py sets the module fixture ``curve_name``
and star-imports this module, so the three curves run as three files (in
parallel under xdist) and each file's blitzar_tpu programs (the table build
and one query per shape) compile once and serve all of its tests: one
unsigned shape at n = 7 that the handle query shares. The signed
multi-output calls (n = 1, 7 and 64) are held to blitzar_tpu's pure-Python
oracle (refimpl/weierstrass.py) in the entry's output bytes, which the
unsigned call holds to blitzar_tpu's jitted entry: that entry's compile of
each signed call shape took ~30 s a shape."""

import numpy as np
import pytest
import torch

from blitzar_tpu import api as japi
from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.refimpl import weierstrass as jref
from blitzar_tpu_torch import api
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.utils.limbs import from_jax_points, handle_from_jax_table, to_jax_points

N_MAX = 64
UNSIGNED_WIDTHS = [1, 2, 7, 13, 31, 32]


def _ints_to_rows(values, nbytes: int) -> np.ndarray:
    rows = np.zeros((len(values), nbytes), np.uint8)
    for i, v in enumerate(values):
        rows[i] = np.frombuffer((int(v) % (1 << (8 * nbytes))).to_bytes(nbytes, "little"), np.uint8)
    return rows


def _descriptors(module, n: int, seed: int):
    """Six columns of the signed call: unsigned 1 and 32 bytes, signed 8 and
    16 bytes (the 16-byte one with the extremes, and shorter), a ragged
    unsigned 5-byte one and a zero-length one."""
    rng = np.random.default_rng(seed)
    s16 = [int(a) * (1 << 64) + int(b) for a, b in zip(rng.integers(-(1 << 62), 1 << 62, size=n),
                                                         rng.integers(0, 1 << 62, size=n))]
    s16[:3] = [-(1 << 127), (1 << 127) - 1, -1][: len(s16[:3])]
    m = max(n - 2, 1)
    cols = [
        (1, rng.integers(0, 256, size=(n, 1), dtype=np.uint8), False),
        (32, rng.integers(0, 256, size=(n, 32), dtype=np.uint8), False),
        (8, _ints_to_rows(rng.integers(-(1 << 63), (1 << 63) - 1, size=n), 8), True),
        (16, _ints_to_rows(s16[:m], 16), True),
        (5, rng.integers(0, 256, size=(m, 5), dtype=np.uint8), False),
        (4, np.zeros((0, 4), np.uint8), False),
    ]
    return [module.SequenceDescriptor(nb, rows.shape[0], rows, signed) for nb, rows, signed in cols]


def _unsigned_descriptors(module, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [module.SequenceDescriptor(nb, n, rng.integers(0, 256, size=(n, nb), dtype=np.uint8)) for nb in UNSIGNED_WIDTHS]


@pytest.fixture(scope="module")
def curves(curve_name):
    jc = {c.name: c for c in (jwc.BLS12381_G1, jwc.BN254_G1, jwc.GRUMPKIN)}[curve_name]
    tc = {c.name: c for c in twc.CURVES}[curve_name]
    return jc, tc


@pytest.fixture(scope="module")
def gens(curves):
    """N_MAX oracle points on both sides: blitzar_tpu's PointP2 and the
    port's on the CPU."""
    jc, tc = curves
    pts = tc.oracle.random_points(N_MAX, seed=31)
    return pts, jc.from_affine_ints(pts), tc.from_affine_ints(pts, "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def backends():
    api.reset_backend_for_testing()
    japi.reset_backend_for_testing()
    api.init("cpu")
    japi.init()
    yield
    api.reset_backend_for_testing()
    japi.reset_backend_for_testing()


def _slice(points, n: int):
    return type(points)(*(c[:, :n] for c in points))


def _entries(curve):
    """The port's commitment entry of ``curve`` and blitzar_tpu's of the same name."""
    entry = api.COMMITMENT_ENTRIES[curve]
    return entry, getattr(japi, entry.__name__)


def _oracle_output(curve_name: str, desc, pts) -> bytes:
    """One column's commitment by blitzar_tpu's oracle, as the entry writes
    it: zcash-compressed for bls12-381 G1, else the (x, y, infinity)
    struct's bytes (32-byte little-endian x and y)."""
    ref = {"bls12_381_g1": jref.BLS12381_G1, "bn254_g1": jref.BN254_G1, "grumpkin": jref.GRUMPKIN}[curve_name]
    bits = 8 * desc.element_nbytes
    vals = [int.from_bytes(bytes(r), "little") for r in desc.rows()]
    if desc.is_signed:
        vals = [v - (1 << bits) if v >> (bits - 1) else v for v in vals]
    pt = ref.msm(vals, pts[: len(vals)])
    if curve_name == "bls12_381_g1":
        return jref.compress_bls12_381(pt)
    if pt is None:
        return bytes(64) + b"\x01"
    return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little") + b"\x00"


@pytest.mark.parametrize("n", [1, 7, N_MAX])
def test_signed_multi_output_commitments_match(curves, gens, n):
    _, tc = curves
    pts, _, tg = gens
    entry, _ = _entries(tc)
    descriptors = _descriptors(api, n, seed=n)
    got = entry(descriptors, _slice(tg, n))
    assert got.shape[0] == 6
    want = [_oracle_output(tc.name, d, pts) for d in descriptors]
    if tc.name == "bls12_381_g1":
        assert [bytes(g) for g in got] == want
    else:
        assert [bytes(g["x"]) + bytes(g["y"]) + bytes([g["infinity"]]) for g in got] == want
    assert (got["infinity"][5] == 1) if tc.name != "bls12_381_g1" else got[5][0] == 0b1100_0000


def test_unsigned_widths_match(curves, gens):
    _, tc = curves
    _, jg, tg = gens
    entry, jentry = _entries(tc)
    got = entry(_unsigned_descriptors(api, 7, seed=5), _slice(tg, 7))
    want = jentry(_unsigned_descriptors(japi, 7, seed=5), _slice(jg, 7))
    assert got.tobytes() == want.tobytes()


def test_commitment_against_the_oracle(curves, gens):
    """One signed column at n = 7 through the port alone, against the
    oracle's sum, so the two packages are not only checked against each other."""
    _, tc = curves
    pts, _, tg = gens
    vals = [3, -5, (1 << 63) - 1, -(1 << 63), 0, 1, -1]
    got = _entries(tc)[0]([api.SequenceDescriptor(8, 7, _ints_to_rows(vals, 8), True)], _slice(tg, 7))
    want = tc.oracle.msm(vals, pts[:7])
    if tc.name == "bls12_381_g1":
        from blitzar_tpu_torch.refimpl.weierstrass import compress_bls12_381

        assert bytes(got[0]) == compress_bls12_381(want)
    else:
        assert (bytes(got["x"][0]), bytes(got["y"][0])) == (want[0].to_bytes(32, "little"), want[1].to_bytes(32, "little"))


def test_empty_descriptor_list(curves, gens):
    _, tc = curves
    got = _entries(tc)[0]([], gens[2])
    assert got.shape[0] == 0


def test_table_matches_blitzar_tpu_point_table(curves, gens):
    """The plain build's table equals blitzar_tpu's bit for bit: the same
    projective sums in the same order (so also as points)."""
    jc, tc = curves
    _, jg, tg = gens
    th = tfixed.MultiexpHandle(_slice(tg, 7), curve=tc)
    jh = jfixed.MultiexpHandle(_slice(jg, 7), curve=jc)
    assert th.table.shape == (1, 256, 3, tc.nlimbs // 2)
    want = np.stack([np.asarray(c) for c in jh._point_table()])
    assert np.array_equal(to_jax_points(th.point_table()), want)


def test_fixed_multiexponentiation_matches(curves, gens):
    """A handle through multiexp_handle_new(curve_id, ...) on both sides,
    queried with 32-byte scalars (blitzar_tpu's query shape of the unsigned
    call), and the handle carried over from blitzar_tpu's saved table."""
    jc, tc = curves
    _, jg, tg = gens
    scalars = np.random.default_rng(6).integers(0, 256, size=(len(UNSIGNED_WIDTHS), 7, 32), dtype=np.uint8)
    th = api.multiexp_handle_new(api.CURVE_IDS[tc], _slice(tg, 7))
    jh = japi.multiexp_handle_new(api.CURVE_IDS[tc], _slice(jg, 7))
    assert th.curve is tc and th.n == 7
    got = tc.to_affine_ints(api.fixed_multiexponentiation(th, scalars))
    jres = japi.fixed_multiexponentiation(jh, scalars)
    want = tc.to_affine_ints(from_jax_points(np.stack([np.asarray(c) for c in jres]), device="cpu"))
    assert got == want
    carried = handle_from_jax_table(*(np.asarray(c) for c in jh._point_table()), n=7, curve=tc, device="cpu")
    assert carried.curve is tc and carried.window_width == 8 and carried.n == 7
    assert torch.equal(carried.table, th.table)
    assert tc.to_affine_ints(tfixed.fixed_multiexponentiation(carried, scalars[:1])) == want[:1]
