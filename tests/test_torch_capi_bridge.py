"""The port's ABI bridge (``blitzar_tpu_torch/capi_bridge.py``) parsers and
emitters against blitzar_tpu's (``blitzar_tpu/capi_bridge.py``), in process
and with no shared library, on the same byte buffers, tolerance 0 on
canonical values: descriptors of 1-32 bytes (n = 0 and signed columns
among them), radix-2^51 limbs that carry values >= p, the identity and
infinity flags of both affine layouts, the projective Montgomery structs of
all three Weierstrass curves, the uncompressed result bytes and the
emitted point structs. blitzar_tpu's helpers are plain numpy and
``jnp.asarray``: nothing compiles.
"""

import ctypes

import numpy as np
import pytest
import torch

from blitzar_tpu import capi_bridge as jbridge
from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu_torch import api
from blitzar_tpu_torch import capi_bridge as bridge
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.fields import fp25519 as F
from blitzar_tpu_torch.utils import limbs

P = 2**255 - 19
CURVES = {"bls12_381_g1": (wc.BLS12381_G1, jwc.BLS12381_G1), "bn254_g1": (wc.BN254_G1, jwc.BN254_G1),
          "grumpkin": (wc.GRUMPKIN, jwc.GRUMPKIN)}


@pytest.fixture(scope="module", autouse=True)
def cpu_backend():
    api.reset_backend_for_testing()
    api.init("cpu")
    yield
    api.reset_backend_for_testing()


def _buffer(data: bytes):
    return (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data + b"\0" * (len(data) == 0))


def _addr(buf) -> int:
    return ctypes.addressof(buf)


def _np(limb_tensor) -> np.ndarray:
    return np.asarray(limb_tensor).astype(np.int64)


@pytest.mark.parametrize("nbytes", [1, 2, 3, 4, 5, 7, 8, 12, 16, 24, 31, 32])
def test_descriptors_match(nbytes):
    rng = np.random.default_rng(nbytes)
    columns = [(nbytes, 9, False), (nbytes, 0, False), (min(nbytes, 16), 5, True), (nbytes, 1, nbytes <= 16)]
    data = [rng.integers(0, 256, size=n * nb, dtype=np.uint8).tobytes() for nb, n, _ in columns]
    bufs = [_buffer(d) for d in data]
    raw = b"".join(bytes([nb]) + bytes(7) + n.to_bytes(8, "little") + _addr(b).to_bytes(8, "little")
                   + int(s).to_bytes(4, "little") + b"\xaa" * 4 for (nb, n, s), b in zip(columns, bufs))
    table = _buffer(raw)
    got = bridge.parse_descriptors(_addr(table), len(columns))
    want = jbridge._parse_descriptors(_addr(table), len(columns))
    assert len(got) == len(want) == len(columns)
    for g, w, d in zip(got, want, data):
        assert (g.element_nbytes, g.n, g.is_signed) == (w.element_nbytes, w.n, w.is_signed)
        assert bytes(g.data) == bytes(w.data) == d
        assert g.rows().shape == (g.n, g.element_nbytes)


def _f51_struct(coords) -> bytes:
    """Four coordinate values (< 2^256) as 5 radix-2^51 words each; the top
    word takes the bits above 204 (52 of them for a value >= 2^255)."""
    return b"".join(((v >> (51 * i)) & ((1 << 51) - 1) if i < 4 else v >> 204).to_bytes(8, "little")
                    for v in coords for i in range(5))


def _f51_values(rng, n: int) -> list[list[int]]:
    """n points' four coordinate values, among them values >= p (p, p + 5,
    2^255 - 1, 2p - 1, 2^256 - 1) and the ones just below p."""
    edge = [P, P + 5, 2**255 - 1, 2 * P - 1, 2**256 - 1, P - 1, 0, 1]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") for _ in range(4 * n - len(edge))]
    return [vals[4 * i : 4 * i + 4] for i in range(n)]


def test_ristretto255_structs_match_wide_limbs():
    """Limbs that carry values >= p parse to the same canonical values."""
    pts = _f51_values(np.random.default_rng(1), 6)
    buf = _buffer(b"".join(_f51_struct(c) for c in pts))
    got = bridge.parse_ristretto255_points(_addr(buf), len(pts))
    want = jbridge._parse_ristretto255_points(_addr(buf), len(pts))
    for c, (g, w) in enumerate(zip(got, want)):
        g_ints = limbs.limbs_to_ints(g)
        assert g_ints == [v[c] % P for v in pts]
        assert g_ints == [v % P for v in limbs.limbs_to_ints(_np(w))]
        assert all(v < P for v in g_ints)


def test_ristretto255_emitted_structs_match():
    pts = _f51_values(np.random.default_rng(2), 5)
    buf = _buffer(b"".join(_f51_struct(c) for c in pts))
    points = bridge.parse_ristretto255_points(_addr(buf), len(pts))
    got = bridge.emit_ristretto255_points(points)
    want = jbridge._emit_ristretto255_points(jbridge._parse_ristretto255_points(_addr(buf), len(pts)))
    assert got.shape == (5, 160) and got.tobytes() == want
    one = bridge.emit_ristretto255_points(type(points)(*(c[:, 0] for c in points)))  # batch shape ()
    assert one.tobytes() == want[:160]


def _mont_bytes(v: int, k: int) -> bytes:
    return v.to_bytes(8 * k, "little")


def _affine_buffer(name: str, rng, n: int, infinity_at=()):
    curve, _ = CURVES[name]
    f = curve.field
    k = f.nbytes // 8
    out = b""
    for i in range(n):
        x, y = (int.from_bytes(rng.bytes(8 * k), "little") % f.modulus for _ in range(2))
        out += _mont_bytes(x, k) + _mont_bytes(y, k)
        if name != "bls12_381_g1":
            out += bytes([1 if i in infinity_at else 0]) + rng.bytes(7)  # padding is ignored
    return _buffer(out)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_affine_structs_match(name):
    """bls12-381 G1 {X[6], Y[6]}; bn254 G1 and Grumpkin {X[4], Y[4],
    infinity} with the flag set on some (the identity)."""
    curve, jcurve = CURVES[name]
    n, infinity_at = 7, (0, 3, 6)
    buf = _affine_buffer(name, np.random.default_rng(3), n, infinity_at)
    has_flag = name != "bls12_381_g1"
    got = bridge.parse_mont_affine_points(_addr(buf), n, curve)
    want = jbridge._parse_mont_affine_points(_addr(buf), n, jcurve, has_infinity=has_flag)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), _np(w))
    if has_flag:
        assert [curve.to_affine_ints(got)[i] for i in infinity_at] == [None] * len(infinity_at)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_p2_structs_and_their_emission_match(name):
    curve, jcurve = CURVES[name]
    f = curve.field
    k = f.nbytes // 8
    rng = np.random.default_rng(4)
    n = 6
    raw = b"".join(_mont_bytes(int.from_bytes(rng.bytes(8 * k), "little") % f.modulus, k) for _ in range(3 * n))
    buf = _buffer(raw)
    got = bridge.parse_mont_p2_points(_addr(buf), n, curve)
    want = jbridge._parse_mont_p2_points(_addr(buf), n, jcurve)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), _np(w))
    emitted = bridge.emit_mont_p2_points(got)
    out = (ctypes.c_uint8 * len(raw))()

    class Handle:
        pass

    handle = Handle()
    handle.curve = jcurve
    jbridge._emit_fixed_result(_addr(out), handle, want)
    assert emitted.tobytes() == bytes(out) == raw


@pytest.mark.parametrize("name", ["bn254_g1", "grumpkin"])
def test_uncompressed_result_bytes_match(name):
    """The API's standard-form (x, y, infinity) structs to the reference's
    Montgomery structs: blitzar_tpu's writer, fed the same structs."""
    curve, jcurve = CURVES[name]
    f = curve.field
    rng = np.random.default_rng(5)
    affine = np.zeros(5, dtype=[("x", np.uint8, f.nbytes), ("y", np.uint8, f.nbytes), ("infinity", np.uint8)])
    for i in range(5):
        if i in (1, 4):
            affine["infinity"][i] = 1
            continue
        for c in ("x", "y"):
            v = int.from_bytes(rng.bytes(f.nbytes), "little") % f.modulus
            affine[c][i] = np.frombuffer(v.to_bytes(f.nbytes, "little"), np.uint8)
    got = bridge.emit_uncompressed(curve, affine)
    out = (ctypes.c_uint8 * (72 * 5))()
    one_generator = _buffer(bytes(64) + b"\x01" + bytes(7))  # the writer parses its generators first
    jbridge._uncompressed_commitments(_addr(out), 0, 0, _addr(one_generator), 1, jcurve,
                                      lambda descriptors, generators: affine)
    assert got.shape == (5, 72) and got.tobytes() == bytes(out)
    assert got[1].tolist() == [0] * 64 + [1] + [0] * 7


def test_point_conversions_run_on_the_backends_device():
    """The structs' words reach the device as they are: the limbs of a
    parsed point lie on the backend's device, int32, canonical."""
    buf = _buffer(_f51_struct([P + 3, 2, 1, 2**255 - 1]))
    pt = bridge.parse_ristretto255_points(_addr(buf), 1)
    assert all(c.device == api.device() and c.dtype == torch.int32 for c in pt)
    assert torch.equal(F.canonicalize(pt.x), pt.x)
