"""The ristretto255 encode and decode of csrc/ristretto.cu (the bodies in
csrc/edwards25519.cuh, run by csrc/host_harness.cpp) and the CPU wrappers
``cuda_point.ristretto_encode`` / ``ristretto_decode`` against
blitzar_tpu's ``curves.ristretto.encode`` / ``decode`` on the same points
and bytes: encodings equal byte for byte, valid flags equal exactly, valid
slots equal as canonical points. The points hold the identity, the RFC 9496
basepoint multiples, sums of the plain add (z far from 1) and the same
sums with p or 2p added to each coordinate's limbs (unreduced, limbs near
2^17); the bytes hold an invalid encoding of each kind."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.curves import ristretto as jrst
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import to_jax_points, to_tensor
from vectors import RISTRETTO_BASEPOINT_MULTIPLES

import torch_host_harness

P = TF.P
COUNT = 24  # seeded generator pairs: COUNT sums and COUNT wide-limb points
P_LIMBS = [0xFFED] + [0xFFFF] * 14 + [0x7FFF]  # p
TWO_P_LIMBS = [0xFFDA] + [0xFFFF] * 15  # 2p = 2^256 - 38


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _rfc_bytes() -> np.ndarray:
    return np.stack([np.frombuffer(bytes.fromhex(h), np.uint8) for h in RISTRETTO_BASEPOINT_MULTIPLES], axis=1)


@pytest.fixture(scope="module")
def points() -> ted.PointP3:
    """The identity, the RFC 9496 multiples, COUNT plain-add sums of seeded
    elligator points scaled by random factors, and the same sums as
    canonical limbs plus p (x, y, t) or 2p (z)."""
    rng = np.random.default_rng(15)
    r = rng.integers(0, 1 << 16, size=(4, 16, COUNT)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    a = cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1]))
    b = cuda_point.elligator_form_plain(to_tensor(r[2]), to_tensor(r[3]))
    k = to_tensor(rng.integers(1, 1 << 16, size=(16, COUNT)))
    sums = ted._add_impl(ted.PointP3(*(TF.mul(c, k) for c in a)), b)
    p, two_p = (torch.tensor(v, dtype=torch.int32)[:, None] for v in (P_LIMBS, TWO_P_LIMBS))
    canon = [TF.canonicalize(c) for c in sums]
    wide = ted.PointP3(canon[0] + p, canon[1] + p, canon[2] + two_p, canon[3] + p)
    rfc, valid = trst.decode(torch.from_numpy(_rfc_bytes()))
    assert bool(valid.all())
    pts = ted.cat([ted.identity((1,)), rfc, sums, wide])
    assert int(max(c.max() for c in wide)) >= 1 << 16
    assert int(min(c.min() for c in pts)) >= 0 and int(max(c.max() for c in pts)) < 1 << 17
    return pts


def _host_encode(harness, pts: ted.PointP3) -> np.ndarray:
    n = pts.x.shape[1]
    coords = np.ascontiguousarray(np.stack([c.numpy() for c in pts]))
    out = np.zeros((32, n), np.uint8)
    harness.btt_host_ristretto_encode(ctypes.c_void_p(coords.ctypes.data), ctypes.c_int64(n),
                                      ctypes.c_void_p(out.ctypes.data))
    return out


def _host_decode(harness, data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    data = np.ascontiguousarray(data)
    n = data.shape[1]
    out = np.zeros((4, 16, n), np.int32)
    valid = np.zeros(n, np.uint8)
    harness.btt_host_ristretto_decode(ctypes.c_void_p(data.ctypes.data), ctypes.c_int64(n),
                                      ctypes.c_void_p(out.ctypes.data), ctypes.c_void_p(valid.ctypes.data))
    return out, valid.astype(bool)


def test_encode_body_matches_jax(harness, points):
    """blitzar_tpu's encode (on canonical limbs of the same points), the
    plain version, the wrapper on a CPU tensor and the harness's body: the
    same bytes; the identity is 32 zero bytes, the RFC multiples their
    vectors."""
    want = np.asarray(jrst.encode(jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(points)))))
    assert np.array_equal(cuda_point.ristretto_encode_plain(points).numpy(), want)
    assert np.array_equal(cuda_point.ristretto_encode(points).numpy(), want)
    host = _host_encode(harness, points)
    assert np.array_equal(host, want)
    assert not host[:, 0].any()
    assert np.array_equal(host[:, 1 : 1 + len(RISTRETTO_BASEPOINT_MULTIPLES)], _rfc_bytes())


def test_encode_wrapper_takes_batch_shapes(points):
    """A (2, m) batch and a strided view encode as their flat batch."""
    n = points.x.shape[1] // 2 * 2
    flat = cuda_point.ristretto_encode(ted.index_batch(points, slice(0, n))).numpy()
    grid = ted.reshape_batch(ted.index_batch(points, slice(0, n)), (2, n // 2))
    assert np.array_equal(cuda_point.ristretto_encode(grid).numpy().reshape(32, n), flat)
    strided = ted.PointP3(*(c[:, 0:n:2] for c in points))
    assert np.array_equal(cuda_point.ristretto_encode(strided).numpy(), flat[:, 0::2])


def _fe_sqrt(x: int) -> int | None:
    """A square root of x mod p, or None."""
    r = pow(x, (P + 3) // 8, P)
    if (r * r - x) % P:
        r = r * trst.SQRT_M1 % P
    return r if (r * r - x) % P == 0 else None


def _reason(s: int) -> str:
    """Why an even canonical s fails to decode, or "valid" (RFC 9496 §4.3.1
    in Python ints)."""
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    v = (-trst.D_INT * u1 * u1 - u2 * u2) % P
    w = v * u2 * u2 % P
    if w == 0 or _fe_sqrt(pow(w, P - 2, P)) is None:
        return "not_square"
    inv_sqrt = trst._fe_abs_int(_fe_sqrt(pow(w, P - 2, P)))
    den_x = inv_sqrt * u2 % P
    den_y = inv_sqrt * den_x * v % P
    x = trst._fe_abs_int(2 * s * den_x)
    y = u1 * den_y % P
    if (x * y % P) & 1:
        return "negative_t"
    return "y_zero" if y == 0 else "valid"


def _le(value: int) -> np.ndarray:
    return np.frombuffer(value.to_bytes(32, "little"), np.uint8)


def _invalid_bytes() -> dict:
    """One encoding of each kind of invalid (and s = 0, the identity)."""
    found = {}
    s = 2
    while len(found) < 3:
        found.setdefault(_reason(s), s)
        s += 2
    top = _rfc_bytes()[:, 2].copy()
    top[31] |= 0x80
    return {
        "s_is_p_plus_1": _le(P + 1), "s_is_2^255_minus_2": _le(2**255 - 2), "all_ones": np.full(32, 0xFF, np.uint8),
        "odd": _le(2 * found["valid"] + 1), "one": _le(1), "top_bit": top,
        "not_square": _le(found["not_square"]), "negative_t": _le(found["negative_t"]),
        "y_zero": _le(P - 1), "zero": _le(0),
    }


def test_invalid_kinds_are_what_they_say():
    assert _reason(P - 1) == "y_zero"
    kinds = _invalid_bytes()
    assert _reason(int.from_bytes(bytes(kinds["not_square"]), "little")) == "not_square"
    assert _reason(int.from_bytes(bytes(kinds["negative_t"]), "little")) == "negative_t"


def test_decode_body_matches_jax(harness, points):
    """Encodings of the points, then one invalid encoding of each kind:
    blitzar_tpu's decode, the plain version, the wrapper on a CPU tensor and
    the harness's body give the same valid flags, and the same canonical
    points in the valid slots; the harness's points encode back to the
    bytes."""
    kinds = _invalid_bytes()
    good = cuda_point.ristretto_encode_plain(points).numpy()
    data = np.concatenate([good, np.stack(list(kinds.values()), axis=1)], axis=1)
    jpts, jvalid = jrst.decode(jnp.asarray(data))
    jvalid = np.asarray(jvalid)
    expect = [True] * good.shape[1] + [k == "zero" for k in kinds]
    assert jvalid.tolist() == expect
    want = np.stack([np.asarray(JF.canonicalize(c)) for c in jpts]).astype(np.int64)

    host, host_valid = _host_decode(harness, data)
    assert host_valid.tolist() == expect
    assert np.array_equal(host[:, :, jvalid], want[:, :, jvalid])
    for got_pts, got_valid in (cuda_point.ristretto_decode_plain(torch.from_numpy(data)),
                               cuda_point.ristretto_decode(torch.from_numpy(data))):
        assert got_valid.tolist() == expect
        canon = np.stack([TF.canonicalize(c).numpy() for c in got_pts])
        assert np.array_equal(canon[:, :, jvalid], want[:, :, jvalid])
    back = _host_encode(harness, ted.PointP3(*(torch.from_numpy(c[:, jvalid]) for c in host)))
    assert np.array_equal(back, data[:, jvalid])


def test_decode_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="expected"):
        cuda_point.ristretto_decode(torch.zeros((31, 2), dtype=torch.uint8))
    with pytest.raises(ValueError, match="expected"):
        cuda_point.ristretto_decode(torch.zeros((32, 2), dtype=torch.int32))
