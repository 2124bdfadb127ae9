"""The bucket engine of blitzar_tpu_torch.msm.engine (plain path) against
blitzar_tpu: the plain doubling, choose_capacity and the digits; through the
API with BLITZAR_TPU_TORCH_MSM_ENGINE=bucket, the upstream vectors, signed
and mixed-width outputs and a skewed column against the default engine, and
bn254 G1 against the oracle. blitzar_tpu's own msm_jit compiles for minutes
here; the one comparison with it is under ``-m slow``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import engine as jengine
from blitzar_tpu_torch import api
from blitzar_tpu_torch import generators as tgen
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.msm import engine as tengine
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points
from vectors import RUST_DATA, RUST_EXPECTED


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small ops: one thread a worker keeps
    the parallel test run from oversubscribing the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bucket(monkeypatch):
    api.reset_backend_for_testing()
    api.init("cpu")
    monkeypatch.setenv(tengine.ENGINE_VAR, "bucket")
    yield monkeypatch
    api.reset_backend_for_testing()


def _descs(rows_list, nbytes, signed):
    out = []
    for vals in rows_list:
        data = np.zeros((len(vals), nbytes), np.uint8)
        for i, v in enumerate(vals):
            data[i] = np.frombuffer((int(v) % (1 << (8 * nbytes))).to_bytes(nbytes, "little"), np.uint8)
        out.append(api.SequenceDescriptor(nbytes, len(vals), data, signed))
    return out


def _both_engines(monkeypatch, run):
    """(bucket engine's result, the default engine's result) of run()."""
    got = run()
    monkeypatch.delenv(tengine.ENGINE_VAR)
    tengine.clear_handle_cache()
    return got, run()


def test_plain_double_matches_jax():
    """ed_double's plain twin against blitzar_tpu's _double_impl, the
    identity among the points: canonical limbs."""
    pts = tgen.ristretto_generators(63, 5, "cpu")
    pts = ted.cat([ted.identity((1,)), pts])
    want = jed._double_impl(jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(pts))))
    got = cuda_point.ed_double_plain(pts)
    assert np.array_equal(to_jax_points(got), np.stack([np.asarray(JF.canonicalize(c)) for c in want]))
    assert torch.equal(ted.double(pts).x, got.x)


def test_choose_capacity_and_digits_match_jax():
    for n in list(range(1, 70)) + [255, 256, 1000, 4096, 65536, 100000, 1 << 20, (1 << 20) + 3, 1 << 24]:
        assert tengine.choose_capacity(n) == jengine.choose_capacity(n), n
    scalars = np.random.default_rng(2).integers(0, 256, size=(3, 10, 5), dtype=np.uint8)
    got = tengine.digit_decompose(torch.from_numpy(scalars))
    assert np.array_equal(got.numpy(), np.asarray(jengine.digit_decompose(jnp.asarray(scalars))))


def test_rust_vectors_through_the_bucket_engine(bucket):
    calls = []
    inner = tengine.bucket_msm
    bucket.setattr(tengine, "bucket_msm", lambda *a, **k: calls.append(1) or inner(*a, **k))
    got = api.compute_curve25519_commitments(_descs(RUST_DATA, 4, False))
    assert [bytes(g) for g in got] == RUST_EXPECTED and calls == [1]


def test_signed_mixed_widths_match_default_engine(bucket):
    """Three outputs: signed 16-byte (the boundaries among them), unsigned
    2-byte over fewer generators, signed 1-byte; n = 37 pads to 64."""
    rng = np.random.default_rng(8)
    s16 = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, size=37)]
    s16[:4] = [-(1 << 127), (1 << 127) - 1, -1, 0]
    descs = (_descs([s16], 16, True) + _descs([[int(v) for v in rng.integers(0, 1 << 16, size=20)]], 2, False)
             + _descs([[int(v) for v in rng.integers(-128, 128, size=37)]], 1, True))
    got, want = _both_engines(bucket, lambda: api.compute_curve25519_commitments(descs))
    assert np.array_equal(got, want)


def test_skewed_column_takes_several_rounds(bucket):
    """Every scalar equal: one bucket a window holds all 40 points, against
    C = 16 slots, so the accumulation runs three rounds."""
    rounds = []
    inner = tengine.bucket_accumulate
    bucket.setattr(tengine, "bucket_accumulate",
                   lambda p, d, *a: rounds.append(int(torch.bincount(d[0]).max())) or inner(p, d, *a))
    assert tengine.choose_capacity(40) == 16
    descs = _descs([[0x0305] * 40], 2, False)
    got, want = _both_engines(bucket, lambda: api.compute_curve25519_commitments(descs))
    assert np.array_equal(got, want) and max(rounds) == 40


def test_bn254_g1_through_the_bucket_engine(bucket):
    """bn254 G1 at n = 13 (pads to 16): a signed and an unsigned column
    against the oracle's sums; the Horner doublings on wdouble's plain twin."""
    curve = twc.BN254_G1
    pts = curve.oracle.random_points(13, seed=4)
    rng = np.random.default_rng(9)
    s4 = [int(v) for v in rng.integers(-(1 << 31), 1 << 31, size=13)]
    u3 = [int(v) for v in rng.integers(0, 1 << 24, size=13)]
    gens = curve.from_affine_ints(pts, "cpu")
    got = tengine.msm(gens, [d.rows() for d in _descs([s4], 4, True) + _descs([u3], 3, False)], [4, 3],
                      [True, False], curve=curve)
    assert curve.to_affine_ints(got) == [curve.oracle.msm(s4, pts), curve.oracle.msm(u3, pts)]


def test_default_engine_is_the_partition_table(monkeypatch):
    monkeypatch.delenv(tengine.ENGINE_VAR, raising=False)
    monkeypatch.setattr(tengine, "bucket_msm", lambda *a, **k: pytest.fail("bucket engine without its variable"))
    gens = tgen.ristretto_generators(8, 0, "cpu")
    tengine.msm(gens, [np.ones((8, 1), np.uint8)], [1], [False])


@pytest.mark.slow
def test_bucket_engine_matches_jax_msm_jit():
    """blitzar_tpu's bucket engine (msm_jit, compiled for this shape) and the
    port's on the same digits: two signed 2-byte outputs at n = 16."""
    from blitzar_tpu import generators as jgen

    n = 16
    rng = np.random.default_rng(10)
    scalars = rng.integers(0, 256, size=(2, n, 2), dtype=np.uint8)
    signs = rng.integers(0, 2, size=(2, n), dtype=np.uint8)
    jg = jgen.ristretto_generators(n)
    want = jengine.msm_jit(jg, jengine.digit_decompose(jnp.asarray(scalars)), jnp.asarray(signs),
                           num_outputs=2, num_windows=2, capacity=jengine.choose_capacity(n))
    tg = from_jax_points(np.stack([np.asarray(c) for c in jg]), device="cpu")
    got = tengine.msm_digits(tg, tengine.digit_decompose(torch.from_numpy(scalars)), torch.from_numpy(signs), 2, 2,
                             tengine.choose_capacity(n))
    want_t = from_jax_points(np.stack([np.asarray(JF.canonicalize(c)) for c in want]), device="cpu")
    assert np.array_equal(trst.encode(got).numpy(), trst.encode(want_t).numpy())
