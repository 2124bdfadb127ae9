"""The streamed build+query of blitzar_tpu_torch (msm/fixed.py, plain
versions on the CPU) against blitzar_tpu's ``streaming_multiexponentiation``
for ristretto255, and the engine's dispatch to it.

Both sides stream in small chunks (blitzar_tpu's ``STREAM_CHUNK_POINTS`` set
to 64 as tests/test_streaming.py does, the port's to 64 too) over n = 300
points, so the port's last chunk is short. blitzar_tpu compiles one chunk
program per (window, signed) shape on this host (~25-30 s each), so each
window runs its signed program only: once with the signs and once with no
sign set, which is its unsigned result (Q_pos - Q_neg with nothing
negative), against the port's signed and unsigned queries."""

import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.msm import engine as tengine
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.utils.limbs import from_jax_points

N = 300
RNG = np.random.default_rng(30)
SCALARS = RNG.integers(0, 256, size=(2, N, 4), dtype=np.uint8)
SIGNS = RNG.integers(0, 2, size=(2, N), dtype=np.uint8)


def _enc(p) -> np.ndarray:
    return trst.encode(p).numpy().T


def _enc_jax(p) -> np.ndarray:
    return _enc(from_jax_points(np.stack([np.asarray(c) for c in p]), device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(jfixed, "STREAM_CHUNK_POINTS", 64)
    monkeypatch.setattr(tfixed, "STREAM_CHUNK_POINTS", 64)


@pytest.fixture(scope="module")
def jgens():
    return jgen.ristretto_generators(N)


@pytest.fixture(scope="module")
def tgens(jgens):
    return from_jax_points(np.stack([np.asarray(c) for c in jgens]), device="cpu")


@pytest.fixture(scope="module")
def jax_results(jgens):
    """blitzar_tpu's streamed results per window: (unsigned, signed)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfixed, "STREAM_CHUNK_POINTS", 64)
        for w in (4, 8):
            unsigned = jfixed.streaming_multiexponentiation(jgens, SCALARS, window_width=w, signs=np.zeros_like(SIGNS))
            signed = jfixed.streaming_multiexponentiation(jgens, SCALARS, window_width=w, signs=SIGNS)
            out[w] = (_enc_jax(unsigned), _enc_jax(signed))
    return out


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_streaming_matches_blitzar_tpu(jax_results, tgens, w, signed):
    got = tfixed.streaming_multiexponentiation(tgens, SCALARS, window_width=w, signs=SIGNS if signed else None)
    assert np.array_equal(_enc(got), jax_results[w][signed])


def test_streaming_matches_the_oracle(tgens):
    """A third output set at w = 8 through the port alone (n = 300 in 64-point
    chunks), against the refimpl's naive MSM."""
    scalars = np.random.default_rng(31).integers(0, 256, size=(1, N, 2), dtype=np.uint8)
    got = _enc(tfixed.streaming_multiexponentiation(tgens, scalars))
    ints = [int.from_bytes(bytes(scalars[0, i]), "little") for i in range(N)]
    assert bytes(got[0]) == R.ristretto_encode(R.naive_msm(ints, R.get_generators(N)))


@pytest.fixture(scope="module")
def handle_100(tgens):
    """The handle path's signed result over the first 100 points."""
    handle = tfixed.MultiexpHandle(tgens, n=100)
    return _enc(tfixed.fixed_multiexponentiation_signed(handle, SCALARS[:, :100], SIGNS[:, :100]))


@pytest.mark.parametrize("chunk", [8, 64, 1 << 18])
def test_chunking_leaves_the_point(monkeypatch, tgens, handle_100, chunk):
    """The point is the same however the chunks fall: one group a chunk,
    64-point chunks with a short last one, one chunk."""
    monkeypatch.setattr(tfixed, "STREAM_CHUNK_POINTS", chunk)
    got = tfixed.streaming_multiexponentiation(tgens, SCALARS[:, :100], signs=SIGNS[:, :100])
    assert np.array_equal(_enc(got), handle_100)


class _Spy:
    """Counts the engine's streamed MSMs."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = tfixed.streaming_multiexponentiation

        def spy(*args, **kwargs):
            self.calls += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(tfixed, "streaming_multiexponentiation", spy)


def test_engine_streams_above_its_threshold(monkeypatch, tgens):
    """Above STREAM_ABOVE (2^20, here 64) the engine streams every MSM and
    builds no handle; the result equals the handle path's."""
    monkeypatch.setattr(tengine, "STREAM_ABOVE", 64)
    spy = _Spy(monkeypatch)
    tengine.clear_handle_cache()
    data = [SCALARS[o, :100] for o in range(2)]
    for _ in range(2):
        got = tengine.msm(tgens, data, [4, 4], [False, False])
    assert spy.calls == 2 and not tengine._HANDLE_CACHE
    handle = tfixed.MultiexpHandle(tgens, n=100, window_width=4)
    assert np.array_equal(_enc(got), _enc(tfixed.fixed_multiexponentiation(handle, SCALARS[:, :100])))


def test_small_n_takes_the_handle_from_the_first_msm(monkeypatch, tgens):
    """A fresh small generator set builds its handle on its first MSM and
    reuses it on the second (blitzar_tpu streams that first MSM instead,
    its engine.py:380-412); both give the streamed path's point, signed and
    unsigned."""
    spy = _Spy(monkeypatch)
    tengine.clear_handle_cache()
    gens = type(tgens)(*(c[:, :40].clone() for c in tgens))
    data = [SCALARS[o, :40] for o in range(2)]
    first = tengine.msm(gens, data, [4, 4], [False, True])
    assert spy.calls == 0 and len(tengine._HANDLE_CACHE) == 1
    second = tengine.msm(gens, data, [4, 4], [False, True])
    assert spy.calls == 0 and len(tengine._HANDLE_CACHE) == 1
    scalars, signs, _ = tengine.prepare_scalars(data, [4, 4], [False, True])
    streamed = tfixed.streaming_multiexponentiation(gens, scalars, signs=signs)
    assert np.array_equal(_enc(first), _enc(second)) and np.array_equal(_enc(first), _enc(streamed))
    tengine.clear_handle_cache()
