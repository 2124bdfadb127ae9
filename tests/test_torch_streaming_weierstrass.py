"""The streamed build+query of blitzar_tpu_torch for bn254 G1 (plain versions
on the CPU) against blitzar_tpu's ``streaming_multiexponentiation(...,
curve=BN254_G1)`` at n = 96, both streaming in small chunks (64 points; the
port's last chunk is short). blitzar_tpu compiles its signed chunk program
once (~70 s on this host): it runs with the signs and with no sign set,
which is its unsigned result, against the port's signed and unsigned
queries; the comparison is of affine points."""

import numpy as np
import pytest
import torch

from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.msm import engine as tengine
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.utils.limbs import from_jax_points

N = 96
TC, JC = twc.BN254_G1, jwc.BN254_G1
RNG = np.random.default_rng(40)
SCALARS = RNG.integers(0, 256, size=(2, N, 8), dtype=np.uint8)
SIGNS = RNG.integers(0, 2, size=(2, N), dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def points():
    return TC.oracle.random_points(N - 1, seed=41) + [None]


@pytest.fixture(scope="module")
def jax_results(points):
    """blitzar_tpu's streamed results as affine ints: (unsigned, signed)."""
    jp = JC.from_affine_ints(points)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfixed, "STREAM_CHUNK_POINTS", 64)
        for signs in (np.zeros_like(SIGNS), SIGNS):
            res = jfixed.streaming_multiexponentiation(jp, SCALARS, curve=JC, signs=signs)
            out.append(TC.to_affine_ints(from_jax_points(np.stack([np.asarray(c) for c in res]), device="cpu")))
    return out


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_streaming_matches_blitzar_tpu(monkeypatch, points, jax_results, signed):
    monkeypatch.setattr(tfixed, "STREAM_CHUNK_POINTS", 64)
    got = tfixed.streaming_multiexponentiation(
        TC.from_affine_ints(points, "cpu"), SCALARS, curve=TC, signs=SIGNS if signed else None)
    assert TC.to_affine_ints(got) == jax_results[signed]


def test_engine_streams_weierstrass_above_its_threshold(monkeypatch, points):
    """Through the engine (STREAM_ABOVE lowered to 64) against the oracle:
    one signed 8-byte column."""
    monkeypatch.setattr(tfixed, "STREAM_CHUNK_POINTS", 64)
    monkeypatch.setattr(tengine, "STREAM_ABOVE", 64)
    tengine.clear_handle_cache()
    vals = [int(v) for v in RNG.integers(-(1 << 62), 1 << 62, size=N)]
    rows = np.stack([np.frombuffer((v % (1 << 64)).to_bytes(8, "little"), np.uint8) for v in vals])
    got = tengine.msm(TC.from_affine_ints(points, "cpu"), [rows], [8], [True], curve=TC)
    assert not tengine._HANDLE_CACHE
    assert TC.to_affine_ints(got) == [TC.oracle.msm(vals, points)]
