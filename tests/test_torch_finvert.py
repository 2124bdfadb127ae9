"""finvert.cu's batch inversion (csrc/field_batch.cuh: a thread's strided
elements by Montgomery's trick, zeros left out), run by csrc/host_harness.cpp
tile by tile as the kernel runs them, against blitzar_tpu's elementwise
``F.invert`` as canonical values: 0, p, 2p and limbs that reduce to 0 give
0; values above 2^255 and limbs up to 2^17 reduce first; counts that are not
a multiple of a thread's elements leave short lanes and empty ones. The
wrapper's checks too (its plain version on the CPU)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.ops import cuda_field
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints, to_tensor

import torch_host_harness

P = 2**255 - 19
# the limbs of 0 a batch inversion must leave out: 0, p, 2p, p with its
# lowest limb carried from the next (limbs below 2^17)
P_LIMBS = [0xFFED] + [0xFFFF] * 14 + [0x7FFF]
JAX_WIDTH = 3072
ZERO_FORMS = [[0] * 16, P_LIMBS, [0xFFDA] + [0xFFFF] * 15, [0x1FFED, 0xFFFE] + [0xFFFF] * 13 + [0x7FFF]]


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _operands(count: int, seed: int, wide: bool = False) -> np.ndarray:
    """(16, count) limbs: random 16-bit ones, every 5th element a form of 0
    in turn (16-bit limbs only: 0, p, 2p), every 7th above 2^255, the last
    40 zeros; ``wide``: those 7th with limbs up to 2^17 (values up to 2^257,
    the port's invariant) and p with a carried limb among the zeros."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(16, count)).astype(np.int64)
    high = np.arange(0, count, 7)
    a[:, high] = rng.integers(0, 1 << (17 if wide else 16), size=(16, len(high)))
    a[15, high] |= 0x8000
    forms = np.array(ZERO_FORMS if wide else ZERO_FORMS[:3]).T
    zeros = np.arange(3, count, 5)
    a[:, zeros] = forms[:, np.arange(len(zeros)) % forms.shape[1]]
    a[:, max(0, count - 40):] = 0
    return a


def _host_finvert(harness, a: np.ndarray, per: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.int32)
    out = np.zeros_like(a)
    rc = harness.btt_host_finvert(ctypes.c_void_p(a.ctypes.data), ctypes.c_int64(a.shape[1]), ctypes.c_int(per),
                                  ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return out


_JAX_INVERT = jax.jit(lambda x: JF.canonicalize(JF.invert(x)))


def _jax_invert(a: np.ndarray) -> np.ndarray:
    """blitzar_tpu's F.invert, canonical, on a batch padded with zeros to
    ``JAX_WIDTH`` elements (one shape for every case: one compile)."""
    padded = np.zeros((16, JAX_WIDTH), np.uint32)
    padded[:, : a.shape[1]] = a
    return np.asarray(_JAX_INVERT(jnp.asarray(padded))).astype(np.int64)[:, : a.shape[1]]


def _value(limbs: np.ndarray) -> list[int]:
    return [sum(int(limbs[l, i]) << (16 * l) for l in range(16)) for i in range(limbs.shape[1])]


@pytest.mark.parametrize("count, per", [(1000, 16), (1000, 32), (1000, 64), (5, 16), (2048, 32), (3000, 64)])
def test_batch_finvert_body_matches_jax(harness, count, per):
    """The harness's tiles of 32 x per elements (count not a multiple of
    them: short lanes, and lanes with nothing), every output canonical and
    blitzar_tpu's F.invert of its element (16-bit limbs, its invariant)."""
    a = _operands(count, count + per)
    got = _host_finvert(harness, a, per)
    assert np.array_equal(got, _jax_invert(a))
    vals = _value(a)
    assert _value(got) == [pow(v % P, P - 2, P) for v in vals]
    assert all(g == 0 for g, v in zip(_value(got), vals) if v % P == 0)


@pytest.mark.parametrize("per", [16, 64])
def test_batch_finvert_body_on_wide_limbs(harness, per):
    """Limbs up to 2^17 (values up to 2^257) and p with a carried limb: the
    inverse of the value mod p, canonical, and the plain version's."""
    a = _operands(1500, per, wide=True)
    got = _host_finvert(harness, a, per)
    assert got.max() < 1 << 16
    assert _value(got) == [pow(v % P, P - 2, P) for v in _value(a)]
    assert np.array_equal(got, TF.canonicalize(cuda_field.finvert_plain(to_tensor(a))).numpy())


def test_batch_finvert_all_zero_and_one_lane(harness):
    """A batch of zeros alone (every product empty), and p, 2p, p with a
    carried limb, each alone in its lane: all 0; one nonzero element in a
    lane of zeros is inverted."""
    forms = np.array(ZERO_FORMS, dtype=np.int64).T
    a = np.concatenate([np.zeros((16, 64), np.int64), forms, np.asarray(ints_to_limbs([7, P + 7]))], axis=1)
    got = _host_finvert(harness, a, 16)
    vals = _value(got)
    assert vals[: 64 + len(ZERO_FORMS)] == [0] * (64 + len(ZERO_FORMS))
    assert vals[-2:] == [pow(7, P - 2, P)] * 2


def test_finvert_wrapper_checks_and_plain():
    """On the CPU the wrapper runs the plain version, on a (16, count) batch
    and on a strided (16, 2, count) one; a batch without 16 limbs raises."""
    a = to_tensor(_operands(70, 3, wide=True))
    want = [pow(v % P, P - 2, P) for v in _value(a.numpy().astype(np.int64))]
    assert limbs_to_ints(TF.canonicalize(cuda_field.finvert(a))) == want
    pair = torch.stack([a, a], dim=1)
    assert limbs_to_ints(TF.canonicalize(cuda_field.finvert(pair)[:, 1])) == want
    with pytest.raises(ValueError):
        cuda_field.finvert(torch.zeros((8, 4), dtype=torch.int32))
