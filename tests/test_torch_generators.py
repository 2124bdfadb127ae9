"""blitzar_tpu_torch.generators against blitzar_tpu.generators: the
xorshift128+ limbs, the derived generators at two offsets, the prefix cache
and the one commitment."""

import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch import generators as tgen
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.utils.limbs import to_jax_points


def _canon_jax(p) -> np.ndarray:
    from blitzar_tpu.fields import fp25519 as JF

    return np.stack([np.asarray(JF.canonicalize(c)) for c in p]).astype(np.uint32)


def test_xorshift_limbs_match_jax():
    """The port derives in torch int64 (32-bit halves), blitzar_tpu in numpy
    uint64: the same limbs, the indices' top bit and wrap included."""
    tops = np.array([2**32 - 1, 2**32, 2**40 + 3, 2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)
    idx = np.concatenate([np.arange(50, dtype=np.uint64), tops])
    got = tgen._xorshift_limbs(torch.from_numpy(idx.view(np.int64)))
    want = jgen._xorshift_limbs(idx)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy().astype(np.uint32), w)


@pytest.mark.parametrize("offset", [0, 5])
def test_generators_match_jax(offset):
    got = tgen.ristretto_generators(40, offset, device="cpu")
    want = jgen.ristretto_generators(40, offset=offset)
    assert np.array_equal(to_jax_points(got), _canon_jax(want))


def test_prefix_cache_and_one_commitment():
    tgen.CACHE.reset()
    a = tgen.get_precomputed_generators(6, 2, device="cpu")
    b = tgen.get_precomputed_generators(6, 2, device="cpu")
    assert a.x is b.x  # identical requests return the same tensors
    full = tgen.get_precomputed_generators(8, 0, device="cpu")
    assert np.array_equal(to_jax_points(ted.index_batch(full, slice(2, 8))), to_jax_points(a))
    one = tgen.one_commitment(7, device="cpu")
    acc = R.IDENTITY
    for i in range(7):
        acc = R.pt_add(acc, R.compute_base_element(i))
    enc = trst.encode(ted.PointP3(*(c[:, None] for c in one)))
    assert bytes(enc[:, 0].numpy()) == R.ristretto_encode(acc)
    assert bytes(trst.encode(tgen.one_commitment(0, device="cpu")).numpy()) == bytes(32)
    tgen.CACHE.reset()


def test_one_commitment_pads_its_lanes(monkeypatch):
    """n not a multiple of the lane count: identities fill the last row."""
    monkeypatch.setattr(tgen, "_ONE_COMMIT_LANES", 3)
    tgen.CACHE.reset()
    acc = R.IDENTITY
    for i in range(7):
        acc = R.pt_add(acc, R.compute_base_element(i))
    one = tgen.one_commitment(7, device="cpu")
    enc = trst.encode(ted.PointP3(*(c[:, None] for c in one)))
    assert bytes(enc[:, 0].numpy()) == R.ristretto_encode(acc)
    tgen.CACHE.reset()
