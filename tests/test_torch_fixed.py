"""blitzar_tpu_torch.msm.fixed (plain path) against blitzar_tpu.msm.fixed:
the partition table, the bit-row products, the doubling combine, unsigned
and signed queries, and a handle carried over from blitzar_tpu's table.

Shapes follow tests/test_fixed.py (n = 12, w = 4, 4-byte scalars) and
tests/test_engine_conformance.py (n = 40, the default w = 8, 16-byte signed
scalars), so blitzar_tpu compiles nothing those tests do not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.msm import engine as jengine
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.msm import engine as tengine
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import from_jax_points, handle_from_jax_table, to_jax_points

N, W = 12, 4
JGENS = jgen.ristretto_generators(N)
TGENS = from_jax_points(np.stack([np.asarray(c) for c in JGENS]), device="cpu")
SCALARS = np.random.default_rng(5).integers(0, 256, size=(2, N, 4), dtype=np.uint8)


def _canon_jax(p) -> np.ndarray:
    from blitzar_tpu.fields import fp25519 as JF

    return np.stack([np.asarray(JF.canonicalize(c)) for c in p]).astype(np.uint32)


def _enc_jax(p) -> np.ndarray:
    """Encodings of blitzar_tpu points, by the port's encoder (held against
    blitzar_tpu's in tests/test_torch_curve.py; far cheaper on this host)."""
    return _enc(from_jax_points(np.stack([np.asarray(c) for c in p]), device="cpu"))


def _enc(p) -> np.ndarray:
    return trst.encode(p).numpy().T


@pytest.fixture(scope="module")
def handles():
    return jfixed.MultiexpHandle(JGENS, window_width=W), tfixed.MultiexpHandle(TGENS, window_width=W)


def test_table_matches_jax_point_table(handles):
    jh, th = handles
    assert th.table.shape == (N // W, 1 << W, 3, 8)
    assert np.array_equal(to_jax_points(th.point_table()), _canon_jax(jh._point_table()))


def test_products_and_combine_match_jax(handles, monkeypatch):
    """At w = 4 (16 entries a group) both packages take their few-row query
    (blitzar_tpu its one-hot einsum on the CPU): equal products."""
    jh, th = handles
    num_outputs, n, nbytes = SCALARS.shape
    nbits = 8 * nbytes
    rows = jfixed._bits_from_bytes(SCALARS).reshape(num_outputs * nbits, n)
    jprod = jfixed._partition_products(jh.t_split, jnp.asarray(rows), W)
    calls = []
    inner = tfixed.fewrow_products
    monkeypatch.setattr(tfixed, "fewrow_products", lambda *a, **k: calls.append(1) or inner(*a, **k))
    tprod = tfixed.partition_products(th, torch.from_numpy(SCALARS))
    assert calls == [1] and not tfixed.lookup_msm_fits(th.num_groups, 1 << W, num_outputs * nbits)
    assert np.array_equal(_enc(tprod), _enc_jax(jprod))
    # the combine on the very same products: same ladder, same coordinates
    jp = jed.reshape_batch(jprod, (num_outputs, nbits))
    got = tfixed.doubling_combine(from_jax_points(_canon_jax(jprod), device="cpu"), num_outputs, nbits)
    want = jfixed._doubling_combine(jp, nbits)
    assert np.array_equal(to_jax_points(got), _canon_jax(want))


def test_unsigned_query_matches_jax(handles):
    jh, th = handles
    got = tfixed.fixed_multiexponentiation(th, SCALARS)
    want = jfixed.fixed_multiexponentiation(jh, SCALARS)
    assert np.array_equal(_enc(got), _enc_jax(want))


def test_signed_query_matches_jax():
    n = 40
    rng = np.random.default_rng(9)
    mags = rng.integers(0, 256, size=(12, n, 16), dtype=np.uint8)
    mags[:, :, 15] &= 0x7F
    signs = rng.integers(0, 2, size=(12, n), dtype=np.uint8)
    jg = jgen.ristretto_generators(n)
    tg = from_jax_points(np.stack([np.asarray(c) for c in jg]), device="cpu")
    want = jfixed.fixed_multiexponentiation_signed(jfixed.MultiexpHandle(jg, n=n), mags, signs)
    got = tfixed.fixed_multiexponentiation_signed(tfixed.MultiexpHandle(tg, n=n), mags, signs)
    assert np.array_equal(_enc(got), _enc_jax(want))


def test_handle_from_jax_table(handles):
    jh, th = handles
    coords = [np.asarray(c) for c in jh._point_table()]
    carried = handle_from_jax_table(*coords, n=N, device="cpu")
    assert carried.window_width == W and carried.n == N
    assert torch.equal(carried.table, th.table)
    got = tfixed.fixed_multiexponentiation(carried, SCALARS)
    assert np.array_equal(_enc(got), _enc_jax(jfixed.fixed_multiexponentiation(jh, SCALARS)))


@pytest.mark.parametrize("n", [1, 10])
def test_window_padding_matches_oracle(n):
    """n not a multiple of w: identity padding, zero scalars select entry 0."""
    gens = ted.index_batch(TGENS, slice(0, n))
    handle = tfixed.MultiexpHandle(gens, window_width=W)
    assert handle.num_groups == -(-n // W)
    vals = [[int(v) for v in row] for row in np.random.default_rng(n).integers(0, 1 << 16, size=(2, n))]
    scalars = np.stack([[np.frombuffer(v.to_bytes(2, "little"), np.uint8) for v in row] for row in vals])
    got = _enc(tfixed.fixed_multiexponentiation(handle, scalars))
    oracle = [R.compute_base_element(i) for i in range(n)]
    assert [bytes(g) for g in got] == [R.ristretto_encode(R.naive_msm(row, oracle)) for row in vals]


def test_lookup_chunks_cover_every_group():
    for groups, rows in [(1, 1), (5, 3072), (12500, 2560), (131072, 256), (7, 1)]:
        cg, k = cuda_point.lookup_chunks(groups, rows)
        assert (k - 1) * cg < groups <= k * cg and k * rows < cuda_point.LOOKUP_THREADS + rows


def test_beyond_handle_range_raises():
    """No size cap is left: above 2^20 the engine streams and a handle takes
    any n the card holds. What still raises is an MSM over more scalars than
    generators, the streamed size included."""
    assert not hasattr(tfixed, "MAX_HANDLE_POINTS") and not hasattr(tfixed, "STREAMING_TODO")
    data = [np.zeros((tengine.STREAM_ABOVE + 1, 1), np.uint8)]
    with pytest.raises(ValueError, match="generators"):
        tengine.msm(TGENS, data, [1], [False])


def test_prepare_scalars_matches_jax():
    rng = np.random.default_rng(4)
    data = [rng.integers(0, 256, size=(n, 8), dtype=np.uint8) for n in (5, 0, 9)]
    data[0][:, 7] = [0x80, 0xFF, 0x7F, 0, 0xFE]
    for signed in ([True, False, True], [False, False, False]):
        got = tengine.prepare_scalars(data, [8, 8, 8], signed)
        want = jengine.prepare_scalars(data, [8, 8, 8], signed)
        assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2])) and got[2] == want[2]
