"""The few-row partition query of blitzar_tpu_torch.msm.fixed (plain path):
the plain niels_add and niels tree against blitzar_tpu; the query at n =
1000, 1024 and 2048 (w = 8: a 125-group chunk, 128-group chunks, 256-group
chunks) and with w = 4 against the ed_lookup_msm path on the same handle and
scalars; signed rows, a cached (streamed) table, a Weierstrass table; the
routing against blitzar_tpu's; one-column commitments through the API.
The handles come from one 2048-point derivation (module fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.ops import pallas_point as pp
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch import api
from blitzar_tpu_torch import generators as tgen
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import to_jax_points

N = 2048


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small ops: one thread a worker keeps
    the parallel test run from oversubscribing the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def gens():
    return tgen.ristretto_generators(N, 0, "cpu")


@pytest.fixture(scope="module")
def handles(gens):
    """w = 8 over all N points and w = 4 over the first 1024, each built
    from its subset sums (a batch inversion: the same entries as the
    kernel's build)."""
    h8 = tfixed.MultiexpHandle.from_point_table(cuda_point.subset_sums_plain(gens, 8), n=N)
    g4 = ted.index_batch(gens, slice(0, 1024))
    h4 = tfixed.MultiexpHandle.from_point_table(cuda_point.subset_sums_plain(g4, 4), n=1024)
    return {8: h8, 4: h4}


def _sub_handle(handle, n):
    """The handle of the first n points, n a multiple of the window: its
    first n / w groups."""
    return tfixed.MultiexpHandle.from_table(handle.table[: n // handle.window_width], n=n)


def _canon(c) -> np.ndarray:
    return TF.canonicalize(c).numpy().astype(np.uint32)


def _enc(p) -> np.ndarray:
    return trst.encode(p).numpy().T


def _scalars(n_pad, nbytes, seed, outputs=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, size=(outputs, n_pad, nbytes), dtype=np.uint8))


def _spy(monkeypatch, module, name, calls):
    inner = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or inner(*a, **k))


def test_plain_niels_add_matches_jax(gens):
    """niels_add's plain twin against blitzar_tpu's _niels_add_impl, a
    doubling and the identity among the pairs: canonical limbs."""
    pts = ted.cat([ted.identity((1,)), ted.index_batch(gens, slice(1, 64))])
    other = ted.cat([ted.index_batch(pts, slice(0, 4)), ted.index_batch(gens, slice(100, 160))])
    n1, n2 = ted.to_niels(pts), ted.to_niels(other)
    got = cuda_point.niels_add_plain(n1, n2)
    jn = [jed.Niels(*(jnp.asarray(_canon(c)) for c in n)) for n in (n1, n2)]
    want = jed._niels_add_impl(*jn)
    assert np.array_equal(to_jax_points(got), np.stack([np.asarray(JF.canonicalize(c)) for c in want]))


def test_plain_niels_tree_is_the_column_sum(gens):
    """The plain niels tree over (256, 2) entries (the first level is
    _niels_add_impl, held against blitzar_tpu above; blitzar_tpu's own
    ed.tree_reduce of the 128 sums runs eagerly here for a minute) gives
    each column's sum: the reference oracle's sum of its 256 generators.
    fewrow_niels takes no table chunk of 128 groups."""
    cols, size = 2, 256
    entries = cuda_point.pack_niels(ted.to_niels(ted.index_batch(gens, slice(0, size * cols))))
    got = cuda_point.niels_tree_plain(entries.reshape(size, cols, 3, 8))
    want = []
    for c in range(cols):
        acc = R.IDENTITY
        for s in range(size):
            acc = R.pt_add(acc, R.compute_base_element(s * cols + c))
        want.append(R.ristretto_encode(acc))
    assert [bytes(e) for e in _enc(got)] == want
    with pytest.raises(ValueError):
        cuda_point.fewrow_niels(entries.reshape(-1, 4, 3, 8)[:128], _scalars(256, 1, 1), None, 2, 128)


@pytest.mark.parametrize("n, w, nbytes, reduce", [
    (1000, 8, 1, "odd chunk"), (1024, 8, 1, "niels_add"), (1024, 8, 8, "niels_add"),
    (2048, 8, 1, "fewrow_niels"), (2048, 8, 8, "fewrow_niels"),
    (1024, 4, 2, "fewrow_niels"),
])
def test_fewrow_query_matches_lookup(handles, monkeypatch, n, w, nbytes, reduce):
    """partition_products routes the query to the few-row path (fewer than
    128 bit rows, or w = 4), whose chunk reduce is the one named; its
    products equal ed_lookup_msm's on the same handle and scalars."""
    handle = _sub_handle(handles[w], n)
    groups = handle.num_groups
    scalars = _scalars(groups * w, nbytes, n + nbytes)
    calls = []
    for name in ("fewrow_niels", "niels_add", "ed_lookup_msm"):
        _spy(monkeypatch, cuda_point, name, calls)
    got = tfixed.partition_products(handle, scalars)
    want = tfixed.sum_leading(cuda_point.ed_lookup_msm(handle.table, scalars, None, w))
    assert not tfixed.lookup_msm_fits(groups, 1 << w, 8 * nbytes)
    assert set(calls) == {"ed_lookup_msm"} | (set() if reduce == "odd chunk" else {reduce})
    assert calls[-1] == "ed_lookup_msm"
    assert np.array_equal(_enc(got), _enc(want))


def test_signed_fewrow_query_matches_lookup(handles):
    handle = _sub_handle(handles[8], 1024)
    scalars = _scalars(1024, 2, 3, outputs=2)
    signs = torch.from_numpy(np.random.default_rng(4).integers(0, 2, size=(2, 1024), dtype=np.uint8))
    got = tfixed.fewrow_products(handle.table, scalars, signs, 8)
    want = tfixed.sum_leading(cuda_point.ed_lookup_msm(handle.table, scalars, signs, 8))
    assert got.x.shape == (16, 64) and np.array_equal(_enc(got), _enc(want))


def test_cached_table_fewrow_query_matches_lookup(gens):
    """A streamed chunk's cached table (w = 8, 2048 points): the few-row
    query equals the cached lookup's products."""
    table = cuda_point.build_cached_table_plain(gens, 8)
    scalars = _scalars(N, 1, 5)
    got = tfixed.fewrow_products(table, scalars, None, 8)
    want = tfixed.sum_leading(cuda_point.ed_lookup_msm(table, scalars, None, 8))
    assert np.array_equal(_enc(got), _enc(want))


def test_weierstrass_fewrow_query_matches_lookup_and_oracle():
    """bn254 G1, 64 points at w = 8 (8 groups): a 1-byte column's query
    takes the few-row path; it equals w_lookup_msm's products and, combined,
    the oracle's MSM."""
    curve = twc.BN254_G1
    pts = curve.oracle.random_points(64, seed=6)
    handle = tfixed.MultiexpHandle(curve.from_affine_ints(pts, "cpu"), curve=curve)
    scalars = _scalars(64, 1, 7)
    assert not tfixed.w_lookup_msm_fits(handle.num_groups, 256, 8)
    got = tfixed.partition_products(handle, scalars)
    want = tfixed.sum_leading(cuda_wpoint.w_lookup_msm(curve, handle.table, scalars, None, 8), curve)
    assert curve.to_affine_ints(got) == curve.to_affine_ints(want)
    out = tfixed.fixed_multiexponentiation(handle, scalars.numpy())
    assert curve.to_affine_ints(out) == [curve.oracle.msm([int(v) for v in scalars[0, :, 0]], pts)]


def test_routing_matches_blitzar_tpu():
    for groups in (1, 8, 15, 16, 24, 32, 125, 128, 131072):
        for v in (16, 256, 65536):
            for rows in (8, 64, 127, 128, 256, 512):
                assert tfixed.lookup_msm_fits(groups, v, rows) == pp.lookup_msm_fits(groups, v, rows)
                assert tfixed.w_lookup_msm_fits(groups, v, rows) == pp.w_lookup_msm_fits(groups, v, rows)
    assert (tfixed.LOOKUP_GT, tfixed.W_LOOKUP_GT) == (pp.LOOKUP_GT, pp.W_LOOKUP_GT)
    from blitzar_tpu.msm import fixed as jfixed

    for groups in (1, 5, 125, 128, 256, 12500, 131072, 131075):
        assert tfixed.table_chunk_groups(groups) == jfixed._table_chunk_groups(groups)
    for size in (1, 2, 128, 129, 256, 384, 1024, 2048, 4096):
        assert cuda_point.niels_tree_fits(size) == (pp.tree_fits(jed, size) and size <= cuda_point.NIELS_TREE_MAX)


def test_one_byte_column_commitment(gens):
    """A commitment to one 1-byte column of 1000 values (a handle of the
    1000 points, 125 groups: the few-row query) through the API: the
    reference oracle's point."""
    api.reset_backend_for_testing()
    api.init("cpu")
    vals = np.random.default_rng(8).integers(0, 256, size=1000, dtype=np.uint8)
    sub = ted.index_batch(gens, slice(0, 1000))
    got = api.compute_curve25519_commitments([api.SequenceDescriptor(1, 1000, vals)], generators=sub)
    oracle = [R.compute_base_element(i) for i in range(1000)]
    assert bytes(got[0]) == R.ristretto_encode(R.naive_msm([int(v) for v in vals], oracle))
    api.reset_backend_for_testing()
