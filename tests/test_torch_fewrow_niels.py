"""fewrow_niels.cu's column sums (csrc/niels_tree.cuh: indices from the
scalar bytes, entries read from the table, a lane's halving tree depth first
over its stack, then the lanes halved), run by csrc/host_harness.cpp column
by column as the kernel's blocks run them, limb for limb against the plain
version (``cuda_point.fewrow_niels_plain``: the gather and the tree in plain
ops, in row blocks), and their sums over the table chunks against blitzar_tpu's ``_partition_products`` (its one-hot einsum
branch on the CPU) as points. Seeded numpy scalars; n = 1000, 1024 and 2048;
1-, 3- and 8-byte columns; signed rows; w = 4 and 8. The handles come from
one 2048-point derivation (module fixture)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch import generators as tgen
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points

import torch_host_harness

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
def harness():
    return torch_host_harness.load()


@pytest.fixture(scope="module")
def handles():
    """w = 8 and w = 4 handles over 2048 canonical generators, each built
    from its subset sums (a batch inversion: the kernel's build's entries)."""
    gens = tgen.ristretto_generators(N, 0, "cpu")
    return {w: tfixed.MultiexpHandle.from_point_table(cuda_point.subset_sums_plain(gens, w), n=N) for w in (4, 8)}


def _tiled(table, groups: int):
    """The first ``groups`` groups of the table repeated along its groups."""
    return torch.cat([table] * -(-groups // table.shape[0]))[:groups]


def _query(handles, n, w, nbytes, outputs, signed, seed):
    """The table of n points (n / w groups; above 2048 points the handle's
    groups again, so that a query has several table chunks), seeded scalars
    (O, n, nbytes) and signs (or None)."""
    table = _tiled(handles[w].table, n // w)
    rng = np.random.default_rng(seed)
    scalars = torch.from_numpy(rng.integers(0, 256, size=(outputs, n, nbytes), dtype=np.uint8))
    signs = torch.from_numpy(rng.integers(0, 2, size=(outputs, n), dtype=np.uint8)) if signed else None
    return table, scalars, signs


def _host(harness, table, scalars, signs, w):
    """The harness's launch: (rc, (16, chunks, R) extended points)."""
    num_outputs, n, nbytes = scalars.shape
    groups = table.shape[0]
    gc = tfixed.table_chunk_groups(groups)
    rows = (2 if signs is not None else 1) * num_outputs * 8 * nbytes
    cols = groups // gc * rows
    out = np.zeros((4, 16, cols), np.int32)
    table, scalars = table.contiguous(), scalars.contiguous()
    rc = harness.btt_host_fewrow_niels(
        ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(scalars.data_ptr()),
        None if signs is None else ctypes.c_void_p(signs.contiguous().data_ptr()),
        ctypes.c_int64(num_outputs), ctypes.c_int64(n), ctypes.c_int(nbytes), ctypes.c_int(w), ctypes.c_int64(gc),
        ctypes.c_void_p(out.ctypes.data))
    return rc, ted.PointP3(*(torch.from_numpy(c).reshape(16, groups // gc, rows) for c in out))


def _canon(p) -> list:
    return [TF.canonicalize(c) for c in p]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_canon(a), _canon(b)))


def _enc(p) -> np.ndarray:
    return trst.encode(p).numpy().T


def _jax_products(handle, table, scalars, signs, w):
    """blitzar_tpu's _partition_products on the port's point table (byte
    split by blitzar_tpu) and the query's bit rows (signed: the positive
    rows, then the negative ones, as the port orders them)."""
    groups = table.shape[0]
    pt = to_jax_points(handle.point_table())
    pt = np.concatenate([pt] * -(-groups // pt.shape[2]), axis=2)[:, :, :groups]
    t_split = jfixed._split_table(jed.PointP3(*(jnp.asarray(c) for c in pt)), jed)
    num_outputs, n, nbytes = scalars.shape
    bits = jfixed._bits_from_bytes(scalars.numpy()).reshape(num_outputs * 8 * nbytes, n)
    if signs is not None:
        neg = np.repeat(signs.numpy(), 8 * nbytes, axis=0)
        bits = np.concatenate([bits * (1 - neg), bits * neg])
    return jfixed._partition_products(t_split, jnp.asarray(bits.astype(np.uint8)), w)


# (n, w, bytes, outputs, signed, seed): one chunk of 256 groups (n = 1024
# at w = 4, 2048 at w = 8) or 512 (2048 at w = 4); two of 1024 (8192 at w = 4)
CASES = [
    (1024, 4, 1, 1, False, 0), (1024, 4, 3, 1, True, 1), (2048, 8, 1, 1, False, 2),
    (2048, 8, 3, 2, True, 0), (2048, 8, 8, 1, False, 1), (2048, 4, 8, 1, True, 2),
    (2048, 4, 1, 3, False, 0), (8192, 4, 1, 1, True, 1), (8192, 4, 2, 1, False, 2),
]


@pytest.mark.parametrize("n, w, nbytes, outputs, signed, seed", CASES)
def test_fewrow_niels_body_matches_plain(harness, handles, n, w, nbytes, outputs, signed, seed):
    """The harness's column sums equal the plain version's limb for limb,
    and the wrapper's (its plain version on the CPU)."""
    table, scalars, signs = _query(handles, n, w, nbytes, outputs, signed, n + 7 * nbytes + seed)
    gc = tfixed.table_chunk_groups(table.shape[0])
    rc, got = _host(harness, table, scalars, signs, w)
    assert rc == 0
    want = cuda_point.fewrow_niels_plain(table, scalars, signs, w, gc)
    assert got.x.shape == want.x.shape and _same(got, want)
    assert _same(cuda_point.fewrow_niels(table, scalars, signs, w, gc), want)


@pytest.mark.parametrize("n, w, nbytes, outputs, signed", [(2048, 8, 3, 1, False), (8192, 4, 1, 1, True)])
def test_fewrow_niels_sums_match_partition_products(harness, handles, n, w, nbytes, outputs, signed):
    """The column sums summed over the chunks are blitzar_tpu's bit-row
    products as points (encodings), and the query's own (fewrow_products)."""
    table, scalars, signs = _query(handles, n, w, nbytes, outputs, signed, 3 * n + nbytes)
    rc, sums = _host(harness, table, scalars, signs, w)
    assert rc == 0
    got = ted.tree_reduce(sums, sums.x.shape[1])
    want = from_jax_points(np.stack([np.asarray(c) for c in _jax_products(handles[w], table, scalars, signs, w)]),
                           device="cpu")
    assert np.array_equal(_enc(got), _enc(want))
    assert np.array_equal(_enc(tfixed.fewrow_products(table, scalars, signs, w)), _enc(want))


def test_fewrow_niels_plain_on_a_sample_of_chunks(handles):
    """``chunks`` picks table chunks: the same sums as the whole run's."""
    table, scalars, signs = _query(handles, 8192, 4, 2, 1, True, 5)  # two chunks of 1024 groups
    whole = cuda_point.fewrow_niels_plain(table, scalars, signs, 4, 1024)
    part = cuda_point.fewrow_niels_plain(table, scalars, signs, 4, 1024, torch.tensor([whole.x.shape[1] - 1]))
    assert _same(part, ted.index_batch(whole, (slice(-1, None),)))


@pytest.mark.parametrize("n, w", [(1000, 8), (1024, 8), (1000, 4)])
def test_chunks_the_kernel_does_not_take(harness, handles, monkeypatch, n, w):
    """n = 1000 (125- and 2-group chunks) and n = 1024 at w = 8 (128-group
    chunks): the harness refuses the chunk size, the wrapper raises, and
    the query gathers its entries instead (no fewrow_niels call), equal to
    the lookup's products."""
    table, scalars, signs = _query(handles, n, w, 1, 1, False, n)
    assert _host(harness, table, scalars, signs, w)[0] == -1
    with pytest.raises(ValueError):
        cuda_point.fewrow_niels(table, scalars, signs, w, tfixed.table_chunk_groups(table.shape[0]))
    calls = []
    inner = cuda_point.fewrow_niels
    monkeypatch.setattr(cuda_point, "fewrow_niels", lambda *a, **k: calls.append(1) or inner(*a, **k))
    got = tfixed.fewrow_products(table, scalars, signs, w)
    want = tfixed.sum_leading(cuda_point.ed_lookup_msm(table, scalars, signs, w))
    assert calls == [] and np.array_equal(_enc(got), _enc(want))


def test_fewrow_niels_plain_in_row_blocks(handles, monkeypatch):
    """With a budget that holds two rows' entries, the plain version gathers
    in row blocks and gives the sums of one block; the wrapper raises on a
    chunk size that does not divide the group count."""
    table, scalars, signs = _query(handles, 8192, 4, 1, 1, True, 9)  # 16 rows, two chunks of 1024 groups
    whole = cuda_point.fewrow_niels_plain(table, scalars, signs, 4, 1024)
    monkeypatch.setattr(cuda_point, "FEWROW_BUDGET_BYTES", 2 * table.shape[0] * 96)
    assert len(cuda_point.fewrow_blocks(table, 16)) == 8
    assert _same(cuda_point.fewrow_niels_plain(table, scalars, signs, 4, 1024), whole)
    with pytest.raises(ValueError):
        cuda_point.fewrow_niels(table[:1536], scalars[:, :6144], signs[:, :6144], 4, 1024)
