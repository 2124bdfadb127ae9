"""csrc/ed_convert.cuh, the bodies of the ristretto255 table conversions
(``ed_to_niels``: extended points to niels words; ``ed_file_rows``: niels
words to the reference's raw-file rows; ``ed_file_entries``: rows back to
niels words), run by csrc/host_harness.cpp, against blitzar_tpu's
conversions (its npz read's ``_ed_niels_split``, its raw writer's
``_ed_affine_xyt`` and field51 words, its reader's ``f51_u64_to_limbs16``)
and against the port's plain versions, word for word. The tables hold
identity entries (entry 0 of every group); ``ed_to_niels`` runs in tiles of
32 x per entries, the last one short; the rows read back include
non-canonical field51 limbs of every magnitude."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.msm import interop as jinterop
from blitzar_tpu.utils import limbs as jlimbs
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils import limbs as tlimbs
from blitzar_tpu_torch.utils.limbs import to_jax_points, to_tensor

import torch_host_harness

GROUPS, W = 9, 4  # 144 entries: tiles of 32 x 3 leave a short one


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


@pytest.fixture(scope="module")
def table() -> ted.PointP3:
    """(16, GROUPS, 2^W) extended subset sums of seeded points (z != 1 but in
    the one-point entries' and the identity's)."""
    rng = np.random.default_rng(71)
    r = rng.integers(0, 1 << 16, size=(2, 16, GROUPS * W)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    pts = cuda_point.elligator_form_plain(to_tensor(r[0], "cpu"), to_tensor(r[1], "cpu"))
    return cuda_point.subset_sums_plain(pts, W)


@pytest.fixture(scope="module")
def words(table) -> torch.Tensor:
    return cuda_point.ed_to_niels_plain(table)


def _host_to_niels(harness, table, per: int) -> torch.Tensor:
    count = table.x[0].numel()
    pts = np.ascontiguousarray(np.stack([c.reshape(16, -1).numpy() for c in table[:3]]))
    out = torch.zeros((count, 3, 8), dtype=torch.int32)
    rc = harness.btt_host_ed_to_niels(ctypes.c_void_p(pts.ctypes.data), ctypes.c_int64(count), ctypes.c_int(per),
                                      ctypes.c_void_p(out.data_ptr()))
    assert rc == 0
    return out


def _host_rows(harness, words) -> torch.Tensor:
    words = words.reshape(-1, 3, 8).contiguous()
    rows = torch.zeros((words.shape[0], 15), dtype=torch.int64)
    harness.btt_host_ed_file_rows(ctypes.c_void_p(words.data_ptr()), ctypes.c_int64(words.shape[0]),
                                  ctypes.c_void_p(rows.data_ptr()))
    return rows


def _host_entries(harness, rows) -> torch.Tensor:
    rows = rows.contiguous()
    out = torch.zeros((rows.shape[0], 3, 8), dtype=torch.int32)
    harness.btt_host_ed_file_entries(ctypes.c_void_p(rows.data_ptr()), ctypes.c_int64(rows.shape[0]),
                                     ctypes.c_void_p(out.data_ptr()))
    return out


def test_ed_to_niels_body_matches_jax_and_plain(harness, table, words):
    """The niels words of blitzar_tpu's npz read (``_ed_niels_split``: its
    byte-split (a | b | 2d*t) limbs, canonicalized), the plain version, and
    the harness's tiles at per = 1, 3 (a short last tile) and 64 (the
    kernel's at 2^21 entries: one short tile) agree word for word."""
    jt = jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(table)))
    split = np.asarray(jax.jit(jfixed._ed_niels_split)(jt)).astype(np.int64)  # (G, 96, V): low bytes, then high
    limbs = np.moveaxis(split[:, :48] | (split[:, 48:] << 8), 1, 0)  # (48, G, V)
    want = cuda_point.pack_niels(ted.Niels(*(TF.canonicalize(to_tensor(limbs[16 * k : 16 * k + 16], "cpu"))
                                             for k in range(3))))
    assert torch.equal(words, want)
    assert torch.equal(cuda_point.ed_to_niels(table), words)  # the wrapper on a CPU tensor
    assert torch.equal(tfixed.niels_table(table), words)
    for per in (1, 3, 64):
        assert torch.equal(_host_to_niels(harness, table, per), words.reshape(-1, 3, 8)), f"per = {per}"


def test_ed_to_niels_body_on_rescaled_points(harness, table, words):
    """Entries whose z differ a lot (a table's entries scaled by random
    factors: the same points, other coordinates) give the same words."""
    rng = np.random.default_rng(72)
    k = to_tensor(rng.integers(1, 1 << 16, size=(16, GROUPS, 1 << W)), "cpu")
    scaled = ted.PointP3(*(TF.mul(c, k) for c in table))
    assert torch.equal(cuda_point.ed_to_niels_plain(scaled), words)
    assert torch.equal(_host_to_niels(harness, scaled, 2), words.reshape(-1, 3, 8))


def test_file_rows_body_matches_jax_and_plain(harness, table, words):
    """The raw file's rows as blitzar_tpu writes them for the same table
    (``_ed_affine_xyt`` and its field51 words), the plain version's and the
    harness's, word for word; the identity is {0, 1, 0}."""
    flat = [jnp.asarray(c.reshape(16, -1)) for c in to_jax_points(table)]
    want = np.concatenate([jlimbs.limbs16_to_f51_u64(np.asarray(c)) for c in jinterop._ed_affine_xyt(flat)],
                          axis=1).view(np.int64)
    plain = cuda_point.ed_file_rows_plain(words)
    assert np.array_equal(plain.numpy(), want)
    assert torch.equal(cuda_point.ed_file_rows(words), plain)
    assert torch.equal(_host_rows(harness, words), plain)
    assert plain[0].tolist() == [0] * 5 + [1] + [0] * 9


def _non_canonical(rows: torch.Tensor) -> torch.Tensor:
    """Other field51 representations of the rows' x and y: 2p added to each
    (limb 0 past 2^51), each limb's 51st bit carried down, limbs of random
    u64 magnitude, all ones (the largest value, below 2^269), p itself (0),
    and 2^255 (19): rows 3 and 7."""
    p_limbs = [(1 << 51) - 19] + [(1 << 51) - 1] * 4
    out = rows.clone()
    for c in (0, 5):
        out[0::4, c : c + 5] += 2 * torch.tensor(p_limbs)
        lim = out[1::4, c : c + 5]
        for i in range(4):  # 2^51 more in limb i, one less in limb i + 1 where it has one
            move = lim[:, i + 1] > 0
            lim[:, i] += torch.where(move, 1 << 51, 0)
            lim[:, i + 1] -= move.to(torch.int64)
        out[1::4, c : c + 5] = lim
    rng = np.random.default_rng(73)
    out[2::4, 0:10] = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, size=out[2::4, 0:10].shape,
                                                    dtype=np.int64))
    out[3, 0:5] = -1
    out[3, 5:10] = torch.tensor(p_limbs)
    out[7, 0:5] = torch.tensor([0, 0, 0, 0, 1 << 51])
    return out


def test_file_entries_body_matches_plain_on_any_field51(harness, words):
    """Rows written canonical read back to the same words; rows of any
    field51 limbs (``_non_canonical``) give the plain version's words, whose
    x and y are blitzar_tpu's reader's; the row's X*Y is never read."""
    rows = cuda_point.ed_file_rows_plain(words)
    assert torch.equal(_host_entries(harness, rows), words.reshape(-1, 3, 8))
    assert torch.equal(cuda_point.ed_file_entries_plain(rows), words.reshape(-1, 3, 8))
    odd = _non_canonical(rows)
    odd[:, 10:15] = 12345  # not read
    plain = cuda_point.ed_file_entries_plain(odd)
    assert torch.equal(_host_entries(harness, odd), plain)
    assert torch.equal(cuda_point.ed_file_entries(odd), plain)  # the wrapper on a CPU tensor
    raw = odd.numpy().view(np.uint64)
    for c in (0, 5):
        assert torch.equal(tlimbs.f51_u64_to_limbs16(odd[:, c : c + 5]),
                           to_tensor(jlimbs.f51_u64_to_limbs16(raw[:, c : c + 5]), "cpu"))
    same = torch.ones(len(rows), dtype=torch.bool)
    same[2::4] = False
    same[3] = same[7] = False
    assert torch.equal(plain[same], words.reshape(-1, 3, 8)[same])  # + 2p, carried down: the same points
    x = tlimbs.f51_u64_to_limbs16(odd[[3, 7], 0:5])
    all_ones = (2**64 - 1) * sum(1 << (51 * i) for i in range(5))
    assert [int(v) for v in tlimbs.limbs_to_ints(x)] == [all_ones % TF.P, 19]


def test_conversion_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="expected"):
        cuda_point.ed_file_rows(torch.zeros((4, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        cuda_point.ed_file_entries(torch.zeros((4, 10), dtype=torch.int64))
