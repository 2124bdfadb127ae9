"""csrc/w_affine.cuh, the body of the w_affine kernel (a Weierstrass table
chunk to the affine rows of the reference's raw file), run by
csrc/host_harness.cpp lane after lane, against blitzar_tpu's
``interop._w_affine_xy`` with its row format (blitzar_tpu/msm/interop.py:
100-113) and against the port's plain version, word for word, on
bls12-381 G1, bn254 G1 and Grumpkin. The tables hold identity entries
(entry 0 of every group, and the sums of a point with its negation) and
the tiles of 32 x per entries end in a short one."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.msm import interop as jinterop
from blitzar_tpu.utils import limbs as jlimbs
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.ops import cuda_wpoint

import torch_host_harness

CURVES = [(j, t) for j in (jwc.BLS12381_G1, jwc.BN254_G1, jwc.GRUMPKIN) for t in twc.CURVES if t.name == j.name]
W = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _chunk(tc, groups: int, seed: int) -> torch.Tensor:
    """A (groups, 2^W, 3, K) table chunk over random points where each
    group's third point is the negation of its first: entry 0 and entry 5
    of every group are identities."""
    pts = tc.oracle.random_points(groups * W, seed=seed)
    p = tc.field.modulus
    for g in range(groups):
        x, y = pts[g * W]
        pts[g * W + 2] = (x, (p - y) % p)
    return cuda_wpoint.w_build_table_plain(tc, tc.from_affine_ints(pts, "cpu"), W)


def _reference_rows(jc, entries: torch.Tensor) -> np.ndarray:
    """blitzar_tpu's rows for the chunk: _w_affine_xy, then its writer's
    marker and word conversion."""
    p = cuda_wpoint.unpack_points(entries)
    coords = [jnp.asarray(c.reshape(c.shape[0], -1).numpy().astype(np.uint32)) for c in p]
    xa, ya, inf = jinterop._w_affine_xy(coords, jc)
    x_rows = jlimbs.limbs16_to_u64(np.asarray(xa))
    y_rows = jlimbs.limbs16_to_u64(np.asarray(ya))
    inf = np.asarray(inf)
    k = x_rows.shape[1]
    x_rows[inf] = 0
    x_rows[inf, k - 1] = np.uint64(2**64 - 1)
    y_rows[inf] = jlimbs.limbs16_to_u64(np.asarray(jc.field._int_limbs(jc.field.r))[:, None])[0]
    return np.concatenate([x_rows, y_rows], axis=1).view(np.int64)


@pytest.mark.parametrize("jc,tc", CURVES, ids=[j.name for j, _ in CURVES])
def test_w_affine_body_matches_jax_and_plain(harness, jc, tc):
    """Tiles of 32 x per entries, lane l taking entries l + 32 j: per = 1
    (one entry a lane), 3 (a short last tile: 27 groups of 8 entries are
    216, not a multiple of 96) and 64 (the kernel's: one short tile)."""
    entries = _chunk(tc, 27, seed=61)
    count = entries.shape[0] * entries.shape[1]
    want = _reference_rows(jc, entries)
    plain = cuda_wpoint.w_affine_plain(tc, entries)
    assert np.array_equal(plain.numpy(), want)
    assert int((entries[:, :, 2] == 0).all(-1).sum()) == 2 * 27  # the identities
    for per in (1, 3, 64):
        rows = torch.zeros((count, tc.nlimbs // 2), dtype=torch.int64)
        rc = harness.btt_host_w_affine(ctypes.c_int(tc.kernel_id), ctypes.c_void_p(entries.data_ptr()),
                                       ctypes.c_int64(count), ctypes.c_int(per), ctypes.c_void_p(rows.data_ptr()))
        assert rc == 0
        assert torch.equal(rows, plain), f"per = {per}"


def test_w_affine_wrapper_checks_its_chunk():
    tc = twc.BN254_G1
    with pytest.raises(ValueError, match="expected"):
        cuda_wpoint.w_affine(tc, torch.zeros((2, 4, 3, 12), dtype=torch.int32))
