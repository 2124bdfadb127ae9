"""The generator disk cache's load from the file's uint16 rows
(``ed_from_affine_rows``, csrc/ed_convert.cuh): the host harness (the
kernel's body, entry by entry) and the port's CPU wrapper against
blitzar_tpu's ``_disk_load`` of a file that blitzar_tpu's own
``_disk_save`` wrote, at a prefix smaller than the file; rows at the top
of the 16-bit range (values p and above, up to 2^256 - 1) against
blitzar_tpu's ``_affine_to_p3_chunk``; and the port's ``_disk_load``
making one ``ed_from_affine_rows`` call on the prefix's rows as they are in
the file. Tolerance 0 on canonical limbs."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_harness
from blitzar_tpu import generators as jgen
from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch import generators as tgen
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, to_jax_points

N = 128  # generators in the file
PREFIX = 100  # generators loaded from it
P = 2**255 - 19


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """blitzar_tpu's cache directory with its save of the first N
    generators (derived by the port, on the CPU)."""
    root = tmp_path_factory.mktemp("cache_rows")
    points = tgen.ristretto_generators(N, 0, "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jgen, "_DISK_DIR", str(root))
    jgen._disk_save(jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(points))), N)
    mp.undo()
    return root / f"ristretto_gen_a_{N}.npy"


def _canon(coords) -> np.ndarray:
    return np.stack([np.asarray(JF.canonicalize(jnp.asarray(np.asarray(c, np.uint32)))) for c in coords]
                    ).astype(np.int64)


def _host(harness, rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.uint16)
    out = np.zeros((4, 16, rows.shape[-1]), np.int32)
    harness.btt_host_ed_from_affine_rows(ctypes.c_void_p(rows.ctypes.data), ctypes.c_int64(rows.shape[-1]),
                                         ctypes.c_void_p(out.ctypes.data))
    return out.astype(np.int64)


def _wrapper(rows: np.ndarray) -> np.ndarray:
    got = cuda_point.ed_from_affine_rows(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint16)))
    return np.stack([c.numpy() for c in got]).astype(np.int64)


def test_rows_match_blitzar_tpu_load(harness, jax_file, monkeypatch):
    arr = np.load(jax_file)
    assert arr.shape == (2, 16, N) and arr.dtype == np.uint16
    monkeypatch.setattr(jgen, "_DISK_DIR", str(jax_file.parent))
    want = _canon(jgen._disk_load(PREFIX))
    assert want.shape == (4, 16, PREFIX)
    rows = arr[:, :, :PREFIX]
    assert np.array_equal(_host(harness, rows), want)
    assert np.array_equal(_wrapper(rows), want)


def test_rows_at_the_top_of_the_limbs_match_blitzar_tpu(harness):
    """x and y of p, p + 1, 2^255 - 1, 2^256 - 1 (every limb 0xFFFF), 0 and
    1 in turn: values the 16-bit limbs hold that are not canonical."""
    vals = [P, P + 1, 2**255 - 1, 2**256 - 1, 0, 1]
    xs, ys = vals, vals[3:] + vals[:3]
    rows = np.stack([ints_to_limbs(xs), ints_to_limbs(ys)]).astype(np.uint16)
    jax_rows = [jnp.asarray(r) for r in rows]
    want = _canon(jgen._affine_to_p3_chunk(*jax_rows))
    assert np.array_equal(_host(harness, rows), want)
    assert np.array_equal(_wrapper(rows), want)


def test_port_load_is_one_call_on_the_file_rows(jax_file, monkeypatch):
    """The port's load of the prefix: one ``ed_from_affine_rows`` call on
    the file's uint16 rows, no int32 cast before it; the points it returns
    are that call's."""
    calls = []
    inner = cuda_point.ed_from_affine_rows

    def recording(rows):
        calls.append(rows)
        return inner(rows)

    monkeypatch.setattr(cuda_point, "ed_from_affine_rows", recording)
    monkeypatch.setattr(tgen, "DISK_DIR", str(jax_file.parent))
    got = tgen._disk_load(PREFIX, "cpu")
    assert len(calls) == 1 and calls[0].dtype == torch.uint16
    assert np.array_equal(calls[0].numpy(), np.load(jax_file)[:, :, :PREFIX])
    assert np.array_equal(np.stack([c.numpy() for c in got]), _wrapper(calls[0].numpy()))
