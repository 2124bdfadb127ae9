"""Handle files of blitzar_tpu_torch against blitzar_tpu, ristretto255: the
reference's raw format written byte for byte as blitzar_tpu writes it, each
package reading the other's raw and npz files with equal query results, a
w = 16 file re-windowed to w = 8 on import, and the format sniffing of
api.multiexp_handle_new_from_file. The Weierstrass curves are in
tests/test_torch_interop_weierstrass.py."""

import os
import shutil

import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.msm import interop as jinterop
from blitzar_tpu_torch import api
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.msm import interop as tinterop
from blitzar_tpu_torch.ops import cuda_point
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points

N, W = 16, 4
JGENS = jgen.ristretto_generators(N)
TGENS = from_jax_points(np.stack([np.asarray(c) for c in JGENS]), device="cpu")
SCALARS = np.random.default_rng(31).integers(0, 256, size=(2, N, 4), dtype=np.uint8)


def _enc(p) -> np.ndarray:
    return trst.encode(p).numpy().T


def _enc_jax(p) -> np.ndarray:
    return _enc(from_jax_points(np.stack([np.asarray(c) for c in p]), device="cpu"))


@pytest.fixture(scope="module")
def handles():
    """blitzar_tpu's handle over its own table build (equal to the port's,
    tests/test_torch_fixed.py), and the port's."""
    return jfixed.MultiexpHandle(JGENS, window_width=W), tfixed.MultiexpHandle(TGENS, window_width=W)


@pytest.fixture(scope="module")
def want(handles):
    """The port's own query on its built handle."""
    return _enc(tfixed.fixed_multiexponentiation(handles[1], SCALARS))


def test_raw_file_bytes_equal_jax(handles, tmp_path):
    jh, th = handles
    tinterop.write_reference_file(th, tmp_path / "port.raw")
    jinterop.write_reference_file(jh, str(tmp_path / "jax.raw"))
    data = (tmp_path / "port.raw").read_bytes()
    assert data == (tmp_path / "jax.raw").read_bytes()
    assert len(data) == 4 + (N // W) * (1 << W) * 15 * 8 and data[:4] == W.to_bytes(4, "little")
    rows = np.frombuffer(data[4:], "<u8").reshape(-1, 15)
    assert rows[0].tolist() == [0] * 5 + [1, 0, 0, 0, 0] + [0] * 5  # entry 0 is the identity {0, 1, 0}


def test_each_reads_the_others_raw_file(handles, want, tmp_path):
    jh, th = handles
    tinterop.write_reference_file(th, tmp_path / "port.raw")
    jinterop.write_reference_file(jh, str(tmp_path / "jax.raw"))
    got = tinterop.read_reference_file(str(tmp_path / "jax.raw"), ted, "cpu")
    assert (got.window_width, got.num_groups, got.n) == (W, N // W, N)
    assert torch.equal(got.table, th.table)
    assert np.array_equal(_enc(tfixed.fixed_multiexponentiation(got, SCALARS)), want)
    jgot = jinterop.read_reference_file(str(tmp_path / "port.raw"))
    assert np.array_equal(_enc_jax(jfixed.fixed_multiexponentiation(jgot, SCALARS)), want)


def test_each_reads_the_others_npz(handles, want, tmp_path):
    jh, th = handles
    th.write_to_file(str(tmp_path / "port"))  # ".npz" appended, as np.savez does
    jh.write_to_file(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as data:
        assert str(data["curve"]) == "curve25519" and int(data["window_width"]) == W and int(data["n"]) == N
        assert data["coord0"].dtype == np.uint32 and data["coord0"].shape == (16, N // W, 1 << W)
        assert np.array_equal(np.stack([data[f"coord{i}"] for i in range(4)]), to_jax_points(th.point_table()))
    got = tfixed.MultiexpHandle.new_from_file(str(tmp_path / "jax.npz"), ted, "cpu")
    assert (got.window_width, got.n) == (W, N) and torch.equal(got.table, th.table)
    assert np.array_equal(_enc(tfixed.fixed_multiexponentiation(got, SCALARS)), want)
    jgot = jfixed.MultiexpHandle.new_from_file(str(tmp_path / "port.npz"))
    assert np.array_equal(_enc_jax(jfixed.fixed_multiexponentiation(jgot, SCALARS)), want)


def test_w16_file_is_rewindowed_to_8(tmp_path):
    """A w = 16 table of 16 generators (one group of 2^16 entries) comes
    back as the w = 8 table of two groups, entry for entry: no group
    arithmetic, only indexing. blitzar_tpu reads the same file alike."""
    gens = ted.index_batch(TGENS, slice(0, 16))
    # the w = 16 table from its subset sums: one batch inversion over rows
    # of 256 entries instead of the plain build's 2^16 inversions
    wide = tfixed.MultiexpHandle.from_point_table(cuda_point.subset_sums_plain(gens, 16))
    path = str(tmp_path / "w16.raw")
    tinterop.write_reference_file(wide, path)
    got = tinterop.read_reference_file(path, ted, "cpu")
    assert (got.window_width, got.num_groups, got.n) == (8, 2, 16)
    assert torch.equal(got.table, tfixed.MultiexpHandle(gens, window_width=8).table)
    jgot = jinterop.read_reference_file(path)
    assert jgot.window_width == 8
    jtable = np.stack([np.asarray(TF.canonicalize(torch.from_numpy(np.asarray(c).astype(np.int32))))
                       for c in jgot.table])
    assert np.array_equal(jtable, to_jax_points(got.point_table()))


def test_api_sniffs_the_format(want, tmp_path):
    api.reset_backend_for_testing()
    api.init("cpu")
    try:
        handle = api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, TGENS)
        api.multiexp_handle_write_to_file(handle, str(tmp_path / "h"))
        assert os.path.exists(tmp_path / "h.npz")
        shutil.copy(tmp_path / "h.npz", tmp_path / "h.bin")  # an npz by its zip magic, whatever its name
        tinterop.write_reference_file(handle, tmp_path / "r.bin")
        for name in ("h", "h.npz", "h.bin", "r.bin"):
            got = api.multiexp_handle_new_from_file(api.SXT_CURVE_RISTRETTO255, str(tmp_path / name))
            assert got.device == api.device() and got.curve is ted
            assert np.array_equal(api.compress_ristretto255(api.fixed_multiexponentiation(got, SCALARS)), want)
        with pytest.raises(ValueError, match="curve25519"):
            api.multiexp_handle_new_from_file(api.SXT_CURVE_BN_254, str(tmp_path / "h.npz"))
        (tmp_path / "short.bin").write_bytes(b"\x04\x00\x00\x00" + b"\x00" * 100)
        with pytest.raises(ValueError, match="whole groups"):
            api.multiexp_handle_new_from_file(api.SXT_CURVE_RISTRETTO255, str(tmp_path / "short.bin"))
    finally:
        api.reset_backend_for_testing()
