"""The generator disk cache of blitzar_tpu_torch.generators against
blitzar_tpu's: a cache written by either package is loaded by the port (and
the port's by blitzar_tpu), with the same points; the smallest covering
prefix is sliced; legacy extended files are honoured; the cache is off
unless its variable names a directory, and "" disables it; an unwritable
directory skips the save. Both cache directories point into tmp_path. The N
generators are derived once, in the module fixture, with saves at multiples
of N (the module's DISK_CHUNK, 2^16, patched): the rules are the same at any
multiple, and a 2^16 derivation in plain PyTorch takes minutes here."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu_torch import generators as tgen
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.utils.limbs import from_jax_points, to_jax_points

N = 256


@pytest.fixture(scope="module")
def derived(tmp_path_factory):
    """The first N generators, derived by the port with its cache in a
    fresh directory: the derivation saves the cache file."""
    root = tmp_path_factory.mktemp("gencache")
    mp = pytest.MonkeyPatch()
    mp.setattr(tgen, "DISK_DIR", str(root / "port"))
    mp.setattr(tgen, "DISK_CHUNK", N)
    points = tgen.ristretto_generators(N, 0, "cpu")
    mp.undo()
    return root, points


def _same_points(p, q) -> bool:
    return bool(ted.points_equal(p, q).all())


def _no_derivation(monkeypatch):
    def fail(_):
        raise AssertionError("derived instead of loading the cache")

    monkeypatch.setattr(tgen, "_xorshift_limbs", fail)


def test_port_saves_affine_uint16(derived):
    root, points = derived
    assert sorted(os.listdir(root / "port")) == [f"ristretto_gen_a_{N}.npy"]  # no temporary file left
    arr = np.load(root / "port" / f"ristretto_gen_a_{N}.npy")
    assert arr.shape == (2, 16, N) and arr.dtype == np.uint16
    zinv = TF.invert(points.z[:, :64])
    for k, c in enumerate((points.x, points.y)):
        assert np.array_equal(arr[k, :, :64], TF.canonicalize(TF.mul(c[:, :64], zinv)).numpy())


def test_port_loads_its_own_cache(derived, monkeypatch):
    root, points = derived
    monkeypatch.setattr(tgen, "DISK_DIR", str(root / "port"))
    _no_derivation(monkeypatch)
    got = tgen.ristretto_generators(N, 0, "cpu")
    assert torch.equal(got.z, TF.from_int(1, (N,)))
    assert _same_points(got, points)
    prefix = tgen.ristretto_generators(N // 2 + 3, 0, "cpu")  # the smallest covering prefix, sliced
    assert _same_points(prefix, ted.index_batch(points, slice(0, N // 2 + 3)))


def test_port_loads_jax_cache_and_jax_loads_ports(derived, monkeypatch):
    root, points = derived
    jdir = str(root / "jax")
    monkeypatch.setattr(jgen, "_DISK_DIR", jdir)
    jgen._disk_save(jed.PointP3(*(jnp.asarray(c) for c in to_jax_points(points))), N)
    assert os.path.exists(os.path.join(jdir, f"ristretto_gen_a_{N}.npy"))
    canon = [TF.canonicalize(torch.from_numpy(a.astype(np.int32)).transpose(0, 1)) for a in
             (np.load(os.path.join(jdir, f"ristretto_gen_a_{N}.npy")), np.load(root / "port" / f"ristretto_gen_a_{N}.npy"))]
    assert torch.equal(canon[0], canon[1])  # the same file content, canonically
    monkeypatch.setattr(tgen, "DISK_DIR", jdir)
    _no_derivation(monkeypatch)
    assert _same_points(tgen.ristretto_generators(N, 0, "cpu"), points)
    monkeypatch.setattr(jgen, "_DISK_DIR", str(root / "port"))
    loaded = jgen._disk_load(N)
    assert _same_points(from_jax_points(np.stack([np.asarray(c) for c in loaded]), device="cpu"), points)


def test_legacy_extended_file(derived, tmp_path, monkeypatch):
    _, points = derived
    legacy = to_jax_points(ted.index_batch(points, slice(0, 64)))  # (4, 16, 64) uint32
    np.save(tmp_path / "ristretto_gen_64.npy", legacy)
    monkeypatch.setattr(tgen, "DISK_DIR", str(tmp_path))
    _no_derivation(monkeypatch)
    assert _same_points(tgen.ristretto_generators(40, 0, "cpu"), ted.index_batch(points, slice(0, 40)))


def test_disabled_offsets_unwritable_and_corrupt(derived, tmp_path, monkeypatch):
    """With saves at multiples of 16: "" saves and loads nothing; an offset
    derivation neither; a directory that cannot be made skips the save; a
    file that does not read as a cache array is derived past."""
    _, points = derived
    monkeypatch.setattr(tgen, "DISK_CHUNK", 16)
    want = ted.index_batch(points, slice(0, 32))
    monkeypatch.setattr(tgen, "DISK_DIR", "")
    assert _same_points(tgen.ristretto_generators(32, 0, "cpu"), want)
    cache = tmp_path / "cache"
    monkeypatch.setattr(tgen, "DISK_DIR", str(cache))
    tgen.ristretto_generators(32, 16, "cpu")
    assert not cache.exists()
    (tmp_path / "file").write_bytes(b"")
    monkeypatch.setattr(tgen, "DISK_DIR", str(tmp_path / "file" / "sub"))
    assert _same_points(tgen.ristretto_generators(32, 0, "cpu"), want)
    monkeypatch.setattr(tgen, "DISK_DIR", str(cache))
    cache.mkdir()
    (cache / "ristretto_gen_a_48.npy").write_bytes(b"not an array")
    np.save(cache / "ristretto_gen_a_64.npy", np.zeros((2, 16, 64), np.uint32))  # the wrong dtype
    assert _same_points(tgen.ristretto_generators(32, 0, "cpu"), want)
    assert sorted(os.listdir(cache)) == ["ristretto_gen_a_32.npy", "ristretto_gen_a_48.npy", "ristretto_gen_a_64.npy"]


@pytest.mark.parametrize("value", [None, "", "somewhere"])
def test_cache_directory_comes_from_its_variable(value):
    """Off unless BLITZAR_TPU_TORCH_GENERATOR_CACHE_DIR names a directory
    (read when the module is imported, in a fresh interpreter here)."""
    env = {k: v for k, v in os.environ.items() if k != "BLITZAR_TPU_TORCH_GENERATOR_CACHE_DIR"}
    if value is not None:
        env["BLITZAR_TPU_TORCH_GENERATOR_CACHE_DIR"] = value
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", "from blitzar_tpu_torch import generators; print(repr(generators.DISK_DIR))"],
                         cwd=root, env=env, capture_output=True, text=True, check=True).stdout
    assert out.strip() == repr(value or "")
