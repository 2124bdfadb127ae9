"""The kernels' own arithmetic (csrc/fp25519.cuh, csrc/edwards25519.cuh),
compiled for the host with g++ through csrc/host_harness.cpp, against
blitzar_tpu on a few hundred seeded values: the one check of the CUDA code's
carries that needs no card."""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.ops import build, cuda_point
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, to_jax_points, to_tensor

P = 2**255 - 19
EDGES = [0, 1, 2, 19, 38, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2**255 - 1, 2**255, 2**256 - 1]


@pytest.fixture(scope="module")
def harness():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this host")
    src = build.CSRC / "host_harness.cpp"
    h = hashlib.sha256()
    for path in [src] + sorted(build.CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    out_dir = build.BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / "libhost_harness.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"tmp-{os.getpid()}.so"
        subprocess.run(
            [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(build.CSRC), str(src), "-o", str(tmp)],
            check=True,
        )
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def _run(fn, *arrays, out_shape):
    """Call a harness function on int32 arrays; returns the output array."""
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    out = np.zeros(out_shape, np.int32)
    n = out_shape[-1]
    args = [ctypes.c_void_p(a.ctypes.data) for a in arrays] + [ctypes.c_void_p(out.ctypes.data), ctypes.c_int64(n)]
    fn(*args)
    return out


def _field_values(seed: int, count: int = 287) -> np.ndarray:
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(16, count)).astype(np.int64)
    return np.concatenate([ints_to_limbs(EDGES), limbs], axis=1)


def _canon(x) -> np.ndarray:
    return np.asarray(JF.canonicalize(jnp.asarray(np.asarray(x, np.uint32)))).astype(np.uint32)


FIELD_OPS = {
    "mul": (0, lambda a, b: JF.mul(a, b)),
    "sq": (1, lambda a, b: JF.sq(a)),
    "invert": (2, lambda a, b: JF.invert(a)),
    "add": (3, lambda a, b: JF.add(a, b)),
    "sub": (4, lambda a, b: JF.sub(a, b)),
    "pow22523": (5, lambda a, b: JF.pow22523(a)),
}


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_field_ops_match_jax(harness, op):
    code, jfn = FIELD_OPS[op]
    a, b = _field_values(1), _field_values(2)[:, ::-1]
    out = _run(functools.partial(harness.btt_host_field, ctypes.c_int(code)), a, b, out_shape=a.shape)
    want = _canon(jfn(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))))
    assert np.array_equal(out.astype(np.uint32), want)


def _points(seed: int, count: int = 256):
    """count distinct points (the plain elligator_form of seeded field
    elements), as (4, 16, n) canonical limbs."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1 << 16, size=(2, 16, count)).astype(np.int64)
    r[:, 15] &= 0x7FFF
    return to_jax_points(cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1]))), r


def _jax_point(coords):
    return jed.PointP3(*(jnp.asarray(c) for c in coords))


def _canon_point(p) -> np.ndarray:
    return np.stack([_canon(c) for c in p])


def test_edwards_add_double_match_jax(harness):
    p, _ = _points(3)
    q, _ = _points(4)
    q[:, :, :4] = p[:, :, :4]  # doubling through the unified add
    got = _run(harness.btt_host_ed_add, p, q, out_shape=p.shape)
    assert np.array_equal(got.astype(np.uint32), _canon_point(jed._add_impl(_jax_point(p), _jax_point(q))))
    got = _run(harness.btt_host_ed_double, p, out_shape=p.shape)
    assert np.array_equal(got.astype(np.uint32), _canon_point(jed._double_impl(_jax_point(p))))


def test_madd_and_to_niels_match(harness):
    p, _ = _points(5)
    q, _ = _points(6)
    niels = _run(harness.btt_host_to_niels, q, out_shape=(3,) + q.shape[1:])
    tq = ted.PointP3(*(to_tensor(c) for c in q))
    want_niels = np.stack([c.numpy() for c in cuda_point.unpack_niels(cuda_point.pack_niels(ted.to_niels(tq)))])
    assert np.array_equal(niels, want_niels)
    got = _run(harness.btt_host_ed_madd, p, niels, out_shape=p.shape)
    jn = jed.Niels(*(jnp.asarray(c.astype(np.uint32)) for c in niels))
    assert np.array_equal(got.astype(np.uint32), _canon_point(jed._madd_impl(_jax_point(p), jn)))


def test_elligator_form_matches_plain(harness):
    """Against the plain version, which tests/test_torch_curve.py holds
    against blitzar_tpu's elligator (and whose JAX run costs ~40 s here)."""
    _, r = _points(7, count=64)
    r[:, :, 0] = 0
    got = _run(harness.btt_host_elligator_form, r[0], r[1], out_shape=(4, 16, 64))
    want = to_jax_points(cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1])))
    assert np.array_equal(got.astype(np.uint32), want)
