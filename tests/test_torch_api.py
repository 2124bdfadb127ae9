"""blitzar_tpu_torch.api on the CPU backend: the upstream vectors, the
engine edge cases against blitzar_tpu.api, the device policy, and the rule
that the port imports neither jax nor blitzar_tpu."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from blitzar_tpu import api as japi
from blitzar_tpu.refimpl import core as R
from blitzar_tpu_torch import api
from vectors import RUST_DATA, RUST_EXPECTED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GENS = 40
NBYTES = 16

# copied from tests/test_engine_conformance.py (reference
# multiexp/test/multiexponentiation.cc:26-136): (name, values, is_signed)
EDGE_OUTPUTS = [
    ("zeros", [0, 0, 0], False),
    ("ones_twos", [1, 2, 3], False),
    ("u8_max", [255, 255], False),
    ("max_uint64", [2**64 - 1] * 3, False),
    ("max_uint128", [2**128 - 1], False),
    ("alternating", [1, 0, 1, 0, 1], False),
    ("ragged_long", [1, 2, 3, 4, 5, 6, 7], False),
    ("ragged_short", [9, 8], False),
    ("n_zero", [], False),
    ("signed_small", [-5, 3, -1, 1], True),
    ("signed_boundary", [-(1 << 127), (1 << 127) - 1, -1, 1], True),
    ("chunk_crossing", [(i * 2654435761) % (1 << 32) for i in range(N_GENS)], False),
]


@pytest.fixture(autouse=True)
def fresh_backends():
    api.reset_backend_for_testing()
    japi.reset_backend_for_testing()
    yield
    api.reset_backend_for_testing()
    japi.reset_backend_for_testing()


def _descriptors(module, rows_list, nbytes, signed):
    out = []
    for vals in rows_list:
        data = np.zeros((len(vals), nbytes), np.uint8)
        for i, v in enumerate(vals):
            data[i] = np.frombuffer((int(v) % (1 << (8 * nbytes))).to_bytes(nbytes, "little"), np.uint8)
        out.append(module.SequenceDescriptor(nbytes, len(vals), data, signed))
    return out


def test_rust_vectors_through_api():
    api.init("cpu", num_precomputed_generators=10)
    got = api.compute_curve25519_commitments(_descriptors(api, RUST_DATA, 4, False))
    assert [bytes(g) for g in got] == RUST_EXPECTED


def test_edge_outputs_match_blitzar_tpu():
    api.init("cpu")
    japi.init()
    descs, jdescs = [], []
    for _, vals, signed in EDGE_OUTPUTS:
        descs += _descriptors(api, [vals], NBYTES, signed)
        jdescs += _descriptors(japi, [vals], NBYTES, signed)
    got = api.compute_curve25519_commitments(descs)
    want = japi.compute_curve25519_commitments(jdescs)
    bad = [name for (name, _, _), g, w in zip(EDGE_OUTPUTS, got, want) if bytes(g) != bytes(w)]
    assert not bad, f"mismatched outputs {bad}"


def test_generators_offset_and_one_commit():
    api.init("cpu")
    data = np.frombuffer((3).to_bytes(2, "little") + (5).to_bytes(2, "little"), np.uint8)
    gens = api.get_ristretto255_generators(4, offset=2)
    with_gens = api.compute_curve25519_commitments([api.SequenceDescriptor(2, 2, data)], generators=gens)
    with_offset = api.compute_curve25519_commitments([api.SequenceDescriptor(2, 2, data)], generators_offset=2)
    want = R.ristretto_encode(R.naive_msm([3, 5], [R.compute_base_element(2), R.compute_base_element(3)]))
    assert bytes(with_gens[0]) == bytes(with_offset[0]) == want
    one = api.get_curve25519_one_commit(6)
    acc = R.IDENTITY
    for i in range(6):
        acc = R.pt_add(acc, R.compute_base_element(i))
    assert bytes(api.compress_ristretto255(one)) == R.ristretto_encode(acc)


def test_compress_decompress_roundtrip():
    api.init("cpu")
    enc = api.compress_ristretto255(api.get_ristretto255_generators(6))
    assert [bytes(e) for e in enc] == [R.ristretto_encode(R.compute_base_element(i)) for i in range(6)]
    pts, valid = api.decompress_ristretto255(enc)
    assert valid.all()
    assert np.array_equal(api.compress_ristretto255(pts), enc)


def test_empty_and_zero_length_inputs():
    api.init("cpu")
    assert api.compute_curve25519_commitments([]).shape == (0, 32)
    got = api.compute_curve25519_commitments([api.SequenceDescriptor(8, 0, np.zeros(0, np.uint8))] * 2)
    assert got.shape == (2, 32) and not got.any()


def test_validation_and_one_shot_init():
    api.init("cpu")
    with pytest.raises(RuntimeError):
        api.init("cpu")
    with pytest.raises(ValueError):
        api.compute_curve25519_commitments([api.SequenceDescriptor(17, 1, np.zeros(17, np.uint8), True)])
    with pytest.raises(ValueError):
        api.compute_curve25519_commitments([api.SequenceDescriptor(33, 1, np.zeros(33, np.uint8))])


def test_no_cuda_means_no_default_device():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the policy for hosts without one does not apply")
    for call in (api.init, lambda: api.init("gpu"), lambda: api.get_ristretto255_generators(3)):
        api.reset_backend_for_testing()
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    api.reset_backend_for_testing()
    with pytest.raises(ValueError):
        api.init("tpu")


def test_point_converters_default_to_the_card():
    from blitzar_tpu_torch.utils.limbs import from_jax_points, handle_from_jax_table

    coords = np.zeros((4, 16, 4), np.uint32)
    assert from_jax_points(coords, device="cpu").x.device.type == "cpu"
    if torch.cuda.is_available():
        assert from_jax_points(coords).x.is_cuda
        return
    table = np.zeros((16, 1, 4), np.uint32)
    for call in (lambda: from_jax_points(coords), lambda: handle_from_jax_table(table, table, table, table)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


def _port_files():
    pkg = os.path.join(REPO, "blitzar_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "blitzar_tpu"), f"{path}: imports {name}"


def test_import_loads_neither_jax_nor_blitzar_tpu():
    modules = sorted(
        "blitzar_tpu_torch." + os.path.relpath(p, REPO)[len("blitzar_tpu_torch/") : -3].replace(os.sep, ".")
        for p in _port_files()
        if p.startswith(os.path.join(REPO, "blitzar_tpu_torch") + os.sep) and not p.endswith("__init__.py")
    )
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib\n"
        "for m in %r: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'blitzar_tpu')]\n"
        "print('LOADED', len([m for m in sys.modules if m.startswith('blitzar_tpu_torch')]), bad)\n"
    ) % (REPO, modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd="/", timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout
