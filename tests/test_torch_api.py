"""blitzar_tpu_torch.api on the CPU backend: the upstream vectors, the
engine edge cases against blitzar_tpu's oracle, the device policy, and the rule
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
    """The edge cases in one call, each output against blitzar_tpu's
    pure-Python oracle (refimpl/core.py; its jitted API compiled ~60 s for
    this call's shape)."""
    api.init("cpu")
    descs = []
    for _, vals, signed in EDGE_OUTPUTS:
        descs += _descriptors(api, [vals], NBYTES, signed)
    got = api.compute_curve25519_commitments(descs)
    gens = R.get_generators(N_GENS)
    want = [R.ristretto_encode(R.pedersen_commitment([v % (1 << (8 * NBYTES)) for v in vals], NBYTES, signed, gens))
            for _, vals, signed in EDGE_OUTPUTS]
    bad = [name for (name, _, _), g, w in zip(EDGE_OUTPUTS, got, want) if bytes(g) != w]
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
    # the card-only tests run where jax is not installed
    yield os.path.join(REPO, "tests", "test_torch_cuda.py")


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


def test_every_launcher_has_its_signature():
    """Each C launcher of csrc/*.cu (the streamed path's build_cached_table
    and tree_reduce_lanes included) has its ctypes signature in ops/build.py,
    and each signature its launcher, with as many arguments."""
    import re

    from blitzar_tpu_torch.ops import build

    found = {}
    for src in build.sources():
        for name, params in re.findall(r'extern "C" int (btt_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert {k: len(v) for k, v in build.SIGNATURES.items()} == found


# ---------------------------------------------------------------------------
# curve ids, the handle signature and the handle cache (all four curves)
# ---------------------------------------------------------------------------


def test_multiexp_handle_new_takes_the_curve_id_first():
    """sxt_multiexp_handle_new(curve_id, generators, n) (reference
    blitzar_api.h:631), as blitzar_tpu.api.multiexp_handle_new."""
    from blitzar_tpu_torch.curves import edwards25519 as ted
    from blitzar_tpu_torch.curves import weierstrass as twc

    api.init("cpu")
    assert {k: getattr(api, k) for k in dir(japi) if k.startswith("SXT_CURVE_")} == {
        k: getattr(japi, k) for k in dir(japi) if k.startswith("SXT_CURVE_")}
    assert api.CURVES == {0: ted, 1: twc.BLS12381_G1, 2: twc.BN254_G1, 3: twc.GRUMPKIN}
    gens = api.get_ristretto255_generators(4)
    handle = api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, gens)
    scalars = np.stack([[np.frombuffer(int(v).to_bytes(4, "little"), np.uint8) for v in row] for row in RUST_DATA])
    got = api.compress_ristretto255(api.fixed_multiexponentiation(handle, scalars))
    assert [bytes(g) for g in got] == RUST_EXPECTED
    pts = twc.BN254_G1.oracle.random_points(5, seed=1)
    whandle = api.multiexp_handle_new(api.SXT_CURVE_BN_254, twc.BN254_G1.from_affine_ints(pts, "cpu"), n=3)
    assert whandle.curve is twc.BN254_G1 and whandle.n == 3
    one = np.zeros((1, 3, 1), np.uint8)
    one[0, 2, 0] = 1
    assert twc.BN254_G1.to_affine_ints(api.fixed_multiexponentiation(whandle, one)) == [pts[2]]
    with pytest.raises(ValueError, match="curve id"):
        api.multiexp_handle_new(7, gens)
    with pytest.raises(TypeError):
        api.multiexp_handle_new(gens)


def test_curve_maps_name_each_curve_once():
    """CURVE_IDS inverts CURVES; COMMITMENT_ENTRIES gives each Weierstrass
    curve the entry that blitzar_tpu names alike, and the README's bn254
    example runs through it."""
    from blitzar_tpu_torch.curves import weierstrass as twc

    assert {api.CURVES[i]: i for i in api.CURVES} == api.CURVE_IDS
    assert set(api.COMMITMENT_ENTRIES) == set(twc.CURVES)
    assert all(callable(getattr(japi, e.__name__)) for e in api.COMMITMENT_ENTRIES.values())
    api.init("cpu")
    desc = api.SequenceDescriptor(element_nbytes=4, n=3, data=np.arange(12, dtype=np.uint8))
    g = (1, 2)
    pts = [g, (g[0], twc.BN254_G1.field.modulus - g[1]), None]
    structs = api.COMMITMENT_ENTRIES[twc.BN254_G1]([desc], twc.BN254_G1.from_affine_ints(pts, api.device()))
    s = [int.from_bytes(bytes(desc.rows()[i]), "little") for i in range(3)]
    want = twc.BN254_G1.oracle.msm([s[0] - s[1]], [g])
    assert (bytes(structs["x"][0]), bytes(structs["y"][0])) == (want[0].to_bytes(32, "little"), want[1].to_bytes(32, "little"))


def test_field_table_names_each_field_once():
    """The proof fields' C ABI ids equal blitzar_tpu's; each id's codec
    works in the field the kernels take for that id; the frozen sumcheck
    vectors are keyed by the codecs' names."""
    import torch_proof_vectors as vec
    from blitzar_tpu_torch.fields import params as tparams
    from blitzar_tpu_torch.ops import cuda_mont

    assert (api.SXT_FIELD_SCALAR255, api.SXT_FIELD_GRUMPKIN) == (japi.SXT_FIELD_SCALAR255, japi.SXT_FIELD_GRUMPKIN)
    assert sorted(api.FIELD_CODECS) == sorted(cuda_mont.FIELDS)
    for field_id, codec in api.FIELD_CODECS.items():
        assert codec.field_id == field_id and codec.field is cuda_mont.FIELDS[field_id]
        assert cuda_mont._field_id(codec.field) == field_id
    assert {name for name, _ in vec.SUMCHECK} == {c.name for c in api.FIELD_CODECS.values()}
    with pytest.raises(ValueError):
        cuda_mont._field_id(tparams.BN254_FP)


def test_handle_cache_keeps_curves_apart():
    """Generators of two curves with equal limbs (here the very same
    tensors) get two handles, each of its own curve; a Weierstrass batch
    sharing its x tensor with a ristretto255 one too."""
    from blitzar_tpu_torch.curves import edwards25519 as ted
    from blitzar_tpu_torch.curves import weierstrass as twc
    from blitzar_tpu_torch.msm import engine

    engine.clear_handle_cache()
    n = 8
    x = twc.BN254_G1.from_affine_ints([None] * n, "cpu").x
    w_pts = twc.PointP2(x, x.clone(), x.clone())
    ed_pts = ted.PointP3(x, x.clone(), x.clone(), x.clone())
    handles = [
        engine.cached_handle(w_pts, n, twc.BN254_G1),
        engine.cached_handle(w_pts, n, twc.GRUMPKIN),
        engine.cached_handle(ed_pts, n),
    ]
    assert [h.curve for h in handles] == [twc.BN254_G1, twc.GRUMPKIN, ted]
    assert len({id(h) for h in handles}) == 3
    assert engine.cached_handle(w_pts, n, twc.GRUMPKIN) is handles[1]
    copy = twc.PointP2(x.clone(), x.clone(), x.clone())  # equal limbs in fresh tensors
    assert engine.cached_handle(copy, n, twc.BN254_G1) is handles[0]
    assert engine.cached_handle(copy, n, twc.GRUMPKIN) is handles[1]
    assert engine._content_digest(w_pts, n, twc.BN254_G1) != engine._content_digest(w_pts, n, twc.GRUMPKIN)
    engine.clear_handle_cache()


def test_weierstrass_entries_validate_and_keep_the_device():
    from blitzar_tpu_torch.curves import weierstrass as twc

    api.init("cpu")
    gens = twc.GRUMPKIN.from_affine_ints(twc.GRUMPKIN.oracle.random_points(2, seed=2), "cpu")
    assert api.compute_grumpkin_uncompressed_commitments_with_generators([], gens).shape == (0,)
    assert api.compute_bls12_381_g1_commitments_with_generators([], gens).shape == (0, 48)
    with pytest.raises(ValueError):
        api.compute_grumpkin_uncompressed_commitments_with_generators(
            [api.SequenceDescriptor(33, 1, np.zeros(33, np.uint8))], gens)
    elsewhere = twc.PointP2(*(c.to("meta") for c in gens))
    with pytest.raises(ValueError, match="backend"):
        api.compute_grumpkin_uncompressed_commitments_with_generators(
            [api.SequenceDescriptor(1, 2, np.ones(2, np.uint8))], elsewhere)
    with pytest.raises(ValueError, match="backend"):
        api.multiexp_handle_new(api.SXT_CURVE_GRUMPKIN, elsewhere)


# ---------------------------------------------------------------------------
# the handle cache and the shared generators give the commitment of the
# generators as they are at the call
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """The plain handle builds run many small ops: one thread a worker
    keeps the parallel test run from oversubscribing the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit_column(n: int, i: int):
    """One 1-byte column of n scalars: 1 at i, else 0 (its commitment is
    generator i)."""
    data = np.zeros((n, 1), np.uint8)
    data[i] = 1
    return [api.SequenceDescriptor(1, n, data)]


def test_written_generators_give_the_new_commitment(one_thread):
    """An in-place write to the generators after a commitment: the next
    commitment is over the new content, not the cached handle's."""
    from blitzar_tpu_torch.curves import edwards25519 as ted

    api.init("cpu")
    n = 16
    a = ted.PointP3(*(c.clone() for c in api.get_ristretto255_generators(n)))
    b = api.get_ristretto255_generators(n, offset=100)
    data = np.random.default_rng(31).integers(0, 256, size=(n, 4), dtype=np.uint8)
    desc = [api.SequenceDescriptor(4, n, data)]
    first = api.compute_curve25519_commitments(desc, generators=a)
    for dst, src in zip(a, b):
        dst.copy_(src)
    vals = [int.from_bytes(bytes(r), "little") for r in data]
    want = R.ristretto_encode(R.naive_msm(vals, [R.compute_base_element(100 + i) for i in range(n)]))
    got = api.compute_curve25519_commitments(desc, generators=a)
    assert bytes(got[0]) == want and bytes(first[0]) != want


def test_generators_differing_at_an_unsampled_point_get_their_own_handle(one_thread):
    """Two generator sets equal but at point 4, which the handle cache's
    digest does not sample at n = 200: each commits to its own point 4."""
    from blitzar_tpu_torch.msm import engine

    api.init("cpu")
    n = 200
    sampled = set(np.linspace(0, n - 1, num=64, dtype=np.int64)) | set(range(4)) | set(range(n - 4, n))
    assert 4 not in sampled
    gens = api.get_ristretto255_generators(n)
    other = api.get_ristretto255_generators(1, offset=300)
    assert engine._content_digest(gens, n) == engine._content_digest(gens, n)
    first = api.compute_curve25519_commitments(_unit_column(n, 4), generators=gens)
    fresh = type(gens)(*(c.clone() for c in gens))
    for dst, src in zip(fresh, other):
        dst[:, 4] = src[:, 0]
    assert engine._content_digest(fresh, n) == engine._content_digest(gens, n)
    got = api.compute_curve25519_commitments(_unit_column(n, 4), generators=fresh)
    assert bytes(first[0]) == R.ristretto_encode(R.compute_base_element(4))
    assert bytes(got[0]) == R.ristretto_encode(R.compute_base_element(300))


def test_written_copy_of_the_generators_leaves_the_defaults(one_thread):
    """get_ristretto255_generators hands out a copy: zeroing it changes no
    later commitment over the default generators."""
    from blitzar_tpu_torch.msm import engine

    api.init("cpu")
    n = 8
    before = api.compute_curve25519_commitments(_unit_column(n, 2))
    api.get_ristretto255_generators(n).x.zero_()
    engine.clear_handle_cache()
    after = api.compute_curve25519_commitments(_unit_column(n, 2))
    assert bytes(after[0]) == bytes(before[0]) == R.ristretto_encode(R.compute_base_element(2))
