"""The kernels' own arithmetic (csrc/fp25519.cuh, csrc/edwards25519.cuh,
csrc/mont.cuh, csrc/weierstrass.cuh, csrc/tree_reduce.cuh), compiled for the host with g++ through
csrc/host_harness.cpp, against blitzar_tpu (curve25519) and the plain
PyTorch versions (the Montgomery fields and the Weierstrass curves, which
tests/test_torch_mont.py and tests/test_torch_weierstrass.py hold against
blitzar_tpu) on seeded values and edge cases: the one check of the CUDA
code's carries that needs no card."""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import weierstrass as wc
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.ops import cuda_point, cuda_wpoint
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, to_jax_points, to_tensor

import torch_host_harness

P = 2**255 - 19
EDGES = [0, 1, 2, 19, 38, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2**255 - 1, 2**255, 2**256 - 1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small ops: one thread a worker keeps the
    parallel test run from oversubscribing the host (the tree cases' plain
    sums over thousands of points took minutes under six workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


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


def test_cadd_and_to_cached_match(harness):
    """ge_to_cached and the 8-multiply ge_cadd (doublings among the pairs)
    against blitzar_tpu's to_cached and _cadd_impl; canonical limbs."""
    p, _ = _points(8)
    q, _ = _points(9)
    q[:, :, :4] = p[:, :, :4]
    cached = _run(harness.btt_host_to_cached, q, out_shape=(4,) + q.shape[1:])
    tq = ted.PointP3(*(to_tensor(c) for c in q))
    want_cached = np.stack([c.numpy() for c in cuda_point.unpack_cached(cuda_point.pack_cached(ted.to_cached(tq)))])
    assert np.array_equal(cached, want_cached)
    assert np.array_equal(cached.astype(np.uint32), _canon_point(jed.to_cached(_jax_point(q))))
    got = _run(harness.btt_host_ed_cadd, p, cached, out_shape=p.shape)
    jc = jed.Cached(*(jnp.asarray(c.astype(np.uint32)) for c in cached))
    assert np.array_equal(got.astype(np.uint32), _canon_point(jed._cadd_impl(_jax_point(p), jc)))


def _niels_of(points) -> np.ndarray:
    """(4, 16, n) canonical points -> (3, 16, n) niels limbs (the port's
    conversion, held against blitzar_tpu's in test_madd_and_to_niels_match)."""
    tp = ted.PointP3(*(to_tensor(c) for c in points))
    return np.stack([c.numpy() for c in cuda_point.unpack_niels(cuda_point.pack_niels(ted.to_niels(tp)))])


def test_niels_add_matches_jax(harness):
    """ge_niels_add (niels_add.cu), a doubling among the pairs, against
    blitzar_tpu's _niels_add_impl: canonical limbs."""
    p, _ = _points(11)
    q, _ = _points(12)
    q[:, :, :4] = p[:, :, :4]
    n1, n2 = _niels_of(p), _niels_of(q)
    got = _run(harness.btt_host_niels_add, n1, n2, out_shape=p.shape)
    jn = [jed.Niels(*(jnp.asarray(c.astype(np.uint32)) for c in n)) for n in (n1, n2)]
    assert np.array_equal(got.astype(np.uint32), _canon_point(jed._niels_add_impl(*jn)))


@pytest.mark.parametrize("size", [256, 512])
def test_niels_tree_body_matches_plain(harness, size):
    """fewrow_niels.cu's blocks (csrc/niels_tree.cuh: each lane's leaves
    depth first over its stack, then the lanes halved), run by the harness
    column by column on a table of ``size`` groups of 4 entries (w = 2, one
    chunk; the identity among the entries): the plain version's
    coordinates, limb for limb; a chunk size no launch takes (128 groups)
    returns -1."""
    w, nbytes = 2, 2
    pts, _ = _points(13, count=size << w)
    pts[:, :, 5] = to_jax_points(ted.identity((1,)))[:, :, 0]
    entries = cuda_point.pack_niels(ted.to_niels(ted.PointP3(*(to_tensor(c) for c in pts))))
    table = entries.reshape(size, 1 << w, 3, 8).contiguous()
    scalars = torch.from_numpy(np.random.default_rng(size).integers(0, 256, size=(1, size * w, nbytes), dtype=np.uint8))
    rows = 8 * nbytes
    out = np.zeros((4, 16, rows), np.int32)

    def call(groups):
        return harness.btt_host_fewrow_niels(
            ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(scalars.data_ptr()), None, ctypes.c_int64(1),
            ctypes.c_int64(groups * w), ctypes.c_int(nbytes), ctypes.c_int(w), ctypes.c_int64(groups),
            ctypes.c_void_p(out.ctypes.data))

    want = cuda_point.fewrow_niels_plain(table, scalars, None, w, size)
    assert call(size) == 0
    assert np.array_equal(out.reshape(4, 16, 1, rows), np.stack([TF.canonicalize(c).numpy() for c in want]))
    assert call(128) == -1


def _tree_input(curve, size: int, cols: int):
    """A (size, cols) batch of curve points (an identity among them) as the
    harness's (coords, nlimbs, size * cols) array, and the port's batch; a
    Weierstrass batch tiles at most 599 oracle points (a prime period)."""
    if curve is None:
        pts, _ = _points(10 + size, count=size * cols)
        pts[:, :, 1] = to_jax_points(ted.identity((1,)))[:, :, 0]
        batch = ted.reshape_batch(ted.PointP3(*(to_tensor(c) for c in pts)), (size, cols))
        return pts, batch
    count = size * cols - 1
    pts = curve.oracle.random_points(min(count, 599), seed=size)
    batch = curve.from_affine_ints([pts[i % len(pts)] for i in range(count)] + [None], "cpu")
    return _stack(batch), curve.reshape_batch(batch, (size, cols))


# (size, cols): two columns (a warp spans one column's 32 rows), one column
# of 1000 (256 threads of 3-4 points), 37 columns (warps of 2 columns and
# 16 rows, 19 tiles, the last half idle), and a query's (K, R) partials'
# narrow cousin (1024, 8). All are small batches (tree_reduce.cuh): one
# block holds a column; the order of a larger batch, whose column tiles
# take several blocks, differs only in T, and the card tests cover it
TREE_SHAPES = [(1, 2), (3, 2), (300, 2), (1000, 1), (70, 37), (1024, 8)]


@pytest.mark.parametrize("curve", [None] + list(wc.CURVES), ids=lambda c: "ristretto255" if c is None else c.name)
@pytest.mark.parametrize("size, cols", TREE_SHAPES,
                         ids=[str(s) if c == 2 else f"{s}x{c}" for s, c in TREE_SHAPES])
def test_tree_reduce_lanes_body_matches_plain(harness, curve, size, cols):
    """tree_reduce_lanes.cu's order (tree_reduce.cuh), run by the harness
    column by column: the threads' strided serial sums, then the halving
    levels inside a block and across a column tile's blocks. The sum is the
    plain version's point."""
    arr, batch = _tree_input(curve, size, cols)
    curve_id = 0 if curve is None else curve.kernel_id
    out = np.zeros(arr.shape[:2] + (cols,), np.int32)
    rc = harness.btt_host_tree_reduce(ctypes.c_int(curve_id), ctypes.c_void_p(np.ascontiguousarray(arr).ctypes.data),
                                      ctypes.c_int64(size), ctypes.c_int64(cols), ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    got = type(batch)(*(torch.from_numpy(c) for c in out))
    if curve is None:
        want = cuda_point.tree_reduce_lanes_plain(batch)
        assert bool(ted.points_equal(got, want).all())
    else:
        want = cuda_wpoint.w_tree_reduce_lanes_plain(curve, batch)
        assert curve.to_affine_ints(got) == curve.to_affine_ints(want)


def test_elligator_form_matches_plain(harness):
    """Against the plain version, which tests/test_torch_curve.py holds
    against blitzar_tpu's elligator (and whose JAX run costs ~40 s here)."""
    _, r = _points(7, count=64)
    r[:, :, 0] = 0
    got = _run(harness.btt_host_elligator_form, r[0], r[1], out_shape=(4, 16, 64))
    want = to_jax_points(cuda_point.elligator_form_plain(to_tensor(r[0]), to_tensor(r[1])))
    assert np.array_equal(got.astype(np.uint32), want)


# ---------------------------------------------------------------------------
# Montgomery fields and Weierstrass curves (mont.cuh, weierstrass.cuh)
# ---------------------------------------------------------------------------


def _mont_values(field, seed: int, count: int = 120):
    """Edge values (0, 1, m - 1, (m -+ 1) / 2, R mod m, ...) and seeded
    random ones, as a canonical Montgomery-form (nlimbs, n) tensor."""
    m = field.modulus
    edges = [0, 1, 2, m - 1, m - 2, (m - 1) // 2, (m + 1) // 2, field.r, (1 << (field.radix_bits - 1)) % m]
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(field.nbytes), "little") % m for _ in range(count)]
    return field.from_ints(edges + rand, "cpu")


MONT_OPS = {
    "mul": (0, lambda F, a, b: F.mul(a, b)),
    "sq": (1, lambda F, a, b: F.sq(a)),
    "add": (2, lambda F, a, b: F.add(a, b)),
    "sub": (3, lambda F, a, b: F.sub(a, b)),
    "neg": (4, lambda F, a, b: F.neg(a)),
    # against exact inverses (tests/test_torch_mont.py holds the plain inv
    # against blitzar_tpu; its ~1.5 * 381 multiplies are slow here)
    "inv": (5, lambda F, a, b: F.from_ints([pow(v, F.modulus - 2, F.modulus) for v in F.to_ints(a)], "cpu")),
}


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
@pytest.mark.parametrize("op", sorted(MONT_OPS))
def test_mont_ops_match_plain(harness, curve, op):
    field = curve.field
    a, b = _mont_values(field, 1), _mont_values(field, 2).flip(1)
    code, plain = MONT_OPS[op]
    fn = functools.partial(harness.btt_host_mont, ctypes.c_int(curve.kernel_id), ctypes.c_int(code))
    got = _run(fn, a.numpy(), b.numpy(), out_shape=tuple(a.shape))
    assert np.array_equal(got, plain(field, a, b).numpy())


def _stack(p) -> np.ndarray:
    return np.stack([c.numpy() for c in p])


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_weierstrass_add_double_match_plain(harness, curve):
    """Projective inputs with z != 1 (doubles of affine points), the
    identity, P + P and P + (-P)."""
    orc = curve.oracle
    pts = orc.random_points(10, seed=3)
    ps = pts + [None, pts[0], pts[1], pts[2]]
    qs = orc.random_points(10, seed=4) + [pts[3], pts[0], orc.neg(pts[1]), None]
    p = curve._double_impl(curve.from_affine_ints(ps, "cpu"))
    q = curve._double_impl(curve.from_affine_ints(qs, "cpu"))
    fn = functools.partial(harness.btt_host_w, ctypes.c_int(curve.kernel_id))
    got = _run(functools.partial(fn, ctypes.c_int(0)), _stack(p), _stack(q), out_shape=_stack(p).shape)
    assert np.array_equal(got, _stack(curve._add_impl(p, q)))
    got = _run(functools.partial(fn, ctypes.c_int(1)), _stack(p), _stack(q), out_shape=_stack(p).shape)
    assert np.array_equal(got, _stack(curve._double_impl(p)))
    assert curve.to_affine_ints(curve._add_impl(p, q))[-3:] == [orc.add(orc.add(a, a), orc.add(b, b)) for a, b in zip(ps[-3:], qs[-3:])]


@pytest.mark.parametrize("curve", wc.CURVES, ids=lambda c: c.name)
def test_mul_b3_matches_montgomery_multiply(harness, curve):
    """weierstrass.cuh's mul_b3 (x * 3b by modular additions: 3b = 12, 9,
    -51) against mf_mul by 3b in Montgomery form and the plain multiply by
    the constant: equal canonical words at the words 0, 1 and m - 1, at the
    values 0, 1 and m - 1, and at seeded random values."""
    field = curve.field
    m = field.modulus
    r_inv = pow(field.r, -1, m)
    words = [0, 1, m - 1]  # Montgomery words w hold the value w R^-1
    a = torch.cat([field.from_ints([w * r_inv % m for w in words], "cpu"), _mont_values(field, 5)], dim=1)
    assert field.to_ints(a)[:3] == [w * r_inv % m for w in words]
    fn = functools.partial(harness.btt_host_mul_b3, ctypes.c_int(curve.kernel_id))
    by_adds = _run(functools.partial(fn, ctypes.c_int(0)), a.numpy(), out_shape=tuple(a.shape))
    by_mul = _run(functools.partial(fn, ctypes.c_int(1)), a.numpy(), out_shape=tuple(a.shape))
    assert np.array_equal(by_adds, by_mul)
    assert np.array_equal(by_adds, field.mul_const(a, curve.b3).numpy())
    assert field.to_ints(torch.from_numpy(by_adds)) == [v * curve.b3 % m for v in field.to_ints(a)]


# ---------------------------------------------------------------------------
# the proof fields and the sumcheck kernels' lane code (mont.cuh Scalar25519
# and Bn254Fr by SXT_FIELD_* id, sumcheck.cuh)
# ---------------------------------------------------------------------------

from blitzar_tpu_torch.fields import params as tparams  # noqa: E402
from blitzar_tpu_torch.ops import cuda_mont  # noqa: E402

PROOF_FIELDS = [(0, tparams.SCALAR25519), (1, tparams.BN254_FR)]


@pytest.mark.parametrize("field_id,field", PROOF_FIELDS, ids=["scalar25519", "bn254_fr"])
@pytest.mark.parametrize("op", sorted(MONT_OPS))
def test_proof_field_ops_match_plain(harness, field_id, field, op):
    """The Scalar25519 instantiation (and Bn254Fr by its field id) against
    the plain field, which tests/test_torch_proof_kernels.py holds against
    blitzar_tpu."""
    a, b = _mont_values(field, 3), _mont_values(field, 4).flip(1)
    code, plain = MONT_OPS[op]
    fn = functools.partial(harness.btt_host_field_mont, ctypes.c_int(field_id), ctypes.c_int(code))
    got = _run(fn, a.numpy(), b.numpy(), out_shape=tuple(a.shape))
    assert np.array_equal(got, plain(field, a, b).numpy())


@pytest.mark.parametrize("field_id,field", PROOF_FIELDS, ids=["scalar25519", "bn254_fr"])
def test_mul_reduces_raw_rows_below_r(harness, field_id, field):
    """mf_mul with a below R (not m) and b canonical, as cuda_mont.to_mont
    and reduce_residues use it: the canonical a b R^-1."""
    rng = np.random.default_rng(5)
    raw = [0, field.modulus, field.modulus + 1, 2 * field.modulus - 1, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(40)]
    a = torch.from_numpy(np.array([field.int_limbs(v) for v in raw], np.int32).T.copy())
    b = torch.from_numpy(np.array([field.int_limbs(field.r2)] * len(raw), np.int32).T.copy())
    got = _run(functools.partial(harness.btt_host_field_mont, ctypes.c_int(field_id), ctypes.c_int(0)),
               a.numpy(), b.numpy(), out_shape=tuple(a.shape))
    assert field.to_ints(torch.from_numpy(got)) == [v % field.modulus for v in raw]
    assert torch.equal(torch.from_numpy(got), cuda_mont.to_mont(field, a))


def _i32(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("field_id,field", PROOF_FIELDS, ids=["scalar25519", "bn254_fr"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sum_and_fold_lanes_match_plain(harness, field_id, field, degree):
    """sumcheck.cuh's round in evaluation form (every product length up to
    the degree, a repeated MLE; a grid of 2 x 2 threads) and fold_lane,
    lane after lane, against the plain versions of ops/cuda_mont.py."""
    m, mid = 3, 5
    rng = np.random.default_rng(degree)
    mles = field.from_ints([int.from_bytes(rng.bytes(32), "little") for _ in range(m * 2 * mid)], "cpu")
    mles = mles.reshape(field.nlimbs, m, 2 * mid).contiguous()
    lengths = list(range(1, degree + 1))
    terms = [int(t) for t in rng.integers(0, m, size=sum(lengths))]
    mults = field.from_ints([int(v) for v in rng.integers(1, 2**62, size=degree)], "cpu")
    lt, tt = torch.tensor(lengths, dtype=torch.int32), torch.tensor(terms, dtype=torch.int32)
    out = torch.zeros((field.nlimbs, degree + 1), dtype=torch.int32)
    interp = cuda_mont.interpolation(field, degree, "cpu")
    rc = harness.btt_host_sum_round(ctypes.c_int(field_id), ctypes.c_int(degree), _i32(mles), ctypes.c_int64(m),
                                    ctypes.c_int64(mid), _i32(mults), ctypes.c_int(degree), _i32(lt), _i32(tt),
                                    _i32(interp), ctypes.c_int64(2), ctypes.c_int64(2), _i32(out))
    assert rc == 0
    assert torch.equal(out, cuda_mont.mont_sum_round_plain(field, mles, mults, lt, tt, degree))
    r = field.from_ints([int.from_bytes(rng.bytes(32), "little")], "cpu")
    folded = torch.zeros((field.nlimbs, m, mid), dtype=torch.int32)
    assert harness.btt_host_fold_round(ctypes.c_int(field_id), _i32(mles), ctypes.c_int64(m), ctypes.c_int64(mid),
                                       _i32(r), _i32(folded)) == 0
    assert torch.equal(folded, cuda_mont.mont_fold_round_plain(field, mles, r))
