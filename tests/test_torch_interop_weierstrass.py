"""Handle files of blitzar_tpu_torch against blitzar_tpu on bls12-381 G1,
bn254 G1 and Grumpkin: the reference's raw format written byte for byte as
blitzar_tpu writes it for the same table (identity entries included: entry
0 of every group and the sums of an identity generator), and each package
reading the other's raw and npz files with equal query results, equal to
the oracle's sums. blitzar_tpu's handle here holds the port's point table
(its own table build is held against the port's in
tests/test_torch_wcommit_*.py), so it compiles only its writer and query."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.msm import interop as jinterop
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.msm import interop as tinterop
from blitzar_tpu_torch.utils.limbs import from_jax_points

N, W = 12, 4
CURVES = [(j, t) for j in (jwc.BLS12381_G1, jwc.BN254_G1, jwc.GRUMPKIN) for t in twc.CURVES if t.name == j.name]
SCALARS = np.random.default_rng(32).integers(0, 256, size=(2, N, 3), dtype=np.uint8)


@pytest.fixture(scope="module", params=CURVES, ids=[j.name for j, _ in CURVES])
def case(request):
    jc, tc = request.param
    pts = tc.oracle.random_points(N, seed=33)
    pts[5] = None  # an identity generator: its table entries repeat others
    th = tfixed.MultiexpHandle(tc.from_affine_ints(pts, "cpu"), window_width=W, curve=tc)
    jh = jfixed.MultiexpHandle.__new__(jfixed.MultiexpHandle)
    jh.curve, jh.window_width, jh.n, jh.num_groups = jc, W, N, N // W
    jh.table = jc.make_point(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in th.point_table()))
    want = [tc.oracle.msm([int.from_bytes(bytes(r), "little") for r in rows], pts) for rows in SCALARS]
    assert tc.to_affine_ints(tfixed.fixed_multiexponentiation(th, SCALARS)) == want
    return {"jc": jc, "tc": tc, "jh": jh, "th": th, "want": want}


def _jax_affine(case, p):
    return case["tc"].to_affine_ints(from_jax_points(np.stack([np.asarray(c) for c in p]), device="cpu"))


def test_raw_file_bytes_equal_jax(case, tmp_path):
    tc = case["tc"]
    tinterop.write_reference_file(case["th"], tmp_path / "port.raw")
    jinterop.write_reference_file(case["jh"], str(tmp_path / "jax.raw"))
    data = (tmp_path / "port.raw").read_bytes()
    assert data == (tmp_path / "jax.raw").read_bytes()
    k = tc.nlimbs // 4
    rows = np.frombuffer(data[4:], "<u8").reshape(-1, 2 * k)
    assert rows.shape[0] == (N // W) << W
    one = [int(v) for v in np.frombuffer(tc.field.const(1, (1,)).numpy().astype("<u2").tobytes(), "<u8")]
    ident = rows[:, k - 1] == np.uint64(2**64 - 1)
    # entry 0 of each group, and entry {1} of group 1 (generator 5 alone)
    assert ident[0] and ident[(1 << W) + 2] and ident.sum() == N // W + 1
    assert all(r[:k - 1].tolist() == [0] * (k - 1) and r[k:].tolist() == one for r in rows[ident])


def test_each_reads_the_others_raw_file(case, tmp_path):
    tc, th = case["tc"], case["th"]
    tinterop.write_reference_file(th, tmp_path / "port.raw")
    jinterop.write_reference_file(case["jh"], str(tmp_path / "jax.raw"))
    got = tinterop.read_reference_file(str(tmp_path / "jax.raw"), tc, "cpu")
    assert (got.window_width, got.num_groups, got.n, got.curve) == (W, N // W, N, tc)
    assert tc.to_affine_ints(tfixed.fixed_multiexponentiation(got, SCALARS)) == case["want"]
    # the file's affine entries are z = 1 points of the same table
    assert bool(tc.points_equal(got.point_table(), th.point_table()).all())
    jgot = jinterop.read_reference_file(str(tmp_path / "port.raw"), case["jc"])
    assert _jax_affine(case, jfixed.fixed_multiexponentiation(jgot, SCALARS)) == case["want"]


def test_each_reads_the_others_npz(case, tmp_path):
    tc, th = case["tc"], case["th"]
    th.write_to_file(str(tmp_path / "port.npz"))
    case["jh"].write_to_file(str(tmp_path / "jax.npz"))
    got = tfixed.MultiexpHandle.new_from_file(str(tmp_path / "jax.npz"), tc, "cpu")
    assert torch.equal(got.table, th.table) and got.n == N
    assert tc.to_affine_ints(tfixed.fixed_multiexponentiation(got, SCALARS)) == case["want"]
    jgot = jfixed.MultiexpHandle.new_from_file(str(tmp_path / "port.npz"), case["jc"])
    assert _jax_affine(case, jfixed.fixed_multiexponentiation(jgot, SCALARS)) == case["want"]
    with pytest.raises(ValueError, match=tc.name):
        other = next(c for c in twc.CURVES if c is not tc)
        tfixed.MultiexpHandle.new_from_file(str(tmp_path / "port.npz"), other, "cpu")
