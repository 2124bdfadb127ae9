"""blitzar_tpu_torch.ops.cuda_field (the fmul, fsq and finvert wrappers and
their plain versions) and the batch inversions against blitzar_tpu on the
same numpy limbs, canonically: the edges 0, p and values above p included.
Also the radix-2^51 and u64 word conversions of utils/limbs.py against
blitzar_tpu's numpy ones, and mont_mul_ew's plain path in the two
Weierstrass base fields. On the CPU the wrappers run their plain versions;
tests/test_torch_cuda.py holds the kernels against them on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu.utils import limbs as jlimbs
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.fields import params as tparams
from blitzar_tpu_torch.ops import cuda_field, cuda_mont
from blitzar_tpu_torch.utils import limbs as tlimbs
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints, to_tensor

P = 2**255 - 19
EDGES = [0, 1, 2, 19, P - 1, P, P + 1, 2 * P - 1, 2**255 - 1, 2**256 - 1]


def _values(seed: int, count: int = 30) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    return EDGES + [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


A = _values(11)
B = _values(12)[::-1]


def _jax(vals):
    return jnp.asarray(ints_to_limbs(vals).astype(np.uint32))


def _canon(x) -> list[int]:
    if isinstance(x, torch.Tensor):
        return limbs_to_ints(TF.canonicalize(x.reshape(16, -1)))
    return limbs_to_ints(np.asarray(JF.canonicalize(x)).reshape(16, -1))


@pytest.mark.parametrize("wrapper", ["kernel_wrapper", "plain"])
def test_fmul_fsq_finvert_match_jax(wrapper):
    a, b = to_tensor(ints_to_limbs(A)), to_tensor(ints_to_limbs(B))
    ja, jb = _jax(A), _jax(B)
    ops = {
        "kernel_wrapper": (cuda_field.fmul, cuda_field.fsq, cuda_field.finvert),
        "plain": (cuda_field.fmul_plain, cuda_field.fsq_plain, cuda_field.finvert_plain),
    }[wrapper]
    fmul, fsq, finvert = ops
    assert _canon(fmul(a, b)) == _canon(JF.mul(ja, jb)) == [x * y % P for x, y in zip(A, B)]
    assert _canon(fsq(a)) == _canon(JF.sq(ja)) == [x * x % P for x in A]
    inv = _canon(finvert(a))
    assert inv == _canon(JF.invert(ja)) == [pow(x, P - 2, P) for x in A]
    assert inv[0] == 0 and inv[EDGES.index(P)] == 0  # 0 and p map to 0


def test_fmul_broadcasts_one_element():
    a = to_tensor(ints_to_limbs(A)).reshape(16, 5, 8)
    c = 2**255 - 20  # above p/2, limbs < 2^16
    got = cuda_field.fmul(a, to_tensor(ints_to_limbs([c])))  # (16, 1) over (16, 5, 8)
    assert got.shape == a.shape
    assert _canon(got) == _canon(JF.mul(_jax(A), _jax([c] * len(A))))
    with pytest.raises(ValueError):
        cuda_field.fmul(a, to_tensor(ints_to_limbs(A[:8])))


def _nonzero(count: int) -> list[int]:
    return [v for v in _values(13, count + 20) if v % P][:count]


def test_batch_invert_lanes_matches_jax():
    shape = (3, 8)
    vals = _nonzero(24)
    z = to_tensor(ints_to_limbs(vals)).reshape((16,) + shape)
    want = jax.jit(jfixed._batch_invert_lanes)(_jax(vals).reshape((16,) + shape))
    assert _canon(cuda_field.batch_invert_lanes(z)) == _canon(want) == [pow(v, P - 2, P) for v in vals]


@pytest.mark.parametrize("shape", [(8,), (5, 1), (2, 2, 4)])
def test_batch_invert_lanes_any_rows(shape):
    """One row, one lane a row, two row axes: the rows are flattened."""
    vals = _nonzero(int(np.prod(shape)))
    z = to_tensor(ints_to_limbs(vals)).reshape((16,) + shape)
    for got in (TF.batch_invert_lanes(z), cuda_field.batch_invert_lanes(z)):
        assert got.shape == z.shape
        assert _canon(got) == [pow(v, P - 2, P) for v in vals]


@pytest.mark.parametrize("field", [tparams.BN254_FP, tparams.BLS12381_FP, tparams.BN254_FR],
                         ids=lambda f: f.name)
def test_mont_batch_invert_masks_zeros(field):
    """Weierstrass z: zeros (identity entries) give 0, the rest 1/z, by the
    scans and one plain inversion a row."""
    rng = np.random.default_rng(14)
    vals = [int.from_bytes(rng.bytes(field.nbytes), "little") % field.modulus for _ in range(24)]
    vals[0] = vals[9] = vals[10] = 0
    z = field.from_ints(vals, "cpu").reshape(field.nlimbs, 3, 8)
    got = field.batch_invert_lanes(z)
    assert field.to_ints(got) == [pow(v, -1, field.modulus) if v else 0 for v in vals]


def test_mont_mul_ew_takes_the_base_fields():
    assert cuda_mont.MUL_FIELDS[2] is tparams.BN254_FP and cuda_mont.MUL_FIELDS[3] is tparams.BLS12381_FP
    for field in (tparams.BN254_FP, tparams.BLS12381_FP):
        a = field.from_ints([3, field.modulus - 1, 0], "cpu")
        raw = torch.tensor(field.int_limbs((1 << field.radix_bits) - 1), dtype=torch.int32).reshape(-1, 1)
        assert field.to_ints(cuda_mont.mont_mul_ew(field, a, a)) == [9, 1, 0]
        # a raw value below R comes out reduced (the reader's reduce_residues)
        got = cuda_mont.reduce_residues(field, raw)
        assert field.from_mont(got).tolist() == field.from_mont(field.from_ints(
            [((1 << field.radix_bits) - 1) * field.r_inv % field.modulus], "cpu")).tolist()


def test_f51_conversions_match_jax():
    rng = np.random.default_rng(15)
    raw = rng.integers(0, 2**64 - 1, size=(40, 5), dtype=np.uint64, endpoint=True)
    raw[0] = np.uint64(2**64 - 1)
    raw[1] = 0
    raw[2] = [2**51 - 19] + [2**51 - 1] * 4  # p itself
    got = tlimbs.f51_u64_to_limbs16(torch.from_numpy(raw.view(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), jlimbs.f51_u64_to_limbs16(raw))
    limbs = ints_to_limbs(A)  # values up to 2^256 - 1, limbs < 2^16
    got = tlimbs.limbs16_to_f51_u64(to_tensor(limbs))
    assert np.array_equal(got.numpy().view(np.uint64), jlimbs.limbs16_to_f51_u64(limbs.astype(np.uint32)))
    # the port's own invariant (limbs up to 2^17) gives the same canonical words
    loose = to_tensor(rng.integers(0, 1 << 17, size=(16, 40)))
    assert torch.equal(tlimbs.limbs16_to_f51_u64(loose), tlimbs.limbs16_to_f51_u64(TF.canonicalize(loose)))


@pytest.mark.parametrize("k", [4, 6])
def test_u64_conversions_match_jax(k):
    rng = np.random.default_rng(16 + k)
    words = rng.integers(0, 2**64 - 1, size=(33, k), dtype=np.uint64, endpoint=True)
    words[0, -1] = np.uint64(2**64 - 1)
    got = tlimbs.u64_to_limbs16(torch.from_numpy(words.view(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), jlimbs.u64_to_limbs16(words))
    assert np.array_equal(tlimbs.limbs16_to_u64(got).numpy().view(np.uint64), words)
    one = tlimbs.limbs16_to_u64(got[:, :1])
    assert one.shape == (1, k)
