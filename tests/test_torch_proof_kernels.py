"""The plain versions of the proof kernels (ops/cuda_mont.py) and the
curve25519 scalar field (fields/params.py SCALAR25519) against the
blitzar_tpu bodies they replace, bit for bit, on identical inputs carried
across by utils/limbs.py (``from_jax_mont`` / ``to_jax_mont``):

- ``mont_mul_ew``: blitzar_tpu's field mul (the body of
  pallas_point.py:mont_mul_ew), a full b and a broadcast one;
- ``mont_fold_round``: sumcheck.py:_fold_round;
- ``mont_sum_round``: sumcheck.py:_sum_terms at degrees 1 to 5 (both
  fields; each degree's table mixes product lengths), on a lo/hi split of
  one table;
- the field's ring ops, byte codecs and lane sum (also as the inner
  product), and the kernel-backed row conversions of the proofs.

blitzar_tpu runs jitted on the CPU, one program per (field, degree) for the
expansion: the larger degrees compile for seconds, so each degree runs on
one field and the two fields share the degrees between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.fields import params as jparams
from blitzar_tpu.proof import sumcheck as jsc
from blitzar_tpu_torch.fields import params as tparams
from blitzar_tpu_torch.fields.mont import limbs_to_rows, rows_to_limbs
from blitzar_tpu_torch.ops import cuda_mont as cm
from blitzar_tpu_torch.utils.limbs import from_jax_mont, to_jax_mont

FIELDS = {"scalar25519": (jparams.SCALAR25519, tparams.SCALAR25519), "bn254_fr": (jparams.BN254_FR, tparams.BN254_FR)}


def _values(modulus: int, seed: int, count: int) -> list[int]:
    edges = [0, 1, 2, modulus - 1, modulus - 2, (modulus + 1) // 2, (1 << 256) % modulus]
    rng = np.random.default_rng(seed)
    return (edges + [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(count)])[:count]


def _both(name: str, shape, seed: int):
    """The same values as a blitzar_tpu array and a port tensor."""
    jf, tf = FIELDS[name]
    vals = _values(jf.modulus, seed, int(np.prod(shape)))
    ja = jf.from_ints(vals).reshape((jf.nlimbs,) + tuple(shape))
    return ja, from_jax_mont(np.asarray(ja), "cpu")


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(to_jax_mont(t), np.asarray(j))


def test_limbs_cross_both_ways():
    ja, ta = _both("scalar25519", (3, 5), 1)
    assert ta.dtype == torch.int32 and tuple(ta.shape) == (16, 3, 5) and _same(ta, ja)
    assert np.array_equal(np.asarray(jnp.asarray(to_jax_mont(ta))), np.asarray(ja))
    with pytest.raises(ValueError):
        from_jax_mont(np.full((16, 1), 1 << 16, np.uint32), "cpu")


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mont_mul_ew_and_fold_match(name):
    jf, tf = FIELDS[name]
    ja, ta = _both(name, (40,), 2)
    jb, tb = _both(name, (40,), 3)
    jt, tt = _both(name, (3, 8), 4)
    jr, tr = _both(name, (1,), 5)
    fold = jax.jit(jsc._fold_round, static_argnums=(0, 4))
    one_m_r = jf.from_ints([(1 - jf.to_ints(jr)[0]) % jf.modulus])
    want_mul, want_bcast, want_fold = jax.jit(lambda a, b: (jf.mul(a, b), jf.mul(a, b[:, 7:8])))(ja, jb) + (
        fold(jf, jt, jr, one_m_r, 4),)
    assert _same(cm.mont_mul_ew(tf, ta, tb), want_mul)
    assert _same(cm.mont_mul_ew(tf, ta, tb[:, 7:8]), want_bcast)
    assert _same(cm.mont_fold_round(tf, tt, tr), want_fold)


# degree -> (field, product table as blitzar_tpu's terms_struct): every
# product length up to the degree, repeated MLEs included
SUM_CASES = {
    1: ("scalar25519", ((0,), (2,))),
    2: ("bn254_fr", ((1, 2), (0,))),
    3: ("scalar25519", ((0, 1, 2), (2, 0))),
    4: ("bn254_fr", ((2, 0, 1, 1), (1,))),
    5: ("scalar25519", ((0, 1, 2, 0, 1), (2, 1, 0))),
}


@pytest.mark.parametrize("degree", sorted(SUM_CASES))
def test_mont_sum_round_matches_sum_terms(degree):
    name, terms_struct = SUM_CASES[degree]
    jf, tf = FIELDS[name]
    jt, tt = _both(name, (3, 12), 10 + degree)
    jm, tm = _both(name, (len(terms_struct),), 20 + degree)
    want = jax.jit(jsc._sum_terms, static_argnums=(0, 4, 5))(jf, jt[:, :, :6], jt[:, :, 6:], jm, terms_struct, degree)
    lengths = torch.tensor([len(t) for t in terms_struct], dtype=torch.int32)
    terms = torch.tensor([t for ts in terms_struct for t in ts], dtype=torch.int32)
    assert _same(cm.mont_sum_round(tf, tt, tm, lengths, terms, degree), want)


def test_scalar_field_ops_and_codecs_match():
    jf, tf = FIELDS["scalar25519"]
    ja, ta = _both("scalar25519", (30,), 6)
    jb, tb = _both("scalar25519", (30,), 7)
    raw = np.random.default_rng(8).integers(0, 256, size=(30, 32), dtype=np.uint8)
    raw[0] = 0xFF  # 2^256 - 1, reduced mod l
    want = jax.jit(lambda a, b, r: (jf.add(a, b), jf.sub(a, b), jf.neg(a), jf.mul(a, b), jf.from_mont(a),
                                    jf.to_bytes_le(a), jf.from_bytes_le(r), jf.tree_sum(a, 30),
                                    jf.inner_product(a, b, 30)))(ja, jb, jnp.asarray(raw.T))
    got = (tf.add(ta, tb), tf.sub(ta, tb), tf.neg(ta), tf.mul(ta, tb), tf.from_mont(ta), tf.to_bytes_le(ta),
           tf.from_bytes_le(torch.from_numpy(raw.T.copy())), tf.lane_sum(ta), tf.lane_sum(tf.mul(ta, tb)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    # the kernel-backed conversions of the proofs agree with the field's own:
    # raw rows below 2^256 reduced (scalar25519's ABI rows), residues made
    # canonical (the fieldgk ABI rows)
    raw_limbs = rows_to_limbs(raw, tf.nlimbs)
    assert torch.equal(cm.to_mont(tf, raw_limbs), tf.from_bytes_le(torch.from_numpy(raw.T.copy())))
    assert torch.equal(cm.to_mont(tf, tf.from_mont(ta)), ta)
    ints = [int.from_bytes(bytes(row), "little") for row in raw]
    residues = torch.tensor([tf.int_limbs(v % tf.modulus) for v in ints], dtype=torch.int32).T
    assert torch.equal(cm.reduce_residues(tf, raw_limbs), residues)
    assert torch.equal(limbs_to_rows(tf.from_mont(ta)).T, tf.to_bytes_le(ta))
