"""csrc/sumcheck.cuh's round in evaluation form, the body of the
mont_sum_round kernel, run by csrc/host_harness.cpp with the kernel's grid
simulated (blocks of threads over the lanes, each block's partials, their
sums and the last block's finish: multipliers, carry to the round's points,
interpolation), against blitzar_tpu's ``sumcheck._sum_terms`` and the
port's plain version, limb for limb (blitzar_tpu at mid = 5 in one field a
degree, one compile each): degrees 1-5 in both proof fields,
repeated MLEs within a product, products shorter than the degree, products
of the same MLEs in another order, mid = 1, 2 and 5; and 300 products. The
prover's product table merges products of the same MLEs
(``proof/sumcheck.py:product_arrays``) to the same round."""

import ctypes

import jax
import numpy as np
import pytest
import torch

from blitzar_tpu.fields import params as jparams
from blitzar_tpu.proof import sumcheck as jsc
from blitzar_tpu_torch.fields import params as tparams
from blitzar_tpu_torch.ops import cuda_mont as cm
from blitzar_tpu_torch.proof import sumcheck as tsc
from blitzar_tpu_torch.utils.limbs import from_jax_mont, to_jax_mont

import torch_host_harness

FIELDS = {0: (jparams.SCALAR25519, tparams.SCALAR25519), 1: (jparams.BN254_FR, tparams.BN254_FR)}
# degree -> product table (blitzar_tpu's terms_struct) over 4 MLEs: every
# product length up to the degree, a repeated MLE, and a product of the
# same MLEs as an earlier one in another order
CASES = {
    1: ((0,), (2,), (0,)),
    2: ((1, 2), (0,), (2, 1), (3, 3)),
    3: ((0, 1, 2), (2, 0), (3,), (2, 1, 0)),
    4: ((2, 0, 1, 1), (1,), (1, 2, 1, 0), (3, 2, 0)),
    5: ((0, 1, 2, 0, 1), (2, 1, 0), (1, 0, 1, 0, 2), (3, 3), (1, 2, 3, 0)),
}
# (nblocks, threads) grids simulated
GRIDS = ((1, 1), (2, 3), (4, 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _i32(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _harness_round(harness, field_id, degree, mles, mults, lengths, terms, nblocks, threads):
    tf = FIELDS[field_id][1]
    mid = mles.shape[2] // 2
    out = torch.zeros((tf.nlimbs, degree + 1), dtype=torch.int32)
    rc = harness.btt_host_sum_round(ctypes.c_int(field_id), ctypes.c_int(degree), _i32(mles),
                                    ctypes.c_int64(mles.shape[1]), ctypes.c_int64(mid), _i32(mults),
                                    ctypes.c_int(lengths.shape[0]), _i32(lengths), _i32(terms),
                                    _i32(cm.interpolation(tf, degree, "cpu")), ctypes.c_int64(nblocks),
                                    ctypes.c_int64(threads), _i32(out))
    assert rc == 0
    return out


def _random_mles(tf, rng, m, mid):
    vals = [int.from_bytes(rng.bytes(32), "little") % tf.modulus for _ in range(m * 2 * mid)]
    return tf.from_ints(vals, "cpu").reshape(tf.nlimbs, m, 2 * mid).contiguous()


@pytest.mark.parametrize("field_id", sorted(FIELDS), ids=["scalar25519", "bn254_fr"])
@pytest.mark.parametrize("degree", sorted(CASES))
def test_sum_round_grid_matches_sum_terms_and_plain(harness, field_id, degree):
    jf, tf = FIELDS[field_id]
    terms_struct = CASES[degree]
    rng = np.random.default_rng(100 * field_id + degree)
    lengths = torch.tensor([len(t) for t in terms_struct], dtype=torch.int32)
    terms = torch.tensor([t for ts in terms_struct for t in ts], dtype=torch.int32)
    mults = tf.from_ints([int(v) for v in rng.integers(1, 2**62, size=len(terms_struct))], "cpu")
    sum_terms = jax.jit(jsc._sum_terms, static_argnums=(0, 4, 5))
    for mid in (1, 2, 5):
        mles = _random_mles(tf, rng, 4, mid)
        want = cm.mont_sum_round_plain(tf, mles, mults, lengths, terms, degree)
        if mid == 5 and field_id == degree % 2:  # one blitzar_tpu compile a degree
            jt = np.asarray(to_jax_mont(mles))
            jm = np.asarray(to_jax_mont(mults))
            jwant = sum_terms(jf, jt[:, :, :mid], jt[:, :, mid:], jm, terms_struct, degree)
            assert torch.equal(from_jax_mont(np.asarray(jwant), "cpu"), want)
        for nblocks, threads in GRIDS:
            out = _harness_round(harness, field_id, degree, mles, mults, lengths, terms, nblocks, threads)
            assert torch.equal(out, want), f"mid {mid}, grid {nblocks} x {threads}"


@pytest.mark.parametrize("field_id", sorted(FIELDS), ids=["scalar25519", "bn254_fr"])
def test_sum_round_grid_many_products(harness, field_id):
    """300 products of 1-5 factors over 6 MLEs, degree 5: the column sums
    take no room by the number of products."""
    tf = FIELDS[field_id][1]
    rng = np.random.default_rng(200 + field_id)
    struct = [tuple((p + j) % 6 for j in range(1 + p % 5)) for p in range(300)]
    lengths = torch.tensor([len(t) for t in struct], dtype=torch.int32)
    terms = torch.tensor([t for ts in struct for t in ts], dtype=torch.int32)
    mults = tf.from_ints([int(v) for v in rng.integers(1, 2**62, size=len(struct))], "cpu")
    mles = _random_mles(tf, rng, 6, 3)
    want = cm.mont_sum_round_plain(tf, mles, mults, lengths, terms, 5)
    assert torch.equal(_harness_round(harness, field_id, 5, mles, mults, lengths, terms, 2, 2), want)


@pytest.mark.parametrize("field_id", sorted(FIELDS), ids=["scalar25519", "bn254_fr"])
def test_product_arrays_merges_products_of_the_same_mles(field_id):
    """The prover's product table: products of the same MLEs in any order
    become the first, its multiplier their sum; the round is the table's
    as given."""
    tf = FIELDS[field_id][1]
    rng = np.random.default_rng(300 + field_id)
    table = [(3, 3), (5, 2), (tf.modulus - 1, 3), (7, 1), (11, 2), (13, 2)]
    struct = ((0, 1, 2), (2, 0), (2, 1, 0), (3,), (0, 2), (1, 1))
    flat = [t for ts in struct for t in ts]
    mults, lengths, terms, degree = tsc.product_arrays(tf, table, flat, 4, "cpu")
    assert degree == 3
    assert lengths.tolist() == [3, 2, 1, 2] and terms.tolist() == [0, 1, 2, 2, 0, 3, 1, 1]
    assert tf.to_ints(mults) == [2, 16, 7, 13]
    mles = _random_mles(tf, rng, 4, 5)
    given = (tf.from_ints([m for m, _ in table], "cpu"), torch.tensor([k for _, k in table], dtype=torch.int32),
             torch.tensor(flat, dtype=torch.int32))
    assert torch.equal(cm.mont_sum_round_plain(tf, mles, mults, lengths, terms, degree),
                       cm.mont_sum_round_plain(tf, mles, *given, degree))


def test_interpolation_inverts_the_vandermonde_matrix():
    """Row j of the constants holds the X^j coefficients of the Lagrange
    basis of 0..D: times the Vandermonde matrix, the identity."""
    f = tparams.BN254_FR
    for degree in range(1, 6):
        n = degree + 1
        inv = np.array(f.to_ints(cm.interpolation(f, degree, "cpu")), dtype=object).reshape(n, n)
        vander = np.array([[pow(k, j, f.modulus) for j in range(n)] for k in range(n)], dtype=object)
        prod = (inv.dot(vander)) % f.modulus
        assert (prod == np.eye(n, dtype=object)).all()
