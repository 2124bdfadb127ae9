"""blitzar_tpu_torch.fields.mont (plain PyTorch) against blitzar_tpu.fields.mont
on the three Montgomery fields (bn254 Fp, bn254 Fr = Grumpkin Fp, bls12-381
Fp): the limb layout, add/sub/neg/mul/sq/mul_const, inversion (0 -> 0), the
Montgomery-form conversions and the byte codecs, bit for bit, on edge values
(0, 1, m - 1, values near m / 2 and R) and seeded random ones.

The JAX side runs jitted, one program per field for the ring ops and one for
the inversion, so it compiles few programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.fields import params as jparams
from blitzar_tpu_torch.fields import params as tparams

FIELDS = [
    ("bn254_fp", jparams.BN254_FP, tparams.BN254_FP),
    ("bn254_fr", jparams.BN254_FR, tparams.BN254_FR),
    ("bls12381_fp", jparams.BLS12381_FP, tparams.BLS12381_FP),
]


def _values(modulus: int, radix_bits: int, seed: int, count: int = 40) -> list[int]:
    edges = [0, 1, 2, modulus - 1, modulus - 2, (modulus - 1) // 2, (modulus + 1) // 2,
             (1 << radix_bits) % modulus, (1 << (radix_bits - 1)) % modulus]
    rng = np.random.default_rng(seed)
    return edges + [int.from_bytes(rng.bytes(radix_bits // 8), "little") % modulus for _ in range(count)]


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


@pytest.fixture(scope="module", params=FIELDS, ids=[f[0] for f in FIELDS])
def field(request):
    """Both fields, the inputs on both sides, and blitzar_tpu's results."""
    _, jf, tf = request.param
    a = _values(tf.modulus, tf.radix_bits, 1)
    b = _values(tf.modulus, tf.radix_bits, 2)[::-1]
    raw = np.random.default_rng(3).integers(0, 256, size=(tf.nbytes, len(a)), dtype=np.uint8)
    raw[:, 0] = 0xFF  # R - 1: above m, fully reduced by from_bytes_le
    ja, jb = jf.from_ints(a), jf.from_ints(b)

    def ring(x, y, r):
        return (jf.add(x, y), jf.sub(x, y), jf.neg(x), jf.mul(x, y), jf.sq(x), jf.mul_const(x, 7),
                jf.from_mont(x), jf.to_mont(y), jf.to_bytes_le(x), jf.from_bytes_le(r))

    want = dict(zip(("add", "sub", "neg", "mul", "sq", "mul_const", "from_mont", "to_mont", "to_bytes_le",
                     "from_bytes_le"), jax.jit(ring)(ja, jb, jnp.asarray(raw))))
    want["inv"] = jax.jit(jf.inv)(ja)
    return {"jf": jf, "tf": tf, "a": a, "b": b, "ja": ja, "ta": tf.from_ints(a, "cpu"),
            "tb": tf.from_ints(b, "cpu"), "raw": torch.from_numpy(raw), "want": want}


def test_layout_and_int_conversion_match(field):
    tf, ta = field["tf"], field["ta"]
    assert ta.dtype == torch.int32 and tuple(ta.shape) == (tf.nlimbs, len(field["a"]))
    assert _same(ta, field["ja"])
    assert tf.to_ints(ta) == field["jf"].to_ints(field["ja"]) == field["a"]
    assert (tf.modulus, tf.nlimbs, tf.r) == (field["jf"].modulus, field["jf"].nlimbs, field["jf"].r)
    assert (tf.n_prime * tf.modulus + 1) % (1 << tf.radix_bits) == 0


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "sq", "mul_const"])
def test_ring_ops_match(field, op):
    tf, ta, tb = field["tf"], field["ta"], field["tb"]
    got = {
        "add": lambda: tf.add(ta, tb),
        "sub": lambda: tf.sub(ta, tb),
        "neg": lambda: tf.neg(ta),
        "mul": lambda: tf.mul(ta, tb),
        "sq": lambda: tf.sq(ta),
        "mul_const": lambda: tf.mul_const(ta, 7),
    }[op]()
    assert _same(got, field["want"][op])


def test_inv_matches_with_zero_to_zero(field):
    tf, ta = field["tf"], field["ta"]
    got = tf.inv(ta)
    assert _same(got, field["want"]["inv"])
    m = tf.modulus
    assert tf.to_ints(got) == [pow(v, m - 2, m) for v in field["a"]]
    assert tf.to_ints(got)[0] == 0


def test_form_and_byte_conversions_match(field):
    tf, ta, tb, want = field["tf"], field["ta"], field["tb"], field["want"]
    assert _same(tf.from_mont(ta), want["from_mont"])
    assert _same(tf.to_mont(tb), want["to_mont"])
    assert _same(tf.to_bytes_le(ta), want["to_bytes_le"])
    assert _same(tf.from_bytes_le(field["raw"]), want["from_bytes_le"])
    # the bytes are the standard form's, little-endian
    assert [int.from_bytes(bytes(col), "little") for col in tf.to_bytes_le(ta).numpy().T] == field["a"]


def test_predicates_and_select(field):
    tf, ta, tb = field["tf"], field["ta"], field["tb"]
    zero = tf.zeros((ta.shape[1],))
    assert tf.is_zero(ta).tolist() == [v == 0 for v in field["a"]]
    assert bool(tf.eq(ta, ta.clone()).all()) and not bool(tf.eq(tf.add(ta, tf.one((1,))), ta).any())
    cond = torch.arange(ta.shape[1]) % 2 == 0
    picked = tf.cmov(ta, tb, cond)
    assert torch.equal(picked[:, ::2], tb[:, ::2]) and torch.equal(picked[:, 1::2], ta[:, 1::2])
    assert torch.equal(tf.sub(ta, ta), zero) and torch.equal(tf.add(ta, tf.neg(ta)), zero)
