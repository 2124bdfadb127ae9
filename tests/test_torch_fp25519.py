"""blitzar_tpu_torch.fields.fp25519 (plain PyTorch) against blitzar_tpu's
field on the same seeded inputs: canonical values must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzar_tpu.fields import fp25519 as JF
from blitzar_tpu_torch.fields import fp25519 as TF
from blitzar_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints, to_tensor

P = 2**255 - 19
# the edges of tests/test_fp25519.py:47 and the values around p and 2^255
EDGES = [0, 1, 2, 19, 38, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2**255 - 1, 2**255, 2**256 - 1]


def _values(seed: int, count: int = 40) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    rand = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]
    return EDGES + rand


A = _values(1)
B = _values(2)[::-1]


def _jax(vals):
    return jnp.asarray(ints_to_limbs(vals).astype(np.uint32))


def _torch(vals):
    return to_tensor(ints_to_limbs(vals))


def _canon(x) -> list[int]:
    if isinstance(x, torch.Tensor):
        return limbs_to_ints(TF.canonicalize(x))
    return limbs_to_ints(np.asarray(JF.canonicalize(x)))


BINARY = {
    "add": (JF.add, TF.add),
    "sub": (JF.sub, TF.sub),
    "mul": (JF.mul, TF.mul),
}
UNARY = {
    "neg": (JF.neg, TF.neg),
    "sq": (JF.sq, TF.sq),
    "mul_const": (lambda a: JF.mul_const(a, 121666), lambda a: TF.mul_const(a, 121666)),
    "mul_small": (lambda a: JF.mul_small(a, 38), lambda a: TF.mul_small(a, 38)),
    "add_const": (lambda a: JF.add_const(a, P - 5), lambda a: TF.add_const(a, P - 5)),
    "sub_from_const": (lambda a: JF.sub_from_const(2, a), lambda a: TF.sub_from_const(2, a)),
    "canonicalize": (JF.canonicalize, TF.canonicalize),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_jax(op):
    jf, tf = BINARY[op]
    assert _canon(tf(_torch(A), _torch(B))) == _canon(jf(_jax(A), _jax(B)))


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_jax(op):
    jf, tf = UNARY[op]
    assert _canon(tf(_torch(A))) == _canon(jf(_jax(A)))


def test_invert_and_pow22523_match_jax():
    vals = A[:8] + A[-8:]
    got_inv, got_pow = TF.invert(_torch(vals)), TF.pow22523(_torch(vals))
    assert _canon(got_inv) == _canon(JF.invert(_jax(vals)))
    assert _canon(got_pow) == _canon(JF.pow22523(_jax(vals)))
    assert _canon(got_inv) == [pow(v, P - 2, P) for v in vals]


def test_bytes_and_predicates_match_jax():
    ja, ta = _jax(A), _torch(A)
    assert np.array_equal(TF.to_bytes(ta).numpy(), np.asarray(JF.to_bytes(ja)))
    raw = np.random.default_rng(3).integers(0, 256, size=(32, len(A)), dtype=np.uint8)
    raw[:, : len(EDGES)] = 0xFF  # bit 255 set everywhere: must be masked
    got = TF.from_bytes(torch.from_numpy(raw))
    assert _canon(got) == _canon(JF.from_bytes(jnp.asarray(raw)))
    assert np.array_equal(TF.is_negative(ta).numpy(), np.asarray(JF.is_negative(ja)).astype(np.int32))
    assert np.array_equal(TF.is_zero(ta).numpy(), np.asarray(JF.is_zero(ja)))
    tb, jb = _torch(B), _jax(B)
    assert np.array_equal(TF.eq(ta, tb).numpy(), np.asarray(JF.eq(ja, jb)))
    assert np.array_equal(TF.eq(ta, ta).numpy(), np.ones(len(A), bool))
    cond = np.arange(len(A)) % 3 == 0
    assert _canon(TF.cmov(ta, tb, torch.from_numpy(cond))) == _canon(JF.cmov(ja, jb, jnp.asarray(cond)))


def test_stored_invariant_and_batch_shape():
    """Limbs stay below 2^17 (what the kernels' fe_load accepts), and a 2-D
    batch works like a flat one."""
    x = _torch(A)
    for _ in range(3):
        x = TF.mul(TF.sub(x, _torch(B)), TF.add(x, x))
        assert int(x.min()) >= 0 and int(x.max()) < 1 << 17
    flat = TF.mul(_torch(A[:12]), _torch(B[:12]))
    grid = TF.mul(_torch(A[:12]).reshape(16, 3, 4), _torch(B[:12]).reshape(16, 3, 4))
    assert _canon(grid.reshape(16, 12)) == _canon(flat)
