"""Shared cases of tests/test_torch_packed*.py: packed and vlen queries of
blitzar_tpu_torch against blitzar_tpu on one curve. blitzar_tpu's handle
holds the port's point table (its table build is held against the port's
elsewhere), so it compiles its packed query twice a curve (packed, vlen)
and nothing else."""

import jax.numpy as jnp
import numpy as np

from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import ristretto as trst
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.utils.limbs import from_jax_points

N, W = 24, 4
# bit widths that straddle bytes: 86 bits, 11 bytes a generator
BIT_TABLE = [1, 8, 13, 64]
# ascending, a tie, a zero, one past a byte's worth of generators
LENGTHS = [0, 9, 9, N]


def jax_handle(jcurve, th):
    """A blitzar_tpu handle over the port handle's point table."""
    jh = jfixed.MultiexpHandle.__new__(jfixed.MultiexpHandle)
    jh.curve, jh.window_width, jh.n, jh.num_groups = jcurve, th.window_width, th.n, th.num_groups
    jh.table = jcurve.make_point(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in th.point_table()))
    jh.t_split = jfixed._split_table(jh.table, jcurve)
    return jh


def canonical(curve, p):
    """Points as comparable values: encodings for ristretto255, affine ints
    for a Weierstrass curve."""
    if curve is ted:
        return trst.encode(p).numpy().T.tolist()
    return curve.to_affine_ints(p)


def from_jax(curve, p):
    return canonical(curve, from_jax_points(np.stack([np.asarray(c) for c in p]), device="cpu"))


def packed_scalars(seed: int, n: int = N, bits: int = sum(BIT_TABLE)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, -(-bits // 8)), dtype=np.uint8)


def output_scalars(packed: np.ndarray, bit_table, lengths=None) -> list[np.ndarray]:
    """Each output's own (1, n, ceil(bits / 8)) scalars cut from the packed
    rows, zeroed from its length on."""
    bits = np.unpackbits(packed, axis=1, bitorder="little")
    out, start = [], 0
    for o, nb in enumerate(bit_table):
        rows = np.packbits(bits[:, start : start + nb], axis=1, bitorder="little")
        if lengths is not None:
            rows[lengths[o]:] = 0
        out.append(rows[None])
        start += nb
    return out


def check_curve(jcurve, tcurve, th):
    """The port's packed and vlen queries equal blitzar_tpu's and the port's
    own fixed MSM of each output's scalars."""
    jh = jax_handle(jcurve, th)
    packed = packed_scalars(34)
    got = tfixed.fixed_packed_multiexponentiation(th, BIT_TABLE, N, packed)
    want = from_jax(tcurve, jfixed.fixed_packed_multiexponentiation(jh, BIT_TABLE, N, packed))
    assert canonical(tcurve, got) == want
    each = [canonical(tcurve, tfixed.fixed_multiexponentiation(th, s))[0] for s in output_scalars(packed, BIT_TABLE)]
    assert want == each
    got = tfixed.fixed_vlen_multiexponentiation(th, BIT_TABLE, LENGTHS, packed)
    want = from_jax(tcurve, jfixed.fixed_vlen_multiexponentiation(jh, BIT_TABLE, LENGTHS, packed))
    assert canonical(tcurve, got) == want
    each = [canonical(tcurve, tfixed.fixed_multiexponentiation(th, s))[0]
            for s in output_scalars(packed, BIT_TABLE, LENGTHS)]
    assert want == each
    assert canonical(tcurve, got)[0] == canonical(tcurve, tcurve.identity((1,)))[0]  # length 0
