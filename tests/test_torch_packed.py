"""Packed and vlen queries (blitzar_tpu_torch.msm.fixed, api) against
blitzar_tpu on ristretto255 and bn254 G1 (bls12-381 G1 and Grumpkin in
tests/test_torch_packed_weierstrass.py): bit widths that straddle bytes,
lengths with a tie and a zero, the per-bit length mask, the empty bit
table, Proof-of-SQL's column widths against per-output MSMs, and the api
entries."""

import numpy as np
import pytest
import torch

from blitzar_tpu import generators as jgen
from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu.msm import fixed as jfixed
from blitzar_tpu_torch import api
from blitzar_tpu_torch.curves import edwards25519 as ted
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.utils.limbs import from_jax_points
from torch_packed_cases import (
    BIT_TABLE, LENGTHS, N, W, canonical, check_curve, from_jax, jax_handle, output_scalars, packed_scalars,
)

JGENS = jgen.ristretto_generators(N)
TGENS = from_jax_points(np.stack([np.asarray(c) for c in JGENS]), device="cpu")


@pytest.fixture(scope="module")
def ed_handle():
    return tfixed.MultiexpHandle(TGENS, window_width=W)


def test_ristretto255_matches_jax(ed_handle):
    from blitzar_tpu.curves import edwards25519 as jed

    check_curve(jed, ted, ed_handle)


def test_bn254_g1_matches_jax():
    pts = twc.BN254_G1.oracle.random_points(N, seed=35)
    th = tfixed.MultiexpHandle(twc.BN254_G1.from_affine_ints(pts, "cpu"), window_width=W, curve=twc.BN254_G1)
    check_curve(jwc.BN254_G1, twc.BN254_G1, th)


def test_mask_lengths_is_per_bit():
    """Byte 1 of a row holds bits 8..15: bit 8 of output 1 (length 3) and
    bits 9..15 of output 2 (length 5); generators 3 and 4 keep only the
    latter."""
    bit_table, lengths = [1, 8, 13], [2, 3, 5]
    packed = torch.full((6, 3), 0xFF, dtype=torch.uint8)
    tfixed._mask_lengths(packed, bit_table, lengths)
    bits = np.unpackbits(packed.numpy(), axis=1, bitorder="little")
    owner = np.repeat(np.arange(3), bit_table)
    want = np.zeros_like(bits)
    for g in range(6):
        want[g, : len(owner)] = g < np.asarray(lengths)[owner]
    assert np.array_equal(bits, want)


def test_proof_of_sql_widths_equal_per_output_msms(ed_handle):
    """[1, 8, 16, 32, 64, 128, 256]: 505 bits, 64 bytes a generator; each
    output equals the MSM of its own scalars, zeroed past its length."""
    n = 8
    handle = tfixed.MultiexpHandle(ted.index_batch(TGENS, slice(0, n)), window_width=W)
    bit_table = [1, 8, 16, 32, 64, 128, 256]
    lengths = [1, 2, 3, 5, 6, n - 1, n]
    packed = packed_scalars(36, n=n, bits=sum(bit_table))
    assert packed.shape == (n, 64)
    for lens in (None, lengths):
        if lens is None:
            got = tfixed.fixed_packed_multiexponentiation(handle, bit_table, n, packed.reshape(-1))
        else:
            got = tfixed.fixed_vlen_multiexponentiation(handle, bit_table, lens, packed)
        each = [canonical(ted, tfixed.fixed_multiexponentiation(handle, s))[0]
                for s in output_scalars(packed, bit_table, lens)]
        assert canonical(ted, got) == each


def test_empty_table_and_bad_lengths(ed_handle):
    assert ed_handle.table.shape[0] == N // W
    from blitzar_tpu.curves import edwards25519 as jed

    got = tfixed.fixed_packed_multiexponentiation(ed_handle, [], N, np.zeros(0, np.uint8))
    want = jfixed.fixed_packed_multiexponentiation(jax_handle(jed, ed_handle), [], N, np.zeros(0, np.uint8))
    assert got.x.shape == (16, 0) and np.asarray(want.x).shape == (16, 0)
    with pytest.raises(ValueError, match="ascending"):
        tfixed.fixed_vlen_multiexponentiation(ed_handle, BIT_TABLE, LENGTHS[::-1], packed_scalars(37))
    with pytest.raises(ValueError, match="exceeds"):
        tfixed.fixed_packed_multiexponentiation(ed_handle, BIT_TABLE, N + 1, packed_scalars(37, n=N + 1))


@pytest.mark.parametrize("kind", ["packed", "vlen"])
def test_zero_width_output_is_the_identity(ed_handle, kind):
    """An output of width 0 has no bit rows: blitzar_tpu gives the identity
    there and leaves the other outputs as they are; so does the port."""
    from blitzar_tpu.curves import edwards25519 as jed

    bit_table, lengths = [0, 8, 13], [5, 9, N]
    packed = packed_scalars(39, bits=sum(bit_table))
    jh = jax_handle(jed, ed_handle)
    if kind == "packed":
        got = tfixed.fixed_packed_multiexponentiation(ed_handle, bit_table, N, packed)
        want = jfixed.fixed_packed_multiexponentiation(jh, bit_table, N, packed)
        lengths = None
    else:
        got = tfixed.fixed_vlen_multiexponentiation(ed_handle, bit_table, lengths, packed)
        want = jfixed.fixed_vlen_multiexponentiation(jh, bit_table, lengths, packed)
    got = canonical(ted, got)
    assert got == from_jax(ted, want)
    assert got[0] == canonical(ted, ted.identity((1,)))[0]
    each = [canonical(ted, tfixed.fixed_multiexponentiation(ed_handle, s))[0]
            for s in output_scalars(packed, bit_table, lengths)[1:]]
    assert got[1:] == each


def test_all_zero_widths_give_identities(ed_handle):
    """Every width 0: no bytes a generator, every output the identity
    (blitzar_tpu itself divides by zero there)."""
    empty = np.zeros((N, 0), np.uint8)
    identity = canonical(ted, ted.identity((1,)))[0]
    got = tfixed.fixed_packed_multiexponentiation(ed_handle, [0, 0, 0], N, empty)
    assert canonical(ted, got) == [identity] * 3
    got = tfixed.fixed_vlen_multiexponentiation(ed_handle, [0, 0], [3, N], empty)
    assert canonical(ted, got) == [identity] * 2
    with pytest.raises(ValueError, match="non-negative"):
        tfixed.fixed_packed_multiexponentiation(ed_handle, [-1, 8], N, packed_scalars(40, bits=8))


def test_api_entries(ed_handle):
    api.reset_backend_for_testing()
    api.init("cpu")
    try:
        packed = packed_scalars(38)
        handle = api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, TGENS)
        got = api.fixed_packed_multiexponentiation(handle, BIT_TABLE, N, packed)
        want = tfixed.fixed_packed_multiexponentiation(ed_handle, BIT_TABLE, N, packed)
        assert canonical(ted, got) == canonical(ted, want)
        kept = packed.copy()
        got = api.fixed_vlen_multiexponentiation(handle, BIT_TABLE, LENGTHS, packed)
        assert np.array_equal(packed, kept)  # the length mask leaves the caller's scalars alone
        want = tfixed.fixed_vlen_multiexponentiation(ed_handle, BIT_TABLE, LENGTHS, packed)
        assert canonical(ted, got) == canonical(ted, want)
    finally:
        api.reset_backend_for_testing()
