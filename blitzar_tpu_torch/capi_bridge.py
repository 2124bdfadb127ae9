"""The C ABI's bridge over the port: the counterpart of
blitzar_tpu/capi_bridge.py, with the same function names and arguments.

The shim (``cbindings/capi.cc`` of this package) embeds or joins CPython
and forwards every ``sxt_*`` call here as raw pointer values (ints) and
sizes. This module parses the reference's structs (the layouts of
``cbindings/blitzar_tpu_api.h``, copied below, not imported), calls the
port's Python API (``api.py``) and writes its results back in the
reference's layouts. It adds no arithmetic beyond layout, so an entry's
bytes equal the API's on the same inputs:

  sxt_sequence_descriptor   {u8 element_nbytes; u64 n; const u8* data;
                             int is_signed}                      32 bytes
  sxt_ristretto255          {u64 X[5], Y[5], Z[5], T[5]}  radix-2^51 limbs
  sxt_bls12_381_g1          {u64 X[6], Y[6]}              Montgomery, R = 2^384
  sxt_bn254_g1, sxt_grumpkin {u64 X[4], Y[4]; u8 infinity}  72 bytes
  sxt_*_p2                  {u64 X[k], Y[k], Z[k]}        Montgomery
  sxt_transcript            203 bytes (``Transcript.from_bytes203``)

The caller's memory is read through a numpy view and copied once (to the
backend's device for points, to the host for scalar rows); the u64 words
become the port's 16-bit limbs on that device (``utils/limbs.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import api
from .curves import edwards25519 as ed
from .curves import weierstrass as wc
from .proof import ceil_log2
from .proof.transcript import Transcript
from .utils import limbs as _limbs

# reference blitzar_api.h:25-26
SXT_CPU_BACKEND = 1
SXT_GPU_BACKEND = 2
BACKENDS = {SXT_CPU_BACKEND: "cpu", SXT_GPU_BACKEND: "gpu"}

DESCRIPTOR_NBYTES = 32  # u8 + pad, u64 n at 8, pointer at 16, int is_signed at 24
RISTRETTO255_NBYTES = 160
TRANSCRIPT_NBYTES = 203
SCALAR_NBYTES = 32
PRODUCT_ENTRY_NBYTES = 40  # {FIELD multiplier; unsigned product_length} + pad

# ---------------------------------------------------------------------------
# the caller's memory
# ---------------------------------------------------------------------------


def _view(addr: int, size: int) -> np.ndarray:
    """A uint8 view of the caller's ``size`` bytes at ``addr`` (no copy)."""
    if size == 0:
        return np.zeros(0, np.uint8)
    return np.frombuffer((ctypes.c_uint8 * size).from_address(addr), np.uint8)


def _read(addr: int, size: int) -> np.ndarray:
    """The caller's bytes, copied once into a host array."""
    return _view(addr, size).copy()


def _to_device(addr: int, size: int) -> torch.Tensor:
    """The caller's bytes as a uint8 tensor on the backend's device, copied
    once (straight from the caller's memory to the card)."""
    return torch.from_numpy(_view(addr, size)).to(api.device(), copy=True)


def _write(addr: int, data) -> None:
    """Copy a host array (or bytes) into the caller's memory."""
    if isinstance(data, (bytes, bytearray)):
        ctypes.memmove(addr, bytes(data), len(data))
        return
    data = np.ascontiguousarray(data)
    ctypes.memmove(addr, data.ctypes.data, data.nbytes)


# ---------------------------------------------------------------------------
# points: the reference's u64 words <-> the port's limbs on the device
# ---------------------------------------------------------------------------


def _u64_words(raw: torch.Tensor, n: int, stride: int, nwords: int) -> torch.Tensor:
    """(n * stride) uint8 bytes -> (n, nwords) int64 words: the first
    8 nwords bytes of each stride-byte struct."""
    rows = raw.reshape(n, stride)
    if stride != 8 * nwords:
        rows = rows[:, : 8 * nwords].contiguous()
    return rows.view(torch.int64)


def parse_ristretto255_points(addr: int, n: int) -> ed.PointP3:
    """n sxt_ristretto255 structs -> a (n,) PointP3 on the backend's device."""
    words = _u64_words(_to_device(addr, RISTRETTO255_NBYTES * n), n, RISTRETTO255_NBYTES, 20).reshape(n, 4, 5)
    return ed.PointP3(*(_limbs.f51_u64_to_limbs16(words[:, c]) for c in range(4)))


def emit_ristretto255_points(points: ed.PointP3) -> np.ndarray:
    """A point batch -> the packed sxt_ristretto255 structs' bytes, (n, 160)
    uint8 (canonical radix-2^51 limbs)."""
    words = torch.stack([_limbs.limbs16_to_f51_u64(c.reshape(c.shape[0], -1)) for c in points], dim=1)
    return words.cpu().numpy().view(np.uint8).reshape(-1, RISTRETTO255_NBYTES)


def _words(curve: wc.WCurve) -> int:
    return curve.field.nbytes // 8


def parse_mont_p2_points(addr: int, n: int, curve: wc.WCurve) -> wc.PointP2:
    """n projective Montgomery structs {X[k], Y[k], Z[k]} -> a (n,) PointP2
    on the backend's device: the words are the limbs' bits (no multiply)."""
    k = _words(curve)
    words = _u64_words(_to_device(addr, 24 * k * n), n, 24 * k, 3 * k).reshape(n, 3, k)
    return wc.PointP2(*(_limbs.u64_to_limbs16(words[:, c]) for c in range(3)))


def affine_stride(curve: wc.WCurve) -> int:
    """Bytes of one affine generator struct: bls12-381 G1 {X[6], Y[6]} has
    no flag; bn254 G1 and Grumpkin {X[4], Y[4], u8 infinity} pad to 72."""
    k = _words(curve)
    return 16 * k if curve is wc.BLS12381_G1 else 16 * k + 8


def parse_mont_affine_points(addr: int, n: int, curve: wc.WCurve) -> wc.PointP2:
    """n affine Montgomery structs -> a (n,) PointP2 on the backend's device
    with z = 1; a set infinity flag gives the identity (0, 1, 0)."""
    k, stride = _words(curve), affine_stride(curve)
    raw = _to_device(addr, stride * n)
    words = _u64_words(raw, n, stride, 2 * k).reshape(n, 2, k)
    x, y = _limbs.u64_to_limbs16(words[:, 0]), _limbs.u64_to_limbs16(words[:, 1])
    field = curve.field
    one, zero = field.one((n,), raw.device), field.zeros((n,), raw.device)
    if stride == 16 * k:
        return wc.PointP2(x, y, one)
    infinity = raw.reshape(n, stride)[:, 16 * k] != 0
    return wc.PointP2(torch.where(infinity, zero, x), torch.where(infinity, one, y), torch.where(infinity, zero, one))


def emit_mont_p2_points(points: wc.PointP2) -> np.ndarray:
    """A projective point batch -> the packed {X[k], Y[k], Z[k]} structs'
    bytes, (n, 24 k) uint8: the limbs' bits as u64 words."""
    words = torch.stack([_limbs.limbs16_to_u64(c.reshape(c.shape[0], -1)) for c in points], dim=1)
    n = words.shape[0]
    return words.cpu().numpy().view(np.uint8).reshape(n, -1)


def emit_uncompressed(curve: wc.WCurve, affine: np.ndarray) -> np.ndarray:
    """The API's standard-form (x, y, infinity) structs -> the reference's
    {X[k], Y[k], u8 infinity} Montgomery structs, 72 bytes each; the
    identity keeps x and y zero with infinity = 1."""
    field, nb = curve.field, curve.field.nbytes
    out = np.zeros((len(affine), 2 * nb + 8), np.uint8)
    for i, row in enumerate(affine):
        if row["infinity"]:
            out[i, 2 * nb] = 1
            continue
        for j, coord in enumerate(("x", "y")):
            mont = int.from_bytes(bytes(row[coord]), "little") * field.r % field.modulus
            out[i, j * nb : (j + 1) * nb] = np.frombuffer(mont.to_bytes(nb, "little"), np.uint8)
    return out


# ---------------------------------------------------------------------------
# descriptors and scalars
# ---------------------------------------------------------------------------


def parse_descriptors(addr: int, num: int) -> list[api.SequenceDescriptor]:
    """num sxt_sequence_descriptor structs -> the API's descriptors, each
    column's bytes copied once into a host array."""
    raw = _view(addr, DESCRIPTOR_NBYTES * num).reshape(num, DESCRIPTOR_NBYTES)
    words = raw.view("<u8")  # (num, 4)
    out = []
    for i in range(num):
        nbytes, n, data = int(raw[i, 0]), int(words[i, 1]), int(words[i, 2])
        is_signed = int(raw[i, 24:28].view("<i4")[0])
        out.append(api.SequenceDescriptor(nbytes, n, _read(data, n * nbytes) if n else np.zeros(0, np.uint8),
                                          bool(is_signed)))
    return out


def _scalar_rows(addr: int, n: int) -> np.ndarray:
    """(n, 32) uint8 scalar rows, copied once."""
    return _read(addr, SCALAR_NBYTES * n).reshape(n, SCALAR_NBYTES)


# ---------------------------------------------------------------------------
# entries called from cbindings/capi.cc
# ---------------------------------------------------------------------------


def init(backend: int, num_precomputed_generators: int) -> int:
    """sxt_init: 0 on success; 1 for an unknown backend, a second init, or
    the GPU backend with no CUDA device (there is no CPU fallback)."""
    if backend not in BACKENDS:
        return 1
    try:
        api.init(BACKENDS[backend], num_precomputed_generators=num_precomputed_generators)
    except RuntimeError:
        return 1
    return 0


def curve25519_compute_pedersen_commitments(
    res_addr: int, num_sequences: int, descriptors_addr: int,
    generators_addr: int, num_generators: int, offset: int,
) -> None:
    descriptors = parse_descriptors(descriptors_addr, num_sequences)
    generators = parse_ristretto255_points(generators_addr, num_generators) if generators_addr else None
    _write(res_addr, api.compute_curve25519_commitments(descriptors, generators, generators_offset=offset))


def bls12_381_g1_compute_pedersen_commitments(
    res_addr: int, num_sequences: int, descriptors_addr: int, generators_addr: int, num_generators: int,
) -> None:
    descriptors = parse_descriptors(descriptors_addr, num_sequences)
    generators = parse_mont_affine_points(generators_addr, num_generators, wc.BLS12381_G1)
    _write(res_addr, api.compute_bls12_381_g1_commitments_with_generators(descriptors, generators))


def _uncompressed_commitments(res_addr, num_sequences, descriptors_addr, generators_addr, num_generators, curve):
    descriptors = parse_descriptors(descriptors_addr, num_sequences)
    generators = parse_mont_affine_points(generators_addr, num_generators, curve)
    _write(res_addr, emit_uncompressed(curve, api.COMMITMENT_ENTRIES[curve](descriptors, generators)))


def bn254_g1_uncompressed_compute_pedersen_commitments(
    res_addr: int, num_sequences: int, descriptors_addr: int, generators_addr: int, num_generators: int,
) -> None:
    _uncompressed_commitments(res_addr, num_sequences, descriptors_addr, generators_addr, num_generators,
                              wc.BN254_G1)


def grumpkin_uncompressed_compute_pedersen_commitments(
    res_addr: int, num_sequences: int, descriptors_addr: int, generators_addr: int, num_generators: int,
) -> None:
    _uncompressed_commitments(res_addr, num_sequences, descriptors_addr, generators_addr, num_generators,
                              wc.GRUMPKIN)


def ristretto255_get_generators(res_addr: int, offset: int, n: int) -> int:
    if n:
        _write(res_addr, emit_ristretto255_points(api.get_ristretto255_generators(n, offset)))
    return 0


def curve25519_get_one_commit(res_addr: int, n: int) -> int:
    _write(res_addr, emit_ristretto255_points(api.get_curve25519_one_commit(n)))
    return 0


# -- inner product -----------------------------------------------------------


def curve25519_prove_inner_product(
    l_addr: int, r_addr: int, ap_addr: int, transcript_addr: int,
    n: int, generators_offset: int, a_addr: int, b_addr: int,
) -> None:
    transcript = Transcript.from_bytes203(bytes(_view(transcript_addr, TRANSCRIPT_NBYTES)))
    l_vec, r_vec, ap = api.prove_inner_product(
        transcript, n, generators_offset, _scalar_rows(a_addr, n), _scalar_rows(b_addr, n))
    if len(l_vec):
        _write(l_addr, l_vec)
        _write(r_addr, r_vec)
    _write(ap_addr, ap.to_bytes(SCALAR_NBYTES, "little"))
    _write(transcript_addr, transcript.to_bytes203())


def curve25519_verify_inner_product(
    transcript_addr: int, n: int, generators_offset: int, b_addr: int,
    product_addr: int, a_commit_addr: int, l_addr: int, r_addr: int, ap_addr: int,
) -> int:
    transcript = Transcript.from_bytes203(bytes(_view(transcript_addr, TRANSCRIPT_NBYTES)))
    rounds = ceil_log2(n)
    ok = api.verify_inner_product(
        transcript, n, generators_offset, _scalar_rows(b_addr, n), _scalar_rows(product_addr, 1)[0],
        parse_ristretto255_points(a_commit_addr, 1), _scalar_rows(l_addr, rounds), _scalar_rows(r_addr, rounds),
        _scalar_rows(ap_addr, 1)[0])
    _write(transcript_addr, transcript.to_bytes203())
    return 1 if ok else 0


# -- fixed multiexponentiation ------------------------------------------------

HANDLES: dict = {}
_NEXT_HANDLE = [1]


def _register(handle) -> int:
    hid = _NEXT_HANDLE[0]
    _NEXT_HANDLE[0] += 1
    HANDLES[hid] = handle
    return hid


def multiexp_handle_new(curve_id: int, generators_addr: int, n: int) -> int:
    if curve_id == api.SXT_CURVE_RISTRETTO255:
        points = parse_ristretto255_points(generators_addr, n)
    else:
        points = parse_mont_p2_points(generators_addr, n, api.CURVES[curve_id])
    return _register(api.multiexp_handle_new(curve_id, points, n))


def multiexp_handle_new_from_file(curve_id: int, filename: bytes) -> int:
    return _register(api.multiexp_handle_new_from_file(curve_id, filename.decode()))


def multiexp_handle_write_to_file(hid: int, filename: bytes) -> None:
    api.multiexp_handle_write_to_file(HANDLES[hid], filename.decode())


def multiexp_handle_free(hid: int) -> None:
    HANDLES.pop(hid, None)


def _emit_fixed_result(res_addr: int, handle, points) -> None:
    if handle.curve is ed:
        _write(res_addr, emit_ristretto255_points(points))
    else:
        _write(res_addr, emit_mont_p2_points(points))


def fixed_multiexponentiation(
    res_addr: int, hid: int, element_num_bytes: int, num_outputs: int, n: int, scalars_addr: int,
) -> None:
    handle = HANDLES[hid]
    # column-major (reference blitzar_api.h:663-676): generator-major rows
    raw = _read(scalars_addr, num_outputs * n * element_num_bytes)
    scalars = raw.reshape(n, num_outputs, element_num_bytes).transpose(1, 0, 2)
    _emit_fixed_result(res_addr, handle, api.fixed_multiexponentiation(handle, scalars))


def _bit_table(addr: int, num_outputs: int) -> np.ndarray:
    return _read(addr, 4 * num_outputs).view("<u4")


def fixed_packed_multiexponentiation(
    res_addr: int, hid: int, bit_table_addr: int, num_outputs: int, n: int, scalars_addr: int,
) -> None:
    handle = HANDLES[hid]
    bit_table = _bit_table(bit_table_addr, num_outputs)
    num_bytes = -(-int(bit_table.sum()) // 8)
    scalars = _read(scalars_addr, num_bytes * n)
    _emit_fixed_result(res_addr, handle, api.fixed_packed_multiexponentiation(handle, bit_table, n, scalars))


def fixed_vlen_multiexponentiation(
    res_addr: int, hid: int, bit_table_addr: int, lengths_addr: int, num_outputs: int, scalars_addr: int,
) -> None:
    handle = HANDLES[hid]
    bit_table = _bit_table(bit_table_addr, num_outputs)
    lengths = _bit_table(lengths_addr, num_outputs)
    n = int(lengths.max()) if num_outputs else 0
    num_bytes = -(-int(bit_table.sum()) // 8)
    scalars = _read(scalars_addr, num_bytes * n)
    _emit_fixed_result(res_addr, handle, api.fixed_vlen_multiexponentiation(handle, bit_table, lengths, scalars))


# -- sumcheck ------------------------------------------------------------------

SUMCHECK_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint)


def _element_from_bytes(codec, raw: bytes) -> int:
    """An ABI element's value: scalar25519 crosses as standard-form bytes,
    Grumpkin's field as Montgomery bytes (the other way is the codec's
    ``element_to_transcript_bytes``)."""
    field, value = codec.field, int.from_bytes(raw, "little")
    if codec.field_id == api.SXT_FIELD_SCALAR255:
        return value % field.modulus
    return value * field.r_inv % field.modulus


def prove_sumcheck(
    polynomials_addr: int, evaluation_point_addr: int, field_id: int,
    mles_addr: int, product_table_addr: int, product_terms_addr: int,
    n: int, num_mles: int, num_products: int, num_product_terms: int,
    round_degree: int, callback_addr: int, context_addr: int,
) -> None:
    codec = api.FIELD_CODECS[field_id]
    to_bytes = codec.element_to_transcript_bytes
    # the MLEs: an n x num_mles column-major matrix, so MLE j's n rows in
    # turn; the uint8 rows go to the card as they are (mont_from_rows)
    mles = _read(mles_addr, SCALAR_NBYTES * n * num_mles).reshape(num_mles, n, SCALAR_NBYTES)
    table = _view(product_table_addr, PRODUCT_ENTRY_NBYTES * num_products).reshape(num_products,
                                                                                   PRODUCT_ENTRY_NBYTES)
    product_table = [(_element_from_bytes(codec, bytes(row[:32])), int(row[32:36].view("<u4")[0])) for row in table]
    product_terms = _read(product_terms_addr, 4 * num_product_terms).view("<u4").tolist()

    callback = SUMCHECK_CALLBACK(callback_addr)
    challenges: list[bytes] = []

    def challenge(polynomial: list[int]) -> int:
        data = b"".join(to_bytes(c) for c in polynomial)
        poly_buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        r_buf = (ctypes.c_uint8 * SCALAR_NBYTES)()
        callback(ctypes.addressof(r_buf), context_addr, ctypes.addressof(poly_buf), len(polynomial))
        challenges.append(bytes(r_buf))
        return _element_from_bytes(codec, challenges[-1])

    polynomials, _ = api.prove_sumcheck(field_id, mles, product_table, product_terms, n,
                                        challenge_callback=challenge)
    out = b"".join(to_bytes(c) for poly in polynomials for c in poly + [0] * (round_degree + 1 - len(poly)))
    _write(polynomials_addr, out)
    _write(evaluation_point_addr, b"".join(challenges))
