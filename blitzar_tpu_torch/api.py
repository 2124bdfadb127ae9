"""Public API of the port (blitzar_tpu/api.py): ristretto255 commitments
and generators, bls12-381 G1 / bn254 G1 / Grumpkin commitments with
generators, fixed-generator handles of any of the four curves (their files,
packed and vlen queries), the inner-product argument over ristretto255 and
the sumcheck prover.

Entry points follow the reference C ABI (cbindings/blitzar_api.h): ``init``
is one-shot, ristretto255 generators default to the canonical precomputed
set, results are numpy arrays of canonical encodings (compressed points,
affine structs). The work runs on the card: on
``cuda`` unless ``init(backend="cpu")`` asked for the CPU, where every
kernel runs its plain PyTorch version. Without a CUDA device and without an
explicit ``"cpu"`` the entry points raise; they never fall back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import generators as _gen
from .curves import edwards25519 as ed
from .curves import ristretto as rst
from .curves import weierstrass as wc
from .msm import engine as _engine
from .msm import fixed as _fixed
from .ops import cuda_mont as _cm
from .proof import ceil_log2
from .proof import inner_product as _ipa
from .proof import sumcheck as _sc

BACKENDS = {"auto": "cuda", "gpu": "cuda", "cpu": "cpu"}

# curve ids (reference blitzar_api.h:28-31)
SXT_CURVE_RISTRETTO255 = 0
SXT_CURVE_BLS_381 = 1
SXT_CURVE_BN_254 = 2
SXT_CURVE_GRUMPKIN = 3

CURVES = {
    SXT_CURVE_RISTRETTO255: ed,
    SXT_CURVE_BLS_381: wc.BLS12381_G1,
    SXT_CURVE_BN_254: wc.BN254_G1,
    SXT_CURVE_GRUMPKIN: wc.GRUMPKIN,
}
CURVE_IDS = {curve: curve_id for curve_id, curve in CURVES.items()}

# field ids (reference blitzar_api.h:33-34) and the sumcheck's codec of each
SXT_FIELD_SCALAR255 = _cm.SXT_FIELD_SCALAR255
SXT_FIELD_GRUMPKIN = _cm.SXT_FIELD_GRUMPKIN
FIELD_CODECS = _sc.CODECS


@dataclasses.dataclass
class SequenceDescriptor:
    """Mirror of sxt_sequence_descriptor (reference blitzar_api.h:115-136)."""

    element_nbytes: int
    n: int
    data: np.ndarray  # (n * element_nbytes,) or (n, element_nbytes) uint8 LE
    is_signed: bool = False

    def rows(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.uint8).reshape(self.n, self.element_nbytes)


class _Backend:
    def __init__(self):
        self.initialized = False
        self.device = torch.device("cuda")

    def reset(self):
        self.initialized = False
        self.device = torch.device("cuda")
        _gen.CACHE.reset()
        _engine.clear_handle_cache()


_BACKEND = _Backend()


def init(backend: str = "auto", num_precomputed_generators: int = 0) -> None:
    """One-shot library init (reference sxt_init). backend: "auto" | "gpu" |
    "cpu"; "auto" means "gpu". Raises on a second call, and for "gpu"
    when no CUDA device is present."""
    if _BACKEND.initialized:
        raise RuntimeError("init may only be called once (reference backend.cc:116)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {sorted(BACKENDS)}")
    device = torch.device(BACKENDS[backend])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {backend!r} needs a CUDA device and none is available; "
            "pass backend='cpu' to run on the CPU"
        )
    _BACKEND.device = device
    _BACKEND.initialized = True
    if num_precomputed_generators:
        _gen.get_precomputed_generators(int(num_precomputed_generators), 0, device)


def reset_backend_for_testing() -> None:
    """Reference cbindings/backend.cc:106-108 test hook."""
    _BACKEND.reset()


def device() -> torch.device:
    """The device the entry points run on (initialising with "auto")."""
    if not _BACKEND.initialized:
        init()
    return _BACKEND.device


# ---------------------------------------------------------------------------
# generators, one commitments, (de)compression
# ---------------------------------------------------------------------------


def get_ristretto255_generators(n: int, offset: int = 0) -> ed.PointP3:
    """Reference sxt_ristretto255_get_generators (blitzar_api.h:440), which
    copies into the caller's buffer: a copy, so that a write to it leaves
    the shared prefix (and every later default commitment) as it was."""
    return ed.PointP3(*(c.clone() for c in _gen.get_precomputed_generators(n, offset, device())))


def get_curve25519_one_commit(n: int) -> ed.PointP3:
    """Reference sxt_curve25519_get_one_commit (blitzar_api.h:477)."""
    return _gen.one_commitment(n, device())


def compress_ristretto255(points: ed.PointP3) -> np.ndarray:
    """(n,) point batch -> (n, 32) uint8 canonical encodings."""
    return rst.encode(points).cpu().numpy().T.copy()


def decompress_ristretto255(data: np.ndarray):
    """(n, 32) uint8 -> (PointP3 on the backend's device, valid bool array)."""
    raw = torch.from_numpy(np.ascontiguousarray(np.asarray(data, np.uint8).T)).to(device())
    pts, valid = rst.decode(raw)
    return pts, valid.cpu().numpy()


# ---------------------------------------------------------------------------
# Pedersen commitments
# ---------------------------------------------------------------------------


def _validate_descriptors(descriptors) -> None:
    """Reference release asserts (cbindings/pedersen.cc:44-69) and the signed
    width contract (multiexp/base/exponent_sequence.h:40)."""
    for d in descriptors:
        if not 1 <= int(d.element_nbytes) <= 32:
            raise ValueError(f"element_nbytes must be in [1, 32], got {d.element_nbytes}")
        if d.is_signed and int(d.element_nbytes) > 16:
            raise ValueError(f"signed sequences require element_nbytes <= 16 (got {d.element_nbytes})")
        if int(d.n) > 0 and d.data is None:
            raise ValueError("nonempty sequence with null data")


def _check_generators(generators, dev: torch.device) -> None:
    """Generators must lie on the backend's device: a CPU tensor under the
    card's backend would run the plain versions instead of the kernels."""
    if generators.x.device.type != dev.type:
        raise ValueError(f"generators lie on {generators.x.device}, the backend runs on {dev}")


def compute_curve25519_commitments(
    descriptors, generators: ed.PointP3 | None = None, generators_offset: int = 0
) -> np.ndarray:
    """Pedersen commitments over ristretto255 -> (num_sequences, 32) uint8.

    Mirrors sxt_curve25519_compute_pedersen_commitments[_with_generators]
    (reference blitzar_api.h:243-286). ``generators`` must lie on the
    backend's device."""
    dev = device()
    descriptors = list(descriptors)
    if not descriptors:
        return np.zeros((0, 32), dtype=np.uint8)
    _validate_descriptors(descriptors)
    n_max = max(int(d.n) for d in descriptors)
    if generators is None:
        generators = _gen.get_precomputed_generators(n_max, generators_offset, dev)
    _check_generators(generators, dev)
    result = _engine.msm(
        generators,
        [d.rows() for d in descriptors],
        [int(d.element_nbytes) for d in descriptors],
        [bool(d.is_signed) for d in descriptors],
    )
    return compress_ristretto255(result)


def _generic_commitments(descriptors, generators: wc.PointP2, curve: wc.WCurve) -> wc.PointP2:
    dev = device()
    descriptors = list(descriptors)
    if not descriptors:
        return curve.identity((0,), dev)
    _validate_descriptors(descriptors)
    _check_generators(generators, dev)
    return _engine.msm(
        generators,
        [d.rows() for d in descriptors],
        [int(d.element_nbytes) for d in descriptors],
        [bool(d.is_signed) for d in descriptors],
        curve=curve,
    )


def _affine_struct(curve: wc.WCurve, points: wc.PointP2) -> np.ndarray:
    """Points -> structured array mirroring the reference's uncompressed
    affine output structs (sxt_bn254_g1 / sxt_grumpkin, blitzar_api.h:87-106):
    x and y as standard-form little-endian bytes and an infinity flag; the
    identity is x = y = 0 with infinity set. The projective -> affine step
    runs on the host in Python integers, one inversion per point."""
    nbytes = curve.field.nbytes
    affine = curve.to_affine_ints(points)
    out = np.zeros(len(affine), dtype=[("x", np.uint8, nbytes), ("y", np.uint8, nbytes), ("infinity", np.uint8)])
    for j, pt in enumerate(affine):
        if pt is None:
            out["infinity"][j] = 1
            continue
        out["x"][j] = np.frombuffer(pt[0].to_bytes(nbytes, "little"), np.uint8)
        out["y"][j] = np.frombuffer(pt[1].to_bytes(nbytes, "little"), np.uint8)
    return out


def compute_bls12_381_g1_commitments_with_generators(descriptors, generators: wc.PointP2) -> np.ndarray:
    """-> (num_sequences, 48) uint8 zcash-compressed G1 (reference
    sxt_bls12_381_g1_compute_pedersen_commitments_with_generators,
    blitzar_api.h:324). ``generators`` must lie on the backend's device."""
    return wc.compress_bls12_381(_generic_commitments(descriptors, generators, wc.BLS12381_G1))


def compute_bn254_g1_uncompressed_commitments_with_generators(descriptors, generators: wc.PointP2) -> np.ndarray:
    """-> structured (x, y, infinity) affine array (reference
    sxt_bn254_g1_uncompressed_compute_pedersen_commitments_with_generators,
    blitzar_api.h:364)."""
    return _affine_struct(wc.BN254_G1, _generic_commitments(descriptors, generators, wc.BN254_G1))


def compute_grumpkin_uncompressed_commitments_with_generators(descriptors, generators: wc.PointP2) -> np.ndarray:
    """-> structured (x, y, infinity) affine array (reference
    sxt_grumpkin_uncompressed_compute_pedersen_commitments_with_generators,
    blitzar_api.h:404)."""
    return _affine_struct(wc.GRUMPKIN, _generic_commitments(descriptors, generators, wc.GRUMPKIN))


# the commitment entry of each Weierstrass curve
COMMITMENT_ENTRIES = {
    wc.BLS12381_G1: compute_bls12_381_g1_commitments_with_generators,
    wc.BN254_G1: compute_bn254_g1_uncompressed_commitments_with_generators,
    wc.GRUMPKIN: compute_grumpkin_uncompressed_commitments_with_generators,
}


# ---------------------------------------------------------------------------
# fixed-generator handles (reference blitzar_api.h:631-752)
# ---------------------------------------------------------------------------


def multiexp_handle_new(curve_id: int, generators, n: int | None = None) -> _fixed.MultiexpHandle:
    """Reference sxt_multiexp_handle_new (blitzar_api.h:631): a handle over
    ``generators`` of the curve ``curve_id`` (one of ``CURVES``), which must
    lie on the backend's device."""
    if curve_id not in CURVES:
        raise ValueError(f"unknown curve id {curve_id}: expected one of {sorted(CURVES)}")
    _check_generators(generators, device())
    return _fixed.MultiexpHandle(generators, curve=CURVES[curve_id], n=n)


def multiexp_handle_new_from_file(curve_id: int, filename: str) -> _fixed.MultiexpHandle:
    """Reference sxt_multiexp_handle_new_from_file (blitzar_api.h:641): a
    handle of the curve ``curve_id`` read from blitzar_tpu's npz or the
    reference's raw format (sniffed: a file that does not end in ".npz" and
    does not start with "PK" is raw), its table on the backend's device."""
    if curve_id not in CURVES:
        raise ValueError(f"unknown curve id {curve_id}: expected one of {sorted(CURVES)}")
    return _fixed.MultiexpHandle.new_from_file(filename, curve=CURVES[curve_id], device=device())


def multiexp_handle_write_to_file(handle: _fixed.MultiexpHandle, filename: str) -> None:
    """Reference sxt_multiexp_handle_write_to_file (blitzar_api.h:649), in
    blitzar_tpu's npz format (``msm/interop.py`` writes the raw one)."""
    handle.write_to_file(filename)


def fixed_multiexponentiation(handle: _fixed.MultiexpHandle, scalars):
    """Reference sxt_fixed_multiexponentiation (blitzar_api.h:685): scalars
    (num_outputs, n, element_nbytes) uint8 -> (num_outputs,) points of the
    handle's curve."""
    device()
    return _fixed.fixed_multiexponentiation(handle, scalars)


def fixed_packed_multiexponentiation(handle: _fixed.MultiexpHandle, output_bit_table, n: int, scalars):
    """Reference sxt_fixed_packed_multiexponentiation (blitzar_api.h:712):
    scalars are n rows of ceil(sum(output_bit_table) / 8) packed bytes, bits
    LSB-first across a row, output o taking the next output_bit_table[o]
    bits -> (len(output_bit_table),) points of the handle's curve."""
    device()
    return _fixed.fixed_packed_multiexponentiation(handle, output_bit_table, n, scalars)


def fixed_vlen_multiexponentiation(handle: _fixed.MultiexpHandle, output_bit_table, output_lengths, scalars):
    """Reference sxt_fixed_vlen_multiexponentiation (blitzar_api.h:741): the
    packed query over max(output_lengths) rows, output o over its first
    output_lengths[o] generators (ascending lengths)."""
    device()
    return _fixed.fixed_vlen_multiexponentiation(handle, output_bit_table, output_lengths, scalars)


# ---------------------------------------------------------------------------
# inner-product argument (reference blitzar_api.h:566-631)
# ---------------------------------------------------------------------------


def _ipa_generators(n: int, generators_offset: int):
    """G = generators[offset, offset + np) and Q = generators[offset + np],
    np = 2^ceil(lg n), on the backend's device."""
    np_ = 1 << ceil_log2(n)
    dev = device()
    return (_gen.get_precomputed_generators(np_, generators_offset, dev),
            _gen.get_precomputed_generators(1, generators_offset + np_, dev))


def prove_inner_product(transcript, n: int, generators_offset: int, a_vector, b_vector):
    """Reference sxt_curve25519_prove_inner_product (blitzar_api.h:566):
    ``transcript`` is a ``proof.transcript.Transcript``; a and b are n
    scalars ((n, 32) uint8 rows, ints or 32-byte strings). Returns
    (l_vector (rounds, 32) uint8, r_vector (rounds, 32) uint8, ap_value
    int)."""
    g_vector, q_value = _ipa_generators(n, generators_offset)
    return _ipa.prove_inner_product(transcript, a_vector, b_vector, g_vector, q_value)


def verify_inner_product(
    transcript, n: int, generators_offset: int, b_vector, product, a_commit: ed.PointP3,
    l_vector, r_vector, ap_value,
) -> bool:
    """Reference sxt_curve25519_verify_inner_product (blitzar_api.h:611):
    ``a_commit`` is a (1,) point on the backend's device."""
    g_vector, q_value = _ipa_generators(n, generators_offset)
    _check_generators(a_commit, g_vector.x.device)
    return _ipa.verify_inner_product(
        transcript, b_vector, product, a_commit, l_vector, r_vector, ap_value, g_vector, q_value
    )


# ---------------------------------------------------------------------------
# sumcheck (reference blitzar_api.h:766)
# ---------------------------------------------------------------------------


def prove_sumcheck(
    field_id: int, mles, product_table, product_terms, n: int, transcript=None, challenge_callback=None
):
    """Reference sxt_prove_sumcheck (blitzar_api.h:766) over the field
    ``field_id`` (``SXT_FIELD_SCALAR255`` or ``SXT_FIELD_GRUMPKIN``). mles:
    (num_mles, n, 32) uint8 ABI rows or num_mles rows of ints; the
    challenges come from a Merlin ``transcript``
    (``proof.transcript.Transcript``) or from ``challenge_callback``
    (polynomial -> int, the C callback flavour). Returns
    (round_polynomials, evaluation_point)."""
    if field_id not in FIELD_CODECS:
        raise ValueError(f"unknown field id {field_id}: expected one of {sorted(FIELD_CODECS)}")
    codec = FIELD_CODECS[field_id]
    if challenge_callback is not None:
        tr = _sc.CallbackSumcheckTranscript(challenge_callback)
    elif transcript is not None:
        tr = _sc.ReferenceSumcheckTranscript(transcript, codec)
    else:
        raise ValueError("pass a transcript or a challenge_callback")
    return _sc.prove_sum(tr, mles, product_table, product_terms, n, codec, device())
