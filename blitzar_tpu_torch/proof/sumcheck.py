"""Sumcheck prover and verifier for sums of products of multilinear
extensions (the port of blitzar_tpu/proof/sumcheck.py).

The round loop of reference proof_computation.h:32-69, the transcript
protocol of reference_transcript.h (domain "sumcheck proof v1", labels
"n"/"k"/"P"/"R") and the host-only verifier of verification.h:30-79, over the
curve25519 scalar field and the Grumpkin base field (reference
cbindings/base/field_id_utility.h:30-41). Round polynomials and evaluation
points equal blitzar_tpu's, byte for byte.

Each round of ``prove_sum`` on the card: one ``mont_sum_round`` launch
gives the round polynomial's coefficients in Montgomery form; they cross to
the host (2 to 6 field elements) for the transcript; the challenge comes
back as one element and one ``mont_fold_round`` launch halves the table.
The table is resident and shrinks by half each round (3 x 2^20 elements are
~200 MB in the int32 limb layout); blitzar_tpu keeps it full width with a
traced ``mid`` and lane shifts, a TPU means that gives the same values. The
last round's fold is not needed and not done.

Transcript byte contract (blitzar_tpu/proof/sumcheck.py:20-26): for
scalar25519 elements enter the transcript as canonical little-endian bytes
and challenges are 256-bit draws reduced mod l; for fieldgk (the Grumpkin
base field) the reference appends the Montgomery form's bytes and treats the
squeezed bytes as a Montgomery element converted to bytes in place, so the
challenge is raw * R^-2 mod r. Both quirks are reproduced.

Not ported yet (ROADMAP.md, section 1): blitzar_tpu's host-chunked rounds for
tables above its device budget (sumcheck.py:498-546) and the sharded prover
(sumcheck_sharded.py); here every table is resident.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.mont import MontField, rows_to_limbs
from ..ops import cuda_mont
from . import ceil_log2
from .transcript import Transcript

MAX_DEGREE = cuda_mont.MAX_DEGREE


# ---------------------------------------------------------------------------
# field codecs: how elements cross the transcript and the ABI
# ---------------------------------------------------------------------------


class FieldCodec:
    name: str
    field_id: int
    field: MontField

    def element_to_transcript_bytes(self, value: int) -> bytes:
        raise NotImplementedError

    def challenge_from_bytes(self, raw: bytes) -> int:
        raise NotImplementedError

    def rows_to_mont(self, rows: np.ndarray, n_pad: int, device) -> torch.Tensor:
        """(num_mles, n, 32) uint8 ABI rows -> (nlimbs, num_mles, n_pad)
        canonical Montgomery table, zero-padded."""
        num_mles, n, _ = rows.shape
        raw = rows_to_limbs(rows.reshape(num_mles * n, -1), self.field.nlimbs, device)
        table = torch.zeros((self.field.nlimbs, num_mles, n_pad), dtype=torch.int32, device=device)
        table[:, :, :n] = self._reduce(raw).reshape(self.field.nlimbs, num_mles, n)
        return table


class _Scalar25519Codec(FieldCodec):
    name, field_id = "scalar25519", cuda_mont.SXT_FIELD_SCALAR255
    field = cuda_mont.FIELDS[field_id]

    def element_to_transcript_bytes(self, value: int) -> bytes:
        return (value % self.field.modulus).to_bytes(32, "little")

    def challenge_from_bytes(self, raw: bytes) -> int:
        return int.from_bytes(raw, "little") % self.field.modulus

    def _reduce(self, raw: torch.Tensor) -> torch.Tensor:
        # the ABI bytes are standard-form values below 2^256: reduced mod l
        return cuda_mont.to_mont(self.field, raw)


class _FieldGkCodec(FieldCodec):
    """Grumpkin base field: Montgomery-form bytes into the transcript,
    R^-2-twisted challenges out (module docstring)."""

    name, field_id = "grumpkin", cuda_mont.SXT_FIELD_GRUMPKIN
    field = cuda_mont.FIELDS[field_id]

    def element_to_transcript_bytes(self, value: int) -> bytes:
        return (value % self.field.modulus * self.field.r % self.field.modulus).to_bytes(32, "little")

    def challenge_from_bytes(self, raw: bytes) -> int:
        rinv = self.field.r_inv
        return int.from_bytes(raw, "little") * rinv * rinv % self.field.modulus

    def _reduce(self, raw: torch.Tensor) -> torch.Tensor:
        # the ABI bytes are Montgomery residues below 2^256, taken as limbs;
        # a residue at or above r stands for the same element, made
        # canonical here (the kernels assume canonical input)
        return cuda_mont.reduce_residues(self.field, raw)


SCALAR25519_CODEC = _Scalar25519Codec()
FIELDGK_CODEC = _FieldGkCodec()

# the codec of each field by its C ABI id
CODECS = {codec.field_id: codec for codec in (SCALAR25519_CODEC, FIELDGK_CODEC)}


# ---------------------------------------------------------------------------
# transcripts
# ---------------------------------------------------------------------------


class SumcheckTranscript:
    """Round-challenge source (reference sumcheck_transcript.h)."""

    def init(self, num_variables: int, round_degree: int) -> None: ...

    def round_challenge(self, polynomial: list[int]) -> int: ...


class ReferenceSumcheckTranscript(SumcheckTranscript):
    """Merlin-backed transcript (reference reference_transcript.h:27-44)."""

    def __init__(self, transcript: Transcript, codec: FieldCodec):
        self.transcript = transcript
        self.codec = codec

    def init(self, num_variables: int, round_degree: int) -> None:
        self.transcript.append_message(b"domain-sep", b"sumcheck proof v1")
        self.transcript.append_u64(b"n", num_variables)
        self.transcript.append_u64(b"k", round_degree)

    def round_challenge(self, polynomial: list[int]) -> int:
        data = b"".join(self.codec.element_to_transcript_bytes(c) for c in polynomial)
        self.transcript.append_message(b"P", data)
        return self.codec.challenge_from_bytes(self.transcript.challenge_bytes(b"R", 32))


class CallbackSumcheckTranscript(SumcheckTranscript):
    """A user callback drawing the challenges (reference
    cbindings/backend/callback_sumcheck_transcript.h:26-40)."""

    def __init__(self, callback):
        self.callback = callback

    def init(self, num_variables: int, round_degree: int) -> None:
        pass

    def round_challenge(self, polynomial: list[int]) -> int:
        return self.callback(polynomial)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def product_arrays(field: MontField, product_table, product_terms, num_mles: int, device):
    """The product table as the round kernel takes it: (mults (nlimbs, P)
    Montgomery, lengths (P,) int32, terms int32, degree), all on
    ``device``; raises on a malformed table. Products of the same MLEs
    (counted with multiplicity, in any order) become one, at the first's
    place, whose multiplier is their sum: the same round polynomials, each
    product's lanes summed once."""
    lengths = [int(num_terms) for _, num_terms in product_table]
    terms = [int(t) for t in product_terms]
    if not lengths or min(lengths) < 1 or sum(lengths) != len(terms):
        raise ValueError(f"product table {product_table} does not match {len(terms)} product terms")
    degree = max(lengths)
    if degree > MAX_DEGREE:
        raise ValueError(f"product of {degree} terms: at most {MAX_DEGREE}")
    if any(not 0 <= t < num_mles for t in terms):
        raise ValueError(f"product terms {terms} index outside {num_mles} MLEs")
    merged: dict = {}  # sorted MLEs -> [multiplier, MLEs in the first's order]
    first = 0
    for (mult, _), length in zip(product_table, lengths):
        ts = terms[first : first + length]
        first += length
        entry = merged.setdefault(tuple(sorted(ts)), [0, ts])
        entry[0] = (entry[0] + int(mult)) % field.modulus
    mults = field.from_ints([m for m, _ in merged.values()], device)
    as_tensor = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return (mults, as_tensor([len(ts) for _, ts in merged.values()]),
            as_tensor([t for _, ts in merged.values() for t in ts]), degree)


def mles_to_table(codec: FieldCodec, mles, n: int, n_pad: int, device) -> torch.Tensor:
    """MLEs as (num_mles, n, 32) uint8 ABI rows or as rows of integers ->
    the (nlimbs, num_mles, n_pad) canonical Montgomery table, zero-padded."""
    field = codec.field
    if isinstance(mles, np.ndarray) and mles.dtype == np.uint8 and mles.ndim == 3:
        if mles.shape[1] != n:
            raise ValueError(f"MLE rows of length {mles.shape[1]}, expected {n}")
        return codec.rows_to_mont(mles, n_pad, device)
    rows = [[int(v) % field.modulus for v in row] for row in mles]
    if any(len(row) != n for row in rows):
        raise ValueError(f"every MLE needs {n} values")
    flat = [v for row in rows for v in row + [0] * (n_pad - n)]
    return field.from_ints(flat, device).reshape(field.nlimbs, len(rows), n_pad)


def prove_sum(
    transcript: SumcheckTranscript,
    mles,
    product_table,
    product_terms,
    n: int,
    codec: FieldCodec = SCALAR25519_CODEC,
    device="cuda",
):
    """Returns (round_polynomials, evaluation_point) (reference prove_sum,
    proof_computation.h:32-69).

    mles: (num_mles, n, 32) uint8 ABI rows, or num_mles rows of n ints;
    product_table: [(multiplier int, num_terms)]; product_terms: the flat
    MLE indices of the products. round_polynomials: num_variables lists of
    degree + 1 coefficient ints (standard form); evaluation_point: the
    num_variables challenges. n that is not a power of two is zero-padded;
    n = 1 is one variable (a table of two, the second zero), as in
    blitzar_tpu."""
    if n < 1:
        raise ValueError("n must be positive")
    field = codec.field
    num_variables = max(ceil_log2(n), 1)
    n_pad = 1 << num_variables
    table = mles_to_table(codec, mles, n, n_pad, device)
    mults, lengths, terms, degree = product_arrays(field, product_table, product_terms, table.shape[1], device)
    transcript.init(num_variables, degree)
    polynomials: list[list[int]] = []
    evaluation_point: list[int] = []
    for round_index in range(num_variables):
        coeffs = cuda_mont.mont_sum_round(field, table, mults, lengths, terms, degree)
        polynomial = field.to_ints(coeffs)
        polynomials.append(polynomial)
        r = transcript.round_challenge(polynomial)
        evaluation_point.append(r)
        if round_index + 1 < num_variables:
            table = cuda_mont.mont_fold_round(field, table, field.from_ints([r], device))
    return polynomials, evaluation_point


# ---------------------------------------------------------------------------
# verifier (host only, reference verification.h:30-79)
# ---------------------------------------------------------------------------


def sum_polynomial_01(polynomial: list[int], modulus: int) -> int:
    """f(0) + f(1) = 2 c0 + c1 + ... (reference polynomial_utility.h)."""
    if not polynomial:
        return 0
    return (polynomial[0] + sum(polynomial)) % modulus


def evaluate_polynomial(polynomial: list[int], x: int, modulus: int) -> int:
    e = 0
    for c in reversed(polynomial):
        e = (e * x + c) % modulus
    return e


def verify_sumcheck_no_evaluation(
    expected_sum: int,
    transcript: SumcheckTranscript,
    round_polynomials,
    round_degree: int,
    num_variables: int,
    codec: FieldCodec = SCALAR25519_CODEC,
):
    """Returns (ok, evaluation_point, final_expected_sum): every round's
    f(0) + f(1) is held to the running expected sum; the final MLE
    evaluation check is the caller's (hence "no evaluation")."""
    m = codec.field.modulus
    if num_variables < 1 or round_degree < 1:
        raise ValueError("num_variables and round_degree must be positive")
    if len(round_polynomials) != num_variables or any(len(p) != round_degree + 1 for p in round_polynomials):
        return False, [], expected_sum
    transcript.init(num_variables, round_degree)
    evaluation_point: list[int] = []
    expected = expected_sum % m
    for polynomial in round_polynomials:
        if sum_polynomial_01(polynomial, m) != expected:
            return False, evaluation_point, expected
        r = transcript.round_challenge(polynomial)
        evaluation_point.append(r)
        expected = evaluate_polynomial(polynomial, r, m)
    return True, evaluation_point, expected
