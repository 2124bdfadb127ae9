"""Cases shared by tests/test_torch_sumcheck_*.py: one field's sumcheck
prover (``api.prove_sumcheck`` on the CPU backend, the plain versions of the
round kernels) and verifier against blitzar_tpu.proof.sumcheck, exactly:
the round polynomials, the evaluation points and the verifier's answers.

Each test_torch_sumcheck_<field>.py sets the module fixture ``field_id`` and
star-imports this module, so the two fields run as two files (in parallel
under xdist). blitzar_tpu compiles one round program per (product table,
degree, table width); every n below has its own, shared by the transcript
and input kinds, and n = 8 and 37 are the frozen vectors' problems
(tests/torch_proof_vectors.py), so recomputing those compiles nothing more."""

import numpy as np
import pytest
import torch

import torch_proof_vectors as vec
from blitzar_tpu.proof import sumcheck as jsc
from blitzar_tpu.proof.transcript import Transcript as JTranscript
from blitzar_tpu_torch import api
from blitzar_tpu_torch.proof import sumcheck as tsc
from blitzar_tpu_torch.proof.transcript import Transcript

JAX_CODECS = {api.SXT_FIELD_SCALAR255: jsc.SCALAR25519_CODEC, api.SXT_FIELD_GRUMPKIN: jsc.FIELDGK_CODEC}

# n -> (product table, product terms) over three MLEs: degrees 1, 2, 4, 3, 5
CASES = {
    1: ([(5, 1)], [0]),
    2: ([(3, 2)], [0, 1]),
    3: ([(2, 4), (9, 1)], [0, 1, 2, 0, 2]),
    8: tuple(vec.SUMCHECK_CASES["n8_deg3"][1:]),
    37: tuple(vec.SUMCHECK_CASES["n37_deg5"][1:]),
}
KINDS = ["merlin-bytes", "merlin-ints", "callback-bytes"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def cpu_backend():
    api.reset_backend_for_testing()
    api.init("cpu")
    yield
    api.reset_backend_for_testing()


def _rows(n: int, seed: int) -> np.ndarray:
    """(3, n, 32) uint8 ABI rows of 62-bit values."""
    rows = np.zeros((3, n, 32), np.uint8)
    vals = np.random.default_rng(seed).integers(0, 2**62, size=(3, n), dtype=np.uint64)
    rows[:, :, :8] = vals.view(np.uint8).reshape(3, n, 8)
    return rows


def _ints(rows: np.ndarray) -> list[list[int]]:
    return [[int.from_bytes(bytes(r), "little") for r in mle] for mle in rows]


def _callback(modulus: int):
    return lambda poly: (7 * sum(poly) + 3 * len(poly) + 1) % modulus


def _prove_both(field_id: int, kind: str, mles, table, terms, n: int, label=b"t"):
    codec = JAX_CODECS[field_id]
    if kind.startswith("callback"):
        cb = _callback(codec.field.modulus)
        want = jsc.prove_sum(jsc.CallbackSumcheckTranscript(cb), mles, table, terms, n, codec)
        got = api.prove_sumcheck(field_id, mles, table, terms, n, challenge_callback=cb)
    else:
        want = jsc.prove_sum(jsc.ReferenceSumcheckTranscript(JTranscript(label), codec), mles, table, terms, n, codec)
        got = api.prove_sumcheck(field_id, mles, table, terms, n, transcript=Transcript(label))
    return got, want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", sorted(CASES))
def test_prove_matches_blitzar_tpu(field_id, n, kind):
    table, terms = CASES[n]
    rows = _rows(n, seed=n)
    mles = _ints(rows) if kind == "merlin-ints" else rows
    got, want = _prove_both(field_id, kind, mles, table, terms, n)
    assert got == want
    polys, point = got
    assert len(polys) == len(point) == max(tsc.ceil_log2(n), 1)
    assert all(len(p) == max(k for _, k in table) + 1 for p in polys)


def test_rows_at_or_above_the_modulus(field_id):
    """ABI rows m, m + 5 and 2^256 - 1: reduced (scalar25519) or taken as
    the residues they are (grumpkin), as blitzar_tpu takes them."""
    codec = JAX_CODECS[field_id]
    m = codec.field.modulus
    n = 3
    rows = _rows(n, seed=50)
    for i, v in enumerate([m, m + 5, 2**256 - 1]):
        rows[i % 3, i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    reduced = rows.copy()
    for i, v in enumerate([m, m + 5, 2**256 - 1]):
        reduced[i % 3, i] = np.frombuffer((v % m).to_bytes(32, "little"), np.uint8)
    table, terms = CASES[n]
    got, want = _prove_both(field_id, "merlin-bytes", rows, table, terms, n)
    assert got == want
    assert got == _prove_both(field_id, "merlin-bytes", reduced, table, terms, n)[1]


@pytest.mark.parametrize("case", sorted(vec.SUMCHECK_CASES))
def test_frozen_vectors(field_id, case):
    """The port reproduces the frozen vectors, and blitzar_tpu still does."""
    n, table, terms = vec.SUMCHECK_CASES[case]
    frozen = vec.SUMCHECK[(api.FIELD_CODECS[field_id].name, case)]
    got, want = _prove_both(field_id, "merlin-bytes", vec.sumcheck_inputs(n), table, terms, n, vec.SUMCHECK_LABEL)
    assert got == want == (frozen["polynomials"], frozen["evaluation_point"])


def _values(field_id: int, rows: np.ndarray) -> list[list[int]]:
    """The field elements the ABI rows stand for: standard-form values, or
    Montgomery residues (times R^-1) for grumpkin."""
    field = JAX_CODECS[field_id].field
    scale = 1 if field_id == api.SXT_FIELD_SCALAR255 else pow(field.r, -1, field.modulus)
    return [[v * scale % field.modulus for v in mle] for mle in _ints(rows)]


def _claimed_and_final(field_id, rows, table, terms, point):
    """sum over the cube of sum_p mult_p prod MLE_t, and the same at the
    evaluation point, each MLE evaluated by folds, in Python integers."""
    m = JAX_CODECS[field_id].field.modulus
    vals = _values(field_id, rows)
    n_pad = 1 << len(point)
    vals = [v + [0] * (n_pad - len(v)) for v in vals]
    at_point = []
    for v in vals:
        for r in point:
            half = len(v) // 2
            v = [(lo + r * (hi - lo)) % m for lo, hi in zip(v[:half], v[half:])]
        at_point.append(v[0])
    claimed = final = 0
    first = 0
    for mult, length in table:
        ts = terms[first : first + length]
        first += length
        for i in range(n_pad):
            prod = mult
            for t in ts:
                prod = prod * vals[t][i] % m
            claimed += prod
        prod = mult
        for t in ts:
            prod = prod * at_point[t] % m
        final += prod
    return claimed % m, final % m


def test_verifier_accepts_and_rejects_as_blitzar_tpu(field_id):
    n = 37
    table, terms = CASES[n]
    rows = _rows(n, seed=n)
    polys, point = _prove_both(field_id, "merlin-bytes", rows, table, terms, n)[0]
    claimed, final = _claimed_and_final(field_id, rows, table, terms, point)
    degree = max(k for _, k in table)
    tcodec, jcodec = api.FIELD_CODECS[field_id], JAX_CODECS[field_id]
    m = jcodec.field.modulus
    tampered = [list(p) for p in polys]
    tampered[2][1] = (tampered[2][1] + 1) % m

    def both(expected, proof, deg, rounds):
        got = tsc.verify_sumcheck_no_evaluation(
            expected, tsc.ReferenceSumcheckTranscript(Transcript(b"t"), tcodec), proof, deg, rounds, tcodec)
        want = jsc.verify_sumcheck_no_evaluation(
            expected, jsc.ReferenceSumcheckTranscript(JTranscript(b"t"), jcodec), proof, deg, rounds, jcodec)
        assert got == want
        return got

    ok, got_point, got_final = both(claimed, polys, degree, len(polys))
    assert ok and got_point == point and got_final == final
    assert not both((claimed + 1) % m, polys, degree, len(polys))[0]
    assert not both(claimed, tampered, degree, len(polys))[0]
    assert not both(claimed, polys[:-1], degree, len(polys))[0]
    assert not both(claimed, polys, degree + 1, len(polys))[0]


def test_bad_product_tables_raise(field_id):
    rows = _rows(4, seed=1)
    for table, terms in (([(1, 6)], [0] * 6), ([(1, 2)], [0, 3]), ([(1, 2)], [0])):
        with pytest.raises(ValueError):
            api.prove_sumcheck(field_id, rows, table, terms, 4, transcript=Transcript(b"t"))
