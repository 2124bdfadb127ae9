"""Cases shared by tests/test_torch_ipa_*.py: the inner-product argument of
blitzar_tpu_torch (``api.prove_inner_product`` / ``api.verify_inner_product``
on the CPU backend, plain versions of the kernels) against
blitzar_tpu.proof.inner_product, exactly: L, R and ap, and the verifier's
answers on the honest proof and on tampered ones.

The inputs are the frozen vectors' (tests/torch_proof_vectors.py: label
b"ipa-vec", a = 3i + 1, b = 5i + 2), so at n = 4 and 7 both sides also
reproduce the frozen L, R and ap. Each test_torch_ipa_<n>.py sets the module
fixture ``n``; blitzar_tpu compiles its prover and verifier programs per
2^ceil(lg n), so the sizes run as separate files (in parallel under xdist),
and with the shapes of tests/test_inner_product.py."""

import numpy as np
import pytest
import torch

import torch_proof_vectors as vec
from blitzar_tpu import generators as jgen
from blitzar_tpu.curves import edwards25519 as jed
from blitzar_tpu.msm import engine as jengine
from blitzar_tpu.proof import inner_product as jipa
from blitzar_tpu.proof.transcript import Transcript as JTranscript
from blitzar_tpu_torch import api
from blitzar_tpu_torch.proof import inner_product as tipa
from blitzar_tpu_torch.proof.transcript import Transcript

ORDER = tipa.ORDER


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny ops, where torch's intra-op
    threads only add overhead (and contend with the other test workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(values) -> np.ndarray:
    return np.stack([np.frombuffer(int(v).to_bytes(32, "little"), np.uint8) for v in values])


@pytest.fixture(scope="module")
def proofs(n):
    """Both sides' proofs at n, and what each verifier needs."""
    api.reset_backend_for_testing()
    api.init("cpu")
    a, b = vec.ipa_inputs(n)
    np_ = 1 << jipa.ceil_log2(n)
    g, q = jgen.ristretto_generators(np_), jgen.ristretto_generators(1, offset=np_)
    jproof = jipa.prove_inner_product(JTranscript(vec.IPA_LABEL), a, b, g, q)
    tproof = api.prove_inner_product(Transcript(vec.IPA_LABEL), n, 0, a, b)
    j_commit = jengine.msm(jed.index_batch(g, (slice(0, n),)), [_rows(a)], [32], [False])
    t_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, _rows(a))]))
    yield {"a": a, "b": b, "g": g, "q": q, "jproof": jproof, "tproof": tproof, "j_commit": j_commit,
           "t_commit": t_commit, "product": sum(x * y for x, y in zip(a, b)) % ORDER}
    api.reset_backend_for_testing()


def test_prove_matches_blitzar_tpu_and_frozen(n, proofs):
    (tl, tr, tap), (jl, jr, jap) = proofs["tproof"], proofs["jproof"]
    rounds = jipa.ceil_log2(n)
    assert tl.shape == tr.shape == (rounds, 32) and tl.dtype == np.uint8
    assert np.array_equal(tl, jl) and np.array_equal(tr, jr) and tap == jap
    if n in vec.IPA:
        frozen = vec.IPA[n]
        assert [bytes(row).hex() for row in tl] == frozen["L"]
        assert [bytes(row).hex() for row in tr] == frozen["R"]
        assert tap == frozen["ap"]


def _tampered(proof, product):
    """(name, product, l, r, ap) of the honest proof and of tampered ones:
    ap + 1, and with rounds a flipped L byte, an invalid L encoding and a
    round too few."""
    l, r, ap = proof
    cases = [("honest", product, l, r, ap), ("ap+1", product, l, r, (ap + 1) % ORDER)]
    if len(l):
        flipped = l.copy()
        flipped[0, 5] ^= 0x10
        invalid = l.copy()
        invalid[-1] = 0xFF
        cases += [("flipped L byte", product, flipped, r, ap), ("invalid L", product, invalid, r, ap),
                  ("round too few", product, l[1:], r[1:], ap)]
    return cases


def test_verify_answers_match_blitzar_tpu(n, proofs):
    answers = {}
    label = vec.IPA_LABEL
    for name, product, l, r, ap in _tampered(proofs["tproof"], proofs["product"]):
        got = api.verify_inner_product(Transcript(label), n, 0, proofs["b"], product, proofs["t_commit"], l, r, ap)
        want = jipa.verify_inner_product(JTranscript(label), proofs["b"], product, proofs["j_commit"], l, r, ap,
                                         proofs["g"], proofs["q"])
        assert got == want, name
        answers[name] = got
    assert answers.pop("honest") and not any(answers.values()), answers
