"""The inner-product argument with its G queries streamed: blitzar_tpu_torch
against blitzar_tpu at n = 8, blitzar_tpu's ``_STREAM_COMMIT_MIN`` lowered
from 2^21 to 8 (blitzar_tpu/proof/inner_product.py:197) and the port's
``engine.STREAM_ABOVE`` from 2^20 to 4, so every round's
two-output G query, and the port's verifier's, is a streamed build+query
over the original generators. The proofs are byte-equal, and the port's
verifier accepts the honest proof and rejects tampered ones."""

import numpy as np
import pytest
import torch

import torch_proof_vectors as vec
from blitzar_tpu import generators as jgen
from blitzar_tpu.proof import inner_product as jipa
from blitzar_tpu.proof.transcript import Transcript as JTranscript
from blitzar_tpu_torch import api
from blitzar_tpu_torch.msm import engine as tengine
from blitzar_tpu_torch.msm import fixed as tfixed
from blitzar_tpu_torch.proof import inner_product as tipa
from blitzar_tpu_torch.proof.transcript import Transcript

N = 8


@pytest.fixture(scope="module")
def proofs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain versions run many tiny ops
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jipa, "_STREAM_COMMIT_MIN", 8)
        mp.setattr(tengine, "STREAM_ABOVE", 4)
        api.reset_backend_for_testing()
        api.init("cpu")
        a, b = vec.ipa_inputs(N)
        g, q = jgen.ristretto_generators(N), jgen.ristretto_generators(1, offset=N)
        jproof = jipa.prove_inner_product(JTranscript(vec.IPA_LABEL), a, b, g, q)
        calls = []
        inner = tfixed.stream_products
        mp.setattr(tfixed, "stream_products", lambda *args, **kw: calls.append(1) or inner(*args, **kw))
        tproof = api.prove_inner_product(Transcript(vec.IPA_LABEL), N, 0, a, b)
        prove_streams = len(calls)
        rows = np.stack([np.frombuffer(int(v).to_bytes(32, "little"), np.uint8) for v in a])
        commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, N, rows)]))
        product = sum(x * y for x, y in zip(a, b)) % tipa.ORDER

        def verify(l, r, ap):
            return api.verify_inner_product(Transcript(vec.IPA_LABEL), N, 0, b, product, commit, l, r, ap)

        yield {"jproof": jproof, "tproof": tproof, "prove_streams": prove_streams, "verify": verify,
               "calls": calls, "handles": list(tengine._HANDLE_CACHE)}
        api.reset_backend_for_testing()
    torch.set_num_threads(threads)


def test_streamed_proof_matches_blitzar_tpu(proofs):
    (tl, tr, tap), (jl, jr, jap) = proofs["tproof"], proofs["jproof"]
    assert tl.shape == (3, 32)
    assert np.array_equal(tl, jl) and np.array_equal(tr, jr) and tap == jap
    # one streamed G query a round, and no handle of G
    assert proofs["prove_streams"] == 3
    assert all(h[2] != N for h in proofs["handles"])


@pytest.mark.parametrize("tamper", ["honest", "ap+1", "flipped L byte"])
def test_streamed_verifier(proofs, tamper):
    l, r, ap = proofs["tproof"]
    before = len(proofs["calls"])
    if tamper == "ap+1":
        ap = (ap + 1) % tipa.ORDER
    elif tamper == "flipped L byte":
        l = l.copy()
        l[1, 3] ^= 0x04
    assert proofs["verify"](l, r, ap) == (tamper == "honest")
    if tamper != "flipped L byte":  # (whose L may not decode: no query then)
        assert len(proofs["calls"]) == before + 1  # the verifier's G query streamed too
