"""blitzar_tpu_torch.proof.transcript (the port's own copy) against
blitzar_tpu.proof.transcript and the merlin crate's vector: byte for byte,
messages of every size around the STROBE-128 rate, u64s, challenges, scalar
challenges and the 203-byte ABI state."""

import numpy as np
import pytest

from blitzar_tpu.proof.transcript import Transcript as JTranscript
from blitzar_tpu_torch.proof.transcript import Transcript

ORDER = 2**252 + 27742317777372353535851937790883648493


def test_merlin_vector():
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


@pytest.mark.parametrize("size", [0, 1, 31, 165, 166, 167, 400])
def test_matches_blitzar_tpu(size):
    msg = np.random.default_rng(size).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    ours, theirs = Transcript(b"proto"), JTranscript(b"proto")
    for t in (ours, theirs):
        t.append_message(b"m", msg)
        t.append_u64(b"n", 2**64 - 1 - size)
    assert ours.to_bytes203() == theirs.to_bytes203()
    assert ours.challenge_bytes(b"c", size + 1) == theirs.challenge_bytes(b"c", size + 1)
    assert ours.challenge_scalar(b"x", ORDER) == theirs.challenge_scalar(b"x", ORDER)
    assert ours.to_bytes203() == theirs.to_bytes203()


def test_abi_state_round_trip():
    t = Transcript(b"proto")
    t.append_message(b"m", b"abc")
    state = t.to_bytes203()
    assert len(state) == 203
    again, jt = Transcript.from_bytes203(state), JTranscript.from_bytes203(state)
    assert again.challenge_bytes(b"c", 64) == jt.challenge_bytes(b"c", 64) == t.challenge_bytes(b"c", 64)
