"""The proofs' rows to Montgomery limbs (csrc/mont_rows.cu): the host
harness's run of the kernel's schedule and body (csrc/mont_rows.cuh) and
``cuda_mont.mont_from_rows_plain`` against blitzar_tpu's device conversions
(proof/inner_product.py:_mont_from_rows, proof/sumcheck.py's two codecs'
mles_to_device), on rows at and above the modulus, at and above 2^255,
all 0xFF, narrower than 32 bytes, with n off a power of two and padding;
then the proofs through the port's API on the CPU against the frozen
vectors."""

import ctypes

import numpy as np
import pytest
import torch

import torch_host_harness
import torch_proof_vectors as vec
from blitzar_tpu.proof import inner_product as jipa
from blitzar_tpu.proof import sumcheck as jsc
from blitzar_tpu_torch import api
from blitzar_tpu_torch.ops import cuda_mont
from blitzar_tpu_torch.proof.transcript import Transcript

FIELDS = {"scalar25519": (cuda_mont.SXT_FIELD_SCALAR255, "standard", jsc.SCALAR25519_CODEC),
          "grumpkin": (cuda_mont.SXT_FIELD_GRUMPKIN, "residues", jsc.FIELDGK_CODEC)}
# (field, num_mles, n, nbytes, n_pad): two blocks of a column run and a
# pad, the 4-byte and the byte reads, a padding-only block, one element
CASES = [
    ("scalar25519", 1, 300, 32, 512),
    ("scalar25519", 3, 37, 32, 64),
    ("scalar25519", 2, 20, 13, 32),
    ("scalar25519", 3, 5, 8, 300),
    ("grumpkin", 3, 300, 32, 512),
    ("grumpkin", 2, 37, 20, 64),
    ("grumpkin", 1, 1, 31, 1),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def harness():
    return torch_host_harness.load()


def _rows(field, num_mles: int, n: int, nbytes: int, seed: int) -> np.ndarray:
    """(num_mles, n, nbytes) seeded rows, the first of each MLE edge values
    (cut to nbytes): 0, 1, m - 1, m, m + 1, 2^255 - 19, 2^255, 2^256 - 1."""
    rows = np.random.default_rng(seed).integers(0, 256, size=(num_mles, n, nbytes), dtype=np.uint8)
    m = field.modulus
    edges = [0, 1, m - 1, m, m + 1, 2**255 - 19, 2**255, 2**256 - 1]
    for k, v in enumerate(edges[:n]):
        rows[:, k] = np.frombuffer(v.to_bytes(32, "little")[:nbytes], np.uint8)
    return rows


def _values(limbs: np.ndarray) -> list[int]:
    """(nlimbs, *batch) limbs -> the batch's integers, in order."""
    flat = np.asarray(limbs, np.int64).reshape(limbs.shape[0], -1)
    return [sum(int(flat[l, j]) << (16 * l) for l in range(flat.shape[0])) for j in range(flat.shape[1])]


def _host(harness, field_id: int, field, mode: str, flat: np.ndarray, num_mles: int, n_pad: int) -> np.ndarray:
    flat = np.ascontiguousarray(flat, np.uint8)
    scale = np.ascontiguousarray(cuda_mont._rows_scale(field, mode, "cpu").numpy(), np.int32)
    out = np.full((field.nlimbs, num_mles, n_pad), -1, np.int32)
    rc = harness.btt_host_mont_from_rows(
        ctypes.c_int(field_id), ctypes.c_void_p(flat.ctypes.data), ctypes.c_int64(num_mles),
        ctypes.c_int64(flat.shape[0] // num_mles), ctypes.c_int(flat.shape[1]), ctypes.c_int64(n_pad),
        ctypes.c_void_p(scale.ctypes.data), ctypes.c_void_p(out.ctypes.data))
    assert rc == 0
    return out


@pytest.mark.parametrize("name,num_mles,n,nbytes,n_pad", CASES)
def test_rows_match_blitzar_tpu(harness, name, num_mles, n, nbytes, n_pad):
    field_id, mode, jcodec = FIELDS[name]
    field = cuda_mont.FIELDS[field_id]
    rows = _rows(field, num_mles, n, nbytes, seed=n + nbytes)
    flat = rows.reshape(num_mles * n, nbytes)
    plain = cuda_mont.mont_from_rows_plain(field, torch.from_numpy(flat.copy()), num_mles, n_pad, mode)
    host = _host(harness, field_id, field, mode, flat, num_mles, n_pad)
    assert np.array_equal(host, plain.numpy())
    assert not host[:, :, n:].any()
    got = _values(host)
    assert max(got) < field.modulus
    want = np.asarray(jcodec.mles_to_device(rows, n_pad))
    assert got == [v % field.modulus for v in _values(want)]
    if name == "scalar25519" and num_mles == 1 and nbytes == 32:
        assert got == [v % field.modulus for v in _values(np.asarray(jipa._mont_from_rows(flat, n_pad)))]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    field = cuda_mont.FIELDS[cuda_mont.SXT_FIELD_SCALAR255]
    rows = torch.zeros((6, 32), dtype=torch.uint8)
    for bad in (dict(rows=rows.to(torch.int32)), dict(rows=torch.zeros((6, 33), dtype=torch.uint8)),
                dict(num_mles=4), dict(n_pad=2), dict(mode="montgomery")):
        kwargs = dict(rows=rows, num_mles=2, n_pad=4, mode="standard") | bad
        with pytest.raises(ValueError):
            cuda_mont.mont_from_rows(field, **kwargs)


@pytest.fixture
def cpu_backend():
    api.reset_backend_for_testing()
    api.init("cpu")
    yield
    api.reset_backend_for_testing()


@pytest.mark.parametrize("case", sorted(vec.SUMCHECK_CASES))
def test_sumcheck_rows_reproduce_the_frozen_vectors(cpu_backend, case):
    n, ptable, pterms = vec.SUMCHECK_CASES[case]
    for fid, codec in api.FIELD_CODECS.items():
        got = api.prove_sumcheck(fid, vec.sumcheck_inputs(n), ptable, pterms, n,
                                 transcript=Transcript(vec.SUMCHECK_LABEL))
        frozen = vec.SUMCHECK[(codec.name, case)]
        assert got == (frozen["polynomials"], frozen["evaluation_point"])


@pytest.mark.parametrize("n", sorted(vec.IPA))
def test_ipa_rows_reproduce_the_frozen_vectors(cpu_backend, n):
    a, b = vec.ipa_inputs(n)
    rows = [np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in x]) for x in (a, b)]
    l, r, ap = api.prove_inner_product(Transcript(vec.IPA_LABEL), n, 0, *rows)
    frozen = vec.IPA[n]
    assert [bytes(x).hex() for x in l] == frozen["L"] and [bytes(x).hex() for x in r] == frozen["R"]
    assert ap == frozen["ap"]
