"""Bulletproofs inner-product argument over ristretto255 (the port of
blitzar_tpu/proof/inner_product.py).

Round structure and transcript protocol of reference
sxt/proof/inner_product/proof_computation.cc:61-155 (domain "inner product
proof v1", labels "n"/"L"/"R"/"x"):

  round (mid = n_k / 2):
    cL = <a_lo, b_hi>, cR = <a_hi, b_lo>
    L = <a_lo, G_hi> + cL Q        R = <a_hi, G_lo> + cR Q
    x = challenge;  a' = x a_lo + x^-1 a_hi;  b' = x^-1 b_lo + x b_hi
    G' = x^-1 G_lo + x G_hi

As in blitzar_tpu, the generator fold is never done: the folded generator
G^(k)[i] is sum_{j mod n_k = i} mu_j G_j over the ORIGINAL generators, mu_j
the product of the challenges (x or x^-1) of the halves j sat in. So each
round's L and R are one two-output query on the handle of the original G
(exponents mu_j a_lo[(j mod n_k) - mid] and mu_j a_hi[j mod n_k]) plus a
two-output query on a handle of Q (window 4, one point). L and R are the
reference's points, and their canonical encodings its bytes.

On the card every full-width scalar multiply is one ``mont_mul_ew`` launch.
mu is kept in standard form and a, b in Montgomery form, so mu a is the
standard-form exponent in one multiply. cL and cR are lane sums of
``mont_mul_ew`` products, reduced on the host, where the transcript is; L
and R are encoded together, one ``ristretto_encode`` launch a round. The fold is lazy in
blitzar_tpu (inside the next round's program); here it follows each
challenge, and the last round's fold of a, which gives ap, runs on the
host on the two values left.

Over more than ``engine.STREAM_ABOVE`` generators (2^21 on, since the
padded count is a power of two) G keeps no handle: each round's two-output
G query, and the verifier's, is streamed over the original generators chunk
by chunk (``fixed.stream_products``), as
blitzar_tpu/proof/inner_product.py:195-218 does from its
``_STREAM_COMMIT_MIN`` = 2^21 on; Q's handle stays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import edwards25519 as ed
from ..fields import params
from ..fields.mont import limbs_to_rows, rows_to_limbs
from ..msm import engine
from ..msm import fixed
from ..ops import cuda_mont, cuda_point
from . import ceil_log2
from .transcript import Transcript

S = params.SCALAR25519
ORDER = params.L25519
NBITS = 256


# ---------------------------------------------------------------------------
# host-side scalar plumbing
# ---------------------------------------------------------------------------


def scalars_to_ints(values) -> list[int]:
    """(n, 32) uint8 LE rows, 32-byte strings or ints -> ints mod l."""
    out = []
    for v in values:
        if isinstance(v, int):
            out.append(v % ORDER)
        elif isinstance(v, (bytes, bytearray)):
            out.append(int.from_bytes(v, "little") % ORDER)
        else:
            out.append(int.from_bytes(bytes(np.asarray(v, np.uint8)), "little") % ORDER)
    return out


def _scalar_rows(values) -> np.ndarray:
    """Scalars -> (n, 32) uint8 LE rows; an (n, 32) uint8 array (the ABI
    layout) passes as it is, unreduced (blitzar_tpu inner_product.py:70-85)."""
    if isinstance(values, np.ndarray) and values.dtype == np.uint8 and values.ndim == 2 and values.shape[1] == 32:
        return values
    ints = scalars_to_ints(values)
    rows = np.zeros((len(ints), 32), np.uint8)
    for i, v in enumerate(ints):
        rows[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return rows


def _int_row(value: int) -> np.ndarray:
    return np.frombuffer((value % ORDER).to_bytes(32, "little"), np.uint8)


def _mont_rows(rows: np.ndarray, length: int, device) -> torch.Tensor:
    """(n, 32) rows -> (nlimbs, length) Montgomery, reduced mod l, zero-padded."""
    raw = rows_to_limbs(rows, S.nlimbs, device)
    if raw.shape[1] < length:
        raw = torch.nn.functional.pad(raw, (0, length - raw.shape[1]))
    return cuda_mont.to_mont(S, raw)


def _mont_int(value: int, device) -> torch.Tensor:
    return S.from_ints([value], device)


def _lane_sum_int(a: torch.Tensor) -> int:
    """The sum of an (nlimbs, W) batch of standard-form values, mod l."""
    return sum(int(v) << (16 * i) for i, v in enumerate(S.lane_sum(a).tolist()))


def _g_source(g_vector: ed.PointP3, np_: int):
    """What G's queries run on: its cached handle up to
    ``engine.STREAM_ABOVE`` generators, the points themselves (streamed)
    above, as every MSM of the engine."""
    return g_vector if np_ > engine.STREAM_ABOVE else engine.cached_handle(g_vector, np_)


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------


def _query(queries, num_outputs: int) -> ed.PointP3:
    """The sum of queries: ``queries`` is a list of (source, (O, n, 32)
    uint8 device scalars), the source a handle (n <= its points) or a point
    batch of n points, streamed; returns (O,) points. The bit-row products
    are added before one doubling-and-add ladder (sum_b 2^b (P_b + Q_b) is
    sum_b 2^b P_b + sum_b 2^b Q_b): one ladder for L and R, and one for the
    verifier's check, and no host round trip as in
    ``fixed.fixed_multiexponentiation``."""
    w = fixed.DEFAULT_WINDOW_WIDTH
    products = None
    for source, scalars in queries:
        handle = isinstance(source, fixed.MultiexpHandle)
        width = source.num_groups * source.window_width if handle else -(-scalars.shape[1] // w) * w
        if scalars.shape[1] < width:
            scalars = torch.nn.functional.pad(scalars, (0, 0, 0, width - scalars.shape[1]))
        part = fixed.partition_products(source, scalars) if handle else fixed.stream_products(source, scalars)
        products = part if products is None else ed.add(products, part)
    return fixed.doubling_combine(products, num_outputs, NBITS)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def _init_transcript(transcript: Transcript, n: int) -> None:
    transcript.append_message(b"domain-sep", b"inner product proof v1")
    transcript.append_u64(b"n", n)


def _round_challenge(transcript: Transcript, l_bytes: bytes, r_bytes: bytes) -> int:
    transcript.append_message(b"L", l_bytes)
    transcript.append_message(b"R", r_bytes)
    return transcript.challenge_scalar(b"x", ORDER)


def _round_exponents(a: torch.Tensor, mu: torch.Tensor, mid: int) -> torch.Tensor:
    """(2, np_, 32) uint8 standard-form exponents [e_L; e_R] over the
    original generators: with n_k = 2 mid,
      e_L[j] = mu[j] a[(j mod n_k) - mid]  where (j mod n_k) >= mid, else 0
      e_R[j] = mu[j] a[mid + (j mod n_k)]  where (j mod n_k) <  mid, else 0
    (a (nlimbs, n_k) Montgomery, mu (nlimbs, np_) standard form)."""
    periods = mu.shape[1] // (2 * mid)
    zeros = torch.zeros_like(a[:, :mid])
    base_l = torch.cat([zeros, a[:, :mid]], dim=1).repeat(1, periods)
    base_r = torch.cat([a[:, mid:], zeros], dim=1).repeat(1, periods)
    e_l = cuda_mont.mont_mul_ew(S, mu, base_l)
    e_r = cuda_mont.mont_mul_ew(S, mu, base_r)
    return torch.stack([limbs_to_rows(e_l), limbs_to_rows(e_r)])


def _cross_terms(a: torch.Tensor, b: torch.Tensor, mid: int) -> tuple[int, int]:
    """cL = <a_lo, b_hi>, cR = <a_hi, b_lo> (a, b Montgomery: the products
    are Montgomery, the sums' Montgomery form reduced on the host)."""
    c_l = S.lane_sum(cuda_mont.mont_mul_ew(S, a[:, :mid], b[:, mid:]))
    c_r = S.lane_sum(cuda_mont.mont_mul_ew(S, a[:, mid:], b[:, :mid]))
    return tuple(S.to_ints(torch.stack([c_l, c_r], dim=1)))


def _fold(a, b, mu, x: int, xinv: int, mid: int):
    """a' = x a_lo + x^-1 a_hi, b' = x^-1 b_lo + x b_hi, and mu times x^-1
    on the low half of each period of 2 mid, x on the high half."""
    dev = a.device
    xm, xim = _mont_int(x, dev), _mont_int(xinv, dev)
    a_next = S.add(cuda_mont.mont_mul_ew(S, a[:, :mid], xm), cuda_mont.mont_mul_ew(S, a[:, mid:], xim))
    b_next = S.add(cuda_mont.mont_mul_ew(S, b[:, :mid], xim), cuda_mont.mont_mul_ew(S, b[:, mid:], xm))
    factor = torch.cat([xim.expand(-1, mid), xm.expand(-1, mid)], dim=1).repeat(1, mu.shape[1] // (2 * mid))
    return a_next, b_next, cuda_mont.mont_mul_ew(S, mu, factor)


def prove_inner_product(transcript: Transcript, a_vector, b_vector, g_vector: ed.PointP3, q_value: ed.PointP3):
    """Returns (l_vector (rounds, 32) uint8, r_vector (rounds, 32) uint8,
    ap_value int) (reference prove_inner_product,
    proof_computation.cc:61-107). g_vector holds np = 2^ceil(lg n) points,
    q_value is a (1,) batch, both on the device the proof runs on."""
    a_rows = _scalar_rows(a_vector)
    b_rows = _scalar_rows(b_vector)
    n = a_rows.shape[0]
    if n < 1 or b_rows.shape[0] != n:
        raise ValueError(f"a and b need equal positive lengths, got {n} and {b_rows.shape[0]}")
    num_rounds = ceil_log2(n)
    np_ = 1 << num_rounds
    if g_vector.x.shape[1] != np_:
        raise ValueError(f"g_vector must have {np_} points, has {g_vector.x.shape[1]}")
    _init_transcript(transcript, n)
    l_out = np.zeros((num_rounds, 32), np.uint8)
    r_out = np.zeros((num_rounds, 32), np.uint8)
    if n == 1:
        return l_out, r_out, scalars_to_ints([a_rows[0]])[0]

    dev = g_vector.x.device
    a = _mont_rows(a_rows, np_, dev)
    b = _mont_rows(b_rows, np_, dev)
    mu = cuda_mont.constant(S, 1, dev).expand(-1, np_).contiguous()
    g_source = _g_source(g_vector, np_)
    # Q's handle: window 4 over one point (blitzar_tpu inner_product.py:391)
    q_handle = fixed.MultiexpHandle(q_value, window_width=4, n=1)
    for k in range(num_rounds):
        mid = a.shape[1] // 2
        c_l, c_r = _cross_terms(a, b, mid)
        q_scalars = torch.from_numpy(np.stack([_int_row(c_l), _int_row(c_r)])[:, None]).to(dev)
        lr = cuda_point.ristretto_encode(_query([(g_source, _round_exponents(a, mu, mid)), (q_handle, q_scalars)], 2)).cpu().numpy().T
        l_out[k], r_out[k] = lr
        x = _round_challenge(transcript, bytes(lr[0]), bytes(lr[1]))
        xinv = pow(x, -1, ORDER)
        if mid > 1:
            a, b, mu = _fold(a, b, mu, x, xinv, mid)
        else:
            a0, a1 = S.to_ints(a)
            ap_value = (x * a0 + xinv * a1) % ORDER
    return l_out, r_out, ap_value


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def _g_exponents(allinv_ap: int, x_sq: list[int], device) -> torch.Tensor:
    """(nlimbs, np) standard form: entry j = allinv ap prod over set bits k
    of j of x_sq[rounds - 1 - k], by doubling concatenation (reference
    verification_computation.cc:28-44)."""
    g = cuda_mont.constant(S, allinv_ap, device)
    for v in reversed(x_sq):
        g = torch.cat([g, cuda_mont.mont_mul_ew(S, g, _mont_int(v, device))], dim=1)
    return g


def verify_inner_product(
    transcript: Transcript,
    b_vector,
    product,
    a_commit: ed.PointP3,
    l_vector,
    r_vector,
    ap_value,
    g_vector: ed.PointP3,
    q_value: ed.PointP3,
) -> bool:
    """Reference verify_inner_product (proof_computation.cc:112-155) with
    compute_verification_exponents (verification_computation.cc:80-123):
    the sum of the G MSM (exponents g_exps) and the [Q | L | R] MSM
    (exponents <g_exps, b>, -x_i^2, -x_i^-2) against product Q + a_commit,
    compared as encodings. g_vector, q_value and a_commit lie on the device
    the check runs on."""
    b_rows = _scalar_rows(b_vector)
    n = b_rows.shape[0]
    if n < 1:
        raise ValueError("b must not be empty")
    num_rounds = ceil_log2(n)
    np_ = 1 << num_rounds
    ap = scalars_to_ints([ap_value])[0]
    product_int = scalars_to_ints([product])[0]
    l_vector = np.asarray(l_vector, np.uint8).reshape(-1, 32)
    r_vector = np.asarray(r_vector, np.uint8).reshape(-1, 32)
    if l_vector.shape[0] != num_rounds or r_vector.shape[0] != num_rounds:
        return False
    dev = g_vector.x.device

    _init_transcript(transcript, n)
    x_vec = [_round_challenge(transcript, bytes(l_vector[i]), bytes(r_vector[i])) for i in range(num_rounds)]
    x_sq = [x * x % ORDER for x in x_vec]
    allinv = 1
    for x in x_vec:
        allinv = allinv * pow(x, -1, ORDER) % ORDER
    g_exps = _g_exponents(allinv * ap % ORDER, x_sq, dev)  # standard form
    # <g_exps, b> over the first n: standard form times Montgomery is standard
    prod_check = _lane_sum_int(cuda_mont.mont_mul_ew(S, g_exps[:, :n], _mont_rows(b_rows, n, dev)))

    if num_rounds:
        lr_pts, lr_valid = cuda_point.ristretto_decode(torch.from_numpy(np.concatenate([l_vector, r_vector]).T.copy()).to(dev))
        if not bool(lr_valid.all()):
            return False
    else:
        lr_pts = ed.identity((0,), dev)

    # expected = <g_exps, G> + <g_exps, b> Q - sum x_i^2 L_i - sum x_i^-2 R_i
    # against commit = product Q + a_commit (reference
    # proof_computation.cc:139-154), checked as expected - product Q ==
    # a_commit: one combined query over G's handle (cached by the prover;
    # G streamed above engine.STREAM_ABOVE generators) and a handle of
    # [Q | L | R] with Q's exponent <g_exps, b> - product.
    # ristretto255 encodings are canonical, one per group element, so the
    # two encodings are equal exactly when blitzar_tpu's two are. The
    # [Q | L | R] handle serves this one check and stays out of the cache.
    qlr = ed.cat([q_value, lr_pts])
    exps = [prod_check - product_int] + [-v for v in x_sq] + [-pow(v, -1, ORDER) for v in x_sq]
    qlr_scalars = torch.from_numpy(np.stack([_int_row(v) for v in exps])[None]).to(dev)
    g_scalars = limbs_to_rows(g_exps)[None]
    check = _query([(_g_source(g_vector, np_), g_scalars), (fixed.MultiexpHandle(qlr), qlr_scalars)], 1)
    enc = cuda_point.ristretto_encode(ed.cat([check, a_commit])).cpu().numpy().T
    return bytes(enc[0]) == bytes(enc[1])
