"""The CUDA kernels of the proofs (the sumcheck prover and the inner-product
argument): wrappers, plain versions, counts.

Each wrapper takes a field (``fields/params.py``: ``SCALAR25519`` or
``BN254_FR``) and (nlimbs, *batch) int32 Montgomery limbs, the public layout.
On a tensor that lies on the CPU it runs the plain PyTorch version beside it;
on a CUDA tensor it checks device, dtype, shape and layout, allocates the
outputs, launches its kernel from ``csrc/`` on the current stream and adds
one to ``cuda_point.LAUNCHES[name]``, or raises. The plain versions serve
the CPU tests and the comparisons of ``chip_smoke.py``; nothing on the
card's main path calls them. One template per kernel covers both fields; the
launcher picks the instantiation by the field's C ABI id (:data:`FIELDS`,
the port's one table of the proof fields).

The kernels and the TPU kernels they replace (all in
``blitzar_tpu/ops/pallas_point.py``):

===================  ======================================  ==================
wrapper              replaces                                 source
===================  ======================================  ==================
``mont_mul_ew``      ``mont_mul_ew`` :1139 (body :1128)       mont_mul_ew.cu
``mont_fold_round``  ``mont_fold_round`` :1172 (body :1110)   mont_fold_round.cu
``mont_sum_round``   ``mont_sum_round`` :1077 (body :1026)    mont_sum_round.cu
===================  ======================================  ==================

Kernel inputs are canonical (below m), but ``mont_mul_ew``'s ``a`` may be
any value below R: :func:`to_mont` and :func:`reduce_residues` use that to
reduce raw 256-bit rows in one launch.
"""

from __future__ import annotations

import functools

import torch

from ..fields import params
from ..fields.mont import MontField
from . import build
from .cuda_point import _field_arg, _launch, _on_card, _stream

# the fields of the proof kernels by their C ABI id (reference
# blitzar_api.h:33-34); api.py and the sumcheck's codecs take them from here
SXT_FIELD_SCALAR255 = 0
SXT_FIELD_GRUMPKIN = 1
FIELDS = {SXT_FIELD_SCALAR255: params.SCALAR25519, SXT_FIELD_GRUMPKIN: params.BN254_FR}

MAX_DEGREE = 5  # reference proof/sumcheck/constant.h:25
# mont_sum_round: the blocks its partials hold at most (the kernel takes as
# many as the card holds at once, fewer for a short round)
SUM_MAX_BLOCKS = 1024


# mont_mul_ew's fields by the id its launcher takes: the proof fields, and
# the base fields of bn254 G1 and bls12-381 G1 (ids of the port's own, for
# the batch inversion of a Weierstrass table, ``msm/interop.py``); Grumpkin's
# base field is BN254_FR
MUL_FIELDS = {**FIELDS, 2: params.BN254_FP, 3: params.BLS12381_FP}


def _field_id(field: MontField, fields=FIELDS) -> int:
    for field_id, f in fields.items():
        if f is field:
            return field_id
    raise ValueError(f"{field} has no such kernel: expected one of {list(fields.values())}")


# ---------------------------------------------------------------------------
# mont_mul_ew  (replaces pallas_point.py:mont_mul_ew :1139)
# ---------------------------------------------------------------------------


def mont_mul_ew_plain(field: MontField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return field.mul(a, b)


def mont_mul_ew(field: MontField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a * b * R^-1 of (nlimbs, W) ``a`` and (nlimbs, W) or
    (nlimbs, 1) ``b`` (broadcast) -> (nlimbs, W), in any field of
    :data:`MUL_FIELDS`; launches count per field in
    ``cuda_point.INSTANCE_LAUNCHES``.

    Kernel csrc/mont_mul_ew.cu, one thread per element. Bound: bytes."""
    width = a.shape[-1]
    if a.dim() != 2 or b.dim() != 2 or b.shape[1] not in (1, width):
        raise ValueError(f"mont_mul_ew: shapes {tuple(a.shape)} x {tuple(b.shape)}: expected (nl, W) x (nl, W | 1)")
    if not _on_card(a):
        return mont_mul_ew_plain(field, a, b)
    fid = _field_id(field, MUL_FIELDS)
    a, a_stride = _field_arg(a, a.device, (width,), field.nlimbs)
    b, b_stride = _field_arg(b, a.device, (b.shape[1],), field.nlimbs)
    out = torch.empty((field.nlimbs, width), dtype=torch.int32, device=a.device)
    _launch(
        "mont_mul_ew", build.library().btt_mont_mul_ew,
        fid, a.data_ptr(), a_stride, b.data_ptr(), b_stride, int(b.shape[1] != 1), width, out.data_ptr(),
        _stream(a.device), instance=field.name,
    )
    return out


def constant(field: MontField, value: int, device) -> torch.Tensor:
    """The limbs of ``value`` itself (no Montgomery scaling) as (nlimbs, 1)."""
    return torch.tensor(field.int_limbs(value), dtype=torch.int32, device=device).reshape(field.nlimbs, 1)


def to_mont(field: MontField, raw: torch.Tensor) -> torch.Tensor:
    """(nlimbs, W) raw limbs of values below R -> their reduced Montgomery
    form (times R^2 mod m, then R^-1)."""
    return mont_mul_ew(field, raw, constant(field, field.r2, raw.device))


def reduce_residues(field: MontField, raw: torch.Tensor) -> torch.Tensor:
    """(nlimbs, W) Montgomery residues below R -> the same elements,
    canonical (times R mod m, the form of 1, then R^-1)."""
    return mont_mul_ew(field, raw, constant(field, field.r, raw.device))


# ---------------------------------------------------------------------------
# mont_fold_round  (replaces pallas_point.py:mont_fold_round :1172)
# ---------------------------------------------------------------------------


def _check_table(field: MontField, mles: torch.Tensor) -> int:
    """An (nlimbs, m, 2 mid) int32 MLE table; returns mid."""
    if mles.dim() != 3 or mles.shape[0] != field.nlimbs or mles.shape[2] % 2 or mles.dtype != torch.int32:
        raise ValueError(f"MLE table {tuple(mles.shape)} {mles.dtype}: expected ({field.nlimbs}, m, 2 mid) int32")
    return mles.shape[2] // 2


def mont_fold_round_plain(field: MontField, mles: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """blitzar_tpu's formula (sumcheck.py:_fold_round): (1 - r) lo + r hi."""
    mid = _check_table(field, mles)
    r = r.reshape(field.nlimbs, 1, 1)
    one_m_r = field.sub(field.one((1, 1), r.device), r)
    return field.add(field.mul(one_m_r, mles[..., :mid]), field.mul(r, mles[..., mid:]))


def mont_fold_round(field: MontField, mles: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The sumcheck fold of an (nlimbs, m, 2 mid) table with the challenge r
    ((nlimbs, 1) Montgomery): (nlimbs, m, mid), (1 - r) lo + r hi with lo
    and hi the halves of each MLE.

    Kernel csrc/mont_fold_round.cu, one thread per output element, computing
    lo + r (hi - lo). Bound: bytes."""
    mid = _check_table(field, mles)
    if not _on_card(mles):
        return mont_fold_round_plain(field, mles, r)
    fid = _field_id(field)
    if mles.stride(2) != 1:
        mles = mles.contiguous()
    r, r_stride = _field_arg(r.reshape(field.nlimbs, 1), mles.device, (1,), field.nlimbs)
    m = mles.shape[1]
    out = torch.empty((field.nlimbs, m, mid), dtype=torch.int32, device=mles.device)
    _launch(
        "mont_fold_round", build.library().btt_mont_fold_round,
        fid, mles.data_ptr(), mles.stride(0), mles.stride(1), m, mid, r.data_ptr(), r_stride, out.data_ptr(),
        _stream(mles.device),
    )
    return out


# ---------------------------------------------------------------------------
# mont_sum_round  (replaces pallas_point.py:mont_sum_round :1077)
# ---------------------------------------------------------------------------


def _check_products(field: MontField, mults, lengths, terms, degree: int) -> None:
    num_products = lengths.shape[0]
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree {degree} outside 1..{MAX_DEGREE}")
    if tuple(mults.shape) != (field.nlimbs, num_products) or mults.dtype != torch.int32:
        raise ValueError(f"mults {tuple(mults.shape)}: expected ({field.nlimbs}, {num_products}) int32")
    if lengths.dtype != torch.int32 or terms.dtype != torch.int32 or terms.dim() != 1:
        raise ValueError("lengths and terms must be 1-D int32")


def mont_sum_round_plain(field: MontField, mles, mults, lengths, terms, degree: int) -> torch.Tensor:
    """blitzar_tpu's expansion (sumcheck.py:_sum_terms): per product the
    coefficients of prod_j (lo_j + (hi_j - lo_j) X) over all lanes, summed,
    then times the product's multiplier."""
    mid = _check_table(field, mles)
    _check_products(field, mults, lengths, terms, degree)
    lo, hi = mles[..., :mid], mles[..., mid:]
    total = field.zeros((degree + 1,), mles.device)
    first = 0
    for p, length in enumerate(lengths.tolist()):
        ts = terms[first : first + length].tolist()
        first += length
        c = [lo[:, ts[0]], field.sub(hi[:, ts[0]], lo[:, ts[0]])]
        for t in ts[1:]:
            a = lo[:, t]
            b = field.sub(hi[:, t], a)
            c = ([field.mul(c[0], a)] + [field.add(field.mul(c[k], a), field.mul(c[k - 1], b)) for k in range(1, len(c))]
                 + [field.mul(c[-1], b)])
        sums = field.mul(mults[:, p : p + 1], field.lane_sum(torch.stack(c, dim=1)))  # (nl, length + 1)
        total = field.add(total, torch.nn.functional.pad(sums, (0, degree - length)))
    return total


@functools.lru_cache(maxsize=None)
def _interpolation_ints(modulus: int, degree: int) -> tuple:
    """The inverse Vandermonde matrix of the points 0..degree mod m, row j
    the coefficients of X^j: entry (j, k) of Lagrange basis polynomial k."""
    n = degree + 1
    rows = [[0] * n for _ in range(n)]
    for k in range(n):
        poly, denom = [1], 1
        for i in range(n):
            if i != k:
                poly = [(a - i * b) % modulus for a, b in zip([0] + poly, poly + [0])]  # times (X - i)
                denom = denom * (k - i) % modulus
        scale = pow(denom, -1, modulus)
        for j in range(n):
            rows[j][k] = poly[j] * scale % modulus
    return tuple(v for row in rows for v in row)


_INTERPOLATION: dict = {}


def interpolation(field: MontField, degree: int, device) -> torch.Tensor:
    """(nlimbs, (degree + 1)^2) Montgomery constants: the inverse Vandermonde
    matrix of the points 0..degree, row-major (csrc/sumcheck.cuh:
    interp_term), made once a field, degree and device."""
    key = (field.name, degree, str(device))
    if key not in _INTERPOLATION:
        _INTERPOLATION[key] = field.from_ints(_interpolation_ints(field.modulus, degree), device)
    return _INTERPOLATION[key]


# one word a (device, stream): mont_sum_round's ticket, 0 between launches
# (each launch's last block resets it); launches on one stream run in order,
# so no two launches share a ticket at once
_TICKETS: dict = {}


def _ticket(device, stream: int) -> torch.Tensor:
    key = (str(device), stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def mont_sum_round(field: MontField, mles: torch.Tensor, mults: torch.Tensor, lengths: torch.Tensor,
                   terms: torch.Tensor, degree: int) -> torch.Tensor:
    """One sumcheck round polynomial of an (nlimbs, m, 2 mid) MLE table:
    (nlimbs, degree + 1) Montgomery coefficients of
    sum_i sum_p mults[p] prod_{t in product p} (lo_t[i] + (hi_t[i] - lo_t[i]) X).
    Product p has lengths[p] (1..degree) MLE indices, in order in
    ``terms``; ``mults`` is (nlimbs, P), ``lengths`` (P,) and ``terms``
    int32, all on the table's device. Products of the same MLEs are summed
    each (``proof/sumcheck.py:product_arrays`` merges them first).

    Kernel csrc/mont_sum_round.cu, one launch: each product's values at
    0..L summed over the lanes in evaluation form; the last block applies
    the multipliers and interpolates. Launches on one stream share a ticket
    word and run in order.
    Bound: bytes or integer multiplies, by the product table (chip_smoke.py
    ``sum_round_muls``)."""
    mid = _check_table(field, mles)
    if not _on_card(mles):
        return mont_sum_round_plain(field, mles, mults, lengths, terms, degree)
    _check_products(field, mults, lengths, terms, degree)
    num_products = lengths.shape[0]
    if num_products < 1:
        raise ValueError("mont_sum_round takes at least one product")
    fid = _field_id(field)
    dev = mles.device
    for t in (mults, lengths, terms):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
    if mles.stride(2) != 1:
        mles = mles.contiguous()
    mults, lengths, terms = mults.contiguous(), lengths.contiguous(), terms.contiguous()
    interp = interpolation(field, degree, dev)
    words = field.nlimbs // 2
    # the partials, then the column sums
    partials = torch.empty((num_products * (degree + 1), SUM_MAX_BLOCKS + 1, words), dtype=torch.int32, device=dev)
    out = torch.empty((field.nlimbs, degree + 1), dtype=torch.int32, device=dev)
    stream = _stream(dev)
    _launch(
        "mont_sum_round", build.library().btt_mont_sum_round,
        fid, degree, mles.data_ptr(), mles.stride(0), mles.stride(1), mid, mults.data_ptr(), num_products,
        lengths.data_ptr(), terms.data_ptr(), interp.data_ptr(), SUM_MAX_BLOCKS, partials.data_ptr(),
        _ticket(dev, stream).data_ptr(), out.data_ptr(), stream,
    )
    return out
