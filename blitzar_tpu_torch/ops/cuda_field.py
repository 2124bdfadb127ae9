"""The CUDA kernels of GF(2^255 - 19) arithmetic on whole batches: wrappers,
plain versions, counts.

They carry the generator disk cache (``generators.py``) and a ristretto255
handle's npz write (niels entries back to points, ``msm/fixed.py``), where a
plain PyTorch multiply over a 2^20-point table's 2^25 entries would need
tens of GiB for its int64 partial products; the table conversions of the
other file paths are one launch a chunk each (``ops/cuda_point.py``:
``ed_to_niels``, ``ed_file_rows``, ``ed_file_entries``). Each wrapper takes (16, *batch) int32 limbs (the public
layout, limbs below 2^17, ``fields/fp25519.py``). On a tensor that lies on
the CPU it runs the plain version beside it; on a CUDA tensor it checks
device, dtype and shape, allocates the output, launches its kernel from
``csrc/`` on the current stream and adds one to ``cuda_point.LAUNCHES[name]``,
or raises. Kernel outputs hold canonical 16-bit limbs.

The kernels and the TPU kernels they replace (all in
``blitzar_tpu/ops/pallas_point.py``):

=============  ===============================  ==========
wrapper        replaces                         source
=============  ===============================  ==========
``fmul``       ``_fmul_tiled`` :130 / :157      fmul.cu
``fsq``        ``_fsq_tiled`` :144 / :162       fmul.cu
``finvert``    ``_finvert_tiled`` :172 / :185   finvert.cu
=============  ===============================  ==========
"""

from __future__ import annotations

import torch

from ..fields import fp25519 as F
from . import build
from .cuda_point import _field_arg, _launch, _on_card, _stream


# ---------------------------------------------------------------------------
# fmul  (replaces pallas_point.py:_fmul_tiled :130 / fmul :157)
# ---------------------------------------------------------------------------


def fmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.mul(a, b)


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a * b of a (16, *batch) ``a`` and a ``b`` of the same
    shape or of one element ((16, 1, ...), broadcast over ``a``).

    Kernel csrc/fmul.cu, one thread per element. Bound: bytes (96 an
    element against 144 int32 multiplies)."""
    batch = tuple(a.shape[1:])
    broadcast = b.dim() >= 1 and b.shape[0] == F.NLIMBS and b[0].numel() == 1 and tuple(b.shape[1:]) != batch
    if a.dim() < 2 or a.shape[0] != F.NLIMBS or not (broadcast or tuple(b.shape) == tuple(a.shape)):
        raise ValueError(f"fmul: shapes {tuple(a.shape)} x {tuple(b.shape)}: expected (16, *batch) x (16, *batch | 1)")
    if broadcast:
        b = b.reshape((F.NLIMBS,) + (1,) * len(batch))
    if not _on_card(a):
        return fmul_plain(a, b)
    a, a_stride = _field_arg(a, a.device, batch)
    if broadcast:
        b, b_stride = _field_arg(b.reshape(F.NLIMBS, 1), a.device, (1,))
    else:
        b, b_stride = _field_arg(b, a.device, batch)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    count = a[0].numel()
    if count:
        _launch(
            "fmul", build.library().btt_fmul,
            a.data_ptr(), a_stride, b.data_ptr(), b_stride, 0 if broadcast else 1, count, out.data_ptr(),
            _stream(a.device),
        )
    return out


# ---------------------------------------------------------------------------
# fsq  (replaces pallas_point.py:_fsq_tiled :144 / fsq :162)
# ---------------------------------------------------------------------------


def fsq_plain(a: torch.Tensor) -> torch.Tensor:
    return F.sq(a)


def fsq(a: torch.Tensor) -> torch.Tensor:
    """Elementwise a^2 of a (16, *batch) batch.

    Kernel csrc/fmul.cu (its second launcher), one thread per element.
    Bound: bytes (64 an element against 144 int32 multiplies)."""
    if a.dim() < 2 or a.shape[0] != F.NLIMBS:
        raise ValueError(f"fsq: shape {tuple(a.shape)}: expected (16, *batch)")
    if not _on_card(a):
        return fsq_plain(a)
    a, a_stride = _field_arg(a, a.device, tuple(a.shape[1:]))
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    count = a[0].numel()
    if count:
        _launch("fsq", build.library().btt_fsq, a.data_ptr(), a_stride, count, out.data_ptr(), _stream(a.device))
    return out


# ---------------------------------------------------------------------------
# finvert  (replaces pallas_point.py:_finvert_tiled :172 / finvert :185)
# ---------------------------------------------------------------------------


def finvert_plain(a: torch.Tensor) -> torch.Tensor:
    return F.invert(a)


def finvert(a: torch.Tensor) -> torch.Tensor:
    """Elementwise a^(p - 2) of a (16, *batch) batch; 0 maps to 0.

    Kernel csrc/finvert.cu, one thread per element, the 265-multiply chain in
    registers. Bound: operations; the least work that inverts a batch is a
    batch inversion (three multiplies an element), which ``ed_to_niels``
    (``ops/cuda_point.py``) runs for a table's z."""
    if a.dim() < 2 or a.shape[0] != F.NLIMBS:
        raise ValueError(f"finvert: shape {tuple(a.shape)}: expected (16, *batch)")
    if not _on_card(a):
        return finvert_plain(a)
    a, a_stride = _field_arg(a, a.device, tuple(a.shape[1:]))
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    count = a[0].numel()
    if count:
        _launch("finvert", build.library().btt_finvert, a.data_ptr(), a_stride, count, out.data_ptr(),
                _stream(a.device))
    return out

