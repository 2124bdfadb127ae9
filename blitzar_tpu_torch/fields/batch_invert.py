"""Montgomery's trick along the last axis of a batch of field elements, for
any field whose elementwise multiply and inversion are passed in
(blitzar_tpu/msm/fixed.py:184-194). ``fields/fp25519.py`` and
``fields/mont.py`` run it with their own ops, ``ops/cuda_field.py`` and
``msm/interop.py`` with kernels."""

from __future__ import annotations

import torch


def batch_invert_lanes(z: torch.Tensor, mul, invert) -> torch.Tensor:
    """1/z for a (nlimbs, *rows, V) batch: the prefix products of each row's
    V lanes, one ``invert`` of each row's total, and a backward pass that
    peels one lane off the total at a time, 3 (V - 1) ``mul`` a row, each
    over a limb-major (nlimbs, rows) slice. Every z must be nonzero: a zero
    lane zeroes its whole row."""
    lanes = z.shape[-1]
    # (nlimbs, V, rows): each lane a limb-major (nlimbs, rows) slice
    zt = z.reshape(z.shape[0], -1, lanes).movedim(-1, 1).contiguous()
    prefix = [zt[:, 0]]
    for j in range(1, lanes):
        prefix.append(mul(prefix[-1], zt[:, j]))
    inv = invert(prefix[-1])
    out = torch.empty_like(zt)
    for j in range(lanes - 1, 0, -1):
        out[:, j] = mul(inv, prefix[j - 1])
        inv = mul(inv, zt[:, j])
    out[:, 0] = inv
    return out.movedim(1, -1).reshape(z.shape)
