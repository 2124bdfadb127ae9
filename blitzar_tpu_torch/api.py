"""Public API of the port, ristretto255 surface (blitzar_tpu/api.py).

Entry points follow the reference C ABI (cbindings/blitzar_api.h): ``init``
is one-shot, generators default to the canonical precomputed set, results
are numpy arrays of canonical encodings. The work runs on the card: on
``cuda`` unless ``init(backend="cpu")`` asked for the CPU, where every
kernel runs its plain PyTorch version. Without a CUDA device and without an
explicit ``"cpu"`` the entry points raise; they never fall back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import generators as _gen
from .curves import edwards25519 as ed
from .curves import ristretto as rst
from .msm import engine as _engine
from .msm import fixed as _fixed

BACKENDS = {"auto": "cuda", "gpu": "cuda", "cpu": "cpu"}


@dataclasses.dataclass
class SequenceDescriptor:
    """Mirror of sxt_sequence_descriptor (reference blitzar_api.h:115-136)."""

    element_nbytes: int
    n: int
    data: np.ndarray  # (n * element_nbytes,) or (n, element_nbytes) uint8 LE
    is_signed: bool = False

    def rows(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.uint8).reshape(self.n, self.element_nbytes)


class _Backend:
    def __init__(self):
        self.initialized = False
        self.device = torch.device("cuda")

    def reset(self):
        self.initialized = False
        self.device = torch.device("cuda")
        _gen.CACHE.reset()
        _engine.clear_handle_cache()


_BACKEND = _Backend()


def init(backend: str = "auto", num_precomputed_generators: int = 0) -> None:
    """One-shot library init (reference sxt_init). backend: "auto" | "gpu" |
    "cpu"; "auto" means "gpu". Raises on a second call, and for "gpu"
    when no CUDA device is present."""
    if _BACKEND.initialized:
        raise RuntimeError("init may only be called once (reference backend.cc:116)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {sorted(BACKENDS)}")
    device = torch.device(BACKENDS[backend])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {backend!r} needs a CUDA device and none is available; "
            "pass backend='cpu' to run on the CPU"
        )
    _BACKEND.device = device
    _BACKEND.initialized = True
    if num_precomputed_generators:
        _gen.get_precomputed_generators(int(num_precomputed_generators), 0, device)


def reset_backend_for_testing() -> None:
    """Reference cbindings/backend.cc:106-108 test hook."""
    _BACKEND.reset()


def device() -> torch.device:
    """The device the entry points run on (initialising with "auto")."""
    if not _BACKEND.initialized:
        init()
    return _BACKEND.device


# ---------------------------------------------------------------------------
# generators, one commitments, (de)compression
# ---------------------------------------------------------------------------


def get_ristretto255_generators(n: int, offset: int = 0) -> ed.PointP3:
    """Reference sxt_ristretto255_get_generators (blitzar_api.h:440)."""
    return _gen.get_precomputed_generators(n, offset, device())


def get_curve25519_one_commit(n: int) -> ed.PointP3:
    """Reference sxt_curve25519_get_one_commit (blitzar_api.h:477)."""
    return _gen.one_commitment(n, device())


def compress_ristretto255(points: ed.PointP3) -> np.ndarray:
    """(n,) point batch -> (n, 32) uint8 canonical encodings."""
    return rst.encode(points).cpu().numpy().T.copy()


def decompress_ristretto255(data: np.ndarray):
    """(n, 32) uint8 -> (PointP3 on the backend's device, valid bool array)."""
    raw = torch.from_numpy(np.ascontiguousarray(np.asarray(data, np.uint8).T)).to(device())
    pts, valid = rst.decode(raw)
    return pts, valid.cpu().numpy()


# ---------------------------------------------------------------------------
# Pedersen commitments
# ---------------------------------------------------------------------------


def _validate_descriptors(descriptors) -> None:
    """Reference release asserts (cbindings/pedersen.cc:44-69) and the signed
    width contract (multiexp/base/exponent_sequence.h:40)."""
    for d in descriptors:
        if not 1 <= int(d.element_nbytes) <= 32:
            raise ValueError(f"element_nbytes must be in [1, 32], got {d.element_nbytes}")
        if d.is_signed and int(d.element_nbytes) > 16:
            raise ValueError(f"signed sequences require element_nbytes <= 16 (got {d.element_nbytes})")
        if int(d.n) > 0 and d.data is None:
            raise ValueError("nonempty sequence with null data")


def compute_curve25519_commitments(
    descriptors, generators: ed.PointP3 | None = None, generators_offset: int = 0
) -> np.ndarray:
    """Pedersen commitments over ristretto255 -> (num_sequences, 32) uint8.

    Mirrors sxt_curve25519_compute_pedersen_commitments[_with_generators]
    (reference blitzar_api.h:243-286). ``generators`` must lie on the
    backend's device."""
    dev = device()
    descriptors = list(descriptors)
    if not descriptors:
        return np.zeros((0, 32), dtype=np.uint8)
    _validate_descriptors(descriptors)
    n_max = max(int(d.n) for d in descriptors)
    if generators is None:
        generators = _gen.get_precomputed_generators(n_max, generators_offset, dev)
    result = _engine.msm(
        generators,
        [d.rows() for d in descriptors],
        [int(d.element_nbytes) for d in descriptors],
        [bool(d.is_signed) for d in descriptors],
    )
    return compress_ristretto255(result)


# ---------------------------------------------------------------------------
# fixed-generator handles (reference blitzar_api.h:631-685)
# ---------------------------------------------------------------------------


def multiexp_handle_new(generators: ed.PointP3, n: int | None = None) -> _fixed.MultiexpHandle:
    """Reference sxt_multiexp_handle_new (blitzar_api.h:631), ristretto255."""
    device()
    return _fixed.MultiexpHandle(generators, n=n)


def fixed_multiexponentiation(handle: _fixed.MultiexpHandle, scalars) -> ed.PointP3:
    """Reference sxt_fixed_multiexponentiation (blitzar_api.h:685): scalars
    (num_outputs, n, element_nbytes) uint8 -> (num_outputs,) points."""
    device()
    return _fixed.fixed_multiexponentiation(handle, scalars)
