"""blitzar_tpu_torch: the PyTorch/CUDA port of blitzar_tpu.

Pedersen commitments over ristretto255 on an NVIDIA H100: the entry points
of ``api`` run on the card, where the hot work goes through five CUDA
kernels written for sm_90a (``csrc/``, bound in ``ops/cuda_point.py``);
``api.init(backend="cpu")`` runs the same path on the CPU through each
kernel's plain PyTorch version. The package imports torch and numpy, never
jax or blitzar_tpu, which stays the reference it is tested against.
"""

from . import api

__all__ = ["api"]
