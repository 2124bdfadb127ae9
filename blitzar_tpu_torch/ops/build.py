"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` holds one kernel and a plain C launcher; ``nvcc``
compiles every source at once (one process each, all started together)
for ``sm_90a`` and links the objects into one shared library, which is
loaded with ``ctypes``. No PyTorch header is compiled, so a build takes
seconds. The library goes to ``build/blitzar_tpu_torch/<digest>/`` at the
root of the checkout, keyed on a digest of the sources and flags: the first
kernel call of a process builds it if it is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "blitzar_tpu_torch"
LIB_NAME = "libblitzar_tpu_torch.so"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# C signatures of the launchers (csrc/*.cu); every one returns cudaGetLastError()
SIGNATURES = {
    "btt_build_niels_table": [_P, _P, _P, _P, _I64, _I, _I64, _P, _P],
    "btt_build_cached_table": [_P, _P, _P, _P, _I64, _I, _I64, _P, _P],
    "btt_ed_lookup_msm": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _I64, _I64, _P, _P, _P, _P, _P],
    "btt_doubling_combine": [_P, _P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P, _P],
    "btt_ed_add": [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _I64, _I, _I64, _P, _P, _P, _P, _P],
    "btt_ed_double": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P],
    "btt_niels_add": [_P, _P, _P, _I64, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P],
    "btt_fewrow_niels": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _I64, _P, _P, _P, _P, _P],
    "btt_elligator_form": [_P, _I64, _P, _I64, _I64, _P, _P, _P, _P, _P],
    "btt_fmul": [_P, _I64, _P, _I64, _I64, _I64, _P, _P],
    "btt_fsq": [_P, _I64, _I64, _P, _P],
    "btt_finvert": [_P, _I64, _I64, _P, _P],
    "btt_ed_to_niels": [_P, _P, _P, _I64, _I64, _P, _P],
    "btt_ed_file_rows": [_P, _I64, _P, _P],
    "btt_ed_file_entries": [_P, _I64, _P, _P],
    "btt_ed_niels_points": [_P, _I64, _P, _P, _P, _P, _I64, _P],
    "btt_ed_affine": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _I64, _P],
    "btt_ed_from_affine_rows": [_P, _I64, _P, _P, _P, _P, _I64, _P],
    "btt_ed_horner": [_P, _P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P, _P],
    "btt_ed_window_sums": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P],
    "btt_ristretto_encode": [_P, _P, _P, _P, _I64, _I64, _P, _P],
    "btt_ristretto_decode": [_P, _I64, _P, _P, _P, _P, _P, _P],
    # the Weierstrass kernels take the curve's C ABI id first
    "btt_w_build_table": [_I, _P, _P, _P, _I64, _I, _I64, _P, _P],
    "btt_w_lookup_msm": [_I, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I64, _I64, _P, _P, _P, _P],
    # the tree reduce takes the curve's C ABI id first (0 ristretto255)
    "btt_tree_reduce_lanes": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _I64, _P],
    "btt_tree_reduce_scratch": [_I, _I64, _I64, ctypes.POINTER(_I64)],
    "btt_wadd": [_I, _P, _P, _P, _I64, _P, _P, _P, _I64, _I, _I64, _P, _P, _P, _P],
    "btt_wdouble": [_I, _P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "btt_w_doubling_combine": [_I, _P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P],
    "btt_w_affine": [_I, _P, _I64, _P, _P],
    "btt_w_horner": [_I, _P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P],
    "btt_w_window_sums": [_I, _P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    # the proof kernels take the field's C ABI id first
    "btt_mont_mul_ew": [_I, _P, _I64, _P, _I64, _I64, _I64, _P, _P],
    "btt_mont_fold_round": [_I, _P, _I64, _I64, _I64, _I64, _P, _I64, _P, _P],
    "btt_mont_from_rows": [_I, _P, _I64, _I64, _I, _I64, _P, _P, _P],
    "btt_mont_sum_round": [_I, _I, _P, _I64, _I64, _I64, _P, _I, _P, _P, _P, _I64, _P, _P, _P, _P],
}

_LIB: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the kernels if this digest has no library yet; return its path.
    The compiler's per-kernel register report is kept in ``ptxas.log``."""
    out_dir = BUILD_ROOT / digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        objs.append(str(obj))
        if proc.returncode:
            failed.append(src.name)
    (tmp / "ptxas.log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(logs))
    link = subprocess.run(
        [compiler, "-shared", *objs, "-o", str(tmp / LIB_NAME)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp / "ptxas.log", out_dir / "ptxas.log")
    os.replace(tmp / LIB_NAME, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
