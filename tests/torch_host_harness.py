"""Builds csrc/host_harness.cpp with g++ (the kernels' arithmetic compiled
for the host) into build/blitzar_tpu_torch/host-<digest>/ and loads it;
shared by the CPU tests of that arithmetic."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import pytest

from blitzar_tpu_torch.ops import build


def load() -> ctypes.CDLL:
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this host")
    src = build.CSRC / "host_harness.cpp"
    h = hashlib.sha256()
    for path in [src] + sorted(build.CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    out_dir = build.BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / "libhost_harness.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"tmp-{os.getpid()}.so"
        subprocess.run(
            [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(build.CSRC), str(src), "-o", str(tmp)],
            check=True,
        )
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
