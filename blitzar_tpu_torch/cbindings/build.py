"""Build the port's C ABI library, ``libblitzar_tpu.so``.

    python3 -m blitzar_tpu_torch.cbindings.build      # prints the library's path

g++ compiles ``capi.cc`` (host code: no nvcc) against the ABI's one header,
``cbindings/blitzar_tpu_api.h`` at the checkout's root, and links it to
this Python's ``libpython`` (include and link flags from ``sysconfig``, with
an rpath). The Python the library starts in a process without one and the
checkout's root it puts on ``sys.path`` are baked in with ``-D``. The
library goes to ``build/blitzar_tpu_torch/capi/<digest>/`` at the root of
the checkout, keyed on a digest of the sources and flags (the scheme of
``ops/build.py``); :func:`build` makes it if it is missing. Its name keeps
``rust/build.rs``'s ``-l blitzar_tpu``: ``BLITZAR_TPU_LIB_DIR=<that
directory>`` links the Rust crate to the port. The kernels still build and
load at their first call, through ``ops/build.py``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SOURCE = HERE / "capi.cc"
HEADER = ROOT / "cbindings" / "blitzar_tpu_api.h"
BUILD_ROOT = ROOT / "build" / "blitzar_tpu_torch" / "capi"
LIB_NAME = "libblitzar_tpu.so"
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared"]


def _cstring(value: str) -> str:
    return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'


def flags() -> list[str]:
    """The compile and link flags: this Python's headers and libpython,
    and the two values baked in."""
    libdir = sysconfig.get_config_var("LIBDIR")
    return [
        *CXX_FLAGS,
        f"-DBLITZAR_TPU_PYTHON={_cstring(sys.executable)}",
        f"-DBLITZAR_TPU_ROOT={_cstring(str(ROOT))}",
        "-I", str(HEADER.parent),
        "-I", sysconfig.get_config_var("INCLUDEPY"),
        "-L", libdir, f"-lpython{sysconfig.get_config_var('LDVERSION')}", f"-Wl,-rpath,{libdir}",
    ]


def digest() -> str:
    h = hashlib.sha256(" ".join(flags()).encode())
    for path in (SOURCE, HEADER):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library into the digest's directory under ``build/``
    unless it is there; return its path."""
    out = BUILD_ROOT / digest()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.tmp-{os.getpid()}"
    # the flags after the source: the linker takes libraries after objects
    proc = subprocess.run(["g++", str(SOURCE), "-o", str(tmp), *flags()],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {LIB_NAME} failed:\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build())
