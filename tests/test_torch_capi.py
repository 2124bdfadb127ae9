"""The port's C ABI (``blitzar_tpu_torch/cbindings``) on the CPU.

The library is built with g++ into a temporary directory and driven in
subprocesses, since the shim aborts on misuse and ``sxt_init`` is one-shot:
``tests/torch_capi_driver.py`` runs all 18 entries with the CPU backend
against blitzar_tpu's pure-Python oracle and the frozen proof vectors (one
case here per section of its output), the reference's pure-C
``cbindings/abi_test.c`` and the port's ``abi_consumer.c`` run against the
library with no PYTHONPATH, and each of the reference's init refusals (an
unknown backend, a second init, the GPU backend with no card) is checked
through the ABI beside the Python API's raise. Nothing here compiles an
XLA program.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from torch_capi_driver import SECTIONS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "cbindings", "blitzar_tpu_api.h")
DRIVER = os.path.join(REPO, "tests", "torch_capi_driver.py")
CONSUMER = os.path.join(REPO, "blitzar_tpu_torch", "cbindings", "abi_consumer.c")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None or shutil.which("gcc") is None, reason="needs g++ and gcc")


def _env(**extra) -> dict:
    """The environment of a consumer: no PYTHONPATH (the library finds the
    port and torch by itself), one torch thread."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def lib():
    from blitzar_tpu_torch.cbindings import build

    return build.build()


def _compile_c(source: str, lib, out) -> str:
    subprocess.run(["gcc", "-x", "c", "-std=c11", source, "-I", os.path.join(REPO, "cbindings"),
                    "-L", str(lib.parent), "-lblitzar_tpu", f"-Wl,-rpath,{lib.parent}", "-o", str(out)],
                   check=True, capture_output=True)
    return str(out)


def test_library_exports_exactly_the_header_functions(lib):
    with open(HEADER) as f:
        text = re.sub(r"/\*.*?\*/", " ", f.read(), flags=re.S)
    declared = set(re.findall(r"\b(sxt_\w+)\s*\(", text))
    out = subprocess.run(["nm", "-D", "--defined-only", str(lib)], check=True, capture_output=True, text=True)
    exported = {line.split()[-1] for line in out.stdout.splitlines() if line.split() and
                line.split()[-1].startswith("sxt_")}
    assert len(declared) == 18 and exported == declared


def test_shim_imports_only_the_ports_bridge():
    """capi.cc imports blitzar_tpu_torch.capi_bridge and nothing else (no
    blitzar_tpu, no jax)."""
    with open(os.path.join(REPO, "blitzar_tpu_torch", "cbindings", "capi.cc")) as f:
        text = f.read()
    assert re.findall(r'PyImport_\w+\("([^"]+)"', text) == ["blitzar_tpu_torch.capi_bridge"]


@pytest.fixture(scope="module")
def driver(lib, tmp_path_factory):
    work = tmp_path_factory.mktemp("capi_work")
    return subprocess.run([sys.executable, DRIVER, str(lib), str(work)], capture_output=True, text=True,
                          env=_env(), cwd=str(work), timeout=600)


@pytest.mark.parametrize("section", SECTIONS)
def test_entry_matches_blitzar_tpu(driver, section):
    """One section of the driver's run: its entries' bytes equal
    blitzar_tpu's oracle or the frozen vectors."""
    assert re.search(rf"^PASS {section} \(", driver.stdout, re.M), (
        f"stdout:\n{driver.stdout}\nstderr:\n{driver.stderr[-3000:]}")


def test_driver_ends_cleanly(driver):
    assert driver.returncode == 0 and driver.stdout.rstrip().endswith("CAPI_OK"), driver.stderr[-3000:]


def test_reference_abi_test_passes_against_the_port(lib, tmp_path):
    """cbindings/abi_test.c, unchanged: the upstream end-to-end commitments
    from a pure-C process with the CPU backend."""
    exe = _compile_c(os.path.join(REPO, "cbindings", "abi_test.c"), lib, tmp_path / "abi_test")
    proc = subprocess.run([exe], capture_output=True, text=True, env=_env(), cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0 and "ABI_OK" in proc.stdout, proc.stderr[-3000:]


def test_abi_consumer_commits_counter_scalars(lib, tmp_path):
    """The port's pure-C consumer with the CPU backend at 2^4: the upstream
    commitments hold and the counter-scalar column's commitment equals the
    oracle's."""
    from blitzar_tpu.refimpl import core as R

    exe = _compile_c(CONSUMER, lib, tmp_path / "abi_consumer")
    proc = subprocess.run([exe, "1", "4"], capture_output=True, text=True, env=_env(), cwd=str(tmp_path),
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    k1, k2, mask = 0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, (1 << 64) - 1
    scalars = [(i * k1 & mask) | ((i * k2 + 1) & mask) << 64 for i in range(16)]
    assert line["rust_ok"] and line["log2_n"] == 4
    assert line["hex"] == R.ristretto_encode(R.naive_msm(scalars, R.get_generators(16))).hex()
    assert len(line["warm_ms"]) == 3 and line["cold_ms"] > 0


# Each refusal: the Python API raises, the ABI's sxt_init returns 1, and
# the library stays as it was (uninitialised, or initialised once).
INIT_CASE = r"""
import ctypes, os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
from blitzar_tpu_torch import api
import torch_capi_structs as abi

lib = abi.load({lib!r})
init = lambda backend: abi.init(lib, backend)

def raises(backend, error):
    try:
        api.init(backend)
    except error:
        return True
    return False

case = {case!r}
if case == "unknown backend":
    assert raises("tpu", ValueError) and init(0) == 1 and init(3) == 1 and init(-1) == 1
    assert init(1) == 0, "an unknown backend leaves the library uninitialised"
elif case == "second init":
    assert init(1) == 0
    assert raises("cpu", RuntimeError) and raises("gpu", RuntimeError)
    assert init(1) == 1 and init(2) == 1 and init(7) == 1
elif case == "gpu without a card":
    assert raises("gpu", RuntimeError) and init(2) == 1
    print("REFUSED", flush=True)
    # no CPU fallback: a commitment now starts the card's backend, which
    # raises, and the shim aborts
    out = (ctypes.c_uint8 * 32)()
    lib.sxt_curve25519_compute_pedersen_commitments(out, 0, None, ctypes.c_uint64(0))
    print("NOT REACHED", flush=True)
print("CASE_OK", flush=True)
"""


@pytest.mark.parametrize("case", ["unknown backend", "second init", "gpu without a card"])
def test_init_refusals_agree_with_the_api(lib, tmp_path, case):
    code = INIT_CASE.format(repo=REPO, lib=str(lib), case=case)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path),
                          env=_env(CUDA_VISIBLE_DEVICES=""), timeout=300)
    if case == "gpu without a card":
        assert proc.returncode != 0 and "REFUSED" in proc.stdout and "NOT REACHED" not in proc.stdout
        assert "blitzar_tpu panic" in proc.stderr, proc.stderr[-3000:]
    else:
        assert proc.returncode == 0 and "CASE_OK" in proc.stdout, proc.stderr[-3000:]
