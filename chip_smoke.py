#!/usr/bin/env python3
"""Build blitzar_tpu_torch's kernels and drive its commitment path on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each fatal on failure:

1. build the five CUDA kernels from ``blitzar_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the card's name and power limit;
2. run each kernel at the shapes the 2^20 commitment gives it and hold it
   against its plain PyTorch version on the same inputs (canonical values
   must be equal), timing both; where the plain version is too large to run
   whole, on a sample spread over the whole output, its last element included;
3. the upstream end-to-end vectors through ``api.compute_curve25519_commitments``
   on the card, and a signed multi-output case against the plain CPU run;
4. full width: canonical generators with counter scalars at 2^16 and 2^20
   (compressed result = the pinned digest) and ten 32-byte outputs at
   n = 100000 (blake2b digest pinned), with the generator derivation, the
   handle build and the median of five queries timed at 2^20;
5. every kernel must have launched during phases 3-4.

The second-to-last line is ``{"kernels": [...]}`` (per kernel: launches in
phases 3-4, time, plain time, bound, error), the line before it the card as
``nvidia-smi`` names it, the last ``{"ok": true, "device": {...}}``. Details
also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory 3.35 TB/s;
# float32 67 TFLOP/s = 33.5 T FMA/s. Assumption: 32-bit integer multiplies
# (IMAD) issue at half the FMA rate on sm_90, 64 per SM per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 67e12 / 2 / 2
# int32 multiply instructions per field multiply in csrc/fp25519.cuh: 64
# word products of 32 x 32 -> 64 bits (lo and hi: 2 each) + 8 folds by 38.
IMAD_PER_FIELD_MUL = 2 * (64 + 8)
# field multiplies per operation of csrc/edwards25519.cuh (squares count as
# multiplies; multiplies by 2 are not counted)
MULS_ADD = 9
MULS_MADD = 7
MULS_DOUBLE = 8
MULS_INVERT = 265
MULS_ELLIGATOR = 288
MULS_ELLIGATOR_FORM = 2 * MULS_ELLIGATOR + MULS_ADD
# the least a niels table needs, per group of w points and V = 2^w entries:
# V - 1 - w unified adds (the doubling concatenation; one-point entries are
# copies), one batched inversion of the V - 1 nonzero Z (Montgomery's trick:
# 3 multiplies per element and one inversion), and per entry x = X/Z, y =
# Y/Z, x*y and 2d*x*y (4 multiplies)
MULS_BATCH_INVERT_PER_ELEMENT = 3
MULS_NIELS_FROM_ZINV = 4


def muls_niels_table_group(w: int) -> int:
    entries = (1 << w) - 1
    return ((entries - w) * MULS_ADD + entries * MULS_BATCH_INVERT_PER_ELEMENT + MULS_INVERT
            + entries * MULS_NIELS_FROM_ZINV)

# Upstream end-to-end commitment vectors (copied from tests/vectors.py:
# reference rust/tests/src/main.rs:26-48).
RUST_DATA = [
    [2000, 7500, 5000, 1500],
    [5000, 0, 400000, 10],
    [2000 + 5000, 7500 + 0, 5000 + 400000, 1500 + 10],
]
RUST_EXPECTED = [
    "04693a833b45966a788920e1aff45273d8b4ce9615faf062fbc092f436a9c761",
    "02feb2c3c6ee2c9c181d58c4253f9d32ec9f3d3199b54f7e37bc4301e4f84833",
    "1eeda3eafc6f2d85ebe31575e5bc5895f06dcd5a0682c79805dd39e7a8098d7a",
]

# Pinned digests produced by the reference's own CPU backend (copied from
# benchmarks/pinned_digests.py; provenance in benchmarks/pinned.py:1-16).
PINNED_RISTRETTO_MSM = {
    16: "52b35ab759789e0c1d408b587fde2312f5b4eaea78f563b92a886bc232f3e516",
    20: "f89560f09c6bc178be50fdeae2968eb9b46578cdc32ca4f806d8219c4ecf0a56",
}
PINNED_PEDERSEN_100000_10_32 = "b2:7d8c3fa03557ce6b28cf72d7bbc354bb"

K1 = 0x9E3779B97F4A7C15
K2 = 0xC2B2AE3D27D4EB4F


def counter_scalars(n: int, nbytes: int = 32, output: int = 0) -> np.ndarray:
    """Row i = LE64((i+output)*K1) || LE64((i+output)*K2 + 1) || zeros (the
    counter-scalar rule of benchmarks/pinned.py:22-40)."""
    i = np.arange(n, dtype=np.uint64) + np.uint64(output)
    with np.errstate(over="ignore"):
        v1 = i * np.uint64(K1)
        v2 = i * np.uint64(K2) + np.uint64(1)
    rows = np.zeros((n, nbytes), np.uint8)
    rows[:, : min(8, nbytes)] = v1.astype("<u8").view(np.uint8).reshape(n, 8)[:, : min(8, nbytes)]
    if nbytes >= 16:
        rows[:, 8:16] = v2.astype("<u8").view(np.uint8).reshape(n, 8)
    return rows


def digest(encodings: np.ndarray) -> str:
    """One output: its hex encoding; several: blake2b-128 over all of them
    (benchmarks/pinned.py:79-89)."""
    if encodings.shape[0] == 1:
        return bytes(encodings[0]).hex()
    return "b2:" + hashlib.blake2b(encodings.tobytes(), digest_size=16).hexdigest()


class Failure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise Failure(what)
    print(f"ok  {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of fn over reps runs after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, imads: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = imads / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev) -> dict:
    """Each kernel at the shapes of one 2^20 commitment with 32-byte counter
    scalars, against its plain version."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.utils.limbs import to_tensor

    n = 1 << 20
    w = 8
    groups = n // w
    results = {}

    def point_err(a, b) -> int:
        return max(int((F.canonicalize(x).long() - F.canonicalize(y).long()).abs().max()) for x, y in zip(a, b))

    def record(name, replaces, source, ms, plain_ms, err, bytes_moved, imads, plain_fraction=1.0):
        b_ms, b_by = bound(bytes_moved, imads)
        results[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "plain_fraction": plain_fraction,
        }
        check(err == 0, f"{name}: kernel equals plain, tolerance 0 on canonical limbs (max abs err {err}; "
                        f"{ms:.3f} ms vs plain {plain_ms:.1f} ms)")

    def spread(count: int, total: int):
        """count indices evenly over range(total), the first and last included"""
        return torch.linspace(0, total - 1, count, device=dev).round().long()

    # elligator_form: all n generators; plain on 2^16 of them spread over all n
    # (its temporaries at 2^20 are ~2 GB per multiply)
    r0, r1 = generators._xorshift_limbs(np.arange(n, dtype=np.uint64))
    r0, r1 = to_tensor(r0, dev), to_tensor(r1, dev)
    ms = cuda_ms(torch, lambda: cp.elligator_form(r0, r1))
    gens = cp.elligator_form(r0, r1)
    m = min(n, 1 << 16)
    sample = spread(m, n)
    s0, s1 = r0[:, sample], r1[:, sample]
    plain_ms = cuda_ms(torch, lambda: cp.elligator_form_plain(s0, s1), reps=1)
    plain = cp.elligator_form_plain(s0, s1)
    err = point_err(ed.index_batch(gens, sample), plain)
    record("elligator_form", "blitzar_tpu/ops/pallas_point.py:212", "blitzar_tpu_torch/csrc/elligator_form.cu",
           ms, plain_ms, err, n * (2 * 64 + 4 * 64), n * MULS_ELLIGATOR_FORM * IMAD_PER_FIELD_MUL, m / n)

    # build_niels_table: all groups; plain on 512 groups spread over all of them
    ms = cuda_ms(torch, lambda: cp.build_niels_table(gens, w), reps=1)
    table = cp.build_niels_table(gens, w)
    g_plain = min(groups, 512)
    sel = spread(g_plain, groups)
    members = ed.index_batch(gens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    plain_ms = cuda_ms(torch, lambda: cp.build_niels_table_plain(members, w), reps=1)
    plain = cp.build_niels_table_plain(members, w)
    err = int((table[sel].long() - plain.long()).abs().max())
    record("build_niels_table", "blitzar_tpu/ops/pallas_point.py:806", "blitzar_tpu_torch/csrc/build_niels_table.cu",
           ms, plain_ms, err, n * 4 * 64 + table.numel() * 4,
           groups * muls_niels_table_group(w) * IMAD_PER_FIELD_MUL, g_plain / groups)

    # ed_lookup_msm: one 32-byte output, as the 2^20 pinned commitment
    scalars = torch.from_numpy(counter_scalars(n, 32)[None]).to(dev)
    ms = cuda_ms(torch, lambda: cp.ed_lookup_msm(table, scalars, None, w))
    partials = cp.ed_lookup_msm(table, scalars, None, w)
    plain_ms = cuda_ms(torch, lambda: cp.ed_lookup_msm_plain(table, scalars, None, w), reps=1)
    plain = cp.ed_lookup_msm_plain(table, scalars, None, w)
    err = point_err(partials, plain)
    # the data decide the work: madds for the nonzero indices, table bytes
    # for the distinct nonzero entries they touch (each read once)
    idx = cp.query_index(scalars, None, w).long()
    nonzero = int((idx != 0).sum())
    touched = torch.zeros((groups, 1 << w), dtype=torch.bool, device=dev)
    touched[torch.arange(groups, device=dev)[None, :].expand_as(idx), idx] = True
    entries = int(touched[:, 1:].sum())
    record("ed_lookup_msm", "blitzar_tpu/ops/pallas_point.py:533", "blitzar_tpu_torch/csrc/ed_lookup_msm.cu",
           ms, plain_ms, err, scalars.numel() + entries * 96 + partials.x.numel() * 16,
           nonzero * MULS_MADD * IMAD_PER_FIELD_MUL)
    results["ed_lookup_msm"]["nonzero_lookups"] = nonzero
    results["ed_lookup_msm"]["table_entries_touched"] = entries

    # ed_add: the first level of the tree reduce over the lookup's partials
    k = partials.x.shape[1]
    lo = ed.index_batch(partials, slice(0, k // 2))
    hi = ed.index_batch(partials, slice(k // 2, 2 * (k // 2)))
    ms = cuda_ms(torch, lambda: cp.ed_add(lo, hi))
    out = cp.ed_add(lo, hi)
    plain_ms = cuda_ms(torch, lambda: cp.ed_add_plain(lo, hi), reps=1)
    err = point_err(out, cp.ed_add_plain(lo, hi))
    count = lo.x[0].numel()
    record("ed_add", "blitzar_tpu/ops/pallas_point.py:237", "blitzar_tpu_torch/csrc/ed_add.cu",
           ms, plain_ms, err, count * 3 * 256, count * MULS_ADD * IMAD_PER_FIELD_MUL)

    # doubling_combine: the 256 bit-row products of the one output
    products = ed.reshape_batch(ed.tree_reduce(partials, k), (1, 256))
    ms = cuda_ms(torch, lambda: cp.doubling_combine(products))
    out = cp.doubling_combine(products)
    plain_ms = cuda_ms(torch, lambda: cp.doubling_combine_plain(products), reps=1)
    err = point_err(out, cp.doubling_combine_plain(products))
    record("doubling_combine", "blitzar_tpu/ops/pallas_point.py:982", "blitzar_tpu_torch/csrc/doubling_combine.cu",
           ms, plain_ms, err, 256 * 256 + 256, 255 * (MULS_DOUBLE + MULS_ADD) * IMAD_PER_FIELD_MUL)
    return results


def descriptors_from_ints(api, rows_list, nbytes, signed):
    out = []
    for vals in rows_list:
        data = np.zeros((len(vals), nbytes), np.uint8)
        for i, v in enumerate(vals):
            data[i] = np.frombuffer((int(v) % (1 << (8 * nbytes))).to_bytes(nbytes, "little"), np.uint8)
        out.append(api.SequenceDescriptor(nbytes, len(vals), data, signed))
    return out


def phase_api_small(torch) -> None:
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import ristretto as rst
    from blitzar_tpu_torch.msm import engine

    got = api.compute_curve25519_commitments(descriptors_from_ints(api, RUST_DATA, 4, False))
    check([bytes(g).hex() for g in got] == RUST_EXPECTED, "RUST_EXPECTED reproduced on cuda")

    rng = np.random.default_rng(20)
    n = 64
    rows = [[int(v) for v in rng.integers(-(1 << 62), 1 << 62, size=n)] for _ in range(3)]
    rows[1][:5] = [-(1 << 127), (1 << 127) - 1, -1, 0, 1]
    descs = descriptors_from_ints(api, rows, 16, True)
    got = api.compute_curve25519_commitments(descs)
    cpu_gens = generators.ristretto_generators(n, 0, "cpu")
    want = rst.encode(engine.msm(cpu_gens, [d.rows() for d in descs], [16] * 3, [True] * 3)).numpy().T
    check(np.array_equal(got, want), "signed 3-output 16-byte commitment on cuda equals the plain CPU run")


def timed(torch, fn):
    """(result, ms) of fn on the host clock, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def warm_stages(torch, desc) -> dict:
    """Host-clock times of the steps of a warm commitment, one by one."""
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import ristretto as rst
    from blitzar_tpu_torch.msm import engine, fixed

    gens = generators.get_precomputed_generators(desc.n, 0, api.device())
    (scalars, _, n), prepare_ms = timed(torch, lambda: engine.prepare_scalars([desc.rows()], [32], [False]))
    handle, cache_ms = timed(torch, lambda: engine.cached_handle(gens, n))
    result, query_ms = timed(torch, lambda: fixed.fixed_multiexponentiation(handle, scalars))
    _, encode_ms = timed(torch, lambda: rst.encode(result).cpu())
    return {"prepare_scalars": prepare_ms, "handle_cache_lookup": cache_ms, "query": query_ms, "encode": encode_ms}


def profile_commitment(torch, desc, expected: str) -> dict:
    """Device time by kernel (and copy) over one warm commitment, from
    torch.profiler, and the device's busy share of the host wall time. The
    commitment itself must succeed and equal ``expected``; only a profiler
    that fails to start, stop or report is reported instead of failing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blitzar_tpu_torch import api

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # the profiler is untried on this machine: report, do not fail
        return {"error": repr(e)}
    t0 = time.perf_counter()
    got = api.compute_curve25519_commitments([desc])
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    try:
        prof.stop()
        events, error = prof.events(), None
    except Exception as e:
        events, error = None, repr(e)
    check(digest(got) == expected, "profiled commitment equals the pinned digest")
    if events is None:
        return {"error": error}
    by_name: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        return {"error": "the profiler recorded no device activity"}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
            "device_ms_by_name": {k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}}


def phase_full_width(torch, timings: dict) -> dict:
    """The pinned full-width commitments; returns the kernel launches of the
    first (cold) 2^20 commitment."""
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.ops import cuda_point as cp

    per_commitment = {}
    for log_n in (16, 20):
        n = 1 << log_n
        desc = api.SequenceDescriptor(32, n, counter_scalars(n, 32))
        before = dict(cp.LAUNCHES)
        got, ms = timed(torch, lambda: api.compute_curve25519_commitments([desc]))
        check(digest(got) == PINNED_RISTRETTO_MSM[log_n], f"2^{log_n} commitment equals the pinned digest ({ms:.1f} ms)")
        timings[f"commit_2^{log_n}_cold_ms"] = ms
        if log_n == 20:
            per_commitment = {k: cp.LAUNCHES[k] - before[k] for k in cp.KERNELS}
            warm = [timed(torch, lambda: api.compute_curve25519_commitments([desc]))[1] for _ in range(3)]
            timings["commit_2^20_warm_ms_all"] = warm
            timings["commit_2^20_warm_ms_median"] = float(np.median(warm))
            timings["stages_commit_2^20_warm_ms"] = warm_stages(torch, desc)
            timings["profile_commit_2^20_warm"] = profile_commitment(torch, desc, PINNED_RISTRETTO_MSM[log_n])

    n, outputs = 100000, 10
    descs = [api.SequenceDescriptor(32, n, counter_scalars(n, 32, output=o)) for o in range(outputs)]
    got, ms = timed(torch, lambda: api.compute_curve25519_commitments(descs))
    check(digest(got) == PINNED_PEDERSEN_100000_10_32, f"n=100000 x 10 outputs equals the pinned digest ({ms:.1f} ms)")
    timings["commit_100000x10_cold_ms"] = ms

    # the stages of a 2^20 commitment, apart
    n = 1 << 20
    gens, timings["generators_2^20_ms"] = timed(torch, lambda: generators.ristretto_generators(n, 0, "cuda"))
    handle, timings["handle_build_2^20_ms"] = timed(torch, lambda: api.multiexp_handle_new(gens))
    scalars = counter_scalars(n, 32)[None]
    queries = []
    for _ in range(5):
        res, ms = timed(torch, lambda: api.fixed_multiexponentiation(handle, scalars))
        queries.append(ms)
    timings["query_2^20_ms_all"] = queries
    timings["query_2^20_ms_median"] = float(np.median(queries))
    check(digest(api.compress_ristretto255(res)) == PINNED_RISTRETTO_MSM[20], "timed 2^20 query equals the pinned digest")
    return per_commitment


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "blitzar_tpu_torch", "csrc")):
        print("FAIL: run chip_smoke.py from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.ops import build
    from blitzar_tpu_torch.ops import cuda_point as cp

    report: dict = {"timings": {}}
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        t0 = time.perf_counter()
        build.library()
        report["timings"]["build_s"] = time.perf_counter() - t0
        print(f"ok  kernels built in {report['timings']['build_s']:.1f} s from {build.CSRC}", flush=True)
        log = (build.BUILD_ROOT / build.digest() / "ptxas.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if line.startswith("==") or "registers" in line or "spill" in line:
                    print(f"    {line.strip()}")

        results = phase_kernels(torch, torch.device("cuda"))

        api.init("gpu")
        cp.reset_launches()
        phase_api_small(torch)
        per_commitment = phase_full_width(torch, report["timings"])
        launches = dict(cp.LAUNCHES)
        for name in cp.KERNELS:
            results[name]["launches"] = launches[name]
            results[name]["launches_per_2^20_commitment"] = per_commitment.get(name)
        check(all(launches[k] > 0 for k in cp.KERNELS), f"every kernel launched on the main path: {launches}")
        report["kernels"] = [results[k] for k in cp.KERNELS]
        report["card"] = card
        report["device"] = torch.cuda.get_device_name(0)
        print("timings: " + json.dumps(report["timings"]), flush=True)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": report["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
