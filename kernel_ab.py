#!/usr/bin/env python3
"""Time the kernels that the Edwards adds (csrc/edwards25519.cuh), the
partition lookup and the tree reduce reach, in one checkout of the
repository, at the shapes of its main paths, each checked against its plain
version; one run per checkout, in turns, compares two trees on one card:

    python3 kernel_ab.py --root build/ab/parent --out chiprun_out/ab/1_parent.json
    python3 kernel_ab.py --root .               --out chiprun_out/ab/2_change.json
    python3 kernel_ab.py --root .               --out chiprun_out/ab/3_change.json
    python3 kernel_ab.py --root build/ab/parent --out chiprun_out/ab/4_parent.json

``--root`` names the checkout whose ``blitzar_tpu_torch`` is imported (and
whose kernels are built into its own ``build/``); the shapes, inputs and
timing (``chip_smoke.device_ms``: median device time of one launch) are this
script's, so both trees run the same work. Cases:

- ``elligator_form`` (2^20 generators), ``build_niels_table`` (2^20, w = 8),
  ``ed_lookup_msm`` (one 32-byte counter column over that table, as the
  pinned 2^20 commitment), ``ed_add`` (512 pairs, the IPA query's shape),
  ``doubling_combine`` (one output's 256 bit-row products),
  ``niels_tree_reduce_lanes`` (the few-row query's first row block at
  2^20, one-byte column), ``build_cached_table`` and the cached
  ``ed_lookup_msm`` on a 2^18-point chunk (w = 8, random 32-byte scalars);
- ``tree_reduce_lanes`` at every (curve, size, cols) that chip_smoke.py's
  paths launched it at (its phase 19), on the same tiled points as there.

Each case's result is held against its plain version (canonical limbs, or
points for the tree reduces; on a spread sample where the plain version is
large); the JSON holds each case's ``ms`` and whether it matched. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (curve, size, cols) of tree_reduce_lanes launches on chip_smoke.py's paths
# (phase 19's tree_reduce_lanes_by_shape): ristretto255, then the three
# Weierstrass curves
TREE_SHAPES = (
    [("ristretto255", s, c) for s, c in [
        (1, 8), (1, 96), (1, 256), (1, 384), (1, 512), (1, 768), (2, 334375), (2, 696875), (3, 256),
        (3, 262146), (3, 917511), (4, 256), (4, 512), (4, 768), (5, 384), (8, 256), (8, 512), (64, 8), (64, 32),
        (64, 256), (128, 1), (128, 8), (128, 11), (128, 16), (128, 21), (255, 8), (255, 32), (255, 320), (256, 6),
        (256, 10), (263, 512), (264, 512), (349, 384), (368, 2550), (368, 5610), (512, 256), (520, 1275),
        (520, 3825), (521, 256), (527, 256), (528, 256), (1024, 2048), (1049, 128), (3125, 107), (3125, 223),
        (4504, 255), (43691, 6), (43691, 21)]]
    + [("bls12_381_g1", s, c) for s, c in [(1, 256), (1, 1536), (5, 256), (8, 512), (13, 1536), (1024, 256)]]
    + [("bn254_g1", s, c) for s, c in [
        (1, 1536), (8, 512), (13, 1536), (16, 256), (128, 1), (128, 8), (128, 11), (128, 16), (128, 21),
        (255, 32), (368, 765), (368, 7395), (512, 512), (1024, 128), (1024, 256), (1024, 1024), (1024, 1408),
        (1024, 2048), (1024, 2688), (2048, 128)]]
    + [("grumpkin", s, c) for s, c in [(1, 256), (1, 1536), (5, 256), (8, 512), (13, 1536), (1024, 256)]]
    # and a lookup's (1024, 256) partials, K before the lookup's chunk rule changed
    + [("ristretto255", 1024, 256)]
)
TREE_CHECK_COLS = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose blitzar_tpu_torch is timed")
    ap.add_argument("--out", required=True, help="JSON file to write")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import build
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    assert os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(cp.__file__)))) == root, cp.__file__
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    report = {"root": root, "card": cs.card_line(), "build_s": time.perf_counter() - t0, "cases": {}}
    cases = report["cases"]
    spread = functools.partial(cs.spread_indices, torch, dev)
    ed_err = functools.partial(cs.point_err, canonical=F.canonicalize)

    def case(name, fn, ok, reps=5, **extra):
        ms = cs.device_ms(torch, fn, reps=reps)
        cases[name] = {"ms": ms, "ok": bool(ok), **extra}
        print(f"{'ok ' if ok else 'BAD'} {name}: {ms:.4f} ms", flush=True)

    n, w = 1 << 20, 8
    groups = n // w
    r0, r1 = generators._xorshift_limbs(torch.arange(n, device=dev))
    gens = cp.elligator_form(r0, r1)
    sample = spread(4096, n)
    case("elligator_form", lambda: cp.elligator_form(r0, r1),
         ed_err(ed.index_batch(gens, sample), cp.elligator_form_plain(r0[:, sample], r1[:, sample])) == 0)

    table = cp.build_niels_table(gens, w)
    sel = spread(64, groups)
    members = ed.index_batch(gens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    case("build_niels_table", lambda: cp.build_niels_table(gens, w),
         torch.equal(table[sel], cp.build_niels_table_plain(members, w)), reps=3)

    scalars = torch.from_numpy(cs.counter_scalars(n, 32)[None]).to(dev)
    partials = cp.ed_lookup_msm(table, scalars, None, w)
    k = partials.x.shape[1]
    chunks = spread(4, k)
    case("ed_lookup_msm", lambda: cp.ed_lookup_msm(table, scalars, None, w),
         ed_err(ed.index_batch(partials, chunks), cp.ed_lookup_msm_plain(table, scalars, None, w, chunks)) == 0,
         chunks=k)

    lo = ed.reshape_batch(ed.index_batch(gens, slice(0, 512)), (512,))
    hi = ed.reshape_batch(ed.index_batch(gens, slice(512, 1024)), (512,))
    case("ed_add", lambda: cp.ed_add(lo, hi), ed_err(cp.ed_add(lo, hi), cp.ed_add_plain(lo, hi)) == 0, reps=50)

    products = ed.reshape_batch(ed.index_batch(gens, slice(0, 256)), (1, 256))
    case("doubling_combine", lambda: cp.doubling_combine(products),
         ed_err(cp.doubling_combine(products), cp.doubling_combine_plain(products)) == 0, reps=20)

    idx = cp.query_index(torch.from_numpy(cs.counter_scalars(n, 1)[None]).to(dev), None, w)
    entries = fixed.chunk_entries(table, idx[fixed.fewrow_blocks(table, 8)[0]], w)
    case("niels_tree_reduce_lanes", lambda: cp.niels_tree_reduce_lanes(entries),
         ed_err(cp.niels_tree_reduce_lanes(entries), cp.niels_tree_reduce_lanes_plain(entries)) == 0,
         shape=list(entries.shape[:2]))
    del table, partials, entries, idx

    chunk = cs.CHUNK
    cgroups = chunk // w
    cgens = ed.index_batch(gens, slice(0, chunk))
    ctable = cp.build_cached_table(cgens, w)
    sel = spread(64, cgroups)
    members = ed.index_batch(cgens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    case("build_cached_table", lambda: cp.build_cached_table(cgens, w),
         torch.equal(ctable[sel], cp.build_cached_table_plain(members, w)), reps=3)
    rng = np.random.default_rng(6)
    cscalars = torch.from_numpy(rng.integers(0, 256, size=(1, chunk, 32), dtype=np.uint8)).to(dev)
    cpartials = cp.ed_lookup_msm(ctable, cscalars, None, w)
    k = cpartials.x.shape[1]
    chunks = spread(4, k)
    case("ed_lookup_msm_cached", lambda: cp.ed_lookup_msm(ctable, cscalars, None, w),
         ed_err(ed.index_batch(cpartials, chunks), cp.ed_lookup_msm_plain(ctable, cscalars, None, w, chunks)) == 0,
         chunks=k)
    del gens, cgens, ctable, cpartials, r0, r1
    torch.cuda.empty_cache()

    curves = {c.name: c for c in wc.CURVES}
    ed_base = generators.get_precomputed_generators(1 << 16, 0, dev)
    for instance, size, cols in TREE_SHAPES:
        curve = curves.get(instance)
        ix = torch.arange(size * cols, device=dev)
        if curve is None:
            batch = ed.reshape_batch(ed.index_batch(ed_base, ix % (1 << 16)), (size, cols))
            kernel, plain, equal, pick = cp.tree_reduce_lanes, cp.tree_reduce_lanes_plain, ed.points_equal, \
                ed.index_batch
        else:
            batch, _ = cs.tiled_generators(curve, size * cols, dev)
            batch = curve.reshape_batch(batch, (size, cols))
            kernel = functools.partial(cw.w_tree_reduce_lanes, curve)
            plain = functools.partial(cw.w_tree_reduce_lanes_plain, curve)
            equal, pick = curve.points_equal, curve.index_batch
        del ix
        cols_ix = spread(min(cols, TREE_CHECK_COLS), cols)
        ok = bool(equal(pick(kernel(batch), cols_ix), plain(pick(batch, (slice(None), cols_ix)))).all())
        case(f"tree_reduce_lanes/{instance}/{size}x{cols}", lambda: kernel(batch), ok)
        del batch
    torch.cuda.empty_cache()

    report["all_ok"] = all(c["ok"] for c in cases.values())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"root": root, "all_ok": report["all_ok"], "cases": len(cases)}))
    return 0 if report["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
