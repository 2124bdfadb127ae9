#!/usr/bin/env python3
"""Time the kernels that the Edwards adds (csrc/edwards25519.cuh), the
Weierstrass adds and the Montgomery multiply (csrc/weierstrass.cuh,
csrc/mont.cuh), the partition lookups, the ladders and the tree reduce
reach, in one checkout of the repository, at the shapes of its main paths,
each checked against its plain version; one run per checkout, in turns,
compares two trees on one card:

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
  ``doubling_combine`` (one output's 256 bit-row products), the few-row
  query's column sums at 2^20, one-byte column (the tree's ``fewrow_niels``,
  or its ``niels_tree_reduce_lanes`` on the first gathered row block),
  ``build_cached_table`` and the cached
  ``ed_lookup_msm`` on a 2^18-point chunk (w = 8, random 32-byte scalars);
- the Weierstrass query (section ``weierstrass``): ``w_build_table`` and
  ``w_lookup_msm`` at bn254 G1 2^20 (one 32-byte counter column over the
  oracle's 521 points tiled), the ladder of that query's 256 bit-row
  products and of seven outputs (``fixed.doubling_combine``: the kernel
  ``w_doubling_combine``, or a tree's 510 ``wdouble``/``wadd`` launches;
  also timed back to back, host issue included, as ``cuda_ms``; the
  kernel, where the tree has it, also in one segment, blitzar_tpu's
  order), ``wadd`` and ``wdouble`` at one point and at 512, and on a
  2^18-point chunk of each curve (random 32-byte scalars) ``w_lookup_msm``,
  ``w_tree_reduce_lanes`` on its partials and the ladder of the 256 bit-row
  products they sum to;
- the proof kernels (section ``mont``): ``mont_mul_ew``, ``mont_fold_round``
  and ``mont_sum_round`` (degree 3, the sumcheck benchmark's round table, and
  degree 5) at chip_smoke.py's 2^20 shapes, in both proof fields, and
  ``mont_sum_round`` at the benchmark's mid = 2^10, 8 and 1 and summed over
  a 2^20 proof's 20 rounds; ``mont_mul_ew`` also in the two Weierstrass
  base fields; a Weierstrass raw file's chunk put in affine form
  (``msm/interop.py``: the tree's ``w_affine`` kernel, or its batch
  inversion over ``mont_mul_ew`` launches), a 2^22-entry chunk of each
  curve and the w = 16 file of 64 generators' chunk (4 x 2^16), its rows
  against the plain version on a slice of the chunk, device time of the
  kernel and back to back (``cuda_ms``, host issue included) for both;
- ``tree_reduce_lanes`` at every (curve, size, cols) that chip_smoke.py's
  paths launched it at (its phase 19), on the same tiled points as there
  (section ``trees``);
- the two table builds of csrc/table_build.cuh's lane schedule (section
  ``tables``): ``w_build_table`` at bn254 G1 2^20 and on a 2^18-point chunk
  of each curve, ``build_cached_table`` on a 2^18-point chunk;
- the ladders of csrc/ladder.cuh (section ``ladders``):
  ``doubling_combine`` at 1, 2, 7 and 10 outputs, also in one segment
  where the tree takes ``seg_bits``, and bn254 G1's ladder of one and seven
  outputs;
- the ristretto255 table conversions (section ``convert``): a point
  table's chunk to niels words (``fixed.niels_table``: the tree's
  ``ed_to_niels``, or its batch inversion over ``fmul`` and ``finvert``
  launches) at the 2^16 npz read's 2^21 entries, and niels words to the raw
  file's rows and back (the tree's ``ed_file_rows`` and ``ed_file_entries``,
  or its ``fmul`` chains in ``msm/interop.py``) at a 2^20 handle's 2^22-entry
  chunk; each against the tree's plain path on 4096 entries of it, device
  time where the tree has the one-launch kernel, and back to back
  (``cuda_ms``, host issue included) for both;
- the bucket engine's Horner (section ``horner``): ``engine.horner`` (the
  tree's ``ed_horner`` / ``w_horner``, or its 8 one-point doublings and an
  add a window) over ristretto255 window sums of 1 and 10 outputs and
  bn254 G1 ones of one output, 32 windows each, the same points as the
  engine's loop on the CPU, timed as the conversions;
- the few-row query (section ``fewrow``): ``fixed.fewrow_products`` of one
  counter column at chip_smoke.py phase 17's shapes (1- and 8-byte columns
  and a w = 4 handle's 32-byte one at 2^20, a 1-byte column at 2^10), timed
  whole back to back beside the lookup's products, split by stage on the
  host clock, and its niels column sums' device time by (size, cols);
- ``finvert`` (section ``finvert``) at chip_smoke.py's ``FINVERT_COUNTS``
  on operands with zeros and non-canonical limbs;
- the conversions back to points (section ``points``): the npz write's
  point table (``fixed.niels_point_table``: the tree's ``ed_niels_points``
  launch a chunk, or its ``fmul`` chain among plain passes) of a 2^16
  handle (one 2^21-entry chunk) and a 2^20 one (8 chunks of 2^22), the 2^16
  npz write whole, the generator disk cache's save of 2^20 generators
  (``generators._disk_save``: ``ed_affine``, or ``finvert`` and ``fmul``)
  and a legacy extended file's load of 2^16 (``generators._disk_load``);
- the bucket engine's window sums (section ``windows``):
  ``engine.window_sums`` (the tree's ``ed_window_sums`` / ``w_window_sums``
  launch, or its 8 ``ed_add`` / ``wadd`` scan launches, cats and a
  ``tree_reduce_lanes`` launch) at R = 8, 32 and 320 rows of ristretto255
  bucket sums and 32 of bn254 G1, as points against the tree's CPU path,
  and the bucket engine's 2^20 commitment (the pinned digest) split by
  stage with the window sums a stage of their own.

- the ristretto255 codec (section ``codec``): the encode and the decode
  (the tree's ``ristretto_encode`` / ``ristretto_decode`` launch, or its
  plain ``curves/ristretto.py`` chain) at chip_smoke.py's ``CODEC_COUNTS``
  (1, 2, 40, 2^16) on its ``codec_inputs`` (the decode's bytes with
  invalid ones among them), each against the plain version on the card;
  the warm 2^20 commitment's encode stage (the encoding and its copy to the
  host, host clock, median of 5) and the warm commitment whole (median of
  3); the IPA at 2^20 (chip_smoke.py phase 10's rows): prove cold, warm
  (median of 2) with the encode's share of one more, verify, and a digest of
  the proof, which both trees must give.
- the proofs' rows to Montgomery limbs (section ``rows``): the sumcheck's
  3 x 2^20 rows (chip_smoke.py phase 9's) in both fields and the IPA's 2^20
  b rows, split by ``chip_smoke.rows_parts`` into the host's steps, the
  copy to the card and the launches (the tree's ``mont_from_rows``, or its
  numpy split, int32 copy and ``mont_mul_ew``), with the table's digest,
  which both trees must give; and the IPA 2^20 verify whole (median of 3);
- the elementwise adds (section ``adds``): ``ed_add`` at the IPA's 512
  pairs, at the skewed bucket column's 5610 and at (32, 255) and (320,
  255) (chip_smoke.py phase 2's shapes), as it is and with q negated (the
  tree's ``negate_q``, or a plain ``neg`` and the launch, back to back),
  ``niels_add`` at the few-row path's 64 x 8 and at 512, each against its
  plain version; and an empty launch's device time (the floor).
- the Weierstrass add (section ``wadds``): ``wadd`` on each curve at the
  signed combine's 1, 2, 3, 7 and 10 outputs (chip_smoke.py phases 4 and
  12) and at 512 and (32, 255) pairs, as it is and with q negated (the
  tree's ``negate_q``, or a plain ``curve.neg`` and the launch, back to
  back), each against its plain version; and an empty launch's device time;
- the generator disk cache's load (section ``cache``): 2^20 generators
  saved by the tree's ``generators._disk_save``, then loaded, split by
  ``chip_smoke.cache_load_parts`` into the host's steps, the copy to the
  card and the launches (the tree's ``ed_from_affine_rows``, or its int32
  cast, copy and ``fmul``), with the points' digest, which both trees must
  give; and ``generators._disk_load`` whole (median of 3).

Each case of ``points`` and ``windows`` is timed whole back to back
(``cuda_ms``, host issue included) and, queued behind a sleep once, split
into its kernel launches, each between its own CUDA events (its device
time), beside the device span of the whole call, whose rest is the plain
passes between the launches (``launch_split``).

Each case's result is held against its plain version (canonical limbs, or
points for the tree reduces and the ladders; on a spread sample where the
plain version is large); the JSON holds each case's ``ms`` and whether it
matched. ``--sections`` runs some of the seventeen sections (``edwards``,
``weierstrass``, ``mont``, ``trees``, ``tables``, ``ladders``, ``convert``,
``horner``, ``fewrow``, ``finvert``, ``points``, ``windows``, ``codec``,
``rows``, ``adds``, ``wadds``, ``cache``).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import inspect
import json
import os
import shutil
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


SECTIONS = ("edwards", "weierstrass", "mont", "trees", "tables", "ladders", "convert", "horner", "fewrow", "finvert",
            "points", "windows", "codec", "rows", "adds", "wadds", "cache")
# the few-row queries of chip_smoke.py phase 17: (n, bytes of the column, w)
FEWROW_QUERIES = ((1 << 20, 1, 8), (1 << 20, 8, 8), (1 << 20, 32, 4), (1 << 10, 1, 8))
# the Weierstrass lookups' partials at the shapes their chunk rules give a
# 256-row query: K = 1024 (the rule before w_lookup_msm took lookup_chunks),
# 527 at 2^20 and 521 at a 2^18-point chunk since
W_TREE_SHAPES = [(c, s, 256) for c in ("bls12_381_g1", "bn254_g1", "grumpkin") for s in (521, 527)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose blitzar_tpu_torch is timed")
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--sections", default=",".join(SECTIONS), help="comma-separated sections to run")
    args = ap.parse_args()
    sections = args.sections.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"sections are {SECTIONS}")
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this script's chip_smoke.py (its helpers), whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from blitzar_tpu_torch.ops import build
    from blitzar_tpu_torch.ops import cuda_point as cp

    assert os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(cp.__file__)))) == root, cp.__file__
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    report = {"root": root, "card": cs.card_line(), "build_s": time.perf_counter() - t0,
              "ptxas": {src: cs.ptxas_report((build.BUILD_ROOT / build.digest() / "ptxas.log").read_text(), src)
                        for src in ("w_lookup_msm.cu", "w_doubling_combine.cu", "wadd.cu", "wdouble.cu",
                                    "w_build_table.cu", "build_cached_table.cu", "doubling_combine.cu",
                                    "w_affine.cu", "mont_sum_round.cu", "ed_convert.cu", "ed_horner.cu",
                                    "w_horner.cu", "fewrow_niels.cu", "niels_tree_reduce_lanes.cu", "finvert.cu",
                                    "window_sums.cu", "ristretto.cu", "mont_rows.cu", "ed_add.cu", "niels_add.cu")},
              "cases": {}}
    cases = report["cases"]

    def case(name, fn, ok, reps=5, ms=None, **extra):
        """ms: fn's device time, unless given (a time taken otherwise)."""
        if ms is None:
            ms = cs.device_ms(torch, fn, reps=reps)
        cases[name] = {"ms": ms, "ok": bool(ok), **extra}
        print(f"{'ok ' if ok else 'BAD'} {name}: {ms:.4f} ms", flush=True)

    for section in SECTIONS:
        if section in sections:
            globals()[f"section_{section}"](torch, cs, dev, case)
            torch.cuda.empty_cache()

    report["all_ok"] = all(c["ok"] for c in cases.values())
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"root": root, "all_ok": report["all_ok"], "cases": len(cases)}))
    return 0 if report["all_ok"] else 1


def section_edwards(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    spread = functools.partial(cs.spread_indices, torch, dev)
    ed_err = functools.partial(cs.point_err, canonical=F.canonicalize)
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
         bool(ed.points_equal(cp.doubling_combine(products), cp.doubling_combine_plain(products)).all()), reps=20)

    column = torch.from_numpy(cs.counter_scalars(n, 1)[None]).to(dev)
    if hasattr(cp, "fewrow_niels"):  # the one-byte query's column sums, one launch
        gc = fixed.table_chunk_groups(groups)
        chunks = spread(4, groups // gc)
        sums = cp.fewrow_niels(table, column, None, w, gc)
        case("fewrow_niels", lambda: cp.fewrow_niels(table, column, None, w, gc),
             ed_err(ed.index_batch(sums, chunks), cp.fewrow_niels_plain(table, column, None, w, gc, chunks)) == 0,
             shape=[gc, sums.x.shape[1] * sums.x.shape[2]])
        del sums
    else:
        idx = cp.query_index(column, None, w)
        entries = fixed.chunk_entries(table, idx[fixed.fewrow_blocks(table, 8)[0]], w)
        case("niels_tree_reduce_lanes", lambda: cp.niels_tree_reduce_lanes(entries),
             ed_err(cp.niels_tree_reduce_lanes(entries), cp.niels_tree_reduce_lanes_plain(entries)) == 0,
             shape=list(entries.shape[:2]))
        del entries, idx
    del table, partials

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



def ladder_reference(curve, rows, nbits: int):
    """One segment's ladder on the plain adds (wdouble_plain, wadd_plain),
    blitzar_tpu's order: every tree's result is the same point."""
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    acc = curve.index_batch(rows, (slice(None), nbits - 1))
    for b in range(nbits - 2, -1, -1):
        acc = cw.wadd_plain(curve, cw.wdouble_plain(curve, acc), curve.index_batch(rows, (slice(None), b)))
    return acc


def section_weierstrass(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    spread = functools.partial(cs.spread_indices, torch, dev)
    n, w = 1 << 20, 8
    groups = n // w
    bn = wc.BN254_G1
    gens, _ = cs.tiled_generators(bn, n, dev)
    table = cw.w_build_table(bn, gens, w)
    sel = spread(64, groups)
    members = bn.index_batch(gens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    case("w_build_table/bn254_g1/2^20", lambda: cw.w_build_table(bn, gens, w),
         torch.equal(table[sel], cw.w_build_table_plain(bn, members, w)), reps=3)
    scalars = torch.from_numpy(cs.counter_scalars(n, 32)[None]).to(dev)
    partials = cw.w_lookup_msm(bn, table, scalars, None, w)
    k = partials.x.shape[1]
    chunks = spread(4, k)
    case("w_lookup_msm/bn254_g1/2^20", lambda: cw.w_lookup_msm(bn, table, scalars, None, w),
         cs.point_err(bn.index_batch(partials, chunks), cw.w_lookup_msm_plain(bn, table, scalars, None, w, chunks)) == 0,
         chunks=k)
    products = cw.w_tree_reduce_lanes(bn, partials)  # (256,) bit-row products
    cols = spread(8, partials.x.shape[2])
    ok = bool(bn.points_equal(bn.index_batch(products, cols),
                              cw.w_tree_reduce_lanes_plain(bn, bn.index_batch(partials, (slice(None), cols)))).all())
    case("w_tree_reduce_lanes/bn254_g1/lookup_partials_2^20", lambda: cw.w_tree_reduce_lanes(bn, partials), ok,
         shape=[k, partials.x.shape[2]])
    del table, partials

    nbits = 256
    rows = {1: products, 7: bn.index_batch(products, ((torch.arange(nbits, device=dev)[None]
                                                        + 37 * torch.arange(7, device=dev)[:, None]) % nbits).reshape(-1))}
    # a tree that issues the ladder as 510 launches queues too many behind
    # device_ms's sleep for more than one rep
    kernel = hasattr(cw, "w_doubling_combine")
    for outputs, flat in rows.items():
        got = fixed.doubling_combine(flat, outputs, nbits, bn)
        want = ladder_reference(bn, bn.reshape_batch(flat, (outputs, nbits)), nbits)
        case(f"ladder/bn254_g1/{outputs}x{nbits}", lambda: fixed.doubling_combine(flat, outputs, nbits, bn),
             bool(bn.points_equal(got, want).all()), reps=5 if kernel else 1,
             cuda_ms=cs.cuda_ms(torch, lambda: fixed.doubling_combine(flat, outputs, nbits, bn), reps=5))
        if kernel:  # the same kernel in one segment: blitzar_tpu's order, its coordinates
            one = functools.partial(cw.w_doubling_combine, bn, bn.reshape_batch(flat, (outputs, nbits)))
            seg_rule = cw.ladder_segment_bits
            cw.ladder_segment_bits = lambda nb: nb
            try:
                case(f"ladder/bn254_g1/{outputs}x{nbits}/one_segment", one, cs.point_err(one(), want) == 0, reps=5)
            finally:
                cw.ladder_segment_bits = seg_rule

    lo, hi = bn.index_batch(products, slice(0, 128)), bn.index_batch(products, slice(128, 256))
    pairs = bn.cat([products, products]), bn.cat([lo, hi, hi, lo])  # 512 points
    one = bn.index_batch(products, slice(0, 1)), bn.index_batch(products, slice(1, 2))
    for label, (p, q) in (("1", one), ("512", pairs)):
        case(f"wadd/bn254_g1/{label}", lambda: cw.wadd(bn, p, q), cs.point_err(cw.wadd(bn, p, q), cw.wadd_plain(bn, p, q)) == 0,
             reps=50)
        case(f"wdouble/bn254_g1/{label}", lambda: cw.wdouble(bn, p),
             cs.point_err(cw.wdouble(bn, p), cw.wdouble_plain(bn, p)) == 0, reps=50)
    del gens, products

    chunk = cs.CHUNK
    rng = np.random.default_rng(6)
    cscalars = torch.from_numpy(rng.integers(0, 256, size=(1, chunk, 32), dtype=np.uint8)).to(dev)
    for curve in wc.CURVES:
        cgens, _ = cs.tiled_generators(curve, chunk, dev)
        ctable = cw.w_build_table(curve, cgens, w)
        cpartials = cw.w_lookup_msm(curve, ctable, cscalars, None, w)
        k = cpartials.x.shape[1]
        chunks = spread(4, k)
        case(f"w_lookup_msm/{curve.name}/2^18", lambda: cw.w_lookup_msm(curve, ctable, cscalars, None, w),
             cs.point_err(curve.index_batch(cpartials, chunks),
                          cw.w_lookup_msm_plain(curve, ctable, cscalars, None, w, chunks)) == 0, chunks=k)
        cols = spread(8, cpartials.x.shape[2])
        ok = bool(curve.points_equal(curve.index_batch(cw.w_tree_reduce_lanes(curve, cpartials), cols),
                                     cw.w_tree_reduce_lanes_plain(curve, curve.index_batch(cpartials, (slice(None), cols))))
                  .all())
        case(f"w_tree_reduce_lanes/{curve.name}/lookup_partials_2^18", lambda: cw.w_tree_reduce_lanes(curve, cpartials),
             ok, shape=[k, cpartials.x.shape[2]])
        cproducts = cw.w_tree_reduce_lanes(curve, cpartials)
        want = ladder_reference(curve, curve.reshape_batch(cproducts, (1, nbits)), nbits)
        case(f"ladder/{curve.name}/1x{nbits}_2^18", lambda: fixed.doubling_combine(cproducts, 1, nbits, curve),
             bool(curve.points_equal(fixed.doubling_combine(cproducts, 1, nbits, curve), want).all()),
             reps=5 if kernel else 1,
             cuda_ms=cs.cuda_ms(torch, lambda: fixed.doubling_combine(cproducts, 1, nbits, curve), reps=5))
        del cgens, ctable, cpartials, cproducts


def section_mont(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import interop
    from blitzar_tpu_torch.ops import cuda_mont as cm
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    n, m = 1 << 20, 3
    for fid, field in cm.MUL_FIELDS.items():
        a = cs.random_canonical(torch, field, (n,), dev, 1)
        b = cs.random_canonical(torch, field, (n,), dev, 2)
        case(f"mont_mul_ew/{field.name}/2^20", lambda: cm.mont_mul_ew(field, a, b),
             torch.equal(cm.mont_mul_ew(field, a, b), cm.mont_mul_ew_plain(field, a, b)), reps=10)
        if fid not in cm.FIELDS:
            continue
        table = cs.random_canonical(torch, field, (m, n), dev, 3)
        r = cs.random_canonical(torch, field, (1,), dev, 4)
        case(f"mont_fold_round/{field.name}/3x2^20", lambda: cm.mont_fold_round(field, table, r),
             torch.equal(cm.mont_fold_round(field, table, r), cm.mont_fold_round_plain(field, table, r)), reps=10)
        wide = cs.random_canonical(torch, field, (7, n), dev, 5)
        for key, mles, (ptable, pterms) in (("degree3", table, cs.SUMCHECK_BENCH_ROUND),
                                            ("degree5", wide, cs.SUMCHECK_DEG5)):
            degree = max(k for _, k in ptable)
            mults = field.from_ints([mu for mu, _ in ptable], dev)
            lengths = torch.tensor([k for _, k in ptable], dtype=torch.int32, device=dev)
            terms = torch.tensor(pterms, dtype=torch.int32, device=dev)
            run = functools.partial(cm.mont_sum_round, field, mles, mults, lengths, terms, degree)
            case(f"mont_sum_round/{field.name}/{key}", run,
                 torch.equal(run(), cm.mont_sum_round_plain(field, mles, mults, lengths, terms, degree)), reps=10)
            if key != "degree3":
                continue
            # the benchmark's rounds: mid = 2^19 .. 1 (the 2^20 row above
            # is mid 2^19), each on the first 2 mid lanes of a fresh table
            rounds = []
            for bits in range(19, -1, -1):
                mid = 1 << bits
                t = cs.random_canonical(torch, field, (m, 2 * mid), dev, 6 + bits)
                run = functools.partial(cm.mont_sum_round, field, t, mults, lengths, terms, degree)
                ok = torch.equal(run(), cm.mont_sum_round_plain(field, t, mults, lengths, terms, degree))
                ms = cs.device_ms(torch, run, reps=10)
                rounds.append(ms)
                if mid in (1 << 10, 8, 1):
                    case(f"mont_sum_round/{field.name}/degree3/mid{mid}", run, ok, reps=10)
                elif not ok:
                    case(f"mont_sum_round/{field.name}/degree3/mid{mid}", run, ok, reps=10)
            case(f"mont_sum_round/{field.name}/degree3/20_rounds", None, True, ms=sum(rounds), rounds_ms=rounds)
        del a, b, table, wide
    torch.cuda.empty_cache()

    # a raw file's chunk in affine form: the tree's w_affine, or its batch
    # inversion over mont_mul_ew (interop._w_rows)
    kernel = getattr(cw, "w_affine", None)
    affine = (lambda c, chunk: kernel(c, chunk)) if kernel else (lambda c, chunk: interop._w_rows(c, chunk))
    for curve in wc.CURVES:
        for groups, entries in ((1 << 14, 256), (4, 1 << 16)):
            chunk = cs.affine_chunk(torch, curve, groups, entries, dev, 47)
            rows = affine(curve, chunk)
            g = max(1, 4096 // entries)
            ok = torch.equal(rows[: g * entries].cpu(), affine(curve, chunk[:g].cpu()))  # the tree's plain path
            back_to_back = cs.cuda_ms(torch, lambda: affine(curve, chunk), reps=3)
            name = f"files_affine/{curve.name}/{groups}x{entries}"
            # the parent's many launches and host steps cannot queue behind
            # device_ms's sleep: its ms is the back-to-back time
            case(name, lambda: affine(curve, chunk), ok, reps=3, ms=None if kernel else back_to_back,
                 back_to_back_ms=back_to_back, one_launch=bool(kernel))
            del chunk, rows
        torch.cuda.empty_cache()


def section_tables(torch, cs, dev, case) -> None:
    """The two table builds of table_build.cuh's lane schedule:
    w_build_table at bn254 G1 2^20 and on a 2^18-point chunk of each curve
    (the oracle's 521 points tiled, w = 8), build_cached_table on a
    2^18-point chunk of the canonical generators; limb for limb the plain
    version on 64 groups spread over the table."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    spread = functools.partial(cs.spread_indices, torch, dev)
    w = 8
    for curve, n in [(wc.BN254_G1, 1 << 20)] + [(c, cs.CHUNK) for c in wc.CURVES]:
        groups = n // w
        gens, _ = cs.tiled_generators(curve, n, dev)
        table = cw.w_build_table(curve, gens, w)
        sel = spread(64, groups)
        members = curve.index_batch(gens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
        case(f"w_build_table/{curve.name}/2^{n.bit_length() - 1}", lambda: cw.w_build_table(curve, gens, w),
             torch.equal(table[sel], cw.w_build_table_plain(curve, members, w)), reps=3)
        del gens, table
    cgens = generators.get_precomputed_generators(cs.CHUNK, 0, dev)
    cgroups = cs.CHUNK // w
    ctable = cp.build_cached_table(cgens, w)
    sel = spread(64, cgroups)
    members = ed.index_batch(cgens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    case("build_cached_table/2^18", lambda: cp.build_cached_table(cgens, w),
         torch.equal(ctable[sel], cp.build_cached_table_plain(members, w)), reps=5)
    del cgens, ctable


def section_ladders(torch, cs, dev, case) -> None:
    """The two ladders of ladder.cuh: doubling_combine at 1, 2, 7 and 10
    outputs of 256 bit-row products (the first 2^16 generators tiled, an
    output rotated by 37 bits from the one before), also in one segment
    (blitzar_tpu's order) where the tree's wrapper takes ``seg_bits``; the
    same points as the one-segment plain version. w_doubling_combine's bn254
    G1 ladder of one and of seven outputs, as section weierstrass."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    nbits = 256
    base = ed.reshape_batch(ed.index_batch(generators.get_precomputed_generators(1 << 16, 0, dev),
                                           torch.arange(nbits, device=dev)), (1, nbits))
    segments = "seg_bits" in inspect.signature(cp.doubling_combine).parameters
    for outputs in cs.LADDER_OUTPUTS:
        rows = ed.index_batch(base, (0, (torch.arange(nbits, device=dev)[None]
                                         + 37 * torch.arange(outputs, device=dev)[:, None]) % nbits))
        want = cp.doubling_combine_plain(rows)
        case(f"doubling_combine/{outputs}x{nbits}", lambda: cp.doubling_combine(rows),
             bool(ed.points_equal(cp.doubling_combine(rows), want).all()), reps=10)
        if segments:
            one = functools.partial(cp.doubling_combine, rows, seg_bits=nbits)
            case(f"doubling_combine/{outputs}x{nbits}/one_segment", one,
                 cs.point_err(one(), want, F.canonicalize) == 0, reps=10)
    bn = wc.BN254_G1
    gens, _ = cs.tiled_generators(bn, nbits, dev)
    for outputs in (1, 7):
        flat = bn.index_batch(gens, ((torch.arange(nbits, device=dev)[None]
                                      + 37 * torch.arange(outputs, device=dev)[:, None]) % nbits).reshape(-1))
        want = ladder_reference(bn, bn.reshape_batch(flat, (outputs, nbits)), nbits)
        case(f"ladder/bn254_g1/{outputs}x{nbits}/tiled", lambda: fixed.doubling_combine(flat, outputs, nbits, bn),
             bool(bn.points_equal(fixed.doubling_combine(flat, outputs, nbits, bn), want).all()), reps=10)


def section_trees(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    spread = functools.partial(cs.spread_indices, torch, dev)
    curves = {c.name: c for c in wc.CURVES}
    ed_base = generators.get_precomputed_generators(1 << 16, 0, dev)
    for instance, size, cols in TREE_SHAPES + W_TREE_SHAPES:
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



def one_launch_case(torch, cs, case, name, fn, ok, kernel: bool, **extra) -> None:
    """A path step timed back to back (``cuda_ms``, host issue included) and,
    where the tree runs it as one launch, by its device time; the parent's
    many launches and host steps cannot queue behind device_ms's sleep."""
    back_to_back = cs.cuda_ms(torch, fn, reps=3)
    case(name, fn, ok, reps=5, ms=None if kernel else back_to_back, back_to_back_ms=back_to_back,
         one_launch=kernel, **extra)


# the npz read's chunk at 2^16 points, and a 2^20 handle's raw-file chunk
CONVERT_ENTRIES = (1 << 21, 1 << 22)


def section_convert(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.msm import fixed, interop
    from blitzar_tpu_torch.ops import cuda_point as cp

    kernel = hasattr(cp, "ed_to_niels")
    rows_of = cp.ed_file_rows if kernel else interop._ed_rows
    entries_of = cp.ed_file_entries if kernel else interop._ed_entries
    check = 16  # groups of 256 held against the tree's plain path on the CPU
    for count in CONVERT_ENTRIES:
        chunk = cs.ed_conversion_chunk(torch, dev, count, 48)
        words = fixed.niels_table(chunk)
        part = ed.PointP3(*(c[:, :check].cpu() for c in chunk))
        log = count.bit_length() - 1
        if count == CONVERT_ENTRIES[0]:
            one_launch_case(torch, cs, case, f"convert/to_niels/2^{log}", lambda: fixed.niels_table(chunk),
                            torch.equal(words[:check].cpu(), fixed.niels_table(part)), kernel)
            continue
        rows = rows_of(words)
        one_launch_case(torch, cs, case, f"convert/file_rows/2^{log}", lambda: rows_of(words),
                        torch.equal(rows[: check * 256].cpu(), rows_of(words[:check].cpu())), kernel)
        back = entries_of(rows)
        one_launch_case(torch, cs, case, f"convert/file_entries/2^{log}", lambda: entries_of(rows),
                        torch.equal(back.reshape(words.shape), words), kernel)
        del rows, back
    del chunk, words


def section_horner(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import cuda_point as cp

    kernel = "ed_horner" in cp.KERNELS
    windows = 32
    base = generators.get_precomputed_generators(1 << 16, 0, dev)
    bn = wc.BN254_G1
    for curve, outputs in ((ed, 1), (ed, 10), (bn, 1)):
        idx = torch.arange(outputs * windows, device=dev)
        if curve is ed:
            sums = ed.reshape_batch(ed.index_batch(base, idx * 37 % (1 << 16)), (outputs, windows))
        else:
            gens, _ = cs.tiled_generators(bn, outputs * windows, dev)
            sums = bn.reshape_batch(gens, (outputs, windows))
        got = engine.horner(sums, curve)
        cpu = type(sums)(*(c.cpu() for c in sums))
        want = engine.horner(cpu, curve)  # the tree's CPU path: the engine's loop
        ok = bool(curve.points_equal(type(got)(*(c.cpu() for c in got)), want).all())
        name = "ristretto255" if curve is ed else curve.name
        one_launch_case(torch, cs, case, f"horner/{name}/{outputs}x{windows}", lambda: engine.horner(sums, curve), ok,
                        kernel)



def section_fewrow(torch, cs, dev, case) -> None:
    """The few-row query (``fixed.fewrow_products``) of one counter column
    at chip_smoke.py phase 17's shapes over the canonical generators: timed
    whole, back to back (``cuda_ms``), its products held against the
    lookup's as points; then split, each stage of one call synchronised on
    the host clock (the (R, G) index tensor, the entry gathers, the niels
    column sums, ``niels_add``, the tree reduces; "host_and_rest" is the
    call's host time and plain steps), and the niels column sums' device
    time at each (size, cols) the call launched them at: the tree's
    ``fewrow_niels``, or its ``niels_tree_reduce_lanes`` on each gathered
    row block."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    one_launch = hasattr(cp, "fewrow_niels")
    niels = "fewrow_niels" if one_launch else "niels_tree_reduce_lanes"
    stages = {"query_index": [(cp, "query_index")], "gather": [(fixed, "chunk_entries")],
              niels: [(cp, niels)], "niels_add": [(cp, "niels_add")], "tree_reduce_lanes": [(cp, "tree_reduce_lanes")]}
    handle = None
    for n, nbytes, w in FEWROW_QUERIES:
        if handle is None or (handle.n, handle.window_width) != (n, w):
            handle = None
            torch.cuda.empty_cache()
            handle = fixed.MultiexpHandle(generators.get_precomputed_generators(n, 0, dev), window_width=w)
        table = handle.table
        scalars = torch.from_numpy(cs.counter_scalars(n, nbytes)[None]).to(dev)
        query = functools.partial(fixed.fewrow_products, table, scalars, None, w)

        def lookup():
            return fixed.sum_leading(cp.ed_lookup_msm(table, scalars, None, w))

        ok = bool(ed.points_equal(query(), lookup()).all())
        with cs.StageTimer(torch, stages) as st:
            _, total = cs.timed(torch, query)
        split = {"total": total, **st.ms, "host_and_rest": total - sum(st.ms.values())}
        groups = table.shape[0]
        gc = fixed.table_chunk_groups(groups)
        kernel_ms = {}
        if one_launch and cp.niels_tree_fits(gc):
            cols = groups // gc * 8 * nbytes
            kernel_ms[f"{gc}x{cols}"] = {"ms": cs.device_ms(torch, lambda: cp.fewrow_niels(table, scalars, None, w, gc),
                                                            reps=5), "launches": 1}
        elif not one_launch and cp.niels_tree_fits(gc):
            idx = cp.query_index(scalars, None, w)
            for rows in fixed.fewrow_blocks(table, idx.shape[0]):
                sel = fixed.chunk_entries(table, idx[rows], w)
                key = f"{sel.shape[0]}x{sel.shape[1]}"
                if key not in kernel_ms:
                    kernel_ms[key] = {"ms": cs.device_ms(torch, lambda: cp.niels_tree_reduce_lanes(sel), reps=5),
                                      "launches": 0}
                kernel_ms[key]["launches"] += 1
                del sel
            del idx
        case(f"fewrow/2^{n.bit_length() - 1}_{nbytes}B_w{w}", query, ok, ms=cs.cuda_ms(torch, query, reps=5),
             lookup_ms=cs.cuda_ms(torch, lookup, reps=5), split=split, niels_kernel=niels, niels_kernel_ms=kernel_ms)
        del scalars
    del handle


def section_finvert(torch, cs, dev, case) -> None:
    """``finvert`` at chip_smoke.py's counts (``FINVERT_COUNTS``: a legacy
    extended file's load, a cache save's 2^20) on its operands with zeros,
    p, 2p, non-canonical limbs and values above 2^255
    (``finvert_operands``), against the plain version on every element."""
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_field as cf

    for count in cs.FINVERT_COUNTS:
        a = cs.finvert_operands(torch, dev, count, 49)
        want = F.canonicalize(cf.finvert_plain(a))
        run = functools.partial(cf.finvert, a)
        case(f"finvert/2^{count.bit_length() - 1}", run, torch.equal(F.canonicalize(run()), want), reps=10)
        del a, want



def launch_split(torch, fn) -> dict:
    """fn() once, queued behind a sleep, each kernel launch between its own
    CUDA events: the launches by kernel with each one's device ms, their
    sum, the device span of the whole call and its rest (the plain passes
    between the launches, and any wait for the host once the sleep is
    over) and the call's host-clock time (the sleep included). A launch
    made after fn synchronises (a copy to the host) counts its own host
    issue too."""
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_field, cuda_mont, cuda_wpoint

    modules = (cp, cuda_field, cuda_mont, cuda_wpoint)
    inner, seen = cp._launch, []

    def launch(name, f, *args, instance=None):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        inner(name, f, *args, instance=instance)
        stop.record()
        seen.append((name, start, stop))

    fn()
    torch.cuda.synchronize()
    first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for m in modules:
        m._launch = launch
    try:
        torch.cuda._sleep(1 << 25)
        t0 = time.perf_counter()
        first.record()
        fn()
        last.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for m in modules:
            m._launch = inner
    by: dict = {}
    for name, start, stop in seen:
        by.setdefault(name, []).append(start.elapsed_time(stop))
    launches_ms = sum(sum(v) for v in by.values())
    span = first.elapsed_time(last)
    return {"launches": {k: len(v) for k, v in by.items()}, "launch_device_ms": by, "launches_ms": launches_ms,
            "span_ms": span, "rest_of_span_ms": span - launches_ms, "host_ms": host_ms}


def split_case(torch, cs, case, name, fn, ok, kernel: bool, **extra) -> None:
    """A path step whole back to back (``cuda_ms``) and split by
    ``launch_split``; its ``ms`` the back-to-back time."""
    split = launch_split(torch, fn)
    case(name, fn, ok, ms=cs.cuda_ms(torch, fn, reps=3), one_launch=kernel, split=split, **extra)


# the npz write's handles: one 2^21-entry chunk, and 8 chunks of 2^22
POINTS_HANDLES = (1 << 16, 1 << 20)
CACHE_SAVE_N = 1 << 20
LEGACY_N = 1 << 16


def section_points(torch, cs, dev, case) -> None:
    import shutil
    import tempfile

    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    kernel = hasattr(cp, "ed_affine")
    work = tempfile.mkdtemp(prefix="kernel_ab-", dir=os.path.join(HERE, "build"))
    saved_dir = generators.DISK_DIR
    try:
        generators.DISK_DIR = ""
        gens = generators.ristretto_generators(CACHE_SAVE_N, 0, dev)
        for n in POINTS_HANDLES:
            handle = fixed.MultiexpHandle(ed.index_batch(gens, slice(0, n)))
            words = handle.table
            table = fixed.niels_point_table(words)
            want = fixed.niels_point_table(words[:16].cpu())
            ok = all(torch.equal(F.canonicalize(c[:, :16]).cpu(), F.canonicalize(w)) for c, w in zip(table, want))
            del table
            split_case(torch, cs, case, f"points/npz_table/2^{n.bit_length() - 1}",
                       lambda: fixed.niels_point_table(words), ok, kernel, entries=words.shape[0] * words.shape[1])
            if n == POINTS_HANDLES[0]:
                path = os.path.join(work, "h.npz")
                times = []
                for _ in range(3):
                    _, ms = cs.timed(torch, lambda: handle.write_to_file(path))
                    times.append(ms)
                size = os.path.getsize(path)
                os.remove(path)
                case(f"points/npz_write_whole/2^{n.bit_length() - 1}", None, ok, ms=float(np.median(times)),
                     times_ms=times, bytes=size)
            del handle, words
            torch.cuda.empty_cache()

        # the disk cache's save of 2^20 generators, whole (D2H and disk) and split
        generators.DISK_DIR = work
        path = os.path.join(work, f"ristretto_gen_a_{CACHE_SAVE_N}.npy")

        def save():
            if os.path.exists(path):
                os.remove(path)
            generators._disk_save(gens, CACHE_SAVE_N)

        save()
        sample = slice(0, 4096)
        part = [c[:, sample].cpu() for c in gens]
        zinv = F.invert(part[2])
        arr = np.load(path)
        ok = all(np.array_equal(arr[k, :, sample], F.canonicalize(F.mul(part[k], zinv)).numpy()) for k in (0, 1))
        times = []
        for _ in range(3):
            _, ms = cs.timed(torch, save)
            times.append(ms)
        split = launch_split(torch, save)
        extra = {"ed_affine_device_ms": cs.device_ms(torch, lambda: cp.ed_affine(gens), reps=10)} if kernel else {}
        case(f"points/cache_save/2^{CACHE_SAVE_N.bit_length() - 1}", None, ok, ms=float(np.median(times)),
             times_ms=times, one_launch=kernel, split=split, **extra)
        os.remove(path)

        # a legacy extended file of 2^16 generators (z as derived), loaded
        legacy = os.path.join(work, f"ristretto_gen_{LEGACY_N}.npy")
        np.save(legacy, np.stack([F.canonicalize(c[:, :LEGACY_N]).cpu().numpy().astype(np.uint32) for c in gens]))
        loaded = generators._disk_load(LEGACY_N, dev)
        ok = bool(ed.points_equal(loaded, ed.index_batch(gens, slice(0, LEGACY_N))).all())
        times = []
        for _ in range(3):
            _, ms = cs.timed(torch, lambda: generators._disk_load(LEGACY_N, dev))
            times.append(ms)
        split = launch_split(torch, lambda: generators._disk_load(LEGACY_N, dev))
        extra = {}
        if kernel:
            part = ed.index_batch(gens, slice(0, LEGACY_N))
            extra["ed_affine_device_ms"] = cs.device_ms(torch, lambda: cp.ed_affine(part), reps=10)
        case(f"points/legacy_load/2^{LEGACY_N.bit_length() - 1}", None, ok, ms=float(np.median(times)),
             times_ms=times, one_launch=kernel, split=split, **extra)
    finally:
        generators.DISK_DIR = saved_dir
        shutil.rmtree(work, ignore_errors=True)


# the bucket engine's (output, window) rows: a signed 8-byte column, one
# 32-byte column, ten of them (100000 x 10)
WINDOW_ROWS = (8, 32, 320)
BUCKET_COMMIT_N = 1 << 20  # the bucket engine's commitment split (the pinned digest)


def window_buckets(torch, cs, curve, rows: int, dev):
    """(rows, 255) bucket sums on the card: the first 2^16 canonical
    generators (ristretto255) or the oracle's 521 points tiled, every
    seventh bucket and the whole second row empty."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed

    k = torch.arange(rows * 255, device=dev)
    empty = (k % 7 == 3) | (k // 255 == 1)
    if curve is ed:
        base = generators.get_precomputed_generators(1 << 16, 0, dev)
        pts = ed.index_batch(base, (k * 37) % base.x.shape[1])
    else:
        pts, _ = cs.tiled_generators(curve, rows * 255, dev)
    pts = curve.select(pts, curve.identity((rows * 255,), dev), empty)
    return curve.reshape_batch(pts, (rows, 255))


def section_windows(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import cuda_point as cp

    kernel = "ed_window_sums" in cp.KERNELS
    bn = wc.BN254_G1
    for curve, rows in [(ed, r) for r in WINDOW_ROWS] + [(bn, 32)]:
        buckets = window_buckets(torch, cs, curve, rows, dev)
        got = engine.window_sums(buckets, curve)
        cpu = type(buckets)(*(c.cpu() for c in buckets))
        want = engine.window_sums(cpu, curve)  # the tree's CPU path: the plain scan and tree
        ok = bool(curve.points_equal(type(got)(*(c.cpu() for c in got)), want).all())
        name = "ristretto255" if curve is ed else curve.name
        fn = functools.partial(engine.window_sums, buckets, curve)
        extra = {"device_ms": cs.device_ms(torch, fn, reps=10)} if kernel else {}
        split_case(torch, cs, case, f"windows/{name}/{rows}", fn, ok, kernel, **extra)
        del buckets, cpu

    # the bucket engine's 2^20 commitment, split by stage (host clock, each
    # stage synchronised), the window sums a stage of their own
    n = BUCKET_COMMIT_N
    api.init("gpu")
    generators.get_precomputed_generators(n, 0, dev)
    desc = api.SequenceDescriptor(32, n, cs.counter_scalars(n, 32))
    os.environ[engine.ENGINE_VAR] = "bucket"
    try:
        commit = functools.partial(api.compute_curve25519_commitments, [desc])
        pinned = cs.PINNED_RISTRETTO_MSM[n.bit_length() - 1]
        ok = cs.digest(commit()) == pinned
        times = []
        for _ in range(3):
            _, ms = cs.timed(torch, commit)
            times.append(ms)
        stages = {"sort": [(engine, "sort_digits")], "gather": [(engine, "gather_slab")],
                  "accumulate": [(engine, "bucket_accumulate")], "window_sums": [(engine, "window_sums")],
                  "horner": [(engine, "horner")]}
        with cs.StageTimer(torch, stages) as st:
            again, total = cs.timed(torch, commit)
        ok = ok and cs.digest(again) == pinned
        split = dict(st.ms)
        split["slab_reduce_and_round_adds"] = split.pop("accumulate") - split["sort"] - split["gather"]
        split = {"total": total, **split, "host_and_rest": total - sum(split.values())}
        case(f"windows/bucket_commit/2^{n.bit_length() - 1}", None, ok, ms=float(np.median(times)), times_ms=times, split=split)
    finally:
        os.environ.pop(engine.ENGINE_VAR, None)


IPA_N = 1 << 20


def section_codec(torch, cs, dev, case) -> None:
    import hashlib

    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import ristretto as rst
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.msm import engine, fixed
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.proof import inner_product as tipa
    from blitzar_tpu_torch.proof.transcript import Transcript

    kernel = hasattr(cp, "ristretto_encode")
    encode = cp.ristretto_encode if kernel else rst.encode
    decode = cp.ristretto_decode if kernel else rst.decode
    for count in cs.CODEC_COUNTS:
        pts, want, data, mask = cs.codec_inputs(torch, dev, count)
        ok = torch.equal(encode(pts), want)
        one_launch_case(torch, cs, case, f"codec/encode/{count}", functools.partial(encode, pts), ok, kernel)
        got, valid = decode(data)
        plain, plain_valid = rst.decode(data)
        good = torch.from_numpy(mask).to(dev)
        ok = (valid.cpu().numpy().tolist() == plain_valid.cpu().numpy().tolist() == mask.tolist()
              and all(torch.equal(F.canonicalize(g)[:, good], F.canonicalize(p)[:, good]) for g, p in zip(got, plain)))
        one_launch_case(torch, cs, case, f"codec/decode/{count}", functools.partial(decode, data), ok, kernel)
        del pts, want, data, got, plain

    # the warm 2^20 commitment: its encode stage (host clock, as chip_smoke.py's
    # warm_stages), and whole
    n = IPA_N
    if not api._BACKEND.initialized:  # the windows section's, where both run
        api.init("gpu")
    desc = api.SequenceDescriptor(32, n, cs.counter_scalars(n, 32))
    commit = functools.partial(api.compute_curve25519_commitments, [desc])
    ok = cs.digest(commit()) == cs.PINNED_RISTRETTO_MSM[20]
    gens = generators.get_precomputed_generators(n, 0, dev)
    scalars, _, rows = engine.prepare_scalars([desc.rows()], [32], [False])
    result = fixed.fixed_multiexponentiation(engine.cached_handle(gens, rows), scalars)
    ok = ok and cs.digest(encode(result).cpu().numpy().T) == cs.PINNED_RISTRETTO_MSM[20]
    stage = [cs.timed(torch, lambda: encode(result).cpu())[1] for _ in range(5)]
    case("codec/commit_2^20_encode_stage", None, ok, ms=float(np.median(stage)), times_ms=stage)
    warm = [cs.timed(torch, commit)[1] for _ in range(3)]
    case("codec/commit_2^20_warm", None, ok, ms=float(np.median(warm)), times_ms=warm)

    # the IPA at 2^20 (chip_smoke.py phase 10): prove, its encode's share, verify
    rng = np.random.default_rng(3)
    a, b = cs.bench_rows(rng, (n,)), cs.bench_rows(rng, (n,))

    def prove():
        return api.prove_inner_product(Transcript(b"bench"), n, 0, a, b)

    (l, r, ap), cold = cs.timed(torch, prove)
    warm = [cs.timed(torch, prove)[1] for _ in range(2)]
    target = (cp, "ristretto_encode") if kernel else (rst, "encode")
    with cs.StageTimer(torch, {"encode": [target]}) as st:
        (l2, r2, ap2), total = cs.timed(torch, prove)
    ok = np.array_equal(l, l2) and np.array_equal(r, r2) and ap == ap2
    proof = hashlib.sha256(l.tobytes() + r.tobytes() + int(ap).to_bytes(32, "little")).hexdigest()
    case("codec/ipa_2^20_prove", None, ok, ms=float(np.median(warm)), cold_ms=cold, times_ms=warm,
         split_ms={"total": total, "encode": st.ms["encode"]}, proof_sha256=proof)
    av = np.frombuffer(a[:, :8].tobytes(), "<u8").tolist()
    bv = np.frombuffer(b[:, :8].tobytes(), "<u8").tolist()
    product = sum(x * y for x, y in zip(av, bv)) % tipa.ORDER
    a_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, a)]))

    def verify(lv=l):
        return api.verify_inner_product(Transcript(b"bench"), n, 0, b, product, a_commit, lv, r, ap)

    verified, _ = cs.timed(torch, verify)
    times = [cs.timed(torch, verify)[1] for _ in range(3)]
    flipped = l.copy()
    flipped[3, 7] ^= 0x01
    ok = bool(verified) and not verify(lv=flipped)
    case("codec/ipa_2^20_verify", None, ok, ms=float(np.median(times)), times_ms=times)



def section_rows(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.proof import inner_product as tipa
    from blitzar_tpu_torch.proof import sumcheck as tsc
    from blitzar_tpu_torch.proof.transcript import Transcript

    n = IPA_N
    rows = cs.bench_rows(np.random.default_rng(4), (3, n)).reshape(3 * n, 32)
    for codec in (tsc.SCALAR25519_CODEC, tsc.FIELDGK_CODEC):
        mode = "standard" if codec is tsc.SCALAR25519_CODEC else "residues"
        parts = cs.rows_parts(torch, codec.field, rows, 3, n, mode)
        case(f"rows/sumcheck_{codec.name}_3x2^20", None, parts["equals_plain"],
             ms=parts["host"] + parts["copy"] + parts["kernel"], **parts)
    rng = np.random.default_rng(3)
    a, b = cs.bench_rows(rng, (n,)), cs.bench_rows(rng, (n,))
    parts = cs.rows_parts(torch, tipa.S, b, 1, n, "standard")
    case("rows/ipa_b_2^20", None, parts["equals_plain"], ms=parts["host"] + parts["copy"] + parts["kernel"], **parts)

    if not api._BACKEND.initialized:
        api.init("gpu")
    l, r, ap = api.prove_inner_product(Transcript(b"bench"), n, 0, a, b)
    av = np.frombuffer(a[:, :8].tobytes(), "<u8").tolist()
    bv = np.frombuffer(b[:, :8].tobytes(), "<u8").tolist()
    product = sum(x * y for x, y in zip(av, bv)) % tipa.ORDER
    a_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, a)]))

    def verify():
        return api.verify_inner_product(Transcript(b"bench"), n, 0, b, product, a_commit, l, r, ap)

    verified, _ = cs.timed(torch, verify)
    times = [cs.timed(torch, verify)[1] for _ in range(3)]
    case("rows/ipa_2^20_verify", None, bool(verified), ms=float(np.median(times)), times_ms=times)


# the elementwise adds' shapes: ed_add's (batch) at the IPA's 512 pairs, the
# skewed bucket column's 5610 round adds (chip_smoke.py phase 20) and
# chip_smoke.py phase 2's (R, 255); niels_add's at the few-row path's 64 x 8
ADD_SHAPES = ((512,), (5610,), (32, 255), (320, 255))
NIELS_ADD_SHAPES = ((64, 8), (512,))


def section_adds(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    ed_err = functools.partial(cs.point_err, canonical=F.canonicalize)
    flag = "negate_q" in inspect.signature(cp.ed_add).parameters
    count = 2 * 320 * 255
    r0, r1 = generators._xorshift_limbs(torch.arange(count, device=dev))
    gens = cp.elligator_form(r0, r1)
    case("adds/empty_launch", lambda: torch.cuda._sleep(0), True, reps=100)
    for shape in ADD_SHAPES:
        size = int(np.prod(shape))
        p = ed.reshape_batch(ed.index_batch(gens, slice(0, size)), shape)
        q = ed.reshape_batch(ed.index_batch(gens, slice(size, 2 * size)), shape)
        key = "x".join(map(str, shape))
        case(f"adds/ed_add/{key}", lambda: cp.ed_add(p, q),
             ed_err(cp.ed_add(p, q), cp.ed_add_plain(p, q)) == 0, reps=50)
        # p - q: the tree's one launch reading q negated (device time), or
        # its plain neg and the launch (back to back)
        if flag:
            neg_fn = functools.partial(cp.ed_add, p, q, negate_q=True)
        else:
            neg_fn = functools.partial(lambda p, q: cp.ed_add(p, ed.neg(q)), p, q)
        case(f"adds/ed_add_negate_q/{key}", neg_fn,
             ed_err(neg_fn(), cp.ed_add_plain(p, ed.neg(q))) == 0, reps=50,
             ms=None if flag else cs.cuda_ms(torch, neg_fn, reps=20), one_launch=flag,
             back_to_back_ms=cs.cuda_ms(torch, neg_fn, reps=20))
    entries = cp.pack_niels(ed.to_niels(ed.index_batch(gens, slice(0, 2 * 512))))
    for shape in NIELS_ADD_SHAPES:
        size = int(np.prod(shape))
        n1, n2 = (ed.Niels(*(c.reshape((16,) + shape).contiguous() for c in cp.unpack_niels(entries[s])))
                  for s in (slice(0, size), slice(512, 512 + size)))
        case(f"adds/niels_add/{'x'.join(map(str, shape))}", lambda: cp.niels_add(n1, n2),
             ed_err(cp.niels_add(n1, n2), cp.niels_add_plain(n1, n2)) == 0, reps=50)


# wadd's shapes: the signed combine's outputs on the paths (chip_smoke.py
# phases 4 and 12), 512 pairs and the bucket engine's round adds at (32, 255)
WADD_SHAPES = ((1,), (2,), (3,), (7,), (10,), (512,), (32, 255))


def section_wadds(torch, cs, dev, case) -> None:
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    flag = "negate_q" in inspect.signature(cw.wadd).parameters
    count = 2 * 32 * 255
    case("wadds/empty_launch", lambda: torch.cuda._sleep(0), True, reps=100)
    for curve in wc.CURVES:
        tiled, _ = cs.tiled_generators(curve, count, dev)
        pts = curve._double_impl(curve.index_batch(tiled, torch.randperm(count, device=dev)))  # z != 1
        for shape in WADD_SHAPES:
            size = int(np.prod(shape))
            p = curve.reshape_batch(curve.index_batch(pts, slice(0, size)), shape)
            q = curve.reshape_batch(curve.index_batch(pts, slice(size, 2 * size)), shape)
            key = f"{curve.name}/{'x'.join(map(str, shape))}"
            case(f"wadds/wadd/{key}", lambda: cw.wadd(curve, p, q),
                 cs.point_err(cw.wadd(curve, p, q), cw.wadd_plain(curve, p, q)) == 0, reps=50)
            # p - q: the tree's one launch reading q negated (device time), or
            # its plain neg and the launch (back to back)
            if flag:
                neg_fn = functools.partial(cw.wadd, curve, p, q, negate_q=True)
            else:
                neg_fn = functools.partial(lambda p, q: cw.wadd(curve, p, curve.neg(q)), p, q)
            case(f"wadds/wadd_negate_q/{key}", neg_fn,
                 cs.point_err(neg_fn(), cw.wadd_plain(curve, p, curve.neg(q))) == 0, reps=50,
                 ms=None if flag else cs.cuda_ms(torch, neg_fn, reps=20), one_launch=flag,
                 back_to_back_ms=cs.cuda_ms(torch, neg_fn, reps=20))
        del tiled, pts


CACHE_LOAD_N = 1 << 20


def section_cache(torch, cs, dev, case) -> None:
    import tempfile

    from blitzar_tpu_torch import generators

    work = tempfile.mkdtemp(prefix="kernel_ab-cache-", dir=os.path.join(HERE, "build"))
    try:
        generators.DISK_DIR = work
        gens = generators.ristretto_generators(CACHE_LOAD_N, 0, dev)  # derived and saved
        path = os.path.join(work, f"ristretto_gen_a_{CACHE_LOAD_N}.npy")
        parts = cs.cache_load_parts(torch, path, CACHE_LOAD_N)
        loaded = generators._disk_load(CACHE_LOAD_N, dev)
        ok = bool(generators.ed.points_equal(loaded, gens).all())
        case("cache/load_parts_2^20", None, ok, ms=parts["host"] + parts["copy"] + parts["kernel"], **parts)
        times = [cs.timed(torch, lambda: generators._disk_load(CACHE_LOAD_N, dev))[1] for _ in range(3)]
        case("cache/disk_load_2^20", None, ok, ms=float(np.median(times)), times_ms=times)
    finally:
        generators.DISK_DIR = ""
        generators.CACHE.reset()
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
