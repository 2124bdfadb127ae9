#!/usr/bin/env python3
"""Build blitzar_tpu_torch's kernels and drive its commitment, proof,
large-n (streamed), handle-file, bucket-engine and few-row query paths on
one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each fatal on failure:

1. build the kernels of the twenty-seven CUDA sources in ``blitzar_tpu_torch/csrc``
   (nvcc, sm_90a; one process per source, all at once), print their
   registers and spills (none allowed in ``ed_convert.cu``, ``ed_horner.cu``,
   ``w_horner.cu``, ``fewrow_niels.cu``, ``finvert.cu``,
   ``window_sums.cu``, ``ristretto.cu``, ``mont_rows.cu``, ``ed_add.cu`` and
   ``niels_add.cu``) and the card's name and power limit;
2. run each kernel at the shapes its path gives it at full width
   (ristretto255 2^20 commitment for the five Edwards kernels of the handle
   path, bn254 G1 for the five Weierstrass ones (the ladder
   ``w_doubling_combine`` at one output's 256 bit-row products and at
   seven; ``doubling_combine`` at one, two, seven and ten outputs, limb
   for limb the plain version in the kernel's segments and, run in one
   segment, in blitzar_tpu's order), a 2^20 IPA round and a 2^20 sumcheck
   round
   for the three proof kernels, in both proof fields; ``mont_from_rows`` at
   the sumcheck's 3 x 2^20 rows and at 2^20 - 5 rows padded to 2^20, in both
   fields; ``ed_add`` also reading q negated and at the window sums' (32,
   255) and (320, 255), beside an empty launch's device time; its and
   ``niels_add``'s readings at one thread a pair, constants, beside this
   run's times in ``earlier_add_ms``, outside the kernels line; ``wadd``
   at one point both ways, beside an empty launch) and hold it against
   its plain PyTorch version on the same inputs (canonical values must be
   equal), timing both (a kernel's time is the median device time of one
   launch, see ``device_ms``); where the plain version is too large to run
   whole, on a sample spread over the whole output, its last element
   included; the two table builds' ptxas registers and spills (none
   allowed) go to their own record of ``chiprun_out/chip_smoke.json``, as
   do ``w_affine``'s (no spill) and ``mont_sum_round``'s (no spill, no stack
   frame at any degree in either field);
3. the upstream end-to-end vectors through ``api.compute_curve25519_commitments``
   on the card, and a signed multi-output case against the plain CPU run
   (each signed ristretto255 commitment of phases 3-6 must take one
   ``ed_add`` launch that reads Q_neg negated for Q_pos - Q_neg, and no
   plain ``neg``);
4. the bn254 G1, Grumpkin and bls12-381 G1 commitment entries at n = 100
   (signed and unsigned columns, three outputs) against the oracle's sums
   (``blitzar_tpu_torch/refimpl/weierstrass.py``), the signed 8-byte column
   also through the streamed query; each signed Weierstrass query's Q_pos
   - Q_neg (handle and streamed, every curve) must be one ``wadd`` launch
   that reads Q_neg negated, and no plain ``curve.neg``;
5. ristretto255 full width: canonical generators with counter scalars at
   2^16 and 2^20 (compressed result = the pinned digest) and ten 32-byte
   outputs at n = 100000 (blake2b digest pinned), with the generator
   derivation, the handle build and the median of five queries timed at 2^20,
   a warm 2^20 commitment split by stage, its encode stage one
   ``ristretto_encode`` launch and, by the profiler, no other kernel on the
   device but the copy to the host;
6. Weierstrass full width: bn254 G1 at 2^20, then Grumpkin and bls12-381 G1
   at 2^16, one column of 32-byte counter scalars over 521 oracle points
   tiled to n (a prime period: a lookup that read the wrong group could not
   pass); the result must equal the oracle's collapsed sum
   sum_j (sum_{i = j mod 521} s_i) G_j, and each cold commitment's ladder
   must be one ``w_doubling_combine`` launch with no ``wadd`` or ``wdouble``
   (as must (e)'s streamed commitments in phase 12 and the bn254 G1 packed
   and vlen queries of phase 14). Cold and warm commitments, the handle
   build and the median of five queries are timed;
7. every commitment kernel of the handle path must have launched during
   phases 3-6 (the commitment path, counts from 0; the streamed path's
   kernels are held to phase 12);
8. the frozen IPA (n = 4, 7) and sumcheck (both fields, n = 8 and 37)
   vectors of ``tests/torch_proof_vectors.py`` through the entry points;
9. the benchmark's sumcheck at 2^20 in both fields: the verifier accepts
   against the sum over the cube, the final sum equals the MLEs folded to
   the evaluation point, a tampered coefficient is rejected, its table is
   one ``mont_from_rows`` launch; cold and warm proofs and the per-stage
   split of one more timed, the table's conversion also in three parts
   (host, copy, kernel: ``rows_parts``);
10. the benchmark's IPA at 2^20: the proof verifies against the port's own
   commitment to a, not with a flipped L byte or ap + 1; cold and warm
   proofs, the per-stage split of one proof and the verifier timed, the
   verifier also split by stage, its b rows in three parts; each row set
   of the prove (a, b) and the verify (b) is one ``mont_from_rows`` launch;
11. the proof kernels and the ristretto255 kernels the proofs use must
   have launched during phases 8-10 (the proof path, counts from 0, run
   from empty generator and handle caches: the proofs derive G and Q);
12. MSMs above 2^20 (the large-n path, counts from 0, from empty handle
   caches): (a) the streamed query at 2^20 reproduces the pinned digest;
   (b) ristretto255 at 2^21 through the commitment entry (one 32-byte
   column from seed 6) equals the handle path's commitments over the two
   halves added, and a 2^21 handle's query; (c) ristretto255 at 2^24 (the
   next column of seed 6): w = 8 equals w = 4, cold and warm times and the
   split between upload, chunk builds, lookups, reduces, combine and
   encode; (d) three signed outputs at n = 2^20 + 3 (a short last chunk)
   equal the lifted handle's; (e) bn254 G1 at 2^22, Grumpkin and bls12-381
   G1 at 2^20 + 3 against the oracle's collapsed sums; (f) a fresh 4096-point
   set builds its handle on its first commitment and reuses it on the
   second, with the same result;
   (g) the IPA at 2^21 (G streamed) verifies, not with a flipped L byte;
13. the streamed path's kernels against their plain versions at its shapes
   (``build_cached_table`` and the cached ``ed_lookup_msm`` on a 2^18-point
   chunk of (c), ``tree_reduce_lanes`` on the partials of that lookup and of
   each Weierstrass curve's first chunk), and every one of them, and every
   instantiation of the templated ones (the ladder's too), must have
   launched in phase 12; each curve's ``w_build_table``, ``w_lookup_msm``
   and ``w_doubling_combine`` against plain on its first chunk of (e);
14. handle files, packed and vlen queries and the generator disk cache
   (counts from 0, also by element count; the cache, off by default, in a
   fresh directory under ``build/`` for (iv) alone): (i) the ristretto255 2^20 handle written in the
   reference's raw format (4.0 GB) and read back reproduces the pinned
   digest, the bn254 G1 2^20 one (2.1 GB) the oracle's collapsed sum; (ii)
   npz round trips at 2^16 (the ristretto255 write one ``ed_niels_points``
   launch a chunk, no ``fmul`` or ``finvert`` launch) and w = 16 raw files
   of 64 generators re-windowed to 8, on all four curves; (iii) packed and vlen queries at
   2^20 with Proof-of-SQL's widths [1, 8, 16, 32, 64, 128, 256] on the
   handles read back in (i): each output equals the fixed MSM of its own
   scalars (bn254 G1: and the oracle); every Weierstrass raw write makes one
   ``w_affine`` launch a chunk, no ``mont_mul_ew`` launch and no plain
   field inversion; every ristretto255 raw write one ``ed_file_rows``
   launch a chunk, every raw read one ``ed_file_entries`` launch, the npz
   read one ``ed_to_niels`` launch, none of them an ``fmul`` or ``finvert``
   launch; (iv) 2^20 generators derived and
   saved (one ``ed_affine`` launch, no ``fmul`` or ``finvert``), then loaded
   with the in-memory cache cleared (the same points; one
   ``ed_from_affine_rows`` launch on the file's uint16 rows, no ``fmul``;
   the load split afterwards into host, copy and kernel), and a
   cold 2^20 commitment over them (the pinned digest); a legacy extended
   file of 2^16 of them loaded (one ``ed_affine`` launch, no ``fmul`` or
   ``finvert``). Every file is deleted once read, the directory at exit;
15. ``fmul``, ``finvert`` and ``mont_mul_ew`` in the two Weierstrass base
   fields against their plain versions at every element count phase 14
   launched them at, ``fmul`` and ``fsq`` (on no path) at a table
   conversion's chunk of 2^22 entries, ``finvert`` (a batch inversion) at
   ``FINVERT_COUNTS`` (a legacy extended file's 2^16, a cache save's 2^20)
   on every element, zeros, p, 2p and non-canonical limbs among them
   (``finvert_operands``); ``w_affine`` at
   every (curve, entries) phase 14 launched it at and at a 2^22-entry chunk
   of each Weierstrass curve, against its plain version on every row
   (tolerance 0 on the file's words); ``ed_to_niels``, ``ed_file_rows``,
   ``ed_file_entries``, ``ed_niels_points`` and ``ed_affine`` at every
   element count phase 14 launched them at, against their plain versions on
   every entry (tolerance 0 on the words and canonical limbs);
   ``ed_from_affine_rows`` at every count phase 14 launched it at and 2^20,
   against its plain version on every generator (tolerance 0 on canonical
   limbs); ``ed_from_affine_rows``, ``w_affine`` in each curve, the five
   conversions and both base-field instantiations of ``mont_mul_ew`` must
   have launched in phase 14 (``finvert`` and ``fmul`` run on no path: the
   cache's save and legacy load are one ``ed_affine`` launch, its load one
   ``ed_from_affine_rows`` launch);
16. the bucket engine (``BLITZAR_TPU_TORCH_MSM_ENGINE=bucket`` set for this
   phase alone; counts from 0, empty handle caches): the pinned ristretto255
   digests at 2^16, 2^20 (cold, warm, split into sort, gather, slab reduce,
   window sums and Horner) and 100000 x 10; a signed 8-byte 2^20 column and a
   skewed 2^16 column (one scalar everywhere: many rounds) against the
   default engine; bn254 G1 at 2^16 against the oracle's collapsed sum;
   each commitment's combine must be one ``ed_window_sums`` or
   ``w_window_sums`` launch and one ``ed_horner`` or ``w_horner`` launch and
   nothing else (no ``ed_add``, ``wadd`` or ``tree_reduce_lanes``),
   ``ed_double`` and ``wdouble`` must not launch on the path, and
   ``tree_reduce_lanes`` (the slabs) and ``ed_add`` (the skewed column's
   round adds) must;
17. the few-row partition query (counts from 0, empty handle caches): 1-byte
   and 8-byte counter columns over 2^20 canonical generators through the
   default commitment entry equal the same commitment through
   ``ed_lookup_msm`` on the same handle; a w = 4 2^20 handle's 32-byte
   query gives the pinned digest both ways; n = 2^10 with a 1-byte column;
   each few-row query and its ``ed_lookup_msm`` counterpart timed (median
   of 5); each 2^20 query (1- and 8-byte, w = 4) must be one
   ``fewrow_niels`` launch and gather no entry (``entry_gathers``), the
   2^10 one gathers its 128-group chunk and launches ``niels_add``;
18. ``ed_double`` (one output and ten; on no path since the Horner is one
   launch) and ``niels_add`` against their plain versions at the shapes of
   phases 16 and 17, ``fewrow_niels`` at every (outputs, n, bytes, w,
   signs, chunk groups) the few-row and files paths launched it at
   (tolerance 0 on table chunks spread over each query), timed, bounded,
   launches x (time - bound) summed over the shapes; ``ed_horner`` and
   ``w_horner`` at every (outputs, windows) phase 16 launched them at,
   limb for limb their plain versions in the kernel's segments, timed and
   bounded; ``ed_window_sums`` and ``w_window_sums`` at every (curve, rows)
   phase 16 launched them at, the same points as their plain versions (the
   reverse scan and tree), timed and bounded;
19. ``tree_reduce_lanes`` at every (curve, size, cols) the paths of phases
   3-17 launched it at (counted by path as those phases ran, the bucket and
   few-row paths inside their main-path calls alone): timed, bounded and
   held against its plain version as points on up to 64 columns of each,
   and launches x (time - bound) summed over the shapes, each beside the
   kernel's time there before its redesign (a constant, not this run's)
   (``tree_reduce_lanes_by_shape`` in ``chiprun_out/chip_smoke.json``).
   ``ed_lookup_msm``'s and ``tree_reduce_lanes``'s ptxas registers, stack
   frames and spills go to ``ptxas_lookup_and_reduce``, their readings
   before their redesign (constants) beside this run's to
   ``earlier_lookup_reduce_ms``; ``w_lookup_msm``'s and
   ``w_doubling_combine``'s to ``ptxas_weierstrass_query`` and, beside the
   lookup's and the 510-launch ladder's earlier readings,
   ``earlier_w_query_ms``; the two ladders' to ``ptxas_ladders`` and
   ``w_build_table``'s (no spill allowed) to ``ptxas_table_builds``, their
   times by shape beside their readings before their redesign around
   ``csrc/table_build.cuh``'s lane schedule and ``csrc/ladder.cuh``
   (constants) to ``earlier_build_ladder_ms``; none of it is in the kernels
   line;
20. ``w_build_table`` (by curve, groups and w), ``doubling_combine`` (by
   outputs and bits), ``mont_sum_round`` (by field, round size, degree,
   MLEs and products), ``ed_add`` (by pairs, q negated or not) and
   ``wadd`` (by curve and pairs, both ways; tolerance 0 on canonical
   limbs) at every shape the paths of phases 3-17 launched
   them at (counted as phase 19 counts the tree reduce): timed, bounded,
   held against their plain versions, and launches x (time - bound)
   summed over the shapes (``kernels_by_shape``); then every kernel's
   launches x (time - bound) on its paths, largest first (``ranking``:
   per shape where phases 15, 18, 19, 20 and 21 time them, else at the
   headline shape);
21. ``ristretto_encode`` and ``ristretto_decode`` (the ristretto255 codec)
   at 1, 2, 40 and 2^16 points and at every count the paths of phases 3-17
   launched them at: held against their plain versions (``curves/
   ristretto.py``; bytes equal, valid flags equal, valid slots equal as
   canonical points), the decode on encodings of sums of generators, the
   identity first, with every fifth from the second on replaced by an
   invalid one (s >= p, odd s, bit 255 set, no square root, negative t, y =
   0, all ones, in turn), timed, bounded, launches x (time - bound) summed
   over the counts; ``ristretto.cu``'s ptxas report (no spill) goes to
   ``ptxas_codec``.

The last three lines are ``{"kernels": [...]}`` (per kernel: launches on
its path, time, plain time, bound, error), the card as ``nvidia-smi`` names
it, and ``{"ok": true, "device": {...}}``. Details
also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import heapq
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# the outputs of the ristretto255 ladders the paths launch (one column,
# an IPA round's L and R, the packed query's seven widths, 100000 x 10)
LADDER_OUTPUTS = (1, 2, 7, 10)
MULS_ELLIGATOR = 288
MULS_ELLIGATOR_FORM = 2 * MULS_ELLIGATOR + MULS_ADD
# the least a niels table needs, per group of w points and V = 2^w entries:
# V - 1 - w unified adds (the doubling concatenation; one-point entries are
# copies), one batched inversion of the V - 1 nonzero Z (Montgomery's trick:
# 3 multiplies per element and one inversion), and per entry x = X/Z, y =
# Y/Z, x*y and 2d*x*y (4 multiplies)
MULS_BATCH_INVERT_PER_ELEMENT = 3
MULS_NIELS_FROM_ZINV = 4


# 32-bit multiplies per Montgomery multiply of csrc/mont.cuh for K words
# (CIOS: K^2 word products a_j b_i and K^2 u m_j, lo and hi each, plus K
# multiplies for u); field multiplies per complete Weierstrass add and
# double of csrc/weierstrass.cuh: its multiplies by the constant 3b (two in
# an add, one in a doubling) are a few modular additions (mul_b3), not
# multiplies, so the function's least work counts 12 and 8
IMAD_PER_MONT_MUL = {8: 4 * 8 * 8 + 8, 12: 4 * 12 * 12 + 12}
MULS_WADD = 12
MULS_WDOUBLE = 8
# the oracle points a Weierstrass full-width run tiles to n (a prime period)
W_PERIOD = 521
W_KERNELS = ("w_build_table", "w_lookup_msm", "wadd", "wdouble", "w_doubling_combine")
# Earlier readings, not measured by this run: the Weierstrass query's two
# device stages before their redesign, at bn254 G1 2^20 with one 32-byte
# counter column (w_lookup_msm's device_ms; the ladder of one output's 256
# bit-row products, then 255 wdouble and 255 wadd launches issued from
# Python, and of seven, the packed query's shape, cuda_ms back to back),
# from kernel_ab.py's first run of the parent tree in the chip call that
# compared the trees, on an NVIDIA H100 80GB HBM3 at 700.00 W. Written
# beside this run's times under their own key of chiprun_out/chip_smoke.json,
# never into the kernels line.
EARLIER_W_QUERY_MS = {"w_lookup_msm": 11.879648208618164, "ladder_1x256": 23.942239379882814,
                      "ladder_7x256": 22.524960327148438}
W_QUERY_SOURCES = {"w_lookup_msm": "w_lookup_msm.cu", "w_doubling_combine": "w_doubling_combine.cu"}


def muls_niels_table_group(w: int) -> int:
    entries = (1 << w) - 1
    return ((entries - w) * MULS_ADD + entries * MULS_BATCH_INVERT_PER_ELEMENT + MULS_INVERT
            + entries * MULS_NIELS_FROM_ZINV)

# An earlier reading, not measured by this run: the table builds' device
# times before their redesign around csrc/table_build.cuh, this script's
# readings of the earlier kernels (build_niels_table at 2^20,
# build_cached_table on a 2^18-point chunk, w = 8) on an NVIDIA H100 80GB
# HBM3 at 700.00 W. Written beside this run's times under its own key of
# chiprun_out/chip_smoke.json, never into the kernels line.
EARLIER_TABLE_BUILD_MS = {"build_niels_table": 322.45062255859375, "build_cached_table": 4.6976637840271}
TABLE_BUILD_SOURCES = {"build_niels_table": "build_niels_table.cu", "build_cached_table": "build_cached_table.cu",
                       "w_build_table": "w_build_table.cu"}
# The same for w_build_table before it took table_build.cuh's lane schedule
# and for the ristretto255 ladder before it took ladder.cuh's segments (one
# thread an output), with build_cached_table and the Weierstrass ladder, which
# share their code now: kernel_ab.py's first run of the parent tree (sections
# tables and ladders), run in turns with this tree on one NVIDIA H100 80GB
# HBM3 at 700.00 W; keys as this run's records name the shapes
# (the earlier ristretto255 ladder ran blitzar_tpu's one-segment order; the
# Weierstrass ladder was read on the oracle's points tiled).
EARLIER_BUILD_LADDER_MS = {
    "w_build_table/bn254_g1/2^20": 27.39708709716797, "w_build_table/bls12_381_g1/2^18": 20.50009536743164,
    "w_build_table/bn254_g1/2^18": 6.624351978302002, "w_build_table/grumpkin/2^18": 7.438208103179932,
    "build_cached_table/2^18": 1.6424000263214111, "doubling_combine/1x256": 1.7111839652061462,
    "doubling_combine/2x256": 1.7111520171165466, "doubling_combine/7x256": 1.712112009525299,
    "doubling_combine/10x256": 1.7283200025558472, "w_doubling_combine/bn254_g1/1x256": 1.931327998638153,
}
LADDER_SOURCES = {"doubling_combine": "doubling_combine.cu", "w_doubling_combine": "w_doubling_combine.cu"}
# The same for the lookup and its reduce before their redesign around
# csrc/lookup.cuh and the coalesced tree_reduce.cuh: the parent tree's own
# chip_smoke.py in the chip call that compared the trees (its first run), on
# an NVIDIA H100 80GB HBM3 at 700.00 W (ed_lookup_msm at 2^20, the cached
# one on a 2^18-point chunk, tree_reduce_lanes at a lookup's (1024, 256)
# partials then).
EARLIER_LOOKUP_REDUCE_MS = {
    "ed_lookup_msm": 2.992095947265625, "ed_lookup_msm_cached": 1.3291200399398804,
    "tree_reduce_lanes/ristretto255": 0.17265599966049194, "tree_reduce_lanes/bls12_381_g1": 0.9529920220375061,
    "tree_reduce_lanes/bn254_g1": 0.45737600326538086, "tree_reduce_lanes/grumpkin": 0.4527360051870346,
}
# tree_reduce_lanes before its redesign at every (curve, size, cols) the
# paths launch it at: kernel_ab.py's first run of the parent tree, in the
# chip call that compared the trees kernel by kernel (NVIDIA H100 80GB HBM3,
# 700.00 W). Phase 19 writes each beside this run's time.
EARLIER_TREE_MS = {
    "ristretto255/1x8": 0.0060800001956522465, "ristretto255/1x96": 0.0060800001956522465,
    "ristretto255/1x256": 0.006111999973654747, "ristretto255/1x384": 0.006335999816656113,
    "ristretto255/1x512": 0.006624000146985054, "ristretto255/1x768": 0.0071680000983178616,
    "ristretto255/2x334375": 2.7349441051483154, "ristretto255/2x696875": 5.750944137573242,
    "ristretto255/3x256": 0.015584000386297703, "ristretto255/3x262146": 2.9700798988342285,
    "ristretto255/3x917511": 10.401503562927246, "ristretto255/4x256": 0.01568000018596649,
    "ristretto255/4x512": 0.01635199971497059, "ristretto255/4x768": 0.019872000440955162,
    "ristretto255/5x384": 0.02054399996995926, "ristretto255/8x256": 0.02054399996995926,
    "ristretto255/8x512": 0.021503999829292297, "ristretto255/64x8": 0.02956799976527691,
    "ristretto255/64x32": 0.03542400151491165, "ristretto255/64x256": 0.04182400181889534,
    "ristretto255/128x1": 0.0326399989426136, "ristretto255/128x8": 0.034304000437259674,
    "ristretto255/128x11": 0.03561599925160408, "ristretto255/128x16": 0.03667199984192848,
    "ristretto255/128x21": 0.03731200098991394, "ristretto255/255x8": 0.03920000046491623,
    "ristretto255/255x32": 0.049536000937223434, "ristretto255/255x320": 0.0944959968328476,
    "ristretto255/256x6": 0.038656000047922134, "ristretto255/256x10": 0.040832001715898514,
    "ristretto255/263x512": 0.15936000645160675, "ristretto255/264x512": 0.15782399475574493,
    "ristretto255/349x384": 0.12787200510501862, "ristretto255/368x2550": 0.6296640038490295,
    "ristretto255/368x5610": 1.2837120294570923, "ristretto255/512x256": 0.10412800312042236,
    "ristretto255/520x1275": 0.46540799736976624, "ristretto255/520x3825": 1.2268480062484741,
    "ristretto255/521x256": 0.12345600128173828, "ristretto255/527x256": 0.11961600184440613,
    "ristretto255/528x256": 0.1223360002040863, "ristretto255/1024x2048": 1.2483839988708496,
    "ristretto255/1049x128": 0.10860799998044968, "ristretto255/3125x107": 0.23545600473880768,
    "ristretto255/3125x223": 0.44863998889923096, "ristretto255/4504x255": 0.8634560108184814,
    "ristretto255/43691x6": 1.8952000141143799, "ristretto255/43691x21": 2.102976083755493,
    "bls12_381_g1/1x256": 0.006047999951988459, "bls12_381_g1/1x1536": 0.009279999881982803,
    "bls12_381_g1/5x256": 0.17526400089263916, "bls12_381_g1/8x512": 0.17900800704956055,
    "bls12_381_g1/13x1536": 0.47523200511932373, "bls12_381_g1/1024x256": 0.9653440117835999,
    "bn254_g1/1x1536": 0.007391999941319227, "bn254_g1/8x512": 0.08710400015115738,
    "bn254_g1/13x1536": 0.122079998254776, "bn254_g1/16x256": 0.11270400136709213,
    "bn254_g1/128x1": 0.1794240027666092, "bn254_g1/128x8": 0.1764480024576187,
    "bn254_g1/128x11": 0.18380799889564514, "bn254_g1/128x16": 0.18902400135993958,
    "bn254_g1/128x21": 0.1908160001039505, "bn254_g1/255x32": 0.21404799818992615,
    "bn254_g1/368x765": 0.5917119979858398, "bn254_g1/368x7395": 5.646143913269043,
    "bn254_g1/512x512": 0.6346880197525024, "bn254_g1/1024x128": 0.3968319892883301,
    "bn254_g1/1024x256": 0.4491199851036072, "bn254_g1/1024x1024": 1.449023962020874,
    "bn254_g1/1024x1408": 1.9364160299301147, "bn254_g1/1024x2048": 2.890144109725952,
    "bn254_g1/1024x2688": 3.439903974533081, "bn254_g1/2048x128": 0.6742720007896423,
    "grumpkin/1x256": 0.005919999908655882, "grumpkin/1x1536": 0.007424000184983015,
    "grumpkin/5x256": 0.08454400300979614, "grumpkin/8x512": 0.08560000360012054,
    "grumpkin/13x1536": 0.1191679984331131, "grumpkin/1024x256": 0.4463360011577606,
}
LOOKUP_REDUCE_SOURCES = {"ed_lookup_msm": "ed_lookup_msm.cu", "tree_reduce_lanes": "tree_reduce_lanes.cu"}


def ptxas_report(log_text: str, source: str) -> list:
    """Registers, stack frame and spills of each function compiled from
    ``source`` (kernel instantiations and the device functions they call),
    read from the build's ``ptxas -v`` log."""
    funcs: dict = {}
    mine, entry, props = False, None, None
    for line in log_text.splitlines():
        if line.startswith("== "):
            mine = line[3:].strip() == source
        elif not mine:
            continue
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
            funcs.setdefault(entry, {"function": entry, "entry": True})
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
            funcs.setdefault(props, {"function": props, "entry": False})
        elif "spill stores" in line and props is not None:
            parts = line.replace(",", "").split()
            funcs[props].update(stack_frame=int(parts[0]), spill_stores=int(parts[parts.index("spill") - 2]),
                                spill_loads=int(parts[parts.index("loads") - 3]))
        elif "Used" in line and "registers" in line and entry is not None:
            parts = line.replace(",", "").split()
            funcs[entry]["registers"] = int(parts[parts.index("registers") - 1])
    return list(funcs.values())


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
    """Mean time of fn over reps runs launched back to back after one
    warm-up, between two CUDA events: the host's launch time counts wherever
    it is longer than the device's work (the plain versions, the ladder)."""
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


def device_ms(torch, fn, reps: int = 3) -> float:
    """Median device time of one fn() over reps, after one warm-up: a
    kernel's ``ms``. The reps queue behind a sleep kernel, each between its
    own pair of CUDA events, so the host's time to make a launch (argument
    checks, the output's allocation, the ctypes call) falls outside every
    pair. The sleep must still be running once the host has queued the last
    pair; else it is made longer and the reading taken again."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25  # ~17 ms at the H100's 1.98 GHz
    for _ in range(4):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        for start, stop in pairs:
            start.record()
            fn()
            stop.record()
        queued = not slept.query()
        torch.cuda.synchronize()
        if queued:
            return float(np.median([start.elapsed_time(stop) for start, stop in pairs]))
        cycles *= 4
    raise Failure("device_ms: the launches could not be queued behind the sleep")


def bound(bytes_moved: float, imads: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = imads / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_record(results, name, replaces, source, ms, plain_ms, err, bytes_moved, imads, plain_fraction=1.0,
                  compared="canonical limbs"):
    """One kernel's entry of the {"kernels": [...]} line; the kernel must
    equal its plain version exactly (``err`` is the largest limb difference,
    or for ``compared="points"`` the number of unequal points)."""
    b_ms, b_by = bound(bytes_moved, imads)
    results[name] = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "plain_fraction": plain_fraction,
    }
    check(err == 0, f"{name}: kernel equals plain, tolerance 0 on {compared} (max abs err {err}; "
                    f"{ms:.3f} ms vs plain {plain_ms:.1f} ms)")


def table_build_ptxas(log_text: str, built_here: bool) -> dict:
    """The table builds' registers and spills, which must be none, from
    the ptxas log of the library this process loaded (``built_here``: the
    log was written by this run's build, not found beside a library built
    earlier from the same sources and flags)."""
    out = {"built_in_this_run": built_here}
    for name, source in TABLE_BUILD_SOURCES.items():
        funcs = out[name] = ptxas_report(log_text, source)
        for f in funcs:
            print(f"    {source} {f['function']}: {f.get('registers', '-')} registers, {f.get('stack_frame')} bytes "
                  f"stack frame, {f.get('spill_stores')} bytes spill stores, {f.get('spill_loads')} bytes spill loads")
        check(any(f["entry"] for f in funcs) and all(
                  f.get("spill_stores") == 0 and f.get("spill_loads") == 0 for f in funcs),
              f"{name}: no spills in the kernel or its device functions")
    return out


def affine_sum_ptxas(log_text: str, built_here: bool) -> dict:
    """w_affine's and mont_sum_round's registers, stack frames and spills:
    no spill in either, and no stack frame in mont_sum_round (each degree
    1-5 in both fields), from the ptxas log as :func:`table_build_ptxas`
    reads it."""
    out = {"built_in_this_run": built_here}
    for name, source in (("w_affine", "w_affine.cu"), ("mont_sum_round", "mont_sum_round.cu")):
        funcs = out[name] = ptxas_report(log_text, source)
        for f in funcs:
            print(f"    {source} {f['function']}: {f.get('registers', '-')} registers, {f.get('stack_frame')} bytes "
                  f"stack frame, {f.get('spill_stores')} bytes spill stores, {f.get('spill_loads')} bytes spill loads")
        entries = [f for f in funcs if f["entry"]]
        check(entries and all(f.get("spill_stores") == 0 and f.get("spill_loads") == 0 for f in funcs),
              f"{name}: no spills in the kernel or its device functions")
        if name == "mont_sum_round":
            check(len(entries) >= 10 and all(f.get("stack_frame") == 0 for f in entries),
                  f"mont_sum_round: every instantiation (degrees 1-5, two fields), no stack frame in any")
    return out


# the kernels of the table conversions and the bucket engine's window sums
# and Horner: no spill allowed
CONVERSION_HORNER_SOURCES = {
    "ed_to_niels/ed_file_rows/ed_file_entries/ed_niels_points/ed_affine": "ed_convert.cu",
    "ed_horner": "ed_horner.cu", "w_horner": "w_horner.cu", "ed_window_sums/w_window_sums": "window_sums.cu"}


# the few-row query's column sums and the batch finvert: no spill allowed
FEWROW_FINVERT_SOURCES = {"fewrow_niels": "fewrow_niels.cu", "finvert": "finvert.cu"}
# the ristretto255 codec: no spill allowed
CODEC_SOURCES = {"ristretto_encode/ristretto_decode": "ristretto.cu"}
ROWS_ADDS_SOURCES = {"mont_from_rows": "mont_rows.cu", "ed_add": "ed_add.cu", "niels_add": "niels_add.cu"}
WADD_SOURCES = {"wadd": "wadd.cu"}


def conversion_horner_ptxas(log_text: str, built_here: bool, sources: dict = CONVERSION_HORNER_SOURCES) -> dict:
    """The registers, stack frames and spills (none allowed) of the kernels
    of ``sources`` (the conversions and the Horner kernels by default),
    from the ptxas log as :func:`table_build_ptxas` reads it."""
    out = {"built_in_this_run": built_here}
    for name, source in sources.items():
        funcs = out[name] = ptxas_report(log_text, source)
        for f in funcs:
            print(f"    {source} {f['function']}: {f.get('registers', '-')} registers, {f.get('stack_frame')} bytes "
                  f"stack frame, {f.get('spill_stores')} bytes spill stores, {f.get('spill_loads')} bytes spill loads")
        check(any(f["entry"] for f in funcs) and all(
                  f.get("spill_stores") == 0 and f.get("spill_loads") == 0 for f in funcs),
              f"{name}: no spills in the kernels or their device functions")
    return out


def lookup_reduce_ptxas(log_text: str, built_here: bool) -> dict:
    """The lookup's and the tree reduce's registers, stack frames and
    spills (recorded, not required to be none: PERF.md states the ones that
    stay), from the ptxas log as :func:`table_build_ptxas` reads it."""
    out = {"built_in_this_run": built_here}
    for name, source in LOOKUP_REDUCE_SOURCES.items():
        out[name] = ptxas_report(log_text, source)
        check(any(f["entry"] for f in out[name]), f"{name}: ptxas reported its kernels")
    return out


def earlier_lookup_reduce_times(results: dict) -> dict:
    """This run's lookup and tree-reduce times beside the earlier readings."""
    out = {"note": "earlier_ms: readings before the redesign around csrc/lookup.cuh and the coalesced "
                   "tree_reduce.cuh, not measured by this run; the tree reduce then ran at (1024, 256)"}
    for key, was in EARLIER_LOOKUP_REDUCE_MS.items():
        name, _, curve = key.partition("/")
        rec = results[name] if not curve else results[name][curve if curve != "ristretto255" else "ristretto255_1024x256"]
        out[key] = {"ms": rec["ms"], "shape": rec.get("shape"), "earlier_ms": was}
        print(f"    {key}: {rec['ms']:.4f} ms in this run (earlier reading, not this run: {was:.4f} ms)")
    path = results["tree_reduce_lanes"]
    out["tree_reduce_lanes/ristretto255_path_shape"] = {"ms": path["ms"], "shape": path["shape"]}
    return out


def w_query_ptxas(log_text: str, built_here: bool) -> dict:
    """w_lookup_msm's and w_doubling_combine's registers, stack frames and
    spills per curve instantiation (recorded; PERF.md states any spill), from
    the ptxas log as :func:`table_build_ptxas` reads it."""
    out = {"built_in_this_run": built_here}
    for name, source in W_QUERY_SOURCES.items():
        out[name] = ptxas_report(log_text, source)
        check(any(f["entry"] for f in out[name]), f"{name}: ptxas reported its kernels")
    return out


def earlier_w_query_times(results: dict) -> dict:
    """This run's Weierstrass lookup and ladder times beside the earlier
    readings (constants)."""
    ladder = results["w_doubling_combine"]
    now = {"w_lookup_msm": results["w_lookup_msm"]["ms"], "ladder_1x256": ladder["cuda_ms"],
           "ladder_7x256": ladder["cuda_ms_7_outputs"]}
    out = {"note": "earlier_ms: readings before the redesign (kernel_ab.py on the parent tree), not measured by "
                   "this run; the ladders as cuda_ms, back to back, host issue included"}
    for key, was in EARLIER_W_QUERY_MS.items():
        out[key] = {"ms": now[key], "earlier_ms": was}
        print(f"    {key}: {now[key]:.4f} ms in this run (earlier reading, not this run: {was:.4f} ms)")
    return out


LADDER_KERNELS = ("w_doubling_combine", "wadd", "wdouble")


def check_one_ladder(before: dict, what: str, queries: int = 1) -> None:
    """The Weierstrass commitment(s) run since ``before`` (a copy of the
    launch counts) ran their ladders as ``queries`` launches of
    w_doubling_combine, and no wadd or wdouble (an unsigned query)."""
    from blitzar_tpu_torch.ops import cuda_point as cp

    got = {k: cp.LAUNCHES[k] - before[k] for k in LADDER_KERNELS}
    check(got == {"w_doubling_combine": queries, "wadd": 0, "wdouble": 0},
          f"{what}: the ladder ran as {queries} w_doubling_combine launch(es), no wadd or wdouble ({got})")


def ladder_ptxas(log_text: str, built_here: bool) -> dict:
    """The two ladders' registers, stack frames and spills per instantiation
    (recorded; PERF.md states any spill), from the ptxas log as
    :func:`table_build_ptxas` reads it."""
    out = {"built_in_this_run": built_here}
    for name, source in LADDER_SOURCES.items():
        out[name] = ptxas_report(log_text, source)
        check(any(f["entry"] for f in out[name]), f"{name}: ptxas reported its kernels")
    return out


def build_ladder_times(results: dict) -> dict:
    """This run's w_build_table, build_cached_table and ladder times by
    shape, beside the earlier readings (constants)."""
    ed_ladder = results["doubling_combine"]
    now = {"w_build_table/bn254_g1/2^20": results["w_build_table"]["ms"],
           "build_cached_table/2^18": results["build_cached_table"]["ms"],
           "w_doubling_combine/bn254_g1/1x256": results["w_doubling_combine"]["ms"]}
    for name, rec in results["w_build_table"]["by_curve_2^18_chunk"].items():
        now[f"w_build_table/{name}/2^18"] = rec["ms"]
    for outputs, rec in ed_ladder["by_outputs"].items():
        now[f"doubling_combine/{outputs}x256"] = rec["ms"]
        now[f"doubling_combine/{outputs}x256/one_segment"] = rec["ms_one_segment"]
    out = {"note": "earlier_ms: readings before the redesign (kernel_ab.py on the parent tree), not measured by "
                   "this run"}
    for key, ms in now.items():
        was = EARLIER_BUILD_LADDER_MS.get(key)
        out[key] = {"ms": ms, "earlier_ms": was}
        print(f"    {key}: {ms:.4f} ms in this run (earlier reading, not this run: {was} ms)")
    return out


def earlier_add_times(results: dict) -> dict:
    """This run's ed_add and niels_add times beside their readings at one
    thread a pair (constants)."""
    add, shapes = results["ed_add"], results["ed_add"]["at_shapes"]
    now = {"ed_add/512": add["ms"], "ed_add/32x255": shapes["32x255"]["ms"], "ed_add/320x255": shapes["320x255"]["ms"],
           "niels_add/64x8": results["niels_add"]["ms"]}
    out = {"note": "earlier_ms: readings at one thread a pair, before the four-lane design (kernel_ab.py on the "
                   "parent tree), not measured by this run"}
    for key, was in EARLIER_ADD_MS.items():
        out[key] = {"ms": now[key], "earlier_ms": was}
        print(f"    {key}: {now[key]:.4f} ms in this run (earlier reading, not this run: {was} ms)")
    return out


def earlier_table_build_times(results: dict) -> dict:
    """This run's table-build times beside the earlier readings."""
    out = {"note": "earlier_ms: readings before the redesign around csrc/table_build.cuh, not measured by this run"}
    for name, was in EARLIER_TABLE_BUILD_MS.items():
        out[name] = {"ms": results[name]["ms"], "earlier_ms": was}
        print(f"    {name}: {results[name]['ms']:.3f} ms in this run (earlier reading, not this run: {was:.3f} ms)")
    return out


def spread_indices(torch, dev, count: int, total: int):
    """count indices evenly over range(total), the first and last included"""
    return torch.linspace(0, total - 1, count, dtype=torch.float64, device=dev).round().long()


def point_err(a, b, canonical=lambda t: t) -> int:
    """Largest limb difference between two point batches, coordinate by
    coordinate, after ``canonical``."""
    return max(int((canonical(x).long() - canonical(y).long()).abs().max()) for x, y in zip(a, b))


def lookup_work(torch, scalars, w: int, groups: int) -> tuple[int, int]:
    """What a lookup query's data make it do: its nonzero indices (one add
    each) and the distinct nonzero table entries they touch (each read once)."""
    from blitzar_tpu_torch.ops import cuda_point as cp

    idx = cp.query_index(scalars, None, w).long()
    touched = torch.zeros((groups, 1 << w), dtype=torch.bool, device=idx.device)
    touched[torch.arange(groups, device=idx.device)[None, :].expand_as(idx), idx] = True
    return int((idx != 0).sum()), int(touched[:, 1:].sum())


# ed_add's window-sum shapes (R, 255), and the one-thread-a-pair adds'
# times before the four-lane design (constants: this script's readings of
# that design on an NVIDIA H100 80GB HBM3, 700.00 W; not measured by this
# run, so reported beside this run's under earlier_add_ms, not in the
# kernels line)
ED_ADD_ROWS = (32, 320)
EARLIER_ADD_MS = {"ed_add/512": 0.010816000401973724, "ed_add/32x255": [0.0112, 0.0120],
                  "ed_add/320x255": [0.0326, 0.0361], "niels_add/64x8": 0.010111999697983265}


def phase_kernels(torch, dev) -> dict:
    """Each kernel at the shapes of one 2^20 commitment with 32-byte counter
    scalars, against its plain version."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    n = 1 << 20
    w = 8
    groups = n // w
    results = {}
    record = functools.partial(kernel_record, results)
    spread = functools.partial(spread_indices, torch, dev)
    ed_err = functools.partial(point_err, canonical=F.canonicalize)

    # elligator_form: all n generators; plain on 2^16 of them spread over all n
    # (its temporaries at 2^20 are ~2 GB per multiply)
    r0, r1 = generators._xorshift_limbs(torch.arange(n, device=dev))
    ms = device_ms(torch, lambda: cp.elligator_form(r0, r1))
    gens = cp.elligator_form(r0, r1)
    m = min(n, 1 << 16)
    sample = spread(m, n)
    s0, s1 = r0[:, sample], r1[:, sample]
    plain_ms = cuda_ms(torch, lambda: cp.elligator_form_plain(s0, s1), reps=1)
    plain = cp.elligator_form_plain(s0, s1)
    err = ed_err(ed.index_batch(gens, sample), plain)
    record("elligator_form", "blitzar_tpu/ops/pallas_point.py:212", "blitzar_tpu_torch/csrc/elligator_form.cu",
           ms, plain_ms, err, n * (2 * 64 + 4 * 64), n * MULS_ELLIGATOR_FORM * IMAD_PER_FIELD_MUL, m / n)

    # build_niels_table: all groups; plain on 512 groups spread over all of them
    ms = device_ms(torch, lambda: cp.build_niels_table(gens, w), reps=1)
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
    ms = device_ms(torch, lambda: cp.ed_lookup_msm(table, scalars, None, w))
    partials = cp.ed_lookup_msm(table, scalars, None, w)
    plain_ms = cuda_ms(torch, lambda: cp.ed_lookup_msm_plain(table, scalars, None, w), reps=1)
    plain = cp.ed_lookup_msm_plain(table, scalars, None, w)
    err = ed_err(partials, plain)
    # the data decide the work: madds for the nonzero indices, table bytes
    # for the distinct nonzero entries they touch
    nonzero, entries = lookup_work(torch, scalars, w, groups)
    record("ed_lookup_msm", "blitzar_tpu/ops/pallas_point.py:533", "blitzar_tpu_torch/csrc/ed_lookup_msm.cu",
           ms, plain_ms, err, scalars.numel() + entries * 96 + partials.x.numel() * 16,
           nonzero * MULS_MADD * IMAD_PER_FIELD_MUL)
    results["ed_lookup_msm"]["nonzero_lookups"] = nonzero
    results["ed_lookup_msm"]["table_entries_touched"] = entries

    # ed_add: at the IPA query's shape, G's 512 bit-row products plus Q's
    # (here two pairs of rows of partials)
    lo = ed.reshape_batch(ed.index_batch(partials, slice(0, 2)), (512,))
    hi = ed.reshape_batch(ed.index_batch(partials, slice(2, 4)), (512,))
    ms = device_ms(torch, lambda: cp.ed_add(lo, hi), reps=100)
    out = cp.ed_add(lo, hi)
    plain_ms = cuda_ms(torch, lambda: cp.ed_add_plain(lo, hi), reps=1)
    err = ed_err(out, cp.ed_add_plain(lo, hi))
    count = lo.x[0].numel()
    # and reading q negated (the signed Q_pos - Q_neg), and at the window
    # sums' (R, 255) shapes, both ways, generators as the points
    err = max(err, ed_err(cp.ed_add(lo, hi, negate_q=True), cp.ed_add_plain(lo, hi, True)))
    by_shape = {}
    for rows in ED_ADD_ROWS:
        size = rows * 255
        p = ed.reshape_batch(ed.index_batch(gens, slice(0, size)), (rows, 255))
        q = ed.reshape_batch(ed.index_batch(gens, slice(size, 2 * size)), (rows, 255))
        for flag in (False, True):
            err = max(err, ed_err(cp.ed_add(p, q, negate_q=flag), cp.ed_add_plain(p, q, flag)))
            b_ms, _ = bound(size * 3 * 256, size * MULS_ADD * IMAD_PER_FIELD_MUL)
            by_shape[f"{rows}x255" + ("_negate_q" if flag else "")] = {
                "ms": device_ms(torch, lambda: cp.ed_add(p, q, negate_q=flag), reps=50), "bound_ms": b_ms}
    record("ed_add", "blitzar_tpu/ops/pallas_point.py:237", "blitzar_tpu_torch/csrc/ed_add.cu",
           ms, plain_ms, err, count * 3 * 256, count * MULS_ADD * IMAD_PER_FIELD_MUL,
           compared="canonical limbs, q as it is and negated")
    rec = results["ed_add"]
    rec["negate_q_ms"] = device_ms(torch, lambda: cp.ed_add(lo, hi, negate_q=True), reps=100)
    rec["at_shapes"] = by_shape
    # the floor under any launch's device time: a launch that does nothing
    rec["empty_launch_ms"] = device_ms(torch, lambda: torch.cuda._sleep(0), reps=100)

    # doubling_combine: the ladder of the 256 bit-row products of the one
    # output, and of 2, 7 and 10 outputs (an IPA round's L and R, the packed
    # query's Proof-of-SQL widths, the ten columns of 100000 x 10: here the
    # products rotated by 37 bits an output); limb for limb the plain version
    # in the kernel's segments, and the same points as blitzar_tpu's
    # one-segment ladder (the default plain version), which the kernel also
    # runs with seg_bits = nbits, limb for limb
    nbits = 256
    products = ed.reshape_batch(cp.tree_reduce_lanes(partials), (1, nbits))
    seg_bits = cp.ladder_segment_bits(nbits)
    ms = device_ms(torch, lambda: cp.doubling_combine(products), reps=5)
    plain_ms = cuda_ms(torch, lambda: cp.doubling_combine_plain(products), reps=1)
    by_outputs, err, unequal = {}, 0, 0
    for outputs in LADDER_OUTPUTS:
        rows = ed.index_batch(products, (0, (torch.arange(nbits, device=dev)[None]
                                             + 37 * torch.arange(outputs, device=dev)[:, None]) % nbits))
        got = cp.doubling_combine(rows)
        one = cp.doubling_combine_plain(rows)
        err = max(err, ed_err(got, cp.doubling_combine_plain(rows, seg_bits)),
                  ed_err(cp.doubling_combine(rows, seg_bits=nbits), one))
        unequal += int((~ed.points_equal(got, one)).sum())
        b_ms, _ = bound(outputs * (nbits + 1) * 256, outputs * (nbits - 1) * (MULS_DOUBLE + MULS_ADD)
                        * IMAD_PER_FIELD_MUL)
        by_outputs[str(outputs)] = {"ms": device_ms(torch, lambda: cp.doubling_combine(rows), reps=5),
                                    "ms_one_segment": device_ms(torch, lambda: cp.doubling_combine(rows, seg_bits=nbits),
                                                                reps=5),
                                    "bound_ms": b_ms}
    check(unequal == 0, f"doubling_combine at {LADDER_OUTPUTS} outputs: the same points as blitzar_tpu's "
                        f"one-segment ladder")
    record("doubling_combine", "blitzar_tpu/ops/pallas_point.py:982", "blitzar_tpu_torch/csrc/doubling_combine.cu",
           ms, plain_ms, err, (nbits + 1) * 256, (nbits - 1) * (MULS_DOUBLE + MULS_ADD) * IMAD_PER_FIELD_MUL,
           compared="canonical limbs, in the kernel's segments and in one")
    rec = results["doubling_combine"]
    rec["by_outputs"] = by_outputs
    nseg = -(-nbits // seg_bits)
    rec["segment_bits"] = seg_bits
    rec["critical_path_muls"] = ((seg_bits - 1) * (MULS_DOUBLE + MULS_ADD) + seg_bits * (nseg - 1) * MULS_DOUBLE
                                 + (nseg - 1) * MULS_ADD)
    rec["critical_path_muls_one_segment"] = (nbits - 1) * (MULS_DOUBLE + MULS_ADD)
    return results


@functools.lru_cache(maxsize=None)
def oracle_points(curve) -> tuple:
    """The oracle's W_PERIOD points random_points(521, seed=7), derived once
    a curve (in Python integers, about a second each on the host)."""
    return tuple(curve.oracle.random_points(W_PERIOD, seed=7))


def tiled_generators(curve, n: int, dev):
    """The oracle's W_PERIOD points random_points(521, seed=7), tiled to n
    on the card: (points, the oracle points)."""
    import torch

    pts = list(oracle_points(curve))
    base = curve.from_affine_ints(pts, dev)
    return curve.index_batch(base, torch.arange(n, device=dev) % W_PERIOD), pts


def collapsed_scalars(rows: np.ndarray) -> list[int]:
    """sum_{i = j mod W_PERIOD} of the little-endian scalar rows[i], for each
    j < W_PERIOD: then sum_i s_i G_(i mod P) = sum_j S_j G_j. The sums are
    exact (32-bit words summed in uint64), not reduced."""
    n, nbytes = rows.shape
    padded = np.pad(rows, ((0, (-n) % W_PERIOD), (0, (-nbytes) % 4)))
    words = padded.view("<u4").astype(np.uint64)
    sums = words.reshape(-1, W_PERIOD, words.shape[1]).sum(axis=0)
    return [sum(int(v) << (32 * k) for k, v in enumerate(row)) for row in sums]


def w_output_equals(curve, got, o: int, pt) -> bool:
    """Output o of a Weierstrass commitment entry equals the oracle's affine
    point pt (None for the identity): zcash-compressed bytes for bls12-381
    G1, the (x, y, infinity) struct for bn254 G1 and Grumpkin."""
    from blitzar_tpu_torch.refimpl.weierstrass import compress_bls12_381

    if curve.name == "bls12_381_g1":
        return bytes(got[o]) == compress_bls12_381(pt)
    if pt is None:
        return bool(got["infinity"][o] == 1 and not got["x"][o].any() and not got["y"][o].any())
    nb = curve.field.nbytes
    return bool(got["infinity"][o] == 0 and bytes(got["x"][o]) == pt[0].to_bytes(nb, "little")
                and bytes(got["y"][o]) == pt[1].to_bytes(nb, "little"))


def w_build_record(torch, dev, curve, gens, w: int, reps: int = 1, sample_groups: int = 512) -> dict:
    """w_build_table on all of ``gens``: its record (device time, bound,
    the largest limb difference from the plain version on ``sample_groups``
    groups spread over all of them, the last included)."""
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    n = gens.x.shape[1]
    groups = n // w
    ms = device_ms(torch, lambda: cw.w_build_table(curve, gens, w), reps=reps)
    table = cw.w_build_table(curve, gens, w)
    sel = spread_indices(torch, dev, min(groups, sample_groups), groups)
    members = curve.index_batch(gens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    plain_ms = cuda_ms(torch, lambda: cw.w_build_table_plain(curve, members, w), reps=1)
    err = int((table[sel].long() - cw.w_build_table_plain(curve, members, w).long()).abs().max())
    sub: dict = {}
    kernel_record(sub, "w_build_table", "blitzar_tpu/ops/pallas_point.py:806", "blitzar_tpu_torch/csrc/w_build_table.cu",
                  ms, plain_ms, err, n * 3 * curve.nlimbs * 4 + table.numel() * 4,
                  groups * ((1 << w) - 1) * MULS_WADD * IMAD_PER_MONT_MUL[curve.nlimbs // 2], len(sel) / groups,
                  compared=f"{curve.name} canonical limbs, {groups} groups, w = {w}")
    return {**sub["w_build_table"], "groups": groups, "w": w}


def phase_wkernels(torch, dev) -> dict:
    """The five Weierstrass kernels at the shapes of one bn254 G1 2^20
    commitment with 32-byte counter scalars, against their plain versions."""
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    curve = wc.BN254_G1
    n, w = 1 << 20, 8
    groups = n // w
    words = curve.nlimbs // 2
    imad = IMAD_PER_MONT_MUL[words]
    point_bytes = 3 * curve.nlimbs * 4  # a public (X, Y, Z) in int32 limbs
    entry_bytes = 3 * words * 4
    results: dict = {}
    record = functools.partial(kernel_record, results)
    spread = functools.partial(spread_indices, torch, dev)

    gens, _ = tiled_generators(curve, n, dev)

    # w_build_table: all groups; plain on 512 groups spread over all of them
    results["w_build_table"] = w_build_record(torch, dev, curve, gens, w, reps=3)
    table = cw.w_build_table(curve, gens, w)

    # w_lookup_msm: one 32-byte output; plain on 16 of the chunks, spread
    scalars = torch.from_numpy(counter_scalars(n, 32)[None]).to(dev)
    ms = device_ms(torch, lambda: cw.w_lookup_msm(curve, table, scalars, None, w))
    partials = cw.w_lookup_msm(curve, table, scalars, None, w)
    k = partials.x.shape[1]
    chunks = spread(min(k, 16), k)
    plain_ms = cuda_ms(torch, lambda: cw.w_lookup_msm_plain(curve, table, scalars, None, w, chunks), reps=1)
    err = point_err(curve.index_batch(partials, chunks), cw.w_lookup_msm_plain(curve, table, scalars, None, w, chunks))
    # the data decide the work: complete adds for the nonzero indices, table
    # bytes for the distinct nonzero entries they touch
    nonzero, entries = lookup_work(torch, scalars, w, groups)
    record("w_lookup_msm", "blitzar_tpu/ops/pallas_point.py:636", "blitzar_tpu_torch/csrc/w_lookup_msm.cu",
           ms, plain_ms, err, scalars.numel() + entries * entry_bytes + partials.x.numel() * 4 * 3,
           nonzero * MULS_WADD * imad, len(chunks) / k)
    results["w_lookup_msm"]["nonzero_lookups"] = nonzero
    results["w_lookup_msm"]["table_entries_touched"] = entries

    # wadd: timed at a ladder step's shape (one point: the lowest two
    # bit-row products), held against plain there and on the first two rows
    # of partials (512 of them)
    products = cw.w_tree_reduce_lanes(curve, partials)
    acc = curve.index_batch(products, slice(0, 1))
    nxt = curve.index_batch(products, slice(1, 2))
    lo = curve.index_batch(partials, 0)
    hi = curve.index_batch(partials, 1)
    ms = device_ms(torch, lambda: cw.wadd(curve, acc, nxt), reps=100)
    plain_ms = cuda_ms(torch, lambda: cw.wadd_plain(curve, acc, nxt), reps=1)
    err = max(point_err(cw.wadd(curve, p, q, negate_q=neg), cw.wadd_plain(curve, p, q, neg))
              for p, q in ((acc, nxt), (lo, hi)) for neg in (False, True))
    record("wadd", "blitzar_tpu/ops/pallas_point.py:891", "blitzar_tpu_torch/csrc/wadd.cu",
           ms, plain_ms, err, 3 * point_bytes, MULS_WADD * imad)
    # q read negated (the signed combine's), and an empty launch (the floor)
    results["wadd"]["ms_negate_q"] = device_ms(torch, lambda: cw.wadd(curve, acc, nxt, negate_q=True), reps=100)
    results["wadd"]["empty_launch_ms"] = device_ms(torch, lambda: torch.cuda._sleep(0), reps=100)

    # wdouble: timed at a ladder step's shape (one point: the lowest bit-row
    # product, not the identity), held against plain there and on all 256
    # bit-row products (the upper 128 are the identity with counter
    # scalars); no point but the identity is its own double, so a kernel
    # that kept its input would fail the second check
    ms = device_ms(torch, lambda: cw.wdouble(curve, acc), reps=100)
    plain_ms = cuda_ms(torch, lambda: cw.wdouble_plain(curve, acc), reps=1)
    err = max(point_err(cw.wdouble(curve, p), cw.wdouble_plain(curve, p)) for p in (acc, products))
    doubled = cw.wdouble(curve, products)
    finite = (products.z != 0).any(0)
    changed = torch.stack([(d != p).any(0) for d, p in zip(doubled, products)]).any(0)
    check(bool(finite[0]) and bool(changed[finite].all()),
          f"wdouble moves each of the {int(finite.sum())} bit-row products that are not the identity")
    record("wdouble", "blitzar_tpu/ops/pallas_point.py:907", "blitzar_tpu_torch/csrc/wdouble.cu",
           ms, plain_ms, err, 2 * point_bytes, MULS_WDOUBLE * imad)

    # w_doubling_combine: the ladder of that query's 256 bit-row products
    # (one output), and of seven outputs (the packed query's Proof-of-SQL
    # widths, padded to 256 bits: here the products rotated by 37 bits an
    # output); held against plain on both. Bound: the function's least work,
    # 255 doublings and adds an output (latency in fact: PERF.md gives the
    # critical path in dependent multiplies)
    nbits = 256
    one = curve.reshape_batch(products, (1, nbits))
    seven = curve.index_batch(one, (0, (torch.arange(nbits, device=dev)[None] + 37 * torch.arange(7, device=dev)[:, None])
                                    % nbits))
    ladder = functools.partial(cw.w_doubling_combine, curve)
    ms = device_ms(torch, lambda: ladder(one), reps=5)
    plain_ms = cuda_ms(torch, lambda: cw.w_doubling_combine_plain(curve, one), reps=1)
    err = max(point_err(ladder(p), cw.w_doubling_combine_plain(curve, p)) for p in (one, seven))
    record("w_doubling_combine", "blitzar_tpu/msm/fixed.py:596 (pallas_point.py:907, :891)",
           "blitzar_tpu_torch/csrc/w_doubling_combine.cu", ms, plain_ms, err, (nbits + 1) * point_bytes,
           (nbits - 1) * (MULS_WDOUBLE + MULS_WADD) * imad)
    rec = results["w_doubling_combine"]
    rec["ms_7_outputs"] = device_ms(torch, lambda: ladder(seven), reps=5)
    b_ms, _ = bound((nbits + 1) * 7 * point_bytes, 7 * (nbits - 1) * (MULS_WDOUBLE + MULS_WADD) * imad)
    rec["bound_ms_7_outputs"] = b_ms
    # back to back, the host's issue time counted (as the earlier ladder's
    # 510 launches were timed)
    rec["cuda_ms"] = cuda_ms(torch, lambda: fixed.doubling_combine(products, 1, nbits, curve), reps=5)
    rec["cuda_ms_7_outputs"] = cuda_ms(torch, lambda: ladder(seven), reps=5)
    seg = cw.ladder_segment_bits(nbits)
    nseg = -(-nbits // seg)
    rec["segment_bits"] = seg
    rec["critical_path_muls"] = ((seg - 1) * (MULS_WDOUBLE + MULS_WADD) + seg * (nseg - 1) * MULS_WDOUBLE
                                 + (nseg - 1) * MULS_WADD)
    rec["critical_path_muls_one_segment"] = (nbits - 1) * (MULS_WDOUBLE + MULS_WADD)
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


def phase_w_api_small(torch) -> None:
    """The three Weierstrass commitment entries on the card at n = 100: a
    signed 8-byte, a signed 16-byte (shorter) and an unsigned 32-byte
    column against the oracle's sums; and the 8-byte column through the
    streamed query (which ``engine.msm`` takes above 2^20 generators), its
    Q_pos - Q_neg as the handle's."""
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import fixed

    n = 100
    rng = np.random.default_rng(21)
    for curve in wc.CURVES:
        pts = curve.oracle.random_points(n, seed=22)
        s8 = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, size=n)]
        s16 = [int(v) * (1 << 60) + int(u) for v, u in zip(rng.integers(-(1 << 60), 1 << 60, size=n - 9),
                                                            rng.integers(0, 1 << 60, size=n - 9))]
        s16[:3] = [-(1 << 127), (1 << 127) - 1, -1]
        u32 = [int.from_bytes(rng.integers(0, 256, size=32, dtype=np.uint8).tobytes(), "little") for _ in range(n)]
        descs = (descriptors_from_ints(api, [s8], 8, True) + descriptors_from_ints(api, [s16], 16, True)
                 + descriptors_from_ints(api, [u32], 32, False))
        got = api.COMMITMENT_ENTRIES[curve](descs, curve.from_affine_ints(pts, api.device()))
        want = [curve.oracle.msm(vals, pts) for vals in (s8, s16, u32)]
        check(all(w_output_equals(curve, got, o, pt) for o, pt in enumerate(want)),
              f"{curve.name}: signed and unsigned 3-output commitment at n = {n} on cuda equals the oracle")
        mags = np.array([[np.frombuffer(abs(v).to_bytes(8, "little"), np.uint8) for v in s8]])
        signs = np.array([[v < 0 for v in s8]], np.uint8)
        got = fixed.streaming_multiexponentiation(curve.from_affine_ints(pts, api.device()), mags, curve, signs=signs)
        check(curve.to_affine_ints(got) == want[:1],
              f"{curve.name}: the signed 8-byte column through the streamed query at n = {n} on cuda equals the oracle")


def timed(torch, fn):
    """(result, ms) of fn on the host clock, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def warm_stages(torch, desc) -> dict:
    """Host-clock times of the steps of a warm commitment, one by one. The
    encode stage (the encoding and its copy to the host) must be one
    ``ristretto_encode`` launch and, by the profiler, run no other kernel:
    its device activity is that kernel and the copy (``encode_profile``)."""
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.msm import engine, fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    gens = generators.get_precomputed_generators(desc.n, 0, api.device())
    (scalars, _, n), prepare_ms = timed(torch, lambda: engine.prepare_scalars([desc.rows()], [32], [False]))
    handle, cache_ms = timed(torch, lambda: engine.cached_handle(gens, n))
    result, query_ms = timed(torch, lambda: fixed.fixed_multiexponentiation(handle, scalars))
    before = dict(cp.LAUNCHES)
    encoded, encode_ms = timed(torch, lambda: cp.ristretto_encode(result).cpu())
    launches = {k: v - before[k] for k, v in cp.LAUNCHES.items() if v != before[k]}
    check(launches == {"ristretto_encode": 1}, f"the warm 2^20 commitment's encode stage is one ristretto_encode "
                                               f"launch ({encode_ms:.3f} ms; {launches})")
    want = digest(encoded.numpy().T)
    prof = profile_commitment(torch, lambda: cp.ristretto_encode(result).cpu(),
                              lambda got: digest(got.numpy().T) == want, "encode stage gives the same bytes")
    names = list(prof.get("device_ms_by_name", {}))
    check(names and all(k == "ristretto_encode_kernel" or k.startswith("Memcpy") for k in names),
          f"the encode stage runs ristretto_encode_kernel and no aten kernel on the device: {names or prof}")
    return {"prepare_scalars": prepare_ms, "handle_cache_lookup": cache_ms, "query": query_ms, "encode": encode_ms,
            "encode_launches": launches, "encode_profile": prof}


def profile_commitment(torch, run, verify, what: str) -> dict:
    """Device time by kernel (and copy) over one warm commitment ``run()``,
    from torch.profiler, and the device's busy share of the host wall time.
    The commitment itself must succeed and pass ``verify``; only a profiler
    that fails to start, stop or report is reported instead of failing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # the profiler is untried on this machine: report, do not fail
        return {"error": repr(e)}
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    try:
        prof.stop()
        events, error = prof.events(), None
    except Exception as e:
        events, error = None, repr(e)
    check(verify(got), f"profiled {what}")
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
            timings["profile_commit_2^20_warm"] = profile_commitment(
                torch, lambda: api.compute_curve25519_commitments([desc]),
                lambda got: digest(got) == PINNED_RISTRETTO_MSM[20], "2^20 commitment equals the pinned digest")

    n, outputs = 100000, 10
    descs = [api.SequenceDescriptor(32, n, counter_scalars(n, 32, output=o)) for o in range(outputs)]
    got, ms = timed(torch, lambda: api.compute_curve25519_commitments(descs))
    check(digest(got) == PINNED_PEDERSEN_100000_10_32, f"n=100000 x 10 outputs equals the pinned digest ({ms:.1f} ms)")
    timings["commit_100000x10_cold_ms"] = ms

    # the stages of a 2^20 commitment, apart
    n = 1 << 20
    gens, timings["generators_2^20_ms"] = timed(torch, lambda: generators.ristretto_generators(n, 0, "cuda"))
    handle, timings["handle_build_2^20_ms"] = timed(
        torch, lambda: api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, gens))
    scalars = counter_scalars(n, 32)[None]
    queries = []
    for _ in range(5):
        res, ms = timed(torch, lambda: api.fixed_multiexponentiation(handle, scalars))
        queries.append(ms)
    timings["query_2^20_ms_all"] = queries
    timings["query_2^20_ms_median"] = float(np.median(queries))
    check(digest(api.compress_ristretto255(res)) == PINNED_RISTRETTO_MSM[20], "timed 2^20 query equals the pinned digest")
    return per_commitment


def phase_w_full_width(torch, timings: dict) -> dict:
    """bn254 G1 at 2^20, Grumpkin and bls12-381 G1 at 2^16 against the
    oracle's collapsed sums; returns the kernel launches of the first (cold)
    bn254 G1 2^20 commitment."""
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.ops import cuda_point as cp

    per_commitment = {}
    for curve, log_n in ((wc.BN254_G1, 20), (wc.GRUMPKIN, 16), (wc.BLS12381_G1, 16)):
        n = 1 << log_n
        key = f"{curve.name}_2^{log_n}"
        gens, pts = tiled_generators(curve, n, api.device())
        rows = counter_scalars(n, 32)
        t0 = time.perf_counter()
        expected = curve.oracle.msm(collapsed_scalars(rows), pts)
        timings[f"{key}_oracle_s"] = time.perf_counter() - t0
        desc = api.SequenceDescriptor(32, n, rows)
        entry = api.COMMITMENT_ENTRIES[curve]
        before = dict(cp.LAUNCHES)
        got, ms = timed(torch, lambda: entry([desc], gens))
        check(w_output_equals(curve, got, 0, expected), f"{key} commitment equals the oracle's collapsed sum ({ms:.1f} ms)")
        check_one_ladder(before, f"{key} cold commitment")
        timings[f"{key}_commit_cold_ms"] = ms
        if log_n == 20:
            per_commitment = {k: cp.LAUNCHES[k] - before[k] for k in cp.KERNELS}
        warm = []
        for _ in range(3):
            got, ms = timed(torch, lambda: entry([desc], gens))
            warm.append(ms)
        check(w_output_equals(curve, got, 0, expected), f"{key} warm commitment equals the oracle's collapsed sum")
        timings[f"{key}_commit_warm_ms_all"] = warm
        timings[f"{key}_commit_warm_ms_median"] = float(np.median(warm))
        if log_n == 20:
            timings[f"profile_{key}_commit_warm"] = profile_commitment(
                torch, lambda: entry([desc], gens), lambda got: w_output_equals(curve, got, 0, expected),
                f"{key} commitment equals the oracle's collapsed sum")
        handle, timings[f"{key}_handle_build_ms"] = timed(torch, lambda: api.multiexp_handle_new(api.CURVE_IDS[curve], gens))
        queries = []
        for _ in range(5):
            res, ms = timed(torch, lambda: api.fixed_multiexponentiation(handle, rows[None]))
            queries.append(ms)
        timings[f"{key}_query_ms_all"] = queries
        timings[f"{key}_query_ms_median"] = float(np.median(queries))
        check(curve.to_affine_ints(res) == [expected], f"{key} timed query equals the oracle's collapsed sum")
        del handle, gens
    return per_commitment


# ---------------------------------------------------------------------------
# the proofs: the sumcheck prover and the inner-product argument
# ---------------------------------------------------------------------------

# the benchmark's sumcheck problem (benchmarks/run_benchmarks.py:302-320):
# three MLEs, two products of degree 3; and a degree-5 table for the kernel
# over seven MLEs, no factor shared, so that no product reuses another's
SUMCHECK_BENCH = ([(1, 3), (1, 3)], [0, 1, 2, 1, 2, 0])
# SUMCHECK_BENCH as the prover gives it to each round (proof/sumcheck.py:
# product_arrays merges products of the same MLEs)
SUMCHECK_BENCH_ROUND = ([(2, 3)], [0, 1, 2])
SUMCHECK_DEG5 = ([(7, 5), (11, 2)], [0, 1, 2, 3, 4, 5, 6])
PROOF_KERNELS = ("mont_mul_ew", "mont_fold_round", "mont_sum_round", "mont_from_rows")
# the kernels every proof path launches (the IPA's generators G and Q, its
# handles of them, its queries and L + R; the sumcheck's rounds)
PROOF_PATH_KERNELS = PROOF_KERNELS + ("elligator_form", "build_niels_table", "ed_lookup_msm", "ed_add",
                                      "doubling_combine", "ristretto_encode", "ristretto_decode")
# the codec kernel whose path is the proof path (the IPA verifier's L and R);
# ristretto_encode's is the commitment path (one launch a commitment)
DECODE_KERNELS = ("ristretto_decode",)


def merge_muls(length: int) -> int:
    """Field multiplies of the cheapest expansion I know of a product of
    ``length`` linear polynomials: merge the two of lowest degree first
    (Huffman order), a merge of degrees a and b costing a + b + 1 multiplies
    (pointwise at a + b + 1 points, Toom-Cook; carrying a partial product to
    more points takes small integer combinations, counted as additions)."""
    degrees = [1] * length
    muls = 0
    while len(degrees) > 1:
        a, b = heapq.heappop(degrees), heapq.heappop(degrees)
        muls += a + b + 1
        heapq.heappush(degrees, a + b)
    return muls


def sum_round_muls(product_table, product_terms, lanes: int) -> int:
    """The least field multiplies of one sumcheck round over ``lanes``:
    products of the same factors count once (their multipliers add up),
    each distinct product of len factors costs merge_muls(len) a lane, and
    once a round its len + 1 lane sums are interpolated to coefficients and
    scaled by the multiplier ((len + 1)(len + 2) constant multiplies). The
    kernel itself spends (len - 1)(len + 2) + 2 a lane on every product."""
    distinct = set()
    first = 0
    for _, k in product_table:
        distinct.add(tuple(sorted(product_terms[first : first + k])))
        first += k
    return sum(lanes * merge_muls(len(p)) + (len(p) + 1) * (len(p) + 2) for p in distinct)


def random_canonical(torch, field, shape, dev, seed: int):
    """Random canonical Montgomery limbs on the card: 16-bit limbs with the
    top limb cut below the modulus's top limb (so every value is below m)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    limbs = torch.randint(0, 1 << 16, (field.nlimbs,) + tuple(shape), generator=gen, device=dev, dtype=torch.int32)
    top = field.modulus >> (16 * (field.nlimbs - 1))
    limbs[-1] %= top
    return limbs


def phase_mont_kernels(torch, dev) -> dict:
    """The three proof kernels at the 2^20 shapes of the proofs, for both
    fields, against their plain versions on the whole output: mont_mul_ew
    as an IPA round's exponent multiply (full b) and fold (broadcast b),
    mont_fold_round and mont_sum_round on a (16, 3, 2^20) table (the
    sumcheck benchmark's first round, degree 3), mont_sum_round also at
    degree 5 on a (16, 7, 2^20) table. Each result must also differ from
    its input."""
    from blitzar_tpu_torch.ops import cuda_mont as cm

    n, m = 1 << 20, 3
    imad = IMAD_PER_MONT_MUL[8]
    results: dict = {}
    for index, field in enumerate(cm.FIELDS.values()):
        fr: dict = {}
        record = functools.partial(kernel_record, fr)
        elem = field.nlimbs * 4  # bytes of one element in int32 limbs
        a = random_canonical(torch, field, (n,), dev, 1)
        b = random_canonical(torch, field, (n,), dev, 2)
        table = random_canonical(torch, field, (m, n), dev, 3)
        r = random_canonical(torch, field, (1,), dev, 4)

        ms = device_ms(torch, lambda: cm.mont_mul_ew(field, a, b), reps=10)
        out = cm.mont_mul_ew(field, a, b)
        plain_ms = cuda_ms(torch, lambda: cm.mont_mul_ew_plain(field, a, b), reps=1)
        err = int((out.long() - cm.mont_mul_ew_plain(field, a, b).long()).abs().max())
        bcast = cm.mont_mul_ew(field, a, b[:, :1])
        err = max(err, int((bcast.long() - cm.mont_mul_ew_plain(field, a, b[:, :1]).long()).abs().max()))
        check(bool((out != a).any(0).float().mean() > 0.99), f"{field.name} mont_mul_ew moves its input")
        record("mont_mul_ew", "blitzar_tpu/ops/pallas_point.py:1139", "blitzar_tpu_torch/csrc/mont_mul_ew.cu",
               ms, plain_ms, err, 3 * n * elem, n * imad)
        fr["mont_mul_ew"]["broadcast_ms"] = device_ms(torch, lambda: cm.mont_mul_ew(field, a, b[:, :1]), reps=10)

        ms = device_ms(torch, lambda: cm.mont_fold_round(field, table, r), reps=10)
        out = cm.mont_fold_round(field, table, r)
        plain_ms = cuda_ms(torch, lambda: cm.mont_fold_round_plain(field, table, r), reps=1)
        err = int((out.long() - cm.mont_fold_round_plain(field, table, r).long()).abs().max())
        check(bool((out != table[..., : n // 2]).any(0).float().mean() > 0.99), f"{field.name} mont_fold_round moves its input")
        record("mont_fold_round", "blitzar_tpu/ops/pallas_point.py:1172", "blitzar_tpu_torch/csrc/mont_fold_round.cu",
               ms, plain_ms, err, (m * n + m * n // 2 + 1) * elem, m * (n // 2) * imad)

        wide = random_canonical(torch, field, (7, n), dev, 5)
        for key, mles, (ptable, pterms) in (("degree3", table, SUMCHECK_BENCH_ROUND),
                                            ("degree5", wide, SUMCHECK_DEG5)):
            degree = max(k for _, k in ptable)
            mults = field.from_ints([mu for mu, _ in ptable], dev)
            lengths = torch.tensor([k for _, k in ptable], dtype=torch.int32, device=dev)
            terms = torch.tensor(pterms, dtype=torch.int32, device=dev)
            ms = device_ms(torch, lambda: cm.mont_sum_round(field, mles, mults, lengths, terms, degree), reps=10)
            out = cm.mont_sum_round(field, mles, mults, lengths, terms, degree)
            plain_ms = cuda_ms(torch, lambda: cm.mont_sum_round_plain(field, mles, mults, lengths, terms, degree),
                               reps=1)
            err = int((out.long() - cm.mont_sum_round_plain(field, mles, mults, lengths, terms, degree).long())
                      .abs().max())
            check(bool((out != 0).any(0).all()), f"{field.name} mont_sum_round degree {degree}: every coefficient nonzero")
            muls = sum_round_muls(ptable, pterms, n // 2)
            sub: dict = {}
            kernel_record(sub, "mont_sum_round", "blitzar_tpu/ops/pallas_point.py:1077",
                          "blitzar_tpu_torch/csrc/mont_sum_round.cu", ms, plain_ms, err, mles.shape[1] * n * elem,
                          muls * imad)
            sub["mont_sum_round"]["least_field_muls"] = muls
            if key == "degree3":
                fr["mont_sum_round"] = sub["mont_sum_round"]
            else:
                fr["mont_sum_round"]["degree5"] = sub["mont_sum_round"]
        rows_record(torch, fr, field, dev)
        if index == 0:
            results = fr
        else:
            for name in PROOF_KERNELS:
                results[name][field.name] = fr[name]
        del a, b, table, wide
    return results


# mont_from_rows: the sumcheck's three 2^20 MLEs, and one 2^20 column of
# n = 2^20 - 5 rows (the padding written too)
ROWS_SHAPES = ((3, 1 << 20, 1 << 20), (1, (1 << 20) - 5, 1 << 20))


def rows_record(torch, fr: dict, field, dev) -> None:
    """mont_from_rows at ROWS_SHAPES on random 32-byte rows (all 0xFF,
    2^255 and m among them), limb for limb its plain version; the record at
    the sumcheck's 3 x 2^20, the others by (num_mles, n, n_pad)."""
    from blitzar_tpu_torch.ops import cuda_mont as cm

    mode = "standard" if field is cm.FIELDS[cm.SXT_FIELD_SCALAR255] else "residues"
    by_shape = {}
    for num_mles, n, n_pad in ROWS_SHAPES:
        host = np.random.default_rng(n).integers(0, 256, size=(num_mles * n, 32), dtype=np.uint8)
        for k, v in enumerate((2**256 - 1, 2**255, field.modulus)):
            host[k] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
        rows = torch.from_numpy(host).to(dev)
        ms = device_ms(torch, lambda: cm.mont_from_rows(field, rows, num_mles, n_pad, mode), reps=10)
        out = cm.mont_from_rows(field, rows, num_mles, n_pad, mode)
        plain_ms = cuda_ms(torch, lambda: cm.mont_from_rows_plain(field, rows, num_mles, n_pad, mode), reps=1)
        err = int((out.long() - cm.mont_from_rows_plain(field, rows, num_mles, n_pad, mode).long()).abs().max())
        check(not out[:, :, n:].any() and bool((out[:, :, :n] != 0).any(0).float().mean() > 0.99),
              f"{field.name} mont_from_rows ({num_mles}, {n}, {n_pad}): zero padding, nonzero elements")
        sub: dict = {}
        kernel_record(sub, "mont_from_rows", "none: blitzar_tpu/proof/sumcheck.py:63-87 and "
                      "blitzar_tpu/proof/inner_product.py:88-104 (jitted from_bytes_le)",
                      "blitzar_tpu_torch/csrc/mont_rows.cu", ms, plain_ms, err,
                      rows.numel() + out.numel() * 4, num_mles * n * IMAD_PER_MONT_MUL[8])
        by_shape[f"{num_mles}x{n}->{n_pad}"] = sub["mont_from_rows"]
        del rows, out
    fr["mont_from_rows"] = dict(by_shape[f"{ROWS_SHAPES[0][0]}x{ROWS_SHAPES[0][1]}->{ROWS_SHAPES[0][2]}"])
    fr["mont_from_rows"]["at_shapes"] = by_shape


def phase_proof_vectors(torch) -> None:
    """The frozen IPA and sumcheck vectors (tests/torch_proof_vectors.py)
    through the entry points on the card."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_proof_vectors as vec
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.proof.transcript import Transcript

    for n, frozen in vec.IPA.items():
        a, b = vec.ipa_inputs(n)
        l, r, ap = api.prove_inner_product(Transcript(vec.IPA_LABEL), n, 0, a, b)
        check([bytes(x).hex() for x in l] == frozen["L"] and [bytes(x).hex() for x in r] == frozen["R"]
              and ap == frozen["ap"], f"IPA frozen vector n = {n} on cuda")
        rows = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in a])
        a_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, rows)]))
        product = sum(x * y for x, y in zip(a, b))
        check(api.verify_inner_product(Transcript(vec.IPA_LABEL), n, 0, b, product, a_commit, l, r, ap),
              f"IPA n = {n}: the frozen proof verifies on cuda")
    for fid, codec in api.FIELD_CODECS.items():
        for case, (n, ptable, pterms) in vec.SUMCHECK_CASES.items():
            frozen = vec.SUMCHECK[(codec.name, case)]
            got = api.prove_sumcheck(fid, vec.sumcheck_inputs(n), ptable, pterms, n,
                                     transcript=Transcript(vec.SUMCHECK_LABEL))
            check(got == (frozen["polynomials"], frozen["evaluation_point"]),
                  f"sumcheck frozen vector {codec.name} {case} on cuda")


def bench_rows(rng, shape) -> np.ndarray:
    """(*shape, 32) uint8 rows of 62-bit values drawn as the benchmark draws
    them (low 8 bytes from rng, the rest zero)."""
    rows = np.zeros(tuple(shape) + (32,), np.uint8)
    rows[..., :8] = rng.integers(1, 2**62, size=shape, dtype=np.uint64).view(np.uint8).reshape(tuple(shape) + (8,))
    return rows


def rows_parts(torch, field, rows, num_mles: int, n_pad: int, mode: str, reps: int = 3) -> dict:
    """The proofs' conversion of (num_mles * n, nbytes) ABI rows to the
    (nlimbs, num_mles, n_pad) Montgomery table, in three parts, each on the
    host clock between synchronisations (median of reps): ``host`` (the
    host's steps), ``copy`` (to the card) and ``kernel`` (the launches),
    as the checkout's ``blitzar_tpu_torch`` runs them: its one
    ``mont_from_rows`` launch on the uint8 rows, or (a tree without it) the
    numpy split ``rows_to_limbs``, the int32 limbs' copy and a
    ``mont_mul_ew`` launch into a zeroed table. Also the table's sha256 (equal
    on both trees) and whether it equals the plain version. Its launches
    are measurements, not a path's: the counts are restored after it."""
    from blitzar_tpu_torch.ops import cuda_point as cp

    saved = dict(cp.LAUNCHES), dict(cp.INSTANCE_LAUNCHES)
    try:
        return _rows_parts(torch, field, rows, num_mles, n_pad, mode, reps)
    finally:
        cp.LAUNCHES.update(saved[0])
        cp.INSTANCE_LAUNCHES.clear()
        cp.INSTANCE_LAUNCHES.update(saved[1])


def _rows_parts(torch, field, rows, num_mles: int, n_pad: int, mode: str, reps: int) -> dict:
    from blitzar_tpu_torch.fields.mont import rows_to_limbs
    from blitzar_tpu_torch.ops import cuda_mont as cm

    n = rows.shape[0] // num_mles
    kernel = hasattr(cm, "mont_from_rows")
    scale = cm.constant(field, field.r2 if mode == "standard" else field.r, "cuda")

    def host():
        if kernel:
            return torch.from_numpy(np.require(rows, np.uint8, ["C", "W"]))
        return rows_to_limbs(rows, field.nlimbs, "cpu")

    def convert(on_card):
        if kernel:
            return cm.mont_from_rows(field, on_card, num_mles, n_pad, mode)
        table = torch.zeros((field.nlimbs, num_mles, n_pad), dtype=torch.int32, device="cuda")
        table[:, :, :n] = cm.mont_mul_ew(field, on_card, scale).reshape(field.nlimbs, num_mles, n)
        return table

    times: dict = {"host": [], "copy": [], "kernel": []}
    for _ in range(reps):
        staged, ms = timed(torch, host)
        times["host"].append(ms)
        on_card, ms = timed(torch, lambda: staged.to("cuda"))
        times["copy"].append(ms)
        table, ms = timed(torch, lambda: convert(on_card))
        times["kernel"].append(ms)
    if kernel:
        want = cm.mont_from_rows_plain(field, on_card, num_mles, n_pad, mode)
    else:
        want = torch.zeros_like(table)
        want[:, :, :n] = field.mul(on_card, scale).reshape(field.nlimbs, num_mles, n)
    out = {part: float(np.median(v)) for part, v in times.items()}
    out.update(times_ms=times, one_launch=kernel, equals_plain=bool(torch.equal(table, want)),
               table_sha256=hashlib.sha256(table.cpu().numpy().tobytes()).hexdigest(),
               bytes_copied=int(staged.numel() * staged.element_size()))
    if kernel:
        out["kernel_device_ms"] = device_ms(torch, lambda: convert(on_card), reps=5)
    return out


def cache_load_parts(torch, path: str, n: int, reps: int = 3) -> dict:
    """The generator disk cache's load of the first n generators from the
    affine file at ``path`` ((2, 16, count) uint16), in three parts, each on
    the host clock between synchronisations (median of reps): ``host``
    (np.load of the file, memory-mapped, and the host's steps), ``copy`` (to
    the card) and ``kernel`` (the launches), as the checkout's
    ``generators._disk_load`` runs them: one contiguous copy of the prefix's
    uint16 rows and one ``ed_from_affine_rows`` launch, or (a tree without
    it) x and y widened to int32, their copy and ``fmul`` for t with z = 1.
    Also the points' sha256 (canonical limbs, equal on both trees) and the
    bytes copied. Its launches are measurements, not a path's: the counts
    are restored after it."""
    from blitzar_tpu_torch.ops import cuda_point as cp

    saved = dict(cp.LAUNCHES), dict(cp.INSTANCE_LAUNCHES)
    try:
        return _cache_load_parts(torch, path, n, reps)
    finally:
        cp.LAUNCHES.update(saved[0])
        cp.INSTANCE_LAUNCHES.clear()
        cp.INSTANCE_LAUNCHES.update(saved[1])


def _cache_load_parts(torch, path: str, n: int, reps: int) -> dict:
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_field as cf
    from blitzar_tpu_torch.ops import cuda_point as cp

    kernel = hasattr(cp, "ed_from_affine_rows")

    def host():
        arr = np.load(path, mmap_mode="r")
        if kernel:
            return [torch.from_numpy(np.array(arr[:, :, :n], order="C"))]
        return [torch.from_numpy(arr[k, :, :n].astype(np.int32)) for k in range(2)]

    def convert(on_card):
        if kernel:
            return cp.ed_from_affine_rows(on_card[0])
        x, y = on_card
        return ed.PointP3(x, y, F.from_int(1, (n,), "cuda"), cf.fmul(x, y))

    times: dict = {"host": [], "copy": [], "kernel": []}
    for _ in range(reps):
        staged, ms = timed(torch, host)
        times["host"].append(ms)
        on_card, ms = timed(torch, lambda: [t.to("cuda") for t in staged])
        times["copy"].append(ms)
        points, ms = timed(torch, lambda: convert(on_card))
        times["kernel"].append(ms)
    canon = torch.stack([F.canonicalize(c) for c in points]).cpu().numpy()
    out = {part: float(np.median(v)) for part, v in times.items()}
    out.update(times_ms=times, one_launch=kernel, points_sha256=hashlib.sha256(canon.tobytes()).hexdigest(),
               bytes_copied=int(sum(t.numel() * t.element_size() for t in staged)))
    # the launch alone (the tree without the kernel: its fmul; z's ones are
    # made on the host, which a device time cannot queue)
    launch = (lambda: cp.ed_from_affine_rows(on_card[0])) if kernel else (lambda: cf.fmul(*on_card))
    out["kernel_device_ms"] = device_ms(torch, launch, reps=5)
    return out


@contextlib.contextmanager
def signed_combines():
    """Records each call of ``fixed.combine_signed`` (a signed query's Q_pos
    - Q_neg) on the card while the block runs: its curve, whether a
    streamed query made it, the launches it made and the plain negations
    (``ed.neg``, ``WCurve.neg``) inside it."""
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    inner, plain_neg, plain_wneg, calls, negs = fixed.combine_signed, ed.neg, wc.WCurve.neg, [], []
    streamed_inner, streaming = fixed.streaming_multiexponentiation, []

    def recording(products, num_outputs, nbits, curve=ed):
        if products.x.device.type != "cuda":
            return inner(products, num_outputs, nbits, curve)
        before, negs_before = dict(cp.LAUNCHES), len(negs)
        out = inner(products, num_outputs, nbits, curve)
        calls.append({"curve": "ristretto255" if curve is ed else curve.name, "outputs": num_outputs,
                      "streamed": bool(streaming), "negs": len(negs) - negs_before,
                      "launches": {k: v - before[k] for k, v in cp.LAUNCHES.items() if v != before[k]}})
        return out

    def streamed(*args, **kwargs):
        streaming.append(1)
        try:
            return streamed_inner(*args, **kwargs)
        finally:
            streaming.pop()

    fixed.combine_signed, fixed.streaming_multiexponentiation = recording, streamed
    ed.neg = lambda p: negs.append(1) or plain_neg(p)
    wc.WCurve.neg = lambda self, p: negs.append(1) or plain_wneg(self, p)
    try:
        yield calls
    finally:
        fixed.combine_signed, fixed.streaming_multiexponentiation, ed.neg = inner, streamed_inner, plain_neg
        wc.WCurve.neg = plain_wneg


@contextlib.contextmanager
def launches_per_call(module, attr: str):
    """Records the launches of each call of module.attr while the block
    runs (the counts are read around the call, not reset); a call that
    runs the host's limb split (``rows_to_limbs``, the plain version's)
    records it as a launch of "rows_to_limbs"."""
    from blitzar_tpu_torch.fields import mont
    from blitzar_tpu_torch.ops import cuda_mont as cm
    from blitzar_tpu_torch.ops import cuda_point as cp

    inner, calls, splits = getattr(module, attr), [], []

    def recording(*args, **kwargs):
        before, split_before = dict(cp.LAUNCHES), len(splits)
        out = inner(*args, **kwargs)
        calls.append({k: v - before[k] for k, v in cp.LAUNCHES.items() if v != before[k]})
        if len(splits) > split_before:
            calls[-1]["rows_to_limbs"] = len(splits) - split_before
        return out

    plain_split = mont.rows_to_limbs
    split = lambda *a, **k: splits.append(1) or plain_split(*a, **k)  # noqa: E731
    mont.rows_to_limbs = cm.rows_to_limbs = split
    setattr(module, attr, recording)
    try:
        yield calls
    finally:
        setattr(module, attr, inner)
        mont.rows_to_limbs = cm.rows_to_limbs = plain_split


def phase_sumcheck_full_width(torch, timings: dict) -> None:
    """The benchmark's sumcheck at n = 2^20 (three MLEs of 62-bit rows from
    seed 4, two products of degree 3) for both fields: the claimed sum
    computed apart (sum over the cube of prod MLE, plain PyTorch on the
    card), the verifier's acceptance, the final evaluation (each MLE folded
    to the evaluation point by the plain fold), a tampered proof rejected;
    cold and warm (median of 3) proof times, and the split of one more
    proof between building the table, the two round kernels, the
    transcript and the rest."""
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.fields.mont import rows_to_limbs
    from blitzar_tpu_torch.ops import cuda_mont as cm
    from blitzar_tpu_torch.proof import sumcheck as tsc
    from blitzar_tpu_torch.proof.transcript import Transcript

    n = 1 << 20
    ptable, pterms = SUMCHECK_BENCH
    degree = 3
    rows = bench_rows(np.random.default_rng(4), (3, n))
    for fid, codec in api.FIELD_CODECS.items():
        key, field = codec.name, codec.field

        def prove():
            return api.prove_sumcheck(fid, rows, ptable, pterms, n, transcript=Transcript(b"bench"))

        with launches_per_call(tsc, "mles_to_table") as table_calls:
            (polys, point), ms = timed(torch, prove)
        check(table_calls == [{"mont_from_rows": 1}],
              f"sumcheck {key} 2^20: the table is one mont_from_rows launch, no mont_mul_ew, no host limb split "
              f"({table_calls})")
        timings[f"sumcheck_{key}_2^20_cold_ms"] = ms
        warm = [timed(torch, prove)[1] for _ in range(3)]
        timings[f"sumcheck_{key}_2^20_warm_ms_all"] = warm
        timings[f"sumcheck_{key}_2^20_warm_ms_median"] = float(np.median(warm))
        stages = {"table_from_rows": [(tsc, "mles_to_table")], "mont_sum_round": [(cm, "mont_sum_round")],
                  "mont_fold_round": [(cm, "mont_fold_round")],
                  "transcript": [(tsc.ReferenceSumcheckTranscript, "round_challenge")]}
        with StageTimer(torch, stages) as st:
            again, total = timed(torch, prove)
        check(again == (polys, point), f"sumcheck {key} 2^20: the timed proofs agree")
        timings[f"sumcheck_{key}_2^20_split_ms"] = {
            "total": total, "rounds": len(polys), **st.ms, "host_and_rest": total - sum(st.ms.values())}
        parts = timings[f"sumcheck_{key}_2^20_table_parts_ms"] = rows_parts(
            torch, field, rows.reshape(3 * n, 32), 3, n, codec.rows_mode)
        check(parts["equals_plain"], f"sumcheck {key} 2^20: the table from rows in three parts, host "
                                     f"{parts['host']:.2f}, copy {parts['copy']:.2f}, kernel {parts['kernel']:.2f} ms")
        # the table as the rows stand for it, by the plain field: 62-bit
        # standard-form values (scalar25519) or Montgomery residues (grumpkin)
        raw = rows_to_limbs(rows.reshape(3 * n, 32), field.nlimbs, "cuda")
        table = (field.to_mont(raw) if fid == api.SXT_FIELD_SCALAR255 else raw).reshape(field.nlimbs, 3, n)
        claimed = 0
        first = 0
        for mult, k in ptable:
            prod = table[:, pterms[first]]
            for t in pterms[first + 1 : first + k]:
                prod = field.mul(prod, table[:, t])
            first += k
            claimed += mult * field.to_ints(field.lane_sum(prod).reshape(field.nlimbs, 1))[0]
        claimed %= field.modulus
        ok, vpoint, final = tsc.verify_sumcheck_no_evaluation(
            claimed, tsc.ReferenceSumcheckTranscript(Transcript(b"bench"), codec), polys, degree, len(polys), codec)
        check(ok and vpoint == point, f"sumcheck {key} 2^20: the verifier accepts against the sum over the cube "
                                      f"({timings[f'sumcheck_{key}_2^20_warm_ms_median']:.1f} ms warm)")
        for rch in point:
            table = cm.mont_fold_round_plain(field, table, field.from_ints([rch], "cuda"))
        at_point = field.to_ints(table.reshape(field.nlimbs, 3))
        want_final = 0
        first = 0
        for mult, k in ptable:
            prod = mult
            for t in pterms[first : first + k]:
                prod = prod * at_point[t] % field.modulus
            first += k
            want_final += prod
        check(final == want_final % field.modulus, f"sumcheck {key} 2^20: the final sum equals sum mult prod MLE(r)")
        tampered = [list(p) for p in polys]
        tampered[5][1] = (tampered[5][1] + 1) % field.modulus
        bad, _, _ = tsc.verify_sumcheck_no_evaluation(
            claimed, tsc.ReferenceSumcheckTranscript(Transcript(b"bench"), codec), tampered, degree, len(polys), codec)
        check(not bad, f"sumcheck {key} 2^20: a tampered coefficient is rejected")
        del table, raw


class StageTimer:
    """Host-clock time of named module functions or class methods
    (synchronised around each call) while active: the per-stage split of a
    proof. Only the timed
    run pays the synchronisations."""

    def __init__(self, torch, stages: dict):
        self.torch, self.stages = torch, stages  # name -> [(module, attribute)]
        self.ms = dict.fromkeys(stages, 0.0)
        self.saved = []

    def __enter__(self):
        for name, targets in self.stages.items():
            for module, attr in targets:
                fn = getattr(module, attr)
                self.saved.append((module, attr, fn))
                setattr(module, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed_fn(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return timed_fn

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)


def phase_ipa_full_width(torch, timings: dict) -> None:
    """The benchmark's IPA at n = 2^20 (62-bit a and b rows from seed 3, the
    canonical generators): prove cold and warm (median of 3), the per-round
    split of one more proof, verify; product = <a, b> mod l on the host,
    a_commit the port's own commitment to a over G[0, n); the proof must
    verify, and must not with one L byte flipped or with ap + 1."""
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.proof import inner_product as tipa
    from blitzar_tpu_torch.proof.transcript import Transcript

    n = 1 << 20
    rng = np.random.default_rng(3)
    a, b = bench_rows(rng, (n,)), bench_rows(rng, (n,))

    def prove():
        return api.prove_inner_product(Transcript(b"bench"), n, 0, a, b)

    with launches_per_call(tipa, "_mont_rows") as row_calls:
        (l, r, ap), timings["ipa_2^20_prove_cold_ms"] = timed(torch, prove)
    check(row_calls == [{"mont_from_rows": 1}] * 2, f"IPA 2^20 prove: a and b rows one mont_from_rows launch each, "
                                                    f"no host limb split ({row_calls})")
    warm = [timed(torch, prove)[1] for _ in range(3)]
    timings["ipa_2^20_prove_warm_ms_all"] = warm
    timings["ipa_2^20_prove_warm_ms_median"] = float(np.median(warm))
    stages = {"query": [(tipa, "_query")], "encode": [(cp, "ristretto_encode")],
              "exponents_cross_terms_fold": [(tipa, "_round_exponents"), (tipa, "_cross_terms"), (tipa, "_fold")]}
    with StageTimer(torch, stages) as st:
        (l2, r2, ap2), total = timed(torch, prove)
    check(np.array_equal(l2, l) and np.array_equal(r2, r) and ap2 == ap, "IPA 2^20: the timed proofs agree")
    split = dict(st.ms)
    split["host_and_rest"] = total - sum(st.ms.values())
    timings["ipa_2^20_prove_split_ms"] = {"total": total, "rounds": len(l), **split}

    av = np.frombuffer(a[:, :8].tobytes(), "<u8").tolist()
    bv = np.frombuffer(b[:, :8].tobytes(), "<u8").tolist()
    product = sum(x * y for x, y in zip(av, bv)) % tipa.ORDER
    a_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, a)]))

    def verify(lv=l, apv=ap):
        return api.verify_inner_product(Transcript(b"bench"), n, 0, b, product, a_commit, lv, r, apv)

    with launches_per_call(tipa, "_mont_rows") as row_calls:
        ok, timings["ipa_2^20_verify_ms"] = timed(torch, verify)
    check(row_calls == [{"mont_from_rows": 1}],
          f"IPA 2^20 verify: the b rows one mont_from_rows launch, no host limb split ({row_calls})")
    check(ok, f"IPA 2^20: the proof verifies (prove {timings['ipa_2^20_prove_warm_ms_median']:.1f} ms warm, "
              f"verify {timings['ipa_2^20_verify_ms']:.1f} ms)")
    stages = {"decode": [(cp, "ristretto_decode")], "encode": [(cp, "ristretto_encode")], "query": [(tipa, "_query")],
              "g_exponents": [(tipa, "_g_exponents")], "b_rows": [(tipa, "_scalar_rows"), (tipa, "_mont_rows")],
              "handle_cache_lookup": [(engine, "cached_handle")]}
    with StageTimer(torch, stages) as st:
        ok, total = timed(torch, verify)
    check(ok, "IPA 2^20: the split verify accepts too")
    timings["ipa_2^20_verify_split_ms"] = {"total": total, **st.ms, "host_and_rest": total - sum(st.ms.values())}
    parts = timings["ipa_2^20_b_rows_parts_ms"] = rows_parts(torch, tipa.S, b, 1, n, "standard")
    check(parts["equals_plain"], f"IPA 2^20: the b rows in three parts, host {parts['host']:.2f}, copy "
                                 f"{parts['copy']:.2f}, kernel {parts['kernel']:.2f} ms")
    flipped = l.copy()
    flipped[3, 7] ^= 0x01
    check(not verify(lv=flipped), "IPA 2^20: one flipped L byte is rejected")
    check(not verify(apv=(ap + 1) % tipa.ORDER), "IPA 2^20: ap + 1 is rejected")


# ---------------------------------------------------------------------------
# MSMs above 2^20: the streamed build+query on all four curves, handles and
# the IPA past 2^20
# ---------------------------------------------------------------------------

# the kernels of the streamed path, and the instantiations of the templated
# ones that the large-n phase must launch
LARGE_KERNELS = ("build_cached_table", "ed_lookup_msm_cached", "tree_reduce_lanes")
LARGE_INSTANCES = tuple(f"tree_reduce_lanes/{c}" for c in ("ristretto255", "bls12_381_g1", "bn254_g1", "grumpkin")) + tuple(
    f"{k}/{c}" for k in ("w_build_table", "w_lookup_msm", "w_doubling_combine")
    for c in ("bls12_381_g1", "bn254_g1", "grumpkin"))
MULS_CADD = 8
CHUNK = 1 << 18  # msm/fixed.py STREAM_CHUNK_POINTS, the chunk the kernels are held at


def clear_handles(torch) -> None:
    from blitzar_tpu_torch.msm import engine

    engine.clear_handle_cache()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_large_n(torch, timings: dict) -> dict:
    """(a)-(g) of the large-n phase; returns the inputs (h) holds the kernels
    at: the 2^24 query's scalars."""
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import ristretto as rst
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import engine, fixed
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.proof import inner_product as tipa
    from blitzar_tpu_torch.proof.transcript import Transcript

    dev = api.device()
    check(fixed.STREAM_CHUNK_POINTS == CHUNK, f"the streamed chunk is {CHUNK} points")
    torch.cuda.reset_peak_memory_stats()

    # (a) the streamed path at 2^20, called directly, reproduces the pinned
    # digest the handle path reproduces (phase 5)
    n = 1 << 20
    gens = generators.get_precomputed_generators(n, 0, dev)
    out, ms = timed(torch, lambda: fixed.streaming_multiexponentiation(gens, counter_scalars(n, 32)[None]))
    check(digest(api.compress_ristretto255(out)) == PINNED_RISTRETTO_MSM[20],
          f"(a) streamed 2^20 counter-scalar MSM equals the pinned digest ({ms:.1f} ms)")
    timings["stream_2^20_ms"] = ms

    # (b) 2^21 through the commitment entry (streamed), one 32-byte column
    # from seed 6 (benchmarks/run_benchmarks.py:453-458): equal to the sum of
    # the handle path's commitments over [0, 2^20) and [2^20, 2^21), and to a
    # 2^21 handle's query (niels table, built apart from the cached ones)
    rng = np.random.default_rng(6)
    n = 1 << 21
    rows = rng.integers(0, 256, size=(1, n, 32), dtype=np.uint8)
    got, timings["commit_2^21_cold_ms"] = timed(
        torch, lambda: api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, rows[0])]))
    half = n // 2
    lo = api.compute_curve25519_commitments([api.SequenceDescriptor(32, half, rows[0, :half])])
    hi = api.compute_curve25519_commitments([api.SequenceDescriptor(32, half, rows[0, half:])], generators_offset=half)
    both = ed.add(api.decompress_ristretto255(lo)[0], api.decompress_ristretto255(hi)[0])
    check(np.array_equal(api.compress_ristretto255(both), got),
          f"(b) streamed 2^21 commitment equals the sum of the handle path's over the two halves "
          f"({timings['commit_2^21_cold_ms']:.1f} ms)")
    clear_handles(torch)
    gens = generators.get_precomputed_generators(n, 0, dev)
    handle, timings["handle_build_2^21_ms"] = timed(torch, lambda: api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, gens))
    res, timings["handle_query_2^21_ms"] = timed(torch, lambda: api.fixed_multiexponentiation(handle, rows))
    check(np.array_equal(api.compress_ristretto255(res), got),
          f"(b) a 2^21 handle ({handle.table.numel() * 4 / 2**30:.2f} GiB of niels entries) gives the same commitment")
    del handle, res
    clear_handles(torch)

    # (c) 2^24, the benchmark's dense streamed row: the next column of seed 6;
    # cold from an empty generator cache, so it derives all 2^24 generators
    n = 1 << 24
    rows24 = rng.integers(0, 256, size=(1, n, 32), dtype=np.uint8)
    desc = api.SequenceDescriptor(32, n, rows24[0])
    generators.CACHE.reset()
    torch.cuda.empty_cache()
    got, timings["commit_2^24_cold_ms"] = timed(torch, lambda: api.compute_curve25519_commitments([desc]))
    warm = []
    for _ in range(3):
        again, ms = timed(torch, lambda: api.compute_curve25519_commitments([desc]))
        warm.append(ms)
        check(np.array_equal(again, got), "(c) a warm 2^24 commitment equals the cold one")
    timings["commit_2^24_warm_ms_all"] = warm
    timings["commit_2^24_warm_ms_median"] = float(np.median(warm))
    gens = generators.get_precomputed_generators(n, 0, dev)
    w4, timings["stream_2^24_w4_ms"] = timed(torch, lambda: fixed.streaming_multiexponentiation(gens, rows24, window_width=4))
    check(np.array_equal(api.compress_ristretto255(w4), got),
          f"(c) 2^24 at w = 8 equals w = 4 (cold {timings['commit_2^24_cold_ms']:.1f} ms, "
          f"warm {timings['commit_2^24_warm_ms_median']:.1f} ms)")
    stages = {"upload": [(fixed, "_device_rows")], "chunk_builds": [(cp, "build_cached_table")],
              "lookups": [(cp, "ed_lookup_msm")], "reduces": [(cp, "tree_reduce_lanes")],
              "combine": [(cp, "doubling_combine")], "encode": [(cp, "ristretto_encode")]}
    with StageTimer(torch, stages) as st:
        again, total = timed(torch, lambda: api.compute_curve25519_commitments([desc]))
    check(np.array_equal(again, got), "(c) the split 2^24 commitment equals the cold one")
    timings["commit_2^24_split_ms"] = {"total": total, "chunks": n // CHUNK, **st.ms,
                                       "host_and_rest": total - sum(st.ms.values())}
    _, timings["generators_2^24_ms"] = timed(torch, lambda: generators.ristretto_generators(n, 0, "cuda"))
    clear_handles(torch)

    # (d) signed, three outputs of signed 8-byte values, n = 2^20 + 3 (a last
    # chunk of 3 points and 5 identities): streamed equals the lifted handle
    n = (1 << 20) + 3
    vals = np.random.default_rng(7).integers(-(1 << 63), (1 << 63) - 1, size=(3, n), dtype=np.int64)
    descs = [api.SequenceDescriptor(8, n, vals[o].astype("<i8").view(np.uint8).reshape(n, 8), True) for o in range(3)]
    got, timings["commit_signed_3x(2^20+3)_ms"] = timed(torch, lambda: api.compute_curve25519_commitments(descs))
    scalars, signs, _ = engine.prepare_scalars([d.rows() for d in descs], [8] * 3, [True] * 3)
    handle = api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, generators.get_precomputed_generators(n, 0, dev))
    want = api.compress_ristretto255(fixed.fixed_multiexponentiation_signed(handle, scalars, signs))
    check(np.array_equal(got, want), "(d) signed 3-output streamed commitment at n = 2^20 + 3 equals the lifted handle's")
    del handle
    clear_handles(torch)

    # (e) bn254 G1 at 2^22, Grumpkin and bls12-381 G1 at 2^20 + 3: one column
    # of counter scalars over the oracle's 521 points tiled to n
    for curve, log_label, n in ((wc.BN254_G1, "2^22", 1 << 22), (wc.GRUMPKIN, "2^20+3", (1 << 20) + 3),
                                (wc.BLS12381_G1, "2^20+3", (1 << 20) + 3)):
        key = f"{curve.name}_{log_label}"
        gens, pts = tiled_generators(curve, n, dev)
        rows = counter_scalars(n, 32)
        expected = curve.oracle.msm(collapsed_scalars(rows), pts)
        before = dict(cp.LAUNCHES)
        got, timings[f"{key}_commit_ms"] = timed(
            torch, lambda: api.COMMITMENT_ENTRIES[curve]([api.SequenceDescriptor(32, n, rows)], gens))
        check(w_output_equals(curve, got, 0, expected),
              f"(e) {key} streamed commitment equals the oracle's collapsed sum ({timings[f'{key}_commit_ms']:.1f} ms)")
        check_one_ladder(before, f"(e) {key} streamed commitment")
        check(not engine._HANDLE_CACHE, f"(e) {key} built no handle")
        del gens
    clear_handles(torch)

    # (f) small n: a fresh 4096-point set builds its handle on its first
    # commitment (blitzar_tpu streams that one) and reuses it on the second
    n = 4096
    gens = generators.ristretto_generators(n, 12345, dev)
    desc = api.SequenceDescriptor(32, n, counter_scalars(n, 32))
    before = dict(cp.LAUNCHES)
    first, timings["small_4096_first_ms"] = timed(torch, lambda: api.compute_curve25519_commitments([desc], gens))
    mid = dict(cp.LAUNCHES)
    second, timings["small_4096_second_ms"] = timed(torch, lambda: api.compute_curve25519_commitments([desc], gens))
    after = dict(cp.LAUNCHES)
    built = mid["build_niels_table"] > before["build_niels_table"] and mid["build_cached_table"] == before["build_cached_table"]
    reused = after["build_niels_table"] == mid["build_niels_table"] and after["build_cached_table"] == mid["build_cached_table"]
    check(built and reused and np.array_equal(first, second),
          f"(f) a fresh 4096-point set: handle built on the first commitment "
          f"({timings['small_4096_first_ms']:.1f} ms), reused on the second "
          f"({timings['small_4096_second_ms']:.1f} ms), equal")
    del gens
    clear_handles(torch)

    # (g) the IPA at 2^21, the smallest n blitzar_tpu streams its G query at:
    # 62-bit a and b from seed 3 (run_benchmarks.py:232-291)
    n = 1 << 21
    rng3 = np.random.default_rng(3)
    a, b = bench_rows(rng3, (n,)), bench_rows(rng3, (n,))
    (l, r, ap), timings["ipa_2^21_prove_cold_ms"] = timed(
        torch, lambda: api.prove_inner_product(Transcript(b"bench"), n, 0, a, b))
    check(not any(e[2] == n for e in engine._HANDLE_CACHE), "(g) the 2^21 IPA built no handle of G")
    av = np.frombuffer(a[:, :8].tobytes(), "<u8").tolist()
    bv = np.frombuffer(b[:, :8].tobytes(), "<u8").tolist()
    product = sum(x * y for x, y in zip(av, bv)) % tipa.ORDER
    a_commit, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, a)]))

    def verify(lv=l):
        return api.verify_inner_product(Transcript(b"bench"), n, 0, b, product, a_commit, lv, r, ap)

    ok, timings["ipa_2^21_verify_ms"] = timed(torch, verify)
    check(ok, f"(g) IPA 2^21: the proof verifies (prove {timings['ipa_2^21_prove_cold_ms']:.1f} ms cold, "
              f"verify {timings['ipa_2^21_verify_ms']:.1f} ms)")
    flipped = l.copy()
    flipped[5, 9] ^= 0x01
    check(not verify(lv=flipped), "(g) IPA 2^21: one flipped L byte is rejected")
    timings["large_n_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    clear_handles(torch)
    return {"rows24": rows24}


def phase_large_kernels(torch, dev, rows24) -> dict:
    """(h) the streamed path's kernels against their plain versions at its
    shapes: build_cached_table and the cached ed_lookup_msm on the first
    2^18-point chunk of the 2^24 query (w = 8, its 32-byte scalars; plain on
    512 groups and 16 lookup chunks spread over the chunk), tree_reduce_lanes
    on that lookup's (K, 256) partials (K = 521) and on a (1024, 256) tiling
    of them, and on the (K, 256) partials of each Weierstrass curve's first
    chunk of (e) (compared as points: the kernel adds in another order);
    each curve's w_lookup_msm on that chunk (plain on 16 spread chunks) and
    w_doubling_combine on its 256 bit-row products, limb for limb."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    w = 8
    groups = CHUNK // w
    results: dict = {}
    record = functools.partial(kernel_record, results)
    spread = functools.partial(spread_indices, torch, dev)
    gens = generators.get_precomputed_generators(CHUNK, 0, dev)

    ms = device_ms(torch, lambda: cp.build_cached_table(gens, w), reps=3)
    table = cp.build_cached_table(gens, w)
    sel = spread(512, groups)
    members = ed.index_batch(gens, (sel[:, None] * w + torch.arange(w, device=dev)).reshape(-1))
    plain_ms = cuda_ms(torch, lambda: cp.build_cached_table_plain(members, w), reps=1)
    err = int((table[sel].long() - cp.build_cached_table_plain(members, w).long()).abs().max())
    # least work a group: the w points to cached form (w multiplies by 2d),
    # each of the other 2^w - 1 - w nonzero entries one add of an entry and
    # a cached point and its own multiply by 2d
    entries = 1 << w
    record("build_cached_table", "blitzar_tpu/ops/pallas_point.py:806", "blitzar_tpu_torch/csrc/build_cached_table.cu",
           ms, plain_ms, err, CHUNK * 256 + table.numel() * 4,
           groups * ((entries - 1 - w) * (MULS_CADD + 1) + w) * IMAD_PER_FIELD_MUL, len(sel) / groups)

    scalars = torch.from_numpy(rows24[:, :CHUNK]).to(dev)
    ms = device_ms(torch, lambda: cp.ed_lookup_msm(table, scalars, None, w))
    partials = cp.ed_lookup_msm(table, scalars, None, w)
    k = partials.x.shape[1]
    chunks = spread(16, k)
    plain_ms = cuda_ms(torch, lambda: cp.ed_lookup_msm_plain(table, scalars, None, w, chunks), reps=1)
    err = point_err(ed.index_batch(partials, chunks), cp.ed_lookup_msm_plain(table, scalars, None, w, chunks),
                    F.canonicalize)
    nonzero, touched = lookup_work(torch, scalars, w, groups)
    record("ed_lookup_msm_cached", "blitzar_tpu/ops/pallas_point.py:533", "blitzar_tpu_torch/csrc/ed_lookup_msm.cu",
           ms, plain_ms, err, scalars.numel() + touched * 128 + partials.x.numel() * 16,
           nonzero * MULS_CADD * IMAD_PER_FIELD_MUL, len(chunks) / k)
    results["ed_lookup_msm_cached"]["nonzero_lookups"] = nonzero
    results["ed_lookup_msm_cached"]["table_entries_touched"] = touched
    del table

    # tree_reduce_lanes: a point is 256 bytes (ristretto255) or 3 nlimbs
    # int32 limbs; (size - 1) adds per column; compared as points
    def tree_record(name, kernel, plain, equal, p, point_bytes, imads_per_add):
        size, cols = p.x.shape[1], p.x.shape[2]
        sub: dict = {}
        t_ms = device_ms(torch, kernel, reps=10)
        t_plain_ms = cuda_ms(torch, plain, reps=1)
        mismatches = int((~equal(kernel(), plain())).sum())
        kernel_record(sub, "tree_reduce_lanes", "blitzar_tpu/ops/pallas_point.py:344",
                      "blitzar_tpu_torch/csrc/tree_reduce_lanes.cu", t_ms, t_plain_ms, mismatches,
                      (size + 1) * cols * point_bytes, (size - 1) * cols * imads_per_add, compared=f"{name} points")
        sub["tree_reduce_lanes"]["shape"] = [size, cols]
        return sub["tree_reduce_lanes"]

    results["tree_reduce_lanes"] = tree_record(
        "ristretto255", lambda: cp.tree_reduce_lanes(partials), lambda: cp.tree_reduce_lanes_plain(partials),
        ed.points_equal, partials, 256, MULS_ADD * IMAD_PER_FIELD_MUL)
    # and at (1024, 256), the partials' shape before the lookup's chunk rule
    # changed (its rows tiled from these partials), beside the earlier reading
    wide = ed.index_batch(partials, torch.arange(1024, device=dev) % k)
    results["tree_reduce_lanes"]["ristretto255_1024x256"] = tree_record(
        "ristretto255 (1024, 256)", lambda: cp.tree_reduce_lanes(wide), lambda: cp.tree_reduce_lanes_plain(wide),
        ed.points_equal, wide, 256, MULS_ADD * IMAD_PER_FIELD_MUL)
    del wide
    wscalars = torch.from_numpy(counter_scalars(CHUNK, 32)[None]).to(dev)
    results["w_lookup_msm_by_curve"], results["w_doubling_combine_by_curve"] = {}, {}
    results["w_build_table_by_curve"] = {}
    for curve in (wc.BLS12381_G1, wc.BN254_G1, wc.GRUMPKIN):
        wgens, _ = tiled_generators(curve, CHUNK, dev)
        # each curve's table build at a streamed chunk (plain on 512 groups
        # spread over it), limb for limb
        results["w_build_table_by_curve"][curve.name] = w_build_record(torch, dev, curve, wgens, w)
        wtable = cw.w_build_table(curve, wgens, w)
        wpartials = cw.w_lookup_msm(curve, wtable, wscalars, None, w)
        results["tree_reduce_lanes"][curve.name] = tree_record(
            curve.name, functools.partial(cw.w_tree_reduce_lanes, curve, wpartials),
            functools.partial(cw.w_tree_reduce_lanes_plain, curve, wpartials), curve.points_equal, wpartials,
            3 * curve.nlimbs * 4, MULS_WADD * IMAD_PER_MONT_MUL[curve.nlimbs // 2])
        # each curve's instantiation of the lookup (plain on 16 spread chunks)
        # and of the ladder (that chunk's 256 bit-row products) against plain
        imad = IMAD_PER_MONT_MUL[curve.nlimbs // 2]
        point_bytes = 3 * curve.nlimbs * 4
        sub: dict = {}
        ms = device_ms(torch, lambda: cw.w_lookup_msm(curve, wtable, wscalars, None, w))
        k = wpartials.x.shape[1]
        chunks = spread(16, k)
        plain_ms = cuda_ms(torch, lambda: cw.w_lookup_msm_plain(curve, wtable, wscalars, None, w, chunks), reps=1)
        err = point_err(curve.index_batch(wpartials, chunks), cw.w_lookup_msm_plain(curve, wtable, wscalars, None, w,
                                                                                    chunks))
        nonzero, touched = lookup_work(torch, wscalars, w, groups)
        kernel_record(sub, "w_lookup_msm", "blitzar_tpu/ops/pallas_point.py:636",
                      "blitzar_tpu_torch/csrc/w_lookup_msm.cu", ms, plain_ms, err,
                      wscalars.numel() + touched * point_bytes // 2 + wpartials.x.numel() * 4 * 3,
                      nonzero * MULS_WADD * imad, len(chunks) / k, compared=f"{curve.name} canonical limbs")
        results["w_lookup_msm_by_curve"][curve.name] = {**sub["w_lookup_msm"], "shape": [k, wpartials.x.shape[2]]}
        products = curve.reshape_batch(cw.w_tree_reduce_lanes(curve, wpartials), (1, -1))
        nbits = products.x.shape[2]
        ms = device_ms(torch, lambda: cw.w_doubling_combine(curve, products), reps=5)
        plain_ms = cuda_ms(torch, lambda: cw.w_doubling_combine_plain(curve, products), reps=1)
        err = point_err(cw.w_doubling_combine(curve, products), cw.w_doubling_combine_plain(curve, products))
        kernel_record(sub, "w_doubling_combine", "blitzar_tpu/msm/fixed.py:596 (pallas_point.py:907, :891)",
                      "blitzar_tpu_torch/csrc/w_doubling_combine.cu", ms, plain_ms, err, (nbits + 1) * point_bytes,
                      (nbits - 1) * (MULS_WDOUBLE + MULS_WADD) * imad, compared=f"{curve.name} canonical limbs")
        results["w_doubling_combine_by_curve"][curve.name] = sub["w_doubling_combine"]
        del wgens, wtable, wpartials
    return results


# ---------------------------------------------------------------------------
# handle files, packed and vlen queries, the generator disk cache
# ---------------------------------------------------------------------------

# the kernels of these paths, w_affine (a Weierstrass raw file's affine
# rows), the ristretto255 table conversions and ed_from_affine_rows (the
# affine cache file's load), which must launch there, and mont_mul_ew's
# instantiations in the Weierstrass base fields (a raw file read back); the
# field kernels fmul, fsq and finvert are held against plain but run on no
# path (fmul since the cache's load is one ed_from_affine_rows launch)
ED_FILE_KERNELS = ("ed_to_niels", "ed_file_rows", "ed_file_entries", "ed_niels_points", "ed_affine")
FILE_KERNELS = ("fmul", "fsq", "finvert", "w_affine", "ed_from_affine_rows") + ED_FILE_KERNELS
FILE_PATH_KERNELS = ("ed_from_affine_rows", "w_affine") + ED_FILE_KERNELS
# the kernels a ristretto255 table's conversion (a raw write or read, an npz
# read or write) and the disk cache's save and legacy load ran on before
# they took one launch a chunk
ED_FILE_CHAINS = ("fmul", "finvert")
# the launcher argument that holds the element count, where it is not the
# third from the end
ELEMENT_ARG = {"ed_niels_points": 1, "ed_affine": 4, "ed_from_affine_rows": 1}
FILE_INSTANCES = ("mont_mul_ew/bn254_fp", "mont_mul_ew/bls12381_fp", "w_affine/bls12_381_g1", "w_affine/bn254_g1",
                  "w_affine/grumpkin")
# Proof-of-SQL's column widths (505 bits, 64 bytes a generator) and lengths
POSQL_BITS = [1, 8, 16, 32, 64, 128, 256]
POSQL_LENGTHS = [1 << 10, 1 << 16, 1 << 18, (1 << 19) + 7, (1 << 20) - 3, 1 << 20, 1 << 20]
CACHE_VAR = "BLITZAR_TPU_TORCH_GENERATOR_CACHE_DIR"
# the handles of the raw files and of packed/vlen, and of the npz files
FILES_N = 1 << 20
FILES_NPZ_N = 1 << 16
# the plain versions of the field kernels run on at most this many elements
# of a shape, spread over all of them (2^20 at a kernel's headline shape)
FIELD_SAMPLE = 1 << 16
# finvert's counts, the element counts it ran at on the files path before
# ed_affine: a cache save's 2^20 generators and a legacy extended file's
# load of the smallest prefix a save writes
FINVERT_COUNTS = (1 << 16, 1 << 20)
LEGACY_N = FINVERT_COUNTS[0]
# 16-bit limbs of p = 2^255 - 19, of 2p, and of p with its lowest limb
# carried from the next (limbs below 2^17): three forms of 0
P_LIMBS = [0xFFED] + [0xFFFF] * 14 + [0x7FFF]
ZERO_FORMS = ([0] * 16, P_LIMBS, [0xFFDA] + [0xFFFF] * 15, [0x1FFED, 0xFFFE] + [0xFFFF] * 13 + [0x7FFF])


def finvert_operands(torch, dev, count: int, seed: int):
    """(16, count) int32 limbs for finvert: random 16-bit limbs (values up to
    2^256, many above p); every 7th element one of the three forms of 0
    (``ZERO_FORMS``, p and 2p among them) in turn, every 11th above 2^255
    with limbs up to 2^17; the last 4096 elements 0 (a batch inversion's
    whole runs of zeros)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(0, 1 << 16, (16, count), generator=gen, device=dev, dtype=torch.int32)
    wide = torch.arange(0, count, 11, device=dev)
    a[:, wide] = torch.randint(0, 1 << 17, (16, len(wide)), generator=gen, device=dev, dtype=torch.int32)
    a[15, wide] |= 0x8000
    forms = torch.tensor(ZERO_FORMS, dtype=torch.int32, device=dev).T  # (16, 4)
    zeros = torch.arange(0, count, 7, device=dev)
    a[:, zeros] = forms[:, torch.arange(len(zeros), device=dev) % forms.shape[1]]
    a[:, max(0, count - 4096):] = 0
    return a


def comparable(curve, points):
    """Result points as comparable values: compressed encodings for
    ristretto255, affine ints for a Weierstrass curve."""
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.ops import cuda_point as cp

    if curve is ed:
        return [bytes(r) for r in cp.ristretto_encode(points).cpu().numpy().T]
    return curve.to_affine_ints(points)


def own_scalars(bits: np.ndarray, bit_table, lengths=None) -> list:
    """Each output's own (n, ceil(bits / 8)) scalars cut from the unpacked
    (n, 8 num_bytes) bit matrix of a packed query, zeroed from its length
    on."""
    out, start = [], 0
    for o, nb in enumerate(bit_table):
        rows = np.packbits(bits[:, start : start + nb], axis=1, bitorder="little")
        if lengths is not None:
            rows[lengths[o]:] = 0
        out.append(rows)
        start += nb
    return out


def phase_files(torch, timings: dict, work: str) -> None:
    """(i) raw files at 2^20: ristretto255 (canonical generators, the
    pinned digest) and bn254 G1 (the 521 tiled points, the oracle); (ii) npz
    round trips at 2^16 and w = 16 raw files of 64 generators re-windowed
    to 8, all four curves; (iii) packed and vlen queries at 2^20 with
    Proof-of-SQL's column widths on the handles read back in (i), each
    output against the fixed MSM of its own scalars (bn254 G1 also against
    the oracle); (iv) the generator disk cache at 2^20: derive and save,
    then load with the in-memory cache cleared, and a commitment over the
    loaded generators; the cache is on for (iv) alone, in a fresh directory
    under ``work``. Every file is deleted once it is read."""
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.msm import engine, fixed, interop
    from blitzar_tpu_torch.ops import cuda_point as cp

    dev = api.device()
    torch.cuda.reset_peak_memory_stats()
    n, m = FILES_N, FILES_NPZ_N
    rows20 = counter_scalars(n, 32)

    def one_a_chunk(before, kernel, chunks, what):
        made = {k: cp.LAUNCHES[k] - before[k] for k in (kernel,) + ED_FILE_CHAINS}
        check(made == {kernel: chunks, **dict.fromkeys(ED_FILE_CHAINS, 0)},
              f"{what}: one {kernel} launch a chunk ({chunks}), no fmul or finvert launch ({made})")

    def raw_round_trip(curve, handle, key):
        path = os.path.join(work, f"{key}.raw")
        chunks = len(fixed.table_chunks(handle.table.shape[0], handle.table.shape[1]))
        before = dict(cp.LAUNCHES)
        with counting_plain_inversions() as inversions:
            _, timings[f"raw_{key}_write_ms"] = timed(torch, lambda: interop.write_reference_file(handle, path))
        if curve is ed:
            one_a_chunk(before, "ed_file_rows", chunks, f"(i)/(ii) the {key} write")
        else:
            made = {k: cp.LAUNCHES[k] - before[k] for k in ("w_affine", "mont_mul_ew")}
            check(made == {"w_affine": chunks, "mont_mul_ew": 0} and inversions["calls"] == 0,
                  f"(i)/(ii) the {key} write: one w_affine launch a chunk ({chunks}), no mont_mul_ew launch and no "
                  f"plain inversion ({made}, {inversions['calls']} plain inversions)")
        timings[f"raw_{key}_bytes"] = size = os.path.getsize(path)
        before = dict(cp.LAUNCHES)
        back, timings[f"raw_{key}_read_ms"] = timed(
            torch, lambda: api.multiexp_handle_new_from_file(api.CURVE_IDS[curve], path))
        if curve is ed:
            # the read's chunks are whole groups of the file, each its entries or, re-windowed, its w / 8
            # x 256 picked ones (interop.read_reference_file)
            w, rw = handle.window_width, interop.REWINDOW
            per_group = (w // rw) << rw if w > rw and w % rw == 0 else 1 << w
            read_chunks = len(fixed.table_chunks(handle.num_groups, per_group))
            one_a_chunk(before, "ed_file_entries", read_chunks, f"(i)/(ii) the {key} read")
        os.remove(path)
        entries = handle.num_groups << handle.window_width
        check(size == 4 + entries * interop.entry_words(curve) * 8 and back.device.type == dev.type,
              f"(i)/(ii) {key}: {size} bytes written (write {timings[f'raw_{key}_write_ms']:.0f} ms), "
              f"read back onto {back.device} (read {timings[f'raw_{key}_read_ms']:.0f} ms)")
        return back

    # (i) raw files at 2^20
    gens = generators.get_precomputed_generators(n, 0, dev)
    built = api.multiexp_handle_new(api.SXT_CURVE_RISTRETTO255, gens)
    ed_handle = raw_round_trip(ed, built, "ristretto255_2^20")
    check(torch.equal(ed_handle.table, built.table), "(i) ristretto255 2^20: the table read back equals the one written")
    del built
    got, ms = timed(torch, lambda: api.fixed_multiexponentiation(ed_handle, rows20[None]))
    check(digest(api.compress_ristretto255(got)) == PINNED_RISTRETTO_MSM[20],
          f"(i) the 2^20 handle read from a raw file reproduces the pinned digest ({ms:.1f} ms)")
    bn = wc.BN254_G1
    wgens, bn_pts = tiled_generators(bn, n, dev)
    built = api.multiexp_handle_new(api.SXT_CURVE_BN_254, wgens)
    bn_handle = raw_round_trip(bn, built, "bn254_g1_2^20")
    del built, wgens
    expected = bn.oracle.msm(collapsed_scalars(rows20), bn_pts)
    got, ms = timed(torch, lambda: api.fixed_multiexponentiation(bn_handle, rows20[None]))
    check(bn.to_affine_ints(got) == [expected],
          f"(i) the bn254 G1 2^20 handle read from a raw file equals the oracle's collapsed sum ({ms:.1f} ms)")

    # (ii) npz round trips at 2^16 (the pinned digest; a Weierstrass curve
    # its built handle's commitment), w = 16 files of 64 generators
    rows16 = counter_scalars(m, 32)
    rng = np.random.default_rng(42)
    for curve in (ed,) + wc.CURVES:
        name = "ristretto255" if curve is ed else curve.name
        cid = api.CURVE_IDS[curve]
        if curve is ed:
            g = generators.get_precomputed_generators(m, 0, dev)
            want = PINNED_RISTRETTO_MSM[16]
            answer = lambda res: digest(api.compress_ristretto255(res))  # noqa: E731
        else:
            g, pts = tiled_generators(curve, m, dev)
            answer = curve.to_affine_ints
        handle = api.multiexp_handle_new(cid, g)
        if curve is not ed:  # the built handle's own commitment (phase 6 holds it to the oracle)
            want = answer(api.fixed_multiexponentiation(handle, rows16[None]))
        path = os.path.join(work, f"{name}.npz")
        before = dict(cp.LAUNCHES)
        _, w_ms = timed(torch, lambda: api.multiexp_handle_write_to_file(handle, path))
        if curve is ed:
            one_a_chunk(before, "ed_niels_points", len(fixed.table_chunks(handle.num_groups, 256)),
                        f"(ii) the {name} 2^16 npz write")
        size = os.path.getsize(path)
        before = dict(cp.LAUNCHES)
        back, r_ms = timed(torch, lambda: api.multiexp_handle_new_from_file(cid, path))
        if curve is ed:
            one_a_chunk(before, "ed_to_niels", len(fixed.table_chunks(handle.num_groups, 256)),
                        f"(ii) the {name} 2^16 npz read")
        os.remove(path)
        timings[f"npz_{name}_2^16"] = {"write_ms": w_ms, "read_ms": r_ms, "bytes": size}
        check(torch.equal(back.table, handle.table) and answer(api.fixed_multiexponentiation(back, rows16[None])) == want,
              f"(ii) {name} 2^16 npz round trip: same table, same commitment ({size} bytes, write {w_ms:.0f} ms, "
              f"read {r_ms:.0f} ms)")
        g64 = curve.index_batch(g, slice(0, 64))
        wide = fixed.MultiexpHandle(g64, window_width=16, curve=curve)
        narrow = fixed.MultiexpHandle(g64, curve=curve)
        back = raw_round_trip(curve, wide, f"{name}_w16_64")
        sc = rng.integers(0, 256, size=(2, 64, 32), dtype=np.uint8)
        same = comparable(curve, api.fixed_multiexponentiation(back, sc)) == comparable(
            curve, api.fixed_multiexponentiation(narrow, sc))
        if curve is ed:
            same = same and torch.equal(back.table, narrow.table)
        else:
            vals = [[int.from_bytes(bytes(r), "little") for r in rows] for rows in sc]
            same = same and comparable(curve, api.fixed_multiexponentiation(back, sc)) == [
                curve.oracle.msm(v, pts[:64]) for v in vals]
        check((back.window_width, back.num_groups) == (8, 8) and same,
              f"(ii) {name}: a w = 16 file of 64 generators reads back as the w = 8 handle")
        del handle, back, wide, narrow, g

    # (iii) packed and vlen at 2^20 on the handles read back in (i)
    packed = np.random.default_rng(43).integers(0, 256, size=(n, 64), dtype=np.uint8)
    bits = np.unpackbits(packed, axis=1, bitorder="little")
    for curve, handle in ((ed, ed_handle), (bn, bn_handle)):
        name = "ristretto255" if curve is ed else curve.name
        for kind, lengths in (("packed", None), ("vlen", POSQL_LENGTHS)):
            before = dict(cp.LAUNCHES)
            if lengths is None:
                got, ms = timed(torch, lambda: api.fixed_packed_multiexponentiation(handle, POSQL_BITS, n, packed))
            else:
                got, ms = timed(torch, lambda: api.fixed_vlen_multiexponentiation(handle, POSQL_BITS, lengths, packed))
            if curve is bn:
                check_one_ladder(before, f"(iii) {kind} {name} 2^20 query")
            scalars = own_scalars(bits, POSQL_BITS, lengths)
            each, each_ms = timed(torch, lambda: [api.fixed_multiexponentiation(handle, s[None]) for s in scalars])
            each = [comparable(curve, p)[0] for p in each]
            timings[f"{kind}_{name}_2^20_ms"] = ms
            timings[f"{kind}_{name}_2^20_per_output_msms_ms"] = each_ms
            ok = comparable(curve, got) == each
            if curve is bn:
                ok = ok and each == [bn.oracle.msm(collapsed_scalars(s), bn_pts) for s in scalars]
            check(ok, f"(iii) {kind} {name} 2^20, widths {POSQL_BITS}: each output equals the MSM of its own "
                      f"scalars{' and the oracle' if curve is bn else ''} ({ms:.1f} ms; seven MSMs {each_ms:.1f} ms)")
    del ed_handle, bn_handle, bits
    timings["files_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # (iv) the generator disk cache at 2^20, off by default, here in a fresh
    # directory
    generators.CACHE.reset()
    engine.clear_handle_cache()
    ref, timings["generators_2^20_derive_ms"] = timed(torch, lambda: generators.ristretto_generators(n, 0, dev))
    cache_dir = os.path.join(work, "gencache")
    generators.DISK_DIR = cache_dir
    before = dict(cp.LAUNCHES)
    _, timings["generators_2^20_derive_and_save_ms"] = timed(
        torch, lambda: generators.ristretto_generators(n, 0, dev))
    one_a_chunk(before, "ed_affine", 1, "(iv) the 2^20 cache save")
    saved = os.path.join(cache_dir, f"ristretto_gen_a_{n}.npy")
    check(os.path.exists(saved), f"(iv) 2^20 generators saved to the disk cache "
                                 f"({timings['generators_2^20_derive_and_save_ms']:.1f} ms with the derivation, "
                                 f"{timings['generators_2^20_derive_ms']:.1f} ms without the save)")
    generators.CACHE.reset()
    derived = cp.LAUNCHES["elligator_form"]
    before = dict(cp.LAUNCHES)
    loaded, timings["generators_2^20_load_ms"] = timed(torch, lambda: generators.get_precomputed_generators(n, 0, dev))
    made = {k: cp.LAUNCHES[k] - before[k] for k in ("ed_from_affine_rows",) + ED_FILE_CHAINS + ("ed_affine",)}
    check(made == {"ed_from_affine_rows": 1, "fmul": 0, "finvert": 0, "ed_affine": 0},
          f"(iv) the 2^20 load: one ed_from_affine_rows launch on the file's uint16 rows, no fmul, finvert or "
          f"ed_affine launch ({made})")
    check(cp.LAUNCHES["elligator_form"] == derived and bool(ed.points_equal(loaded, ref).all()),
          f"(iv) loaded, not derived, with the in-memory cache cleared: the same 2^20 points "
          f"({timings['generators_2^20_load_ms']:.1f} ms)")

    generators.CACHE.reset()
    desc = api.SequenceDescriptor(32, n, rows20)
    got, ms = timed(torch, lambda: api.compute_curve25519_commitments([desc]))
    check(cp.LAUNCHES["elligator_form"] == derived and digest(got) == PINNED_RISTRETTO_MSM[20],
          f"(iv) a cold 2^20 commitment over cache-loaded generators equals the pinned digest ({ms:.1f} ms)")
    timings["commit_2^20_cold_from_disk_cache_ms"] = ms
    # a legacy extended file (blitzar_tpu's (4, 16, n) uint32 limbs) of the
    # first 2^16 generators, z as derived: its load normalises z by ed_affine
    legacy_n = LEGACY_N
    np.save(os.path.join(cache_dir, f"ristretto_gen_{legacy_n}.npy"),
            np.stack([F.canonicalize(c[:, :legacy_n]).cpu().numpy().astype(np.uint32) for c in ref]))
    generators.CACHE.reset()
    before = dict(cp.LAUNCHES)
    legacy, timings["generators_2^16_legacy_load_ms"] = timed(
        torch, lambda: generators.get_precomputed_generators(legacy_n, 0, dev))
    one_a_chunk(before, "ed_affine", 1, "(iv) the legacy 2^16 load")
    check(cp.LAUNCHES["elligator_form"] == derived
          and bool(ed.points_equal(legacy, ed.index_batch(ref, slice(0, legacy_n))).all()),
          f"(iv) a legacy extended file of 2^16 generators loads with one ed_affine launch: the same points "
          f"({timings['generators_2^16_legacy_load_ms']:.1f} ms)")
    generators.DISK_DIR = ""
    generators.CACHE.reset()
    clear_handles(torch)


@contextlib.contextmanager
def counting_plain_inversions():
    """Counts the calls of the plain Montgomery inversion (``MontField.inv``)
    on a card's tensors while the block runs."""
    from blitzar_tpu_torch.fields import mont

    inv = mont.MontField.inv
    seen = {"calls": 0}

    def counting(self, a):
        seen["calls"] += a.device.type == "cuda"
        return inv(self, a)

    mont.MontField.inv = counting
    try:
        yield seen
    finally:
        mont.MontField.inv = inv


def affine_chunk(torch, curve, groups: int, entries: int, dev, seed: int):
    """A (groups, entries, 3, K) table chunk of random canonical projective
    coordinates; entry 0 of every group is the identity (0, 1, 0), as in a
    partition table."""
    from blitzar_tpu_torch.curves.weierstrass import PointP2
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    f = curve.field
    x, y, z = (random_canonical(torch, f, (groups, entries), dev, seed + k) for k in range(3))
    x[:, :, 0], z[:, :, 0] = 0, 0
    y[:, :, 0] = f.one((groups,), dev)
    return cw.pack_points(PointP2(x, y, z))


def w_affine_shape(torch, dev, curve, groups: int, entries: int, launches: int) -> dict:
    """w_affine on a chunk of groups x entries: its device time, its bound
    (5 field multiplies an entry and one inversion; 3K words read, 2K
    written an entry), and every row against the plain version, run on
    slices of at most 2^20 entries (the plain version's time: their sum)."""
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    chunk = affine_chunk(torch, curve, groups, entries, dev, 47)
    count, words = groups * entries, curve.nlimbs // 2
    ms = device_ms(torch, lambda: cw.w_affine(curve, chunk), reps=5)
    rows = cw.w_affine(curve, chunk)
    step = max(1, (1 << 20) // entries)
    err, plain_ms = 0, 0.0
    for g0 in range(0, groups, step):
        want, t = timed(torch, lambda: cw.w_affine_plain(curve, chunk[g0 : g0 + step]))
        plain_ms += t
        err = max(err, int((rows[g0 * entries : (g0 + step) * entries] != want).sum()))
    m2 = curve.field.modulus - 2
    inversion = m2.bit_length() - 1 + bin(m2).count("1") - 1
    b_ms, b_by = bound(count * 5 * words * 4, (5 * count + inversion) * IMAD_PER_MONT_MUL[words])
    check(err == 0, f"w_affine {curve.name} at {groups} x {entries} entries, {launches} launches on the files path: "
                    f"equal to plain on every row, tolerance 0 on the file's words ({ms:.4f} ms, bound {b_ms:.4f})")
    return {"instance": curve.name, "groups": groups, "entries": count, "launches": launches, "ms": ms,
            "plain_ms": plain_ms, "plain_fraction": 1.0, "max_abs_err": float(err), "bound_ms": b_ms,
            "bound_by": b_by, "bytes": count * 5 * words * 4, "imads": (5 * count + inversion) * IMAD_PER_MONT_MUL[words]}


@contextlib.contextmanager
def launch_shapes(counts: dict):
    """Counts, beside the wrappers' own counts, the launches of the field
    kernels, the ristretto255 conversions and mont_mul_ew by kernel (and
    instantiation) and element count into ``counts``: {"fmul": {elements:
    launches}, ...}. The element count is the launcher's third argument
    from the end, or ``ELEMENT_ARG``'s."""
    from blitzar_tpu_torch.ops import cuda_field as cf
    from blitzar_tpu_torch.ops import cuda_mont as cm
    from blitzar_tpu_torch.ops import cuda_point as cp

    inner = cp._launch

    def launch(name, fn, *args, instance=None):
        inner(name, fn, *args, instance=instance)
        if name in FILE_KERNELS or name == "mont_mul_ew":
            by = counts.setdefault(f"{name}/{instance}" if instance else name, {})
            elements = int(args[ELEMENT_ARG.get(name, -3)])
            by[elements] = by.get(elements, 0) + 1

    cf._launch = cm._launch = cp._launch = launch
    try:
        yield counts
    finally:
        cf._launch = cm._launch = cp._launch = inner


def field_shape(torch, dev, kernel, plain, operands, count: int, bytes_moved: float, imads: float,
                canonical=lambda t: t, sample_count: int = FIELD_SAMPLE) -> dict:
    """One elementwise kernel at ``count`` elements: its device time, its
    bound, and its largest limb difference from its plain version on
    min(count, sample_count) elements spread over all of them (the plain
    version's time on those). ``operands(count)`` makes the inputs on the
    card; an operand of one element is broadcast and not sampled."""
    ops = operands(count)
    sample = spread_indices(torch, dev, min(count, sample_count), count)
    picked = [o[:, sample] if o.shape[1] == count else o for o in ops]
    ms = device_ms(torch, lambda: kernel(*ops))
    plain_ms = cuda_ms(torch, lambda: plain(*picked), reps=1)
    err = int((canonical(kernel(*ops)[:, sample]).long() - canonical(plain(*picked)).long()).abs().max())
    b_ms, b_by = bound(bytes_moved, imads)
    return {"elements": count, "ms": ms, "plain_ms": plain_ms, "plain_fraction": len(sample) / count,
            "max_abs_err": float(err), "bound_ms": b_ms, "bound_by": b_by}


def phase_field_kernels(torch, dev, path_shapes: dict, affine_shapes: dict) -> dict:
    """The field kernels and the base-field mont_mul_ew against their plain
    versions, timed at every element count the files path launched them at
    (``path_shapes``, from :func:`launch_shapes`) and at a headline shape:
    ``fmul`` at a table conversion's chunk (``fixed.TABLE_CHUNK_ENTRIES``
    entries; also with a broadcast constant), ``fsq`` (on no path) at the
    same chunk, ``finvert`` at the 2^20 generators of a cache save,
    ``mont_mul_ew`` at the largest count its field launched. Per count:
    launches, device time and bound, and the path's device time, the sum of
    launches x time. ``w_affine`` at every (curve, entries) of
    ``affine_shapes`` (PATH_SHAPES' files-path counts) and at a 2^22-entry
    chunk of each curve (2^14 groups of 256), its headline bn254 G1's."""
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.fields import params
    from blitzar_tpu_torch.msm import fixed
    from blitzar_tpu_torch.ops import cuda_field as cf
    from blitzar_tpu_torch.ops import cuda_mont as cm

    results: dict = {}
    gen = torch.Generator(device=dev).manual_seed(44)

    def limbs(count):
        return torch.randint(0, 1 << 16, (16, count), generator=gen, device=dev, dtype=torch.int32)

    chunk = fixed.TABLE_CHUNK_ENTRIES
    kinds = {  # kernel, plain, operands, bytes and int32 multiplies an element, headline count
        "fmul": (cf.fmul, cf.fmul_plain, lambda c: (limbs(c), limbs(c)), 96, IMAD_PER_FIELD_MUL, chunk),
        "fsq": (cf.fsq, cf.fsq_plain, lambda c: (limbs(c),), 64, IMAD_PER_FIELD_MUL, chunk),
        # the least work that inverts a batch is a batch inversion: three
        # multiplies an element and one inversion
        "finvert": (cf.finvert, cf.finvert_plain, lambda c: (finvert_operands(torch, dev, c, 44),), 64,
                    MULS_BATCH_INVERT_PER_ELEMENT * IMAD_PER_FIELD_MUL, FILES_N),
    }
    replaces = {"fmul": 130, "fsq": 144, "finvert": 172}
    sources = {"fmul": "fmul.cu", "fsq": "fmul.cu", "finvert": "finvert.cu"}
    for name, (kernel, plain, operands, per_bytes, per_imads, head) in kinds.items():
        launched = path_shapes.get(name, {})
        extra = MULS_INVERT * IMAD_PER_FIELD_MUL if name == "finvert" else 0
        by = {}
        counts = set(launched) | {head} | (set(FINVERT_COUNTS) if name == "finvert" else set())
        for count in sorted(counts):
            # finvert on every element: its zeros and non-canonical forms among them
            by[count] = field_shape(torch, dev, kernel, plain, operands, count, count * per_bytes,
                                    count * per_imads + extra, F.canonicalize,
                                    1 << 20 if count == head or name == "finvert" else FIELD_SAMPLE)
            by[count]["launches"] = launched.get(count, 0)
            check(by[count]["max_abs_err"] == 0, f"{name} at {count} elements: kernel equals plain, tolerance 0 "
                                                 f"on canonical limbs ({by[count]['ms']:.4f} ms)")
        top = by[head]
        kernel_record(results, name, f"blitzar_tpu/ops/pallas_point.py:{replaces[name]}",
                      f"blitzar_tpu_torch/csrc/{sources[name]}", top["ms"], top["plain_ms"], top["max_abs_err"],
                      head * per_bytes, head * per_imads + extra, top["plain_fraction"])
        results[name]["elements"] = head
        results[name]["by_elements"] = {str(c): r for c, r in by.items()}
        results[name]["files_path_device_ms"] = sum(r["launches"] * r["ms"] for r in by.values())
    c = limbs(1)
    results["fmul"]["broadcast"] = field_shape(torch, dev, cf.fmul, cf.fmul_plain, lambda k: (limbs(k), c), chunk,
                                               chunk * 64, chunk * IMAD_PER_FIELD_MUL, F.canonicalize)
    check(results["fmul"]["broadcast"]["max_abs_err"] == 0, "fmul with a broadcast constant equals plain")
    results["finvert"]["kernel_multiplies_per_element"] = MULS_INVERT

    base = {}
    for field in (params.BN254_FP, params.BLS12381_FP):
        launched = path_shapes.get(f"mont_mul_ew/{field.name}", {})
        words = field.nlimbs // 2

        def operands(count, field=field):
            return tuple(random_canonical(torch, field, (count,), dev, seed) for seed in (45, 46))

        by = {}
        for count in sorted(launched):
            by[count] = field_shape(torch, dev, functools.partial(cm.mont_mul_ew, field),
                                    functools.partial(cm.mont_mul_ew_plain, field), operands, count,
                                    count * 3 * words * 4, count * IMAD_PER_MONT_MUL[words])
            by[count]["launches"] = launched[count]
            check(by[count]["max_abs_err"] == 0, f"mont_mul_ew in {field.name} at {count} elements: kernel equals "
                                                 f"plain, tolerance 0 on canonical limbs ({by[count]['ms']:.4f} ms)")
        base[field.name] = {"by_elements": {str(c): r for c, r in by.items()},
                            "files_path_device_ms": sum(r["launches"] * r["ms"] for r in by.values())}
    results["mont_mul_ew_base_fields"] = base

    from blitzar_tpu_torch.curves import weierstrass as wc

    launched = shape_paths(affine_shapes)
    chunk = fixed.TABLE_CHUNK_ENTRIES
    by = {}
    for curve in wc.CURVES:
        shapes = {count for (name, count) in launched if name == curve.name} | {chunk}
        for count in sorted(shapes):
            entries = 1 << 16 if count < chunk else 256  # the w16_64 files' groups, else w = 8's
            n = sum(launched.get((curve.name, count), {}).values())
            by[f"{curve.name}/{count}"] = w_affine_shape(torch, dev, curve, count // entries, entries, n)
        torch.cuda.empty_cache()
    top = by[f"bn254_g1/{chunk}"]
    kernel_record(results, "w_affine", "blitzar_tpu/ops/pallas_point.py:1139",
                  "blitzar_tpu_torch/csrc/w_affine.cu", top["ms"], top["plain_ms"], top["max_abs_err"], top["bytes"],
                  top["imads"])
    results["w_affine"]["elements"] = chunk
    results["w_affine"]["by_elements"] = by
    results["w_affine"]["files_path_device_ms"] = sum(r["launches"] * r["ms"] for r in by.values())
    return results


# the generator cache's load at the files path's counts and at its headline
# (a 2^20 file): 64 bytes read and four coordinates of 16 int32 limbs
# written a generator, one field multiply (x y)
CACHE_LOAD_HEAD = FILES_N
CACHE_LOAD_BYTES = 64 + 4 * 64


def phase_cache_load_kernel(torch, dev, path_shapes: dict) -> dict:
    """``ed_from_affine_rows`` at every element count the files path
    launched it at (``path_shapes``, from :func:`launch_shapes`) and at
    ``CACHE_LOAD_HEAD``: device time, bound, launches, and every generator
    against the plain version (tolerance 0 on canonical limbs; the plain
    version's time: its sum over slices of 2^18 generators). The rows are
    the canonical affine x and y of the first generators, as a cache file
    holds them, with the last 64 set to 0xFFFF limbs (2^256 - 1, a value
    the file's limbs can hold that is not canonical)."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.ops import cuda_point as cp

    launched = path_shapes.get("ed_from_affine_rows", {})
    by = {}
    for count in sorted(set(launched) | {CACHE_LOAD_HEAD}):
        affine = cp.ed_affine(generators.get_precomputed_generators(count, 0, dev))
        host = np.stack([affine.x.cpu().numpy(), affine.y.cpu().numpy()]).astype(np.uint16)
        host[:, :, -64:] = 0xFFFF
        rows = torch.from_numpy(host).to(dev)
        del affine
        ms = device_ms(torch, lambda: cp.ed_from_affine_rows(rows), reps=5)
        got = cp.ed_from_affine_rows(rows)
        err, plain_ms, step = 0, 0.0, 1 << 18
        for s0 in range(0, count, step):
            want, t = timed(torch, lambda: cp.ed_from_affine_rows_plain(rows[:, :, s0 : s0 + step]))
            plain_ms += t
            err = max(err, max(int((g[:, s0 : s0 + step].long() - w.long()).abs().max()) for g, w in zip(got, want)))
        b_ms, b_by = bound(count * CACHE_LOAD_BYTES, count * IMAD_PER_FIELD_MUL)
        check(err == 0, f"ed_from_affine_rows at {count} generators, {launched.get(count, 0)} launches on the "
                        f"files path: equal to plain on every generator, tolerance 0 on canonical limbs "
                        f"({ms:.4f} ms, bound {b_ms:.4f})")
        by[count] = {"elements": count, "launches": launched.get(count, 0), "ms": ms, "plain_ms": plain_ms,
                     "plain_fraction": 1.0, "max_abs_err": float(err), "bound_ms": b_ms, "bound_by": b_by}
        del rows, got
    results: dict = {}
    top = by[CACHE_LOAD_HEAD]
    kernel_record(results, "ed_from_affine_rows", "blitzar_tpu/ops/pallas_point.py:130",
                  "blitzar_tpu_torch/csrc/ed_convert.cu", top["ms"], top["plain_ms"], top["max_abs_err"],
                  CACHE_LOAD_HEAD * CACHE_LOAD_BYTES, CACHE_LOAD_HEAD * IMAD_PER_FIELD_MUL)
    results["ed_from_affine_rows"]["elements"] = CACHE_LOAD_HEAD
    results["ed_from_affine_rows"]["by_elements"] = {str(c): r for c, r in by.items()}
    results["ed_from_affine_rows"]["files_path_device_ms"] = sum(r["launches"] * r["ms"] for r in by.values())
    torch.cuda.empty_cache()
    return results


# field multiplies a ristretto255 conversion needs an entry at its least,
# and the bytes it moves an entry (each input it needs read once, its output
# written once): ed_to_niels a batch inversion's 3, x/z, y/z, x*y and
# 2d*x*y (and one inversion a chunk), reading x, y and z (16 int32 limbs
# each) and writing 96 bytes of words; ed_file_rows (a - b)/2, (a + b)/2 and
# x*y, reading a and b and writing a 120-byte row; ed_file_entries x*y and
# 2d*x*y, reading the row's X and Y and writing the words; ed_niels_points
# (a - b)/2, (a + b)/2 and x*y, reading a and b and writing four
# coordinates; ed_affine a batch inversion's 3, x/z, y/z and x*y (and one
# inversion a call), reading x, y and z and writing four coordinates
CONVERSIONS = {"ed_to_niels": (7, 3 * 64 + 96), "ed_file_rows": (3, 64 + 120), "ed_file_entries": (2, 80 + 96),
               "ed_niels_points": (3, 64 + 4 * 64), "ed_affine": (6, 3 * 64 + 4 * 64)}
INVERTING = ("ed_to_niels", "ed_affine")
# each conversion's headline: a 2^22-entry table chunk (the raw files and
# the npz read), the 2^16 npz write's one chunk of 2^21, a cache save's 2^20
CONVERSION_HEADS = {"ed_to_niels": 1 << 22, "ed_file_rows": 1 << 22, "ed_file_entries": 1 << 22,
                    "ed_niels_points": 1 << 21, "ed_affine": 1 << 20}
CONVERSION_REPLACES = {"ed_affine": 172}


def ed_conversion_chunk(torch, dev, count: int, seed: int):
    """(16, count / 256, 256) extended points on the card (a table chunk's
    groups of 256 entries; one group of ``count`` below 256): elligator
    points each scaled by a random factor, so z != 1."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    r0, r1 = generators._xorshift_limbs(torch.arange(seed, seed + count, device=dev))
    pts = cp.elligator_form(r0, r1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(1, 1 << 16, (16, count), generator=gen, device=dev, dtype=torch.int32)
    entries = 256 if count % 256 == 0 else count
    return ed.reshape_batch(ed.PointP3(*(F.mul(c, k) for c in pts)), (count // entries, entries))


def entry_rows(torch, out, count: int):
    """A conversion's output as (count, words) rows: niels words and file
    rows as they are, points as their four coordinates' 64 limbs an entry."""
    if isinstance(out, torch.Tensor):
        return out.reshape(count, -1)
    return torch.stack([c.reshape(16, count) for c in out]).reshape(64, count).T


def phase_conversion_kernels(torch, dev, path_shapes: dict) -> dict:
    """The five ristretto255 conversions at every element count the files
    path launched them at (``path_shapes``, from :func:`launch_shapes`) and
    at their headlines (``CONVERSION_HEADS``): device time, bound, launches,
    and every entry against the plain version, tolerance 0 on the words and
    canonical limbs (the plain version's time: its sum over slices of 2^20
    entries). The inputs chain: a chunk of extended points (``ed_affine``'s
    input, flat), its niels words (``ed_niels_points``'), their file rows."""
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.ops import cuda_point as cp

    counts = sorted(set().union(*(path_shapes.get(k, {}) for k in ED_FILE_KERNELS)) | set(CONVERSION_HEADS.values()))
    by: dict = {name: {} for name in ED_FILE_KERNELS}
    step = 1 << 20

    def part(name, x, lo, hi):
        if name == "ed_to_niels":
            v = x.x.shape[2]
            return ed.index_batch(x, slice(lo // v, hi // v))
        if name == "ed_affine":
            return ed.index_batch(x, slice(lo, hi))
        return x.reshape(-1, 3, 8)[lo:hi] if name in ("ed_file_rows", "ed_niels_points") else x[lo:hi]

    for count in counts:
        chunk = ed_conversion_chunk(torch, dev, count, 48)
        words = cp.ed_to_niels(chunk)
        inputs = {"ed_to_niels": chunk, "ed_file_rows": words, "ed_file_entries": cp.ed_file_rows(words),
                  "ed_niels_points": words, "ed_affine": ed.reshape_batch(chunk, (count,))}
        for name in ED_FILE_KERNELS:
            launched = path_shapes.get(name, {})
            if count != CONVERSION_HEADS[name] and count not in launched:
                continue
            kernel, plain, x = getattr(cp, name), getattr(cp, f"{name}_plain"), inputs[name]
            ms = device_ms(torch, lambda: kernel(x), reps=5)
            got = entry_rows(torch, kernel(x), count)
            err, plain_ms = 0, 0.0
            for lo in range(0, count, step):
                want, t = timed(torch, lambda: plain(part(name, x, lo, lo + step)))
                plain_ms += t
                err = max(err, int((got[lo : lo + step] != entry_rows(torch, want, min(step, count - lo))).sum()))
            muls, per_bytes = CONVERSIONS[name]
            imads = (count * muls + (MULS_INVERT if name in INVERTING else 0)) * IMAD_PER_FIELD_MUL
            b_ms, b_by = bound(count * per_bytes, imads)
            check(err == 0, f"{name} at {count} entries, {launched.get(count, 0)} launches on the files path: equal "
                            f"to plain on every entry, tolerance 0 ({ms:.4f} ms, bound {b_ms:.4f})")
            by[name][count] = {"elements": count, "launches": launched.get(count, 0), "ms": ms, "plain_ms": plain_ms,
                               "plain_fraction": 1.0, "max_abs_err": float(err), "bound_ms": b_ms, "bound_by": b_by,
                               "bytes": count * per_bytes, "imads": imads}
        del chunk, words, inputs
        torch.cuda.empty_cache()
    results: dict = {}
    for name in ED_FILE_KERNELS:
        head = CONVERSION_HEADS[name]
        top = by[name][head]
        kernel_record(results, name, f"blitzar_tpu/ops/pallas_point.py:{CONVERSION_REPLACES.get(name, 130)}",
                      "blitzar_tpu_torch/csrc/ed_convert.cu", top["ms"], top["plain_ms"], top["max_abs_err"],
                      top["bytes"], top["imads"], compared="words and canonical limbs")
        results[name]["elements"] = head
        results[name]["by_elements"] = {str(c): r for c, r in by[name].items()}
        results[name]["files_path_device_ms"] = sum(r["launches"] * r["ms"] for r in by[name].values())
    return results


# ---------------------------------------------------------------------------
# the bucket engine and the few-row partition query
# ---------------------------------------------------------------------------

# the kernels that only these paths launch, each required on its own path
# (the bucket path's window sums and Horner: ed_window_sums, w_window_sums,
# ed_horner, w_horner), and the one-point doublings its Horner ran on
# before, which must not launch there
HORNER_KERNELS = ("ed_horner", "w_horner")
WINDOW_KERNELS = ("ed_window_sums", "w_window_sums")
HORNER_STEP_KERNELS = ("ed_double", "wdouble")
BUCKET_KERNELS = HORNER_KERNELS + WINDOW_KERNELS + HORNER_STEP_KERNELS
FEWROW_KERNELS = ("niels_add", "fewrow_niels")
MULS_NIELS_ADD = 8
QUERY_REPS = 5


@contextlib.contextmanager
def bucket_engine():
    """BLITZAR_TPU_TORCH_MSM_ENGINE=bucket inside the block alone."""
    from blitzar_tpu_torch.msm import engine

    os.environ[engine.ENGINE_VAR] = "bucket"
    try:
        yield
    finally:
        os.environ.pop(engine.ENGINE_VAR, None)


@contextlib.contextmanager
def counted(*totals):
    """One main-path call: the counts start from 0 just before it and are
    added to each dict of totals just after, so the reference and timing
    calls around it stay out of the path's launches."""
    from blitzar_tpu_torch.ops import cuda_point as cp

    cp.reset_launches()
    was, PATH_SHAPES.on = PATH_SHAPES.on, True
    try:
        yield
    finally:
        PATH_SHAPES.on = was
    for total in totals:
        for k, v in cp.LAUNCHES.items():
            total[k] = total.get(k, 0) + v


@contextlib.contextmanager
def horner_calls():
    """Records each call of the bucket engine's Horner (``engine.horner``)
    while the block runs: its curve, (outputs, windows) and the launches the
    call made."""
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import cuda_point as cp

    inner, calls = engine.horner, []

    def recording(windows, curve=engine.ed):
        before = dict(cp.LAUNCHES)
        out = inner(windows, curve)
        calls.append({"curve": "ristretto255" if curve is engine.ed else curve.name,
                      "shape": list(windows.x.shape[1:]),
                      "launches": {k: v - before[k] for k, v in cp.LAUNCHES.items() if v != before[k]}})
        return out

    engine.horner = recording
    try:
        yield calls
    finally:
        engine.horner = inner


@contextlib.contextmanager
def combine_calls():
    """Records each call of the bucket engine's combine
    (``engine.combine_buckets``: the window sums and the Horner) while the
    block runs: its curve, rows and the launches the call made."""
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import cuda_point as cp

    inner, calls = engine.combine_buckets, []

    def recording(bucket_sums, num_outputs, num_windows, curve=engine.ed):
        before = dict(cp.LAUNCHES)
        out = inner(bucket_sums, num_outputs, num_windows, curve)
        calls.append({"curve": "ristretto255" if curve is engine.ed else curve.name,
                      "rows": int(bucket_sums.x.shape[1]),
                      "launches": {k: v - before[k] for k, v in cp.LAUNCHES.items() if v != before[k]}})
        return out

    engine.combine_buckets = recording
    try:
        yield calls
    finally:
        engine.combine_buckets = inner


@contextlib.contextmanager
def lookup_routing():
    """Every query to its lookup kernel, as the port routed them before the
    few-row query: the routing's end-to-end cost is timed against this."""
    from blitzar_tpu_torch.msm import fixed

    saved = fixed.lookup_msm_fits, fixed.w_lookup_msm_fits
    fixed.lookup_msm_fits = fixed.w_lookup_msm_fits = lambda *a: True
    try:
        yield
    finally:
        fixed.lookup_msm_fits, fixed.w_lookup_msm_fits = saved


@contextlib.contextmanager
def entry_gathers():
    """Records each call of ``fixed.chunk_entries`` (the few-row query's
    gather of selected entries) while the block runs."""
    from blitzar_tpu_torch.msm import fixed

    inner, calls = fixed.chunk_entries, []
    fixed.chunk_entries = lambda *a, **k: calls.append(1) or inner(*a, **k)
    try:
        yield calls
    finally:
        fixed.chunk_entries = inner


def median_ms(torch, fn, reps: int = QUERY_REPS) -> tuple:
    """(the last result, the median host-clock time of reps calls of fn)."""
    times = []
    for _ in range(reps):
        out, ms = timed(torch, fn)
        times.append(ms)
    return out, float(np.median(times))


def phase_bucket(torch, timings: dict) -> dict:
    """(a) the bucket engine through the commitment entries: the pinned
    ristretto255 digests at 2^16, 2^20 (cold, warm, split) and 100000 x 10;
    a signed 2^20 column against the default engine; a skewed 2^16 column
    (one scalar everywhere: each window's one bucket holds every point, so
    the accumulation takes many rounds) against the default engine; bn254 G1
    at 2^16 against the oracle's collapsed sum. Returns the launches of
    the bucket-engine commitments of one call each (not the timing reps)."""
    from blitzar_tpu_torch import api
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import cuda_point as cp

    launches = dict.fromkeys(cp.KERNELS, 0)

    def commit(descs, count=True):
        with bucket_engine(), counted(launches) if count else contextlib.nullcontext():
            return api.compute_curve25519_commitments(descs)

    for log_n in (16, 20):
        n = 1 << log_n
        desc = api.SequenceDescriptor(32, n, counter_scalars(n, 32))
        got, ms = timed(torch, lambda: commit([desc]))
        check(digest(got) == PINNED_RISTRETTO_MSM[log_n],
              f"(a) bucket engine: the 2^{log_n} commitment equals the pinned digest ({ms:.1f} ms)")
        timings[f"bucket_commit_2^{log_n}_ms"] = ms
    got, timings["bucket_commit_2^20_warm_ms_median"] = median_ms(torch, lambda: commit([desc], False), 3)
    stages = {"sort": [(engine, "sort_digits")], "gather": [(engine, "gather_slab")],
              "accumulate": [(engine, "bucket_accumulate")], "window_sums": [(engine, "window_sums")],
              "horner": [(engine, "horner")]}
    with StageTimer(torch, stages) as st:
        again, total = timed(torch, lambda: commit([desc], False))
    check(digest(again) == PINNED_RISTRETTO_MSM[20], "(a) bucket engine: the split 2^20 commitment equals the pinned digest")
    split = dict(st.ms)
    split["slab_reduce_and_round_adds"] = split.pop("accumulate") - split["sort"] - split["gather"]
    timings["bucket_commit_2^20_split_ms"] = {"total": total, **split,
                                              "host_and_rest": total - sum(split.values())}

    n, outputs = 100000, 10
    descs = [api.SequenceDescriptor(32, n, counter_scalars(n, 32, output=o)) for o in range(outputs)]
    got, timings["bucket_commit_100000x10_ms"] = timed(torch, lambda: commit(descs))
    check(digest(got) == PINNED_PEDERSEN_100000_10_32,
          f"(a) bucket engine: n = 100000 x 10 equals the pinned digest ({timings['bucket_commit_100000x10_ms']:.1f} ms)")

    n = 1 << 20
    vals = np.random.default_rng(23).integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
    desc = api.SequenceDescriptor(8, n, vals.astype("<i8").view(np.uint8).reshape(n, 8), True)
    got, timings["bucket_commit_signed_2^20_ms"] = timed(torch, lambda: commit([desc]))
    check(np.array_equal(got, api.compute_curve25519_commitments([desc])),
          f"(a) bucket engine: a signed 8-byte 2^20 column equals the default engine's "
          f"({timings['bucket_commit_signed_2^20_ms']:.1f} ms)")

    n = 1 << 16
    rows = np.repeat(counter_scalars(1, 32, output=12345), n, axis=0)
    desc = api.SequenceDescriptor(32, n, rows)
    rounds = []
    inner = engine.gather_slab
    engine.gather_slab = lambda *a, **k: rounds.append(a[5]) or inner(*a, **k)
    try:
        got, timings["bucket_commit_skewed_2^16_ms"] = timed(torch, lambda: commit([desc]))
    finally:
        engine.gather_slab = inner
    check(max(rounds) + 1 > 1 and np.array_equal(got, api.compute_curve25519_commitments([desc])),
          f"(a) bucket engine: a skewed 2^16 column ({max(rounds) + 1} rounds of C = {engine.choose_capacity(n)}) "
          f"equals the default engine's ({timings['bucket_commit_skewed_2^16_ms']:.1f} ms)")
    timings["bucket_skewed_2^16_rounds"] = max(rounds) + 1

    curve = wc.BN254_G1
    gens, pts = tiled_generators(curve, n, api.device())
    rows = counter_scalars(n, 32)
    expected = curve.oracle.msm(collapsed_scalars(rows), pts)
    with bucket_engine(), counted(launches):
        got, timings["bucket_bn254_g1_2^16_ms"] = timed(
            torch, lambda: api.COMMITMENT_ENTRIES[curve]([api.SequenceDescriptor(32, n, rows)], gens))
    check(w_output_equals(curve, got, 0, expected),
          f"(a) bucket engine: bn254 G1 at 2^16 equals the oracle's collapsed sum ({timings['bucket_bn254_g1_2^16_ms']:.1f} ms)")
    check(not os.environ.get(engine.ENGINE_VAR), "(a) the bucket engine's variable is unset again")
    return launches


def phase_fewrow(torch, timings: dict) -> tuple:
    """(b) the few-row partition query at full width, 2^20 canonical
    generators through the default commitment entry: a 1-byte and an 8-byte
    counter column equal the same commitment through ed_lookup_msm on the
    same handle; a w = 4 handle's 32-byte counter column (256 rows, 16
    entries a group: the few-row query too) gives the pinned digest; n = 2^10
    with one 1-byte column (128-group chunks: niels_add). The few-row and
    the lookup query are timed on the same handle and rows (median of 5),
    and the warm 2^20 commitments end to end, routed as blitzar_tpu routes
    them and with every query sent to its lookup kernel (ristretto255 and
    bn254 G1). Returns the inputs phase (c) holds the kernels at and the
    launches of the default-entry commitments and the w = 4 query, one
    call each (not the handle build, the references or the timing reps)."""
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import engine, fixed
    from blitzar_tpu_torch.ops import cuda_point as cp

    dev = api.device()
    out = {}
    launches = dict.fromkeys(cp.KERNELS, 0)
    for n, nbytes in ((1 << 20, 1), (1 << 20, 8), (1 << 10, 1)):
        gens = generators.get_precomputed_generators(n, 0, dev)
        rows = counter_scalars(n, nbytes)
        desc = api.SequenceDescriptor(nbytes, n, rows)
        key = f"2^{n.bit_length() - 1}_{nbytes}B"
        launched: dict = {}
        with counted(launches, launched), entry_gathers() as gathered:
            got, timings[f"fewrow_commit_{key}_ms"] = timed(torch, lambda: api.compute_curve25519_commitments([desc]))
        launched = {k: launched[k] for k in FEWROW_KERNELS + ("ed_lookup_msm",)}
        handle = engine.cached_handle(gens, n)
        scalars = fixed._scalars_tensor(handle, rows[None])
        nbits = 8 * nbytes

        def via_lookup():
            return fixed.doubling_combine(fixed.sum_leading(cp.ed_lookup_msm(handle.table, scalars, None, 8)), 1, nbits)

        def via_fewrow():
            return fixed.doubling_combine(fixed.fewrow_products(handle.table, scalars, None, 8), 1, nbits)

        want = api.compress_ristretto255(via_lookup())
        # 2^20: 1024-group table chunks, one fewrow_niels launch and no
        # gathered entry; 2^10: one 128-group chunk, gathered, niels_add
        one_launch = n == 1 << 20
        path = ({"fewrow_niels": 1, "niels_add": 0} if one_launch else {"fewrow_niels": 0, "niels_add": 1})
        check(not fixed.lookup_msm_fits(handle.num_groups, 256, nbits)
              and {k: launched[k] for k in path} == path and bool(gathered) != one_launch
              and launched["ed_lookup_msm"] == 0 and np.array_equal(got, want),
              f"(b) {key} column: the default commitment takes the few-row query ({launched}, "
              f"{len(gathered)} entry gathers) and equals ed_lookup_msm's "
              f"({timings[f'fewrow_commit_{key}_ms']:.1f} ms)")
        _, timings[f"fewrow_query_{key}_ms_median"] = median_ms(torch, via_fewrow)
        _, timings[f"lookup_query_{key}_ms_median"] = median_ms(torch, via_lookup)
        if n == 1 << 20:
            _, timings[f"fewrow_commit_{key}_warm_ms_median"] = median_ms(
                torch, lambda: api.compute_curve25519_commitments([desc]))
            with lookup_routing():
                routed, timings[f"lookup_routed_commit_{key}_warm_ms_median"] = median_ms(
                    torch, lambda: api.compute_curve25519_commitments([desc]))
            check(np.array_equal(routed, got), f"(b) {key} column: routed to ed_lookup_msm, the same commitment")
        if n == 1 << 10:
            idx = cp.query_index(scalars, None, 8)
            sel = fixed.chunk_entries(handle.table, idx, 8)
            half = sel.shape[0] // 2
            # limb-major, as the wrapper makes them before its launch
            out["niels_halves"] = tuple(type(h)(*(c.contiguous() for c in h))
                                        for h in (cp.unpack_niels(sel[:half]), cp.unpack_niels(sel[half:])))

    n = 1 << 20
    gens = generators.get_precomputed_generators(n, 0, dev)
    handle = fixed.MultiexpHandle(gens, window_width=4)
    rows = counter_scalars(n, 32)[None]
    launched = {}
    with counted(launches, launched), entry_gathers() as gathered:
        res, timings["fewrow_w4_query_2^20_ms"] = timed(torch, lambda: api.fixed_multiexponentiation(handle, rows))
    check(digest(api.compress_ristretto255(res)) == PINNED_RISTRETTO_MSM[20]
          and launched["fewrow_niels"] == 1 and launched["niels_add"] == 0 and not gathered,
          f"(b) a w = 4 handle: the 2^20 query takes the few-row query, one fewrow_niels launch and no entry "
          f"gathered, and equals the pinned digest ({timings['fewrow_w4_query_2^20_ms']:.1f} ms)")
    scalars = fixed._scalars_tensor(handle, rows)
    _, timings["fewrow_query_w4_2^20_32B_ms_median"] = median_ms(
        torch, lambda: fixed.fewrow_products(handle.table, scalars, None, 4))
    lookup, timings["lookup_query_w4_2^20_32B_ms_median"] = median_ms(
        torch, lambda: fixed.sum_leading(cp.ed_lookup_msm(handle.table, scalars, None, 4)))
    check(digest(cp.ristretto_encode(fixed.doubling_combine(lookup, 1, 256)).cpu().numpy().T) == PINNED_RISTRETTO_MSM[20],
          "(b) the w = 4 handle through ed_lookup_msm equals the pinned digest too")
    del handle

    # bn254 G1: an 8-byte 2^20 column, warm, routed both ways end to end
    curve = wc.BN254_G1
    gens, _ = tiled_generators(curve, n, dev)
    desc = api.SequenceDescriptor(8, n, counter_scalars(n, 8))
    entry = api.COMMITMENT_ENTRIES[curve]
    with counted(launches):
        got, timings["fewrow_commit_bn254_g1_2^20_8B_ms"] = timed(torch, lambda: entry([desc], gens))
    _, timings["fewrow_commit_bn254_g1_2^20_8B_warm_ms_median"] = median_ms(torch, lambda: entry([desc], gens))
    with lookup_routing():
        routed, timings["lookup_routed_commit_bn254_g1_2^20_8B_warm_ms_median"] = median_ms(
            torch, lambda: entry([desc], gens))
    check(routed.tobytes() == got.tobytes(), "(b) bn254 G1 8-byte 2^20 column: routed to w_lookup_msm, the same commitment")
    return out, launches


def phase_fewrow_kernels(torch, dev, inputs: dict, shapes: dict) -> dict:
    """(c) ed_double, niels_add and fewrow_niels against their plain
    versions at their paths' shapes: ed_double at a Horner step of one
    output and of the ten of 100000 x 10; niels_add at the halves of n =
    2^10's one-byte query (64 x 8); fewrow_niels at every shape
    (``fewrow_niels_record``) the few-row and files paths launched it at
    (``shapes``, PATH_SHAPES' counts), its headline the 2^20 one-byte
    query's (1024 entries x 1024 columns)."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    results: dict = {}
    ed_err = functools.partial(point_err, canonical=F.canonicalize)
    by_outputs = {}
    for outputs in (1, 10):
        pts = generators.get_precomputed_generators(outputs, 77, dev)
        ms = device_ms(torch, lambda: cp.ed_double(pts), reps=100)
        plain_ms = cuda_ms(torch, lambda: cp.ed_double_plain(pts), reps=1)
        err = ed_err(cp.ed_double(pts), cp.ed_double_plain(pts))
        b_ms, b_by = bound(outputs * 512, outputs * MULS_DOUBLE * IMAD_PER_FIELD_MUL)
        by_outputs[str(outputs)] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": float(err), "bound_ms": b_ms,
                                    "bound_by": b_by}
        if outputs == 1:
            kernel_record(results, "ed_double", "blitzar_tpu/ops/pallas_point.py:254",
                          "blitzar_tpu_torch/csrc/ed_double.cu", ms, plain_ms, err, outputs * 512,
                          outputs * MULS_DOUBLE * IMAD_PER_FIELD_MUL)
        check(err == 0, f"ed_double at {outputs} outputs equals plain ({ms:.4f} ms)")
    results["ed_double"]["by_outputs"] = by_outputs

    n1, n2 = inputs["niels_halves"]
    count = n1.a[0].numel()
    ms = device_ms(torch, lambda: cp.niels_add(n1, n2), reps=100)
    plain_ms = cuda_ms(torch, lambda: cp.niels_add_plain(n1, n2), reps=1)
    err = ed_err(cp.niels_add(n1, n2), cp.niels_add_plain(n1, n2))
    kernel_record(results, "niels_add", "blitzar_tpu/ops/pallas_point.py:79", "blitzar_tpu_torch/csrc/niels_add.cu",
                  ms, plain_ms, err, count * (2 * 192 + 256), count * MULS_NIELS_ADD * IMAD_PER_FIELD_MUL)
    results["niels_add"]["shape"] = list(n1.a.shape[1:])

    records = [fewrow_niels_record(torch, dev, key, paths) for key, paths in sorted(shape_paths(shapes).items())]
    check(bool(records), "fewrow_niels: the paths launched it")
    top = next((r for r in records if r["key"] == FEWROW_HEADLINE), records[0])
    kernel_record(results, "fewrow_niels", "blitzar_tpu/ops/pallas_point.py:426",
                  "blitzar_tpu_torch/csrc/fewrow_niels.cu", top["ms"], top["plain_ms"], top["max_abs_err"],
                  top["bytes"], top["imads"], top["plain_fraction"])
    results["fewrow_niels"].update(shape=[top["chunk_groups"], top["cols"]], by_shape=records,
                                   launches_x_gap_ms_all_shapes=sum(r["launches_x_gap_ms"] for r in records))
    return results


# the few-row query's column sums: the key (outputs, n_pad, nbytes, w,
# signed, chunk groups) of the 2^20 one-byte
# query, the headline; the plain version gathers at most this many entries
# a shape (table chunks spread over the query, the last included)
FEWROW_HEADLINE = (1, 1 << 20, 1, 8, False, 1024)
FEWROW_SAMPLE_ENTRIES = 1 << 20


def fewrow_niels_record(torch, dev, key: tuple, paths: dict) -> dict:
    """fewrow_niels at one launch shape (``SHAPE_KEYS``) on a table of
    random words and random scalar bytes and signs (its work does not
    depend on them: every entry a row picks is added, entry 0 too): the
    device time, the bound (the entries read, 96 bytes each, against gc/2
    niels adds of 8 multiplies and gc/2 - 1 extended adds of 9 a column),
    launches by path and launches x (ms - bound), and limb for limb the
    plain version on table chunks spread over the query."""
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    outputs, n_pad, nbytes, w, signed, gc = key
    groups = n_pad // w
    gen = torch.Generator(device=dev).manual_seed(n_pad + nbytes + w)
    table = torch.randint(-(1 << 31), (1 << 31) - 1, (groups, 1 << w, 3, 8), generator=gen, device=dev,
                          dtype=torch.int32)
    scalars = torch.randint(0, 256, (outputs, n_pad, nbytes), generator=gen, device=dev, dtype=torch.uint8)
    signs = torch.randint(0, 2, (outputs, n_pad), generator=gen, device=dev, dtype=torch.uint8) if signed else None
    rows = (2 if signed else 1) * outputs * 8 * nbytes
    nc = groups // gc

    def run():
        return cp.fewrow_niels(table, scalars, signs, w, gc)

    ms = device_ms(torch, run, reps=5)
    chunks = spread_indices(torch, dev, max(1, min(nc, FEWROW_SAMPLE_ENTRIES // (gc * rows))), nc)
    plain_ms = cuda_ms(torch, lambda: cp.fewrow_niels_plain(table, scalars, signs, w, gc, chunks), reps=1)
    err = point_err(ed.index_batch(run(), chunks), cp.fewrow_niels_plain(table, scalars, signs, w, gc, chunks),
                    F.canonicalize)
    cols = nc * rows
    nbytes_moved = cols * (gc * 96 + 256) + outputs * n_pad * (nbytes + (1 if signed else 0))
    imads = cols * (gc // 2 * MULS_NIELS_ADD + (gc // 2 - 1) * MULS_ADD) * IMAD_PER_FIELD_MUL
    b_ms, b_by = bound(nbytes_moved, imads)
    launches = sum(paths.values())
    check(err == 0, f"fewrow_niels at {gc} x {cols} ({outputs} x {n_pad} x {nbytes} bytes, w = {w}, "
                    f"{'signed' if signed else 'unsigned'}), {launches} launches {paths}: equal to plain "
                    f"on {len(chunks)} of {nc} chunks, tolerance 0 on canonical limbs ({ms:.4f} ms, bound {b_ms:.4f})")
    del table, scalars, signs
    torch.cuda.empty_cache()
    return {"key": key, "chunk_groups": gc, "cols": cols, "outputs": outputs, "n_pad": n_pad,
            "nbytes": nbytes, "w": w, "signed": signed, "launches": launches, "launches_by_path": paths, "ms": ms,
            "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms, "plain_fraction": len(chunks) / nc,
            "max_abs_err": float(err), "bytes": nbytes_moved, "imads": imads,
            "launches_x_gap_ms": launches * (ms - b_ms)}


def phase_horner_kernels(torch, dev, counts: dict) -> dict:
    """(d) ed_horner and w_horner at every (curve, outputs, windows) the
    bucket path launched them at (``PATH_SHAPES``, its main-path calls): the
    device time, the bound, the launches, and limb for limb the plain
    version in the kernel's segments; window sums from the first 2^16
    generators (ristretto255) or the oracle's 521 points, tiled. Each
    record also gives the output's critical path, 8 (W - 1) dependent
    doublings. The headline is one 32-byte column's (1, 32), ristretto255
    and bn254 G1."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    curves = {c.name: c for c in wc.CURVES}
    ed_base = generators.get_precomputed_generators(1 << 16, 0, dev)
    results: dict = {}
    for name, head, replaces, source in (
            ("ed_horner", ("ristretto255", 1, 32), 254, "ed_horner.cu"),
            ("w_horner", ("bn254_g1", 1, 32), 907, "w_horner.cu")):
        records = []
        for (instance, outputs, windows), paths in sorted(shape_paths(counts.get(name, {})).items()):
            curve = curves.get(instance)
            idx = torch.arange(outputs * windows, device=dev)
            if curve is None:
                sums = ed.reshape_batch(ed.index_batch(ed_base, idx % (1 << 16)), (outputs, windows))
                kernel, plain = cp.ed_horner, cp.ed_horner_plain
                err_of = functools.partial(point_err, canonical=F.canonicalize)
                muls, point_bytes, imad = 8 * MULS_DOUBLE + MULS_ADD, 256, IMAD_PER_FIELD_MUL
            else:
                gens, _ = tiled_generators(curve, outputs * windows, dev)
                sums = curve.reshape_batch(gens, (outputs, windows))
                kernel = functools.partial(cw.w_horner, curve)
                plain = functools.partial(cw.w_horner_plain, curve)
                err_of, point_bytes = point_err, 3 * curve.nlimbs * 4
                muls, imad = 8 * MULS_WDOUBLE + MULS_WADD, IMAD_PER_MONT_MUL[curve.nlimbs // 2]
            seg_bits = cp.ladder_segment_bits(windows)  # the wrappers' default on the card
            ms = device_ms(torch, lambda: kernel(sums, seg_bits), reps=10)
            plain_ms = cuda_ms(torch, lambda: plain(sums, seg_bits), reps=1)
            err = err_of(kernel(sums, seg_bits), plain(sums, seg_bits))
            nbytes, imads = outputs * (windows + 1) * point_bytes, outputs * (windows - 1) * muls * imad
            b_ms, b_by = bound(nbytes, imads)
            launches = sum(paths.values())
            check(err == 0, f"{name}/{instance} at ({outputs}, {windows}), {launches} launches {paths}: equal to "
                            f"plain in the kernel's segments, tolerance 0 on the limbs ({ms:.4f} ms)")
            records.append({"instance": instance, "outputs": outputs, "windows": windows, "launches": launches,
                            "launches_by_path": paths, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                            "plain_ms": plain_ms, "max_abs_err": float(err),
                            "critical_path_doublings": 8 * (windows - 1), "bytes": nbytes, "imads": imads,
                            "launches_x_gap_ms": launches * (ms - b_ms)})
        top = next(r for r in records if (r["instance"], r["outputs"], r["windows"]) == head)
        kernel_record(results, name, f"blitzar_tpu/ops/pallas_point.py:{replaces}",
                      f"blitzar_tpu_torch/csrc/{source}", top["ms"], top["plain_ms"], top["max_abs_err"],
                      top["bytes"], top["imads"])
        results[name].update(shape=[head[1], head[2]], instance=head[0], by_shape=records,
                             critical_path_doublings=top["critical_path_doublings"],
                             launches_x_gap_ms_all_shapes=sum(r["launches_x_gap_ms"] for r in records))
    return results


# the window sums' dependent point operations a row (window_sums.cuh: a
# lane's run, the suffix scan, 5 doublings and an add, the halving) and the
# adds a row takes at its least (the running-sum method, 2 x 254)
WINDOW_CRITICAL_OPS = 13 + 5 + 6 + 5
WINDOW_LEAST_ADDS = 2 * 254


def window_sum_buckets(torch, curve, rows: int, dev):
    """(rows, 255) bucket sums on the card: the first 2^16 canonical
    generators (ristretto255) or the oracle's 521 points tiled, every
    seventh bucket empty, the second row wholly empty and the third bucket
    255 alone (a window whose digits are all 0 or all 255)."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed

    k = torch.arange(rows * 255, device=dev)
    empty = (k % 7 == 3) | (k // 255 == 1) | ((k // 255 == 2) & (k % 255 != 254))
    if curve is ed:
        base = generators.get_precomputed_generators(1 << 16, 0, dev)
        pts = ed.index_batch(base, (k * 37) % base.x.shape[1])
    else:
        pts, _ = tiled_generators(curve, rows * 255, dev)
    return curve.reshape_batch(curve.select(pts, curve.identity((rows * 255,), dev), empty), (rows, 255))


def phase_window_kernels(torch, dev, counts: dict) -> dict:
    """(e) ed_window_sums and w_window_sums at every (curve, rows) the
    bucket path launched them at (``PATH_SHAPES``, its main-path calls):
    the device time, the bound, the launches, and the rows as points
    against the plain reverse scan and tree (another order of additions:
    the same points, other coordinates; ``max_abs_err`` counts the unequal
    rows). The headline is one 32-byte column's 32 rows, ristretto255 and
    bn254 G1."""
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    curves = {c.name: c for c in wc.CURVES}
    results: dict = {}
    for name, head in (("ed_window_sums", ("ristretto255", 32)), ("w_window_sums", ("bn254_g1", 32))):
        records = []
        shapes = shape_paths(counts.get(name, {}))
        for (instance, rows), paths in sorted(shapes.items()):
            curve = curves.get(instance, ed)
            buckets = window_sum_buckets(torch, curve, rows, dev)
            if curve is ed:
                kernel, muls, imad, point_bytes = cp.ed_window_sums, MULS_ADD, IMAD_PER_FIELD_MUL, 256
            else:
                kernel = functools.partial(cw.w_window_sums, curve)
                muls, imad = MULS_WADD, IMAD_PER_MONT_MUL[curve.nlimbs // 2]
                point_bytes = 3 * curve.nlimbs * 4
            ms = device_ms(torch, lambda: kernel(buckets), reps=10)
            plain_ms = cuda_ms(torch, lambda: cp.window_sums_plain(curve, buckets), reps=1)
            got, want = kernel(buckets), cp.window_sums_plain(curve, buckets)
            err = int((~curve.points_equal(got, want)).sum())
            empty_ok = bool(curve.points_equal(curve.index_batch(got, slice(1, 2)), curve.identity((1,), dev)).all())
            nbytes, imads = rows * (255 + 1) * point_bytes, rows * WINDOW_LEAST_ADDS * muls * imad
            b_ms, b_by = bound(nbytes, imads)
            launches = sum(paths.values())
            check(err == 0 and (rows < 2 or empty_ok),
                  f"{name}/{instance} at {rows} rows, {launches} launches {paths}: the same points as plain "
                  f"({err} rows differ; the empty row the identity) ({ms:.4f} ms)")
            records.append({"instance": instance, "rows": rows, "launches": launches, "launches_by_path": paths,
                            "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
                            "max_abs_err": float(err), "critical_path_point_ops": WINDOW_CRITICAL_OPS,
                            "bytes": nbytes, "imads": imads, "launches_x_gap_ms": launches * (ms - b_ms)})
            del buckets
        top = next(r for r in records if (r["instance"], r["rows"]) == head)
        kernel_record(results, name, "blitzar_tpu/ops/pallas_point.py:237" if name == "ed_window_sums" else
                      "blitzar_tpu/ops/pallas_point.py:891", "blitzar_tpu_torch/csrc/window_sums.cu", top["ms"],
                      top["plain_ms"], top["max_abs_err"], top["bytes"], top["imads"], compared="points (rows)")
        results[name].update(rows=head[1], instance=head[0], by_shape=records,
                             critical_path_point_ops=WINDOW_CRITICAL_OPS,
                             launches_x_gap_ms_all_shapes=sum(r["launches_x_gap_ms"] for r in records))
    return results


# ---------------------------------------------------------------------------
# tree_reduce_lanes at every shape the paths launch it at
# ---------------------------------------------------------------------------


class PathShapes:
    """Launches of the kernels whose time depends on their shape
    (``SHAPE_KEYS``), by kernel, by path and by shape: counted while a
    path's calls run (a whole phase, or only inside :func:`counted` where a
    phase counts its main-path calls alone)."""

    def __init__(self):
        self.path, self.on, self.counts = None, False, {}

    def install(self) -> None:
        from blitzar_tpu_torch.ops import cuda_mont as cm
        from blitzar_tpu_torch.ops import cuda_point as cp
        from blitzar_tpu_torch.ops import cuda_wpoint as cw

        launch = cp._launch

        def counting(name, fn, *args, instance=None):
            launch(name, fn, *args, instance=instance)
            if name in SHAPE_KEYS and self.on and self.path:
                by = self.counts.setdefault(name, {}).setdefault(self.path, {})
                key = SHAPE_KEYS[name](instance, args)
                by[key] = by.get(key, 0) + 1

        cp._launch = cw._launch = cm._launch = counting

    @contextlib.contextmanager
    def phase(self, path: str, on: bool = True):
        self.path, self.on = path, on
        try:
            yield
        finally:
            self.path, self.on = None, False


# a launch's shape from its launcher's arguments: tree_reduce_lanes (curve,
# 4 coordinates, stride, size, cols, ...) by (instance, size, cols);
# w_build_table (curve, 3 coordinates, stride, w, groups, ...) by (instance,
# groups, w); doubling_combine (4 coordinates, stride, outputs, nbits, ...)
# by (outputs, nbits); mont_sum_round (field, degree, table, stride(0),
# stride(1), mid, mults, products, ...) by (field id, mid, degree, MLEs,
# products); w_affine (curve, chunk, entries, ...) by (instance, entries);
# ed_horner (4 coordinates, stride, outputs, windows, ...) and w_horner
# (curve, 3 coordinates, stride, outputs, windows, ...) by (instance,
# outputs, windows); fewrow_niels (table, scalars, signs, outputs, n_pad,
# row stride, nbytes, w, chunk groups, ...) by (outputs, n_pad, nbytes, w,
# signed, chunk groups); ed_window_sums (4 coordinates, stride, rows, ...)
# and w_window_sums (curve, 3 coordinates, stride, rows, ...) by (instance,
# rows); ristretto_encode (4 coordinates, stride, count, ...) and
# ristretto_decode (bytes, count, ...) by count; ed_add (8 coordinates and
# their strides, negate_q, count, ...) by (count, negate_q); wadd (curve,
# 6 coordinates and their strides, negate_q, count, ...) by (instance, count,
# negate_q)
SHAPE_KEYS = {
    "tree_reduce_lanes": lambda instance, a: (instance, int(a[6]), int(a[7])),
    "w_build_table": lambda instance, a: (instance, int(a[6]), int(a[5])),
    "doubling_combine": lambda instance, a: (int(a[5]), int(a[6])),
    "mont_sum_round": lambda instance, a: (int(a[0]), int(a[5]), int(a[1]), int(a[3]) // int(a[4]), int(a[7])),
    "w_affine": lambda instance, a: (instance, int(a[2])),
    "ed_horner": lambda instance, a: ("ristretto255", int(a[5]), int(a[6])),
    "w_horner": lambda instance, a: (instance, int(a[5]), int(a[6])),
    "ed_window_sums": lambda instance, a: ("ristretto255", int(a[5])),
    "w_window_sums": lambda instance, a: (instance, int(a[5])),
    "fewrow_niels": lambda instance, a: (int(a[3]), int(a[4]), int(a[6]), int(a[7]), a[2] is not None, int(a[8])),
    "ristretto_encode": lambda instance, a: int(a[5]),
    "ristretto_decode": lambda instance, a: int(a[1]),
    "ed_add": lambda instance, a: (int(a[11]), bool(a[10])),
    "wadd": lambda instance, a: (instance, int(a[10]), bool(a[9])),
}
PATH_SHAPES = PathShapes()
TREE_SAMPLE_COLS = 64


def phase_tree_shapes(torch, dev, counts: dict) -> dict:
    """tree_reduce_lanes at every (curve, size, cols) a path launched it
    at: its device time and bound on a batch of that shape (the first 2^16
    generators, or the oracle's 521 points, tiled over it), equal as
    points to the plain version on up to 64 columns spread over the batch,
    and launches x (ms - bound) summed over the shapes; beside each, the
    kernel's time before its redesign (``EARLIER_TREE_MS``, not this run's)
    and the shapes this run read slower than that."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.ops import cuda_point as cp
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    curves = {c.name: c for c in wc.CURVES}
    shapes: dict = {}
    for path, by in counts.items():
        for key, n in by.items():
            shapes.setdefault(key, {})[path] = n
    ed_base = generators.get_precomputed_generators(1 << 16, 0, dev)
    records = []
    for (instance, size, cols), paths in sorted(shapes.items()):
        curve = curves.get(instance)
        idx = torch.arange(size * cols, device=dev)
        if curve is None:
            batch = ed.reshape_batch(ed.index_batch(ed_base, idx % (1 << 16)), (size, cols))
            kernel, plain, equal = cp.tree_reduce_lanes, cp.tree_reduce_lanes_plain, ed.points_equal
            point_bytes, imads_per_add, pick = 256, MULS_ADD * IMAD_PER_FIELD_MUL, ed.index_batch
        else:
            batch, _ = tiled_generators(curve, size * cols, dev)
            batch = curve.reshape_batch(batch, (size, cols))
            kernel = functools.partial(cw.w_tree_reduce_lanes, curve)
            plain = functools.partial(cw.w_tree_reduce_lanes_plain, curve)
            equal, pick = curve.points_equal, curve.index_batch
            point_bytes = 3 * curve.nlimbs * 4
            imads_per_add = MULS_WADD * IMAD_PER_MONT_MUL[curve.nlimbs // 2]
        del idx
        ms = device_ms(torch, lambda: kernel(batch), reps=5)
        sample = spread_indices(torch, dev, min(cols, TREE_SAMPLE_COLS), cols)
        sub = pick(batch, (slice(None), sample))
        plain_ms = cuda_ms(torch, lambda: plain(sub), reps=1)
        mismatches = int((~equal(pick(kernel(batch), sample), plain(sub))).sum())
        b_ms, b_by = bound((size + 1) * cols * point_bytes, (size - 1) * cols * imads_per_add)
        launches = sum(paths.values())
        records.append({"instance": instance, "size": size, "cols": cols, "launches": launches,
                        "launches_by_path": paths, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                        "launches_x_gap_ms": launches * (ms - b_ms), "plain_ms": plain_ms,
                        "plain_cols": len(sample), "mismatches": mismatches,
                        "earlier_ms": EARLIER_TREE_MS.get(f"{instance}/{size}x{cols}")})
        check(mismatches == 0, f"tree_reduce_lanes/{instance} at ({size}, {cols}), {launches} launches "
                               f"{paths}: equal to plain as points on {len(sample)} columns ({ms:.4f} ms, "
                               f"bound {b_ms:.4f} ms)")
        del batch, sub
    torch.cuda.empty_cache()
    total = sum(r["launches_x_gap_ms"] for r in records)
    by_instance: dict = {}
    for r in records:
        by_instance[r["instance"]] = by_instance.get(r["instance"], 0.0) + r["launches_x_gap_ms"]
    slower = [f"{r['instance']}/{r['size']}x{r['cols']}" for r in records
              if r["earlier_ms"] is not None and r["ms"] > r["earlier_ms"]]
    print(f"    tree_reduce_lanes: {len(records)} shapes, {len(slower)} read slower than before the redesign "
          f"(earlier readings, not this run's): {slower}")
    return {"shapes": records, "launches_x_gap_ms": total, "launches_x_gap_ms_by_instance": by_instance,
            "earlier_note": "earlier_ms: the kernel before its redesign, kernel_ab.py's parent run on the "
                            "same shapes (EARLIER_TREE_MS), not measured by this run",
            "slower_than_earlier": slower}


def shape_paths(counts: dict) -> dict:
    """{path: {key: launches}} -> {key: {path: launches}}"""
    shapes: dict = {}
    for path, by in counts.items():
        for key, n in by.items():
            shapes.setdefault(key, {})[path] = n
    return shapes


def sum_round_table(m: int, products: int, degree: int):
    """A product table for a mont_sum_round shape: ``products`` products of
    ``degree`` factors over the m MLEs in turn (the sumcheck benchmark's
    round, SUMCHECK_BENCH_ROUND, at its shape)."""
    terms = [(p + j) % m for p in range(products) for j in range(degree)]
    return [(1, degree)] * products, terms


def phase_ranked_shapes(torch, dev, counts: dict) -> dict:
    """w_build_table (by curve, groups, w), doubling_combine (by outputs and
    bits), mont_sum_round (by field, round size, degree, MLEs, products),
    ed_add (by pairs, q negated or not) and wadd (by curve and pairs, both
    ways) at every shape a path launched them at, as phase 19 holds
    tree_reduce_lanes: each shape's device time, bound, launches and
    launches x (ms - bound), held against the plain version (the table on
    up to 64 groups, the ladder in the kernel's segments and the round in
    full, limb for limb), and the sum over the shapes. The inputs are the
    oracle's 521 points tiled (w_build_table), the first 2^16 generators
    tiled (doubling_combine) and random canonical tables (mont_sum_round,
    product tables by ``sum_round_table``)."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_mont as cm
    from blitzar_tpu_torch.ops import cuda_point as cp

    curves = {c.name: c for c in wc.CURVES}
    out: dict = {}

    def finish(name: str, records: list) -> None:
        total = sum(r["launches_x_gap_ms"] for r in records)
        out[name] = {"shapes": records, "launches": sum(r["launches"] for r in records), "launches_x_gap_ms": total}
        print(f"    {name}: {len(records)} shapes, {out[name]['launches']} launches, launches x gap {total:.3f} ms")

    records = []
    for (instance, groups, w), paths in sorted(shape_paths(counts.get("w_build_table", {})).items()):
        curve = curves[instance]
        gens, _ = tiled_generators(curve, groups * w, dev)
        rec = w_build_record(torch, dev, curve, gens, w, reps=3, sample_groups=64)
        launches = sum(paths.values())
        records.append({"instance": instance, "groups": groups, "w": w, "launches": launches,
                        "launches_by_path": paths, "ms": rec["ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "plain_ms": rec["plain_ms"], "max_abs_err": rec["max_abs_err"],
                        "launches_x_gap_ms": launches * (rec["ms"] - rec["bound_ms"])})
        del gens
    finish("w_build_table", records)

    records = []
    ed_base = generators.get_precomputed_generators(1 << 16, 0, dev)
    for (outputs, nbits), paths in sorted(shape_paths(counts.get("doubling_combine", {})).items()):
        rows = ed.reshape_batch(ed.index_batch(ed_base, torch.arange(outputs * nbits, device=dev) % (1 << 16)),
                                (outputs, nbits))
        ms = device_ms(torch, lambda: cp.doubling_combine(rows), reps=5)
        seg_bits = cp.ladder_segment_bits(nbits)
        plain_ms = cuda_ms(torch, lambda: cp.doubling_combine_plain(rows, seg_bits), reps=1)
        err = point_err(cp.doubling_combine(rows), cp.doubling_combine_plain(rows, seg_bits), F.canonicalize)
        b_ms, b_by = bound(outputs * (nbits + 1) * 256,
                           outputs * (nbits - 1) * (MULS_DOUBLE + MULS_ADD) * IMAD_PER_FIELD_MUL)
        launches = sum(paths.values())
        check(err == 0, f"doubling_combine at ({outputs}, {nbits}), {launches} launches {paths}: equal to plain "
                        f"in the kernel's segments, tolerance 0 on canonical limbs ({ms:.4f} ms)")
        records.append({"outputs": outputs, "nbits": nbits, "launches": launches, "launches_by_path": paths,
                        "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms, "max_abs_err": float(err),
                        "launches_x_gap_ms": launches * (ms - b_ms)})
        del rows
    del ed_base
    finish("doubling_combine", records)

    records = []
    for (fid, mid, degree, m, products), paths in sorted(shape_paths(counts.get("mont_sum_round", {})).items()):
        field = cm.FIELDS[fid]
        ptable, pterms = sum_round_table(m, products, degree)
        mles = random_canonical(torch, field, (m, 2 * mid), dev, mid + degree)
        mults = field.from_ints([mu for mu, _ in ptable], dev)
        lengths = torch.tensor([k for _, k in ptable], dtype=torch.int32, device=dev)
        terms = torch.tensor(pterms, dtype=torch.int32, device=dev)
        run = functools.partial(cm.mont_sum_round, field, mles, mults, lengths, terms, degree)
        plain = functools.partial(cm.mont_sum_round_plain, field, mles, mults, lengths, terms, degree)
        ms = device_ms(torch, run, reps=5)
        plain_ms = cuda_ms(torch, plain, reps=1)
        err = int((run().long() - plain().long()).abs().max())
        b_ms, b_by = bound(m * 2 * mid * field.nlimbs * 4,
                           sum_round_muls(ptable, pterms, mid) * IMAD_PER_MONT_MUL[field.nlimbs // 2])
        launches = sum(paths.values())
        check(err == 0, f"mont_sum_round {field.name} at mid {mid}, degree {degree}, {m} MLEs, {products} products, "
                        f"{launches} launches {paths}: equal to plain ({ms:.4f} ms)")
        records.append({"field": field.name, "mid": mid, "degree": degree, "mles": m, "products": products,
                        "launches": launches, "launches_by_path": paths, "ms": ms, "bound_ms": b_ms,
                        "bound_by": b_by, "plain_ms": plain_ms, "max_abs_err": float(err),
                        "launches_x_gap_ms": launches * (ms - b_ms)})
        del mles
    finish("mont_sum_round", records)

    records = []
    ed_base = generators.get_precomputed_generators(1 << 16, 0, dev)
    for (count, negate), paths in sorted(shape_paths(counts.get("ed_add", {})).items()):
        p, q = (ed.index_batch(ed_base, (torch.arange(count, device=dev) + k * count) % (1 << 16)) for k in (0, 1))
        run = functools.partial(cp.ed_add, p, q, negate_q=negate)
        ms = device_ms(torch, run, reps=20)
        plain_ms = cuda_ms(torch, lambda: cp.ed_add_plain(p, q, negate), reps=1)
        err = point_err(run(), cp.ed_add_plain(p, q, negate), F.canonicalize)
        b_ms, b_by = bound(count * 3 * 256, count * MULS_ADD * IMAD_PER_FIELD_MUL)
        launches = sum(paths.values())
        check(err == 0, f"ed_add at {count} pairs{', q negated' if negate else ''}, {launches} launches {paths}: "
                        f"equal to plain ({ms:.4f} ms)")
        records.append({"pairs": count, "negate_q": negate, "launches": launches, "launches_by_path": paths,
                        "ms": ms, "bound_ms": b_ms,
                        "bound_by": b_by, "plain_ms": plain_ms, "max_abs_err": float(err),
                        "launches_x_gap_ms": launches * (ms - b_ms)})
        del p, q
    del ed_base
    finish("ed_add", records)

    # wadd at every (curve, pairs) a path launched it at, both ways (the
    # launches are the path's at the way it ran), on the oracle's tiled
    # points doubled (z != 1), against the plain version limb for limb
    from blitzar_tpu_torch.ops import cuda_wpoint as cw

    records = []
    launched = shape_paths(counts.get("wadd", {}))
    for instance, count in sorted({(i, c) for i, c, _ in launched}):
        curve = curves[instance]
        tiled, _ = tiled_generators(curve, 2 * count, dev)
        pts = curve._double_impl(tiled)
        p, q = curve.index_batch(pts, slice(0, count)), curve.index_batch(pts, slice(count, 2 * count))
        imad = IMAD_PER_MONT_MUL[curve.nlimbs // 2]
        for negate in (False, True):
            paths = launched.get((instance, count, negate), {})
            run = functools.partial(cw.wadd, curve, p, q, negate_q=negate)
            ms = device_ms(torch, run, reps=20)
            plain_ms = cuda_ms(torch, lambda: cw.wadd_plain(curve, p, q, negate), reps=1)
            err = point_err(run(), cw.wadd_plain(curve, p, q, negate))
            b_ms, b_by = bound(count * 3 * 3 * curve.nlimbs * 4, count * MULS_WADD * imad)
            launches = sum(paths.values())
            check(err == 0, f"wadd {instance} at {count} pairs{', q negated' if negate else ''}, {launches} launches "
                            f"{paths}: equal to plain, tolerance 0 on canonical limbs ({ms:.4f} ms)")
            records.append({"instance": instance, "pairs": count, "negate_q": negate, "launches": launches,
                            "launches_by_path": paths, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                            "plain_ms": plain_ms, "max_abs_err": float(err), "launches_x_gap_ms": launches * (ms - b_ms)})
        del tiled, pts, p, q
    finish("wadd", records)
    torch.cuda.empty_cache()
    return out


# the ristretto255 codec (phase 21): the counts it is held at besides the
# paths' (a commitment's one column, an IPA round's L and R, the IPA 2^20
# verifier's 40 L and R, a compress of a 2^16 batch); field multiplies a
# point (squares counted; multiplies by 2 not): sqrt_ratio_m1's 273 (the
# pow22523 chain's 262 and 11 around it) and the encode's 14 more, the
# decode's 11; bytes a point (four coordinates of 16 int32 limbs and 32
# bytes; the decode's valid byte); each kernel's headline count (its path's
# shape: one column; the verifier's 40)
CODEC_COUNTS = (1, 2, 40, 1 << 16)
MULS_CODEC = {"ristretto_encode": 287, "ristretto_decode": 284}
CODEC_BYTES = {"ristretto_encode": 256 + 32, "ristretto_decode": 32 + 256 + 1}
CODEC_HEADLINE = {"ristretto_encode": 1, "ristretto_decode": 40}
# even canonical s whose decode fails for one reason each, the first of each
# from s = 2 up (tests/test_torch_ristretto_codec.py's search): no square
# root, a negative t
CODEC_NOT_SQUARE, CODEC_NEGATIVE_T = 8, 2


def codec_inputs(torch, dev, count: int):
    """count points on the card (sums of two canonical generators each, z
    far from 1, the identity first), their plain encodings, and the bytes
    the decode is held at: the encodings with every fifth from the second
    on replaced by an invalid one, the kinds in turn (s = p + 1, s = 1, bit
    255 set on the slot's own encoding, no square root, a negative t, s = p
    - 1 (y = 0), all ones); and the valid mask the bytes must decode to."""
    from blitzar_tpu_torch import generators
    from blitzar_tpu_torch.curves import edwards25519 as ed
    from blitzar_tpu_torch.curves import ristretto as rst
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    r0, r1 = generators._xorshift_limbs(torch.arange(1000, 1000 + 2 * count, device=dev))
    gens = cp.elligator_form(r0, r1)
    pts = cp.ed_add(ed.index_batch(gens, slice(0, count)), ed.index_batch(gens, slice(count, 2 * count)))
    pts = ed.cat([ed.identity((1,), dev), ed.index_batch(pts, slice(1, count))])
    enc = rst.encode(pts)  # the plain encode (ristretto_encode_plain), in any tree kernel_ab.py times
    data = enc.cpu().numpy().copy()
    values = {0: F.P + 1, 1: 1, 3: CODEC_NOT_SQUARE, 4: CODEC_NEGATIVE_T, 5: F.P - 1}
    bad = np.arange(1, count, 5)
    for j, col in enumerate(bad):
        kind = j % 7
        if kind == 2:
            data[31, col] |= 0x80
        elif kind == 6:
            data[:, col] = 0xFF
        else:
            data[:, col] = np.frombuffer(values[kind].to_bytes(32, "little"), np.uint8)
    valid = np.ones(count, bool)
    valid[bad] = False
    return pts, enc, torch.from_numpy(data).to(dev), valid


def phase_codec_kernels(torch, dev, counts: dict) -> dict:
    """ristretto_encode and ristretto_decode at CODEC_COUNTS and at every
    count the paths launched them at (``counts``, PATH_SHAPES's): bytes
    equal to the plain encode; the plain decode's valid flags, which must be
    the inputs' mask, and its canonical points in the valid slots; each
    count's device time, plain time (one run, back to back), bound and
    launches on all paths, launches x (ms - bound) summed (``by_shape``);
    the kernels line's record at the headline count."""
    from blitzar_tpu_torch.fields import fp25519 as F
    from blitzar_tpu_torch.ops import cuda_point as cp

    results: dict = {}
    by_shape = {name: [] for name in MULS_CODEC}
    records = {}
    for count in sorted(set(CODEC_COUNTS) | {k for name in MULS_CODEC for by in counts.get(name, {}).values()
                                              for k in by}):
        pts, want, data, mask = codec_inputs(torch, dev, count)
        got = cp.ristretto_encode(pts)
        enc_err = int((got.long() - want.long()).abs().max())
        dec, valid = cp.ristretto_decode(data)
        plain, plain_valid = cp.ristretto_decode_plain(data)
        check(valid.cpu().numpy().tolist() == plain_valid.cpu().numpy().tolist() == mask.tolist(),
              f"ristretto_decode at {count}: valid flags equal the plain version's and the inputs' "
              f"({int((~mask).sum())} invalid)")
        ok = torch.from_numpy(mask).to(dev)
        dec_err = max(int((F.canonicalize(c)[:, ok].long() - F.canonicalize(p)[:, ok].long()).abs().max())
                      for c, p in zip(dec, plain))
        runs = {"ristretto_encode": (lambda: cp.ristretto_encode(pts), lambda: cp.ristretto_encode_plain(pts), enc_err),
                "ristretto_decode": (lambda: cp.ristretto_decode(data), lambda: cp.ristretto_decode_plain(data),
                                     dec_err)}
        for name, (kernel, plain_fn, err) in runs.items():
            ms = device_ms(torch, kernel, reps=10)
            plain_ms = cuda_ms(torch, plain_fn, reps=1)
            b_ms, b_by = bound(count * CODEC_BYTES[name], count * MULS_CODEC[name] * IMAD_PER_FIELD_MUL)
            launches = sum(by.get(count, 0) for by in counts.get(name, {}).values())
            row = {"count": count, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "max_abs_err": float(err), "launches": launches, "launches_x_gap_ms": launches * (ms - b_ms),
                   "launches_by_path": {path: by.get(count, 0) for path, by in counts.get(name, {}).items()}}
            by_shape[name].append(row)
            check(err == 0, f"{name} at {count} points: kernel equals plain (max abs err {err}; {ms:.4f} ms, "
                            f"bound {b_ms:.2e} ms, plain {plain_ms:.1f} ms; {launches} launches on the paths)")
            if count == CODEC_HEADLINE[name]:
                records[name] = (ms, plain_ms, err, count)
        del pts, want, data, dec, plain
    for name, (ms, plain_ms, err, count) in records.items():
        kernel_record(results, name, "blitzar_tpu/ops/pallas_point.py:130 + :144", "blitzar_tpu_torch/csrc/ristretto.cu",
                      ms, plain_ms, err, count * CODEC_BYTES[name], count * MULS_CODEC[name] * IMAD_PER_FIELD_MUL,
                      compared="bytes" if name == "ristretto_encode" else "valid flags and canonical limbs")
        results[name]["headline_count"] = count
        results[name]["by_shape"] = by_shape[name]
        results[name]["critical_path_muls"] = MULS_CODEC[name]
    return results


def ranking(kernels: list, shapes: dict, tree_shapes: dict) -> list:
    """Every kernel's launches x (ms - bound), largest first: over every
    path and every shape a path launched it at for the kernels timed by
    shape (phases 18, 19 and 20), over phase 15's element counts for the
    field kernels and the conversions, else its path's launches at its
    headline shape."""
    rows = []
    for rec in kernels:
        name, launches = rec["name"], rec["launches"]
        if name in shapes:
            gap, launches, how = shapes[name]["launches_x_gap_ms"], shapes[name]["launches"], "every shape"
        elif name == "tree_reduce_lanes":
            gap = tree_shapes["launches_x_gap_ms"]
            launches = sum(r["launches"] for r in tree_shapes["shapes"])
            how = "every shape"
        elif "by_elements" in rec:
            gap = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rec["by_elements"].values())
            how = "every element count of the files path"
        elif "by_shape" in rec:
            gap = sum(r["launches_x_gap_ms"] for r in rec["by_shape"])
            launches = sum(r["launches"] for r in rec["by_shape"])
            how = "every shape"
        else:
            gap, how = launches * (rec["ms"] - rec["bound_ms"]), "headline shape"
        # mont_mul_ew's base-field instantiations on the files path, by count
        for field in rec.get("base_fields", {}).values():
            gap += sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in field["by_elements"].values())
            launches += sum(r["launches"] for r in field["by_elements"].values())
            how = "headline shape; base fields at every element count of the files path"
        rows.append({"kernel": name, "launches": launches, "launches_x_gap_ms": gap, "shapes": how})
    return sorted(rows, key=lambda r: -r["launches_x_gap_ms"])


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "blitzar_tpu_torch", "csrc")):
        print("FAIL: run chip_smoke.py from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # files and the generator disk cache go to a fresh directory of the
    # checkout's build/, removed at exit, so a second run starts cold too;
    # the cache is off (its default) but in phase 14 (iv)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    os.environ.pop(CACHE_VAR, None)
    from blitzar_tpu_torch import api, generators
    from blitzar_tpu_torch.curves import weierstrass as wc
    from blitzar_tpu_torch.msm import engine
    from blitzar_tpu_torch.ops import build
    from blitzar_tpu_torch.ops import cuda_point as cp

    report: dict = {"timings": {}}
    try:
        check(generators.DISK_DIR == "", "the generator disk cache is off by default")
        card = card_line()
        print(f"card: {card}", flush=True)
        built_here = not (build.BUILD_ROOT / build.digest() / build.LIB_NAME).exists()
        t0 = time.perf_counter()
        build.library()
        report["timings"]["build_s"] = time.perf_counter() - t0
        print(f"ok  kernels built in {report['timings']['build_s']:.1f} s from {build.CSRC}", flush=True)
        log = (build.BUILD_ROOT / build.digest() / "ptxas.log").read_text()
        for line in log.splitlines():
            if line.startswith("==") or "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
        report["ptxas_table_builds"] = table_build_ptxas(log, built_here)
        report["ptxas_lookup_and_reduce"] = lookup_reduce_ptxas(log, built_here)
        report["ptxas_weierstrass_query"] = w_query_ptxas(log, built_here)
        report["ptxas_ladders"] = ladder_ptxas(log, built_here)
        report["ptxas_affine_and_sum_round"] = affine_sum_ptxas(log, built_here)
        report["ptxas_conversions_and_horner"] = conversion_horner_ptxas(log, built_here)
        report["ptxas_fewrow_and_finvert"] = conversion_horner_ptxas(log, built_here, FEWROW_FINVERT_SOURCES)
        report["ptxas_codec"] = conversion_horner_ptxas(log, built_here, CODEC_SOURCES)
        report["ptxas_rows_and_adds"] = conversion_horner_ptxas(log, built_here, ROWS_ADDS_SOURCES)
        report["ptxas_wadd"] = conversion_horner_ptxas(log, built_here, WADD_SOURCES)
        PATH_SHAPES.install()

        results = phase_kernels(torch, torch.device("cuda"))
        results.update(phase_wkernels(torch, torch.device("cuda")))
        results.update(phase_mont_kernels(torch, torch.device("cuda")))

        # the commitment path: launches counted from 0 over phases 3-6
        api.init("gpu")
        cp.reset_launches()
        with PATH_SHAPES.phase("commitment"), signed_combines() as signed_calls:
            phase_api_small(torch)
            phase_w_api_small(torch)
            per_commitment = phase_full_width(torch, report["timings"])
            per_commitment.update({k: v for k, v in phase_w_full_width(torch, report["timings"]).items()
                                   if k in W_KERNELS})
        commit_launches = dict(cp.LAUNCHES)
        report["signed_combines_commitment_path"] = signed_calls
        ed_calls = [c for c in signed_calls if c["curve"] == "ristretto255"]
        w_calls = [c for c in signed_calls if c["curve"] != "ristretto255"]
        check(ed_calls and all(c["launches"] == {"doubling_combine": 1, "ed_add": 1} and c["negs"] == 0
                               for c in ed_calls),
              f"each signed ristretto255 commitment's Q_pos - Q_neg: one ed_add launch reading Q_neg negated, no "
              f"plain neg ({len(ed_calls)} calls)")
        check({(c["curve"], c["streamed"]) for c in w_calls} == {(c.name, s) for c in wc.CURVES for s in (False, True)}
              and all(c["launches"] == {"w_doubling_combine": 1, "wadd": 1} and c["negs"] == 0 for c in w_calls),
              f"each signed Weierstrass commitment's Q_pos - Q_neg (handle and streamed, every curve): one wadd "
              f"launch reading Q_neg negated, no plain curve.neg ({len(w_calls)} calls: "
              f"{sorted({(c['curve'], c['streamed'], c['negs']) for c in w_calls})})")
        # the proof path: launches counted from 0 over phases 8-10, from empty
        # generator and handle caches, so that the proofs derive their own G
        # and Q and build their own handles
        generators.CACHE.reset()
        engine.clear_handle_cache()
        cp.reset_launches()
        with PATH_SHAPES.phase("proof"):
            phase_proof_vectors(torch)
            phase_sumcheck_full_width(torch, report["timings"])
            phase_ipa_full_width(torch, report["timings"])
        proof_launches = dict(cp.LAUNCHES)
        # the large-n path: launches counted from 0 over (a)-(g), from empty
        # handle caches; then (h), the kernels against their plain versions
        clear_handles(torch)
        cp.reset_launches()
        with PATH_SHAPES.phase("large_n"):
            large = phase_large_n(torch, report["timings"])
        large_launches = dict(cp.LAUNCHES)
        large_instances = dict(cp.INSTANCE_LAUNCHES)
        results.update(phase_large_kernels(torch, torch.device("cuda"), large["rows24"]))
        results["w_lookup_msm"]["by_curve_2^18_chunk"] = results.pop("w_lookup_msm_by_curve")
        results["w_doubling_combine"]["by_curve_2^18_chunk"] = results.pop("w_doubling_combine_by_curve")
        results["w_build_table"]["by_curve_2^18_chunk"] = results.pop("w_build_table_by_curve")
        report["earlier_table_build_ms"] = earlier_table_build_times(results)
        report["earlier_lookup_reduce_ms"] = earlier_lookup_reduce_times(results)
        report["earlier_w_query_ms"] = earlier_w_query_times(results)
        report["earlier_build_ladder_ms"] = build_ladder_times(results)
        # handle files, packed and vlen queries, the disk cache: counts from
        # 0 over (i)-(iv), also by element count; then the field kernels
        # against their plain versions at those counts
        clear_handles(torch)
        cp.reset_launches()
        with launch_shapes({}) as file_shapes, PATH_SHAPES.phase("files"):
            phase_files(torch, report["timings"], work)
        file_launches = dict(cp.LAUNCHES)
        file_instances = dict(cp.INSTANCE_LAUNCHES)
        # (iv)'s 2^20 load in three parts (host, copy, kernel), outside the
        # path's counts, as the proofs' rows are split (rows_parts)
        parts = report["timings"]["generators_2^20_load_parts_ms"] = cache_load_parts(
            torch, os.path.join(work, "gencache", f"ristretto_gen_a_{FILES_N}.npy"), FILES_N)
        print(f"    (iv) the 2^20 load: host {parts['host']:.2f} ms, copy {parts['copy']:.2f} ms, kernel "
              f"{parts['kernel']:.3f} ms ({parts['kernel_device_ms']:.4f} ms on the device), "
              f"{parts['bytes_copied']} bytes copied", flush=True)
        results.update(phase_field_kernels(torch, torch.device("cuda"), file_shapes,
                                           PATH_SHAPES.counts.get("w_affine", {})))
        results.update(phase_conversion_kernels(torch, torch.device("cuda"), file_shapes))
        results.update(phase_cache_load_kernel(torch, torch.device("cuda"), file_shapes))
        results["mont_mul_ew"]["base_fields"] = results.pop("mont_mul_ew_base_fields")
        # the bucket engine, then the few-row query, from empty handle
        # caches: each path's launches are those of its main-path calls
        # alone, counted from 0 around each; then their kernels against plain
        clear_handles(torch)
        with horner_calls() as horner, combine_calls() as combines, PATH_SHAPES.phase("bucket", on=False):
            bucket_launches = phase_bucket(torch, report["timings"])
        report["bucket_horner_calls"] = horner
        report["bucket_combine_calls"] = combines
        check(horner and all(c["launches"] == {"ed_horner" if c["curve"] == "ristretto255" else "w_horner": 1}
                             for c in horner),
              f"(a) each bucket-engine commitment's Horner: one ed_horner or w_horner launch and no other "
              f"({len(horner)} calls: {sorted({(c['curve'], tuple(c['shape'])) for c in horner})})")
        check(len(combines) == len(horner) and all(
                  c["launches"] == ({"ed_window_sums": 1, "ed_horner": 1} if c["curve"] == "ristretto255" else
                                    {"w_window_sums": 1, "w_horner": 1}) for c in combines),
              f"(a) each bucket-engine commitment's combine: one window-sum and one Horner launch, no ed_add, wadd "
              f"or tree_reduce_lanes ({len(combines)} calls: {sorted({(c['curve'], c['rows']) for c in combines})})")
        clear_handles(torch)
        with PATH_SHAPES.phase("fewrow", on=False):
            fewrow_inputs, fewrow_launches = phase_fewrow(torch, report["timings"])
        results.update(phase_fewrow_kernels(torch, torch.device("cuda"), fewrow_inputs,
                                            PATH_SHAPES.counts.get("fewrow_niels", {})))
        report["earlier_add_ms"] = earlier_add_times(results)
        results.update(phase_horner_kernels(torch, torch.device("cuda"), PATH_SHAPES.counts))
        results.update(phase_window_kernels(torch, torch.device("cuda"), PATH_SHAPES.counts))
        del fewrow_inputs
        clear_handles(torch)
        # tree_reduce_lanes at every shape the paths above launched it at
        tree_shapes = phase_tree_shapes(torch, torch.device("cuda"), PATH_SHAPES.counts.get("tree_reduce_lanes", {}))
        report["tree_reduce_lanes_by_shape"] = tree_shapes
        results["tree_reduce_lanes"]["launches_x_gap_ms_all_shapes"] = tree_shapes["launches_x_gap_ms"]
        # w_build_table, doubling_combine and mont_sum_round at every shape
        # the paths launched them at
        ranked = report["kernels_by_shape"] = phase_ranked_shapes(torch, torch.device("cuda"), PATH_SHAPES.counts)
        for name, rec in ranked.items():
            results[name]["launches_x_gap_ms_all_shapes"] = rec["launches_x_gap_ms"]
            results[name]["launches_all_paths"] = rec["launches"]
        # the ristretto255 codec at every count the paths launched it at
        results.update(phase_codec_kernels(torch, torch.device("cuda"), PATH_SHAPES.counts))
        results["mont_mul_ew"]["launches_files_path_by_field"] = {
            k.split("/")[1]: v for k, v in file_instances.items() if k.startswith("mont_mul_ew/")}
        for name in cp.KERNELS:
            path = (large_launches if name in LARGE_KERNELS else
                    proof_launches if name in PROOF_KERNELS + DECODE_KERNELS else
                    file_launches if name in FILE_KERNELS else bucket_launches if name in BUCKET_KERNELS else
                    fewrow_launches if name in FEWROW_KERNELS else commit_launches)
            results[name]["launches"] = path[name]
            results[name]["launches_commitment_path"] = commit_launches[name]
            results[name]["launches_proof_path"] = proof_launches[name]
            results[name]["launches_large_n_path"] = large_launches[name]
            results[name]["launches_files_path"] = file_launches[name]
            results[name]["launches_bucket_path"] = bucket_launches[name]
            results[name]["launches_fewrow_path"] = fewrow_launches[name]
            # launches in the cold 2^20 commitment: ristretto255 for the
            # Edwards kernels, bn254 G1 for the Weierstrass ones
            results[name]["launches_per_2^20_commitment"] = per_commitment.get(name)
        results["tree_reduce_lanes"]["launches_large_n_path_by_curve"] = {
            k.split("/")[1]: v for k, v in large_instances.items() if k.startswith("tree_reduce_lanes/")}
        commit_kernels = [k for k in cp.KERNELS if k not in PROOF_KERNELS + DECODE_KERNELS + LARGE_KERNELS
                          + FILE_KERNELS + BUCKET_KERNELS + FEWROW_KERNELS]
        check(all(commit_launches[k] > 0 for k in commit_kernels),
              f"every commitment kernel launched on the commitment path: {commit_launches}")
        check(all(proof_launches[k] > 0 for k in PROOF_PATH_KERNELS),
              f"every proof kernel launched on the proof path: {proof_launches}")
        check(all(large_launches[k] > 0 for k in LARGE_KERNELS) and all(large_instances.get(k, 0) > 0
                                                                         for k in LARGE_INSTANCES),
              f"every streamed-path kernel and instantiation launched on the large-n path: {large_instances}")
        check(all(file_launches[k] > 0 for k in FILE_PATH_KERNELS) and all(file_instances.get(k, 0) > 0
                                                                            for k in FILE_INSTANCES),
              f"ed_from_affine_rows, w_affine, the ristretto255 conversions, and mont_mul_ew in both base fields, "
              f"launched on the files and cache path: { {k: file_launches[k] for k in FILE_KERNELS} } {file_instances}")
        check(all(bucket_launches[k] > 0 for k in HORNER_KERNELS + WINDOW_KERNELS + ("tree_reduce_lanes", "ed_add"))
              and all(bucket_launches[k] == 0 for k in HORNER_STEP_KERNELS),
              f"ed_window_sums, w_window_sums, ed_horner, w_horner, tree_reduce_lanes and ed_add launched on the "
              f"bucket engine's path, ed_double and wdouble not: {bucket_launches}")
        check(all(fewrow_launches[k] > 0 for k in FEWROW_KERNELS),
              f"niels_add and fewrow_niels launched on the few-row query's path: "
              f"{ {k: fewrow_launches[k] for k in FEWROW_KERNELS} }")
        report["kernels"] = [results[k] for k in cp.KERNELS]
        report["ranking"] = ranking(report["kernels"], ranked, tree_shapes)
        for row in report["ranking"][:8]:
            print(f"    rank: {row['kernel']} {row['launches_x_gap_ms']:.3f} ms over {row['launches']} launches "
                  f"({row['shapes']})")
        report["card"] = card
        report["device"] = torch.cuda.get_device_name(0)
        print("timings: " + json.dumps(report["timings"]), flush=True)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": report["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
