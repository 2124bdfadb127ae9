"""The port's C ABI on the card, entry by entry against the port's Python API
in the same process (``chip_smoke.py`` phase 22 runs it):

    python tests/torch_capi_card_driver.py <libblitzar_tpu.so> <work dir> [--log2-n 20]
    python tests/torch_capi_card_driver.py <libblitzar_tpu.so> <work dir> --no-card

The library is loaded with ctypes into this process, so the bridge and the
test share the port's modules: ``sxt_init`` with the GPU backend
initialises the API too, and every entry's bytes are held to the API's on
the same inputs. At 2^20 (the default): the counter-scalar commitment and
``_with_generators`` over ``sxt_ristretto255_get_generators``' structs (the
pinned digest both times; the ABI's commitment launches the API's kernels,
by ``cuda_point``'s counters, and runs no plain version); a handle from
those structs with one 32-byte query; packed and vlen queries at
Proof-of-SQL's widths and lengths; a 2^16 handle written and read back;
bn254 G1 at 2^20, Grumpkin and bls12-381 G1 at 2^16 over 521 oracle points
tiled to n; the IPA (prove, verify, a tampered ``ap``) and the sumcheck in
both fields through the callback. The warm commitment's ABI share is split
on the host clock: the bridge's copy of the column alone, its descriptor
parse (that copy included), and the API's call on the parsed descriptors.
Prints ``CAPI_CARD <json>`` (checks and host-clock timings, ABI beside
API) and exits 0, or prints ``FAIL: ...`` and exits 1. ``--no-card`` (run with no visible card): ``sxt_init`` with
the GPU backend must return 1, then a commitment is called, which must abort
the process. The CPU backend's checks against blitzar_tpu are
``tests/torch_capi_driver.py``'s.

It imports the port and ``chip_smoke.py``'s helpers, never jax or
blitzar_tpu.
"""

import argparse
import contextlib
import ctypes
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
from torch_capi_structs import CALLBACK, SequenceDescriptor, SumcheckDescriptor, init, load  # noqa: E402

CHECKS: list[str] = []


def check(cond, what: str) -> None:
    if not cond:
        raise cs.Failure(what)
    CHECKS.append(what)
    print(f"ok  {what}", flush=True)


def ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(arr.ctypes.data)


def descriptor(rows: np.ndarray):
    """One (n, nbytes) uint8 column as a SequenceDescriptor array."""
    desc = (SequenceDescriptor * 1)()
    desc[0] = SequenceDescriptor(rows.shape[1], rows.shape[0], ctypes.cast(rows.ctypes.data,
                                                                           ctypes.POINTER(ctypes.c_uint8)), 0)
    return desc


@contextlib.contextmanager
def counting_plain():
    """Counts the calls of every plain version of the ops modules while
    active: on the card's path there must be none."""
    from blitzar_tpu_torch.ops import cuda_field, cuda_mont, cuda_point, cuda_wpoint

    calls, saved = [], []
    for module in (cuda_point, cuda_wpoint, cuda_mont, cuda_field):
        for name in dir(module):
            fn = getattr(module, name)
            if name.endswith("_plain") and callable(fn):
                saved.append((module, name, fn))
                setattr(module, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


class Run:
    def __init__(self, lib_path: str, log2_n: int):
        import torch

        from blitzar_tpu_torch import api, capi_bridge
        from blitzar_tpu_torch.ops import cuda_point as cp

        self.torch, self.api, self.bridge, self.cp = torch, api, capi_bridge, cp
        self.lib = load(lib_path)
        self.n = 1 << log2_n
        self.n_small = 1 << min(16, log2_n)
        self.timings: dict = {}

    def sync(self):
        self.torch.cuda.synchronize()

    def timed(self, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, (time.perf_counter() - t0) * 1e3

    def launches(self, fn):
        """(result, kernel launches, plain calls) of fn."""
        before = dict(self.cp.LAUNCHES)
        with counting_plain() as plain:
            out = fn()
        self.sync()
        return out, {k: v - before[k] for k, v in self.cp.LAUNCHES.items() if v != before[k]}, plain

    def pinned(self, log2_n: int, hexes) -> bool:
        """The digest is the pinned one where the repo pins it."""
        return log2_n not in cs.PINNED_RISTRETTO_MSM or cs.digest(np.stack(hexes)) == cs.PINNED_RISTRETTO_MSM[log2_n]

    # -- the ristretto255 commitments -----------------------------------------

    def abi_commit(self, rows, gens=None) -> np.ndarray:
        out = np.zeros((1, 32), np.uint8)
        if gens is None:
            self.lib.sxt_curve25519_compute_pedersen_commitments(ptr(out), 1, descriptor(rows), ctypes.c_uint64(0))
        else:
            self.lib.sxt_curve25519_compute_pedersen_commitments_with_generators(ptr(out), 1, descriptor(rows),
                                                                                 ptr(gens))
        return out

    def commitments(self):
        api, n, log2_n = self.api, self.n, self.n.bit_length() - 1
        rows = cs.counter_scalars(n, 32)
        desc = [api.SequenceDescriptor(32, n, rows)]
        got, self.timings[f"abi_commit_2^{log2_n}_cold_ms"] = self.timed(lambda: self.abi_commit(rows))
        check(self.pinned(log2_n, got), f"the ABI's 2^{log2_n} commitment gives the pinned digest {cs.digest(got)}")
        abi_ms, api_ms = [], []
        for _ in range(3):  # in turns, warm
            a, t = self.timed(lambda: self.abi_commit(rows))
            abi_ms.append(t)
            b, t = self.timed(lambda: api.compute_curve25519_commitments(desc))
            api_ms.append(t)
            check(np.array_equal(a, got) and np.array_equal(b, got), "warm: the ABI's bytes equal the API's")
        self.timings[f"abi_commit_2^{log2_n}_warm_ms_all"] = abi_ms
        self.timings[f"api_commit_2^{log2_n}_warm_ms_all"] = api_ms
        self.timings[f"abi_commit_2^{log2_n}_warm_ms_median"] = float(np.median(abi_ms))
        self.timings[f"api_commit_2^{log2_n}_warm_ms_median"] = float(np.median(api_ms))
        self.timings[f"abi_share_commit_2^{log2_n}_warm_ms"] = float(np.median(abi_ms) - np.median(api_ms))
        _, abi_launches, abi_plain = self.launches(lambda: self.abi_commit(rows))
        _, api_launches, _ = self.launches(lambda: api.compute_curve25519_commitments(desc))
        self.timings["abi_commit_launches"] = abi_launches
        check(abi_launches == api_launches and abi_launches,
              f"the ABI's 2^{log2_n} commitment makes the API's kernel launches: {abi_launches}")
        check(not abi_plain, f"the ABI's commitment runs no plain version ({abi_plain})")
        self.split(rows, got)

        # the canonical generators as structs, and _with_generators over them
        gens = np.zeros((n, 160), np.uint8)
        _, self.timings[f"abi_get_generators_2^{log2_n}_ms"] = self.timed(
            lambda: self.lib.sxt_ristretto255_get_generators(ptr(gens), ctypes.c_uint64(0), ctypes.c_uint64(n)))
        api_gens = api.get_ristretto255_generators(n)
        parsed = self.bridge.parse_ristretto255_points(gens.ctypes.data, n)
        from blitzar_tpu_torch.fields import fp25519 as F

        check(all(self.torch.equal(p, F.canonicalize(q)) for p, q in zip(parsed, api_gens)),
              f"sxt_ristretto255_get_generators' 2^{log2_n} structs hold the API's generators")
        want = self.abi_commit(rows)
        ms_abi, ms_api = [], []
        for _ in range(3):
            a, t = self.timed(lambda: self.abi_commit(rows, gens))
            ms_abi.append(t)
            b, t = self.timed(lambda: api.compute_curve25519_commitments(desc, api_gens))
            ms_api.append(t)
            check(np.array_equal(a, want) and np.array_equal(b, want),
                  f"_with_generators over the 2^{log2_n} structs: the pinned digest, the API's bytes")
        self.timings[f"abi_with_generators_2^{log2_n}_warm_ms_all"] = ms_abi
        self.timings[f"api_with_generators_2^{log2_n}_warm_ms_all"] = ms_api
        self.timings[f"abi_with_generators_2^{log2_n}_warm_ms_median"] = float(np.median(ms_abi))
        self.timings[f"api_with_generators_2^{log2_n}_warm_ms_median"] = float(np.median(ms_api))
        return rows, gens, want

    def split(self, rows, want):
        """The warm commitment's ABI share in parts, each timed alone in
        turns: the bridge's one copy of the column (``_read``), its parse of
        the descriptor (that copy and the struct's fields), and the API's
        call on the parsed descriptors. What the ABI call takes beyond the
        last two is the shim's and ctypes' own."""
        log2_n, desc = self.n.bit_length() - 1, descriptor(rows)
        parts: dict[str, list[float]] = {"read": [], "parse": [], "api_on_parsed": []}
        for _ in range(3):
            _, t = self.timed(lambda: self.bridge._read(rows.ctypes.data, rows.nbytes))
            parts["read"].append(t)
            parsed, t = self.timed(lambda: self.bridge.parse_descriptors(ctypes.addressof(desc), 1))
            parts["parse"].append(t)
            got, t = self.timed(lambda: self.api.compute_curve25519_commitments(parsed))
            parts["api_on_parsed"].append(t)
            check(np.array_equal(got, want), "the API on the bridge's parsed descriptor gives the ABI's bytes")
        for part, ms in parts.items():
            self.timings[f"split_commit_2^{log2_n}_{part}_ms_all"] = ms
            self.timings[f"split_commit_2^{log2_n}_{part}_ms_median"] = float(np.median(ms))

    # -- handles ------------------------------------------------------------

    def compressed(self, res: np.ndarray) -> np.ndarray:
        """sxt_ristretto255 result structs -> their (n, 32) encodings."""
        return self.api.compress_ristretto255(self.bridge.parse_ristretto255_points(res.ctypes.data, res.shape[0]))

    def query(self, hid, rows) -> np.ndarray:
        res = np.zeros((1, 160), np.uint8)
        self.lib.sxt_fixed_multiexponentiation(ptr(res), ctypes.c_void_p(hid), ctypes.c_uint(rows.shape[1]),
                                               ctypes.c_uint(1), ctypes.c_uint(rows.shape[0]), ptr(rows))
        return res

    def handles(self, rows, gens, want, work: str):
        api, n, log2_n = self.api, self.n, self.n.bit_length() - 1
        hid, ms = self.timed(lambda: self.lib.sxt_multiexp_handle_new(ctypes.c_uint(0), ptr(gens), ctypes.c_uint(n)))
        self.timings[f"abi_handle_new_2^{log2_n}_ms"] = ms
        handle = self.bridge.HANDLES[hid]
        res, self.timings[f"abi_handle_query_2^{log2_n}_ms"] = self.timed(lambda: self.query(hid, rows))
        check(np.array_equal(self.compressed(res), want) and np.array_equal(
            api.compress_ristretto255(api.fixed_multiexponentiation(handle, rows[None])), want),
            f"a handle from the 2^{log2_n} structs: one 32-byte query, the pinned digest, the API's result")

        # packed and vlen at Proof-of-SQL's widths and lengths
        packed = np.random.default_rng(43).integers(0, 256, size=(n, 64), dtype=np.uint8)
        bits = (ctypes.c_uint32 * len(cs.POSQL_BITS))(*cs.POSQL_BITS)
        lengths = [min(length, n) for length in cs.POSQL_LENGTHS]
        lens = (ctypes.c_uint32 * len(lengths))(*lengths)
        out = np.zeros((len(cs.POSQL_BITS), 160), np.uint8)
        num = ctypes.c_uint(len(cs.POSQL_BITS))
        _, ms = self.timed(lambda: self.lib.sxt_fixed_packed_multiexponentiation(
            ptr(out), ctypes.c_void_p(hid), bits, num, ctypes.c_uint(n), ptr(packed)))
        self.timings[f"abi_packed_2^{log2_n}_ms"] = ms
        want_packed = api.compress_ristretto255(api.fixed_packed_multiexponentiation(handle, cs.POSQL_BITS, n, packed))
        check(np.array_equal(self.compressed(out), want_packed),
              f"the packed query at 2^{log2_n}, widths {cs.POSQL_BITS}: the API's points")
        _, ms = self.timed(lambda: self.lib.sxt_fixed_vlen_multiexponentiation(
            ptr(out), ctypes.c_void_p(hid), bits, lens, num, ptr(packed)))
        self.timings[f"abi_vlen_2^{log2_n}_ms"] = ms
        want_vlen = api.compress_ristretto255(api.fixed_vlen_multiexponentiation(handle, cs.POSQL_BITS, lengths,
                                                                                 packed[: max(lengths)]))
        check(np.array_equal(self.compressed(out), want_vlen), f"the vlen query at 2^{log2_n}, lengths {lengths}: "
                                                               f"the API's points")
        self.lib.sxt_multiexp_handle_free(ctypes.c_void_p(hid))
        check(hid not in self.bridge.HANDLES, "free drops the handle")

        # a 2^16 handle written and read back
        small, log2_small = self.n_small, self.n_small.bit_length() - 1
        gens_small = np.ascontiguousarray(gens[:small])
        rows_small = cs.counter_scalars(small, 32)
        path = os.path.join(work, "abi_handle.npz").encode()
        h16 = self.lib.sxt_multiexp_handle_new(ctypes.c_uint(0), ptr(gens_small), ctypes.c_uint(small))
        _, self.timings[f"abi_write_2^{log2_small}_ms"] = self.timed(
            lambda: self.lib.sxt_multiexp_handle_write_to_file(ctypes.c_void_p(h16), path))
        back, self.timings[f"abi_read_2^{log2_small}_ms"] = self.timed(
            lambda: self.lib.sxt_multiexp_handle_new_from_file(ctypes.c_uint(0), path))
        got = self.compressed(self.query(back, rows_small))
        api_back = api.multiexp_handle_new_from_file(0, path.decode())
        check(self.pinned(log2_small, got) and np.array_equal(
            got, api.compress_ristretto255(api.fixed_multiexponentiation(api_back, rows_small[None]))),
            f"a 2^{log2_small} handle written and read back: the pinned digest, the API's read")
        for h in (h16, back):
            self.lib.sxt_multiexp_handle_free(ctypes.c_void_p(h))
        os.remove(path)

    # -- the Weierstrass commitments ------------------------------------------

    def weierstrass(self):
        from blitzar_tpu_torch.curves import weierstrass as wc

        api, bridge = self.api, self.bridge
        for curve, n in ((wc.BN254_G1, self.n), (wc.GRUMPKIN, self.n_small), (wc.BLS12381_G1, self.n_small)):
            key = f"{curve.name}_2^{n.bit_length() - 1}"
            pts = list(cs.oracle_points(curve))
            f, k = curve.field, curve.field.nbytes // 8
            stride = bridge.affine_stride(curve)
            period = np.zeros((len(pts), stride), np.uint8)
            for i, (x, y) in enumerate(pts):
                for j, v in enumerate((x, y)):
                    period[i, 8 * k * j : 8 * k * (j + 1)] = np.frombuffer(
                        (v * f.r % f.modulus).to_bytes(8 * k, "little"), np.uint8)
            structs = np.ascontiguousarray(np.resize(period, (n, stride)))
            rows = cs.counter_scalars(n, 32)
            nbytes = 48 if curve is wc.BLS12381_G1 else stride
            out = np.zeros((1, nbytes), np.uint8)
            entry = {wc.BLS12381_G1: self.lib.sxt_bls12_381_g1_compute_pedersen_commitments_with_generators,
                     wc.BN254_G1: self.lib.sxt_bn254_g1_uncompressed_compute_pedersen_commitments_with_generators,
                     wc.GRUMPKIN: self.lib.sxt_grumpkin_uncompressed_compute_pedersen_commitments_with_generators}
            _, ms = self.timed(lambda: entry[curve](ptr(out), 1, descriptor(rows), ptr(structs)))
            self.timings[f"abi_{key}_commit_ms"] = ms
            gens, _ = cs.tiled_generators(curve, n, api.device())
            want = api.COMMITMENT_ENTRIES[curve]([api.SequenceDescriptor(32, n, rows)], gens)
            if curve is not wc.BLS12381_G1:
                want = bridge.emit_uncompressed(curve, want)
            check(np.array_equal(out, want), f"{key} _with_generators over 521 tiled oracle points: the API's bytes")

    # -- the proofs -----------------------------------------------------------

    def ipa(self):
        from blitzar_tpu_torch.proof.transcript import Transcript

        api, n, log2_n = self.api, self.n, self.n.bit_length() - 1
        rng = np.random.default_rng(3)
        a, b = cs.bench_rows(rng, (n,)), cs.bench_rows(rng, (n,))
        rounds = log2_n
        lv, rv, ap = (np.zeros((rounds, 32), np.uint8), np.zeros((rounds, 32), np.uint8), np.zeros(32, np.uint8))
        label = Transcript(b"bench").to_bytes203()

        def abi_prove():
            tr = np.frombuffer(label, np.uint8).copy()
            self.lib.sxt_curve25519_prove_inner_product(ptr(lv), ptr(rv), ptr(ap), ptr(tr), ctypes.c_uint64(n),
                                                        ctypes.c_uint64(0), ptr(a), ptr(b))
            return tr

        def api_prove():
            tr = Transcript(b"bench")
            return api.prove_inner_product(tr, n, 0, a, b), tr

        abi_ms, api_ms = [], []
        for _ in range(2):  # in turns; the second of each is warm
            tr, t = self.timed(abi_prove)
            abi_ms.append(t)
            ((l_api, r_api, ap_api), tr_api), t = self.timed(api_prove)
            api_ms.append(t)
            check(np.array_equal(lv, l_api) and np.array_equal(rv, r_api)
                  and int.from_bytes(ap.tobytes(), "little") == ap_api and tr.tobytes() == tr_api.to_bytes203(),
                  f"the IPA 2^{log2_n} prove: L, R, ap and the transcript equal the API's")
        self.timings[f"abi_ipa_2^{log2_n}_prove_ms_all"] = abi_ms
        self.timings[f"api_ipa_2^{log2_n}_prove_ms_all"] = api_ms
        av = np.frombuffer(a[:, :8].tobytes(), "<u8").tolist()
        bv = np.frombuffer(b[:, :8].tobytes(), "<u8").tolist()
        from blitzar_tpu_torch.proof import inner_product as tipa

        product = np.frombuffer((sum(x * y for x, y in zip(av, bv)) % tipa.ORDER).to_bytes(32, "little"), np.uint8)
        a_commit_pt, _ = api.decompress_ristretto255(api.compute_curve25519_commitments([api.SequenceDescriptor(32, n, a)]))
        a_commit = np.ascontiguousarray(self.bridge.emit_ristretto255_points(a_commit_pt))

        def abi_verify(apv):
            tr = np.frombuffer(label, np.uint8).copy()
            ok = self.lib.sxt_curve25519_verify_inner_product(
                ptr(tr), ctypes.c_uint64(n), ctypes.c_uint64(0), ptr(b), ptr(product), ptr(a_commit), ptr(lv),
                ptr(rv), ptr(apv))
            return ok, tr

        abi_ms, api_ms = [], []
        for _ in range(2):  # in turns; the second of each is warm
            (ok, tr), t = self.timed(lambda: abi_verify(ap))
            abi_ms.append(t)
            tr_api = Transcript(b"bench")
            ok_api, t = self.timed(lambda: api.verify_inner_product(tr_api, n, 0, b, product, a_commit_pt, lv, rv, ap))
            api_ms.append(t)
            check(ok == 1 and ok_api and tr.tobytes() == tr_api.to_bytes203(),
                  f"the IPA 2^{log2_n} verify returns 1, its transcript the API's")
        self.timings[f"abi_ipa_2^{log2_n}_verify_ms_all"] = abi_ms
        self.timings[f"api_ipa_2^{log2_n}_verify_ms_all"] = api_ms
        bad = ap.copy()
        bad[0] ^= 1
        check(abi_verify(bad)[0] == 0, f"the IPA 2^{log2_n} verify returns 0 for a tampered ap")

    def sumcheck(self):
        from blitzar_tpu_torch.proof import sumcheck as tsc
        from blitzar_tpu_torch.proof.transcript import Transcript

        api, n, log2_n = self.api, self.n, self.n.bit_length() - 1
        ptable, pterms = cs.SUMCHECK_BENCH
        degree = max(k for _, k in ptable)
        rows = cs.bench_rows(np.random.default_rng(4), (3, n))
        for fid, codec in api.FIELD_CODECS.items():
            field = codec.field
            m = field.modulus

            def elem(v: int) -> bytes:  # the ABI's bytes of an element
                return (v % m if fid == api.SXT_FIELD_SCALAR255 else v % m * field.r % m).to_bytes(32, "little")

            def abi_prove():
                # the reference transcript, driven through the callback
                tr = tsc.ReferenceSumcheckTranscript(Transcript(b"bench"), codec)
                tr.init(log2_n, degree)

                def callback(r_ptr, context, poly_ptr, poly_len):
                    data = ctypes.string_at(poly_ptr, 32 * poly_len)
                    tr.transcript.append_message(b"P", data)
                    ctypes.memmove(r_ptr, elem(codec.challenge_from_bytes(tr.transcript.challenge_bytes(b"R", 32))),
                                   32)

                cb = CALLBACK(callback)
                table = b"".join(elem(mult) + int(k).to_bytes(4, "little") + bytes(4) for mult, k in ptable)
                table = np.frombuffer(table, np.uint8).copy()
                terms = (ctypes.c_uint32 * len(pterms))(*pterms)
                desc = SumcheckDescriptor(ctypes.c_void_p(rows.ctypes.data), ctypes.c_void_p(table.ctypes.data), terms,
                                          n, 3, len(ptable), len(pterms), degree)
                polys = np.zeros((log2_n, degree + 1, 32), np.uint8)
                point = np.zeros((log2_n, 32), np.uint8)
                self.lib.sxt_prove_sumcheck(ptr(polys), ptr(point), ctypes.c_uint(fid), ctypes.byref(desc),
                                            ctypes.cast(cb, ctypes.c_void_p), None)
                return polys, point

            abi_ms, api_ms = [], []
            for _ in range(2):
                (polys, point), t = self.timed(abi_prove)
                abi_ms.append(t)
                (want_polys, want_point), t = self.timed(
                    lambda: api.prove_sumcheck(fid, rows, ptable, pterms, n, transcript=Transcript(b"bench")))
                api_ms.append(t)
                check(polys.tobytes() == b"".join(elem(c) for p in want_polys for c in p)
                      and point.tobytes() == b"".join(elem(c) for c in want_point),
                      f"the sumcheck 2^{log2_n} ({codec.name}) through the callback: the API's round polynomials "
                      f"and evaluation point")
            self.timings[f"abi_sumcheck_{codec.name}_2^{log2_n}_ms_all"] = abi_ms
            self.timings[f"api_sumcheck_{codec.name}_2^{log2_n}_ms_all"] = api_ms


def no_card(lib_path: str) -> int:
    lib = load(lib_path)
    rc = init(lib, 2)
    print(f"sxt_init(SXT_GPU_BACKEND) = {rc}", flush=True)
    if rc != 1:
        return 0  # the caller sees no abort and fails
    print("REFUSED", flush=True)
    out = np.zeros((1, 32), np.uint8)
    lib.sxt_curve25519_compute_pedersen_commitments(ptr(out), 1, descriptor(cs.counter_scalars(4, 32)),
                                                    ctypes.c_uint64(0))
    print("NOT REACHED", flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("lib")
    parser.add_argument("work")
    parser.add_argument("--log2-n", type=int, default=20)
    parser.add_argument("--no-card", action="store_true")
    args = parser.parse_args()
    if args.no_card:
        return no_card(args.lib)
    run = Run(args.lib, args.log2_n)
    try:
        check(init(run.lib, 2) == 0, "sxt_init with the GPU backend")
        check(run.api.device().type == "cuda", "the API shares the ABI's backend")
        rows, gens, want = run.commitments()
        run.handles(rows, gens, want, args.work)
        del gens
        run.weierstrass()
        run.ipa()
        run.sumcheck()
    except cs.Failure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print("CAPI_CARD " + json.dumps({"checks": len(CHECKS), "timings": run.timings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
