"""Drive the port's libblitzar_tpu.so through all 18 sxt_* entries with the
CPU backend, at small n, in its own process (the shim aborts on misuse and
sxt_init is one-shot):

    python tests/torch_capi_driver.py <libblitzar_tpu.so> <work dir>

Every entry is held to blitzar_tpu's pure-Python oracle
(``blitzar_tpu/refimpl``: ``naive_msm``, ``get_generators``,
``ristretto_encode``, the Weierstrass curves' sums, the IPA prover and
verifier with blitzar_tpu's ``Transcript``) or to the frozen vectors of
``tests/torch_proof_vectors.py``, byte for byte. Each section prints
``PASS <section>`` or ``FAIL <section>: <reason>`` and the run goes on;
``tests/test_torch_capi.py`` reads the lines. No jax is imported (the
oracle is pure Python), so nothing compiles.
"""

import ctypes
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import torch_proof_vectors as vec  # noqa: E402
from torch_capi_structs import CALLBACK, SequenceDescriptor, SumcheckDescriptor, init, load  # noqa: E402
from blitzar_tpu.proof.transcript import Transcript as JTranscript  # noqa: E402
from blitzar_tpu.refimpl import core as R  # noqa: E402
from blitzar_tpu.refimpl import inner_product as RIPA  # noqa: E402
from blitzar_tpu.refimpl import weierstrass as RW  # noqa: E402

P = 2**255 - 19
ORDER = RIPA.ORDER
GRUMPKIN_FIELD = RW.GRUMPKIN.p  # the sumcheck's Grumpkin field: bn254's scalar field

SECTIONS = (
    "init", "pedersen", "pedersen_offset", "with_generators", "get_generators", "one_commit",
    "bls12_381_g1", "bn254_g1", "grumpkin", "handle_ristretto255", "handle_weierstrass",
    "packed_vlen", "files", "ipa", "sumcheck_scalar25519", "sumcheck_grumpkin",
)


KEEP = []  # buffers the descriptors point into


def buf(data) -> ctypes.Array:
    raw = bytes(data)
    out = (ctypes.c_uint8 * max(len(raw), 1)).from_buffer_copy(raw + b"\0" * (len(raw) == 0))
    KEEP.append(out)
    return out


def descriptors(columns):
    """[(nbytes, signed, values)] -> a SequenceDescriptor array; signed values
    are stored in two's complement."""
    arr = (SequenceDescriptor * max(len(columns), 1))()
    for i, (nbytes, signed, values) in enumerate(columns):
        raw = b"".join(int(v % (1 << (8 * nbytes))).to_bytes(nbytes, "little") for v in values)
        data = buf(raw)
        arr[i] = SequenceDescriptor(nbytes, len(values), ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8)),
                                    int(signed))
    return arr


def signed_value(v: int, nbytes: int, signed: bool) -> int:
    a, s = R.decode_scalar(int(v % (1 << (8 * nbytes))).to_bytes(nbytes, "little"), signed)
    return s * a


def ristretto_structs(points, wide: bool = False) -> bytes:
    """Extended points -> sxt_ristretto255 bytes; ``wide`` adds p to each
    coordinate first (limbs that carry a value >= p, the top one 52 bits)."""
    out = b""
    for pt in points:
        for c in pt:
            v = c % P + (P if wide else 0)
            words = [(v >> (51 * i)) & ((1 << 51) - 1) for i in range(4)] + [v >> 204]
            out += b"".join(w.to_bytes(8, "little") for w in words)
    return out


def ristretto_points_of(raw: bytes, n: int):
    """sxt_ristretto255 bytes -> affine (x, y) of each point."""
    words = np.frombuffer(raw, "<u8").reshape(n, 4, 5)
    out = []
    for i in range(n):
        x, y, z, _ = (sum(int(w) << (51 * k) for k, w in enumerate(words[i, c])) % P for c in range(4))
        zi = pow(z, -1, P)
        out.append((x * zi % P, y * zi % P))
    return out


def affine(pt):
    x, y, z, _ = pt
    zi = pow(z, -1, P)
    return (x * zi % P, y * zi % P)


CURVES = {"bls12_381_g1": (RW.BLS12381_G1, 1, 6, 384), "bn254_g1": (RW.BN254_G1, 2, 4, 256),
          "grumpkin": (RW.GRUMPKIN, 3, 4, 256)}


def mont_words(v: int, k: int) -> bytes:
    return v.to_bytes(8 * k, "little")


def affine_structs(name: str, points) -> bytes:
    curve, _, k, rbits = CURVES[name]
    out = b""
    for pt in points:
        if pt is None:
            out += bytes(16 * k) + b"\x01" + bytes(7)
            continue
        x, y = (c * (1 << rbits) % curve.p for c in pt)
        out += mont_words(x, k) + mont_words(y, k)
        if name != "bls12_381_g1":
            out += bytes(8)
    return out


def p2_structs(name: str, points, lam: int = 7) -> bytes:
    """Affine points -> projective Montgomery {X, Y, Z} = lam (x, y, 1);
    None -> (0, 1, 0)."""
    curve, _, k, rbits = CURVES[name]
    r = 1 << rbits
    out = b""
    for pt in points:
        xyz = (0, 1, 0) if pt is None else (lam * pt[0], lam * pt[1], lam)
        out += b"".join(mont_words(c * r % curve.p, k) for c in xyz)
    return out


def p2_points_of(name: str, raw: bytes, n: int):
    curve, _, k, rbits = CURVES[name]
    rinv = pow(1 << rbits, -1, curve.p)
    words = np.frombuffer(raw, "<u8").reshape(n, 3, k)
    out = []
    for i in range(n):
        x, y, z = (sum(int(w) << (64 * j) for j, w in enumerate(words[i, c])) * rinv % curve.p for c in range(3))
        out.append(None if z == 0 else (x * pow(z, -1, curve.p) % curve.p, y * pow(z, -1, curve.p) % curve.p))
    return out


class Driver:
    def __init__(self, lib_path: str, work: str):
        self.lib = load(lib_path)
        for name in ("sxt_multiexp_handle_write_to_file", "sxt_multiexp_handle_free", "sxt_fixed_multiexponentiation",
                     "sxt_fixed_packed_multiexponentiation", "sxt_fixed_vlen_multiexponentiation"):
            getattr(self.lib, name).argtypes = None
        self.work = work
        self.failed = 0

    def run(self, section: str) -> None:
        t0 = time.perf_counter()
        try:
            getattr(self, section)()
            print(f"PASS {section} ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:  # noqa: BLE001 - each section reports and the run goes on
            self.failed += 1
            print(f"FAIL {section}: {traceback.format_exc()}", flush=True)

    # -- init and commitments ------------------------------------------------

    def init(self):
        assert init(self.lib, 1, 4) == 0
        assert init(self.lib, 1) == 1, "a second init returns 1"
        assert init(self.lib, 2) == 1, "a second init (GPU) returns 1"

    def commit(self, columns, offset=0):
        out = (ctypes.c_uint8 * (32 * max(len(columns), 1)))()
        self.lib.sxt_curve25519_compute_pedersen_commitments(out, len(columns), descriptors(columns),
                                                             ctypes.c_uint64(offset))
        return [bytes(out[32 * i : 32 * i + 32]) for i in range(len(columns))]

    @staticmethod
    def expected(columns, offset=0):
        n = max((len(v) for _, _, v in columns), default=0)
        gens = R.get_generators(n, offset)
        return [R.ristretto_encode(R.naive_msm([signed_value(v, nb, s) for v in vals], gens))
                for nb, s, vals in columns]

    def pedersen(self):
        rng = np.random.default_rng(21)
        columns = [(4, False, rng.integers(0, 2**32, 6).tolist()),
                   (1, True, [-128, 127, -1, 0, 5]),
                   (32, False, [2**255 - 1, 3, 2**200 + 7]),
                   (3, False, []),
                   (16, True, [-(2**127), 2**127 - 1, -5]),
                   (2, False, rng.integers(0, 2**16, 7).tolist())]
        assert self.commit(columns) == self.expected(columns)
        assert self.commit([]) == []
        assert self.commit([(8, False, [])]) == [bytes(32)], "an empty column commits to the identity"

    def pedersen_offset(self):
        columns = [(8, False, [11, 2**63, 5, 0, 9]), (1, True, [-3, 4])]
        assert self.commit(columns, offset=5) == self.expected(columns, offset=5)

    def generators(self, n, offset=0):
        out = (ctypes.c_uint8 * (160 * max(n, 1)))()
        assert self.lib.sxt_ristretto255_get_generators(out, ctypes.c_uint64(offset), ctypes.c_uint64(n)) == 0
        return bytes(out)[: 160 * n]

    def with_generators(self):
        columns = [(4, False, [2000, 7500, 5000, 1500, 9]), (1, True, [-1, 2, -3])]
        want = self.expected(columns, offset=3)
        gens = buf(self.generators(5, offset=3))
        out = (ctypes.c_uint8 * 64)()
        self.lib.sxt_curve25519_compute_pedersen_commitments_with_generators(out, 2, descriptors(columns), gens)
        assert [bytes(out[:32]), bytes(out[32:])] == want
        # limbs that carry each coordinate plus p parse to the same points
        wide = buf(ristretto_structs(R.get_generators(5, 3), wide=True))
        self.lib.sxt_curve25519_compute_pedersen_commitments_with_generators(out, 2, descriptors(columns), wide)
        assert [bytes(out[:32]), bytes(out[32:])] == want

    def get_generators(self):
        got = ristretto_points_of(self.generators(6, offset=2), 6)
        assert got == [affine(g) for g in R.get_generators(6, 2)]
        assert self.generators(0) == b""

    def one_commit(self):
        for n in (0, 1, 5):
            out = (ctypes.c_uint8 * 160)()
            assert self.lib.sxt_curve25519_get_one_commit(out, ctypes.c_uint64(n)) == 0
            want = R.naive_msm([1] * n, R.get_generators(n))
            assert ristretto_points_of(bytes(out), 1) == [affine(want)], n

    # -- the Weierstrass commitments ------------------------------------------

    def weierstrass(self, name):
        curve, _, k, rbits = CURVES[name]
        pts = curve.random_points(6, seed=3)
        if name != "bls12_381_g1":
            pts[2] = None  # an infinity flag: the identity
        columns = [(4, False, [5, 0, 7, 2**32 - 1, 9, 1]), (1, True, [-128, 127, -1, 3]), (8, False, [0, 0])]
        gens = buf(affine_structs(name, pts))
        want = [curve.msm([signed_value(v, nb, s) for v in vals], pts[: len(vals)])
                for nb, s, vals in columns]
        if name == "bls12_381_g1":
            out = (ctypes.c_uint8 * (48 * 3))()
            self.lib.sxt_bls12_381_g1_compute_pedersen_commitments_with_generators(out, 3, descriptors(columns), gens)
            assert [bytes(out[48 * i : 48 * i + 48]) for i in range(3)] == [RW.compress_bls12_381(w) for w in want]
            return
        out = (ctypes.c_uint8 * (72 * 3))()
        entry = getattr(self.lib, f"sxt_{name}_uncompressed_compute_pedersen_commitments_with_generators")
        entry(out, 3, descriptors(columns), gens)
        raw = bytes(out)
        for i, w in enumerate(want):
            row = raw[72 * i : 72 * i + 72]
            if w is None:
                assert row == bytes(64) + b"\x01" + bytes(7), i
                continue
            xy = [c * (1 << rbits) % curve.p for c in w]
            assert row == mont_words(xy[0], k) + mont_words(xy[1], k) + bytes(8), i

    def bls12_381_g1(self):
        self.weierstrass("bls12_381_g1")

    def bn254_g1(self):
        self.weierstrass("bn254_g1")

    def grumpkin(self):
        self.weierstrass("grumpkin")

    # -- handles -------------------------------------------------------------

    def query(self, handle, values, nbytes, result_nbytes):
        """values: num_outputs lists of n ints -> the result structs' bytes."""
        num_outputs, n = len(values), len(values[0])
        col = b"".join(int(values[o][i]).to_bytes(nbytes, "little") for i in range(n) for o in range(num_outputs))
        res = (ctypes.c_uint8 * (result_nbytes * num_outputs))()
        self.lib.sxt_fixed_multiexponentiation(res, ctypes.c_void_p(handle), ctypes.c_uint(nbytes),
                                               ctypes.c_uint(num_outputs), ctypes.c_uint(n), buf(col))
        return bytes(res)

    def new_handle(self, curve_id, structs, n):
        handle = self.lib.sxt_multiexp_handle_new(ctypes.c_uint(curve_id), buf(structs), ctypes.c_uint(n))
        assert handle, "a handle id"
        return handle

    def handle_ristretto255(self):
        gens = R.get_generators(9)
        handle = self.new_handle(0, self.generators(9), 9)
        values = [[3, 5, 7, 9, 0, 1, 2**24 - 1, 8, 6], [11, 13, 17, 19, 23, 29, 31, 37, 41]]
        got = ristretto_points_of(self.query(handle, values, 3, 160), 2)
        assert got == [affine(R.naive_msm(v, gens)) for v in values]
        short = [[1, 2, 3, 4]]  # fewer scalars than generators
        assert ristretto_points_of(self.query(handle, short, 1, 160), 1) == [affine(R.naive_msm(short[0], gens))]
        self.lib.sxt_multiexp_handle_free(ctypes.c_void_p(handle))
        from blitzar_tpu_torch import capi_bridge

        assert handle not in capi_bridge.HANDLES, "free drops the handle"

    def handle_weierstrass(self):
        for name, (curve, curve_id, k, _) in CURVES.items():
            pts = curve.random_points(5, seed=11)
            pts[1] = None
            handle = self.new_handle(curve_id, p2_structs(name, pts), 5)
            values = [[1, 2, 3, 4, 5], [255, 0, 17, 200, 9]]
            got = p2_points_of(name, self.query(handle, values, 1, 24 * k), 2)
            assert got == [curve.msm(v, pts) for v in values], name
            self.lib.sxt_multiexp_handle_free(ctypes.c_void_p(handle))

    def packed(self, handle, bit_table, n, packed, lengths=None):
        bits = (ctypes.c_uint32 * len(bit_table))(*bit_table)
        res_nbytes = 160 if handle[1] is None else 24 * CURVES[handle[1]][2]
        res = (ctypes.c_uint8 * (res_nbytes * len(bit_table)))()
        if lengths is None:
            self.lib.sxt_fixed_packed_multiexponentiation(res, ctypes.c_void_p(handle[0]), bits,
                                                          ctypes.c_uint(len(bit_table)), ctypes.c_uint(n), buf(packed))
        else:
            lens = (ctypes.c_uint32 * len(lengths))(*lengths)
            self.lib.sxt_fixed_vlen_multiexponentiation(res, ctypes.c_void_p(handle[0]), bits, lens,
                                                        ctypes.c_uint(len(bit_table)), buf(packed))
        return bytes(res)

    def packed_vlen(self):
        n, bit_table, lengths = 9, [1, 8, 3, 0, 12], [2, 4, 6, 9, 9]
        packed = np.random.default_rng(5).integers(0, 256, size=(n, 3), dtype=np.uint8)
        bits = np.unpackbits(packed, axis=1, bitorder="little")

        def own(lens):
            out, start = [], 0
            for o, nb in enumerate(bit_table):
                vals = [int("".join(str(b) for b in bits[i, start : start + nb][::-1]) or "0", 2) for i in range(n)]
                if lens is not None:
                    vals = [v if i < lens[o] else 0 for i, v in enumerate(vals)]
                out.append(vals)
                start += nb
            return out

        ed_handle = (self.new_handle(0, self.generators(n), n), None)
        gens = R.get_generators(n)
        pts = RW.BN254_G1.random_points(n, seed=13)
        bn_handle = (self.new_handle(2, p2_structs("bn254_g1", pts), n), "bn254_g1")
        for lens in (None, lengths):
            got = ristretto_points_of(self.packed(ed_handle, bit_table, n, packed.tobytes(), lens), len(bit_table))
            assert got == [affine(R.naive_msm(v, gens)) for v in own(lens)], lens
            got = p2_points_of("bn254_g1", self.packed(bn_handle, bit_table, n, packed.tobytes(), lens),
                               len(bit_table))
            assert got == [RW.BN254_G1.msm(v, pts) for v in own(lens)], lens

    def files(self):
        from blitzar_tpu_torch import capi_bridge
        from blitzar_tpu_torch.msm import interop

        n = 10
        values = [[7, 1, 0, 3, 5, 200, 9, 4, 2, 6]]
        handle = self.new_handle(0, self.generators(n), n)
        want = self.query(handle, values, 1, 160)
        npz = os.path.join(self.work, "ristretto.npz")
        self.lib.sxt_multiexp_handle_write_to_file(ctypes.c_void_p(handle), npz.encode())
        back = self.lib.sxt_multiexp_handle_new_from_file(ctypes.c_uint(0), npz.encode())
        assert ristretto_points_of(self.query(back, values, 1, 160), 1) == ristretto_points_of(want, 1)
        # the reference's raw format, sniffed
        raw = os.path.join(self.work, "ristretto.raw")
        interop.write_reference_file(capi_bridge.HANDLES[handle], raw)
        again = self.lib.sxt_multiexp_handle_new_from_file(ctypes.c_uint(0), raw.encode())
        assert ristretto_points_of(self.query(again, values, 1, 160), 1) == ristretto_points_of(want, 1)
        pts = RW.GRUMPKIN.random_points(n, seed=17)
        w_handle = self.new_handle(3, p2_structs("grumpkin", pts), n)
        path = os.path.join(self.work, "grumpkin.npz")
        self.lib.sxt_multiexp_handle_write_to_file(ctypes.c_void_p(w_handle), path.encode())
        w_back = self.lib.sxt_multiexp_handle_new_from_file(ctypes.c_uint(3), path.encode())
        assert p2_points_of("grumpkin", self.query(w_back, values, 1, 96), 1) == [RW.GRUMPKIN.msm(values[0], pts)]
        for h in (handle, back, again, w_handle, w_back):
            self.lib.sxt_multiexp_handle_free(ctypes.c_void_p(h))

    # -- proofs --------------------------------------------------------------

    def ipa(self):
        n = 7  # the frozen vector's: three rounds, a and b padded to 8
        a, b = vec.ipa_inputs(n)
        rounds = 3
        g, q = R.get_generators(8), R.get_generators(1, 8)[0]
        jt = JTranscript(vec.IPA_LABEL)
        jl, jr, jap = RIPA.prove_inner_product(jt, a, b, g, q)
        rows = lambda vals: buf(b"".join(int(v).to_bytes(32, "little") for v in vals))  # noqa: E731
        lv, rv = (ctypes.c_uint8 * (32 * rounds))(), (ctypes.c_uint8 * (32 * rounds))()
        ap = (ctypes.c_uint8 * 32)()
        tr = (ctypes.c_uint8 * 203).from_buffer_copy(JTranscript(vec.IPA_LABEL).to_bytes203())
        self.lib.sxt_curve25519_prove_inner_product(lv, rv, ap, tr, ctypes.c_uint64(n), ctypes.c_uint64(0),
                                                    rows(a), rows(b))
        got_l = [bytes(lv[32 * i : 32 * i + 32]) for i in range(rounds)]
        got_r = [bytes(rv[32 * i : 32 * i + 32]) for i in range(rounds)]
        assert got_l == jl and got_r == jr and int.from_bytes(bytes(ap), "little") == jap
        assert [x.hex() for x in got_l] == vec.IPA[n]["L"] and jap == vec.IPA[n]["ap"]
        assert bytes(tr) == jt.to_bytes203(), "the transcript after prove"
        product = sum(x * y for x, y in zip(a, b)) % ORDER
        a_commit = R.naive_msm(a, g)
        for tampered in (False, True):
            apv = (jap + tampered) % ORDER
            jt2 = JTranscript(vec.IPA_LABEL)
            want = RIPA.verify_inner_product(jt2, b, product, a_commit, jl, jr, apv, g, q)
            tr2 = (ctypes.c_uint8 * 203).from_buffer_copy(JTranscript(vec.IPA_LABEL).to_bytes203())
            ok = self.lib.sxt_curve25519_verify_inner_product(
                tr2, ctypes.c_uint64(n), ctypes.c_uint64(0), rows(b), rows([product]),
                buf(ristretto_structs([a_commit])), lv, rv, rows([apv]))
            assert ok == (0 if tampered else 1) and want == (not tampered), tampered
            assert bytes(tr2) == jt2.to_bytes203(), "the transcript after verify"

    def sumcheck(self, field):
        modulus = ORDER if field == "scalar25519" else GRUMPKIN_FIELD
        field_id = 0 if field == "scalar25519" else 1
        r = 1 << 256
        rinv = pow(r, -1, modulus)

        def elem(v: int) -> bytes:  # the ABI's element bytes
            return (v % modulus if field_id == 0 else v % modulus * r % modulus).to_bytes(32, "little")

        for case, (n, ptable, pterms) in vec.SUMCHECK_CASES.items():
            frozen = vec.SUMCHECK[(field, case)]
            degree = max(k for _, k in ptable)
            round_degree = degree + (case == "n37_deg5")  # a padded case too
            rounds = len(frozen["polynomials"])
            mles = vec.sumcheck_inputs(n)
            # the reference transcript, driven through the callback
            jt = JTranscript(vec.SUMCHECK_LABEL)
            jt.append_message(b"domain-sep", b"sumcheck proof v1")
            jt.append_u64(b"n", rounds)
            jt.append_u64(b"k", degree)
            seen = []

            def callback(r_ptr, context, poly_ptr, poly_len):
                data = ctypes.string_at(poly_ptr, 32 * poly_len)
                seen.append(data)
                jt.append_message(b"P", data)
                raw = int.from_bytes(jt.challenge_bytes(b"R", 32), "little")
                # scalar25519: the value mod l; Grumpkin: its twist R^-2,
                # sent as Montgomery bytes (value R)
                value = raw % modulus if field_id == 0 else raw * rinv * rinv % modulus
                ctypes.memmove(r_ptr, elem(value), 32)

            cb = CALLBACK(callback)
            table = b"".join(elem(m) + int(k).to_bytes(4, "little") + bytes(4) for m, k in ptable)
            terms = (ctypes.c_uint32 * len(pterms))(*pterms)
            desc = SumcheckDescriptor(ctypes.cast(buf(mles.tobytes()), ctypes.c_void_p),
                                      ctypes.cast(buf(table), ctypes.c_void_p), terms, n, 3, len(ptable),
                                      len(pterms), round_degree)
            polys = (ctypes.c_uint8 * (32 * (round_degree + 1) * rounds))()
            point = (ctypes.c_uint8 * (32 * rounds))()
            self.lib.sxt_prove_sumcheck(polys, point, ctypes.c_uint(field_id), ctypes.byref(desc),
                                        ctypes.cast(cb, ctypes.c_void_p), None)
            raw = bytes(polys)
            step = 32 * (round_degree + 1)
            for i, want in enumerate(frozen["polynomials"]):
                coeffs = [raw[i * step + 32 * j : i * step + 32 * j + 32] for j in range(round_degree + 1)]
                assert coeffs == [elem(c) for c in want] + [bytes(32)] * (round_degree + 1 - len(want)), (case, i)
                assert seen[i] == b"".join(elem(c) for c in want), (case, i)
            assert bytes(point) == b"".join(elem(c) for c in frozen["evaluation_point"]), case

    def sumcheck_scalar25519(self):
        self.sumcheck("scalar25519")

    def sumcheck_grumpkin(self):
        self.sumcheck("grumpkin")


def main() -> int:
    torch.set_num_threads(1)
    driver = Driver(sys.argv[1], sys.argv[2])
    for section in SECTIONS:
        driver.run(section)
    print("CAPI_OK" if not driver.failed else f"CAPI_FAILED {driver.failed}", flush=True)
    return 1 if driver.failed else 0


if __name__ == "__main__":
    sys.exit(main())
