"""Merlin-compatible transcript: STROBE-128 duplex over keccak-f[1600].

The port's own copy of blitzar_tpu/proof/transcript.py (the port imports
nothing of blitzar_tpu). Host-side, pure Python: transcripts are tiny and
inherently sequential (Fiat-Shamir). Byte-compatible with the reference
sxt/proof/transcript/{strobe128,transcript}.cc (which is itself
byte-compatible with the Rust `merlin` crate), with the reference's 203-byte
ABI state (``to_bytes203`` / ``from_bytes203``).
"""

from __future__ import annotations

import struct

# --- keccak-f[1600] (public standard algorithm) ----------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rotl(x: int, s: int) -> int:
    return ((x << s) | (x >> (64 - s))) & _M64


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state (little-endian lanes)."""
    lanes = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            (lanes[x][y],) = struct.unpack_from("<Q", state, 8 * (x + 5 * y))
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
        # iota
        lanes[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            struct.pack_into("<Q", state, 8 * (x + 5 * y), lanes[x][y])


# --- STROBE-128 -------------------------------------------------------------

_STROBE_R = 166
_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    """Mirrors reference strobe128.cc (merlin's STROBE-128 instance)."""

    def __init__(self, label: bytes):
        self.state = bytearray(200)
        init = bytes([1, 168, 1, 0, 1, 96]) + b"STROBEv1.0.2"
        self.state[: len(init)] = init
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(label, False)

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "changing flags while continuing is illegal"
            return
        assert not (flags & _FLAG_T), "T flag is not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (_FLAG_C | _FLAG_K)) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    # -- 203-byte ABI state (reference sxt_transcript, blitzar_api.h:61-63:
    # 200-byte keccak state + pos + pos_begin + cur_flags) -------------------

    def to_bytes203(self) -> bytes:
        return bytes(self.state) + bytes([self.pos, self.pos_begin, self.cur_flags])

    @classmethod
    def from_bytes203(cls, data: bytes) -> "Strobe128":
        assert len(data) == 203
        obj = cls.__new__(cls)
        obj.state = bytearray(data[:200])
        obj.pos = data[200]
        obj.pos_begin = data[201]
        obj.cur_flags = data[202]
        return obj


class Transcript:
    """Merlin transcript (reference transcript.cc / merlin crate)."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def to_bytes203(self) -> bytes:
        return self.strobe.to_bytes203()

    @classmethod
    def from_bytes203(cls, data: bytes) -> "Transcript":
        obj = cls.__new__(cls)
        obj.strobe = Strobe128.from_bytes203(data)
        return obj

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)

    # typed helpers (reference transcript_utility.h)
    def append_u64(self, label: bytes, value: int):
        self.append_message(label, struct.pack("<Q", value))

    def challenge_scalar(self, label: bytes, order: int) -> int:
        """256-bit challenge reduced mod `order` (reference challenge_value +
        s25o::reduce32)."""
        raw = self.challenge_bytes(label, 32)
        return int.from_bytes(raw, "little") % order
