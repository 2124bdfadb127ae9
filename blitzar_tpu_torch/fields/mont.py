"""Montgomery-form prime-field arithmetic in plain PyTorch (bn254 Fp and Fr,
bls12-381 Fp, the curve25519 scalar field).

Representation (the public layout of ``blitzar_tpu.fields.mont``): a batch
of elements is one int32 tensor of shape ``(nlimbs, *batch)``: radix-2^16
little-endian limbs, limb axis leading, canonical in [0, m), in Montgomery
form with R = 2^(16 * nlimbs) (2^256 for the two 254-bit fields, 2^384 for
bls12-381). A ``blitzar_tpu`` array crosses over by a dtype change.

Every op widens to int64 and works there (torch has no uint32 arithmetic on
the CPU): a product is the schoolbook sum of 16-bit limb products followed
by Montgomery's reduction on whole numbers; carries settle by parallel
passes and a look-ahead (:func:`_settle`), and each op's final conditional
subtraction is settled beside it in the same pass. Every output is canonical, so any correct method gives the same
limbs: this is the plain version behind the CUDA kernels of
``ops/cuda_wpoint.py`` and ``ops/cuda_mont.py``, whose own arithmetic
(``csrc/mont.cuh``) works in 8 or 12 32-bit words with the same R.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import batch_invert

MASK = 0xFFFF


@functools.lru_cache(maxsize=None)
def _columns(n: int, device, low: bool = False) -> torch.Tensor:
    """Column i + j of limb product (i, j), flattened row-major; with
    ``low``, every column >= n goes to column n (a product mod R keeps
    columns 0..n-1)."""
    idx = torch.arange(n, device=device)
    cols = (idx[:, None] + idx[None, :]).reshape(-1)
    return torch.clamp(cols, max=n) if low else cols


@functools.lru_cache(maxsize=None)
def _limb_column(limbs: tuple, ndim: int, device) -> torch.Tensor:
    """Constant limbs as an int64 (k, 1, ..) column, made once per device."""
    return torch.tensor(limbs, dtype=torch.int64, device=device).reshape((len(limbs),) + (1,) * ndim)


def _settle(x: torch.Tensor, passes: int):
    """(k, *batch) non-negative int64 limbs -> (exact 16-bit limbs, carry
    out of the top), same value.

    ``passes`` parallel passes (each limb keeps its low 16 bits and gains the
    high part of the limb below; each pass takes 16 bits off the size of the
    carries) must leave every limb below 2^16 + 2^15: one pass for limbs
    below 2^31, two below 2^47, three below 2^63. Then a limb at or above
    2^16 has low bits below 0xFFFF, and what is left is a 0/1 carry per limb,
    found by look-ahead instead of limb by limb: a limb passes an incoming
    carry on only if it is 0xFFFF, so the carry out of limb i is that of the
    last limb j <= i that is not 0xFFFF, which is 1 iff limb j >= 2^16."""
    top = torch.zeros_like(x[0])
    for _ in range(passes):
        carry = x >> 16
        x = x & MASK
        x[1:] += carry[:-1]
        top = top + carry[-1]
    k = x.shape[0]
    idx = torch.arange(k, device=x.device).reshape((k,) + (1,) * (x.dim() - 1))
    last = torch.cummax(torch.where(x != MASK, idx, -1), dim=0).values
    carry_out = torch.gather(x >> 16, 0, last.clamp(min=0)) * (last >= 0)
    out = x & MASK
    out[1:] += carry_out[:-1]
    return out & MASK, top + carry_out[-1]


class MontField:
    def __init__(self, name: str, modulus: int, nlimbs: int):
        if modulus % 2 == 0 or modulus >= 1 << (16 * nlimbs) or nlimbs % 2:
            raise ValueError(f"{name}: need an odd modulus below 2^(16 * nlimbs) and an even limb count")
        self.name = name
        self.modulus = modulus
        self.nlimbs = nlimbs
        self.nbytes = 2 * nlimbs
        self.radix_bits = 16 * nlimbs
        self.r = (1 << self.radix_bits) % modulus
        self.r2 = self.r * self.r % modulus
        self.r3 = self.r2 * self.r % modulus
        self.r_inv = pow(self.r, -1, modulus)
        self.n_prime = (-pow(modulus, -1, 1 << self.radix_bits)) % (1 << self.radix_bits)

    def __repr__(self):
        return f"MontField({self.name})"

    # -- host conversions ----------------------------------------------------

    def int_limbs(self, value: int) -> list[int]:
        """Radix-2^16 limbs of a non-negative int below R (no reduction)."""
        return [(value >> (16 * i)) & MASK for i in range(self.nlimbs)]

    def from_ints(self, values, device="cuda") -> torch.Tensor:
        """Python ints (reduced mod m) -> Montgomery-form (nlimbs, n) int32
        on ``device`` (the card unless the caller asks for the CPU)."""
        m = self.modulus
        rows = [self.int_limbs(int(v) % m * self.r % m) for v in values]
        arr = np.array(rows, dtype=np.int32).reshape(len(rows), self.nlimbs)
        return torch.from_numpy(np.ascontiguousarray(arr.T)).to(device)

    def to_ints(self, a: torch.Tensor) -> list[int]:
        """Montgomery-form (nlimbs, *batch) -> standard-form Python ints, the
        batch flattened."""
        arr = a.reshape(self.nlimbs, -1).cpu().numpy().astype("<u2")
        return [
            int.from_bytes(arr[:, j].tobytes(), "little") * self.r_inv % self.modulus
            for j in range(arr.shape[1])
        ]

    # -- constants -----------------------------------------------------------

    def _raw(self, value: int, ndim: int, device) -> torch.Tensor:
        """The limbs of ``value`` itself as an int64 (nlimbs, 1, ..) column."""
        return _limb_column(tuple(self.int_limbs(value)), ndim, torch.device(device))

    def _raw_wide(self, value: int, ndim: int, device) -> torch.Tensor:
        """As :meth:`_raw`, 2 nlimbs + 1 limbs (a value below R^2 2)."""
        limbs = tuple((value >> (16 * i)) & MASK for i in range(2 * self.nlimbs + 1))
        return _limb_column(limbs, ndim, torch.device(device))

    def const(self, value: int, batch_shape=(), device="cpu") -> torch.Tensor:
        """The field constant ``value`` in Montgomery form, broadcast to a
        (nlimbs, *batch) int32 tensor."""
        mont = value % self.modulus * self.r % self.modulus
        col = self._raw(mont, len(batch_shape), device).to(torch.int32)
        return col.expand((self.nlimbs,) + tuple(batch_shape)).contiguous()

    def zeros(self, batch_shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros((self.nlimbs,) + tuple(batch_shape), dtype=torch.int32, device=device)

    def one(self, batch_shape=(), device="cpu") -> torch.Tensor:
        return self.const(1, batch_shape, device)

    # -- carries -------------------------------------------------------------

    def _complement(self, ndim: int, device) -> torch.Tensor:
        """The limbs of R - m: x + (R - m) reaches R exactly when x >= m."""
        return self._raw((1 << self.radix_bits) - self.modulus, ndim, device)

    def _mont_reduce(self, acc: torch.Tensor) -> torch.Tensor:
        """(2 nlimbs, *batch) int64 column sums (each < 2^37) of a value
        T < m R -> T R^-1 mod m, canonical int32.

        Montgomery's REDC on whole numbers: U = T (-m^-1) mod R comes from
        T's low columns unsettled (their value is T mod R, up to multiples of
        R); then T + U m is divisible by R and v = (T + U m) / R < 2m. v is
        settled together with v + R - m, which reaches R exactly when
        v >= m. Every column stays far below 2^63: the products for U below
        2^58, T + U m below 2^38."""
        n = self.nlimbs
        batch = tuple(acc.shape[1:])
        ndim = len(batch)
        products = acc[:n].unsqueeze(1) * self._raw(self.n_prime, ndim, acc.device).unsqueeze(0)
        u = torch.zeros((n + 1,) + batch, dtype=torch.int64, device=acc.device)
        u.index_add_(0, _columns(n, acc.device, low=True), products.reshape((n * n,) + batch))
        u, _ = _settle(u[:n], passes=3)  # U mod R, exact
        full = torch.cat([acc, torch.zeros_like(acc[:1])])
        mod = self._raw(self.modulus, ndim, acc.device)
        full.index_add_(0, _columns(n, acc.device), (u.unsqueeze(1) * mod.unsqueeze(0)).reshape((n * n,) + batch))
        comp = self._raw_wide(((1 << self.radix_bits) - self.modulus) << self.radix_bits, ndim, acc.device)  # (R - m) R
        limbs, _ = _settle(torch.stack([full, full + comp], dim=1), passes=2)  # (2n + 1, 2, *batch)
        return torch.where(limbs[2 * n, 1] > 0, limbs[n : 2 * n, 1], limbs[n : 2 * n, 0]).to(torch.int32)

    # -- ring ops ------------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + b, settled together with a + b + R - m (which reaches R
        exactly when a + b >= m)."""
        s = a.to(torch.int64) + b.to(torch.int64)
        limbs, top = _settle(torch.stack([s, s + self._complement(s.dim() - 1, s.device)], dim=1), passes=1)
        return torch.where(top[1] > 0, limbs[:, 1], limbs[:, 0]).to(torch.int32)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b as a + (R - b), which reaches R exactly when a >= b, settled
        together with a + (R - b) + m (the result when a < b)."""
        d = a.to(torch.int64) + (MASK - b.to(torch.int64))
        d[0] += 1
        limbs, top = _settle(torch.stack([d, d + self._raw(self.modulus, d.dim() - 1, d.device)], dim=1), passes=1)
        return torch.where(top[0] > 0, limbs[:, 0], limbs[:, 1]).to(torch.int32)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a * b * R^-1 mod m. The schoolbook columns
        (the limb products a_i b_j summed into column i + j) hold at most 24
        products below 2^32 each: < 2^37."""
        n = self.nlimbs
        products = a.to(torch.int64).unsqueeze(1) * b.to(torch.int64).unsqueeze(0)  # (n, n, *batch)
        acc = torch.zeros((2 * n,) + tuple(products.shape[2:]), dtype=torch.int64, device=a.device)
        acc.index_add_(0, _columns(n, a.device), products.reshape((n * n,) + tuple(products.shape[2:])))
        return self._mont_reduce(acc)

    def sq(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def mul_const(self, a: torch.Tensor, value: int) -> torch.Tensor:
        """a times the field constant ``value`` (a plain integer)."""
        return self.mul(a, self.const(value, (1,) * (a.dim() - 1), a.device))

    def pow_const(self, a: torch.Tensor, exponent: int) -> torch.Tensor:
        """a^exponent by square-and-multiply over the exponent's bits."""
        acc = self.one(a.shape[1:], a.device)
        for bit in bin(exponent)[2:]:
            acc = self.sq(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^(m-2); 0 maps to 0."""
        return self.pow_const(a, self.modulus - 2)

    def batch_invert_lanes(self, z: torch.Tensor) -> torch.Tensor:
        """1/z for an (nlimbs, *rows, V) batch, 0 -> 0, by Montgomery's trick
        along the last axis (``fields/batch_invert.py``): the form of
        blitzar_tpu/msm/interop.py:59-78, whose zeros are a Weierstrass
        table's identity entries. Zeros stand as one in the scans and are
        masked after; each row's total is inverted by :meth:`inv`. The
        plain version of ``ops/cuda_wpoint.py``'s ``w_affine``, whose kernel
        does all of it in one launch."""
        nonzero = ~self.is_zero(z)
        z_safe = torch.where(nonzero.unsqueeze(0), z, self.one((1,) * (z.dim() - 1), z.device))
        inv = batch_invert.batch_invert_lanes(z_safe, self.mul, self.inv)
        return torch.where(nonzero.unsqueeze(0), inv, 0)

    # -- predicates and selection --------------------------------------------

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    def cmov(self, a: torch.Tensor, b: torch.Tensor, cond) -> torch.Tensor:
        """b where cond, else a (cond broadcast over the limb axis)."""
        return torch.where(cond.unsqueeze(0).to(torch.bool), b, a)

    # -- form and byte conversions -------------------------------------------

    def to_mont(self, a_std: torch.Tensor) -> torch.Tensor:
        """Standard-form canonical limbs -> Montgomery form (times R^2 / R)."""
        return self.mul(a_std, self._raw(self.r2, a_std.dim() - 1, a_std.device).to(torch.int32))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> standard-form canonical limbs (times 1 / R)."""
        return self.mul(a, self._raw(1, a.dim() - 1, a.device).to(torch.int32))

    def from_bytes_le(self, b: torch.Tensor) -> torch.Tensor:
        """(nbytes_in, *batch) uint8 little-endian -> Montgomery form. The
        first 2 * nlimbs bytes count; any value below R is fully reduced
        (reduce first: std / R, then times R^3 / R = std * R)."""
        b = b.to(torch.int64)
        batch = tuple(b.shape[1:])
        if b.shape[0] < self.nbytes:
            b = torch.cat([b, torch.zeros((self.nbytes - b.shape[0],) + batch, dtype=torch.int64, device=b.device)])
        pairs = b[: self.nbytes].reshape((self.nlimbs, 2) + batch)
        std = pairs[:, 0] | (pairs[:, 1] << 8)
        reduced = self._mont_reduce(torch.cat([std, torch.zeros_like(std)]))
        return self.mul(reduced, self._raw(self.r3, len(batch), b.device).to(torch.int32))

    def to_bytes_le(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> (nbytes, *batch) uint8 canonical little-endian
        bytes of the standard-form value."""
        std = self.from_mont(a)
        pairs = torch.stack([std & 0xFF, std >> 8], dim=1)
        return pairs.reshape((self.nbytes,) + tuple(a.shape[1:])).to(torch.uint8)

    # -- reductions ------------------------------------------------------------

    def lane_sum(self, a: torch.Tensor) -> torch.Tensor:
        """(nlimbs, *rest, L) -> (nlimbs, *rest): the sums over the last
        axis, canonical. The limb columns are summed exactly in int64 (each
        below 2^16 L) on ``a``'s device and reduced mod m on the host in
        Python integers (a Montgomery sum reduces like a plain one)."""
        rest = tuple(a.shape[1:-1])
        cols = a.to(torch.int64).sum(dim=-1).reshape(self.nlimbs, -1).cpu().numpy()
        values = [sum(int(v) << (16 * i) for i, v in enumerate(cols[:, j])) % self.modulus for j in range(cols.shape[1])]
        out = np.array([self.int_limbs(v) for v in values], dtype=np.int32).reshape((len(values), self.nlimbs))
        return torch.from_numpy(np.ascontiguousarray(out.T)).reshape((self.nlimbs,) + rest).to(a.device)


def rows_to_limbs(rows, nlimbs: int, device="cpu") -> torch.Tensor:
    """(n, nbytes <= 2 nlimbs) uint8 little-endian rows -> (nlimbs, n) int32
    radix-2^16 limbs of the values as they are (no reduction); missing high
    bytes are zero."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    rows = np.asarray(rows, np.uint8)
    padded = np.zeros((rows.shape[0], 2 * nlimbs), np.uint8)
    padded[:, : rows.shape[1]] = rows
    limbs = padded.view("<u2").astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(limbs.T)).to(device)


def limbs_to_rows(limbs: torch.Tensor) -> torch.Tensor:
    """(nlimbs, n) radix-2^16 limbs -> (n, 2 nlimbs) uint8 little-endian
    rows, on the limbs' device."""
    pairs = torch.stack([limbs & 0xFF, (limbs >> 8) & 0xFF], dim=-1)  # (nlimbs, n, 2)
    return pairs.permute(1, 0, 2).reshape(limbs.shape[1], -1).to(torch.uint8)
