"""The CUDA kernels of the commitment path: wrappers, plain versions, counts.

Each wrapper takes tensors in the public layout (field batches (16, *batch)
int32, point batches ``PointP3`` of four of them, limb axis leading). On a
tensor that lies on the CPU it runs the plain PyTorch version beside it; on
a CUDA tensor it checks device, dtype, shape and layout, allocates the
outputs, launches its kernel from ``csrc/`` on the current stream and adds
one to ``LAUNCHES[name]``, or raises. The plain versions serve the CPU tests
and the comparisons of ``chip_smoke.py``; nothing on the card's main path
calls them.

Kernel outputs hold canonical 16-bit limbs. Inputs may hold any limbs below
2^17, the invariant of ``fields/fp25519.py``.

The kernels and the TPU kernels they replace (all in
``blitzar_tpu/ops/pallas_point.py``):

=====================  ======================================  ==========
wrapper                replaces                                 source
=====================  ======================================  ==========
``build_niels_table``  ``_build_split_tiled`` :806 (niels)      build_niels_table.cu
``ed_lookup_msm``      ``_lookup_tiled`` :533                   ed_lookup_msm.cu
``doubling_combine``   ``_combine_tiled`` :982                  doubling_combine.cu
``ed_add``             ``_add_tiled`` :237                      ed_add.cu
``elligator_form``     ``_elligator_form_tiled`` :212           elligator_form.cu
=====================  ======================================  ==========
"""

from __future__ import annotations

import torch

from ..curves import edwards25519 as ed
from ..curves import ristretto as rst
from ..fields import fp25519 as F
from . import build

KERNELS = (
    "build_niels_table",
    "ed_lookup_msm",
    "doubling_combine",
    "ed_add",
    "elligator_form",
)

# launches of each kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)

# threads the lookup aims for: rows x group chunks (about 2048 per SM)
LOOKUP_THREADS = 1 << 18


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _limb_major(t: torch.Tensor) -> bool:
    """(16, *batch) with the batch contiguous inside each limb row."""
    if t.dim() < 2 or t.shape[0] != F.NLIMBS or t.dtype != torch.int32:
        return False
    expected = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _field_arg(t: torch.Tensor, device, batch) -> tuple[torch.Tensor, int]:
    """Check one (16, *batch) int32 field tensor for a launch; returns the
    tensor (made limb-major if it was not) and its limb stride."""
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 limbs, got {t.dtype}")
    if tuple(t.shape) != (F.NLIMBS,) + tuple(batch):
        raise ValueError(f"expected shape {(F.NLIMBS,) + tuple(batch)}, got {tuple(t.shape)}")
    if not _limb_major(t):
        t = t.contiguous()
    return t, t.stride(0)


def _point_arg(p: ed.PointP3, device, batch) -> tuple[list[torch.Tensor], int]:
    coords = [_field_arg(c, device, batch)[0] for c in p]
    if len({c.stride(0) for c in coords}) != 1:
        coords = [c.contiguous() for c in coords]
    return coords, coords[0].stride(0)


def _empty_point(batch, device) -> ed.PointP3:
    return ed.PointP3(
        *(torch.empty((F.NLIMBS,) + tuple(batch), dtype=torch.int32, device=device) for _ in range(4))
    )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def _ptrs(coords) -> list[int]:
    return [c.data_ptr() for c in coords]


# ---------------------------------------------------------------------------
# niels table layout: (G, 2^w, 3, 8) int32 words, entry = a | b | 2d*t
# ---------------------------------------------------------------------------


def limbs_to_words(c: torch.Tensor) -> torch.Tensor:
    """Canonical (16, *batch) limbs -> (*batch, 8) int32 holding the 32-bit
    words' bit patterns."""
    c = c.to(torch.int64)
    w = c[0::2] | (c[1::2] << 16)
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    return w.movedim(0, -1)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(*batch, 8) int32 words -> (16, *batch) int32 limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(tuple(w.shape[:-1]) + (F.NLIMBS,))
    return limbs.movedim(-1, 0).to(torch.int32)


def pack_niels(n: ed.Niels) -> torch.Tensor:
    """Niels (16, *batch) -> (*batch, 3, 8) int32 table entries."""
    return torch.stack([limbs_to_words(F.canonicalize(c)) for c in n], dim=-2)


def unpack_niels(entries: torch.Tensor) -> ed.Niels:
    """(*batch, 3, 8) table entries -> Niels (16, *batch)."""
    return ed.Niels(*(words_to_limbs(entries[..., k, :]) for k in range(3)))


# ---------------------------------------------------------------------------
# ed_add  (replaces pallas_point.py:_add_tiled :237 / add :291)
# ---------------------------------------------------------------------------


def ed_add_plain(p: ed.PointP3, q: ed.PointP3) -> ed.PointP3:
    return ed._add_impl(p, q)


def ed_add(p: ed.PointP3, q: ed.PointP3) -> ed.PointP3:
    """Elementwise p + q (unified add-2008-hwcd-3) over equal batch shapes.

    Kernel csrc/ed_add.cu, one thread per element. Bound: bytes (three
    points of 256 bytes per element against 9 field multiplies)."""
    if not _on_card(p.x):
        return ed_add_plain(p, q)
    batch = tuple(p.x.shape[1:])
    pc, ps = _point_arg(p, p.x.device, batch)
    qc, qs = _point_arg(q, p.x.device, batch)
    out = _empty_point(batch, p.x.device)
    count = p.x[0].numel()
    _launch(
        "ed_add", build.library().btt_ed_add,
        *_ptrs(pc), ps, *_ptrs(qc), qs, count, *_ptrs(out), _stream(p.x.device),
    )
    return out


# ---------------------------------------------------------------------------
# elligator_form  (replaces pallas_point.py:_elligator_form_tiled :212)
# ---------------------------------------------------------------------------


def elligator_form_plain(r0: torch.Tensor, r1: torch.Tensor) -> ed.PointP3:
    return ed._add_impl(rst.elligator(r1), rst.elligator(r0))


def elligator_form(r0: torch.Tensor, r1: torch.Tensor) -> ed.PointP3:
    """Canonical generators: elligator(r1) + elligator(r0) per index, for
    (16, n) field batches.

    Kernel csrc/elligator_form.cu, one thread per generator. Bound: integer
    multiplies, two ~265-multiply pow22523 chains per generator."""
    if not _on_card(r0):
        return elligator_form_plain(r0, r1)
    batch = tuple(r0.shape[1:])
    r0, s0 = _field_arg(r0, r0.device, batch)
    r1, s1 = _field_arg(r1, r0.device, batch)
    out = _empty_point(batch, r0.device)
    _launch(
        "elligator_form", build.library().btt_elligator_form,
        r0.data_ptr(), s0, r1.data_ptr(), s1, r0[0].numel(), *_ptrs(out), _stream(r0.device),
    )
    return out


# ---------------------------------------------------------------------------
# build_niels_table  (replaces pallas_point.py:_build_split_tiled :806)
# ---------------------------------------------------------------------------


def build_niels_table_plain(points: ed.PointP3, w: int) -> torch.Tensor:
    """Subset sums by w doubling concatenations (table_{j+1} = [table_j |
    table_j + G_j]), then affine niels with one inversion per entry."""
    n_pad = points.x.shape[1]
    groups = n_pad // w
    pts = ed.reshape_batch(points, (groups, w))
    table = ed.identity((groups, 1), points.x.device)
    for j in range(w):
        gj = ed.PointP3(*(c[:, :, j : j + 1].expand_as(tc) for c, tc in zip(pts, table)))
        shifted = ed._add_impl(table, gj)
        table = ed.PointP3(*(torch.cat([tc, sc], dim=2) for tc, sc in zip(table, shifted)))
    return pack_niels(ed.to_niels(table))


def build_niels_table(points: ed.PointP3, w: int) -> torch.Tensor:
    """Partition table of points (16, G*w): (G, 2^w, 3, 8) int32 words, entry
    v of group g = sum of points g*w + j over the set bits j of v, affine
    niels (y + x, y - x, 2d*x*y), entry 0 the identity.

    Kernel csrc/build_niels_table.cu, one thread per entry with its own
    inversion. Bound: integer multiplies. The function needs ~17 field
    multiplies per entry (V - 1 - w adds, one batched inversion and 4
    multiplies per entry, per group); the kernel does ~300 (its inversions)."""
    n_pad = points.x.shape[1]
    if n_pad % w:
        raise ValueError(f"point count {n_pad} is not a multiple of the window {w}")
    groups = n_pad // w
    if not _on_card(points.x):
        return build_niels_table_plain(points, w)
    coords, stride = _point_arg(points, points.x.device, (n_pad,))
    table = torch.empty((groups, 1 << w, 3, 8), dtype=torch.int32, device=points.x.device)
    _launch(
        "build_niels_table", build.library().btt_build_niels_table,
        *_ptrs(coords), stride, w, groups, table.data_ptr(), _stream(points.x.device),
    )
    return table


# ---------------------------------------------------------------------------
# ed_lookup_msm  (replaces pallas_point.py:_lookup_tiled :533)
# ---------------------------------------------------------------------------


def lookup_chunks(groups: int, rows: int) -> tuple[int, int]:
    """(groups per chunk, chunk count): enough (chunk, row) threads to fill
    the card, never an empty chunk."""
    nchunks = max(1, min(groups, -(-LOOKUP_THREADS // max(rows, 1))))
    chunk_groups = -(-groups // nchunks)
    return chunk_groups, -(-groups // chunk_groups)


def _check_query(table: torch.Tensor, scalars: torch.Tensor, signs, w: int):
    groups, entries = table.shape[0], table.shape[1]
    if entries != 1 << w or tuple(table.shape[2:]) != (3, 8) or table.dtype != torch.int32:
        raise ValueError(f"table {tuple(table.shape)} {table.dtype} is no (G, 2^{w}, 3, 8) int32 table")
    if scalars.dtype != torch.uint8 or scalars.dim() != 3 or scalars.shape[1] != groups * w:
        raise ValueError(f"scalars {tuple(scalars.shape)} {scalars.dtype}: expected (O, {groups * w}, nbytes) uint8")
    if signs is not None and (signs.dtype != torch.uint8 or tuple(signs.shape) != tuple(scalars.shape[:2])):
        raise ValueError(f"signs {tuple(signs.shape)} {signs.dtype}: expected {tuple(scalars.shape[:2])} uint8")
    return groups


def query_index(scalars: torch.Tensor, signs, w: int) -> torch.Tensor:
    """(R, G) table indices of a query: row r = half * O * nbits + o * nbits
    + b (LSB-first bits; the second half only for signed queries), idx =
    sum_j bit_b(scalar[o, g*w + j]) << j."""
    num_outputs, n_pad, nbytes = scalars.shape
    shifts = torch.arange(8, device=scalars.device, dtype=torch.int32)
    bits = ((scalars.to(torch.int32)[..., None] >> shifts) & 1).reshape(num_outputs, n_pad, 8 * nbytes)
    bits = bits.permute(0, 2, 1)  # (O, nbits, n)
    if signs is not None:
        neg = (signs == 1)[:, None, :].to(torch.int32)
        bits = torch.cat([bits * (1 - neg), bits * neg])
    rows = bits.reshape(-1, n_pad // w, w)
    weights = torch.arange(w, device=scalars.device, dtype=torch.int32)
    return (rows << weights).sum(dim=-1)


def ed_lookup_msm_plain(table, scalars, signs, w: int) -> ed.PointP3:
    groups = table.shape[0]
    idx = query_index(scalars, signs, w)  # (R, G)
    rows = idx.shape[0]
    chunk_groups, nchunks = lookup_chunks(groups, rows)
    device = table.device
    idx = torch.nn.functional.pad(idx, (0, nchunks * chunk_groups - groups))
    idx = idx.reshape(rows, nchunks, chunk_groups).permute(2, 1, 0)  # (cg, K, R)
    flat = table.reshape(groups << w, 3, 8)
    acc = ed.identity((nchunks, rows), device)
    chunk_start = torch.arange(nchunks, device=device)[:, None] * chunk_groups
    for s in range(chunk_groups):
        ix = idx[s].to(torch.int64)  # (K, R); padded groups have idx 0
        g = torch.clamp(chunk_start + s, max=groups - 1)
        entry = unpack_niels(flat[(g << w) + ix])
        acc = ed.select(acc, ed._madd_impl(acc, entry), ix != 0)
    return acc


def ed_lookup_msm(table: torch.Tensor, scalars: torch.Tensor, signs, w: int) -> ed.PointP3:
    """Per-chunk partition products of a query: (16, K, R) partials whose
    sum over K is row r's sum over groups g of table[g, idx[r, g]] (see
    :func:`query_index`; :func:`lookup_chunks` gives K). scalars: (O, G*w,
    nbytes) uint8 magnitudes; signs: (O, G*w) uint8 (1 = negative) or None.

    Kernel csrc/ed_lookup_msm.cu, thread (k, r) gathers niels entries and
    accumulates with 7-multiply mixed adds, skipping entry 0. Bound: integer
    multiplies, 7 field multiplies per nonzero index."""
    groups = _check_query(table, scalars, signs, w)
    if not _on_card(table):
        return ed_lookup_msm_plain(table, scalars, signs, w)
    device = table.device
    for t in (scalars, signs):
        if t is not None and t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
    table, scalars = table.contiguous(), scalars.contiguous()
    signs = None if signs is None else signs.contiguous()
    num_outputs, n_pad, nbytes = scalars.shape
    rows = (2 if signs is not None else 1) * num_outputs * 8 * nbytes
    chunk_groups, nchunks = lookup_chunks(groups, rows)
    out = _empty_point((nchunks, rows), device)
    _launch(
        "ed_lookup_msm", build.library().btt_ed_lookup_msm,
        table.data_ptr(), scalars.data_ptr(), None if signs is None else signs.data_ptr(),
        num_outputs, n_pad, nbytes, w, chunk_groups, nchunks, *_ptrs(out), _stream(device),
    )
    return out


# ---------------------------------------------------------------------------
# doubling_combine  (replaces pallas_point.py:_combine_tiled :982)
# ---------------------------------------------------------------------------


def doubling_combine_plain(products: ed.PointP3) -> ed.PointP3:
    nbits = products.x.shape[2]
    acc = ed.index_batch(products, (slice(None), nbits - 1))
    for b in range(nbits - 2, -1, -1):
        acc = ed._add_impl(ed._double_impl(acc), ed.index_batch(products, (slice(None), b)))
    return acc


def doubling_combine(products: ed.PointP3) -> ed.PointP3:
    """(16, O, nbits) bit products -> (16, O): sum_b 2^b * products[:, o, b],
    by a double-and-add ladder from the top bit.

    Kernel csrc/doubling_combine.cu, one thread per output. Bound: latency of
    the serial ladder (nbits - 1 doublings and adds per output)."""
    if not _on_card(products.x):
        return doubling_combine_plain(products)
    num_outputs, nbits = products.x.shape[1], products.x.shape[2]
    coords, stride = _point_arg(products, products.x.device, (num_outputs, nbits))
    out = _empty_point((num_outputs,), products.x.device)
    _launch(
        "doubling_combine", build.library().btt_doubling_combine,
        *_ptrs(coords), stride, num_outputs, nbits, *_ptrs(out), _stream(products.x.device),
    )
    return out
