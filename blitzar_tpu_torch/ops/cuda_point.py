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

======================  ======================================  =====================
wrapper                 replaces                                 source
======================  ======================================  =====================
``build_niels_table``   ``_build_split_tiled`` :806 (niels)      build_niels_table.cu
``build_cached_table``  ``_build_split_tiled`` :806 (cached)     build_cached_table.cu
``ed_lookup_msm``       ``_lookup_tiled`` :533 (both forms)      ed_lookup_msm.cu
``doubling_combine``    ``_combine_tiled`` :982                  doubling_combine.cu
``ed_add``              ``_add_tiled`` :237                      ed_add.cu
``ed_double``           ``_double_tiled`` :254                   ed_double.cu
``niels_add``           ``_niels_add_tiled`` :79                 niels_add.cu
``fewrow_niels``        ``_niels_tree_tiled`` :426 (with the     fewrow_niels.cu
                        few-row query's gather)
``elligator_form``      ``_elligator_form_tiled`` :212           elligator_form.cu
``tree_reduce_lanes``   ``_tree_tiled`` :344                     tree_reduce_lanes.cu
``ed_to_niels``         ``_fmul_tiled`` :130 + ``_finvert_tiled``  ed_convert.cu
                        :172 (a table's batch inversion)
``ed_file_rows``        ``_fmul_tiled`` :130 (the raw write)     ed_convert.cu
``ed_file_entries``     ``_fmul_tiled`` :130 (the raw read)      ed_convert.cu
``ed_niels_points``     ``_fmul_tiled`` :130 (the npz write)     ed_convert.cu
``ed_affine``           ``_finvert_tiled`` :172 + ``_fmul_tiled``  ed_convert.cu
                        :130 (the generator disk cache)
``ed_from_affine_rows`` ``_fmul_tiled`` :130 (the disk cache's   ed_convert.cu
                        load)
``ed_horner``           ``_double_tiled`` :254 + ``_add_tiled``  ed_horner.cu
                        :237 (the bucket engine's Horner)
``ed_window_sums``      ``_add_tiled`` :237 (the bucket engine's  window_sums.cu
                        scan) + ``_tree_tiled`` :344
``ristretto_encode``    ``_fmul_tiled`` :130 + ``_fsq_tiled``     ristretto.cu
                        :144 (the ristretto255 encode's chain)
``ristretto_decode``    ``_fmul_tiled`` :130 + ``_fsq_tiled``     ristretto.cu
                        :144 (the ristretto255 decode's chain)
======================  ======================================  =====================

``ed_to_niels``, ``ed_file_rows`` and ``ed_file_entries`` convert a chunk
of a table between extended points, niels words and the reference's raw
file rows in one launch, where the files paths ran chains of ``fmul``
launches (3 x 255 scan steps and a ``finvert`` for a batch inversion);
``ed_niels_points`` turns niels words back into extended points (the npz
write) and ``ed_affine`` extended points into canonical affine ones (the
generator disk cache), one launch a chunk each, where ``fmul`` and
``finvert`` launches ran among plain passes; ``ed_from_affine_rows`` turns
the disk cache file's uint16 rows into extended points in one launch,
where the load widened them to int32 on the host and launched ``fmul``.
``ed_horner`` is the bucket engine's Horner over a commitment's 8-bit
windows as one launch, the ladder of ``doubling_combine`` with 8 doublings
a step, where the engine launched ``ed_double`` 8 times and ``ed_add``
once a window; ``ed_window_sums`` its sums over the buckets of every
(output, window) row as one launch, where 8 ``ed_add`` scan launches, 8
plain cats and a ``tree_reduce_lanes`` launch ran.

``ristretto_encode`` and ``ristretto_decode`` are the ristretto255 codec
(``api.compress_ristretto255``, ``decompress_ristretto255``, every
ristretto255 commitment's result, the IPA's L and R and its verifier), one
launch each where the plain encode ran ~280 field multiplies of ~50 small
launches each; blitzar_tpu computes them as plain ``jnp``.

``ed_lookup_msm`` counts its launches on a cached table (a streamed chunk's)
as ``ed_lookup_msm_cached``. The Weierstrass kernels (``w_build_table``,
``w_lookup_msm``, ``wadd``, ``wdouble``, ``w_doubling_combine``, ``w_affine``,
``w_horner``, ``w_window_sums`` and ``tree_reduce_lanes``'s Weierstrass
instantiations) have their wrappers in
``ops/cuda_wpoint.py``,
the proof kernels (``mont_mul_ew``, ``mont_fold_round``, ``mont_sum_round``,
``mont_from_rows``) in ``ops/cuda_mont.py``, the field kernels (``fmul``, ``fsq``, ``finvert``)
in ``ops/cuda_field.py``; their launches are counted here too, so ``KERNELS``
and ``LAUNCHES`` cover every kernel, and ``INSTANCE_LAUNCHES`` counts the
launches of each curve's instantiation of a templated kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..curves import edwards25519 as ed
from ..curves import ristretto as rst
from ..fields import fp25519 as F
from ..utils import limbs as limb_util
from . import build

KERNELS = (
    "build_niels_table",
    "ed_lookup_msm",
    "build_cached_table",
    "ed_lookup_msm_cached",
    "tree_reduce_lanes",
    "doubling_combine",
    "ed_add",
    "ed_double",
    "niels_add",
    "fewrow_niels",
    "elligator_form",
    "ed_to_niels",
    "ed_file_rows",
    "ed_file_entries",
    "ed_niels_points",
    "ed_affine",
    "ed_from_affine_rows",
    "ed_horner",
    "ed_window_sums",
    "ristretto_encode",
    "ristretto_decode",
    "fmul",
    "fsq",
    "finvert",
    "w_build_table",
    "w_lookup_msm",
    "wadd",
    "wdouble",
    "w_doubling_combine",
    "w_affine",
    "w_horner",
    "w_window_sums",
    "mont_mul_ew",
    "mont_fold_round",
    "mont_sum_round",
    "mont_from_rows",
)

# launches of each kernel since the last reset_launches(), and of each
# curve's instantiation of a templated kernel ("name/curve")
LAUNCHES = dict.fromkeys(KERNELS, 0)
INSTANCE_LAUNCHES: dict[str, int] = {}

# (chunk, row) threads the lookups (ed_lookup_msm, w_lookup_msm) aim for:
# two waves of 512 threads (blocks at 128 registers) on each of the H100's
# 132 SMs; K = 528 for a 32-byte query's 256 rows
LOOKUP_THREADS = 2 * 132 * 512


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    INSTANCE_LAUNCHES.clear()


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
    """(nlimbs, *batch) with the batch contiguous inside each limb row."""
    if t.dim() < 2 or t.dtype != torch.int32:
        return False
    expected = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def _field_arg(t: torch.Tensor, device, batch, nlimbs: int = F.NLIMBS) -> tuple[torch.Tensor, int]:
    """Check one (nlimbs, *batch) int32 field tensor for a launch; returns
    the tensor (made limb-major if it was not) and its limb stride."""
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 limbs, got {t.dtype}")
    if tuple(t.shape) != (nlimbs,) + tuple(batch):
        raise ValueError(f"expected shape {(nlimbs,) + tuple(batch)}, got {tuple(t.shape)}")
    if not _limb_major(t):
        t = t.contiguous()
    return t, t.stride(0)


def _point_arg(p, device, batch, nlimbs: int = F.NLIMBS) -> tuple[list[torch.Tensor], int]:
    """Check a point batch (any number of coordinates) for a launch: its
    coordinates, limb-major with one limb stride, and that stride."""
    coords = [_field_arg(c, device, batch, nlimbs)[0] for c in p]
    if len({c.stride(0) for c in coords}) != 1:
        coords = [c.contiguous() for c in coords]
    return coords, coords[0].stride(0)


def _out_point_arg(out, device, batch, nlimbs: int = F.NLIMBS) -> int:
    """Check a point batch a kernel writes in place (views into a larger
    output): on ``device``, int32, (nlimbs, *batch), limb-major, one limb
    stride; returns the stride. Nothing is copied: a layout the kernel does
    not take raises."""
    for c in out:
        if c.device != device or c.dtype != torch.int32 or tuple(c.shape) != (nlimbs,) + tuple(batch):
            raise ValueError(f"output {tuple(c.shape)} {c.dtype} on {c.device}: expected "
                             f"{(nlimbs,) + tuple(batch)} int32 on {device}")
        if not _limb_major(c) or c.stride(0) != out[0].stride(0):
            raise ValueError("output coordinates must be limb-major with one limb stride")
    return out[0].stride(0)


def _empty_point(batch, device, point=ed.PointP3, nlimbs: int = F.NLIMBS):
    return point(
        *(torch.empty((nlimbs,) + tuple(batch), dtype=torch.int32, device=device) for _ in point._fields)
    )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, fn, *args, instance: str | None = None) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
    if instance is not None:
        key = f"{name}/{instance}"
        INSTANCE_LAUNCHES[key] = INSTANCE_LAUNCHES.get(key, 0) + 1


def _ptrs(coords) -> list[int]:
    return [c.data_ptr() for c in coords]


# ---------------------------------------------------------------------------
# niels table layout: (G, 2^w, 3, 8) int32 words, entry = a | b | 2d*t
# ---------------------------------------------------------------------------


def limbs_to_words(c: torch.Tensor) -> torch.Tensor:
    """Canonical (2K, *batch) 16-bit limbs -> (*batch, K) int32 holding the
    32-bit words' bit patterns."""
    c = c.to(torch.int64)
    w = c[0::2] | (c[1::2] << 16)
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
    return w.movedim(0, -1)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(*batch, K) int32 words -> (2K, *batch) int32 limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(tuple(w.shape[:-1]) + (2 * w.shape[-1],))
    return limbs.movedim(-1, 0).to(torch.int32)


def pack_niels(n: ed.Niels) -> torch.Tensor:
    """Niels (16, *batch) -> (*batch, 3, 8) int32 table entries."""
    return torch.stack([limbs_to_words(F.canonicalize(c)) for c in n], dim=-2)


def unpack_niels(entries: torch.Tensor) -> ed.Niels:
    """(*batch, 3, 8) table entries -> Niels (16, *batch)."""
    return ed.Niels(*(words_to_limbs(entries[..., k, :]) for k in range(3)))


def pack_cached(c: ed.Cached) -> torch.Tensor:
    """Cached (16, *batch) -> (*batch, 4, 8) int32 table entries."""
    return torch.stack([limbs_to_words(F.canonicalize(x)) for x in c], dim=-2)


def unpack_cached(entries: torch.Tensor) -> ed.Cached:
    """(*batch, 4, 8) table entries -> Cached (16, *batch)."""
    return ed.Cached(*(words_to_limbs(entries[..., k, :]) for k in range(4)))


# ---------------------------------------------------------------------------
# a table's conversions: ed_to_niels, ed_file_rows, ed_file_entries (replace
# chains of pallas_point.py:_fmul_tiled :130, and _finvert_tiled :172)
# ---------------------------------------------------------------------------

FILE_ROW_WORDS = 15  # a raw file's ristretto255 entry: {X, Y, X*Y}, five u64 field51 limbs each


def ed_to_niels_plain(points: ed.PointP3) -> torch.Tensor:
    """:func:`ed_to_niels` by the plain adds: z inverted by a batch
    inversion along runs of up to 256 entries (``F.batch_invert_lanes``;
    exact inverses, so the words do not depend on the batching), then x/z,
    y/z and (y + x, y - x, 2d*x*y)."""
    return pack_niels(ed.to_niels(points, invert=_invert_runs))


def ed_to_niels(points: ed.PointP3) -> torch.Tensor:
    """(16, *batch) extended points (a chunk of a point table) -> (*batch, 3,
    8) niels words, canonical: the handle's entries (blitzar_tpu/msm/fixed.py:
    197-220). t is not read; no z may be 0.

    Kernel csrc/ed_convert.cu, one launch: each thread runs Montgomery's
    trick over 32, 64 or 128 entries of the chunk (a power of two, the
    chunk over 2^15 threads; its prefixes parked in the words it writes),
    one inversion a thread, 7 field multiplies an entry. Bound: bytes (x,
    y and z read, 96 bytes written an entry); a thread's own inversion adds
    about 4 multiplies an entry at 64 entries a thread."""
    if not _on_card(points.x):
        return ed_to_niels_plain(points)
    batch = tuple(points.x.shape[1:])
    coords, stride = _point_arg(points[:3], points.x.device, batch)
    out = torch.empty(batch + (3, 8), dtype=torch.int32, device=points.x.device)
    _launch(
        "ed_to_niels", build.library().btt_ed_to_niels,
        *_ptrs(coords), stride, points.x[0].numel(), out.data_ptr(), _stream(points.x.device),
    )
    return out


def _check_words(words: torch.Tensor) -> None:
    if words.dim() < 2 or tuple(words.shape[-2:]) != (3, 8) or words.dtype != torch.int32:
        raise ValueError(f"niels words {tuple(words.shape)} {words.dtype}: expected (*batch, 3, 8) int32")


def ed_file_rows_plain(words: torch.Tensor) -> torch.Tensor:
    """:func:`ed_file_rows` by the plain multiplies: x = (a - b)/2, y = (a +
    b)/2, x*y, each as canonical field51 limbs."""
    _check_words(words)
    x, y = ed.niels_to_affine(unpack_niels(words.reshape(-1, 3, 8)))
    return torch.cat([limb_util.limbs16_to_f51_u64(c) for c in (x, y, F.mul(x, y))], dim=1)


def ed_file_rows(words: torch.Tensor) -> torch.Tensor:
    """(*batch, 3, 8) niels words (a chunk of a handle's table) -> (E, 15)
    int64 rows of the reference's raw file, E the batch's size: affine {X,
    Y, X*Y}, canonical radix-2^51 limbs as u64 bit patterns.

    Kernel csrc/ed_convert.cu, one launch, one thread an entry: 3 field
    multiplies, t not read, a block's rows written out from shared memory.
    Bound: bytes (64 read, 120 written an entry)."""
    _check_words(words)
    if not _on_card(words):
        return ed_file_rows_plain(words)
    words = words.contiguous()
    count = words.numel() // 24
    rows = torch.empty((count, FILE_ROW_WORDS), dtype=torch.int64, device=words.device)
    _launch(
        "ed_file_rows", build.library().btt_ed_file_rows,
        words.data_ptr(), count, rows.data_ptr(), _stream(words.device),
    )
    return rows


def _check_rows(rows: torch.Tensor) -> None:
    if rows.dim() != 2 or rows.shape[1] != FILE_ROW_WORDS or rows.dtype != torch.int64:
        raise ValueError(f"file rows {tuple(rows.shape)} {rows.dtype}: expected (E, {FILE_ROW_WORDS}) int64")


def ed_file_entries_plain(rows: torch.Tensor) -> torch.Tensor:
    """:func:`ed_file_entries` by the plain multiplies: x and y reduced from
    any field51 limbs (``utils.limbs.f51_u64_to_limbs16``), then (y + x, y -
    x, 2d*x*y)."""
    _check_rows(rows)
    x = limb_util.f51_u64_to_limbs16(rows[:, 0:5])
    y = limb_util.f51_u64_to_limbs16(rows[:, 5:10])
    return pack_niels(ed.affine_to_niels(x, y))


def ed_file_entries(rows: torch.Tensor) -> torch.Tensor:
    """(E, 15) int64 rows of the reference's raw file -> (E, 3, 8) niels
    words: x and y from any field51 representation (u64 limbs of any
    magnitude, values below 2^269, reduced mod p), 2d*x*y recomputed (the
    row's X*Y is not read).

    Kernel csrc/ed_convert.cu, one launch, one thread an entry: 2 field
    multiplies, a block's rows read in and its words written out through
    shared memory. Bound: bytes (80 read, 96 written an entry)."""
    _check_rows(rows)
    if not _on_card(rows):
        return ed_file_entries_plain(rows)
    rows = rows.contiguous()
    count = rows.shape[0]
    words = torch.empty((count, 3, 8), dtype=torch.int32, device=rows.device)
    _launch(
        "ed_file_entries", build.library().btt_ed_file_entries,
        rows.data_ptr(), count, words.data_ptr(), _stream(rows.device),
    )
    return words


def ed_niels_points_plain(words: torch.Tensor) -> ed.PointP3:
    """:func:`ed_niels_points` by the plain multiplies: the unpacked
    entries, ``ed.niels_to_p3`` (x = (a - b)/2, y = (a + b)/2, z = 1, t =
    2d*t / (2d)) and canonical limbs."""
    _check_words(words)
    return ed.PointP3(*(F.canonicalize(c) for c in ed.niels_to_p3(unpack_niels(words))))


def ed_niels_points(words: torch.Tensor, out: ed.PointP3 | None = None) -> ed.PointP3:
    """(*batch, 3, 8) niels words (a chunk of a handle's table) -> (16,
    *batch) canonical extended points (x, y, 1, x*y): the point table of the
    npz write (blitzar_tpu/msm/fixed.py:397-414). ``out`` (four (16,
    *batch) views with one limb stride, a chunk's slice of a whole table's
    coordinates) takes the points in place and is returned.

    Kernel csrc/ed_convert.cu, one launch, one thread an entry: x = (a -
    b)/2, y = (a + b)/2 and x*y, 3 field multiplies, t not read, z = 1
    written. Bound: bytes (64 read, four coordinates of 16 int32 limbs
    written an entry)."""
    _check_words(words)
    batch = tuple(words.shape[:-2])
    if not _on_card(words):
        points = ed_niels_points_plain(words)
        if out is None:
            return points
        for dst, src in zip(out, points):
            dst.copy_(src)
        return out
    device = words.device
    words = words.contiguous()
    if words.data_ptr() % 16:  # the kernel reads an entry by 16-byte loads
        words = words.clone()
    if out is None:
        out = _empty_point(batch, device)
    stride = _out_point_arg(out, device, batch)
    _launch(
        "ed_niels_points", build.library().btt_ed_niels_points,
        words.data_ptr(), words.numel() // 24, *_ptrs(out), stride, _stream(device),
    )
    return out


def ed_affine_plain(points: ed.PointP3) -> ed.PointP3:
    """:func:`ed_affine` by the plain field ops: z inverted, x/z, y/z and
    their product, canonical limbs."""
    zinv = F.invert(points.z)
    x, y = F.mul(points.x, zinv), F.mul(points.y, zinv)
    one = F.from_int(1, tuple(points.x.shape[1:]), points.x.device)
    return ed.PointP3(F.canonicalize(x), F.canonicalize(y), one, F.canonicalize(F.mul(x, y)))


def ed_affine(points: ed.PointP3) -> ed.PointP3:
    """(16, *batch) extended points, no z 0 (generators) -> canonical (x/z,
    y/z, 1, x*y/z^2): the generator disk cache's affine form
    (blitzar_tpu/generators.py:132-144), and a legacy extended file's z
    normalised to 1. t is not read.

    Kernel csrc/ed_convert.cu, one launch: each thread runs Montgomery's
    trick over 8, 16, 32 or 64 strided entries (by the count; its prefixes
    parked in the output's t), one inversion a thread, 6 field multiplies
    an entry. Bound: bytes (x, y, z read, four coordinates written) over
    operations."""
    if not _on_card(points.x):
        return ed_affine_plain(points)
    device = points.x.device
    batch = tuple(points.x.shape[1:])
    coords, stride = _point_arg(points[:3], device, batch)
    out = _empty_point(batch, device)
    count = points.x[0].numel()
    _launch(
        "ed_affine", build.library().btt_ed_affine,
        *_ptrs(coords), stride, count, *_ptrs(out), count, _stream(device),
    )
    return out


def ed_from_affine_rows_plain(rows: torch.Tensor) -> ed.PointP3:
    """:func:`ed_from_affine_rows` by the plain field ops: the limbs widened,
    x * y, z = 1, canonical limbs."""
    x, y = (F.canonicalize(rows[k].view(torch.int16).to(torch.int32) & 0xFFFF) for k in range(2))
    one = F.from_int(1, tuple(rows.shape[2:]), rows.device)
    return ed.PointP3(x, y, one, F.canonicalize(F.mul(x, y)))


def ed_from_affine_rows(rows: torch.Tensor) -> ed.PointP3:
    """(2, 16, n) uint16 limbs of affine x and y (the generator disk cache
    file's rows, blitzar_tpu/generators.py:62-72) -> canonical (x, y, 1,
    x*y), (16, n) int32 each.

    Kernel csrc/ed_convert.cu, one launch: one thread a generator, its 32
    limb rows read as 16-bit words and widened in registers, one field
    multiply. Bound: bytes (64 read and 256 written a generator)."""
    if rows.dim() != 3 or tuple(rows.shape[:2]) != (2, F.NLIMBS):
        raise ValueError(f"expected (2, {F.NLIMBS}, n) rows, got {tuple(rows.shape)}")
    if rows.dtype != torch.uint16:
        raise TypeError(f"expected uint16 limbs, got {rows.dtype}")
    if not _on_card(rows):
        return ed_from_affine_rows_plain(rows)
    rows = rows.contiguous()
    count = rows.shape[2]
    out = _empty_point((count,), rows.device)
    _launch(
        "ed_from_affine_rows", build.library().btt_ed_from_affine_rows,
        rows.data_ptr(), count, *_ptrs(out), count, _stream(rows.device),
    )
    return out


# ---------------------------------------------------------------------------
# ed_add  (replaces pallas_point.py:_add_tiled :237 / add :291)
# ---------------------------------------------------------------------------


def ed_add_plain(p: ed.PointP3, q: ed.PointP3, negate_q: bool = False) -> ed.PointP3:
    return ed._add_impl(p, ed.neg(q) if negate_q else q)


def ed_add(p: ed.PointP3, q: ed.PointP3, negate_q: bool = False) -> ed.PointP3:
    """Elementwise p + q (unified add-2008-hwcd-3) over equal batch shapes,
    or p - q with ``negate_q`` (q read as (-x, y, z, -t), no pass first).

    Kernel csrc/ed_add.cu: four lanes of a warp a pair (csrc/quad_add.cuh).
    Bound: the launch and one lane's 3 dependent multiplies at the paths'
    batches; integer multiplies (12 field multiplies a pair) at large ones."""
    if not _on_card(p.x):
        return ed_add_plain(p, q, negate_q)
    batch = tuple(p.x.shape[1:])
    pc, ps = _point_arg(p, p.x.device, batch)
    qc, qs = _point_arg(q, p.x.device, batch)
    out = _empty_point(batch, p.x.device)
    count = p.x[0].numel()
    _launch(
        "ed_add", build.library().btt_ed_add,
        *_ptrs(pc), ps, *_ptrs(qc), qs, int(negate_q), count,
        *_ptrs(out), _stream(p.x.device),
    )
    return out


# ---------------------------------------------------------------------------
# ed_double  (replaces pallas_point.py:_double_tiled :254 / double :298)
# ---------------------------------------------------------------------------


def ed_double_plain(p: ed.PointP3) -> ed.PointP3:
    return ed._double_impl(p)


def ed_double(p: ed.PointP3) -> ed.PointP3:
    """Elementwise 2p (dbl-2008-hwcd), any batch shape, one element included.

    Kernel csrc/ed_double.cu, one thread per element. Bound: integer
    multiplies (8 field multiplies per element) at large batches; launch
    latency for the few outputs of a Horner step."""
    if not _on_card(p.x):
        return ed_double_plain(p)
    batch = tuple(p.x.shape[1:])
    pc, ps = _point_arg(p, p.x.device, batch)
    out = _empty_point(batch, p.x.device)
    _launch(
        "ed_double", build.library().btt_ed_double,
        *_ptrs(pc), ps, p.x[0].numel(), *_ptrs(out), _stream(p.x.device),
    )
    return out


# ---------------------------------------------------------------------------
# niels_add  (replaces pallas_point.py:_niels_add_tiled :79 / niels_add :95)
# ---------------------------------------------------------------------------


def niels_add_plain(n1: ed.Niels, n2: ed.Niels) -> ed.PointP3:
    return ed._niels_add_impl(n1, n2)


def niels_add(n1: ed.Niels, n2: ed.Niels) -> ed.PointP3:
    """Elementwise n1 + n2 of two affine niels batches of one shape, as
    extended points (7 multiplies and one by 1/(2d)).

    Kernel csrc/niels_add.cu, four lanes of a warp a pair (csrc/quad_add.cuh).
    Bound: the launch and one lane's 3 dependent multiplies at the few-row
    path's batch; integer multiplies (8 field multiplies a pair) at large ones."""
    if not _on_card(n1.a):
        return niels_add_plain(n1, n2)
    batch = tuple(n1.a.shape[1:])
    pc, ps = _point_arg(n1, n1.a.device, batch)
    qc, qs = _point_arg(n2, n1.a.device, batch)
    out = _empty_point(batch, n1.a.device)
    _launch(
        "niels_add", build.library().btt_niels_add,
        *_ptrs(pc), ps, *_ptrs(qc), qs, n1.a[0].numel(), *_ptrs(out), _stream(n1.a.device),
    )
    return out


# ---------------------------------------------------------------------------
# fewrow_niels  (replaces pallas_point.py:_niels_tree_tiled :426 /
# niels_tree_reduce_lanes :447, and the few-row query's gather before it)
# ---------------------------------------------------------------------------

# the chunk sizes a column of the kernel takes: powers of two above the TPU
# kernel's 128 lanes, up to 2048 (its largest table chunk)
NIELS_TREE_LANES = 128
NIELS_TREE_MAX = 2048
# bytes of selected entries a row block of a gathered few-row query holds at
# most: the plain version's, and the query's on tables fewrow_niels does not
# take (msm/fixed.py)
FEWROW_BUDGET_BYTES = 256 << 20


def niels_tree_fits(size: int) -> bool:
    """Whether :func:`fewrow_niels` takes table chunks of ``size`` groups
    (blitzar_tpu's tree_fits, pallas_point.py:391-393: a power of two above
    128)."""
    return size & (size - 1) == 0 and NIELS_TREE_LANES < size <= NIELS_TREE_MAX


def fewrow_blocks(table: torch.Tensor, r_rows: int) -> list:
    """The row blocks of a gathered few-row query: slices whose selected
    entries stay under ``FEWROW_BUDGET_BYTES``."""
    groups, entry_bytes = table.shape[0], table.shape[2] * table.shape[3] * 4
    rb = max(1, min(r_rows, FEWROW_BUDGET_BYTES // (groups * entry_bytes)))
    return [slice(lo, min(lo + rb, r_rows)) for lo in range(0, r_rows, rb)]


def niels_tree_plain(entries: torch.Tensor) -> ed.PointP3:
    """(size, cols, 3, 8) niels entries -> (16, cols) column sums in the
    kernel's order of additions: entries s and s + size/2 by the niels add,
    then halving extended adds."""
    size = entries.shape[0]
    n = unpack_niels(entries)
    half = size // 2
    lo = ed.Niels(*(c[:, :half] for c in n))
    hi = ed.Niels(*(c[:, half:] for c in n))
    return ed.tree_reduce(ed._niels_add_impl(lo, hi), half)


def fewrow_niels_plain(table: torch.Tensor, scalars: torch.Tensor, signs, w: int, gc: int,
                       chunks=None) -> ed.PointP3:
    """:func:`fewrow_niels` in plain ops: for each block of rows
    (:func:`fewrow_blocks`), the entry each (row, group) picks gathered into
    (gc, chunks x rows) columns, then :func:`niels_tree_plain`. ``chunks``
    (a 1-D index tensor) computes only those table chunks, (16,
    len(chunks), R): the comparison of a full-size run on a sample."""
    groups = table.shape[0]
    idx = query_index(scalars, signs, w)  # (R, G)
    dev = table.device
    ids = torch.arange(groups // gc, device=dev) if chunks is None else chunks.to(dev)
    g = ids[None, :] * gc + torch.arange(gc, device=dev)[:, None]  # (gc, K): group s of chunk k
    flat = table.reshape((groups << w,) + tuple(table.shape[2:]))
    out = []
    for rows in fewrow_blocks(table, idx.shape[0]):
        sel = flat[(g[:, :, None] << w) + idx[rows][:, g].permute(1, 2, 0)]  # (gc, K, rows, 3, 8)
        sums = niels_tree_plain(sel.reshape((gc, -1) + tuple(table.shape[2:])))
        out.append(ed.reshape_batch(sums, (len(ids), -1)))
    return out[0] if len(out) == 1 else ed.cat(out, dim=2)


def fewrow_niels(table: torch.Tensor, scalars: torch.Tensor, signs, w: int, gc: int) -> ed.PointP3:
    """A few-row query's column sums on a niels table: (16, chunks, R), each
    row r's sum over the gc groups of each table chunk of table[g, idx[r,
    g]] (:func:`query_index`; entry 0, the identity, counts like any
    other); their sum over the chunks is row r's product. table: (G, 2^w, 3,
    8) niels words, gc in (128, 2048] (:func:`niels_tree_fits`) dividing G;
    scalars, signs as :func:`ed_lookup_msm`'s.

    Kernel csrc/fewrow_niels.cu, one launch: a column is a warp of 32
    lanes, which form their indices from the scalar bytes and read their
    entries straight from the table, each lane summing its share in the
    plain version's halving order (csrc/niels_tree.cuh), then the lanes
    halved; nothing is gathered first. Bound: integer multiplies (gc/2
    niels adds and gc/2 - 1 extended adds a column)."""
    groups = _check_query(table, scalars, signs, w, {(3, 8)})
    if not niels_tree_fits(gc) or groups % gc:
        raise ValueError(f"table chunks of {gc} groups over {groups}: expected a power of two in "
                         f"({NIELS_TREE_LANES}, {NIELS_TREE_MAX}] dividing the group count")
    if not _on_card(table):
        return fewrow_niels_plain(table, scalars, signs, w, gc)
    device = table.device
    table, scalars, signs, row = query_args(table, scalars, signs)
    num_outputs, n_pad, nbytes = scalars.shape
    rows = (2 if signs is not None else 1) * num_outputs * 8 * nbytes
    nc = groups // gc
    out = _empty_point((nc * rows,), device)
    _launch(
        "fewrow_niels", build.library().btt_fewrow_niels,
        table.data_ptr(), scalars.data_ptr(), None if signs is None else signs.data_ptr(),
        num_outputs, n_pad, row, nbytes, w, gc, *_ptrs(out), _stream(device),
    )
    return ed.reshape_batch(out, (nc, rows))


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


def subset_sums_plain(points: ed.PointP3, w: int) -> ed.PointP3:
    """(16, G, 2^w) subset sums of each group of w points by w doubling
    concatenations (table_{j+1} = [table_j | table_j + G_j], blitzar_tpu's
    order), extended."""
    n_pad = points.x.shape[1]
    groups = n_pad // w
    pts = ed.reshape_batch(points, (groups, w))
    table = ed.identity((groups, 1), points.x.device)
    for j in range(w):
        gj = ed.PointP3(*(c[:, :, j : j + 1].expand_as(tc) for c, tc in zip(pts, table)))
        shifted = ed._add_impl(table, gj)
        table = ed.PointP3(*(torch.cat([tc, sc], dim=2) for tc, sc in zip(table, shifted)))
    return table


NIELS_RUN_ENTRIES = 256  # entries a batch inversion covers, the kernel's run


def _invert_runs(z: torch.Tensor) -> torch.Tensor:
    """1/z for (16, *batch) by a batch inversion along runs of up to 256
    consecutive entries (the largest power of two up to 256 that divides the
    batch's size: a group's runs, as the kernels invert, for a table)."""
    flat = z.reshape(F.NLIMBS, -1)
    run = math.gcd(flat.shape[1], NIELS_RUN_ENTRIES)
    return F.batch_invert_lanes(flat.reshape(F.NLIMBS, -1, run)).reshape(z.shape)


def build_niels_table_plain(points: ed.PointP3, w: int) -> torch.Tensor:
    """The subset sums as affine niels: z inverted by a batch inversion
    along each run of a group's entries (exact inverses: the table does not
    depend on how they are batched)."""
    return pack_niels(ed.to_niels(subset_sums_plain(points, w), invert=_invert_runs))


def build_niels_table(points: ed.PointP3, w: int) -> torch.Tensor:
    """Partition table of points (16, G*w): (G, 2^w, 3, 8) int32 words, entry
    v of group g = sum of points g*w + j over the set bits j of v, affine
    niels (y + x, y - x, 2d*x*y), entry 0 the identity.

    Kernel csrc/build_niels_table.cu: runs of up to 256 entries over 4 lanes
    each (csrc/table_build.cuh), the extended entries parked in the table's
    own slots, one batch inversion a run and one inversion chain for the
    runs of a block. Any w from 1 to 16. Bound: integer multiplies, ~17 field
    multiplies an entry (V - 1 - w adds, a batched inversion and 4 to the
    affine form, per group)."""
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
# build_cached_table  (replaces pallas_point.py:_build_split_tiled :806,
# cached form)
# ---------------------------------------------------------------------------

MAX_CACHED_WINDOW = 8  # a group is one run of the kernel (csrc/table_build.cuh)


def build_cached_table_plain(points: ed.PointP3, w: int) -> torch.Tensor:
    """The subset sums in the cached form: no inversion."""
    return pack_cached(ed.to_cached(subset_sums_plain(points, w)))


def build_cached_table(points: ed.PointP3, w: int) -> torch.Tensor:
    """Partition table of points (16, G*w): (G, 2^w, 4, 8) int32 words, entry
    v of group g = sum of points g*w + j over the set bits j of v, cached
    (y + x, y - x, z, 2d*t) in blitzar_tpu's order of additions (so equal to
    the plain table limb for limb), entry 0 the identity (1, 1, 1, 0).

    Kernel csrc/build_cached_table.cu: a group's entries over 4 lanes, each
    lane adding its own in blitzar_tpu's order (csrc/table_build.cuh).
    Bound: integer multiplies (2^w - 1 - w adds and 2^w multiplies by 2d
    per group), then the bytes written (128 per entry)."""
    n_pad = points.x.shape[1]
    if n_pad % w:
        raise ValueError(f"point count {n_pad} is not a multiple of the window {w}")
    if not 1 <= w <= MAX_CACHED_WINDOW:
        raise ValueError(f"window {w} outside 1..{MAX_CACHED_WINDOW}")
    groups = n_pad // w
    if not _on_card(points.x):
        return build_cached_table_plain(points, w)
    coords, stride = _point_arg(points, points.x.device, (n_pad,))
    table = torch.empty((groups, 1 << w, 4, 8), dtype=torch.int32, device=points.x.device)
    _launch(
        "build_cached_table", build.library().btt_build_cached_table,
        *_ptrs(coords), stride, w, groups, table.data_ptr(), _stream(points.x.device),
    )
    return table


# ---------------------------------------------------------------------------
# ed_lookup_msm  (replaces pallas_point.py:_lookup_tiled :533)
# ---------------------------------------------------------------------------


def whole_chunks(groups: int, nchunks: int) -> tuple[int, int]:
    """(groups per chunk, chunk count) for at most ``nchunks`` chunks of
    equal length but the last: never an empty chunk."""
    nchunks = max(1, min(groups, nchunks))
    chunk_groups = -(-groups // nchunks)
    return chunk_groups, -(-groups // chunk_groups)


def lookup_chunks(groups: int, rows: int) -> tuple[int, int]:
    """(groups per chunk, chunk count K) of ``ed_lookup_msm`` and
    ``w_lookup_msm``: about
    ``LOOKUP_THREADS`` (chunk, row) threads, each walking one long chunk, so
    the reduce after it reads few (K, R) partials."""
    return whole_chunks(groups, -(-LOOKUP_THREADS // max(rows, 1)))


def _check_query(table: torch.Tensor, scalars: torch.Tensor, signs, w: int, entry_shapes) -> int:
    """Check a query's table ((G, 2^w, coords, words) int32, (coords,
    words) one of ``entry_shapes``), scalars and signs; returns G."""
    groups, entries = table.shape[0], table.shape[1]
    if entries != 1 << w or tuple(table.shape[2:]) not in entry_shapes or table.dtype != torch.int32:
        raise ValueError(f"table {tuple(table.shape)} {table.dtype} is no (G, 2^{w}, coords, words) int32 table "
                         f"with (coords, words) in {sorted(entry_shapes)}")
    if scalars.dtype != torch.uint8 or scalars.dim() != 3 or scalars.shape[1] != groups * w:
        raise ValueError(f"scalars {tuple(scalars.shape)} {scalars.dtype}: expected (O, {groups * w}, nbytes) uint8")
    if signs is not None and (signs.dtype != torch.uint8 or tuple(signs.shape) != tuple(scalars.shape[:2])):
        raise ValueError(f"signs {tuple(signs.shape)} {signs.dtype}: expected {tuple(scalars.shape[:2])} uint8")
    return groups


def query_args(table: torch.Tensor, scalars: torch.Tensor, signs) -> tuple:
    """A query's tensors for a lookup launch: (table, scalars, signs, row
    stride). A view whose rows are slices of longer rows (a streamed chunk of
    the whole upload) passes as it is, with the elements from one output's
    row to the next as its row stride; other layouts are made contiguous.
    The table must be 16-byte aligned: the kernels gather with 16-byte
    loads."""
    device = table.device
    for t in (scalars, signs):
        if t is not None and t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
    table = table.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()
    num_outputs, n_pad, nbytes = scalars.shape
    row = scalars.stride(0) // nbytes if num_outputs > 1 else n_pad
    ok = (scalars.stride(2) == 1 or nbytes == 1) and scalars.stride(1) == nbytes
    ok = ok and (num_outputs == 1 or scalars.stride(0) == row * nbytes)
    if signs is not None:
        ok = ok and (signs.stride(1) == 1 or n_pad == 1) and (num_outputs == 1 or signs.stride(0) == row)
    if not ok:
        scalars, row = scalars.contiguous(), n_pad
        signs = None if signs is None else signs.contiguous()
    return table, scalars, signs, row


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


def lookup_walk(table, scalars, signs, w: int, chunks=None):
    """The plain lookups' walk over a query, in the kernels' order (chunks
    by :func:`lookup_chunks`): the number of (chunk, row) partials (K, R),
    then for each step s of a chunk the (K, R) indices and the (K, R,
    coords, words) entries they pick (padded groups pick entry 0).
    ``chunks`` (a 1-D index tensor) walks only those chunks."""
    groups = table.shape[0]
    idx = query_index(scalars, signs, w)  # (R, G)
    rows = idx.shape[0]
    chunk_groups, nchunks = lookup_chunks(groups, rows)
    idx = torch.nn.functional.pad(idx, (0, nchunks * chunk_groups - groups))
    idx = idx.reshape(rows, nchunks, chunk_groups).permute(2, 1, 0)  # (cg, K, R)
    chunk_ids = torch.arange(nchunks, device=table.device) if chunks is None else chunks.to(table.device)
    idx = idx[:, chunk_ids]
    flat = table.reshape((groups << w,) + tuple(table.shape[2:]))
    chunk_start = chunk_ids[:, None] * chunk_groups

    def steps():
        for s in range(chunk_groups):
            ix = idx[s].to(torch.int64)
            g = torch.clamp(chunk_start + s, max=groups - 1)
            yield ix, flat[(g << w) + ix]

    return (len(chunk_ids), rows), steps()


# the entry forms of a ristretto255 table: (coords, words) -> the add of an
# extended accumulator and an entry
ED_ENTRY_FORMS = {
    (3, 8): lambda acc, e: ed._madd_impl(acc, unpack_niels(e)),
    (4, 8): lambda acc, e: ed._cadd_impl(acc, unpack_cached(e)),
}


def ed_lookup_msm_plain(table, scalars, signs, w: int, chunks=None) -> ed.PointP3:
    """The partials of :func:`ed_lookup_msm`, in the kernel's order of
    additions. ``chunks`` (a 1-D index tensor) computes only those chunks,
    (16, len(chunks), R): the comparison of a full-size run on a sample."""
    add = ED_ENTRY_FORMS[tuple(table.shape[2:])]
    shape, steps = lookup_walk(table, scalars, signs, w, chunks)
    acc = ed.identity(shape, table.device)
    for ix, entries in steps:
        acc = ed.select(acc, add(acc, entries), ix != 0)
    return acc


def ed_lookup_msm(table: torch.Tensor, scalars: torch.Tensor, signs, w: int) -> ed.PointP3:
    """Per-chunk partition products of a query: (16, K, R) partials whose
    sum over K is row r's sum over groups g of table[g, idx[r, g]] (see
    :func:`query_index`; :func:`lookup_chunks` gives K). table: niels (G,
    2^w, 3, 8) or cached (G, 2^w, 4, 8) entries; scalars: (O, G*w, nbytes)
    uint8 magnitudes; signs: (O, G*w) uint8 (1 = negative) or None. Scalars
    and signs may be column slices of longer rows (:func:`query_args`).

    Kernel csrc/ed_lookup_msm.cu, thread (k, r) runs csrc/lookup.cuh's
    schedule: it gathers the entries its indices pick and accumulates
    with 7-multiply mixed adds (niels) or 8-multiply adds (cached),
    skipping entry 0; a launch on a cached table counts as
    ``ed_lookup_msm_cached``. Bound: integer multiplies, 7 or 8 field
    multiplies per nonzero index."""
    groups = _check_query(table, scalars, signs, w, ED_ENTRY_FORMS)
    if not _on_card(table):
        return ed_lookup_msm_plain(table, scalars, signs, w)
    device = table.device
    table, scalars, signs, row = query_args(table, scalars, signs)
    cached = table.shape[2] == 4
    num_outputs, n_pad, nbytes = scalars.shape
    rows = (2 if signs is not None else 1) * num_outputs * 8 * nbytes
    chunk_groups, nchunks = lookup_chunks(groups, rows)
    out = _empty_point((nchunks, rows), device)
    _launch(
        "ed_lookup_msm_cached" if cached else "ed_lookup_msm", build.library().btt_ed_lookup_msm,
        table.data_ptr(), scalars.data_ptr(), None if signs is None else signs.data_ptr(),
        num_outputs, n_pad, row, nbytes, w, int(cached), chunk_groups, nchunks, *_ptrs(out), _stream(device),
    )
    return out


# ---------------------------------------------------------------------------
# tree_reduce_lanes  (replaces pallas_point.py:_tree_tiled :344 /
# tree_reduce_lanes :370)
# ---------------------------------------------------------------------------


def tree_launch(curve_id: int, instance: str, p, nlimbs: int, point):
    """Launch tree_reduce_lanes.cu on a (size, *rest) point batch (any
    coordinate count): its (*rest) sums over the leading axis."""
    batch = tuple(p.x.shape[1:])
    size, rest = batch[0], batch[1:]
    cols = 1
    for d in rest:
        cols *= d
    device = p.x.device
    coords, stride = _point_arg(p, device, batch, nlimbs)
    out = _empty_point((cols,), device, point, nlimbs)
    ins, outs = _ptrs(coords), _ptrs(out)
    if len(ins) == 3:  # the launcher's fourth coordinate is ristretto255's t
        ins, outs = ins + [None], outs + [None]
    lib = build.library()
    # the blocks of a column tile park their sums here (none with one block a tile)
    nbytes = ctypes.c_int64(0)
    if lib.btt_tree_reduce_scratch(curve_id, size, cols, ctypes.byref(nbytes)):
        raise ValueError(f"tree_reduce_lanes: no instantiation for curve id {curve_id}")
    scratch = torch.empty((nbytes.value,), dtype=torch.uint8, device=device) if nbytes.value else None
    _launch(
        "tree_reduce_lanes", lib.btt_tree_reduce_lanes,
        curve_id, *ins, stride, size, cols, *outs, None if scratch is None else scratch.data_ptr(), nbytes.value,
        _stream(device), instance=instance,
    )
    return type(out)(*(c.reshape((nlimbs,) + tuple(rest)) for c in out))


def tree_reduce_lanes_plain(p: ed.PointP3) -> ed.PointP3:
    return ed.tree_reduce(p, p.x.shape[1])


def tree_reduce_lanes(p: ed.PointP3) -> ed.PointP3:
    """(16, size, *rest) -> (16, *rest): the sum over the leading batch axis
    (a query's (K, R) lookup partials, a streamed query's (chunks, R)
    products), in one launch. The sum is the same point as the plain
    version's halving tree; its coordinates differ (another order).

    Kernel csrc/tree_reduce_lanes.cu: lanes of a warp on neighbouring
    columns, warps (and with few columns, blocks) on shares of the leading
    axis; strided serial sums per thread, then halving levels in shared
    memory and across a column tile's blocks (csrc/tree_reduce.cuh).
    Bound: operations and bytes (each point read once) at large size; the
    depth of the tree with few points."""
    size = p.x.shape[1]
    if size == 0 or not _on_card(p.x):
        return tree_reduce_lanes_plain(p)
    return tree_launch(0, "ristretto255", p, F.NLIMBS, ed.PointP3)


# ---------------------------------------------------------------------------
# doubling_combine  (replaces pallas_point.py:_combine_tiled :982)
# ---------------------------------------------------------------------------


def ladder_segment_bits(nbits: int) -> int:
    """Bits a segment of the ladder (csrc/ladder.cuh), L = ceil(sqrt(nbits))
    (at most 32 segments): the critical path's adds, L - 1 in a segment's
    Horner run and S - 1 in the fold, are fewest near L = S. 16 for 256
    bits."""
    return max(math.isqrt(nbits - 1) + 1 if nbits > 1 else 1, -(-nbits // 32))


def ladder_plain(group, products, seg: int, step_bits: int = 1):
    """The ladder of csrc/ladder.cuh on a group's plain adds, in the
    kernels' order: every segment's Horner run at once over an (O, S) batch
    (the short top segment joins when its bits begin), then the fold from
    the top segment down; ``step_bits`` doublings a step (8: the bucket
    engine's Horner over its windows). ``group``: ``curves.edwards25519`` or
    a ``WCurve`` (``_add_impl``, ``_double_impl``, ``index_batch``,
    ``select``). ``seg = nbits`` (one segment) is blitzar_tpu's ladder."""

    def doubles(p, k):
        for _ in range(k):
            p = group._double_impl(p)
        return p

    nbits = products.x.shape[2]
    nseg = -(-nbits // seg)
    dev = products.x.device
    lo = torch.arange(nseg, device=dev) * seg
    length = torch.clamp(nbits - lo, max=seg)
    h = group.index_batch(products, (slice(None), lo + length - 1))  # (nlimbs, O, S)
    for s in range(1, seg):
        below = group.index_batch(products, (slice(None), torch.clamp(lo + length - 1 - s, min=0)))
        h = group.select(h, group._add_impl(doubles(h, step_bits), below), (length > s)[None])
    acc = group.index_batch(h, (slice(None), nseg - 1))
    for j in range(nseg - 2, -1, -1):
        acc = group._add_impl(doubles(acc, seg * step_bits), group.index_batch(h, (slice(None), j)))
    return acc


def doubling_combine_plain(products: ed.PointP3, seg_bits: int | None = None) -> ed.PointP3:
    """:func:`doubling_combine` on the plain adds. By default in one
    segment, blitzar_tpu's ladder and coordinates (so the CPU path's
    commitments equal blitzar_tpu's limb for limb); ``seg_bits`` gives the
    kernel's order in segments of that many bits (the same points)."""
    return ladder_plain(ed, products, seg_bits or products.x.shape[2])


def doubling_combine(products: ed.PointP3, seg_bits: int | None = None) -> ed.PointP3:
    """(16, O, nbits) bit products -> (16, O): sum_b 2^b * products[:, o, b],
    by a double-and-add ladder from the top bit.

    Kernel csrc/doubling_combine.cu, one launch for all outputs: one warp
    an output, lanes on segments of ``seg_bits`` bits (default
    ``ladder_segment_bits``) by Horner, lane 0 folds them
    (csrc/ladder.cuh). The outputs are the points of
    :func:`doubling_combine_plain`, its coordinates with the same
    ``seg_bits`` (which a CPU tensor gets: one segment by default). Bound:
    latency (the top bit's nbits - 1 doublings are a serial chain)."""
    if not _on_card(products.x):
        return doubling_combine_plain(products, seg_bits)
    num_outputs, nbits = products.x.shape[1], products.x.shape[2]
    if nbits < 1:
        raise ValueError("a ladder needs at least one bit")
    coords, stride = _point_arg(products, products.x.device, (num_outputs, nbits))
    out = _empty_point((num_outputs,), products.x.device)
    _launch(
        "doubling_combine", build.library().btt_doubling_combine,
        *_ptrs(coords), stride, num_outputs, nbits, seg_bits or ladder_segment_bits(nbits), *_ptrs(out),
        _stream(products.x.device),
    )
    return out


# ---------------------------------------------------------------------------
# ed_horner  (replaces the bucket engine's Horner on pallas_point.py:
# _double_tiled :254 and _add_tiled :237)
# ---------------------------------------------------------------------------

HORNER_STEP_BITS = 8  # the bucket engine's windows: 8 doublings a Horner step


def ed_horner_plain(windows: ed.PointP3, seg_bits: int | None = None) -> ed.PointP3:
    """:func:`ed_horner` on the plain adds, in the kernel's order
    (:func:`ladder_plain` with 8 doublings a step). By default in one
    segment: the engine's loop (``msm/engine.py:horner_plain``), limb for
    limb; ``seg_bits`` gives the kernel's order in segments of that many
    windows (the same points)."""
    return ladder_plain(ed, windows, seg_bits or windows.x.shape[2], HORNER_STEP_BITS)


def ed_horner(windows: ed.PointP3, seg_bits: int | None = None) -> ed.PointP3:
    """(16, O, W) window sums -> (16, O): sum_w 2^(8 w) windows[:, o, w], by
    Horner from the top window (8 doublings and an add a window), the
    bucket engine's combine of its 8-bit windows.

    Kernel csrc/ed_horner.cu, one launch for all outputs: csrc/ladder.cuh's
    ladder with 8 doublings a step, one warp an output, lanes on segments
    of ``seg_bits`` windows (default ``ladder_segment_bits``), lane 0 folds
    them. The outputs are the points of :func:`ed_horner_plain`, its
    coordinates with the same ``seg_bits`` (which a CPU tensor gets: one
    segment by default). Bound: latency (8 (W - 1) dependent doublings)."""
    num_outputs, num_windows = windows.x.shape[1], windows.x.shape[2]
    if num_windows < 1:
        raise ValueError("a Horner sum needs at least one window")
    if not _on_card(windows.x):
        return ed_horner_plain(windows, seg_bits)
    coords, stride = _point_arg(windows, windows.x.device, (num_outputs, num_windows))
    out = _empty_point((num_outputs,), windows.x.device)
    _launch(
        "ed_horner", build.library().btt_ed_horner,
        *_ptrs(coords), stride, num_outputs, num_windows, seg_bits or ladder_segment_bits(num_windows),
        *_ptrs(out), _stream(windows.x.device),
    )
    return out


# ---------------------------------------------------------------------------
# ed_window_sums  (replaces the bucket engine's scan on pallas_point.py:
# _add_tiled :237 and its sum on _tree_tiled :344)
# ---------------------------------------------------------------------------

WINDOW_BUCKETS = 255  # a row's bucket sums, digits 1..255


def check_buckets(buckets) -> int:
    """The row count R of an (R, 255) bucket-sum batch."""
    if buckets.x.dim() != 3 or buckets.x.shape[2] != WINDOW_BUCKETS:
        raise ValueError(f"bucket sums {tuple(buckets.x.shape)}: expected (nlimbs, R, {WINDOW_BUCKETS})")
    return buckets.x.shape[1]


def window_sums_plain(group, buckets):
    """(R, 255) bucket sums -> (R,) window sums sum_k k S_k, on a group's
    plain adds (``curves.edwards25519`` or a ``WCurve``) in blitzar_tpu's
    order (blitzar_tpu/msm/engine.py:118-126): the reverse (suffix) scan
    over the buckets by 8 Hillis-Steele steps, then the halving tree over
    the 255 suffix sums of each row."""
    check_buckets(buckets)
    nb = WINDOW_BUCKETS
    suffix, shift = buckets, 1
    while shift < nb:  # bucket k += bucket k + shift
        head = group._add_impl(group.index_batch(suffix, (slice(None), slice(0, nb - shift))),
                               group.index_batch(suffix, (slice(None), slice(shift, nb))))
        suffix = group.cat([head, group.index_batch(suffix, (slice(None), slice(nb - shift, None)))], dim=2)
        shift *= 2
    return group.tree_reduce(type(suffix)(*(c.transpose(1, 2) for c in suffix)), nb)


def ed_window_sums_plain(buckets: ed.PointP3) -> ed.PointP3:
    return window_sums_plain(ed, buckets)


def ed_window_sums(buckets: ed.PointP3) -> ed.PointP3:
    """(16, R, 255) bucket sums of the bucket engine's (output, window) rows
    -> (16, R): each row's sum_k k S_k (bucket k - 1 holds digit k's sum),
    the same points as :func:`ed_window_sums_plain` (which a CPU tensor
    gets: blitzar_tpu's order and coordinates).

    Kernel csrc/window_sums.cu, one launch for all rows: one warp a row,
    lane t running buckets t + 32 j, a suffix scan of the lanes' sums and
    a halving of their shares by shuffles (csrc/window_sums.cuh). Bound:
    latency (29 dependent adds and doublings a row; the function's least
    work, 508 adds a row, takes the card microseconds)."""
    rows = check_buckets(buckets)
    if not _on_card(buckets.x):
        return ed_window_sums_plain(buckets)
    device = buckets.x.device
    coords, stride = _point_arg(buckets, device, (rows, WINDOW_BUCKETS))
    out = _empty_point((rows,), device)
    if rows:
        _launch(
            "ed_window_sums", build.library().btt_ed_window_sums,
            *_ptrs(coords), stride, rows, *_ptrs(out), _stream(device),
        )
    return out


# ---------------------------------------------------------------------------
# ristretto_encode, ristretto_decode (the ristretto255 codec: chains of
# pallas_point.py:_fmul_tiled :130 and _fsq_tiled :144)
# ---------------------------------------------------------------------------


def ristretto_encode_plain(points: ed.PointP3) -> torch.Tensor:
    return rst.encode(points)


def ristretto_encode(points: ed.PointP3) -> torch.Tensor:
    """(16, *batch) extended points, limbs below 2^17 at any limb-major
    layout -> (32, *batch) uint8 canonical ristretto255 encodings
    (``curves/ristretto.py:encode``); the identity encodes to 32 zero bytes.

    Kernel csrc/ristretto.cu, one thread a point, one launch. Bound:
    operations (~280 field multiplies a point) at a large batch; a small one
    is the latency of one thread's ~280 dependent multiplies."""
    if not _on_card(points.x):
        return ristretto_encode_plain(points)
    device = points.x.device
    batch = tuple(points.x.shape[1:])
    coords, stride = _point_arg(points, device, batch)
    out = torch.empty((32,) + batch, dtype=torch.uint8, device=device)
    count = out[0].numel()
    if count:
        _launch(
            "ristretto_encode", build.library().btt_ristretto_encode,
            *_ptrs(coords), stride, count, out.data_ptr(), _stream(device),
        )
    return out


def _check_encodings(data: torch.Tensor) -> None:
    if data.dim() < 1 or data.shape[0] != 32 or data.dtype != torch.uint8:
        raise ValueError(f"encodings {tuple(data.shape)} {data.dtype}: expected (32, *batch) uint8")


def ristretto_decode_plain(data: torch.Tensor) -> tuple[ed.PointP3, torch.Tensor]:
    _check_encodings(data)
    return rst.decode(data)


def ristretto_decode(data: torch.Tensor) -> tuple[ed.PointP3, torch.Tensor]:
    """(32, *batch) uint8 ristretto255 encodings -> ((16, *batch) points
    (x, y, 1, x*y), canonical limbs; (*batch,) bool valid mask), as
    ``curves/ristretto.py:decode``: valid means canonical (s < p, even, bit
    255 clear), a square root, t non-negative and y nonzero; an invalid
    slot holds junk.

    Kernel csrc/ristretto.cu, one thread an encoding, one launch. Bound: as
    :func:`ristretto_encode`'s."""
    if not _on_card(data):
        return ristretto_decode_plain(data)
    _check_encodings(data)
    device = data.device
    batch = tuple(data.shape[1:])
    data = data.contiguous()
    coords = torch.empty((4, 16) + batch, dtype=torch.int32, device=device)
    valid = torch.empty(batch, dtype=torch.bool, device=device)
    points = ed.PointP3(*coords.unbind(0))
    count = valid.numel()
    if count:
        _launch(
            "ristretto_decode", build.library().btt_ristretto_decode,
            data.data_ptr(), count, *_ptrs(points), valid.data_ptr(), _stream(device),
        )
    return points, valid
