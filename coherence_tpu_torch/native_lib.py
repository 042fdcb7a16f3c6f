"""ctypes loader for the port's native host library
(``native/coherence_native.cpp``).

The port's copy of ``coherence_tpu.native_lib``, trimmed to the six entry
points the port calls: ``blit_masked_rgb``, ``bezier_subdivide_batch``,
``edge_spans``, ``expand_1x_grouped``, ``expand_aa_grouped`` and
``jbig2_generic_region``; and the port's own ``brush_stroke_table`` and
``brush_strip_lists`` (the brush_stamp kernel's host lists) and
``sprite_band_spans`` (the sprite_raster kernel's).  The library
is compiled by g++ on first use, and again whenever the source is newer, into
``build/native/`` at the root of the checkout.  It is built with
``-march=native``, so its file name carries a hash of the flags and of the
host's CPU model and feature flags: a library built on another host is
never loaded here.  The port has no NumPy fallback for these: a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "coherence_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "native")
GXX_FLAGS = [
    "-O3",
    "-march=native",
    # The bezier/scanline entry points are bit-exact float64 transcriptions
    # of NumPy formulas: FMA contraction of a*b+c would change the double
    # rounding, so forbid it.
    "-ffp-contract=off",
    "-shared",
    "-fPIC",
    "-pthread",
]


def _host_tag() -> str:
    """A short hash of the build flags and of what -march=native reads: the
    CPU's model name and feature flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            seen = set()
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part") and key not in seen:
                    seen.add(key)
                    h.update(line.encode())
    except OSError:
        h.update(platform.processor().encode())
    return h.hexdigest()[:12]


LIBRARY = os.path.join(BUILD_DIR, f"libcoherence_native-{_host_tag()}.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> None:
    """Compile the library if this host's build is missing or older than
    its source."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(_SRC):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native host library ({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, LIBRARY)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(LIBRARY)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        lib.blit_masked_rgb.restype = None
        lib.blit_masked_rgb.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags=("C_CONTIGUOUS", "WRITEABLE")), i32, i32, u8p, i32, i32, i32, i32,
        ]
        lib.bezier_subdivide_batch.restype = i64
        lib.bezier_subdivide_batch.argtypes = [f64p, i64, ctypes.c_double, f64p, i64, i64p]
        lib.edge_spans_count.restype = i64
        lib.edge_spans_count.argtypes = [i64p, i64, i64, i64]
        lib.edge_spans_fill.restype = None
        lib.edge_spans_fill.argtypes = [i64p, i64, ctypes.c_int32, i64, i64, i64] + [i64p] * 7
        lib.expand_1x_count.restype = i64
        lib.expand_1x_count.argtypes = [i64p, i64p, i64p] + [i64] * 5
        lib.expand_1x_grouped.restype = i64
        lib.expand_1x_grouped.argtypes = [i64p, i64p, i64p] + [i64] * 5 + [i64p] * 5
        lib.expand_aa_count.restype = i64
        lib.expand_aa_count.argtypes = [i64p, i64p, i64p] + [i64] * 6 + [u8p]
        lib.expand_aa_grouped.restype = i64
        lib.expand_aa_grouped.argtypes = [i64p, i64p, i64p] + [i64] * 7 + [u8p] + [i64p] * 5
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.jbig2_generic_region.restype = i32
        lib.jbig2_generic_region.argtypes = [u8p, i64, i32, i32, i32, i8p, i32, i32, u8p]
        # Pointers as plain addresses: ndpointer's checks cost more than the lists (the wrapper checks).
        vp = ctypes.c_void_p
        lib.brush_stroke_table.restype = i64
        lib.brush_stroke_table.argtypes = [vp, i32, i32, i32, vp, i32, vp]
        lib.brush_strip_lists.restype = i64
        lib.brush_strip_lists.argtypes = [vp, vp, vp, i32, i32, vp, i32, i32, i32, vp, i64, i32, i32, vp, i64, vp, vp,
                                          i64]
        lib.sprite_band_spans.restype = i64
        lib.sprite_band_spans.argtypes = [vp, vp, vp, i64, i32, vp, vp]
        _lib = lib
        return _lib


def blit_masked_rgb(fb: np.ndarray, rgbm: np.ndarray, oy: int, ox: int) -> None:
    """Write a sprite into fb (H, W, 3) uint8 where its mask is set, with
    the sprite's row 0, column 0 landing at fb[oy, ox]; clipped to fb.
    rgbm is (h, w, 4) uint8: r, g, b and, in its fourth channel, the mask
    (the JAX package's entry point takes int32 colours and the mask apart)."""
    lib = _load()
    h, w = rgbm.shape[:2]
    lib.blit_masked_rgb(fb, fb.shape[0], fb.shape[1], np.ascontiguousarray(rgbm, dtype=np.uint8), h, w, oy, ox)


def bezier_subdivide_batch(ctrl: np.ndarray, eps: float):
    """De Casteljau subdivision of a batch of beziers to chords, exactly
    matching geometry.path.bezier_subdivide's DFS order and flatness
    classification (polygon.ml:107-127).

    ctrl: (n, 8) float64 control points [x1 y1 x2 y2 x3 y3 x4 y4].
    Returns (chords (total, 4) float64 [ax ay bx by], counts (n,) int64)."""
    lib = _load()
    ctrl = np.ascontiguousarray(ctrl, dtype=np.float64)
    n = ctrl.shape[0]
    counts = np.empty(n, dtype=np.int64)
    cap = max(32 * n, 64)
    while True:
        out = np.empty((cap, 4), dtype=np.float64)
        total = lib.bezier_subdivide_batch(ctrl, n, float(eps), out, cap, counts)
        if total <= cap:
            return out[:total], counts
        cap = int(total)


def edge_spans(edges: np.ndarray, nonzero: bool, crossing_ext: int,
               clip_lo: int, clip_hi: int):
    """Native scanline sweep (raster/scanline._edge_spans semantics, same
    array order bit-for-bit).  Returns (rows, cov_s, cov_e, cross_rows,
    cross_s, cross_e) int64 arrays, or None when no rows survive the clip."""
    lib = _load()
    edges = np.ascontiguousarray(edges, dtype=np.int64)
    n = edges.shape[0]
    T = lib.edge_spans_count(edges, n, clip_lo, clip_hi)
    if T == 0:
        return None
    cov_rows = np.empty(T, dtype=np.int64)
    cov_s = np.empty(T, dtype=np.int64)
    cov_e = np.empty(T, dtype=np.int64)
    cross_rows = np.empty(2 * T, dtype=np.int64)
    cross_s = np.empty(2 * T, dtype=np.int64)
    cross_e = np.empty(2 * T, dtype=np.int64)
    counts = np.empty(2, dtype=np.int64)
    lib.edge_spans_fill(
        edges, n, 1 if nonzero else 0, int(crossing_ext),
        int(clip_lo), int(clip_hi),
        cov_rows, cov_s, cov_e, cross_rows, cross_s, cross_e, counts,
    )
    m = int(counts[1])
    return cov_rows, cov_s, cov_e, cross_rows[:m], cross_s[:m], cross_e[:m]


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _groups(ng, groups, out_r, out_s, out_e):
    return {
        int(groups[i, 0]): (
            out_r[groups[i, 1] : groups[i, 2]],
            out_s[groups[i, 1] : groups[i, 2]],
            out_e[groups[i, 1] : groups[i, 2]],
        )
        for i in range(int(ng[0]))
    }


def expand_1x_grouped(rows, ss, ee, nty: int, ntx: int, tile_h: int, tile_w: int):
    """Tile assignment of 1x pixel spans, grouped by tile (fused
    tile_raster._expand_1x + _group_slices; per-tile entry order matches
    NumPy's stable sort bit-for-bit).  Returns {tile: (r_rel, s_rel,
    e_rel)}."""
    lib = _load()
    rows, ss, ee = _as_i64(rows), _as_i64(ss), _as_i64(ee)
    T = rows.shape[0]
    total = lib.expand_1x_count(rows, ss, ee, T, nty, ntx, tile_h, tile_w) if T else 0
    if total == 0:
        return {}
    out_r, out_s, out_e = (np.empty(total, np.int64) for _ in range(3))
    groups = np.empty((nty * ntx, 3), np.int64)
    ng = np.empty(1, np.int64)
    lib.expand_1x_grouped(rows, ss, ee, T, nty, ntx, tile_h, tile_w, out_r, out_s, out_e, groups, ng)
    return _groups(ng, groups, out_r, out_s, out_e)


def expand_aa_grouped(rows, ss, ee, nty: int, ntx: int, hstep: int, wstep: int,
                      hpad: int, ttw: int, edge_tiles: np.ndarray):
    """Tile assignment of 16x AA spans to edge-tile t-plane windows,
    grouped by tile (fused tile_raster._expand_aa + _group_slices).
    Returns {tile: (r_rel, s_rel, e_rel)}."""
    lib = _load()
    rows, ss, ee = _as_i64(rows), _as_i64(ss), _as_i64(ee)
    et = np.ascontiguousarray(edge_tiles, dtype=np.uint8)
    T = rows.shape[0]
    total = lib.expand_aa_count(rows, ss, ee, T, nty, ntx, hstep, wstep, hpad, et) if T else 0
    if total == 0:
        return {}
    out_r, out_s, out_e = (np.empty(total, np.int64) for _ in range(3))
    groups = np.empty((nty * ntx, 3), np.int64)
    ng = np.empty(1, np.int64)
    lib.expand_aa_grouped(rows, ss, ee, T, nty, ntx, hstep, wstep, hpad, ttw, et,
                          out_r, out_s, out_e, groups, ng)
    return _groups(ng, groups, out_r, out_s, out_e)


def jbig2_generic_region(data: bytes, w: int, h: int, template: int, at, tpgdon: bool):
    """Native arithmetic generic-region decode (io/jbig2.py's hot loop) ->
    (h, w) uint8, or NotImplemented when the decoder refuses the data
    (the caller then runs the Python decoder, as the JAX package does)."""
    lib = _load()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    at_arr = np.asarray([c for p in at for c in p], dtype=np.int8)
    out = np.zeros((h, w), dtype=np.uint8)
    rc = lib.jbig2_generic_region(
        buf, buf.size, int(w), int(h), int(template),
        at_arr, len(at), 1 if tpgdon else 0, out,
    )
    if rc != 0:
        return NotImplemented
    return out


def brush_stroke_table(brushes: np.ndarray, strokes: np.ndarray) -> np.ndarray:
    """brush_stamp's stroke table (the C entry point says what it holds):
    `brushes` (s, bhb, bwb) C-contiguous int32; fills the extents and patch
    offsets of `strokes` ((s, words) C-contiguous int32) and returns the
    patches as int32 words.  Raises ValueError where a texel lies outside
    0..255."""
    if brushes.dtype != np.int32 or not brushes.flags.c_contiguous or strokes.dtype != np.int32 \
            or not strokes.flags.c_contiguous:
        raise ValueError("brush_stroke_table: need C-contiguous int32 brushes and strokes")
    s, bhb, bwb = brushes.shape
    patches = np.empty(s * -(-bhb * bwb // 16) * 16, np.uint8)
    used = _load().brush_stroke_table(brushes.ctypes.data, s, bhb, bwb, strokes.ctypes.data, strokes.shape[1],
                                      patches.ctypes.data)
    if used < 0:
        raise ValueError("brush_stamp: a brush texel lies outside 0..255")
    return patches[:used].view(np.int32)


def brush_strip_lists(corners: np.ndarray, valid: np.ndarray, points, strokes: np.ndarray, bhb: int, bwb: int,
                      meta, hp: int, wp: int, ranges: np.ndarray) -> tuple:
    """brush_stamp's lists (the C entry point says what each holds):
    `corners` (s, n, 2) int32 stamp corners, `valid` (s, n) bool, `points`
    (s, n, 2) int32 stamp points or None (plane mode), `strokes` (s, words)
    int32, `meta` (pieces, 3) int32 in piece mode, None in plane mode, every
    array C-contiguous.  Fills `ranges` ((blocks, 4) int32) and returns
    (stamp entries, point entries, None), int32, or (None, None, (stroke,
    stamp)) for the first valid stamp whose (bhb, bwb) patch leaves the
    plane."""
    lib = _load()
    s, n = corners.shape[:2]
    for a, dtype in ((corners, np.int32), (valid, np.bool_), (points, np.int32), (strokes, np.int32), (meta, np.int32),
                     (ranges, np.int32)):
        if a is not None and (a.dtype != dtype or not a.flags.c_contiguous):
            raise ValueError(f"brush_strip_lists: need C-contiguous {np.dtype(dtype)} arrays, got {a.dtype}")
    counts = np.zeros(2, np.int64)
    with _lock:  # the entries land in one buffer kept from call to call (fresh pages cost more than the lists)
        while True:
            entries = _brush_entries[0]
            total = lib.brush_strip_lists(corners.ctypes.data, valid.ctypes.data,
                                          None if points is None else points.ctypes.data, s, n, strokes.ctypes.data,
                                          strokes.shape[1], bhb, bwb, None if meta is None else meta.ctypes.data,
                                          0 if meta is None else len(meta), hp, wp, ranges.ctypes.data, len(ranges),
                                          counts.ctypes.data, entries.ctypes.data, entries.size)
            if total == -1:
                raise ValueError("brush_strip_lists: a block's stroke, a size or the ranges' rows are out of range")
            if total < -1:
                return None, None, divmod(-2 - int(total), n)
            if total <= entries.size:
                return entries[: counts[0]].copy(), entries[counts[0] : total].copy(), None
            _brush_entries[0] = np.empty(2 * int(total), np.int32)


_brush_entries = [np.empty(1 << 16, np.int32)]


def sprite_band_spans(fam, planes: np.ndarray) -> tuple:
    """sprite_raster's packed spans of one family of n members (the C
    entry point says how each is packed): `fam` n (rows, starts, ends)
    triples of inclusive spans, or None for none; `planes` (n, 4) int64,
    each member's plane (origin row, height, origin column, width).
    Returns (the uint64 spans on their plane's rows, member by member and
    16-row group by group, and the int64 index of each member's groups'
    first spans and their end: ceil(height / 16) + 1 entries a member).
    Raises ValueError where a triple's arrays differ in length."""
    n = len(fam)
    ptrs, counts, kept = np.zeros(3 * n, np.uint64), np.zeros(n, np.int64), []
    for m, sp in enumerate(fam):
        if sp is None:
            continue
        trip = [np.ascontiguousarray(a, np.int64) for a in sp]
        if not len(trip[0]) == len(trip[1]) == len(trip[2]):
            raise ValueError(f"sprite_band_spans: member {m}'s rows, starts and ends differ in length")
        kept.extend(trip)  # alive through the call
        counts[m] = len(trip[0])
        ptrs[3 * m : 3 * m + 3] = [a.ctypes.data for a in trip]
    planes = np.ascontiguousarray(planes, np.int64).reshape(n, 4)
    n_first = int(((planes[:, 1] + 15) // 16 + 1).sum())
    if not kept:  # no spans: every group's range is empty
        return np.zeros(0, np.uint64), np.zeros(n_first, np.int64)
    out = np.empty(int(counts.sum()), np.uint64)
    first = np.empty(n_first, np.int64)
    threads = min(SPRITE_PACK_THREADS, 1 + len(out) // SPRITE_PACK_SPANS_A_THREAD)
    packed = _load().sprite_band_spans(ptrs.ctypes.data, counts.ctypes.data, planes.ctypes.data, n, threads,
                                       out.ctypes.data, first.ctypes.data)
    return out[:packed], first


# sprite_band_spans' threads: at most SPRITE_PACK_THREADS, one a
# SPRITE_PACK_SPANS_A_THREAD spans (a thread's start costs as much as
# packing some ten thousand spans).
SPRITE_PACK_THREADS = 4
SPRITE_PACK_SPANS_A_THREAD = 1 << 17
