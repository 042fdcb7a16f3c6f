"""Dash-pattern path splitting (PDF 8.4.3.6 line dash pattern).

The port's copy of ``coherence_tpu.geometry.dash``, whole: host code.

BEYOND REFERENCE: the reference captures ``path_dash`` into its graphic
tree (pdfgraphics.mli:93) but nothing consumes it — dashed strokes render
solid.  Here ``dash_path`` splits a path into the pattern's "on" intervals
as open subpaths BEFORE stroking, so each dash gets the stroke's caps,
exactly how contemporary rasterizers implement dashing.

Curves flatten to chords at the renderer's standard flatness
(``curve_accuracy``, polygon.ml:19) for arc-length walking — dash pieces
are short, so chord-level splitting is visually exact at stroke widths.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from .path import (
    Path,
    Point,
    Straight,
    Subpath,
    bezier_subdivide,
    f_accuracy,
)

__all__ = ["dash_path"]


def _chords(sub: Subpath) -> List[Tuple[Point, Point]]:
    out: List[Tuple[Point, Point]] = []
    for seg in sub.segments:
        if isinstance(seg, Straight):
            out.append((seg.a, seg.b))
        else:
            out.extend(bezier_subdivide(f_accuracy, seg.p1, seg.p2, seg.p3, seg.p4))
    # No implicit closing chord: in this codebase `closed` is the FILL
    # convention (every PDF-read subpath is closed=True) and closing edges
    # are explicit segments (`h` appends one, pdfgraphics.py closepath);
    # the stroker likewise never strokes an implicit closure.
    return out


def dash_path(path: Path, dashes: Sequence[float], phase: float = 0.0) -> Path:
    """The subset of `path` covered by the dash pattern's "on" intervals,
    as open subpaths ready for stroking.  A degenerate pattern (empty, all
    zeros, or any negative) returns the path unchanged (solid), per the
    PDF error rule."""
    ds = [float(v) for v in dashes]
    if not ds or any(v < 0.0 for v in ds) or sum(ds) <= 0.0:
        return path
    n = len(ds)
    out_subs: List[Subpath] = []
    for sub in path.subpaths:
        chords = _chords(sub)
        if not chords:
            continue
        # Pattern state from the phase: index + remaining length.  `down`
        # is tracked explicitly — for ODD-length arrays the on/off state
        # flips on the second pass through the array (PDF 8.4.3.6), so
        # idx parity alone is wrong there; the cycle is 2*sum(ds).
        idx = 0
        rem = ds[0]
        down = True
        left = float(phase) % (sum(ds) * (2 if n % 2 else 1))
        while left > 1e-12:
            if rem <= 1e-12:  # zero-length entries toggle without consuming
                idx = (idx + 1) % n
                rem = ds[idx]
                down = not down
                continue
            step = min(left, rem)
            rem -= step
            left -= step
        run: List[Point] = []

        def flush():
            nonlocal run
            if len(run) >= 2:
                segs = tuple(
                    Straight(run[i], run[i + 1])
                    for i in range(len(run) - 1)
                    if run[i] != run[i + 1]
                )
                if segs:
                    out_subs.append(Subpath(False, False, segs))
            run = []

        for a, b in chords:
            seg_len = math.hypot(b[0] - a[0], b[1] - a[1])
            if seg_len <= 0.0:
                continue
            t = 0.0
            while t < seg_len:
                step = min(rem, seg_len - t)
                t0, t1 = t / seg_len, (t + step) / seg_len
                p0 = (a[0] + (b[0] - a[0]) * t0, a[1] + (b[1] - a[1]) * t0)
                p1 = (a[0] + (b[0] - a[0]) * t1, a[1] + (b[1] - a[1]) * t1)
                if down:
                    if not run:
                        run = [p0]
                    run.append(p1)
                t += step
                rem -= step
                if rem <= 1e-12:
                    if down:
                        flush()
                    down = not down
                    idx = (idx + 1) % n
                    rem = ds[idx]
        flush()
    if not out_subs:
        # Fully "off": an empty path would rasterize nothing — return a
        # degenerate empty-subpath path so the stroker draws nothing.
        return Path(path.winding, ())
    return Path(path.winding, tuple(out_subs))
