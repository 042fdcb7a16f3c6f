"""Paths, bezier subdivision and edge lists (parity: reference ``polygon.ml``
and the path types of ``pdfgraphics.mli:9-29``).

The port's copy of ``coherence_tpu.geometry.path``, trimmed to what the
port uses.  Edge lists always come from the port's native library
(``native_lib.bezier_subdivide_batch``), whose chords are bit-identical to
``bezier_subdivide`` below.

A *path* is ``Path(windingrule, [Subpath(hole, closed, [segments])])``.
Segments are ``Straight(a, b)`` or ``Bezier(p1, p2, p3, p4)`` over float
points.  Edge lists are numpy ``(N, 4)`` int64 arrays of subpixel-bin
coordinates ``[x0, y0, x1, y1]`` (``polygon.ml:79``), where (x0, y0) is the
minimum-y end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .. import coord, native_lib
from .. import transform as tr

# Winding rules (pdfgraphics.mli).
EVEN_ODD = "evenodd"
NONZERO = "nonzero"

Point = Tuple[float, float]

# De Casteljau subdivision accuracy; lower is more accurate (polygon.ml:19).
curve_accuracy = 0.2


@dataclass(frozen=True)
class Straight:
    a: Point
    b: Point


@dataclass(frozen=True)
class Bezier:
    p1: Point
    p2: Point
    p3: Point
    p4: Point


Segment = object  # Straight | Bezier


@dataclass(frozen=True)
class Subpath:
    hole: bool
    closed: bool
    segments: Tuple[Segment, ...]

    def __iter__(self):  # destructuring convenience
        return iter((self.hole, self.closed, self.segments))


@dataclass(frozen=True)
class Path:
    winding: str
    subpaths: Tuple[Subpath, ...]

    def __iter__(self):
        return iter((self.winding, self.subpaths))


def mkpath(winding: str, subpaths) -> Path:
    return Path(
        winding,
        tuple(
            sp
            if isinstance(sp, Subpath)
            else Subpath(bool(sp[0]), bool(sp[1]), tuple(sp[2]))
            for sp in subpaths
        ),
    )


# ---------------------------------------------------------------------------
# Transforming paths (polygon.ml:51-64)
# ---------------------------------------------------------------------------


def transform_segment(matrix: tr.Matrix, seg):
    f = lambda p: tr.transform_matrix(matrix, p)
    if isinstance(seg, Straight):
        return Straight(f(seg.a), f(seg.b))
    return Bezier(f(seg.p1), f(seg.p2), f(seg.p3), f(seg.p4))


def transform_path(t, path: Path) -> Path:
    matrix = tr.matrix_of_transform(t)
    return Path(
        path.winding,
        tuple(
            Subpath(sp.hole, sp.closed, tuple(transform_segment(matrix, s) for s in sp.segments))
            for sp in path.subpaths
        ),
    )


def path_of_pointlist(winding: str, points: Sequence[Point]) -> Path:
    """Closed path of straight segments through points (polygon.ml:68-76)."""
    if len(points) < 2:
        raise ValueError("path_of_pointlist: not enough points")
    pts = list(points) + [points[0]]
    segs = tuple(Straight(pts[k], pts[k + 1]) for k in range(len(pts) - 1))
    return Path(winding, (Subpath(False, True, segs),))


# ---------------------------------------------------------------------------
# Bezier subdivision (polygon.ml:83-141)
# ---------------------------------------------------------------------------


def _distance_point_from_line(c: Point, a: Point, b: Point) -> float:
    # polygon.ml:83-89
    ax, ay = a
    bx, by = b
    cx, cy = c
    l = math.sqrt((bx - ax) ** 2 + (by - ay) ** 2)
    if l == 0.0 or not math.isfinite(l):
        return float("nan")
    s = ((ay - cy) * (bx - ax) - (ax - cx) * (by - ay)) / (l * l)
    return abs(s) * l


def bezier_epsilon(epsilon: float):
    """Flatness predicate factory (polygon.ml:107-116).

    Matches the reference's float classification: degenerate (nan/inf/zero/
    subnormal) distances count as flat.
    """

    def flat(p1, p2, p3, p4) -> bool:
        d1 = _distance_point_from_line(p2, p1, p4)
        d2 = _distance_point_from_line(p3, p1, p4)

        def normal(d):
            return math.isfinite(d) and d != 0.0 and abs(d) >= 2.2250738585072014e-308

        if normal(d1) and normal(d2):
            return d1 < epsilon and d2 < epsilon
        return True

    return flat


f_accuracy = bezier_epsilon(curve_accuracy)


def _mid(p, q):
    return ((p[0] + q[0]) / 2.0, (p[1] + q[1]) / 2.0)


def bezier_subdivide(flat, p1, p2, p3, p4) -> List[Tuple[Point, Point]]:
    """De Casteljau subdivision to chords, in order (polygon.ml:119-127)."""
    out: List[Tuple[Point, Point]] = []
    stack = [(p1, p2, p3, p4)]
    # Iterative DFS preserving left-to-right order.
    while stack:
        a, b, c, d = stack.pop()
        if flat(a, b, c, d):
            out.append((a, d))
        else:
            l2, h = _mid(a, b), _mid(b, c)
            l3, r3 = _mid(l2, h), _mid(c, d)
            r2 = _mid(h, r3)
            l4 = _mid(l3, r2)
            stack.append((l4, r2, r3, d))  # right pushed first → left popped first
            stack.append((a, l2, l3, l4))
    return out


def _partway(t: float, a: Point, b: Point) -> Point:
    if not 0.0 <= t <= 1.0:
        raise ValueError(f"_partway: proportion {t} outside [0, 1]")
    t2 = 1.0 - t
    return (t2 * a[0] + t * b[0], t2 * a[1] + t * b[1])


def bezier_split(t: float, seg: Bezier) -> Tuple[Bezier, Bezier]:
    """Split a bezier at proportion t (polygon.ml:131-141)."""
    if not isinstance(seg, Bezier):
        raise ValueError("bezier_split: unrecognised segment")
    d = lambda a, b: _partway(t, a, b)
    l2, h = d(seg.p1, seg.p2), d(seg.p2, seg.p3)
    l3, r3 = d(l2, h), d(seg.p3, seg.p4)
    r2 = d(h, r3)
    l4 = d(l3, r2)
    return Bezier(seg.p1, l2, l3, l4), Bezier(l4, r2, r3, seg.p4)


# ---------------------------------------------------------------------------
# Points equally spaced on a path (polygon.ml:144-218)
# ---------------------------------------------------------------------------


def _straightlength(p1: Point, p2: Point) -> float:
    return math.hypot(p2[0] - p1[0], p2[1] - p1[1])


def points_on_subpath(sep: float, segments) -> List[Point]:
    """Points at separation `sep` along a subpath (polygon.ml:190-212).

    Beziers are flattened to straight segments first; then we repeatedly walk
    `sep` along the straight pieces, emitting a point each time.  Mirrors the
    reference exactly, including its (reversed-accumulator) segment order.
    """
    straights: List[Tuple[Point, Point]] = []
    for seg in segments:
        if isinstance(seg, Straight):
            straights.insert(0, (seg.a, seg.b))
        else:
            edges = bezier_subdivide(f_accuracy, seg.p1, seg.p2, seg.p3, seg.p4)
            straights = edges + straights
    points: List[Point] = []
    work = straights
    while work:
        # takelength: walk sep along the remaining segments (polygon.ml:173-184)
        remaining = sep
        while work:
            p1, p2 = work[0]
            l = _straightlength(p1, p2)
            if remaining <= l:
                if l <= 0.0:
                    raise ValueError("points_on_subpath: zero-length segment")
                prop = remaining / l
                p = (
                    p1[0] * (1.0 - prop) + p2[0] * prop,
                    p1[1] * (1.0 - prop) + p2[1] * prop,
                )
                if p == p2:
                    work = work[1:]
                else:
                    work = [(p, p2)] + work[1:]
                points.append(p)
                break
            remaining -= l
            work = work[1:]
    return points


def points_on_path(sep: float, path: Path) -> List[Point]:
    """All points at separation `sep` on a path (polygon.ml:215-218)."""
    out: List[Point] = []
    for sp in path.subpaths:
        out.extend(points_on_subpath(sep, sp.segments))
    return out


# ---------------------------------------------------------------------------
# Edge lists (polygon.ml:220-304)
# ---------------------------------------------------------------------------


def edgelist_from_subpath_float(sp: Subpath) -> List[Tuple[Point, Point]]:
    """Float chord list of a subpath; holes ignored (polygon.ml:222-228)."""
    out: List[Tuple[Point, Point]] = []
    for seg in sp.segments:
        if isinstance(seg, Straight):
            out.append((seg.a, seg.b))
        else:
            out.extend(bezier_subdivide(f_accuracy, seg.p1, seg.p2, seg.p3, seg.p4))
    return out


def path_proper_bounds(path: Path) -> Tuple[float, float, float, float]:
    """Float bounding rect (xmin, xmax, ymin, ymax) (polygon.ml:290-304)."""
    xs: List[float] = []
    ys: List[float] = []
    for sp in path.subpaths:
        for a, b in edgelist_from_subpath_float(sp):
            xs += [a[0], b[0]]
            ys += [a[1], b[1]]
    if not xs:
        raise ValueError("path_proper_bounds: zero edges")
    return min(xs), max(xs), min(ys), max(ys)


def _chords(segs) -> np.ndarray:
    """(N, 4) float64 chords [ax ay bx by] of an ordered segment list:
    straights as they are, beziers through the native batch subdivider."""
    beziers = [s for s in segs if not isinstance(s, Straight)]
    ctrl = np.empty((len(beziers), 8), dtype=np.float64)
    for j, s in enumerate(beziers):
        ctrl[j] = (*s.p1, *s.p2, *s.p3, *s.p4)
    chords, counts = native_lib.bezier_subdivide_batch(ctrl, curve_accuracy)
    pieces: List[np.ndarray] = []
    straight_buf: List[Tuple[float, float, float, float]] = []
    off = 0
    cur = 0
    for s in segs:
        if isinstance(s, Straight):
            straight_buf.append((s.a[0], s.a[1], s.b[0], s.b[1]))
        else:
            if straight_buf:
                pieces.append(np.array(straight_buf, dtype=np.float64))
                straight_buf = []
            c = int(counts[cur])
            pieces.append(chords[off : off + c])
            off += c
            cur += 1
    if straight_buf:
        pieces.append(np.array(straight_buf, dtype=np.float64))
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)


def edgelist_of_path(path: Path) -> np.ndarray:
    """All subpaths combined into one subbin edge list (polygon.ml:284-287)."""
    segs = [s for sp in path.subpaths for s in sp.segments]
    if not segs:
        return np.zeros((0, 4), dtype=np.int64)
    return coord.sub_of_float_np(_chords(segs))


def bounds_polygon(path: Path) -> Tuple[int, int, int, int]:
    """Integer pixel bounding box (minx, maxx, miny, maxy) (polygon.ml:405-440).

    Straight segments bound exactly; beziers are subdivided at flatness 1 and
    the resulting bounds expanded by 1 pixel in each direction.
    """
    if not path.subpaths:
        raise ValueError("bounds_polygon: malformed (empty) path")
    minx = miny = np.iinfo(np.int64).max
    maxx = maxy = np.iinfo(np.int64).min
    flat1 = bezier_epsilon(1.0)
    f = coord.pix_of_float
    for sp in path.subpaths:
        for seg in sp.segments:
            if isinstance(seg, Straight):
                for (x, y) in (seg.a, seg.b):
                    px, py = f(x), f(y)
                    minx, maxx = min(minx, px), max(maxx, px)
                    miny, maxy = min(miny, py), max(maxy, py)
            else:
                bxmin = bymin = np.iinfo(np.int64).max
                bxmax = bymax = np.iinfo(np.int64).min
                for a, b in bezier_subdivide(flat1, seg.p1, seg.p2, seg.p3, seg.p4):
                    for (x, y) in (a, b):
                        px, py = f(x), f(y)
                        bxmin, bxmax = min(bxmin, px), max(bxmax, px)
                        bymin, bymax = min(bymin, py), max(bymax, py)
                minx, maxx = min(minx, bxmin - 1), max(maxx, bxmax + 1)
                miny, maxy = min(miny, bymin - 1), max(maxy, bymax + 1)
    return int(minx), int(maxx), int(miny), int(maxy)
