"""Shape primitives and path stroking (parity: reference ``shapes.ml``).

The port's copy of ``coherence_tpu.geometry.shapes``, whole: host code with
no device work.

Circle/rectangle/arc constructors from bezier quarters, and a PDF-1.5-style
stroker: offset "rails" for straight and flattened bezier segments, joins
(bevel / round / mitre with limit), caps (butt / round / projecting), and the
degenerate-path → dot-circle rule.  Stroked outlines render with the even-odd
rule (``shapes.ml:505-516``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .. import transform as tr
from .path import (
    EVEN_ODD,
    NONZERO,
    Bezier,
    Path,
    Straight,
    Subpath,
    bezier_epsilon,
    bezier_split,
    bezier_subdivide,
    bounds_polygon,
    curve_accuracy,
    edgelist_of_path,
)

Point = Tuple[float, float]

# Bezier quarter-circle control-length factor (shapes.ml:13).
kappa = ((math.sqrt(2.0) - 1.0) / 3.0) * 4.0

_pi = math.pi

# --- small vector helpers (camlpdf Pdfutil geometry section) ---------------


def _mkvector(a: Point, b: Point) -> Point:
    return (b[0] - a[0], b[1] - a[1])


def _invert(v: Point) -> Point:
    return (-v[0], -v[1])


def _offset_point(v: Point, p: Point) -> Point:
    return (p[0] + v[0], p[1] + v[1])


def _veclength(v: Point) -> float:
    return math.hypot(v[0], v[1])


def _scalevectolength(l: float, v: Point) -> Point:
    cur = _veclength(v)
    if cur == 0.0:
        return v
    f = l / cur
    return (v[0] * f, v[1] * f)


def _mkunitvector(a: Point, b: Point) -> Point:
    return _scalevectolength(1.0, _mkvector(a, b))


def _between(a: Point, b: Point) -> Point:
    return ((a[0] + b[0]) / 2.0, (a[1] + b[1]) / 2.0)


def _distance_between(a: Point, b: Point) -> float:
    return _veclength(_mkvector(a, b))


def _perpendicular(v: Point) -> Point:
    return (-v[1], v[0])


def _couple(f, l):
    return [f(l[k], l[k + 1]) for k in range(len(l) - 1)]


def _pair_reduce(f, l):
    """Balanced pairwise reduction (Pdfutil.pair_reduce)."""
    if not l:
        raise ValueError("pair_reduce: empty")
    while len(l) > 1:
        nxt = [f(l[k], l[k + 1]) for k in range(0, len(l) - 1, 2)]
        if len(l) % 2 == 1:
            nxt.append(l[-1])
        l = nxt
    return l[0]


# ---------------------------------------------------------------------------
# Angles (shapes.ml:17-37)
# ---------------------------------------------------------------------------


def rotation(c: Point, p: Point, p2: Point) -> float:
    """Signed shorter-arc rotation from p to p2 about c (shapes.ml:17-22)."""
    px, py = p[0] - c[0], p[1] - c[1]
    qx, qy = p2[0] - c[0], p2[1] - c[1]
    return math.atan2(px * qy - py * qx, px * qx + py * qy)


def angle_to(c: Point, p: Point) -> float:
    """Absolute angle to p from centre c, in [0, 2pi) (shapes.ml:27-29)."""
    r = math.atan2(p[1] - c[1], p[0] - c[0])
    return r + 2.0 * _pi if r < 0.0 else r


def restrict_angle(s: float, a: float) -> float:
    """Restrict angle a to a multiple of s (shapes.ml:34-37)."""
    p = math.fmod(math.floor(a / s) * s, 2.0 * _pi)
    p2 = math.fmod(p + s, 2.0 * _pi)
    return p if abs(p - a) < abs(p2 - a) else p2


# ---------------------------------------------------------------------------
# Useful shapes (shapes.ml:41-147)
# ---------------------------------------------------------------------------


def quarter(s: float, c: Point, r: float) -> Bezier:
    """Quarter circle from angle s to s + pi/2 about c (shapes.ml:45-57)."""
    std = [(1.0, 0.0), (1.0, kappa), (kappa, 1.0), (0.0, 1.0)]
    t = [
        tr.Translate(c[0], c[1]),
        tr.Scale((0.0, 0.0), r, r),
        tr.Rotate((0.0, 0.0), s),
    ]
    p, q, r_, s_ = [tr.transform(t, pt) for pt in std]
    return Bezier(p, q, r_, s_)


def quarter_anticlockwise(s: float, c: Point, r: float) -> Bezier:
    b = quarter(s, c, r)
    return Bezier(b.p4, b.p3, b.p2, b.p1)


def joinsegs(segments: List[Bezier]) -> List[Bezier]:
    """Fix float misalignment between consecutive beziers (shapes.ml:71-77)."""
    out: List[Bezier] = []
    for seg in segments:
        if out:
            prev = out[-1]
            seg = Bezier(prev.p4, seg.p2, seg.p3, seg.p4)
        out.append(seg)
    return out


def joinsegs_ends(p1: Point, p2: Point, segments: List[Bezier]) -> List[Bezier]:
    """joinsegs, then pin start/end points to p1/p2 (shapes.ml:81-89)."""
    segs = joinsegs(segments)
    if not segs:
        return []
    if len(segs) == 1:
        s = segs[0]
        return [Bezier(p1, s.p2, s.p3, p2)]
    first, last = segs[0], segs[-1]
    return (
        [Bezier(p1, first.p2, first.p3, first.p4)]
        + segs[1:-1]
        + [Bezier(last.p1, last.p2, last.p3, p2)]
    )


def arc(p1: Point, p2: Point, c: Point) -> List[Bezier]:
    """Shorter bezier arc from p1 to p2 about c (shapes.ml:96-127)."""
    ninety = _pi / 2.0
    angletogo = rotation(c, p1, p2)
    abs_angle = angle_to(c, p1)
    r = _distance_between(p1, c)
    if angletogo > 0.0:
        q, ninety_abs = quarter, ninety
    else:
        q, ninety_abs = quarter_anticlockwise, -ninety
    segments: List[Bezier] = []
    togo = abs(angletogo)
    while togo > 0.0:
        if togo >= ninety:
            togo -= ninety
            segments.append(q(abs_angle, c, r))
            abs_angle = math.fmod(abs_angle + ninety_abs, 2.0 * _pi)
        else:
            portion_needed = togo / ninety
            portion, _ = bezier_split(portion_needed, q(abs_angle, c, r))
            segments.append(portion)
            togo = 0.0
    return joinsegs_ends(p1, p2, segments)


def circle(x: float, y: float, r: float) -> Path:
    """Circle from four bezier quarters (shapes.ml:130-138)."""
    segs = joinsegs(
        [
            quarter(0.0, (x, y), r),
            quarter(_pi / 2.0, (x, y), r),
            quarter(_pi, (x, y), r),
            quarter(3.0 * _pi / 2.0, (x, y), r),
        ]
    )
    return Path(NONZERO, (Subpath(False, True, tuple(segs)),))


def rectangle(x: float, y: float, w: float, h: float) -> Path:
    """Axis-aligned rectangle path (shapes.ml:140-147)."""
    return Path(
        EVEN_ODD,
        (
            Subpath(
                False,
                True,
                (
                    Straight((x, y), (x + w, y)),
                    Straight((x + w, y), (x + w, y + h)),
                    Straight((x + w, y + h), (x, y + h)),
                    Straight((x, y + h), (x, y)),
                ),
            ),
        ),
    )


# ---------------------------------------------------------------------------
# Stroking (shapes.ml:149-540)
# ---------------------------------------------------------------------------

ButtCap = "butt"
RoundCap = "round"
ProjectingCap = "projecting"

RoundJoin = "roundjoin"
MitredJoin = "mitredjoin"
BevelJoin = "beveljoin"


@dataclass(frozen=True)
class StrokeSpec:
    """Stroke specification (shapes.ml:172-177)."""

    startcap: str = ButtCap
    join: str = MitredJoin
    endcap: str = ButtCap
    mitrelimit: float = 10.0
    linewidth: float = 1.0


def mkcap(captype: str, p1: Point, p2: Point, width: float, perp: Point):
    """Cap segments from p1 to p2 (shapes.ml:203-225)."""
    if captype == ButtCap:
        return [Straight(p1, p2)]
    if captype == ProjectingCap:
        half = _scalevectolength(width / 2.0, perp)
        p = _offset_point(half, p1)
        q = _offset_point(half, p2)
        return _couple(lambda a, b: Straight(a, b), [p1, p, q, p2])
    # RoundCap
    radius = width / 2.0
    midpoint = _between(p1, p2)
    perpscaled = _scalevectolength(radius, perp)
    centrearc = _offset_point(perpscaled, midpoint)
    control_length = radius * kappa
    lvector = _scalevectolength(control_length, perp)
    cleft = _scalevectolength(control_length, _mkvector(p2, p1))
    cright = _scalevectolength(control_length, _mkvector(p1, p2))
    p1_up = _offset_point(lvector, p1)
    p2_up = _offset_point(lvector, p2)
    c_left = _offset_point(cleft, centrearc)
    c_right = _offset_point(cright, centrearc)
    return [Bezier(p1, p1_up, c_left, centrearc), Bezier(centrearc, c_right, p2_up, p2)]


def _reverserail(rail):
    """Reverse a rail (shapes.ml:241-247)."""
    out = []
    for seg in reversed(rail):
        if isinstance(seg, Straight):
            out.append(Straight(seg.b, seg.a))
        else:
            out.append(Bezier(seg.p4, seg.p3, seg.p2, seg.p1))
    return out


def capsegment(spec: StrokeSpec, r, r2):
    """Cap an open pair of rails into a closed outline (shapes.ml:252-279)."""
    if not r or not r2:
        raise ValueError("capsegment: empty rail")
    s, m = r[0].a, r[0].b
    n, e = r[-1].a, r[-1].b
    p1, p4 = s, e
    v = _mkunitvector(m, s)
    v2 = _mkunitvector(n, e)
    p2, p3 = r2[0].a, r2[-1].b
    start_segments = mkcap(spec.startcap, p1, p2, spec.linewidth, v)
    end_segments = mkcap(spec.endcap, p3, p4, spec.linewidth, v2)
    return start_segments + r2 + end_segments + _reverserail(r)


def _fdiv(a: float, b: float) -> float:
    """IEEE float division, as OCaml's ``/.``: x/0 = ±inf, 0/0 = nan.
    Python raises ZeroDivisionError instead, which the stroker must not do
    — parallel/degenerate rails (e.g. a path reversing along itself) hit
    these divisions and rely on the inf/nan propagating into the
    mitre-limit and on-line checks, which then reject the crosspoint
    exactly as the reference does (shapes.ml:284-304, 344-403)."""
    if b == 0.0:
        if a == 0.0 or a != a:
            return math.nan
        return math.inf if (a > 0.0) == (math.copysign(1.0, b) > 0.0) else -math.inf
    return a / b


def crosspoint(p1: Point, v1: Point, p2: Point, v2: Point) -> Point:
    """Intersection of two point+vector lines (shapes.ml:284-304)."""
    px, py = p1
    vx, vy = v1
    px2, py2 = p2
    vx2, vy2 = v2
    if vy == 0.0 and vx2 == 0.0:
        return (px2, py)
    if vx == 0.0 and vy2 == 0.0:
        return (px, py2)
    if vx2 == 0.0:
        return (px2, _fdiv(vy, vx) * (px2 - px) + py)
    if vx == 0.0:
        return (px, _fdiv(vy2, vx2) * (px - px2) + py2)
    if vy2 == 0.0:
        return (_fdiv(py2 - py, _fdiv(vy, vx)) + px, py2)
    if vy == 0.0:
        return (_fdiv(py - py2, _fdiv(vy2, vx2)) + px2, py)
    m = _fdiv(vy, vx)
    m2 = _fdiv(vy2, vx2)
    c = py + (-px * m)
    c2 = py2 + (-px2 * m2)
    p = _fdiv(m, m2)
    c3 = c2 * p
    ycoeff = 1.0 - p
    y = _fdiv(c - c3, ycoeff)
    x = _fdiv(c - y, -m)
    return (x, y)


def crosspoint_lines(l1: Tuple[Point, Point], l2: Tuple[Point, Point]) -> Point:
    (a, b), (c, d) = l1, l2
    return crosspoint(a, _mkvector(a, b), c, _mkvector(c, d))


def _point_possibly_on_lines(l1, l2, pt) -> bool:
    """Bounding-box membership on either line (shapes.ml:312-318)."""
    (a, b), (c, d) = l1
    (a2, b2), (c2, d2) = l2
    x, y = pt
    on1 = min(a, c) <= x <= max(a, c) and min(b, d) <= y <= max(b, d)
    on2 = min(a2, c2) <= x <= max(a2, c2) and min(b2, d2) <= y <= max(b2, d2)
    return on1 or on2


def mkjoin(spec: StrokeSpec, c: Point, p1: Point, p2: Point, v1: Point, v2: Point):
    """Join from p1 to p2 about centre c (shapes.ml:323-335)."""
    if spec.join == BevelJoin:
        return [Straight(p1, p2)]
    if spec.join == RoundJoin:
        return arc(p1, p2, c)
    # MitredJoin
    angle_between = abs(rotation(c, p1, p2))
    phi = 2.0 * math.asin(1.0 / spec.mitrelimit)
    if angle_between < phi:
        return mkjoin(
            StrokeSpec(spec.startcap, BevelJoin, spec.endcap, spec.mitrelimit, spec.linewidth),
            c, p1, p2, v1, v2,
        )
    cp = crosspoint(p1, v1, p2, v2)
    return _couple(lambda a, b: Straight(a, b), [p1, cp, p2])


def joinsegments(spec: StrokeSpec, rails1, rails2):
    """Join two rail pairs (shapes.ml:344-403)."""
    s1, s2 = rails1
    s1p, s2p = rails2
    if not s1 and not s2 and not s1p and not s2p:
        raise ValueError("joinsegments: both sections empty")
    if (not s1 and not s2) or (not s1p and not s2p):
        raise ValueError("joinsegments: empty section")
    left = (s1[:-1], s2[:-1])
    left_middle = (s1[-1], s2[-1])
    right_middle = (s1p[0], s2p[0])
    right = (s1p[1:], s2p[1:])
    ab, cd = left_middle
    a2b2, c2d2 = right_middle
    if not (isinstance(ab, Straight) and isinstance(cd, Straight)):
        raise ValueError("joinsegments: not implemented")
    if not (isinstance(a2b2, Straight) and isinstance(c2d2, Straight)):
        raise ValueError("joinsegments: not implemented")
    a, b, c, d = ab.a, ab.b, cd.a, cd.b
    a2, b2, c2, d2 = a2b2.a, a2b2.b, c2d2.a, c2d2.b
    lr_cross = crosspoint_lines((a, b), (a2, b2))
    l2r2_cross = crosspoint_lines((c, d), (c2, d2))
    on_first = _point_possibly_on_lines((a, b), (a2, b2), lr_cross)
    on_second = _point_possibly_on_lines((c, d), (c2, d2), l2r2_cross)
    if on_first == on_second:
        # Already joined (angle pi), or path goes back on itself.
        middlerail = Straight(a, b2)
        middlerail2 = Straight(c, d2)
        return (
            left[0] + [middlerail] + right[0],
            left[1] + [middlerail2] + right[1],
        )
    if not on_first:
        # Join on the first rail (shapes.ml:380-391).
        centre = _between(b, d)
        vl = _mkunitvector(a, b)
        vr = _mkunitvector(b2, a2)
        join = mkjoin(spec, centre, b, a2, vl, vr)
        cross = [Straight(c, l2r2_cross), Straight(l2r2_cross, d2)]
        return (
            left[0] + [left_middle[0]] + join + [right_middle[0]] + right[0],
            left[1] + cross + right[1],
        )
    # Join on the second rail (shapes.ml:392-403).
    centre = _between(b, d)
    vl = _mkunitvector(c, d)
    vr = _mkunitvector(d2, c2)
    join = mkjoin(spec, centre, d, c2, vl, vr)
    cross = [Straight(a, lr_cross), Straight(lr_cross, b2)]
    return (
        left[0] + cross + right[0],
        left[1] + [left_middle[1]] + join + [right_middle[1]] + right[1],
    )


def straight(s: Point, e: Point, width: float):
    """Rails of a stroked straight segment (shapes.ml:407-415)."""
    offset = _perpendicular(_mkvector(s, e))
    so = _scalevectolength(width / 2.0, offset)
    so2 = _invert(so)
    a = _offset_point(so, s)
    b = _offset_point(so2, s)
    c = _offset_point(so2, e)
    d = _offset_point(so, e)
    return [Straight(a, d)], [Straight(b, c)]


def bezier_rails(p1: Point, p2: Point, p3: Point, p4: Point, width: float):
    """Rails of a stroked (non-degenerate) bezier (shapes.ml:418-450)."""
    subdivided = bezier_subdivide(bezier_epsilon(curve_accuracy), p1, p2, p3, p4)
    points = [a for a, _ in subdivided] + [subdivided[-1][1]]
    edges = _couple(lambda s, e: _mkvector(s, e), points)
    midedge_offsets = [_perpendicular(e) for e in edges]
    point_offsets = _couple(_between, midedge_offsets)
    offs = [midedge_offsets[0]] + point_offsets + [midedge_offsets[-1]]
    offs = [_scalevectolength(width / 2.0, o) for o in offs]
    offs2 = [_invert(o) for o in offs]
    offset_points = [_offset_point(o, p) for o, p in zip(offs, points)]
    offset2_points = [_offset_point(o, p) for o, p in zip(offs2, points)]
    mkrail = lambda pts: _couple(lambda a, b: Straight(a, b), pts)
    return mkrail(offset_points), mkrail(offset2_points)


def strokesubpath(spec: StrokeSpec, segments):
    """Stroke one subpath into a closed outline (shapes.ml:453-460)."""
    rails = []
    for seg in segments:
        if isinstance(seg, Straight):
            rails.append(straight(seg.a, seg.b, spec.linewidth))
        else:
            rails.append(bezier_rails(seg.p1, seg.p2, seg.p3, seg.p4, spec.linewidth))
    joined = _pair_reduce(lambda x, y: joinsegments(spec, x, y), rails)
    return capsegment(spec, joined[0], joined[1])


def _degenerate(subpaths):
    """Degenerate single-point path check (shapes.ml:479-484)."""
    if len(subpaths) == 1:
        segs = subpaths[0].segments
        if len(segs) == 1:
            s = segs[0]
            if isinstance(s, Straight) and s.a == s.b:
                return s.a
            if isinstance(s, Bezier) and s.p1 == s.p2 == s.p3 == s.p4:
                return s.p1
    return None


def _segment_ok(seg) -> bool:
    if isinstance(seg, Straight):
        return seg.a != seg.b
    return not (seg.p1 == seg.p2 or seg.p3 == seg.p4)


def _clean_path(subpaths):
    out = []
    for sp in subpaths:
        segs = tuple(s for s in sp.segments if _segment_ok(s))
        if segs:
            out.append(Subpath(sp.hole, sp.closed, segs))
    return out


def strokepath_polygon(spec: StrokeSpec, path: Path) -> Path:
    """Stroke a path to an outline path (shapes.ml:505-512)."""
    degen = _degenerate(path.subpaths)
    if degen is not None and spec.startcap == RoundCap and spec.endcap == RoundCap:
        return circle(degen[0], degen[1], spec.linewidth / 2.0)
    subpaths = _clean_path(path.subpaths)
    stroked = [
        Subpath(False, True, tuple(strokesubpath(spec, sp.segments))) for sp in subpaths
    ]
    return Path(EVEN_ODD, tuple(stroked))


def strokepath(spec: StrokeSpec, path: Path) -> np.ndarray:
    """Stroke a path to a subbin edge list (shapes.ml:515-516).

    The result renders with the even-odd rule.
    """
    return edgelist_of_path(strokepath_polygon(spec, path))


def bounds_stroke(path: Path, spec: StrokeSpec) -> Tuple[int, int, int, int]:
    """Integer bounds of a stroke (shapes.ml:522-540)."""
    if spec.startcap == ProjectingCap or spec.endcap == ProjectingCap:
        oversize = spec.linewidth
    else:
        oversize = spec.linewidth / 2.0
    if spec.join == MitredJoin:
        oversize = max(oversize, spec.mitrelimit * spec.linewidth)
    oi = int(math.ceil(oversize))
    minx, maxx, miny, maxy = bounds_polygon(path)
    return minx - oi, maxx + oi, miny - oi, maxy + oi
