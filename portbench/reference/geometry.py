"""Transforms, paths, bezier flattening and subbin edge lists, in plain Python
and NumPy: the reference's own copy of the renderer's geometry.

Frozen from coherence_tpu_torch/transform.py:62-137 (matrices of transform
lists, first element outermost), coherence_tpu_torch/geometry/path.py:135-309
(the flatness test, De Casteljau subdivision, points spaced along a path,
integer bounds of straight segments) and coherence_tpu_torch/coord.py:24-53
(32 subpixel bins per pixel), with coherence_tpu_torch/geometry/shapes.py:40,
158-231 (bezier circle quarters, rectangles).  The program subdivides beziers in its native library;
this file keeps the Python recursion that the native one is a transcription
of.  A path here is (winding, [(closed, [segment])]) with a segment either
("S", a, b) or ("B", p1, p2, p3, p4); a transform op is ("T", dx, dy) or
("S", cx, cy, sx, sy).
"""

from __future__ import annotations

import math

import numpy as np

EVEN_ODD = "evenodd"
NONZERO = "nonzero"
IPS = 32  # subpixel bins per pixel
HALF = IPS // 2
CURVE_ACCURACY = 0.2
KAPPA = ((math.sqrt(2.0) - 1.0) / 3.0) * 4.0
IDENTITY = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def matmul(m, n):
    """m after n."""
    a, b, c, d, e, f = m
    a2, b2, c2, d2, e2, f2 = n
    return (a * a2 + c * b2, b * a2 + d * b2, a * c2 + c * d2, b * c2 + d * d2, a * e2 + c * f2 + e,
            b * e2 + d * f2 + f)


def _about(cx: float, cy: float, m):
    return matmul((1, 0, 0, 1, cx, cy), matmul(m, (1, 0, 0, 1, -cx, -cy)))


def matrix_of_op(op):
    if op[0] == "T":
        return (1.0, 0.0, 0.0, 1.0, op[1], op[2])
    if op[0] == "S":
        return _about(op[1], op[2], (op[3], 0.0, 0.0, op[4], 0.0, 0.0))
    if op[0] == "R":
        ca, sa = math.cos(op[3]), math.sin(op[3])
        return _about(op[1], op[2], (ca, sa, -sa, ca, 0.0, 0.0))
    raise ValueError(f"not a transform op: {op!r}")


def matrix_of_transform(ops):
    """The first op is outermost (applied last)."""
    m = IDENTITY
    for op in ops:
        m = matmul(m, matrix_of_op(op))
    return m


def apply(m, p):
    a, b, c, d, e, f = m
    x, y = p
    return (a * x + c * y + e, b * x + d * y + f)


def transform_path(ops, path):
    m = matrix_of_transform(ops)
    winding, subpaths = path
    return winding, [(closed, [(s[0], *(apply(m, q) for q in s[1:])) for s in segs]) for closed, segs in subpaths]


# --- shapes -------------------------------------------------------------


def _quarter(s: float, c, r: float):
    std = [(1.0, 0.0), (1.0, KAPPA), (KAPPA, 1.0), (0.0, 1.0)]
    ops = [("T", c[0], c[1]), ("S", 0.0, 0.0, r, r), ("R", 0.0, 0.0, s)]
    m = matrix_of_transform(ops)
    return ["B", *(apply(m, pt) for pt in std)]


def circle(x: float, y: float, r: float):
    """Four bezier quarters, each starting where the last ended."""
    segs = []
    for s in (0.0, math.pi / 2.0, math.pi, 3.0 * math.pi / 2.0):
        q = _quarter(s, (x, y), r)
        if segs:
            q[1] = segs[-1][4]
        segs.append(q)
    return NONZERO, [(True, [tuple(q) for q in segs])]


def rectangle(x: float, y: float, w: float, h: float):
    return EVEN_ODD, [(True, [("S", (x, y), (x + w, y)), ("S", (x + w, y), (x + w, y + h)),
                              ("S", (x + w, y + h), (x, y + h)), ("S", (x, y + h), (x, y))])]


# --- flattening ---------------------------------------------------------


def _distance_point_from_line(c, a, b) -> float:
    ax, ay = a
    bx, by = b
    cx, cy = c
    l = math.sqrt((bx - ax) ** 2 + (by - ay) ** 2)
    if l == 0.0 or not math.isfinite(l):
        return float("nan")
    s = ((ay - cy) * (bx - ax) - (ax - cx) * (by - ay)) / (l * l)
    return abs(s) * l


def _flat(eps: float):
    def flat(p1, p2, p3, p4) -> bool:
        d1 = _distance_point_from_line(p2, p1, p4)
        d2 = _distance_point_from_line(p3, p1, p4)

        def normal(d):
            return math.isfinite(d) and d != 0.0 and abs(d) >= 2.2250738585072014e-308

        if normal(d1) and normal(d2):
            return d1 < eps and d2 < eps
        return True

    return flat


def _mid(p, q):
    return ((p[0] + q[0]) / 2.0, (p[1] + q[1]) / 2.0)


def subdivide(flat, p1, p2, p3, p4):
    """Chords of a bezier, in order."""
    out, stack = [], [(p1, p2, p3, p4)]
    while stack:
        a, b, c, d = stack.pop()
        if flat(a, b, c, d):
            out.append((a, d))
        else:
            l2, h = _mid(a, b), _mid(b, c)
            l3, r3 = _mid(l2, h), _mid(c, d)
            r2 = _mid(h, r3)
            l4 = _mid(l3, r2)
            stack.append((l4, r2, r3, d))
            stack.append((a, l2, l3, l4))
    return out


_ACCURATE = _flat(CURVE_ACCURACY)


def chords(segs):
    out = []
    for s in segs:
        if s[0] == "S":
            out.append((s[1], s[2]))
        else:
            out.extend(subdivide(_ACCURATE, *s[1:]))
    return out


def sub_of_float(f: np.ndarray) -> np.ndarray:
    return np.ceil(np.asarray(f, dtype=np.float64) * float(IPS) - float(HALF)).astype(np.int64)


def pix_of_sub(n: np.ndarray) -> np.ndarray:
    """ceil(n / 32) with the division truncating toward zero."""
    v = np.asarray(n, dtype=np.int64) + (IPS - 1)
    return (np.sign(v) * (np.abs(v) // IPS)).astype(np.int64)


def edges_of_path(path) -> np.ndarray:
    """(N, 4) int64 subbin edges [x0, y0, x1, y1] of every subpath."""
    segs = [s for _closed, ss in path[1] for s in ss]
    if not segs:
        return np.zeros((0, 4), dtype=np.int64)
    c = np.asarray([(a[0], a[1], b[0], b[1]) for a, b in chords(segs)], dtype=np.float64)
    return sub_of_float(c)


def bounds_polygon(path):
    """Integer pixel bounds (minx, maxx, miny, maxy) of a path of straight
    segments."""
    f = lambda v: int(pix_of_sub(sub_of_float(np.float64(v))))
    pts = []
    for _closed, segs in path[1]:
        for s in segs:
            if s[0] != "S":
                raise ValueError("bounds_polygon: straight segments only")
            pts += [s[1], s[2]]
    xs, ys = [f(x) for x, _ in pts], [f(y) for _, y in pts]
    return min(xs), max(xs), min(ys), max(ys)


def points_on_path(sep: float, path):
    """Points every `sep` along each subpath, walking its chords in the
    renderer's (reversed-accumulator) order."""
    out = []
    for _closed, segs in path[1]:
        straights = []
        for s in segs:
            if s[0] == "S":
                straights.insert(0, (s[1], s[2]))
            else:
                straights = subdivide(_ACCURATE, *s[1:]) + straights
        work = straights
        while work:
            remaining = sep
            while work:
                p1, p2 = work[0]
                l = math.hypot(p2[0] - p1[0], p2[1] - p1[1])
                if remaining <= l:
                    if l <= 0.0:
                        raise ValueError("points_on_path: zero-length segment")
                    prop = remaining / l
                    p = (p1[0] * (1.0 - prop) + p2[0] * prop, p1[1] * (1.0 - prop) + p2[1] * prop)
                    work = work[1:] if p == p2 else [(p, p2)] + work[1:]
                    out.append(p)
                    break
                remaining -= l
                work = work[1:]
    return out
