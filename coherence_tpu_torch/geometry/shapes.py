"""Shape primitives (parity: reference ``shapes.ml:41-147``).

The port's copy of ``coherence_tpu.geometry.shapes``, trimmed to the two
constructors the port uses: circles from four bezier quarters, and
axis-aligned rectangles.  The stroker is not ported.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .. import transform as tr
from .path import EVEN_ODD, NONZERO, Bezier, Path, Straight, Subpath

Point = Tuple[float, float]

# Bezier quarter-circle control-length factor (shapes.ml:13).
kappa = ((math.sqrt(2.0) - 1.0) / 3.0) * 4.0

_pi = math.pi


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


def joinsegs(segments: List[Bezier]) -> List[Bezier]:
    """Fix float misalignment between consecutive beziers (shapes.ml:71-77)."""
    out: List[Bezier] = []
    for seg in segments:
        if out:
            prev = out[-1]
            seg = Bezier(prev.p4, seg.p2, seg.p3, seg.p4)
        out.append(seg)
    return out


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
