"""Brushes and brushstrokes: the host math of ``coherence_tpu.raster.brush``
(parity: reference ``brush.ml``).

A brush is (opacity, kind) with kind (GAUSSIAN, radius) or (DUMMY, rx,
ry); a brushstroke pairs a brush with a path.  Strokes stamp the brush at
points spaced width/20 along the path.  Everything here is host Python and
numpy; the stamping itself runs batched in ``raster/brush_tiles``.  The
scalar ``sprite_of_brushstroke`` and ``smear`` belong to the general
renderer and are not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .. import colour as C
from .. import transform as tr
from ..geometry import path as gpath

GAUSSIAN = "gaussian"
DUMMY = "dummy"


def mkround(radius: float, opacity: float):
    """Round Gaussian brush (brush.ml:66-67)."""
    return (opacity, (GAUSSIAN, radius))


def sizeof_brush(brush) -> Tuple[int, int]:
    """Width/height of the brush canvas, always odd (brush.ml:25-28)."""
    _, kind = brush
    if kind[0] == GAUSSIAN:
        w = int(math.ceil(kind[1])) * 2 + 1
        return w, w
    return kind[1] * 2 + 1, kind[2] * 2 + 1


def _scaleof(op):
    if isinstance(op, tr.Scale):
        return op.sx, op.sy
    return 1.0, 1.0


def transform_brushkind(m, kind):
    """Affine transform of a brush kind (brush.ml:39-48)."""
    sx, sy = _scaleof(m)
    if kind[0] == GAUSSIAN:
        return (GAUSSIAN, kind[1] * ((abs(sx) + abs(sy)) / 2.0))
    w2 = kind[1] * ((sx + sy) / 2.0)
    h2 = kind[2] * ((sx + sy) / 2.0)
    return (DUMMY, int(w2 + 0.5), int(h2 + 0.5))


def transform_brush(m, brush):
    opacity, kind = brush
    return opacity, transform_brushkind(m, kind)


def transform_brush_many(brush, ops):
    for op in reversed(list(ops) if isinstance(ops, list) else [ops]):
        brush = transform_brush(op, brush)
    return brush


def transform_brushstroke(m, brushstroke):
    brush, path = brushstroke
    ops = m if isinstance(m, list) else [m]
    return transform_brush_many(brush, ops), gpath.transform_path(m, path)


def _g(x: float, y: float, r: float) -> float:
    # brush.ml:60-63
    r = r / 2.0
    return 255.0 * math.exp(-((x / r) ** 2 + (y / r) ** 2))


def drawround_alpha(radius: float, opacity: float) -> np.ndarray:
    """Alpha plane of a round Gaussian brush stamped with `opacity`
    (brush.ml:75-92 with colour = white: every channel equals the alpha)."""
    assert radius >= 0.0 and 0.0 <= opacity <= 1.0
    intop = int(opacity * 255.0)
    intr = int(math.ceil(radius))
    size = intr * 2 + 1
    out = np.zeros((size, size), dtype=np.int32)
    # dissolve(dissolve(white, intop), v) on the alpha channel.
    a = C.div255(255 * intop) if intop not in (0, 255) else (0 if intop == 0 else 255)
    for yy in range(size):
        for xx in range(size):
            v = int(_g(float(xx - intr), float(yy - intr), radius))
            out[yy, xx] = C.div255(a * v) if v not in (0, 255) else (0 if v == 0 else a)
    return out


def points_of_brushstroke(brushstroke) -> List[Tuple[float, float]]:
    """Stamp points at spacing width/20 (brush.ml:126-131)."""
    brush, path = brushstroke
    w, _ = sizeof_brush(brush)
    return gpath.points_on_path(w / 20.0, path)


def _int_points(points):
    return [(int(math.floor(x + 0.5)), int(math.floor(y + 0.5))) for (x, y) in points]


def bounds_brushstroke(brushstroke):
    """Integer bounds (brush.ml:225-232)."""
    brush, path = brushstroke
    w, h = sizeof_brush(brush)
    w, h = w // 2, h // 2
    minx, maxx, miny, maxy = gpath.bounds_polygon(path)
    return minx - w, maxx + w, miny - h, maxy + h
