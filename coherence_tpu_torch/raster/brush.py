"""Brushes, brushstrokes and smearing (parity: reference ``brush.ml``).

The PyTorch counterpart of ``coherence_tpu.raster.brush``, whole.  A brush
is (opacity, kind) with kind (GAUSSIAN, radius) or (DUMMY, rx, ry)
(brush.ml:14-19); a brushstroke pairs a brush with a path.  Strokes stamp
the brush at points spaced width/20 along the path (brush.ml:126-131),
compositing alphas with ``alpha_over``; the fill is applied afterwards by
dissolving the fill colour by the accumulated alpha (brush.ml:176-222).

The stamps run in the reference's order and rounding (``_stamp_alpha``,
which the batched ``raster/brush_tiles`` build shares); the JAX package
runs the walk as a ``lax.scan``.  On a CUDA device the walk is one launch
of the hand-written ``brush_stamp`` kernel and the smear's two passes one
launch of ``smear_walk``; on the CPU each runs as torch operations, one
step a stamp (``_stamp_alpha_torch``, ``_smear_walk_torch``).  The JAX
package's pow2 padding of canvas, brush and stamp count bounds compiled
programs and is not kept.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .. import colour as C
from .. import kernels
from .. import transform as tr
from ..geometry import path as gpath
from . import region
from .region import NULL_SHAPE, NULL_SPRITE, Canvas, Sprite

GAUSSIAN = "gaussian"
DUMMY = "dummy"


def mkround(radius: float, opacity: float):
    """Round Gaussian brush (brush.ml:66-67)."""
    return (opacity, (GAUSSIAN, radius))


def mkdummy(brushstroke):
    """Dummy shadow of a brushstroke (brush.ml:70-72)."""
    brush, path = brushstroke
    w, h = sizeof_brush(brush)
    return ((1.0, (DUMMY, (w - 1) // 2, (h - 1) // 2)), path)


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


def drawbrush_rgba(brush, colour: int) -> np.ndarray:
    """Brush canvas as (h, w, 4) int32 colours (brush.ml:94-99)."""
    opacity, kind = brush
    if kind[0] != GAUSSIAN:
        raise ValueError("cannot draw a dummy brush")
    radius = kind[1]
    intop = int(opacity * 255.0)
    intr = int(math.ceil(radius))
    size = intr * 2 + 1
    out = np.zeros((size, size, 4), dtype=np.int32)
    base = C.dissolve(colour, delta=intop)
    for yy in range(size):
        for xx in range(size):
            v = int(_g(float(xx - intr), float(yy - intr), radius))
            out[yy, xx] = C.rgba_of_colour(C.dissolve(base, delta=v))
    return out


def points_of_brushstroke(brushstroke) -> List[Tuple[float, float]]:
    """Stamp points at spacing width/20 (brush.ml:126-131)."""
    brush, path = brushstroke
    w, _ = sizeof_brush(brush)
    return gpath.points_on_path(w / 20.0, path)


def _int_points(points):
    return [(int(math.floor(x + 0.5)), int(math.floor(y + 0.5))) for (x, y) in points]


def shape_of_brushstroke(brushstroke, device):
    """Shape of a brushstroke: stamp-point mask bloated by the brush radius;
    minshape is Null (brush.ml:135-173)."""
    brush, _ = brushstroke
    points = _int_points(points_of_brushstroke(brushstroke))
    if not points:
        return NULL_SHAPE, NULL_SHAPE
    w, h = sizeof_brush(brush)
    wr, hr = (w - 1) // 2, (h - 1) // 2
    xs = np.array([p[0] for p in points])
    ys = np.array([p[1] for p in points])
    x0, x1 = int(xs.min()), int(xs.max())
    y0, y1 = int(ys.min()), int(ys.max())
    mask = np.zeros((y1 - y0 + 1, x1 - x0 + 1), dtype=bool)
    mask[ys - y0, xs - x0] = True
    base = region.shape_of_mask((x0, y0, x1, y1), mask, device)
    return region.bloat(wr, hr, base), NULL_SHAPE


def bounds_brushstroke(brushstroke):
    """Integer bounds (brush.ml:225-232)."""
    brush, path = brushstroke
    w, h = sizeof_brush(brush)
    w, h = w // 2, h // 2
    minx, maxx, miny, maxy = gpath.bounds_polygon(path)
    return minx - w, maxx + w, miny - h, maxy + h


# ---------------------------------------------------------------------------
# Device stamping
# ---------------------------------------------------------------------------


def _stamp_alpha(brushes, offsets, valid, hp: int, wp: int, device) -> torch.Tensor:
    """(s, hp, wp) int32 alpha planes: each stroke's valid stamps
    alpha_over its (bhb, bwb) brush patch at offsets[s, i] (top-left
    corner), in stamp order; an invalid stamp leaves its patch as it is.
    On a CUDA device one ``brush_stamp`` launch (plane mode) computes them;
    on the CPU ``_stamp_alpha_torch``."""
    if torch.device(device).type == "cpu":
        return _stamp_alpha_torch(brushes, offsets, valid, hp, wp, device)
    return kernels.brush_stamp_planes(brushes, offsets, valid, hp, wp, device)


def _stamp_alpha_torch(brushes, offsets, valid, hp: int, wp: int, device) -> torch.Tensor:
    """Plain version of ``_stamp_alpha``.  Strokes are independent, so
    stamp i of every stroke runs in one batched step; a step with no valid
    stamp is skipped on the host."""
    s, bhb, bwb = brushes.shape
    canvas = torch.zeros((s, hp, wp), dtype=torch.int32, device=device)
    aa = torch.from_numpy(brushes).to(device)
    offs = torch.from_numpy(offsets).to(device).long()
    live = torch.from_numpy(valid).to(device)[:, :, None, None]
    si = torch.arange(s, device=device)[:, None, None]
    ar, ac = torch.arange(bhb, device=device), torch.arange(bwb, device=device)
    for i in np.nonzero(valid.any(axis=0))[0]:
        rows = (offs[:, i, 0, None] + ar)[:, :, None]
        cols = (offs[:, i, 1, None] + ac)[:, None, :]
        patch = canvas[si, rows, cols]
        stamped = torch.where(aa == 255, aa, C.prelerp_arr(patch, aa, aa))
        canvas[si, rows, cols] = torch.where((aa == 0) | ~live[:, i], patch, stamped)
    return canvas


def sprite_of_brushstroke(brushstroke, fill, shp, device):
    """Rasterize a brushstroke within shape `shp` (brush.ml:176-222)."""
    brush, path = brushstroke
    opacity, kind = brush
    if kind[0] == DUMMY:
        base, _ = shape_of_brushstroke(brushstroke, device)
        from . import fills as _fills

        return region.fillshape(base, _fills.plain(C.white))
    if shp is None:
        return NULL_SPRITE
    bw, bh = sizeof_brush(brush)
    bwr, bhr = (bw - 1) // 2, (bh - 1) // 2
    bloated = region.bloat(bwr, bhr, shp)
    points = _int_points(points_of_brushstroke(brushstroke))
    # Filter stamp points to the bloated shape with ONE mask readback:
    # per-point region.point_in_shape would cost one device sync per stamp.
    if points:
        parr = np.asarray(points, np.int64)
        bx0, by0, bx1, by1 = bloated.box
        inb = (
            (parr[:, 0] >= bx0)
            & (parr[:, 0] <= bx1)
            & (parr[:, 1] >= by0)
            & (parr[:, 1] <= by1)
        )
        m = bloated.mask_np()
        keep = np.zeros(len(points), dtype=bool)
        sel = np.nonzero(inb)[0]
        keep[sel] = m[parr[sel, 1] - by0, parr[sel, 0] - bx0]
        points = [points[i] for i in np.nonzero(keep)[0]]
    # Every kept stamp's patch lies inside the twice-bloated box.
    x0, y0, x1, y1 = region.bloat(bwr, bhr, bloated).box
    hc, wc = y1 - y0 + 1, x1 - x0 + 1
    dev = shp.mask.device
    if points:
        offs = np.array([[py - y0 - bhr, px - x0 - bwr] for (px, py) in points], dtype=np.int32)
        canvas_a = _stamp_alpha(
            drawround_alpha(kind[1], opacity)[None], offs[None],
            np.ones((1, len(points)), dtype=bool), hc, wc, dev,
        )[0]
    else:
        canvas_a = torch.zeros((hc, wc), dtype=torch.int32, device=dev)
    # Apply the fill: dissolve fill colour by the accumulated alpha, within shp.
    w, h = shp.wh
    sx0, sy0 = shp.box[0], shp.box[1]
    alpha = canvas_a[sy0 - y0 : sy0 - y0 + h, sx0 - x0 : sx0 - x0 + w]
    fill_rgba = fill.image_device(shp.box, h, w, dev)
    rgba = torch.where(shp.mask[..., None], C.dissolve_rgba(fill_rgba, alpha), 0)
    return Sprite(shp.box, shp.mask, rgba)


# ---------------------------------------------------------------------------
# Smearing (brush.ml:236-331)
# ---------------------------------------------------------------------------


def points_of_brushstroke_smear(brushstroke):
    """Subdivide to points on adjacent pixels (brush.ml:239-254)."""
    _, path = brushstroke

    def adjacent(p1, p2, p3, p4):
        return math.dist(p1, p4) <= 2.0

    pts = []
    for sp in path.subpaths:
        for seg in sp.segments:
            if isinstance(seg, gpath.Straight):
                p = ((seg.a[0] + seg.b[0]) / 2.0, (seg.a[1] + seg.b[1]) / 2.0)
                edges = gpath.bezier_subdivide(adjacent, seg.a, p, p, seg.b)
            else:
                edges = gpath.bezier_subdivide(adjacent, seg.p1, seg.p2, seg.p3, seg.p4)
            pts.extend(a for a, _ in edges)
    return pts


def find_smear_directions(points):
    """Direction (toward previous point) per deduped int point
    (brush.ml:263-278)."""
    if not points:
        return []
    ipts = [(int(x), int(y)) for (x, y) in points]
    dedup = [ipts[0]]
    for p in ipts[1:]:
        if p != dedup[-1]:
            dedup.append(p)

    def sgn(v):
        return -1 if v > 0 else (1 if v < 0 else 0)

    prevs = [dedup[0]] + dedup[:-1]
    return [
        ((x, y), (sgn(x - px), sgn(y - py)))
        for (x, y), (px, py) in zip(dedup, prevs)
    ]


def _smear_walk(cv: torch.Tensor, opac_a: torch.Tensor, offsets, dirs, bh: int, bw: int) -> torch.Tensor:
    """The smear's two passes (the reference smears twice, brush.ml:308)
    over the int32 (H, W, 4) canvas, in place: for each point, read a
    brush-sized patch shifted by -dir, then dissolve it under the patch at
    the point, weighted by the opacity brush (brush.ml:308-328).  At alpha
    0 the smear writes the shifted patch (dissolve_between).  On a CUDA
    device one ``smear_walk`` launch runs both passes; on the CPU
    ``_smear_walk_torch``."""
    if cv.device.type == "cpu":
        return _smear_walk_torch(cv, opac_a, offsets, dirs, bh, bw)
    return kernels.smear_walk(cv, opac_a, offsets, dirs, bh, bw)


def _smear_walk_torch(cv: torch.Tensor, opac_a: torch.Tensor, offsets, dirs, bh: int, bw: int) -> torch.Tensor:
    """Plain version of ``_smear_walk``: one step of torch operations per
    point and pass."""
    al = opac_a[..., None]
    for _ in range(kernels.SMEAR_PASSES):
        for (r, c), (dx, dy) in zip(offsets, dirs):
            src = cv[r - dy : r - dy + bh, c - dx : c - dx + bw]
            dst = cv[r : r + bh, c : c + bw]
            # dissolve_between ~a:dst src ~alpha:opacbrush_alpha
            mixed = C.dissolve_rgba(dst, al) + C.dissolve_rgba(src, 255 - al)
            cv[r : r + bh, c : c + bw] = torch.where(al == 0, src, torch.where(al == 255, dst, mixed))
    return cv


def smear(spr, brushstroke, device):
    """Smear a sprite along a brushstroke (brush.ml:281-331)."""
    from . import fills as _fills

    brush, path = brushstroke
    # 0. Flesh the sprite out to the brushstroke's shape.
    shp, _ = shape_of_brushstroke(brushstroke, device)
    filler = region.fillshape(shp, _fills.plain(C.clear)) if shp is not None else None
    if filler is not None:
        spr, _ = region.caf("over", "opaque", spr, filler)
    if spr is None:
        return spr
    bw, bh = sizeof_brush(brush)
    radx, rady = (bw - 1) // 2, (bh - 1) // 2
    points = points_of_brushstroke_smear(brushstroke)
    if not points:
        return spr
    pwd = find_smear_directions(points)
    canvas = region.flatten_sprite(max(radx, rady) * 2 + 2, spr, C.clear)
    ox, oy = canvas.origin
    offsets = []
    dirs = []
    for (x, y), (dx, dy) in pwd:
        # Top-left corner of the brush patch centred at (x+1, y+1) in the
        # reference's shifted coordinates; clip stamps falling outside.
        row = (y - oy) - rady + 1
        col = (x - ox) - radx + 1
        if (
            0 <= row - 1 - abs(dy)
            and 0 <= col - 1 - abs(dx)
            and row + bh + 1 <= canvas.height
            and col + bw + 1 <= canvas.width
        ):
            offsets.append((row, col))
            dirs.append((dx, dy))
    if not offsets:
        return spr
    opac = drawround_alpha(brush[1][1], 1.0) if brush[1][0] == GAUSSIAN else np.full(
        (bh, bw), 255, np.int32
    )
    opac_a = torch.from_numpy(opac).to(canvas.rgba.device)
    cv = _smear_walk(canvas.rgba.clone(), opac_a, offsets, dirs, bh, bw)
    return region.pickup(region.shape_of_sprite(spr), Canvas(cv, canvas.origin))
