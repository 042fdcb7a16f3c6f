"""The renderer's pixels in plain PyTorch: integer colour arithmetic, the
Gaussian-matte anti-aliasing, the tile route's paint rule, Gaussian brush
strokes, the front-to-back composite and the exact separable blur.

Frozen from the plain versions that coherence_tpu_torch keeps beside its
kernels: colour.py:165-308 (div255, prelerp, dissolve), raster/aa.py:37-122
(the 32x32 truncated-Gaussian table, the stride-16 coverage product, the
opacity formula), raster/tile_raster.py:94-112 (interior where a crossing span
covers and no coverage span does, the fringe dissolved by its opacity),
raster/brush.py:93-206 and raster/brush_tiles.py:86-166 (stamps alpha_over a
Gaussian patch in order, the mask a box dilation of the stamp points),
raster/compositor.py:42-64 (over on packed words), raster/convolve.py:86-141
and raster/framepath.py:217-248 (the blur: x pass, then y pass, each divided
and clamped; blended by the filter's alpha).  Each layer is computed whole
over its own box, not tile by tile: every pixel depends only on its own
footprint, so the tiles the program cuts cannot change it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import geometry as G
from .sweep import edge_spans, scaled_spans

TILE_H, TILE_W = 64, 128
RES = 32
AA = RES // 2  # the anti-aliasing mask's scale


def _maintable() -> np.ndarray:
    t = np.zeros((RES, RES), dtype=np.int64)
    for x in range(1, RES + 1):
        for y in range(1, RES + 1):
            fx = ((x - 1) * 6.0) / (RES - 1) - 3.0
            fy = ((y - 1) * 6.0) / (RES - 1) - 3.0
            t[x - 1, y - 1] = int(math.exp(-(fx * fx + fy * fy) / 2.0) * 255.0)
    return t


MAINTABLE = _maintable()
VOLUME = int(MAINTABLE.sum()) * 256 // 255
_K2 = MAINTABLE.T
# The table as the four 16x16 quadrants of the stride lattice, (256, 4).
WQ = np.stack([_K2[:AA, :AA].reshape(-1), _K2[:AA, AA:].reshape(-1), _K2[AA:, :AA].reshape(-1),
               _K2[AA:, AA:].reshape(-1)], axis=1)
# Scaled samples per band of an opacity plane.
BAND_SAMPLES = 1 << 24


def div255(i):
    return (i + (i >> 8) + 1) >> 8


def prelerp(p, q, a):
    t = a * p + 128
    return p + q - (((t >> 8) + t) >> 8)


def dissolve(col: torch.Tensor, delta, dtype=torch.int32) -> torch.Tensor:
    """`col` scaled by delta / 255: exact in int32 (div255); in any other
    `dtype`, the product and quotient taken in that type and floored."""
    d = torch.as_tensor(delta, dtype=torch.int32, device=col.device)
    if d.ndim == col.ndim - 1:
        d = d[..., None]
    if dtype == torch.int32:
        scaled = div255(col * d)
    else:
        scaled = torch.floor(col.to(dtype) * d.to(dtype) / 255).to(torch.int32)
    return torch.where(d == 0, 0, torch.where(d == 255, col, scaled))


def pack(rgba: torch.Tensor) -> torch.Tensor:
    rgba = rgba.to(torch.int32)
    return rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16) | (rgba[..., 3] << 24)


def unpack(packed: torch.Tensor) -> torch.Tensor:
    return torch.stack([(packed >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)


def over_packed(acc: torch.Tensor, layer: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """`acc` over `layer`, both packed: per channel acc + layer (255 - a) / 255
    by prelerp, exact in int32; in any other `dtype`, layer * a / 255 taken in
    that type and rounded."""
    aa = (acc >> 24) & 0xFF
    out = 0
    for s in (0, 8, 16, 24):
        l, a = (layer >> s) & 0xFF, (acc >> s) & 0xFF
        if dtype == torch.int32:
            ch = prelerp(l, a, aa)
        else:
            ch = l + a - torch.floor(aa.to(dtype) * l.to(dtype) / 255 + 0.5).to(torch.int32)
        out = out | (ch << s)
    return out


def mask_of_spans(h: int, w: int, rows, starts, ends, device) -> torch.Tensor:
    """bool (h, w) from inclusive spans [start, end] per row, all already
    inside the plane's columns; rows outside 0..h-1 are dropped."""
    rows, starts, ends = (np.asarray(a, np.int64) for a in (rows, starts, ends))
    keep = (rows >= 0) & (rows < h)
    r = torch.from_numpy(np.concatenate([rows[keep], rows[keep]])).to(device)
    c = torch.from_numpy(np.concatenate([starts[keep], ends[keep] + 1])).to(device)
    k = int(keep.sum())
    vals = torch.ones(2 * k, dtype=torch.int32, device=device)
    vals[k:] = -1
    diff = torch.zeros((h, w + 1), dtype=torch.int32, device=device)
    diff.index_put_((r, c), vals, accumulate=True)
    return torch.cumsum(diff, dim=1, dtype=torch.int32)[:, :-1] > 0


def coverage_counts(t_mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Opacities (h, w) from a bool (16h + 16, 16w + 16) scaled mask whose
    origin lies 32 scaled pixels above and left of the box.  The product is
    exact in float32: 0/1 inputs, integer weights, sums below 2**24."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the coverage product needs float32 matmul at 'highest' precision, TF32 off")
    b = t_mask.reshape(h + 1, AA, w + 1, AA).permute(0, 2, 1, 3).reshape(-1, AA * AA).to(torch.float32)
    p = (b @ torch.as_tensor(WQ, dtype=torch.float32, device=t_mask.device)).reshape(h + 1, w + 1, 4)
    cov = p[:h, :w, 0] + p[:h, 1:, 1] + p[1:, :w, 2] + p[1:, 1:, 3]
    counts = torch.round(cov).to(torch.int32)
    return (counts * 256 + VOLUME // 2) // VOLUME


def opacity(box, scaled, device) -> torch.Tensor:
    """int32 (h, w) anti-aliasing opacity over the 1-based pixel box, from
    scaled spans (rows, s, e) in absolute scaled pixels, in row bands."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0 + 1, y1 - y0 + 1
    out = torch.zeros((h, w), dtype=torch.int32, device=device)
    if scaled is None:
        return out
    rows, ss, ee = (np.asarray(a, np.int64) for a in scaled)
    c0 = AA * x0 - 2 * AA
    tw = AA * w + AA
    cs, ce = np.clip(ss - c0, 0, tw), np.clip(ee + 1 - c0, 0, tw)
    keep = ce > cs
    band = max(1, BAND_SAMPLES // (AA * (tw + 1)) - 1)
    for by in range(0, h, band):
        bh = min(band, h - by)
        r = rows - (AA * (y0 + by) - 2 * AA)
        t_mask = mask_of_spans(AA * bh + AA, tw, r[keep], cs[keep], ce[keep] - 1, device)
        out[by : by + bh] = coverage_counts(t_mask, bh, w)
    return out


class Layer(NamedTuple):
    """An object's pixels: packed (h, w) at 0-based frame row y0, column x0,
    and the tiles its program pieces cover (frame tile indices)."""

    y0: int
    x0: int
    packed: torch.Tensor
    tiles: frozenset


def _clip_spans(rows, s, e, pw: int):
    keep = (e >= 1) & (s <= pw)
    return rows[keep], np.maximum(s[keep], 1), np.minimum(e[keep], pw)


def _tiles_of_spans(rows, s, e, ntx: int) -> set:
    """Tiles that the inclusive 1-based spans touch."""
    out = set()
    ty = (rows - 1) // TILE_H
    for t, a, b in zip(ty.tolist(), ((s - 1) // TILE_W).tolist(), ((e - 1) // TILE_W).tolist()):
        out.update(t * ntx + x for x in range(a, b + 1))
    return out


def culled(edges: np.ndarray, pw: int, ph: int) -> bool:
    """The tile route's cull: wholly two pixels or more off the grid."""
    if not len(edges):
        return False
    xs, ys = edges[:, [0, 2]], edges[:, [1, 3]]
    return bool(xs.max() // 32 < -2 or xs.min() // 32 > pw + 2 or ys.max() // 32 < -2 or ys.min() // 32 > ph + 2)


def path_layer(edges: np.ndarray, winding: str, rgba4, pw: int, ph: int, device,
               dtype=torch.int32) -> Optional[Layer]:
    """A plain-filled path on the tile route: the fill where a crossing span
    covers and no coverage span does, the fill dissolved by the opacity on
    coverage spans, nothing elsewhere."""
    if culled(edges, pw, ph):
        return None
    spans = edge_spans(edges, winding, G.HALF, rows_clip=(1, ph))
    if spans is None:
        return None
    crow, cs, ce = _clip_spans(*spans[:3], pw)
    xrow, xs, xe = _clip_spans(*spans[3:], pw)
    if crow.size + xrow.size == 0:
        return None
    rows = np.concatenate([crow, xrow])
    y0, y1 = int(rows.min()), int(rows.max())
    x0, x1 = int(np.concatenate([cs, xs]).min()), int(np.concatenate([ce, xe]).max())
    h, w = y1 - y0 + 1, x1 - x0 + 1
    covm = mask_of_spans(h, w, crow - y0, cs - x0, ce - x0, device)
    crossm = mask_of_spans(h, w, xrow - y0, xs - x0, xe - x0, device)
    colour = torch.as_tensor(np.asarray(rgba4, np.int32), device=device)
    op = torch.zeros((h, w), dtype=torch.int32, device=device)
    if crow.size:
        fy0, fy1 = int(crow.min()), int(crow.max())
        fx0, fx1 = int(cs.min()), int(ce.max())
        aa = scaled_spans(edges, winding, AA, rows_clip=(-AA, ph * AA - 1))
        op[fy0 - y0 : fy1 - y0 + 1, fx0 - x0 : fx1 - x0 + 1] = opacity((fx0, fy0, fx1, fy1), aa, device)
    rgba = torch.where((crossm & ~covm)[..., None], colour,
                       torch.where(covm[..., None], dissolve(colour.expand(h, w, 4), op, dtype), 0))
    ntx = pw // TILE_W
    tiles = _tiles_of_spans(crow, cs, ce, ntx) | _tiles_of_spans(xrow, xs, xe, ntx)
    return Layer(y0 - 1, x0 - 1, pack(rgba), frozenset(tiles))


def _g(x: float, y: float, r: float) -> float:
    r = r / 2.0
    return 255.0 * math.exp(-((x / r) ** 2 + (y / r) ** 2))


def brush_alpha(radius: float, opacity_: float) -> np.ndarray:
    """The Gaussian brush's alpha patch at `opacity_`."""
    intop = int(opacity_ * 255.0)
    intr = int(math.ceil(radius))
    size = intr * 2 + 1
    a = div255(255 * intop) if intop not in (0, 255) else (0 if intop == 0 else 255)
    out = np.zeros((size, size), dtype=np.int32)
    for yy in range(size):
        for xx in range(size):
            v = int(_g(float(xx - intr), float(yy - intr), radius))
            out[yy, xx] = div255(a * v) if v not in (0, 255) else (0 if v == 0 else a)
    return out


def brush_layer(radius: float, opacity_: float, path, rgba4, pw: int, ph: int, device,
                dtype=torch.int32) -> Optional[Layer]:
    """A plain-filled Gaussian brush stroke: stamps every width / 20 along
    the path, each alpha_over its patch in order; the fill dissolved by the
    alpha inside the box dilation of the stamp points by the brush radius.
    Its pieces are every grid tile of the points' box grown by the radius."""
    size = int(math.ceil(radius)) * 2 + 1
    r = (size - 1) // 2
    pts = [(int(math.floor(x + 0.5)), int(math.floor(y + 0.5))) for x, y in G.points_on_path(size / 20.0, path)]
    if not pts:
        return None
    parr = np.asarray(pts, np.int64)
    sx0, sy0 = int(parr[:, 0].min()) - r, int(parr[:, 1].min()) - r
    sx1, sy1 = int(parr[:, 0].max()) + r, int(parr[:, 1].max()) + r
    ntx, nty = pw // TILE_W, ph // TILE_H
    tx_lo, tx_hi = max(0, (sx0 - 1) // TILE_W), min(ntx - 1, (sx1 - 1) // TILE_W)
    ty_lo, ty_hi = max(0, (sy0 - 1) // TILE_H), min(nty - 1, (sy1 - 1) // TILE_H)
    if tx_hi < tx_lo or ty_hi < ty_lo:
        return None
    h, w = sy1 - sy0 + 1, sx1 - sx0 + 1
    aa = torch.as_tensor(brush_alpha(radius, opacity_), device=device)
    canvas = torch.zeros((h, w), dtype=torch.int32, device=device)
    for x, y in pts:
        patch = canvas[y - r - sy0 : y + r + 1 - sy0, x - r - sx0 : x + r + 1 - sx0]
        stamped = torch.where(aa == 255, aa, prelerp(patch, aa, aa))
        patch.copy_(torch.where(aa == 0, patch, stamped))
    points = torch.zeros((1, 1, h, w), dtype=torch.float32, device=device)
    points[0, 0, torch.as_tensor(parr[:, 1] - sy0, device=device), torch.as_tensor(parr[:, 0] - sx0, device=device)] = 1
    mask = torch.nn.functional.max_pool2d(points, 2 * r + 1, stride=1, padding=r)[0, 0] > 0
    colour = torch.as_tensor(np.asarray(rgba4, np.int32), device=device)
    rgba = torch.where(mask[..., None], dissolve(colour.expand(h, w, 4), canvas, dtype), 0)
    # Only the grid's pixels: cut to the tile range.
    gy0, gy1 = ty_lo * TILE_H + 1, (ty_hi + 1) * TILE_H
    gx0, gx1 = tx_lo * TILE_W + 1, (tx_hi + 1) * TILE_W
    cy0, cy1, cx0, cx1 = max(sy0, gy0), min(sy1, gy1), max(sx0, gx0), min(sx1, gx1)
    tiles = frozenset(ty * ntx + tx for ty in range(ty_lo, ty_hi + 1) for tx in range(tx_lo, tx_hi + 1))
    if cy1 < cy0 or cx1 < cx0:
        return Layer(gy0 - 1, gx0 - 1, torch.zeros((0, 0), dtype=torch.int32, device=device), tiles)
    return Layer(cy0 - 1, cx0 - 1, pack(rgba[cy0 - sy0 : cy1 - sy0 + 1, cx0 - sx0 : cx1 - sx0 + 1]), tiles)


def alpha_plane(edges: np.ndarray, winding: str, width: int, height: int, device) -> torch.Tensor:
    """(height, width) int32 alpha of a white path under the whole-shape
    anti-aliasing matte: the opacity on every pixel of its shape (coverage
    and crossing spans), no interior shortcut."""
    plane = torch.zeros((height, width), dtype=torch.int32, device=device)
    spans = edge_spans(edges, winding, G.HALF)
    if spans is None:
        return plane
    crow, cs, ce = _clip_spans(*spans[:3], width)
    xrow, xs, xe = _clip_spans(*spans[3:], width)
    rows = np.concatenate([crow, xrow])
    s, e = np.concatenate([cs, xs]), np.concatenate([ce, xe])
    keep = (rows >= 1) & (rows <= height)
    rows, s, e = rows[keep], s[keep], e[keep]
    if rows.size == 0:
        return plane
    y0, y1, x0, x1 = int(rows.min()), int(rows.max()), int(s.min()), int(e.max())
    mask = mask_of_spans(y1 - y0 + 1, x1 - x0 + 1, rows - y0, s - x0, e - x0, device)
    op = opacity((x0, y0, x1, y1), scaled_spans(edges, winding, AA), device)
    white = torch.full((y1 - y0 + 1, x1 - x0 + 1, 4), 255, dtype=torch.int32, device=device)
    plane[y0 - 1 : y1, x0 - 1 : x1] = torch.where(mask, dissolve(white, op)[..., 3], 0)
    return plane


def composite(layers, background: torch.Tensor, region=None, dtype=torch.int32) -> torch.Tensor:
    """Fold packed layers front to back over the packed background.  With
    `region` = (y0, y1, x0, x1), only that part of the frame, returned alone."""
    ph, pw = background.shape
    ry0, ry1, rx0, rx1 = region if region is not None else (0, ph, 0, pw)
    acc = torch.zeros((ry1 - ry0, rx1 - rx0), dtype=torch.int32, device=background.device)
    for lay in layers:
        if lay is None:
            continue
        h, w = lay.packed.shape
        y0, y1 = max(ry0, lay.y0), min(ry1, lay.y0 + h)
        x0, x1 = max(rx0, lay.x0), min(rx1, lay.x0 + w)
        if y0 >= y1 or x0 >= x1:
            continue
        win = acc[y0 - ry0 : y1 - ry0, x0 - rx0 : x1 - rx0]
        win.copy_(over_packed(win, lay.packed[y0 - lay.y0 : y1 - lay.y0, x0 - lay.x0 : x1 - lay.x0], dtype))
    return over_packed(acc, background[ry0:ry1, rx0:rx1], dtype)


def gaussian(r: int):
    """The separable Gaussian's integer weights and their total."""
    vals = tuple(int(4 * r * r * (math.exp(-((x / r) ** 2)) / 2.0) + 0.5) for x in range(-r, r + 1))
    return vals, sum(vals)


def _pass(img: torch.Tensor, weights, axis: int, dtype) -> torch.Tensor:
    """Correlation along `axis` with zero padding, accumulated in `dtype`."""
    pad = len(weights) // 2
    size = img.shape[axis]
    shape = list(img.shape)
    shape[axis] += 2 * pad
    padded = torch.zeros(shape, dtype=dtype, device=img.device)
    padded.narrow(axis, pad, size).copy_(img)
    out = torch.zeros(img.shape, dtype=dtype, device=img.device)
    for k, wk in enumerate(weights):
        if wk:
            out += int(wk) * padded.narrow(axis, k, size)
    return out


def _divide_clamp(sums: torch.Tensor, total: int) -> torch.Tensor:
    """Divide, then r and g clamp to alpha; b does not (the renderer's quirk)."""
    q = torch.div(sums, total, rounding_mode="floor").to(torch.int32)
    ta = q[..., 3]
    return torch.stack([torch.minimum(ta, q[..., 0]), torch.minimum(ta, q[..., 1]), q[..., 2], ta], dim=-1)


def blur(content: torch.Tensor, weights, total: int, dtype=torch.int32) -> torch.Tensor:
    cx = _divide_clamp(_pass(content, weights, 1, dtype), total)
    return _divide_clamp(_pass(cx, weights, 0, dtype), total)


def blur_blend(content: torch.Tensor, f_alpha: torch.Tensor, weights, total: int, dtype=torch.int32):
    """(H, W, 4) display: the blur of the (H, W, 4) content blended in by the
    filter's alpha wherever it is positive.  `dtype` other than int32 takes
    the blur's sums and the blend in that type."""
    cy = blur(content, weights, total, dtype)
    blended = dissolve(content, 255 - f_alpha, dtype) + dissolve(cy, f_alpha, dtype)
    return torch.where(f_alpha[..., None] > 0, blended, content)
