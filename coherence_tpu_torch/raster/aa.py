"""Correlated-matte antialiasing (parity: reference ``polygon.ml:611-750``).

The PyTorch counterpart of ``coherence_tpu.raster.aa``.  The reference sums
a 32x32 truncated-Gaussian table under the 16x-scaled coverage mask of each
fringe pixel; that is a stride-16 valid correlation of the scaled binary
mask with the integer table.  On a CUDA device a matte is one launch of SR1
(``kernels/csrc/sprite_raster.cu``: the count as an exact integer sum of
the table, from the span lists).  The plain version computes it as one
float32 matrix product per batch (``aa.py:93-109`` in the JAX package),
on the CPU and in the comparisons.  The product is exact:
the inputs are 0/1, the weights are integers <= 255 and every partial sum
is an integer below 2^24, so any summation order gives the same integers,
provided float32 is not rounded to TF32 or bf16 on the way (checked at the
call).

Opacity follows ``polygon.ml:645-652``:
``opacity = (count*256 + volume/2) / volume`` with
``volume = (sum(table) * 256) / 255`` (integer division).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import colour as C
from .. import kernels
from . import scanline
from .region import NULL_SPRITE, Sprite

res = 32
softness = 2.0
_H = res // 2  # 16: the scale factor of the AA mask (polygon.ml:676)


def _make_maintable() -> np.ndarray:
    """The truncated Gaussian on [-3, 3]^2, x255 (polygon.ml:616-629)."""
    t = np.zeros((res, res), dtype=np.int64)
    for x in range(1, res + 1):
        for y in range(1, res + 1):
            fx = ((x - 1) * 6.0) / (res - 1) - 3.0
            fy = ((y - 1) * 6.0) / (res - 1) - 3.0
            t[x - 1, y - 1] = int(math.exp(-(fx * fx + fy * fy) / softness) * 255.0)
    return t


maintable = _make_maintable()
volume = int(maintable.sum()) * 256 // 255

# The 32x32 footprint splits into the 2x2 neighbouring 16x16 blocks of the
# stride lattice: coverage[j, k] = sum over (db, da) of <B[j+db, k+da], Wq[db, da]>,
# with B the mask's 16x16 blocks flattened.  The weight at (row offset v, col
# offset u) is maintable[u][v] (polygon.ml:694-705: the first index is x).
_K2 = maintable.T
_WQ = np.stack(
    [
        _K2[0:_H, 0:_H].reshape(-1),
        _K2[0:_H, _H : 2 * _H].reshape(-1),
        _K2[_H : 2 * _H, 0:_H].reshape(-1),
        _K2[_H : 2 * _H, _H : 2 * _H].reshape(-1),
    ],
    axis=1,
)  # (256, 4): quadrant order (db, da) = (0,0), (0,1), (1,0), (1,1)


def span_bucket(n: int, floor: int) -> int:
    """The JAX package's pow2 bucket with a floor; the brush-tile build
    keeps it because it fixes the atlas block layout."""
    return max(floor, 1 << (max(1, n) - 1).bit_length())


def mask_of_spans(n: int, h: int, w: int, item, rows, starts, stops, device) -> torch.Tensor:
    """bool (n, h, w) masks from inclusive column spans: +1 at (item, row,
    start), -1 at (item, row, stop), then a prefix sum along each row.
    `starts`/`stops` must lie in 0..w.  Rows outside 0..h-1 are dropped
    here, on the host: the JAX package's scatter drops them silently, while
    a PyTorch scatter raises (CPU) or faults (CUDA) on them."""
    rows = np.asarray(rows, np.int64)
    keep = (rows >= 0) & (rows < h)
    item = np.asarray(item, np.int64)[keep]
    idx = (
        torch.from_numpy(np.concatenate([item, item])).to(device),
        torch.from_numpy(np.concatenate([rows[keep], rows[keep]])).to(device),
        torch.from_numpy(
            np.concatenate([np.asarray(starts, np.int64)[keep], np.asarray(stops, np.int64)[keep]])
        ).to(device),
    )
    k = int(keep.sum())
    vals = torch.ones(2 * k, dtype=torch.int32, device=device)
    vals[k:] = -1
    diff = torch.zeros((n, h, w + 1), dtype=torch.int32, device=device)
    diff.index_put_(idx, vals, accumulate=True)
    return torch.cumsum(diff, dim=2, dtype=torch.int32)[..., :-1] > 0


def coverage_counts(t_mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-pixel opacities (0..255), int32 (n, h, w), from bool scaled masks
    (n, 16h+16, 16w+16) whose origin is at scaled coords (16*y0 - 32,
    16*x0 - 32) for the pixel box origin (x0, y0)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the AA coverage product needs full float32 matmul precision "
            "(torch.backends.cuda.matmul.allow_tf32 = False, precision 'highest')"
        )
    n = t_mask.shape[0]
    b = t_mask.reshape(n, h + 1, _H, w + 1, _H).permute(0, 1, 3, 2, 4)
    b = b.reshape(-1, _H * _H).to(torch.float32)
    wq = torch.as_tensor(_WQ, dtype=torch.float32, device=t_mask.device)
    p = (b @ wq).reshape(n, h + 1, w + 1, 4)
    cov = p[:, :h, :w, 0] + p[:, :h, 1:, 1] + p[:, 1:, :w, 2] + p[:, 1:, 1:, 3]
    counts = torch.round(cov).to(torch.int32)
    return (counts * 256 + volume // 2) // volume


# Scaled samples per band of coverage_opacity (its int32 difference plane
# and float32 product are 64 MiB each at this count): a band takes as many
# pixel rows as fit, 33 for a shape as wide as a 1080p frame.
_BAND_SAMPLES = 1 << 24


def coverage_opacity(box, scaled, device) -> torch.Tensor:
    """Per-pixel AA opacity, int32 (h, w), over the pixel box `box`, from
    scaled spans (rows, s, e) in absolute scaled-pixel coordinates (or None
    for an empty mask): on a CUDA device one staged copy and one launch of
    SR1 in opacity mode (kernels.sprite_raster_opacity), elsewhere
    coverage_opacity_torch."""
    if torch.device(device).type == "cuda":
        return kernels.sprite_raster_opacity(box, scaled, device)
    return coverage_opacity_torch(box, scaled, device)


def coverage_opacity_torch(box, scaled, device) -> torch.Tensor:
    """coverage_opacity's plain version, on any device: computed in row
    bands of about _BAND_SAMPLES samples; every pixel's value depends only
    on its own 32x32 footprint, so the bands do not change it."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0 + 1, y1 - y0 + 1
    out = torch.zeros((h, w), dtype=torch.int32, device=device)
    if scaled is None:
        return out
    rows, ss, ee = (np.asarray(a, np.int64) for a in scaled)
    tc0 = _H * x0 - 2 * _H
    tw = _H * w + _H
    cs = np.clip(ss - tc0, 0, tw)
    ce = np.clip(ee + 1 - tc0, 0, tw)
    band_h = max(1, _BAND_SAMPLES // (_H * (tw + 1)) - 1)
    for by in range(0, h, band_h):
        bh = min(band_h, h - by)
        r = rows - (_H * (y0 + by) - 2 * _H)
        t_mask = mask_of_spans(1, _H * bh + _H, tw, np.zeros_like(r), r, cs, ce, device)
        out[by : by + bh] = coverage_counts(t_mask, bh, w)[0]
    return out


def polygon_sprite_edgelist(fill, shp, edges: np.ndarray, winding: str):
    """AA sprite of an edge list within shape `shp` (polygon.ml:729-746),
    on the shape's device.

    Every pixel of `shp` gets ``dissolve(fill(x, y), opacity)`` where opacity
    is the Gaussian-filtered coverage of the 16x-scaled polygon.
    """
    if shp is None:
        return NULL_SPRITE
    scaled = scanline.scaled_spans_of_edgelist(edges, winding, _H)
    h, w = shp.mask.shape
    dev = shp.mask.device
    opacity = coverage_opacity(shp.box, scaled, dev)
    dissolved = C.dissolve_rgba(fill.image_device(shp.box, h, w, dev), opacity)
    return Sprite(shp.box, shp.mask, torch.where(shp.mask[..., None], dissolved, 0))


def polygon_sprite(fill, shp, path):
    """AA sprite of a path (polygon.ml:748-750)."""
    from ..geometry.path import edgelist_of_path

    return polygon_sprite_edgelist(fill, shp, edgelist_of_path(path), path.winding)
