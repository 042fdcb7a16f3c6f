"""Boxes and sprites: the subset of ``coherence_tpu.raster.region``
that the tiled frame path uses.

Boxes are the reference's inclusive ``(x0, y0, x1, y1)`` pixel boxes in
1-based coordinates; ``mask[y - y0, x - x0]``.  Unlike the JAX package, a
mask or plane here is exactly the box's size: the pow2 padding there exists
to bound the number of compiled programs, which eager PyTorch does not have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

Box = Tuple[int, int, int, int]  # x0, y0, x1, y1 inclusive


def box_union(a: Box, b: Box) -> Box:
    return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))


def box_intersect(a: Box, b: Box) -> Optional[Box]:
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    if x0 > x1 or y0 > y1:
        return None
    return (x0, y0, x1, y1)


def box_wh(b: Box) -> Tuple[int, int]:
    return b[2] - b[0] + 1, b[3] - b[1] + 1


_MIN_H, _MIN_W = 8, 128


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def bucket_hw(h: int, w: int) -> Tuple[int, int]:
    """The JAX package's pow2 window buckets.  The blur window keeps them:
    the window size decides which pixels the blend may write, so the
    port's windows must match the reference's exactly."""
    return _bucket(h, _MIN_H), _bucket(w, _MIN_W)


def _box_count(m_int: torch.Tensor, rx: int, ry: int) -> torch.Tensor:
    """Separable box-window sum of an int32 (H, W) plane over [x-rx, x+rx]
    x [y-ry, y+ry]; cells outside the plane count as zero.  `> 0` of it is
    the box dilation of a mask (the reference's bloat)."""
    H, W = m_int.shape
    dev = m_int.device
    # Row pass: windowed sum over columns, from clipped prefix-sum reads.
    c = torch.cumsum(m_int, dim=1, dtype=torch.int32)
    xx = torch.arange(W, device=dev)
    hi = c[:, (xx + rx).clamp(0, W - 1)]
    lo_idx = xx - rx - 1
    lo = torch.where(lo_idx >= 0, c[:, lo_idx.clamp(0, W - 1)], 0)
    row = hi - lo
    # Column pass: windowed sum over rows.
    c2 = torch.cumsum(row, dim=0, dtype=torch.int32)
    yy = torch.arange(H, device=dev)
    hi2 = c2[(yy + ry).clamp(0, H - 1), :]
    lo_idx2 = yy - ry - 1
    lo2 = torch.where((lo_idx2 >= 0)[:, None], c2[lo_idx2.clamp(0, H - 1), :], 0)
    return hi2 - lo2


@dataclass
class Sprite:
    box: Box
    mask: torch.Tensor  # bool (h, w): where the sprite is defined
    rgba: torch.Tensor  # int32 (h, w, 4) premultiplied; 0 outside mask


def translate_sprite(dx: int, dy: int, s: Optional[Sprite]) -> Optional[Sprite]:
    """A pure box shift (ref sprite.ml:469-501)."""
    if s is None:
        return None
    x0, y0, x1, y1 = s.box
    return Sprite((x0 + dx, y0 + dy, x1 + dx, y1 + dy), s.mask, s.rgba)
