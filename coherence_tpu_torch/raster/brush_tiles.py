"""Batched brush-stroke rasterization at atlas-tile granularity.

The PyTorch counterpart of ``coherence_tpu.raster.brush_tiles``.  Strokes
are staged on the host (stamp points, the stroke's box grown by the brush
radius, its grid-clipped tile set) and grouped by the JAX package's static
buckets; ``flush`` rasterizes each group into the (TILE_H, TILE_W) pieces
that ``TiledScene.add_rastered`` ingests:

  * the stamps alpha_over the Gaussian patch one after another, in the
    reference's order and integer arithmetic, batched over the group's
    strokes (each stroke owns its own plane);
  * the stroke's shape mask is the box-window dilation of the stamp-point
    plane (``region._box_count > 0``, the reference's bloat);
  * the plain fill dissolves by the stamped alpha inside the mask, and each
    (stroke, tile) piece is sliced out packed.

The JAX package runs this as one XLA program per group, not as a Pallas
kernel.  On a CUDA device a group is one launch of the hand-written
``brush_stamp`` kernel in piece mode, its host lists in one staged copy;
on the CPU it is torch operations (``_group_block_torch``).  Blocks keep
the JAX layout (sorted groups, pow2 stroke and piece buckets, padding
pieces cut from stroke 0 at the plane origin), so a scene's atlas is equal
to the reference's slot for slot.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import colour as C
from .. import kernels
from . import aa as raa
from . import region
from .brush import (
    GAUSSIAN,
    _int_points,
    _stamp_alpha_torch,
    drawround_alpha,
    points_of_brushstroke,
    sizeof_brush,
)
from .compositor import TILE_H, TILE_W, pack_rgba

# Stamp-point coordinates the JAX scatter drops (its mode="drop"); the
# host filters them out before the scatter here.
_FAR = 32767


def _group_lists(npb: int, items) -> tuple:
    """A group's host lists: (brushes (s, bhb, bwb), offsets (s, npb, 2),
    valid (s, npb), points (s, npb, 2) with _FAR padding, fills (s, 4),
    radii (s, 2) as (wr, hr), meta (pb, 3)).  meta lists each stroke's
    pieces as (stroke, plane row, plane col) in staging order, then
    padding pieces up to the pow2 bucket: stroke 0's plane at the origin,
    as the JAX package's zero meta rows slice it."""
    s = len(items)
    offsets = np.zeros((s, npb, 2), np.int32)
    valid = np.zeros((s, npb), bool)
    points = np.full((s, npb, 2), _FAR, np.int32)
    for si, it in enumerate(items):
        offsets[si, : len(it[2])] = it[2]
        valid[si, : len(it[3])] = it[3]
        points[si, : len(it[4])] = it[4]
    metas = [(si, oy, ox) for si, it in enumerate(items) for _tile, oy, ox in it[7]]
    meta = np.zeros((raa.span_bucket(len(metas), floor=8), 3), np.int32)
    meta[: len(metas)] = metas
    return (np.stack([it[1] for it in items]), offsets, valid, points,
            np.stack([it[5] for it in items]), np.array([it[6] for it in items], np.int32).reshape(s, 2), meta)


class BrushTileBuild:
    """Accumulate plain-filled Gaussian brush strokes; ``flush`` returns
    (blocks, registry) for ``TiledScene.add_rastered``.  Keys whose strokes
    produce no visible pieces appear in the registry with an empty list."""

    def __init__(self, nty: int, ntx: int, device):
        self.nty, self.ntx = nty, ntx
        self.device = torch.device(device)
        # static-bucket key -> list of per-stroke host data
        self.groups: Dict[tuple, list] = {}
        self.empty_keys: List[object] = []

    def add_stroke(self, key, brushstroke, fill4) -> bool:
        """Stage one stroke's host data.  False when the stroke is not a
        Gaussian brush (those need the scalar path)."""
        brush, _path = brushstroke
        opacity, kind = brush
        if kind[0] != GAUSSIAN:
            return False
        points = _int_points(points_of_brushstroke(brushstroke))
        if not points:
            self.empty_keys.append(key)
            return True
        bw, bh = sizeof_brush(brush)
        wr, hr = (bw - 1) // 2, (bh - 1) // 2
        parr = np.asarray(points, np.int64)
        x0, y0 = int(parr[:, 0].min()), int(parr[:, 1].min())
        x1, y1 = int(parr[:, 0].max()), int(parr[:, 1].max())
        # Shape box = point bbox grown by the brush radii (region.bloat).
        sx0, sy0, sx1, sy1 = x0 - wr, y0 - hr, x1 + wr, y1 + hr
        tx_lo = max(0, (sx0 - 1) // TILE_W)
        tx_hi = min(self.ntx - 1, (sx1 - 1) // TILE_W)
        ty_lo = max(0, (sy0 - 1) // TILE_H)
        ty_hi = min(self.nty - 1, (sy1 - 1) // TILE_H)
        if tx_hi < tx_lo or ty_hi < ty_lo:
            self.empty_keys.append(key)
            return True
        th, tw = ty_hi - ty_lo + 1, tx_hi - tx_lo + 1
        bhb, bwb = region.bucket_hw(bh, bw)
        th_b, tw_b = raa.span_bucket(th, floor=1), raa.span_bucket(tw, floor=1)
        hp = bhb + th_b * TILE_H + 2 * bhb
        wp = bwb + tw_b * TILE_W + 2 * bwb
        # Plane row 0 / col 0 in 1-based frame pixels.
        oy0 = ty_lo * TILE_H + 1 - bhb
        ox0 = tx_lo * TILE_W + 1 - bwb
        offs = np.stack([parr[:, 1] - hr - oy0, parr[:, 0] - wr - ox0], axis=1).astype(np.int32)
        # A stamp is kept iff its (bh, bw) patch can touch the real tile
        # region; kept offsets then keep the padded patch inside the plane,
        # and dropped stamps cannot touch any piece pixel.  Dropped offsets
        # are zeroed as in the JAX package, whose dynamic_slice would clamp
        # an out-of-range one.
        val = (
            (offs[:, 0] + bh > bhb)
            & (offs[:, 0] < bhb + th * TILE_H)
            & (offs[:, 1] + bw > bwb)
            & (offs[:, 1] < bwb + tw * TILE_W)
        )
        offs[~val] = 0
        pt = np.stack([parr[:, 1] - oy0, parr[:, 0] - ox0], axis=1).astype(np.int32)
        outside = (pt[:, 0] < 0) | (pt[:, 0] >= hp) | (pt[:, 1] < 0) | (pt[:, 1] >= wp)
        pt[outside] = _FAR
        npb = raa.span_bucket(len(points), floor=8)
        gkey = (hp, wp, bhb, bwb, npb)
        pieces = [
            (ty * self.ntx + tx, bhb + (ty - ty_lo) * TILE_H, bwb + (tx - tx_lo) * TILE_W)
            for ty in range(ty_lo, ty_hi + 1)
            for tx in range(tx_lo, tx_hi + 1)
        ]
        bpad = np.zeros((bhb, bwb), np.int32)
        bpad[:bh, :bw] = drawround_alpha(kind[1], opacity)
        self.groups.setdefault(gkey, []).append(
            (key, bpad, offs, val, pt, np.asarray(fill4, np.int32), (wr, hr), pieces)
        )
        return True

    def _group_block(self, hp: int, wp: int, bhb: int, bwb: int, npb: int, items) -> torch.Tensor:
        """One group's (pb, TILE_H, TILE_W) int32 block: its strokes'
        pieces in staging order, then padding pieces.  On a CUDA device one
        ``brush_stamp`` launch (piece mode) makes it from the group's lists;
        on the CPU ``_group_block_torch``."""
        if self.device.type == "cpu":
            return self._group_block_torch(hp, wp, bhb, bwb, npb, items)
        return kernels.brush_stamp_pieces(*_group_lists(npb, items), hp, wp, self.device)

    def _group_block_torch(self, hp: int, wp: int, bhb: int, bwb: int, npb: int, items) -> torch.Tensor:
        """Plain version of ``_group_block``: the stamps as batched torch
        steps (``_stamp_alpha_torch``), then per stroke the point scatter,
        ``region._box_count``, the dissolve, the pack and one slice a
        piece."""
        brushes, offsets, valid, _, _, _, meta = _group_lists(npb, items)
        alpha = _stamp_alpha_torch(brushes, offsets, valid, hp, wp, self.device)
        planes = []
        for si, (_, _, _, _, pt, f4, (wr, hr), _) in enumerate(items):
            pt = torch.from_numpy(pt[pt[:, 0] != _FAR].astype(np.int64)).to(self.device)
            ptplane = torch.zeros((hp, wp), dtype=torch.int32, device=self.device)
            ptplane.index_put_((pt[:, 0], pt[:, 1]), torch.ones_like(pt[:, 0], dtype=torch.int32), accumulate=True)
            mask = region._box_count(ptplane, wr, hr) > 0
            fill = torch.from_numpy(f4).to(self.device)[None, None, :]
            planes.append(pack_rgba(torch.where(mask[..., None], C.dissolve_rgba(fill, alpha[si]), 0)))
        return torch.stack([planes[si][oy : oy + TILE_H, ox : ox + TILE_W] for si, oy, ox in meta])

    def flush(self):
        """Returns (blocks, registry): a list of (p, TILE_H, TILE_W) int32
        tensors and key -> [(tile, block_id, slot)]."""
        blocks: List[torch.Tensor] = []
        registry: Dict[object, List[Tuple[int, int, int]]] = {}
        for key in self.empty_keys:
            registry.setdefault(key, [])
        for gkey in sorted(self.groups):
            items = self.groups[gkey]
            slot = 0
            for it in items:
                entries = registry.setdefault(it[0], [])
                for tile, _oy, _ox in it[7]:
                    entries.append((tile, len(blocks), slot))
                    slot += 1
            blocks.append(self._group_block(*gkey, items))
        return blocks, registry
