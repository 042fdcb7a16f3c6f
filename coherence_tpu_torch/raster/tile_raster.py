"""Tile-normalized batched rasterizer: objects -> fixed-size atlas pieces.

The PyTorch counterpart of ``coherence_tpu.raster.tile_raster`` on its
per-class route (the JAX package's combined one-program route exists for
its remote TPU link and has no counterpart).  Every object rasterizes
directly into frame-aligned TILE_H x TILE_W pieces, the unit of the tiled
scene's atlas:

  * the host sweep runs once per object (``scanline._edge_spans`` at 1x and
    16x) and assigns spans to the tiles they overlap (the port's native
    library's fused expansion and grouping);
  * tiles with fringe pixels become *edge* items (1x coverage and crossing
    spans plus 16x AA spans); tiles inside the shape become *interior*
    items (crossing spans only);
  * items batch by span-capacity class; each batch scatters the spans into
    difference planes, prefix-sums them to masks, takes the Gaussian-matte
    AA coverage from the stride-16 table product (``raster/aa``), colours
    and packs.

Blocks keep the JAX package's batch layout (class order, fixed chunks,
pow2 buckets, zero padding slots), so a scene's atlas is bit-identical to
the reference's slot for slot.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import colour as C
from .. import native_lib
from . import aa as raa
from . import scanline
from .compositor import TILE_H, TILE_W, pack_rgba

_H = raa._H  # 16
_TTH = _H * TILE_H + _H  # scaled plane rows per tile (1040)
_TTW = _H * TILE_W + _H  # scaled plane cols per tile (2064)

# Span-capacity classes (K1 for each 1x family, KA for the 16x AA family)
# and the per-class batch chunks: they fix the block layout of the atlas.
_CLASSES = [(256, 4096), (512, 8192), (1024, 16384), (2048, 32768), (4096, 65536)]
_K_INTERIOR = 256
_CHUNKS = [256, 256, 128, 32, 8]
_CHUNK_INTERIOR = 32

# Edge items rasterized per step: each holds a 1040 x 2065 int32 difference
# plane and its prefix sum (~30 MB in all), so this bounds the working set.
_EDGE_STEP = 16


def _n_bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _batches(items: list, chunk: int) -> list:
    """[(batch_items, slots)]: one pow2-bucketed batch below `chunk` items,
    else fixed `chunk`-slot batches (the JAX package's block layout)."""
    nb = _n_bucket(len(items))
    if nb < chunk:
        return [(items, nb)]
    return [(items[i : i + chunk], chunk) for i in range(0, len(items), chunk)]


def _tile_masks(spans, h: int, w: int, device) -> torch.Tensor:
    """bool (n, h, w) masks from per-item (rows, starts, ends) span arrays
    (inclusive ends, tile-relative)."""
    lens = [len(r) for r, _, _ in spans]
    item = np.repeat(np.arange(len(spans)), lens)
    rows, ss, ee = (np.concatenate([s[i] for s in spans]) if spans else np.zeros(0, np.int64) for i in range(3))
    return raa.mask_of_spans(len(spans), h, w, item, rows, ss, ee + 1, device)


def _edge_impl(cov, cross, aasp, fills: torch.Tensor) -> torch.Tensor:
    """Edge-tile pieces: per-item (rows, starts, ends) 1x coverage, 1x
    crossing and 16x AA spans (tile-relative), (n, 4) int32 plain fills.
    Returns (n, TILE_H, TILE_W) packed int32 pieces."""
    device = fills.device
    covm = _tile_masks(cov, TILE_H, TILE_W, device)
    crossm = _tile_masks(cross, TILE_H, TILE_W, device)
    mmask = crossm & ~covm  # interior (minshape rule, polygon.ml:520-528)
    fringe = covm  # shape - minshape == coverage spans
    opacity = raa.coverage_counts(_tile_masks(aasp, _TTH, _TTW, device), TILE_H, TILE_W)
    colour = fills[:, None, None, :]
    dissolved = C.dissolve_rgba(colour, opacity)
    rgba = torch.where(
        mmask[..., None], colour, torch.where(fringe[..., None], dissolved, 0)
    )
    return pack_rgba(rgba)


def _interior_impl(cross, fills: torch.Tensor) -> torch.Tensor:
    """Interior pieces (no fringe in the tile): the fill where the crossing
    mask covers."""
    crossm = _tile_masks(cross, TILE_H, TILE_W, fills.device)
    return pack_rgba(torch.where(crossm[..., None], fills[:, None, None, :], 0))


class TileBuild:
    """Staged work items, flushed with one batched pass per class."""

    def __init__(self, nty: int, ntx: int, device):
        self.nty, self.ntx = nty, ntx
        self.device = torch.device(device)
        # class id -> [(owner_key, tile, cov, cross, aa, fill)]
        self.edge_items: Dict[int, list] = {}
        # [(owner_key, tile, cross, fill)]
        self.interior_items: list = []

    def add_object(self, key, edges, shape_winding, aa_winding, fill4) -> bool:
        """Sweep one object and stage its tile items.  False when it exceeds
        every capacity class (nothing is staged then)."""
        got = self._sweep_stage(np.asarray(edges, dtype=np.int64), shape_winding, aa_winding)
        if got is False:
            return False
        staged_edge, staged_interior = got
        for cls, tile, cov1, cross1, aa1 in staged_edge:
            self.edge_items.setdefault(cls, []).append((key, tile, cov1, cross1, aa1, fill4))
        for tile, cross1 in staged_interior:
            self.interior_items.append((key, tile, cross1, fill4))
        return True

    def _sweep_stage(self, e64, shape_winding, aa_winding):
        """([(cls, tile, cov, cross, aa)], [(tile, cross)]), or False."""
        # The grid is the viewport: sweep only rows that can land in it.
        spans = scanline._edge_spans(
            e64, shape_winding, scanline._HALF, rows_clip=(1, self.nty * TILE_H)
        )
        if spans is None:
            return [], []
        rows, cov_s, cov_e, x_rows, x_s, x_e = spans
        if rows.size == 0 and x_rows.size == 0:
            return [], []
        covg = native_lib.expand_1x_grouped(rows, cov_s, cov_e, self.nty, self.ntx, TILE_H, TILE_W)
        crossg = native_lib.expand_1x_grouped(x_rows, x_s, x_e, self.nty, self.ntx, TILE_H, TILE_W)
        edge_tiles = np.zeros(self.nty * self.ntx, dtype=bool)
        if covg:
            edge_tiles[list(covg)] = True
        aa = scanline.scaled_spans_of_edgelist(
            e64, aa_winding, _H, rows_clip=(-_H, self.nty * _H * TILE_H - 1)
        )
        aag = {}
        if aa is not None and covg:
            aag = native_lib.expand_aa_grouped(
                aa[0], aa[1], aa[2], self.nty, self.ntx,
                _H * TILE_H, _H * TILE_W, _H, _TTW, edge_tiles,
            )
        # Validate capacities up front so a too-complex object falls back
        # atomically (no partial piece sets).
        empty = (np.zeros(0, np.int64),) * 3
        staged_edge, staged_interior = [], []
        for t in sorted(set(covg) | set(crossg)):
            cov1 = covg.get(t)
            cross1 = crossg.get(t, empty)
            if cov1 is None:
                if 2 * cross1[0].shape[0] > _K_INTERIOR:
                    return False
                staged_interior.append((t, cross1))
                continue
            aa1 = aag.get(t, empty)
            need1 = 2 * max(cov1[0].shape[0], cross1[0].shape[0])
            needa = 2 * aa1[0].shape[0]
            cls = next(
                (ci for ci, (k1, ka) in enumerate(_CLASSES) if need1 <= k1 and needa <= ka),
                None,
            )
            if cls is None:
                return False
            staged_edge.append((cls, t, cov1, cross1, aa1))
        return staged_edge, staged_interior

    def _fills(self, items, col: int) -> torch.Tensor:
        return torch.from_numpy(np.asarray([it[col] for it in items], np.int32).reshape(-1, 4)).to(self.device)

    def flush(self):
        """Rasterize every staged item.  Returns (blocks, registry): blocks
        is a list of (n, TILE_H, TILE_W) int32 tensors whose slots past the
        real items are zero; registry maps owner_key -> [(tile, block_id,
        slot)]."""
        blocks: List[torch.Tensor] = []
        registry: Dict[object, List[Tuple[int, int, int]]] = {}

        def new_block(items, nb) -> torch.Tensor:
            for slot, it in enumerate(items):
                registry.setdefault(it[0], []).append((it[1], len(blocks), slot))
            blocks.append(torch.zeros((nb, TILE_H, TILE_W), dtype=torch.int32, device=self.device))
            return blocks[-1]

        for cls in sorted(self.edge_items):
            for items, nb in _batches(self.edge_items[cls], _CHUNKS[cls]):
                block = new_block(items, nb)
                for lo in range(0, len(items), _EDGE_STEP):
                    part = items[lo : lo + _EDGE_STEP]
                    block[lo : lo + len(part)] = _edge_impl(
                        [it[2] for it in part],
                        [it[3] for it in part],
                        [it[4] for it in part],
                        self._fills(part, 5),
                    )
        if self.interior_items:
            for items, nb in _batches(self.interior_items, _CHUNK_INTERIOR):
                block = new_block(items, nb)
                block[: len(items)] = _interior_impl([it[2] for it in items], self._fills(items, 3))
        return blocks, registry
