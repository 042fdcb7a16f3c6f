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
  * items batch by span-capacity class.  On a CUDA device a flush is one
    launch of TR1 (``kernels.tile_raster``, ``kernels/csrc/tile_raster.cu``)
    over every block, its span lists uploaded in one staged copy, the
    blocks views of its one output; on the CPU the plain version scatters
    the spans into difference planes, prefix-sums them to masks, takes the
    Gaussian-matte AA coverage from the stride-16 table product
    (``raster/aa``), colours and packs, block by block.

Blocks keep the JAX package's batch layout (class order, fixed chunks,
pow2 buckets, zero padding slots), so a scene's atlas is bit-identical to
the reference's slot for slot.

Each object's host sweep is memoized in a content-addressed, byte-capped
LRU (the JAX package's sweep cache): a zoom back to a scale seen before
re-stages from it every object whose edges come back bit for bit.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .. import colour as C
from .. import kernels, native_lib
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


# --- sweep cache ----------------------------------------------------------
# Content-addressed memo of TileBuild._sweep_stage results: (edge bytes,
# windings, grid) -> staged per-tile spans (host numpy only, so a hit serves
# any device).  Byte-capped LRU; exact-bytes keys make a hit bit-identical
# by construction (no invalidation).

_SWEEP_CACHE: "OrderedDict" = OrderedDict()
_SWEEP_CACHE_LOCK = threading.Lock()
_SWEEP_CACHE_MAX_BYTES = 256 << 20
_SWEEP_CACHE_BYTES = [0]
sweep_cache_stats = {"hits": 0, "misses": 0}


def _sweep_entry_bytes(ck, val) -> int:
    n = len(ck[0]) + 64
    if val is not False:
        for part in val:
            for item in part:
                for x in item:
                    if isinstance(x, tuple):
                        n += sum(a.nbytes for a in x)
    return n


def _sweep_cache_get(ck):
    with _SWEEP_CACHE_LOCK:
        got = _SWEEP_CACHE.get(ck)
        if got is None:
            sweep_cache_stats["misses"] += 1
            return None
        sweep_cache_stats["hits"] += 1
        _SWEEP_CACHE.move_to_end(ck)
        return got[0]


def _sweep_cache_put(ck, val) -> None:
    nb = _sweep_entry_bytes(ck, val)
    if nb > _SWEEP_CACHE_MAX_BYTES // 8:
        return  # one huge object must not evict the whole working set
    with _SWEEP_CACHE_LOCK:
        old = _SWEEP_CACHE.pop(ck, None)
        if old is not None:
            _SWEEP_CACHE_BYTES[0] -= old[1]
        _SWEEP_CACHE[ck] = (val, nb)
        _SWEEP_CACHE_BYTES[0] += nb
        while _SWEEP_CACHE_BYTES[0] > _SWEEP_CACHE_MAX_BYTES and _SWEEP_CACHE:
            _, (_, evicted) = _SWEEP_CACHE.popitem(last=False)
            _SWEEP_CACHE_BYTES[0] -= evicted


def sweep_cache_clear() -> None:
    with _SWEEP_CACHE_LOCK:
        _SWEEP_CACHE.clear()
        _SWEEP_CACHE_BYTES[0] = 0
        sweep_cache_stats["hits"] = sweep_cache_stats["misses"] = 0


class TileBuild:
    """Staged work items, flushed with one block per batch of a class."""

    def __init__(self, nty: int, ntx: int, device):
        self.nty, self.ntx = nty, ntx
        self.device = torch.device(device)
        # class id -> [(owner_key, tile, cov, cross, aa, fill)]
        self.edge_items: Dict[int, list] = {}
        # [(owner_key, tile, cross, fill)]
        self.interior_items: list = []

    def add_object(self, key, edges, shape_winding, aa_winding, fill4) -> bool:
        """Sweep one object and stage its tile items.  False when it exceeds
        every capacity class (nothing is staged then).  The sweep comes from
        the sweep cache where this geometry was swept before on this grid
        (False results are cached too)."""
        e64 = np.asarray(edges, dtype=np.int64)
        ck = (e64.tobytes(), shape_winding, aa_winding, self.nty, self.ntx)
        got = _sweep_cache_get(ck)
        if got is None:
            got = self._sweep_stage(e64, shape_winding, aa_winding)
            _sweep_cache_put(ck, got)
        if got is False:
            return False
        staged_edge, staged_interior = got
        for cls, tile, cov1, cross1, aa1 in staged_edge:
            self.edge_items.setdefault(cls, []).append((key, tile, cov1, cross1, aa1, fill4))
        for tile, cross1 in staged_interior:
            self.interior_items.append((key, tile, cross1, fill4))
        return True

    def _sweep_stage(self, e64, shape_winding, aa_winding):
        """([(cls, tile, cov, cross, aa)], [(tile, cross)]), or False: a pure
        function of (e64, windings, grid), the unit the sweep cache stores."""
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

    def batches(self) -> Iterator[Tuple[list, int, bool]]:
        """(items, slots, edge) for each block of the flush, in block order:
        every edge class in class order, then the interior items."""
        for cls in sorted(self.edge_items):
            for items, nb in _batches(self.edge_items[cls], _CHUNKS[cls]):
                yield items, nb, True
        if self.interior_items:
            for items, nb in _batches(self.interior_items, _CHUNK_INTERIOR):
                yield items, nb, False

    def kernel_lists(self, items, nb: int, edge: bool) -> tuple:
        """kernels.tile_raster_lists' block for `items` (a batch of
        batches()): (cov, cross, aa, fills, nb), cov and aa None for
        interior items."""
        fills = np.asarray([it[5 if edge else 3] for it in items], np.int32).reshape(-1, 4)
        if edge:
            return [it[2] for it in items], [it[3] for it in items], [it[4] for it in items], fills, nb
        return None, [it[2] for it in items], None, fills, nb

    def block(self, items, nb: int, edge: bool) -> torch.Tensor:
        """One block of `nb` pieces for `items` (a batch of batches()): on a
        CUDA device one TR1 launch (its lists in one staged copy), on the CPU
        the plain version."""
        if self.device.type != "cuda":
            return self.block_torch(items, nb, edge)
        return kernels.tile_raster(kernels.stage_tile_lists([self.kernel_lists(items, nb, edge)], self.device))

    def block_torch(self, items, nb: int, edge: bool) -> torch.Tensor:
        """The plain version of block() on this build's device: _edge_impl
        every _EDGE_STEP items, or _interior_impl, into a zeroed block."""
        out = torch.zeros((nb, TILE_H, TILE_W), dtype=torch.int32, device=self.device)
        fills = torch.from_numpy(np.asarray([it[5 if edge else 3] for it in items], np.int32).reshape(-1, 4))
        fills = fills.to(self.device)
        if not edge:
            if items:
                out[: len(items)] = _interior_impl([it[2] for it in items], fills)
            return out
        for lo in range(0, len(items), _EDGE_STEP):
            part = items[lo : lo + _EDGE_STEP]
            out[lo : lo + len(part)] = _edge_impl([it[2] for it in part], [it[3] for it in part],
                                                  [it[4] for it in part], fills[lo : lo + len(part)])
        return out

    def flush(self):
        """Rasterize every staged item.  Returns (blocks, registry): blocks
        is a list of (n, TILE_H, TILE_W) int32 tensors whose slots past the
        real items are zero (on a CUDA device views of one launch's output,
        its lists in one staged copy); registry maps owner_key -> [(tile,
        block_id, slot)]."""
        batches = list(self.batches())
        registry: Dict[object, List[Tuple[int, int, int]]] = {}
        for block_id, (items, _, _) in enumerate(batches):
            for slot, it in enumerate(items):
                registry.setdefault(it[0], []).append((it[1], block_id, slot))
        if self.device.type != "cuda":
            blocks = [self.block_torch(items, nb, edge) for items, nb, edge in batches]
        elif batches:
            out = kernels.tile_raster(kernels.stage_tile_lists([self.kernel_lists(*b) for b in batches], self.device))
            blocks = list(out.split([nb for _, nb, _ in batches]))
        else:
            blocks = []
        return blocks, registry
