"""Sparse tiled-scene compositor: per-tile front-to-back object lists.

The PyTorch counterpart of ``coherence_tpu.raster.tiled_scene``.  Each
object's raster is shattered into frame-aligned TILE_H x TILE_W pieces of
packed RGBA, held in one atlas tensor of shape (capacity, TILE_H, TILE_W);
per frame the host builds each tile's front-to-back list of atlas slots
with box arithmetic, and one kernel launch composites the listed pieces:

  * ``composite_dirty`` over a compacted list of dirty-tile slots, in place
    on the frame (replaces the Pallas ``_kernel_subset``);
  * ``composite_full`` over every tile into a fresh frame (replaces both
    ``_kernel_atlas_row`` and ``_kernel``: they compute the same function,
    because ``over`` onto an opaque accumulator is the identity);
  * ``composite_runs`` over every tile into a fresh frame, from the listed
    pieces gathered tile-major into contiguous runs (``gather_runs``;
    replaces ``_kernel_runs_row``).

Each wrapper picks by the tensors' device: on the CPU it runs the plain
PyTorch version beside it here; on a CUDA device it launches the hand
written Hopper kernel (``coherence_tpu_torch.kernels``) or raises.

Where the JAX package donates a buffer to a program that returns its
update, the port updates the tensor in place: the atlas in ``shatter_into``
and ``add_rastered``, the frame in ``composite_dirty``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .compositor import TILE_H, TILE_W, _over_packed, pack_rgba
from .region import Sprite


def _tiles(plane: torch.Tensor) -> torch.Tensor:
    """(nty, ntx, TILE_H, TILE_W) view of a tile-aligned (ph, pw) plane."""
    ph, pw = plane.shape
    return plane.view(ph // TILE_H, TILE_H, pw // TILE_W, TILE_W).transpose(1, 2)


def _fold(acc: torch.Tensor, atlas: torch.Tensor, idxs: Optional[torch.Tensor], lo: torch.Tensor,
          hi: torch.Tensor) -> torch.Tensor:
    """Front-to-back fold of each tile's list idxs[lo[i]:hi[i]] (slots
    lo[i]:hi[i] themselves when `idxs` is None) into acc[i], with the
    per-pixel open mask of the reference kernels (a pixel stops taking
    pieces once its alpha is 255)."""
    depth = hi - lo
    for d in range(int(depth.max()) if depth.numel() else 0):
        sel = torch.nonzero(depth > d).flatten()
        a = acc[sel]
        slots = lo[sel] + d
        layer = atlas[slots if idxs is None else idxs[slots].long()]
        open_mask = ((a >> 24) & 0xFF) != 255
        acc[sel] = torch.where(open_mask, _over_packed(a, layer), a)
    return acc


def composite_full_torch(starts, idxs, background, atlas, nty: int, ntx: int) -> torch.Tensor:
    """Plain version of ``composite_full``: every tile's pieces
    idxs[starts[t]:starts[t+1]] over its background tile, into a new frame."""
    starts = starts.long()
    acc = torch.zeros((nty * ntx, TILE_H, TILE_W), dtype=torch.int32, device=atlas.device)
    acc = _fold(acc, atlas, idxs, starts[:-1], starts[1:])
    out = torch.empty_like(background)
    _tiles(out)[...] = _over_packed(acc.view(nty, ntx, TILE_H, TILE_W), _tiles(background))
    return out


# Pieces per chunk of the run walk (the JAX package's _RUN_CHUNK): the runs
# end in _RUN_CHUNK - 1 zero pieces, as the reference pads them.
_RUN_CHUNK = 4


def gather_runs(atlas: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """Tile-major piece runs: runs[k] = atlas[idxs[k]], then _RUN_CHUNK - 1
    zero pieces (the JAX package's _gather_runs_kernel, an XLA op outside
    its Pallas kernel)."""
    pad = torch.zeros((_RUN_CHUNK - 1, TILE_H, TILE_W), dtype=atlas.dtype, device=atlas.device)
    return torch.cat([atlas.index_select(0, idxs), pad])


def composite_runs_torch(starts, background, runs, nty: int, ntx: int) -> torch.Tensor:
    """Plain version of ``composite_runs``: every tile's pieces
    runs[starts[t]:starts[t+1]] over its background tile, into a new frame."""
    starts = starts.long()
    acc = torch.zeros((nty * ntx, TILE_H, TILE_W), dtype=torch.int32, device=runs.device)
    acc = _fold(acc, runs, None, starts[:-1], starts[1:])
    out = torch.empty_like(background)
    _tiles(out)[...] = _over_packed(acc.view(nty, ntx, TILE_H, TILE_W), _tiles(background))
    return out


def composite_dirty_torch(coords, spans, idxs, background, frame, atlas, n_slots: int) -> torch.Tensor:
    """Plain version of ``composite_dirty``: slot j recomposites tile
    (coords[2j], coords[2j+1]) from idxs[spans[2j]:spans[2j+1]] over its
    background tile, in place in `frame`; a slot with spans[2j] < 0 leaves
    its tile as it is."""
    coords = coords.long().view(n_slots, 2)
    spans = spans.long().view(n_slots, 2)
    live = spans[:, 0] >= 0
    ty, tx = coords[live, 0], coords[live, 1]
    acc = torch.zeros((int(live.sum()), TILE_H, TILE_W), dtype=torch.int32, device=atlas.device)
    acc = _fold(acc, atlas, idxs, spans[live, 0], spans[live, 1])
    _tiles(frame)[ty, tx] = _over_packed(acc, _tiles(background)[ty, tx])
    return frame


def composite_full(starts, idxs, background, atlas, nty: int, ntx: int) -> torch.Tensor:
    """Every tile's listed pieces over the background, into a new frame."""
    if atlas.device.type == "cpu":
        return composite_full_torch(starts, idxs, background, atlas, nty, ntx)
    return kernels.composite_full(starts, idxs, background, atlas, nty, ntx)


def composite_runs(starts, background, runs, nty: int, ntx: int) -> torch.Tensor:
    """Every tile's run of pieces over the background, into a new frame."""
    if runs.device.type == "cpu":
        return composite_runs_torch(starts, background, runs, nty, ntx)
    return kernels.composite_runs(starts, background, runs, nty, ntx)


def composite_dirty(coords, spans, idxs, background, frame, atlas, n_slots: int) -> torch.Tensor:
    """The listed dirty tiles recomposited in place in `frame`."""
    if atlas.device.type == "cpu":
        return composite_dirty_torch(coords, spans, idxs, background, frame, atlas, n_slots)
    return kernels.composite_dirty(coords, spans, idxs, background, frame, atlas, n_slots)


def shatter_into(atlas: torch.Tensor, rgba: torch.Tensor, oys, oxs, base: int) -> torch.Tensor:
    """Pack `rgba` and shatter it into len(oys) pieces written in place at
    atlas slots [base, base + n): piece[r, c] = packed[r + oy, c + ox],
    zero outside the raster."""
    packed = pack_rgba(rgba)
    hs, ws = packed.shape
    dev = atlas.device
    iy = torch.arange(TILE_H, device=dev)[None, :] + torch.as_tensor(np.asarray(oys), device=dev)[:, None]
    ix = torch.arange(TILE_W, device=dev)[None, :] + torch.as_tensor(np.asarray(oxs), device=dev)[:, None]
    valid = ((iy >= 0) & (iy < hs))[:, :, None] & ((ix >= 0) & (ix < ws))[:, None, :]
    g = packed[iy.clamp(0, hs - 1)[:, :, None], ix.clamp(0, ws - 1)[:, None, :]]
    atlas[base : base + len(oys)] = torch.where(valid, g, 0)
    return atlas


class PieceMap(dict):
    """``key -> [(tile, entry), ...]`` with a maintained reverse index
    ``by_tile: tile -> {key: [entries]}``, so per-frame host work scales
    with the dirty tiles instead of the scene.  Every mutation assigns a
    whole entry list, so __setitem__ is the one place the index updates."""

    def __init__(self):
        super().__init__()
        self.by_tile: Dict[int, Dict[object, List[int]]] = {}

    def __setitem__(self, key, entries):
        for tile, _ in super().get(key) or ():
            d = self.by_tile.get(tile)
            if d is not None:
                d.pop(key, None)
                if not d:
                    del self.by_tile[tile]
        entries = list(entries)
        super().__setitem__(key, entries)
        for tile, entry in entries:
            self.by_tile.setdefault(tile, {}).setdefault(key, []).append(entry)

    def __delitem__(self, key):
        self[key] = []
        super().__delitem__(key)

    def pop(self, key, *default):
        if key in self:
            got = self[key]
            del self[key]
            return got
        if default:
            return default[0]
        raise KeyError(key)

    def tile_entries(self, tile: int, pos: Dict[object, int], skip=None) -> List[Tuple[int, int]]:
        """(order_pos, entry) pairs of every ordered key covering `tile`."""
        out = []
        for key, es in self.by_tile.get(tile, {}).items():
            if skip is not None and key in skip:
                continue
            p = pos.get(key)
            if p is not None:
                out.extend((p, e) for e in es)
        return out


class TiledScene:
    """Frame-grid atlas of object raster pieces + per-frame tile lists."""

    def __init__(self, width: int, height: int, device):
        if width % TILE_W or height % TILE_H:
            raise ValueError(f"frame {width}x{height} is not a multiple of the {TILE_W}x{TILE_H} tile")
        self.width, self.height = width, height
        self.ntx = width // TILE_W
        self.nty = height // TILE_H
        self.device = torch.device(device)
        # ONE (cap, TH, TW) int32 buffer, cap a pow2 >= _n_pieces; slots
        # >= _n_pieces are zero (reserve_slots relies on it).
        self._data: Optional[torch.Tensor] = None
        self._n_pieces = 0
        # Sorted disjoint (start, len) runs of freed slots below _n_pieces.
        self._free_runs: List[Tuple[int, int]] = []
        self.pieces: PieceMap = PieceMap()
        # animated objects: key -> (slot base, capacity)
        self._reserved: Dict[object, Tuple[int, int]] = {}
        self._order_cache: Optional[Tuple[object, int, Dict[object, int]]] = None

    def reset(self) -> None:
        """Clear the scene and keep the atlas's capacity: the slots re-zero
        in place (restoring the spare-capacity invariant) and the piece
        lists, reservations and caches clear.  An in-place scene swap, as
        an interactive zoom makes, then reuses the allocation."""
        if self._data is not None:
            self._data.zero_()
        self._n_pieces = 0
        self._free_runs = []
        self.pieces = PieceMap()
        self._reserved = {}
        self._order_cache = None

    def _ensure(self, k: int) -> None:
        """Spare capacity for `k` more pieces; new slots are zero."""
        need = self._n_pieces + k
        cap = 8 if self._data is None else int(self._data.shape[0])
        while cap < need:
            cap *= 2
        if self._data is None:
            self._data = torch.zeros((cap, TILE_H, TILE_W), dtype=torch.int32, device=self.device)
        elif cap > self._data.shape[0]:
            pad = torch.zeros((cap - self._data.shape[0], TILE_H, TILE_W), dtype=torch.int32, device=self.device)
            self._data = torch.cat([self._data, pad])

    def _alloc(self, k: int) -> int:
        """`k` contiguous slots: best fit from the free pool, else appended.
        The caller fully overwrites them before installing entries."""
        best = None
        for i, (start, ln) in enumerate(self._free_runs):
            if ln >= k and (best is None or ln < self._free_runs[best][1]):
                best = i
                if ln == k:
                    break
        if best is not None:
            start, ln = self._free_runs[best]
            if ln == k:
                self._free_runs.pop(best)
            else:
                self._free_runs[best] = (start + k, ln - k)
            return start
        self._ensure(k)
        base = self._n_pieces
        self._n_pieces += k
        return base

    def _free_entries(self, entries) -> None:
        """Return entries' slots to the free pool as coalesced runs."""
        slots = sorted(e for _, e in entries)
        if not slots:
            return
        runs = []
        s0 = prev = slots[0]
        for s in slots[1:]:
            if s == prev + 1:
                prev = s
            else:
                runs.append((s0, prev - s0 + 1))
                s0 = prev = s
        runs.append((s0, prev - s0 + 1))
        out: List[Tuple[int, int]] = []
        for start, ln in sorted(self._free_runs + runs):
            if out and start <= out[-1][0] + out[-1][1]:
                if start != out[-1][0] + out[-1][1]:
                    raise RuntimeError("double free of atlas slots")
                out[-1] = (out[-1][0], start + ln - out[-1][0])
            else:
                out.append((start, ln))
        self._free_runs = out

    def _free_object(self, key) -> None:
        res = self._reserved.pop(key, None)
        if res is not None:
            base, cap = res
            self._free_entries([(0, base + j) for j in range(cap)])
            self.pieces.pop(key, None)
        else:
            old = self.pieces.pop(key, None)
            if old:
                self._free_entries(old)

    def set_empty(self, key) -> None:
        """Install an empty piece list for `key`, freeing its slots."""
        self._free_object(key)
        self.pieces[key] = []

    def _order_pos(self, order) -> Dict[object, int]:
        cached = self._order_cache
        if cached is not None and cached[0] is order and cached[1] == len(order):
            return cached[2]
        pos = {k: i for i, k in enumerate(order)}
        self._order_cache = (order, len(order), pos)
        return pos

    def _coords_of_box(self, box) -> List[Tuple[int, int]]:
        """(ty, tx) of the grid tiles a 1-based box overlaps."""
        x0, y0, x1, y1 = box
        tx_lo, tx_hi = max(0, (x0 - 1) // TILE_W), min(self.ntx - 1, (x1 - 1) // TILE_W)
        ty_lo, ty_hi = max(0, (y0 - 1) // TILE_H), min(self.nty - 1, (y1 - 1) // TILE_H)
        return [(ty, tx) for ty in range(ty_lo, ty_hi + 1) for tx in range(tx_lo, tx_hi + 1)]

    def add_object(self, key, spr: Sprite) -> None:
        """Shatter a sprite into frame-aligned pieces (replacing `key`'s)."""
        if key not in self._reserved:
            old = self.pieces.get(key)
            if old:
                self._free_entries(old)
                self.pieces[key] = []
        coords = self._coords_of_box(spr.box)
        if not coords:
            self.pieces[key] = []
            return
        x0, y0 = spr.box[0], spr.box[1]
        oys = [ty * TILE_H - (y0 - 1) for ty, _ in coords]
        oxs = [tx * TILE_W - (x0 - 1) for _, tx in coords]
        base = self._alloc(len(coords))
        shatter_into(self._data, spr.rgba, oys, oxs, base)
        self.pieces[key] = [(ty * self.ntx + tx, base + j) for j, (ty, tx) in enumerate(coords)]

    def add_rastered(self, registry, blocks) -> None:
        """Ingest tile_raster pieces: `blocks` is a list of (n, TILE_H,
        TILE_W) int32 tensors, `registry` maps key -> [(tile, block_id,
        slot)].  All blocks paste into one contiguous run of slots."""
        for key in registry:
            if key not in self._reserved and self.pieces.get(key):
                self._free_entries(self.pieces[key])
                self.pieces[key] = []
        sizes = [int(blk.shape[0]) for blk in blocks]
        total = sum(sizes)
        off = self._alloc(total) if total else 0
        base = []
        for blk, sz in zip(blocks, sizes):
            base.append(off)
            self._data[off : off + sz] = blk
            off += sz
        for key, pieces in registry.items():
            self.pieces[key] = [(tile, base[b] + slot) for tile, b, slot in pieces]

    def reserve_slots(self, key, cap: int) -> None:
        """Reserve `cap` fixed slots for an animated object, appended (never
        recycled: they must start zero)."""
        base = self._n_pieces
        self._ensure(cap)
        self._n_pieces += cap
        self._reserved[key] = (base, cap)
        self.pieces[key] = []

    def _inplace_args(self, key, spr: Sprite):
        """(oys, oxs, base, entries) for the in-place shatter of an
        animated object, or None for an off-grid sprite.  The offsets are
        padded to the reserved capacity by repeating the last piece."""
        base, cap = self._reserved[key]
        coords = self._coords_of_box(spr.box)
        if len(coords) > cap:
            raise ValueError(f"update_object_inplace: {len(coords)} pieces > cap {cap}")
        if not coords:
            return None
        x0, y0 = spr.box[0], spr.box[1]
        padded = coords + [coords[-1]] * (cap - len(coords))
        oys = np.asarray([ty * TILE_H - (y0 - 1) for ty, _ in padded], np.int64)
        oxs = np.asarray([tx * TILE_W - (x0 - 1) for _, tx in padded], np.int64)
        entries = [(ty * self.ntx + tx, base + j) for j, (ty, tx) in enumerate(coords)]
        return oys, oxs, base, entries

    def update_object_inplace(self, key, spr: Sprite) -> None:
        """Shatter an animated object into its reserved slots, in place."""
        got = self._inplace_args(key, spr)
        if got is None:
            self.pieces[key] = []
            return
        oys, oxs, base, entries = got
        shatter_into(self._data, spr.rgba, oys, oxs, base)
        self.pieces[key] = entries

    def atlas(self) -> torch.Tensor:
        if self._data is None:
            self._ensure(0)
        return self._data

    def build_lists(self, order: List[object]):
        """(starts, idxs) int32 tensors on the scene's device: tile t's
        front-to-back atlas slots are idxs[starts[t]:starts[t+1]].  idxs is
        zero-padded to a pow2 no smaller than the atlas capacity, as in the
        JAX package."""
        n_tiles = self.ntx * self.nty
        per_tile: List[List[int]] = [[] for _ in range(n_tiles)]
        for key in order:
            for tile, entry in self.pieces.get(key, ()):
                per_tile[tile].append(entry)
        starts = np.zeros(n_tiles + 1, dtype=np.int32)
        starts[1:] = np.cumsum([len(p) for p in per_tile])
        n_idx = 8
        while n_idx < starts[-1]:
            n_idx *= 2
        n_idx = max(n_idx, int(self.atlas().shape[0]))
        idxs = np.zeros(n_idx, dtype=np.int32)
        idxs[: starts[-1]] = [e for p in per_tile for e in p]
        return torch.from_numpy(starts).to(self.device), torch.from_numpy(idxs).to(self.device)

    def render_full(self, background, starts, idxs) -> torch.Tensor:
        """Every listed piece over `background`, into a new frame."""
        return composite_full(starts, idxs, background, self.atlas(), self.nty, self.ntx)

    def render_runs(self, background, starts, idxs) -> torch.Tensor:
        """Every listed piece over `background`, into a new frame, through
        the run-contiguous compositor: the listed pieces are gathered
        tile-major first.  Equal to render_full."""
        runs = gather_runs(self.atlas(), idxs)
        return composite_runs(starts, background, runs, self.nty, self.ntx)

    def _dirty_args(self, order, dirty_tiles, pieces_override=None):
        """Host (coords, spans, idxs, n_slots) numpy arrays for the compacted
        dirty-tile slots, or None when nothing is dirty.  Slot arrays are
        flat (2 * n_slots,): slot j at [2j, 2j+1].  Padding slots repeat the
        last real slot.  `pieces_override` maps key -> entries to use
        instead of self.pieces[key]."""
        dirty = sorted(set(dirty_tiles))
        if not dirty:
            return None
        pos = self._order_pos(order)
        over_by_tile: Dict[int, List[Tuple[int, int]]] = {}
        for key, entries in (pieces_override or {}).items():
            p = pos.get(key)
            if p is not None:
                for tile, entry in entries:
                    over_by_tile.setdefault(tile, []).append((p, entry))
        n = len(dirty)
        n_slots = 8
        while n_slots < n:
            n_slots *= 2
        coords = np.zeros(2 * n_slots, np.int32)
        spans = np.zeros(2 * n_slots, np.int32)
        idxs_list: List[int] = []
        for j, t in enumerate(dirty):
            cand = self.pieces.tile_entries(t, pos, skip=pieces_override)
            cand.extend(over_by_tile.get(t, ()))
            cand.sort()
            coords[2 * j], coords[2 * j + 1] = t // self.ntx, t % self.ntx
            spans[2 * j] = len(idxs_list)
            idxs_list.extend(e for _, e in cand)
            spans[2 * j + 1] = len(idxs_list)
        coords[2 * n :: 2] = coords[2 * n - 2]
        coords[2 * n + 1 :: 2] = coords[2 * n - 1]
        spans[2 * n :: 2] = spans[2 * n - 2]
        spans[2 * n + 1 :: 2] = spans[2 * n - 1]
        n_idx = 8
        while n_idx < len(idxs_list):
            n_idx *= 2
        idxs = np.zeros(n_idx, np.int32)
        idxs[: len(idxs_list)] = idxs_list
        return coords, spans, idxs, n_slots

    def render_dirty(self, frame, background, order, dirty_tiles) -> torch.Tensor:
        """Re-render only `dirty_tiles`, in place in `frame`."""
        got = self._dirty_args(order, dirty_tiles)
        if got is None:
            return frame
        coords, spans, idxs, n_slots = got
        return composite_dirty(*self.upload(coords, spans, idxs), background, frame, self.atlas(), n_slots)

    def upload(self, *arrays) -> List[torch.Tensor]:
        """Host int32 arrays as tensors on the scene's device."""
        return [torch.from_numpy(a).to(self.device) for a in arrays]
