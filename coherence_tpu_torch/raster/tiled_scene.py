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
    replaces ``_kernel_runs_row``);
  * ``composite_full_banded`` and ``composite_dirty_banded``, the same two
    compositions for every row band a device holds under a mesh, each band
    from its own local atlas (``BandedAtlas``; they replace the Pallas calls
    of ``render_sharded`` and ``render_dirty_sharded``).

  * ``shatter_into``, a moved sprite packed and cut into its reserved
    slots (the hand-written ``shatter_into`` kernel; it replaces the JAX
    package's ``_shatter_into_kernel``, an XLA program).

Each wrapper picks by the tensors' device: on the CPU it runs the plain
PyTorch version beside it here; on a CUDA device it launches the hand
written Hopper kernel (``coherence_tpu_torch.kernels``) or raises.  The
host lists a launch reads cross in one copy (``staging.stage``).

Where the JAX package donates a buffer to a program that returns its
update, the port updates the tensor in place: the atlas in ``shatter_into``
and ``add_rastered``, the frame in ``composite_dirty``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..parallel.mesh import Mesh, RowSharded
from .compositor import TILE_H, TILE_W, _over_packed, pack_rgba
from .region import Sprite
from .staging import stage


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


# Pieces per chunk of the JAX package's run walk (its _RUN_CHUNK): the runs
# end in _RUN_CHUNK - 1 zero pieces, the reference's layout; the port's
# kernel walks piece by piece and never reads past a tile's run.
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


def composite_full_banded_torch(starts, idxs, background, atlas, band_ty: int, ntx: int) -> torch.Tensor:
    """Plain version of ``composite_full_banded``: for each band b of the
    stack, composite_full_torch of its lists starts[b], idxs[b] over its
    rows of the background, from its local atlas atlas[b]."""
    band_h = band_ty * TILE_H
    out = torch.empty_like(background)
    for b in range(atlas.shape[0]):
        rows = slice(b * band_h, (b + 1) * band_h)
        out[rows] = composite_full_torch(starts[b], idxs[b], background[rows], atlas[b], band_ty, ntx)
    return out


def composite_dirty_banded_torch(coords, spans, idxs, background, frame, atlas, n_slots: int) -> torch.Tensor:
    """Plain version of ``composite_dirty_banded``: for each band b of the
    stack, composite_dirty_torch of its slots coords[b], spans[b], idxs[b]
    (band-local tile coordinates), in place in its rows of `frame`."""
    band_h = frame.shape[0] // atlas.shape[0]
    for b in range(atlas.shape[0]):
        rows = slice(b * band_h, (b + 1) * band_h)
        composite_dirty_torch(coords[b], spans[b], idxs[b], background[rows], frame[rows], atlas[b], n_slots)
    return frame


def composite_full_banded(starts, idxs, background, atlas, band_ty: int, ntx: int) -> torch.Tensor:
    """Every listed piece of every band of a device's stack over its
    background rows, into new rows: (n_bands, band_ty * ntx + 1) starts,
    (n_bands, k) band-local idxs, (n_bands, local_cap, TILE_H, TILE_W)
    local atlases, background (n_bands * band_ty * TILE_H, ntx * TILE_W)."""
    if atlas.device.type == "cpu":
        return composite_full_banded_torch(starts, idxs, background, atlas, band_ty, ntx)
    return kernels.composite_full_banded(starts, idxs, background, atlas, band_ty, ntx)


def composite_dirty_banded(coords, spans, idxs, background, frame, atlas, n_slots: int) -> torch.Tensor:
    """Every band's listed dirty tiles of a device's stack recomposited in
    place in `frame` (its bands' rows): (n_bands, 2 * n_slots) coords and
    spans, (n_bands, k) band-local idxs, (n_bands, local_cap, TILE_H,
    TILE_W) local atlases."""
    if atlas.device.type == "cpu":
        return composite_dirty_banded_torch(coords, spans, idxs, background, frame, atlas, n_slots)
    return kernels.composite_dirty_banded(coords, spans, idxs, background, frame, atlas, n_slots)


def shatter_into_torch(atlas: torch.Tensor, rgba: torch.Tensor, oys, oxs, base: int) -> torch.Tensor:
    """Plain version of ``shatter_into``: pack `rgba` and shatter it into
    pieces written in place at atlas slots [base, base + n): piece[j][r, c]
    = packed[r + oys[j], c + oxs[j]], zero outside the raster.  (n,) offsets
    write into a (cap, TILE_H, TILE_W) atlas; (n_bands, n) offsets into a
    stack of band atlases (n_bands, cap, TILE_H, TILE_W), band b from row b
    of the offsets.  Offsets may be host arrays or tensors on the atlas's
    device."""
    packed = pack_rgba(rgba)
    hs, ws = packed.shape
    dev = atlas.device
    iy = torch.arange(TILE_H, device=dev) + torch.as_tensor(oys, device=dev)[..., None]
    ix = torch.arange(TILE_W, device=dev) + torch.as_tensor(oxs, device=dev)[..., None]
    valid = ((iy >= 0) & (iy < hs))[..., :, None] & ((ix >= 0) & (ix < ws))[..., None, :]
    g = packed[iy.clamp(0, hs - 1)[..., :, None], ix.clamp(0, ws - 1)[..., None, :]]
    atlas[..., base : base + iy.shape[-2], :, :] = torch.where(valid, g, 0)
    return atlas


def shatter_into(atlas: torch.Tensor, rgba: torch.Tensor, oys, oxs, base: int) -> torch.Tensor:
    """The moved sprite's pieces written in place at atlas slots [base, base
    + n) (shatter_into_torch's function).  On a CUDA device host offsets
    cross in one staged copy, or come as int32 tensors on the card."""
    if atlas.device.type == "cpu":
        return shatter_into_torch(atlas, rgba, oys, oxs, base)
    if not isinstance(oys, torch.Tensor):
        oys, oxs = stage(atlas.device, oys, oxs)
    return kernels.shatter_into(atlas, rgba.contiguous(), oys, oxs, base)


class PieceMap(dict):
    """``key -> [(tile, entry), ...]`` with a maintained reverse index
    ``by_tile: tile -> {key: [entries]}``, so per-frame host work scales
    with the dirty tiles instead of the scene.  Every mutation assigns a
    whole entry list, so __setitem__ is the one place the index updates."""

    def __init__(self):
        super().__init__()
        self.by_tile: Dict[int, Dict[object, List[int]]] = {}
        self.version = 0  # bumps on every assignment (the banded atlas's cache key)

    def __setitem__(self, key, entries):
        self.version += 1
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
        # The per-band atlas of the last mesh render (_banded_of).
        self._banded: Optional[BandedAtlas] = None

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
        # The fresh PieceMap's version restarts at 0, so a cached banded
        # atlas could match a new scene's version: drop it.
        self._banded = None

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

    def remove_object(self, key) -> None:
        """Delete an object: its slots (its whole reserved run, for an
        animated one) return to the free pool for later adds.  The caller
        dirties its tiles and drops it from the compositing order."""
        self._free_object(key)

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

    def add_boxes(self, items) -> None:
        """Add plain-colour rectangles in bulk: ``items = [(key, (x0, y0,
        x1, y1), (r, g, b, a)), ...]`` (1-based inclusive boxes,
        premultiplied channels).  Every piece of every box is made straight
        into the atlas by a few torch operations for the whole call, with no
        sprite, pack or shatter per box.  The piece count is padded to a
        power of two (at least 8) with empty pieces, as in the JAX package,
        so the atlas layout matches it slot for slot."""
        metas: List[List[int]] = []
        regs = []
        for key, box, rgba in items:
            if key not in self._reserved and self.pieces.get(key):
                self._free_entries(self.pieces[key])
                self.pieces[key] = []
            x0, y0, x1, y1 = box
            r, g, b, a = (int(v) for v in rgba)
            col = int(np.asarray(r | (g << 8) | (b << 16) | (a << 24), np.uint32).view(np.int32))
            entries = []
            for ty, tx in self._coords_of_box(box):
                entries.append((ty * self.ntx + tx, len(metas)))
                metas.append([(x0 - 1) - tx * TILE_W, (y0 - 1) - ty * TILE_H, x1 - x0 + 1, y1 - y0 + 1, col])
            regs.append((key, entries))
        if not metas:
            for key, entries in regs:
                self.pieces[key] = entries
            return
        nb = 8
        while nb < len(metas):
            nb *= 2
        meta = np.zeros((nb, 5), np.int64)  # padding pieces are 0 x 0 boxes: zero pieces
        meta[: len(metas)] = metas
        base = self._alloc(nb)
        ox, oy, w, h, col = torch.from_numpy(meta).to(self.device)[:, :, None, None].unbind(1)
        rows = torch.arange(TILE_H, device=self.device)[:, None]
        cols = torch.arange(TILE_W, device=self.device)[None, :]
        inside = (rows >= oy) & (rows < oy + h) & (cols >= ox) & (cols < ox + w)
        self._data[base : base + nb] = torch.where(inside, col.to(torch.int32), 0)
        for key, entries in regs:
            self.pieces[key] = [(tile, base + e) for tile, e in entries]

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

    def build_lists(self, order: List[object], dirty_tiles=None):
        """(starts, idxs) int32 tensors on the scene's device: tile t's
        front-to-back atlas slots are idxs[starts[t]:starts[t+1]].  With
        `dirty_tiles`, only those tiles list pieces (the others render the
        background alone).  idxs is zero-padded to a pow2 no smaller than
        the atlas capacity, as in the JAX package."""
        n_tiles = self.ntx * self.nty
        per_tile: List[List[int]] = [[] for _ in range(n_tiles)]
        allowed = None if dirty_tiles is None else set(dirty_tiles)
        for key in order:
            for tile, entry in self.pieces.get(key, ()):
                if allowed is None or tile in allowed:
                    per_tile[tile].append(entry)
        starts = np.zeros(n_tiles + 1, dtype=np.int32)
        starts[1:] = np.cumsum([len(p) for p in per_tile])
        n_idx = 8
        while n_idx < starts[-1]:
            n_idx *= 2
        n_idx = max(n_idx, int(self.atlas().shape[0]))
        idxs = np.zeros(n_idx, dtype=np.int32)
        idxs[: starts[-1]] = [e for p in per_tile for e in p]
        return tuple(stage(self.device, starts, idxs))

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
        return composite_dirty(*stage(self.device, coords, spans, idxs), background, frame, self.atlas(), n_slots)


class BandedAtlas:
    """The atlas split by row bands for a mesh: band d's local atlas holds
    only the pieces whose tiles fall in band d, plus every reserved
    (animated) block, so a device holds about 1/n of the global atlas
    instead of a copy.

    The layout is the JAX package's, slot for slot: the reserved blocks
    first, at the same local offsets on every band (an animated object
    roams across bands, and one base addresses it on all of them), then the
    band's static pieces in global slot order.  Unused local slots hold a
    copy of global slot 0, as the reference's gather of a zero-filled index
    leaves them.  local_cap is a power of two, at least 8.  ``g2l[d]`` maps
    the global entries band d references to its local slots.

    ``data[g]`` is the stack (bands of mesh.groups[g], local_cap, TILE_H,
    TILE_W) int32 on that group's device.  The global atlas stays the
    source of truth; ``version`` is the PieceMap version it was built from
    or last brought up to date with (update_inplace)."""

    def __init__(self, ts: "TiledScene", mesh: Mesh):
        n = mesh.size
        if ts.nty % n:
            raise ValueError(f"{ts.nty} tile rows do not divide into {n} bands")
        band_tiles = ts.ntx * (ts.nty // n)
        res = sorted(ts._reserved.items(), key=lambda kv: kv[1][0])
        reserved_local: Dict[object, int] = {}
        res_g2l: Dict[int, int] = {}
        off = 0
        for key, (base, cap) in res:
            reserved_local[key] = off
            for j in range(cap):
                res_g2l[base + j] = off + j
            off += cap
        n_res = off
        statics = []
        for d in range(n):
            seen = set()
            for t in range(d * band_tiles, (d + 1) * band_tiles):
                for es in ts.pieces.by_tile.get(t, {}).values():
                    seen.update(e for e in es if e not in res_g2l)
            statics.append(sorted(seen))
        local_cap = 8
        while local_cap < n_res + max(len(s) for s in statics):
            local_cap *= 2
        gidx = np.zeros((n, local_cap), np.int64)
        g2l = []
        for d, band_statics in enumerate(statics):
            m = dict(res_g2l)
            for g, local in res_g2l.items():
                gidx[d, local] = g
            for j, g in enumerate(band_statics):
                m[g] = n_res + j
                gidx[d, n_res + j] = g
            g2l.append(m)
        atlas = ts.atlas()
        data = [atlas[torch.from_numpy(gidx[b0:b1]).to(atlas.device)].to(dev) for dev, b0, b1 in mesh.groups]
        self._set(mesh, data, g2l, reserved_local, local_cap, ts.pieces.version)

    def _set(self, mesh, data, g2l, reserved_local, local_cap, version) -> None:
        self.mesh = mesh
        self.data: List[torch.Tensor] = data
        self.g2l: List[Dict[int, int]] = g2l
        self.reserved_local: Dict[object, int] = reserved_local
        self.local_cap = local_cap
        self.version = version

    @classmethod
    def from_state(cls, mesh: Mesh, data, g2l, reserved_local, local_cap: int, version: int) -> "BandedAtlas":
        """A banded atlas holding the given per-group stacks and maps."""
        banded = cls.__new__(cls)
        banded._set(mesh, data, g2l, reserved_local, local_cap, version)
        return banded

    def map_entries(self, d: int, entries: List[int]) -> List[int]:
        g = self.g2l[d]
        return [g[e] for e in entries]

    def update_inplace(self, ts: "TiledScene", key, rgba, entries, oys, oxs) -> None:
        """The per-frame animated update: write the moved object's pieces
        into every band's reserved slots, one shatter per device over its
        stack.  A piece whose tile lies in the band gets its content; every
        other reserved slot gets zeros, through out-of-range offsets.  That
        is harmless: a band's lists reference only reserved slots whose
        tiles lie in that band.  Callers set ``version = ts.pieces.version``
        after installing the new piece list."""
        rb = self.reserved_local[key]
        base, cap = ts._reserved[key]
        band_tiles = ts.ntx * (ts.nty // self.mesh.size)
        oob = 1 << 20  # beyond any raster: the shatter yields zeros
        oys_b = np.full((self.mesh.size, cap), oob, np.int64)
        oxs_b = np.full((self.mesh.size, cap), oob, np.int64)
        for tile, g_entry in entries:
            j, d = g_entry - base, tile // band_tiles
            oys_b[d, j], oxs_b[d, j] = oys[j], oxs[j]
        for data, (dev, b0, b1) in zip(self.data, self.mesh.groups):
            shatter_into(data, rgba.to(dev), oys_b[b0:b1], oxs_b[b0:b1], rb)


def _banded_of(ts: TiledScene, mesh: Mesh) -> BandedAtlas:
    """The scene's banded atlas for `mesh`, rebuilt when the mesh or the
    piece lists changed since it was built."""
    cached = ts._banded
    if cached is not None and cached.mesh == mesh and cached.version == ts.pieces.version:
        return cached
    ts._banded = BandedAtlas(ts, mesh)
    return ts._banded


def _band_rows(plane, mesh: Mesh, band_h: int) -> RowSharded:
    return plane if isinstance(plane, RowSharded) else RowSharded.scatter(plane, mesh, band_h)


def sharded_lists(ts: TiledScene, order, banded: BandedAtlas):
    """Host (starts, idxs) int32 arrays, (n_bands, band_tiles + 1) and
    (n_bands, k): band d's local tile t (row-major in the band) composites
    its local slots idxs[d, starts[d, t]:starts[d, t + 1]].  Rows of idxs
    are zero-padded to the longest band's count, at least 1."""
    n = banded.mesh.size
    band_tiles = ts.ntx * (ts.nty // n)
    pos = ts._order_pos(order)
    starts = np.zeros((n, band_tiles + 1), np.int32)
    lists = []
    for d in range(n):
        g2l = banded.g2l[d]
        flat: List[int] = []
        for j, t in enumerate(range(d * band_tiles, (d + 1) * band_tiles)):
            cand = ts.pieces.tile_entries(t, pos)
            cand.sort()
            flat.extend(g2l[e] for _, e in cand)
            starts[d, j + 1] = len(flat)
        lists.append(flat)
    idxs = np.zeros((n, max(1, max(len(f) for f in lists))), np.int32)
    for d, flat in enumerate(lists):
        idxs[d, : len(flat)] = flat
    return starts, idxs


def sharded_dirty_lists(ts: TiledScene, order, dirty_tiles, banded: BandedAtlas):
    """Host (coords, spans, idxs, n_slots): int32 arrays (n_bands, 2 *
    n_slots), (n_bands, 2 * n_slots), (n_bands, k).  Band d's slot j
    recomposites its local tile (coords[d, 2j], coords[d, 2j+1]) from its
    local slots idxs[d, spans[d, 2j]:spans[d, 2j+1]].  n_slots is one power
    of two (at least 8) for all bands, as is k.  A band's padding slots
    repeat its last real slot; a band with no dirty tile gets the
    passthrough span (-1, -1) on local tile (0, 0) in every slot, which
    leaves its rows as they are."""
    n = banded.mesh.size
    band_ty = ts.nty // n
    band_tiles = band_ty * ts.ntx
    pos = ts._order_pos(order)
    by_band: List[List[int]] = [[] for _ in range(n)]
    for t in sorted(set(dirty_tiles)):
        by_band[t // band_tiles].append(t)
    n_slots = 8
    while n_slots < max(len(b) for b in by_band):
        n_slots *= 2
    coords = np.zeros((n, 2 * n_slots), np.int32)
    spans = np.zeros((n, 2 * n_slots), np.int32)
    lists = []
    for d, tiles in enumerate(by_band):
        g2l = banded.g2l[d]
        flat: List[int] = []
        if not tiles:
            spans[d] = -1
        for j, t in enumerate(tiles):
            cand = ts.pieces.tile_entries(t, pos)
            cand.sort()
            coords[d, 2 * j], coords[d, 2 * j + 1] = t // ts.ntx - d * band_ty, t % ts.ntx
            spans[d, 2 * j] = len(flat)
            flat.extend(g2l[e] for _, e in cand)
            spans[d, 2 * j + 1] = len(flat)
        if tiles:
            k = len(tiles)
            coords[d, 2 * k :: 2], coords[d, 2 * k + 1 :: 2] = coords[d, 2 * k - 2], coords[d, 2 * k - 1]
            spans[d, 2 * k :: 2], spans[d, 2 * k + 1 :: 2] = spans[d, 2 * k - 2], spans[d, 2 * k - 1]
        lists.append(flat)
    n_idx = 8
    while n_idx < max(len(f) for f in lists):
        n_idx *= 2
    idxs = np.zeros((n, n_idx), np.int32)
    for d, flat in enumerate(lists):
        idxs[d, : len(flat)] = flat
    return coords, spans, idxs, n_slots


def render_sharded(ts: TiledScene, background, order, mesh: Mesh) -> RowSharded:
    """The full frame under a mesh: each band composites its tiles from its
    own local atlas (BandedAtlas) with lists built on the host, one
    composite_full_banded launch per device; no data crosses bands.
    `background` is a RowSharded plane or a whole one.  Returns the new
    frame as a RowSharded plane."""
    if ts.nty % mesh.size:
        raise ValueError(f"{ts.nty} tile rows do not divide into {mesh.size} bands")
    band_ty = ts.nty // mesh.size
    banded = _banded_of(ts, mesh)
    starts, idxs = sharded_lists(ts, order, banded)
    bg = _band_rows(background, mesh, band_ty * TILE_H)
    parts = []
    for g, (dev, b0, b1) in enumerate(mesh.groups):
        s, i = stage(dev, starts[b0:b1], idxs[b0:b1])
        parts.append(composite_full_banded(s, i, bg.parts[g], banded.data[g], band_ty, ts.ntx))
    return RowSharded(mesh, band_ty * TILE_H, parts)


def render_dirty_sharded(ts: TiledScene, frame, background, order, dirty_tiles, mesh: Mesh) -> RowSharded:
    """Re-render `dirty_tiles` under a mesh, in place in each band's frame
    rows, one composite_dirty_banded launch per device over its bands'
    lists (sharded_dirty_lists); bands with no dirty tile keep their rows.
    `frame` and `background` are RowSharded planes or whole ones (a whole
    frame is copied into bands first).  Returns the frame."""
    if ts.nty % mesh.size:
        raise ValueError(f"{ts.nty} tile rows do not divide into {mesh.size} bands")
    band_h = ts.nty // mesh.size * TILE_H
    banded = _banded_of(ts, mesh)
    coords, spans, idxs, n_slots = sharded_dirty_lists(ts, order, dirty_tiles, banded)
    frame, bg = _band_rows(frame, mesh, band_h), _band_rows(background, mesh, band_h)
    for g, (dev, b0, b1) in enumerate(mesh.groups):
        c, s, i = stage(dev, coords[b0:b1], spans[b0:b1], idxs[b0:b1])
        composite_dirty_banded(c, s, i, bg.parts[g], frame.parts[g], banded.data[g], n_slots)
    return frame
