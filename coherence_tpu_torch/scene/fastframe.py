"""Device-resident scene view and blur-filtered display: the tiled frame path.

The PyTorch counterpart of ``coherence_tpu.scene.fastframe`` on its tiled
route.  Every object is rasterized once into frame-aligned atlas pieces by
the tile rasterizer (``raster/tile_raster``); frames recomposite only the
dirty tiles (``raster/tiled_scene``).  An animated object keeps reserved
atlas slots that each move rewrites in place.  ``FilteredDisplay`` keeps a
display plane equal to the blur filter's blend of the unfiltered content,
updated per frame in the dirty window only.

Where the JAX package donates buffers into one fused program per frame,
the port runs the same three stages (shatter, dirty recomposite, windowed
blur blend) as separate launches that update the atlas, the content frame
and the display plane in place.

Scene builds go through a content-addressed scene-build cache, so that an
interactive zoom back to a scale seen before (or prefetched) restores the
atlas from a snapshot instead of rasterizing again.

Every view holds its tensors on the device it was made for; there is no
default device.  Under a mesh (``DeviceView.use_mesh``) the content frame,
its background and the display plane are split by tile-row bands over the
mesh's devices (``parallel.mesh.RowSharded``), each band composites from its
own local atlas, and the global atlas stays on the view's device as the
source of truth.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Set

import numpy as np
import torch

from .. import colour as C
from .. import kernels
from .. import transform as tr
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..parallel.mesh import Mesh, RowSharded
from ..raster import aa as raa
from ..raster import brush as rbrush
from ..raster import fills as rfills
from ..raster import region, scanline
from ..raster.compositor import TILE_H, TILE_W, pack_rgba, unpack_rgba
from ..raster.framepath import blur_blend_into, blur_blend_rect, blur_window, fold_layers_carry
from ..raster.brush_tiles import BrushTileBuild
from ..raster.region import Box, Sprite, translate_sprite
from ..raster.staging import stage
from ..raster.tile_raster import TileBuild
from ..raster.tiled_scene import (
    TiledScene,
    _banded_of,
    composite_dirty,
    render_dirty_sharded,
    render_sharded,
    shatter_into,
)
from . import cache
from . import render as R


def _plain_shapekind(o: R.Obj):
    """(transformed shape kind, plain fill) of a plain-filled basic object;
    else None."""
    g = o.geometry
    if not isinstance(g, R.Basic):
        return None
    f = g.fill
    if type(f) is not rfills.PlainFill or f.kind != rfills.PLAIN:
        return None
    return R.transform_shapekind(o.transform, g.shape), f


def _batch_extract(o: R.Obj):
    """(edges, shape_winding, aa_winding, fill_rgba4) for a plain-filled
    path or stroked path, the objects the tile rasterizer takes; else
    None."""
    got = _plain_shapekind(o)
    if got is None:
        return None
    sk, f = got
    if isinstance(sk, R.PathShape):
        return gpath.edgelist_of_path(sk.path), sk.path.winding, sk.path.winding, f._rgba
    if isinstance(sk, R.StrokedPathShape):
        # Shape uses nonzero, the AA matte even-odd (render.ml:1002-1008).
        return gshapes.strokepath(sk.spec, sk.path), gpath.NONZERO, gpath.EVEN_ODD, f._rgba
    return None


def _brush_extract(o: R.Obj):
    """(brushstroke, fill_rgba4) for a plain-filled Gaussian brush stroke,
    the objects the brush-tile build takes; else None."""
    got = _plain_shapekind(o)
    if got is None or not isinstance(got[0], R.BrushStroke):
        return None
    sk, f = got
    if sk.brushstroke[0][1][0] != rbrush.GAUSSIAN:
        return None
    return sk.brushstroke, f._rgba


# The AA coverage plane of one batched member is at most this many scaled
# samples at its bucket's size (the JAX package's aa._MAX_T_ELEMS): a larger
# member takes the scalar route, whose coverage runs in row bands.
_MAX_T_ELEMS = 48 * 1024 * 1024
# A bucket group rasterizes in runs of members whose coverage planes hold
# at most this many samples together (an int32 difference plane and a
# float32 product of this size, ~0.2 GB each); one member always fits.
_SUB_BATCH_SAMPLES = _MAX_T_ELEMS
_SPAN_BUCKET_MIN = 512  # the JAX package's span bucket floor (aa._SPAN_BUCKET_MIN)


def full_sprite_of_object(o: R.Obj, device, whole_scene=None) -> Optional[Sprite]:
    """An object's complete raster on `device`: the directly filled
    interior and the AA fringe, composed with one caf (the spriteof
    pipeline of render.ml:1198-1213 without the update-shape restriction)."""
    shp, minshp = R.shape_of_basicshape(o, device)
    if shp is None:
        return region.NULL_SPRITE
    maxshape = region.shape_difference(shp, minshp)
    fill = R.fillin_obj(o).transform(list(o.transform))
    fringe = R.sprite_of_basicshape(o, maxshape, whole_scene or [o], device) if maxshape is not None else None
    interior = region.fillshape(minshp, fill) if minshp is not None else None
    spr, _ = region.caf("nocover", "opaque", interior, fringe)
    return spr


def _minshape_empty(rows, cov_s, cov_e, x_rows, x_s, x_e, h: int, w: int) -> bool:
    """True iff (crossings - coverage) is empty: the minshape rule of
    polygon.ml:520-528 on the host at 1x.  Inputs are box-relative."""

    def dense(rr, ss, ee):
        diff = np.zeros((h, w + 1), dtype=np.int32)
        np.add.at(diff, (rr, np.clip(ss, 0, w)), 1)
        np.add.at(diff, (rr, np.clip(ee + 1, 0, w)), -1)
        return np.cumsum(diff, axis=1)[:, :-1] > 0

    if x_rows.size == 0:
        return True
    cov = dense(rows, cov_s, cov_e)
    cross = dense(x_rows, x_s, x_e)
    return not bool((cross & ~cov).any())


class _Member(NamedTuple):
    """One member of a bucket group: its index in the scene, its 1x
    coverage and crossing spans and its 16x AA spans (absolute
    coordinates), box origin and size, fill, box and minshape emptiness."""

    index: int
    cov: tuple
    cross: tuple
    aa: Optional[tuple]
    x0: int
    y0: int
    w: int
    h: int
    fill: tuple
    box: Box
    min_empty: bool


def _spans_in(spans, origin_r: int, origin_c: int, h: int, w: int):
    """(rows, starts, stops) of inclusive spans relative to an origin, rows
    outside 0..h-1 dropped and columns clipped to 0..w (the JAX package's
    scatter drops out-of-range rows and clips columns to the logical
    extent)."""
    rows, ss, ee = (np.asarray(a, np.int64) for a in spans)
    r = rows - origin_r
    keep = (r >= 0) & (r < h)
    return r[keep], np.clip(ss[keep] - origin_c, 0, w), np.clip(ee[keep] + 1 - origin_c, 0, w)


def _batch_masks(n: int, hp: int, wp: int, parts, device) -> torch.Tensor:
    """bool (n, hp, wp) masks of per-member (rows, starts, stops) spans."""
    item = np.concatenate([np.full(len(p[0]), j, np.int64) for j, p in enumerate(parts)])
    rows, starts, stops = (np.concatenate([p[i] for p in parts]) for i in range(3))
    return raa.mask_of_spans(n, hp, wp, item, rows, starts, stops, device)


def _raster_members(members: List[_Member], device):
    """(shape masks, minshape masks, rgba) of a sub-batch of one bucket
    group, each member's planes exactly its box's size: the JAX package's
    _build_group_kernel, as batched torch: one mask_of_spans per span
    family, the coverage product, then the fill dissolved by the opacity.
    The CPU path, and SR1's plain version (_sprite_raster_members).
    The batch runs at the members' largest box; a pixel's value depends only
    on its own footprint, so the others' padding changes no value."""
    hp, wp = max(m.h for m in members), max(m.w for m in members)
    n = len(members)
    covm = _batch_masks(n, hp, wp, [_spans_in(m.cov, m.y0, m.x0, m.h, m.w) for m in members], device)
    crossm = _batch_masks(n, hp, wp, [_spans_in(m.cross, m.y0, m.x0, m.h, m.w) for m in members], device)
    sc = raa._H
    aa_parts = [
        _spans_in(m.aa, sc * m.y0 - 2 * sc, sc * m.x0 - 2 * sc, sc * m.h + sc, sc * m.w + sc)
        if m.aa is not None else (np.zeros(0, np.int64),) * 3
        for m in members
    ]
    opacity = raa.coverage_counts(_batch_masks(n, sc * hp + sc, sc * wp + sc, aa_parts, device), hp, wp)
    smask = covm | crossm  # shape = coverage | crossings
    mmask = crossm & ~covm  # minshape = crossings - coverage
    fringe = smask & ~mmask
    colour = torch.tensor([m.fill for m in members], dtype=torch.int32, device=device)[:, None, None, :]
    rgba = torch.where(mmask[..., None], colour, torch.where(fringe[..., None], C.dissolve_rgba(colour, opacity), 0))
    crop = [(m.h, m.w) for m in members]
    return ([smask[j, :h, :w].contiguous() for j, (h, w) in enumerate(crop)],
            [mmask[j, :h, :w].contiguous() for j, (h, w) in enumerate(crop)],
            [rgba[j, :h, :w].contiguous() for j, (h, w) in enumerate(crop)])


def _sprite_raster_members(members: List[_Member], device):
    """_raster_members' planes for every member of a build on the CUDA
    `device`: one staged copy of the host lists and one launch of SR1
    (kernels.sprite_raster, kernels/csrc/sprite_raster.cu); each plane a
    contiguous view of its one output buffer, on 16 bytes."""
    lists = kernels.sprite_raster_lists([(m.x0, m.y0, m.w, m.h) for m in members], [m.fill for m in members],
                                        [m.cov for m in members], [m.cross for m in members],
                                        [m.aa for m in members])
    return tuple(zip(*kernels.sprite_raster(lists, kernels.stage_sprite_lists(lists, device))))


def _sub_batches(members: List[_Member]):
    """Consecutive runs of a group's members whose coverage planes, at the
    run's largest box, hold at most _SUB_BATCH_SAMPLES samples together."""
    sc = raa._H
    run: List[_Member] = []
    for m in members:
        cand = run + [m]
        hp, wp = max(c.h for c in cand), max(c.w for c in cand)
        if run and len(cand) * (sc * hp + sc) * (sc * wp + sc) > _SUB_BATCH_SAMPLES:
            yield run
            run = [m]
        else:
            run = cand
    if run:
        yield run


def _group_members(objs, device):
    """(out, groups) of full_sprites_of_objects before its raster: out
    holds the scalar route's sprites (None elsewhere), groups maps each
    (bucket, span-capacity) key to its members in scene order, the keys in
    the order the JAX package meets them."""
    out: List[Optional[Sprite]] = [None] * len(objs)
    groups: Dict[tuple, List[_Member]] = {}
    for i, o in enumerate(objs):
        ext = _batch_extract(o)
        if ext is None:
            out[i] = full_sprite_of_object(o, device)
            continue
        edges, shape_w, aa_w, f4 = ext
        spans = scanline._edge_spans(np.asarray(edges, dtype=np.int64), shape_w, scanline._HALF)
        if spans is None:
            continue
        rows, cov_s, cov_e, x_rows, x_s, x_e = spans
        if rows.size == 0:
            continue
        x0 = int(min(cov_s.min(), x_s.min() if x_s.size else cov_s.min()))
        x1 = int(max(cov_e.max(), x_e.max() if x_e.size else cov_e.max()))
        y0, y1 = int(rows.min()), int(rows.max())
        w, h = x1 - x0 + 1, y1 - y0 + 1
        min_empty = _minshape_empty(rows - y0, cov_s - x0, cov_e - x0, x_rows - y0, x_s - x0, x_e - x0, h, w)
        hb, wb = region.bucket_hw(h, w)
        if (raa._H * hb + raa._H) * (raa._H * wb + raa._H) > _MAX_T_ELEMS:
            out[i] = full_sprite_of_object(o, device)
            continue
        aa = scanline.scaled_spans_of_edgelist(edges, aa_w, raa._H)
        key = (hb, wb, raa.span_bucket(2 * rows.size, _SPAN_BUCKET_MIN),
               raa.span_bucket(2 * x_rows.size, _SPAN_BUCKET_MIN),
               raa.span_bucket(2 * (aa[0].shape[0] if aa is not None else 0), _SPAN_BUCKET_MIN))
        groups.setdefault(key, []).append(_Member(i, (rows, cov_s, cov_e), (x_rows, x_s, x_e), aa, x0, y0, w, h,
                                                  tuple(int(v) for v in f4), (x0, y0, x1, y1), min_empty))
    return out, groups


def full_sprites_of_objects(objs, device) -> List[Optional[Sprite]]:
    """Batched ``full_sprite_of_object`` over a scene, on `device`:
    plain-filled paths and stroked paths are rasterized together (on a
    CUDA device every member in one launch of SR1, elsewhere per
    (bucket, span-capacity) group in sub-batches of _raster_members); any
    other object takes the scalar pipeline.  A sprite (or None, for an
    empty object) per object, in order; the coherence cache is seeded with
    each batched member's shape and minshape, in the JAX package's
    order."""
    out, groups = _group_members(objs, device)
    if torch.device(device).type == "cuda":
        # Every group's members in one launch; the plain version's sub-batches only cap its planes' memory.
        ordered = [m for members in groups.values() for m in members]
        rastered = zip(ordered, *_sprite_raster_members(ordered, device)) if ordered else ()
    else:
        rastered = (got for members in groups.values() for run in _sub_batches(members)
                    for got in zip(run, *_raster_members(run, device)))
    for m, mask, minmask, rgba in rastered:
        out[m.index] = Sprite(m.box, mask, rgba)
        # Seed the shape cache as the scalar path would have: an empty
        # minshape as NULL_SHAPE, else the untightened shape with its
        # emptiness left unknown.
        idset = objs[m.index].idset
        if cache.usecache and cache.getshape(idset) is None:
            minshp = region.NULL_SHAPE if m.min_empty else region.Shape(m.box, minmask, empty_known=False)
            cache.addshape(idset, region.Shape(m.box, mask, empty_known=False), minshp)
    return out


def group_sprite_batched(objs, shp, device):
    """A Group's rendered sprite through the batched raster: every member
    rasterized by full_sprites_of_objects, then all of them folded front to
    back over `shp` in one fold_layers_carry call (the JAX package folds in
    chunks of 16 with the carry: the same left fold), replacing the
    per-member render_scene fold (render.ml:1310-1335).  NotImplemented when
    a member is not a plain-filled path or stroked path composited with
    `over`: the caller folds then."""
    if shp is None:
        return region.NULL_SPRITE
    for o in objs:
        if o.compop != R.OVER or _batch_extract(o) is None:
            return NotImplemented
    layers = [s for s in full_sprites_of_objects(objs, device) if s is not None]
    if not layers:
        return region.NULL_SPRITE
    box = shp.box
    h, w = shp.mask.shape
    offs = [(s.box[1] - box[1], s.box[0] - box[0]) for s in layers]
    acc, _, covered = fold_layers_carry(
        offs, [(s.rgba, s.mask) for s in layers], torch.zeros((h, w, 4), dtype=torch.int32, device=shp.mask.device),
        shp.mask, torch.zeros((h, w), dtype=torch.bool, device=shp.mask.device))
    return Sprite(box, covered, torch.where(covered[..., None], acc, 0))


# Scene-build cache (build_tiled_scene): content digest -> (atlas snapshot,
# n_pieces, positional piece lists), least recently used first.  Four
# entries cover the zoom tool's prefetched pair (2x and 0.5x) plus the
# current and the last-visited scale; each holds one atlas-sized snapshot
# on the scene's device.
_SCENE_BUILD_CACHE: "OrderedDict[bytes, tuple]" = OrderedDict()
_SCENE_BUILD_CACHE_MAX = 4
_SCENE_BUILD_CACHE_STATS = {"hits": 0, "misses": 0}


def scene_build_cache_stats(reset: bool = False) -> dict:
    """Hits and misses of cacheable builds (since the last reset)."""
    out = dict(_SCENE_BUILD_CACHE_STATS)
    if reset:
        _SCENE_BUILD_CACHE_STATS["hits"] = 0
        _SCENE_BUILD_CACHE_STATS["misses"] = 0
    return out


def scene_build_cache_clear() -> None:
    _SCENE_BUILD_CACHE.clear()


def zoom_transform(cx: float, cy: float, f: float) -> list:
    """The zoom tool's transform: scale by `f` about (cx, cy).  A zoom step
    and its prefetch must build it the same way, so that their digests
    match bit for bit."""
    return [tr.Translate(cx, cy), tr.Scale((0.0, 0.0), f, f), tr.Translate(-cx, -cy)]


def _scene_digest_update(h, tag: bytes, *parts) -> None:
    # Every part is length-framed, and arrays carry their dtype and shape,
    # so distinct part sequences never hash the same byte stream: the
    # digest is a content address, and an alias would restore the wrong
    # scene's atlas.
    h.update(len(tag).to_bytes(4, "big"))
    h.update(tag)
    for p in parts:
        if isinstance(p, np.ndarray):
            head = repr((p.dtype.str, p.shape)).encode()
            h.update(len(head).to_bytes(4, "big"))
            h.update(head)
            b = np.ascontiguousarray(p).tobytes()
        else:
            b = repr(p).encode()
        h.update(len(b).to_bytes(8, "big"))
        h.update(b)


def stage_tiled_scene(nty: int, ntx: int, width: int, height: int, keyed_objs, device):
    """The host half of build_tiled_scene: sweep every object and stage it
    into tile work items (paths) or brush groups (Gaussian brush strokes).
    Returns (tb, bb, handled, fallback, culled, digest): the tile and brush
    builds, the keys the tile rasterizer takes, the [(key, object)] that
    need the scalar pipeline (a fancy fill, a CPG, a group, a filter, a
    path beyond every span class), the keys culled as wholly off the grid,
    and a content digest of the staged scene (the scene-build cache key),
    None when any object falls back: its content is not digested."""
    tb = TileBuild(nty, ntx, device)
    bb = BrushTileBuild(nty, ntx, device)
    handled, fallback, culled = [], [], []
    h = hashlib.blake2b(digest_size=16)
    _scene_digest_update(h, b"grid", nty, ntx, width, height)
    for key, o in keyed_objs:
        ext = _batch_extract(o)
        if ext is None:
            # Objects off the grid (the viewport) are culled by bounds.
            xmin, xmax, ymin, ymax = R.bounds_of_basicshape(o)
            if xmax < -1 or xmin > width + 2 or ymax < -1 or ymin > height + 2:
                culled.append(key)
                _scene_digest_update(h, b"cull")
                continue
            bext = _brush_extract(o)
            if bext is not None and bb.add_stroke(key, *bext):
                # The brushstroke's structure (exact float reprs) determines
                # its staged stamps.
                _scene_digest_update(h, b"brush", *bext)
            else:
                fallback.append((key, o))
            continue
        edges, sw, aw, fill4 = ext
        if len(edges):
            e = np.asarray(edges, dtype=np.int64)
            # Subbins -> conservative pixel bounds (the AA matte reaches half
            # a pixel past the geometry; +-2 pixels is safely beyond it).
            if (
                e[:, [0, 2]].max() // 32 < -2
                or e[:, [0, 2]].min() // 32 > width + 2
                or e[:, [1, 3]].max() // 32 < -2
                or e[:, [1, 3]].min() // 32 > height + 2
            ):
                culled.append(key)
                _scene_digest_update(h, b"cull")
                continue
        if not tb.add_object(key, *ext):
            fallback.append((key, o))
            continue
        handled.append(key)
        _scene_digest_update(h, b"tile", np.asarray(edges, np.int64), sw, aw, fill4)
    return tb, bb, handled, fallback, culled, (None if fallback else h.digest())


def build_tiled_scene(ts: TiledScene, keyed_objs, staged=None) -> None:
    """Rasterize `keyed_objs` ([(key, R.Obj)]) into `ts`: paths through the
    tile rasterizer, Gaussian brush strokes through the brush-tile build,
    every other object through the scalar pipeline (full_sprite_of_object)
    and a shatter.  `staged`: a stage_tiled_scene result for these objects,
    if the host sweep already ran.

    A build into an empty scene with no fallback object is cacheable: a
    scene whose staged content was built before (with any object ids, as
    the zoom tool mints fresh ones every step) restores from the snapshot
    of that build, an atlas copy plus the piece lists, provided the atlas
    capacity matches."""
    if staged is None:
        staged = stage_tiled_scene(ts.nty, ts.ntx, ts.width, ts.height, keyed_objs, ts.device)
    tb, bb, handled, fallback, culled, digest = staged
    cacheable = digest is not None and ts._n_pieces == 0 and not ts.pieces
    if cacheable:
        hit = _SCENE_BUILD_CACHE.get(digest)
        if hit is not None and (ts._data is None or hit[0].shape == ts._data.shape):
            snap, snap_n, snap_entries = hit
            _SCENE_BUILD_CACHE.move_to_end(digest)
            _SCENE_BUILD_CACHE_STATS["hits"] += 1
            if ts._data is None:
                # The snapshot may come from a build on another device.
                ts._data = snap.to(ts.device, copy=True)
            else:
                ts._data.copy_(snap)
            ts._n_pieces = snap_n
            ts._free_runs = []
            for (key, _o), entries in zip(keyed_objs, snap_entries):
                ts.pieces[key] = entries
            return
        _SCENE_BUILD_CACHE_STATS["misses"] += 1

    for key in culled:
        ts.pieces[key] = []
    blocks, registry = tb.flush()
    ts.add_rastered(registry, blocks)
    bblocks, bregistry = bb.flush()
    ts.add_rastered(bregistry, bblocks)
    for key in handled:
        ts.pieces.setdefault(key, [])  # swept-empty objects have no pieces
    for key, o in fallback:
        spr = full_sprite_of_object(o, ts.device)
        if spr is not None:
            ts.add_object(key, spr)
        else:
            ts.pieces[key] = []

    if cacheable:
        # Snapshot after the whole build; the clone keeps it apart from the
        # in-place updates the live atlas sees later.
        snap_entries = [list(ts.pieces.get(key, ())) for key, _o in keyed_objs]
        _SCENE_BUILD_CACHE[digest] = (ts.atlas().clone(), ts._n_pieces, snap_entries)
        while len(_SCENE_BUILD_CACHE) > _SCENE_BUILD_CACHE_MAX:
            _SCENE_BUILD_CACHE.popitem(last=False)


def tiled_sprite_of_object(o: R.Obj, width: int, height: int, device) -> Optional[Sprite]:
    """One object's Sprite assembled from tile pieces, aligned to the frame
    grid (`width`/`height` are tile multiples; parts outside fall away).
    The mask is alpha > 0, which is bit-neutral under `over`.  An object
    the tile rasterizer does not take comes from the scalar pipeline."""
    ext = _batch_extract(o)
    if ext is None:
        return full_sprite_of_object(o, device)
    nty, ntx = height // TILE_H, width // TILE_W
    tb = TileBuild(nty, ntx, device)
    if not tb.add_object("k", *ext):
        return full_sprite_of_object(o, device)
    blocks, registry = tb.flush()
    pieces = registry.get("k", [])
    if not pieces:
        return None
    return _sprite_from_tile_pieces(pieces, blocks, ntx)


def _sprite_from_tile_pieces(pieces, blocks, ntx: int) -> Sprite:
    """Assemble a Sprite from [(tile, block_id, slot)] pieces of (n,
    TILE_H, TILE_W) packed blocks."""
    tys = [t // ntx for t, _, _ in pieces]
    txs = [t % ntx for t, _, _ in pieces]
    ty0, tx0 = min(tys), min(txs)
    th, tw = max(tys) - ty0 + 1, max(txs) - tx0 + 1
    packed = torch.zeros((th * TILE_H, tw * TILE_W), dtype=torch.int32, device=blocks[0].device)
    for t, b, s in pieces:
        ty, tx = t // ntx - ty0, t % ntx - tx0
        packed[ty * TILE_H : (ty + 1) * TILE_H, tx * TILE_W : (tx + 1) * TILE_W] = blocks[b][s]
    rgba = unpack_rgba(packed)
    box = (tx0 * TILE_W + 1, ty0 * TILE_H + 1, (tx0 + tw) * TILE_W, (ty0 + th) * TILE_H)
    return Sprite(box, rgba[..., 3] > 0, rgba)


def sprites_of_keys(ts: TiledScene, keys) -> List[Optional[Sprite]]:
    """Per-object Sprites of a built TiledScene, assembled from its atlas
    pieces (None for a key with none): a scene built by the tile route also
    yields the per-layer sprites that FrameBuffer's window folds take.
    Boxes are tile-aligned; the mask is alpha > 0, which is bit-neutral
    under `over`."""
    atlas = [ts.atlas()]
    out = []
    for key in keys:
        pieces = ts.pieces.get(key)
        out.append(_sprite_from_tile_pieces([(t, 0, e) for t, e in pieces], atlas, ts.ntx) if pieces else None)
    return out


def alpha_plane_of_object(o: R.Obj, width: int, height: int, device) -> torch.Tensor:
    """(height, width) int32 alpha plane of an object's raster: the filter
    geometry alpha that the blur blend weights by (render.ml:1248-1265).

    It is the general renderer's sprite_of_basicshape (render.ml:1097) over
    the object's whole shape: pure AA coverage with no minshape shortcut, so
    pixels just inside an edge keep alpha < 255.  The tile rasterizer's
    interior = fill rule is wrong here by design.  Any geometry the general
    renderer draws serves as a lens: a path, a stroked path, a CPG."""
    plane = torch.zeros((height, width), dtype=torch.int32, device=device)
    shp = R.shapeonly_of_basicshape(o, device)
    spr = R.sprite_of_basicshape(o, shp, [o], device)
    if spr is None:
        return plane
    box = region.box_intersect(spr.box, (1, 1, width, height))
    if box is None:
        return plane
    alpha = torch.where(spr.mask, spr.rgba[..., 3], 0)
    bx0, by0, bx1, by1 = box
    plane[by0 - 1 : by1, bx0 - 1 : bx1] = region._window(alpha, spr.box, box)
    return plane


def _background(rgba4, h: int, w: int, device) -> torch.Tensor:
    """(h, w) packed constant-colour plane."""
    col = pack_rgba(torch.as_tensor(rgba4, dtype=torch.int32))
    return torch.full((h, w), int(col), dtype=torch.int32, device=device)


class DeviceView:
    """A window-sized packed framebuffer + tiled scene with dirty tracking,
    all on `device`."""

    def __init__(self, width: int, height: int, *, device, bg_colour: int = None,
                 atlas_cap: int = None):
        self.device = torch.device(device)
        self.width, self.height = width, height
        self.pw = ((width + TILE_W - 1) // TILE_W) * TILE_W
        self.ph = ((height + TILE_H - 1) // TILE_H) * TILE_H
        self.ts = TiledScene(self.pw, self.ph, self.device)
        if atlas_cap:
            self.ts._ensure(atlas_cap)
        bg = C.rgba_of_colour(bg_colour if bg_colour is not None else C.white)
        self.background = _background(bg, self.ph, self.pw, self.device)
        # A distinct tensor: the frame is updated in place.
        self.frame = self.background.clone()
        self.order: List[object] = []  # keys front-to-back
        self.sprites: Dict[object, Optional[Sprite]] = {}
        # key -> source R.Obj: tiled builds materialize no Sprite, so a
        # translate of a tiled object re-rasterizes from here.
        self.objs: Dict[object, R.Obj] = {}
        self.dirty: Set[int] = set(range(self.ts.nty * self.ts.ntx))
        self.mesh: Optional[Mesh] = None

    def use_mesh(self, mesh: Mesh) -> None:
        """Split this view by tile rows over `mesh`: band d holds tile rows
        [d * nty / n, (d + 1) * nty / n) of the frame and background on
        mesh.devices[d].  Full renders then go through render_sharded,
        dirty renders through render_dirty_sharded: per-band kernels over
        a banded atlas (each device holds only its bands' pieces), with no
        data crossing bands."""
        if self.ts.nty % mesh.size:
            raise ValueError(f"use_mesh: {self.ts.nty} tile rows do not divide into {mesh.size} bands")
        self.mesh = mesh
        band_h = self.ph // mesh.size
        self.background = RowSharded.scatter(self.background, mesh, band_h)
        self.frame = RowSharded.scatter(self.frame, mesh, band_h)

    def _tiles_of(self, key) -> Set[int]:
        return {tile for tile, _ in self.ts.pieces.get(key, ())}

    def set_scene(self, scene: List[R.Obj], tiled: bool = False, staged=None) -> None:
        """(Re)build from a front-to-back scene list.  By default every
        object's full sprite is made by the batched raster
        (full_sprites_of_objects) and shattered into the atlas: the sprites
        stay, so an object can be made animated.  tiled=True rasterizes
        through the tile rasterizer instead (the fast cold start) and
        materializes no Sprite: the first translate_object of such an
        object re-rasterizes it.  `staged` is a stage_tiled_scene result for
        `scene`, where the host sweep already ran (tile route only)."""
        self.order = []
        if tiled:
            build_tiled_scene(self.ts, [(o.idset, o) for o in scene], staged=staged)
            for o in scene:
                self.sprites[o.idset] = None
                self.objs[o.idset] = o
                self.order.append(o.idset)
                self.dirty |= self._tiles_of(o.idset)
            return
        for o, spr in zip(scene, full_sprites_of_objects(list(scene), self.device)):
            self._install(o, spr, None)

    def reset_scene(self, scene: List[R.Obj], tiled: bool = False, staged=None) -> None:
        """Replace the whole scene in place, as an interactive zoom or pan
        does (the reference transforms the scene and redraws,
        engine.ml:1015-1057): the atlas keeps its allocation and capacity,
        so a tiled build of the same content restores from the scene-build
        cache."""
        self.ts.reset()
        self.sprites = {}
        self.dirty = set(range(self.ts.nty * self.ts.ntx))
        self.set_scene(scene, tiled=tiled, staged=staged)

    def prefetch_scene(self, scene: List[R.Obj]) -> None:
        """Build `scene` into the scene-build cache ahead of a reset_scene
        whose staged content will match (the digest is content-addressed,
        so fresh object ids still hit).  The live view is untouched: the
        build runs into a scratch TiledScene of the live atlas's capacity,
        since a restore needs equal capacities.  A scene already cached, or
        one with an object that takes the scalar pipeline (its content has
        no digest), is not built."""
        keyed = [(o.idset, o) for o in scene]
        ts = TiledScene(self.pw, self.ph, self.device)
        if self.ts._data is not None:
            ts._ensure(int(self.ts._data.shape[0]))
        staged = stage_tiled_scene(ts.nty, ts.ntx, ts.width, ts.height, keyed, self.device)
        if staged[5] is None or staged[5] in _SCENE_BUILD_CACHE:
            return
        build_tiled_scene(ts, keyed, staged=staged)

    def prefetch_zoom_candidates(self, scene: List[R.Obj]) -> None:
        """Prefetch the scenes the zoom tool would produce next: the whole
        scene scaled 2x and 0.5x about the logical frame's centre (not the
        tile-padded one), with the zoom tool's exact transform recipe, so
        that a real zoom step's digest matches bit for bit.  The JAX
        package runs this from an idle thread; here the caller runs it
        when it likes, and it blocks."""
        for f in (2.0, 0.5):
            tmat = zoom_transform(self.width / 2.0, self.height / 2.0, f)
            self.prefetch_scene([R.transform_renderobject_many(tmat, o) for o in scene])

    def add_object(self, o: R.Obj, index: Optional[int] = None) -> None:
        """Add an object at `index` of the front-to-back order (at the back
        by default), rasterized by the scalar pipeline."""
        self._install(o, full_sprite_of_object(o, self.device), index)

    def _install(self, o: R.Obj, spr: Optional[Sprite], index: Optional[int]) -> None:
        key = o.idset
        self.objs[key] = o
        self.sprites[key] = spr
        if spr is not None:
            self.ts.add_object(key, spr)
        else:
            self.ts.pieces[key] = []
        if index is None:
            self.order.append(key)
        else:
            self.order.insert(index, key)
        self.dirty |= self._tiles_of(key)

    def make_animated(self, key) -> None:
        """Reserve atlas slots for an object that moves every frame; its
        moves then rewrite those slots in place."""
        spr = self.sprites.get(key)
        if spr is None:
            raise ValueError("make_animated: object has no materialized sprite")
        hs, ws = spr.mask.shape
        cap = ((hs + TILE_H - 1) // TILE_H + 1) * ((ws + TILE_W - 1) // TILE_W + 1)
        self.ts.reserve_slots(key, cap)
        self.ts.update_object_inplace(key, spr)
        self.dirty |= self._tiles_of(key)

    def replace_object(self, key, o: R.Obj) -> None:
        """Re-rasterize an edited object in place of `key` (the edit may
        mint a new id): its old tiles and its new ones go dirty, and the
        old key's atlas slots return to the free pool."""
        old_tiles = self._tiles_of(key)
        spr = full_sprite_of_object(o, self.device)
        self.sprites[o.idset] = spr
        self.objs[o.idset] = o
        if spr is not None:
            self.ts.add_object(o.idset, spr)
        else:
            self.ts.pieces[o.idset] = []
        self.order = [o.idset if k == key else k for k in self.order]
        if key != o.idset:
            self.sprites.pop(key, None)
            self.objs.pop(key, None)
            self.ts.remove_object(key)
        self.dirty |= old_tiles | self._tiles_of(o.idset)

    def remove_object(self, key) -> None:
        """Delete an object: its tiles go dirty and its atlas slots (the
        whole reserved run of an animated object) return to the free pool,
        so delete and re-add churn never grows the atlas."""
        self.dirty |= self._tiles_of(key)
        self.ts.remove_object(key)
        self.order = [k for k in self.order if k != key]
        self.sprites.pop(key, None)
        self.objs.pop(key, None)

    def restack(self, new_order: List[object]) -> None:
        """A depth change: the tiles of every object whose place in the
        order changed go dirty."""
        for k, (a, b) in enumerate(zip(self.order, new_order)):
            if a != b:
                self.dirty |= self._tiles_of(a) | self._tiles_of(b)
        self.order = list(new_order)

    def translate_object(self, key, dx: int, dy: int) -> None:
        """Move an object by whole pixels, reusing its raster."""
        old_tiles = self._tiles_of(key)
        spr = self.sprites.get(key)
        if spr is None:
            o = self.objs.get(key)
            if o is None:
                return
            o2 = R.translate_renderobject(dx, dy, o)
            self.objs[key] = o2
            spr2 = tiled_sprite_of_object(o2, self.pw, self.ph, self.device)
            self.sprites[key] = spr2
            if spr2 is not None:
                self.ts.add_object(key, spr2)
            else:
                self.ts.set_empty(key)
            self.dirty |= old_tiles | self._tiles_of(key)
            return
        moved = translate_sprite(dx, dy, spr)
        self.sprites[key] = moved
        if key in self.ts._reserved:
            self.ts.update_object_inplace(key, moved)
        else:
            self.ts.add_object(key, moved)
        self.dirty |= old_tiles | self._tiles_of(key)

    def render(self, full: bool = False) -> None:
        """Composite the dirty tiles (in place) or every tile (a new frame)."""
        if full:
            if self.mesh is not None:
                self.frame = render_sharded(self.ts, self.background, self.order, self.mesh)
            else:
                starts, idxs = self.ts.build_lists(self.order)
                self.frame = self.ts.render_full(self.background, starts, idxs)
        elif self.dirty:
            if self.mesh is not None:
                self.frame = render_dirty_sharded(self.ts, self.frame, self.background, self.order, self.dirty,
                                                  self.mesh)
            else:
                self.frame = self.ts.render_dirty(self.frame, self.background, self.order, self.dirty)
        self.dirty.clear()

    def content(self, device) -> torch.Tensor:
        """The packed (ph, pw) content frame, whole, on `device`."""
        if self.mesh is not None:
            return self.frame.gather(device)
        return self.frame.to(device)

    def read(self) -> np.ndarray:
        """(height, width, 4) uint8 RGBA of the logical window."""
        rgba = unpack_rgba(self.content(self.device)[: self.height, : self.width])
        return rgba.to(torch.uint8).cpu().numpy()


def blur_blend_window(display, content_packed, f_alpha, oy, ox, ry0, rx0, h, w, d_box,
                      hb, wb, weights, total) -> torch.Tensor:
    """Blend the blur of the content plane into the display window, in
    place: the per-frame filter pass (one ``blur_blend`` launch on a CUDA
    device).  The window must be the dirty box bloated by 2*radius, with
    the content tiles covering it fresh."""
    return blur_blend_into(display, content_packed, (oy, ox), f_alpha, (oy, ox), hb, wb, ry0, rx0, h, w, d_box,
                           weights, total)


def blur_blend_window_sharded(display: RowSharded, content: RowSharded, f_alpha, oy, ox, ry0, rx0, h, w,
                              d_box, hb, wb, weights, total) -> RowSharded:
    """blur_blend_window under a mesh: the window's content and display rows
    are copied from the bands it crosses onto f_alpha's device, blended
    there by the same blur_blend_window, and the display rows written back
    to their bands.  The window lies inside the frame, so its blur reads the
    same pixels as the unsharded pass.  Each window is a fresh tensor (the
    kernel wrappers refuse a band's row views, H14)."""
    dev = f_alpha.device
    content_win = content.window(oy, oy + hb, ox, ox + wb, dev)
    display_win = display.window(oy, oy + hb, ox, ox + wb, dev)
    alpha_win = f_alpha[oy : oy + hb, ox : ox + wb].clone(memory_format=torch.contiguous_format)
    blur_blend_window(display_win, content_win, alpha_win, 0, 0, ry0, rx0, h, w, d_box, hb, wb, weights, total)
    display.write_window(oy, ox, display_win)
    return display


class FilteredDisplay:
    """Display = blur(content) blended by a filter geometry's alpha plane.

    The DeviceView's frame holds the exact unfiltered scene content; this
    class derives the displayed frame from it, full-frame once, then per
    dirty window.  Under a mesh the display plane is split into the view's
    row bands (a RowSharded plane), as the content frame is."""

    def __init__(self, view: DeviceView, f_alpha: torch.Tensor, kernel):
        self.view = view
        self.f_alpha = f_alpha
        self.kernel = kernel
        self.rgba = None  # (height, width, 4) int32, whole or RowSharded
        self.box = (1, 1, view.width, view.height)

    def full_refresh(self) -> None:
        """Render pending content (every tile after set_scene) and
        blur-blend the whole display; under a mesh, on f_alpha's device,
        then split into bands."""
        view = self.view
        view.render()
        self.rgba = blur_blend_rect(view.content(self.f_alpha.device), self.f_alpha, self.kernel.values,
                                    self.kernel.total)
        if view.mesh is not None:
            self.rgba = RowSharded.scatter(self.rgba, view.mesh, view.ph // view.mesh.size)

    def _window_tiles(self, oy, ox, ry0, rx0, h, w) -> Set[int]:
        """Tiles covering the logical window (its content must be fresh for
        the convolution support)."""
        ntx = self.view.ts.ntx
        x0, y0 = ox + rx0, oy + ry0  # 0-based
        return {
            ty * ntx + tx
            for ty in range(y0 // TILE_H, (y0 + h - 1) // TILE_H + 1)
            for tx in range(x0 // TILE_W, (x0 + w - 1) // TILE_W + 1)
        }

    def _blend(self, win) -> None:
        _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
        blend = blur_blend_window if self.view.mesh is None else blur_blend_window_sharded
        blend(self.rgba, self.view.frame, self.f_alpha, oy, ox, ry0, rx0, h, w, d_box, hb, wb,
              self.kernel.values, self.kernel.total)

    def step(self, dirty: Box) -> None:
        """One frame: recomposite the content tiles covering bloat(dirty,
        2r), then blur-blend the dirty window into the display."""
        win = blur_window(dirty, self.box, self.kernel.radius, self.view.height, self.view.width)
        if win is None:
            self.view.render()
            return
        self.view.dirty |= self._window_tiles(*win[1:7])
        self.view.render()
        self._blend(win)

    def _dirty_box(self, box: Box) -> Box:
        """`box` grown by every tile already dirty from other edits: those
        tiles get fresh content this frame, so their displayed pixels must
        be re-blended too."""
        view, ts = self.view, self.view.ts
        for t in view.dirty:
            ty, tx = t // ts.ntx, t % ts.ntx
            tile_box = (
                tx * TILE_W + 1,
                ty * TILE_H + 1,
                min(view.width, (tx + 1) * TILE_W),
                min(view.height, (ty + 1) * TILE_H),
            )
            box = region.box_union(box, tile_box)
        return box

    def stage_animated(self, key, dx: int, dy: int):
        """The host half of step_animated, changing no state: (moved sprite,
        (oys, oxs, base) of its in-place shatter, its new piece entries,
        the blur window or None, the dirty-tile arguments (coords, spans,
        idxs, n_slots) or None).  None when `key` has no reserved slots or
        moves off the grid: the step then takes translate_object + step."""
        view, ts = self.view, self.view.ts
        spr = view.sprites[key]
        moved = translate_sprite(dx, dy, spr)
        got = ts._inplace_args(key, moved) if key in ts._reserved else None
        if got is None:
            return None
        oys, oxs, base, entries = got
        dirty_box = self._dirty_box(region.box_union(spr.box, moved.box))
        win = blur_window(dirty_box, self.box, self.kernel.radius, view.height, view.width)
        if win is None:
            return moved, (oys, oxs, base), entries, None, None
        dirty_tiles = view.dirty | self._window_tiles(*win[1:7])
        dirty_tiles |= {t for t, _ in ts.pieces.get(key, ())}
        dirty_tiles |= {t for t, _ in entries}
        dirty = ts._dirty_args(view.order, dirty_tiles, pieces_override={key: entries})
        return moved, (oys, oxs, base), entries, win, dirty

    def step_animated(self, key, dx: int, dy: int) -> None:
        """Move one animated object and refresh the filtered display: shatter
        into its reserved slots, recomposite the dirty tiles, blur-blend the
        window.  Identical to translate_object + step.  On a CUDA device a
        steady frame is the JAX package's one program
        (_animated_blur_frame_kernel) as one staged copy of the frame's
        lists and three launches: shatter_into, composite_dirty, blur_blend.
        Under a mesh the same three stages run per band
        (_step_animated_sharded)."""
        view, ts = self.view, self.view.ts
        spr = view.sprites.get(key)
        if spr is None:
            return
        if view.mesh is not None and key in ts._reserved:
            self._step_animated_sharded(key, dx, dy)
            return
        staged = self.stage_animated(key, dx, dy)
        if staged is None:
            view.translate_object(key, dx, dy)
            self.step(region.box_union(spr.box, view.sprites[key].box))
            return
        moved, (oys, oxs, base), entries, win, dirty = staged
        if win is None:
            view.sprites[key] = moved
            ts.update_object_inplace(key, moved)
            return
        coords, spans, idxs, n_slots = dirty
        oys, oxs, coords, spans, idxs = stage(view.device, oys, oxs, coords, spans, idxs)
        shatter_into(ts.atlas(), moved.rgba, oys, oxs, base)
        composite_dirty(coords, spans, idxs, view.background, view.frame, ts.atlas(), n_slots)
        self._blend(win)
        ts.pieces[key] = entries
        view.sprites[key] = moved
        view.dirty.clear()

    def _step_animated_sharded(self, key, dx: int, dy: int) -> None:
        """The animated frame under a mesh: the banded atlas's reserved
        slots updated in place, the dirty tiles recomposited per band, the
        window blended.  Identical to translate_object + step.

        The order keeps the banded atlas valid without a rebuild: fetch it
        before the new pieces are installed, shatter into the global atlas
        (the source of truth for later rebuilds), install the pieces, update
        the bands' reserved slots, then mark the banded atlas current."""
        view, ts = self.view, self.view.ts
        spr = view.sprites[key]
        moved = translate_sprite(dx, dy, spr)
        got = ts._inplace_args(key, moved)
        if got is None:
            view.translate_object(key, dx, dy)
            self.step(region.box_union(spr.box, view.sprites[key].box))
            return
        oys, oxs, base, entries = got
        banded = _banded_of(ts, view.mesh)
        shatter_into(ts.atlas(), moved.rgba, oys, oxs, base)
        old_tiles = {t for t, _ in ts.pieces.get(key, ())}
        ts.pieces[key] = entries
        banded.update_inplace(ts, key, moved.rgba, entries, oys, oxs)
        banded.version = ts.pieces.version
        view.sprites[key] = moved
        win = blur_window(self._dirty_box(region.box_union(spr.box, moved.box)), self.box, self.kernel.radius,
                          view.height, view.width)
        view.dirty |= old_tiles | {t for t, _ in entries}
        if win is None:
            view.render()
            return
        view.dirty |= self._window_tiles(*win[1:7])
        view.render()
        self._blend(win)

    def play_animated(self, key, deltas, capture_every: int = 0, require_scan: bool = False):
        """A whole animation of per-step (dx, dy) moves of `key`, equal to
        calling step_animated per delta.  The JAX package runs it as one
        device program (a lax.scan of the fused frame); here every step's
        host work (offsets, dirty lists, blur windows) is staged and
        uploaded first, in one copy, then each step's three launches
        (shatter_into, composite_dirty, blur_blend on a CUDA device) run
        back to back with no host work between them.  Returns the display planes after every
        capture_every-th step as (len(deltas) // capture_every, H, W, 4)
        uint8 when capture_every > 0 (it must divide len(deltas)), else
        None.

        Falls back to sequential step_animated where the JAX package's scan
        cannot be staged: a mesh, pending non-animated dirt, an unreserved
        key, no deltas, a step leaving the reserved capacity, an empty blur
        window, or windows of different bucket sizes.  require_scan=True
        raises RuntimeError with the reason instead of falling back."""
        view, ts = self.view, self.view.ts
        spr = view.sprites.get(key)
        if capture_every and len(deltas) % capture_every:
            raise ValueError("capture_every must divide len(deltas)")

        def fallback(reason):
            if require_scan:
                raise RuntimeError(f"play_animated scan unavailable: {reason}")
            frames = []
            for i, (dx, dy) in enumerate(deltas):
                self.step_animated(key, dx, dy)
                if capture_every and (i + 1) % capture_every == 0:
                    frames.append(self.read().astype(np.uint8))
            return np.stack(frames) if capture_every else None

        if spr is None or key not in ts._reserved or view.mesh is not None or view.dirty or not deltas:
            return fallback("unreserved key, mesh, pending dirt, or no deltas")

        prev, prev_entries = spr, list(ts.pieces.get(key, ()))
        steps, statics = [], None
        for dx, dy in deltas:
            moved = translate_sprite(dx, dy, prev)
            try:
                got = ts._inplace_args(key, moved)
            except ValueError:  # the step outgrows the reserved capacity
                got = None
            if got is None:
                return fallback("step leaves the reserved slot capacity")
            oys, oxs, base, entries = got
            win = blur_window(region.box_union(prev.box, moved.box), self.box, self.kernel.radius,
                              view.height, view.width)
            if win is None:
                return fallback("empty blur window")
            if statics is None:
                statics = (base, win[7], win[8])
            elif statics != (base, win[7], win[8]):
                return fallback("blur windows straddle bucket sizes")
            dirty_tiles = self._window_tiles(*win[1:7])
            dirty_tiles |= {t for t, _ in prev_entries}
            dirty_tiles |= {t for t, _ in entries}
            args = ts._dirty_args(view.order, dirty_tiles, pieces_override={key: entries})
            steps.append((oys, oxs, args, win))
            prev, prev_entries = moved, entries

        # Every step's offsets and lists in one upload.
        flat = [a for oys, oxs, (coords, spans, idxs, _), _ in steps for a in (oys, oxs, coords, spans, idxs)]
        parts = iter(stage(view.device, *flat))
        staged = [tuple(next(parts) for _ in range(5)) for _ in steps]

        atlas, rgba, base = ts.atlas(), spr.rgba, statics[0]
        frames = []
        for i, ((oys, oxs, coords, spans, idxs), (_, _, (_, _, _, n_slots), win)) in enumerate(zip(staged, steps)):
            shatter_into(atlas, rgba, oys, oxs, base)
            composite_dirty(coords, spans, idxs, view.background, view.frame, atlas, n_slots)
            self._blend(win)
            if capture_every and (i + 1) % capture_every == 0:
                frames.append(self.rgba.to(torch.uint8))
        ts.pieces[key] = prev_entries
        view.sprites[key] = prev
        return torch.stack(frames).cpu().numpy() if capture_every else None

    def read(self) -> np.ndarray:
        if self.view.mesh is not None:
            return self.rgba.gather("cpu").numpy()
        return self.rgba.cpu().numpy()
