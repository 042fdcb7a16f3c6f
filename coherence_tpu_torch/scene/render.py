"""Scene model and hidden-surface-removal renderer (parity: ``render.ml``).

The PyTorch counterpart of ``coherence_tpu.scene.render``, whole, with the
two debug-page dumps (``pdf_debug_active``, ``pdf_filter_debug_active``:
``utils.debugpdf``, one readback per fragment).

Scenes are front-to-back lists of renderobjects (element 0 topmost).  The
renderer folds over the scene carrying an *update shape* (pixels still
needing paint) and an accumulator sprite; each object is rasterized only
within ``shape ∩ update``, composited with ``caf over``, and the newly
opaque pixels are subtracted from the update, so fully occluded content is
never rasterized, and rendering stops as soon as the update shape empties
(``render.ml:1268-1335``).  Per-object shapes and partial sprites are
memoised in the coherence cache with translation aliasing (``cache.ml``).

Every geometric leaf rasterizes through the device raster layer: interior
(minshape) pixels by direct fill, the AA fringe (shape − minshape) via the
Gaussian-matte coverage product, composed with a single ``caf``
(``render.ml:1198-1213``).

Everything that rasterizes takes the device as its last positional
argument (``shape_of_basicshape(o, device)``, ``render_scene(..., device)``,
``render_simple_scene(scene, shape, device)``); a ``View`` carries its own.
A filter's three callbacks receive it too: ``reading_scene(shp, idset, obj,
scene_below, device)``, ``filter(sprite, obj, shape, device)``,
``dirty(shape, obj, device)``.  There is no default device.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from .. import colour as C
from .. import ident
from .. import transform as tr
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..raster import aa as raa
from ..raster import brush as rbrush
from ..raster import convolve as rconvolve
from ..raster import fills as rfills
from ..raster import region, scanline
from ..raster.region import (
    NULL_SHAPE,
    NULL_SPRITE,
    box_overlap,
    caf,
    shape_difference as s_diff,
    shape_intersection as s_int,
    shape_union as s_uni,
)
from ..utils import flags, profiling
from . import cache

pdf_debug_active = False
pdf_filter_debug_active = False

# ---------------------------------------------------------------------------
# Types (render.ml:19-75)
# ---------------------------------------------------------------------------

# CPG operations
UNION = "union"
INTERSECTION = "intersection"
SUBTRACTION = "subtraction"
EXCLUSIVE_OR = "exclusiveor"


@dataclass(frozen=True)
class HLine:
    y: float
    xmin: float
    xmax: float


@dataclass(frozen=True)
class VLine:
    x: float
    ymin: float
    ymax: float


@dataclass(frozen=True)
class RectanglePrim:
    xmin: float
    ymin: float
    xmax: float
    ymax: float


@dataclass(frozen=True)
class PathShape:
    path: gpath.Path


@dataclass(frozen=True)
class BrushStroke:
    brushstroke: tuple  # (brush, path)


@dataclass(frozen=True)
class StrokedPathShape:
    path: gpath.Path
    spec: gshapes.StrokeSpec


@dataclass(frozen=True)
class CPG:
    op: str
    a: object  # basicshape
    b: object


@dataclass(frozen=True)
class Basic:
    fill: rfills.Fill
    shape: object  # basicshape


@dataclass(frozen=True)
class Convolved:
    kernel: object
    geometry: object


@dataclass(frozen=True)
class Group:
    objects: tuple  # scene


@dataclass(frozen=True)
class Primitive:
    colour: int
    prim: object


FILTER_PLAIN = "filterplain"
FILTER_FANCY = "filterfancy"


@dataclass(frozen=True)
class Filter:
    """Scene-rewriting filter (render.ml:50-55).

    reading_scene(shp, idset, obj, scene_below, device) ->
        (reading shape, modified shptorender, modified scene)
    filter(sprite, obj, shape, device) -> sprite   (raster post-process)
    dirty(shape, obj, device) -> shape             (dirty-region transfer)
    """

    geometry: object
    reading_scene: Callable
    filter: Callable
    dirty: Callable
    filterkind: str


@dataclass(frozen=True)
class FilterG:
    filter: Filter


# Compositing operators (render.ml:65-68)
OVER = "over"
NOCOVER = "nocover"


@dataclass(frozen=True)
class PreTrans:
    v: float
    op: object  # inner compop


@dataclass(frozen=True)
class Obj:
    idset: ident.IdSet
    geometry: object
    transform: tuple  # tuple of transform ops
    compop: object


Scene = List[Obj]


def _t(transform) -> tuple:
    if isinstance(transform, tuple):
        return transform
    if isinstance(transform, list):
        return tuple(transform)
    return (transform,)


def mk_obj(geometry, transform=(), compop=OVER) -> Obj:
    return Obj(ident.new_ids(), geometry, _t(transform), compop)


# ---------------------------------------------------------------------------
# Utility functions (render.ml:96-188)
# ---------------------------------------------------------------------------


def idset_in(o: Obj) -> ident.IdSet:
    return o.idset


def obj_eq(a: Obj, b: Obj) -> bool:
    return ident.set_eq(a.idset, b.idset)


def mkgroup(objs) -> Obj:
    return Obj(ident.new_ids(), Group(tuple(objs)), (), OVER)


def fakeobj(geom) -> Obj:
    return Obj(ident.new_ids(), geom, (), NOCOVER)


def fakeobj_t(geom, transform) -> Obj:
    return Obj(ident.new_ids(), geom, _t(transform), NOCOVER)


def transform_in(o: Obj):
    return o.transform


def primobj(c: int, p) -> Obj:
    return Obj(ident.new_ids(), Primitive(c, p), (), OVER)


# Set while rendering under any filter (render.ml:127-129).
underanyfilter = False


def filterkind_in(o: Obj) -> Optional[str]:
    if isinstance(o.geometry, FilterG):
        return o.geometry.filter.filterkind
    return None


def findfill(geom) -> str:
    """Fill kind of a geometry, for dirty regions (render.ml:137-142)."""
    if isinstance(geom, FilterG):
        return rfills.FANCY
    if isinstance(geom, Basic):
        return geom.fill.kind
    if isinstance(geom, Convolved):
        return findfill(geom.geometry)
    if isinstance(geom, Group):
        return rfills.FANCY
    return rfills.PLAIN  # Primitive


def containsfilter(o: Obj) -> bool:
    g = o.geometry
    if isinstance(g, FilterG):
        return True
    if isinstance(g, Group):
        return any(containsfilter(x) for x in g.objects)
    return False


def fillkind_in(o: Obj) -> str:
    g = o.geometry
    if isinstance(g, Basic):
        return g.fill.kind
    if isinstance(g, Group):
        return rfills.FANCY
    if isinstance(g, Convolved):
        return fillkind_in(fakeobj(g.geometry))
    if isinstance(g, FilterG):
        return fillkind_in(fakeobj(g.filter.geometry))
    return rfills.PLAIN


def fillin_obj(o: Obj) -> rfills.Fill:
    g = o.geometry
    if isinstance(g, Basic):
        return g.fill
    if isinstance(g, Group):
        return rfills.dummyfancy
    if isinstance(g, Convolved):
        return fillin_obj(fakeobj(g.geometry))
    if isinstance(g, FilterG):
        return fillin_obj(fakeobj(g.filter.geometry))
    return rfills.dummyfancy


def mkpoly(path, fill, transform, compop) -> Obj:
    return Obj(ident.new_ids(), Basic(fill, PathShape(path)), _t(transform), compop)


def mkrectangle(x, y, w, h, fill, transform=(), compop=OVER) -> Obj:
    return mkpoly(gshapes.rectangle(x, y, w, h), fill, transform, compop)


def rectangle(x, y, w, h) -> PathShape:
    return PathShape(gshapes.rectangle(x, y, w, h))


# ---------------------------------------------------------------------------
# Transforming renderobjects and shapes (render.ml:190-271)
# ---------------------------------------------------------------------------


def transform_shapespec(f, spec: gshapes.StrokeSpec) -> gshapes.StrokeSpec:
    scale = tr.decompose(tr.matrix_of_transform(f))[0]
    return gshapes.StrokeSpec(
        spec.startcap, spec.join, spec.endcap, spec.mitrelimit, spec.linewidth * abs(scale)
    )


def transform_shapekind(f, sk):
    if isinstance(sk, PathShape):
        return PathShape(gpath.transform_path(list(f), sk.path))
    if isinstance(sk, BrushStroke):
        return BrushStroke(rbrush.transform_brushstroke(list(f), sk.brushstroke))
    if isinstance(sk, StrokedPathShape):
        return StrokedPathShape(
            gpath.transform_path(list(f), sk.path), transform_shapespec(f, sk.spec)
        )
    if isinstance(sk, CPG):
        return CPG(sk.op, transform_shapekind(f, sk.a), transform_shapekind(f, sk.b))
    raise TypeError(sk)


def transform_renderobject(f, o: Obj) -> Obj:
    """Compose f outside the object's transform (render.ml:208-216)."""
    if isinstance(o.geometry, Group):
        return Obj(
            ident.new_ids(),
            Group(tuple(transform_renderobject(f, x) for x in o.geometry.objects)),
            o.transform,
            o.compop,
        )
    return Obj(ident.new_ids(), o.geometry, tuple(tr.compose(f, list(o.transform))), o.compop)


def transform_renderobject_many(ts, o: Obj) -> Obj:
    """Append a transform list outside (render.ml:219-227)."""
    if isinstance(o.geometry, Group):
        return Obj(
            ident.new_ids(),
            Group(tuple(transform_renderobject_many(ts, x) for x in o.geometry.objects)),
            o.transform,
            o.compop,
        )
    return Obj(
        ident.new_ids(), o.geometry, tuple(tr.append(list(ts), list(o.transform))), o.compop
    )


def transform_basicshape(f, geom):
    """Transform a geometry in place (render.ml:230-239)."""
    if isinstance(geom, FilterG):
        flt = geom.filter
        return FilterG(
            Filter(
                transform_basicshape(f, flt.geometry),
                flt.reading_scene,
                flt.filter,
                flt.dirty,
                flt.filterkind,
            )
        )
    if isinstance(geom, Basic):
        return Basic(geom.fill.transform(list(f)), transform_shapekind(f, geom.shape))
    if isinstance(geom, Convolved):
        if isinstance(geom.geometry, Group):
            return Convolved(
                geom.kernel,
                Group(
                    tuple(
                        transform_renderobject_many(list(f), x)
                        for x in geom.geometry.objects
                    )
                ),
            )
        return Convolved(geom.kernel, transform_basicshape(f, geom.geometry))
    raise TypeError(f"transform_basicshape: {geom}")


def transform_primitive(f, p):
    t = lambda pt: tr.transform(list(f), pt)
    if isinstance(p, HLine):
        xmin2, y2 = t((p.xmin, p.y))
        xmax2, _ = t((p.xmax, p.y))
        return HLine(y2, xmin2, xmax2)
    if isinstance(p, VLine):
        x2, ymin2 = t((p.x, p.ymin))
        _, ymax2 = t((p.x, p.ymax))
        return VLine(x2, ymin2, ymax2)
    xmin2, ymin2 = t((p.xmin, p.ymin))
    xmax2, ymax2 = t((p.xmax, p.ymin))
    return RectanglePrim(xmin2, ymin2, xmax2, ymax2)


def translate_renderobject(dx: int, dy: int, o: Obj) -> Obj:
    """Whole-pixel translation registered as a cache alias so the stored
    raster is reused (render.ml:259-271)."""
    top = tr.Translate(float(dx), float(dy))
    if isinstance(o.geometry, Group):
        transform2, geometry2 = (), Group(
            tuple(translate_renderobject(dx, dy, x) for x in o.geometry.objects)
        )
    else:
        transform2, geometry2 = tuple(tr.compose(top, list(o.transform))), o.geometry
    idset2 = ident.new_ids()
    if not containsfilter(o):
        cache.addtranslation(idset2, o.idset, dx, dy)
    return Obj(idset2, geometry2, transform2, o.compop)


# ---------------------------------------------------------------------------
# Bounding boxes (render.ml:273-437).
#
# The reference routes all CPG/group bounds through the GPC C polygon clipper
# — but feeds it axis-aligned boxes only (render.ml:328-349), so plain box
# union/intersection is the complete replacement (SURVEY.md §2 native note).
# ---------------------------------------------------------------------------


def proper_bounds_geom(geom) -> Tuple[float, float, float, float]:
    if isinstance(geom, FilterG):
        return proper_bounds_geom(geom.filter.geometry)
    if isinstance(geom, Convolved):
        return proper_bounds_geom(geom.geometry)
    if isinstance(geom, Primitive):
        p = geom.prim
        if isinstance(p, HLine):
            return p.xmin, p.xmax, p.y, p.y
        if isinstance(p, VLine):
            return p.x, p.x, p.ymin, p.ymax
        return p.xmin, p.xmax, p.ymin, p.ymax
    if isinstance(geom, Basic):
        sk = geom.shape
        if isinstance(sk, (PathShape,)):
            return gpath.path_proper_bounds(sk.path)
        if isinstance(sk, BrushStroke):
            return gpath.path_proper_bounds(sk.brushstroke[1])
        if isinstance(sk, StrokedPathShape):
            return gpath.path_proper_bounds(sk.path)
        if isinstance(sk, CPG):
            ax0, ax1, ay0, ay1 = proper_bounds_geom(Basic(rfills.dummy, sk.a))
            bx0, bx1, by0, by1 = proper_bounds_geom(Basic(rfills.dummy, sk.b))
            if sk.op == INTERSECTION:
                return max(ax0, bx0), min(ax1, bx1), max(ay0, by0), min(ay1, by1)
            return min(ax0, bx0), max(ax1, bx1), min(ay0, by0), max(ay1, by1)
    if isinstance(geom, Group):
        if not geom.objects:
            raise ValueError("empty groups aren't allowed")
        bs = [proper_bounds(o) for o in geom.objects]
        x0 = min(b[0] for b in bs)
        x1 = max(b[1] for b in bs)
        y0 = min(b[2] for b in bs)
        y1 = max(b[3] for b in bs)
        return x0, x1, y0, y1
    raise TypeError(geom)


def proper_bounds(o: Obj) -> Tuple[float, float, float, float]:
    """Float bounds of the transformed object (render.ml:351-365)."""
    xmin, xmax, ymin, ymax = proper_bounds_geom(o.geometry)
    pts = [(xmin, ymin), (xmin, ymax), (xmax, ymax), (xmax, ymin)]
    txy = [tr.transform(list(o.transform), p) for p in pts]
    xs = [p[0] for p in txy]
    ys = [p[1] for p in txy]
    return min(xs), max(xs), min(ys), max(ys)


# Per-instance memo for bounds_of_basicshape.  The render fold consults the
# bounds of EVERY scene object on EVERY render for the bbox trivial reject
# (renderobj, render.ml:1268-1275); recomputing them walks the whole
# transformed path in Python and dominates interactive per-event host time
# (profiled: ~60% of a drag event on the host-compute path).  Obj is a
# frozen dataclass, so (geometry, transform) can never change under a live
# instance — keyed by identity, verified by a weakref, evicted on GC.
_bounds_memo: dict = {}


def bounds_of_basicshape(o: Obj) -> Tuple[int, int, int, int]:
    """Integer (xmin, xmax, ymin, ymax) bounds (render.ml:368-437), memoized
    per Obj instance (immutable)."""
    key = id(o)
    hit = _bounds_memo.get(key)
    if hit is not None and hit[0]() is o:
        return hit[1]
    val = _bounds_of_basicshape_impl(o)
    try:
        ref = weakref.ref(o, lambda _r, _k=key: _bounds_memo.pop(_k, None))
    except TypeError:
        return val
    _bounds_memo[key] = (ref, val)
    return val


def _bounds_of_basicshape_impl(o: Obj) -> Tuple[int, int, int, int]:
    g = o.geometry
    if isinstance(g, FilterG):
        return bounds_of_basicshape(Obj(o.idset, g.filter.geometry, o.transform, o.compop))
    if isinstance(g, Convolved):
        width = rconvolve.radius_of_kernel(g.kernel)
        if isinstance(g.geometry, Group):
            inner = Obj(o.idset, g.geometry, o.transform, o.compop)
        else:
            inner = fakeobj_t(g.geometry, o.transform)
        xmin, xmax, ymin, ymax = bounds_of_basicshape(inner)
        return xmin - width, xmax + width, ymin - width, ymax + width
    if isinstance(g, Primitive):
        p = g.prim
        ti = lambda v: int(math.trunc(v))
        if isinstance(p, HLine):
            return ti(p.xmin), ti(p.xmax), ti(p.y), ti(p.y)
        if isinstance(p, VLine):
            return ti(p.x), ti(p.x), ti(p.ymin), ti(p.ymax)
        return ti(p.xmin), ti(p.xmax), ti(p.ymin), ti(p.ymax)
    if isinstance(g, Group):
        bs = [
            bounds_of_basicshape(
                Obj(x.idset, x.geometry, tuple(tr.append(list(o.transform), list(x.transform))), x.compop)
            )
            for x in g.objects
        ]
        return (
            min(b[0] for b in bs),
            max(b[1] for b in bs),
            min(b[2] for b in bs),
            max(b[3] for b in bs),
        )
    # Basic
    sk = transform_shapekind(o.transform, g.shape)
    if isinstance(sk, PathShape):
        return gpath.bounds_polygon(sk.path)
    if isinstance(sk, BrushStroke):
        return rbrush.bounds_brushstroke(sk.brushstroke)
    if isinstance(sk, StrokedPathShape):
        return gshapes.bounds_stroke(sk.path, sk.spec)
    # CPG: box union / intersection of the parts (GPC-on-boxes replacement).
    a = bounds_of_basicshape(Obj(ident.new_ids(), Basic(rfills.dummy, sk.a), (), o.compop))
    b = bounds_of_basicshape(Obj(ident.new_ids(), Basic(rfills.dummy, sk.b), (), o.compop))
    if sk.op == INTERSECTION:
        return max(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), min(a[3], b[3])
    return min(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3])


# ---------------------------------------------------------------------------
# Positioning (render.ml:439-462)
# ---------------------------------------------------------------------------

Left, TopLeft, Top, TopRight, Right = "Left", "TopLeft", "Top", "TopRight", "Right"
BottomRight, Bottom, BottomLeft, Centre = "BottomRight", "Bottom", "BottomLeft", "Centre"


def findpoint(anchor: str, o: Obj) -> Tuple[float, float]:
    minx, maxx, miny, maxy = proper_bounds(o)
    mid = lambda a, b: ((a[0] + b[0]) / 2.0, (a[1] + b[1]) / 2.0)
    tl, trp = (minx, miny), (maxx, miny)
    bl, br = (minx, maxy), (maxx, maxy)
    l, t = mid(tl, bl), mid(tl, trp)
    r, b = mid(trp, br), mid(bl, br)
    c = mid(l, r)
    return {
        Left: l, TopLeft: tl, Top: t, TopRight: trp, Right: r,
        BottomRight: br, Bottom: b, BottomLeft: bl, Centre: c,
    }[anchor]


def position_anchor(anchor: str, p: Tuple[float, float], o: Obj) -> Obj:
    fx, fy = findpoint(anchor, o)
    return transform_renderobject(tr.Translate(p[0] - fx, p[1] - fy), o)



# ---------------------------------------------------------------------------
# Shape of an object (render.ml:464-594)
# ---------------------------------------------------------------------------


def shape_of_basicshape(o: Obj, device, getshp: bool = True, getminshp: bool = True):
    """(shape, minshape) of an object, on `device`, through the cache."""
    g = o.geometry
    if isinstance(g, FilterG):
        return shape_of_basicshape(
            Obj(o.idset, g.filter.geometry, o.transform, o.compop), device, getshp, getminshp
        )
    if isinstance(g, Group):
        got = cache.getshape(o.idset)
        if got is not None:
            return got
        shp = NULL_SHAPE
        for x in g.objects:
            xobj = Obj(
                ident.new_ids(),
                x.geometry,
                tuple(tr.append(list(o.transform), list(x.transform))),
                x.compop,
            )
            s, _ = shape_of_basicshape(xobj, device, getshp, getminshp)
            shp = s_uni(shp, s)
        minshp = NULL_SHAPE
        cache.addshape(o.idset, shp, minshp)
        return shp, minshp
    if isinstance(g, Basic):
        got = cache.getshape(o.idset)
        if got is not None:
            return got
        sk = transform_shapekind(o.transform, g.shape)
        if isinstance(sk, PathShape):
            shp, minshp = scanline.shapeminshape_polygon(sk.path, device)
        elif isinstance(sk, BrushStroke):
            shp, minshp = rbrush.shape_of_brushstroke(sk.brushstroke, device)
        elif isinstance(sk, StrokedPathShape):
            shp, minshp = scanline.shapeminshape_of_unsorted_edgelist(
                gshapes.strokepath(sk.spec, sk.path), gpath.NONZERO, device
            )
        else:  # CPG set algebra (render.ml:511-528)
            a_shp, a_min = shape_of_basicshape(
                Obj(ident.new_ids(), Basic(rfills.dummy, sk.a), (), o.compop), device
            )
            b_shp, b_min = shape_of_basicshape(
                Obj(ident.new_ids(), Basic(rfills.dummy, sk.b), (), o.compop), device
            )
            if sk.op == UNION:
                shp, minshp = s_uni(a_shp, b_shp), s_uni(a_min, b_min)
            elif sk.op == INTERSECTION:
                shp, minshp = s_int(a_shp, b_shp), s_int(a_min, b_min)
            elif sk.op == SUBTRACTION:
                shp, minshp = s_diff(a_shp, b_min), s_diff(a_min, b_shp)
            else:  # exclusive or
                shp = s_diff(s_uni(a_shp, b_shp), s_int(a_min, b_min))
                minshp = s_uni(s_diff(b_min, a_shp), s_diff(a_min, b_shp))
        cache.addshape(o.idset, shp, minshp)
        return shp, minshp
    if isinstance(g, Convolved):
        got = cache.getshape(o.idset)
        if got is not None:
            return got
        r = rconvolve.radius_of_kernel(g.kernel)
        was = cache.usecache
        cache.usecache = False  # render.ml:540 (inner ids are fresh each call)
        try:
            inner = Obj(o.idset, g.geometry, o.transform, o.compop)
            shp = region.bloat(r, r, shapeonly_of_basicshape(inner, device))
            if findfill(g.geometry) == rfills.PLAIN:
                minshp = region.erode(r, r, minshapeonly_of_basicshape(inner, device))
            else:
                minshp = NULL_SHAPE
        finally:
            cache.usecache = was
        cache.addshape(o.idset, shp, minshp)
        return shp, minshp
    # Primitive (render.ml:558-586): shape == minshape, from direct masks.
    p = g.prim
    ti = lambda v: int(math.trunc(v))
    if isinstance(p, HLine):
        yi, xmini, xmaxi = ti(p.y), ti(p.xmin), ti(p.xmax)
        if xmaxi < xmini:
            raise ValueError(f"HLine with xmax < xmin: {p}")
        if xmaxi == xmini:
            return NULL_SHAPE, NULL_SHAPE
        shape = region.shape_of_box((xmini, yi, xmaxi, yi), device)
    elif isinstance(p, VLine):
        xi, ymini, ymaxi = ti(p.x), ti(p.ymin), ti(p.ymax)
        if ymaxi < ymini:
            raise ValueError(f"VLine with ymax < ymin: {p}")
        if ymaxi == ymini:
            return NULL_SHAPE, NULL_SHAPE
        shape = region.shape_of_box((xi, ymini, xi, ymaxi), device)
    else:
        if p.xmax < p.xmin or p.ymax < p.ymin:
            raise ValueError(f"inverted rectangle primitive: {p}")
        shape = region.shape_of_box((ti(p.xmin), ti(p.ymin), ti(p.xmax), ti(p.ymax)), device)
    return shape, shape


def shapeonly_of_basicshape(o: Obj, device):
    return shape_of_basicshape(o, device, True, False)[0]


def minshapeonly_of_basicshape(o: Obj, device):
    return shape_of_basicshape(o, device, False, True)[1]


# ---------------------------------------------------------------------------
# CPG rasterization (render.ml:847-981)
# ---------------------------------------------------------------------------


def _register_cpg_ops():

    def _alpha(x):
        return x[..., 3:4]

    def cpg_add(a, b):
        t = torch.clamp(_alpha(a) + _alpha(b), max=255)
        z = torch.zeros_like(t)
        return torch.cat([z, z, z, t], dim=-1)

    def cpg_sub(a, b):
        c = torch.clamp(_alpha(a) - _alpha(b), min=0)
        return torch.cat([c, c, c, c], dim=-1)

    def cpg_min(a, b):
        c = torch.minimum(_alpha(a), _alpha(b))
        return torch.cat([c, c, c, c], dim=-1)

    def cpg_eor(a, b):
        # Continuous XOR approximation (render.ml:858-864).
        aa, ab = _alpha(a), _alpha(b)
        inv = lambda v: 255 - v
        lo_lo = torch.maximum(aa, ab)
        hi_lo = inv(torch.maximum(inv(aa), ab))
        lo_hi = inv(torch.maximum(aa, inv(ab)))
        hi_hi = torch.maximum(inv(aa), inv(ab))
        c = torch.where(
            aa < 128, torch.where(ab < 128, lo_lo, lo_hi), torch.where(ab < 128, hi_lo, hi_hi)
        )
        return torch.cat([c, c, c, c], dim=-1)

    region.register_caf_op("cpg_add", cpg_add)
    region.register_caf_op("cpg_sub", cpg_sub)
    region.register_caf_op("cpg_min", cpg_min)
    region.register_caf_op("cpg_eor", cpg_eor)


_register_cpg_ops()


def invert_fill(spr):
    """Invert alpha levels (render.ml:850-854)."""

    def f(rgba):
        c = 255 - rgba[..., 3:4]
        return torch.cat([c, c, c, c], dim=-1)

    return region.sprite_map(f, spr)


def sprite_of_cpg(shp, fill, f_transform, op, a, b, whole_scene, device):
    """Constructive planar geometry renderer (render.ml:867-981)."""
    fill2 = fill.transform(list(f_transform))
    dummy_a = Obj(ident.new_ids(), Basic(rfills.plain(C.black), a), (), OVER)
    dummy_b = Obj(ident.new_ids(), Basic(rfills.plain(C.black), b), (), OVER)
    shp_a, minshp_a = shape_of_basicshape(dummy_a, device)
    shp_b, minshp_b = shape_of_basicshape(dummy_b, device)
    shp_a, minshp_a = s_int(shp_a, shp), s_int(minshp_a, shp)
    shp_b, minshp_b = s_int(shp_b, shp), s_int(minshp_b, shp)
    maxshp_a = s_diff(shp_a, minshp_a)
    maxshp_b = s_diff(shp_b, minshp_b)
    torender_a = s_int(shp, shp_a)
    torender_b = s_diff(s_int(shp, shp_b), s_int(minshp_a, minshp_b))
    spr_a = sprite_of_basicshape(dummy_a, torender_a, whole_scene, device)
    spr_b = sprite_of_basicshape(dummy_b, torender_b, whole_scene, device)
    shrend_a = region.shape_of_sprite(spr_a)
    shrend_b = region.shape_of_sprite(spr_b)
    total = s_uni(shrend_a, shrend_b)
    mm = s_int(s_int(minshp_a, minshp_b), total)
    mM = s_int(s_int(minshp_a, maxshp_b), total)
    Mm = s_int(s_int(maxshp_a, minshp_b), total)
    MM = s_int(s_int(maxshp_a, maxshp_b), total)

    def cafop(name, x, y):
        return caf(name, "opaque", x, y)[0]

    pa = lambda s: region.portion(spr_a, s)
    pb = lambda s: region.portion(spr_b, s)
    if op == UNION:
        minmin, minmax, maxmin = pa(mm), pb(mM), pa(Mm)
        maxmax = cafop("cpg_add", pa(MM), pb(MM))
    elif op == SUBTRACTION:
        minmin, minmax, maxmin = NULL_SPRITE, invert_fill(pb(mM)), NULL_SPRITE
        maxmax = cafop("cpg_sub", pa(MM), pb(MM))
    elif op == INTERSECTION:
        minmin, minmax, maxmin = pa(mm), pb(mM), pa(Mm)
        maxmax = cafop("cpg_min", pa(MM), pb(MM))
    else:  # exclusive or
        minmin, minmax, maxmin = NULL_SPRITE, invert_fill(pb(mM)), invert_fill(pa(Mm))
        maxmax = cafop("cpg_eor", pa(MM), pb(MM))
    covered = s_uni(s_uni(mm, mM), s_uni(Mm, MM))
    min_a = pa(s_int(s_diff(minshp_a, covered), shrend_a))
    min_b = pb(s_int(s_diff(minshp_b, covered), shrend_b))
    max_a = pa(s_int(s_diff(maxshp_a, covered), shrend_a))
    max_b = pb(s_int(s_diff(maxshp_b, covered), shrend_b))
    alpha = None
    for part in (minmin, minmax, maxmin, maxmax, min_a, min_b, max_a, max_b):
        if part is None:
            continue
        alpha = part if alpha is None else cafop("nocover", alpha, part)
    if alpha is None:
        return NULL_SPRITE
    # Apply the fill by dissolving it with the combined alpha plane.
    h, w = alpha.mask.shape
    fill_rgba = fill2.image_device(alpha.box, h, w, alpha.mask.device)
    rgba = torch.where(alpha.mask[..., None], C.dissolve_rgba(fill_rgba, alpha.rgba[..., 3]), 0)
    return region.Sprite(alpha.box, alpha.mask, rgba)


# ---------------------------------------------------------------------------
# Rasterizing basic shapes (render.ml:984-1078)
# ---------------------------------------------------------------------------


def sprite_of_basicshape(o: Obj, shp, whole_scene, device, force_fancy: bool = False):
    g = o.geometry
    if isinstance(g, FilterG):
        return sprite_of_basicshape(
            Obj(o.idset, g.filter.geometry, o.transform, o.compop), shp, whole_scene, device, True
        )
    if isinstance(g, Group):
        objs = [
            Obj(
                ident.new_ids(),
                x.geometry,
                tuple(tr.append(list(o.transform), list(x.transform))),
                x.compop,
            )
            for x in g.objects
        ]
        if flags.get("batch_group_raster"):
            from . import fastframe  # fastframe imports this module

            got = fastframe.group_sprite_batched(objs, shp, device)
            if got is not NotImplemented:
                return got
        a, _, _ = render_scene(
            ident.new_ids(), False, (shp, NULL_SPRITE), objs, whole_scene, NULL_SHAPE, device
        )
        return a
    if isinstance(g, Basic):
        sk = transform_shapekind(o.transform, g.shape)
        fill = g.fill.transform(list(o.transform))
        if isinstance(sk, PathShape):
            spr = raa.polygon_sprite(fill, shp, sk.path)
            if region.debug_spritecheck and not region.spritecheck(spr):
                raise ValueError("sprite_of_basicshape: malformed")
            return spr
        if isinstance(sk, StrokedPathShape):
            stroked = gshapes.strokepath(sk.spec, sk.path)
            return raa.polygon_sprite_edgelist(fill, shp, stroked, gpath.EVEN_ODD)
        if isinstance(sk, BrushStroke):
            return rbrush.sprite_of_brushstroke(sk.brushstroke, fill, shp, device)
        return sprite_of_cpg(shp, g.fill, o.transform, sk.op, sk.a, sk.b, whole_scene, device)
    if isinstance(g, Convolved):
        r = rconvolve.radius_of_kernel(g.kernel)
        shp2 = region.bloat(r, r, shp)
        if isinstance(g.geometry, Group):
            inner = fakeobj_t(g.geometry, o.transform)
            rasterized = sprite_of_basicshape(inner, shp2, whole_scene, device)
            return region.portion(rconvolve.convolve_sprite(g.kernel, rasterized), shp)
        s2 = transform_basicshape(o.transform, g.geometry)
        rasterized = sprite_of_basicshape(fakeobj(s2), shp2, whole_scene, device)
        return region.portion(rconvolve.convolve_sprite(g.kernel, rasterized), shp)
    raise ValueError("Primitive should already have been rendered")


# ---------------------------------------------------------------------------
# The HSR core (render.ml:1080-1335)
# ---------------------------------------------------------------------------


def spriteof_filter(lmo, lower, whole_scene, obj, idset, objects_below, shptorender, flt: Filter, device):
    """Render a filter object (render.ml:1080-1131): rewrite the scene below,
    render it, raster-filter the result, then blend with the unfiltered scene
    by the filter geometry's alpha."""
    global underanyfilter
    setanyfilter = not underanyfilter
    if setanyfilter:
        underanyfilter = True
    try:
        scene_torender, shptorender2, scene2 = flt.reading_scene(
            shptorender, idset, obj, objects_below, device
        )
        scene_rendered, lower2, _ = render_scene(
            lmo, lower, (scene_torender, NULL_SPRITE), scene2, whole_scene, NULL_SHAPE, device
        )
        filtered = flt.filter(scene_rendered, obj, shptorender2, device)
        alpha_in_update = sprite_of_basicshape(obj, shptorender2, whole_scene, device)
        _, pixels_finished = caf("nocover", "opaque", NULL_SPRITE, alpha_in_update)
        pixels_for_normal = s_diff(shptorender2, pixels_finished)
        scenerendered, lower2, _ = render_scene(
            lmo, lower2, (pixels_for_normal, NULL_SPRITE), objects_below, whole_scene, NULL_SHAPE,
            device,
        )
        r = blend_prime(scenerendered, filtered, alpha_in_update)
        e = shapeonly_of_basicshape(obj, device)
        if pdf_filter_debug_active:
            # The filter debug page layout of render.ml:1117-1130.
            from ..utils import debugpdf as D

            D.add_debug_shape(shptorender)
            D.add_debug_shape(scene_torender, dx=300)
            D.add_debug_sprite(scene_rendered, dx=600)
            D.add_debug_sprite(filtered, dx=900)
            D.add_debug_sprite(alpha_in_update, dx=1200)
            D.add_debug_shape(pixels_finished, dy=300)
            D.add_debug_shape(pixels_for_normal, dx=300, dy=300)
            D.add_debug_sprite(scenerendered, dx=600, dy=300)
            D.add_debug_sprite(r, dx=900, dy=300)
            D.add_debug_shape(e, dx=1200, dy=300)
            D.write_debug_page("Filter")
        return r, e
    finally:
        if setanyfilter:
            underanyfilter = False


def _att_out(col, alphacol):
    return C.dissolve_rgba(col, 255 - alphacol[..., 3])


def _att_in(col, alphacol):
    return C.dissolve_rgba(col, alphacol[..., 3])


def blend_prime(sprsc, sprsc2, alpha):
    """Alpha-weighted blend of scene and filtered scene (render.ml:1248-1265)."""
    a_in_1 = region.portion(alpha, region.shape_of_sprite(sprsc))
    a_in_2 = region.portion(alpha, region.shape_of_sprite(sprsc2))
    # Registered on every call, as the reference does: a caller may have
    # replaced the table's entries in between.
    region.register_caf_op("blend_att_out", _att_out)
    region.register_caf_op("blend_att_in", _att_in)
    s1, _ = caf("blend_att_out", "opaque", sprsc, a_in_1)
    s2, _ = caf("blend_att_in", "opaque", sprsc2, a_in_2)
    out, _ = caf("plus", "opaque", s1, s2)
    return out


def spriteof(lmo, lower, obj: Obj, shp, objects_below, whole_scene, device):
    """Per-object render with cache consult/extend (render.ml:1134-1242)."""
    idset = obj.idset
    geom = obj.geometry
    lower2 = lower
    if isinstance(geom, FilterG) and not lower:
        cachedwholesprite, pshape = NULL_SPRITE, NULL_SHAPE
    else:
        got = cache.getsprite(idset)
        cachedwholesprite, pshape = got if got is not None else (NULL_SPRITE, NULL_SHAPE)
    shptorender = s_diff(shp, pshape)
    if region.is_null_shape(shptorender):
        part = region.portion(cachedwholesprite, shp)
        ef = region.shape_of_sprite(part) if isinstance(geom, FilterG) else NULL_SHAPE
        return part, ef, lower2
    if isinstance(geom, Convolved) and isinstance(
        geom.geometry, (Convolved, Primitive, FilterG)
    ):
        raise ValueError("spriteof: malformed scene")
    if isinstance(geom, (Basic, Group)) or (
        isinstance(geom, Convolved) and isinstance(geom.geometry, (Basic, Group))
    ):
        fill = fillin_obj(obj)
        shp_o, minshp = shape_of_basicshape(obj, device)
        maxshape = s_diff(shp_o, minshp)
        # Tighten the AA fringe's box: its loose intersection box would make
        # the Gaussian-coverage product run over the whole object area even
        # though only the fringe needs it (one bounds sync, large savings).
        maxshapebitshape = region.boxshape(s_int(shptorender, maxshape))
        maxshapebit = sprite_of_basicshape(obj, maxshapebitshape, whole_scene, device)
        minshapebitshape = s_int(minshp, shptorender)
        transformed_fill = fill.transform(list(obj.transform))
        minshapebit = region.fillshape(minshapebitshape, transformed_fill)
        rendered, _ = caf("nocover", "opaque", minshapebit, maxshapebit)
        ef = NULL_SHAPE
    elif isinstance(geom, Primitive):
        shape = shapeonly_of_basicshape(obj, device)
        torender = s_int(shptorender, shape)
        rendered = region.fillshape(torender, rfills.plain(geom.colour))
        ef = NULL_SHAPE
    elif isinstance(geom, FilterG):
        rendered, ef = spriteof_filter(
            lmo, lower2, whole_scene, obj, idset, objects_below, shptorender, geom.filter, device
        )
    else:
        raise TypeError(geom)
    newwholesprite, _ = caf("nocover", "opaque", cachedwholesprite, rendered)
    if newwholesprite is NULL_SPRITE:
        return NULL_SPRITE, ef, lower2
    pshape2 = region.shape_of_sprite(newwholesprite)
    if not isinstance(geom, Primitive):
        cache.addsprite(idset, newwholesprite, pshape2)
    part = region.portion(newwholesprite, s_int(shp, pshape2))
    return part, ef, lower2


def renderobj(lmo, lower, obj: Obj, objects_below, whole_scene, ua, master_update, device):
    """Render one object into the accumulator (render.ml:1268-1308)."""
    u, a = ua
    idset = obj.idset
    xmin, xmax, ymin, ymax = bounds_of_basicshape(obj)
    if u is None:
        raise ValueError("renderobj called for null dirty region")
    ux0, uy0, ux1, uy1 = u.box
    if not box_overlap((xmin, ymin, xmax, ymax), (ux0, uy0, ux1, uy1)):
        return u, a, (lower or lmo == idset)  # trivial reject on bounds
    r = shapeonly_of_basicshape(obj, device)
    r2 = s_int(r, u)
    if region.is_null_shape(r2):
        return u, a, lower
    s, ef, lower2 = spriteof(lmo, lower, obj, r2, objects_below, whole_scene, device)
    geom = obj.geometry
    if isinstance(geom, FilterG):
        a2, _ = caf("over", "opaque", a, s)
        f = ef
    else:
        op = obj.compop
        if op == OVER:
            a2, f = caf("over", "opaque", a, s)
        elif isinstance(op, PreTrans) and op.op == OVER:
            delta = int(math.trunc(op.v * 255.0))
            s2 = region.sprite_map(lambda rgba: C.dissolve_rgba(rgba, delta), s)
            a2, f = caf("over", "opaque", a, s2)
        else:
            raise ValueError(f"unknown compop {op}")
    u2 = s_diff(s_diff(u, f), ef)
    return u2, a2, lower2


def render_scene(lmo, lower, ua, objlist, whole_scene, master_update, device):
    """Front-to-back fold with early termination (render.ml:1310-1335)."""
    u, a = ua
    for k, obj in enumerate(objlist):
        if region.is_null_shape(u):
            profiling.counter("render.early_exit")
            if pdf_debug_active and not underanyfilter:
                from ..utils import debugpdf as D

                D.add_debug_sprite(a)
                D.write_debug_page("Final result of render_scene")
            return a, lower, u
        profiling.counter("render.objects_visited")
        u, a, lower = renderobj(
            lmo, lower, obj, list(objlist[k + 1 :]), whole_scene, (u, a), master_update, device
        )
    if pdf_debug_active and not underanyfilter:
        from ..utils import debugpdf as D

        D.add_debug_sprite(a)
        D.write_debug_page("Final result of render_scene")
    return a, lower, u


# ---------------------------------------------------------------------------
# Selections and views (render.ml:596-845, 1337-1474)
# ---------------------------------------------------------------------------

Size = "Size"


@dataclass(frozen=True)
class Rotate:
    x: int
    y: int


HandleTopLeft = "HandleTopLeft"
HandleTopMiddle = "HandleTopMiddle"
HandleTopRight = "HandleTopRight"
HandleLeftMiddle = "HandleLeftMiddle"
HandleRightMiddle = "HandleRightMiddle"
HandleBottomLeft = "HandleBottomLeft"
HandleBottomMiddle = "HandleBottomMiddle"
HandleBottomRight = "HandleBottomRight"
HandleRotationCentre = "HandleRotationCentre"

_SIZE_HANDLES = [
    HandleTopLeft, HandleTopMiddle, HandleTopRight, HandleLeftMiddle,
    HandleRightMiddle, HandleBottomLeft, HandleBottomMiddle, HandleBottomRight,
]


class HandleRef:
    def __init__(self):
        self.obj: Optional[Obj] = None


def handles_size():
    return [(h, ident.new_ids(), HandleRef()) for h in _SIZE_HANDLES]


def handles_rotate():
    return [(HandleRotationCentre, ident.new_ids(), HandleRef())] + handles_size()


# selection = (objects, handlelist); selections = (box kind, selection)
null_selection = (Size, ([], []))


def renderobject_of_handle(selections, handle):
    _, (_, handlelist) = selections
    for h, _, ref in handlelist:
        if h == handle and ref.obj is not None:
            return ref.obj
    raise ValueError("renderobject_of_handle: handle not found")


def segments_of_points(points):
    if not points:
        return []
    pts = list(points) + [points[0]]
    return [gpath.Straight(pts[k], pts[k + 1]) for k in range(len(pts) - 1)]


def segments_of_points_open(points):
    return [gpath.Straight(points[k], points[k + 1]) for k in range(len(points) - 1)]


selection_colour = C.mkcol(255, 0, 0)
selection_fill = rfills.plain(selection_colour)

# Sizing arrow glyph (render.ml:669-672).
_arrow_points = [
    (1.0, -1.5), (2.0, -1.5), (0.0, -3.5), (-2.0, -1.5), (-1.0, -1.5),
    (-1.0, 1.5), (-2.0, 1.5), (0.0, 3.5), (2.0, 1.5), (1.0, 1.5),
]
arrow = segments_of_points(_arrow_points)


def arrow_at(p, angle_deg: float) -> Obj:
    t = [
        tr.Translate(p[0], p[1]),
        tr.Rotate((0.0, 0.0), math.radians(angle_deg)),
        tr.Scale((0.0, 0.0), 3.0, 3.0),
    ]
    path = gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, True, tuple(arrow)),))
    return Obj(ident.new_ids(), Basic(selection_fill, PathShape(path)), tuple(t), OVER)


def _rotate_glyph():
    k = gshapes.kappa
    down = segments_of_points_open(
        [(0.5, -2.0), (1.5, -2.0), (0.0, -4.0), (-1.5, -2.0), (-0.5, -2.0)]
    )
    outer = [gpath.Bezier((-0.5, -2.0), (-0.5, 2.5 * k - 2.0), (2.0 - 2.5 * k, 0.5), (2.0, 0.5))]
    right = segments_of_points_open(
        [(2.0, 0.5), (2.0, 1.5), (4.0, 0.0), (2.0, -1.5), (2.0, -0.5)]
    )
    inner = [gpath.Bezier((2.0, -0.5), (2.0 - 1.5 * k, -0.5), (0.5, 1.5 * k - 2.0), (0.5, -2.0))]
    return down + outer + right + inner


rotate_glyph = _rotate_glyph()


def rotate_at(p, angle_deg: float) -> Obj:
    t = [
        tr.Translate(p[0], p[1]),
        tr.Rotate((0.0, 0.0), math.radians(angle_deg)),
        tr.Scale((0.0, 0.0), 4.0, 4.0),
    ]
    path = gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, True, tuple(rotate_glyph)),))
    return Obj(ident.new_ids(), Basic(selection_fill, PathShape(path)), tuple(t), OVER)


rotation_centre = segments_of_points(
    [
        (1.0, 2.0), (2.0, 2.0), (2.0, 1.0), (3.0, 1.0), (3.0, 2.0), (4.0, 2.0),
        (4.0, 3.0), (3.0, 3.0), (3.0, 4.0), (2.0, 4.0), (2.0, 3.0), (1.0, 3.0),
    ]
)


def mkobj(fill, geom_shape) -> Obj:
    return Obj(ident.new_ids(), Basic(fill, geom_shape), (), OVER)


def rotation_centre_at(p) -> Obj:
    path = gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, True, tuple(rotation_centre)),))
    scaled = transform_renderobject(
        tr.Scale((0.0, 0.0), 4.0, 4.0), mkobj(selection_fill, PathShape(path))
    )
    return position_anchor(Centre, (float(p[0]), float(p[1])), scaled)


def drawable_primitive_rectangle(col, xmin, xmax, ymin, ymax):
    assert xmax >= xmin and ymax >= ymin
    return [
        Primitive(col, HLine(ymin, xmin, xmax)),
        Primitive(col, HLine(ymax, xmin, xmax)),
        Primitive(col, VLine(xmin, ymin, ymax)),
        Primitive(col, VLine(xmax, ymin, ymax)),
    ]


def drawable_of_rubberband(x0, y0, x1, y1):
    xmin, xmax = float(min(x0, x1)), float(max(x0, x1))
    ymin, ymax = float(min(y0, y1)), float(max(y0, y1))
    return [
        Obj(ident.new_ids(), g, (), OVER)
        for g in drawable_primitive_rectangle(C.black, xmin, xmax, ymin, ymax)
    ]


def drawable_of_selection(selections):
    """Selection handles + bounding rectangle (render.ml:758-814)."""
    box, (renderobjects, handles) = selections
    if not renderobjects:
        return []
    bs = [bounds_of_basicshape(o) for o in renderobjects]
    xmin = float(min(b[0] for b in bs))
    xmax = float(max(b[1] for b in bs))
    ymin = float(min(b[2] for b in bs))
    ymax = float(max(b[3] for b in bs))
    rect = [
        Obj(ident.new_ids(), g, (), OVER)
        for g in drawable_primitive_rectangle(selection_colour, xmin, xmax, ymin, ymax)
    ]

    def setobj(handle, o):
        for h, _, ref in handles:
            if h == handle:
                ref.obj = o
                return
        raise ValueError("failed to set object in selection")

    if box == Size:
        p = lambda v: v - 8.0
        m = lambda v: v + 8.0
        pp = lambda v: v - 12.0
        mm = lambda v: v + 12.0
        hl = [
            (HandleTopLeft, arrow_at((p(xmin), p(ymin)), 135.0)),
            (HandleTopMiddle, arrow_at(((xmax + xmin) / 2.0, pp(ymin)), 180.0)),
            (HandleTopRight, arrow_at((m(xmax), p(ymin)), 225.0)),
            (HandleRightMiddle, arrow_at((mm(xmax), (ymax + ymin) / 2.0), 270.0)),
            (HandleBottomRight, arrow_at((m(xmax), m(ymax)), 315.0)),
            (HandleBottomMiddle, arrow_at(((xmax + xmin) / 2.0, mm(ymax)), 0.0)),
            (HandleBottomLeft, arrow_at((p(xmin), m(ymax)), 45.0)),
            (HandleLeftMiddle, arrow_at((pp(xmin), (ymax + ymin) / 2.0), 90.0)),
        ]
    else:
        pp = lambda v: v - 12.0
        mm = lambda v: v + 12.0
        hl = [
            (HandleTopLeft, rotate_at((pp(xmin), pp(ymin)), 90.0)),
            (HandleTopMiddle, arrow_at(((xmax + xmin) / 2.0, pp(ymin)), 90.0)),
            (HandleTopRight, rotate_at((mm(xmax), pp(ymin)), 180.0)),
            (HandleRightMiddle, arrow_at((mm(xmax), (ymax + ymin) / 2.0), 180.0)),
            (HandleBottomRight, rotate_at((mm(xmax), mm(ymax)), 270.0)),
            (HandleBottomMiddle, arrow_at(((xmax + xmin) / 2.0, mm(ymax)), 270.0)),
            (HandleBottomLeft, rotate_at((pp(xmin), mm(ymax)), 0.0)),
            (HandleLeftMiddle, arrow_at((pp(xmin), (ymax + ymin) / 2.0), 0.0)),
            (HandleRotationCentre, rotation_centre_at((float(box.x), float(box.y)))),
        ]
    for h, o in hl:
        setobj(h, o)
    return [o for _, o in hl] + rect


def is_selected(selections, obj: Obj) -> bool:
    _, (objs, _) = selections
    return any(obj_eq(obj, o) for o in objs)


def outline_of_scene(scene):
    bs = [bounds_of_basicshape(o) for o in scene]
    xmin = float(min(b[0] for b in bs))
    xmax = float(max(b[1] for b in bs))
    ymin = float(min(b[2] for b in bs))
    ymax = float(max(b[3] for b in bs))
    return [
        Obj(ident.new_ids(), g, (), OVER)
        for g in drawable_primitive_rectangle(C.black, xmin, xmax, ymin, ymax)
    ]



@dataclass
class View:
    """A window displaying a scene (render.ml:837-845), rendered on
    `device`."""

    device: object
    scene: list = field(default_factory=list)
    pages: list = field(default_factory=list)
    window: object = None
    background: list = field(default_factory=list)
    selections: tuple = null_selection
    master_update: object = NULL_SHAPE
    rubberband: Optional[Tuple[int, int, int, int]] = None
    tool: str = "select"


# ---------------------------------------------------------------------------
# Frame rendering (render.ml:1337-1370)
# ---------------------------------------------------------------------------


def render_frame(lmo, view: View, update, display_selection=True, topobjects=()):
    """Render a frame on the view's device: selection/rubberband on top,
    pages+background beneath (render.ml:1345-1365)."""
    selections = view.selections if display_selection else null_selection
    scene = list(topobjects) + list(view.scene)
    selection_scene = drawable_of_selection(selections)
    rubber = (
        drawable_of_rubberband(*view.rubberband) if view.rubberband is not None else []
    )

    def render(s):
        a, _, _ = render_scene(
            lmo, False, (update, NULL_SPRITE), s, s, view.master_update, view.device
        )
        return a

    allbut = render(rubber + selection_scene + scene)
    background = render(list(view.pages) + list(view.background))
    out, _ = caf("over", "opaque", allbut, background)
    return out


def render_simple_scene(scene, shape, device):
    """Render `scene` within `shape` on `device` (the shape's own)."""
    a, _, _ = render_scene(
        ident.new_ids(), False, (shape, NULL_SPRITE), scene, scene, shape, device
    )
    return a


# ---------------------------------------------------------------------------
# Dirty regions (render.ml:1372-1438)
# ---------------------------------------------------------------------------


def plaindirty(o: Obj, n: Obj, u, device):
    """Dirty region for a transformed plain-filled object (render.ml:1376-1382).

    BEYOND REFERENCE for filters: the filter blend alpha is the Gaussian AA
    rasterization of the lens (spriteof_filter ``alpha_in_update``), whose
    32x32-table-at-16x fringe reaches up to 1px INSIDE the geometric
    minshape, so "fully covered before and after" does not imply
    blend-invariant there.  The minshapes are eroded by the AA footprint so
    that incremental frames equal from-scratch renders exactly."""
    shp_o, minshp_o = shape_of_basicshape(o, device)
    shp_n, minshp_n = shape_of_basicshape(n, device)
    if isinstance(o.geometry, FilterG) or isinstance(n.geometry, FilterG):
        minshp_o = region.erode(1, 1, minshp_o)
        minshp_n = region.erode(1, 1, minshp_n)
    return s_int(s_uni(s_diff(shp_o, minshp_n), s_diff(shp_n, minshp_o)), u)


def alldirty(o: Obj, n: Obj, u, device):
    return s_int(
        s_uni(shapeonly_of_basicshape(o, device), shapeonly_of_basicshape(n, device)), u
    )


def compop_in(o: Obj):
    return o.compop


def dirty_region(obj: Obj, obj2: Obj, device):
    """Choose plain or full dirty (render.ml:1396-1400)."""
    fk = fillkind_in(obj)
    flk = filterkind_in(obj)
    same_op = compop_in(obj) == compop_in(obj2)
    if fk == rfills.PLAIN and same_op and flk in (None, FILTER_PLAIN):
        return lambda u: plaindirty(obj, obj2, u, device)
    return lambda u: alldirty(obj, obj2, u, device)


def dirty_selections(s, s2, u, device):
    """Dirty region between two selections (render.ml:1407-1416)."""
    shapes = [shapeonly_of_basicshape(o, device) for o in drawable_of_selection(s)]
    shapes += [shapeonly_of_basicshape(o, device) for o in drawable_of_selection(s2)]
    total = NULL_SHAPE
    for sh in shapes:
        total = s_uni(total, sh)
    return s_int(total, u)


def dirty_filter(lmo, initial_dirty, scene, device):
    """Compose filter dirty functions above the LMO (render.ml:1420-1438)."""

    def extract_filters(s):
        out = []
        for o in s:
            if isinstance(o.geometry, FilterG):
                out.append(o)
            elif isinstance(o.geometry, Group):
                out.extend(extract_filters(o.geometry.objects))
        return out

    above = []
    for o in scene:
        if o.idset == lmo:
            break
        above.append(o)
    filters = extract_filters(above)
    shape = initial_dirty
    for fobj in reversed(filters):
        shape = fobj.geometry.filter.dirty(shape, fobj, device)
    return shape


# ---------------------------------------------------------------------------
# Picking (render.ml:1440-1474)
# ---------------------------------------------------------------------------


@dataclass
class PickedObject:
    obj: Obj


@dataclass
class PickedSelectionHandle:
    obj: Obj
    objs: list
    handle: str


PickedNone = None


def pickobj(x, y, scene, device):
    for o in scene:
        if region.point_in_shape(shapeonly_of_basicshape(o, device), (x, y)):
            return PickedObject(o)
    return PickedNone


def pickhandle(x, y, handles, device):
    for handle, _, ref in handles:
        if ref.obj is not None and region.point_in_shape(
            shapeonly_of_basicshape(ref.obj, device), (x, y)
        ):
            return handle, ref.obj
    return None


def picksel(x, y, selections, device):
    _, (objs, handles) = selections
    got = pickhandle(x, y, handles, device)
    if got is None:
        return PickedNone
    handle, obj = got
    return PickedSelectionHandle(obj, objs, handle)


def pick(x, y, view: View):
    picked = picksel(x, y, view.selections, view.device)
    if picked is PickedNone:
        return pickobj(x, y, view.scene, view.device)
    return picked
