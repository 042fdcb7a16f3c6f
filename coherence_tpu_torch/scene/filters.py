"""Concrete scene filters (parity: reference ``filters.ml``).

The PyTorch counterpart of ``coherence_tpu.scene.filters``, whole.  Each
callback takes the device as its last argument (see ``render.Filter``).

Filters are scene-rewriting primitive-combiners: each provides a
``reading_scene`` function that rewrites the scene below it (and can grow the
region to read), a raster ``filter`` post-process, and a ``dirty`` transfer
function used when propagating dirty regions through the filter stack
(render.ml:1420-1438).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import colour as C
from .. import coord
from .. import ident
from .. import transform as tr
from ..geometry import path as gpath
from ..raster import brush as rbrush
from ..raster import convolve as rconvolve
from ..raster import fills as rfills
from ..raster import region, scanline
from ..raster.region import NULL_SHAPE
from . import render as R
from .render import (
    Basic,
    BrushStroke,
    Convolved,
    Filter,
    FilterG,
    FILTER_FANCY,
    FILTER_PLAIN,
    Group,
    Obj,
    PathShape,
    Primitive,
    StrokedPathShape,
)

# --- common helpers (filters.ml:6-91) ---------------------------------------


def nullfilterfunction(spr, _obj, _shp, _device):
    return spr


def nulldirty(shp, _obj, _device):
    return shp


def totaldirty(shp, renderobj, device):
    """Any impact requires recalculating the whole filter (filters.ml:16-20)."""
    ourshp = R.shapeonly_of_basicshape(renderobj, device)
    if region.shape_intersects(ourshp, shp):
        return region.shape_union(shp, ourshp)
    return shp


def reparent(pred, filter_idset, scene):
    """Give combined ids to objects satisfying pred (filters.ml:24-29)."""
    return [
        Obj(ident.combine(o.idset, filter_idset), o.geometry, o.transform, o.compop)
        if pred(o)
        else o
        for o in scene
    ]


def _always(_o):
    return True


def _never(_o):
    return False


def transform_shape(t, shp, device):
    """Raster -> geometric -> raster shape transform (filters.ml:35-62)."""
    if shp is None:
        return NULL_SHAPE
    mask = shp.mask_np()
    x0, y0, _, _ = shp.box
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return NULL_SHAPE
    # Compress each row of the mask into runs (s..e); each run becomes the
    # degenerate back-and-forth edge pair of the reference's edgelist_of_span.
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    new_run = np.ones(len(ys), dtype=bool)
    new_run[1:] = (ys[1:] != ys[:-1]) | (xs[1:] != xs[:-1] + 1)
    first_idx = np.flatnonzero(new_run)
    last_idx = np.append(first_idx[1:] - 1, len(xs) - 1)
    starts = (xs[first_idx] + x0).astype(np.float64)
    ends = (xs[last_idx] + x0).astype(np.float64)
    rows = (ys[first_idx] + y0).astype(np.float64)
    m = tr.matrix_of_transform(list(t))
    a, b, c, d, e, f_ = m
    ax = a * starts + c * rows + e
    ay = b * starts + d * rows + f_
    bx = a * ends + c * rows + e
    by = b * ends + d * rows + f_
    fwd = np.stack(
        [
            coord.sub_of_float_np(ax),
            coord.sub_of_float_np(ay),
            coord.sub_of_float_np(bx),
            coord.sub_of_float_np(by),
        ],
        axis=-1,
    )
    back = fwd[:, [2, 3, 0, 1]]
    earr = np.concatenate([fwd, back], axis=0)
    out, _ = scanline.shapeminshape_of_edgelist(earr, gpath.EVEN_ODD, device)
    return out


def bloatdirty(xradius: int, yradius: int):
    """Standard bloating dirty fn for blur/smear (filters.ml:67-75)."""

    def dirty(shp, obj, device):
        filter_shape = R.shapeonly_of_basicshape(obj, device)
        bloated_filter = region.bloat(xradius, yradius, filter_shape)
        in_filter = region.shape_intersection(bloated_filter, shp)
        out_filter = region.shape_difference(shp, bloated_filter)
        bloated = region.bloat(xradius, yradius, in_filter)
        bloated_in_filter = region.shape_intersection(bloated, bloated_filter)
        return region.shape_union(bloated_in_filter, out_filter)

    return dirty


def changefills(f, geom):
    """Apply a colour function to every non-filter fill (filters.ml:78-91)."""
    if isinstance(geom, FilterG):
        return geom
    if isinstance(geom, Convolved):
        return Convolved(geom.kernel, changefills(f, geom.geometry))
    if isinstance(geom, Basic):
        return Basic(geom.fill.changecolour(f), geom.shape)
    if isinstance(geom, Group):
        return Group(
            tuple(
                Obj(o.idset, changefills(f, o.geometry), o.transform, o.compop)
                for o in geom.objects
            )
        )
    return geom  # Primitive


# --- wireframe (filters.ml:93-145) ------------------------------------------


def _wireframe_flatten_scene(scene):
    out = []
    for o in scene:
        g = o.geometry
        if isinstance(g, (FilterG, Primitive)):
            pass
        elif isinstance(g, Group):
            out.extend(_wireframe_flatten_scene(g.objects))
        elif isinstance(g, Basic):
            out.append(o)
        elif isinstance(g, Convolved):
            out.extend(
                _wireframe_flatten_scene([Obj(ident.new_ids(), g.geometry, o.transform, o.compop)])
            )
    return out


def _mkwire(fill, strokespec, o: Obj) -> Obj:
    g = o.geometry
    if not isinstance(g, Basic):
        raise ValueError("mkwire")
    b = g.shape
    if isinstance(b, (PathShape, BrushStroke, StrokedPathShape)):
        if isinstance(b, PathShape):
            p = b.path
        elif isinstance(b, BrushStroke):
            p = b.brushstroke[1]
        else:
            p = b.path
        geom2 = Basic(fill, StrokedPathShape(gpath.transform_path(list(o.transform), p), strokespec))
    else:  # CPG
        geom2 = Group(
            tuple(
                _mkwire(fill, strokespec, R.fakeobj(R.transform_basicshape(o.transform, Basic(rfills.dummy, part))))
                for part in (b.a, b.b)
            )
        )
    return Obj(ident.new_ids(), geom2, (), R.OVER)


def _with_recipe(fg: FilterG, name: str, *args) -> FilterG:
    """Attach a reconstruction recipe for checkpointing (scene/checkpoint.py).

    FilterG is frozen; the recipe is advisory metadata."""
    object.__setattr__(fg, "recipe", (name, args))
    return fg


def wireframe(geometry, strokespec, fill) -> FilterG:
    """Rewrite the scene below into stroked outlines (filters.ml:128-145)."""

    def reading_scene(shp, idset, obj, scene, _device):
        return (
            shp,
            shp,
            reparent(
                _always, idset, [_mkwire(fill, strokespec, o) for o in _wireframe_flatten_scene(scene)]
            ),
        )

    def dirty(d, _obj, _device):
        w = int(math.ceil(strokespec.linewidth))
        return region.bloat(w, w, d)

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, nullfilterfunction, dirty, FILTER_PLAIN)),
        "wireframe",
        geometry,
        strokespec,
        fill,
    )


# --- rgb colour-shift (filters.ml:147-196) ----------------------------------


def _rgb_transform_object(colour_function, transform, o: Obj) -> Obj:
    geom2 = o.geometry if isinstance(o.geometry, FilterG) else changefills(colour_function, o.geometry)
    out = Obj(ident.new_ids(), geom2, o.transform, o.compop)
    for op in reversed(list(transform)):
        out = R.transform_renderobject(op, out)
    return out


def rgb(geometry, transforms, filltype) -> FilterG:
    """Offset r/g/b channels by per-channel transforms (filters.ml:164-196)."""
    rtf, gtf, btf = transforms
    centre = (0.0, 0.0)

    def reading_scene(shp, _idset, obj, scene, _device):
        f = obj.transform
        c = tr.transform(list(f), centre)
        out = []
        for o in scene:
            out.extend(
                [
                    _rgb_transform_object(
                        lambda col: C.dissolve(C.red_channel(col), delta=64), rtf(c), o
                    ),
                    _rgb_transform_object(
                        lambda col: C.dissolve(C.green_channel(col), delta=64), gtf(c), o
                    ),
                    _rgb_transform_object(
                        lambda col: C.dissolve(C.blue_channel(col), delta=64), btf(c), o
                    ),
                ]
            )
        return shp, shp, out

    def dirty(shp, renderobject, device):
        f = renderobject.transform
        c = tr.transform(list(f), centre)
        shp_r = transform_shape(rtf(c), shp, device)
        shp_g = transform_shape(gtf(c), shp, device)
        shp_b = transform_shape(btf(c), shp, device)
        union = region.shape_union(region.shape_union(shp_b, shp_r), shp_g)
        ourshape = R.shapeonly_of_basicshape(renderobject, device)
        infilter = region.shape_intersection(union, ourshape)
        return region.shape_union(infilter, shp)

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, nullfilterfunction, dirty, filltype)),
        "rgb", geometry, transforms, filltype,
    )


# --- smear (filters.ml:198-217) ----------------------------------------------


def smear(brushstroke) -> FilterG:
    brush, _path = brushstroke
    w, h = rbrush.sizeof_brush(brush)
    rx, ry = (w - 1) // 2, (h - 1) // 2

    def reading_scene(shp, _idset, _obj, scene, _device):
        return region.bloat(rx, ry, shp), shp, scene

    def filterfn(spr, obj, shp, device):
        spr2 = rbrush.smear(
            spr, rbrush.transform_brushstroke(list(obj.transform), brushstroke), device
        )
        shp2 = region.shape_intersection(shp, region.shape_of_sprite(spr2))
        return region.portion(spr2, shp2)

    geometry = Basic(rfills.plain(C.white), BrushStroke(rbrush.mkdummy(brushstroke)))
    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, filterfn, totaldirty, FILTER_FANCY)),
        "smear", brushstroke,
    )


# --- hole (filters.ml:219-229) -----------------------------------------------


def hole(geometry) -> FilterG:
    def reading_scene(shp, _idset, _obj, _scene, _device):
        return shp, shp, []

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, nullfilterfunction, nulldirty, FILTER_PLAIN)),
        "hole", geometry,
    )


# --- monochrome (filters.ml:231-242) ------------------------------------------


def monochrome(geometry) -> FilterG:
    def reading_scene(shp, idset, _obj, scene, _device):
        return shp, shp, reparent(_never, idset, scene)

    def filterfn(spr, _obj, _shp, _device):
        return region.sprite_map(C.monochrome_rgba, spr)

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, filterfn, nulldirty, FILTER_PLAIN)),
        "monochrome", geometry,
    )


# --- blur (filters.ml:244-261) -------------------------------------------------


def blur(geometry, kernel) -> FilterG:
    radius = rconvolve.radius_of_kernel(kernel)

    def reading_scene(shp, idset, _obj, scene, _device):
        shp2 = region.bloat(radius * 2 + 1, radius * 2 + 1, shp)
        return shp2, shp, reparent(_never, idset, scene)

    def filterfn(spr, _obj, result_shape, _device):
        if spr is None:
            return spr
        bloated = region.bloat(radius, radius, region.shape_of_sprite(spr))
        pickup = region.shape_intersection(bloated, result_shape)
        return rconvolve.convolve_sprite_in_shape(kernel, spr, bloated, pickup)

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, filterfn, bloatdirty(radius, radius), FILTER_PLAIN)),
        "blur", geometry, kernel,
    )


# --- affine (filters.ml:272-286) ----------------------------------------------


def affine(filter_transform, geometry) -> FilterG:
    def reading_scene(shp, _idset, _obj, scene, _device):
        return shp, shp, [R.transform_renderobject_many(list(filter_transform), o) for o in scene]

    def dirty(shp, obj, device):
        filter_shape = R.shapeonly_of_basicshape(obj, device)
        return region.shape_union(
            shp,
            region.shape_intersection(transform_shape(filter_transform, shp, device), filter_shape),
        )

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, nullfilterfunction, dirty, FILTER_PLAIN)),
        "affine", filter_transform, geometry,
    )


# --- minus (filters.ml:288-303) -------------------------------------------------


def minus(geometry) -> FilterG:
    def reading_scene(shp, _idset, obj, scene, device):
        if not scene:
            return NULL_SHAPE, NULL_SHAPE, []
        inter = region.shape_intersection(
            R.shapeonly_of_basicshape(obj, device), R.shapeonly_of_basicshape(scene[0], device)
        )
        inter2 = region.shape_intersection(inter, shp)
        return inter2, inter2, list(scene[1:])

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, nullfilterfunction, nulldirty, FILTER_PLAIN)),
        "minus", geometry,
    )


# --- blendmode (BEYOND REFERENCE: PDF 32000-1 §11.3.5) -------------------------


def blendmode(geometry, mode: str) -> FilterG:
    """Paint ``geometry`` with a PDF blend mode against the scene below.

    The filter reads the backdrop (scene below, unchanged), rasterizes its
    own geometry at the usual AA/alpha, and returns the opaque
    full-coverage mix ``M = (1-ab)·Cs + ab·B(Cb, Cs)`` over the region;
    ``spriteof_filter``'s ``blend_prime`` then lerps M against the normal
    scene by the object's rasterized alpha — together exactly the PDF
    composite ``C = (1-as)·Cb + as·M``.  The reference has no analogue
    (its only compop is Porter/Duff over, colour.ml:310-328).
    """
    from ..raster import blend as rblend  # registers the pdfblend_* caf ops

    if mode not in rblend.BLEND_MODES:
        raise ValueError(f"unknown blend mode {mode}")
    def reading_scene(shp, idset, _obj, scene, _device):
        return shp, shp, reparent(_never, idset, scene)

    def filterfn(spr, obj, shp, device):
        if shp is None:
            return spr
        # The object's own raster (AA fringe + fill alpha premultiplied).
        src = R.sprite_of_basicshape(obj, shp, None, device)
        if src is None:
            return spr
        # Extend the backdrop to cover all of shp (transparent where the
        # scene below painted nothing) so the caf overlap branch computes
        # the blend everywhere the source covers; ab=0 there gives M=Cs.
        zero = region.sprite_of_mask_rgba(
            shp.box, shp.mask, torch.zeros(tuple(shp.mask.shape) + (4,), dtype=torch.int32, device=shp.mask.device)
        )
        if spr is None:
            back = zero
        else:
            back, _ = region.caf("over", "opaque", spr, zero)
        out, _ = region.caf("pdfblend_" + mode, "opaque", src, back)
        return out

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, filterfn, nulldirty, FILTER_PLAIN)),
        "blendmode", geometry, mode,
    )


# --- swapdepth (filters.ml:305-332) ----------------------------------------------


def remove_ids(renderobjects, ids):
    return [o for o in renderobjects if o.idset not in ids]


def swap_in_list(o, o2, scene):
    arr = list(scene)

    def find(x):
        for k, obj in enumerate(arr):
            if obj.idset == x:
                return k
        return len(arr) - 1

    i, j = find(o), find(o2)
    arr[i], arr[j] = arr[j], arr[i]
    return arr


def swapdepth(o, o2, geometry) -> FilterG:
    def reading_scene(shp, _idset, _renderobject, scene, _device):
        return shp, shp, swap_in_list(o, o2, scene)

    return _with_recipe(
        FilterG(Filter(geometry, reading_scene, nullfilterfunction, nulldirty, FILTER_PLAIN)),
        "swapdepth", o, o2, geometry,
    )
