"""Scene model: the subset of ``coherence_tpu.scene.render`` that the tiled
frame path uses (parity: ``render.ml:19-437``).

Scenes are front-to-back lists of renderobjects (element 0 topmost).  The
port models plain-filled paths (``Basic`` of a ``PathShape``), brush
strokes (``BrushStroke``) and groups of them; stroked paths, CPG, convolved
and filter geometry, and the hidden-surface-removal renderer itself are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .. import ident
from .. import transform as tr
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..raster import brush as rbrush
from ..raster import fills as rfills

OVER = "over"


@dataclass(frozen=True)
class PathShape:
    path: gpath.Path


@dataclass(frozen=True)
class BrushStroke:
    brushstroke: tuple  # (brush, path)


@dataclass(frozen=True)
class Basic:
    fill: rfills.PlainFill
    shape: object  # PathShape | BrushStroke


@dataclass(frozen=True)
class Group:
    objects: tuple  # front-to-back scene


@dataclass(frozen=True)
class Obj:
    idset: ident.IdSet
    geometry: object
    transform: tuple  # tuple of transform ops
    compop: object


def rectangle(x, y, w, h) -> PathShape:
    return PathShape(gshapes.rectangle(x, y, w, h))


def transform_shapekind(f, sk):
    if isinstance(sk, PathShape):
        return PathShape(gpath.transform_path(list(f), sk.path))
    if isinstance(sk, BrushStroke):
        return BrushStroke(rbrush.transform_brushstroke(list(f), sk.brushstroke))
    raise NotImplementedError(f"shape kind {type(sk).__name__} is not ported")


def transform_renderobject_many(ts, o: Obj) -> Obj:
    """Append a transform list outside the object's own (render.ml:219-227)."""
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


def translate_renderobject(dx: int, dy: int, o: Obj) -> Obj:
    """Whole-pixel translation under a fresh idset (render.ml:259-271; the
    render cache alias the JAX package registers has no port yet)."""
    top = tr.Translate(float(dx), float(dy))
    if isinstance(o.geometry, Group):
        return Obj(
            ident.new_ids(),
            Group(tuple(translate_renderobject(dx, dy, x) for x in o.geometry.objects)),
            (),
            o.compop,
        )
    return Obj(ident.new_ids(), o.geometry, tuple(tr.compose(top, list(o.transform))), o.compop)


def bounds_of_basicshape(o: Obj) -> Tuple[int, int, int, int]:
    """Integer (xmin, xmax, ymin, ymax) bounds (render.ml:368-437)."""
    g = o.geometry
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
    if not isinstance(g, Basic):
        raise NotImplementedError(f"geometry {type(g).__name__} is not ported")
    sk = transform_shapekind(o.transform, g.shape)
    if isinstance(sk, BrushStroke):
        return rbrush.bounds_brushstroke(sk.brushstroke)
    return gpath.bounds_polygon(sk.path)
