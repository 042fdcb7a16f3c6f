"""PDF graphic -> scene conversion (parity: render.ml:1476-1565).

The subset of ``coherence_tpu.scene.pdfscene`` that the port supports:
filled and stroked (also dashed) paths painted in a plain device colour
(RGB, CMYK or gray), inside marked-content sections and under clip paths
(a clip that cuts the geometry becomes a CPG intersection, which only the
general renderer draws, not the tile route).  Anything else (soft masks,
blend modes, images, shadings, patterns, text) raises
``NotImplementedError``."""

from __future__ import annotations

from .. import colour as C
from .. import ident
from ..geometry import dash as gdash
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..io import pdfgraphics as PG
from ..raster import fills as rfills
from . import render as R


def _path_bbox(p):
    """Conservative float bbox over all control points, or None."""
    xs, ys = [], []
    for sp in p.subpaths:
        for seg in sp.segments:
            pts = (seg.a, seg.b) if isinstance(seg, gpath.Straight) else (seg.p1, seg.p2, seg.p3, seg.p4)
            for x, y in pts:
                xs.append(x)
                ys.append(y)
    if not xs:
        return None
    return min(xs), min(ys), max(xs), max(ys)


def _rect_of_path(p):
    """(x0, y0, x1, y1) when the path is one closed axis-aligned rectangle."""
    if len(p.subpaths) != 1:
        return None
    segs = list(p.subpaths[0].segments)
    if len(segs) < 3 or not all(isinstance(s, gpath.Straight) for s in segs):
        return None
    for a, b in zip(segs, segs[1:]):
        if a.b != b.a:
            return None
    if segs[-1].b != segs[0].a:
        return None
    xs, ys = set(), set()
    for s in segs:
        if s.a[0] != s.b[0] and s.a[1] != s.b[1]:
            return None
        xs.update((s.a[0], s.b[0]))
        ys.update((s.a[1], s.b[1]))
    if len(xs) != 2 or len(ys) != 2:
        return None
    (x0, x1), (y0, y1) = sorted(xs), sorted(ys)
    return x0, y0, x1, y1


def clipped_shape(shape, clips, painted_bbox):
    """Intersect a basicshape with the active clip stack via CPG geometry
    (BEYOND REFERENCE: the reference's scene_of_graphic discards Clip paths,
    render.ml:1558-1560).  Rectangular clips that already contain the
    painted geometry's conservative bbox are skipped, so the ubiquitous
    page-box ``re W n`` clip costs nothing."""
    for cp in clips:
        r = _rect_of_path(cp)
        if r is not None and painted_bbox is not None:
            if (
                r[0] <= painted_bbox[0]
                and r[1] <= painted_bbox[1]
                and painted_bbox[2] <= r[2]
                and painted_bbox[3] <= r[3]
            ):
                continue
        shape = R.CPG(R.INTERSECTION, shape, R.PathShape(cp))
    return shape


def rgb_of_cmyk(c, m, y, k):
    return (
        1.0 - min(1.0, c * (1.0 - k) + k),
        1.0 - min(1.0, m * (1.0 - k) + k),
        1.0 - min(1.0, y * (1.0 - k) + k),
    )


def fill_of_pdf_colour(vals, transparency: float, colourspace: str) -> rfills.PlainFill:
    if colourspace == PG.DEVICE_RGB and len(vals) == 3:
        r, g, b = vals
    elif colourspace == PG.DEVICE_CMYK and len(vals) == 4:
        r, g, b = rgb_of_cmyk(*vals)
    elif colourspace == PG.DEVICE_GRAY and len(vals) == 1:
        r = g = b = vals[0]
    else:
        raise NotImplementedError(f"fill colour {vals!r} in {colourspace!r}")
    t = int(transparency * 255.0)
    return rfills.plain(C.dissolve(C.colour_of_rgba_float(r, g, b, 1.0), delta=t))


def cap_of_pdfcap(c: int) -> str:
    return {0: gshapes.ButtCap, 1: gshapes.RoundCap, 2: gshapes.ProjectingCap}[c]


def join_of_pdfjoin(j: int) -> str:
    return {0: gshapes.MitredJoin, 1: gshapes.RoundJoin, 2: gshapes.BevelJoin}[j]


def scene_of_graphic(pdf, graphic: PG.Graphic):
    """Scene from a graphic's elements in element order (render.ml:1524-1565);
    callers reverse for front-to-back stacking."""

    def convert(elements, clips=()):
        out = []
        for el in elements:
            if isinstance(el, PG.GPath):
                a = el.attributes
                if a.path_softmask is not None:
                    raise NotImplementedError("soft masks")
                if getattr(a, "path_blend", "Normal") not in (None, "Normal", "Compatible"):
                    raise NotImplementedError(f"blend mode {a.path_blend}")
                if a.path_line is not None:
                    cs, vals = a.path_line
                    fill = fill_of_pdf_colour(vals, a.path_transparency.line_transparency, cs)
                    stroke_path = el.path
                    if a.path_dash[0]:
                        # Dash before stroking, so that each dash gets caps.
                        stroke_path = gdash.dash_path(el.path, a.path_dash[0], a.path_dash[1])
                    spec = gshapes.StrokeSpec(
                        startcap=cap_of_pdfcap(a.path_capstyle),
                        join=join_of_pdfjoin(a.path_joinstyle),
                        endcap=cap_of_pdfcap(a.path_capstyle),
                        mitrelimit=a.path_mitrelimit,
                        linewidth=a.path_linewidth,
                    )
                    pb = _path_bbox(stroke_path)
                    if pb is not None:
                        # Mitre spikes reach mitrelimit*w/2 past a vertex and
                        # caps w*sqrt(2)/2: expand conservatively.
                        e = a.path_linewidth * max(1.0, a.path_mitrelimit)
                        pb = (pb[0] - e, pb[1] - e, pb[2] + e, pb[3] + e)
                    shape = clipped_shape(R.StrokedPathShape(stroke_path, spec), clips, pb)
                    out.append(R.Obj(ident.new_ids(), R.Basic(fill, shape), (), R.OVER))
                if a.path_fill is not None:
                    cs, vals = a.path_fill  # pattern colours raise in the PDF reader
                    fill = fill_of_pdf_colour(vals, a.path_transparency.fill_transparency, cs)
                    shape = clipped_shape(R.PathShape(el.path), clips, _path_bbox(el.path))
                    out.append(R.Obj(ident.new_ids(), R.Basic(fill, shape), (), R.OVER))
            elif isinstance(el, PG.Clip):
                out.extend(convert(el.elements, clips + (el.path,)))
            elif isinstance(el, (PG.MCSection, PG.MCSectionProperties)):
                out.extend(convert(el.elements, clips))
            else:
                raise NotImplementedError(f"graphic element {type(el).__name__}")
        return out

    return convert(graphic.elements)
