"""Demo scenes (parity: reference ``examples.ml``) and the benchmark
scenes.

The PyTorch counterpart of ``coherence_tpu.scene.examples``, whole: the
bundled PDF scene assets (lion, q, logo, brushcurve, the text and filter
demos, which hold outlines only) and the same demo objects: the
gradient-filled CPG xor, the affine/blur/rgb/mono/minus/wireframe/smear
filter objects, brush strokes, stroked curves and the radial fill.  Beside
them, the benchmark scenes: the animated blur-filtered lion scene that
``bench.py`` times, the interactive 4K mixed-primitive scene and the dense
layer stack of ``benchmarks/run.py`` (configs 5 and 2)."""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch

from .. import colour as C
from .. import ident
from .. import transform as tr
from ..geometry import shapes as gshapes
from ..io import pdf as P
from ..io import pdfgraphics as PG
from ..raster import brush as rbrush
from ..raster import convolve as rconvolve
from ..raster import fills as rfills
from . import filters as F
from . import pdfscene
from . import render as R

# Directory holding the PDF scene assets (examples.ml:5 `path`).
path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "assets")


root2 = math.sqrt(2.0)

circlezero = R.PathShape(gshapes.circle(0.0, 0.0, 100.0))
circleone = R.PathShape(gshapes.circle(100.0, 100.0, 100.0))
circletwo = R.PathShape(gshapes.circle(200.0, 100.0, 90.0))


def object_of_geometry(g) -> R.Obj:
    return R.Obj(ident.new_ids(), g, (), R.OVER)


def object_of_geometry_compop(c, g) -> R.Obj:
    return R.Obj(ident.new_ids(), g, (), c)


def path_of_graphic(graphic: PG.Graphic):
    """First path in a graphic (examples.ml:23-30)."""

    def find(elements):
        for el in elements:
            if isinstance(el, PG.GPath):
                return el.path
            if isinstance(el, (PG.MCSection, PG.MCSectionProperties, PG.Clip)):
                got = find(el.elements)
                if got is not None:
                    return got
        return None

    p = find(graphic.elements)
    if p is None:
        raise ValueError("no path in graphic")
    return p


@lru_cache(maxsize=None)
def pdf_graphic_from_file(fname: str, page_index: int = 0):
    """Memoized PDF page loader (examples.ml:33-45); `page_index` selects
    the page (BEYOND REFERENCE: the reference always takes page 1)."""
    pdf = P.pdf_of_file(fname)
    pages = pdf.pages()
    if not pages:
        raise ValueError("No pages in PDF file")
    idx = max(0, min(len(pages) - 1, int(page_index)))
    return PG.graphic_of_page(pdf, pages[idx]), pdf


def pdf_pathsinfile(fname: str):
    graphic, _ = pdf_graphic_from_file(os.path.join(path, fname))
    return path_of_graphic(graphic)



# --- common objects (examples.ml:52-57) --------------------------------------


def redblob() -> R.Obj:
    return object_of_geometry_compop(
        R.PreTrans(1.0, R.OVER), R.Basic(rfills.plain(C.red), circleone)
    )


def blueblob() -> R.Obj:
    return object_of_geometry(R.Basic(rfills.plain(C.blue), circleone))


# --- filter demo objects (examples.ml:59-128) --------------------------------


def cpg_example() -> R.Obj:
    fill = rfills.gradient(
        (60.0, 100.0),
        (220.0, 150.0),
        True,
        True,
        C.dissolve(C.cornflowerblue, delta=128),
        C.yellow,
    )
    return object_of_geometry(R.Basic(fill, R.CPG(R.EXCLUSIVE_OR, circleone, circletwo)))


def affinefilter() -> R.Obj:
    fill = rfills.gradient(
        (200.0, 250.0), (200.0, 270.0), True, True, C.white, C.dissolve(C.white, delta=0)
    )
    return object_of_geometry(
        F.affine(
            [tr.Scale((200.0, 250.0), 1.0, -0.5), tr.ShearX((200.0, 250.0), -0.3)],
            R.Basic(fill, R.rectangle(200.0, 200.0, 600.0, 100.0)),
        )
    )


def blurfilter() -> R.Obj:
    return object_of_geometry(
        F.blur(
            R.Basic(rfills.plain(C.white), R.PathShape(gshapes.circle(100.0, 150.0, 40.0))),
            rconvolve.mkgaussian(5),
        )
    )


def rgbfilter() -> R.Obj:
    return object_of_geometry(
        F.rgb(
            R.Basic(rfills.plain(C.white), R.PathShape(gshapes.circle(0.0, 0.0, 40.0))),
            (
                lambda c: [tr.Translate(10.0, 10.0)],
                lambda c: [tr.Translate(-10.0, 0.0)],
                lambda c: [tr.Translate(0.0, 0.0)],
            ),
            R.FILTER_PLAIN,
        )
    )


# --- five objects (examples.ml:91-128) ---------------------------------------


def brush() -> R.Obj:
    pth = pdf_pathsinfile("brushcurve.pdf")
    return object_of_geometry(
        R.Basic(
            rfills.plain(C.dissolve(C.darkorange, delta=185)),
            R.BrushStroke((rbrush.mkround(15.0, 0.5), pth)),
        )
    )


def brushcircle() -> R.Obj:
    b = brush()
    bs = b.geometry.shape.brushstroke
    moved = rbrush.transform_brushstroke([tr.Translate(-115.0, -690.0)], bs)
    return object_of_geometry(
        R.Basic(rfills.plain(C.purple), R.CPG(R.EXCLUSIVE_OR, R.BrushStroke(moved), circlezero))
    )


def brushblue() -> R.Obj:
    pth = pdf_pathsinfile("brushcurve.pdf")
    return object_of_geometry(
        R.Basic(
            rfills.plain(C.dissolve(C.blue, delta=185)),
            R.BrushStroke((rbrush.mkround(15.0, 0.5), pth)),
        )
    )


def minusfilter() -> R.Obj:
    return object_of_geometry(
        F.minus(R.Basic(rfills.plain(C.white), R.PathShape(gshapes.circle(100.0, 150.0, 40.0))))
    )


def monofilter() -> R.Obj:
    return object_of_geometry(
        F.monochrome(
            R.Basic(rfills.plain(C.white), R.PathShape(gshapes.circle(100.0, 150.0, 40.0)))
        )
    )


def q_shape() -> R.Obj:
    return R.mkpoly(pdf_pathsinfile("q.pdf"), rfills.plain(C.darkgreen), (), R.OVER)


def q_shape_2() -> R.Obj:
    return R.mkpoly(
        pdf_pathsinfile("q.pdf"),
        rfills.plain(C.dissolve(C.cornflowerblue, delta=200)),
        (),
        R.OVER,
    )


def logo() -> R.Obj:
    return R.mkpoly(
        pdf_pathsinfile("logo.pdf"), rfills.plain(C.dissolve(C.darkred, delta=255)), (), R.OVER
    )


def swaptoptwo(objs) -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (200.0, 200.0),
        object_of_geometry(
            F.swapdepth(
                R.idset_in(objs[0]),
                R.idset_in(objs[1]),
                R.Basic(rfills.plain(C.white), R.rectangle(100.0, 100.0, 200.0, 200.0)),
            )
        ),
    )


def load_text(name: str) -> R.Obj:
    graphic, pdf = pdf_graphic_from_file(os.path.join(path, name))
    objs = pdfscene.scene_of_graphic(pdf, graphic)
    if not objs:
        raise ValueError("renderobjects_of_graphic produced no content")
    return R.Obj(ident.new_ids(), R.Group(tuple(reversed(objs))), (), R.OVER)


def aatext():
    return load_text("aatext.pdf")


def mintext1():
    return load_text("mintext1.pdf")


def mintext2():
    return load_text("mintext2.pdf")


def filtertext1():
    return load_text("filtertext1.pdf")


def filtertext2():
    return load_text("filtertext2.pdf")


def lionfilter1():
    return load_text("lionfilter1.pdf")


def lionfilter2():
    return load_text("lionfilter2.pdf")


def smalllion() -> R.Obj:
    """The lion as one front-to-back Group (examples.ml)."""
    graphic, pdf = pdf_graphic_from_file(os.path.join(path, "lion.pdf"))
    objs = pdfscene.scene_of_graphic(pdf, graphic)
    return R.Obj(ident.new_ids(), R.Group(tuple(reversed(objs))), (), R.OVER)


def radial_filled() -> R.Obj:
    fill = rfills.radial(
        (60.0, 100.0), (60.0, 100.0), (200.0, 150.0), True, True,
        C.lightsteelblue, C.darkslateblue,
    )
    return R.position_anchor(
        R.Centre, (500.0, 200.0), R.Obj(ident.new_ids(), R.Basic(fill, circleone), (), R.OVER)
    )


def wirecircle() -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (250.0, 250.0),
        object_of_geometry(
            R.Basic(
                rfills.plain(C.black),
                R.StrokedPathShape(
                    gshapes.circle(100.0, 100.0, 100.0),
                    gshapes.StrokeSpec(
                        startcap=gshapes.ButtCap,
                        endcap=gshapes.ButtCap,
                        join=gshapes.RoundJoin,
                        mitrelimit=5.0,
                        linewidth=1.0,
                    ),
                ),
            )
        ),
    )


def hole() -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (250.0, 300.0),
        object_of_geometry(
            F.hole(R.Basic(rfills.plain(C.white), R.rectangle(200.0, 200.0, 100.0, 100.0)))
        ),
    )


def wireframe() -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (200.0, 200.0),
        object_of_geometry(
            F.wireframe(
                R.Basic(rfills.plain(C.white), R.PathShape(gshapes.circle(0.0, 0.0, 40.0))),
                gshapes.StrokeSpec(
                    startcap=gshapes.ButtCap,
                    join=gshapes.BevelJoin,
                    endcap=gshapes.ButtCap,
                    linewidth=0.5,
                    mitrelimit=root2,
                ),
                rfills.plain(C.dissolve(C.black, delta=200)),
            )
        ),
    )


def _curve_spec(linewidth: float) -> gshapes.StrokeSpec:
    return gshapes.StrokeSpec(
        startcap=gshapes.RoundCap,
        join=gshapes.RoundJoin,
        endcap=gshapes.RoundCap,
        linewidth=linewidth,
        mitrelimit=root2,
    )


def p6_curve() -> R.Obj:
    pth = pdf_pathsinfile("brushcurve.pdf")
    return R.position_anchor(
        R.Centre,
        (300.0, 300.0),
        object_of_geometry(
            R.Basic(
                rfills.plain(C.dissolve(C.slateblue, delta=255)),
                R.StrokedPathShape(pth, _curve_spec(2.0)),
            )
        ),
    )


def p6_curve2() -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (310.0, 310.0),
        object_of_geometry(
            R.Basic(
                rfills.plain(C.dissolve(C.slateblue, delta=128)),
                R.StrokedPathShape(pdf_pathsinfile("brushcurve.pdf"), _curve_spec(4.0)),
            )
        ),
    )


def p6_curve3() -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (320.0, 320.0),
        object_of_geometry(
            R.Basic(
                rfills.plain(C.dissolve(C.slateblue, delta=192)),
                R.StrokedPathShape(pdf_pathsinfile("brushcurve.pdf"), _curve_spec(4.0)),
            )
        ),
    )


def curves() -> R.Obj:
    return R.position_anchor(
        R.Centre, (120.0, 300.0), R.mkgroup([p6_curve(), p6_curve2(), p6_curve3()])
    )


def smear() -> R.Obj:
    pth = pdf_pathsinfile("brushcurve.pdf")
    return R.position_anchor(
        R.Centre,
        (250.0, 350.0),
        R.Obj(ident.new_ids(), F.smear((rbrush.mkround(15.0, 1.0), pth)), (), R.OVER),
    )


def wirebrush() -> R.Obj:
    pth = pdf_pathsinfile("brushcurve.pdf")
    return R.position_anchor(
        R.Centre,
        (250.0, 350.0),
        R.Obj(
            ident.new_ids(),
            F.wireframe(
                R.Basic(
                    rfills.plain(C.white), R.BrushStroke((rbrush.mkround(15.0, 1.0), pth))
                ),
                gshapes.StrokeSpec(
                    startcap=gshapes.ButtCap,
                    join=gshapes.BevelJoin,
                    endcap=gshapes.ButtCap,
                    linewidth=0.5,
                    mitrelimit=root2,
                ),
                rfills.plain(C.black),
            ),
            (),
            R.OVER,
        ),
    )


def monobrush() -> R.Obj:
    pth = pdf_pathsinfile("brushcurve.pdf")
    return R.position_anchor(
        R.Centre,
        (250.0, 350.0),
        R.Obj(
            ident.new_ids(),
            F.monochrome(
                R.Basic(
                    rfills.plain(C.white), R.BrushStroke((rbrush.mkround(15.0, 1.0), pth))
                )
            ),
            (),
            R.OVER,
        ),
    )


def curve() -> R.Obj:
    return R.position_anchor(
        R.Centre,
        (500.0, 200.0),
        R.Obj(
            ident.new_ids(),
            R.Basic(
                rfills.plain(C.gold),
                R.BrushStroke((rbrush.mkround(20.0, 0.6), pdf_pathsinfile("brushcurve.pdf"))),
            ),
            (),
            R.OVER,
        ),
    )


def bench_scene(width: int, height: int, *, blob_radius: float, blob_at, f_box):
    """The scene ``bench.py`` builds, at `width` x `height`: (the lion's
    objects front to back, scaled to fit the frame and flipped upright;
    a translucent crimson blob (dissolve 170) of radius `blob_radius`
    centred at `blob_at`; the blur filter's geometry, a white rectangle
    over the 1-based inclusive pixel box `f_box`)."""
    lion = smalllion()
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(lion)
    scale = min(width / (xmax - xmin), height / (ymax - ymin))
    lion = R.transform_renderobject_many(
        [
            tr.Translate(0.0, float(height)),
            tr.Scale((0.0, 0.0), 1.0, -1.0),
            tr.Scale((0.0, 0.0), scale, scale),
            tr.Translate(-xmin, -ymin),
        ],
        lion,
    )
    blob = R.Obj(
        ident.new_ids(),
        R.Basic(
            rfills.plain(C.dissolve(C.crimson, delta=170)),
            R.PathShape(gshapes.circle(0.0, 0.0, float(blob_radius))),
        ),
        (tr.Translate(float(blob_at[0]), float(blob_at[1])),),
        R.OVER,
    )
    x0, y0, x1, y1 = f_box
    f_geom = R.Obj(
        ident.new_ids(),
        R.Basic(rfills.plain(C.white), R.rectangle(float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1))),
        (),
        R.OVER,
    )
    return list(lion.geometry.objects), blob, f_geom


def interactive_4k_scene(width: int, height: int, seed: int = 0):
    """The interactive scene of ``benchmarks/run.py`` config 5 (3840x2160
    there), built draw for draw in run.py's order from
    ``numpy.random.default_rng(seed)``.  Returns (objects front to back,
    blob, filter geometry):

      * 1000 primitives: per object cx, cy, three colour draws, then r in
        [6, 30) for a circle (even k) or w, h in [8, 56) for a rectangle
        (odd k); alpha 150 where k % 3 == 0, else 255;
      * 6 strokes: a round Gaussian brush mkround(12.0, 0.5) along a circle
        of r in [60, 140) whose centre keeps 300 pixels from the frame's
        edges, filled with darkorange dissolved to 185;
      * the animated blob: crimson dissolved to 170, radius 70, at
        Translate(400, 700);
      * the blur filter's geometry: a white rectangle (x, y, w, h) =
        (200, 500, 3000, 1300)."""
    n_objects, n_strokes, stroke_margin = 1000, 6, 300
    rng = np.random.default_rng(seed)

    def rand_colour(k):
        alpha = 255 if k % 3 else 150
        return C.dissolve(C.colour_of_rgba(*(int(v) for v in rng.integers(0, 256, 3)), 255), delta=alpha)

    objs = []
    for k in range(n_objects):
        cx = float(rng.integers(60, width - 60))
        cy = float(rng.integers(60, height - 60))
        col = rand_colour(k)
        if k % 2 == 0:
            geom = R.PathShape(gshapes.circle(cx, cy, float(rng.integers(6, 30))))
        else:
            geom = R.rectangle(cx, cy, float(rng.integers(8, 56)), float(rng.integers(8, 56)))
        objs.append(R.Obj(ident.new_ids(), R.Basic(rfills.plain(col), geom), (), R.OVER))
    for _ in range(n_strokes):
        cx = float(rng.integers(stroke_margin, width - stroke_margin))
        cy = float(rng.integers(stroke_margin, height - stroke_margin))
        pth = gshapes.circle(cx, cy, float(rng.integers(60, 140)))
        objs.append(
            R.Obj(
                ident.new_ids(),
                R.Basic(rfills.plain(C.dissolve(C.darkorange, delta=185)),
                        R.BrushStroke((rbrush.mkround(12.0, 0.5), pth))),
                (),
                R.OVER,
            )
        )
    blob = R.Obj(
        ident.new_ids(),
        R.Basic(rfills.plain(C.dissolve(C.crimson, delta=170)),
                R.PathShape(gshapes.circle(0.0, 0.0, 70.0))),
        (tr.Translate(400.0, 700.0),),
        R.OVER,
    )
    f_geom = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.white), R.rectangle(200.0, 500.0, 3000.0, 1300.0)), (),
                   R.OVER)
    return objs, blob, f_geom


# benchmarks/run.py config 2 draws its rectangles for a 1920x1088 frame.
_HSR_W, _HSR_H = 1920, 1088


def hsr_rects(k: int, height: int, width: int, seed: int = 0):
    """The rectangles of ``benchmarks/run.py`` config 2's layer stack, in
    its draw order from ``numpy.random.default_rng(seed)``: per layer
    (x0, y0, w, h, (r, g, b), a), with a = 255 on even layers and 128 on
    odd ones and the colour premultiplied.  run.py's bounds (x0 in [0,
    W - 600), y0 in [0, H - 500), w in [150, 600), h in [150, 500)) are for
    1920x1088; at another size they scale with the frame, so that at
    1920x1088 the draws are run.py's exactly."""
    rng = np.random.default_rng(seed)

    def sx(v):
        return v * width // _HSR_W

    def sy(v):
        return v * height // _HSR_H

    out = []
    for j in range(k):
        x0, y0 = int(rng.integers(0, width - sx(600))), int(rng.integers(0, height - sy(500)))
        w, h = int(rng.integers(sx(150), sx(600))), int(rng.integers(sy(150), sy(500)))
        a = 255 if j % 2 == 0 else 128
        col = tuple(int(v) for v in (rng.integers(0, 256, 3) * a) // 255)
        out.append((x0, y0, w, h, col, a))
    return out


def hsr_layers(k: int, height: int, width: int, seed: int = 0, *, device) -> torch.Tensor:
    """Config 2's stack as a packed (k, height, width) int32 tensor on
    `device`, layer 0 topmost: each layer is zero but for its rectangle,
    filled on the device (a host (k, H, W, 4) array would take 3.3 GB at
    full size)."""
    layers = torch.zeros((k, height, width), dtype=torch.int32, device=device)
    for j, (x0, y0, w, h, (r, g, b), a) in enumerate(hsr_rects(k, height, width, seed)):
        word = r | (g << 8) | (b << 16) | (a << 24)
        layers[j, y0 : y0 + h, x0 : x0 + w] = word - (1 << 32) if word >= 1 << 31 else word
    return layers
