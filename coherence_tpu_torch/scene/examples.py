"""Demo scenes (parity: reference ``examples.ml``) and the benchmark
scenes: the bundled lion, the animated blur-filtered lion scene that
``bench.py`` times, the interactive 4K mixed-primitive scene and the dense
layer stack of ``benchmarks/run.py`` (configs 5 and 2)."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import colour as C
from .. import ident
from .. import transform as tr
from ..geometry import shapes as gshapes
from ..io import pdf as P
from ..io import pdfgraphics as PG
from ..raster import brush as rbrush
from ..raster import fills
from . import pdfscene
from . import render as R

# The PDF scene assets shipped beside the JAX package.
path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "assets")


def pdf_graphic_from_file(fname: str):
    """(graphic of the first page, pdf) (examples.ml:33-45)."""
    pdf = P.pdf_of_file(fname)
    pages = pdf.pages()
    if not pages:
        raise ValueError("No pages in PDF file")
    return PG.graphic_of_page(pdf, pages[0]), pdf


def smalllion() -> R.Obj:
    """The lion as one front-to-back Group (examples.ml)."""
    graphic, pdf = pdf_graphic_from_file(os.path.join(path, "lion.pdf"))
    objs = pdfscene.scene_of_graphic(pdf, graphic)
    return R.Obj(ident.new_ids(), R.Group(tuple(reversed(objs))), (), R.OVER)


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
            fills.plain(C.dissolve(C.crimson, delta=170)),
            R.PathShape(gshapes.circle(0.0, 0.0, float(blob_radius))),
        ),
        (tr.Translate(float(blob_at[0]), float(blob_at[1])),),
        R.OVER,
    )
    x0, y0, x1, y1 = f_box
    f_geom = R.Obj(
        ident.new_ids(),
        R.Basic(fills.plain(C.white), R.rectangle(float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1))),
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
        objs.append(R.Obj(ident.new_ids(), R.Basic(fills.plain(col), geom), (), R.OVER))
    for _ in range(n_strokes):
        cx = float(rng.integers(stroke_margin, width - stroke_margin))
        cy = float(rng.integers(stroke_margin, height - stroke_margin))
        pth = gshapes.circle(cx, cy, float(rng.integers(60, 140)))
        objs.append(
            R.Obj(
                ident.new_ids(),
                R.Basic(fills.plain(C.dissolve(C.darkorange, delta=185)),
                        R.BrushStroke((rbrush.mkround(12.0, 0.5), pth))),
                (),
                R.OVER,
            )
        )
    blob = R.Obj(
        ident.new_ids(),
        R.Basic(fills.plain(C.dissolve(C.crimson, delta=170)),
                R.PathShape(gshapes.circle(0.0, 0.0, 70.0))),
        (tr.Translate(400.0, 700.0),),
        R.OVER,
    )
    f_geom = R.Obj(ident.new_ids(), R.Basic(fills.plain(C.white), R.rectangle(200.0, 500.0, 3000.0, 1300.0)), (),
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
