"""Toolbar icon rendering (parity: reference ``icons.ml``).

The port's counterpart of ``coherence_tpu.scene.icons``: a PDF's first page
rendered through the general renderer into a 32x32 canvas on `device`."""

from __future__ import annotations

from .. import colour as C
from .. import ident
from .. import transform as tr
from ..raster import region
from . import render as R


def view_from_scene(scene, device) -> R.View:
    return R.View(
        device=device,
        scene=scene,
        pages=[],
        window=None,
        background=[R.primobj(C.clear, R.RectanglePrim(1.0, 1.0, 32.0, 32.0))],
        selections=R.null_selection,
        master_update=region.shape_of_box((1, 1, 32, 32), device),
        rubberband=None,
        tool="select",
    )


def fit_icon_scene(scene):
    """Scale a PDF-derived scene into a 32x32 icon (icons.ml:17-24)."""
    scaled = [
        R.transform_renderobject(tr.Scale((0.0, 0.0), 0.1, -0.1), o) for o in scene
    ]
    return [R.position_anchor(R.Centre, (16.0, 16.0), o) for o in scaled]


def render_icon(scene, device):
    """Render a 32x32 icon canvas, flattened onto white (icons.ml:26-28)."""
    rendered = R.render_frame(
        ident.new_ids(),
        view_from_scene(scene, device),
        region.shape_of_box((1, 1, 32, 32), device),
    )
    if rendered is None:
        return region.newcanvasclear(32, 32, device)
    return region.flatten_sprite(0, rendered, C.white)


def icon_of_pdf(fname: str, device):
    """Load a PDF and render its first page as an icon (engine.ml:145-162)."""
    from ..io import pdf as P
    from ..io import pdfgraphics as PG
    from . import pdfscene

    pdf = P.pdf_of_file(fname)
    pages = pdf.pages()
    if not pages:
        raise ValueError("Icon file has no pages")
    graphic = PG.graphic_of_page(pdf, pages[0])
    objs = pdfscene.scene_of_graphic(pdf, graphic, device)
    scene = [R.mkgroup(objs)]
    return render_icon(fit_icon_scene(scene), device)
