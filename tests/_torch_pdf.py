"""Helpers of the PDF parity tests: a canonical form of a graphic element
tree, a signature of a scene, the per-page results of one page builder on
one side, and ``parity``, which holds the port's results to the JAX
package's.

The two packages' element classes keep their names and fields, but a
``Stream`` has no value ``repr`` and numpy arrays print abridged, so trees
are compared through ``canon``.  Scenes hold objects with ids drawn from
each side's own counter; ``scene_sig`` keeps what an object is (its
geometry, fill and compositing operator, recursively) and not its ids.
"""

import dataclasses

import numpy as np


def canon(o):
    """A nested tuple of class names and values, equal across packages for
    equal trees."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return (type(o).__name__,) + tuple(canon(getattr(o, f.name)) for f in dataclasses.fields(o))
    if type(o).__name__ == "Stream":
        return ("Stream", canon(o.dict), bytes(o.raw))
    if isinstance(o, dict):
        return ("dict",) + tuple((k, canon(v)) for k, v in o.items())
    if isinstance(o, (list, tuple)):
        return (type(o).__name__,) + tuple(canon(v) for v in o)
    if isinstance(o, np.ndarray):
        return ("ndarray", o.dtype.str, o.shape, o.tobytes())
    return repr(o)


def _fill_sig(f):
    name = type(f).__name__
    if name == "PlainFill":
        return (name, f.colour)
    if name == "MaskedFill":
        return (name, _fill_sig(f.base), f.mask.tobytes(), f.matrix)
    if name in ("ImageFill", "TextureFill"):
        return (name, f.tex.tobytes(), f.matrix)
    return (name, repr(vars(f)) if name in ("GradientFill", "RadialFill", "RadialFill2") else "")


def _geometry_sig(g):
    name = type(g).__name__
    if name == "Basic":
        return (name, _fill_sig(g.fill), type(g.shape).__name__)
    if name == "Group":
        return (name, tuple(scene_sig(m) for m in g.objects))
    if name == "FilterG":
        recipe = getattr(g, "recipe", (None, ()))
        return (name, recipe[0], tuple(a for a in recipe[1] if isinstance(a, str)),
                g.filter.filterkind, _geometry_sig(g.filter.geometry))
    return name


def scene_sig(o):
    """What a scene object is, without its ids: its geometry (fills,
    shapes, group members and filters, recursively), the number of its
    transforms and its compositing operator."""
    return _geometry_sig(o.geometry), len(o.transform), repr(o.compop)


def page_results(side, P, PG, PS, build):
    """[(canon tree, scene signature, np_sprite)] for each page of
    build(P) (a Pdf, or bytes that P reads), rendered on the CPU over the
    page's MediaBox at one pixel per unit."""
    obj = build(P)
    pdf = P.pdf_of_bytes(obj) if isinstance(obj, bytes) else obj
    out = []
    for page in pdf.pages():
        g = PG.graphic_of_page(pdf, page)
        scene = PS.scene_of_graphic(pdf, g, "cpu") if side.name == "port" else PS.scene_of_graphic(pdf, g)
        mb = [float(pdf.resolve(v)) for v in pdf.resolve(page.get("MediaBox", [0, 0, 100, 100]))]
        box = (1, 1, max(1, int(mb[2] - mb[0])), max(1, int(mb[3] - mb[1])))
        spr = side.render_simple_scene(list(reversed(scene)), side.shape_of_box(box)) if scene else None
        out.append((canon(g.elements), tuple(scene_sig(o) for o in scene), side.np_sprite(spr)))
    return out


def parity(build):
    """Both sides' results for every page of build(P); asserts they are
    equal (tree, scene and render, tolerance 0) and returns the port's."""
    from coherence_tpu.io import pdf as JP
    from coherence_tpu.io import pdfgraphics as JPG
    from coherence_tpu.scene import pdfscene as JS
    from coherence_tpu_torch.io import pdf as TP
    from coherence_tpu_torch.io import pdfgraphics as TPG
    from coherence_tpu_torch.scene import pdfscene as TS

    from _torch_general import JAX, PORT, describe, same_raster

    a, b = page_results(JAX, JP, JPG, JS, build), page_results(PORT, TP, TPG, TS, build)
    assert len(a) == len(b) and a
    for i, (pa, pb) in enumerate(zip(a, b)):
        assert pb[0] == pa[0], f"page {i}: graphic trees differ"
        assert pb[1] == pa[1], f"page {i}: scenes differ"
        assert same_raster(pa[2], pb[2]), f"page {i}: {describe(pa[2], pb[2])}"
    return b
