"""The port's copies of the JAX package's host modules against the
originals, on the same inputs: equal results, bit for bit.

  * ``io.pdf`` + ``io.pdfgraphics``: every PDF in assets/ (the lion is the
    one the port's scenes load) parsed to the same page content and the
    same graphic element tree; text wherever a page holds it painted as the
    JAX package paints it; the modules the port copies whole (the reader
    and writer, the graphics, encryption, the font programs, the decoders
    and ``io.pdfimages``) and the widths table, byte for byte (their
    behaviour is held by tests/test_torch_pdf_{graphics,images,text,
    writer}.py);
  * ``native_lib``: ``bezier_subdivide_batch``, ``edge_spans``,
    ``expand_1x_grouped`` and ``expand_aa_grouped`` on seeded numpy inputs
    (and the batch subdivider against the JAX package's Python
    ``bezier_subdivide``, the reference it transcribes);
  * ``geometry``: circles, rectangles, their edge lists, bounds, transforms
    and spaced points;
  * ``transform``: the compositions the port builds.

Objects of one package never reach the other: each side builds its own
from the same numbers, and the results are compared as arrays or as their
``repr`` (the copied classes keep their names and fields).
"""

import glob
import math
import os
import re

import numpy as np
import pytest

from coherence_tpu import native_lib as j_native
from coherence_tpu.io import pdf as JP
from coherence_tpu.io import pdfgraphics as JPG
from coherence_tpu.raster import tile_raster as JTR
from coherence_tpu.scene import pdfscene as JS

from coherence_tpu_torch import coord as t_coord
from coherence_tpu_torch import native_lib as t_native
from coherence_tpu_torch.io import pdf as TP
from coherence_tpu_torch.io import pdfgraphics as TPG
from coherence_tpu_torch.scene import pdfscene as TS

from _torch_general import JAX as GENERAL_JAX, PORT as GENERAL_PORT, both_sides, same_raster  # noqa: F401
from _torch_hosts import JAX, PORT, ops
from _torch_pdf import canon, scene_sig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "assets", "*.pdf")))


def test_assets_include_the_lion():
    assert "lion.pdf" in ASSETS


@pytest.mark.parametrize("asset", ASSETS)
def test_pdf_asset_parses_equal(asset):
    fname = os.path.join(ROOT, "assets", asset)
    jpdf, tpdf = JP.pdf_of_file(fname), TP.pdf_of_file(fname)
    jpages, tpages = jpdf.pages(), tpdf.pages()
    assert tpages and len(tpages) == len(jpages)
    for jpage, tpage in zip(jpages, tpages):
        assert tpdf.page_content(tpage) == jpdf.page_content(jpage)
        jg, tg = JPG.graphic_of_page(jpdf, jpage), TPG.graphic_of_page(tpdf, tpage)
        assert tg.elements and repr(tg.elements) == repr(jg.elements)


def _text_page(P, where):
    """A page whose only text sits in `where`: the page's content, a form
    XObject, an annotation's appearance stream or a tiling-pattern cell."""
    text = P.Stream({}, b"BT /F1 12 Tf (x) Tj ET")
    page = {"Contents": text, "Resources": {}}
    if where != "content":
        page["Contents"] = P.Stream({}, b"/Fm0 Do" if where == "form" else b"/Pattern cs /T0 scn 0 0 10 10 re f")
    if where == "form":
        page["Resources"] = {"XObject": {"Fm0": P.Stream({"Subtype": P.Name("Form"), "BBox": [0, 0, 9, 9]}, text.raw)}}
    elif where == "tiling cell":
        page["Resources"] = {"Pattern": {"T0": P.Stream({"PatternType": 1, "BBox": [0, 0, 5, 5]}, text.raw)}}
    elif where == "annotation":
        page["Contents"] = P.Stream({}, b"")
        page["Annots"] = [{"Subtype": P.Name("Stamp"), "Rect": [0, 0, 9, 9],
                           "AP": {"N": P.Stream({"BBox": [0, 0, 9, 9]}, text.raw)}}]
    return P.Pdf({1: {"Type": P.Name("Page")}}, {}), page


def _painted(side, P, PG, PS, where):
    """(canon tree, scene signature, np_sprite) of _text_page on a side,
    rendered on the CPU over 1..40 x 1..30."""
    pdf, page = _text_page(P, where)
    g = PG.graphic_of_page(pdf, page)
    scene = PS.scene_of_graphic(pdf, g, "cpu") if side.name == "port" else PS.scene_of_graphic(pdf, g)
    spr = side.render_simple_scene(list(reversed(scene)), side.shape_of_box((1, 1, 40, 30))) if scene else None
    return canon(g.elements), tuple(scene_sig(o) for o in scene), side.np_sprite(spr)


@pytest.mark.parametrize("where,what", [
    ("content", "text"), ("form", "text"), ("annotation", "text"), ("tiling cell", "text"),
])
def test_pdf_content_outside_the_port_raises(where, what, both_sides):
    """Text wherever a page holds it (the page's content, a form, an
    annotation's appearance, a tiling cell), which the port's reader once
    refused, gives the JAX package's element tree, scene and pixels.  (The
    test keeps the name it had while the port refused text.)"""
    a = _painted(GENERAL_JAX, JP, JPG, JS, where)
    b = _painted(GENERAL_PORT, TP, TPG, TS, where)
    assert b[0] == a[0] and b[1] == a[1] and same_raster(a[2], b[2])
    assert "TextBlock" in repr(b[0])


@pytest.mark.parametrize("content", [
    b"q 10 0 0 10 0 0 cm BI /W 1 /H 1 /BPC 8 /CS /G ID \x80 EI Q",
    b"/Sh0 sh",
    b"/P0 scn 0 0 10 10 re f",
])
def test_formerly_refused_content_parses_as_the_jax_package(content):
    """An inline image, a shading and a pattern colour, which the port's
    reader refused before images and graphics were ported, give the JAX
    package's element tree."""
    trees = []
    for P, PG in ((JP, JPG), (TP, TPG)):
        sh = {"ShadingType": 2, "ColorSpace": P.Name("DeviceRGB"), "Coords": [0, 0, 10, 0],
              "Function": {"FunctionType": 2, "Domain": [0, 1], "C0": [1, 0, 0], "C1": [0, 0, 1], "N": 1}}
        pdf = P.Pdf({1: {"Type": P.Name("Page")}}, {})
        page = {"Contents": P.Stream({}, content),
                "Resources": {"Shading": {"Sh0": sh}, "Pattern": {"P0": {"PatternType": 2, "Shading": sh}}}}
        trees.append(repr(PG.graphic_of_page(pdf, page).elements))
    assert trees[0] == trees[1] and trees[1] != "[]"


@pytest.mark.parametrize("name", ["ccitt", "jbig2", "jpeg", "jp2", "pdfimages", "pdf", "pdfgraphics", "pdfcrypt",
                                  "afm", "cff", "cmap", "truetype", "type1"])
def test_whole_copies_match_their_modules(name):
    """The decoders, the image module, the reader and writer, the graphics,
    encryption and the font programs are the JAX package's, whole: past
    the module docstring, which names the module it copies, the port's
    file is the original, character for character, except that two
    docstrings cite the reference's Makefile by name where the original
    gives a path on the machine it was written on."""
    def body(path):
        with open(path) as f:
            src = f.read()
        return src[:src.index('"""', 3)], src[src.index('"""', 3):]

    doc, code = body(os.path.join(ROOT, "coherence_tpu_torch", "io", f"{name}.py"))
    assert f"The port's copy of ``coherence_tpu.io.{name}``, whole." in doc
    original = body(os.path.join(ROOT, "coherence_tpu", "io", f"{name}.py"))[1]
    assert code == re.sub(r"/\S*/reference/Makefile:20", "the reference's Makefile:20", original)


def test_widths_table_is_the_jax_packages():
    """The bundled standard-14 widths table, byte for byte."""
    def read(package):
        with open(os.path.join(ROOT, package, "io", "data", "std14_widths.txt.gz"), "rb") as f:
            return f.read()

    assert read("coherence_tpu_torch") == read("coherence_tpu")


def _circle_ctrl(rng, n):
    """n random cubic beziers, some degenerate (coincident points)."""
    ctrl = rng.uniform(-300.0, 900.0, (n, 8))
    ctrl[::7, 2:4] = ctrl[::7, 0:2]
    ctrl[::11, 4:8] = ctrl[::11, 0:4]
    return ctrl


@pytest.mark.parametrize("eps", [0.2, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bezier_subdivide_batch_matches_jax(seed, eps):
    rng = np.random.default_rng(seed)
    ctrl = _circle_ctrl(rng, 64)
    jchords, jcounts = j_native.bezier_subdivide_batch(ctrl, eps)
    tchords, tcounts = t_native.bezier_subdivide_batch(ctrl, eps)
    assert np.array_equal(tcounts, jcounts)
    assert np.array_equal(tchords, jchords)
    # Against the JAX package's Python subdivision, which both transcribe.
    flat = JAX.gpath.bezier_epsilon(eps)
    want = [c for row in ctrl for c in JAX.gpath.bezier_subdivide(flat, *row.reshape(4, 2).tolist())]
    assert np.array_equal(tchords, np.array([(*a, *b) for a, b in want]))


def _edges(seed):
    """An edge list of random circles and polygons, through each side's
    geometry: (JAX edges, port edges, winding)."""
    rng = np.random.default_rng(seed)
    sides = []
    for h in (JAX, PORT):
        r = np.random.default_rng(seed)
        subpaths = []
        for _ in range(3):
            cx, cy, rad = r.uniform(-50, 600), r.uniform(-50, 330), r.uniform(3, 120)
            subpaths.extend(h.gshapes.circle(cx, cy, rad).subpaths)
            pts = [tuple(p) for p in r.uniform(-80, 600, (int(r.integers(3, 7)), 2)).tolist()]
            ring = pts + pts[:1]
            segs = tuple(h.gpath.Straight(a, b) for a, b in zip(ring, ring[1:]))
            subpaths.append(h.gpath.Subpath(False, True, segs))
        sides.append(h.gpath.edgelist_of_path(h.gpath.Path(h.gpath.NONZERO, tuple(subpaths))))
    return sides[0], sides[1], bool(rng.integers(0, 2))


SPAN_CASES = [(seed, nonzero, ext, clip) for seed in (0, 1, 2) for nonzero in (False, True)
              for ext, clip in ((16, None), (0, None), (16, (1, 256)))]


@pytest.mark.parametrize("seed,nonzero,ext,clip", SPAN_CASES)
def test_edge_spans_matches_jax(seed, nonzero, ext, clip):
    jedges, tedges, _ = _edges(seed)
    assert np.array_equal(tedges, jedges)
    lo, hi = clip if clip is not None else (-(2**62), 2**62)
    want = j_native.edge_spans(jedges, nonzero, ext, lo, hi)
    got = t_native.edge_spans(tedges, nonzero, ext, lo, hi)
    assert want is not None and got is not None
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _grouped_equal(got, want):
    assert sorted(got) == sorted(want)
    for t in want:
        for g, w in zip(got[t], want[t]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_expand_grouped_matches_jax(seed):
    """The 1x tile assignment of coverage and crossing spans, and the 16x
    AA assignment, at the tile raster's own constants."""
    jedges, tedges, nonzero = _edges(seed)
    nty, ntx, th, tw = 4, 4, 64, 128
    rows, cov_s, cov_e, x_rows, x_s, x_e = t_native.edge_spans(tedges, nonzero, 16, 1, nty * th)
    for r, s, e in ((rows, cov_s, cov_e), (x_rows, x_s, x_e)):
        want = j_native.expand_1x_grouped(r, s, e, nty, ntx, th, tw)
        got = t_native.expand_1x_grouped(r, s, e, nty, ntx, th, tw)
        assert want
        _grouped_equal(got, want)
    edge_tiles = np.zeros(nty * ntx, dtype=bool)
    edge_tiles[list(t_native.expand_1x_grouped(rows, cov_s, cov_e, nty, ntx, th, tw))] = True
    hh = JTR._H
    aa = t_native.edge_spans(tedges * hh, nonzero, 0, -hh, nty * hh * th - 1)
    ar, as_, ae = (np.concatenate([aa[0], aa[3]]), np.concatenate([aa[1], aa[4]]), np.concatenate([aa[2], aa[5]]))
    args = (ar, as_, ae, nty, ntx, hh * th, hh * tw, hh, JTR._TTW, edge_tiles)
    want = j_native.expand_aa_grouped(*args)
    assert want
    _grouped_equal(t_native.expand_aa_grouped(*args), want)


def test_native_library_builds_into_build_dir():
    t_native.bezier_subdivide_batch(np.zeros((1, 8)), 0.2)
    assert os.path.dirname(t_native.LIBRARY) == os.path.join(ROOT, "build", "native")
    assert os.path.basename(t_native.LIBRARY).startswith("libcoherence_native-")
    assert os.path.exists(t_native.LIBRARY)


SHAPES = [("circle", (0.0, 0.0, 12.0)), ("circle", (200.5, 120.25, 70.0)), ("circle", (-30.0, 500.0, 0.5)),
          ("rectangle", (11.0, 76.0, 438.0, 176.0)), ("rectangle", (-15.5, -9.0, 200.0, 300.0))]
TRANSFORMS = [
    (),
    (("Translate", 180.0, 60.0),),
    (("Translate", 0.0, 256.0), ("Scale", (0.0, 0.0), 1.0, -1.0), ("Scale", (0.0, 0.0), 0.37, 0.37),
     ("Translate", -17.5, -4.25)),
    (("Translate", 960.0, 540.0), ("Scale", (0.0, 0.0), 2.0, 2.0), ("Translate", -960.0, -540.0)),
    (("Rotate", (3.0, 4.0), math.pi / 3.0), ("Scale", (1.0, 2.0), 0.5, 3.0)),
]


@pytest.mark.parametrize("t", range(len(TRANSFORMS)))
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_geometry_matches_jax(shape, t):
    kind, args = SHAPES[shape]
    got, want = [], []
    for h, out in ((JAX, want), (PORT, got)):
        path = h.gpath.transform_path(list(ops(h, TRANSFORMS[t])), getattr(h.gshapes, kind)(*args))
        out.append(repr(path))
        out.append(h.gpath.edgelist_of_path(path))
        out.append(h.gpath.bounds_polygon(path))
        out.append(h.gpath.points_on_path(3.5, path))
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
    assert got[2:] == want[2:]


@pytest.mark.parametrize("t", range(len(TRANSFORMS)))
def test_transform_matches_jax(t):
    j, p = ops(JAX, TRANSFORMS[t]), ops(PORT, TRANSFORMS[t])
    assert PORT.tr.matrix_of_transform(p) == JAX.tr.matrix_of_transform(j)
    top = ("Translate", 7.0, -3.0)
    assert repr(PORT.tr.compose(ops(PORT, [top])[0], list(p))) == repr(JAX.tr.compose(ops(JAX, [top])[0], list(j)))
    assert repr(PORT.tr.append(list(p), list(p))) == repr(JAX.tr.append(list(j), list(j)))
    for pt in ((0.0, 0.0), (12.5, -7.25), (1919.0, 1079.0)):
        assert PORT.tr.transform(p, pt) == JAX.tr.transform(j, pt)


@pytest.mark.parametrize("f", [0.0, 0.49, 0.5, -0.5, -16.03125, 1079.99, 1e6])
def test_coord_matches_jax(f):
    from coherence_tpu import coord as j_coord

    assert t_coord.pix_of_float(f) == j_coord.pix_of_float(f)
    assert t_coord.sub_of_float(f) == j_coord.sub_of_float(f)
    arr = np.array([f, -f, f * 3.7])
    assert np.array_equal(t_coord.sub_of_float_np(arr), j_coord.sub_of_float_np(arr))


def test_ident_draws_fresh_ids():
    a, b = PORT.ident.new_ids(), PORT.ident.new_ids()
    assert a != b and a[1] == hash(a[0]) and b[0][0] == a[0][0] + 1


@pytest.mark.parametrize("oy,ox", [(0, 0), (-3, 5), (90, 95), (-200, 0), (5, -4), (99, 109)])
def test_native_blit_matches_jax_package(oy, ox):
    """The port's blit takes the sprite as one uint8 plane (r, g, b, mask);
    the JAX package's takes int32 colours and the mask apart."""
    rng = np.random.default_rng(abs(oy) * 31 + abs(ox))
    fb = rng.integers(0, 256, (100, 110, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (20, 30, 4)).astype(np.int32)
    mask = rng.random((20, 30)) < 0.5
    want, got = fb.copy(), fb.copy()
    j_native.blit_masked_rgb(want, rgba, mask, oy, ox)
    t_native.blit_masked_rgb(got, np.concatenate([rgba[..., :3], mask[..., None]], -1).astype(np.uint8), oy, ox)
    assert np.array_equal(got, want)
