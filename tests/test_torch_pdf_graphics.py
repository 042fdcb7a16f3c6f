"""The port's PDF graphics (``io.pdfgraphics``, ``scene.pdfscene``)
against the JAX package's, page by page: the same graphic element tree
(canonical repr), the same scene in element order, and the same CPU render
of the page (box, mask and colours; tolerance 0).

Each fixture builds its pages from the same numbers with a side's own
``mkpage``, ``Name``, ``Stream`` and ``Ref`` (the modern-file fixture is
written by each side's own writer, and chip_smoke.py's three-page document
too).  One fixture family per JAX test module of the PDF graphics stack:
colour spaces, soft masks, mesh shadings, axial/radial/function shadings,
tiling and shading patterns, transparency groups, optional content,
annotations, element kinds, clips, xref streams, rotated and multi-page
documents, blend modes and corrupted files; then the fallbacks for
malformed input, among them a mask group whose conversion fails, text in a
mask group, and the one divergence kept on purpose: a failed sub-render
(soft mask, tiling cell, Type 3 glyph) is raised, not hidden.
"""

import os
import sys
import zlib

import numpy as np
import pytest

from coherence_tpu.io import pdf as JP
from coherence_tpu.io import pdfgraphics as JPG
from coherence_tpu.scene import pdfscene as JS

from coherence_tpu_torch.io import pdf as TP
from coherence_tpu_torch.io import pdfgraphics as TPG
from coherence_tpu_torch.io.truetype import fallback_font_path
from coherence_tpu_torch.raster import region as t_region
from coherence_tpu_torch.scene import pdfscene as TS

from _torch_general import JAX, PORT, both_sides, describe, same_raster  # noqa: F401
from _torch_pdf import page_results, parity
from _torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BOX = (0, 0, 100, 100)
TS_FALLBACK_FACE = fallback_font_path("Helvetica")


def _form(P, content, group=None, bbox=(0, 0, 100, 100), **extra):
    d = {"Type": P.Name("XObject"), "Subtype": P.Name("Form"), "BBox": list(bbox), "Resources": {}}
    if group is not None:
        d["Group"] = {"Type": P.Name("Group"), "S": P.Name(group)}
    d.update(extra)
    return P.Stream(d, content)


def _fn2(c0, c1, n=1.0):
    return {"FunctionType": 2, "Domain": [0, 1], "C0": list(c0), "C1": list(c1), "N": n}


def _fn4(P, program: bytes, domain, rng):
    return P.Stream({"FunctionType": 4, "Domain": list(domain), "Range": list(rng)}, program)


def _pack(fields) -> bytes:
    """(value, bits) pairs packed MSB first, padded to a byte."""
    acc, n = 0, 0
    for v, bits in fields:
        acc = (acc << bits) | (int(v) & ((1 << bits) - 1))
        n += bits
    pad = (-n) % 8
    return (acc << pad).to_bytes((n + pad) // 8, "big")


def _xy(x, y):
    return [(round(x / 120.0 * 65535), 16), (round(y / 120.0 * 65535), 16)]


def _rgb8(r, g, b):
    return [(round(r * 255), 8), (round(g * 255), 8), (round(b * 255), 8)]


def _mesh(P, st, data, **extra):
    d = {"ShadingType": st, "ColorSpace": P.Name("DeviceRGB"), "BitsPerCoordinate": 16,
         "BitsPerComponent": 8, "Decode": [0, 120, 0, 120, 0, 1, 0, 1, 0, 1]}
    if st != 5:
        d["BitsPerFlag"] = 8
    d.update(extra)
    return P.Stream(d, data)


def _coons(ax, ay, w, bulge=6.0):
    """12 boundary points of a Coons patch over the square at (ax, ay)."""
    return [(ax, ay), (ax - bulge, ay + w / 3), (ax + bulge, ay + 2 * w / 3), (ax, ay + w),
            (ax + w / 3, ay + w + bulge), (ax + 2 * w / 3, ay + w - bulge), (ax + w, ay + w),
            (ax + w + bulge, ay + 2 * w / 3), (ax + w - bulge, ay + w / 3), (ax + w, ay),
            (ax + 2 * w / 3, ay + bulge), (ax + w / 3, ay - bulge)]


# --- the fixture families ----------------------------------------------------


def colourspaces(P):
    N = P.Name
    lut = bytes([255, 0, 0, 0, 128, 0, 20, 40, 250])
    cs = {
        "Ix": [N("Indexed"), N("DeviceRGB"), 2, lut],
        "Sep": [N("Separation"), N("Spot"), N("DeviceCMYK"), _fn2((0, 0, 0, 0), (0.1, 0.7, 0.2, 0.05))],
        "DN": [N("DeviceN"), [N("A"), N("B")], N("DeviceRGB"),
               _fn4(P, b"{ 2 copy add 2 div 3 1 roll exch }", (0, 1, 0, 1), (0, 1, 0, 1, 0, 1))],
        "Lab": [N("Lab"), {"WhitePoint": [0.9505, 1.0, 1.089], "Range": [-100, 100, -100, 100]}],
        "ICC": [N("ICCBased"), P.Stream({"N": 3}, b"")],
        "Cal": [N("CalRGB"), {"WhitePoint": [0.9505, 1.0, 1.089]}],
        "Gray": N("DeviceGray"),
    }
    content = (b"/Ix cs 1 scn 2 2 20 20 re f /Ix CS 2 SCN 4 w 30 10 m 60 10 l S "
               b"/Sep cs 0.6 scn 24 2 20 20 re f /DN cs 0.25 0.75 scn 46 2 20 20 re f "
               b"/Lab cs 60 40 -30 scn 68 2 20 20 re f /Lab cs 0 0 0 scn 2 30 10 10 re f "
               b"/ICC cs 0.1 0.9 0.3 scn 24 30 20 20 re f /Cal cs 0.7 0.2 0.9 scn 46 30 20 20 re f "
               b"/Gray cs 0.4 scn 68 30 20 20 re f /Nope cs 1 0 0 scn 2 60 20 20 re f "
               b"[/Indexed /DeviceRGB 1 <00ff00ff0000>] cs 1 scn 24 60 20 20 re f")
    return P.mkpage(content, mediabox=BOX, resources={"ColorSpace": cs})


def softmask(P):
    N = P.Name

    def gs(content, s="Luminosity", bbox=(0, 0, 100, 100)):
        g = _form(P, content, group="Transparency", bbox=bbox)
        return {"Type": N("ExtGState"), "SMask": {"Type": N("Mask"), "S": N(s), "G": g}}

    ext = {
        "Lum": gs(b"1 1 1 rg 0 0 50 100 re f 0.5 g 50 0 50 50 re f"),
        "Alpha": gs(b"/A gs 0 0 1 rg 20 20 60 60 re f", s="Alpha", bbox=(10, 10, 90, 90)),
        "None": {"SMask": N("None")},
        "A": {"ca": 0.4},
    }
    ext["Alpha"]["SMask"]["G"].dict["Resources"] = {"ExtGState": {"A": {"ca": 0.4}}}
    img = P.Stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 2, "Height": 2,
                    "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8}, bytes(range(0, 240, 20)))
    content = (b"q /Lum gs 1 0 0 rg 10 10 80 80 re f 0 0 1 RG 6 w 5 50 m 95 50 l S Q "
               b"q /Alpha gs 0 0.6 0 rg 5 5 90 30 re f q 40 0 0 40 55 55 cm /Im0 Do Q Q "
               b"/None gs 0.5 g 40 40 20 20 re f")
    return P.mkpage(content, mediabox=BOX, resources={"ExtGState": ext, "XObject": {"Im0": img}})


def mesh_shadings(P):
    free = b"".join(_pack([(0, 8)] + _xy(*p) + _rgb8(*c)) for p, c in (
        ((10, 10), (1, 0, 0)), ((60, 15), (0, 1, 0)), ((30, 55), (0, 0, 1))))
    free += _pack([(1, 8)] + _xy(70, 60) + _rgb8(1, 1, 0))
    free += _pack([(2, 8)] + _xy(20, 80) + _rgb8(0, 1, 1))
    lattice = b"".join(_pack(_xy(60 + 20 * i, 10 + 20 * j) + _rgb8(i / 2, j / 2, 0.5))
                       for j in range(3) for i in range(3))
    coons = _pack([(0, 8)] + [f for p in _coons(65, 65, 40) for f in _xy(*p)]
                  + _rgb8(1, 0, 0) + _rgb8(0, 1, 0) + _rgb8(0, 0, 1) + _rgb8(1, 1, 0))
    coons += _pack([(2, 8)] + [f for p in _coons(65, 65, 40)[4:12] for f in _xy(p[0], p[1] - 40)]
                   + _rgb8(0, 0, 0) + _rgb8(1, 1, 1))
    tensor = _pack([(0, 8)] + [f for p in _coons(5, 70, 30, 3.0) + [(15, 80), (15, 90), (25, 90), (25, 80)]
                               for f in _xy(*p)]
                   + _rgb8(0.2, 0.4, 0.6) + _rgb8(1, 0, 1) + _rgb8(0, 0.5, 0) + _rgb8(1, 0.5, 0))
    gray = _mesh(P, 4, b"".join(_pack([(0, 8)] + _xy(*p) + [(v, 8)]) for p, v in (
        ((80, 80), 0), ((110, 90), 128), ((95, 115), 255))),
        ColorSpace=P.Name("DeviceGray"), Decode=[0, 120, 0, 120, 0, 1])
    shadings = {"Free": _mesh(P, 4, free), "Lat": _mesh(P, 5, lattice, VerticesPerRow=3),
                "Coons": _mesh(P, 6, coons), "Tensor": _mesh(P, 7, tensor), "Gray": gray,
                "Fn": _mesh(P, 4, free, Function=_fn2((1, 1, 1), (0.2, 0, 0.4)),
                            Decode=[0, 120, 0, 120, 0, 1], ColorSpace=P.Name("DeviceRGB")),
                "Bad": _mesh(P, 4, b"\x00\x01")}
    shadings["Fn"].raw = b"".join(_pack([(0, 8)] + _xy(*p) + [(v, 8)]) for p, v in (
        ((40, 40), 0), ((100, 40), 255), ((70, 100), 128)))
    pats = {"P0": {"PatternType": 2, "Shading": shadings["Coons"], "Matrix": [0.5, 0, 0, 0.5, 0, 0]}}
    content = (b"/Free sh /Lat sh q 0 0 60 120 re W n /Coons sh Q /Tensor sh /Gray sh "
               b"q 0.5 0 0 0.5 50 0 cm /Fn sh Q /Bad sh /Pattern cs /P0 scn 0 0 40 40 re f")
    return P.mkpage(content, mediabox=(0, 0, 120, 120), resources={"Shading": shadings, "Pattern": pats})


def pdf_shadings(P):
    N = P.Name
    sampled = P.Stream({"FunctionType": 0, "Domain": [0, 1], "Range": [0, 1, 0, 1, 0, 1], "Size": [3],
                        "BitsPerSample": 8}, bytes([255, 0, 0, 0, 255, 0, 0, 0, 255]))
    stitched = {"FunctionType": 3, "Domain": [0, 1], "Bounds": [0.4], "Encode": [0, 1, 0, 1],
                "Functions": [_fn2((1, 0, 0), (1, 1, 0)), _fn2((1, 1, 0), (0, 0, 1), 2.0)]}
    sh = {
        "Ax": {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [10, 0, 90, 0],
               "Function": _fn2((1, 0, 0), (0, 0, 1)), "Extend": [True, False]},
        "Ax3": {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0, 10, 0, 70],
                "Function": stitched, "Extend": [True, True], "BBox": [0, 0, 50, 80]},
        "Rad": {"ShadingType": 3, "ColorSpace": N("DeviceRGB"), "Coords": [50, 40, 0, 50, 40, 30],
                "Function": sampled},
        "Rad2": {"ShadingType": 3, "ColorSpace": N("DeviceGray"), "Coords": [40, 30, 5, 50, 40, 35],
                 "Function": _fn2((1,), (0,)), "Extend": [False, True]},
        "Fun": {"ShadingType": 1, "ColorSpace": N("DeviceRGB"), "Domain": [0, 100, 0, 80],
                "Function": _fn4(P, b"{ pop 100 div 0 0 }", (0, 100, 0, 80), (0, 1, 0, 1, 0, 1))},
        "FunArr": {"ShadingType": 1, "ColorSpace": N("DeviceRGB"), "Domain": [0, 1, 0, 1],
                   "Matrix": [40, 0, 0, 30, 55, 45],
                   "Function": [_fn4(P, b"{ pop }", (0, 1, 0, 1), (0, 1)),
                                _fn4(P, b"{ exch pop }", (0, 1, 0, 1), (0, 1)),
                                _fn4(P, b"{ add 2 div }", (0, 1, 0, 1), (0, 1))]},
        "Bad": {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0, 0, 10, 0],
                "Function": _fn4(P, b"{ 1 0 div }", (0, 1), (0, 1, 0, 1, 0, 1))},
    }
    pats = {"PA": {"PatternType": 2, "Shading": sh["Ax"], "Matrix": [0.5, 0, 0, 1, 10, 0]},
            "PR": {"PatternType": 2, "Shading": sh["Rad2"]}}
    content = (b"q 10 10 80 20 re W n /Ax sh Q /Ax3 sh q 20 20 60 40 re W* n /Rad sh Q "
               b"q 0.5 0 0 0.5 0 40 cm /Fun sh Q /FunArr sh /Rad2 sh /Bad sh "
               b"/Pattern cs /PA scn 0 60 100 10 re f /PR scn 70 5 25 25 re f")
    return P.mkpage(content, mediabox=(0, 0, 100, 80), resources={"Shading": sh, "Pattern": pats})


def _tiling(P, content, **d):
    base = {"Type": P.Name("Pattern"), "PatternType": 1, "PaintType": 1, "TilingType": 1,
            "BBox": [0, 0, 10, 10], "XStep": 10, "YStep": 10, "Resources": {}}
    base.update(d)
    return P.Stream(base, content)


def pdf_patterns(P):
    N = P.Name
    pats = {
        "T0": _tiling(P, b"1 0 0 rg 0 0 5 5 re f 0 0 1 rg 5 5 5 5 re f"),
        "T1": _tiling(P, b"0 0 6 6 re f", PaintType=2, Matrix=[1.5, 0, 0, 1.5, 3, 1], XStep=8, YStep=8),
        "T2": _tiling(P, b"q 0.5 0 0 0.5 0 0 cm 0 0.5 0 rg 0 0 20 20 re f Q", BBox=[0, 0, 12, 12], XStep=0),
        "S0": {"PatternType": 2, "Shading": {"ShadingType": 2, "ColorSpace": N("DeviceRGB"),
                                             "Coords": [0, 0, 30, 30], "Function": _fn2((0, 1, 0), (1, 0, 1))}},
    }
    cs = {"PU": [N("Pattern"), N("DeviceRGB")], "PC": [N("Pattern"), N("DeviceCMYK")]}
    content = (b"/Pattern cs /T0 scn 0 0 45 45 re f /PU cs 0 0 1 /T1 scn 50 0 45 45 re f "
               b"/PC cs 0 1 1 0 /T1 scn 50 50 45 45 re f /Pattern CS /T2 SCN 8 w 5 70 m 45 70 l S "
               b"/Pattern cs /S0 scn 0 50 20 20 re f /Pattern cs /Missing scn 25 50 10 10 re f")
    return P.mkpage(content, mediabox=BOX, resources={"Pattern": pats, "ColorSpace": cs})


def formgroup(P):
    N = P.Name
    overlap = b"1 0 0 rg 20 20 40 40 re f 40 40 40 40 re f"
    xo = {"G1": _form(P, overlap, group="Transparency"),
          "G2": _form(P, b"0 0 1 rg 10 50 50 30 re f 0 1 0 rg 30 60 50 30 re f", group="Transparency"),
          "G3": _form(P, overlap, group="Transparency", Matrix=[0.5, 0, 0, 0.5, 50, 0]),
          "F0": _form(P, b"0.5 g 5 5 10 10 re f")}
    ext = {"Half": {"ca": 0.5}, "Mul": {"BM": N("Multiply")}, "MulHalf": {"BM": N("Screen"), "ca": 0.6},
           "Norm": {"BM": N("Normal"), "ca": 1.0}}
    content = (b"0.9 0.8 0.2 rg 0 0 100 100 re f q /Half gs /G1 Do Q q /Mul gs /G2 Do Q "
               b"q /MulHalf gs /G3 Do Q q /Norm gs /F0 Do Q q /Half gs /F0 Do Q")
    return P.mkpage(content, mediabox=BOX, resources={"XObject": xo, "ExtGState": ext})


def ocg(P):
    N, R = P.Name, P.Ref
    page_content = (b"/OC /on BDC 1 0 0 rg 5 5 20 20 re f EMC /OC /off BDC 0 1 0 rg 30 5 20 20 re f EMC "
                    b"/OC /md BDC 0 0 1 rg 55 5 20 20 re f EMC /Fm0 Do /Fm1 Do /Span BMC 0.5 g 5 60 30 30 re f EMC")
    objects = {
        1: {"Type": N("Catalog"), "Pages": R(2),
            "OCProperties": {"OCGs": [R(5), R(6)], "D": {"BaseState": N("ON"), "OFF": [R(6)]}}},
        2: {"Type": N("Pages"), "Kids": [R(3)], "Count": 1},
        3: {"Type": N("Page"), "Parent": R(2), "MediaBox": list(BOX), "Contents": R(4),
            "Resources": {"Properties": {"on": R(5), "off": R(6),
                                         "md": {"Type": N("OCMD"), "OCGs": [R(5), R(6)], "P": N("AllOn")}},
                          "XObject": {"Fm0": R(7), "Fm1": R(8)}}},
        4: P.Stream({}, page_content),
        5: {"Type": N("OCG"), "Name": b"on"},
        6: {"Type": N("OCG"), "Name": b"off"},
        7: P.Stream({"Type": N("XObject"), "Subtype": N("Form"), "BBox": [0, 0, 100, 100], "OC": R(6)},
                    b"1 0 1 rg 50 50 40 40 re f"),
        8: P.Stream({"Type": N("XObject"), "Subtype": N("Form"), "BBox": [0, 0, 100, 100], "OC": R(5)},
                    b"0 1 1 rg 60 30 30 10 re f"),
    }
    return P.Pdf(objects, {"Root": R(1)})


def pdf_annotations(P):
    N = P.Name
    ap = _form(P, b"0 0 1 rg 0 0 10 10 re f 1 0 0 RG 1 w 0 0 m 10 10 l S", bbox=(0, 0, 10, 10))
    rot = _form(P, b"0 1 0 rg 0 0 20 10 re f", bbox=(0, 0, 20, 10), Matrix=[0, 1, -1, 0, 0, 0])
    on = _form(P, b"1 1 0 rg 0 0 5 5 re f", bbox=(0, 0, 5, 5))
    off = _form(P, b"0 0 0 rg 0 0 5 5 re f", bbox=(0, 0, 5, 5))
    annots = [
        {"Type": N("Annot"), "Subtype": N("Stamp"), "Rect": [10, 10, 40, 30], "AP": {"N": ap}},
        {"Type": N("Annot"), "Subtype": N("Square"), "Rect": [60, 60, 70, 80], "AP": {"N": rot}},
        {"Type": N("Annot"), "Subtype": N("Widget"), "Rect": [50, 10, 70, 30], "AS": N("Off"),
         "AP": {"N": {"On": on, "Off": off}}},
        {"Type": N("Annot"), "Subtype": N("Stamp"), "Rect": [80, 80, 95, 95], "F": 2, "AP": {"N": ap}},
        {"Type": N("Annot"), "Subtype": N("Link"), "Rect": [0, 0, 100, 100], "AP": {"N": ap}},
        {"Type": N("Annot"), "Subtype": N("Stamp"), "Rect": [1, 2], "AP": {"N": ap}},
    ]
    pdf = P.mkpage(b"0.9 g 0 0 100 100 re f", mediabox=BOX)
    pdf.objects[3]["Annots"] = annots
    return pdf


def pdfgraphics_elements(P):
    N = P.Name
    img = P.Stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 3, "Height": 2,
                    "ColorSpace": N("DeviceGray"), "BitsPerComponent": 8}, bytes([0, 80, 160, 240, 120, 40]))
    content = (b"/Tag BMC 0 0 1 RG 3 w 1 J 1 j [6 3] 2 d 10 10 m 90 10 l 90 40 l S EMC "
               b"/Span <</MCID 3>> BDC 1 0 0 rg 2 M 0 j 10 50 m 30 90 l 50 50 l b* EMC "
               b"q 2 0 0 2 0 0 cm 0.2 0.7 0.3 0.1 k 30 30 10 5 re B 0 0 0 1 K 2 J 35 40 m 45 45 25 45 45 40 c S Q "
               b"q 30 0 0 20 60 60 cm /Im0 Do Q "
               b"q 10 0 0 10 5 80 cm BI /W 2 /H 2 /BPC 8 /CS /G ID \x00\x40\x80\xff EI Q "
               b"60 20 m 70 30 v 80 20 y h f 0.3 g 70 70 m 90 90 l 95 70 l n")
    return P.mkpage(content, mediabox=BOX, resources={"XObject": {"Im0": img}})


def pdf_clipping(P):
    N = P.Name
    sh = {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0, 0, 100, 0],
          "Function": _fn2((1, 0, 0), (0, 1, 0))}
    content = (b"q 10 10 80 80 re W n 0 0 1 rg 0 0 100 100 re f "
               b"q 50 50 m 90 50 l 70 90 l h W* n 1 0 0 rg 20 20 70 70 re f "
               b"q 60 60 20 20 re 65 65 10 10 re W* n /Sh0 sh Q Q "
               b"0 1 0 RG 4 w 0 0 m 100 100 l S Q "
               b"q 0 0 100 100 re W n 0 g 40 2 20 5 re f Q "
               b"20 80 m 40 95 l 30 70 l W n 1 1 0 rg 0 60 60 40 re f")
    return P.mkpage(content, mediabox=BOX, resources={"Shading": {"Sh0": sh}})


def pdf_modern(P):
    """An xref-stream file with object streams, written by the side's own
    writer."""
    N = P.Name
    img = P.Stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 2, "Height": 2,
                     "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8, "Filter": N("FlateDecode")},
                    zlib.compress(bytes(range(0, 240, 20))))
    sh = {"ShadingType": 3, "ColorSpace": N("DeviceRGB"), "Coords": [50, 50, 0, 50, 50, 40],
          "Function": _fn2((1, 1, 1), (0, 0, 0.5))}
    pdf = P.mkpage(b"q /Sh0 sh Q 1 0 0 rg 10 10 30 30 re f q 30 0 0 30 60 10 cm /Im0 Do Q",
                   mediabox=BOX, resources={"XObject": {"Im0": img}, "Shading": {"Sh0": sh}})
    return P.pdf_to_bytes(pdf, modern=True)


def _pages(P, contents, page_extra, pages_extra):
    N, R = P.Name, P.Ref
    kids = [R(3 + 2 * i) for i in range(len(contents))]
    objects = {1: {"Type": N("Catalog"), "Pages": R(2)},
               2: dict({"Type": N("Pages"), "Kids": kids, "Count": len(kids)}, **pages_extra)}
    for i, c in enumerate(contents):
        objects[3 + 2 * i] = dict({"Type": N("Page"), "Parent": R(2), "Contents": R(4 + 2 * i)}, **page_extra[i])
        objects[4 + 2 * i] = P.Stream({"Filter": N("FlateDecode")}, zlib.compress(c))
    return P.Pdf(objects, {"Root": R(1)})


def page_rotate(P):
    return _pages(P, [b"1 0 0 rg 10 10 60 20 re f", b"0 0 1 rg 5 30 20 60 re f", b"0 g 0 0 10 10 re f"],
                  [{}, {"Rotate": 90, "MediaBox": [0, 0, 80, 100]}, {"Rotate": 270}],
                  {"Rotate": 180, "MediaBox": list(BOX)})


def multipage(P):
    ext = {"ExtGState": {"H": {"ca": 0.5}}}
    return _pages(P, [b"/H gs 1 0 0 rg 10 10 50 50 re f", b"0 1 0 rg 20 20 60 60 re f", b""],
                  [{}, {"Resources": {}}, {"MediaBox": [0, 0, 40, 30]}],
                  {"Resources": ext, "MediaBox": list(BOX)})


BLEND_MODES = ["Multiply", "Screen", "Overlay", "Darken", "Lighten", "ColorDodge", "ColorBurn", "HardLight",
               "SoftLight", "Difference", "Exclusion", "Hue", "Saturation", "Color", "Luminosity"]


def blendmodes(P):
    N = P.Name
    ext = {f"B{i}": {"BM": N(m)} for i, m in enumerate(BLEND_MODES)}
    ext["Arr"] = {"BM": [N("Bogus"), N("Multiply")]}
    ext["Compat"] = {"BM": N("Compatible")}
    ext["Half"] = {"BM": N("Screen"), "ca": 0.5}
    img = P.Stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 2, "Height": 1,
                    "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8}, bytes([250, 10, 10, 10, 10, 250]))
    sh = {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0, 0, 100, 0],
          "Function": _fn2((0, 0, 1), (1, 1, 0)), "BBox": [0, 80, 100, 100]}
    parts = [b"0.2 0.5 0.8 rg 0 0 100 100 re f 0.9 0.3 0.1 rg 0 0 50 100 re f"]
    for i in range(len(BLEND_MODES)):
        x, y = 3 + (i % 5) * 19, 3 + (i // 5) * 19
        parts.append(b"q /B%d gs 0.1 0.8 0.6 rg %d %d 16 16 re f Q" % (i, x, y))
    parts.append(b"q /Arr gs 1 1 0 rg 5 62 20 10 re f Q q /Compat gs 0 0 0 rg 30 62 10 10 re f Q "
                 b"q /Half gs 0 1 1 RG 3 w 50 62 m 95 72 l S Q q /B0 gs 40 0 0 10 55 80 cm /Im0 Do Q "
                 b"q /B9 gs /Sh0 sh Q")
    return P.mkpage(b" ".join(parts), mediabox=BOX,
                    resources={"ExtGState": ext, "XObject": {"Im0": img}, "Shading": {"Sh0": sh}})


def _rich_bytes():
    """The JAX fuzz test's feature-dense page without its text: paths, a
    clip, a stroke, an image and a shading."""
    N = JP.Name
    img = JP.Stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 2, "Height": 2, "BitsPerComponent": 8,
                     "ColorSpace": N("DeviceRGB"), "Filter": N("FlateDecode")}, zlib.compress(bytes(range(12))))
    sh = {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0.0, 0.0, 50.0, 0.0],
          "Function": {"FunctionType": 2, "Domain": [0.0, 1.0], "C0": [1.0, 0.0, 0.0], "C1": [0.0, 0.0, 1.0], "N": 1.0}}
    content = (b"q 5 5 90 90 re W n 0.2 0.9 0.1 rg 10 10 40 40 re f 2 w 0 0 1 RG 20 60 m 80 60 l S "
               b"q 20 0 0 20 30 30 cm /Im0 Do Q q /Sh0 sh Q Q")
    return JP.pdf_to_bytes(JP.mkpage(content, mediabox=BOX, resources={"XObject": {"Im0": img}, "Shading": {"Sh0": sh}}))


def _mutated(trial):
    data = bytearray(_rich_bytes())
    rng = np.random.RandomState(trial)
    kind = trial % 4
    if kind == 0:
        data = data[: rng.randint(1, len(data))]
    elif kind == 1:
        for _ in range(rng.randint(1, 12)):
            data[rng.randint(0, len(data))] = rng.randint(0, 256)
    elif kind == 2:
        at = rng.randint(0, len(data))
        data[at:at] = bytes(rng.randint(0, 256, rng.randint(1, 64)).tolist())
    else:
        a = rng.randint(0, len(data) - 1)
        del data[a: min(len(data), a + rng.randint(1, 200))]
    return bytes(data)


def _outcome(side, P, PG, PS, data):
    try:
        return page_results(side, P, PG, PS, lambda _P: data)
    except Exception as e:  # noqa: BLE001 - the kind of failure is what is compared
        return type(e).__name__


def pdf_fuzz(P):
    return _rich_bytes()


def chip_smoke_document(P):
    """chip_smoke.py's three-page document (graphics, images, text) at
    480x270, written by each side's own writer."""
    import chip_smoke

    return P.pdf_to_bytes(P.Pdf(*chip_smoke.pdf_document(P, 480, 270, image_wh=(64, 48))))


FAMILIES = {f.__name__: f for f in (
    colourspaces, softmask, mesh_shadings, pdf_shadings, pdf_patterns, formgroup, ocg, pdf_annotations,
    pdfgraphics_elements, pdf_clipping, pdf_modern, page_rotate, multipage, blendmodes, pdf_fuzz,
    chip_smoke_document)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(family, both_sides):
    got = parity(FAMILIES[family])
    assert any(p[2] is not None for p in got)


def test_corrupted_files_fail_or_degrade_as_the_jax_package(both_sides):
    """Mutations of the fuzz family's file (truncated, flipped, spliced,
    cut): each parses and renders to the same result on both sides, or
    fails with the same kind of exception on both."""
    kinds = set()
    for trial in range(12):
        data = _mutated(trial)
        for side in (JAX, PORT):
            side.cache.clear()
        a = _outcome(JAX, JP, JPG, JS, data)
        b = _outcome(PORT, TP, TPG, TS, data)
        if isinstance(a, str) or isinstance(b, str):
            assert a == b, f"trial {trial}: {a if isinstance(a, str) else 'ok'} vs {b if isinstance(b, str) else 'ok'}"
            kinds.add(a)
            continue
        for pa, pb in zip(a, b):
            assert pb[:2] == pa[:2] and same_raster(pa[2], pb[2]), f"trial {trial}"
        kinds.add("ok")
    assert "ok" in kinds and len(kinds) > 1


# --- fallbacks for malformed input ------------------------------------------


def malformed_smask(P):
    N = P.Name
    ext = {"NoG": {"SMask": {"Type": N("Mask"), "S": N("Luminosity")}},
           "BadBox": {"SMask": {"Type": N("Mask"), "S": N("Luminosity"),
                                "G": _form(P, b"1 g 0 0 9 9 re f", bbox=(0, 0, "x", 9))}},
           "Empty": {"SMask": {"Type": N("Mask"), "S": N("Alpha"), "G": _form(P, b"1 g 0 0 9 9 re f", bbox=(5, 5, 5, 5))}}}
    return P.mkpage(b"q /NoG gs 1 0 0 rg 10 10 30 30 re f Q q /BadBox gs 0 1 0 rg 50 10 30 30 re f Q "
                    b"q /Empty gs 0 0 1 rg 10 50 30 30 re f Q", mediabox=BOX, resources={"ExtGState": ext})


def unknown_blend(P):
    ext = {"U": {"BM": P.Name("NoSuchMode")}, "UA": {"BM": [P.Name("Nope"), P.Name("AlsoNot")]}}
    return P.mkpage(b"0 0 1 rg 0 0 100 100 re f /U gs 1 0 0 rg 10 10 40 40 re f /UA gs 0 1 0 rg 50 50 40 40 re f",
                    mediabox=BOX, resources={"ExtGState": ext})


def colour_mismatch(P):
    return P.mkpage(b"/DeviceRGB cs 0.5 scn 10 10 30 30 re f /DeviceCMYK CS 1 0 SCN 4 w 50 50 m 90 90 l S "
                    b"/DeviceGray cs 0.1 0.2 0.3 0.4 0.5 scn 60 10 30 30 re f", mediabox=BOX)


def empty_tiling_cell(P):
    pats = {"E": _tiling(P, b""), "Z": _tiling(P, b"1 0 0 rg 0 0 5 5 re f", BBox=[0, 0, 0, 10]),
            "N": _tiling(P, b"0 0 1 rg 0 0 5 5 n")}
    return P.mkpage(b"/Pattern cs /E scn 0 0 30 30 re f /Z scn 35 0 30 30 re f /N scn 70 0 30 30 re f",
                    mediabox=BOX, resources={"Pattern": pats})


FALLBACKS = {f.__name__: f for f in (malformed_smask, unknown_blend, colour_mismatch, empty_tiling_cell)}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_fallback_matches_jax(case, both_sides):
    parity(FALLBACKS[case])


def test_malformed_smask_paints_the_unmasked_fill(both_sides):
    """A /SMask whose group is missing or unreadable gives the base fill
    itself on both sides: the page renders as the same page without it."""
    got = parity(malformed_smask)
    plain = parity(lambda P: P.mkpage(b"q 1 0 0 rg 10 10 30 30 re f Q q 0 1 0 rg 50 10 30 30 re f Q "
                                      b"q 0 0 1 rg 10 50 30 30 re f Q", mediabox=BOX))
    assert same_raster(got[0][2], plain[0][2])


def test_softmask_reads_back_once_per_mask(both_sides, monkeypatch):
    """Each soft mask renders its group on the device and reads the result
    back to the host once: outside the sub-renders' own syncs, one counted
    sync per masked fill."""
    inside = []
    render = TS.R.render_simple_scene

    def counted(*args):
        before = t_region.syncs
        out = render(*args)
        inside.append(t_region.syncs - before)
        return out

    monkeypatch.setattr(TS.R, "render_simple_scene", counted)
    t_region.syncs = 0
    pdf = softmask(TP)
    scene = TS.scene_of_graphic(pdf, TPG.graphic_of_page(pdf, pdf.pages()[0]), "cpu")
    masked = sum(type(o.geometry.fill).__name__ == "MaskedFill" for o in scene)
    assert masked == 4 and len(inside) == masked
    assert t_region.syncs - sum(inside) == masked


def test_sub_render_needs_a_device():
    pdf = softmask(TP)
    g = TPG.graphic_of_page(pdf, pdf.pages()[0])
    with pytest.raises(ValueError, match="needs a device"):
        TS.scene_of_graphic(pdf, g)


def _mask_page(P, group_content: bytes, **group_resources):
    """A fill under a Luminosity soft mask whose group draws
    `group_content`."""
    g = _form(P, group_content, group="Transparency", Resources=group_resources)
    ext = {"M": {"SMask": {"Type": P.Name("Mask"), "S": P.Name("Luminosity"), "G": g}}}
    return P.mkpage(b"q /M gs 0.2 0.4 0.9 rg 5 5 90 90 re f Q", mediabox=BOX, resources={"ExtGState": ext})


def test_text_in_a_soft_mask_group_is_refused(both_sides):
    """Text inside a mask group (read while the scene is built) masks the
    fill as in the JAX package.  (The test keeps the name it had while the
    port refused text.)"""
    def text_mask(P):
        font = {"Type": P.Name("Font"), "Subtype": P.Name("Type1"), "BaseFont": P.Name("Helvetica")}
        return _mask_page(P, b"1 g BT /F1 60 Tf 5 30 Td (Wx) Tj ET", Font={"F1": font})

    got = parity(text_mask)
    plain = parity(lambda P: P.mkpage(b"0.2 0.4 0.9 rg 5 5 90 90 re f", mediabox=BOX))
    assert got[0][1][0][0][1][0] == "MaskedFill"
    if TS_FALLBACK_FACE is not None:
        assert not same_raster(got[0][2], plain[0][2])


def test_a_mask_group_that_fails_to_convert_paints_the_unmasked_fill(both_sides):
    """A mask group holding a stroke with a line cap outside 0-2 fails in
    scene conversion: both packages paint the fill unmasked, as the same
    page without the mask."""
    got = parity(lambda P: _mask_page(P, b"1 g 9 J 4 w 10 10 m 90 90 l S 0 0 50 100 re f"))
    plain = parity(lambda P: P.mkpage(b"q 0.2 0.4 0.9 rg 5 5 90 90 re f Q", mediabox=BOX))
    assert got[0][1] == plain[0][1] and same_raster(got[0][2], plain[0][2])


def _sub_render_pages():
    """A soft mask, a tiling cell, and a Type 3 glyph whose content holds a
    soft mask: each renders a sub-scene."""
    N = TP.Name
    tiling = TP.mkpage(b"/Pattern cs /T0 scn 0 0 45 45 re f", mediabox=BOX,
                       resources={"Pattern": {"T0": _tiling(TP, b"1 0 0 rg 0 0 5 5 re f")}})
    glyph = TP.Stream({}, b"1000 0 d0 /M gs 0 0 1 rg 0 0 750 750 re f")
    group = _form(TP, b"1 g 0 0 500 1000 re f", group="Transparency", bbox=(0, 0, 1000, 1000))
    font = {"Type": N("Font"), "Subtype": N("Type3"), "FontBBox": [0, 0, 1000, 1000],
            "FontMatrix": [0.001, 0, 0, 0.001, 0, 0], "CharProcs": {"sq": glyph},
            "Encoding": {"Type": N("Encoding"), "Differences": [97, N("sq")]}, "FirstChar": 97, "LastChar": 97,
            "Widths": [1000], "Resources": {"ExtGState": {"M": {"SMask": {"Type": N("Mask"), "S": N("Luminosity"),
                                                                           "G": group}}}}}
    type3 = TP.mkpage(b"BT /F1 50 Tf 20 20 Td (a) Tj ET", mediabox=BOX, resources={"Font": {"F1": font}})
    return {"soft mask": softmask(TP), "tiling cell": tiling, "Type 3 glyph": type3}


@pytest.mark.parametrize("where", ["soft mask", "tiling cell", "Type 3 glyph"])
def test_a_failing_sub_render_is_raised(where, both_sides, monkeypatch):
    """The one deliberate divergence: where the JAX package falls back on
    any exception, a failure of the port's sub-render on its device comes
    out of scene_of_graphic as SubRenderError (no fallback hides the
    device), while the same page converts when the sub-render works."""
    pdf = _sub_render_pages()[where]
    graphic = TPG.graphic_of_page(pdf, pdf.pages()[0])
    assert TS.scene_of_graphic(pdf, graphic, "cpu")

    def fails(*args):
        raise RuntimeError("the card went away")

    monkeypatch.setattr(TS.R, "render_simple_scene", fails)
    with pytest.raises(TS.SubRenderError, match="the card went away"):
        TS.scene_of_graphic(pdf, graphic, "cpu")
