"""The port's PDF text (``io.truetype``, ``cff``, ``type1``, ``cmap``,
``afm``, the text operators of ``io.pdfgraphics`` and ``scene.pdftext``)
against the JAX package's: every scenario of ``test_pdf_text.py``,
``test_type1.py``, ``test_pdf_type3.py`` and ``test_afm_metrics.py`` that
builds a page, run through both packages (the same graphic element tree,
the same scene and the same CPU render, tolerance 0), and the font parsers
on the same programs (the same outlines, advances and code maps).

Each page is built from the same numbers with a side's own ``mkpage``,
``Name`` and ``Stream``.  Scenarios that embed or fall back to DejaVu skip
where it is not installed, as the JAX tests do.  The font programs come
from the JAX tests' own builders.
"""

import zlib

import numpy as np
import pytest

from coherence_tpu.io import afm as j_afm
from coherence_tpu.io import cff as j_cff
from coherence_tpu.io import cmap as j_cmap
from coherence_tpu.io import pdf as JP
from coherence_tpu.io import pdfgraphics as JPG
from coherence_tpu.io import truetype as j_tt
from coherence_tpu.io import type1 as j_t1
from coherence_tpu.scene import pdftext as j_text

from coherence_tpu_torch.io import afm as t_afm
from coherence_tpu_torch.io import cff as t_cff
from coherence_tpu_torch.io import cmap as t_cmap
from coherence_tpu_torch.io import pdf as TP
from coherence_tpu_torch.io import pdfgraphics as TPG
from coherence_tpu_torch.io import truetype as t_tt
from coherence_tpu_torch.io import type1 as t_t1
from coherence_tpu_torch.scene import pdftext as t_text

from _torch_general import both_sides  # noqa: F401
from _torch_pdf import canon, parity
from _torch_threads import one_torch_thread  # noqa: F401
from test_pdf_text import _mk_min_cff
from test_type1 import NOTDEF, OP, SQUARE, _build_font, _cs

DEJAVU = t_tt.fallback_font_path("Helvetica")
needs_font = pytest.mark.skipif(DEJAVU is None, reason="no DejaVu installed")
BOX = (0, 0, 200, 100)


def _helvetica(P, **extra):
    return {"Font": {"F1": {"Type": P.Name("Font"), "Subtype": P.Name("Type1"), "BaseFont": P.Name("Helvetica"),
                            **extra}}}


def _dejavu_stream(P):
    data = open(DEJAVU, "rb").read()
    return P.Stream({"Filter": P.Name("FlateDecode"), "Length1": len(data)}, zlib.compress(data))


def _gid(ch: str) -> int:
    return t_tt.TrueTypeFont(open(DEJAVU, "rb").read()).gid_of_unicode(ord(ch))


def _type0(P, encoding, **child_extra):
    N = P.Name
    child = {"Type": N("Font"), "Subtype": N("CIDFontType2"), "BaseFont": N("DejaVuSans"), "DW": 1000,
             "CIDSystemInfo": {"Registry": b"Adobe", "Ordering": b"Identity"},
             "FontDescriptor": {"Type": N("FontDescriptor"), "FontFile2": _dejavu_stream(P)}, **child_extra}
    return {"Type": N("Font"), "Subtype": N("Type0"), "BaseFont": N("DejaVuSans"), "Encoding": encoding,
            "DescendantFonts": [child]}


# --- page scenarios of test_pdf_text.py ----------------------------------------


def fallback_text(P):
    return P.mkpage(b"BT /F1 48 Tf 10 30 Td 1 0 0 rg (Hi) Tj ET", mediabox=BOX, resources=_helvetica(P))


def embedded_truetype_widths(P):
    N = P.Name
    fd = {"Type": N("Font"), "Subtype": N("TrueType"), "BaseFont": N("AAAAAA+DejaVuSans"), "FirstChar": 65,
          "Widths": [500, 500], "FontDescriptor": {"Type": N("FontDescriptor"), "FontFile2": _dejavu_stream(P)}}
    return P.mkpage(b"BT /F1 40 Tf 10 30 Td (AB) Tj ET", mediabox=BOX, resources={"Font": {"F1": fd}})


def type0_identity_h(P):
    g = _gid("A")
    font = _type0(P, P.Name("Identity-H"), W=[g, [700]])
    code = bytes([g >> 8, g & 255]).hex().encode()
    return P.mkpage(b"BT /F1 50 Tf 20 20 Td <" + code + b"> Tj ET", mediabox=(0, 0, 120, 100),
                    resources={"Font": {"F1": font}})


def tj_kerning_multiline(P):
    return P.mkpage(b"BT /F1 20 Tf 14 TL 10 60 Td [(x) -2000 (x)] TJ T* (x) Tj ET", mediabox=BOX,
                    resources=_helvetica(P))


def spacing_operators(P):
    """Tc, Tw (on the space only), Tz, Ts, TL with T*, ' and "."""
    return P.mkpage(b"BT /F1 14 Tf 16 TL 5 85 Td 2 Tc (a b c) Tj T* 6 Tw (a b c) Tj 0 Tc 0 Tw "
                    b"T* 70 Tz (a b c) Tj 100 Tz 4 Ts (up) Tj 0 Ts (a b) ' 3 1 (a b c) \" ET",
                    mediabox=BOX, resources=_helvetica(P))


def render_mode_3(P):
    return P.mkpage(b"BT /F1 30 Tf 10 40 Td 3 Tr (A) Tj 0 Tr (B) Tj ET", mediabox=(0, 0, 120, 100),
                    resources=_helvetica(P))


def garbage_fontfile3(P):
    N = P.Name
    fd = {"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("Times-Roman"),
          "FontDescriptor": {"Type": N("FontDescriptor"),
                             "FontFile3": P.Stream({"Subtype": N("Type1C")}, b"\x01\x00\x04\x01")}}
    return P.mkpage(b"BT /F1 24 Tf 10 30 Td (ok) Tj ET", mediabox=(0, 0, 100, 60), resources={"Font": {"F1": fd}})


def bare_cff_fontfile3(P):
    """A bare CFF FontFile3 (the box charstring of the JAX test's Type 2
    interpreter case): code 32 maps to gid 1 through the ISOAdobe charset."""
    import struct

    def num(v):
        return bytes([v + 139])

    box = (b"\x1c" + struct.pack(">h", 550) + num(100) + num(100) + b"\x15" + num(80) + b"\x06" + num(60) + b"\x07"
           + b"\x1c" + struct.pack(">h", -80) + b"\x06" + b"\x0e")
    N = P.Name
    ff = P.Stream({"Subtype": N("Type1C"), "Filter": N("FlateDecode")}, zlib.compress(_mk_min_cff([b"\x0e", box])))
    fd = {"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("Mini"),
          "FontDescriptor": {"Type": N("FontDescriptor"), "FontFile3": ff}}
    return P.mkpage(b"BT /F1 80 Tf 0.2 0.4 0.8 rg 10 10 Td (   ) Tj ET", mediabox=BOX, resources={"Font": {"F1": fd}})


def sticky_text_state(P):
    return P.mkpage(b"/F1 30 Tf BT 10 60 Td (A) Tj ET BT 10 20 Td (B) Tj ET", mediabox=(0, 0, 100, 100),
                    resources=_helvetica(P))


def encoding_differences(P):
    """Three pages: /Differences 65 -> zero, the plain A, and 0."""
    N = P.Name
    diffs = _helvetica(P, Encoding={"Type": N("Encoding"), "Differences": [65, N("zero")]})
    pages = [(b"BT /F1 40 Tf 10 30 Td (A) Tj ET", diffs), (b"BT /F1 40 Tf 10 30 Td (A) Tj ET", _helvetica(P)),
             (b"BT /F1 40 Tf 10 30 Td (0) Tj ET", _helvetica(P))]
    return _document(P, pages, (0, 0, 100, 100))


def text_fill_alpha(P):
    res = _helvetica(P)
    res["ExtGState"] = {"GS0": {"Type": P.Name("ExtGState"), "ca": 0.25}}
    return P.mkpage(b"/GS0 gs BT /F1 60 Tf 10 25 Td 1 0 0 rg (H) Tj ET", mediabox=(0, 0, 100, 100), resources=res)


def inline_image_named_colourspace(P):
    res = {"ColorSpace": {"Cs1": [P.Name("Indexed"), P.Name("DeviceRGB"), 1, bytes([255, 0, 0, 0, 0, 255])]}}
    return P.mkpage(b"q 16 0 0 16 0 0 cm BI /W 2 /H 1 /BPC 8 /CS /Cs1 ID \x00\x01 EI Q", mediabox=(0, 0, 16, 16),
                    resources=res)


def type0_identity_v(P):
    g = _gid("H")
    font = _type0(P, P.Name("Identity-V"), DW2=[880, -1000])
    code = (bytes([g >> 8, g & 255]) * 2).hex().encode()
    return P.mkpage(b"BT /F1 30 Tf 60 160 Td <" + code + b"> Tj ET", mediabox=(0, 0, 120, 200),
                    resources={"Font": {"F1": font}})


def type0_w2(P):
    """Two pages: /W2 halving the vertical displacement, and the DW2
    default."""
    g = _gid("H")
    code = (bytes([g >> 8, g & 255]) * 2).hex().encode()
    content = b"BT /F1 30 Tf 60 160 Td <" + code + b"> Tj ET"
    pages = [(content, {"Font": {"F1": _type0(P, P.Name("Identity-V"), W2=[g, [-500, 300, 880]])}}),
             (content, {"Font": {"F1": _type0(P, P.Name("Identity-V"))}})]
    return _document(P, pages, (0, 0, 120, 200))


def type0_embedded_cmap(P):
    g = _gid("A")
    src = ("/CIDInit /ProcSet findresource begin\nbegincmap\n/WMode 0 def\n1 begincodespacerange\n<00> <FF>\n"
           "endcodespacerange\n1 begincidchar\n<41> %d\nendcidchar\nendcmap end" % g).encode()
    font = _type0(P, P.Stream({}, src))
    font["DescendantFonts"][0]["DW"] = 700
    return P.mkpage(b"BT /F1 50 Tf 20 20 Td (A) Tj ET", mediabox=(0, 0, 120, 100), resources={"Font": {"F1": font}})


def _document(P, pages, mediabox):
    """A Pdf of several (content, resources) pages."""
    N, R = P.Name, P.Ref
    objects = {1: {"Type": N("Catalog"), "Pages": R(2)},
               2: {"Type": N("Pages"), "Kids": [], "Count": len(pages), "MediaBox": list(mediabox)}}
    for i, (content, res) in enumerate(pages):
        num = 3 + 2 * i
        objects[num] = {"Type": N("Page"), "Parent": R(2), "Contents": R(num + 1), "Resources": res}
        objects[num + 1] = P.Stream({}, content)
        objects[2]["Kids"].append(R(num))
    return P.Pdf(objects, {"Root": R(1)})


# --- test_type1.py, test_pdf_type3.py -------------------------------------------


def type1_fontfile(P):
    N = P.Name
    program = _build_font([(".notdef", NOTDEF), ("square", SQUARE)], encoding_puts=[(97, "square")])
    font = {"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("TestFont"), "FirstChar": 97, "LastChar": 97,
            "Widths": [600], "FontDescriptor": {"Type": N("FontDescriptor"), "FontName": N("TestFont"), "Flags": 4,
                                                "FontFile": P.Stream({"Length1": 0, "Length2": 0, "Length3": 0},
                                                                     program)}}
    return P.mkpage(b"BT /F1 100 Tf 0 0 1 rg 20 40 Td (a) Tj ET", mediabox=(0, 0, 200, 200),
                    resources={"Font": {"F1": font}})


def _type3(P, charprocs, diffs, widths, first_char=97):
    N = P.Name
    return {"Type": N("Font"), "Subtype": N("Type3"), "FontBBox": [0, 0, 1000, 1000],
            "FontMatrix": [0.001, 0.0, 0.0, 0.001, 0.0, 0.0], "CharProcs": charprocs,
            "Encoding": {"Type": N("Encoding"), "Differences": diffs}, "FirstChar": first_char,
            "LastChar": first_char + len(widths) - 1, "Widths": widths, "Resources": {}}


def _type3_page(P, proc: bytes, name: str, widths, content: bytes):
    font = _type3(P, {name: P.Stream({}, proc)}, [97, P.Name(name)], widths)
    return P.mkpage(content, mediabox=(0, 0, 200, 200), resources={"Font": {"F1": font}})


def type3_stencil(P):
    return _type3_page(P, b"750 0 0 0 750 750 d1 0 1 0 rg 0 0 750 750 re f", "square", [1000],
                       b"BT /F1 50 Tf 1 0 0 rg 20 100 Td (a) Tj ET")


def type3_d0_colours(P):
    return _type3_page(P, b"750 0 d0 0 0 1 rg 0 0 750 750 re f", "square", [1000],
                       b"BT /F1 50 Tf 1 0 0 rg 20 100 Td (a) Tj ET")


def type3_widths(P):
    return _type3_page(P, b"500 0 0 0 500 750 d1 0 0 500 750 re f", "bar", [1000],
                       b"BT /F1 50 Tf 0 0 0 rg 20 100 Td (aa) Tj ET")


def type3_unmapped_code(P):
    return _type3_page(P, b"1000 0 0 0 750 750 d1 0 0 750 750 re f", "square", [1000, 1000],
                       b"BT /F1 50 Tf 0 0 0 rg 20 100 Td (ba) Tj ET")


# --- text in the rest of the reader ------------------------------------------------


def clip_modes(P):
    """Tr 7 clipping an axial shading, Tr 4 painting and clipping a fill,
    and Tr 1 and 2 in CMYK and gray."""
    N = P.Name
    sh = {"ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0, 0, 200, 0],
          "Function": {"FunctionType": 2, "Domain": [0, 1], "C0": [1, 0, 0], "C1": [0, 0, 1], "N": 1}}
    res = _helvetica(P)
    res["Shading"] = {"Sh0": sh}
    return P.mkpage(b"q BT /F1 60 Tf 5 40 Td 7 Tr (Wa) Tj ET /Sh0 sh Q "
                    b"q BT /F1 40 Tf 0 0.5 0 rg 110 50 Td 4 Tr (x) Tj ET 0.9 0.6 0 rg 100 40 90 60 re f Q "
                    b"BT /F1 20 Tf 1 Tr 0 1 1 0 K 2 w 5 5 Td (st) Tj 2 Tr 0.5 g 0.2 G (fs) Tj ET",
                    mediabox=BOX, resources=res)


def text_in_forms_and_groups(P):
    """Text in a form, in a transparency group at ca 0.5, under Multiply,
    with a rotated Tm, and with a tiling pattern as its colour."""
    N = P.Name
    fonts = _helvetica(P)
    form = P.Stream({"Type": N("XObject"), "Subtype": N("Form"), "BBox": [0, 0, 200, 100], "Resources": fonts},
                    b"BT /F1 24 Tf 0 0 1 rg 10 60 Td (form) Tj ET")
    grp = P.Stream({"Type": N("XObject"), "Subtype": N("Form"), "BBox": [0, 0, 200, 100], "Resources": fonts,
                    "Group": {"Type": N("Group"), "S": N("Transparency")}},
                   b"0.9 0.9 0 rg 100 50 90 40 re f BT /F1 24 Tf 1 0 0 rg 105 60 Td (grp) Tj ET")
    cell = P.Stream({"Type": N("Pattern"), "PatternType": 1, "PaintType": 1, "TilingType": 1, "BBox": [0, 0, 6, 6],
                     "XStep": 6, "YStep": 6, "Resources": {}}, b"1 0 0 rg 0 0 3 3 re f 0 0 1 rg 3 3 3 3 re f")
    res = dict(fonts, XObject={"Fm": form, "Grp": grp}, Pattern={"T": cell},
               ExtGState={"Half": {"ca": 0.5}, "Mul": {"BM": N("Multiply")}})
    return P.mkpage(b"/Fm Do q /Half gs /Grp Do Q q /Mul gs BT /F1 30 Tf 0 1 0 rg 10 10 Td (mul) Tj ET Q "
                    b"BT /F1 20 Tf 0.707 0.707 -0.707 0.707 150 5 Tm (rot) Tj ET "
                    b"BT /Pattern cs /T scn /F1 36 Tf 60 5 Td (pat) Tj ET", mediabox=BOX, resources=res)


def malformed_operators(P):
    """Bad operands skip their operator and keep the rest of the run; an
    unreadable TrueType program falls back; an unknown font name shows
    through the fallback face."""
    N = P.Name
    bad = {"Type": N("Font"), "Subtype": N("TrueType"), "BaseFont": N("Broken"), "FirstChar": 65, "Widths": [600],
           "FontDescriptor": {"Type": N("FontDescriptor"), "FontFile2": P.Stream({}, b"\x00\x01\x00\x00junk")}}
    res = _helvetica(P)
    res["Font"]["F2"] = bad
    return P.mkpage(b"BT /F1 (x) Tf /F1 20 Tf 10 70 Td (a) Td (ok) Tj /F1 x Tz (ok) Tj [(k) /N (k)] TJ ET "
                    b"BT /F2 20 Tf 10 40 Td (AA) Tj /F9 20 Tf (zz) Tj ET", mediabox=BOX, resources=res)


PAGES = {f.__name__: f for f in (
    fallback_text, embedded_truetype_widths, type0_identity_h, tj_kerning_multiline, spacing_operators,
    render_mode_3,
    garbage_fontfile3, sticky_text_state, encoding_differences, text_fill_alpha, type0_identity_v, type0_w2,
    type0_embedded_cmap, clip_modes, text_in_forms_and_groups, malformed_operators)}
NO_FONT_PAGES = {f.__name__: f for f in (
    bare_cff_fontfile3, inline_image_named_colourspace, type1_fontfile, type3_stencil, type3_d0_colours,
    type3_widths, type3_unmapped_code)}


@needs_font
@pytest.mark.parametrize("scenario", list(PAGES))
def test_text_page_matches_jax(scenario, both_sides):
    got = parity(PAGES[scenario])
    assert any(p[2] is not None for p in got)


@pytest.mark.parametrize("scenario", list(NO_FONT_PAGES))
def test_embedded_font_page_matches_jax(scenario, both_sides):
    got = parity(NO_FONT_PAGES[scenario])
    assert any(p[2] is not None for p in got)


def test_encoding_differences_shows_the_named_glyph(both_sides):
    """The port paints code 65 under /Differences [65 /zero] as the glyph
    of 0, unlike the plain A (the JAX test's three renders)."""
    if DEJAVU is None:
        pytest.skip("no DejaVu installed")
    diff, plain, zero = parity(encoding_differences)
    assert diff[2] is not None and not np.array_equal(diff[2][1], plain[2][1])
    assert diff[2][0] == zero[2][0] and np.array_equal(diff[2][1], zero[2][1])


# --- the font parsers on the same programs -----------------------------------------


def _outlines(font, gids):
    return [(repr(font.glyph_segments(g)), font.advance(g)) for g in gids]


def test_truetype_outlines_match_jax():
    if DEJAVU is None:
        pytest.skip("no DejaVu installed")
    data = open(DEJAVU, "rb").read()
    j, t = j_tt.TrueTypeFont(data), t_tt.TrueTypeFont(data)
    cps = [ord(c) for c in "Aoé &g"] + [0x20AC]
    assert [t.gid_of_unicode(c) for c in cps] == [j.gid_of_unicode(c) for c in cps]
    gids = [t.gid_of_unicode(c) for c in cps]
    assert _outlines(t, gids) == _outlines(j, gids) and t.units_per_em == j.units_per_em
    assert t_tt.fallback_font_path("Times-Bold") == j_tt.fallback_font_path("Times-Bold")


def test_type2_charstrings_match_jax():
    import struct

    def num(v):
        return bytes([v + 139])

    box = (b"\x1c" + struct.pack(">h", 550) + num(100) + num(100) + b"\x15" + num(80) + b"\x06" + num(60) + b"\x07"
           + b"\x1c" + struct.pack(">h", -80) + b"\x06" + b"\x0e")
    flex1 = (num(0) + num(0) + b"\x15" + (num(2) + num(20)) * 5 + num(5) + b"\x0c\x25" + b"\x0e")
    data = _mk_min_cff([b"\x0e", box, flex1])
    j, t = j_cff.CFFFont(data), t_cff.CFFFont(data)
    assert _outlines(t, range(3)) == _outlines(j, range(3))
    assert [t.gid_of_name(n) for n in ("space", "exclam", "A")] == [j.gid_of_name(n) for n in ("space", "exclam", "A")]


@pytest.mark.parametrize("framing", ["pfa", "pfb", "hex"])
def test_type1_programs_match_jax(framing):
    """test_type1.py's programs: the square, a subr call with curves and a
    seac composite, framed as PFA, PFB and hex eexec."""
    sub = _cs(500, 0, OP["rlineto"], OP["return"])
    curve = _cs(0, 700, OP["hsbw"], 0, 0, OP["rmoveto"], 0, OP["callsubr"], 0, 100, 100, 0, 0, 100,
                OP["rrcurveto"], OP["closepath"], OP["endchar"])
    acute = _cs(50, 300, OP["hsbw"], 0, 700, OP["rmoveto"], 100, 0, OP["rlineto"], 0, 100, OP["rlineto"], -100, 0,
                OP["rlineto"], OP["closepath"], OP["endchar"])
    comp = _cs(50, 600, OP["hsbw"], 50, 250, 50, 97, 194, OP["seac"], OP["endchar"])
    glyphs = [(".notdef", NOTDEF), ("a", SQUARE), ("acute", acute), ("aacute", comp), ("g", curve)]
    program = _build_font(glyphs, subrs=[sub], encoding_puts=[(97, "a"), (98, "g")], pfb=framing == "pfb")
    if framing == "hex":
        i = program.find(b"eexec") + 5
        program = program[:i] + b"\n" + program[i:].lstrip(b"\n").hex().encode()
    j, t = j_t1.Type1Font(program), t_t1.Type1Font(program)
    gids = range(len(glyphs))
    assert _outlines(t, gids) == _outlines(j, gids) and t.units_per_em == j.units_per_em
    assert [t.gid_of_builtin_code(c) for c in b"abc"] == [j.gid_of_builtin_code(c) for c in b"abc"]
    assert len(t.glyph_segments(t.gid_of_name("aacute"))) == 2


def test_embedded_cmap_matches_jax():
    src = (b"/CIDInit /ProcSet findresource begin\n12 dict begin\nbegincmap\n/Identity-H usecmap\n"
           b"/CMapName /Custom-V def\n/WMode 1 def\n2 begincodespacerange\n<00> <7F>\n<8140> <9FFC>\n"
           b"endcodespacerange\n2 begincidrange\n<20> <7E> 1\n<8140> <817E> 633\nendcidrange\n1 begincidchar\n"
           b"<8230> 1000\nendcidchar\nendcmap\nCMapName currentdict /CMap defineresource pop\nend end")
    j, t = j_cmap.parse_cmap(src), t_cmap.parse_cmap(src)
    s = b"\x20\x81\x41\x7e\x82\x30\xbe\xef"
    assert t.wmode == j.wmode and t.split(s) == j.split(s)
    assert [t.cid(n, c) for n, c in t.split(s)] == [j.cid(n, c) for n, c in j.split(s)]


def test_afm_tables_match_jax():
    for name in j_afm._AFM_STEMS:
        assert t_afm.afm_widths(name) == j_afm.afm_widths(name), name
        for enc in (None, "WinAnsiEncoding", "MacRomanEncoding"):
            assert t_afm.code_widths(name, enc, {65: "emdash"}) == j_afm.code_widths(name, enc, {65: "emdash"})
    for alias in ("ABCDEF+Arial-BoldMT", "TimesNewRoman,Italic", "CourierNew", "Garamond"):
        assert t_afm.std14_name(alias) == j_afm.std14_name(alias)


@pytest.mark.parametrize("widths", [None, [600]])
def test_loaded_font_widths_match_jax(widths):
    """A standard font without /Widths takes the AFM advances; explicit
    /Widths win (test_afm_metrics.py's two font loads)."""
    got = []
    for P, text in ((TP, t_text), (JP, j_text)):
        fd = {"Type": P.Name("Font"), "Subtype": P.Name("Type1"), "BaseFont": P.Name("Helvetica")}
        if widths:
            fd.update(FirstChar=65, Widths=widths)
        lf = text._load_font(P.mkpage(b"", mediabox=(0, 0, 100, 100)), fd)
        got.append([lf.width_of_code(c) for c in (32, 65, 87, 109)])
    assert got[0] == got[1]


def test_text_trees_match_jax():
    """BT..ET runs, sticky state set outside a block, and a clip-mode run's
    TextClip: the same element trees (canon) on both sides."""
    content = (b"/F1 12 Tf 2 Tr 1 Tc BT 10 10 Td (a) Tj 0.5 g [(b) -20 (c)] TJ ET q BT 5 Tr (clip) Tj ET "
               b"0 0 10 10 re f Q BT (after) ' 1 2 (x) \" ET")
    trees = []
    for P, PG in ((JP, JPG), (TP, TPG)):
        pdf = P.mkpage(content, mediabox=BOX)
        trees.append(canon(PG.graphic_of_page(pdf, pdf.pages()[0]).elements))
    assert trees[0] == trees[1]
    names = repr(trees[1])
    assert "TextBlock" in names and "TextClip" in names and "TextAttributes" in names
