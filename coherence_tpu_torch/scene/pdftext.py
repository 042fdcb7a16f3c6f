"""PDF text rendering: TextBlock runs -> glyph-outline scene objects.

The port's copy of ``coherence_tpu.scene.pdftext``, with the device
threaded through: a Type 3 glyph is a content stream whose scene may hold a
soft mask or a tiling cell, and a run may be painted with a tiling pattern;
each renders a sub-scene on the ``device`` that ``text_objects_of_block``
and ``clip_path_of_block`` are given.  Malformed input (an unreadable font
program, a bad operand, a glyph that fails to convert) is skipped as in the
JAX package; a failed sub-render (``pdfscene.SubRenderError``) is raised.

BEYOND REFERENCE: the reference captures BT..ET runs into its graphic tree
(pdfgraphics.mli:134, TextBlock here) but ``Render.scene_of_graphic``
consumes paths and clips only (render.ml:1524-1565) — its text demos ship
pre-outlined paths.  Here text paints for real: embedded TrueType programs
(FontFile2 / CIDFontType2) parse into renderer Paths (io/truetype.py) and
every show operator becomes a nonzero-winding filled object through the
exact AA rasterizer; non-embedded and CFF faces fall back to installed
DejaVu equivalents of the standard-14 names.

Layout follows PDF 9.4: the text/line matrix pair (Tm/Td/TD/T*/TL), spacing
parameters (Tc/Tw/Tz/Ts), per-code widths from /Widths (simple fonts) or
/W + /DW (Type0/Identity-H), and TJ kern adjustments.  Render modes: fill
modes paint with the nonstroke colour captured at the op, stroke-only
paints with the stroke colour (outline-stroking approximated by a fill),
mode 3/7 shows nothing but still advances.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

from .. import ident
from .. import transform as tr
from ..geometry.path import NONZERO, Path, Subpath
from ..io import pdf as P
from ..io import pdfgraphics as PG
from ..io import truetype as TT
from . import pdfscene
from . import render as R

__all__ = ["text_objects_of_block"]


# Latin-1 covers the printable range of both StandardEncoding and
# WinAnsiEncoding except a handful of punctuation; map the differences.
_WINANSI_FIXUPS = {
    0x80: 0x20AC, 0x82: 0x201A, 0x83: 0x0192, 0x84: 0x201E, 0x85: 0x2026,
    0x86: 0x2020, 0x87: 0x2021, 0x88: 0x02C6, 0x89: 0x2030, 0x8A: 0x0160,
    0x8B: 0x2039, 0x8C: 0x0152, 0x91: 0x2018, 0x92: 0x2019, 0x93: 0x201C,
    0x94: 0x201D, 0x95: 0x2022, 0x96: 0x2013, 0x97: 0x2014, 0x98: 0x02DC,
    0x99: 0x2122, 0x9A: 0x0161, 0x9B: 0x203A, 0x9C: 0x0153, 0x9F: 0x0178,
}


def _unicode_of_code(code: int) -> int:
    return _WINANSI_FIXUPS.get(code, code)


def _unicode_of_glyph_name(name: str) -> int:
    """Best-effort glyph-name -> unicode: uniXXXX/uXXXX forms, single-char
    names, and the standard latin names (inverted from io/cff's table)."""
    if name.startswith("uni") and len(name) >= 7:
        try:
            return int(name[3:7], 16)
        except ValueError:
            return 0
    if name.startswith("u") and 5 <= len(name) <= 7:
        try:
            return int(name[1:], 16)
        except ValueError:
            pass
    if len(name) == 1:
        return ord(name)
    from ..io.cff import _UNI_TO_NAME

    for cp, nm in _UNI_TO_NAME.items():
        if nm == name:
            return cp
    return 0


class _LoadedFont:
    """A PDF font resource resolved to outlines + widths."""

    def __init__(self):
        self.ttf: Optional[TT.TrueTypeFont] = None
        self.two_byte = False  # Type0 Identity-H: 2-byte codes
        self.widths: Dict[int, float] = {}  # code -> text-space width (/1000)
        self.default_width: Optional[float] = None
        # Vertical writing (PDF 9.7.4.3): a -V CMap selects WMode 1.
        self.vertical = False
        self.dw2 = (0.88, -1.0)  # /DW2 default [880 -1000] (/1000)
        self.w2: Dict[int, Tuple[float, float, float]] = {}  # cid -> w1,vx,vy
        # Embedded CMap stream (PDF 9.7.5.3): variable-length code -> CID.
        self.cmap = None
        self.cid_to_gid: Optional[bytes] = None  # CIDToGIDMap stream data
        self.differences: Dict[int, str] = {}  # /Encoding /Differences
        # Type 3 fonts (PDF 9.6.4): glyphs are content streams.
        self.type3 = False
        self.fontmatrix = (0.001, 0.0, 0.0, 0.001, 0.0, 0.0)
        self.charprocs: Dict[str, object] = {}  # glyph name -> Stream
        self.t3_resources: dict = {}

    def codes_of_bytes(self, s: bytes) -> List[int]:
        if self.cmap is not None:
            # Embedded CMap: codespace-driven splitting, codes -> CIDs.
            return [self.cmap.cid(n, c) for n, c in self.cmap.split(s)]
        if not self.two_byte:
            return list(s)
        return [
            (s[i] << 8) | (s[i + 1] if i + 1 < len(s) else 0)
            for i in range(0, len(s), 2)
        ]

    def gid_of_code(self, code: int) -> int:
        if self.ttf is None:
            return 0
        if self.two_byte:
            if self.cid_to_gid is not None:
                o = 2 * code
                if o + 1 < len(self.cid_to_gid):
                    return (self.cid_to_gid[o] << 8) | self.cid_to_gid[o + 1]
                return 0
            return code  # Identity CIDToGIDMap
        name = self.differences.get(code)
        if name is not None:
            by_name = getattr(self.ttf, "gid_of_name", None)
            if by_name is not None:
                gid = by_name(name)
                if gid:
                    return gid
            cp = _unicode_of_glyph_name(name)
            return self.ttf.gid_of_unicode(cp) if cp else 0
        by_code = getattr(self.ttf, "gid_of_builtin_code", None)
        if by_code is not None:
            # Type 1 faces carry their own /Encoding (PDF 9.6.6.2: the
            # builtin encoding applies when no /Differences override).
            gid = by_code(code)
            if gid:
                return gid
        return self.ttf.gid_of_unicode(_unicode_of_code(code))

    def width_of_code(self, code: int) -> float:
        """Text-space width (glyph units / 1000 convention)."""
        w = self.widths.get(code)
        if w is not None:
            return w
        if self.default_width is not None:
            return self.default_width
        if self.ttf is not None:
            return self.ttf.advance(self.gid_of_code(code)) / self.ttf.units_per_em
        return 0.5

    def vmetrics_of_code(self, code: int) -> Tuple[float, float, float]:
        """Vertical displacement w1 and position vector (vx, vy), all in
        text space (PDF 9.7.4.3: defaults vx = w0/2, vy = DW2[0],
        w1 = DW2[1])."""
        got = self.w2.get(code)
        if got is not None:
            return got
        return (self.dw2[1], self.width_of_code(code) / 2.0, self.dw2[0])


def _font_file(pdf, descriptor) -> Optional[TT.TrueTypeFont]:
    if not isinstance(descriptor, dict):
        return None
    for key in ("FontFile2", "FontFile3", "FontFile"):
        ff = pdf.resolve(descriptor.get(key)) if pdf else descriptor.get(key)
        if isinstance(ff, P.Stream):
            try:
                data = ff.decode()
            except Exception:
                return None
            try:
                return TT.TrueTypeFont(data)
            except Exception:
                pass
            try:  # bare CFF (FontFile3 Type1C / CIDFontType0C)
                from ..io.cff import CFFFont

                return CFFFont(data)
            except Exception:
                pass
            try:  # classic Type 1 (FontFile: PFB/PFA eexec programs)
                from ..io.type1 import Type1Font

                return Type1Font(data)
            except Exception:
                return None
    return None


_FALLBACK_CACHE: Dict[str, Optional[TT.TrueTypeFont]] = {}


def _fallback(base_font) -> Optional[TT.TrueTypeFont]:
    name = base_font.v if isinstance(base_font, P.Name) else str(base_font or "")
    p = TT.fallback_font_path(name or "Helvetica")
    if p is None:
        return None
    if p not in _FALLBACK_CACHE:
        try:
            with open(p, "rb") as fh:
                _FALLBACK_CACHE[p] = TT.TrueTypeFont(fh.read())
        except Exception:
            _FALLBACK_CACHE[p] = None
    return _FALLBACK_CACHE[p]


def _load_font(pdf, fd: dict) -> _LoadedFont:
    res = pdf.resolve if pdf is not None else (lambda o: o)
    lf = _LoadedFont()
    subtype = res(fd.get("Subtype"))
    subtype = subtype.v if isinstance(subtype, P.Name) else ""
    if subtype == "Type0":
        lf.two_byte = True  # Identity-H/V is the overwhelmingly common case
        enc0 = res(fd.get("Encoding"))
        if isinstance(enc0, P.Stream):
            # Embedded CMap stream (PDF 9.7.5.3; BEYOND REFERENCE).
            from ..io import cmap as CM

            try:
                lf.cmap = CM.parse_cmap(enc0.decode())
                lf.vertical = lf.cmap.wmode == 1
            except Exception:
                lf.cmap = None
        else:
            encname = enc0.v if isinstance(enc0, P.Name) else ""
            # Predefined -V CMaps (Identity-V, UniJIS-*-V, ...) = WMode 1.
            lf.vertical = encname.endswith("-V")
        desc = res(fd.get("DescendantFonts"))
        child = res(desc[0]) if isinstance(desc, list) and desc else {}
        if isinstance(child, dict):
            lf.ttf = _font_file(pdf, res(child.get("FontDescriptor")))
            c2g = res(child.get("CIDToGIDMap"))
            if isinstance(c2g, P.Stream):
                lf.cid_to_gid = c2g.decode()
            dw = res(child.get("DW", 1000))
            lf.default_width = float(dw) / 1000.0
            w = res(child.get("W"))
            if isinstance(w, list):
                i = 0
                while i < len(w):
                    c = int(res(w[i]))
                    nxt = res(w[i + 1]) if i + 1 < len(w) else None
                    if isinstance(nxt, list):
                        for j, wv in enumerate(nxt):
                            lf.widths[c + j] = float(res(wv)) / 1000.0
                        i += 2
                    elif nxt is not None and i + 2 < len(w):
                        c2 = int(nxt)
                        wv = float(res(w[i + 2])) / 1000.0
                        for cc in range(c, c2 + 1):
                            lf.widths[cc] = wv
                        i += 3
                    else:
                        break
            dw2 = res(child.get("DW2"))
            if isinstance(dw2, list) and len(dw2) >= 2:
                lf.dw2 = (float(res(dw2[0])) / 1000.0,
                          float(res(dw2[1])) / 1000.0)
            w2 = res(child.get("W2"))
            if isinstance(w2, list):
                # c [w1 vx vy ...]  or  c1 c2 w1 vx vy  (PDF 9.7.4.3)
                i = 0
                while i < len(w2):
                    c = int(res(w2[i]))
                    nxt = res(w2[i + 1]) if i + 1 < len(w2) else None
                    if isinstance(nxt, list):
                        for j in range(0, len(nxt) - 2, 3):
                            lf.w2[c + j // 3] = tuple(
                                float(res(nxt[j + k])) / 1000.0
                                for k in range(3)
                            )
                        i += 2
                    elif nxt is not None and i + 4 < len(w2):
                        c2 = int(nxt)
                        trip = tuple(
                            float(res(w2[i + 2 + k])) / 1000.0
                            for k in range(3)
                        )
                        for cc in range(c, c2 + 1):
                            lf.w2[cc] = trip
                        i += 5
                    else:
                        break
        if lf.ttf is None:
            lf.ttf = _fallback(res(fd.get("BaseFont")))
            # Fallback faces index by unicode, not CID: treat 2-byte codes
            # as unicode code points (right for Identity + ToUnicode-free
            # latin text; wrong glyphs beat no glyphs).
            lf.cid_to_gid = None
            if lf.ttf is not None:
                lf.gid_of_code = lambda code: lf.ttf.gid_of_unicode(code)  # type: ignore
        else:
            cid_cff = getattr(lf.ttf, "is_cid", False) or getattr(
                getattr(lf.ttf, "cff", None), "is_cid", False
            )
            if cid_cff and lf.cid_to_gid is None:
                # CID-keyed CFF: the charset maps CID -> gid.
                cf = lf.ttf if getattr(lf.ttf, "is_cid", False) else lf.ttf.cff
                lf.gid_of_code = cf.gid_of_cid  # type: ignore
        return lf
    if subtype == "Type3":
        # BEYOND REFERENCE: Type 3 glyphs are content streams (PDF 9.6.4)
        # interpreted through the same _process machinery as pages; the
        # reference captures TextBlocks but never rasterizes any font.
        lf.type3 = True
        fm = res(fd.get("FontMatrix"))
        if isinstance(fm, list) and len(fm) == 6:
            lf.fontmatrix = tuple(float(res(v)) for v in fm)
        cp = res(fd.get("CharProcs"))
        if isinstance(cp, dict):
            for k, v in cp.items():
                proc = res(v)
                if isinstance(proc, P.Stream):
                    lf.charprocs[k] = proc
        t3res = res(fd.get("Resources"))
        lf.t3_resources = t3res if isinstance(t3res, dict) else {}
        enc = res(fd.get("Encoding"))
        if isinstance(enc, dict):
            diffs = res(enc.get("Differences"))
            if isinstance(diffs, list):
                code = 0
                for item in diffs:
                    item = res(item)
                    if isinstance(item, (int, float)):
                        code = int(item)
                    elif isinstance(item, P.Name):
                        lf.differences[code] = item.v
                        code += 1
        # /Widths are in GLYPH space: advance = x of (w, 0) under the
        # FontMatrix linear part.
        fc = res(fd.get("FirstChar"))
        widths = res(fd.get("Widths"))
        if isinstance(widths, list) and isinstance(fc, int):
            for i, w in enumerate(widths):
                lf.widths[fc + i] = float(res(w)) * lf.fontmatrix[0]
        lf.default_width = 0.0
        return lf
    # Simple font (Type1 / TrueType / MMType1).
    lf.ttf = _font_file(pdf, res(fd.get("FontDescriptor")))
    embedded = lf.ttf is not None
    if lf.ttf is None:
        lf.ttf = _fallback(res(fd.get("BaseFont")))
    enc = res(fd.get("Encoding"))
    if isinstance(enc, dict):
        diffs = res(enc.get("Differences"))
        if isinstance(diffs, list):
            code = 0
            for item in diffs:
                item = res(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                elif isinstance(item, P.Name):
                    lf.differences[code] = item.v
                    code += 1
    fc = res(fd.get("FirstChar"))
    widths = res(fd.get("Widths"))
    if isinstance(widths, list) and isinstance(fc, int):
        for i, w in enumerate(widths):
            lf.widths[fc + i] = float(res(w)) / 1000.0
    if not embedded and not lf.widths:
        # A standard-14 base font may omit /Widths (PDF 9.6.2.2): take the
        # exact advances from the AFM metrics rather than the fallback
        # face's own (io/afm.py; BEYOND REFERENCE).
        from ..io import afm as _afm

        base = res(fd.get("BaseFont"))
        base = base.v if isinstance(base, P.Name) else str(base or "")
        encname = enc.v if isinstance(enc, P.Name) else (
            getattr(res(enc.get("BaseEncoding")), "v", None)
            if isinstance(enc, dict)
            else None
        )
        got = _afm.code_widths(base, encname, lf.differences)
        if got:
            lf.widths.update(got)
    return lf


def _get_font(pdf, resources, name: str) -> Optional[_LoadedFont]:
    res = pdf.resolve if pdf is not None else (lambda o: o)
    fonts = res(resources.get("Font", {})) if isinstance(resources, dict) else {}
    fd = res(fonts.get(name)) if isinstance(fonts, dict) else None
    if not isinstance(fd, dict):
        lf = _LoadedFont()
        lf.ttf = _fallback(None)
        from ..io import afm as _afm

        got = _afm.code_widths("Helvetica", None, {})
        if got:
            lf.widths.update(got)
        return lf
    cache = getattr(pdf, "_font_cache", None) if pdf is not None else None
    if cache is None and pdf is not None:
        cache = pdf._font_cache = {}
    key = id(fd)
    if cache is not None and key in cache:
        return cache[key]
    lf = _load_font(pdf, fd)
    if cache is not None:
        cache[key] = lf
    return lf


def _glyph_path(lf: _LoadedFont, code: int, trm) -> Optional[Path]:
    gid = lf.gid_of_code(code)
    if not gid or lf.ttf is None:
        return None
    loops = lf.ttf.glyph_segments(gid)
    if not loops:
        return None
    upem = float(lf.ttf.units_per_em)
    a, b, c, d, e, f = trm

    def xf(p):
        x, y = p[0] / upem, p[1] / upem
        return (a * x + c * y + e, b * x + d * y + f)

    from ..geometry.path import Bezier, Straight

    subpaths = []
    for loop in loops:
        segs = []
        for s in loop:
            if isinstance(s, Straight):
                segs.append(Straight(xf(s.a), xf(s.b)))
            else:
                segs.append(Bezier(xf(s.p1), xf(s.p2), xf(s.p3), xf(s.p4)))
        subpaths.append(Subpath(False, True, tuple(segs)))
    return Path(NONZERO, tuple(subpaths))


# A d1 prelude (wx wy llx lly urx ury d1) marks a stencil glyph: colour
# operators inside are ignored and the glyph paints with the text colour
# (PDF 9.6.4).  d0 glyphs keep their own colours.
_D1_RE = re.compile(rb"^\s*(?:[-+0-9.eE]+\s+){6}d1(?:\s|$)")


def _stencil_elements(elements, colour):
    """Rewrite every painted colour to the show-time text colour."""
    out = []
    for el in elements:
        if isinstance(el, PG.GPath):
            a = el.attributes
            out.append(
                PG.GPath(
                    el.path,
                    replace(
                        a,
                        path_fill=colour if a.path_fill is not None else None,
                        path_line=colour if a.path_line is not None else None,
                    ),
                )
            )
        elif isinstance(el, PG.Clip):
            out.append(PG.Clip(el.path, _stencil_elements(el.elements, colour)))
        elif isinstance(el, PG.MCSection):
            out.append(PG.MCSection(el.name, _stencil_elements(el.elements, colour)))
        else:
            out.append(el)
    return out


def _type3_glyph_objects(pdf, lf: _LoadedFont, proc, trm, colour, attrs, device) -> list:
    """Scene objects for one Type 3 glyph: interpret its CharProc content
    stream with ctm = trm . FontMatrix through the page machinery."""
    try:
        content = proc.decode()
    except Exception:
        return []
    gs = PG._GState(ctm=tuple(tr.matmul(trm, lf.fontmatrix)))
    gs.ca = float(attrs.fill_alpha)
    gs.CA = float(attrs.stroke_alpha)
    if colour is not None:
        gs.fill = colour
        gs.stroke = colour
    try:
        elements = PG._process(pdf, content, lf.t3_resources, gs)
    except Exception:
        return []
    if colour is not None and _D1_RE.match(content):
        elements = _stencil_elements(elements, colour)
    try:
        return pdfscene.scene_of_graphic(
            pdf, PG.Graphic(elements, lf.t3_resources), device
        )
    except pdfscene.SubRenderError:
        raise
    except Exception:
        return []


def text_objects_of_block(pdf, el: PG.TextBlock, clips=(), clip_sink=None, device=None) -> List[R.Obj]:
    """Scene objects painting a TextBlock's show operators.  ``clips`` is
    the active clip-path stack, intersected into each run's glyph shape.
    When ``clip_sink`` is a list, glyph subpaths of clip-mode runs
    (Tr 4-7) are appended to it (PDF 9.3.5 text clipping).  Sub-scenes
    (Type 3 glyphs' soft masks and tiling cells, tiling-pattern text
    colours) render on `device`."""
    res = pdf.resolve if pdf is not None else (lambda o: o)
    resources = res(el.resources) if el.resources is not None else {}
    ctm = tuple(float(v) for v in el.transform)
    tm = lm = tr.IDENTITY_MATRIX
    font: Optional[_LoadedFont] = None
    size = 0.0
    tc = tw = 0.0
    th = 1.0  # Tz / 100
    rise = 0.0
    tl = 0.0
    out: List[R.Obj] = []

    def show(s: bytes, attrs: PG.TextAttributes):
        nonlocal tm
        if font is None:
            return
        mode = attrs.textmode % 4  # clip variants 4-7 paint like 0-3
        colour = attrs.fill if mode in (0, 2) else attrs.stroke
        if font.type3:
            for code in font.codes_of_bytes(s):
                if mode != 3 and size != 0.0:
                    name = font.differences.get(code)
                    proc = font.charprocs.get(name) if name is not None else None
                    if proc is not None:
                        params = (size * th, 0.0, 0.0, size, 0.0, rise)
                        trm = tr.matmul(ctm, tr.matmul(tm, params))
                        out.extend(
                            _type3_glyph_objects(pdf, font, proc, trm, colour, attrs, device)
                        )
                pad = tw if (code == 32 and not font.two_byte) else 0.0
                tx = (font.width_of_code(code) * size + tc + pad) * th
                tm = tr.matmul(tm, (1.0, 0.0, 0.0, 1.0, tx, 0.0))
            return
        subpaths = []
        clip_run = attrs.textmode >= 4 and clip_sink is not None
        for code in font.codes_of_bytes(s):
            w0 = font.width_of_code(code)
            if font.vertical:
                w1, vx, vy = font.vmetrics_of_code(code)
            if (mode != 3 or clip_run) and size != 0.0:
                # glyph space -> text space -> user space (PDF 9.4.4).
                params = (size * th, 0.0, 0.0, size, 0.0, rise)
                if font.vertical:
                    # WMode 1: the glyph origin is displaced by the
                    # position vector v (PDF 9.7.4.3 / 9.4.4).
                    params = tr.matmul(params, (1.0, 0.0, 0.0, 1.0, -vx, -vy))
                trm = tr.matmul(ctm, tr.matmul(tm, params))
                gp = _glyph_path(font, code, trm)
                if gp is not None:
                    if mode != 3:
                        subpaths.extend(gp.subpaths)
                    if clip_run:
                        clip_sink.extend(gp.subpaths)
            pad = tw if (code == 32 and not font.two_byte) else 0.0
            if font.vertical:
                # Advance along -y; Tz scales horizontal writing only.
                ty = w1 * size + tc + pad
                tm = tr.matmul(tm, (1.0, 0.0, 0.0, 1.0, 0.0, ty))
            else:
                tx = (w0 * size + tc + pad) * th
                tm = tr.matmul(tm, (1.0, 0.0, 0.0, 1.0, tx, 0.0))
        if subpaths and colour is not None and mode != 3:
            cs, vals = colour
            alpha = attrs.fill_alpha if mode in (0, 2) else attrs.stroke_alpha
            fill = pdfscene.fill_of_pdf_colour(vals, float(alpha), cs, device)
            run_path = Path(NONZERO, tuple(subpaths))
            shape = pdfscene.clipped_shape(
                R.PathShape(run_path), clips, pdfscene._path_bbox(run_path)
            )
            out.append(
                pdfscene.blend_wrap(
                    R.Obj(
                        ident.new_ids(),
                        R.Basic(fill, shape),
                        (),
                        R.OVER,
                    ),
                    getattr(attrs, "blend", "Normal"),
                )
            )

    def next_line(tx: float, ty: float):
        nonlocal tm, lm
        lm = tr.matmul(lm, (1.0, 0.0, 0.0, 1.0, tx, ty))
        tm = lm

    for attrs, (op, operands) in el.blocks:
        try:
            if op == "Tf" and len(operands) >= 2:
                name = operands[-2]
                size = float(res(operands[-1]))
                font = _get_font(
                    pdf, resources, name.v if isinstance(name, P.Name) else str(name)
                )
            elif op == "Tm" and len(operands) >= 6:
                tm = lm = tuple(float(res(v)) for v in operands[-6:])
            elif op == "Td" and len(operands) >= 2:
                next_line(float(res(operands[-2])), float(res(operands[-1])))
            elif op == "TD" and len(operands) >= 2:
                tl = -float(res(operands[-1]))
                next_line(float(res(operands[-2])), float(res(operands[-1])))
            elif op == "T*":
                next_line(0.0, -tl)
            elif op == "TL" and operands:
                tl = float(res(operands[-1]))
            elif op == "Tc" and operands:
                tc = float(res(operands[-1]))
            elif op == "Tw" and operands:
                tw = float(res(operands[-1]))
            elif op == "Tz" and operands:
                th = float(res(operands[-1])) / 100.0
            elif op == "Ts" and operands:
                rise = float(res(operands[-1]))
            elif op == "Tj" and operands and isinstance(operands[-1], bytes):
                show(operands[-1], attrs)
            elif op == "'" and operands and isinstance(operands[-1], bytes):
                next_line(0.0, -tl)
                show(operands[-1], attrs)
            elif op == '"' and len(operands) >= 3:
                tw = float(res(operands[-3]))
                tc = float(res(operands[-2]))
                next_line(0.0, -tl)
                if isinstance(operands[-1], bytes):
                    show(operands[-1], attrs)
            elif op == "TJ" and operands and isinstance(operands[-1], list):
                for item in operands[-1]:
                    item = res(item)
                    if isinstance(item, bytes):
                        show(item, attrs)
                    elif isinstance(item, (int, float)):
                        if font is not None and font.vertical:
                            ty = -float(item) / 1000.0 * size
                            tm = tr.matmul(tm, (1.0, 0.0, 0.0, 1.0, 0.0, ty))
                        else:
                            tx = -float(item) / 1000.0 * size * th
                            tm = tr.matmul(tm, (1.0, 0.0, 0.0, 1.0, tx, 0.0))
        except pdfscene.SubRenderError:
            raise
        except Exception:
            continue  # malformed operator: skip, keep the rest of the run
    return out


def clip_path_of_block(pdf, el: PG.TextBlock, device=None):
    """Union of glyph outlines of a block's clip-mode runs (Tr 4-7), as a
    nonzero path for the clip stack, or None (PDF 9.3.5; Type 3 clip runs
    are not collected — their glyphs are content streams, not outlines)."""
    sink: list = []
    text_objects_of_block(pdf, el, clip_sink=sink, device=device)
    if not sink:
        return None
    return Path(NONZERO, tuple(sink))
