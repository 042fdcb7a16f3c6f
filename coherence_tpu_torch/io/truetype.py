"""Minimal TrueType outline parser: glyph id -> cubic-bezier Path segments.

The port's copy of ``coherence_tpu.io.truetype``, whole.

BEYOND REFERENCE: the reference captures PDF text runs into its graphic
tree (pdfgraphics.mli:134) but never rasterizes them — its text demos ship
pre-outlined paths.  Here embedded TrueType programs (FontFile2, and the
glyf side of OpenType) parse into the renderer's own Path structures so
text renders through the exact AA rasterizer like any other geometry
(scene/pdftext.py drives this).

Quadratic TrueType contours convert to the renderer's cubic beziers
exactly (a quadratic IS the cubic with control points at 1/3 blends).
Composite glyphs apply their component transforms; CFF-flavoured OpenType
('OTTO') raises ValueError so callers can fall back to a system face.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

__all__ = ["TrueTypeFont", "fallback_font_path"]

_ON_CURVE = 0x01
_X_SHORT = 0x02
_Y_SHORT = 0x04
_REPEAT = 0x08
_X_SAME_OR_POS = 0x10
_Y_SAME_OR_POS = 0x20

# composite flags
_ARGS_ARE_WORDS = 0x0001
_ARGS_ARE_XY = 0x0002
_WE_HAVE_A_SCALE = 0x0008
_MORE_COMPONENTS = 0x0020
_X_AND_Y_SCALE = 0x0040
_TWO_BY_TWO = 0x0080


def _u16(d, o):
    return struct.unpack_from(">H", d, o)[0]


def _i16(d, o):
    return struct.unpack_from(">h", d, o)[0]


def _u32(d, o):
    return struct.unpack_from(">I", d, o)[0]


class TrueTypeFont:
    """Parsed 'sfnt' with glyf outlines (TrueType / OpenType-with-glyf)."""

    def __init__(self, data: bytes):
        self.data = data
        tag = data[:4]
        if tag == b"ttcf":
            # Font collection: use the first face.
            off = _u32(data, 12)
            tag = data[off : off + 4]
            base = off
        else:
            base = 0
        if tag not in (b"\x00\x01\x00\x00", b"true", b"OTTO"):
            raise ValueError("not a TrueType/OpenType font")
        n = _u16(data, base + 4)
        self.tables: Dict[bytes, Tuple[int, int]] = {}
        for i in range(n):
            o = base + 12 + 16 * i
            self.tables[data[o : o + 4]] = (_u32(data, o + 8), _u32(data, o + 12))
        for need in (b"head", b"maxp"):
            if need not in self.tables:
                raise ValueError(f"missing {need.decode()} table")
        head, _ = self.tables[b"head"]
        self.units_per_em = _u16(data, head + 18) or 1000
        self.loca_long = _i16(data, head + 50) == 1
        maxp, _ = self.tables[b"maxp"]
        self.num_glyphs = _u16(data, maxp + 4)
        self.cff = None  # CFF-flavoured OpenType: outlines come from 'CFF '
        if b"glyf" in self.tables and b"loca" in self.tables:
            loca, _ = self.tables[b"loca"]
            if self.loca_long:
                self.loca = [
                    _u32(data, loca + 4 * i) for i in range(self.num_glyphs + 1)
                ]
            else:
                self.loca = [
                    _u16(data, loca + 2 * i) * 2
                    for i in range(self.num_glyphs + 1)
                ]
        elif b"CFF " in self.tables:
            from .cff import CFFFont

            off, ln = self.tables[b"CFF "]
            self.cff = CFFFont(data[off : off + ln])
        else:
            raise ValueError("no glyf or CFF outlines")
        self._advances = self._parse_hmtx()
        self._cmap = None  # lazy
        self._post_names: Optional[Dict[str, int]] = None  # lazy
        self._glyph_cache: Dict[int, List[List[Tuple]]] = {}

    # --- metrics -------------------------------------------------------------

    def _parse_hmtx(self) -> List[int]:
        if b"hhea" not in self.tables or b"hmtx" not in self.tables:
            return [self.units_per_em // 2] * self.num_glyphs
        hhea, _ = self.tables[b"hhea"]
        n_metrics = _u16(self.data, hhea + 34)
        hmtx, _ = self.tables[b"hmtx"]
        adv = []
        last = self.units_per_em // 2
        for i in range(self.num_glyphs):
            if i < n_metrics:
                last = _u16(self.data, hmtx + 4 * i)
            adv.append(last)
        return adv

    def advance(self, gid: int) -> int:
        """Horizontal advance in font units."""
        if 0 <= gid < len(self._advances):
            return self._advances[gid]
        return self.units_per_em // 2

    # --- cmap ----------------------------------------------------------------

    def _pick_cmap(self) -> Optional[int]:
        if b"cmap" not in self.tables:
            return None
        base, _ = self.tables[b"cmap"]
        d = self.data
        n = _u16(d, base + 2)
        best = None
        best_rank = -1
        for i in range(n):
            o = base + 4 + 8 * i
            plat, enc = _u16(d, o), _u16(d, o + 2)
            off = _u32(d, o + 4)
            rank = {
                (3, 10): 5, (0, 4): 5, (0, 6): 5,  # full unicode
                (3, 1): 4, (0, 3): 4, (0, 2): 3, (0, 1): 3, (0, 0): 3,
                (3, 0): 2,  # symbol
                (1, 0): 1,  # mac roman
            }.get((plat, enc), 0)
            if rank > best_rank:
                best_rank, best = rank, base + off
        return best

    def _load_cmap(self) -> Dict[int, int]:
        table = {}
        off = self._pick_cmap()
        if off is None:
            return table
        d = self.data
        fmt = _u16(d, off)
        if fmt == 0:
            for code in range(256):
                gid = d[off + 6 + code]
                if gid:
                    table[code] = gid
        elif fmt == 4:
            segs = _u16(d, off + 6) // 2
            ends = [_u16(d, off + 14 + 2 * i) for i in range(segs)]
            starts = [_u16(d, off + 16 + 2 * segs + 2 * i) for i in range(segs)]
            deltas = [_i16(d, off + 16 + 4 * segs + 2 * i) for i in range(segs)]
            range_off_base = off + 16 + 6 * segs
            for i in range(segs):
                ro = _u16(d, range_off_base + 2 * i)
                for code in range(starts[i], min(ends[i], 0xFFFF) + 1):
                    if ro == 0:
                        gid = (code + deltas[i]) & 0xFFFF
                    else:
                        gi = (
                            range_off_base
                            + 2 * i
                            + ro
                            + 2 * (code - starts[i])
                        )
                        if gi + 1 >= len(d):
                            continue
                        gid = _u16(d, gi)
                        if gid:
                            gid = (gid + deltas[i]) & 0xFFFF
                    if gid:
                        table[code] = gid
        elif fmt == 6:
            first = _u16(d, off + 6)
            count = _u16(d, off + 8)
            for i in range(count):
                gid = _u16(d, off + 10 + 2 * i)
                if gid:
                    table[first + i] = gid
        elif fmt == 12:
            n_groups = _u32(d, off + 12)
            budget = 0x110000  # total unicode space; bounds malformed groups
            for g in range(n_groups):
                o = off + 16 + 12 * g
                s, e, gid0 = _u32(d, o), _u32(d, o + 4), _u32(d, o + 8)
                e = min(e, s + budget - 1)
                for c in range(s, e + 1):
                    table[c] = gid0 + (c - s)
                budget -= e - s + 1
                if budget <= 0:
                    break
        return table

    def gid_of_unicode(self, cp: int) -> int:
        if self._cmap is None:
            self._cmap = self._load_cmap()
        gid = self._cmap.get(cp, 0)
        if gid == 0 and 0x20 <= cp < 0x100:
            # Symbol cmaps (3,0) shift the F0xx private area over ASCII.
            gid = self._cmap.get(0xF000 + cp, 0)
        return gid

    def gid_of_name(self, name: str) -> int:
        """Glyph-name lookup via the 'post' table (format 2), for PDF
        /Encoding /Differences on simple fonts; 0 when absent."""
        if self._post_names is None:
            self._post_names = self._load_post_names()
        return self._post_names.get(name, 0)

    def _load_post_names(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        if b"post" not in self.tables:
            return out
        off, ln = self.tables[b"post"]
        d = self.data
        if _u32(d, off) != 0x00020000:
            return out  # formats 1/3 carry no custom names
        n = _u16(d, off + 32)
        idx = [_u16(d, off + 34 + 2 * i) for i in range(min(n, self.num_glyphs))]
        names: List[str] = []
        p = off + 34 + 2 * n
        end = off + ln
        while p < end and len(names) < n:
            sl = d[p]
            names.append(d[p + 1 : p + 1 + sl].decode("latin1"))
            p += 1 + sl
        for gid, i in enumerate(idx):
            if i >= 258:
                k = i - 258
                if k < len(names) and names[k] not in out:
                    out[names[k]] = gid
            elif i < len(_MAC_GLYPH_NAMES):
                out.setdefault(_MAC_GLYPH_NAMES[i], gid)
        return out

    # --- outlines ------------------------------------------------------------

    def glyph_contours(self, gid: int, _depth: int = 0) -> List[List[Tuple]]:
        """List of contours, each a list of (x, y, on_curve) points in font
        units (composites resolved)."""
        if gid in self._glyph_cache:
            return self._glyph_cache[gid]
        if self.cff is not None or not (0 <= gid < self.num_glyphs) or _depth > 6:
            return []
        start, end = self.loca[gid], self.loca[gid + 1]
        if end <= start:
            self._glyph_cache[gid] = []
            return []
        glyf, _ = self.tables[b"glyf"]
        d = self.data
        o = glyf + start
        n_contours = _i16(d, o)
        if n_contours >= 0:
            out = self._simple_glyph(o, n_contours)
        else:
            out = self._composite_glyph(o + 10, _depth)
        self._glyph_cache[gid] = out
        return out

    def _simple_glyph(self, o: int, n_contours: int) -> List[List[Tuple]]:
        d = self.data
        ends = [_u16(d, o + 10 + 2 * i) for i in range(n_contours)]
        n_pts = (ends[-1] + 1) if ends else 0
        p = o + 10 + 2 * n_contours
        p += 2 + _u16(d, p)  # skip instructions
        flags = []
        while len(flags) < n_pts:
            f = d[p]
            p += 1
            flags.append(f)
            if f & _REPEAT:
                r = d[p]
                p += 1
                flags.extend([f] * r)
        flags = flags[:n_pts]
        xs: List[int] = []
        x = 0
        for f in flags:
            if f & _X_SHORT:
                dx = d[p]
                p += 1
                x += dx if f & _X_SAME_OR_POS else -dx
            elif not (f & _X_SAME_OR_POS):
                x += _i16(d, p)
                p += 2
            xs.append(x)
        ys: List[int] = []
        y = 0
        for f in flags:
            if f & _Y_SHORT:
                dy = d[p]
                p += 1
                y += dy if f & _Y_SAME_OR_POS else -dy
            elif not (f & _Y_SAME_OR_POS):
                y += _i16(d, p)
                p += 2
            ys.append(y)
        pts = [
            (float(xs[i]), float(ys[i]), bool(flags[i] & _ON_CURVE))
            for i in range(n_pts)
        ]
        out = []
        lo = 0
        for e in ends:
            c = pts[lo : e + 1]
            if len(c) >= 2:
                out.append(c)
            lo = e + 1
        return out

    def _composite_glyph(self, p: int, depth: int) -> List[List[Tuple]]:
        d = self.data
        out: List[List[Tuple]] = []
        while True:
            flags = _u16(d, p)
            sub_gid = _u16(d, p + 2)
            p += 4
            if flags & _ARGS_ARE_WORDS:
                a1, a2 = _i16(d, p), _i16(d, p + 2)
                p += 4
            else:
                a1 = struct.unpack_from(">b", d, p)[0]
                a2 = struct.unpack_from(">b", d, p + 1)[0]
                p += 2
            xx, xy, yx, yy = 1.0, 0.0, 0.0, 1.0
            if flags & _WE_HAVE_A_SCALE:
                xx = yy = _i16(d, p) / 16384.0
                p += 2
            elif flags & _X_AND_Y_SCALE:
                xx = _i16(d, p) / 16384.0
                yy = _i16(d, p + 2) / 16384.0
                p += 4
            elif flags & _TWO_BY_TWO:
                xx = _i16(d, p) / 16384.0
                xy = _i16(d, p + 2) / 16384.0
                yx = _i16(d, p + 4) / 16384.0
                yy = _i16(d, p + 6) / 16384.0
                p += 8
            dx, dy = (float(a1), float(a2)) if flags & _ARGS_ARE_XY else (0.0, 0.0)
            for c in self.glyph_contours(sub_gid, depth + 1):
                out.append(
                    [
                        (xx * x + yx * y + dx, xy * x + yy * y + dy, on)
                        for x, y, on in c
                    ]
                )
            if not (flags & _MORE_COMPONENTS):
                break
        return out

    def glyph_segments(self, gid: int):
        """List of closed segment loops (renderer Straight/Bezier objects)
        in font units — one loop per contour, nonzero winding."""
        if self.cff is not None:
            return self.cff.glyph_segments(gid)
        from ..geometry.path import Bezier, Straight

        loops = []
        for contour in self.glyph_contours(gid):
            pts = _insert_implied(contour)
            if len(pts) < 2:
                continue
            # Rotate so index 0 is on-curve (an implied point if needed).
            k = next((i for i, p in enumerate(pts) if p[2]), None)
            if k is None:
                continue
            pts = pts[k:] + pts[:k]
            segs = []
            i = 0
            n = len(pts)
            start = (pts[0][0], pts[0][1])
            cur = start
            while i < n:
                nxt = pts[(i + 1) % n]
                if nxt[2]:
                    b = (nxt[0], nxt[1])
                    if b != cur:
                        segs.append(Straight(cur, b))
                    cur = b
                    i += 1
                else:
                    endp = pts[(i + 2) % n]
                    q = (nxt[0], nxt[1])
                    b = (endp[0], endp[1])
                    # quadratic -> exact cubic (1/3 control blends)
                    c1 = (cur[0] + 2.0 * (q[0] - cur[0]) / 3.0,
                          cur[1] + 2.0 * (q[1] - cur[1]) / 3.0)
                    c2 = (b[0] + 2.0 * (q[0] - b[0]) / 3.0,
                          b[1] + 2.0 * (q[1] - b[1]) / 3.0)
                    segs.append(Bezier(cur, c1, c2, b))
                    cur = b
                    i += 2
            if segs:
                loops.append(segs)
        return loops


def _insert_implied(contour):
    """TrueType implied on-curve points at midpoints of consecutive
    off-curve pairs."""
    out = []
    n = len(contour)
    for i in range(n):
        x, y, on = contour[i]
        out.append((x, y, on))
        nx, ny, non = contour[(i + 1) % n]
        if not on and not non:
            out.append(((x + nx) / 2.0, (y + ny) / 2.0, True))
    return out


# Standard Macintosh glyph order ('post' format 2 indices 0-257).
_MAC_GLYPH_NAMES = (
    ".notdef .null nonmarkingreturn space exclam quotedbl numbersign dollar "
    "percent ampersand quotesingle parenleft parenright asterisk plus comma "
    "hyphen period slash zero one two three four five six seven eight nine "
    "colon semicolon less equal greater question at A B C D E F G H I J K L "
    "M N O P Q R S T U V W X Y Z bracketleft backslash bracketright "
    "asciicircum underscore grave a b c d e f g h i j k l m n o p q r s t u "
    "v w x y z braceleft bar braceright asciitilde Adieresis Aring Ccedilla "
    "Eacute Ntilde Odieresis Udieresis aacute agrave acircumflex adieresis "
    "atilde aring ccedilla eacute egrave ecircumflex edieresis iacute igrave "
    "icircumflex idieresis ntilde oacute ograve ocircumflex odieresis otilde "
    "uacute ugrave ucircumflex udieresis dagger degree cent sterling section "
    "bullet paragraph germandbls registered copyright trademark acute "
    "dieresis notequal AE Oslash infinity plusminus lessequal greaterequal "
    "yen mu partialdiff summation product pi integral ordfeminine "
    "ordmasculine Omega ae oslash questiondown exclamdown logicalnot radical "
    "florin approxequal Delta guillemotleft guillemotright ellipsis "
    "nonbreakingspace Agrave Atilde Otilde OE oe endash emdash quotedblleft "
    "quotedblright quoteleft quoteright divide lozenge ydieresis Ydieresis "
    "fraction currency guilsinglleft guilsinglright fi fl daggerdbl "
    "periodcentered quotesinglbase quotedblbase perthousand Acircumflex "
    "Ecircumflex Aacute Edieresis Egrave Iacute Icircumflex Idieresis Igrave "
    "Oacute Ocircumflex apple Ograve Uacute Ucircumflex Ugrave dotlessi "
    "circumflex tilde macron breve dotaccent ring cedilla hungarumlaut "
    "ogonek caron Lslash lslash Scaron scaron Zcaron zcaron brokenbar Eth "
    "eth Yacute yacute Thorn thorn minus multiply onesuperior twosuperior "
    "threesuperior onehalf onequarter threequarters franc Gbreve gbreve "
    "Idotaccent Scedilla scedilla Cacute cacute Ccaron ccaron dcroat"
).split()


_FALLBACKS = {
    ("serif", False, False): "DejaVuSerif.ttf",
    ("serif", True, False): "DejaVuSerif-Bold.ttf",
    ("serif", False, True): "DejaVuSerif-Italic.ttf",
    ("serif", True, True): "DejaVuSerif-BoldItalic.ttf",
    ("sans", False, False): "DejaVuSans.ttf",
    ("sans", True, False): "DejaVuSans-Bold.ttf",
    ("sans", False, True): "DejaVuSans-Oblique.ttf",
    ("sans", True, True): "DejaVuSans-BoldOblique.ttf",
    ("mono", False, False): "DejaVuSansMono.ttf",
    ("mono", True, False): "DejaVuSansMono-Bold.ttf",
    ("mono", False, True): "DejaVuSansMono-Oblique.ttf",
    ("mono", True, True): "DejaVuSansMono-BoldOblique.ttf",
}


def fallback_font_path(base_name: str) -> Optional[str]:
    """A DejaVu face for a non-embedded PDF base font (the standard-14
    names and friends), or None when no face is installed."""
    import os

    n = base_name.split("+")[-1].lower()  # strip subset prefix
    family = "sans"
    if "times" in n or "serif" in n or "georgia" in n or "roman" in n:
        family = "serif"
    if "courier" in n or "mono" in n or "consol" in n:
        family = "mono"
    bold = "bold" in n or "black" in n or "heavy" in n
    italic = "italic" in n or "oblique" in n
    fname = _FALLBACKS[(family, bold, italic)]
    for root in (
        "/usr/share/fonts/truetype/dejavu",
        _matplotlib_font_dir(),
    ):
        if root:
            p = os.path.join(root, fname)
            if os.path.exists(p):
                return p
    return None


def _matplotlib_font_dir() -> Optional[str]:
    import os

    try:
        import matplotlib

        return os.path.join(
            os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf"
        )
    except Exception:
        return None
