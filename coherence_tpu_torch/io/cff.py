"""CFF / Type2 charstring outlines: glyph id -> renderer Path segments.

The port's copy of ``coherence_tpu.io.cff``, whole.

BEYOND REFERENCE: completes scene/pdftext.py's font coverage — PDF
FontFile3 programs (Subtype Type1C / CIDFontType0C) and CFF-flavoured
OpenType ('OTTO', via io/truetype extracting the 'CFF ' table) carry
PostScript Type2 charstrings, which the reference never rasterizes.
The interpreter executes the path-construction subset (moveto/lineto/
curveto families, flex ops, local/global subrs with bias, seac-style
endchar accents, hint ops skipped with correct hintmask arithmetic) and
emits closed contours of Straight/cubic-Bezier segments in font units
(FontMatrix-scaled em, 1000 by default).

Glyph lookup: charset maps gid -> name (simple fonts) or gid -> CID
(CID-keyed fonts); `gid_of_unicode` goes unicode -> standard glyph name
-> gid for the latin set, enough for the PDF simple-font encodings.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

__all__ = ["CFFFont"]

_STD_STRINGS_LATIN = (
    ".notdef space exclam quotedbl numbersign dollar percent ampersand "
    "quoteright parenleft parenright asterisk plus comma hyphen period "
    "slash zero one two three four five six seven eight nine colon "
    "semicolon less equal greater question at A B C D E F G H I J K L M N "
    "O P Q R S T U V W X Y Z bracketleft backslash bracketright "
    "asciicircum underscore quoteleft a b c d e f g h i j k l m n o p q r "
    "s t u v w x y z braceleft bar braceright asciitilde"
).split()
# Standard-strings SIDs 0..95 are exactly the list above; the full table
# runs to 390 but the latin set is what PDF simple-font text needs.

_UNI_TO_NAME = {}
for _i, _n in enumerate(_STD_STRINGS_LATIN):
    if _i == 0:
        continue
    _UNI_TO_NAME[0x20 + (_i - 1)] = _n
_UNI_TO_NAME[0x27] = "quotesingle"
_UNI_TO_NAME[0x60] = "grave"
_UNI_TO_NAME[0x2019] = "quoteright"
_UNI_TO_NAME[0x2018] = "quoteleft"


def _u8(d, o):
    return d[o]


def _u16(d, o):
    return struct.unpack_from(">H", d, o)[0]


def _u24(d, o):
    return (d[o] << 16) | (d[o + 1] << 8) | d[o + 2]


def _u32(d, o):
    return struct.unpack_from(">I", d, o)[0]


_OFFREAD = {1: _u8, 2: _u16, 3: _u24, 4: _u32}


def _index(d: bytes, o: int) -> Tuple[List[bytes], int]:
    """CFF INDEX at offset o -> (items, offset past the INDEX)."""
    count = _u16(d, o)
    if count == 0:
        return [], o + 2
    osz = d[o + 2]
    rd = _OFFREAD[osz]
    offs = [rd(d, o + 3 + i * osz) for i in range(count + 1)]
    data0 = o + 3 + (count + 1) * osz - 1
    items = [d[data0 + offs[i] : data0 + offs[i + 1]] for i in range(count)]
    return items, data0 + offs[count]


def _dict(data: bytes) -> Dict[int, list]:
    """CFF DICT: operator (op or 0x0c00|op) -> operand list."""
    out: Dict[int, list] = {}
    operands: list = []
    i = 0
    n = len(data)
    while i < n:
        b0 = data[i]
        if b0 <= 21:
            op = b0
            i += 1
            if b0 == 12:
                op = 0x0C00 | data[i]
                i += 1
            out[op] = operands
            operands = []
        elif b0 == 28:
            operands.append(struct.unpack_from(">h", data, i + 1)[0])
            i += 3
        elif b0 == 29:
            operands.append(struct.unpack_from(">i", data, i + 1)[0])
            i += 5
        elif b0 == 30:  # real number (BCD)
            s = ""
            i += 1
            done = False
            while i < n and not done:
                for nib in (data[i] >> 4, data[i] & 15):
                    if nib <= 9:
                        s += str(nib)
                    elif nib == 10:
                        s += "."
                    elif nib == 11:
                        s += "E"
                    elif nib == 12:
                        s += "E-"
                    elif nib == 14:
                        s += "-"
                    elif nib == 15:
                        done = True
                        break
                i += 1
            try:
                operands.append(float(s or "0"))
            except ValueError:
                operands.append(0.0)
        elif 32 <= b0 <= 246:
            operands.append(b0 - 139)
            i += 1
        elif 247 <= b0 <= 250:
            operands.append((b0 - 247) * 256 + data[i + 1] + 108)
            i += 2
        elif 251 <= b0 <= 254:
            operands.append(-(b0 - 251) * 256 - data[i + 1] - 108)
            i += 2
        else:
            i += 1
    return out


def _bias(subrs) -> int:
    n = len(subrs)
    return 107 if n < 1240 else (1131 if n < 33900 else 32768)


class CFFFont:
    """Parsed CFF with Type2 charstrings (bare CFF or PDF FontFile3)."""

    def __init__(self, data: bytes):
        self.data = data
        hdr_size = data[2]
        o = hdr_size
        _names, o = _index(data, o)
        top_dicts, o = _index(data, o)
        self.strings, o = _index(data, o)
        self.gsubrs, o = _index(data, o)
        if not top_dicts:
            raise ValueError("empty CFF Top DICT")
        top = _dict(top_dicts[0])
        cs_off = int(top.get(17, [0])[0])
        if not cs_off:
            raise ValueError("CFF without CharStrings")
        self.charstrings, _ = _index(data, cs_off)
        self.num_glyphs = len(self.charstrings)
        fm = top.get(0x0C07)
        # FontMatrix default 0.001: em = 1/scale.
        scale = float(fm[0]) if fm and fm[0] else 0.001
        self.units_per_em = int(round(1.0 / scale)) if scale else 1000
        self.is_cid = 0x0C1E in top  # ROS
        # Private DICT (+ local subrs); CID fonts use per-FD privates.
        self.subrs: List[bytes] = []
        self.nominal_width = 0.0
        self.default_width = 0.0
        self._fd_select: Optional[List[int]] = None
        self._fd_privates: List[Tuple[List[bytes], float, float]] = []
        priv = top.get(18)
        if priv and len(priv) >= 2:
            self.subrs, self.nominal_width, self.default_width = (
                self._private(int(priv[1]), int(priv[0]))
            )
        if self.is_cid:
            self._parse_cid(top)
        self._charset = self._parse_charset(top)
        self._cid_to_gid: Optional[Dict[int, int]] = None
        self._name_to_gid: Optional[Dict[str, int]] = None
        self._cache: Dict[int, list] = {}
        self._width_cache: Dict[int, float] = {}

    def _private(self, off: int, size: int):
        pd = _dict(self.data[off : off + size])
        subrs: List[bytes] = []
        if 19 in pd:
            subrs, _ = _index(self.data, off + int(pd[19][0]))
        nom = float(pd.get(21, [0.0])[0])
        dflt = float(pd.get(20, [0.0])[0])
        return subrs, nom, dflt

    def _parse_cid(self, top):
        fdarray_off = top.get(0x0C24)
        fdselect_off = top.get(0x0C25)
        if fdarray_off:
            fds, _ = _index(self.data, int(fdarray_off[0]))
            for fd in fds:
                d = _dict(fd)
                priv = d.get(18)
                if priv and len(priv) >= 2:
                    self._fd_privates.append(
                        self._private(int(priv[1]), int(priv[0]))
                    )
                else:
                    self._fd_privates.append(([], 0.0, 0.0))
        if fdselect_off:
            o = int(fdselect_off[0])
            fmt = self.data[o]
            sel = [0] * self.num_glyphs
            if fmt == 0:
                for g in range(self.num_glyphs):
                    sel[g] = self.data[o + 1 + g]
            elif fmt == 3:
                n_ranges = _u16(self.data, o + 1)
                for r in range(n_ranges):
                    first = _u16(self.data, o + 3 + 3 * r)
                    fd = self.data[o + 5 + 3 * r]
                    nxt = _u16(self.data, o + 3 + 3 * (r + 1)) if r + 1 < n_ranges else _u16(self.data, o + 3 + 3 * n_ranges)
                    for g in range(first, min(nxt, self.num_glyphs)):
                        sel[g] = fd
            self._fd_select = sel

    def _parse_charset(self, top) -> List[int]:
        """gid -> SID (name id) or CID."""
        n = self.num_glyphs
        off = top.get(15)
        if off is None or int(off[0]) == 0:
            return list(range(n))  # ISOAdobe order: SID == gid for latin
        if int(off[0]) in (1, 2):
            # Expert/ExpertSubset predefined charsets: not latin; mapping
            # names here would resolve WRONG glyphs, so expose none.
            return [0] * n
        o = int(off[0])
        fmt = self.data[o]
        out = [0]
        if fmt == 0:
            for g in range(1, n):
                out.append(_u16(self.data, o + 1 + 2 * (g - 1)))
        elif fmt in (1, 2):
            p = o + 1
            step = 3 if fmt == 1 else 4
            while len(out) < n:
                first = _u16(self.data, p)
                cnt = self.data[p + 2] if fmt == 1 else _u16(self.data, p + 2)
                for k in range(cnt + 1):
                    if len(out) >= n:
                        break
                    out.append(first + k)
                p += step
        while len(out) < n:
            out.append(0)
        return out

    def _sid_name(self, sid: int) -> str:
        if sid < 96:
            return _STD_STRINGS_LATIN[sid] if sid < len(_STD_STRINGS_LATIN) else ""
        if sid >= 391:
            k = sid - 391
            if k < len(self.strings):
                return self.strings[k].decode("latin1")
        return ""

    def gid_of_name(self, name: str) -> int:
        if self._name_to_gid is None:
            self._name_to_gid = {}
            if not self.is_cid:
                for gid, sid in enumerate(self._charset):
                    nm = self._sid_name(sid)
                    if nm and nm not in self._name_to_gid:
                        self._name_to_gid[nm] = gid
        return self._name_to_gid.get(name, 0)

    def gid_of_cid(self, cid: int) -> int:
        if not self.is_cid:
            return cid if cid < self.num_glyphs else 0
        if self._cid_to_gid is None:
            # One pass (first gid wins); list.index per show code would be
            # O(num_glyphs) per character on CJK faces.
            m: Dict[int, int] = {}
            for gid, c in enumerate(self._charset):
                m.setdefault(c, gid)
            self._cid_to_gid = m
        return self._cid_to_gid.get(cid, 0)

    def gid_of_unicode(self, cp: int) -> int:
        name = _UNI_TO_NAME.get(cp)
        if name is None:
            return 0
        return self.gid_of_name(name)

    # --- charstring interpreter ------------------------------------------------

    def _run(self, gid: int):
        """Execute the Type2 charstring: (contours, width)."""
        if not (0 <= gid < self.num_glyphs):
            return [], self.default_width
        subrs, nominal, default = self.subrs, self.nominal_width, self.default_width
        if self._fd_select is not None and self._fd_privates:
            fd = self._fd_select[gid] if gid < len(self._fd_select) else 0
            if fd < len(self._fd_privates):
                subrs, nominal, default = self._fd_privates[fd]
        gbias = _bias(self.gsubrs)
        lbias = _bias(subrs)
        contours: List[list] = []
        cur: List = []
        x = y = 0.0
        width = [default]
        width_parsed = [False]
        n_stems = [0]
        stack: List[float] = []

        def take_width(nargs: int):
            # The first stack-clearing op may carry a leading width operand:
            # present iff more operands than the op consumes (stems pass -1
            # meaning "even count expected, odd means width").
            if not width_parsed[0]:
                width_parsed[0] = True
                has = (
                    len(stack) % 2 == 1 if nargs < 0 else len(stack) > nargs
                )
                if has and stack:
                    width[0] = nominal + stack.pop(0)

        def moveto(nx, ny):
            nonlocal cur
            if cur:
                contours.append(cur)
            cur = [(nx, ny)]

        def lineto(nx, ny):
            cur.append(("L", nx, ny))

        def curveto(x1, y1, x2, y2, x3, y3):
            cur.append(("C", x1, y1, x2, y2, x3, y3))

        def execute(code: bytes, depth: int):
            nonlocal x, y
            if depth > 10:
                return True
            i = 0
            n = len(code)
            while i < n:
                b0 = code[i]
                if b0 >= 32 or b0 == 28:
                    if b0 == 28:
                        stack.append(struct.unpack_from(">h", code, i + 1)[0])
                        i += 3
                    elif b0 <= 246:
                        stack.append(b0 - 139)
                        i += 1
                    elif b0 <= 250:
                        stack.append((b0 - 247) * 256 + code[i + 1] + 108)
                        i += 2
                    elif b0 <= 254:
                        stack.append(-(b0 - 251) * 256 - code[i + 1] - 108)
                        i += 2
                    else:  # 255: 16.16 fixed
                        stack.append(
                            struct.unpack_from(">i", code, i + 1)[0] / 65536.0
                        )
                        i += 5
                    continue
                i += 1
                if b0 in (1, 3, 18, 23):  # h/vstem(hm)
                    take_width(-1)
                    n_stems[0] += len(stack) // 2
                    stack.clear()
                elif b0 in (19, 20):  # hintmask / cntrmask
                    take_width(-1)
                    n_stems[0] += len(stack) // 2
                    stack.clear()
                    i += (n_stems[0] + 7) // 8
                elif b0 == 21:  # rmoveto
                    take_width(2)
                    if len(stack) >= 2:
                        x += stack[-2]
                        y += stack[-1]
                    moveto(x, y)
                    stack.clear()
                elif b0 == 22:  # hmoveto
                    take_width(1)
                    if stack:
                        x += stack[-1]
                    moveto(x, y)
                    stack.clear()
                elif b0 == 4:  # vmoveto
                    take_width(1)
                    if stack:
                        y += stack[-1]
                    moveto(x, y)
                    stack.clear()
                elif b0 == 5:  # rlineto
                    for k in range(0, len(stack) - 1, 2):
                        x += stack[k]
                        y += stack[k + 1]
                        lineto(x, y)
                    stack.clear()
                elif b0 in (6, 7):  # hlineto / vlineto (alternating)
                    horiz = b0 == 6
                    for v in stack:
                        if horiz:
                            x += v
                        else:
                            y += v
                        lineto(x, y)
                        horiz = not horiz
                    stack.clear()
                elif b0 == 8:  # rrcurveto
                    for k in range(0, len(stack) - 5, 6):
                        x1 = x + stack[k]; y1 = y + stack[k + 1]
                        x2 = x1 + stack[k + 2]; y2 = y1 + stack[k + 3]
                        x = x2 + stack[k + 4]; y = y2 + stack[k + 5]
                        curveto(x1, y1, x2, y2, x, y)
                    stack.clear()
                elif b0 == 24:  # rcurveline
                    k = 0
                    while len(stack) - k >= 8:
                        x1 = x + stack[k]; y1 = y + stack[k + 1]
                        x2 = x1 + stack[k + 2]; y2 = y1 + stack[k + 3]
                        x = x2 + stack[k + 4]; y = y2 + stack[k + 5]
                        curveto(x1, y1, x2, y2, x, y)
                        k += 6
                    if len(stack) - k >= 2:
                        x += stack[k]; y += stack[k + 1]
                        lineto(x, y)
                    stack.clear()
                elif b0 == 25:  # rlinecurve
                    k = 0
                    while len(stack) - k >= 8:
                        x += stack[k]; y += stack[k + 1]
                        lineto(x, y)
                        k += 2
                    if len(stack) - k >= 6:
                        x1 = x + stack[k]; y1 = y + stack[k + 1]
                        x2 = x1 + stack[k + 2]; y2 = y1 + stack[k + 3]
                        x = x2 + stack[k + 4]; y = y2 + stack[k + 5]
                        curveto(x1, y1, x2, y2, x, y)
                    stack.clear()
                elif b0 in (26, 27):  # vvcurveto / hhcurveto
                    k = 0
                    d1 = 0.0
                    if len(stack) % 4 == 1:
                        d1 = stack[0]
                        k = 1
                    while len(stack) - k >= 4:
                        if b0 == 26:
                            x1 = x + d1; y1 = y + stack[k]
                            x2 = x1 + stack[k + 1]; y2 = y1 + stack[k + 2]
                            x = x2; y = y2 + stack[k + 3]
                        else:
                            x1 = x + stack[k]; y1 = y + d1
                            x2 = x1 + stack[k + 1]; y2 = y1 + stack[k + 2]
                            x = x2 + stack[k + 3]; y = y2
                        curveto(x1, y1, x2, y2, x, y)
                        d1 = 0.0
                        k += 4
                    stack.clear()
                elif b0 in (30, 31):  # vhcurveto / hvcurveto
                    horiz = b0 == 31
                    k = 0
                    while len(stack) - k >= 4:
                        last = len(stack) - k == 5
                        if horiz:
                            x1 = x + stack[k]; y1 = y
                            x2 = x1 + stack[k + 1]; y2 = y1 + stack[k + 2]
                            y = y2 + stack[k + 3]
                            x = x2 + (stack[k + 4] if last else 0.0)
                        else:
                            x1 = x; y1 = y + stack[k]
                            x2 = x1 + stack[k + 1]; y2 = y1 + stack[k + 2]
                            x = x2 + stack[k + 3]
                            y = y2 + (stack[k + 4] if last else 0.0)
                        curveto(x1, y1, x2, y2, x, y)
                        horiz = not horiz
                        k += 4
                    stack.clear()
                elif b0 == 10:  # callsubr
                    if stack:
                        idx = int(stack.pop()) + lbias
                        if 0 <= idx < len(subrs):
                            if execute(subrs[idx], depth + 1):
                                return True
                elif b0 == 29:  # callgsubr
                    if stack:
                        idx = int(stack.pop()) + gbias
                        if 0 <= idx < len(self.gsubrs):
                            if execute(self.gsubrs[idx], depth + 1):
                                return True
                elif b0 == 11:  # return
                    return False
                elif b0 == 14:  # endchar
                    take_width(0 if len(stack) in (1, 0) else 4)
                    # (seac accent form ignored: 4 remaining operands)
                    stack.clear()
                    return True
                elif b0 == 12:  # escape: flex family + arithmetic no-ops
                    b1 = code[i]
                    i += 1
                    if b1 == 35 and len(stack) >= 13:  # flex
                        s = stack
                        x1 = x + s[0]; y1 = y + s[1]
                        x2 = x1 + s[2]; y2 = y1 + s[3]
                        x3 = x2 + s[4]; y3 = y2 + s[5]
                        curveto(x1, y1, x2, y2, x3, y3)
                        x4 = x3 + s[6]; y4 = y3 + s[7]
                        x5 = x4 + s[8]; y5 = y4 + s[9]
                        x = x5 + s[10]; y = y5 + s[11]
                        curveto(x4, y4, x5, y5, x, y)
                    elif b1 == 34 and len(stack) >= 7:  # hflex
                        s = stack
                        y0 = y
                        x1 = x + s[0]; y1 = y
                        x2 = x1 + s[1]; y2 = y1 + s[2]
                        x3 = x2 + s[3]; y3 = y2
                        curveto(x1, y1, x2, y2, x3, y3)
                        x4 = x3 + s[4]; y4 = y2
                        x5 = x4 + s[5]; y5 = y0
                        x = x5 + s[6]; y = y0
                        curveto(x4, y4, x5, y5, x, y)
                    elif b1 == 36 and len(stack) >= 9:  # hflex1
                        s = stack
                        y0 = y
                        x1 = x + s[0]; y1 = y + s[1]
                        x2 = x1 + s[2]; y2 = y1 + s[3]
                        x3 = x2 + s[4]; y3 = y2
                        curveto(x1, y1, x2, y2, x3, y3)
                        x4 = x3 + s[5]; y4 = y2
                        x5 = x4 + s[6]; y5 = y4 + s[7]
                        x = x5 + s[8]; y = y0
                        curveto(x4, y4, x5, y5, x, y)
                    elif b1 == 37 and len(stack) >= 11:  # flex1
                        s = stack
                        sx = x; sy = y
                        dx = sum(s[0:10:2]); dy = sum(s[1:11:2])
                        x1 = x + s[0]; y1 = y + s[1]
                        x2 = x1 + s[2]; y2 = y1 + s[3]
                        x3 = x2 + s[4]; y3 = y2 + s[5]
                        curveto(x1, y1, x2, y2, x3, y3)
                        x4 = x3 + s[6]; y4 = y3 + s[7]
                        x5 = x4 + s[8]; y5 = y4 + s[9]
                        if abs(dx) > abs(dy):
                            x = x5 + s[10]; y = sy
                        else:
                            x = sx; y = y5 + s[10]  # snap back to start x
                        curveto(x4, y4, x5, y5, x, y)
                    stack.clear()
                else:
                    stack.clear()
            return False

        execute(self.charstrings[gid], 0)
        if cur:
            contours.append(cur)
        return contours, width[0]

    def advance(self, gid: int) -> float:
        """Advance width in font units."""
        if gid not in self._width_cache:
            self.glyph_segments(gid)
        return self._width_cache.get(gid, self.default_width)

    def glyph_segments(self, gid: int):
        """Closed Straight/Bezier loops in font units (like
        TrueTypeFont.glyph_segments)."""
        if gid in self._cache:
            return self._cache[gid]
        from ..geometry.path import Bezier, Straight

        contours, width = self._run(gid)
        self._width_cache[gid] = width
        loops = []
        for c in contours:
            if len(c) < 2:
                continue
            start = c[0]
            cur = start
            segs = []
            for item in c[1:]:
                if item[0] == "L":
                    p = (item[1], item[2])
                    if p != cur:
                        segs.append(Straight(cur, p))
                    cur = p
                else:
                    _, x1, y1, x2, y2, x3, y3 = item
                    segs.append(Bezier(cur, (x1, y1), (x2, y2), (x3, y3)))
                    cur = (x3, y3)
            if cur != start:
                segs.append(Straight(cur, start))
            if segs:
                loops.append(segs)
        self._cache[gid] = loops
        return loops
