"""Type 1 font programs (Adobe Type 1 Font Format): /FontFile streams.

The port's copy of ``coherence_tpu.io.type1``, whole.

BEYOND REFERENCE: the reference never rasterizes fonts; here classic
Type 1 programs (LaTeX-era Computer Modern, the PostScript base faces)
parse into the same ``glyph_segments`` interface as ``truetype.py`` /
``cff.py`` so PDF text paints through the exact rasterizer.

Covers: PFB segment framing and raw PFA/binary programs, eexec decryption
(hex or binary), lenIV, /Subrs and /CharStrings extraction, the Type 1
charstring ops incl. div, callsubr, seac composition and the
callothersubr flex protocol; the builtin /Encoding (StandardEncoding or
``dup code /name put`` arrays) is exposed for code→glyph lookup.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

from .cff import _UNI_TO_NAME

__all__ = ["Type1Font", "STANDARD_ENCODING"]

# Adobe StandardEncoding, code -> glyph name (non-.notdef entries).
_STD_LOW = (
    "space exclam quotedbl numbersign dollar percent ampersand quoteright "
    "parenleft parenright asterisk plus comma hyphen period slash zero one "
    "two three four five six seven eight nine colon semicolon less equal "
    "greater question at A B C D E F G H I J K L M N O P Q R S T U V W X Y Z "
    "bracketleft backslash bracketright asciicircum underscore quoteleft "
    "a b c d e f g h i j k l m n o p q r s t u v w x y z "
    "braceleft bar braceright asciitilde"
).split()
_STD_HIGH = {
    161: "exclamdown", 162: "cent", 163: "sterling", 164: "fraction",
    165: "yen", 166: "florin", 167: "section", 168: "currency",
    169: "quotesingle", 170: "quotedblleft", 171: "guillemotleft",
    172: "guilsinglleft", 173: "guilsinglright", 174: "fi", 175: "fl",
    177: "endash", 178: "dagger", 179: "daggerdbl", 180: "periodcentered",
    182: "paragraph", 183: "bullet", 184: "quotesinglbase",
    185: "quotedblbase", 186: "quotedblright", 187: "guillemotright",
    188: "ellipsis", 189: "perthousand", 191: "questiondown",
    193: "grave", 194: "acute", 195: "circumflex", 196: "tilde",
    197: "macron", 198: "breve", 199: "dotaccent", 200: "dieresis",
    202: "ring", 203: "cedilla", 205: "hungarumlaut", 206: "ogonek",
    207: "caron", 208: "emdash", 225: "AE", 227: "ordfeminine",
    232: "Lslash", 233: "Oslash", 234: "OE", 235: "ordmasculine",
    241: "ae", 245: "dotlessi", 248: "lslash", 249: "oslash", 250: "oe",
    251: "germandbls",
}
STANDARD_ENCODING: Dict[int, str] = {32 + i: n for i, n in enumerate(_STD_LOW)}
STANDARD_ENCODING.update(_STD_HIGH)


def _decrypt(data: bytes, r: int, skip: int) -> bytes:
    out = bytearray()
    for c in data:
        out.append(c ^ (r >> 8))
        r = ((c + r) * 52845 + 22719) & 0xFFFF
    return bytes(out[skip:])


def _depfb(data: bytes) -> Tuple[bytes, bytes]:
    """PFB segments -> (cleartext, binary-eexec).  Raw programs return
    (whole, b'') and the eexec split happens textually."""
    if not data[:1] == b"\x80":
        return data, b""
    clear = bytearray()
    binary = bytearray()
    o = 0
    while o + 6 <= len(data) and data[o] == 0x80:
        typ = data[o + 1]
        if typ == 3:
            break
        ln = struct.unpack_from("<I", data, o + 2)[0]
        seg = data[o + 6 : o + 6 + ln]
        (clear if typ == 1 else binary).extend(seg)
        o += 6 + ln
    return bytes(clear), bytes(binary)


_HEX = frozenset(b"0123456789abcdefABCDEF")


class Type1Font:
    """Parsed Type 1 program with the truetype.py glyph interface."""

    def __init__(self, data: bytes):
        clear, binary = _depfb(data)
        if not binary:
            i = clear.find(b"eexec")
            if i < 0:
                raise ValueError("not a Type 1 font program (no eexec)")
            rest = clear[i + 5 :].lstrip(b"\r\n\t ")
            if all(c in _HEX for c in rest[:4]):
                hx = bytes(c for c in rest if c in _HEX)
                rest = bytes.fromhex(hx.decode("ascii"))
            binary = rest
            clear = clear[:i]
        priv = _decrypt(binary, 55665, 4)

        m = re.search(rb"/lenIV\s+(\d+)", priv)
        leniv = int(m.group(1)) if m else 4

        self.subrs: List[bytes] = self._parse_subrs(priv, leniv)
        names, charstrings = self._parse_charstrings(priv, leniv)
        if ".notdef" in names:
            k = names.index(".notdef")  # keep gid 0 = .notdef
            names.insert(0, names.pop(k))
            charstrings.insert(0, charstrings.pop(k))
        else:
            names.insert(0, ".notdef")
            charstrings.insert(0, b"")
        self.glyph_names = names
        self.charstrings = charstrings
        self.num_glyphs = len(names)
        self._name_to_gid = {n: i for i, n in enumerate(names)}

        self.encoding = self._parse_encoding(clear)
        fm = re.search(
            rb"/FontMatrix\s*\[\s*([-\d.eE]+)\s+([-\d.eE]+)\s+([-\d.eE]+)"
            rb"\s+([-\d.eE]+)\s+([-\d.eE]+)\s+([-\d.eE]+)",
            clear,
        )
        sx = float(fm.group(1)) if fm else 0.001
        self.units_per_em = round(1.0 / sx) if sx > 0 else 1000
        self.default_width = self.units_per_em * 0.5
        self._cache: Dict[int, list] = {}
        self._width_cache: Dict[int, float] = {}

    # --- program parsing ---------------------------------------------------

    @staticmethod
    def _rd_entries(pattern: re.Pattern, blob: bytes, leniv: int):
        """(key, charstring) pairs for `<key> <len> RD <bin> ..` entries."""
        out = []
        for m in pattern.finditer(blob):
            ln = int(m.group(2))
            start = m.end()
            out.append((m.group(1), _decrypt(blob[start : start + ln], 4330, leniv)))
        return out

    def _parse_subrs(self, priv: bytes, leniv: int) -> List[bytes]:
        i = priv.find(b"/Subrs")
        if i < 0:
            return []
        pat = re.compile(rb"dup\s+(\d+)\s+(\d+)\s+(?:RD|-\|)[ ]")
        entries = self._rd_entries(pat, priv[i:], leniv)
        if not entries:
            return []
        n = max(int(k) for k, _ in entries) + 1
        subrs = [b""] * n
        for k, cs in entries:
            subrs[int(k)] = cs
        return subrs

    def _parse_charstrings(self, priv: bytes, leniv: int):
        i = priv.find(b"/CharStrings")
        blob = priv[i:] if i >= 0 else priv
        pat = re.compile(rb"/([^\s/{}()\[\]<>]+)\s+(\d+)\s+(?:RD|-\|)[ ]")
        names: List[str] = []
        charstrings: List[bytes] = []
        for k, cs in self._rd_entries(pat, blob, leniv):
            name = k.decode("latin1")
            if name in ("CharStrings", "Subrs", "Private", "lenIV"):
                continue
            names.append(name)
            charstrings.append(cs)
        return names, charstrings

    @staticmethod
    def _parse_encoding(clear: bytes) -> Dict[int, str]:
        if re.search(rb"/Encoding\s+StandardEncoding\s+def", clear):
            return dict(STANDARD_ENCODING)
        enc: Dict[int, str] = {}
        i = clear.find(b"/Encoding")
        if i >= 0:
            for m in re.finditer(
                rb"dup\s+(\d+)\s*/([^\s/{}()\[\]<>]+)\s+put", clear[i:]
            ):
                enc[int(m.group(1))] = m.group(2).decode("latin1")
        return enc or dict(STANDARD_ENCODING)

    # --- glyph lookup --------------------------------------------------------

    def gid_of_name(self, name: str) -> int:
        return self._name_to_gid.get(name, 0)

    def gid_of_builtin_code(self, code: int) -> int:
        name = self.encoding.get(code)
        return self._name_to_gid.get(name, 0) if name else 0

    def gid_of_unicode(self, cp: int) -> int:
        name = _UNI_TO_NAME.get(cp)
        return self.gid_of_name(name) if name else 0

    # --- charstring interpreter ----------------------------------------------

    def _run(self, gid: int):
        """Execute the Type 1 charstring: (contours, width, sbx)."""
        if not (0 <= gid < self.num_glyphs) or not self.charstrings[gid]:
            return [], self.default_width, 0.0
        contours: List[list] = []
        cur: List = []
        state = {
            "x": 0.0, "y": 0.0, "w": self.default_width, "sbx": 0.0,
            "flex": None,  # list of collected flex points while active
        }
        stack: List[float] = []
        ps_stack: List[float] = []

        def moveto():
            nonlocal cur
            if cur:
                contours.append(cur)
            cur = [(state["x"], state["y"])]

        def ensure_cur():
            nonlocal cur
            if not cur:
                cur = [(state["x"], state["y"])]

        def lineto():
            ensure_cur()
            cur.append(("L", state["x"], state["y"]))

        def curveto(x1, y1, x2, y2):
            ensure_cur()
            cur.append(("C", x1, y1, x2, y2, state["x"], state["y"]))

        def execute(code: bytes, depth: int) -> bool:
            nonlocal cur
            if depth > 10:
                return True
            i, n = 0, len(code)
            while i < n:
                b0 = code[i]
                if b0 >= 32:
                    if b0 <= 246:
                        stack.append(b0 - 139)
                        i += 1
                    elif b0 <= 250:
                        stack.append((b0 - 247) * 256 + code[i + 1] + 108)
                        i += 2
                    elif b0 <= 254:
                        stack.append(-(b0 - 251) * 256 - code[i + 1] - 108)
                        i += 2
                    else:
                        stack.append(struct.unpack_from(">i", code, i + 1)[0])
                        i += 5
                    continue
                i += 1
                if b0 == 13:  # hsbw: sbx wx
                    if len(stack) >= 2:
                        state["sbx"], state["w"] = stack[0], stack[1]
                        state["x"] = stack[0]
                    stack.clear()
                elif b0 == 21:  # rmoveto
                    if len(stack) >= 2:
                        state["x"] += stack[-2]
                        state["y"] += stack[-1]
                        if state["flex"] is not None:
                            state["flex"].append((state["x"], state["y"]))
                        else:
                            moveto()
                    stack.clear()
                elif b0 == 22:  # hmoveto
                    if stack:
                        state["x"] += stack[-1]
                        if state["flex"] is not None:
                            state["flex"].append((state["x"], state["y"]))
                        else:
                            moveto()
                    stack.clear()
                elif b0 == 4:  # vmoveto
                    if stack:
                        state["y"] += stack[-1]
                        if state["flex"] is not None:
                            state["flex"].append((state["x"], state["y"]))
                        else:
                            moveto()
                    stack.clear()
                elif b0 == 5:  # rlineto
                    if len(stack) >= 2:
                        state["x"] += stack[-2]
                        state["y"] += stack[-1]
                        lineto()
                    stack.clear()
                elif b0 == 6:  # hlineto
                    if stack:
                        state["x"] += stack[-1]
                        lineto()
                    stack.clear()
                elif b0 == 7:  # vlineto
                    if stack:
                        state["y"] += stack[-1]
                        lineto()
                    stack.clear()
                elif b0 == 8:  # rrcurveto
                    if len(stack) >= 6:
                        a = stack[-6:]
                        x1 = state["x"] + a[0]
                        y1 = state["y"] + a[1]
                        x2 = x1 + a[2]
                        y2 = y1 + a[3]
                        state["x"] = x2 + a[4]
                        state["y"] = y2 + a[5]
                        curveto(x1, y1, x2, y2)
                    stack.clear()
                elif b0 == 30:  # vhcurveto: dy1 dx2 dy2 dx3
                    if len(stack) >= 4:
                        a = stack[-4:]
                        x1, y1 = state["x"], state["y"] + a[0]
                        x2, y2 = x1 + a[1], y1 + a[2]
                        state["x"], state["y"] = x2 + a[3], y2
                        curveto(x1, y1, x2, y2)
                    stack.clear()
                elif b0 == 31:  # hvcurveto: dx1 dx2 dy2 dy3
                    if len(stack) >= 4:
                        a = stack[-4:]
                        x1, y1 = state["x"] + a[0], state["y"]
                        x2, y2 = x1 + a[1], y1 + a[2]
                        state["x"], state["y"] = x2, y2 + a[3]
                        curveto(x1, y1, x2, y2)
                    stack.clear()
                elif b0 == 9:  # closepath
                    if cur:
                        contours.append(cur)
                    cur = []
                    stack.clear()
                elif b0 == 10:  # callsubr
                    if stack:
                        k = int(stack.pop())
                        if 0 <= k < len(self.subrs):
                            if execute(self.subrs[k], depth + 1):
                                return True
                elif b0 == 11:  # return
                    return False
                elif b0 == 14:  # endchar
                    return True
                elif b0 in (1, 3):  # hstem / vstem
                    stack.clear()
                elif b0 == 12:
                    b1 = code[i]
                    i += 1
                    if b1 == 12:  # div
                        if len(stack) >= 2:
                            b = stack.pop()
                            a = stack.pop()
                            stack.append(a / b if b else 0.0)
                    elif b1 == 6:  # seac: asb adx ady bchar achar
                        if len(stack) >= 5:
                            asb, adx, ady, bchar, achar = stack[-5:]
                            stack.clear()
                            self._seac(
                                contours, int(bchar), int(achar), asb, adx, ady
                            )
                        return True
                    elif b1 == 7:  # sbw: sbx sby wx wy
                        if len(stack) >= 4:
                            state["sbx"] = stack[0]
                            state["w"] = stack[2]
                            state["x"], state["y"] = stack[0], stack[1]
                        stack.clear()
                    elif b1 == 16:  # callothersubr
                        if len(stack) >= 2:
                            othersubr = int(stack.pop())
                            nargs = int(stack.pop())
                            args = stack[-nargs:] if nargs else []
                            del stack[len(stack) - nargs :]
                            if othersubr == 1:  # flex start
                                state["flex"] = []
                            elif othersubr == 2:
                                pass  # point collected by the rmoveto
                            elif othersubr == 0:  # flex end
                                pts = state["flex"] or []
                                state["flex"] = None
                                if len(pts) >= 7:
                                    # pts[0] is the reference point; two
                                    # curves from the six control points.
                                    (c1, c2, c3, c4, c5, c6) = pts[1:7]
                                    state["x"], state["y"] = c3
                                    curveto(c1[0], c1[1], c2[0], c2[1])
                                    state["x"], state["y"] = c6
                                    curveto(c4[0], c4[1], c5[0], c5[1])
                                # the two following pops fetch x then y for
                                # setcurrentpoint.
                                ps_stack.extend([state["y"], state["x"]])
                            elif othersubr == 3:  # hint replacement
                                ps_stack.append(3.0)
                            else:
                                ps_stack.extend(args)
                    elif b1 == 17:  # pop
                        stack.append(ps_stack.pop() if ps_stack else 0.0)
                    elif b1 == 33:  # setcurrentpoint
                        if len(stack) >= 2:
                            state["x"], state["y"] = stack[-2], stack[-1]
                        stack.clear()
                    else:  # dotsection / vstem3 / hstem3 / unknown
                        stack.clear()
            return False

        execute(self.charstrings[gid], 0)
        if cur:
            contours.append(cur)
        return contours, state["w"], state["sbx"]

    def _seac(self, contours, bcode, acode, asb, adx, ady):
        """Standard-encoding accented composite (Type 1 spec 8.4): base
        glyph plus the accent translated by (adx - asb, ady)."""
        for code, dx, dy in ((bcode, 0.0, 0.0), (acode, adx - asb, ady)):
            name = STANDARD_ENCODING.get(code)
            gid = self._name_to_gid.get(name, 0) if name else 0
            if not gid:
                continue
            sub, _w, _sb = self._run(gid)
            for c in sub:
                if not c:
                    continue
                moved = [(c[0][0] + dx, c[0][1] + dy)]
                for item in c[1:]:
                    if item[0] == "L":
                        moved.append(("L", item[1] + dx, item[2] + dy))
                    else:
                        moved.append(
                            (
                                "C",
                                item[1] + dx, item[2] + dy,
                                item[3] + dx, item[4] + dy,
                                item[5] + dx, item[6] + dy,
                            )
                        )
                contours.append(moved)

    # --- public glyph interface (matches truetype.py / cff.py) ---------------

    def advance(self, gid: int) -> float:
        if gid not in self._width_cache:
            self.glyph_segments(gid)
        return self._width_cache.get(gid, self.default_width)

    def glyph_segments(self, gid: int):
        """Closed Straight/Bezier loops in font units."""
        if gid in self._cache:
            return self._cache[gid]
        from ..geometry.path import Bezier, Straight

        contours, width, _sbx = self._run(gid)
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
