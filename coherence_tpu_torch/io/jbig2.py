"""JBIG2 decoder (ITU-T T.88) for the PDF ``JBIG2Decode`` filter.

The port's copy of ``coherence_tpu.io.jbig2``, whole.

BEYOND REFERENCE: camlpdf's ``Pdfcodec`` has no JBIG2 support; scanned/
OCR'd PDFs overwhelmingly use it.  Scope: the embedded-in-PDF profile —
segment streams (optionally split across /JBIG2Globals), page info,
generic regions (arithmetic templates 0-3 with TPGDON and AT pixels, or
MMR via the existing T.6 decoder in io/ccitt.py), generic REFINEMENT
regions (templates 0-1, TPGRON, AT pixels — 6.3), symbol dictionaries
(arithmetic, including SDREFAGG refinement/aggregate coding — 6.5.8),
text regions (arithmetic, including SBREFINE per-instance refinement —
6.4.11), refinement region segments refining the composed page, pattern
dictionaries + halftone regions (6.6/6.7: gray-coded bitplanes arithmetic
or MMR, skewed grids, skip bitmaps), and the HUFFMAN variants (Annex B: standard tables B.1-B.15, custom table
segments, runcode symbol-ID assignment, collective height-class bitmaps
raw or MMR, refining dictionaries/regions with byte-aligned arithmetic
refinement data, and AGGREGATE symbol coding — REFAGGNINST > 1 under
SDHUFF decodes the embedded fixed-length-code text region of 6.5.8.2.1).

The MQ arithmetic coder (Annex E) and the integer/ID decoding procedures
(Annex A) are transcribed from the spec.  ``tests/test_jbig2.py``
validates them by round-trip against the encoder in this module plus
structural known-answer cases.

Convention: JBIG2 bitmaps use 1 = black.  ``decode_jbig2`` returns packed
rows INVERTED (0 = black) so a 1-bpc DeviceGray PDF image paints black
where JBIG2 coded 1, matching how viewers implement the filter.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# MQ arithmetic coder (T.88 Annex E): Qe, NMPS, NLPS, SWITCH
# ---------------------------------------------------------------------------

QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]


class Contexts:
    """Per-context (index, MPS) state, keyed by integer context label."""

    __slots__ = ("i", "mps")

    def __init__(self, n: int):
        self.i = bytearray(n)
        self.mps = bytearray(n)


class MQDecoder:
    """T.88 E.3 decoding procedures (INITDEC / DECODE / BYTEIN / RENORMD)."""

    __slots__ = ("data", "bp", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data = data
        self.bp = 0
        b = data[0] if data else 0xFF
        self.c = b << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: Contexts, label: int) -> int:
        i = cx.i[label]
        mps = cx.mps[label]
        qe, nmps, nlps, switch = QE[i]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = mps
                cx.i[label] = nmps
            else:
                d = 1 - mps
                if switch:
                    cx.mps[label] = 1 - mps
                cx.i[label] = nlps
            self.a = qe
        else:
            self.c = (self.c - (qe << 16)) & 0xFFFFFFFF
            if self.a & 0x8000:
                return mps
            # MPS exchange path
            if self.a < qe:
                d = 1 - mps
                if switch:
                    cx.mps[label] = 1 - mps
                cx.i[label] = nlps
            else:
                d = mps
                cx.i[label] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


class MQEncoder:
    """T.88 E.2 encoding procedures — used by the tests to round-trip the
    decoder (self-consistency oracle; no system JBIG2 encoder exists)."""

    def __init__(self):
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.out = bytearray()
        self.b = None  # pending byte
        self.first = True

    def encode(self, cx: Contexts, label: int, d: int):
        i = cx.i[label]
        mps = cx.mps[label]
        qe, nmps, nlps, switch = QE[i]
        if d == mps:
            # CODEMPS
            self.a -= qe
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            cx.i[label] = nmps
        else:
            # CODELPS
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                cx.mps[label] = 1 - mps
            cx.i[label] = nlps
        # RENORME (BYTEOUT sets CT itself: 7 after an 0xFF stuff, else 8)
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _emit(self, byte: int):
        if self.b is not None:
            self.out.append(self.b)
        self.b = byte & 0xFF

    def _byteout(self):
        if self.b == 0xFF:
            self._emit(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self._emit(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.b += 1
            if self.b == 0xFF:
                self.c &= 0x7FFFFFF
                self._emit(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self._emit(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def flush(self, marker: bool = True) -> bytes:
        """Terminate (E.2.9 SETBITS + byteouts).  ``marker`` appends the
        JBIG2 0xFF 0xAC convention; JPEG 2000 terminations (io/jp2enc.py)
        pass False and drop a trailing 0xFF instead (T.800 forbids a
        terminated segment ending in 0xFF)."""
        # SETBITS
        tempc = self.c + self.a - 1
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        if self.b is not None:
            self.out.append(self.b)
            self.b = None
        if marker:
            self.out += b"\xff\xac"
        elif self.out and self.out[-1] == 0xFF:
            self.out.pop()
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Integer + symbol-ID decoding (T.88 Annex A)
# ---------------------------------------------------------------------------

OOB = object()


def decode_int(mq: MQDecoder, cx: Contexts):
    """IAx procedure (A.2): returns int or OOB."""
    prev = 1

    def bit():
        nonlocal prev
        d = mq.decode(cx, prev)
        prev = ((prev << 1) | d) if prev < 256 else ((((prev << 1) | d) & 511) | 256)
        return d

    def bits(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | bit()
        return v

    s = bit()
    if not bit():
        v = bits(2)
    elif not bit():
        v = bits(4) + 4
    elif not bit():
        v = bits(6) + 20
    elif not bit():
        v = bits(8) + 84
    elif not bit():
        v = bits(12) + 340
    else:
        v = bits(32) + 4436
    if s:
        if v == 0:
            return OOB
        return -v
    return v


def decode_iaid(mq: MQDecoder, cx: Contexts, symcodelen: int) -> int:
    """IAID procedure (A.3)."""
    prev = 1
    for _ in range(symcodelen):
        prev = (prev << 1) | mq.decode(cx, prev)
    return prev - (1 << symcodelen)


class IntEncoder:
    """Inverse of decode_int/decode_iaid for the test round-trips."""

    def __init__(self, enc: MQEncoder):
        self.enc = enc

    def encode_int(self, cx: Contexts, value) -> None:
        prev = 1

        def bit(d):
            nonlocal prev
            self.enc.encode(cx, prev, d)
            prev = ((prev << 1) | d) if prev < 256 else ((((prev << 1) | d) & 511) | 256)

        def bits(v, n):
            for k in range(n - 1, -1, -1):
                bit((v >> k) & 1)

        if value is OOB:
            bit(1)
            bit(0)
            bits(0, 2)
            return
        s = 1 if value < 0 else 0
        v = -value if value < 0 else value
        bit(s)
        if v < 4:
            bit(0)
            bits(v, 2)
        elif v < 20:
            bit(1)
            bit(0)
            bits(v - 4, 4)
        elif v < 84:
            bit(1)
            bit(1)
            bit(0)
            bits(v - 20, 6)
        elif v < 340:
            bit(1)
            bit(1)
            bit(1)
            bit(0)
            bits(v - 84, 8)
        elif v < 4436:
            bit(1)
            bit(1)
            bit(1)
            bit(1)
            bit(0)
            bits(v - 340, 12)
        else:
            bit(1)
            bit(1)
            bit(1)
            bit(1)
            bit(1)
            bits(v - 4436, 32)

    def encode_iaid(self, cx: Contexts, value: int, symcodelen: int) -> None:
        prev = 1
        v = value + (1 << symcodelen)
        for k in range(symcodelen - 1, -1, -1):
            d = (v >> k) & 1
            self.enc.encode(cx, prev, d)
            prev = (prev << 1) | d


# ---------------------------------------------------------------------------
# Generic region decoding (6.2): templates 0-3, TPGDON, AT pixels
# ---------------------------------------------------------------------------

# Fixed template pixels (dx, dy) per GBTEMPLATE, before the AT pixels.
_TEMPLATES = [
    [(-1, -2), (0, -2), (1, -2),
     (-2, -1), (-1, -1), (0, -1), (1, -1), (2, -1),
     (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
    [(-1, -2), (0, -2), (1, -2), (2, -2),
     (-2, -1), (-1, -1), (0, -1), (1, -1), (2, -1),
     (-3, 0), (-2, 0), (-1, 0)],
    [(-1, -2), (0, -2), (1, -2),
     (-2, -1), (-1, -1), (0, -1), (1, -1),
     (-2, 0), (-1, 0)],
    [(-3, -1), (-2, -1), (-1, -1), (0, -1), (1, -1),
     (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
]
_AT_COUNT = [4, 1, 1, 1]
NOMINAL_AT = [
    [(3, -1), (-3, -1), (2, -2), (-2, -2)],
    [(3, -1)],
    [(2, -1)],
    [(2, -1)],
]
# TPGDON pseudo-pixel context per template (6.2.5.7).
_TPGD_CTX = [0x9B25, 0x0795, 0x00E5, 0x0195]


def _context_pixels(template: int, at) -> List[Tuple[int, int]]:
    """Template + AT pixels in spec context order (row-major by (dy, dx))."""
    pts = list(_TEMPLATES[template]) + [tuple(p) for p in at]
    pts.sort(key=lambda p: (p[1], p[0]))
    return pts


def decode_generic(mq: MQDecoder, cx: Contexts, w: int, h: int, template: int,
                   at, tpgdon: bool, skip=None) -> np.ndarray:
    """Arithmetic generic region decoding (6.2.5.7) -> (h, w) uint8."""
    pts = _context_pixels(template, at)
    nbits = len(pts)
    bitmap = np.zeros((h, w), dtype=np.uint8)
    get = bitmap  # local alias
    ltp = 0
    for y in range(h):
        if tpgdon:
            if mq.decode(cx, _TPGD_CTX[template]):
                ltp ^= 1
            if ltp:
                if y > 0:
                    bitmap[y] = bitmap[y - 1]
                continue
        row = get[y]
        for x in range(w):
            if skip is not None and skip[y, x]:
                row[x] = 0
                continue
            ctxv = 0
            for dx, dy in pts:
                xx, yy = x + dx, y + dy
                if 0 <= yy < h and 0 <= xx < w and (yy < y or (yy == y and xx < x)):
                    # int(): OR-ing a numpy uint8 would clamp ctxv to 8 bits
                    ctxv = (ctxv << 1) | int(get[yy, xx])
                else:
                    ctxv <<= 1
            row[x] = mq.decode(cx, ctxv)
    assert nbits <= 16
    return bitmap


def encode_generic(enc: MQEncoder, cx: Contexts, bitmap: np.ndarray,
                   template: int = 0, at=None, tpgdon: bool = False) -> None:
    """Inverse of decode_generic for the tests (same context walk)."""
    h, w = bitmap.shape
    if at is None:
        at = NOMINAL_AT[template]
    pts = _context_pixels(template, at)
    ltp = 0
    for y in range(h):
        if tpgdon:
            same = y > 0 and bool(np.array_equal(bitmap[y], bitmap[y - 1]))
            sltp = 1 if same != bool(ltp) else 0
            enc.encode(cx, _TPGD_CTX[template], sltp)
            if sltp:
                ltp ^= 1
            if ltp:
                continue
        for x in range(w):
            ctxv = 0
            for dx, dy in pts:
                xx, yy = x + dx, y + dy
                if 0 <= yy < h and 0 <= xx < w and (yy < y or (yy == y and xx < x)):
                    ctxv = (ctxv << 1) | int(bitmap[yy, xx])
                else:
                    ctxv <<= 1
            enc.encode(cx, ctxv, int(bitmap[y, x]))


# ---------------------------------------------------------------------------
# Huffman coding (Annex B): bit reader, canonical tables, standard tables
# ---------------------------------------------------------------------------


class BitReader:
    """MSB-first bit reader over a segment payload."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.pos = byte_pos * 8  # bit position

    def read_bit(self) -> int:
        p = self.pos
        byte = self.data[p >> 3] if (p >> 3) < len(self.data) else 0
        self.pos = p + 1
        return (byte >> (7 - (p & 7))) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_offset(self) -> int:
        return self.pos >> 3

    def skip_bytes(self, n: int) -> None:
        self.pos += 8 * n


class HuffmanTable:
    """A Huffman table of (PREFLEN, RANGELEN, RANGELOW, kind) lines with
    canonical code assignment per T.88 B.3.  kind: '' normal line,
    'L' lower range (value = RANGELOW - read(32)), 'U' upper range
    (value = RANGELOW + read(32)), 'O' out-of-band."""

    def __init__(self, lines):
        self.lines = [
            (l[0], l[1], l[2], l[3] if len(l) > 3 else "") for l in lines
        ]
        maxlen = max((l[0] for l in self.lines), default=0)
        lencount = [0] * (maxlen + 1)
        for l in self.lines:
            if l[0] > 0:
                lencount[l[0]] += 1
        self.codes = {}  # (length, code) -> line
        firstcode = 0
        lencount[0] = 0
        for curlen in range(1, maxlen + 1):
            firstcode = (firstcode + lencount[curlen - 1]) << 1
            curcode = firstcode
            for l in self.lines:
                if l[0] == curlen:
                    self.codes[(curlen, curcode)] = l
                    curcode += 1
        self.maxlen = maxlen

    def decode(self, r: BitReader):
        code = 0
        for length in range(1, self.maxlen + 1):
            code = (code << 1) | r.read_bit()
            line = self.codes.get((length, code))
            if line is not None:
                preflen, rangelen, rangelow, kind = line
                if kind == "O":
                    return OOB
                if kind == "L":
                    return rangelow - r.read(32)
                if kind == "U":
                    return rangelow + r.read(32)
                return rangelow + r.read(rangelen)
        raise ValueError("JBIG2: invalid Huffman code")


# Standard tables B.1-B.15 (T.88 Annex B).  Structure independently
# validated: every table's (RANGELEN, RANGELOW) pairs tile the value line
# contiguously, and the prefix lengths form a complete prefix code
# (Kraft sum == 1) for every table except B.10 (tests/test_jbig2.py).
_STD_TABLES = {
    1: [(1, 4, 0), (2, 8, 16), (3, 16, 272), (3, 32, 65808, "U")],
    2: [(1, 0, 0), (2, 0, 1), (3, 0, 2), (4, 3, 3), (5, 6, 11),
        (6, 32, 75, "U"), (6, 0, 0, "O")],
    3: [(8, 8, -256), (1, 0, 0), (2, 0, 1), (3, 0, 2), (4, 3, 3),
        (5, 6, 11), (8, 32, -257, "L"), (7, 32, 75, "U"), (6, 0, 0, "O")],
    4: [(1, 0, 1), (2, 0, 2), (3, 0, 3), (4, 3, 4), (5, 6, 12),
        (5, 32, 76, "U")],
    5: [(7, 8, -255), (1, 0, 1), (2, 0, 2), (3, 0, 3), (4, 3, 4),
        (5, 6, 12), (7, 32, -256, "L"), (6, 32, 76, "U")],
    6: [(5, 10, -2048), (4, 9, -1024), (4, 8, -512), (4, 7, -256),
        (5, 6, -128), (5, 5, -64), (4, 5, -32), (2, 7, 0), (3, 7, 128),
        (3, 8, 256), (4, 9, 512), (4, 10, 1024), (6, 32, -2049, "L"),
        (6, 32, 2048, "U")],
    7: [(4, 9, -1024), (3, 8, -512), (4, 7, -256), (5, 6, -128),
        (5, 5, -64), (4, 5, -32), (4, 5, 0), (5, 5, 32), (5, 6, 64),
        (4, 7, 128), (3, 8, 256), (3, 9, 512), (3, 10, 1024),
        (5, 32, -1025, "L"), (5, 32, 2048, "U")],
    8: [(8, 3, -15), (9, 1, -7), (8, 1, -5), (9, 0, -3), (7, 0, -2),
        (4, 0, -1), (2, 1, 0), (5, 0, 2), (6, 0, 3), (3, 4, 4),
        (6, 1, 20), (4, 4, 22), (4, 5, 38), (5, 6, 70), (5, 7, 134),
        (6, 7, 262), (7, 8, 390), (6, 10, 646), (9, 32, -16, "L"),
        (9, 32, 1670, "U"), (2, 0, 0, "O")],
    9: [(8, 4, -31), (9, 2, -15), (8, 2, -11), (9, 1, -7), (7, 1, -5),
        (4, 1, -3), (3, 1, -1), (3, 1, 1), (5, 1, 3), (6, 1, 5),
        (3, 5, 7), (6, 2, 39), (4, 5, 43), (4, 6, 75), (5, 7, 139),
        (5, 8, 267), (6, 8, 523), (7, 9, 779), (6, 11, 1291),
        (9, 32, -32, "L"), (9, 32, 3339, "U"), (2, 0, 0, "O")],
    10: [(7, 4, -21), (8, 0, -5), (7, 0, -4), (5, 0, -3), (2, 2, -2),
         (5, 0, 2), (6, 0, 3), (7, 0, 4), (8, 0, 5), (2, 6, 6),
         (5, 5, 70), (6, 5, 102), (7, 6, 134), (8, 7, 198), (8, 8, 326),
         (8, 9, 582), (8, 10, 1094), (7, 11, 2118), (8, 32, -22, "L"),
         (8, 32, 4166, "U"), (2, 0, 0, "O")],
    11: [(1, 0, 1), (2, 1, 2), (4, 0, 4), (4, 1, 5), (5, 1, 7),
         (5, 2, 9), (6, 2, 13), (7, 2, 17), (7, 3, 21), (7, 4, 29),
         (7, 5, 45), (7, 6, 77), (7, 32, 141, "U")],
    12: [(1, 0, 1), (2, 0, 2), (3, 1, 3), (5, 0, 5), (5, 1, 6),
         (6, 1, 8), (7, 0, 10), (7, 1, 11), (7, 2, 13), (7, 3, 17),
         (7, 4, 25), (8, 5, 41), (8, 32, 73, "U")],
    13: [(1, 0, 1), (3, 0, 2), (4, 0, 3), (5, 0, 4), (4, 1, 5),
         (3, 3, 7), (6, 1, 15), (6, 2, 17), (6, 3, 21), (6, 4, 29),
         (6, 5, 45), (7, 6, 77), (7, 32, 141, "U")],
    14: [(3, 0, -2), (3, 0, -1), (1, 0, 0), (3, 0, 1), (3, 0, 2)],
    15: [(7, 4, -24), (6, 2, -8), (5, 1, -4), (4, 0, -2), (3, 0, -1),
         (1, 0, 0), (3, 0, 1), (4, 0, 2), (5, 1, 3), (6, 2, 5),
         (7, 4, 9), (7, 32, -25, "L"), (7, 32, 25, "U")],
}
_STD_CACHE: Dict[int, HuffmanTable] = {}


def standard_table(n: int) -> HuffmanTable:
    t = _STD_CACHE.get(n)
    if t is None:
        t = _STD_CACHE[n] = HuffmanTable(_STD_TABLES[n])
    return t


def parse_table_segment(data: bytes) -> HuffmanTable:
    """Custom Huffman table segment (7.4.13 / B.2)."""
    flags = data[0]
    htoob = flags & 1
    htps = ((flags >> 1) & 7) + 1
    htrs = ((flags >> 4) & 7) + 1
    htlow, hthigh = struct.unpack_from(">ii", data, 1)
    r = BitReader(data, 9)
    lines = []
    rangelow = htlow
    while rangelow < hthigh:
        preflen = r.read(htps)
        rangelen = r.read(htrs)
        lines.append((preflen, rangelen, rangelow))
        rangelow += 1 << rangelen
    lines.append((r.read(htps), 32, htlow - 1, "L"))
    lines.append((r.read(htps), 32, hthigh, "U"))
    if htoob:
        lines.append((r.read(htps), 0, 0, "O"))
    return HuffmanTable([l for l in lines if l[0] > 0])


# ---------------------------------------------------------------------------
# Generic refinement region decoding (6.3): templates 0-1, TPGRON, AT pixels
# ---------------------------------------------------------------------------

# Refinement context pixels (6.3.5.3).  Per template: pixels read from the
# bitmap BEING decoded (causal), then pixels read from the reference bitmap
# at (x - dx, y - dy) offsets.  Template 0 appends AT1 to the coding set and
# AT2 to the reference set (13-bit context); template 1 is fixed (10-bit).
_R_CODING = [
    [(0, -1), (1, -1), (-1, 0)],
    [(-1, -1), (0, -1), (1, -1), (-1, 0)],
]
_R_REFERENCE = [
    [(0, -1), (1, -1), (-1, 0), (0, 0), (1, 0), (-1, 1), (0, 1), (1, 1)],
    [(0, -1), (-1, 0), (0, 0), (1, 0), (0, 1), (1, 1)],
]
# TPGRON pseudo-pixel context per template (6.3.5.6).
_TPGR_CTX = [0x0020, 0x0008]
NOMINAL_R_AT = [(-1, -1), (-1, -1)]


def _r_templates(template: int, at):
    cod = list(_R_CODING[template])
    ref = list(_R_REFERENCE[template])
    if template == 0:
        a = at if at else NOMINAL_R_AT
        cod.append(tuple(a[0]))
        ref.append(tuple(a[1]))
    return cod, ref


def _ref_window_uniform(ref: np.ndarray, rx0: int, ry0: int):
    """The 3x3 reference neighbourhood around (rx0, ry0): 0/1 if uniform
    (out-of-bounds pixels read 0), else None (typical prediction, 6.3.5.6)."""
    rh, rw = ref.shape
    first = None
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            yy, xx = ry0 + ddy, rx0 + ddx
            v = int(ref[yy, xx]) if 0 <= yy < rh and 0 <= xx < rw else 0
            if first is None:
                first = v
            elif v != first:
                return None
    return first


def decode_refinement(mq: MQDecoder, cx: Contexts, w: int, h: int,
                      template: int, at, ref: np.ndarray, dx: int, dy: int,
                      tpgron: bool = False) -> np.ndarray:
    """Arithmetic generic refinement decoding (6.3.5.6) -> (h, w) uint8.

    Pixel (x, y) refines reference pixel (x - dx, y - dy); out-of-bounds
    reference reads are 0.  With TPGRON, rows under LTP predict pixels whose
    3x3 reference window is uniform and decode only the rest."""
    cod, rpts = _r_templates(template, at)
    rh, rw = ref.shape
    out = np.zeros((h, w), dtype=np.uint8)
    ltp = 0
    for y in range(h):
        if tpgron and mq.decode(cx, _TPGR_CTX[template]):
            ltp ^= 1
        for x in range(w):
            if ltp:
                v = _ref_window_uniform(ref, x - dx, y - dy)
                if v is not None:
                    out[y, x] = v
                    continue
            ctxv = 0
            for ddx, ddy in cod:
                yy, xx = y + ddy, x + ddx
                if 0 <= yy < h and 0 <= xx < w and (yy < y or (yy == y and xx < x)):
                    ctxv = (ctxv << 1) | int(out[yy, xx])
                else:
                    ctxv <<= 1
            for ddx, ddy in rpts:
                yy, xx = y - dy + ddy, x - dx + ddx
                if 0 <= yy < rh and 0 <= xx < rw:
                    ctxv = (ctxv << 1) | int(ref[yy, xx])
                else:
                    ctxv <<= 1
            out[y, x] = mq.decode(cx, ctxv)
    return out


def encode_refinement(enc: MQEncoder, cx: Contexts, bitmap: np.ndarray,
                      template: int, at, ref: np.ndarray, dx: int, dy: int,
                      tpgron: bool = False) -> None:
    """Inverse of decode_refinement for the tests (same context walk).

    With TPGRON, a row enters LTP when every uniform-reference-window pixel
    already equals its prediction (so prediction is lossless for that row)."""
    cod, rpts = _r_templates(template, at)
    h, w = bitmap.shape
    rh, rw = ref.shape
    ltp = 0
    for y in range(h):
        if tpgron:
            want = all(
                _ref_window_uniform(ref, x - dx, y - dy)
                in (None, int(bitmap[y, x]))
                for x in range(w)
            )
            sltp = 1 if want != bool(ltp) else 0
            enc.encode(cx, _TPGR_CTX[template], sltp)
            ltp ^= sltp
        for x in range(w):
            if ltp and _ref_window_uniform(ref, x - dx, y - dy) is not None:
                continue
            ctxv = 0
            for ddx, ddy in cod:
                yy, xx = y + ddy, x + ddx
                if 0 <= yy < h and 0 <= xx < w and (yy < y or (yy == y and xx < x)):
                    ctxv = (ctxv << 1) | int(bitmap[yy, xx])
                else:
                    ctxv <<= 1
            for ddx, ddy in rpts:
                yy, xx = y - dy + ddy, x - dx + ddx
                if 0 <= yy < rh and 0 <= xx < rw:
                    ctxv = (ctxv << 1) | int(ref[yy, xx])
                else:
                    ctxv <<= 1
            enc.encode(cx, ctxv, int(bitmap[y, x]))


# ---------------------------------------------------------------------------
# Symbol dictionary (6.5) and text region (6.4), arithmetic variants
# ---------------------------------------------------------------------------


def _compose(dst: np.ndarray, src: np.ndarray, x: int, y: int, op: int) -> None:
    """Composite src onto dst at (x, y) with ComposeOp (OR/AND/XOR/XNOR/REPLACE)."""
    h, w = src.shape
    H, W = dst.shape
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x0 >= x1 or y0 >= y1:
        return
    sub = src[y0 - y : y1 - y, x0 - x : x1 - x]
    d = dst[y0:y1, x0:x1]
    if op == 0:
        d |= sub
    elif op == 1:
        d &= sub
    elif op == 2:
        d ^= sub
    elif op == 3:
        d[...] = 1 - (d ^ sub)
    else:
        d[...] = sub


def _place_symbol(bitmap: np.ndarray, sym: np.ndarray, curs: int, tt: int,
                  refcorner: int, transposed: int, comb_op: int) -> int:
    """6.4.5 step 3(c) symbol placement; returns the advanced CURS."""
    hs, ws = sym.shape
    if transposed:
        # S along y, T along x.
        if refcorner in (0, 1):  # BOTTOMLEFT / TOPLEFT
            x0 = tt
        else:
            x0 = tt - ws + 1
        _compose(bitmap, sym, x0, curs, comb_op)
        return curs + hs - 1
    if refcorner in (1, 3):  # TOPLEFT / TOPRIGHT
        y0 = tt
    else:  # BOTTOMLEFT / BOTTOMRIGHT
        y0 = tt - hs + 1
    _compose(bitmap, sym, curs, y0, comb_op)
    return curs + ws - 1


class _ArithIntCtx:
    """The named integer-decoding context sets of 6.4/6.5."""

    def __init__(self):
        self.sets: Dict[str, Contexts] = {}

    def get(self, name: str) -> Contexts:
        c = self.sets.get(name)
        if c is None:
            c = self.sets[name] = Contexts(512)
        return c


def decode_symbol_dict(mq: MQDecoder, flags: int, at, exflags_runs_allowed: bool,
                       num_ex: int, num_new: int,
                       input_symbols: List[np.ndarray],
                       rat=None) -> List[np.ndarray]:
    """6.5.5 arithmetic symbol dictionary: returns the exported symbols.

    SDREFAGG dictionaries (6.5.8.2) decode each symbol as a refinement of an
    earlier symbol (REFAGGNINST == 1) or as an embedded refining text region
    (REFAGGNINST > 1), sharing this dictionary's integer/IAID contexts."""
    sdhuff = flags & 1
    sdrefagg = (flags >> 1) & 1
    template = (flags >> 10) & 3
    rtemplate = (flags >> 12) & 1
    if sdhuff:
        raise ValueError("JBIG2: Huffman symbol dictionaries unsupported")
    ints = _ArithIntCtx()
    gb = Contexts(1 << 16)
    gr = Contexts(1 << 13)
    total = len(input_symbols) + num_new
    symcodelen = max(1, (total - 1).bit_length()) if total > 1 else 1
    iaid = Contexts(1 << (symcodelen + 1))
    new_symbols: List[np.ndarray] = []
    hcheight = 0
    while len(new_symbols) < num_new:
        dh = decode_int(mq, ints.get("IADH"))
        if dh is OOB:
            raise ValueError("JBIG2: OOB height class delta")
        hcheight += dh
        symwidth = 0
        while True:
            dw = decode_int(mq, ints.get("IADW"))
            if dw is OOB:
                break
            symwidth += dw
            if (hcheight < 0 or symwidth < 0 or hcheight > 5000
                    or symwidth > 5000 or hcheight * symwidth > 1_000_000):
                raise ValueError("JBIG2: implausible symbol size")
            if len(new_symbols) >= num_new:
                raise ValueError("JBIG2: too many symbols in dictionary")
            if sdrefagg:
                allsofar = list(input_symbols) + new_symbols
                refaggninst = decode_int(mq, ints.get("IAAI"))
                if refaggninst is OOB or refaggninst < 1:
                    raise ValueError("JBIG2: bad REFAGGNINST")
                if refaggninst == 1:
                    sid = decode_iaid(mq, iaid, symcodelen)
                    rdx = decode_int(mq, ints.get("IARDX"))
                    rdy = decode_int(mq, ints.get("IARDY"))
                    if rdx is OOB or rdy is OOB or sid >= len(allsofar):
                        raise ValueError("JBIG2: bad refinement reference")
                    bm = decode_refinement(
                        mq, gr, symwidth, hcheight, rtemplate, rat,
                        allsofar[sid], rdx, rdy, False,
                    )
                else:
                    # 6.5.8.2.1: an embedded text region of REFAGGNINST
                    # refining instances, sharing this dictionary's contexts.
                    bm = decode_text_region(
                        mq, symwidth, hcheight, refaggninst, allsofar, 0,
                        log_strips=0, refcorner=1, transposed=0, comb_op=0,
                        default_pixel=0, dsoffset=0,
                        refine=True, rtemplate=rtemplate, rat=rat,
                        ints=ints, iaid=iaid, gr=gr, symcodelen=symcodelen,
                    )
            else:
                bm = decode_generic(mq, gb, symwidth, hcheight, template, at, False)
            new_symbols.append(bm)
    # Export flags (6.5.10): alternating no-export/export runs over
    # input+new symbols.
    allsyms = list(input_symbols) + new_symbols
    exported: List[np.ndarray] = []
    i = 0
    cur = 0
    for _ in range(2 * len(allsyms) + 64):  # zero-runs only toggle phase
        if i >= len(allsyms) or len(exported) >= num_ex:
            break
        run = decode_int(mq, ints.get("IAEX"))
        if run is OOB or run < 0:
            raise ValueError("JBIG2: bad export run")
        if cur:
            exported.extend(allsyms[i : i + run])
        i += run
        cur ^= 1
    if len(exported) != num_ex:
        raise ValueError("JBIG2: export count mismatch")
    return exported


def decode_text_region(mq: MQDecoder, w: int, h: int, num_instances: int,
                       symbols: List[np.ndarray], flags: int,
                       log_strips: int, refcorner: int, transposed: int,
                       comb_op: int, default_pixel: int,
                       dsoffset: int,
                       refine: bool = False, rtemplate: int = 0, rat=None,
                       ints=None, iaid=None, gr=None,
                       symcodelen=None) -> np.ndarray:
    """6.4.5 arithmetic text region decoding -> (h, w) uint8.

    With ``refine`` each instance may refine its symbol (6.4.11: IARI gates,
    IARDW/IARDH/IARDX/IARDY size the refinement).  ``ints``/``iaid``/``gr``/
    ``symcodelen`` let a refining symbol dictionary share its contexts
    (6.5.8.2.1)."""
    sbstrips = 1 << log_strips
    if symcodelen is None:
        symcodelen = max(1, (len(symbols) - 1).bit_length()) if symbols else 1
    if ints is None:
        ints = _ArithIntCtx()
    if iaid is None:
        iaid = Contexts(1 << (symcodelen + 1))
    if gr is None:
        gr = Contexts(1 << 13)
    bitmap = np.full((h, w), default_pixel, dtype=np.uint8)
    if num_instances > w * h + 1024:
        raise ValueError("JBIG2: implausible instance count")
    stript = decode_int(mq, ints.get("IADT"))
    if stript is OOB:
        raise ValueError("JBIG2: bad IADT")
    stript *= -sbstrips
    firsts = 0
    inst = 0
    while inst < num_instances:
        dt = decode_int(mq, ints.get("IADT"))
        if dt is OOB:
            raise ValueError("JBIG2: bad IADT")
        stript += dt * sbstrips
        dfs = decode_int(mq, ints.get("IAFS"))
        if dfs is OOB:
            raise ValueError("JBIG2: bad IAFS")
        firsts += dfs
        curs = firsts
        first = True
        while True:
            if not first:
                ids = decode_int(mq, ints.get("IADS"))
                if ids is OOB:
                    break
                curs += ids + dsoffset
            first = False
            curt = decode_int(mq, ints.get("IAIT")) if sbstrips > 1 else 0
            if curt is OOB:
                raise ValueError("JBIG2: bad IAIT")
            tt = stript + curt
            sid = decode_iaid(mq, iaid, symcodelen)
            if sid >= len(symbols):
                raise ValueError("JBIG2: symbol id out of range")
            sym = symbols[sid]
            if refine:
                ri = decode_int(mq, ints.get("IARI"))
                if ri is OOB:
                    raise ValueError("JBIG2: bad IARI")
                if ri:
                    rdw = decode_int(mq, ints.get("IARDW"))
                    rdh = decode_int(mq, ints.get("IARDH"))
                    rdx = decode_int(mq, ints.get("IARDX"))
                    rdy = decode_int(mq, ints.get("IARDY"))
                    if OOB in (rdw, rdh, rdx, rdy):
                        raise ValueError("JBIG2: bad refinement deltas")
                    hs0, ws0 = sym.shape
                    if ws0 + rdw <= 0 or hs0 + rdh <= 0:
                        raise ValueError("JBIG2: empty refined symbol")
                    # GRREFERENCEDX/DY = floor(RDW/2)+RDX / floor(RDH/2)+RDY
                    sym = decode_refinement(
                        mq, gr, ws0 + rdw, hs0 + rdh, rtemplate, rat, sym,
                        (rdw >> 1) + rdx, (rdh >> 1) + rdy, False,
                    )
            curs = _place_symbol(bitmap, sym, curs, tt, refcorner,
                                 transposed, comb_op)
            inst += 1
            if inst > num_instances:
                raise ValueError("JBIG2: too many instances")
    return bitmap


def read_symbol_code_table(r: BitReader, nsyms: int) -> HuffmanTable:
    """Symbol-ID code assignment (7.4.3.1.7): 35 four-bit runcode lengths,
    then runcode-compressed per-symbol code lengths, canonical codes."""
    runlens = [r.read(4) for _ in range(35)]
    runtab = HuffmanTable(
        [(runlens[i], 0, i) for i in range(35) if runlens[i] > 0]
    )
    codelens: List[int] = []
    prev = 0
    while len(codelens) < nsyms:
        c = runtab.decode(r)
        if c is OOB or c > 34:
            raise ValueError("JBIG2: bad symbol runcode")
        if c < 32:
            codelens.append(c)
            prev = c
        elif c == 32:
            codelens.extend([prev] * (3 + r.read(2)))
        elif c == 33:
            codelens.extend([0] * (3 + r.read(3)))
        else:
            codelens.extend([0] * (11 + r.read(7)))
    if len(codelens) > nsyms:
        raise ValueError("JBIG2: runcode overrun")
    return HuffmanTable(
        [(codelens[i], 0, i) for i in range(nsyms) if codelens[i] > 0]
    )


def decode_text_region_huffman(
    r: BitReader, data: bytes, w: int, h: int, num_instances: int,
    symbols: List[np.ndarray], tabs: dict, log_strips: int, refcorner: int,
    transposed: int, comb_op: int, default_pixel: int, dsoffset: int,
    refine: bool, rtemplate: int, rat,
    embedded_symcodelen=None) -> np.ndarray:
    """6.4.5 Huffman text region decoding.  ``tabs`` holds the selected
    FS/DS/DT/RDW/RDH/RDX/RDY/RSIZE tables; the symbol-ID code table is read
    from ``r`` first (7.4.4.5), then the stream byte-aligns.

    With ``embedded_symcodelen`` the region is the aggregate bitmap of a
    Huffman symbol dictionary (6.5.8.2.1, Table 17): symbol IDs are plain
    fixed-length codes of that many bits and NO symbol-ID code table (or
    byte alignment) precedes the instance data."""
    sbstrips = 1 << log_strips
    if num_instances > w * h + 1024:
        raise ValueError("JBIG2: implausible instance count")
    if embedded_symcodelen is None:
        symtab = read_symbol_code_table(r, len(symbols))
        r.align()
    else:
        symtab = None
    bitmap = np.full((h, w), default_pixel, dtype=np.uint8)
    stript = tabs["DT"].decode(r)
    if stript is OOB:
        raise ValueError("JBIG2: bad DT")
    stript *= -sbstrips
    firsts = 0
    inst = 0
    while inst < num_instances:
        dt = tabs["DT"].decode(r)
        if dt is OOB:
            raise ValueError("JBIG2: bad DT")
        stript += dt * sbstrips
        dfs = tabs["FS"].decode(r)
        if dfs is OOB:
            raise ValueError("JBIG2: bad FS")
        firsts += dfs
        curs = firsts
        first = True
        while True:
            if not first:
                ids = tabs["DS"].decode(r)
                if ids is OOB:
                    break
                curs += ids + dsoffset
            first = False
            curt = r.read(log_strips) if sbstrips > 1 else 0
            tt = stript + curt
            sid = (symtab.decode(r) if symtab is not None
                   else r.read(embedded_symcodelen))
            if sid is OOB or sid >= len(symbols):
                raise ValueError("JBIG2: symbol id out of range")
            sym = symbols[sid]
            if refine and r.read_bit():
                rdw = tabs["RDW"].decode(r)
                rdh = tabs["RDH"].decode(r)
                rdx = tabs["RDX"].decode(r)
                rdy = tabs["RDY"].decode(r)
                bmsize = tabs["RSIZE"].decode(r)
                if OOB in (rdw, rdh, rdx, rdy, bmsize):
                    raise ValueError("JBIG2: bad refinement fields")
                r.align()
                start = r.byte_offset
                end = start + bmsize if bmsize else len(data)
                hs0, ws0 = sym.shape
                if ws0 + rdw <= 0 or hs0 + rdh <= 0:
                    raise ValueError("JBIG2: empty refined symbol")
                mq = MQDecoder(data[start:end])
                gr = Contexts(1 << 13)
                sym = decode_refinement(
                    mq, gr, ws0 + rdw, hs0 + rdh, rtemplate, rat, sym,
                    (rdw >> 1) + rdx, (rdh >> 1) + rdy, False,
                )
                if bmsize:
                    r.skip_bytes(bmsize)
                else:
                    r.pos = end * 8
            curs = _place_symbol(bitmap, sym, curs, tt, refcorner,
                                 transposed, comb_op)
            inst += 1
            if inst > num_instances:
                raise ValueError("JBIG2: too many instances")
    return bitmap


def decode_symbol_dict_huffman(
    data: bytes, o: int, flags: int, tables: List[HuffmanTable],
    num_ex: int, num_new: int, input_symbols: List[np.ndarray],
    rat) -> List[np.ndarray]:
    """6.5.5 Huffman symbol dictionary.  Height classes decode as one
    collective bitmap (raw when BMSIZE == 0, else MMR) split by widths;
    SDREFAGG dictionaries refine per symbol (REFAGGNINST == 1)."""
    sdrefagg = (flags >> 1) & 1
    rtemplate = (flags >> 12) & 1
    ti = iter(tables)

    def pick(sel, builtin):
        if sel < len(builtin) and builtin[sel]:
            return standard_table(builtin[sel])
        return next(ti)

    tdh = pick((flags >> 2) & 3, (4, 5, 0, 0))
    tdw = pick((flags >> 4) & 3, (2, 3, 0, 0))
    tbm = pick((flags >> 6) & 1, (1, 0))
    tag = pick((flags >> 7) & 1, (1, 0))
    r = BitReader(data, o)
    total = len(input_symbols) + num_new
    symcodelen = max(1, (total - 1).bit_length()) if total > 1 else 1
    new_symbols: List[np.ndarray] = []
    hcheight = 0
    while len(new_symbols) < num_new:
        dh = tdh.decode(r)
        if dh is OOB:
            raise ValueError("JBIG2: bad DH")
        hcheight += dh
        symwidth = 0
        totwidth = 0
        hcwidths: List[int] = []
        while True:
            dw = tdw.decode(r)
            if dw is OOB:
                break
            symwidth += dw
            if (hcheight < 0 or symwidth < 1 or hcheight > 5000
                    or symwidth > 5000 or hcheight * symwidth > 1_000_000):
                raise ValueError("JBIG2: implausible symbol size")
            if len(new_symbols) + len(hcwidths) >= num_new:
                raise ValueError("JBIG2: too many symbols in dictionary")
            totwidth += symwidth
            if sdrefagg:
                refaggninst = tag.decode(r)
                if refaggninst is OOB or refaggninst < 1:
                    raise ValueError("JBIG2: bad REFAGGNINST")
                allsofar = list(input_symbols) + new_symbols
                if refaggninst == 1:
                    # 6.5.8.2.2: single refinement of an earlier symbol.
                    sid = r.read(symcodelen)
                    rdx = standard_table(15).decode(r)
                    rdy = standard_table(15).decode(r)
                    bmsize = tbm.decode(r)  # SDHUFFBMSIZE (6.5.8.2.2)
                    if (OOB in (rdx, rdy, bmsize) or bmsize < 0
                            or sid >= len(allsofar)):
                        raise ValueError("JBIG2: bad refinement reference")
                    if bmsize == 0:
                        # An implicit-length refinement bitmap: resuming the
                        # Huffman stream would need the MQ decoder's exact
                        # byte consumption (ambiguous through its lookahead).
                        # Fail cleanly rather than silently eating the rest
                        # of the segment and corrupting later symbols.
                        raise ValueError(
                            "JBIG2: BMSIZE=0 refinement in symbol dictionary "
                            "unsupported"
                        )
                    r.align()
                    start = r.byte_offset
                    end = start + bmsize
                    mq = MQDecoder(data[start:end])
                    gr = Contexts(1 << 13)
                    bm = decode_refinement(
                        mq, gr, symwidth, hcheight, rtemplate, rat,
                        allsofar[sid], rdx, rdy, False,
                    )
                    r.pos = end * 8
                else:
                    # 6.5.8.2.1: aggregate bitmap as an embedded Huffman
                    # text region with the Table-17 parameter assignments
                    # (FS B.6, DS B.8, DT B.11, RD* B.15, RSIZE B.1;
                    # fixed-length symbol codes; TOPLEFT, OR, strips=1).
                    tabs17 = {
                        "FS": standard_table(6),
                        "DS": standard_table(8),
                        "DT": standard_table(11),
                        "RDW": standard_table(15),
                        "RDH": standard_table(15),
                        "RDX": standard_table(15),
                        "RDY": standard_table(15),
                        "RSIZE": standard_table(1),
                    }
                    bm = decode_text_region_huffman(
                        r, data, symwidth, hcheight, refaggninst, allsofar,
                        tabs17, log_strips=0, refcorner=1, transposed=0,
                        comb_op=0, default_pixel=0, dsoffset=0,
                        refine=True, rtemplate=rtemplate, rat=rat,
                        embedded_symcodelen=symcodelen,
                    )
                new_symbols.append(bm)
            else:
                hcwidths.append(symwidth)
        if not sdrefagg and hcwidths:
            bmsize = tbm.decode(r)
            if bmsize is OOB or bmsize < 0:
                raise ValueError("JBIG2: bad BMSIZE")
            r.align()
            start = r.byte_offset
            if bmsize == 0:
                # collective bitmap stored uncompressed, row-padded (6.5.9)
                rowbytes = (totwidth + 7) // 8
                end = start + rowbytes * hcheight
                raw = np.frombuffer(data[start:end], dtype=np.uint8)
                if raw.size != rowbytes * hcheight:
                    raise ValueError("JBIG2: truncated collective bitmap")
                coll = np.unpackbits(
                    raw.reshape(hcheight, rowbytes), axis=1
                )[:, :totwidth]
                r.pos = end * 8
            else:
                from . import ccitt

                packed = ccitt.ccitt_decode(
                    data[start : start + bmsize], columns=totwidth,
                    rows=hcheight, k=-1, black_is_1=True, end_of_block=False,
                )
                coll = np.unpackbits(
                    np.frombuffer(packed, dtype=np.uint8).reshape(hcheight, -1),
                    axis=1,
                )[:, :totwidth]
                r.skip_bytes(bmsize)
            x0 = 0
            for wk in hcwidths:
                new_symbols.append(coll[:, x0 : x0 + wk].copy())
                x0 += wk
        elif not sdrefagg:
            continue
    # Export flags (6.5.10): run lengths via Table B.1 under SDHUFF.
    allsyms = list(input_symbols) + new_symbols
    exported: List[np.ndarray] = []
    i = 0
    cur = 0
    for _ in range(2 * len(allsyms) + 64):  # zero-runs only toggle phase
        if i >= len(allsyms) or len(exported) >= num_ex:
            break
        run = standard_table(1).decode(r)
        if run is OOB or run < 0:
            raise ValueError("JBIG2: bad export run")
        if cur:
            exported.extend(allsyms[i : i + run])
        i += run
        cur ^= 1
    if len(exported) != num_ex:
        raise ValueError("JBIG2: export count mismatch")
    return exported


# ---------------------------------------------------------------------------
# Segment stream parsing (7.2) and page assembly
# ---------------------------------------------------------------------------


class Segment:
    __slots__ = ("number", "type", "referred", "page", "data")

    def __init__(self, number, type_, referred, page, data):
        self.number = number
        self.type = type_
        self.referred = referred
        self.page = page
        self.data = data


def parse_segments(data: bytes) -> List[Segment]:
    out = []
    o = 0
    n = len(data)
    while o + 11 <= n:
        number, flags = struct.unpack_from(">IB", data, o)
        o += 5
        seg_type = flags & 0x3F
        page_assoc_4 = bool(flags & 0x40)
        rts = data[o]
        count = rts >> 5
        if count == 7:
            count = struct.unpack_from(">I", data, o)[0] & 0x1FFFFFFF
            o += 4 + (count + 8) // 8  # 4-byte count + retain bits
        else:
            o += 1
        if number <= 256:
            refsize = 1
        elif number <= 65536:
            refsize = 2
        else:
            refsize = 4
        referred = []
        for _ in range(count):
            if refsize == 1:
                referred.append(data[o])
            elif refsize == 2:
                referred.append(struct.unpack_from(">H", data, o)[0])
            else:
                referred.append(struct.unpack_from(">I", data, o)[0])
            o += refsize
        if page_assoc_4:
            page = struct.unpack_from(">I", data, o)[0]
            o += 4
        else:
            page = data[o]
            o += 1
        (length,) = struct.unpack_from(">I", data, o)
        o += 4
        if length == 0xFFFFFFFF:
            raise ValueError("JBIG2: unknown-length segment unsupported")
        seg = Segment(number, seg_type, referred, page, data[o : o + length])
        o += length
        out.append(seg)
    return out


def _region_info(data: bytes) -> Tuple[int, int, int, int, int, int]:
    """Region segment information field (7.4.1): w, h, x, y, op, offset."""
    w, h, x, y = struct.unpack_from(">IIII", data, 0)
    if w * h > 64_000_000 or w < 1 or h < 1:
        # shared sanity cap: a corrupted header must not drive a
        # multi-gigabyte allocation (text/halftone/refinement regions
        # allocate (h, w) up front)
        raise ValueError("JBIG2: implausible region size")
    op = data[16] & 7
    return w, h, x, y, op, 17


def _read_at(data: bytes, o: int, count: int):
    at = []
    for _ in range(count):
        ax = struct.unpack_from(">b", data, o)[0]
        ay = struct.unpack_from(">b", data, o + 1)[0]
        at.append((ax, ay))
        o += 2
    return at, o


def _decode_generic_segment(seg: Segment) -> Tuple[np.ndarray, int, int, int]:
    data = seg.data
    w, h, x, y, op, o = _region_info(data)
    flags = data[o]
    o += 1
    mmr = flags & 1
    template = (flags >> 1) & 3
    tpgdon = bool((flags >> 3) & 1)
    if w * h > 64_000_000:
        raise ValueError("JBIG2: implausible region size")
    if mmr:
        from . import ccitt

        # MMR == T.6: reuse the CCITT G4 decoder; black_is_1 yields packed
        # rows with 1 = black, the JBIG2 convention.
        packed = ccitt.ccitt_decode(data[o:], columns=w, rows=h, k=-1,
                                    black_is_1=True, end_of_block=False)
        bits = np.unpackbits(
            np.frombuffer(packed, dtype=np.uint8).reshape(h, -1), axis=1
        )[:, :w]
        bitmap = bits.astype(np.uint8)
    else:
        at, o = _read_at(data, o, _AT_COUNT[template])
        from .. import native_lib

        got = native_lib.jbig2_generic_region(data[o:], w, h, template, at, tpgdon)
        if got is not NotImplemented:
            bitmap = got
        else:
            mq = MQDecoder(data[o:])
            cx = Contexts(1 << 16)
            bitmap = decode_generic(mq, cx, w, h, template, at, tpgdon)
    return bitmap, x, y, op


def _decode_symbol_segment(seg: Segment, dicts: Dict[int, List[np.ndarray]],
                           tables: Dict[int, HuffmanTable]):
    data = seg.data
    flags = struct.unpack_from(">H", data, 0)[0]
    o = 2
    sdhuff = flags & 1
    sdrefagg = (flags >> 1) & 1
    template = (flags >> 10) & 3
    rtemplate = (flags >> 12) & 1
    at = None
    if not sdhuff:
        at, o = _read_at(data, o, _AT_COUNT[template])
    rat = None
    if sdrefagg and rtemplate == 0:
        rat, o = _read_at(data, o, 2)
    num_ex, num_new = struct.unpack_from(">II", data, o)
    o += 8
    if num_new > 100_000 or num_ex > 100_000:
        raise ValueError("JBIG2: implausible symbol count")
    input_symbols: List[np.ndarray] = []
    reftables: List[HuffmanTable] = []
    for r in seg.referred:
        input_symbols.extend(dicts.get(r, []))
        if r in tables:
            reftables.append(tables[r])
    if sdhuff:
        exported = decode_symbol_dict_huffman(
            data, o, flags, reftables, num_ex, num_new, input_symbols, rat,
        )
    else:
        mq = MQDecoder(data[o:])
        exported = decode_symbol_dict(mq, flags, at, True, num_ex, num_new,
                                      input_symbols, rat=rat)
    dicts[seg.number] = exported


def _decode_text_segment(seg: Segment, dicts: Dict[int, List[np.ndarray]],
                         tables: Dict[int, HuffmanTable]):
    data = seg.data
    w, h, x, y, op, o = _region_info(data)
    flags = struct.unpack_from(">H", data, o)[0]
    o += 2
    sbhuff = flags & 1
    refine = (flags >> 1) & 1
    log_strips = (flags >> 2) & 3
    refcorner = (flags >> 4) & 3
    transposed = (flags >> 6) & 1
    comb_op = (flags >> 7) & 3
    default_pixel = (flags >> 9) & 1
    dsoffset = (flags >> 10) & 0x1F
    if dsoffset > 15:
        dsoffset -= 32  # 5-bit signed
    rtemplate = (flags >> 15) & 1
    hflags = 0
    if sbhuff:
        hflags = struct.unpack_from(">H", data, o)[0]
        o += 2
    rat = None
    if refine and rtemplate == 0:
        rat, o = _read_at(data, o, 2)
    (num_instances,) = struct.unpack_from(">I", data, o)
    o += 4
    symbols: List[np.ndarray] = []
    reftables: List[HuffmanTable] = []
    for r in seg.referred:
        symbols.extend(dicts.get(r, []))
        if r in tables:
            reftables.append(tables[r])
    if sbhuff:
        ti = iter(reftables)

        def pick(sel, builtin):
            if sel < len(builtin) and builtin[sel]:
                return standard_table(builtin[sel])
            return next(ti)

        tabs = {
            "FS": pick(hflags & 3, (6, 7, 0, 0)),
            "DS": pick((hflags >> 2) & 3, (8, 9, 10, 0)),
            "DT": pick((hflags >> 4) & 3, (11, 12, 13, 0)),
            "RDW": pick((hflags >> 6) & 3, (14, 15, 0, 0)),
            "RDH": pick((hflags >> 8) & 3, (14, 15, 0, 0)),
            "RDX": pick((hflags >> 10) & 3, (14, 15, 0, 0)),
            "RDY": pick((hflags >> 12) & 3, (14, 15, 0, 0)),
            "RSIZE": pick((hflags >> 14) & 1, (1, 0)),
        }
        r = BitReader(data, o)
        bitmap = decode_text_region_huffman(
            r, data, w, h, num_instances, symbols, tabs, log_strips,
            refcorner, transposed, comb_op, default_pixel, dsoffset,
            bool(refine), rtemplate, rat,
        )
    else:
        mq = MQDecoder(data[o:])
        bitmap = decode_text_region(
            mq, w, h, num_instances, symbols, flags, log_strips, refcorner,
            transposed, comb_op, default_pixel, dsoffset,
            refine=bool(refine), rtemplate=rtemplate, rat=rat,
        )
    return bitmap, x, y, op


def _decode_pattern_segment(seg: Segment) -> List[np.ndarray]:
    """Pattern dictionary (7.4.8 / 6.7): one collective generic region of
    (GRAYMAX+1) HDPW-wide patterns, split by index."""
    data = seg.data
    flags = data[0]
    hdmmr = flags & 1
    template = (flags >> 1) & 3
    hdpw, hdph = data[1], data[2]
    (graymax,) = struct.unpack_from(">I", data, 3)
    o = 7
    if hdpw < 1 or hdph < 1 or graymax > 4095:
        raise ValueError("JBIG2: bad pattern dictionary")
    w = (graymax + 1) * hdpw
    if hdmmr:
        from . import ccitt

        packed = ccitt.ccitt_decode(data[o:], columns=w, rows=hdph, k=-1,
                                    black_is_1=True, end_of_block=False)
        coll = np.unpackbits(
            np.frombuffer(packed, dtype=np.uint8).reshape(hdph, -1), axis=1
        )[:, :w].astype(np.uint8)
    else:
        at = [(-hdpw, 0), (-3, -1), (2, -2), (-2, -2)][: _AT_COUNT[template]]
        mq = MQDecoder(data[o:])
        cx = Contexts(1 << 16)
        coll = decode_generic(mq, cx, w, hdph, template, at, False)
    return [coll[:, k * hdpw : (k + 1) * hdpw].copy()
            for k in range(graymax + 1)]


def decode_grayscale(data: bytes, o: int, mmr: bool, template: int,
                     w: int, h: int, bits: int, skip=None) -> np.ndarray:
    """Gray-coded bitplane image decoding (Annex C) -> (h, w) int values.

    Arithmetic planes share one MQ coder and context set; MMR planes are
    one continuous MMR stream of bits*h rows (C.5)."""
    planes = []
    if mmr:
        from . import ccitt

        packed = ccitt.ccitt_decode(data[o:], columns=w, rows=bits * h,
                                    k=-1, black_is_1=True, end_of_block=False)
        allrows = np.unpackbits(
            np.frombuffer(packed, dtype=np.uint8).reshape(bits * h, -1),
            axis=1,
        )[:, :w].astype(np.uint8)
        planes = [allrows[j * h : (j + 1) * h] for j in range(bits)]
    else:
        at = ([(3 if template <= 1 else 2, -1), (-3, -1), (2, -2), (-2, -2)]
              [: _AT_COUNT[template]])
        mq = MQDecoder(data[o:])
        cx = Contexts(1 << 16)
        for _ in range(bits):
            planes.append(
                decode_generic(mq, cx, w, h, template, at, False, skip=skip)
            )
    # planes[0] is the MSB (decoded first); gray-decode downward.
    value = planes[0].astype(np.int32)
    prev = planes[0].astype(np.int32)
    for p in planes[1:]:
        bit = p.astype(np.int32) ^ prev
        value = (value << 1) | bit
        prev = bit
    return value


def _decode_halftone_segment(seg: Segment,
                             patterns: Dict[int, List[np.ndarray]]):
    """Halftone region (7.4.9 / 6.6): grayscale image indexes the referred
    pattern dictionary; patterns composite along the skewed grid."""
    data = seg.data
    w, h, x, y, op, o = _region_info(data)
    flags = data[o]
    o += 1
    hmmr = flags & 1
    template = (flags >> 1) & 3
    enableskip = (flags >> 3) & 1
    comb_op = (flags >> 4) & 7
    defpixel = (flags >> 7) & 1
    hgw, hgh, hgx, hgy = struct.unpack_from(">IIii", data, o)
    o += 16
    hrx, hry = struct.unpack_from(">HH", data, o)
    o += 4
    pats: List[np.ndarray] = []
    for r in seg.referred:
        pats.extend(patterns.get(r, []))
    if not pats:
        raise ValueError("JBIG2: halftone region without pattern dictionary")
    if hgw * hgh > 16_000_000:
        raise ValueError("JBIG2: implausible halftone grid")
    hph, hpw = pats[0].shape
    bits = max(1, (len(pats) - 1).bit_length())
    # Cell origins on the (possibly skewed) grid, 1/256-pixel units (6.6.5).
    mg = np.arange(hgh, dtype=np.int64)[:, None]
    ng = np.arange(hgw, dtype=np.int64)[None, :]
    cx = (hgx + mg * hry + ng * hrx) >> 8
    cy = (hgy + mg * hrx - ng * hry) >> 8
    skip = None
    if enableskip:
        skip = ((cx + hpw <= 0) | (cx >= w) | (cy + hph <= 0)
                | (cy >= h)).astype(np.uint8)
    gray = decode_grayscale(data, o, hmmr, template, hgw, hgh, bits,
                            skip=skip)
    bitmap = np.full((h, w), defpixel, dtype=np.uint8)
    npat = len(pats)
    for m in range(hgh):
        for n in range(hgw):
            if skip is not None and skip[m, n]:
                continue
            gi = int(gray[m, n])
            if gi >= npat:
                gi = npat - 1  # clamp out-of-range gray values
            _compose(bitmap, pats[gi], int(cx[m, n]), int(cy[m, n]), comb_op)
    return bitmap, x, y, op


def _decode_refinement_segment(seg: Segment, page: np.ndarray):
    """Refinement region segment (7.4.7): refines the page region in place
    (the already-composed page pixels under the region are the reference)."""
    data = seg.data
    w, h, x, y, op, o = _region_info(data)
    flags = data[o]
    o += 1
    template = flags & 1
    tpgron = bool((flags >> 1) & 1)
    rat = None
    if template == 0:
        rat, o = _read_at(data, o, 2)
    H, W = page.shape
    ref = np.zeros((h, w), dtype=np.uint8)
    y1, x1 = min(H, y + h), min(W, x + w)
    if y < y1 and x < x1:
        ref[: y1 - y, : x1 - x] = page[y:y1, x:x1]
    mq = MQDecoder(data[o:])
    cx = Contexts(1 << 13)
    bitmap = decode_refinement(mq, cx, w, h, template, rat, ref, 0, 0, tpgron)
    return bitmap, x, y, op


def decode_jbig2(data: bytes, globals_data: Optional[bytes],
                 width: int, height: int) -> bytes:
    """Decode the PDF JBIG2Decode payload (embedded stream format: raw
    segment sequence, optionally preceded by /JBIG2Globals segments) into
    packed 1-bpp rows, INVERTED so 0 = black (see module docstring)."""
    segments: List[Segment] = []
    if globals_data:
        segments.extend(parse_segments(globals_data))
    segments.extend(parse_segments(data))
    if not any(
        s.type in (0, 4, 6, 7, 16, 20, 22, 23, 36, 38, 39, 40, 42, 43, 48)
        for s in segments
    ):
        raise ValueError("JBIG2: no decodable segments")
    page = np.zeros((height, width), dtype=np.uint8)
    page_default_set = False
    dicts: Dict[int, List[np.ndarray]] = {}
    tables: Dict[int, HuffmanTable] = {}
    patterns: Dict[int, List[np.ndarray]] = {}
    for seg in segments:
        t = seg.type
        if t == 48:  # page information
            if len(seg.data) >= 17:
                pflags = seg.data[16]
                if (pflags >> 2) & 1 and not page_default_set:
                    page[...] = 1
                page_default_set = True
        elif t == 0:  # symbol dictionary
            _decode_symbol_segment(seg, dicts, tables)
        elif t == 16:  # pattern dictionary
            patterns[seg.number] = _decode_pattern_segment(seg)
        elif t in (20, 22, 23):  # halftone region
            bitmap, x, y, op = _decode_halftone_segment(seg, patterns)
            _compose(page, bitmap, x, y, op)
        elif t == 53:  # custom Huffman table
            tables[seg.number] = parse_table_segment(seg.data)
        elif t in (36, 38, 39):  # generic region (intermediate/immediate)
            bitmap, x, y, op = _decode_generic_segment(seg)
            _compose(page, bitmap, x, y, op)
        elif t in (4, 6, 7):  # text region
            bitmap, x, y, op = _decode_text_segment(seg, dicts, tables)
            _compose(page, bitmap, x, y, op)
        elif t in (40, 42, 43):  # refinement region
            bitmap, x, y, op = _decode_refinement_segment(seg, page)
            # The refined bitmap REPLACES the page region it refined
            # (6.3: the result is the new region value), regardless of
            # the nominal external combination operator.
            _compose(page, bitmap, x, y, 4)
        elif t in (49, 50, 51, 62):  # end-of-page/stripe/file, extension
            continue
        # unknown segment types are skipped
    packed = np.packbits(page, axis=1)
    return (~packed).tobytes()
