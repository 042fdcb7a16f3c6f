"""From-scratch JPEG (DCTDecode) decoder — no third-party codec.

The port's copy of ``coherence_tpu.io.jpeg``, whole.

Parity: camlpdf links a full codec surface into the reference
(the reference's Makefile:20); every other codec in this IO stack (JBIG2,
CCITT, LZW, Flate predictors, AES) is built from scratch, and this closes
the last third-party dependency in the core decode path (VERDICT r3 item 3).

Supports baseline (SOF0), extended sequential (SOF1) and progressive (SOF2)
Huffman JPEGs plus sequential (SOF9) and progressive (SOF10)
arithmetic-coded JPEGs (T.81 Annex D QM coder, DAC conditioning): restart
intervals, arbitrary integral subsampling, 1/3/4 components, Adobe APP14
colour transforms (YCbCr / YCCK per TN #5116).

The arithmetic is libjpeg's, reproduced from its published algorithms so
output is BYTE-IDENTICAL to PIL (which wraps libjpeg/-turbo — the test
oracle, tests/test_jpeg.py):

* IDCT: the Loeffler-Ligtenberg-Moshovitz 13-bit fixed-point "islow" DCT
  (AAN scaling folded into the quantizer is NOT used — islow is what
  libjpeg picks by default), with the post-IDCT wrap-around range-limit
  table rather than a plain clamp.
* Upsampling: "fancy" (triangle-filter) h2v1/h2v2 paths with libjpeg's
  exact edge cases and rounding; integer replication for other ratios.
* Colour: 16-bit fixed-point YCbCr->RGB / YCCK->CMYK tables with the
  shared range-limit.

Heavy stages (dequantize+IDCT over all blocks, upsampling, colour) are
vectorized numpy; only the entropy-coded scan walks byte-by-byte in Python.
Corrupt streams raise ValueError — they must fail cleanly, never hang
(same bar as io/jbig2.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# --- constants (ITU T.81 + libjpeg fixed-point tables) -----------------------

ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int32)

CONST_BITS, PASS1_BITS = 13, 2
F_0_298631336 = 2446
F_0_390180644 = 3196
F_0_541196100 = 4433
F_0_765366865 = 6270
F_0_899976223 = 7373
F_1_175875602 = 9633
F_1_501321110 = 12299
F_1_847759065 = 15137
F_1_961570560 = 16069
F_2_053119869 = 16819
F_2_562915447 = 20995
F_3_072711026 = 25172

# Post-IDCT range limit: out = RL[x & 1023] == libjpeg's
# range_limit[(DESCALE(...)) & RANGE_MASK] with range_limit pointing
# CENTERJSAMPLE into the 5*256+128 sample_range_limit table (jdmaster.c):
# the +128 level shift, clamping, and the wrap-around for wild values.
_RL = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128),
]).astype(np.uint8)

# Full sample_range_limit with negative subscripts (index + 256), used by
# the colour converters where indices span [-256, 1151].
_SRL = np.zeros(1408, dtype=np.uint8)
_SRL[256:512] = np.arange(256)          # identity
_SRL[512:896] = 255                     # clamp high
_SRL[1280:1408] = np.arange(128)        # wrap tail


def _srl(idx):
    return _SRL[np.clip(idx + 256, 0, 1407)]


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_I = np.arange(256, dtype=np.int64)
_X = _I - 128
CR_R_TAB = (_fix(1.40200) * _X + _ONE_HALF) >> _SCALEBITS
CB_B_TAB = (_fix(1.77200) * _X + _ONE_HALF) >> _SCALEBITS
CR_G_TAB = (-_fix(0.71414)) * _X
CB_G_TAB = (-_fix(0.34414)) * _X + _ONE_HALF


class JpegError(ValueError):
    pass


# --- Huffman ------------------------------------------------------------------


class HuffTable:
    """Canonical Huffman decode table with an 8-bit fast first level."""

    __slots__ = ("mincode", "maxcode", "valptr", "values", "fast")

    def __init__(self, counts: List[int], values: bytes):
        if sum(counts) != len(values) or sum(counts) > 256:
            raise JpegError("bad DHT")
        self.values = values
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        code = 0
        k = 0
        for l in range(1, 17):
            self.valptr[l] = k
            self.mincode[l] = code
            code += counts[l - 1]
            k += counts[l - 1]
            self.maxcode[l] = code - 1
            code <<= 1
        # fast[b] = (value << 4) | codelength for all 8-bit prefixes b whose
        # leading bits form a complete code of length <= 8; 0xFFFF = slow.
        self.fast = np.full(256, 0xFFFF, dtype=np.uint16)
        code = 0
        k = 0
        for l in range(1, 9):
            for _ in range(counts[l - 1]):
                lo = code << (8 - l)
                self.fast[lo : lo + (1 << (8 - l))] = (values[k] << 4) | l
                code += 1
                k += 1
            code <<= 1


class BitReader:
    """MSB-first reader over entropy-coded data with 0xFF00 unstuffing.

    A marker (0xFF xx, xx not 0/RST) ends the segment: further reads yield
    zero bits, like libjpeg's "insert dummy zeroes" recovery, and the
    position stays at the marker for the scan loop to inspect."""

    __slots__ = ("data", "pos", "acc", "nbits", "end")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.end = False

    def _fill(self):
        data, pos = self.data, self.pos
        while self.nbits <= 24:
            if self.end or pos >= len(data):
                self.end = True
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            b = data[pos]
            if b == 0xFF:
                nxt = data[pos + 1] if pos + 1 < len(data) else 0xD9
                if nxt == 0x00:
                    pos += 2
                else:
                    self.end = True  # marker: stop consuming
                    continue
            else:
                pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.nbits += 8
        self.pos = pos

    def peek8(self) -> int:
        if self.nbits < 8:
            self._fill()
        return (self.acc >> (self.nbits - 8)) & 0xFF

    def get_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def get_bit(self) -> int:
        if self.nbits < 1:
            self._fill()
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def decode(self, table: HuffTable) -> int:
        f = int(table.fast[self.peek8()])
        if f != 0xFFFF:
            self.nbits -= f & 0xF
            return f >> 4
        code = self.get_bits(8)
        for l in range(9, 17):
            code = (code << 1) | self.get_bit()
            if code <= table.maxcode[l]:
                return table.values[table.valptr[l] + code - table.mincode[l]]
        raise JpegError("bad Huffman code")

    def restart(self):
        """Byte-align and consume an RSTn marker."""
        self.nbits = 0
        self.acc = 0
        data = self.data
        pos = self.pos
        # Skip to the marker (libjpeg tolerates fill bytes).
        while pos + 1 < len(data) and not (
            data[pos] == 0xFF and 0xD0 <= data[pos + 1] <= 0xD7
        ):
            pos += 1
        if pos + 1 >= len(data):
            raise JpegError("missing restart marker")
        self.pos = pos + 2
        self.end = False


def _extend(v: int, t: int) -> int:
    return v - (1 << t) + 1 if v < (1 << (t - 1)) else v


# --- arithmetic entropy coding (T.81 Annex D/F, SOF9/SOF10) ---------------------

# QM-coder probability estimation state machine, T.81 Table D.3 (the same
# published table libjpeg ships as jpeg_aritab): (Qe, NMPS, NLPS, SWITCH).
# Entry 113 is the non-adapting 0.5-probability state used for sign bits
# ("fixed bin", F.1.4.4.1.1).
_ARITAB = [
    (0x5A1D,1,1,1), (0x2586,2,14,0), (0x1114,3,16,0), (0x080B,4,18,0),
    (0x03D8,5,20,0), (0x01DA,6,23,0), (0x00E5,7,25,0), (0x006F,8,28,0),
    (0x0036,9,30,0), (0x001A,10,33,0), (0x000D,11,35,0), (0x0006,12,9,0),
    (0x0003,13,10,0), (0x0001,13,12,0), (0x5A7F,15,15,1), (0x3F25,16,36,0),
    (0x2CF2,17,38,0), (0x207C,18,39,0), (0x17B9,19,40,0), (0x1182,20,42,0),
    (0x0CEF,21,43,0), (0x09A1,22,45,0), (0x072F,23,46,0), (0x055C,24,48,0),
    (0x0406,25,49,0), (0x0303,26,51,0), (0x0240,27,52,0), (0x01B1,28,54,0),
    (0x0144,29,56,0), (0x00F5,30,57,0), (0x00B7,31,59,0), (0x008A,32,60,0),
    (0x0068,33,62,0), (0x004E,34,63,0), (0x003B,35,32,0), (0x002C,9,33,0),
    (0x5AE1,37,37,1), (0x484C,38,64,0), (0x3A0D,39,65,0), (0x2EF1,40,67,0),
    (0x261F,41,68,0), (0x1F33,42,69,0), (0x19A8,43,70,0), (0x1518,44,72,0),
    (0x1177,45,73,0), (0x0E74,46,74,0), (0x0BFB,47,75,0), (0x09F8,48,77,0),
    (0x0861,49,78,0), (0x0706,50,79,0), (0x05CD,51,48,0), (0x04DE,52,50,0),
    (0x040F,53,50,0), (0x0363,54,51,0), (0x02D4,55,52,0), (0x025C,56,53,0),
    (0x01F8,57,54,0), (0x01A4,58,55,0), (0x0160,59,56,0), (0x0125,60,57,0),
    (0x00F6,61,58,0), (0x00CB,62,59,0), (0x00AB,63,61,0), (0x008F,32,61,0),
    (0x5B12,65,65,1), (0x4D04,66,80,0), (0x412C,67,81,0), (0x37D8,68,82,0),
    (0x2FE8,69,83,0), (0x293C,70,84,0), (0x2379,71,86,0), (0x1EDF,72,87,0),
    (0x1AA9,73,87,0), (0x174E,74,72,0), (0x1424,75,72,0), (0x119C,76,74,0),
    (0x0F6B,77,74,0), (0x0D51,78,75,0), (0x0BB6,79,77,0), (0x0A40,48,77,0),
    (0x5832,81,80,1), (0x4D1C,82,88,0), (0x438E,83,89,0), (0x3BDD,84,90,0),
    (0x34EE,85,91,0), (0x2EAE,86,92,0), (0x299A,87,93,0), (0x2516,71,86,0),
    (0x5570,89,88,1), (0x4CA9,90,95,0), (0x44D9,91,96,0), (0x3E22,92,97,0),
    (0x3824,93,99,0), (0x32B4,94,99,0), (0x2E17,86,93,0), (0x56A8,96,95,1),
    (0x4F46,97,101,0), (0x47E5,98,102,0), (0x41CF,99,103,0), (0x3C3D,100,104,0),
    (0x375E,93,99,0), (0x5231,102,105,0), (0x4C0F,103,106,0), (0x4639,104,107,0),
    (0x415E,99,103,0), (0x5627,106,105,1), (0x50E7,107,108,0), (0x4B85,103,109,0),
    (0x5597,109,110,0), (0x504F,107,111,0), (0x5A10,111,110,1), (0x5522,109,112,0),
    (0x59EB,111,112,1), (0x5A1D,113,113,0),
]
_AR_QE = [r[0] for r in _ARITAB]
_AR_NMPS = [r[1] for r in _ARITAB]
_AR_NLPS = [r[2] for r in _ARITAB]
_AR_SW = [r[3] for r in _ARITAB]


class ArithDecoder:
    """T.81 F.2.2 QM decoder over entropy-coded data.

    Register layout follows libjpeg's jdarith (the C register is compared
    against ``(A - Qe) << ct``), which is arithmetically identical to the
    Figure F.20 flowcharts.  Hitting a marker is legal mid-scan: the
    decoder records it and feeds zero bytes until the scan logic stops.

    Statistics areas are plain bytearrays holding ``index | mps << 7``;
    ``decode(st, i)`` decodes one decision with the state at ``st[i]``.
    """

    __slots__ = ("data", "pos", "c", "a", "ct", "marker")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.reset()

    def reset(self):
        self.c = 0
        self.a = 0
        self.ct = -16  # force loading two initial bytes
        self.marker = -1

    def _byte(self) -> int:
        if self.marker >= 0:
            return 0  # past a marker: feed zeros until the scan ends
        data, pos = self.data, self.pos
        if pos >= len(data):
            self.marker = 0xD9
            return 0
        b = data[pos]
        pos += 1
        if b == 0xFF:
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1  # swallow fill bytes
            nxt = data[pos] if pos < len(data) else 0xD9
            if nxt == 0x00:
                pos += 1  # stuffed zero: the data byte is 0xFF
            else:
                self.marker = nxt  # stop BEFORE the marker
                return 0
        self.pos = pos
        return b

    def decode(self, st: bytearray, i: int) -> int:
        # Renormalize + feed input (F.2.2.6).
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = ((c << 8) | self._byte()) & 0xFFFFFFFF
                ct += 8
                if ct < 0:
                    ct += 1  # still loading the two initial bytes
                    if ct == 0:
                        a = 0x8000  # doubles to 0x10000 below
            a <<= 1
        sv = st[i]
        mps = sv >> 7
        idx = sv & 0x7F
        qe = _AR_QE[idx]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            # Code fell in the upper (LPS) subinterval; conditional
            # exchange decodes the MPS instead when Qe grew past the MPS
            # subinterval (F.2.2.2).
            if a < qe:
                bit = mps
                st[i] = (mps << 7) | _AR_NMPS[idx]
            else:
                bit = mps ^ 1
                st[i] = ((mps ^ _AR_SW[idx]) << 7) | _AR_NLPS[idx]
            a = qe
        elif a < 0x8000:
            # MPS renormalization pending; conditional exchange (F.2.2.1)
            if a < qe:
                bit = mps ^ 1
                st[i] = ((mps ^ _AR_SW[idx]) << 7) | _AR_NLPS[idx]
            else:
                bit = mps
                st[i] = (mps << 7) | _AR_NMPS[idx]
        else:
            bit = mps
        self.a, self.c, self.ct = a, c, ct
        return bit

    def restart(self):
        """Consume the pending RSTn marker and reinitialize (F.2.1.3.4)."""
        data = self.data
        if self.marker < 0:
            # The coder may not have pulled bytes up to the marker yet.
            pos = self.pos
            while pos + 1 < len(data) and not (
                data[pos] == 0xFF and 0xD0 <= data[pos + 1] <= 0xD7
            ):
                pos += 1
            if pos + 1 >= len(data):
                raise JpegError("missing restart marker")
            self.pos = pos + 2
        else:
            if not 0xD0 <= self.marker <= 0xD7:
                raise JpegError("missing restart marker")
            # self.pos sits just before the 0xFF of the marker: skip it.
            pos = self.pos
            while pos + 1 < len(data) and not (
                data[pos] == 0xFF and data[pos + 1] == self.marker
            ):
                pos += 1
            self.pos = min(pos + 2, len(data))
        self.reset()


# --- frame / component state ---------------------------------------------------


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    blocks_w: int = 0      # full (MCU-padded) block columns
    blocks_h: int = 0
    ds_w: int = 0          # downsampled sample dims (ceil(W*h/hmax))
    ds_h: int = 0
    coefs: Optional[np.ndarray] = None  # (blocks_h, blocks_w, 64) int16
    dc_pred: int = 0
    dc_ctx: int = 0  # arithmetic DC conditioning context (F.1.4.4.1.2)
    td: int = 0
    ta: int = 0


@dataclass
class Frame:
    progressive: bool
    precision: int
    width: int
    height: int
    comps: List[Component] = field(default_factory=list)
    hmax: int = 1
    vmax: int = 1
    mcus_x: int = 0
    mcus_y: int = 0
    arith: bool = False


@dataclass
class Decoded:
    """pixels: (h, w, n) uint8 in the JPEG's output colour model:
    n=1 grayscale, n=3 RGB, n=4 true (un-inverted) CMYK."""

    pixels: np.ndarray
    n_components: int
    adobe_transform: Optional[int]


# --- decoder -------------------------------------------------------------------


def decode(data: bytes) -> Decoded:
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise JpegError("not a JPEG (no SOI)")
    pos = 2
    qtabs: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, HuffTable] = {}
    ac_tabs: Dict[int, HuffTable] = {}
    dc_cond: Dict[int, Tuple[int, int]] = {}  # DAC: (L, U), default (0, 1)
    ac_cond: Dict[int, int] = {}  # DAC: Kx, default 5
    frame: Optional[Frame] = None
    restart_interval = 0
    adobe_transform: Optional[int] = None
    saw_adobe = saw_jfif = False
    eoi = False

    while pos + 1 < len(data) and not eoi:
        if data[pos] != 0xFF:
            pos += 1  # stray fill byte between segments
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        if marker == 0xFF:
            pos -= 1  # fill byte 0xFF
            continue
        if pos + 2 > len(data):
            raise JpegError("truncated segment")
        (seglen,) = struct.unpack(">H", data[pos : pos + 2])
        if seglen < 2 or pos + seglen > len(data):
            raise JpegError("bad segment length")
        seg = data[pos + 2 : pos + seglen]
        end = pos + seglen
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                i += 1
                n = 64 * (2 if pq else 1)
                if i + n > len(seg) or tq > 3:
                    raise JpegError("bad DQT")
                raw = seg[i : i + n]
                q = (np.frombuffer(raw, ">u2") if pq else
                     np.frombuffer(raw, np.uint8)).astype(np.int32)
                tbl = np.zeros(64, np.int32)
                tbl[ZIGZAG] = q  # store in natural order
                qtabs[tq] = tbl
                i += n
        elif marker == 0xC4:  # DHT
            i = 0
            while i + 17 <= len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1 : i + 17])
                n = sum(counts)
                vals = seg[i + 17 : i + 17 + n]
                if len(vals) < n or th > 3:
                    raise JpegError("bad DHT")
                (ac_tabs if tc else dc_tabs)[th] = HuffTable(counts, bytes(vals))
                i += 17 + n
        elif marker == 0xDD:  # DRI
            if len(seg) < 2:
                raise JpegError("bad DRI")
            restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):  # SOF0/1/2/9/10
            if frame is not None:
                raise JpegError("multiple frames")
            if len(seg) < 6:
                raise JpegError("bad SOF")
            prec, h, w, nc = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
            if prec != 8:
                raise JpegError(f"unsupported precision {prec}")
            if w == 0 or h == 0 or nc == 0 or nc > 4:
                raise JpegError("bad frame dims")
            if len(seg) < 6 + 3 * nc:
                raise JpegError("bad SOF")
            frame = Frame(marker in (0xC2, 0xCA), prec, w, h)
            frame.arith = marker in (0xC9, 0xCA)
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c : 9 + 3 * c]
                comp = Component(cid, hv >> 4, hv & 15, tq)
                if not (1 <= comp.h <= 4 and 1 <= comp.v <= 4):
                    raise JpegError("bad sampling factors")
                frame.comps.append(comp)
            frame.hmax = max(c.h for c in frame.comps)
            frame.vmax = max(c.v for c in frame.comps)
            frame.mcus_x = -(-w // (8 * frame.hmax))
            frame.mcus_y = -(-h // (8 * frame.vmax))
            for c in frame.comps:
                c.blocks_w = frame.mcus_x * c.h
                c.blocks_h = frame.mcus_y * c.v
                c.ds_w = -(-w * c.h // frame.hmax)
                c.ds_h = -(-h * c.v // frame.vmax)
                c.coefs = np.zeros((c.blocks_h, c.blocks_w, 64), np.int16)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
            raise JpegError(f"unsupported SOF marker 0xFF{marker:02X}")
        elif marker == 0xCC:  # DAC: arithmetic conditioning (B.2.4.3)
            i = 0
            while i + 1 < len(seg):
                tc, tb = seg[i] >> 4, seg[i] & 15
                cs = seg[i + 1]
                if tb > 3:
                    raise JpegError("bad DAC")
                if tc == 0:
                    lo, hi = cs & 0x0F, cs >> 4
                    if lo > hi or hi > 15:
                        raise JpegError("bad DAC DC conditioning")
                    dc_cond[tb] = (lo, hi)
                else:
                    if not 1 <= cs <= 63:
                        raise JpegError("bad DAC AC conditioning")
                    ac_cond[tb] = cs
                i += 2
        elif marker == 0xEE and seg[:5] == b"Adobe":  # APP14
            saw_adobe = True
            if len(seg) >= 12:
                adobe_transform = seg[11]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            saw_jfif = True
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JpegError("SOS before SOF")
            ns = seg[0]
            if len(seg) < 1 + 2 * ns + 3:
                raise JpegError("bad SOS")
            scomps: List[Component] = []
            for i in range(ns):
                cs, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
                comp = next((c for c in frame.comps if c.cid == cs), None)
                if comp is None:
                    raise JpegError("SOS names unknown component")
                comp.td, comp.ta = tdta >> 4, tdta & 15
                scomps.append(comp)
            ss, se, ahal = seg[1 + 2 * ns : 4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if frame.arith:
                pos = _decode_scan_arith(
                    data, end, frame, scomps, dc_cond, ac_cond,
                    restart_interval, ss, se, ah, al,
                )
            else:
                pos = _decode_scan(
                    data, end, frame, scomps, dc_tabs, ac_tabs,
                    restart_interval, ss, se, ah, al,
                )
            continue
        pos = end

    if frame is None:
        raise JpegError("no frame")
    planes = _idct_planes(frame, qtabs)
    pixels = _upsample_and_colour(
        frame, planes, saw_adobe, saw_jfif, adobe_transform
    )
    return Decoded(pixels, len(frame.comps), adobe_transform if saw_adobe else None)


# --- scan decoding --------------------------------------------------------------


def _decode_scan(data, pos, frame, scomps, dc_tabs, ac_tabs, ri, ss, se, ah, al):
    """Decode one entropy-coded scan starting at `pos`; returns the position
    after its data (at the next marker)."""
    r = BitReader(data, pos)
    if frame.progressive:
        _scan_progressive(r, frame, scomps, dc_tabs, ac_tabs, ri, ss, se, ah, al)
    else:
        if ss != 0 or se != 63:
            raise JpegError("bad sequential scan header")
        _scan_sequential(r, frame, scomps, dc_tabs, ac_tabs, ri)
    # Skip to the next marker (r.pos stops at one, or at stream end).
    p = r.pos
    while p + 1 < len(data) and not (
        data[p] == 0xFF and data[p + 1] not in (0x00,)
    ):
        p += 1
    return p


def _mcu_layout(frame, scomps):
    """[(comp, [(by, bx), ...])] per MCU slot, plus MCU grid dims.

    Single-component scans are NOT MCU-interleaved: the grid is the
    component's own full block grid (T.81 A.2.2)."""
    if len(scomps) == 1:
        c = scomps[0]
        # Non-interleaved: ceil of the DOWNSAMPLED size, not the padded grid.
        bw = -(-c.ds_w // 8)
        bh = -(-c.ds_h // 8)
        return [(c, [(0, 0)])], bw, bh
    slots = []
    for c in scomps:
        offs = [(y, x) for y in range(c.v) for x in range(c.h)]
        slots.append((c, offs))
    return slots, frame.mcus_x, frame.mcus_y


def _scan_sequential(r, frame, scomps, dc_tabs, ac_tabs, ri):
    slots, gw, gh = _mcu_layout(frame, scomps)
    for c, _ in slots:
        if c.td not in dc_tabs or c.ta not in ac_tabs:
            raise JpegError("scan references missing Huffman table")
        c.dc_pred = 0
    interleaved = len(scomps) > 1
    togo = ri if ri else -1
    for my in range(gh):
        for mx in range(gw):
            if togo == 0:
                r.restart()
                for c, _ in slots:
                    c.dc_pred = 0
                togo = ri
            for c, offs in slots:
                dct, act = dc_tabs[c.td], ac_tabs[c.ta]
                for oy, ox in offs:
                    by = my * (c.v if interleaved else 1) + oy
                    bx = mx * (c.h if interleaved else 1) + ox
                    blk = c.coefs[by, bx]
                    t = r.decode(dct)
                    if t > 15:
                        raise JpegError("bad DC category")
                    diff = _extend(r.get_bits(t), t) if t else 0
                    c.dc_pred += diff
                    blk[0] = c.dc_pred
                    k = 1
                    while k < 64:
                        rs = r.decode(act)
                        rr, s = rs >> 4, rs & 15
                        if s == 0:
                            if rr != 15:
                                break
                            k += 16
                        else:
                            k += rr
                            if k > 63:
                                raise JpegError("AC index overflow")
                            blk[ZIGZAG[k]] = _extend(r.get_bits(s), s)
                            k += 1
            if togo > 0:
                togo -= 1


def _scan_progressive(r, frame, scomps, dc_tabs, ac_tabs, ri, ss, se, ah, al):
    if ss == 0:
        if se != 0:
            raise JpegError("progressive DC scan with Se != 0")
        _prog_dc(r, frame, scomps, dc_tabs, ri, ah, al)
    else:
        if len(scomps) != 1:
            raise JpegError("progressive AC scan must be single-component")
        if se > 63 or ss > se:
            raise JpegError("bad spectral selection")
        _prog_ac(r, scomps[0], ac_tabs, ri, ss, se, ah, al)


def _prog_dc(r, frame, scomps, dc_tabs, ri, ah, al):
    slots, gw, gh = _mcu_layout(frame, scomps)
    first = ah == 0
    if first:
        for c, _ in slots:
            if c.td not in dc_tabs:
                raise JpegError("missing DC table")
            c.dc_pred = 0
    interleaved = len(scomps) > 1
    togo = ri if ri else -1
    for my in range(gh):
        for mx in range(gw):
            if togo == 0:
                r.restart()
                for c, _ in slots:
                    c.dc_pred = 0
                togo = ri
            for c, offs in slots:
                for oy, ox in offs:
                    by = my * (c.v if interleaved else 1) + oy
                    bx = mx * (c.h if interleaved else 1) + ox
                    blk = c.coefs[by, bx]
                    if first:
                        t = r.decode(dc_tabs[c.td])
                        if t > 15:
                            raise JpegError("bad DC category")
                        diff = _extend(r.get_bits(t), t) if t else 0
                        c.dc_pred += diff
                        blk[0] = c.dc_pred << al
                    else:
                        if r.get_bit():
                            blk[0] = blk[0] | (1 << al)
            if togo > 0:
                togo -= 1


def _prog_ac(r, c, ac_tabs, ri, ss, se, ah, al):
    if c.ta not in ac_tabs:
        raise JpegError("missing AC table")
    act = ac_tabs[c.ta]
    bw = -(-c.ds_w // 8)
    bh = -(-c.ds_h // 8)
    eobrun = 0
    togo = ri if ri else -1
    zz = ZIGZAG
    for by in range(bh):
        for bx in range(bw):
            if togo == 0:
                r.restart()
                eobrun = 0
                togo = ri
            blk = c.coefs[by, bx]
            if ah == 0:  # first pass
                if eobrun:
                    eobrun -= 1
                else:
                    k = ss
                    while k <= se:
                        rs = r.decode(act)
                        rr, s = rs >> 4, rs & 15
                        if s == 0:
                            if rr != 15:
                                eobrun = (1 << rr) - 1
                                if rr:
                                    eobrun += r.get_bits(rr)
                                break
                            k += 16
                        else:
                            k += rr
                            if k > se:
                                raise JpegError("AC index overflow")
                            blk[zz[k]] = _extend(r.get_bits(s), s) << al
                            k += 1
            else:  # refinement pass (T.81 G.1.2.3 / libjpeg decode_mcu_AC_refine)
                p1 = 1 << al
                m1 = -1 << al
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = r.decode(act)
                        rr, s = rs >> 4, rs & 15
                        if s == 0:
                            if rr != 15:
                                eobrun = (1 << rr)
                                if rr:
                                    eobrun += r.get_bits(rr)
                                break
                        else:
                            if s != 1:
                                raise JpegError("bad refinement magnitude")
                            s = p1 if r.get_bit() else m1
                        # advance over rr zero-history coefs, correcting
                        # nonzero ones on the way
                        while k <= se:
                            z = zz[k]
                            if blk[z] != 0:
                                if r.get_bit() and (blk[z] & p1) == 0:
                                    blk[z] += p1 if blk[z] >= 0 else m1
                            else:
                                if rr == 0:
                                    if s:
                                        blk[z] = s
                                    k += 1
                                    break
                                rr -= 1
                            k += 1
                if eobrun > 0:
                    # correct all remaining nonzero coefficients
                    while k <= se:
                        z = zz[k]
                        if blk[z] != 0:
                            if r.get_bit() and (blk[z] & p1) == 0:
                                blk[z] += p1 if blk[z] >= 0 else m1
                        k += 1
                    eobrun -= 1
            if togo > 0:
                togo -= 1


# --- arithmetic scan decoding (T.81 F.2.4, the jdarith statistics model) ---------


def _decode_scan_arith(data, pos, frame, scomps, dc_cond, ac_cond, ri,
                       ss, se, ah, al):
    """Arithmetic-coded scan (SOF9 sequential / SOF10 progressive).

    Statistics bins per T.81 F.2: DC area of 64 states per table
    (contexts 0..19, magnitude categories X1.. at 20, mantissa at +14),
    AC area of 256 states (3 per coefficient index, categories at
    189/217 split by the Kx conditioning), one non-adapting state for
    signs.  All areas reset at scan start and at every restart."""
    dec = ArithDecoder(data, pos)
    dc_stats: Dict[int, bytearray] = {}
    ac_stats: Dict[int, bytearray] = {}
    fixed = bytearray([113])

    def reset_stats():
        for c in scomps:
            dc_stats[c.td] = bytearray(64)
            ac_stats[c.ta] = bytearray(256)
            c.dc_pred = 0
            c.dc_ctx = 0
        fixed[0] = 113

    reset_stats()

    def decode_dc(c: Component) -> int:
        """One DC diff; updates c.dc_pred / c.dc_ctx; returns the new DC."""
        st = dc_stats[c.td]
        ctx = c.dc_ctx
        if dec.decode(st, ctx) == 0:
            c.dc_ctx = 0
            return c.dc_pred
        sign = dec.decode(st, ctx + 1)
        i = ctx + 2 + sign
        m = dec.decode(st, i)
        if m:
            i = 20  # Table F.4: X1
            while dec.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise JpegError("arith DC magnitude overflow")
                i += 1
        lo, hi = dc_cond.get(c.td, (0, 1))
        if m < (1 << lo) >> 1:
            c.dc_ctx = 0
        elif m > (1 << hi) >> 1:
            c.dc_ctx = 12 + sign * 4
        else:
            c.dc_ctx = 4 + sign * 4
        v = m
        i += 14
        m >>= 1
        while m:
            if dec.decode(st, i):
                v |= m
            m >>= 1
        v += 1
        c.dc_pred += -v if sign else v
        return c.dc_pred

    def decode_ac_run(c: Component, blk, kmin, kmax, shift):
        """Sequential/first-pass AC coefficients kmin..kmax into blk."""
        st = ac_stats[c.ta]
        kx = ac_cond.get(c.ta, 5)
        k = kmin
        while k <= kmax:
            base = 3 * (k - 1)
            if dec.decode(st, base):
                return  # EOB
            while dec.decode(st, base + 1) == 0:
                k += 1
                base += 3
                if k > kmax:
                    raise JpegError("arith AC index overflow")
            sign = dec.decode(fixed, 0)
            i = base + 2
            m = dec.decode(st, i)
            if m:
                if dec.decode(st, i):
                    m <<= 1
                    i = 189 if k <= kx else 217
                    while dec.decode(st, i):
                        m <<= 1
                        if m == 0x8000:
                            raise JpegError("arith AC magnitude overflow")
                        i += 1
            v = m
            i += 14
            m >>= 1
            while m:
                if dec.decode(st, i):
                    v |= m
                m >>= 1
            v += 1
            blk[ZIGZAG[k]] = (-v if sign else v) << shift
            k += 1

    def decode_ac_refine(c: Component, blk, kmin, kmax, p1, m1):
        st = ac_stats[c.ta]
        kex = kmax
        while kex > 0 and blk[ZIGZAG[kex]] == 0:
            kex -= 1
        k = kmin
        while k <= kmax:
            base = 3 * (k - 1)
            if k > kex and dec.decode(st, base):
                return  # EOB
            while True:
                z = ZIGZAG[k]
                if blk[z]:
                    if dec.decode(st, base + 2):
                        blk[z] += m1 if blk[z] < 0 else p1
                    break
                if dec.decode(st, base + 1):
                    blk[z] = m1 if dec.decode(fixed, 0) else p1
                    break
                k += 1
                base += 3
                if k > kmax:
                    raise JpegError("arith AC refine overflow")
            k += 1

    slots, gw, gh = _mcu_layout(frame, scomps)
    interleaved = len(scomps) > 1
    dc_scan = not frame.progressive or ss == 0
    ac_scan = not frame.progressive or ss > 0
    if frame.progressive and ss > 0 and len(scomps) != 1:
        raise JpegError("progressive AC scan must be single-component")
    if frame.progressive and ss == 0 and se != 0:
        raise JpegError("progressive DC scan with Se != 0")
    if not frame.progressive and (ss != 0 or se != 63):
        raise JpegError("bad sequential scan header")
    first = ah == 0
    p1 = 1 << al
    m1 = (-1) << al
    togo = ri if ri else -1
    for my in range(gh):
        for mx in range(gw):
            if togo == 0:
                dec.restart()
                reset_stats()
                togo = ri
            for c, offs in slots:
                for oy, ox in offs:
                    by = my * (c.v if interleaved else 1) + oy
                    bx = mx * (c.h if interleaved else 1) + ox
                    blk = c.coefs[by, bx]
                    if dc_scan:
                        if first:
                            dc = decode_dc(c)
                            blk[0] = dc << al if frame.progressive else dc
                        elif dec.decode(fixed, 0):
                            blk[0] = blk[0] | p1
                    if ac_scan:
                        if first:
                            decode_ac_run(
                                c, blk, ss if frame.progressive else 1,
                                se, al if frame.progressive else 0,
                            )
                        else:
                            decode_ac_refine(c, blk, ss, se, p1, m1)
            if togo > 0:
                togo -= 1

    # Skip to the next marker for the segment walker.
    p = dec.pos
    while p + 1 < len(data) and not (data[p] == 0xFF and data[p + 1] != 0x00):
        p += 1
    return p


# --- IDCT (vectorized islow) ----------------------------------------------------


def _idct_islow(coefs: np.ndarray) -> np.ndarray:
    """(n, 64) int32 dequantized -> (n, 8, 8) uint8 samples, bit-identical
    to libjpeg jpeg_idct_islow (jidctint.c algorithm)."""
    n = coefs.shape[0]
    blk = coefs.reshape(n, 8, 8).astype(np.int64)

    def pass1(col, sh):  # one 1-D pass over axis 1, single rounded descale by sh
        z2, z3 = col[:, 2], col[:, 6]
        z1 = (z2 + z3) * F_0_541196100
        t2 = z1 + z3 * (-F_1_847759065)
        t3 = z1 + z2 * F_0_765366865
        z2, z3 = col[:, 0], col[:, 4]
        t0 = (z2 + z3) << CONST_BITS
        t1 = (z2 - z3) << CONST_BITS
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        a0, a1, a2, a3 = col[:, 7], col[:, 5], col[:, 3], col[:, 1]
        z1 = a0 + a3
        z2 = a1 + a2
        z3 = a0 + a2
        z4 = a1 + a3
        z5 = (z3 + z4) * F_1_175875602
        a0 = a0 * F_0_298631336
        a1 = a1 * F_2_053119869
        a2 = a2 * F_3_072711026
        a3 = a3 * F_1_501321110
        z1 = z1 * -F_0_899976223
        z2 = z2 * -F_2_562915447
        z3 = z3 * -F_1_961570560 + z5
        z4 = z4 * -F_0_390180644 + z5
        a0 += z1 + z3
        a1 += z2 + z4
        a2 += z2 + z3
        a3 += z1 + z4
        rnd = 1 << (sh - 1)
        out = np.empty_like(col)
        out[:, 0] = (t10 + a3 + rnd) >> sh
        out[:, 7] = (t10 - a3 + rnd) >> sh
        out[:, 1] = (t11 + a2 + rnd) >> sh
        out[:, 6] = (t11 - a2 + rnd) >> sh
        out[:, 2] = (t12 + a1 + rnd) >> sh
        out[:, 5] = (t12 - a1 + rnd) >> sh
        out[:, 3] = (t13 + a0 + rnd) >> sh
        out[:, 4] = (t13 - a0 + rnd) >> sh
        return out

    # Pass 1 over columns descales by CONST_BITS-PASS1_BITS; pass 2 over rows
    # descales by CONST_BITS+PASS1_BITS+3 in ONE rounded shift (jidctint.c
    # DESCALE is applied once per pass — chaining two shifts rounds twice
    # and is NOT bit-identical).
    tmp = pass1(blk, CONST_BITS - PASS1_BITS)              # columns
    tmp = pass1(tmp.transpose(0, 2, 1),                    # rows
                CONST_BITS + PASS1_BITS + 3)
    return _RL[tmp & 1023].transpose(0, 2, 1)


def _idct_planes(frame: Frame, qtabs) -> List[np.ndarray]:
    planes = []
    for c in frame.comps:
        if c.tq not in qtabs:
            raise JpegError("missing quantization table")
        q = qtabs[c.tq][None, :]
        flat = c.coefs.reshape(-1, 64).astype(np.int32) * q
        sam = _idct_islow(flat)  # (nb, 8, 8)
        nbh, nbw = c.blocks_h, c.blocks_w
        plane = sam.reshape(nbh, nbw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(nbh * 8, nbw * 8)
        planes.append(plane[: c.ds_h, : c.ds_w])
    return planes


# --- upsampling (libjpeg jdsample.c) ---------------------------------------------


def _h2v1_fancy(p: np.ndarray) -> np.ndarray:
    h, w = p.shape
    x = p.astype(np.int32)
    out = np.empty((h, 2 * w), np.int32)
    if w == 1:
        out[:, 0] = out[:, 1] = x[:, 0]
        return out
    out[:, 0] = x[:, 0]
    out[:, 1] = (x[:, 0] * 3 + x[:, 1] + 2) >> 2
    if w > 2:
        c = x[:, 1:-1]
        out[:, 2:-2:2] = (c * 3 + x[:, :-2] + 1) >> 2
        out[:, 3:-2:2] = (c * 3 + x[:, 2:] + 2) >> 2
    out[:, -2] = (x[:, -1] * 3 + x[:, -2] + 1) >> 2
    out[:, -1] = x[:, -1]
    return out


def _h2v2_fancy(p: np.ndarray) -> np.ndarray:
    h, w = p.shape
    x = p.astype(np.int32)
    up = np.maximum(np.arange(h) - 1, 0)
    dn = np.minimum(np.arange(h) + 1, h - 1)
    # colsum rows: output row 2r pairs row r with r-1; 2r+1 with r+1.
    cs = np.empty((2 * h, w), np.int32)
    cs[0::2] = x * 3 + x[up]
    cs[1::2] = x * 3 + x[dn]
    out = np.empty((2 * h, 2 * w), np.int32)
    if w == 1:
        v = (cs[:, 0] * 4 + 8) >> 4
        out[:, 0] = v
        out[:, 1] = (cs[:, 0] * 4 + 7) >> 4
        return out
    out[:, 0] = (cs[:, 0] * 4 + 8) >> 4
    out[:, 1] = (cs[:, 0] * 3 + cs[:, 1] + 7) >> 4
    if w > 2:
        c = cs[:, 1:-1]
        out[:, 2:-2:2] = (c * 3 + cs[:, :-2] + 8) >> 4
        out[:, 3:-2:2] = (c * 3 + cs[:, 2:] + 7) >> 4
    out[:, -2] = (cs[:, -1] * 3 + cs[:, -2] + 8) >> 4
    out[:, -1] = (cs[:, -1] * 4 + 7) >> 4
    return out


def _upsample(frame: Frame, c: Component, plane: np.ndarray) -> np.ndarray:
    he = frame.hmax // c.h
    ve = frame.vmax // c.v
    if frame.hmax % c.h or frame.vmax % c.v:
        raise JpegError("fractional sampling not supported")
    # libjpeg jinit_upsampler picks the fancy path only when
    # downsampled_width > 2; narrower planes get plain replication.
    fancy = plane.shape[1] > 2
    if he == 1 and ve == 1:
        out = plane.astype(np.int32)
    elif he == 2 and ve == 1 and fancy:
        out = _h2v1_fancy(plane)
    elif he == 2 and ve == 2 and fancy:
        out = _h2v2_fancy(plane)
    else:  # int_upsample: replication
        out = np.repeat(np.repeat(plane, ve, axis=0), he, axis=1).astype(np.int32)
    return out[: frame.height, : frame.width]


def _upsample_and_colour(frame, planes, saw_adobe, saw_jfif, transform):
    nc = len(frame.comps)
    ups = [_upsample(frame, c, p) for c, p in zip(frame.comps, planes)]
    if nc == 1:
        return ups[0].astype(np.uint8)[..., None]
    # Colour space per libjpeg jdmaster default rules.
    if nc == 3:
        if saw_jfif:
            ycc = True
        elif saw_adobe:
            ycc = transform != 0
        else:
            ids = [c.cid for c in frame.comps]
            ycc = ids != [0x52, 0x47, 0x42]  # "RGB"
        if not ycc:
            return np.stack(ups, -1).astype(np.uint8)
        r, g, b = _ycc_to_rgb(*ups)
        return np.stack([r, g, b], -1)
    if nc == 4:
        ycck = saw_adobe and transform == 2
        if ycck:
            r, g, b = _ycc_to_rgb(ups[0], ups[1], ups[2])
            stored = np.stack(
                [255 - r.astype(np.int32), 255 - g.astype(np.int32),
                 255 - b.astype(np.int32), ups[3]], -1
            ).astype(np.uint8)
        else:
            stored = np.stack(ups, -1).astype(np.uint8)
        # Adobe 4-component JPEGs store complemented CMYK (TN #5116); return
        # true CMYK so callers need no heuristic.
        return (255 - stored) if saw_adobe else stored
    raise JpegError(f"unsupported component count {nc}")


def _ycc_to_rgb(y, cb, cr):
    y = y.astype(np.int64)
    r = _srl(y + CR_R_TAB[cr])
    g = _srl(y + ((CB_G_TAB[cb] + CR_G_TAB[cr]) >> _SCALEBITS))
    b = _srl(y + CB_B_TAB[cb])
    return r, g, b
