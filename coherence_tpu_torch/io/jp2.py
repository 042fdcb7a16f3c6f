"""From-scratch JPEG 2000 decoder (ITU-T T.800): JPXDecode without PIL.

The port's copy of ``coherence_tpu.io.jp2``, whole.

camlpdf's codec surface includes JPXDecode passthrough; the renderer must
paint /JPXDecode images (reference parses Image elements,
pdfgraphics.mli:139-140).  Round 3 left this codec — alone in the IO
stack — on PIL's OpenJPEG plugin; this module removes that last
third-party decode dependency.  PIL remains the cross-validation oracle
in tests (as libjpeg is for io/jpeg.py and libtiff for io/ccitt.py).

Scope (everything PDF-embedded JP2/J2K files from mainstream encoders
use):
 - JP2 container boxes (jp2h/ihdr/colr/cdef, pclr/cmap palettes) and
   raw J2K codestreams; sYCC -> RGB conversion (colr enum 18)
 - multiple tiles and tile-parts; ALL progressions (LRCP / RLCP /
   RPCL / PCRL / CPRL) and POC progression-order changes (main and
   tile header, B.12.2 no-packet-repeats semantics)
 - component subsampling (XRsiz/YRsiz per B.2, sample-replicated onto
   the reference grid for display)
 - tier-2: tag-tree packet headers, precincts, SOP/EPH, quality layers,
   per-terminated-segment lengths (B.10.7.5)
 - tier-1: EBCOT (significance / refinement / cleanup passes) on the
   shared T.88 MQ coder from io/jbig2.py; ALL codeblock styles —
   arithmetic bypass (raw segments), reset-contexts, termall,
   vertically stripe-causal contexts, predictable termination, SEGSYM
 - 5/3 reversible and 9/7 irreversible inverse DWT (arbitrary region
   parity per T.800 F.3.7), no-quant / derived / expounded dequant
 - RCT and ICT inverse multi-component transforms, DC level shift

The EBCOT context tables are T.800 Tables D.1-D.3; coordinates follow
the ceil-division band/resolution formulas of B.5.  Corruption raises
ValueError (never a hang).  Oracle test vectors for the features PIL
cannot encode come from the first-party encoder in io/jp2enc.py.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .jbig2 import Contexts, MQDecoder

__all__ = ["decode", "Jp2Image"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Packet-header bit reader (B.10.1: bit stuffing after 0xFF bytes)
# ---------------------------------------------------------------------------


class _Bits:
    __slots__ = ("data", "pos", "buf", "ct")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.ct = 0

    def _bytein(self):
        if self.pos >= len(self.data):
            raise ValueError("jp2: packet header overruns tile data")
        if self.buf == 0xFF:
            self.buf = self.data[self.pos]
            self.pos += 1
            self.ct = 7
        else:
            self.buf = self.data[self.pos]
            self.pos += 1
            self.ct = 8

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        self.ct = 0
        if self.buf == 0xFF:
            if self.pos >= len(self.data):
                raise ValueError("jp2: packet header overruns tile data")
            self.buf = self.data[self.pos]
            self.pos += 1


# ---------------------------------------------------------------------------
# Tag trees (B.10.2)
# ---------------------------------------------------------------------------


class _TagTree:
    def __init__(self, w: int, h: int):
        self.levels: List[Tuple[int, int]] = []
        lw, lh = w, h
        while True:
            self.levels.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw, lh = _ceil_div(lw, 2), _ceil_div(lh, 2)
        # per level: low bound + known flag arrays
        self.low = [np.zeros((lh_, lw_), dtype=np.int32) for lw_, lh_ in self.levels]
        self.known = [
            np.zeros((lh_, lw_), dtype=bool) for lw_, lh_ in self.levels
        ]

    def decode(self, rd: _Bits, i: int, j: int, threshold: int) -> bool:
        """True iff value(i, j) < threshold (leaf at level 0, row i, col j)."""
        # Walk root -> leaf.
        chain = []
        for lvl in range(len(self.levels) - 1, -1, -1):
            chain.append((lvl, i >> lvl, j >> lvl))
        low = 0
        for lvl, ii, jj in chain:
            if self.low[lvl][ii, jj] < low:
                self.low[lvl][ii, jj] = low
            while not self.known[lvl][ii, jj]:
                if self.low[lvl][ii, jj] >= threshold:
                    return False
                if rd.bit():
                    self.known[lvl][ii, jj] = True
                else:
                    self.low[lvl][ii, jj] += 1
            low = self.low[lvl][ii, jj]
            if low >= threshold:
                return False
        return True


# ---------------------------------------------------------------------------
# EBCOT tier-1 (D): context tables and the three coding passes
# ---------------------------------------------------------------------------

# Zero-coding context (Table D.1).  Key: (h, v, d) neighbor significance
# sums.  LL/LH table; HL swaps h<->v; HH keys on d first.
def _zc_lut():
    ll = np.zeros((3, 3, 5), dtype=np.uint8)
    hh = np.zeros((3, 3, 5), dtype=np.uint8)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if h == 2:
                    c = 8
                elif h == 1:
                    c = 7 if v >= 1 else (6 if d >= 1 else 5)
                elif v == 2:
                    c = 4
                elif v == 1:
                    c = 3
                else:
                    c = 2 if d >= 2 else (1 if d == 1 else 0)
                ll[h, v, d] = c
                hv = h + v
                if d >= 3:
                    c = 8
                elif d == 2:
                    c = 7 if hv >= 1 else 6
                elif d == 1:
                    c = 5 if hv >= 2 else (4 if hv == 1 else 3)
                else:
                    c = 2 if hv >= 2 else (1 if hv == 1 else 0)
                hh[h, v, d] = c
    return ll, hh


_ZC_LL, _ZC_HH = _zc_lut()

# Sign-coding context (Table D.2): (H+1, V+1) -> (context, xor bit).
_SC = {
    (2, 2): (13, 0), (2, 1): (12, 0), (2, 0): (11, 0),
    (1, 2): (10, 0), (1, 1): (9, 0), (1, 0): (10, 1),
    (0, 2): (11, 1), (0, 1): (12, 1), (0, 0): (13, 1),
}

_CTX_RL = 17
_CTX_UNI = 18
_N_CTX = 19


class _Raw:
    """Raw (arithmetic-bypass) bit reader, D.8.1: MSB-first, 7 payload
    bits after a 0xFF byte; reads past the segment end yield 1s."""

    __slots__ = ("data", "pos", "buf", "ct")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            prev = self.buf
            if self.pos >= len(self.data):
                self.buf, self.ct = 0xFF, 8 if prev != 0xFF else 7
            else:
                self.buf = self.data[self.pos]
                self.pos += 1
                self.ct = 7 if prev == 0xFF else 8
        self.ct -= 1
        return (self.buf >> self.ct) & 1


def _t1_decode(
    segs: List[_Seg],
    w: int,
    h: int,
    numbps: int,
    orient: str,
    cbstyle: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode one codeblock; returns (magnitudes int32, signs bool, last).

    ``last[y, x]`` is the bitplane of the LAST pass that examined the
    coefficient (set at significance and at every refinement, whatever
    the bit).  Truncated streams (quality layers) leave planes below
    ``last`` undecoded; the dequantizer reconstructs at the bin midpoint
    ``mag + 0.5 * 2**last`` (E.1.1.2) — OpenJPEG does the same
    incrementally via its ``one | half`` / ``±poshalf`` updates.

    ``segs`` holds the terminated coder segments (one for the plain
    style); BYPASS passes use the raw reader, every other pass the MQ
    coder, each segment with a fresh coder.  Styles: 0x01 bypass, 0x02
    reset contexts each pass, 0x04 termall, 0x08 vertically stripe-
    causal contexts, 0x10 predictable termination (decode no-op), 0x20
    segmentation symbols.
    """
    segsym = bool(cbstyle & 0x20)
    vsc = bool(cbstyle & 0x08)
    resetctx = bool(cbstyle & 0x02)

    def fresh_contexts():
        cx = Contexts(_N_CTX)
        # Initial states (D.2 init table): all 0 except RL=3, UNI=46, ctx0=4.
        cx.i[0] = 4
        cx.i[_CTX_RL] = 3
        cx.i[_CTX_UNI] = 46
        return cx

    cx = fresh_contexts()
    sig = np.zeros((h + 2, w + 2), dtype=np.uint8)  # 1-px apron
    sgn = np.zeros((h + 2, w + 2), dtype=np.uint8)  # 1 = negative
    mag = np.zeros((h, w), dtype=np.int32)
    last = np.zeros((h, w), dtype=np.int8)
    visited = np.zeros((h + 2, w + 2), dtype=np.uint8)
    refined = np.zeros((h + 2, w + 2), dtype=np.uint8)
    zc = _ZC_HH if orient == "HH" else _ZC_LL
    swap = orient == "HL"

    # Coder for the pass at hand: set per segment in the pass loop.
    mq: Optional[MQDecoder] = None
    raw: Optional[_Raw] = None

    def zc_ctx(y, x, masked=False):
        """Zero-coding context at apron coords; ``masked`` drops the
        south neighbors (VSC: the sample sits on a stripe bottom)."""
        hsum = sig[y, x - 1] + sig[y, x + 1]
        vsum = sig[y - 1, x] + (0 if masked else sig[y + 1, x])
        d = sig[y - 1, x - 1] + sig[y - 1, x + 1]
        if not masked:
            d += sig[y + 1, x - 1] + sig[y + 1, x + 1]
        if swap:
            hsum, vsum = vsum, hsum
        return zc[hsum, vsum, d]

    def decode_sign(y, x, masked=False):
        if raw is not None:
            return raw.bit()  # raw sign: no prediction (D.5)

        def contrib(yy, xx):
            if not sig[yy, xx]:
                return 0
            return -1 if sgn[yy, xx] else 1

        hc = max(-1, min(1, contrib(y, x - 1) + contrib(y, x + 1)))
        south = 0 if masked else contrib(y + 1, x)
        vc = max(-1, min(1, contrib(y - 1, x) + south))
        ctx, xor = _SC[(hc + 1, vc + 1)]
        return mq.decode(cx, ctx) ^ xor

    # Global pass walk across segments.
    p = 0
    bp = numbps - 1  # current magnitude bit position
    passtype = 2  # first pass is cleanup at the MSB
    for seg in segs:
        data = bytes(seg.data)
        is_raw = _pass_is_raw(cbstyle, seg.start)
        if is_raw:
            raw, mq = _Raw(data), None
        else:
            raw, mq = None, MQDecoder(data)
        for _sp in range(seg.npasses):
            if bp < 0:
                break
            if passtype == 0:  # significance propagation
                for y0 in range(0, h, 4):
                    for x in range(w):
                        for y in range(y0, min(y0 + 4, h)):
                            ay, ax = y + 1, x + 1
                            if sig[ay, ax] or visited[ay, ax]:
                                continue
                            masked = vsc and (y & 3) == 3
                            c = zc_ctx(ay, ax, masked)
                            if c == 0:
                                continue
                            visited[ay, ax] = 1
                            d = raw.bit() if raw is not None else mq.decode(cx, c)
                            if d:
                                sig[ay, ax] = 1
                                sgn[ay, ax] = decode_sign(ay, ax, masked)
                                mag[y, x] |= 1 << bp
                                last[y, x] = bp
            elif passtype == 1:  # magnitude refinement
                for y0 in range(0, h, 4):
                    for x in range(w):
                        for y in range(y0, min(y0 + 4, h)):
                            ay, ax = y + 1, x + 1
                            if not sig[ay, ax] or visited[ay, ax]:
                                continue
                            if raw is not None:
                                d = raw.bit()
                            else:
                                if refined[ay, ax]:
                                    c = 16
                                else:
                                    nb = (
                                        sig[ay, ax - 1] + sig[ay, ax + 1]
                                        + sig[ay - 1, ax]
                                        + sig[ay - 1, ax - 1]
                                        + sig[ay - 1, ax + 1]
                                    )
                                    # VSC: a stripe-bottom sample never
                                    # sees the stripe below, in ANY
                                    # context (OpenJPEG suppresses the
                                    # south bits at update time).
                                    if not (vsc and (y & 3) == 3):
                                        nb += (
                                            sig[ay + 1, ax]
                                            + sig[ay + 1, ax - 1]
                                            + sig[ay + 1, ax + 1]
                                        )
                                    c = 15 if nb else 14
                                d = mq.decode(cx, c)
                            refined[ay, ax] = 1
                            last[y, x] = bp
                            if d:
                                mag[y, x] |= 1 << bp
            else:  # cleanup (always MQ)
                for y0 in range(0, h, 4):
                    for x in range(w):
                        y = y0
                        # Run-length mode: full stripe, all insignificant,
                        # unvisited, zero context.
                        if (
                            y0 + 4 <= h
                            and not any(
                                sig[y0 + 1 + k, x + 1]
                                or visited[y0 + 1 + k, x + 1]
                                for k in range(4)
                            )
                            and all(
                                zc_ctx(
                                    y0 + 1 + k, x + 1, vsc and k == 3
                                ) == 0
                                for k in range(4)
                            )
                        ):
                            if not mq.decode(cx, _CTX_RL):
                                continue  # whole column stays zero
                            r = (
                                mq.decode(cx, _CTX_UNI) << 1
                            ) | mq.decode(cx, _CTX_UNI)
                            y = y0 + r
                            ay, ax = y + 1, x + 1
                            sig[ay, ax] = 1
                            sgn[ay, ax] = decode_sign(
                                ay, ax, vsc and (y & 3) == 3
                            )
                            mag[y, x] |= 1 << bp
                            last[y, x] = bp
                            y += 1
                        for yy in range(y, min(y0 + 4, h)):
                            ay, ax = yy + 1, x + 1
                            if sig[ay, ax] or visited[ay, ax]:
                                continue
                            masked = vsc and (yy & 3) == 3
                            if mq.decode(cx, zc_ctx(ay, ax, masked)):
                                sig[ay, ax] = 1
                                sgn[ay, ax] = decode_sign(ay, ax, masked)
                                mag[yy, x] |= 1 << bp
                                last[yy, x] = bp
                if segsym:
                    s = 0
                    for _ in range(4):
                        s = (s << 1) | mq.decode(cx, _CTX_UNI)
                    if s != 0xA:
                        raise ValueError("jp2: segmentation symbol mismatch")
                visited[:] = 0
                bp -= 1
            passtype = (passtype + 1) % 3
            p += 1
            if resetctx:
                cx = fresh_contexts()
    return mag, sgn[1 : h + 1, 1 : w + 1].astype(bool), last


# ---------------------------------------------------------------------------
# Inverse DWT (F.3): 5/3 reversible and 9/7 irreversible, arbitrary parity
# ---------------------------------------------------------------------------

_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _ext(y: np.ndarray, i0: int, left: int, right: int) -> Tuple[np.ndarray, int]:
    """Whole-sample symmetric extension; returns (extended, new origin)."""
    n = y.shape[0]
    if n == 1:
        ext = np.repeat(y, left + right + 1, axis=0)
        return ext, i0 - left
    idx = np.arange(-left, n + right)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    idx = np.where(idx >= n, period - idx, idx)
    return y[idx], i0 - left


def _sr_1d(y: np.ndarray, i0: int, i1: int, reversible: bool) -> np.ndarray:
    """T.800 F.3.7 1D_SR on interleaved signal y covering [i0, i1)."""
    if i1 - i0 == 1:
        if i0 % 2 == 0:
            return y.copy() if reversible else y.copy()
        return (y // 2) if reversible else (y / 2.0)
    if reversible:
        yext, o = _ext(y, i0, 3, 3)
        x = yext.astype(np.int64).copy()
        # X(2n) = Y(2n) - floor((Y(2n-1) + Y(2n+1) + 2) / 4), over every
        # even position the odd step touches: [i0 - 1, i1 + 1].
        start = i0 if i0 % 2 == 0 else i0 - 1
        ev = np.arange(start, i1 + 2, 2)
        x[ev - o] = yext[ev - o] - ((yext[ev - 1 - o] + yext[ev + 1 - o] + 2) >> 2)
        # X(2n+1) = Y(2n+1) + floor((X(2n) + X(2n+2)) / 2)
        start = i0 if i0 % 2 == 1 else i0 + 1
        od = np.arange(start, i1, 2)
        x[od - o] = yext[od - o] + ((x[od - 1 - o] + x[od + 1 - o]) >> 1)
        return x[i0 - o : i1 - o]
    yext, o = _ext(y.astype(np.float64), i0, 4, 4)
    x = yext.copy()
    allidx = np.arange(i0 - 4, i1 + 4)
    ev = allidx[allidx % 2 == 0]
    od = allidx[allidx % 2 == 1]
    x[ev - o] *= _K97
    x[od - o] *= 1.0 / _K97
    ev2 = ev[(ev >= i0 - 3) & (ev < i1 + 3)]
    x[ev2 - o] -= _D97 * (x[ev2 - 1 - o] + x[ev2 + 1 - o])
    od2 = od[(od >= i0 - 2) & (od < i1 + 2)]
    x[od2 - o] -= _G97 * (x[od2 - 1 - o] + x[od2 + 1 - o])
    ev3 = ev[(ev >= i0 - 1) & (ev < i1 + 1)]
    x[ev3 - o] -= _B97 * (x[ev3 - 1 - o] + x[ev3 + 1 - o])
    od3 = od[(od >= i0) & (od < i1)]
    x[od3 - o] -= _A97 * (x[od3 - 1 - o] + x[od3 + 1 - o])
    return x[i0 - o : i1 - o]


def _sr_2d(
    ll: np.ndarray,
    hl: np.ndarray,
    lh: np.ndarray,
    hh: np.ndarray,
    u0: int,
    u1: int,
    v0: int,
    v1: int,
    reversible: bool,
) -> np.ndarray:
    """Interleave subbands into [v0,v1)x[u0,u1) and run HOR then VER SR."""
    dt = np.int64 if reversible else np.float64
    a = np.zeros((v1 - v0, u1 - u0), dtype=dt)
    # Band (m, n) sits at global (2n + xoff, 2m + yoff).
    def paste(band, xoff, yoff):
        if band.size == 0:
            return
        bh, bw = band.shape
        bx0 = _ceil_div(u0 - xoff, 2)
        by0 = _ceil_div(v0 - yoff, 2)
        xs = 2 * (bx0 + np.arange(bw)) + xoff - u0
        ys = 2 * (by0 + np.arange(bh)) + yoff - v0
        a[np.ix_(ys, xs)] = band

    paste(ll, 0, 0)
    paste(hl, 1, 0)
    paste(lh, 0, 1)
    paste(hh, 1, 1)
    if u1 - u0 > 0 and v1 - v0 > 0:
        for r in range(a.shape[0]):
            a[r, :] = _sr_1d(a[r, :], u0, u1, reversible)
        for c in range(a.shape[1]):
            a[:, c] = _sr_1d(a[:, c], v0, v1, reversible)
    return a


# ---------------------------------------------------------------------------
# Codestream structures
# ---------------------------------------------------------------------------


@dataclass
class _Cod:
    prog: int = 0
    layers: int = 1
    mct: int = 0
    levels: int = 5
    xcb: int = 6  # log2 codeblock width
    ycb: int = 6
    cbstyle: int = 0
    transform: int = 1  # 1 = 5/3 reversible
    precincts: Optional[List[Tuple[int, int]]] = None  # (PPx, PPy) per res
    sop: bool = False
    eph: bool = False

    def pp(self, r: int) -> Tuple[int, int]:
        if self.precincts is None:
            return 15, 15
        return self.precincts[min(r, len(self.precincts) - 1)]


@dataclass
class _Qcd:
    style: int = 0  # 0 none, 1 derived, 2 expounded
    guard: int = 2
    exps: List[int] = field(default_factory=list)
    mants: List[int] = field(default_factory=list)


@dataclass
class _Seg:
    """One terminated coder segment of a codeblock (B.10.7.5)."""

    start: int  # global index of its first pass
    maxpasses: int
    npasses: int = 0
    data: bytearray = field(default_factory=bytearray)


def _seg_maxpasses(cbstyle: int, start_pass: int) -> int:
    """Passes per terminated segment for the segment starting at
    ``start_pass`` (D.4.1/D.5): TERMALL terminates every pass; BYPASS
    codes passes 0-9 with MQ then alternates raw (sig+ref) pairs with
    MQ cleanups, terminating at every coder switch."""
    if cbstyle & 0x04:  # termall
        return 1
    if cbstyle & 0x01:  # arithmetic bypass
        if start_pass == 0:
            return 10
        return 1 if (start_pass - 1) % 3 == 2 else 2
    return 109  # single segment: every pass any codeblock can have


def _pass_is_raw(cbstyle: int, p: int) -> bool:
    """BYPASS: significance + refinement passes from pass 10 on are raw."""
    return bool(cbstyle & 0x01) and p >= 10 and (p - 1) % 3 != 2


@dataclass
class _Cblk:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    lblock: int = 3
    npasses: int = 0
    zbp: int = 0
    segs: List[_Seg] = field(default_factory=list)


@dataclass
class _Band:
    orient: str
    x0: int
    y0: int
    x1: int
    y1: int
    eps: int = 0
    mant: int = 0
    gain: int = 0
    cblks: Dict[Tuple[int, int], _Cblk] = field(default_factory=dict)
    # per precinct: (tag trees, cblk index ranges)
    prec: List[dict] = field(default_factory=list)
    coeffs: Optional[np.ndarray] = None


def _parse_cod(body: bytes) -> _Cod:
    scod = body[0]
    prog, layers, mct = body[1], struct.unpack(">H", body[2:4])[0], body[4]
    levels = body[5]
    xcb = (body[6] & 0xF) + 2
    ycb = (body[7] & 0xF) + 2
    cbstyle = body[8]
    transform = body[9]
    precincts = None
    if scod & 1:
        precincts = []
        for i in range(10, len(body)):
            precincts.append((body[i] & 0xF, body[i] >> 4))
    return _Cod(
        prog,
        layers,
        mct,
        levels,
        xcb,
        ycb,
        cbstyle,
        transform,
        precincts,
        bool(scod & 2),
        bool(scod & 4),
    )


def _parse_qcd(body: bytes) -> _Qcd:
    sqcd = body[0]
    style = sqcd & 0x1F
    guard = sqcd >> 5
    q = _Qcd(style, guard)
    if style == 0:
        for b in body[1:]:
            q.exps.append(b >> 3)
            q.mants.append(0)
    elif style == 1:
        v = struct.unpack(">H", body[1:3])[0]
        q.exps.append(v >> 11)
        q.mants.append(v & 0x7FF)
    elif style == 2:
        for i in range(1, len(body) - 1, 2):
            v = struct.unpack(">H", body[i : i + 2])[0]
            q.exps.append(v >> 11)
            q.mants.append(v & 0x7FF)
    else:
        raise ValueError(f"jp2: unknown quantization style {style}")
    return q


@dataclass
class Jp2Image:
    width: int
    height: int
    depths: List[int]
    signed: List[bool]
    planes: List[np.ndarray]  # int32, DC-shifted, clamped
    colorspace: str  # "rgb" | "gray" | "ycc" | "unknown"
    alpha_index: Optional[int] = None
    subs: Optional[List[Tuple[int, int]]] = None  # per-plane (XRsiz, YRsiz)
    offs: Tuple[int, int] = (0, 0)  # (XOsiz, YOsiz) reference-grid origin

    def full_planes(self) -> List[np.ndarray]:
        """Planes sample-replicated onto the (height, width) reference
        grid: full pixel X maps to component sample floor(X/XRsiz)
        (each sample covers an XRsiz x YRsiz reference-grid cell, B.2)."""
        if not self.subs:
            return self.planes
        ox, oy = self.offs
        out = []
        for p, (xr, yr) in zip(self.planes, self.subs):
            if xr == 1 and yr == 1:
                out.append(p)
                continue
            xs = np.clip(
                (np.arange(self.width) + ox) // xr - _ceil_div(ox, xr),
                0, p.shape[1] - 1,
            )
            ys = np.clip(
                (np.arange(self.height) + oy) // yr - _ceil_div(oy, yr),
                0, p.shape[0] - 1,
            )
            out.append(p[np.ix_(ys, xs)])
        return out

    def rgba8(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(h, w, 3) float64 RGB in [0,1] plus optional alpha plane."""
        fl = []
        for p, d in zip(self.full_planes(), self.depths):
            fl.append(p.astype(np.float64) / float((1 << d) - 1))
        alpha = None
        color = fl
        if self.alpha_index is not None:
            alpha = fl[self.alpha_index]
            color = [p for i, p in enumerate(fl) if i != self.alpha_index]
        if len(color) >= 3:
            if self.colorspace == "ycc":
                # sYCC (colr enum 18, IEC 61966-2-1 amendment: BT.601
                # full-range matrix); chroma replicated by full_planes
                # when subsampled, as OpenJPEG's sycc420/422_to_rgb do.
                y, cb, cr = color[0], color[1] - 0.5, color[2] - 0.5
                rgb = np.stack(
                    [
                        y + 1.402 * cr,
                        y - 0.344136 * cb - 0.714136 * cr,
                        y + 1.772 * cb,
                    ],
                    axis=-1,
                ).clip(0.0, 1.0)
            else:
                rgb = np.stack(color[:3], axis=-1)
        else:
            rgb = np.repeat(color[0][..., None], 3, axis=-1)
        return rgb, alpha


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


class _Decoder:
    def __init__(self, cs: bytes):
        self.cs = cs
        self.cod: Optional[_Cod] = None
        self.coc: Dict[int, _Cod] = {}
        self.qcd: Optional[_Qcd] = None
        self.qcc: Dict[int, _Qcd] = {}
        self.tiles: Dict[int, bytearray] = {}
        self.tile_cod: Dict[int, _Cod] = {}
        self.tile_qcd: Dict[int, _Qcd] = {}
        self.poc: List[Tuple[int, int, int, int, int, int]] = []
        self.tile_poc: Dict[int, List] = {}
        self._parse_headers()

    def _parse_poc(self, body: bytes) -> List[Tuple[int, int, int, int, int, int]]:
        """POC entries (A.6.6): (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc)."""
        wide = self.ncomp >= 257
        esz = 9 if wide else 7
        out = []
        p = 0
        while p + esz <= len(body):
            if wide:
                rs, cs, lye, re_, ce, pp = struct.unpack(
                    ">BHHBHB", body[p : p + 9]
                )
            else:
                rs, cs, lye, re_, ce, pp = struct.unpack(
                    ">BBHBBB", body[p : p + 7]
                )
            # CEpoc == 0 means "all components" (the 8-bit field wraps at 256)
            out.append((rs, cs, lye, re_, ce if ce else self.ncomp, pp))
            p += esz
        if not out:
            raise ValueError("jp2: empty POC marker")
        return out

    def _parse_headers(self):
        cs = self.cs
        if cs[:2] != b"\xff\x4f":
            raise ValueError("jp2: missing SOC")
        p = 2
        while p < len(cs):
            marker = struct.unpack(">H", cs[p : p + 2])[0]
            p += 2
            if marker == 0xFFD9:  # EOC
                break
            if marker == 0xFF93:  # SOD inside _parse? handled via SOT branch
                raise ValueError("jp2: SOD outside tile-part")
            ln = struct.unpack(">H", cs[p : p + 2])[0]
            body = cs[p + 2 : p + ln]
            if marker == 0xFF51:  # SIZ
                (
                    _rsiz,
                    self.xsiz,
                    self.ysiz,
                    self.xosiz,
                    self.yosiz,
                    self.xtsiz,
                    self.ytsiz,
                    self.xtosiz,
                    self.ytosiz,
                    csiz,
                ) = struct.unpack(">HIIIIIIIIH", body[:36])
                self.ncomp = csiz
                self.depths, self.signed, self.subs = [], [], []
                for c in range(csiz):
                    ssiz, xr, yr = body[36 + 3 * c : 39 + 3 * c]
                    if xr == 0 or yr == 0:
                        raise ValueError("jp2: zero subsampling factor")
                    self.depths.append((ssiz & 0x7F) + 1)
                    self.signed.append(bool(ssiz & 0x80))
                    self.subs.append((xr, yr))
                p += ln
            elif marker == 0xFF52:
                self.cod = _parse_cod(body)
                p += ln
            elif marker == 0xFF53:  # COC
                c = body[0] if self.ncomp < 257 else struct.unpack(">H", body[:2])[0]
                off = 1 if self.ncomp < 257 else 2
                scoc = body[off]
                sub = bytes([scoc]) + b"\x00\x00\x00\x00" + body[off + 1 :]
                coc = _parse_cod(sub)
                base = self.cod
                coc.prog, coc.layers, coc.mct = base.prog, base.layers, base.mct
                self.coc[c] = coc
                p += ln
            elif marker == 0xFF5C:
                self.qcd = _parse_qcd(body)
                p += ln
            elif marker == 0xFF5D:  # QCC
                c = body[0] if self.ncomp < 257 else struct.unpack(">H", body[:2])[0]
                off = 1 if self.ncomp < 257 else 2
                self.qcc[c] = _parse_qcd(body[off:])
                p += ln
            elif marker == 0xFF5F:  # POC
                self.poc = self._parse_poc(body)
                p += ln
            elif marker == 0xFF90:  # SOT
                _lsot, isot, psot, _tpsot, _tnsot = struct.unpack(
                    ">HHIBB", cs[p : p + 10]
                )
                # Scan the remaining tile-part header segments up to SOD.
                q = p + ln
                while True:
                    m2 = struct.unpack(">H", cs[q : q + 2])[0]
                    if m2 == 0xFF93:
                        q += 2
                        break
                    l2 = struct.unpack(">H", cs[q + 2 : q + 4])[0]
                    b2 = cs[q + 4 : q + 2 + l2]
                    if m2 == 0xFF52:
                        self.tile_cod[isot] = _parse_cod(b2)
                    elif m2 == 0xFF5C:
                        self.tile_qcd[isot] = _parse_qcd(b2)
                    elif m2 == 0xFF5F:
                        self.tile_poc[isot] = self._parse_poc(b2)
                    q += 2 + l2
                if psot == 0:
                    end = len(cs)
                    tail = cs.rfind(b"\xff\xd9")
                    if tail != -1:
                        end = tail
                else:
                    end = p - 2 + psot
                self.tiles.setdefault(isot, bytearray()).extend(cs[q:end])
                p = end
            else:
                p += ln

    # -- geometry -----------------------------------------------------------

    def _tile_rect(self, t: int) -> Tuple[int, int, int, int]:
        ntx = _ceil_div(self.xsiz - self.xtosiz, self.xtsiz)
        ti, tj = t % ntx, t // ntx
        tx0 = max(self.xtosiz + ti * self.xtsiz, self.xosiz)
        ty0 = max(self.ytosiz + tj * self.ytsiz, self.yosiz)
        tx1 = min(self.xtosiz + (ti + 1) * self.xtsiz, self.xsiz)
        ty1 = min(self.ytosiz + (tj + 1) * self.ytsiz, self.ysiz)
        return tx0, ty0, tx1, ty1

    def _cod_for(self, t: int, c: int) -> _Cod:
        if t in self.tile_cod:
            return self.tile_cod[t]
        cod = self.coc.get(c, self.cod)
        if cod is None:
            raise ValueError("jp2: no COD marker")
        return cod

    def _qcd_for(self, t: int, c: int) -> _Qcd:
        if t in self.tile_qcd:
            return self.tile_qcd[t]
        qcd = self.qcc.get(c, self.qcd)
        if qcd is None:
            raise ValueError("jp2: no QCD marker")
        return qcd

    def decode(self) -> Jp2Image:
        ntx = _ceil_div(self.xsiz - self.xtosiz, self.xtsiz)
        nty = _ceil_div(self.ysiz - self.ytosiz, self.ytsiz)
        h = self.ysiz - self.yosiz
        w = self.xsiz - self.xosiz
        # Component planes live on their own subsampled grids (B.2):
        # ceil(xsiz/xr) - ceil(xosiz/xr) samples wide.
        planes = []
        for c in range(self.ncomp):
            xr, yr = self.subs[c]
            wc = _ceil_div(self.xsiz, xr) - _ceil_div(self.xosiz, xr)
            hc = _ceil_div(self.ysiz, yr) - _ceil_div(self.yosiz, yr)
            planes.append(np.zeros((hc, wc), dtype=np.int32))
        for t in range(ntx * nty):
            tx0, ty0, tx1, ty1 = self._tile_rect(t)
            if tx1 <= tx0 or ty1 <= ty0:
                continue
            comps = self._decode_tile(t, tx0, ty0, tx1, ty1)
            for c in range(self.ncomp):
                xr, yr = self.subs[c]
                ys = _ceil_div(ty0, yr) - _ceil_div(self.yosiz, yr)
                xs = _ceil_div(tx0, xr) - _ceil_div(self.xosiz, xr)
                ch, cw = comps[c].shape
                planes[c][ys : ys + ch, xs : xs + cw] = comps[c]
        return Jp2Image(
            w, h, self.depths, self.signed, planes, "unknown",
            subs=list(self.subs), offs=(self.xosiz, self.yosiz),
        )

    # -- per-tile -----------------------------------------------------------

    def _build_bands(self, t: int, c: int, rect) -> List[List[_Band]]:
        tcx0, tcy0, tcx1, tcy1 = rect
        cod = self._cod_for(t, c)
        qcd = self._qcd_for(t, c)
        nl = cod.levels
        res: List[List[_Band]] = []
        qi = 0
        for r in range(nl + 1):
            bands = []
            if r == 0:
                specs = [("LL", nl, 0, 0, 0)]
            else:
                nb = nl - r + 1
                specs = [
                    ("HL", nb, 1, 0, 1),
                    ("LH", nb, 0, 1, 1),
                    ("HH", nb, 1, 1, 2),
                ]
            for orient, nb, xob, yob, gain in specs:
                den = 1 << nb
                bx0 = _ceil_div(tcx0 - (1 << (nb - 1)) * xob, den) if nb else tcx0
                bx1 = _ceil_div(tcx1 - (1 << (nb - 1)) * xob, den) if nb else tcx1
                by0 = _ceil_div(tcy0 - (1 << (nb - 1)) * yob, den) if nb else tcy0
                by1 = _ceil_div(tcy1 - (1 << (nb - 1)) * yob, den) if nb else tcy1
                band = _Band(orient, bx0, by0, bx1, by1, gain=gain)
                if qcd.style == 1:  # derived from the LL entry
                    band.eps = qcd.exps[0] - nl + nb if nb else qcd.exps[0]
                    band.mant = qcd.mants[0]
                else:
                    band.eps = qcd.exps[min(qi, len(qcd.exps) - 1)]
                    band.mant = qcd.mants[min(qi, len(qcd.mants) - 1)]
                qi += 1
                bands.append(band)
            res.append(bands)
        return res

    def _precincts(self, cod: _Cod, r: int, nl: int, rect) -> List[Tuple[int, int, int, int]]:
        tcx0, tcy0, tcx1, tcy1 = rect
        den = 1 << (nl - r)
        trx0, try0 = _ceil_div(tcx0, den), _ceil_div(tcy0, den)
        trx1, try1 = _ceil_div(tcx1, den), _ceil_div(tcy1, den)
        ppx, ppy = cod.pp(r)
        if trx1 <= trx0 or try1 <= try0:
            return []
        px0 = (trx0 >> ppx) << ppx
        py0 = (try0 >> ppy) << ppy
        out = []
        for py in range(py0, try1, 1 << ppy):
            for px in range(px0, trx1, 1 << ppx):
                out.append(
                    (
                        (
                            max(px, trx0),
                            max(py, try0),
                            min(px + (1 << ppx), trx1),
                            min(py + (1 << ppy), try1),
                        ),
                        # The UNCLIPPED lattice cell: the band-grid mapping
                        # divides this, not the clipped rect (B.7 — clipping
                        # first loses a codeblock when the resolution rect
                        # starts on an odd coordinate).
                        (px, py, px + (1 << ppx), py + (1 << ppy)),
                    )
                )
        return out

    def _decode_tile(self, t: int, tx0, ty0, tx1, ty1) -> List[np.ndarray]:
        data = bytes(self.tiles.get(t, b""))
        ncomp = self.ncomp
        # Per-component tile rects on the subsampled grids (B.3).
        rects = []
        for c in range(ncomp):
            xr, yr = self.subs[c]
            rects.append((
                _ceil_div(tx0, xr), _ceil_div(ty0, yr),
                _ceil_div(tx1, xr), _ceil_div(ty1, yr),
            ))
        allbands = [self._build_bands(t, c, rects[c]) for c in range(ncomp)]
        cods = [self._cod_for(t, c) for c in range(ncomp)]
        nlmax = max(cod.levels for cod in cods)
        layers = cods[0].layers
        prog = cods[0].prog

        # Pre-compute precinct/codeblock structure.
        prec_geo: Dict[Tuple[int, int], List] = {}
        for c in range(ncomp):
            cod = cods[c]
            nl = cod.levels
            for r in range(nl + 1):
                precs = self._precincts(cod, r, nl, rects[c])
                prec_geo[(c, r)] = precs
                for band in allbands[c][r]:
                    shift = 0 if r == 0 else 1
                    xcb = min(cod.xcb, cod.pp(r)[0] - shift)
                    ycb = min(cod.ycb, cod.pp(r)[1] - shift)
                    for _prect, lat in precs:
                        # Precinct LATTICE cell mapped onto the band grid,
                        # then clipped to the band below (B.7).
                        if r == 0:
                            pb = lat
                        else:
                            pb = (
                                _ceil_div(lat[0], 2),
                                _ceil_div(lat[1], 2),
                                _ceil_div(lat[2], 2),
                                _ceil_div(lat[3], 2),
                            )
                        bx0, by0 = max(pb[0], band.x0), max(pb[1], band.y0)
                        bx1, by1 = min(pb[2], band.x1), min(pb[3], band.y1)
                        cbs = []
                        if bx1 > bx0 and by1 > by0:
                            cw, ch = 1 << xcb, 1 << ycb
                            gx0, gy0 = bx0 >> xcb, by0 >> ycb
                            gx1, gy1 = _ceil_div(bx1, cw), _ceil_div(by1, ch)
                            for gy in range(gy0, gy1):
                                row = []
                                for gx in range(gx0, gx1):
                                    cb = _Cblk(
                                        max(gx * cw, bx0),
                                        max(gy * ch, by0),
                                        min((gx + 1) * cw, bx1),
                                        min((gy + 1) * ch, by1),
                                    )
                                    row.append(cb)
                                cbs.append(row)
                        nw = len(cbs[0]) if cbs else 0
                        nh = len(cbs)
                        band.prec.append(
                            {
                                "cbs": cbs,
                                "incl": _TagTree(max(nw, 1), max(nh, 1)),
                                "zbp": _TagTree(max(nw, 1), max(nh, 1)),
                            }
                        )

        # Packet iteration per progression order.
        pos = [0]

        def one_packet(c: int, r: int, pi: int, layer: int):
            cod = cods[c]
            if r > cod.levels or pi >= len(prec_geo[(c, r)]):
                return
            if cod.sop and data[pos[0] : pos[0] + 2] == b"\xff\x91":
                pos[0] += 6
            rd = _Bits(data, pos[0])
            bands = allbands[c][r]
            if not rd.bit():  # empty packet
                rd.align()
                pos[0] = rd.pos
                if cod.eph and data[pos[0] : pos[0] + 2] == b"\xff\x92":
                    pos[0] += 2
                return
            todo = []  # (cblk, newpasses, nbytes)
            for band in bands:
                pr = band.prec[pi]
                cbs = pr["cbs"]
                for gy, row in enumerate(cbs):
                    for gx, cb in enumerate(row):
                        if cb.x1 <= cb.x0 or cb.y1 <= cb.y0:
                            continue
                        if not cb.included:
                            inc = pr["incl"].decode(rd, gy, gx, layer + 1)
                        else:
                            inc = bool(rd.bit())
                        if not inc:
                            continue
                        if not cb.included:
                            thr = 1
                            while not pr["zbp"].decode(rd, gy, gx, thr):
                                thr += 1
                            cb.zbp = thr - 1
                            cb.included = True
                        # number of new passes
                        if not rd.bit():
                            np_ = 1
                        elif not rd.bit():
                            np_ = 2
                        else:
                            v = rd.bits(2)
                            if v != 3:
                                np_ = 3 + v
                            else:
                                v = rd.bits(5)
                                if v != 31:
                                    np_ = 6 + v
                                else:
                                    np_ = 37 + rd.bits(7)
                        while rd.bit():
                            cb.lblock += 1
                        # Split the new passes over terminated segments;
                        # one length per segment part (B.10.7.5).
                        cbsty = cod.cbstyle
                        remaining = np_
                        while remaining:
                            if (
                                cb.segs
                                and cb.segs[-1].npasses < cb.segs[-1].maxpasses
                            ):
                                seg = cb.segs[-1]
                            else:
                                seg = _Seg(
                                    cb.npasses,
                                    _seg_maxpasses(cbsty, cb.npasses),
                                )
                                cb.segs.append(seg)
                            take = min(
                                seg.maxpasses - seg.npasses, remaining
                            )
                            nbits = cb.lblock + int(
                                math.floor(math.log2(take))
                            )
                            nbytes = rd.bits(nbits)
                            todo.append((cb, seg, take, nbytes))
                            seg.npasses += take
                            cb.npasses += take
                            remaining -= take
            rd.align()
            pos[0] = rd.pos
            if cod.eph and data[pos[0] : pos[0] + 2] == b"\xff\x92":
                pos[0] += 2
            for _cb, seg, _take, nbytes in todo:
                seg.data.extend(data[pos[0] : pos[0] + nbytes])
                pos[0] += nbytes

        maxprec = max(len(v) for v in prec_geo.values()) if prec_geo else 0
        seen: set = set()

        def iterate(prog_, l1, r0, r1, c0, c1):
            """Emit the progression volume's packets in order, skipping
            ones already emitted by an earlier POC entry (B.12.2: each
            packet appears exactly once).  Position iteration (the P in
            RPCL/PCRL/CPRL) walks precinct indices — exact for the
            ubiquitous one-precinct-per-resolution layout."""

            def emit(c, r, pi, layer):
                key = (c, r, pi, layer)
                if key not in seen:
                    seen.add(key)
                    one_packet(c, r, pi, layer)

            def nprec(c, r):
                return len(prec_geo.get((c, r), []))

            r1_ = min(r1, nlmax + 1)
            c1_ = min(c1, ncomp)
            if prog_ == 0:  # LRCP
                for layer in range(l1):
                    for r in range(r0, r1_):
                        for c in range(c0, c1_):
                            for pi in range(nprec(c, r)):
                                emit(c, r, pi, layer)
            elif prog_ == 1:  # RLCP
                for r in range(r0, r1_):
                    for layer in range(l1):
                        for c in range(c0, c1_):
                            for pi in range(nprec(c, r)):
                                emit(c, r, pi, layer)
            elif prog_ == 2:  # RPCL
                for r in range(r0, r1_):
                    for pi in range(maxprec):
                        for c in range(c0, c1_):
                            if pi < nprec(c, r):
                                for layer in range(l1):
                                    emit(c, r, pi, layer)
            elif prog_ == 3:  # PCRL
                for pi in range(maxprec):
                    for c in range(c0, c1_):
                        for r in range(r0, r1_):
                            if pi < nprec(c, r):
                                for layer in range(l1):
                                    emit(c, r, pi, layer)
            elif prog_ == 4:  # CPRL
                for c in range(c0, c1_):
                    for pi in range(maxprec):
                        for r in range(r0, r1_):
                            if pi < nprec(c, r):
                                for layer in range(l1):
                                    emit(c, r, pi, layer)
            else:
                raise ValueError(f"jp2: progression order {prog_} unsupported")

        poc = self.tile_poc.get(t) or self.poc
        if poc:
            for rs, cs, lye, re_, ce, pp in poc:
                iterate(pp, min(lye, layers), rs, re_, cs, ce)
        else:
            iterate(prog, layers, 0, nlmax + 1, 0, ncomp)

        # Tier-1 + dequant + IDWT per component.
        out = []
        for c in range(ncomp):
            cod = cods[c]
            qcd = self._qcd_for(t, c)
            if cod.cbstyle & ~0x3F:
                raise ValueError(
                    f"jp2: codeblock style 0x{cod.cbstyle:02x} unsupported"
                )
            reversible = cod.transform == 1
            nl = cod.levels
            rb_extra = self.depths[c]
            for r in range(nl + 1):
                for band in allbands[c][r]:
                    bh, bw = band.y1 - band.y0, band.x1 - band.x0
                    dt = np.int64 if reversible else np.float64
                    coeffs = np.zeros((max(bh, 0), max(bw, 0)), dtype=dt)
                    mb = qcd.guard + band.eps - 1
                    if reversible:
                        delta = 1.0
                    else:
                        rb = rb_extra + band.gain
                        delta = (2.0 ** (rb - band.eps)) * (
                            1.0 + band.mant / 2048.0
                        )
                    for pr in band.prec:
                        for row in pr["cbs"]:
                            for cb in row:
                                if not cb.included or cb.npasses == 0:
                                    continue
                                cw, ch = cb.x1 - cb.x0, cb.y1 - cb.y0
                                numbps = mb - cb.zbp
                                mag, neg, lastbp = _t1_decode(
                                    cb.segs,
                                    cw,
                                    ch,
                                    numbps,
                                    band.orient,
                                    cod.cbstyle,
                                )
                                # Truncated blocks (quality layers) leave
                                # planes below lastbp undecoded: reconstruct
                                # at the bin midpoint mag + 0.5*2^lastbp
                                # (E.1.1.2; lastbp==0 for full decodes).
                                if reversible:
                                    vals = mag.astype(np.int64)
                                    nz = vals > 0
                                    vals[nz] += (
                                        1 << lastbp[nz].astype(np.int64)
                                    ) >> 1
                                    vals[neg] = -vals[neg]
                                else:
                                    vals = mag.astype(np.float64)
                                    nz = vals > 0
                                    vals[nz] = (
                                        vals[nz]
                                        + 0.5 * np.exp2(lastbp[nz].astype(np.float64))
                                    ) * delta
                                    vals[neg] = -vals[neg]
                                coeffs[
                                    cb.y0 - band.y0 : cb.y1 - band.y0,
                                    cb.x0 - band.x0 : cb.x1 - band.x0,
                                ] = vals
                    band.coeffs = coeffs
            # IDWT over the component's own (subsampled) tile rect
            tcx0, tcy0, tcx1, tcy1 = rects[c]
            ll = allbands[c][0][0].coeffs
            for r in range(1, nl + 1):
                den = 1 << (nl - r)
                u0, u1 = _ceil_div(tcx0, den), _ceil_div(tcx1, den)
                v0, v1 = _ceil_div(tcy0, den), _ceil_div(tcy1, den)
                hl, lh, hh = (b.coeffs for b in allbands[c][r])
                ll = _sr_2d(ll, hl, lh, hh, u0, u1, v0, v1, reversible)
            out.append(ll)

        # Inverse MCT + DC shift + clamp.
        cod0 = cods[0]
        if cod0.mct and ncomp >= 3:
            if not (out[0].shape == out[1].shape == out[2].shape):
                raise ValueError(
                    "jp2: MCT with mismatched component subsampling"
                )
            y0_, y1_, y2_ = out[0], out[1], out[2]
            if cod0.transform == 1:  # RCT
                g = y0_ - ((y1_ + y2_) >> 2)
                r_ = y2_ + g
                b_ = y1_ + g
            else:  # ICT
                r_ = y0_ + 1.402 * y2_
                g = y0_ - 0.344136 * y1_ - 0.714136 * y2_
                b_ = y0_ + 1.772 * y1_
            out[0], out[1], out[2] = r_, g, b_
        final = []
        for c in range(ncomp):
            v = out[c]
            if v.dtype != np.int64:
                v = np.floor(v + 0.5).astype(np.int64)
            if not self.signed[c]:
                v = v + (1 << (self.depths[c] - 1))
                v = np.clip(v, 0, (1 << self.depths[c]) - 1)
            else:
                half = 1 << (self.depths[c] - 1)
                v = np.clip(v, -half, half - 1)
            final.append(v.astype(np.int32))
        return final


# ---------------------------------------------------------------------------
# JP2 container (ISO base media boxes)
# ---------------------------------------------------------------------------


def _find_boxes(data: bytes, start: int, end: int):
    p = start
    while p + 8 <= end:
        ln = struct.unpack(">I", data[p : p + 4])[0]
        typ = data[p + 4 : p + 8]
        body_start = p + 8
        if ln == 1:
            ln = struct.unpack(">Q", data[p + 8 : p + 16])[0]
            body_start = p + 16
        elif ln == 0:
            ln = end - p
        yield typ, body_start, p + ln
        p += ln


def decode(data: bytes) -> Jp2Image:
    """Decode a JP2 file or raw J2K codestream.

    All corruption surfaces as ValueError (never struct.error/IndexError
    or a hang) — the io-stack robustness bar of io/jpeg.py / io/jbig2.py.
    """
    try:
        return _decode(data)
    except (struct.error, IndexError) as e:
        raise ValueError(f"jp2: corrupt stream ({e})") from e


def _parse_pclr(data: bytes, s: int, e: int):
    """Palette box (I.5.3.4): (entries (NE, NPC) int32 array, per-column
    (depth, signed))."""
    ne, npc = struct.unpack(">HB", data[s : s + 3])
    if not (1 <= ne <= 1024 and 1 <= npc <= 255):
        raise ValueError("jp2: bad pclr box")
    cols = []
    p = s + 3
    for _ in range(npc):
        b = data[p]
        cols.append(((b & 0x7F) + 1, bool(b & 0x80)))
        p += 1
    ent = np.zeros((ne, npc), dtype=np.int64)
    for i in range(ne):
        for j, (depth, signed) in enumerate(cols):
            nb = (depth + 7) // 8
            if p + nb > e:
                raise ValueError("jp2: truncated pclr box")
            v = int.from_bytes(data[p : p + nb], "big")
            if signed and v >= 1 << (depth - 1):
                v -= 1 << depth
            ent[i, j] = v
            p += nb
    return ent, cols


def _parse_cmap(data: bytes, s: int, e: int):
    """Component-mapping box (I.5.3.5): [(CMP, MTYP, PCOL)] per channel."""
    out = []
    p = s
    while p + 4 <= e:
        cmp_, mtyp, pcol = struct.unpack(">HBB", data[p : p + 4])
        out.append((cmp_, mtyp, pcol))
        p += 4
    if not out:
        raise ValueError("jp2: empty cmap box")
    return out


def _apply_palette(img: Jp2Image, pclr, cmap) -> Jp2Image:
    """Map codestream components through pclr/cmap into output channels."""
    ent, cols = pclr
    planes, depths, signed, subs = [], [], [], []
    for cmp_, mtyp, pcol in cmap:
        if cmp_ >= len(img.planes):
            raise ValueError("jp2: cmap names a missing component")
        src = img.planes[cmp_]
        if mtyp == 0:  # direct use
            planes.append(src)
            depths.append(img.depths[cmp_])
            signed.append(img.signed[cmp_])
        elif mtyp == 1:  # palette lookup
            if pcol >= ent.shape[1]:
                raise ValueError("jp2: cmap names a missing palette column")
            idx = np.clip(src, 0, ent.shape[0] - 1)
            planes.append(ent[idx, pcol].astype(np.int32))
            depth, sgn = cols[pcol]
            depths.append(depth)
            signed.append(sgn)
        else:
            raise ValueError(f"jp2: unknown cmap mapping type {mtyp}")
        subs.append(img.subs[cmp_] if img.subs else (1, 1))
    return Jp2Image(
        img.width, img.height, depths, signed, planes, img.colorspace,
        subs=subs, offs=img.offs,
    )


def _decode(data: bytes) -> Jp2Image:
    colorspace = "unknown"
    alpha_index: Optional[int] = None
    cs = None
    pclr = cmap = None
    if data[:2] == b"\xff\x4f":
        cs = data
    else:
        for typ, s, e in _find_boxes(data, 0, len(data)):
            if typ == b"jp2h":
                for t2, s2, e2 in _find_boxes(data, s, e):
                    if t2 == b"colr":
                        meth = data[s2]
                        if meth == 1:
                            enum = struct.unpack(">I", data[s2 + 3 : s2 + 7])[0]
                            colorspace = {16: "rgb", 17: "gray", 18: "ycc"}.get(
                                enum, "unknown"
                            )
                    elif t2 == b"cdef":
                        n = struct.unpack(">H", data[s2 : s2 + 2])[0]
                        for k in range(n):
                            cn, typ_, _asoc = struct.unpack(
                                ">HHH", data[s2 + 2 + 6 * k : s2 + 8 + 6 * k]
                            )
                            if typ_ in (1, 2):
                                alpha_index = cn
                    elif t2 == b"pclr":
                        pclr = _parse_pclr(data, s2, e2)
                    elif t2 == b"cmap":
                        cmap = _parse_cmap(data, s2, e2)
            elif typ == b"jp2c":
                cs = data[s:e]
                break
    if cs is None:
        raise ValueError("jp2: no codestream found")
    img = _Decoder(cs).decode()
    img.colorspace = colorspace
    if pclr is not None:
        if cmap is None:
            # I.5.3.5: cmap is required with pclr; tolerate its absence by
            # expanding palette columns over component 0 in order.
            cmap = [(0, 1, j) for j in range(pclr[0].shape[1])]
        img = _apply_palette(img, pclr, cmap)
    if alpha_index is not None and alpha_index < len(img.planes):
        img.alpha_index = alpha_index
    elif img.colorspace in ("rgb", "unknown") and len(img.planes) == 4:
        img.alpha_index = 3
    elif img.colorspace == "gray" and len(img.planes) == 2:
        img.alpha_index = 1
    return img
