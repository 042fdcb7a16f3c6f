"""Embedded CMap streams for Type 0 fonts (PDF 9.7.5.3 / Adobe CMap syntax).

The port's copy of ``coherence_tpu.io.cmap``, whole.

BEYOND REFERENCE: the reference never rasterizes text, so camlpdf's CMap
handling is unused there.  Here a Type 0 font whose /Encoding is an
embedded CMap stream gets real variable-length code splitting and
code -> CID mapping: ``codespacerange`` entries drive the byte-length
scanner, ``cidrange``/``cidchar`` sections map codes, /WMode selects
vertical writing, and ``usecmap`` composes a base CMap (Identity-H/V or
another embedded stream resolved by the caller).

Only the CMap operators relevant to CID selection are interpreted; the
surrounding PostScript scaffolding (``findresource``/``dict``/``def``)
is skipped token-wise, matching how every mainstream viewer consumes
embedded CMaps.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = ["CMap", "parse_cmap", "IDENTITY_H", "IDENTITY_V"]

_TOKEN = re.compile(
    rb"<[0-9A-Fa-f\s]*>|/[^\s<>\[\]{}/%()]*|[-+]?[0-9]+(?:\.[0-9]*)?"
    rb"|[A-Za-z*]+|\[|\]"
)


class CMap:
    """code -> CID mapping with variable-length codespaces."""

    def __init__(self):
        # (nbytes, lo, hi) with lo/hi as ints over nbytes bytes
        self.codespaces: List[Tuple[int, int, int]] = []
        # (nbytes, lo, hi, first_cid)
        self.ranges: List[Tuple[int, int, int, int]] = []
        self.chars: Dict[Tuple[int, int], int] = {}
        self.wmode = 0
        self.base: Optional["CMap"] = None  # usecmap

    def split(self, s: bytes) -> List[Tuple[int, int]]:
        """Greedy codespace scan -> [(nbytes, code)].  Bytes that match no
        codespace consume one byte (PDF 9.7.6.3 error behaviour)."""
        spaces = self.codespaces or (self.base.codespaces if self.base else [])
        if not spaces:
            spaces = [(2, 0, 0xFFFF)]  # identity default
        by_len: Dict[int, List[Tuple[int, int]]] = {}
        for n, lo, hi in spaces:
            by_len.setdefault(n, []).append((lo, hi))
        lens = sorted(by_len)
        out: List[Tuple[int, int]] = []
        i = 0
        while i < len(s):
            matched = False
            for n in lens:
                if i + n > len(s):
                    continue
                v = int.from_bytes(s[i : i + n], "big")
                if any(lo <= v <= hi for lo, hi in by_len[n]):
                    out.append((n, v))
                    i += n
                    matched = True
                    break
            if not matched:
                # 9.7.6.3: use the shortest codespace length, skip that many
                n = min(lens)
                if i + n <= len(s):
                    out.append((n, int.from_bytes(s[i : i + n], "big")))
                i += n
        return out

    def cid(self, nbytes: int, code: int) -> int:
        got = self.chars.get((nbytes, code))
        if got is not None:
            return got
        for n, lo, hi, first in self.ranges:
            if n == nbytes and lo <= code <= hi:
                return first + (code - lo)
        if self.base is not None:
            return self.base.cid(nbytes, code)
        return 0


def _identity(wmode: int) -> CMap:
    c = CMap()
    c.codespaces = [(2, 0, 0xFFFF)]
    c.ranges = [(2, 0, 0xFFFF, 0)]
    c.wmode = wmode
    return c


IDENTITY_H = _identity(0)
IDENTITY_V = _identity(1)


def _hex(tok: bytes) -> Tuple[int, int]:
    """<..> token -> (nbytes, value)."""
    h = re.sub(rb"\s", b"", tok[1:-1])
    if len(h) % 2:
        h += b"0"
    return (max(1, len(h) // 2), int(h or b"0", 16))


def parse_cmap(data: bytes, lookup_usecmap=None) -> CMap:
    """Parse an embedded CMap program.  ``lookup_usecmap(name)`` may
    resolve a ``usecmap`` reference to a base CMap (e.g. Identity-H)."""
    cm = CMap()
    toks = _TOKEN.findall(data)
    i = 0
    n = len(toks)

    def num(tok) -> int:
        return int(float(tok))

    while i < n:
        t = toks[i]
        if t == b"begincodespacerange":
            i += 1
            while i + 1 < n and toks[i].startswith(b"<"):
                nb, lo = _hex(toks[i])
                _, hi = _hex(toks[i + 1])
                cm.codespaces.append((nb, lo, hi))
                i += 2
            continue
        if t == b"begincidrange":
            i += 1
            while i + 2 < n and toks[i].startswith(b"<"):
                nb, lo = _hex(toks[i])
                _, hi = _hex(toks[i + 1])
                cm.ranges.append((nb, lo, hi, num(toks[i + 2])))
                i += 3
            continue
        if t == b"begincidchar":
            i += 1
            while i + 1 < n and toks[i].startswith(b"<"):
                nb, code = _hex(toks[i])
                cm.chars[(nb, code)] = num(toks[i + 1])
                i += 2
            continue
        if t == b"usecmap" and i >= 1 and toks[i - 1].startswith(b"/"):
            name = toks[i - 1][1:].decode("latin-1")
            if name == "Identity-H":
                cm.base = IDENTITY_H
            elif name == "Identity-V":
                cm.base = IDENTITY_V
            elif lookup_usecmap is not None:
                try:
                    cm.base = lookup_usecmap(name)
                except Exception:
                    cm.base = None
        if t == b"def" and i >= 2 and toks[i - 2] == b"/WMode":
            try:
                cm.wmode = num(toks[i - 1])
            except ValueError:
                pass
        i += 1
    return cm
