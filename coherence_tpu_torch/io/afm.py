"""Standard-14 font metrics (PDF 9.6.2.2: the base fonts' widths may be
omitted from the font dictionary; a conforming reader knows them).  BEYOND
REFERENCE: the reference never rasterizes text, so it needs no metrics at
all; here a bundled widths table (``data/std14_widths.txt.gz``, generated
from the URW metric-compatible clones of the Adobe 14: Nimbus
Sans/Roman/Mono, Standard Symbols, Dingbats) supplies exact advances for
non-embedded standard fonts with NO environment dependency.  matplotlib's
AFMs remain the cross-validation oracle in tests only.

The port's copy of ``coherence_tpu.io.afm``, whole.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

# PDF base name -> matplotlib AFM stem (URW metric clones of the Adobe 14).
_AFM_STEMS = {
    "Helvetica": "phvr8a",
    "Helvetica-Bold": "phvb8a",
    "Helvetica-Oblique": "phvro8a",
    "Helvetica-BoldOblique": "phvbo8a",
    "Times-Roman": "ptmr8a",
    "Times-Bold": "ptmb8a",
    "Times-Italic": "ptmri8a",
    "Times-BoldItalic": "ptmbi8a",
    "Courier": "pcrr8a",
    "Courier-Bold": "pcrb8a",
    "Courier-Oblique": "pcrro8a",
    "Courier-BoldOblique": "pcrbo8a",
    "Symbol": "psyr",
    "ZapfDingbats": "pzdr",
}


def std14_name(base_font: str) -> Optional[str]:
    """Normalize a /BaseFont value (incl. subset tags and the common
    Arial/TimesNewRoman/CourierNew aliases) to a standard-14 name."""
    n = str(base_font or "").split("+")[-1].replace(" ", "")
    low = n.lower()
    if low.startswith("symbol"):
        return "Symbol"
    if low.startswith(("zapfdingbats", "dingbats")):
        return "ZapfDingbats"
    if low.startswith(("helvetica", "arial")):
        fam, styles = "Helvetica", ("Bold", "Oblique", "BoldOblique")
    elif low.startswith(("timesnewroman", "times")):
        fam, styles = "Times", ("Bold", "Italic", "BoldItalic")
    elif low.startswith(("couriernew", "courier")):
        fam, styles = "Courier", ("Bold", "Oblique", "BoldOblique")
    else:
        return None
    bold = "bold" in low
    italic = "italic" in low or "oblique" in low
    if fam == "Times":
        style = ("BoldItalic" if bold and italic
                 else "Bold" if bold else "Italic" if italic else "Roman")
        return f"Times-{style}"
    if bold and italic:
        return f"{fam}-{styles[2]}"
    if bold:
        return f"{fam}-{styles[0]}"
    if italic:
        return f"{fam}-{styles[1]}"
    return fam


_CHAR_RE = re.compile(rb"C\s+(-?\d+)\s*;\s*WX\s+(-?\d+)\s*;\s*N\s+(\S+)\s*;")

# (code -> width, glyphname -> width) per standard-14 name; None = no AFM.
_CACHE: Dict[str, Optional[Tuple[Dict[int, float], Dict[str, float]]]] = {}


def _load_bundled() -> None:
    """Parse the bundled widths table into _CACHE (all 14 fonts at once)."""
    import gzip

    path = os.path.join(os.path.dirname(__file__), "data", "std14_widths.txt.gz")
    with gzip.open(path, "rt", encoding="ascii") as f:
        font = None
        by_code: Dict[int, float] = {}
        by_name: Dict[str, float] = {}
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("["):
                if font is not None:
                    _CACHE[font] = (by_code, by_name)
                font = line[1:-1]
                by_code, by_name = {}, {}
            else:
                code_s, wx_s, name = line.split(" ", 2)
                code, wx = int(code_s), float(wx_s)
                by_name[name] = wx
                if code >= 0:
                    by_code[code] = wx
        if font is not None:
            _CACHE[font] = (by_code, by_name)


def matplotlib_afm_widths(std_name: str):
    """Width tables parsed straight from matplotlib's bundled URW AFM files
    — the cross-validation ORACLE for the bundled table; returns None when
    matplotlib is absent.  Production code uses afm_widths()."""
    try:
        import matplotlib
    except Exception:
        return None
    stem = _AFM_STEMS.get(std_name)
    if stem is None:
        return None
    path = os.path.join(
        os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "afm", stem + ".afm"
    )
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    by_code: Dict[int, float] = {}
    by_name: Dict[str, float] = {}
    for m in _CHAR_RE.finditer(data):
        code, wx, name = int(m.group(1)), float(m.group(2)), m.group(3).decode("ascii")
        by_name[name] = wx
        if code >= 0:
            by_code[code] = wx
    return (by_code, by_name) if by_name else None


def afm_widths(std_name: str):
    """``(by_code, by_name)`` width tables in glyph units (1000/em) for a
    standard-14 name, or None.  ``by_code`` uses the AFM's own default
    encoding (AdobeStandard for the text faces; the builtin symbolic
    encodings for Symbol/ZapfDingbats).  Served from the bundled table —
    no environment dependency."""
    got = _CACHE.get(std_name, "miss")
    if got != "miss":
        return got
    if std_name not in _AFM_STEMS:
        _CACHE[std_name] = None
        return None
    _load_bundled()
    return _CACHE.get(std_name)


# WinAnsiEncoding code -> glyph name (PDF 32000-1 Annex D.2).  ASCII shares
# StandardEncoding's names except quotesingle (0x27) and grave (0x60).
def _winansi_table() -> Dict[int, str]:
    from .type1 import STANDARD_ENCODING

    t = {c: n for c, n in STANDARD_ENCODING.items() if 32 <= c <= 126}
    t[0x27] = "quotesingle"
    t[0x60] = "grave"
    t.update({
        0x80: "Euro", 0x82: "quotesinglbase", 0x83: "florin",
        0x84: "quotedblbase", 0x85: "ellipsis", 0x86: "dagger",
        0x87: "daggerdbl", 0x88: "circumflex", 0x89: "perthousand",
        0x8A: "Scaron", 0x8B: "guilsinglleft", 0x8C: "OE", 0x8E: "Zcaron",
        0x91: "quoteleft", 0x92: "quoteright", 0x93: "quotedblleft",
        0x94: "quotedblright", 0x95: "bullet", 0x96: "endash",
        0x97: "emdash", 0x98: "tilde", 0x99: "trademark", 0x9A: "scaron",
        0x9B: "guilsinglright", 0x9C: "oe", 0x9E: "zcaron",
        0x9F: "Ydieresis", 0xA0: "space", 0xA1: "exclamdown", 0xA2: "cent",
        0xA3: "sterling", 0xA4: "currency", 0xA5: "yen", 0xA6: "brokenbar",
        0xA7: "section", 0xA8: "dieresis", 0xA9: "copyright",
        0xAA: "ordfeminine", 0xAB: "guillemotleft", 0xAC: "logicalnot",
        0xAD: "hyphen", 0xAE: "registered", 0xAF: "macron", 0xB0: "degree",
        0xB1: "plusminus", 0xB2: "twosuperior", 0xB3: "threesuperior",
        0xB4: "acute", 0xB5: "mu", 0xB6: "paragraph",
        0xB7: "periodcentered", 0xB8: "cedilla", 0xB9: "onesuperior",
        0xBA: "ordmasculine", 0xBB: "guillemotright", 0xBC: "onequarter",
        0xBD: "onehalf", 0xBE: "threequarters", 0xBF: "questiondown",
    })
    high = (
        "Agrave Aacute Acircumflex Atilde Adieresis Aring AE Ccedilla "
        "Egrave Eacute Ecircumflex Edieresis Igrave Iacute Icircumflex "
        "Idieresis Eth Ntilde Ograve Oacute Ocircumflex Otilde Odieresis "
        "multiply Oslash Ugrave Uacute Ucircumflex Udieresis Yacute Thorn "
        "germandbls agrave aacute acircumflex atilde adieresis aring ae "
        "ccedilla egrave eacute ecircumflex edieresis igrave iacute "
        "icircumflex idieresis eth ntilde ograve oacute ocircumflex otilde "
        "odieresis divide oslash ugrave uacute ucircumflex udieresis "
        "yacute thorn ydieresis"
    ).split()
    for i, name in enumerate(high):
        t[0xC0 + i] = name
    return t


_WINANSI: Optional[Dict[int, str]] = None


def winansi_name(code: int) -> Optional[str]:
    global _WINANSI
    if _WINANSI is None:
        _WINANSI = _winansi_table()
    return _WINANSI.get(code)


def code_widths(base_font, encoding_name: Optional[str],
                differences: Dict[int, str]) -> Optional[Dict[int, float]]:
    """code -> text-space width (/1000 applied) for a non-embedded
    standard-14 font, or None when unknown.  ``encoding_name`` is the
    font's /Encoding base name (WinAnsiEncoding routes codes through the
    Annex D table; anything else uses the AFM's default encoding);
    /Differences names override either."""
    std = std14_name(base_font)
    if std is None:
        return None
    got = afm_widths(std)
    if got is None:
        return None
    by_code, by_name = got
    out: Dict[int, float] = {}
    win = encoding_name == "WinAnsiEncoding" and std not in ("Symbol", "ZapfDingbats")
    for code in range(256):
        nm = differences.get(code)
        if nm is None and win:
            nm = winansi_name(code)
        w = by_name.get(nm) if nm is not None else by_code.get(code)
        if w is not None:
            out[code] = w / 1000.0
    return out
