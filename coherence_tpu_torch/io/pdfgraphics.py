"""PDF content stream -> structured graphic (parity: vendored
``pdfgraphics.ml``: ``graphic_of_page`` and the ``process_op`` state
machine, plus the inverse ``page_of_graphic``).

Produces the reference's graphic-element tree (pdfgraphics.mli:132-141):
path elements with fill/stroke colour, winding rule, line caps/joins/width,
and transparency; ``Clip`` elements scoping everything up to the matching
``Q`` (pdfgraphics.ml:1124-1139 semantics); ``TextBlock`` elements capturing
BT..ET op runs with per-op text state (pdfgraphics.ml:1159-1183);
``Image``/``GraphicInlineImage`` elements with their placement transform and
alpha. As in the reference, the renderer's ``scene_of_graphic``
(render.ml:1524-1565) consumes only paths and recurses through
clips/marked-content; text and image elements are carried structurally.

The port's copy of ``coherence_tpu.io.pdfgraphics``, whole.
"""

from __future__ import annotations

import math
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import transform as ctr
from ..geometry import path as gpath
from .pdf import Name, Pdf, Ref, Stream, _Lexer, _NUM_RE, _Parser, _WS, mkpage

# Colour spaces (Pdfspace parity — only the device spaces + ICC alternate).
DEVICE_RGB = "DeviceRGB"
DEVICE_CMYK = "DeviceCMYK"
DEVICE_GRAY = "DeviceGray"


@dataclass
class Transparency:
    fill_transparency: float = 1.0
    line_transparency: float = 1.0


@dataclass
class PathAttributes:
    """pdfgraphics.mli path attribute record (subset)."""

    path_fill: Optional[Tuple[str, List[float]]] = None
    path_line: Optional[Tuple[str, List[float]]] = None
    path_linewidth: float = 1.0
    path_capstyle: int = 0
    path_joinstyle: int = 0
    path_mitrelimit: float = 10.0
    path_transparency: Transparency = field(default_factory=Transparency)
    # path_dash (pdfgraphics.mli:93): dash array + phase, ctm-scaled like
    # path_linewidth.  (()., 0.0) = solid.
    path_dash: Tuple[tuple, float] = ((), 0.0)
    # ExtGState /SMask live at paint time: (smask_dict, ctm_at_gs) or None
    # (BEYOND REFERENCE: the reference drops the gstate soft mask).
    path_softmask: object = None
    # ExtGState /BM blend mode in force at the paint op (BEYOND REFERENCE:
    # the reference's only compositing operator is Porter/Duff over).
    path_blend: str = "Normal"


@dataclass
class GPath:
    path: gpath.Path
    attributes: PathAttributes


@dataclass
class MCSection:
    name: str
    elements: list


@dataclass
class MCSectionProperties:
    """BDC..EMC with a properties operand (pdfgraphics.mli:138): keeps
    optional-content membership / MCIDs that plain MCSection would drop."""

    name: str
    properties: object
    elements: list


@dataclass
class Clip:
    path: gpath.Path
    elements: list


@dataclass
class TextAttributes:
    """text_attributes (pdfgraphics.mli:101-102): the render mode in force."""

    textmode: int = 0
    # BEYOND REFERENCE (the mli stops at textmode): nonstroke/stroke colour
    # and constant alpha in force at the op, so scene/pdftext can paint
    # glyph outlines with the right colour and transparency.
    fill: object = None  # (colourspace, components) or None
    stroke: object = None
    fill_alpha: float = 1.0
    stroke_alpha: float = 1.0
    blend: str = "Normal"  # ExtGState /BM at the show op


@dataclass
class TextBlock:
    """Text graphic element (pdfgraphics.mli:134): a BT..ET run captured as
    raw (state, op) pairs plus the CTM at capture time."""

    blocks: list  # [(TextAttributes, (opname, [operands...])), ...]
    transform: "Matrix" = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    # BEYOND REFERENCE: the resource dict in scope at BT, so scene/pdftext
    # can resolve /Font programs when painting the run.
    resources: object = None


@dataclass
class FormGroup:
    """A Form XObject with /Group /S /Transparency whose gstate carries a
    group-level constant alpha or blend mode (PDF 11.6.6) — BEYOND
    REFERENCE: the group's children composite to ONE sprite first, then
    alpha/blend apply once to the result (per-element application
    double-darkens self-overlapping groups, e.g. any Inkscape object with
    opacity < 100%)."""

    elements: list
    ca: float = 1.0  # group constant alpha (nonstroke ca at the Do op)
    blend: str = "Normal"  # group blend mode


@dataclass
class TextClip:
    """Text clipping (PDF 9.3.5, Tr modes 4-7) — BEYOND REFERENCE: after a
    BT..ET block with a clip render mode, subsequent paint until the next
    grestore is clipped by the union of the block's glyph outlines.  The
    glyphs themselves need fonts, so the outlines are derived at scene
    conversion (scene/pdftext.clip_path_of_block) from the wrapped block."""

    block: "TextBlock"  # the source block (also painted as a sibling)
    elements: list


@dataclass
class ImageAttributes:
    """image_attributes (pdfgraphics.mli:104-107)."""

    image_transform: "Matrix"
    image_transparency: float = 1.0
    image_softmask: object = None  # resolved /SMask value from ExtGState
    # BEYOND REFERENCE (mli stops at the three above): the nonstroke colour
    # current at the Do op, painted through stencil masks (/ImageMask).
    image_fill: object = None  # (colourspace, components) or None
    image_blend: str = "Normal"  # ExtGState /BM at the Do op


@dataclass
class Image:
    """Image XObject use (pdfgraphics.mli:139): placement + object number."""

    attributes: ImageAttributes
    objnum: int
    name: str = ""
    # BEYOND REFERENCE: the resolved Stream when the XObject resource was
    # embedded directly rather than by indirect reference (objnum -1).
    stream: object = None


@dataclass
class GraphicInlineImage:
    """BI..ID..EI inline image (pdfgraphics.mli:140)."""

    dict: dict
    data: bytes
    transform: "Matrix" = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    # BEYOND REFERENCE: nonstroke colour at BI time, for /ImageMask paint.
    fill: object = None  # (colourspace, components) or None
    blend: str = "Normal"  # ExtGState /BM at the BI op


@dataclass
class PdfFunction:
    """Pdffun parity (reference Pdffun.parse_function / Pdffun.eval_function,
    pdfgraphics.mli:37-49): all four function kinds — Type 0 (sampled),
    Type 2 (exponential interpolation), Type 3 (stitching), Type 4
    (PostScript calculator)."""

    kind: int
    domain: tuple
    c0: tuple = (0.0,)
    c1: tuple = (1.0,)
    n: float = 1.0
    functions: tuple = ()  # type 3 subfunctions
    bounds: tuple = ()
    encode: tuple = ()
    range: tuple = ()  # /Range pairs (lo0, hi0, lo1, hi1, ...), may be empty
    size: tuple = ()  # type 0: /Size (samples per input dimension)
    bps: int = 8  # type 0: /BitsPerSample
    decode: tuple = ()  # type 0: /Decode (defaults to /Range)
    samples: object = None  # type 0: numpy (prod(size), n_out) float array
    program: tuple = ()  # type 4: parsed calculator program
    raw: object = None  # unsupported kinds: the resolved dict


def _interp(x, x0, x1, y0, y1):
    return y0 if x1 == x0 else y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _eval_sampled(f: PdfFunction, ts):
    """Type 0 (PDF 7.10.2): encode inputs into sample-grid coordinates,
    multilinear-interpolate over the 2^m surrounding corners, decode."""
    m = len(f.size)
    nout = max(1, len(f.range) // 2)
    coords = []
    for i in range(m):
        x = ts[i] if i < len(ts) else 0.0
        d0, d1 = f.domain[2 * i], f.domain[2 * i + 1]
        x = min(max(x, d0), d1)
        if len(f.encode) >= 2 * i + 2:
            e0, e1 = f.encode[2 * i], f.encode[2 * i + 1]
        else:
            e0, e1 = 0.0, float(f.size[i] - 1)
        e = _interp(x, d0, d1, e0, e1)
        coords.append(min(max(e, 0.0), float(f.size[i] - 1)))
    # Strides: first input dimension varies fastest in the sample stream.
    strides = []
    acc = 1
    for i in range(m):
        strides.append(acc)
        acc *= f.size[i]
    out = [0.0] * nout
    for corner in range(1 << m):
        weight = 1.0
        base = 0
        for i in range(m):
            lo = int(math.floor(coords[i]))
            lo = min(lo, f.size[i] - 1)
            hi = min(lo + 1, f.size[i] - 1)
            frac = coords[i] - lo
            if corner >> i & 1:
                weight *= frac
                base += hi * strides[i]
            else:
                weight *= 1.0 - frac
                base += lo * strides[i]
        if weight == 0.0:
            continue
        for j in range(nout):
            out[j] += weight * f.samples[base * nout + j]
    maxv = float((1 << f.bps) - 1)
    dec = f.decode or f.range
    res = []
    for j in range(nout):
        if len(dec) >= 2 * j + 2:
            res.append(_interp(out[j], 0.0, maxv, dec[2 * j], dec[2 * j + 1]))
        else:
            res.append(out[j] / maxv)
    return res


# --- Type 4: PostScript calculator (PDF 7.10.5) ----------------------------


def _ps_tokenize(src: bytes):
    for tok in re.findall(rb"\{|\}|[^\s{}]+", src):
        yield tok


def parse_calculator(src: bytes) -> tuple:
    """Parse a Type-4 program into nested tuples of numbers/operator
    strings (procedure literals become nested tuples)."""
    toks = list(_ps_tokenize(src))
    pos = 0

    def block():
        nonlocal pos
        out = []
        while pos < len(toks):
            t = toks[pos]
            pos += 1
            if t == b"{":
                out.append(block())
            elif t == b"}":
                return tuple(out)
            elif _NUM_RE.match(t):
                out.append(float(t) if b"." in t else int(t))
            else:
                out.append(t.decode("latin1"))
        return tuple(out)

    # The whole program is wrapped in one outer { }.
    while pos < len(toks) and toks[pos] != b"{":
        pos += 1
    if pos < len(toks):
        pos += 1
        return block()
    return ()


def _ps_exec(prog: tuple, stack: list):
    """Execute a parsed calculator procedure against `stack` in place."""

    def popn(k):
        vals = stack[-k:]
        del stack[-k:]
        return vals

    for op in prog:
        if isinstance(op, (int, float, tuple)):
            stack.append(op)
            continue
        if op == "true":
            stack.append(True)
        elif op == "false":
            stack.append(False)
        elif op == "if":
            proc, = popn(1)
            cond, = popn(1)
            if cond:
                _ps_exec(proc, stack)
        elif op == "ifelse":
            p2, = popn(1)
            p1, = popn(1)
            cond, = popn(1)
            _ps_exec(p1 if cond else p2, stack)
        elif op in ("add", "sub", "mul", "div", "idiv", "mod", "exp", "atan",
                    "and", "or", "xor", "bitshift",
                    "eq", "ne", "gt", "ge", "lt", "le"):
            b = stack.pop()
            a = stack.pop()
            if op == "add":
                stack.append(a + b)
            elif op == "sub":
                stack.append(a - b)
            elif op == "mul":
                stack.append(a * b)
            elif op == "div":
                stack.append(a / b if b != 0 else 0.0)
            elif op == "idiv":
                # PostScript idiv truncates toward ZERO (-7 idiv 2 = -3);
                # Python // floors (-4).
                ia, ib = int(a), int(b)
                if not ib:
                    stack.append(0)
                elif (ia < 0) != (ib < 0):
                    stack.append(-(-ia // ib))
                else:
                    stack.append(ia // ib)
            elif op == "mod":
                stack.append(int(math.fmod(int(a), int(b))) if int(b) else 0)
            elif op == "exp":
                stack.append(float(a) ** float(b))
            elif op == "atan":
                ang = math.degrees(math.atan2(float(a), float(b)))
                stack.append(ang + 360.0 if ang < 0 else ang)
            elif op == "and":
                stack.append((a and b) if isinstance(a, bool) else int(a) & int(b))
            elif op == "or":
                stack.append((a or b) if isinstance(a, bool) else int(a) | int(b))
            elif op == "xor":
                stack.append((a != b) if isinstance(a, bool) else int(a) ^ int(b))
            elif op == "bitshift":
                s = int(b)
                stack.append(int(a) << s if s >= 0 else int(a) >> -s)
            elif op == "eq":
                stack.append(a == b)
            elif op == "ne":
                stack.append(a != b)
            elif op == "gt":
                stack.append(a > b)
            elif op == "ge":
                stack.append(a >= b)
            elif op == "lt":
                stack.append(a < b)
            elif op == "le":
                stack.append(a <= b)
        elif op == "neg":
            stack.append(-stack.pop())
        elif op == "abs":
            stack.append(abs(stack.pop()))
        elif op == "sqrt":
            stack.append(math.sqrt(max(0.0, float(stack.pop()))))
        elif op == "sin":
            stack.append(math.sin(math.radians(float(stack.pop()))))
        elif op == "cos":
            stack.append(math.cos(math.radians(float(stack.pop()))))
        elif op == "ln":
            v = float(stack.pop())
            stack.append(math.log(v) if v > 0 else 0.0)
        elif op == "log":
            v = float(stack.pop())
            stack.append(math.log10(v) if v > 0 else 0.0)
        elif op == "ceiling":
            stack.append(float(math.ceil(stack.pop())))
        elif op == "floor":
            stack.append(float(math.floor(stack.pop())))
        elif op == "round":
            v = stack.pop()
            stack.append(float(math.floor(v + 0.5)) if not isinstance(v, int) else v)
        elif op == "truncate":
            v = stack.pop()
            stack.append(float(math.trunc(v)) if not isinstance(v, int) else v)
        elif op == "cvi":
            stack.append(int(stack.pop()))
        elif op == "cvr":
            stack.append(float(stack.pop()))
        elif op == "not":
            v = stack.pop()
            stack.append((not v) if isinstance(v, bool) else ~int(v))
        elif op == "dup":
            stack.append(stack[-1])
        elif op == "pop":
            stack.pop()
        elif op == "exch":
            stack[-1], stack[-2] = stack[-2], stack[-1]
        elif op == "copy":
            k = int(stack.pop())
            if k > 0:
                stack.extend(stack[-k:])
        elif op == "index":
            k = int(stack.pop())
            stack.append(stack[-1 - k])
        elif op == "roll":
            j = int(stack.pop())
            k = int(stack.pop())
            if k > 0:
                j %= k
                if j:
                    part = stack[-k:]
                    del stack[-k:]
                    stack.extend(part[-j:] + part[:-j])
        else:
            raise ValueError(f"calculator: unknown operator {op!r}")


def eval_function(f: PdfFunction, t):
    """Evaluate at input(s) `t` — a scalar for 1-in functions or a sequence
    for multi-input (Type 0/4) ones — clamped to the domain.  All four
    kinds per the PDF spec (Pdffun.eval_function parity); outputs clamp to
    /Range when present.  A tuple of functions (the /Function-array form:
    n separate 1-out functions, one per colour component) evaluates each
    and concatenates the outputs."""
    if isinstance(f, tuple):
        out = []
        for sub in f:
            out.extend(eval_function(sub, t))
        return tuple(out)
    ts = [float(v) for v in t] if isinstance(t, (tuple, list)) else [float(t)]
    t = min(max(ts[0], f.domain[0]), f.domain[1])
    if f.kind == 2:
        # A fractional exponent of a negative base would go complex; the
        # spec restricts Type-2 domains to t >= 0 when N is non-integral.
        base = t if (t >= 0.0 or float(f.n).is_integer()) else 0.0
        out = [c0 + (base ** f.n) * (c1 - c0) for c0, c1 in zip(f.c0, f.c1)]
    elif f.kind == 3:
        d0, d1 = f.domain[0], f.domain[1]
        k = 0
        while k < len(f.bounds) and t >= f.bounds[k]:
            k += 1
        lo = d0 if k == 0 else f.bounds[k - 1]
        hi = d1 if k == len(f.bounds) else f.bounds[k]
        if len(f.encode) >= 2 * k + 2:
            e0, e1 = f.encode[2 * k], f.encode[2 * k + 1]
        else:  # missing/short /Encode defaults to [0 1] per subfunction
            e0, e1 = 0.0, 1.0
        tt = e0 if hi == lo else e0 + (t - lo) * (e1 - e0) / (hi - lo)
        out = eval_function(f.functions[k], tt)
    elif f.kind == 0 and f.samples is not None:
        out = _eval_sampled(f, ts)
    elif f.kind == 4 and f.program:
        stack: list = []
        for i in range(len(f.domain) // 2):
            x = ts[i] if i < len(ts) else 0.0
            stack.append(min(max(x, f.domain[2 * i]), f.domain[2 * i + 1]))
        _ps_exec(f.program, stack)
        nout = max(1, len(f.range) // 2)
        out = [float(v) for v in stack[-nout:]]
    else:
        out = list(f.c0)
    if f.range:
        out = [
            min(max(v, f.range[2 * i]), f.range[2 * i + 1])
            if len(f.range) >= 2 * i + 2
            else v
            for i, v in enumerate(out)
        ]
    return out


@dataclass
class FunctionShadingK:
    """function_shading (pdfgraphics.mli:36-39)."""

    domain: tuple  # (x0, x1, y0, y1)
    matrix: "Matrix"
    function: PdfFunction


@dataclass
class AxialShadingK:
    """axial_shading (pdfgraphics.mli:47-51)."""

    coords: tuple  # (x0, y0, x1, y1)
    domain: tuple  # (t0, t1)
    functions: tuple  # PdfFunction list
    extend: tuple  # (bool, bool)


@dataclass
class RadialShadingK:
    """radial_shading (pdfgraphics.mli:41-45)."""

    coords: tuple  # (x0, y0, r0, x1, y1, r1)
    domain: tuple
    functions: tuple
    extend: tuple


@dataclass
class MeshShadingK:
    """Mesh shadings (PDF shading types 4-7) reduced to Gouraud triangles.

    BEYOND REFERENCE: camlpdf parses these stream types but the reference
    drops every shading at render time.  Vertices are in the shading's
    target space; each triangle is (p0, p1, p2, c0, c1, c2) with colours as
    component tuples in the shading's colourspace (already mapped through
    /Function when present).  Coons/tensor patches (types 6/7) arrive
    pre-subdivided on a surface grid."""

    shading_type: int
    triangles: tuple


@dataclass
class Shading:
    """shading (pdfgraphics.mli:62-69)."""

    colourspace: object
    background: object
    bbox: object
    antialias: bool
    matrix: "Matrix"
    extgstate: object
    kind: object  # one of the *ShadingK dataclasses or a placeholder str
    # ("cs", kind, payload, n_in) for Indexed/Separation/DeviceN/Lab spaces
    # (deep-resolved at read time); None for device spaces.  The writer
    # round-trips `colourspace` raw and ignores this.
    cs_conv: object = None


@dataclass
class ShadingPattern:
    """pattern = ShadingPattern (pdfgraphics.mli:71-74)."""

    shading: Shading
    name: str = ""  # resource name, kept for round-trip


@dataclass
class TilingPattern:
    """Tiling pattern (PDF 8.7.3).  BEYOND REFERENCE: the reference only
    tags these (pdfgraphics.ml:598 ``read_tiling_pattern`` returns the stub
    constructor ``Tiling``); here the cell's content stream is parsed into
    graphic elements so the scene layer can rasterize one cell and paint it
    as a repeating texture fill (scene/pdfscene.fill_of_tiling_pattern)."""

    coloured: bool = True  # /PaintType 1; PaintType 2 tints with `colour`
    bbox: tuple = ()  # pattern-space /BBox (x0, y0, x1, y1)
    xstep: float = 0.0  # /XStep (0 -> bbox width)
    ystep: float = 0.0  # /YStep (0 -> bbox height)
    matrix: tuple = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)  # pattern -> page space
    elements: tuple = ()  # parsed cell graphic elements
    colour: object = None  # PaintType 2: (colourspace, comps) set at scn
    name: str = ""  # resource name, kept for round-trip


@dataclass
class GShading:
    """`sh` operator element (pdfgraphics.mli:158: Shading of path option *
    shading * matrix): paint the shading through the active clip."""

    clip: object  # Optional[gpath.Path]
    shading: Shading
    transform: "Matrix"
    name: str = ""  # resource name, kept for round-trip
    blend: str = "Normal"  # ExtGState /BM at the sh op


@dataclass
class Graphic:
    elements: list
    resources: dict = field(default_factory=dict)


Matrix = Tuple[float, float, float, float, float, float]
_ID: Matrix = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def _mat_mul(m: Matrix, n: Matrix) -> Matrix:
    a, b, c, d, e, f = m
    a2, b2, c2, d2, e2, f2 = n
    return (
        a2 * a + b2 * c,
        a2 * b + b2 * d,
        c2 * a + d2 * c,
        c2 * b + d2 * d,
        e2 * a + f2 * c + e,
        e2 * b + f2 * d + f,
    )


def _apply(m: Matrix, p):
    a, b, c, d, e, f = m
    x, y = p
    return (a * x + c * y + e, b * x + d * y + f)


def _mat_inv(m: Matrix):
    a, b, c, d, e, f = m
    det = a * d - b * c
    if abs(det) < 1e-12:
        return None
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return (ia, ib, ic, id_, -(e * ia + f * ic), -(e * ib + f * id_))


@dataclass
class _GState:
    ctm: Matrix = _ID
    fill: Optional[Tuple[str, List[float]]] = (DEVICE_GRAY, [0.0])
    stroke: Optional[Tuple[str, List[float]]] = (DEVICE_GRAY, [0.0])
    linewidth: float = 1.0
    cap: int = 0
    join: int = 0
    mitre: float = 10.0
    dash: Tuple[tuple, float] = ((), 0.0)  # d operator (user-space units)
    ca: float = 1.0  # fill alpha
    CA: float = 1.0  # stroke alpha
    textmode: int = 0  # Tr render mode (text_attributes)
    softmask: object = None  # ExtGState /SMask (None when /None)
    blend: str = "Normal"  # ExtGState /BM (BEYOND REFERENCE)


# Text-state/show operators captured into TextBlock runs
# (the Pdfops group at pdfgraphics.ml:1058-1075).
_TEXT_OPS = frozenset(
    ["Tc", "Tw", "Tz", "TL", "Tf", "Tr", "Ts", "Td", "TD", "Tm",
     "T*", "Tj", "TJ", "'", '"', "d0", "d1"]
)
# The graphics-state-resident subset: persists across BT..ET blocks.
_STICKY_TEXT_OPS = frozenset(["Tc", "Tw", "Tz", "TL", "Tf", "Ts", "Tr"])


def _inline_image_bytes(d: dict) -> Optional[int]:
    """Exact unfiltered inline-image data length, or None if unknown
    (filtered, or missing dimensions).  Row bytes are padded to whole bytes
    per the PDF imaging model."""
    if d.get("F") is not None or d.get("Filter") is not None:
        return None
    w = d.get("W", d.get("Width"))
    h = d.get("H", d.get("Height"))
    bpc = d.get("BPC", d.get("BitsPerComponent", 8))
    cs = d.get("CS", d.get("ColorSpace"))
    if d.get("IM", d.get("ImageMask")) is True:
        channels = 1
        bpc = 1
    elif isinstance(cs, Name):
        channels = {
            "G": 1, "DeviceGray": 1, "I": 1, "Indexed": 1, "CalGray": 1,
            "RGB": 3, "DeviceRGB": 3, "CalRGB": 3,
            "CMYK": 4, "DeviceCMYK": 4,
        }.get(cs.v)
    elif isinstance(cs, list):  # e.g. [/Indexed ...]
        channels = 1
    else:
        channels = None
    if not isinstance(w, int) or not isinstance(h, int) or channels is None:
        return None
    row = (w * channels * int(bpc) + 7) // 8
    return row * h


def _unpack_bits(data: bytes, bps: int, count: int):
    """First `count` big-endian `bps`-bit unsigned samples of `data`."""
    if bps == 8:
        return list(data[:count])
    if bps in (16, 24, 32):
        nb = bps // 8
        return [
            int.from_bytes(data[i * nb : (i + 1) * nb], "big")
            for i in range(min(count, len(data) // nb))
        ]
    out = []
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= bps:
            out.append((acc >> (nbits - bps)) & ((1 << bps) - 1))
            nbits -= bps
            if len(out) >= count:
                return out
    return out


def parse_function(pdf: Pdf, obj) -> PdfFunction:
    """Pdffun.parse_function parity: all four kinds (0 sampled, 2
    exponential, 3 stitching, 4 calculator)."""
    d = pdf.resolve(obj)
    dd = d.dict if isinstance(d, Stream) else d
    if not isinstance(dd, dict):
        return PdfFunction(0, (0.0, 1.0), raw=dd)
    ft = int(pdf.resolve(dd.get("FunctionType", 2)))
    dom = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Domain", [0, 1])))
    rng = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Range", [])))
    if ft == 2:
        c0 = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("C0", [0.0])))
        c1 = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("C1", [1.0])))
        n = float(pdf.resolve(dd.get("N", 1)))
        return PdfFunction(2, dom, c0, c1, n, range=rng)
    if ft == 3:
        fns = tuple(parse_function(pdf, f) for f in pdf.resolve(dd.get("Functions", [])))
        bounds = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Bounds", [])))
        enc = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Encode", [])))
        return PdfFunction(3, dom, functions=fns, bounds=bounds, encode=enc, range=rng)
    if ft == 0 and isinstance(d, Stream):
        size = tuple(
            int(pdf.resolve(v)) for v in pdf.resolve(dd.get("Size", []))
        )
        bps = int(pdf.resolve(dd.get("BitsPerSample", 8)))
        enc = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Encode", [])))
        dec = tuple(float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Decode", [])))
        if size and rng:
            total = max(1, len(rng) // 2)
            for s in size:
                total *= max(1, s)
            samples = _unpack_bits(d.decode(), bps, total)
            if len(samples) >= total:
                return PdfFunction(
                    0, dom, encode=enc, decode=dec, size=size, bps=bps,
                    samples=samples, range=rng, raw=dd,
                )
        return PdfFunction(0, dom, range=rng, raw=dd)
    if ft == 4 and isinstance(d, Stream):
        try:
            prog = parse_calculator(d.decode())
        except Exception:
            prog = ()
        return PdfFunction(4, dom, program=prog, range=rng, raw=dd)
    return PdfFunction(ft, dom, range=rng, raw=dd)


def _matrix_entry(pdf: Pdf, dd: dict, key: str = "Matrix") -> Matrix:
    m = pdf.resolve(dd.get(key)) if isinstance(dd, dict) else None
    if isinstance(m, list) and len(m) == 6:
        return tuple(float(pdf.resolve(v)) for v in m)
    return _ID


class _BitReader:
    """MSB-first bit stream over mesh shading data (PDF 8.7.4.5.5)."""

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit offset

    def eof(self, nbits: int = 1) -> bool:
        return self.pos + nbits > len(self.d) * 8

    def read(self, n: int) -> int:
        if self.eof(n):
            raise EOFError
        v = 0
        p = self.pos
        left = n
        while left:
            byte = self.d[p >> 3]
            avail = 8 - (p & 7)
            take = min(avail, left)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            p += take
            left -= take
        self.pos = p
        return v


def _bezier1(c0, c1, c2, c3, t):
    s = 1.0 - t
    return (
        s * s * s * c0 + 3 * s * s * t * c1 + 3 * s * t * t * c2 + t * t * t * c3
    )


def _surf_point(P, u, v):
    """Bicubic tensor point: rows indexed by u, columns by v."""
    row = [
        _bezier1(P[i][0][k], P[i][1][k], P[i][2][k], P[i][3][k], v)
        for i in range(4)
        for k in (0, 1)
    ]
    # row = [x0,y0,x1,y1,x2,y2,x3,y3] along u
    return (
        _bezier1(row[0], row[2], row[4], row[6], u),
        _bezier1(row[1], row[3], row[5], row[7], u),
    )


def _coons_internal(P):
    """Fill P[1][1], P[1][2], P[2][1], P[2][2] from the boundary (PDF
    8.7.4.5.7 Coons-to-tensor formulas)."""

    def pt(f):
        return (f(0), f(1))

    def mix(coef):
        def f(k):
            return sum(c * P[i][j][k] for c, i, j in coef) / 9.0

        return pt(f)

    P[1][1] = mix([(-4, 0, 0), (6, 0, 1), (6, 1, 0), (-2, 0, 3), (-2, 3, 0),
                   (3, 3, 1), (3, 1, 3), (-1, 3, 3)])
    P[1][2] = mix([(-4, 0, 3), (6, 0, 2), (6, 1, 3), (-2, 0, 0), (-2, 3, 3),
                   (3, 1, 0), (3, 3, 2), (-1, 3, 0)])
    P[2][1] = mix([(-4, 3, 0), (6, 3, 1), (6, 2, 0), (-2, 3, 3), (-2, 0, 0),
                   (3, 0, 1), (3, 2, 3), (-1, 0, 3)])
    P[2][2] = mix([(-4, 3, 3), (6, 3, 2), (6, 2, 3), (-2, 3, 0), (-2, 0, 3),
                   (3, 2, 0), (3, 0, 2), (-1, 0, 0)])


_PATCH_GRID = 6  # (n+1)^2 surface samples per Coons/tensor patch


def _patch_triangles(P, c00, c03, c33, c30, out):
    """Subdivide a tensor patch into Gouraud triangles with bilinear
    corner-colour interpolation (colour c_uv at grid corners: c00 at
    (u=0,v=0)=P[0][0], c03 at P[0][3], c33 at P[3][3], c30 at P[3][0])."""
    n = _PATCH_GRID
    c00 = tuple(c00)
    c03 = tuple(c03)
    c33 = tuple(c33)
    c30 = tuple(c30)
    nc = len(c00)

    def col(u, v):
        return tuple(
            (1 - u) * (1 - v) * c00[k]
            + (1 - u) * v * c03[k]
            + u * v * c33[k]
            + u * (1 - v) * c30[k]
            for k in range(nc)
        )

    grid = [
        [(_surf_point(P, i / n, j / n), col(i / n, j / n)) for j in range(n + 1)]
        for i in range(n + 1)
    ]
    for i in range(n):
        for j in range(n):
            (pa, ca), (pb, cb) = grid[i][j], grid[i][j + 1]
            (pc, cc), (pd, cd) = grid[i + 1][j + 1], grid[i + 1][j]
            out.append((pa, pb, pc, ca, cb, cc))
            out.append((pa, pc, pd, ca, cc, cd))


def _parse_mesh(pdf: Pdf, d: "Stream", dd: dict, st: int):
    """Shading types 4-7 -> MeshShadingK (Gouraud triangles), or a
    placeholder string when the stream is unreadable."""
    try:
        data = d.decode()
        bpc = int(pdf.resolve(dd.get("BitsPerCoordinate")))
        bpcomp = int(pdf.resolve(dd.get("BitsPerComponent")))
        decode = [float(pdf.resolve(v)) for v in pdf.resolve(dd.get("Decode"))]
        fn = pdf.resolve(dd.get("Function"))
        funcs = None
        if fn is not None:
            fns = fn if isinstance(fn, list) else [fn]
            funcs = tuple(parse_function(pdf, x) for x in fns)
        ncomp = (len(decode) - 4) // 2

        def map_colour(comps):
            if funcs is None:
                return tuple(comps)
            t = comps[0]
            out = []
            for f in funcs:
                v = eval_function(f, t)
                out.extend(v if isinstance(v, (list, tuple)) else [v])
            return tuple(out)

        br = _BitReader(data)

        def dec(raw, bits, lo, hi):
            return lo + raw * (hi - lo) / float((1 << bits) - 1)

        def vertex():
            x = dec(br.read(bpc), bpc, decode[0], decode[1])
            y = dec(br.read(bpc), bpc, decode[2], decode[3])
            comps = [
                dec(br.read(bpcomp), bpcomp, decode[4 + 2 * k], decode[5 + 2 * k])
                for k in range(ncomp)
            ]
            return (x, y), map_colour(comps)

        tris: list = []
        if st == 4:
            bpf = int(pdf.resolve(dd.get("BitsPerFlag", 8)))
            va = vb = vc = None
            while not br.eof(bpf + 2 * bpc + ncomp * bpcomp):
                f = br.read(bpf)
                v = vertex()
                if f == 0:
                    if br.eof(2 * (bpf + 2 * bpc + ncomp * bpcomp)):
                        break
                    br.read(bpf)
                    v2 = vertex()
                    br.read(bpf)
                    v3 = vertex()
                    va, vb, vc = v, v2, v3
                elif f == 1 and vc is not None:
                    va, vb, vc = vb, vc, v
                elif f == 2 and vc is not None:
                    va, vb, vc = va, vc, v
                else:
                    continue
                tris.append((va[0], vb[0], vc[0], va[1], vb[1], vc[1]))
        elif st == 5:
            k = int(pdf.resolve(dd.get("VerticesPerRow", 2)))
            rows = []
            per_vertex = 2 * bpc + ncomp * bpcomp
            while not br.eof(k * per_vertex):
                rows.append([vertex() for _ in range(k)])
            for r0, r1 in zip(rows, rows[1:]):
                for i in range(k - 1):
                    (pa, ca), (pb, cb) = r0[i], r0[i + 1]
                    (pc, cc), (pd, cd) = r1[i], r1[i + 1]
                    tris.append((pa, pb, pc, ca, cb, cc))
                    tris.append((pb, pd, pc, cb, cd, cc))
        elif st in (6, 7):
            bpf = int(pdf.resolve(dd.get("BitsPerFlag", 8)))
            npts_new = 12 if st == 6 else 16
            npts_shared = npts_new - 4
            prev_pts = prev_cols = None

            def point():
                x = dec(br.read(bpc), bpc, decode[0], decode[1])
                y = dec(br.read(bpc), bpc, decode[2], decode[3])
                return (x, y)

            def colour():
                return map_colour(
                    [
                        dec(
                            br.read(bpcomp), bpcomp,
                            decode[4 + 2 * k], decode[5 + 2 * k],
                        )
                        for k in range(ncomp)
                    ]
                )

            while not br.eof(bpf + 2 * bpc):
                f = br.read(bpf)
                if f == 0:
                    pts = [point() for _ in range(npts_new)]
                    cols = [colour() for _ in range(4)]
                else:
                    if prev_pts is None:
                        break
                    # Shared edge (PDF Table 85): new p1-p4 + c1,c2 reuse
                    # the previous patch's edge by flag.
                    src = {
                        1: (prev_pts[3:7], prev_cols[1:3]),
                        2: (prev_pts[6:10], prev_cols[2:4]),
                        3: (prev_pts[9:12] + [prev_pts[0]],
                            [prev_cols[3], prev_cols[0]]),
                    }.get(f)
                    if src is None:
                        break
                    pts = list(src[0]) + [point() for _ in range(npts_shared)]
                    cols = list(src[1]) + [colour(), colour()]
                prev_pts, prev_cols = pts, cols
                # Boundary points onto the 4x4 tensor grid.
                P = [[None] * 4 for _ in range(4)]
                (P[0][0], P[0][1], P[0][2], P[0][3]) = pts[0:4]
                (P[1][3], P[2][3], P[3][3]) = pts[4:7]
                (P[3][2], P[3][1], P[3][0]) = pts[7:10]
                (P[2][0], P[1][0]) = pts[10:12]
                if st == 7:
                    (P[1][1], P[1][2], P[2][2], P[2][1]) = pts[12:16]
                else:
                    _coons_internal(P)
                _patch_triangles(P, cols[0], cols[1], cols[2], cols[3], tris)
        if not tris:
            return f"ShadingType{st}"
        return MeshShadingK(st, tuple(tris))
    except Exception:
        return f"ShadingType{st}"


def cs_converter(pdf, cs):
    """("cs", kind, payload, n_in) for colourspaces whose components need
    non-trivial mapping to RGB (Indexed/Separation/DeviceN/Lab), else None.
    Deep-resolves refs, so the result is usable detached from the Pdf."""
    cs = pdf.resolve(cs) if pdf is not None else cs
    if isinstance(cs, list) and cs:
        head = pdf.resolve(cs[0]) if pdf is not None else cs[0]
        if isinstance(head, Name) and head.v in ("Indexed", "I", "Separation", "DeviceN", "Lab"):
            from . import pdfimages as PI

            try:
                return ("cs",) + tuple(PI._cs_struct(pdf, cs))
            except Exception:
                return None
    return None


def rgb_of_converted(conv, comps):
    """(r, g, b) floats in [0,1] from a cs_converter result + components."""
    import numpy as np

    from . import pdfimages as PI

    _, kind, payload, n_in = conv
    vals = (list(comps) + [0.0] * n_in)[:n_in]
    rgb = PI._rgb_of_components(
        None, kind, payload, np.asarray(vals, dtype=np.float64).reshape(1, 1, -1)
    )[0, 0]
    return tuple(float(min(max(v, 0.0), 1.0)) for v in rgb)


def read_shading(pdf: Pdf, matrix: Matrix, extgstate, sh) -> Shading:
    """read_shading (pdfgraphics.ml:668-700)."""
    d = pdf.resolve(sh)
    dd = d.dict if isinstance(d, Stream) else d
    cs = pdf.resolve(dd.get("ColorSpace"))
    bg = pdf.resolve(dd.get("Background"))
    bbox = pdf.resolve(dd.get("BBox"))
    aa = pdf.resolve(dd.get("AntiAlias", False)) is True
    st = int(pdf.resolve(dd.get("ShadingType", 0)))

    def funcs():
        f = pdf.resolve(dd.get("Function"))
        if isinstance(f, list):
            return tuple(parse_function(pdf, x) for x in f)
        return (parse_function(pdf, f),)

    def floats(key, n, default=None):
        v = pdf.resolve(dd.get(key))
        if isinstance(v, list) and len(v) == n:
            return tuple(float(pdf.resolve(x)) for x in v)
        if default is None:
            raise ValueError(f"read_shading: missing /{key}")
        return default

    def extend():
        v = pdf.resolve(dd.get("Extend"))
        if isinstance(v, list) and len(v) == 2:
            return (pdf.resolve(v[0]) is True, pdf.resolve(v[1]) is True)
        return (False, False)

    if st == 1:
        fn1 = pdf.resolve(dd.get("Function"))
        if isinstance(fn1, list):
            # /Function array: n 1-out functions, one per component.
            parsed1 = (tuple(parse_function(pdf, x) for x in fn1)
                       if fn1 else None)
            if parsed1 is not None and len(parsed1) == 1:
                parsed1 = parsed1[0]
        else:
            parsed1 = parse_function(pdf, fn1) if fn1 is not None else None
        kind = FunctionShadingK(
            floats("Domain", 4, (0.0, 1.0, 0.0, 1.0)),
            _matrix_entry(pdf, dd),
            parsed1,
        )
    elif st == 2:
        kind = AxialShadingK(
            floats("Coords", 4), floats("Domain", 2, (0.0, 1.0)), funcs(), extend()
        )
    elif st == 3:
        kind = RadialShadingK(
            floats("Coords", 6), floats("Domain", 2, (0.0, 1.0)), funcs(), extend()
        )
    elif st in (4, 5, 6, 7) and isinstance(d, Stream):
        kind = _parse_mesh(pdf, d, dd, st)
    else:
        kind = f"ShadingType{st}"
    return Shading(cs, bg, bbox, aa, matrix, extgstate, kind, cs_converter(pdf, cs))


def read_pattern(pdf: Pdf, obj):
    """read_shading_pattern / read_tiling_pattern (pdfgraphics.ml:598,700+)."""
    d = pdf.resolve(obj)
    dd = d.dict if isinstance(d, Stream) else d
    if not isinstance(dd, dict):
        return None
    pt = int(pdf.resolve(dd.get("PatternType", 1)))
    if pt == 2:
        mtx = _matrix_entry(pdf, dd)
        egs = pdf.resolve(dd.get("ExtGState")) or {}
        return ShadingPattern(read_shading(pdf, mtx, egs, dd.get("Shading")))
    paint = int(pdf.resolve(dd.get("PaintType", 1)))
    tp = TilingPattern(coloured=paint == 1)
    try:
        bb = pdf.resolve(dd.get("BBox"))
        if isinstance(bb, list) and len(bb) == 4:
            tp.bbox = tuple(float(pdf.resolve(v)) for v in bb)
        xs = pdf.resolve(dd.get("XStep"))
        ys = pdf.resolve(dd.get("YStep"))
        if isinstance(xs, (int, float)):
            tp.xstep = float(xs)
        if isinstance(ys, (int, float)):
            tp.ystep = float(ys)
        tp.matrix = _matrix_entry(pdf, dd)
        res = pdf.resolve(dd.get("Resources")) or {}
        content = d.decode() if isinstance(d, Stream) else b""
        if content:
            tp.elements = tuple(_process(pdf, content, res, _GState()))
    except Exception:
        pass  # malformed cell: paint falls back to the gray stub
    return tp


def _tokenize(content: bytes):
    """Content stream token/operand stream."""
    lex = _Lexer(content)
    while True:
        save = lex.p
        tok = lex.next_token()
        if not tok:
            return
        yield tok, save


def _hidden_ocgs(pdf: Pdf) -> frozenset:
    """Object numbers of optional-content groups OFF in the document's
    default configuration (/OCProperties /D, PDF 8.11.4.3): BaseState
    applies to every group, then /ON turns groups on, then /OFF off.
    BEYOND REFERENCE: camlpdf exposes no optional-content logic."""
    cached = getattr(pdf, "_ocg_hidden_cache", None)
    if cached is not None:
        return cached
    hidden: set = set()
    try:
        root = pdf.resolve(pdf.trailer.get("Root")) or {}
        ocp = pdf.resolve(root.get("OCProperties"))
        if isinstance(ocp, dict):
            d = pdf.resolve(ocp.get("D")) or {}

            def nums(arr):
                return {r.num for r in (pdf.resolve(arr) or []) if isinstance(r, Ref)}

            base = pdf.resolve(d.get("BaseState"))
            if isinstance(base, Name) and base.v == "OFF":
                hidden = nums(ocp.get("OCGs"))
            hidden -= nums(d.get("ON"))
            hidden |= nums(d.get("OFF"))
    except Exception:
        hidden = set()
    pdf._ocg_hidden_cache = frozenset(hidden)
    return pdf._ocg_hidden_cache


def oc_visible(pdf: Pdf, raw) -> bool:
    """Visibility of content gated by an /OC entry or BDC /OC properties:
    ``raw`` is the UNRESOLVED value (group membership is by indirect
    reference).  Handles plain OCGs and OCMDs with /P AnyOn/AllOn/AnyOff/
    AllOff (PDF 8.11.2.2); /VE visibility expressions are ignored."""
    if pdf is None:
        return True
    hidden = _hidden_ocgs(pdf)
    if not hidden:
        return True

    def off(r):
        return isinstance(r, Ref) and r.num in hidden

    try:
        d = pdf.resolve(raw)
        if isinstance(d, dict) and getattr(pdf.resolve(d.get("Type")), "v", None) == "OCMD":
            ocgs = d.get("OCGs")
            refs = ocgs if isinstance(ocgs, list) else ([ocgs] if ocgs is not None else [])
            refs = [r for r in refs if isinstance(r, Ref)]
            if not refs:
                return True
            p = pdf.resolve(d.get("P"))
            pv = p.v if isinstance(p, Name) else "AnyOn"
            on = [not off(r) for r in refs]
            return {
                "AnyOn": any(on),
                "AllOn": all(on),
                "AnyOff": not all(on),
                "AllOff": not any(on),
            }.get(pv, True)
        return not off(raw)
    except Exception:
        return True


def graphic_of_page(pdf: Pdf, page: dict) -> Graphic:
    """Interpret a page's content streams (pdfgraphics.ml:1229), then any
    annotation appearance streams (BEYOND REFERENCE: PDF 12.5.5 — stamps,
    markup and form-field widgets paint; the reference reads content
    streams only)."""
    content = pdf.page_content(page)
    resources = pdf.resolve(page.get("Resources")) or {}
    elements = _process(pdf, content, resources, _GState())
    elements.extend(_annotation_elements(pdf, page, resources))
    return Graphic(elements, resources)


def _annotation_elements(pdf: Pdf, page: dict, page_res: dict) -> list:
    """Elements from each visible annotation's /AP /N appearance stream,
    mapped BBox-through-Matrix onto /Rect (PDF 12.5.5 algorithm 8.1)."""
    out: list = []
    annots = pdf.resolve(page.get("Annots"))
    if not isinstance(annots, list):
        return out
    for a in annots:
        try:
            a = pdf.resolve(a)
            if not isinstance(a, dict):
                continue
            sub = pdf.resolve(a.get("Subtype"))
            if isinstance(sub, Name) and sub.v in ("Popup", "Link"):
                continue
            flags = int(pdf.resolve(a.get("F", 0)) or 0)
            if flags & 2 or flags & 32:  # Hidden / NoView
                continue
            if "OC" in a and not oc_visible(pdf, a["OC"]):
                continue  # optional content OFF (PDF 8.11.2.3)
            ap = pdf.resolve(a.get("AP"))
            n = pdf.resolve(ap.get("N")) if isinstance(ap, dict) else None
            if isinstance(n, dict):  # appearance states: select by /AS
                state = pdf.resolve(a.get("AS"))
                key = state.v if isinstance(state, Name) else None
                n = pdf.resolve(n.get(key)) if key in n else (
                    pdf.resolve(next(iter(n.values()))) if n else None
                )
            if not isinstance(n, Stream):
                continue
            rect = [float(pdf.resolve(v)) for v in pdf.resolve(a.get("Rect"))]
            rx0, rx1 = sorted((rect[0], rect[2]))
            ry0, ry1 = sorted((rect[1], rect[3]))
            bbox = pdf.resolve(n.dict.get("BBox")) or [0, 0, 1, 1]
            bbox = [float(pdf.resolve(v)) for v in bbox]
            mtx = _matrix_entry(pdf, n.dict)
            # Transformed-bbox corners -> bounds; A maps them onto Rect.
            corners = [
                _apply(mtx, (x, y))
                for x, y in (
                    (bbox[0], bbox[1]), (bbox[2], bbox[1]),
                    (bbox[2], bbox[3]), (bbox[0], bbox[3]),
                )
            ]
            tx0 = min(p[0] for p in corners)
            tx1 = max(p[0] for p in corners)
            ty0 = min(p[1] for p in corners)
            ty1 = max(p[1] for p in corners)
            sx = (rx1 - rx0) / (tx1 - tx0) if tx1 > tx0 else 1.0
            sy = (ry1 - ry0) / (ty1 - ty0) if ty1 > ty0 else 1.0
            A = (sx, 0.0, 0.0, sy, rx0 - tx0 * sx, ry0 - ty0 * sy)
            gs = _GState(ctm=_mat_mul(A, mtx))
            res = pdf.resolve(n.dict.get("Resources")) or page_res
            out.extend(_process(pdf, n.decode(), res, gs))
        except Exception:
            continue  # malformed annotation: skip, keep the rest
    return out


def _scale_of(m: Matrix) -> float:
    a, b, c, d, _, _ = m
    det = abs(a * d - b * c)
    return math.sqrt(det)


def _process(pdf: Pdf, content: bytes, resources: dict, gs: _GState) -> list:
    elements: List[object] = []
    # Clip scoping: elements append to the innermost open Clip's list; a Clip
    # opened at q-depth L closes at the Q that would drop the depth below L
    # (pdfgraphics.ml:1124-1139 getuntil_matching_Q semantics).
    sinks: List[list] = [elements]
    sink_levels: List[int] = [-1]
    qlevel = 0
    # Clip path captured by W/W*; per PDF 8.5.4 it is consumed by the NEXT
    # path-painting operator, whichever it is (a Clip element is created
    # only for n, matching the reference's Op_n-only wrapping), and it is
    # NOT part of the q/Q-saved state (path construction cannot straddle
    # q/Q), so it must not be resurrected by Q.
    pending_clip: Optional[gpath.Path] = None
    in_text = False
    text_ops: List[object] = []
    # Sticky text-state parameters (PDF 9.3.1): legal outside BT..ET and
    # persistent across blocks; replayed at each BT (latest setting wins).
    text_state: Dict[str, list] = {}
    text_tf: Matrix = _ID
    stack: List[object] = []  # operand stack
    gstack: List[_GState] = []
    subpaths: List[list] = []  # list of segment lists (float, post-CTM)
    current: List[object] = []
    start: Optional[Tuple[float, float]] = None
    cur: Optional[Tuple[float, float]] = None

    import copy

    def num(v):
        return float(v)

    def moveto(p):
        nonlocal start, cur, current
        if current:
            subpaths.append(current)
        current = []
        start = cur2 = _apply(gs.ctm, p)
        cur = cur2

    def lineto(p):
        nonlocal cur
        q = _apply(gs.ctm, p)
        if cur is not None:
            current.append(gpath.Straight(cur, q))
        cur = q

    def curveto(p1, p2, p3):
        nonlocal cur
        q1, q2, q3 = _apply(gs.ctm, p1), _apply(gs.ctm, p2), _apply(gs.ctm, p3)
        current.append(gpath.Bezier(cur, q1, q2, q3))
        cur = q3

    def closepath():
        nonlocal cur
        if cur is not None and start is not None and cur != start:
            current.append(gpath.Straight(cur, start))
        cur = start

    def finish_path(winding) -> Optional[gpath.Path]:
        nonlocal subpaths, current, start, cur
        if current:
            subpaths.append(current)
        sps = [
            gpath.Subpath(False, True, tuple(s)) for s in subpaths if s
        ]
        subpaths, current, start, cur = [], [], None, None
        if not sps:
            return None
        return gpath.Path(winding, tuple(sps))

    def snapshot_path(winding) -> Optional[gpath.Path]:
        """The current (unfinished) path, for W/W* clip capture — the
        reference moves the partial path into state.clip (pdfgraphics.ml:742)
        while leaving it to be painted/discarded by the following op."""
        sps = [s for s in subpaths if s]
        if current:
            sps = sps + [current]
        built = [gpath.Subpath(False, True, tuple(list(s))) for s in sps]
        if not built:
            return None
        return gpath.Path(winding, tuple(built))

    def emit(path_fill, path_line, winding):
        nonlocal pending_clip
        pending_clip = None  # any painting operator consumes the candidate
        p = finish_path(winding)
        if p is None:
            return
        if path_fill or path_line:
            attrs = PathAttributes(
                path_fill=gs.fill if path_fill else None,
                path_line=gs.stroke if path_line else None,
                path_linewidth=gs.linewidth * _scale_of(gs.ctm),
                path_capstyle=gs.cap,
                path_joinstyle=gs.join,
                path_mitrelimit=gs.mitre,
                path_transparency=Transparency(gs.ca, gs.CA),
                path_dash=(
                    tuple(v * _scale_of(gs.ctm) for v in gs.dash[0]),
                    gs.dash[1] * _scale_of(gs.ctm),
                ),
                path_softmask=gs.softmask,
                path_blend=gs.blend,
            )
            sinks[-1].append(GPath(p, attrs))

    def resolve_cs(name_or_obj, resources):
        """Device space name, "Pattern", or a ("cs", kind, payload, n_in)
        converter (Indexed/Separation/DeviceN/Lab) whose sc/scn operands
        need mapping to RGB before they enter the graphic tree.  The
        reference routes these through camlpdf's Pdfspace; here the
        conversion shares pdfimages' colourspace machinery."""
        obj = name_or_obj
        if isinstance(obj, Name):
            n = obj.v
            if n in (DEVICE_RGB, DEVICE_CMYK, DEVICE_GRAY, "Pattern"):
                return n
            if n == "CalRGB":
                return DEVICE_RGB
            if n == "CalGray":
                return DEVICE_GRAY
            csd = pdf.resolve(resources.get("ColorSpace", {})) if resources else {}
            obj = pdf.resolve(csd.get(n)) if isinstance(csd, dict) else None
            if isinstance(obj, Name):
                nn = obj.v
                return nn if nn in (DEVICE_RGB, DEVICE_CMYK, DEVICE_GRAY, "Pattern") else DEVICE_RGB
        if isinstance(obj, list) and obj and isinstance(pdf.resolve(obj[0]), Name):
            head = pdf.resolve(obj[0]).v
            if head == "ICCBased" and len(obj) > 1:
                icc = pdf.resolve(obj[1])
                n_comp = pdf.resolve(icc.dict.get("N", 3)) if isinstance(icc, Stream) else 3
                return {1: DEVICE_GRAY, 3: DEVICE_RGB, 4: DEVICE_CMYK}.get(n_comp, DEVICE_RGB)
            if head in (DEVICE_RGB, DEVICE_CMYK, DEVICE_GRAY):
                return head
            if head == "CalRGB":
                return DEVICE_RGB
            if head == "CalGray":
                return DEVICE_GRAY
            if head == "Pattern":
                # [/Pattern /DeviceX]: the underlying space carries the
                # components of uncoloured-pattern scn operands.
                return resolve_cs(pdf.resolve(obj[1]), resources) if len(obj) > 1 else "Pattern"
            if head in ("Indexed", "I", "Separation", "DeviceN", "Lab"):
                from . import pdfimages as PI

                try:
                    kind, payload, n_in = PI._cs_struct(pdf, obj)
                except Exception:
                    return DEVICE_RGB
                return ("cs", kind, payload, n_in)
        return DEVICE_RGB

    def device_colour(cs, vals):
        """Collapse a (colourspace, components) pair to a device space,
        converting through a resolve_cs converter when present."""
        if not (isinstance(cs, tuple) and cs and cs[0] == "cs"):
            return (cs, vals)
        import numpy as np

        from . import pdfimages as PI

        _, kind, payload, n_in = cs
        comps = (list(vals) + [0.0] * n_in)[:n_in]
        rgb = PI._rgb_of_components(
            pdf, kind, payload, np.asarray(comps, dtype=np.float64).reshape(1, 1, -1)
        )[0, 0]
        return (DEVICE_RGB, [float(min(max(v, 0.0), 1.0)) for v in rgb])

    fill_cs = DEVICE_GRAY
    stroke_cs = DEVICE_GRAY

    lex = _Lexer(content)
    while True:
        tok = lex.next_token()
        if not tok:
            break
        if tok in (b"<<",):
            lex.p -= 2
            p = _Parser(b"", 0)
            p.lex = lex
            stack.append(p._obj(lex.next_token()))
            continue
        if tok == b"[":
            p = _Parser(b"", 0)
            p.lex = lex
            stack.append(p._obj(tok))
            continue
        if tok.startswith(b"/"):
            stack.append(Name(tok[1:].decode("latin1")))
            continue
        if tok.startswith(b"(") or (tok.startswith(b"<") and not tok == b"<<"):
            p = _Parser(b"", 0)
            p.lex = lex
            stack.append(p._obj(tok))
            continue
        if _NUM_RE.match(tok):
            stack.append(float(tok) if b"." in tok else int(tok))
            continue
        op = tok.decode("latin1", "replace")
        try:
            if op == "q":
                gstack.append(copy.deepcopy(gs))
                qlevel += 1
            elif op == "Q":
                # Close any clips opened at this depth before restoring.
                while (
                    len(sinks) > 1
                    and sink_levels[-1] is not None
                    and sink_levels[-1] >= qlevel
                ):
                    sinks.pop()
                    sink_levels.pop()
                if gstack:
                    gs = gstack.pop()
                qlevel = max(0, qlevel - 1)
            elif op == "cm":
                f2, e2, d2, c2, b2, a2 = (num(stack.pop()) for _ in range(6))
                gs.ctm = _mat_mul(gs.ctm, (a2, b2, c2, d2, e2, f2))
            elif op == "m":
                y, x = num(stack.pop()), num(stack.pop())
                moveto((x, y))
            elif op == "l":
                y, x = num(stack.pop()), num(stack.pop())
                lineto((x, y))
            elif op == "c":
                y3, x3, y2, x2, y1, x1 = (num(stack.pop()) for _ in range(6))
                curveto((x1, y1), (x2, y2), (x3, y3))
            elif op == "v":
                y3, x3, y2, x2 = (num(stack.pop()) for _ in range(4))
                q2, q3 = _apply(gs.ctm, (x2, y2)), _apply(gs.ctm, (x3, y3))
                current.append(gpath.Bezier(cur, cur, q2, q3))
                cur = q3
            elif op == "y":
                y3, x3, y1, x1 = (num(stack.pop()) for _ in range(4))
                curveto((x1, y1), (x3, y3), (x3, y3))
            elif op == "h":
                closepath()
            elif op == "re":
                hh, ww, y, x = (num(stack.pop()) for _ in range(4))
                moveto((x, y))
                lineto((x + ww, y))
                lineto((x + ww, y + hh))
                lineto((x, y + hh))
                closepath()
            elif op in ("f", "F"):
                emit(True, False, gpath.NONZERO)
            elif op == "f*":
                emit(True, False, gpath.EVEN_ODD)
            elif op == "B":
                emit(True, True, gpath.NONZERO)
            elif op == "B*":
                emit(True, True, gpath.EVEN_ODD)
            elif op == "b":
                closepath()
                emit(True, True, gpath.NONZERO)
            elif op == "b*":
                closepath()
                emit(True, True, gpath.EVEN_ODD)
            elif op == "S":
                emit(False, True, gpath.NONZERO)
            elif op == "s":
                closepath()
                emit(False, True, gpath.NONZERO)
            elif op == "n":
                if pending_clip is not None:
                    finish_path(gpath.NONZERO)  # discard the painted path
                    c = Clip(pending_clip, [])
                    sinks[-1].append(c)
                    sinks.append(c.elements)
                    sink_levels.append(qlevel)
                    pending_clip = None
                else:
                    emit(False, False, gpath.NONZERO)
            elif op == "W":
                pending_clip = snapshot_path(gpath.NONZERO)
            elif op == "W*":
                pending_clip = snapshot_path(gpath.EVEN_ODD)
            elif op == "g":
                gs.fill = (DEVICE_GRAY, [num(stack.pop())])
            elif op == "G":
                gs.stroke = (DEVICE_GRAY, [num(stack.pop())])
            elif op == "rg":
                b_, g_, r_ = (num(stack.pop()) for _ in range(3))
                gs.fill = (DEVICE_RGB, [r_, g_, b_])
            elif op == "RG":
                b_, g_, r_ = (num(stack.pop()) for _ in range(3))
                gs.stroke = (DEVICE_RGB, [r_, g_, b_])
            elif op == "k":
                kk, yy, mm, cc = (num(stack.pop()) for _ in range(4))
                gs.fill = (DEVICE_CMYK, [cc, mm, yy, kk])
            elif op == "K":
                kk, yy, mm, cc = (num(stack.pop()) for _ in range(4))
                gs.stroke = (DEVICE_CMYK, [cc, mm, yy, kk])
            elif op == "cs":
                fill_cs = resolve_cs(stack.pop(), resources)
            elif op == "CS":
                stroke_cs = resolve_cs(stack.pop(), resources)
            elif op in ("sc", "scn"):
                pat_name = stack.pop() if stack and isinstance(stack[-1], Name) else None
                vals = []
                while stack and isinstance(stack[-1], (int, float)):
                    vals.append(num(stack.pop()))
                vals.reverse()
                if pat_name is not None:
                    pats = pdf.resolve(resources.get("Pattern", {}))
                    pobj = pats.get(pat_name.v) if isinstance(pats, dict) else None
                    pat = read_pattern(pdf, pobj) if pobj is not None else None
                    if pat is not None:
                        pat.name = pat_name.v
                        if isinstance(pat, TilingPattern) and not pat.coloured and vals:
                            pat.colour = device_colour(fill_cs, vals)
                        gs.fill = ("Pattern", pat)
                elif vals:
                    gs.fill = device_colour(fill_cs, vals)
            elif op in ("SC", "SCN"):
                pat_name = stack.pop() if stack and isinstance(stack[-1], Name) else None
                vals = []
                while stack and isinstance(stack[-1], (int, float)):
                    vals.append(num(stack.pop()))
                vals.reverse()
                if pat_name is not None:
                    pats = pdf.resolve(resources.get("Pattern", {}))
                    pobj = pats.get(pat_name.v) if isinstance(pats, dict) else None
                    pat = read_pattern(pdf, pobj) if pobj is not None else None
                    if pat is not None:
                        pat.name = pat_name.v
                        if isinstance(pat, TilingPattern) and not pat.coloured and vals:
                            pat.colour = device_colour(stroke_cs, vals)
                        gs.stroke = ("Pattern", pat)
                elif vals:
                    gs.stroke = device_colour(stroke_cs, vals)
            elif op == "sh":
                name = stack.pop()
                shd = pdf.resolve(resources.get("Shading", {}))
                sobj = shd.get(name.v) if isinstance(shd, dict) else None
                if sobj is not None:
                    shading = read_shading(pdf, gs.ctm, {}, sobj)
                    sinks[-1].append(
                        GShading(None, shading, gs.ctm, name=name.v, blend=gs.blend)
                    )
            elif op == "w":
                gs.linewidth = num(stack.pop())
            elif op == "d":
                phase = num(stack.pop())
                arr = stack.pop() if stack else []
                if isinstance(arr, list):
                    gs.dash = (
                        tuple(num(v) for v in arr if isinstance(v, (int, float))),
                        phase,
                    )
            elif op == "J":
                gs.cap = int(stack.pop())
            elif op == "j":
                gs.join = int(stack.pop())
            elif op == "M":
                gs.mitre = num(stack.pop())
            elif op == "gs":
                name = stack.pop()
                egs = pdf.resolve(resources.get("ExtGState", {}))
                entry = pdf.resolve(egs.get(name.v)) if isinstance(egs, dict) else None
                if isinstance(entry, dict):
                    if "ca" in entry:
                        gs.ca = float(pdf.resolve(entry["ca"]))
                    if "CA" in entry:
                        gs.CA = float(pdf.resolve(entry["CA"]))
                    if "LW" in entry:
                        gs.linewidth = float(pdf.resolve(entry["LW"]))
                    if "BM" in entry:
                        bm = pdf.resolve(entry["BM"])
                        if isinstance(bm, list) and bm:
                            # Arrays are a PDF 1.x compatibility form: the
                            # first recognised name wins.
                            bm = pdf.resolve(bm[0])
                        if isinstance(bm, Name):
                            gs.blend = "Normal" if bm.v == "Compatible" else bm.v
                    if "SMask" in entry:
                        sm = pdf.resolve(entry["SMask"])
                        # The mask group's coordinates live in the ctm at
                        # the gs op (PDF 11.6.5.2), so capture both.
                        gs.softmask = (
                            None
                            if isinstance(sm, Name) and sm.v == "None"
                            else (sm, gs.ctm)
                        )
            elif op == "Do":
                name = stack.pop()
                xod = pdf.resolve(resources.get("XObject", {}))
                raw_ref = xod.get(name.v) if isinstance(xod, dict) else None
                xo = pdf.resolve(raw_ref)
                if isinstance(xo, Stream):
                    st = pdf.resolve(xo.dict.get("Subtype"))
                    if "OC" in xo.dict and not oc_visible(pdf, xo.dict["OC"]):
                        pass  # optional content OFF: skip the XObject
                    elif isinstance(st, Name) and st.v == "Form":
                        sub_res = pdf.resolve(xo.dict.get("Resources")) or resources
                        sub_gs = copy.deepcopy(gs)
                        mtx = pdf.resolve(xo.dict.get("Matrix"))
                        if isinstance(mtx, list) and len(mtx) == 6:
                            sub_gs.ctm = _mat_mul(sub_gs.ctm, tuple(float(v) for v in mtx))
                        grp = pdf.resolve(xo.dict.get("Group"))
                        gkind = (
                            pdf.resolve(grp.get("S")) if isinstance(grp, dict) else None
                        )
                        transparency_group = (
                            isinstance(gkind, Name) and gkind.v == "Transparency"
                        )
                        if transparency_group and (
                            sub_gs.ca < 1.0 or sub_gs.blend != "Normal"
                        ):
                            # Group-level alpha/blend: children render at
                            # full alpha / Normal and the group result gets
                            # the gstate applied ONCE (PDF 11.6.6).
                            ca, blend = sub_gs.ca, sub_gs.blend
                            sub_gs.ca = 1.0
                            sub_gs.CA = 1.0
                            sub_gs.blend = "Normal"
                            sinks[-1].append(
                                FormGroup(
                                    _process(pdf, xo.decode(), sub_res, sub_gs),
                                    ca, blend,
                                )
                            )
                        else:
                            sinks[-1].extend(_process(pdf, xo.decode(), sub_res, sub_gs))
                    elif isinstance(st, Name) and st.v == "Image":
                        # pdfgraphics.ml:1036-1045: placement transform,
                        # nonstroke alpha, softmask, object number.
                        objnum = raw_ref.num if isinstance(raw_ref, Ref) else -1
                        sinks[-1].append(
                            Image(
                                ImageAttributes(
                                gs.ctm, gs.ca, gs.softmask, gs.fill, gs.blend
                            ),
                                objnum,
                                name.v,
                                xo if objnum < 0 else None,
                            )
                        )
            elif op == "BI":
                # Inline image: dict entries to ID, then raw bytes to EI.
                d: dict = {}
                while True:
                    k = lex.next_token()
                    if not k or k == b"ID":
                        break
                    key = (
                        k[1:].decode("latin1")
                        if k.startswith(b"/")
                        else k.decode("latin1")
                    )
                    p = _Parser(b"", 0)
                    p.lex = lex
                    d[key] = p._obj(lex.next_token())
                data_start = lex.p
                if data_start < len(lex.d) and lex.d[data_start] in _WS:
                    # Exactly one whitespace after ID; tolerate CRLF.
                    crlf = lex.d[data_start : data_start + 2] == b"\r\n"
                    data_start += 2 if crlf else 1
                n_bytes = _inline_image_bytes(d)
                if n_bytes is not None and data_start + n_bytes <= len(lex.d):
                    # Unfiltered image: the exact data length is computable,
                    # so binary data may contain 'EI' and the terminator may
                    # directly abut the data.
                    data = lex.d[data_start : data_start + n_bytes]
                    lex.p = data_start + n_bytes
                    if lex.peek_token() == b"EI":
                        lex.next_token()
                else:
                    # Filtered/unknown: scan for the terminator, preferring
                    # whitespace-delimited EI, falling back to a bare EI
                    # (whitespace before EI is not required by the spec).
                    tail = lex.d[data_start:]
                    m = re.search(
                        rb"[\x00\t\n\x0c\r ]EI(?=[\x00\t\n\x0c\r ]|$)", tail
                    ) or re.search(rb"EI(?=[\x00\t\n\x0c\r ]|$)", tail)
                    if m:
                        data = tail[: m.start()]
                        lex.p = data_start + m.end()
                    else:
                        data = tail
                        lex.p = len(lex.d)
                cs = d.get("CS", d.get("ColorSpace"))
                if isinstance(cs, Name) and cs.v not in (
                    "G", "RGB", "CMYK", "I",
                    "DeviceGray", "DeviceRGB", "DeviceCMYK", "Indexed",
                ):
                    # Named colourspace from the page resources (legal and
                    # required for inline Indexed/ICC): inline the resolved
                    # object so downstream decoding needs no resources.
                    csd = (
                        pdf.resolve(resources.get("ColorSpace", {}))
                        if isinstance(resources, dict)
                        else {}
                    )
                    got = (
                        pdf.resolve(csd.get(cs.v))
                        if isinstance(csd, dict)
                        else None
                    )
                    if got is not None:
                        d["CS" if "CS" in d else "ColorSpace"] = got
                sinks[-1].append(
                    GraphicInlineImage(d, bytes(data), gs.ctm, gs.fill, gs.blend)
                )
            elif op == "BT":
                in_text = True
                # Sticky text-state parameters (PDF 9.3.1 lives in the
                # graphics state): set at page-description level or in a
                # previous BT..ET block, they stay in force — seed the new
                # block with them so pdftext's per-block replay sees them.
                text_ops = [
                    (
                        TextAttributes(
                            gs.textmode, gs.fill, gs.stroke, gs.ca, gs.CA, gs.blend
                        ),
                        (sop, sops),
                    )
                    for sop, sops in text_state.items()
                ]
                text_tf = gs.ctm
                stack.clear()
            elif op == "ET":
                if in_text and text_ops:
                    tb = TextBlock(text_ops, text_tf, resources)
                    sinks[-1].append(tb)
                    if any(
                        attrs.textmode >= 4 and opn in ("Tj", "TJ", "'", '"')
                        for attrs, (opn, _) in text_ops
                    ):
                        # Clip render mode: wrap subsequent elements until
                        # the enclosing grestore (PDF 9.3.5).
                        tc = TextClip(tb, [])
                        sinks[-1].append(tc)
                        sinks.append(tc.elements)
                        sink_levels.append(qlevel)
                in_text = False
            elif op in _TEXT_OPS:
                operands = list(stack)
                stack.clear()
                if op == "Tr" and operands and isinstance(operands[-1], (int, float)):
                    gs.textmode = int(operands[-1])
                if op in _STICKY_TEXT_OPS:
                    text_state[op] = operands
                if in_text:
                    text_ops.append(
                        (
                            TextAttributes(
                                gs.textmode, gs.fill, gs.stroke, gs.ca, gs.CA
                            ),
                            (op, operands),
                        )
                    )
            elif op in ("BMC", "BDC"):
                # Marked-content section: wrap elements until the matching
                # EMC (pdfgraphics.ml getuntil_matching_emc).
                props = stack.pop() if op == "BDC" else None
                tag = stack.pop()
                name = tag.v if isinstance(tag, Name) else str(tag)
                mc = (
                    MCSectionProperties(name, props, [])
                    if op == "BDC"
                    else MCSection(name, [])
                )
                visible = True
                if op == "BDC" and name == "OC":
                    oc = props
                    if isinstance(oc, Name):
                        # Keep the /Properties entry UNRESOLVED: group
                        # membership is by indirect reference.
                        oc = (pdf.resolve(resources.get("Properties")) or {}).get(oc.v)
                    visible = oc_visible(pdf, oc)
                if visible:
                    sinks[-1].append(mc)
                # A hidden section's elements still capture into mc (keeping
                # the parser in sync) but mc is never attached — dropped,
                # like Hidden-flagged annotations.
                sinks.append(mc.elements)
                sink_levels.append(None)  # closed by EMC, not Q
            elif op == "EMC":
                # Pop back to (and including) the innermost MC sink; any clip
                # sinks opened inside it close with it.
                for k in range(len(sinks) - 1, 0, -1):
                    if sink_levels[k] is None:
                        del sinks[k:]
                        del sink_levels[k:]
                        break
            else:
                # Unhandled operator: drop its operands.
                stack.clear()
        except IndexError:
            stack.clear()
    if current:
        subpaths.append(current)
    return elements


def transform_graphic(t, graphic: Graphic) -> Graphic:
    """Transform every element of a graphic (pdfgraphics.ml
    transform_graphic): paths pointwise; text/image placement matrices by
    composition."""
    tmat = ctr.matrix_of_transform(t)

    def walk(elements):
        out = []
        for el in elements:
            if isinstance(el, GPath):
                out.append(GPath(gpath.transform_path(list(t), el.path), el.attributes))
            elif isinstance(el, MCSection):
                out.append(MCSection(el.name, walk(el.elements)))
            elif isinstance(el, MCSectionProperties):
                out.append(
                    MCSectionProperties(el.name, el.properties, walk(el.elements))
                )
            elif isinstance(el, Clip):
                out.append(Clip(gpath.transform_path(list(t), el.path), walk(el.elements)))
            elif isinstance(el, TextBlock):
                out.append(
                    TextBlock(el.blocks, ctr.matmul(tmat, el.transform), el.resources)
                )
            elif isinstance(el, TextClip):
                b = el.block
                out.append(
                    TextClip(
                        TextBlock(b.blocks, ctr.matmul(tmat, b.transform), b.resources),
                        walk(el.elements),
                    )
                )
            elif isinstance(el, FormGroup):
                out.append(FormGroup(walk(el.elements), el.ca, el.blend))
            elif isinstance(el, Image):
                a = el.attributes
                out.append(
                    Image(
                        ImageAttributes(
                            ctr.matmul(tmat, a.image_transform),
                            a.image_transparency,
                            a.image_softmask,
                            a.image_fill,
                            a.image_blend,
                        ),
                        el.objnum,
                        el.name,
                        el.stream,
                    )
                )
            elif isinstance(el, GraphicInlineImage):
                out.append(
                    GraphicInlineImage(
                        el.dict, el.data, ctr.matmul(tmat, el.transform),
                        el.fill, el.blend,
                    )
                )
            elif isinstance(el, GShading):
                # Compose the transform into the shading's matrix and
                # element ctm, and move its clip path pointwise, so the
                # gradient stays registered with its clip geometry (the
                # reference drops shadings at render time so its
                # transform_graphic gap is invisible; here they render).
                sh = el.shading
                out.append(
                    GShading(
                        gpath.transform_path(list(t), el.clip)
                        if el.clip is not None
                        else None,
                        Shading(
                            sh.colourspace,
                            sh.background,
                            sh.bbox,
                            sh.antialias,
                            ctr.matmul(tmat, sh.matrix),
                            sh.extgstate,
                            sh.kind,
                            sh.cs_conv,
                        ),
                        ctr.matmul(tmat, el.transform),
                        el.name,
                        el.blend,
                    )
                )
            else:
                out.append(el)
        return out

    return Graphic(walk(graphic.elements), graphic.resources)


# ---------------------------------------------------------------------------
# Inverse: structured graphic -> PDF page (pdfgraphics.ml page_of_graphic)
# ---------------------------------------------------------------------------


def _fmt(v: float) -> str:
    s = f"{v:.4f}".rstrip("0").rstrip(".")
    return s or "0"


def _ser_operand(v) -> str:
    """Serialize a captured content-stream operand."""
    if isinstance(v, Name):
        return f"/{v.v}"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _fmt(float(v))
    if isinstance(v, bytes):
        body = (
            v.decode("latin1")
            .replace("\\", "\\\\")
            .replace("(", "\\(")
            .replace(")", "\\)")
        )
        return f"({body})"
    if isinstance(v, list):
        return "[" + " ".join(_ser_operand(x) for x in v) + "]"
    if isinstance(v, dict):
        return (
            "<< "
            + " ".join(f"/{k} {_ser_operand(x)}" for k, x in v.items())
            + " >>"
        )
    return "null"


def _function_dict(f: PdfFunction):
    if f.kind == 2:
        d = {
            "FunctionType": 2,
            "Domain": list(f.domain),
            "C0": list(f.c0),
            "C1": list(f.c1),
            "N": f.n,
        }
    elif f.kind == 3:
        d = {
            "FunctionType": 3,
            "Domain": list(f.domain),
            "Functions": [_function_dict(x) for x in f.functions],
            "Bounds": list(f.bounds),
            "Encode": list(f.encode),
        }
    else:
        return f.raw if isinstance(f.raw, dict) else {"FunctionType": f.kind}
    if f.range:
        d["Range"] = list(f.range)
    return d


def _shading_dict(s: Shading):
    d = {}
    if s.colourspace is not None:
        d["ColorSpace"] = s.colourspace
    if s.background is not None:
        d["Background"] = s.background
    if s.bbox is not None:
        d["BBox"] = s.bbox
    if s.antialias:
        d["AntiAlias"] = True
    k = s.kind
    if isinstance(k, AxialShadingK):
        d["ShadingType"] = 2
        d["Coords"] = list(k.coords)
        d["Domain"] = list(k.domain)
        d["Extend"] = list(k.extend)
        fns = [_function_dict(f) for f in k.functions]
        d["Function"] = fns[0] if len(fns) == 1 else fns
    elif isinstance(k, RadialShadingK):
        d["ShadingType"] = 3
        d["Coords"] = list(k.coords)
        d["Domain"] = list(k.domain)
        d["Extend"] = list(k.extend)
        fns = [_function_dict(f) for f in k.functions]
        d["Function"] = fns[0] if len(fns) == 1 else fns
    elif isinstance(k, FunctionShadingK):
        d["ShadingType"] = 1
        d["Domain"] = list(k.domain)
        if k.matrix != _ID:
            d["Matrix"] = list(k.matrix)
        if isinstance(k.function, tuple):
            d["Function"] = [_function_dict(f) for f in k.function]
        elif k.function is not None:
            d["Function"] = _function_dict(k.function)
    elif isinstance(k, MeshShadingK) and k.triangles:
        # Any mesh kind re-serializes as free-form Gouraud triangles
        # (type 4): patches were already subdivided at read time.
        return _mesh_stream_obj(d, k)
    return d


def _mesh_stream_obj(d: dict, k: MeshShadingK) -> "Stream":
    tris = k.triangles
    xs = [p[0] for t in tris for p in t[:3]]
    ys = [p[1] for t in tris for p in t[:3]]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 <= x0:
        x1 = x0 + 1.0
    if y1 <= y0:
        y1 = y0 + 1.0
    ncomp = len(tris[0][3])
    acc = bytearray()

    def c32(v, lo, hi):
        return round((v - lo) / (hi - lo) * 0xFFFFFFFF)

    for (p0, p1, p2, c0, c1, c2) in tris:
        for p, c in ((p0, c0), (p1, c1), (p2, c2)):
            acc.append(0)  # flag: every triangle standalone
            acc += struct.pack(">II", c32(p[0], x0, x1), c32(p[1], y0, y1))
            for v in c:
                acc += struct.pack(
                    ">H", round(min(max(float(v), 0.0), 1.0) * 0xFFFF)
                )
    d = dict(d)
    d.update(
        {
            "ShadingType": 4,
            "BitsPerCoordinate": 32,
            "BitsPerComponent": 16,
            "BitsPerFlag": 8,
            "Decode": [x0, x1, y0, y1] + [0.0, 1.0] * ncomp,
        }
    )
    return Stream(d, bytes(acc))


def _pattern_dict(p: ShadingPattern):
    d = {"PatternType": 2, "Shading": _shading_dict(p.shading)}
    if p.shading.matrix != _ID:
        d["Matrix"] = list(p.shading.matrix)
    return d


def _tiling_stream_obj(p: TilingPattern):
    """TilingPattern -> pattern stream object: the inverse of read_pattern's
    PatternType-1 branch (BEYOND REFERENCE — the reference's writer drops
    tiling paint entirely).  The cell elements re-serialize through
    page_of_graphic; its content stream and resources embed in the pattern."""
    inner = page_of_graphic(Graphic(list(p.elements)))
    pages = inner.resolve(inner.resolve(inner.trailer["Root"])["Pages"])
    kid = inner.resolve(pages["Kids"][0])
    content = inner.resolve(kid["Contents"])
    bbox = list(p.bbox) if len(p.bbox) == 4 else [0.0, 0.0, 1.0, 1.0]
    d = {
        "Type": Name("Pattern"),
        "PatternType": 1,
        "PaintType": 1 if p.coloured else 2,
        "TilingType": 1,
        "BBox": bbox,
        "XStep": p.xstep or (bbox[2] - bbox[0]),
        "YStep": p.ystep or (bbox[3] - bbox[1]),
        "Resources": kid.get("Resources", {}),
    }
    if p.matrix != _ID:
        d["Matrix"] = list(p.matrix)
    d.update(content.dict)
    return Stream(d, content.raw)


def _copy_object(src: Pdf, obj, objects: dict, memo: dict):
    """Deep-copy a source-document object graph into ``objects`` (the
    output Pdf's object table), rewriting Refs to freshly allocated
    numbers.  Shared refs copy once (memo)."""
    if isinstance(obj, Ref):
        if obj.num in memo:
            return Ref(memo[obj.num])
        n = (max(objects) + 1) if objects else 1
        memo[obj.num] = n
        objects[n] = None  # reserve before recursing (cycles)
        objects[n] = _copy_object(src, src.resolve(obj), objects, memo)
        return Ref(n)
    if isinstance(obj, Stream):
        return Stream(
            {k: _copy_object(src, v, objects, memo) for k, v in obj.dict.items()},
            obj.raw,
        )
    if isinstance(obj, dict):
        return {k: _copy_object(src, v, objects, memo) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_copy_object(src, v, objects, memo) for v in obj]
    return obj


def page_of_graphic(
    graphic: Graphic, mediabox=(0, 0, 612, 792), pdf: Pdf = None
) -> Pdf:
    """Serialize path elements back to a one-page PDF.

    ``pdf`` is the optional SOURCE document: image XObject uses
    (pdfgraphics.mli:139) referencing it by object number are copied
    across — stream bytes untouched, their dependency graph (colourspace
    arrays, /SMask, /DecodeParms) rewritten to fresh object numbers —
    matching the reference's camlpdf object-copying writer.  Without it,
    directly-embedded streams (objnum -1) still round-trip."""
    ops: List[str] = []
    shading_res: dict = {}
    pattern_res: dict = {}
    colourspace_res: dict = {}
    egs_res: dict = {}
    _egs_names: dict = {}
    image_res: List[object] = []  # source Streams to copy, by emit order
    # Emitted-gstate tracking: (blend, ca, CA) per q-nesting level, so a gs
    # is written only when the needed state differs from the one in force
    # (and Q correctly reverts the tracked state).
    _gs_cur = [("Normal", 1.0, 1.0)]

    def res_name(d: dict, prefix: str, payload) -> str:
        nm = f"{prefix}{len(d)}"
        d[nm] = payload
        return nm

    def push_q():
        ops.append("q")
        _gs_cur.append(_gs_cur[-1])

    def pop_q():
        ops.append("Q")
        _gs_cur.pop()

    def set_gstate(blend="Normal", ca=1.0, CA=1.0):
        """Ensure /BM + alphas via an ExtGState resource (BEYOND REFERENCE:
        the reference never writes transparency state)."""
        want = (str(blend), float(ca), float(CA))
        if want == _gs_cur[-1]:
            return
        _gs_cur[-1] = want
        nm = _egs_names.get(want)
        if nm is None:
            nm = res_name(
                egs_res, "Gs",
                {"Type": Name("ExtGState"), "BM": Name(want[0]),
                 "ca": want[1], "CA": want[2]},
            )
            _egs_names[want] = nm
        ops.append(f"/{nm} gs")

    def emit_tiling_cs(p: TilingPattern, nm: str, upper: bool) -> str:
        """The cs/scn (or CS/SCN) pair selecting tiling pattern `nm`;
        uncoloured patterns carry their tint components through a
        [/Pattern /DeviceX] colourspace resource."""
        cs_op, scn_op = ("CS", "SCN") if upper else ("cs", "scn")
        if p.coloured or p.colour is None:
            return f"/Pattern {cs_op} /{nm} {scn_op}"
        under, comps = p.colour
        csnm = res_name(
            colourspace_res, "CSp", [Name("Pattern"), Name(str(under))]
        )
        comps_s = " ".join(_fmt(v) for v in comps)
        return f"/{csnm} {cs_op} {comps_s} /{nm} {scn_op}"

    def emit_path(p: gpath.Path):
        for sp in p.subpaths:
            first = True
            for seg in sp.segments:
                if isinstance(seg, gpath.Straight):
                    if first:
                        ops.append(f"{_fmt(seg.a[0])} {_fmt(seg.a[1])} m")
                        first = False
                    ops.append(f"{_fmt(seg.b[0])} {_fmt(seg.b[1])} l")
                else:
                    if first:
                        ops.append(f"{_fmt(seg.p1[0])} {_fmt(seg.p1[1])} m")
                        first = False
                    ops.append(
                        f"{_fmt(seg.p2[0])} {_fmt(seg.p2[1])} "
                        f"{_fmt(seg.p3[0])} {_fmt(seg.p3[1])} "
                        f"{_fmt(seg.p4[0])} {_fmt(seg.p4[1])} c"
                    )
            if sp.closed:
                ops.append("h")

    def walk(elements):
        for i, el in enumerate(elements):
            if (
                isinstance(el, TextBlock)
                and i + 1 < len(elements)
                and isinstance(elements[i + 1], TextClip)
                and elements[i + 1].block.blocks is el.blocks
            ):
                continue  # painted by the adjacent TextClip's combined form
            if isinstance(el, GPath):
                a = el.attributes
                set_gstate(
                    a.path_blend,
                    a.path_transparency.fill_transparency,
                    a.path_transparency.line_transparency,
                )
                if a.path_line is not None:
                    ops.append(f"{_fmt(a.path_linewidth)} w")
                    ops.append(f"{a.path_capstyle} J {a.path_joinstyle} j")
                    if a.path_dash[0]:
                        arr = " ".join(_fmt(v) for v in a.path_dash[0])
                        ops.append(f"[{arr}] {_fmt(a.path_dash[1])} d")
                if a.path_fill is not None:
                    cs, vals = a.path_fill
                    if isinstance(vals, ShadingPattern):
                        nm = vals.name or res_name(pattern_res, "P", None)
                        pattern_res[nm] = _pattern_dict(vals)
                        ops.append(f"/Pattern cs /{nm} scn")
                    elif isinstance(vals, TilingPattern):
                        nm = vals.name or res_name(pattern_res, "P", None)
                        pattern_res[nm] = _tiling_stream_obj(vals)
                        ops.append(emit_tiling_cs(vals, nm, upper=False))
                    elif cs == DEVICE_RGB:
                        ops.append(" ".join(map(_fmt, vals)) + " rg")
                    elif cs == DEVICE_GRAY:
                        ops.append(f"{_fmt(vals[0])} g")
                    else:
                        ops.append(" ".join(map(_fmt, vals)) + " k")
                if a.path_line is not None:
                    cs, vals = a.path_line
                    if isinstance(vals, ShadingPattern):
                        nm = vals.name or res_name(pattern_res, "P", None)
                        pattern_res[nm] = _pattern_dict(vals)
                        ops.append(f"/Pattern CS /{nm} SCN")
                    elif isinstance(vals, TilingPattern):
                        nm = vals.name or res_name(pattern_res, "P", None)
                        pattern_res[nm] = _tiling_stream_obj(vals)
                        ops.append(emit_tiling_cs(vals, nm, upper=True))
                    elif cs == DEVICE_RGB:
                        ops.append(" ".join(map(_fmt, vals)) + " RG")
                    elif cs == DEVICE_GRAY:
                        ops.append(f"{_fmt(vals[0])} G")
                    else:
                        ops.append(" ".join(map(_fmt, vals)) + " K")
                emit_path(el.path)
                if el.attributes.path_fill is not None and el.attributes.path_line is not None:
                    ops.append("B" if el.path.winding == gpath.NONZERO else "B*")
                elif el.attributes.path_fill is not None:
                    ops.append("f" if el.path.winding == gpath.NONZERO else "f*")
                elif el.attributes.path_line is not None:
                    ops.append("S")
                else:
                    ops.append("n")
            elif isinstance(el, Clip):
                # q <path> W/W* n <contents> Q (pdfgraphics.ml:1648-1657).
                push_q()
                emit_path(el.path)
                ops.append("W n" if el.path.winding == gpath.NONZERO else "W* n")
                walk(el.elements)
                pop_q()
            elif isinstance(el, MCSection):
                ops.append(f"/{el.name} BMC")
                walk(el.elements)
                ops.append("EMC")
            elif isinstance(el, MCSectionProperties):
                ops.append(f"/{el.name} {_ser_operand(el.properties)} BDC")
                walk(el.elements)
                ops.append("EMC")
            elif isinstance(el, TextBlock):
                # q cm BT <text ops> ET Q (pdfgraphics.ml:1487).
                push_q()
                if el.blocks and el.blocks[0][0].blend != "Normal":
                    set_gstate(el.blocks[0][0].blend)
                ops.append(" ".join(map(_fmt, el.transform)) + " cm")
                ops.append("BT")
                for _st, (opname, operands) in el.blocks:
                    line = " ".join(_ser_operand(v) for v in operands)
                    ops.append((line + " " + opname).strip())
                ops.append("ET")
                pop_q()
            elif isinstance(el, TextClip):
                # One shared q scope: the block's clip modes re-derive the
                # TextClip on read; the inverse cm restores the children's
                # coordinate space while the clip stays in force.
                b = el.block
                inv = _mat_inv(b.transform)
                push_q()
                ops.append(" ".join(map(_fmt, b.transform)) + " cm")
                ops.append("BT")
                for _st, (opname, operands) in b.blocks:
                    line = " ".join(_ser_operand(v) for v in operands)
                    ops.append((line + " " + opname).strip())
                ops.append("ET")
                if inv is not None:
                    ops.append(" ".join(map(_fmt, inv)) + " cm")
                walk(el.elements)
                pop_q()
            elif isinstance(el, FormGroup):
                # Content-only writer: the group alpha/blend is set for the
                # children in one q scope (a reread applies them per
                # element — the grouped composite needs a real Form
                # XObject, which this writer does not emit).
                push_q()
                set_gstate(el.blend, el.ca, el.ca)
                walk(el.elements)
                pop_q()
            elif isinstance(el, GraphicInlineImage):
                push_q()
                set_gstate(el.blend)
                ops.append(" ".join(map(_fmt, el.transform)) + " cm")
                body = " ".join(
                    f"/{k} {_ser_operand(v)}" for k, v in el.dict.items()
                )
                ops.append(
                    "BI " + body + " ID\n" + el.data.decode("latin1") + "\nEI"
                )
                pop_q()
            elif isinstance(el, GShading):
                nm = el.name or res_name(shading_res, "Sh", None)
                shading_res[nm] = _shading_dict(el.shading)
                push_q()
                set_gstate(el.blend)
                if el.transform != _ID:
                    ops.append(" ".join(map(_fmt, el.transform)) + " cm")
                ops.append(f"/{nm} sh")
                pop_q()
            elif isinstance(el, Image):
                a = el.attributes
                st = el.stream
                if st is None and pdf is not None and el.objnum >= 0:
                    st = pdf.resolve(Ref(el.objnum))
                if not isinstance(st, Stream):
                    continue  # no source document to copy from
                nm = f"Im{len(image_res)}"
                image_res.append(st)
                push_q()
                set_gstate(a.image_blend, a.image_transparency,
                           a.image_transparency)
                if a.image_fill is not None:
                    # Stencil masks paint the nonstroke colour at the Do.
                    _cs, comps = a.image_fill
                    op = {1: "g", 3: "rg", 4: "k"}.get(len(comps))
                    if op:
                        ops.append(
                            " ".join(_fmt(v) for v in comps) + " " + op
                        )
                if a.image_transform != _ID:
                    ops.append(
                        " ".join(map(_fmt, a.image_transform)) + " cm"
                    )
                ops.append(f"/{nm} Do")
                pop_q()

    walk(graphic.elements)
    resources = {}
    if shading_res:
        resources["Shading"] = shading_res
    if pattern_res:
        resources["Pattern"] = pattern_res
    if colourspace_res:
        resources["ColorSpace"] = colourspace_res
    if egs_res:
        resources["ExtGState"] = egs_res
    if image_res:
        resources["XObject"] = {}  # filled with Refs below
    # latin1 inverts the latin1 decode used when capturing binary operands
    # (inline-image data, non-ASCII string bytes); utf-8 would widen them.
    out = mkpage(
        "\n".join(ops).encode("latin1"), mediabox=mediabox, resources=resources
    )
    if image_res:
        memo: dict = {}
        page = out.resolve(out.resolve(out.objects[1]["Pages"])["Kids"][0])
        xobjs = page["Resources"]["XObject"]
        for i, st in enumerate(image_res):
            n = max(out.objects) + 1
            out.objects[n] = None  # reserve before the copy allocates more
            out.objects[n] = (
                _copy_object(pdf, st, out.objects, memo)
                if pdf is not None
                else st
            )
            xobjs[f"Im{i}"] = Ref(n)
    return out
