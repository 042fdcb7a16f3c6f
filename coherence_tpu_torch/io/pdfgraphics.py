"""PDF content stream -> structured graphic (parity: vendored
``pdfgraphics.ml``: ``graphic_of_page`` and the ``process_op`` state
machine).

The port's copy of ``coherence_tpu.io.pdfgraphics``, trimmed to what the
port's scenes read: filled and stroked path elements with their colour,
winding rule, line attributes and transparency, ``Clip`` elements scoping
everything up to the matching ``Q`` (pdfgraphics.ml:1124-1139 semantics),
marked-content sections (with optional-content visibility) and form
XObjects.  The port's ``scene_of_graphic`` consumes only these.  Text,
images (XObject and inline), shadings, patterns, transparency groups with
their own alpha or blend, non-device colour spaces (Indexed, Separation,
DeviceN, Lab) and annotation appearance streams raise NotImplementedError
where the JAX package would build their elements.  ``page_of_graphic`` and
``transform_graphic`` are not ported.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..geometry import path as gpath
from .pdf import Name, Pdf, Ref, Stream, _Lexer, _NUM_RE, _Parser

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


def _scale_of(m: Matrix) -> float:
    a, b, c, d, _, _ = m
    det = abs(a * d - b * c)
    return math.sqrt(det)


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
    softmask: object = None  # ExtGState /SMask (None when /None)
    blend: str = "Normal"  # ExtGState /BM (BEYOND REFERENCE)


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
    """Interpret a page's content streams (pdfgraphics.ml:1229).  The JAX
    package also paints annotation appearance streams; the port raises on a
    page with a visible one."""
    content = pdf.page_content(page)
    resources = pdf.resolve(page.get("Resources")) or {}
    elements = _process(pdf, content, resources, _GState())
    for a in pdf.resolve(page.get("Annots")) or []:
        a = pdf.resolve(a)
        if not isinstance(a, dict):
            continue
        sub = pdf.resolve(a.get("Subtype"))
        if isinstance(sub, Name) and sub.v in ("Popup", "Link"):
            continue
        if isinstance(pdf.resolve(a.get("AP")), dict):
            raise NotImplementedError("annotation appearance streams")
    return Graphic(elements, resources)


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
    stack: List[object] = []  # operand stack
    gstack: List[_GState] = []
    subpaths: List[list] = []  # list of segment lists (float, post-CTM)
    current: List[object] = []
    start: Optional[Tuple[float, float]] = None
    cur: Optional[Tuple[float, float]] = None

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
        """Device space name or "Pattern"; ICC-based and calibrated spaces
        collapse to the device space with their number of components."""
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
                raise NotImplementedError(f"colour space {head}")
        return DEVICE_RGB

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
            elif op in ("sc", "scn", "SC", "SCN"):
                if stack and isinstance(stack[-1], Name):
                    raise NotImplementedError("pattern colours")
                vals = []
                while stack and isinstance(stack[-1], (int, float)):
                    vals.append(num(stack.pop()))
                vals.reverse()
                if vals and op in ("sc", "scn"):
                    gs.fill = (fill_cs, vals)
                elif vals:
                    gs.stroke = (stroke_cs, vals)
            elif op == "sh":
                raise NotImplementedError("shadings")
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
                            raise NotImplementedError("transparency groups with their own alpha or blend")
                        sinks[-1].extend(_process(pdf, xo.decode(), sub_res, sub_gs))
                    elif isinstance(st, Name) and st.v == "Image":
                        raise NotImplementedError("image XObjects")
            elif op == "BI":
                raise NotImplementedError("inline images")
            elif op == "BT":
                raise NotImplementedError("text")
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
