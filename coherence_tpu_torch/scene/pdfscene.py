"""PDF graphic -> scene conversion (parity: render.ml:1476-1565).

The port's copy of ``coherence_tpu.scene.pdfscene``.  Each path element
becomes a filled object (nonzero/even-odd path) and/or a stroked object
with the PDF cap/join/linewidth; CMYK/Gray collapse to RGB exactly as the
reference's ``rgb_of_cmyk`` (render.ml:1476-1479).  Shadings, patterns,
images, soft masks, blend modes and transparency groups become the general
renderer's fills, filters and groups; text becomes glyph outlines
(``pdftext``).

Soft masks and tiling-pattern cells render a sub-scene through
``sub_render`` on the ``device`` the caller names (the Engine passes its
own), and read the result back to the host once (one counted
``region.syncs``).  Malformed PDF input falls back as in the JAX package
(the unmasked fill, nothing, the gray placeholder, a skipped text run),
whatever part of the host work fails.  A fault of a sub-render or of its
readback comes out as ``SubRenderError``, which every one of those
fallbacks raises again: no fallback hides the device."""

from __future__ import annotations

import math

import numpy as np

from .. import colour as C
from .. import ident
from .. import transform as tr
from ..geometry import dash as gdash
from ..geometry import path as gpath
from ..geometry import shapes as gshapes
from ..io import pdfgraphics as PG
from ..io import pdfimages as PI
from ..raster import blend as rblend
from ..raster import fills as rfills
from ..raster import region
from . import filters as F
from . import render as R


def _path_bbox(p):
    """Conservative float bbox over all control points (hull contains the
    curve), or None for an empty path."""
    xs, ys = [], []
    for sp in p.subpaths:
        for seg in sp.segments:
            pts = (
                (seg.a, seg.b)
                if isinstance(seg, gpath.Straight)
                else (seg.p1, seg.p2, seg.p3, seg.p4)
            )
            for x, y in pts:
                xs.append(x)
                ys.append(y)
    if not xs:
        return None
    return min(xs), min(ys), max(xs), max(ys)


def _rect_of_path(p):
    """(x0, y0, x1, y1) when the path is a single closed axis-aligned
    rectangular ring (e.g. a ``re`` clip), else None."""
    if len(p.subpaths) != 1:
        return None
    segs = list(p.subpaths[0].segments)
    if len(segs) < 3 or not all(isinstance(s, gpath.Straight) for s in segs):
        return None
    for a, b in zip(segs, segs[1:]):
        if a.b != b.a:
            return None
    if segs[-1].b != segs[0].a:
        return None
    xs, ys = set(), set()
    for s in segs:
        if s.a[0] != s.b[0] and s.a[1] != s.b[1]:
            return None  # diagonal side
        xs.update((s.a[0], s.b[0]))
        ys.update((s.a[1], s.b[1]))
    if len(xs) != 2 or len(ys) != 2:
        return None
    (x0, x1), (y0, y1) = sorted(xs), sorted(ys)
    return x0, y0, x1, y1


def clipped_shape(shape, clips, painted_bbox):
    """Intersect a basicshape with the active clip stack via CPG geometry
    (BEYOND REFERENCE: the reference's scene_of_graphic discards Clip paths,
    render.ml:1558-1560).  Rectangular clips that already contain the
    painted geometry's conservative bbox are skipped, so the ubiquitous
    page-box ``re W n`` clip costs nothing."""
    for cp in clips:
        r = _rect_of_path(cp)
        if r is not None and painted_bbox is not None:
            if (
                r[0] <= painted_bbox[0]
                and r[1] <= painted_bbox[1]
                and painted_bbox[2] <= r[2]
                and painted_bbox[3] <= r[3]
            ):
                continue
        shape = R.CPG(R.INTERSECTION, shape, R.PathShape(cp))
    return shape


def blend_wrap(obj: "R.Obj", mode) -> "R.Obj":
    """Wrap an object's geometry in a blend-mode filter when the ExtGState
    /BM in force at its paint op was a (known) non-Normal mode (BEYOND
    REFERENCE: the reference composites with `over` only)."""
    if mode in (None, "Normal", "Compatible"):
        return obj
    if mode not in rblend.BLEND_MODES:
        return obj  # unknown /BM name paints as Normal (PDF 11.3.5 note)
    return R.Obj(obj.idset, F.blendmode(obj.geometry, mode), obj.transform, obj.compop)


def rgb_of_cmyk(c, m, y, k):
    return (
        1.0 - min(1.0, c * (1.0 - k) + k),
        1.0 - min(1.0, m * (1.0 - k) + k),
        1.0 - min(1.0, y * (1.0 - k) + k),
    )


def fill_of_pdf_colour(vals, transparency: float, colourspace: str, device) -> rfills.Fill:
    if isinstance(vals, PG.ShadingPattern):
        got = fill_of_shading_pattern(vals, transparency)
        if got is not None:
            return got
        return rfills.plain(C.gray)  # unsupported shading kind
    if isinstance(vals, PG.TilingPattern):
        got = fill_of_tiling_pattern(vals, transparency, device)
        if got is not None:
            return got
        return rfills.plain(C.gray)  # empty/malformed cell fallback
    t = int(transparency * 255.0)
    if colourspace == PG.DEVICE_RGB and len(vals) == 3:
        r, g, b = vals
    elif colourspace == PG.DEVICE_CMYK and len(vals) == 4:
        r, g, b = rgb_of_cmyk(*vals)
    elif colourspace == PG.DEVICE_GRAY and len(vals) == 1:
        r = g = b = vals[0]
    else:
        return rfills.plain(C.red)  # colourspace mismatch fallback
    col = C.dissolve(C.colour_of_rgba_float(r, g, b, 1.0), delta=t)
    return rfills.plain(col)


def _colour_of_components(cs_obj, comps, transparency: float, conv=None) -> int:
    # PDF functions may return components outside [0,1] (no /Range, or a
    # permissive one); clamp at the colour boundary like the reference's
    # colour ingestion does.
    if conv is not None:
        r, g, b = PG.rgb_of_converted(conv, [float(v) for v in comps])
        t = int(transparency * 255.0)
        return C.dissolve(C.colour_of_rgba_float(r, g, b, 1.0), delta=t)
    comps = [min(max(float(v), 0.0), 1.0) for v in comps]
    name = cs_obj.v if hasattr(cs_obj, "v") else str(cs_obj)
    if name == PG.DEVICE_RGB and len(comps) == 3:
        r, g, b = comps
    elif name == PG.DEVICE_CMYK and len(comps) == 4:
        r, g, b = rgb_of_cmyk(*comps)
    elif len(comps) == 1:
        r = g = b = comps[0]
    elif len(comps) == 3:
        r, g, b = comps
    else:
        r = g = b = 0.5
    t = int(transparency * 255.0)
    return C.dissolve(C.colour_of_rgba_float(r, g, b, 1.0), delta=t)


def _rgb_of_components(cs_obj, comps, conv=None):
    if conv is not None:
        return PG.rgb_of_converted(conv, [float(v) for v in comps])
    comps = [min(max(float(v), 0.0), 1.0) for v in comps]
    name = cs_obj.v if hasattr(cs_obj, "v") else str(cs_obj)
    if name == PG.DEVICE_RGB and len(comps) == 3:
        return tuple(comps)
    if name == PG.DEVICE_CMYK and len(comps) == 4:
        return rgb_of_cmyk(*comps)
    if len(comps) == 1:
        return (comps[0],) * 3
    if len(comps) == 3:
        return tuple(comps)
    return (0.5, 0.5, 0.5)


_MESH_MAX_DIM = 2048  # texture cap per side for mesh rasters


def mesh_extent(sh: PG.Shading):
    """Target-space bbox of a mesh shading's transformed triangles."""
    k = sh.kind
    a, b, c_, d, e, f_ = sh.matrix
    xs, ys = [], []
    for t in k.triangles:
        for (x, y) in t[:3]:
            xs.append(a * x + c_ * y + e)
            ys.append(b * x + d * y + f_)
    if not xs:
        return None
    return (min(xs), min(ys), max(xs), max(ys))


def fill_of_mesh(sh: PG.Shading, transparency: float):
    """Mesh shadings (types 4-7) as an ImageFill: Gouraud triangles
    rasterized on the host at device resolution (the shading matrix is the
    ctm at the sh op / the pattern matrix, so 1 texel ~= 1 device pixel).
    BEYOND REFERENCE: the reference drops every shading at render time."""
    k = sh.kind
    if not isinstance(k, PG.MeshShadingK) or not k.triangles:
        return None
    a, b, c_, d, e, f_ = sh.matrix

    def xf(p):
        return (a * p[0] + c_ * p[1] + e, b * p[0] + d * p[1] + f_)

    tris = [
        (
            xf(p0), xf(p1), xf(p2),
            _rgb_of_components(sh.colourspace, c0, sh.cs_conv),
            _rgb_of_components(sh.colourspace, c1, sh.cs_conv),
            _rgb_of_components(sh.colourspace, c2, sh.cs_conv),
        )
        for (p0, p1, p2, c0, c1, c2) in k.triangles
    ]
    x0 = min(min(p[0] for p in t[:3]) for t in tris) - 1.0
    y0 = min(min(p[1] for p in t[:3]) for t in tris) - 1.0
    x1 = max(max(p[0] for p in t[:3]) for t in tris) + 1.0
    y1 = max(max(p[1] for p in t[:3]) for t in tris) + 1.0
    w, h = x1 - x0, y1 - y0
    if w <= 0 or h <= 0:
        return None
    scale = min(1.0, _MESH_MAX_DIM / max(w, h))
    W = max(1, int(math.ceil(w * scale)))
    H = max(1, int(math.ceil(h * scale)))
    rgb = np.zeros((H, W, 3), dtype=np.float64)
    cov = np.zeros((H, W), dtype=bool)
    for (p0, p1, p2, c0, c1, c2) in tris:
        # texel coords: column u = (x - x0)*scale, row r = (y1 - y)*scale
        # (row 0 = TOP, matching ImageFill's texel orientation).
        ax, ay = (p0[0] - x0) * scale, (y1 - p0[1]) * scale
        bx, by = (p1[0] - x0) * scale, (y1 - p1[1]) * scale
        cx, cy = (p2[0] - x0) * scale, (y1 - p2[1]) * scale
        denom = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(denom) < 1e-12:
            continue
        lo_u = max(0, int(math.floor(min(ax, bx, cx))))
        hi_u = min(W, int(math.ceil(max(ax, bx, cx))) + 1)
        lo_r = max(0, int(math.floor(min(ay, by, cy))))
        hi_r = min(H, int(math.ceil(max(ay, by, cy))) + 1)
        if lo_u >= hi_u or lo_r >= hi_r:
            continue
        us = np.arange(lo_u, hi_u, dtype=np.float64) + 0.5
        rs = np.arange(lo_r, hi_r, dtype=np.float64) + 0.5
        U, Rr = np.meshgrid(us, rs)
        w0 = ((by - cy) * (U - cx) + (cx - bx) * (Rr - cy)) / denom
        w1 = ((cy - ay) * (U - ax) + (ax - cx) * (Rr - ay)) / denom
        w2 = 1.0 - w0 - w1
        eps = -1e-9
        inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
        if not inside.any():
            continue
        col = (
            w0[..., None] * np.asarray(c0)
            + w1[..., None] * np.asarray(c1)
            + w2[..., None] * np.asarray(c2)
        )
        sl = (slice(lo_r, hi_r), slice(lo_u, hi_u))
        # Later triangles paint over earlier ones (PDF paint order).
        rgb[sl] = np.where(inside[..., None], col, rgb[sl])
        cov[sl] |= inside
    a8 = int(transparency * 255.0)
    rgb8 = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.int64)
    tex = np.zeros((H, W, 4), dtype=np.int64)
    tex[..., :3] = (rgb8 * a8 + 127) // 255
    tex[..., 3] = a8
    tex[~cov] = 0
    # ImageFill maps the unit square (v up) onto the bbox rect.
    return rfills.image_fill(tex, (w, 0.0, 0.0, h, x0, y0))


_SMASK_MAX_DIM = 2048  # soft-mask raster cap per side


class SubRenderError(RuntimeError):
    """A sub-scene's render on the device, or its readback, failed.  The
    host fallbacks for malformed input (soft mask, Type 3 glyph, text run,
    text clip) raise it again."""


class NoDeviceError(SubRenderError, ValueError):
    """A sub-scene must render, and scene_of_graphic was given no device."""


def _require_device(device, what: str) -> None:
    if device is None:
        raise NoDeviceError(f"{what} renders a sub-scene: scene_of_graphic needs a device")


def _host(t) -> np.ndarray:
    """One counted readback of a raster tensor."""
    region._sync()
    return t.cpu().numpy()


def sub_render(scene, box, device, read):
    """``read(sprite)`` of ``render_simple_scene(scene)`` over `box` on
    `device` (the render and its one readback), or None when nothing
    painted.  Any failure of either raises SubRenderError."""
    try:
        spr = R.render_simple_scene(scene, region.shape_of_box(box, device), device)
        return None if spr is None else read(spr)
    except Exception as e:
        raise SubRenderError(f"a sub-scene's render on {device} failed: {e!r}") from e


def _softmask_group(pdf, sm_ctm):
    """The parsed /SMask group of `softmask_fill`: (alpha_kind, (ix0, iy0,
    ix1, iy1) device box, elements, resources), or None when the box is
    empty.  Raises on malformed input."""
    sm, ctm = sm_ctm
    g = pdf.resolve(sm.get("G"))
    if not hasattr(g, "decode") or not hasattr(g, "dict"):
        return None
    styp = pdf.resolve(sm.get("S"))
    alpha_kind = getattr(styp, "v", None) == "Alpha"
    bbox = [float(pdf.resolve(v)) for v in pdf.resolve(g.dict.get("BBox"))]
    mtx = PG._matrix_entry(pdf, g.dict)
    total = PG._mat_mul(tuple(float(v) for v in ctm), mtx)
    corners = [
        PG._apply(total, p)
        for p in (
            (bbox[0], bbox[1]), (bbox[2], bbox[1]),
            (bbox[2], bbox[3]), (bbox[0], bbox[3]),
        )
    ]
    ix0 = int(math.floor(min(p[0] for p in corners)))
    iy0 = int(math.floor(min(p[1] for p in corners)))
    ix1 = int(math.ceil(max(p[0] for p in corners)))
    iy1 = int(math.ceil(max(p[1] for p in corners)))
    if ix1 <= ix0 or iy1 <= iy0:
        return None
    ix1 = min(ix1, ix0 + _SMASK_MAX_DIM)
    iy1 = min(iy1, iy0 + _SMASK_MAX_DIM)
    res = pdf.resolve(g.dict.get("Resources")) or {}
    elements = PG._process(pdf, g.decode(), res, PG._GState(ctm=total))
    return alpha_kind, (ix0, iy0, ix1, iy1), elements, res


def softmask_fill(pdf, sm_ctm, base_fill, device):
    """Wrap `base_fill` in a MaskedFill sampling the rendered ExtGState
    /SMask group (PDF 11.6.5): the /G form renders through the normal
    pipeline on `device` at device resolution over its transformed /BBox;
    /S /Luminosity takes the over-black luminosity (709-ish integer
    weights), /S /Alpha the coverage.  BEYOND REFERENCE: the reference
    ignores gstate soft masks entirely.  A group that cannot be read or
    converted returns the unmasked fill (paint-everything, the /None
    behaviour); a failed sub-render raises SubRenderError."""
    try:
        got = _softmask_group(pdf, sm_ctm)
        if got is None:
            return base_fill
        alpha_kind, (ix0, iy0, ix1, iy1), elements, res = got
        _require_device(device, "a soft mask")
        scene = scene_of_graphic(pdf, PG.Graphic(elements, res), device)
        H = iy1 - iy0 + 1
        W = ix1 - ix0 + 1
        mask = np.zeros((H, W), dtype=np.int64)
        got = sub_render(
            list(reversed(scene)), (ix0, iy0, ix1, iy1), device, lambda spr: (spr.box, _host(spr.rgba))
        )
        if got is not None:
            (sx0, sy0, sx1, sy1), r4 = got
            r4 = r4.astype(np.int64)
            if alpha_kind:
                vals = r4[..., 3]
            else:
                # Premultiplied channels ARE the over-black composite.
                vals = (
                    77 * r4[..., 0] + 150 * r4[..., 1] + 29 * r4[..., 2]
                ) >> 8
            oy, ox = sy0 - iy0, sx0 - ix0
            h = min(vals.shape[0], H - oy)
            w = min(vals.shape[1], W - ox)
            if h > 0 and w > 0 and oy >= 0 and ox >= 0:
                mask[oy : oy + h, ox : ox + w] = vals[:h, :w]
        # MaskedFill row 0 = TOP (largest y): flip the render's row order.
        m = (float(ix1 - ix0 + 1), 0.0, 0.0, float(iy1 - iy0 + 1),
             float(ix0), float(iy0))
        return rfills.MaskedFill(base_fill, np.flipud(mask), m)
    except SubRenderError:
        raise
    except Exception:
        return base_fill


_FUNC_SHADING_SAMPLES = 128  # function-shading sample grid per side


def function_shading_quad(sh: PG.Shading):
    """Target-space corners of a type-1 shading's transformed domain."""
    k = sh.kind
    x0, x1, y0, y1 = k.domain
    m = PG._mat_mul(sh.matrix, k.matrix)
    a, b, c_, d, e, f_ = m
    return [
        (a * x + c_ * y + e, b * x + d * y + f_)
        for x, y in ((x0, y0), (x1, y0), (x1, y1), (x0, y1))
    ]


def fill_of_function_shading(sh: PG.Shading, transparency: float):
    """Function-based shadings (type 1): sample f(x, y) over the domain
    onto a texture painted as an ImageFill (the domain rect maps to target
    space through Matrix then the ctm/pattern matrix).  BEYOND REFERENCE:
    the reference drops every shading at render time."""
    k = sh.kind
    if not isinstance(k, PG.FunctionShadingK) or k.function is None:
        return None
    x0, x1, y0, y1 = k.domain
    if not (x1 > x0 and y1 > y0):
        return None
    n = _FUNC_SHADING_SAMPLES
    a8 = int(transparency * 255.0)
    tex = np.zeros((n, n, 4), dtype=np.int64)
    for r in range(n):  # row 0 = TOP of the domain (max y)
        y = y0 + (y1 - y0) * (1.0 - (r + 0.5) / n)
        for cix in range(n):
            x = x0 + (x1 - x0) * (cix + 0.5) / n
            try:
                comps = PG.eval_function(k.function, (x, y))
            except Exception:
                comps = None
            if not comps:
                continue
            rr, gg, bb = _rgb_of_components(sh.colourspace, comps, sh.cs_conv)
            tex[r, cix] = (
                (round(rr * 255) * a8 + 127) // 255,
                (round(gg * 255) * a8 + 127) // 255,
                (round(bb * 255) * a8 + 127) // 255,
                a8,
            )
    m = PG._mat_mul(
        PG._mat_mul(sh.matrix, k.matrix),
        (x1 - x0, 0.0, 0.0, y1 - y0, x0, y0),
    )
    return rfills.image_fill(tex, m)


def fill_of_shading_pattern(pat: PG.ShadingPattern, transparency: float):
    """Map an axial/radial shading pattern onto the renderer's gradient
    fills (fill.ml:77-140): endpoint colours come from the PDF function
    evaluated at the domain ends (exact for the common single Type-2
    linear function; stitched functions approximate by endpoints).
    Pattern-space coordinates transform by the pattern /Matrix.

    Concentric radials map onto the renderer's single-centre radial fill
    (fill.ml:111-140); a PDF radial whose start circle is offset (the
    'highlight' form) renders EXACTLY via the two-circle sweep
    RadialFill2 (beyond the reference, whose fill model cannot express
    it).  r0/r1 and both extend flags are honoured."""
    sh = pat.shading
    k = sh.kind
    if isinstance(k, PG.MeshShadingK):
        return fill_of_mesh(sh, transparency)
    if isinstance(k, PG.FunctionShadingK):
        return fill_of_function_shading(sh, transparency)
    if not isinstance(k, (PG.AxialShadingK, PG.RadialShadingK)):
        return None
    f = k.functions[0] if k.functions else None
    if f is None:
        return None
    v0 = PG.eval_function(f, k.domain[0])
    v1 = PG.eval_function(f, k.domain[1])
    c0 = _colour_of_components(sh.colourspace, v0, transparency, sh.cs_conv)
    c1 = _colour_of_components(sh.colourspace, v1, transparency, sh.cs_conv)
    m = sh.matrix

    def xf(x, y):
        a, b, c_, d, e, fz = m
        return (a * x + c_ * y + e, b * x + d * y + fz)

    if isinstance(k, PG.AxialShadingK):
        p0 = xf(k.coords[0], k.coords[1])
        p1 = xf(k.coords[2], k.coords[3])
        return rfills.gradient(p0, p1, k.extend[0], k.extend[1], c0, c1)
    x0, y0, r0, x1, y1, r1 = k.coords
    if math.hypot(x1 - x0, y1 - y0) > 1e-9:
        # Offset start circle (the 'highlight' form): exact two-circle
        # sweep (BEYOND REFERENCE — fill.ml's radial is concentric-only).
        return rfills.radial2(
            xf(x0, y0), xf(x0 + r0, y0), xf(x1, y1), xf(x1 + r1, y1),
            k.extend[0], k.extend[1], c0, c1,
        )
    c = xf(x1, y1)
    return rfills.radial(
        c, xf(x1 + r0, y1), xf(x1 + r1, y1), k.extend[0], k.extend[1], c0, c1
    )


def fill_of_tiling_pattern(pat: PG.TilingPattern, transparency: float, device):
    """Rasterize a tiling-pattern cell once and tile it as a texture fill
    (PDF 8.7.3).  BEYOND REFERENCE: the reference's ``read_tiling_pattern``
    is the stub ``Tiling`` (pdfgraphics.ml:598) and painting with one falls
    back to nothing; here the cell's parsed graphic renders through the real
    renderer on `device` into a premultiplied texture, read back once
    (``sub_render``).
    Uncoloured patterns (PaintType 2) tint the cell's coverage with the
    colour given at ``scn`` time.

    Returns None when the cell is empty/degenerate (caller falls back)."""
    if len(pat.bbox) != 4 or not pat.elements:
        return None
    bx0, by0, bx1, by1 = pat.bbox
    bw, bh = bx1 - bx0, by1 - by0
    if bw <= 0.0 or bh <= 0.0:
        return None
    # Texture resolution: the pattern matrix's device scale, clamped.
    a, b, c_, d, _, _ = pat.matrix
    sx = math.hypot(a, b) or 1.0
    sy = math.hypot(c_, d) or 1.0
    tw = int(min(512, max(1, round(bw * sx))))
    th = int(min(512, max(1, round(bh * sy))))

    _require_device(device, "a tiling pattern")
    # Cell scene: document order -> front-to-back, pattern space mapped to
    # the (1..tw, 1..th) raster box with y flipped into raster rows.
    objs = scene_of_graphic(None, PG.Graphic(list(pat.elements)), device)
    objs.reverse()
    cell_t = [
        tr.Translate(0.0, float(th)),
        tr.Scale((0.0, 0.0), 1.0, -1.0),
        tr.Scale((0.0, 0.0), tw / bw, th / bh),
        tr.Translate(-bx0, -by0),
    ]
    scene = [R.transform_renderobject_many(cell_t, o) for o in objs]

    def read(spr):
        canvas = region.flatten_sprite(0, spr, C.clear)
        return canvas.origin, _host(canvas.rgba)

    got = sub_render(scene, (1, 1, tw, th), device, read)
    tex = np.zeros((th, tw, 4), dtype=np.int64)
    if got is not None:
        (ox, oy), arr = got  # 1-based scene coords of arr[0, 0]
        r0, c0 = oy - 1, ox - 1
        ra, ca = max(0, r0), max(0, c0)
        rb = min(th, r0 + arr.shape[0])
        cb = min(tw, c0 + arr.shape[1])
        if rb > ra and cb > ca:
            tex[ra:rb, ca:cb] = arr[ra - r0 : rb - r0, ca - c0 : cb - c0]
    if not pat.coloured and pat.colour is not None:
        cs, vals = pat.colour
        col = np.array(
            C.rgba_of_colour(_packed_of_cs_vals(cs, vals)), dtype=np.int64
        )
        tex = rfills._dissolve_np(col, tex[..., 3:4])
    t = int(transparency * 255.0)
    if t < 255:
        tex = rfills._dissolve_np(tex, np.int64(t))
    xstep = pat.xstep or bw
    ystep = pat.ystep or bh
    return rfills.texture(tex, pat.bbox, xstep, ystep, pat.matrix)


def _packed_of_cs_vals(colourspace, vals) -> int:
    """Packed opaque colour from (colourspace, components)."""
    if colourspace == PG.DEVICE_RGB and len(vals) == 3:
        r, g, b = vals
    elif colourspace == PG.DEVICE_CMYK and len(vals) == 4:
        r, g, b = rgb_of_cmyk(*vals)
    elif colourspace == PG.DEVICE_GRAY and len(vals) == 1:
        r = g = b = vals[0]
    else:
        r = g = b = 0.5
    return C.colour_of_rgba_float(r, g, b, 1.0)


def _rgb_triple_of_cs_vals(colourspace, vals):
    """(r, g, b) floats from (colourspace, components)."""
    if colourspace == PG.DEVICE_RGB and len(vals) == 3:
        return tuple(float(v) for v in vals)
    if colourspace == PG.DEVICE_CMYK and len(vals) == 4:
        return rgb_of_cmyk(*vals)
    if colourspace == PG.DEVICE_GRAY and len(vals) == 1:
        g = float(vals[0])
        return (g, g, g)
    return (0.0, 0.0, 0.0)


def _quad_path(corners):
    """Closed even-odd path over 4 (x, y) corners."""
    return gshapes.Path(
        gshapes.EVEN_ODD,
        (
            gshapes.Subpath(
                False,
                True,
                tuple(
                    gshapes.Straight(corners[i], corners[(i + 1) % 4])
                    for i in range(4)
                ),
            ),
        ),
    )


def image_object_of_element(pdf, el, device):
    """Render-scene object painting a PDF image element, or None.

    BEYOND REFERENCE: the reference's scene_of_graphic drops Image /
    GraphicInlineImage elements (render.ml:1524-1565 consumes paths and
    clips only); here the samples decode (io/pdfimages) and paint through
    an ImageFill over the ctm-transformed unit square (PDF 8.9.5.2 image
    space).  Stencil masks paint the nonstroke colour captured at the Do/BI
    op; undecodable exotica fall back to the same gray placeholder the
    unsupported shading kinds use.  An ExtGState soft mask renders on
    `device` (``softmask_fill``)."""
    got = PI.image_stream_of_element(pdf, el)
    if got is None:
        return None
    d, raw = got
    if isinstance(el, PG.Image):
        m = el.attributes.image_transform
        transparency = el.attributes.image_transparency
        fill_cv = el.attributes.image_fill
    else:
        m = el.transform
        transparency = 1.0
        fill_cv = el.fill
    a, b, c_, d_, e, f_ = (float(v) for v in m)
    if abs(a * d_ - b * c_) < 1e-12:
        return None  # degenerate placement
    quad = _quad_path(
        [
            (a * x + c_ * y + e, b * x + d_ * y + f_)
            for x, y in ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
        ]
    )
    mask_fill = _rgb_triple_of_cs_vals(*fill_cv) if fill_cv else None
    try:
        tex = PI.rgba_of_image(pdf, d, raw, mask_fill=mask_fill)
    except Exception:
        return R.Obj(
            ident.new_ids(),
            R.Basic(rfills.plain(C.gray), R.PathShape(quad)),
            (),
            R.OVER,
        )
    t = int(float(transparency) * 255.0)
    if t < 255:
        tex = rfills._dissolve_np(tex, np.int64(t))
    fill = rfills.image_fill(tex, m)
    sm = getattr(el.attributes, "image_softmask", None) if isinstance(
        el, PG.Image
    ) else None
    if isinstance(sm, tuple) and len(sm) == 2:
        # ExtGState /SMask live at the Do op (distinct from the image's own
        # /SMask channel, folded into tex by rgba_of_image).
        fill = softmask_fill(pdf, sm, fill, device)
    return R.Obj(
        ident.new_ids(),
        R.Basic(fill, R.PathShape(quad)),
        (),
        R.OVER,
    )


def cap_of_pdfcap(c: int) -> str:
    return {0: gshapes.ButtCap, 1: gshapes.RoundCap, 2: gshapes.ProjectingCap}[c]


def join_of_pdfjoin(j: int) -> str:
    return {0: gshapes.MitredJoin, 1: gshapes.RoundJoin, 2: gshapes.BevelJoin}[j]


def scene_of_graphic(pdf, graphic: PG.Graphic, device=None):
    """Front-to-back scene from a graphic's elements (render.ml:1524-1565).
    Soft masks and tiling-pattern cells render on `device`, which a graphic
    holding either must name.

    Note the reference prepends line-then-fill per element and concatenates in
    element order; callers reverse for bottom-up stacking (examples.ml:163)."""

    def convert(elements, clips=()):
        out = []
        for el in elements:
            if isinstance(el, PG.GPath):
                a = el.attributes
                if a.path_line is not None:
                    cs, vals = a.path_line
                    fill = fill_of_pdf_colour(
                        vals, a.path_transparency.line_transparency, cs, device
                    )
                    if a.path_softmask is not None:
                        fill = softmask_fill(pdf, a.path_softmask, fill, device)
                    stroke_path = el.path
                    if a.path_dash[0]:
                        # Dash BEFORE stroking so each dash gets caps
                        # (BEYOND REFERENCE: pdfgraphics.mli:93 captures
                        # the dash but the reference strokes solid).
                        stroke_path = gdash.dash_path(
                            el.path, a.path_dash[0], a.path_dash[1]
                        )
                    spec = gshapes.StrokeSpec(
                        startcap=cap_of_pdfcap(a.path_capstyle),
                        join=join_of_pdfjoin(a.path_joinstyle),
                        endcap=cap_of_pdfcap(a.path_capstyle),
                        mitrelimit=a.path_mitrelimit,
                        linewidth=a.path_linewidth,
                    )
                    pb = _path_bbox(stroke_path)
                    if pb is not None:
                        # Mitre spikes reach mitrelimit·w/2 past a vertex;
                        # caps reach w·√2/2 — expand conservatively.
                        e = a.path_linewidth * max(1.0, a.path_mitrelimit)
                        pb = (pb[0] - e, pb[1] - e, pb[2] + e, pb[3] + e)
                    shape = clipped_shape(
                        R.StrokedPathShape(stroke_path, spec), clips, pb
                    )
                    out.append(
                        blend_wrap(
                            R.Obj(
                                ident.new_ids(),
                                R.Basic(fill, shape),
                                (),
                                R.OVER,
                            ),
                            getattr(a, "path_blend", "Normal"),
                        )
                    )
                if a.path_fill is not None:
                    cs, vals = a.path_fill
                    fill = fill_of_pdf_colour(
                        vals, a.path_transparency.fill_transparency, cs, device
                    )
                    if a.path_softmask is not None:
                        fill = softmask_fill(pdf, a.path_softmask, fill, device)
                    shape = clipped_shape(
                        R.PathShape(el.path), clips, _path_bbox(el.path)
                    )
                    out.append(
                        blend_wrap(
                            R.Obj(
                                ident.new_ids(),
                                R.Basic(fill, shape),
                                (),
                                R.OVER,
                            ),
                            getattr(a, "path_blend", "Normal"),
                        )
                    )
            elif isinstance(el, PG.TextBlock):
                # BEYOND REFERENCE: text paints via glyph outlines
                # (scene/pdftext.py); the reference drops TextBlocks here.
                from . import pdftext

                try:
                    out.extend(pdftext.text_objects_of_block(pdf, el, clips=clips, device=device))
                except SubRenderError:
                    raise
                except Exception:
                    pass  # unreadable font program: skip the run
            elif isinstance(el, PG.Clip):
                out.extend(convert(el.elements, clips + (el.path,)))
            elif isinstance(el, (PG.MCSection, PG.MCSectionProperties)):
                out.extend(convert(el.elements, clips))
            elif isinstance(el, (PG.Image, PG.GraphicInlineImage)):
                o = image_object_of_element(pdf, el, device)
                if o is not None:
                    if clips:
                        g = o.geometry  # always Basic here
                        pb = (
                            _path_bbox(g.shape.path)
                            if isinstance(g.shape, R.PathShape)
                            else None
                        )
                        o = R.Obj(
                            o.idset,
                            R.Basic(g.fill, clipped_shape(g.shape, clips, pb)),
                            o.transform,
                            o.compop,
                        )
                    mode = (
                        getattr(el.attributes, "image_blend", "Normal")
                        if isinstance(el, PG.Image)
                        else getattr(el, "blend", "Normal")
                    )
                    out.append(blend_wrap(o, mode))
            elif isinstance(el, PG.FormGroup):
                # Transparency group (PDF 11.6.6): members composite to ONE
                # sprite via Group geometry; the group alpha dissolves that
                # composite once (PreTrans), and a group blend mode blends
                # the composite as a unit.
                inner = convert(el.elements, clips)
                if inner:
                    objs = list(reversed(inner))  # front-to-back for Group
                    compop = (
                        R.PreTrans(float(el.ca), R.OVER)
                        if float(el.ca) < 1.0
                        else R.OVER
                    )
                    grp = R.Obj(ident.new_ids(), R.Group(objs), (), compop)
                    mode = getattr(el, "blend", "Normal")
                    if mode not in (None, "Normal", "Compatible"):
                        if float(el.ca) < 1.0:
                            # Filters ignore compop: fold the group alpha
                            # into each member instead (PDF-exact only for
                            # non-self-overlapping groups).
                            delta = int(float(el.ca) * 255.0)
                            objs = [
                                R.Obj(
                                    o.idset,
                                    R.Basic(
                                        o.geometry.fill.changecolour(
                                            lambda c: C.dissolve(c, delta=delta)
                                        ),
                                        o.geometry.shape,
                                    ),
                                    o.transform,
                                    o.compop,
                                )
                                if isinstance(o.geometry, R.Basic)
                                else o
                                for o in objs
                            ]
                            grp = R.Obj(ident.new_ids(), R.Group(objs), (), R.OVER)
                        grp = blend_wrap(grp, mode)
                    out.append(grp)
            elif isinstance(el, PG.TextClip):
                # Tr 4-7 (PDF 9.3.5): glyph outlines clip subsequent paint
                # until the enclosing grestore.  The block itself painted as
                # the preceding sibling.
                from . import pdftext

                try:
                    cp = pdftext.clip_path_of_block(pdf, el.block, device)
                except SubRenderError:
                    raise
                except Exception:
                    cp = None
                out.extend(
                    convert(el.elements, clips + ((cp,) if cp is not None else ()))
                )
            elif isinstance(el, PG.GShading):
                # `sh` paints the shading through the active clip (or its
                # /BBox).  The reference's scene_of_graphic drops these
                # (render.ml:1524-1565 consumes paths/clips only); here
                # axial/radial shadings become gradient-filled objects.
                fill = fill_of_shading_pattern(PG.ShadingPattern(el.shading), 1.0)
                geom_path = clips[-1] if clips else None
                outer_clips = clips[:-1] if clips else ()
                if geom_path is None and isinstance(el.shading.bbox, list) and len(el.shading.bbox) == 4:
                    # /BBox is in the shading's target space: map its corners
                    # through the ctm at the sh op (el.transform) so the
                    # painted quad lives in the same space as the clip paths
                    # (and as the gradient coords, which go through
                    # sh.matrix = that same ctm).
                    x0, y0, x1, y1 = (float(v) for v in el.shading.bbox)
                    a, b, c_, d_, e, f_ = el.transform
                    geom_path = _quad_path(
                        [
                            (a * x + c_ * y + e, b * x + d_ * y + f_)
                            for x, y in ((x0, y0), (x1, y0), (x1, y1), (x0, y1))
                        ]
                    )
                if geom_path is None and isinstance(el.shading.kind, PG.MeshShadingK):
                    # No clip and no /BBox: a mesh's natural extent is its
                    # transformed triangle bbox.
                    ext = mesh_extent(el.shading)
                    if ext is not None:
                        mx0, my0, mx1, my1 = ext
                        geom_path = _quad_path(
                            [(mx0, my0), (mx1, my0), (mx1, my1), (mx0, my1)]
                        )
                if geom_path is None and isinstance(
                    el.shading.kind, PG.FunctionShadingK
                ):
                    # Type 1 paints its transformed domain rect.
                    geom_path = _quad_path(function_shading_quad(el.shading))
                if fill is not None and geom_path is not None:
                    shape = clipped_shape(
                        R.PathShape(geom_path), outer_clips, _path_bbox(geom_path)
                    )
                    out.append(
                        blend_wrap(
                            R.Obj(
                                ident.new_ids(),
                                R.Basic(fill, shape),
                                (),
                                R.OVER,
                            ),
                            getattr(el, "blend", "Normal"),
                        )
                    )
        return out

    return convert(graphic.elements)
