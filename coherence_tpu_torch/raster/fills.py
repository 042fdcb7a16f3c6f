"""Plain and graduated fills (parity: reference ``fill.ml``).

The PyTorch counterpart of ``coherence_tpu.raster.fills``, whole.  Every
fill computes its colour plane on the host, in numpy float64 and int64 with
the reference's roundings, exactly as the JAX package does; only the int32
result is uploaded (``image_device``, which takes the device).

A Fill provides:
  * ``kind``       — PLAIN fills are translation-invariant, FANCY are not
                     (fill.ml:26); drives the dirty-region logic.
  * ``image(box, H, W)`` — the (H, W, 4) int32 premultiplied colour plane for
                     the (H, W) pixel grid that starts at ``box``'s corner; this is the
                     vectorized ``fillspan`` (fill.ml:44).  Computed on the
                     host in float64 for bit-parity with the reference's
                     OCaml doubles, then cached in rendered sprites.
  * ``single(x, y)`` — ``fillsingle`` (fill.ml:43), one packed colour.
  * ``transform(t)`` — ``filltransform`` (fill.ml:45).
  * ``changecolour(f)`` — ``fillchangecolour`` (fill.ml:46).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .. import colour as C
from .. import transform as tr

PLAIN = "plain"
FANCY = "fancy"


# --- exact integer colour helpers on numpy arrays ---------------------------


def _div255_np(i):
    return (i + (i >> 8) + 1) >> 8


def _dissolve_np(col: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """col: (..., 4) int64; delta broadcastable with trailing 1 axis."""
    scaled = _div255_np(col * delta)
    return np.where(delta == 0, 0, np.where(delta == 255, col, scaled))


def _dissolve_between_np(a, b, alpha):
    """alpha: (..., 1) int64; a, b: (4,) or broadcastable."""
    mixed = _dissolve_np(a, alpha) + _dissolve_np(b, 255 - alpha)
    return np.where(alpha == 0, b, np.where(alpha == 255, a, mixed))


def _grid(box, H: int, W: int):
    x0, y0, _, _ = box
    ys = (y0 + np.arange(H, dtype=np.int64))[:, None]
    xs = (x0 + np.arange(W, dtype=np.int64))[None, :]
    return xs.astype(np.float64), ys.astype(np.float64)


class Fill:
    kind = PLAIN

    def image(self, box, H: int, W: int) -> np.ndarray:
        raise NotImplementedError

    def image_device(self, box, H: int, W: int, device) -> torch.Tensor:
        """The int32 colour plane as a tensor on `device`, broadcastable to
        (H, W, 4).  The default uploads the host plane; constant fills
        return a memoized (1, 1, 4) vector instead, so no per-object plane
        ever crosses the host->device link."""
        return torch.from_numpy(np.ascontiguousarray(self.image(box, H, W), dtype=np.int32)).to(device)

    def single(self, x: int, y: int) -> int:
        raise NotImplementedError

    def transform(self, t) -> "Fill":
        return self

    def changecolour(self, f: Callable[[int], int]) -> "Fill":
        return self


# (colour, device) -> (1, 1, 4) vector, shared by every PlainFill instance.
_DEV_CONST_CACHE: dict = {}


class PlainFill(Fill):
    """fill.ml:62-67."""

    kind = PLAIN

    def __init__(self, colour: int):
        self.colour = colour
        self._rgba = np.array(C.rgba_of_colour(colour), dtype=np.int32)

    def image(self, box, H, W):
        return np.broadcast_to(self._rgba, (H, W, 4))

    def image_device(self, box, H, W, device):
        # A constant plane: a memoized (1, 1, 4) vector that the consumer
        # broadcasts, instead of H*W*16 bytes per object.
        key = (self.colour, str(device))
        v = _DEV_CONST_CACHE.get(key)
        if v is None:
            v = torch.from_numpy(self._rgba.reshape(1, 1, 4).copy()).to(device)
            _DEV_CONST_CACHE[key] = v
        return v

    def single(self, x, y):
        return self.colour

    def transform(self, t):
        return self

    def changecolour(self, f):
        return PlainFill(f(self.colour))

    def __repr__(self):
        return f"PlainFill({C.rgba_of_colour(self.colour)})"


def plain(colour: int) -> PlainFill:
    return PlainFill(colour)


# Dummy fills (fill.ml:49-57).
dummy = plain(C.clear)


class _DummyFancy(PlainFill):
    kind = FANCY


dummyfancy = _DummyFancy(C.clear)


class GradientFill(Fill):
    """Axial gradient, PDF style with extend flags (fill.ml:77-107)."""

    kind = FANCY

    def __init__(self, p0, p1, ext_s: bool, ext_e: bool, cs: int, ce: int):
        self.p0, self.p1 = tuple(p0), tuple(p1)
        self.ext_s, self.ext_e = ext_s, ext_e
        self.cs, self.ce = cs, ce

    def _alphas(self, xs, ys):
        """Returns (region, alpha): region 0=start-ext,1=mid,2=end-ext;
        alpha for the mid region."""
        (x0, y0), (x1, y1) = self.p0, self.p1
        bottom = (x1 - x0) ** 2 + (y1 - y0) ** 2
        xp = ((x1 - x0) * (xs - x0) + (y1 - y0) * (ys - y0)) / bottom
        alpha = 255 - np.trunc(xp * 255.0).astype(np.int64)
        return xp, alpha

    def image(self, box, H, W):
        (x0, y0), (x1, y1) = self.p0, self.p1
        if (x0, y0) == (x1, y1):
            return np.zeros((H, W, 4), dtype=np.int32)
        xs, ys = _grid(box, H, W)
        xp, alpha = self._alphas(xs, ys)
        cs = np.array(C.rgba_of_colour(self.cs), dtype=np.int64)
        ce = np.array(C.rgba_of_colour(self.ce), dtype=np.int64)
        mid = _dissolve_between_np(cs, ce, alpha[..., None])
        out = np.where(
            (xp < 0.0)[..., None],
            cs if self.ext_s else 0,
            np.where((xp > 1.0)[..., None], ce if self.ext_e else 0, mid),
        )
        return out.astype(np.int32)

    def single(self, x, y):
        img = self.image((x, y, x, y), 1, 1)[0, 0]
        return C.colour_of_rgba(*(int(v) for v in img))

    def transform(self, t):
        f = lambda p: tr.transform(t, p)
        return GradientFill(f(self.p0), f(self.p1), self.ext_s, self.ext_e, self.cs, self.ce)

    def changecolour(self, f):
        return GradientFill(self.p0, self.p1, self.ext_s, self.ext_e, f(self.cs), f(self.ce))


def gradient(p0, p1, ext_s, ext_e, cs, ce) -> GradientFill:
    return GradientFill(p0, p1, ext_s, ext_e, cs, ce)


class RadialFill(Fill):
    """Radial gradient (fill.ml:112-140)."""

    kind = FANCY

    def __init__(self, c, p, p2, ext_s: bool, ext_e: bool, cs: int, ce: int):
        self.c, self.p, self.p2 = tuple(c), tuple(p), tuple(p2)
        self.ext_s, self.ext_e = ext_s, ext_e
        self.cs, self.ce = cs, ce

    def image(self, box, H, W):
        cx, cy = self.c
        r = math.dist(self.c, self.p)
        r2 = math.dist(self.c, self.p2)
        diff = r2 - r
        xs, ys = _grid(box, H, W)
        d = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
        cs = np.array(C.rgba_of_colour(self.cs), dtype=np.int64)
        ce = np.array(C.rgba_of_colour(self.ce), dtype=np.int64)
        if diff == 0.0:
            mid = np.broadcast_to(cs, (H, W, 4))
        else:
            t = (d - r) / diff
            alpha = (255 - np.trunc(t * 255.0).astype(np.int64))[..., None]
            mid = _dissolve_between_np(cs, ce, alpha)
        out = np.where(
            (d > r2)[..., None],
            ce if self.ext_e else 0,
            np.where((d < r)[..., None], cs if self.ext_s else 0, mid),
        )
        return out.astype(np.int32)

    def single(self, x, y):
        img = self.image((x, y, x, y), 1, 1)[0, 0]
        return C.colour_of_rgba(*(int(v) for v in img))

    def transform(self, t):
        f = lambda p: tr.transform(t, p)
        return RadialFill(
            f(self.c), f(self.p), f(self.p2), self.ext_s, self.ext_e, self.cs, self.ce
        )

    def changecolour(self, f):
        return RadialFill(self.c, self.p, self.p2, self.ext_s, self.ext_e, f(self.cs), f(self.ce))


def radial(c, p, p2, ext_s, ext_e, cs, ce) -> RadialFill:
    return RadialFill(c, p, p2, ext_s, ext_e, cs, ce)


class RadialFill2(Fill):
    """Two-circle radial gradient (PDF 8.7.4.5.4) — BEYOND REFERENCE: the
    reference's radial fill (fill.ml:112-140) has a single centre, so PDF
    radials whose start circle is offset (the 'highlight' form) cannot be
    expressed there.  For each pixel the largest s with
    |p - c(s)| = r(s), c(s) = c0 + s*(c1 - c0), r(s) = r0 + s*(r1 - r0)
    selects the colour; s outside [0, 1] honours the extend flags (outside
    both -> transparent).  Colour mixing uses the same integer
    dissolve_between as the axial fill."""

    kind = FANCY

    def __init__(self, c0, r0p, c1, r1p, ext_s: bool, ext_e: bool, cs: int, ce: int):
        # Circles carried as centre + a point on the rim (so affine
        # transforms compose by transforming points, like RadialFill).
        self.c0, self.r0p = tuple(c0), tuple(r0p)
        self.c1, self.r1p = tuple(c1), tuple(r1p)
        self.ext_s, self.ext_e = ext_s, ext_e
        self.cs, self.ce = cs, ce

    def image(self, box, H, W):
        x0, y0 = self.c0
        x1, y1 = self.c1
        r0 = math.dist(self.c0, self.r0p)
        r1 = math.dist(self.c1, self.r1p)
        xs, ys = _grid(box, H, W)
        dcx, dcy, dr = x1 - x0, y1 - y0, r1 - r0
        ex, ey = xs - x0, ys - y0
        a = dcx * dcx + dcy * dcy - dr * dr
        b = ex * dcx + ey * dcy + r0 * dr
        c = ex * ex + ey * ey - r0 * r0
        smin = -np.inf if self.ext_s else 0.0
        smax = np.inf if self.ext_e else 1.0

        def usable(s):
            return np.isfinite(s) & (r0 + s * dr >= 0.0) & (s >= smin) & (s <= smax)

        with np.errstate(invalid="ignore", divide="ignore"):
            if abs(a) < 1e-12:
                s = np.where(np.abs(b) > 1e-12, c / (2.0 * b), np.nan)
                s = np.where(usable(s), s, np.nan)
            else:
                disc = b * b - a * c
                sq = np.sqrt(np.maximum(disc, 0.0))
                s_hi = (b + sq) / a
                s_lo = (b - sq) / a
                # Circles paint start -> end, later on top: take the LARGEST
                # usable root (PDF 8.7.4.5.4).
                s_big = np.where(a > 0, s_hi, s_lo)
                s_small = np.where(a > 0, s_lo, s_hi)
                s = np.where(
                    usable(s_big), s_big, np.where(usable(s_small), s_small, np.nan)
                )
                s = np.where(disc < 0.0, np.nan, s)
        valid = np.isfinite(s)
        cs_ = np.array(C.rgba_of_colour(self.cs), dtype=np.int64)
        ce_ = np.array(C.rgba_of_colour(self.ce), dtype=np.int64)
        s_c = np.where(valid, s, 0.0)
        alpha = (255 - np.trunc(np.clip(s_c, 0.0, 1.0) * 255.0).astype(np.int64))[..., None]
        mid = _dissolve_between_np(cs_, ce_, alpha)
        out = np.where(
            (~valid)[..., None],
            0,
            np.where(
                (s_c < 0.0)[..., None],
                cs_,
                np.where((s_c > 1.0)[..., None], ce_, mid),
            ),
        )
        return out.astype(np.int32)

    def single(self, x, y):
        img = self.image((x, y, x, y), 1, 1)[0, 0]
        return C.colour_of_rgba(*(int(v) for v in img))

    def transform(self, t):
        f = lambda p: tr.transform(t, p)
        return RadialFill2(
            f(self.c0), f(self.r0p), f(self.c1), f(self.r1p),
            self.ext_s, self.ext_e, self.cs, self.ce,
        )

    def changecolour(self, f):
        return RadialFill2(
            self.c0, self.r0p, self.c1, self.r1p,
            self.ext_s, self.ext_e, f(self.cs), f(self.ce),
        )


def radial2(c0, r0p, c1, r1p, ext_s, ext_e, cs, ce) -> RadialFill2:
    return RadialFill2(c0, r0p, c1, r1p, ext_s, ext_e, cs, ce)


def _changecolour_tex(tex: np.ndarray, f) -> np.ndarray:
    """Map a packed-colour function over a premultiplied RGBA texel plane
    (shared by TextureFill/ImageFill): per distinct texel, not per pixel."""
    th, tw = tex.shape[:2]
    flat = tex.reshape(-1, 4)
    keys = (flat[:, 0] << 24) | (flat[:, 1] << 16) | (flat[:, 2] << 8) | flat[:, 3]
    uniq, inverse = np.unique(keys, return_inverse=True)
    lut = np.empty((len(uniq), 4), dtype=np.int64)
    for i, k in enumerate(uniq):
        rgba = (int(k >> 24) & 255, int(k >> 16) & 255, int(k >> 8) & 255, int(k) & 255)
        lut[i] = C.rgba_of_colour(f(C.colour_of_rgba(*rgba)))
    return lut[inverse].reshape(th, tw, 4)


class TextureFill(Fill):
    """Repeating texture fill for PDF tiling patterns.  BEYOND REFERENCE:
    ``fill.ml`` has no texture kind (the reference's tiling patterns are the
    stub ``Tiling``, pdfgraphics.ml:598); scene/pdfscene rasterizes the
    pattern cell once and tiles it here.

    ``tex`` is a premultiplied int32 (th, tw, 4) plane of one cell, texel
    row 0 covering the TOP of the pattern /BBox (max pattern y).  ``matrix``
    maps pattern space to the fill's target space and composes under
    ``transform`` exactly like the gradient fills' endpoints do.  Sampling
    is nearest-texel at the pixel grid of ``image``; pixels that land in the
    gap between tiles (|XStep| > BBox width) are transparent."""

    kind = FANCY

    def __init__(self, tex, bbox, xstep: float, ystep: float, matrix):
        self.tex = np.ascontiguousarray(np.asarray(tex, dtype=np.int64))
        self.bbox = tuple(float(v) for v in bbox)
        self.xstep = float(xstep)
        self.ystep = float(ystep)
        self.matrix = tuple(float(v) for v in matrix)

    def image(self, box, H, W):
        th, tw = self.tex.shape[:2]
        bx0, by0, bx1, by1 = self.bbox
        bw, bh = bx1 - bx0, by1 - by0
        if bw <= 0.0 or bh <= 0.0:
            return np.zeros((H, W, 4), dtype=np.int32)
        xs, ys = _grid(box, H, W)
        a, b, c, d, e, f = tr.invert_matrix(self.matrix)
        px = a * xs + c * ys + e
        py = b * xs + d * ys + f
        u = np.mod(px - bx0, abs(self.xstep) or bw)
        v = np.mod(py - by0, abs(self.ystep) or bh)
        inside = (u < bw) & (v < bh)
        iu = np.clip((u * (tw / bw)).astype(np.int64), 0, tw - 1)
        iv = np.clip((v * (th / bh)).astype(np.int64), 0, th - 1)
        out = self.tex[th - 1 - iv, iu]
        return np.where(inside[..., None], out, 0).astype(np.int32)

    def single(self, x, y):
        img = self.image((x, y, x, y), 1, 1)[0, 0]
        return C.colour_of_rgba(*(int(v) for v in img))

    def transform(self, t):
        m = tr.matmul(tr.matrix_of_transform(t), self.matrix)
        return TextureFill(self.tex, self.bbox, self.xstep, self.ystep, m)

    def changecolour(self, f):
        return TextureFill(
            _changecolour_tex(self.tex, f),
            self.bbox, self.xstep, self.ystep, self.matrix,
        )


def texture(tex, bbox, xstep, ystep, matrix) -> TextureFill:
    return TextureFill(tex, bbox, xstep, ystep, matrix)


class ImageFill(Fill):
    """One-shot image fill for PDF image XObjects.  BEYOND REFERENCE:
    ``fill.ml`` has no image kind and the reference drops Image elements at
    scene conversion (render.ml:1524-1565); scene/pdfscene decodes them
    (io/pdfimages) and paints through this fill.

    ``tex`` is a premultiplied int64 (th, tw, 4) plane, row 0 = the image's
    TOP sample row.  ``matrix`` maps image space — the unit square, (0, 0)
    at the bottom-left per PDF 8.9.5.2 — to the fill's target space, and
    composes under ``transform`` exactly like TextureFill's.  Sampling is
    nearest-texel; outside the unit square is transparent (the clip path /
    placement quad normally bounds the fill exactly)."""

    kind = FANCY

    def __init__(self, tex, matrix):
        self.tex = np.ascontiguousarray(np.asarray(tex, dtype=np.int64))
        self.matrix = tuple(float(v) for v in matrix)

    def image(self, box, H, W):
        th, tw = self.tex.shape[:2]
        xs, ys = _grid(box, H, W)
        a, b, c, d, e, f = tr.invert_matrix(self.matrix)
        u = a * xs + c * ys + e
        v = b * xs + d * ys + f
        inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        iu = np.clip((u * tw).astype(np.int64), 0, tw - 1)
        iv = np.clip((v * th).astype(np.int64), 0, th - 1)
        out = self.tex[th - 1 - iv, iu]  # v grows upward; row 0 is the top
        return np.where(inside[..., None], out, 0).astype(np.int32)

    def single(self, x, y):
        img = self.image((x, y, x, y), 1, 1)[0, 0]
        return C.colour_of_rgba(*(int(v) for v in img))

    def transform(self, t):
        m = tr.matmul(tr.matrix_of_transform(t), self.matrix)
        return ImageFill(self.tex, m)

    def changecolour(self, f):
        return ImageFill(_changecolour_tex(self.tex, f), self.matrix)


def image_fill(tex, matrix) -> ImageFill:
    return ImageFill(tex, matrix)


class MaskedFill(Fill):
    """A fill modulated per-pixel by a soft mask (PDF 11.6.5 ExtGState
    /SMask) — BEYOND REFERENCE: fill.ml has no masking and the reference
    ignores the gstate soft mask entirely.

    ``mask`` is an int (mh, mw) plane of 0..255 coverage, row 0 = TOP;
    ``matrix`` maps the unit square onto the mask's target-space quad
    exactly like ImageFill's.  Outside the quad the mask is 0 (nothing
    paints), per the /Luminosity backdrop-black rule."""

    kind = FANCY

    def __init__(self, base: Fill, mask, matrix):
        self.base = base
        self.mask = np.ascontiguousarray(np.asarray(mask, dtype=np.int64))
        self.matrix = tuple(float(v) for v in matrix)

    def image(self, box, H, W):
        img = self.base.image(box, H, W).astype(np.int64)
        if img.ndim != 3:  # constant plane from a plain base: broadcast
            img = np.broadcast_to(np.asarray(img).reshape(1, 1, 4), (H, W, 4))
        mh, mw = self.mask.shape
        xs, ys = _grid(box, H, W)
        a, b, c, d, e, f = tr.invert_matrix(self.matrix)
        u = a * xs + c * ys + e
        v = b * xs + d * ys + f
        inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        iu = np.clip((u * mw).astype(np.int64), 0, mw - 1)
        iv = np.clip((v * mh).astype(np.int64), 0, mh - 1)
        m = np.where(inside, self.mask[mh - 1 - iv, iu], 0)
        return ((img * m[..., None] + 127) // 255).astype(np.int32)

    def single(self, x, y):
        img = self.image((x, y, x, y), 1, 1)[0, 0]
        return C.colour_of_rgba(*(int(v) for v in img))

    def transform(self, t):
        m = tr.matmul(tr.matrix_of_transform(t), self.matrix)
        return MaskedFill(self.base.transform(t), self.mask, m)

    def changecolour(self, f):
        return MaskedFill(self.base.changecolour(f), self.mask, self.matrix)
