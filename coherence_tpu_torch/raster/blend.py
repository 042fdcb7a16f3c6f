"""PDF blend modes (PDF 32000-1 §11.3.5) as caf compositing operators.

The PyTorch counterpart of ``coherence_tpu.raster.blend``, whole.

BEYOND REFERENCE: the reference composites with Porter/Duff ``over`` only
(colour.ml:310-328) and ignores ExtGState /BM.  Here every standard
separable and non-separable blend mode paints: ``scene/filters.blendmode``
wraps an object's geometry in a filter whose raster combine is one of the
``pdfblend_<Mode>`` operators registered below, so the blend itself runs
inside caf (raster/region.py).

Conventions
-----------
Blend functions take/return **un-premultiplied** int32 channel arrays in
[0, 255] (``cb`` = backdrop, ``cs`` = source, shape ``(..., 3)``).  Integer
modes use the exact ``div255`` of ``colour`` so e.g. Multiply is
bit-stable; the float modes (SoftLight and the non-separable four) compute
in float32 over [0, 1] and round to nearest.  Dodge/Burn quotients round
half-up, with the PDF 2.0 boundary clarifications (ColorDodge(0, 1) = 0,
ColorBurn(1, 0) = 1).

The registered caf op computes the full-coverage mix
``M = (1 - ab)·Cs + ab·B(Cb, Cs)`` (premultiplied inputs are
un-premultiplied per pixel) and returns it **opaque**: the filter pipeline's
``blend_prime`` (scene/render.py) then lerps M against the backdrop by
the object's own rasterized alpha, which yields exactly the PDF composite
``C = (1 - as)·Cb + as·M``.
"""

from __future__ import annotations

import torch

from .. import colour as C

# ---------------------------------------------------------------------------
# Separable modes (PDF 32000-1 table 136) — exact integer where possible
# ---------------------------------------------------------------------------


def _multiply(cb, cs):
    return C.div255_arr(cb * cs)


def _screen(cb, cs):
    return cb + cs - C.div255_arr(cb * cs)


def _darken(cb, cs):
    return torch.minimum(cb, cs)


def _lighten(cb, cs):
    return torch.maximum(cb, cs)


def _difference(cb, cs):
    return torch.abs(cb - cs)


def _exclusion(cb, cs):
    # One rounded division of the doubled product (2·div255 would compound
    # the rounding to ~2 LSB; 2·cb·cs exceeds div255_arr's exact window).
    return cb + cs - (2 * cb * cs + 127) // 255


def _hardlight(cb, cs):
    lo = C.div255_arr(cb * (2 * cs))  # cs <= 127: Multiply(cb, 2*cs)
    s = 2 * cs - 255  # cs >= 128: Screen(cb, 2*cs - 1)
    hi = cb + s - C.div255_arr(cb * s)
    return torch.where(cs <= 127, lo, hi)


def _overlay(cb, cs):
    return _hardlight(cs, cb)


def _colordodge(cb, cs):
    denom = torch.clamp(255 - cs, min=1)
    q = torch.clamp((cb * 255 + denom // 2) // denom, max=255)
    out = torch.where(cs == 255, 255, q)
    return torch.where(cb == 0, 0, out)


def _colorburn(cb, cs):
    denom = torch.clamp(cs, min=1)
    q = torch.clamp(((255 - cb) * 255 + denom // 2) // denom, max=255)
    out = torch.where(cs == 0, 0, 255 - q)
    return torch.where(cb == 255, 255, out)


def _softlight(cb, cs):
    x = cb.to(torch.float32) / 255.0
    y = cs.to(torch.float32) / 255.0
    d = torch.where(x <= 0.25, ((16.0 * x - 12.0) * x + 4.0) * x, torch.sqrt(x))
    lo = x - (1.0 - 2.0 * y) * x * (1.0 - x)
    hi = x + (2.0 * y - 1.0) * (d - x)
    return _round255(torch.where(y <= 0.5, lo, hi))


def _round255(f):
    return torch.clamp(torch.round(f * 255.0), 0, 255).to(torch.int32)


# ---------------------------------------------------------------------------
# Non-separable modes (PDF 32000-1 §11.3.5.3) — float32 over [0, 1]
# ---------------------------------------------------------------------------

_LUM_W = (0.3, 0.59, 0.11)


def _lum(c):
    return _LUM_W[0] * c[..., 0] + _LUM_W[1] * c[..., 1] + _LUM_W[2] * c[..., 2]


def _clipcolor(c):
    l = _lum(c)[..., None]
    n = c.amin(dim=-1, keepdim=True)
    x = c.amax(dim=-1, keepdim=True)
    c1 = torch.where(n < 0.0, l + (c - l) * l / torch.clamp(l - n, min=1e-12), c)
    return torch.where(x > 1.0, l + (c1 - l) * (1.0 - l) / torch.clamp(x - l, min=1e-12), c1)


def _setlum(c, l):
    return _clipcolor(c + (l - _lum(c))[..., None])


def _sat(c):
    return c.amax(dim=-1) - c.amin(dim=-1)


def _setsat(c, s):
    mn = c.amin(dim=-1, keepdim=True)
    rng = c.amax(dim=-1, keepdim=True) - mn
    # min channel -> 0, max -> s, mid scaled proportionally (one formula
    # covers all three cases); flat input -> all 0 per the spec.
    return torch.where(rng > 0.0, (c - mn) * s[..., None] / torch.clamp(rng, min=1e-12), 0.0)


def _nonsep(fn):
    def blend(cb, cs):
        x = cb.to(torch.float32) / 255.0
        y = cs.to(torch.float32) / 255.0
        return _round255(fn(x, y))

    return blend


_hue = _nonsep(lambda cb, cs: _setlum(_setsat(cs, _sat(cb)), _lum(cb)))
_saturation = _nonsep(lambda cb, cs: _setlum(_setsat(cb, _sat(cs)), _lum(cb)))
_color = _nonsep(lambda cb, cs: _setlum(cs, _lum(cb)))
_luminosity = _nonsep(lambda cb, cs: _setlum(cb, _lum(cs)))


BLEND_MODES = {
    "Multiply": _multiply,
    "Screen": _screen,
    "Overlay": _overlay,
    "Darken": _darken,
    "Lighten": _lighten,
    "ColorDodge": _colordodge,
    "ColorBurn": _colorburn,
    "HardLight": _hardlight,
    "SoftLight": _softlight,
    "Difference": _difference,
    "Exclusion": _exclusion,
    "Hue": _hue,
    "Saturation": _saturation,
    "Color": _color,
    "Luminosity": _luminosity,
}


# ---------------------------------------------------------------------------
# caf operator: full-coverage mix of premultiplied source over backdrop
# ---------------------------------------------------------------------------


def _unpremul(rgb, a):
    # Premul invariant keeps rgb <= a, so the half-up quotient is <= 255
    # except for the rounding carry — clip it.
    q = torch.clamp((rgb * 255 + a // 2) // torch.clamp(a, min=1), max=255)
    return torch.where(a > 0, q, 0)


def _mix_op(blendfn):
    def op(a, b):
        """a = source sprite (premul), b = backdrop (premul, possibly
        transparent).  Returns the opaque full-coverage mix M."""
        asrc = a[..., 3:4]
        ab = b[..., 3:4]
        cs = _unpremul(a[..., :3], asrc)
        cb = _unpremul(b[..., :3], ab)
        m = C.div255_arr((255 - ab) * cs + ab * blendfn(cb, cs))
        return torch.cat([m, torch.full_like(m[..., :1], 255)], dim=-1)

    return op


def register_blend_ops():
    from . import region

    for name, fn in BLEND_MODES.items():
        region.register_caf_op("pdfblend_" + name, _mix_op(fn))


register_blend_ops()
