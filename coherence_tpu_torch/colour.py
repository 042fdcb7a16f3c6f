"""Colours: premultiplied RGBA with exact 8-bit integer compositing arithmetic.

The PyTorch counterpart of ``coherence_tpu.colour``.  Scalar colours are the
reference's 31-bit "pyramid" packed ints (``colour.ml:28-132``); tensor
colours are ``int32`` RGBA channel tensors of shape ``(..., 4)`` with values
0..255, premultiplied.  Every tensor function uses the same integer
arithmetic (``div255``, ``prelerp``) as the scalar one, so results are
bit-identical per channel (``colour.ml:284-361``).
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# 31-bit pyramid packing (ref colour.ml:66-132)
# ---------------------------------------------------------------------------

_MASK_EQUALITY = 0b1000000000000000000000000000000
_MASK_R_LSB = 0b0100000000000000000000000000000
_MASK_G_LSB = 0b0010000000000000000000000000000
_MASK_CH3 = 0b0001111111000000000000000000000
_MASK_CH2 = 0b0000000000111111100000000000000
_MASK_CH1 = 0b0000000000000000011111110000000
_MASK_CH0 = 0b0000000000000000000000001111111
_MASK_B_LSB = 0b0001000000000000000000000000000
_MASK_A_LSB = 0b0000100000000000000000000000000
_MASK_R_EQ_A = 0b0000010000000000000000000000000
_MASK_G_EQ_A = 0b0000001000000000000000000000000
_MASK_B_EQ_A = 0b0000000100000000000000000000000


def _concat(r: int, g: int, b: int, a: int) -> int:
    return (r << 21) | (g << 14) | (b << 7) | a


def _index_max4(a: int, b: int, c: int, d: int) -> int:
    if a > b:
        if c > d:
            return 0 if a > c else 2
        return 0 if a > d else 3
    if c > d:
        return 1 if b > c else 2
    return 1 if b > d else 3


def colour_of_rgba(r: int, g: int, b: int, a: int) -> int:
    """Pack premultiplied (r, g, b, a), each 0..255, into a 31-bit int."""
    r_lsb, g_lsb, b_lsb, a_lsb = r & 1, g & 1, b & 1, a & 1
    r, g, b, a = r >> 1, g >> 1, b >> 1, a >> 1
    if r != a and g != a and b != a:
        out = (_MASK_R_LSB if r_lsb else 0) | (_MASK_G_LSB if g_lsb else 0)
        if b_lsb:
            out |= _concat(r, g, b, a) if a_lsb else _concat(r, g, a, b)
        else:
            out |= _concat(r, a, b, g) if a_lsb else _concat(a, g, b, r)
        return out
    out = _MASK_EQUALITY
    if r_lsb:
        out |= _MASK_R_LSB
    if g_lsb:
        out |= _MASK_G_LSB
    if b_lsb:
        out |= _MASK_B_LSB
    if a_lsb:
        out |= _MASK_A_LSB
    if r == a:
        out |= _MASK_R_EQ_A | _concat(0, g, b, a)
    elif g == a:
        out |= _MASK_G_EQ_A | _concat(0, r, b, a)
    else:
        out |= _MASK_B_EQ_A | _concat(0, r, g, a)
    return out


def _unsplit(i: int, lsb: int) -> int:
    return (i << 1) | (1 if lsb else 0)


def rgba_of_colour(c: int) -> tuple[int, int, int, int]:
    """Unpack a colour int to (r, g, b, a)."""
    r_lsb = 1 if (c & _MASK_R_LSB) else 0
    g_lsb = 1 if (c & _MASK_G_LSB) else 0
    ch3 = (c & _MASK_CH3) >> 21
    ch2 = (c & _MASK_CH2) >> 14
    ch1 = (c & _MASK_CH1) >> 7
    ch0 = c & _MASK_CH0
    if (c & _MASK_EQUALITY) == 0:
        idx = _index_max4(ch3, ch2, ch1, ch0)
        if idx == 3:
            b_lsb, a_lsb, r, g, b, a = 1, 1, ch3, ch2, ch1, ch0
        elif idx == 2:
            b_lsb, a_lsb, r, g, a, b = 1, 0, ch3, ch2, ch1, ch0
        elif idx == 1:
            b_lsb, a_lsb, r, a, b, g = 0, 1, ch3, ch2, ch1, ch0
        else:
            b_lsb, a_lsb, a, g, b, r = 0, 0, ch3, ch2, ch1, ch0
    else:
        b_lsb = 1 if (c & _MASK_B_LSB) else 0
        a_lsb = 1 if (c & _MASK_A_LSB) else 0
        a = ch0
        if c & _MASK_R_EQ_A:
            r, g, b = a, ch2, ch1
        elif c & _MASK_G_EQ_A:
            g, r, b = a, ch2, ch1
        else:
            b, r, g = a, ch2, ch1
    return (
        _unsplit(r, r_lsb),
        _unsplit(g, g_lsb),
        _unsplit(b, b_lsb),
        _unsplit(a, a_lsb),
    )


def colour_of_rgba_float(r: float, g: float, b: float, a: float) -> int:
    """ref colour.ml:247-251: each channel is int_of_float (x * 255)."""
    if not all(0.0 <= v <= 1.0 for v in (r, g, b, a)):
        raise ValueError(f"colour channel outside [0, 1]: {(r, g, b, a)}")
    return colour_of_rgba(int(r * 255.0), int(g * 255.0), int(b * 255.0), int(a * 255.0))


def alpha_of_colour(c: int) -> int:
    return rgba_of_colour(c)[3]


class Nocover(Exception):
    """Poison compositor exception (ref colour.ml:21-24)."""


def nocover(_a, _b):
    raise Nocover


clear = colour_of_rgba(0, 0, 0, 0)


def red_channel(c: int) -> int:
    r, _, _, a = rgba_of_colour(c)
    return colour_of_rgba(r, 0, 0, a)


def green_channel(c: int) -> int:
    _, g, _, a = rgba_of_colour(c)
    return colour_of_rgba(0, g, 0, a)


def blue_channel(c: int) -> int:
    _, _, b, a = rgba_of_colour(c)
    return colour_of_rgba(0, 0, b, a)


def monochrome(c: int) -> int:
    """Average r,g,b; alpha unaltered (ref colour.ml:277-280)."""
    r, g, b, a = rgba_of_colour(c)
    av = (r + g + b) // 3
    return colour_of_rgba(av, av, av, a)


# ---------------------------------------------------------------------------
# Scalar compositing (exact integer; ref colour.ml:284-375)
# ---------------------------------------------------------------------------


def div255(i: int) -> int:
    """Divide 0..65534 by 255 (ref colour.ml:287)."""
    return (i + (i >> 8) + 1) >> 8


def dissolve(col: int, *, delta: int) -> int:
    """Porter/Duff dissolve (ref colour.ml:291-304)."""
    if not 0 <= delta <= 255:
        raise ValueError(f"dissolve: delta {delta} outside 0..255")
    if delta == 0:
        return clear
    if delta == 255:
        return col
    r, g, b, a = rgba_of_colour(col)
    return colour_of_rgba(
        div255(r * delta), div255(g * delta), div255(b * delta), div255(a * delta)
    )


def prelerp(p: int, q: int, a: int) -> int:
    """Linear interpolation on 0..255 (Alvy Ray Smith; ref colour.ml:310-311)."""
    t = a * p + 128
    return p + q - (((t >> 8) + t) >> 8)


def over(a: int, b: int) -> int:
    """Porter/Duff `over` (ref colour.ml:314-328)."""
    ra, ga, ba, aa = rgba_of_colour(a)
    if aa == 0:
        return b
    if aa == 255:
        return a
    rb, gb, bb, ab = rgba_of_colour(b)
    return colour_of_rgba(
        prelerp(rb, ra, aa), prelerp(gb, ga, aa), prelerp(bb, ba, aa), prelerp(ab, aa, aa)
    )


def alpha_over(a: int, b: int) -> int:
    """`over` on the alpha channel only (ref colour.ml:332-336)."""
    aa = alpha_of_colour(a)
    if aa == 0:
        return b
    if aa == 255:
        return a
    ab = alpha_of_colour(b)
    return colour_of_rgba(0, 0, 0, prelerp(ab, aa, aa))


def pd_plus(a: int, b: int) -> int:
    """Porter/Duff `plus` (ref colour.ml:339-352)."""
    ar, ag, ab_, aa = rgba_of_colour(a)
    br, bg, bb, ba = rgba_of_colour(b)
    if ar + br > 255 or ag + bg > 255 or ab_ + bb > 255 or aa + ba > 255:
        raise ValueError("pd_plus: channel sum above 255")
    return colour_of_rgba(ar + br, ag + bg, ab_ + bb, aa + ba)


def dissolve_between(*, a: int, b: int, alpha: int) -> int:
    """Dissolve between a and b by alpha (ref colour.ml:355-361)."""
    if not 0 <= alpha <= 255:
        raise ValueError(f"dissolve_between: alpha {alpha} outside 0..255")
    if alpha == 0:
        return b
    if alpha == 255:
        return a
    return pd_plus(dissolve(a, delta=alpha), dissolve(b, delta=255 - alpha))


def opaque(col: int) -> bool:
    return alpha_of_colour(col) == 255


def transparent(col: int) -> bool:
    return alpha_of_colour(col) == 0


def int_mult(a: int, b: int) -> int:
    """a * (b/255) on 0..255 (ref colour.ml:372-375)."""
    if b == 255:
        return a
    t = a * b
    return ((t << 8) + t) >> 16


def unpremul_rgb(c: int) -> tuple[int, int, int]:
    r, g, b, a = rgba_of_colour(c)
    if a == 0:
        return 0, 0, 0
    if a == 255:
        return r, g, b
    return (r * 255) // a, (g * 255) // a, (b * 255) // a


def unpremul_components(c: int) -> tuple[int, int, int, int]:
    r, g, b, a = rgba_of_colour(c)
    if a == 0:
        return 0, 0, 0, 0
    if a == 255:
        return r, g, b, 255
    return (r * 255) // a, (g * 255) // a, (b * 255) // a, a


def premul(r: int, g: int, b: int, a: int) -> tuple[int, int, int, int]:
    return int_mult(r, a), int_mult(g, a), int_mult(b, a), a


def mkcol(r: int, g: int, b: int) -> int:
    """Opaque colour (ref colour.ml:403-404; premultiplying by alpha 255
    is the identity)."""
    return colour_of_rgba(r, g, b, 255)


# ---------------------------------------------------------------------------
# Tensor compositing: int32 RGBA channel tensors, shape (..., 4)
# ---------------------------------------------------------------------------


def div255_arr(i: torch.Tensor) -> torch.Tensor:
    return (i + (i >> 8) + 1) >> 8


def prelerp_arr(p: torch.Tensor, q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Alvy Ray Smith's exact lerp on 0..255 (ref colour.ml:310-311)."""
    t = a * p + 128
    return p + q - (((t >> 8) + t) >> 8)


def over_rgba(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Porter/Duff over of (..., 4) int32 premultiplied RGBA, with the
    reference's alpha 0 / 255 early outs (ref colour.ml:314-328)."""
    aa = a[..., 3:4]
    blend = prelerp_arr(b, a, aa)
    return torch.where(aa == 0, b, torch.where(aa == 255, a, blend))


def dissolve_rgba(col: torch.Tensor, delta) -> torch.Tensor:
    """Dissolve by `delta` (int32, broadcastable; 0..255), keeping the
    reference's delta 0 / 255 early outs."""
    d = torch.as_tensor(delta, dtype=torch.int32, device=col.device)
    if d.ndim == col.ndim - 1:
        d = d[..., None]
    scaled = div255_arr(col * d)
    return torch.where(d == 0, 0, torch.where(d == 255, col, scaled))


def alpha_over_rgba(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Alpha-channel-only over (ref colour.ml:332-336): r, g, b of the
    blended branch are 0, as ``alpha_over`` builds ``colour_of_rgba 0 0 0``."""
    aa = a[..., 3:4]
    blended_alpha = prelerp_arr(b[..., 3:4], aa, aa)
    zeros = torch.zeros_like(blended_alpha)
    blend = torch.cat([zeros, zeros, zeros, blended_alpha], dim=-1)
    return torch.where(aa == 0, b, torch.where(aa == 255, a, blend))


def pd_plus_rgba(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Porter/Duff plus (no overflow check on tensors)."""
    return a + b


def dissolve_between_rgba(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """dissolve_between on tensors (ref colour.ml:355-361).  `alpha` is a
    scalar or has a trailing axis of size 1."""
    al = torch.as_tensor(alpha, dtype=torch.int32, device=a.device)
    while al.ndim < a.ndim:
        al = al[..., None]
    mixed = dissolve_rgba(a, al) + dissolve_rgba(b, 255 - al)
    return torch.where(al == 0, b, torch.where(al == 255, a, mixed))


def monochrome_rgba(c: torch.Tensor) -> torch.Tensor:
    """monochrome on tensors (ref colour.ml:277-280)."""
    av = (c[..., 0] + c[..., 1] + c[..., 2]) // 3
    return torch.stack([av, av, av, c[..., 3]], dim=-1)


def rgba_array_of_colour(c: int, device) -> torch.Tensor:
    """Scalar packed colour -> (4,) int32 tensor."""
    return torch.tensor(rgba_of_colour(c), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Named CSS colours (ref colour.ml:406-554)
# ---------------------------------------------------------------------------

_NAMED = {
    "aliceblue": (240, 248, 255), "antiquewhite": (250, 235, 215),
    "aqua": (0, 255, 255), "aquamarine": (127, 255, 212),
    "azure": (240, 255, 255), "beige": (245, 245, 220),
    "bisque": (255, 228, 196), "black": (0, 0, 0),
    "blanchedalmond": (255, 235, 205), "blue": (0, 0, 255),
    "blueviolet": (138, 43, 226), "brown": (165, 42, 42),
    "burlywood": (222, 184, 135), "cadetblue": (95, 158, 160),
    "chartreuse": (127, 255, 0), "chocolate": (210, 105, 30),
    "coral": (255, 127, 80), "cornflowerblue": (100, 149, 237),
    "cornsilk": (255, 248, 220), "crimson": (220, 20, 60),
    "cyan": (0, 255, 255), "darkblue": (0, 0, 139),
    "darkcyan": (0, 139, 139), "darkgoldenrod": (184, 134, 11),
    "darkgray": (169, 169, 169), "darkgreen": (0, 100, 0),
    "darkgrey": (169, 169, 169), "darkkhaki": (189, 183, 107),
    "darkmagenta": (139, 0, 139), "darkolivegreen": (85, 107, 47),
    "darkorange": (255, 140, 0), "darkorchid": (153, 50, 204),
    "darkred": (139, 0, 0), "darksalmon": (233, 150, 122),
    "darkseagreen": (143, 188, 143), "darkslateblue": (72, 61, 139),
    "darkslategray": (47, 79, 79), "darkslategrey": (47, 79, 79),
    "darkturquoise": (0, 206, 209), "darkviolet": (148, 0, 211),
    "deeppink": (255, 20, 147), "deepskyblue": (0, 191, 255),
    "dimgray": (105, 105, 105), "dimgrey": (105, 105, 105),
    "dodgerblue": (30, 144, 255), "firebrick": (178, 34, 34),
    "floralwhite": (255, 250, 240), "forestgreen": (34, 139, 34),
    "fuchsia": (255, 0, 255), "gainsboro": (220, 220, 220),
    "ghostwhite": (248, 248, 255), "gold": (255, 215, 0),
    "goldenrod": (218, 165, 32), "gray": (128, 128, 128),
    "grey": (128, 128, 128), "green": (0, 128, 0),
    "greenyellow": (173, 255, 47), "honeydew": (240, 255, 240),
    "hotpink": (255, 105, 180), "indianred": (205, 92, 92),
    "indigo": (75, 0, 130), "ivory": (255, 255, 240),
    "khaki": (240, 230, 140), "lavender": (230, 230, 250),
    "lavenderblush": (255, 240, 245), "lawngreen": (124, 252, 0),
    "lemonchiffon": (255, 250, 205), "lightblue": (173, 216, 230),
    "lightcoral": (240, 128, 128), "lightcyan": (224, 255, 255),
    "lightgoldenrodyellow": (250, 250, 210), "lightgray": (211, 211, 211),
    "lightgreen": (144, 238, 144), "lightgrey": (211, 211, 211),
    "lightpink": (255, 182, 193), "lightsalmon": (255, 160, 122),
    "lightseagreen": (32, 178, 170), "lightskyblue": (135, 206, 250),
    "lightslategray": (119, 136, 153), "lightslategrey": (119, 136, 153),
    "lightsteelblue": (176, 196, 222), "lightyellow": (255, 255, 224),
    "lime": (0, 255, 0), "limegreen": (50, 205, 50),
    "linen": (250, 240, 230), "magenta": (255, 0, 255),
    "maroon": (128, 0, 0), "mediumaquamarine": (102, 205, 170),
    "mediumblue": (0, 0, 205), "mediumorchid": (186, 85, 211),
    "mediumpurple": (147, 112, 219), "mediumseagreen": (60, 179, 113),
    "mediumslateblue": (123, 104, 238), "mediumspringgreen": (0, 250, 154),
    "mediumturquoise": (72, 209, 204), "mediumvioletred": (199, 21, 133),
    "midnightblue": (25, 25, 112), "mintcream": (245, 255, 250),
    "mistyrose": (255, 228, 225), "moccasin": (255, 228, 181),
    "navajowhite": (255, 222, 173), "navy": (0, 0, 128),
    "oldlace": (253, 245, 230), "olive": (128, 128, 0),
    "olivedrab": (107, 142, 35), "orange": (255, 165, 0),
    "orangered": (255, 69, 0), "orchid": (218, 112, 214),
    "palegoldenrod": (238, 232, 170), "palegreen": (152, 251, 152),
    "paleturquoise": (175, 238, 238), "palevioletred": (219, 112, 147),
    "papayawhip": (255, 239, 213), "peachpuff": (255, 218, 185),
    "peru": (205, 133, 63), "pink": (255, 192, 203),
    "plum": (221, 160, 221), "powderblue": (176, 224, 230),
    "purple": (128, 0, 128), "red": (255, 0, 0),
    "rosybrown": (188, 143, 143), "royalblue": (65, 105, 225),
    "saddlebrown": (139, 69, 19), "salmon": (250, 128, 114),
    "sandybrown": (244, 164, 96), "seagreen": (46, 139, 87),
    "seashell": (255, 245, 238), "sienna": (160, 82, 45),
    "silver": (192, 192, 192), "skyblue": (135, 206, 235),
    "slateblue": (106, 90, 205), "slategray": (112, 128, 144),
    "slategrey": (112, 128, 144), "snow": (255, 250, 250),
    "springgreen": (0, 255, 127), "steelblue": (70, 130, 180),
    "tan": (210, 180, 140), "teal": (0, 128, 128),
    "thistle": (216, 191, 216), "tomato": (255, 99, 71),
    "turquoise": (64, 224, 208), "violet": (238, 130, 238),
    "wheat": (245, 222, 179), "white": (255, 255, 255),
    "whitesmoke": (245, 245, 245), "yellow": (255, 255, 0),
    "yellowgreen": (154, 205, 50),
}


def __getattr__(name: str) -> int:
    try:
        rgb = _NAMED[name]
    except KeyError:
        raise AttributeError(name) from None
    return mkcol(*rgb)


white = mkcol(255, 255, 255)
black = mkcol(0, 0, 0)
