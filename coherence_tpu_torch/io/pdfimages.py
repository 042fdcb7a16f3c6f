"""PDF image decoding: XObject / inline-image samples -> premultiplied RGBA.

The port's copy of ``coherence_tpu.io.pdfimages``, whole.

BEYOND REFERENCE: the reference parses ``Image``/``GraphicInlineImage``
elements into its graphic tree (pdfgraphics.mli:139-140) but
``Render.scene_of_graphic`` consumes paths and clips only
(render.ml:1524-1565), so images never paint.  Here they decode into a
``(h, w, 4)`` premultiplied int64 RGBA plane that ``fills.ImageFill``
samples under the placement transform.

Supported: BitsPerComponent 1/2/4/8/16; DeviceGray/DeviceRGB/DeviceCMYK,
CalGray/CalRGB, ICCBased (by /N), Lab (CIE inverse + sRGB encode),
Indexed (any base), Separation/DeviceN
(tint transform via ``pdfgraphics.eval_function``); /Decode arrays;
stencil masks (/ImageMask, painted with the fill colour current at the
``Do``/``BI`` op); soft masks (/SMask); DCTDecode via the from-scratch
``io/jpeg.py``, JPXDecode through ``io/jp2.py``.  Unsupported
exotica raise ``ValueError`` and
the scene layer falls back to the same gray placeholder the unsupported
shading kinds use.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import pdf as P
from . import pdfgraphics as PG

__all__ = ["rgba_of_image", "image_stream_of_element"]


def _norm_key(d: dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


def _decode_data(pdf, d: dict, raw: bytes) -> Tuple[bytes, Optional[str]]:
    """Apply the stream filter chain; a trailing image codec (DCT/JPX) is
    NOT applied — its name is returned for pixel-level decoding."""
    res = pdf.resolve if pdf is not None else (lambda o: o)
    filt = res(_norm_key(d, "Filter", "F"))
    names: List[str] = []
    if isinstance(filt, P.Name):
        names = [filt.v]
    elif isinstance(filt, list):
        names = [res(f).v for f in filt]
    image_codecs = ("DCTDecode", "DCT", "JPXDecode")
    codec = None
    parms = res(_norm_key(d, "DecodeParms", "DP"))
    jbig2_parms = None
    jbig2 = False
    if names and names[-1] == "JBIG2Decode":
        jbig2 = True
        names = names[:-1]
        if isinstance(parms, list):
            jbig2_parms = res(parms[-1]) if parms else None
            parms = parms[: len(names)]
        else:
            jbig2_parms, parms = parms, None
    if names and names[-1] in image_codecs:
        codec = names[-1]
        names = names[:-1]
        if isinstance(parms, list):
            parms = parms[: len(names)]
    elif any(n in image_codecs for n in names):
        raise ValueError("image codec not last in filter chain")
    # Normalize abbreviated inline-image keys (F/DP) for Stream.decode.
    nd = {k: v for k, v in d.items() if k not in ("F", "DP")}
    nd["Filter"] = [P.Name(n) for n in names]
    if parms is not None:
        nd["DecodeParms"] = parms
    data = P.Stream(nd, raw, pdf).decode()
    if jbig2:
        from . import jbig2 as J2

        g = None
        if isinstance(jbig2_parms, dict):
            gs = res(jbig2_parms.get("JBIG2Globals"))
            if isinstance(gs, P.Stream):
                g = gs.decode()
        w = int(res(_norm_key(d, "Width", "W")))
        h = int(res(_norm_key(d, "Height", "H")))
        data = J2.decode_jbig2(data, g, w, h)
    return data, codec


def _unpack_samples(data: bytes, w: int, h: int, channels: int, bpc: int):
    """(h, w, channels) int32 raw sample values; rows pad to whole bytes."""
    row_bits = w * channels * bpc
    row_bytes = (row_bits + 7) // 8
    need = row_bytes * h
    if len(data) < need:
        data = data + b"\x00" * (need - len(data))
    arr = np.frombuffer(data[:need], dtype=np.uint8).reshape(h, row_bytes)
    if bpc == 8:
        out = arr[:, : w * channels].astype(np.int32)
    elif bpc == 16:
        out = (
            (arr[:, 0 : 2 * w * channels : 2].astype(np.int32) << 8)
            | arr[:, 1 : 2 * w * channels : 2]
        )
    else:  # 1, 2, 4
        bits = np.unpackbits(arr, axis=1)[:, :row_bits]
        per = bits.reshape(h, w * channels, bpc)
        weights = (1 << np.arange(bpc - 1, -1, -1)).astype(np.int32)
        out = (per * weights).sum(axis=2, dtype=np.int32)
    return out.reshape(h, w, channels)


def _apply_decode(samples, decode, bpc: int):
    """Component mapping raw -> Decode interval (PDF 8.9.5.2); returns
    float64 in the decode range."""
    maxv = float((1 << bpc) - 1)
    ch = samples.shape[2]
    out = np.empty(samples.shape, dtype=np.float64)
    for i in range(ch):
        d0, d1 = float(decode[2 * i]), float(decode[2 * i + 1])
        out[..., i] = d0 + samples[..., i] * ((d1 - d0) / maxv)
    return out


def _cs_struct(pdf, cs):
    """Resolve a ColorSpace object to (kind, payload, n_components)."""
    res = pdf.resolve if pdf is not None else (lambda o: o)
    cs = res(cs)
    if isinstance(cs, P.Name):
        n = cs.v
        if n in ("DeviceGray", "G", "CalGray"):
            return ("gray", None, 1)
        if n in ("DeviceRGB", "RGB", "CalRGB"):
            return ("rgb", None, 3)
        if n in ("DeviceCMYK", "CMYK"):
            return ("cmyk", None, 4)
        if n in ("I", "Indexed"):
            raise ValueError("abbreviated Indexed without array")
        return ("rgb", None, 3)
    if isinstance(cs, list) and cs and isinstance(res(cs[0]), P.Name):
        head = res(cs[0]).v
        if head in ("Indexed", "I"):
            base = _cs_struct(pdf, cs[1])
            hival = int(res(cs[2]))
            lookup = res(cs[3])
            table = lookup.decode() if isinstance(lookup, P.Stream) else bytes(lookup)
            return ("indexed", (base, hival, table), 1)
        if head == "ICCBased":
            icc = res(cs[1])
            n = int(res(icc.dict.get("N", 3))) if isinstance(icc, P.Stream) else 3
            return {1: ("gray", None, 1), 4: ("cmyk", None, 4)}.get(
                n, ("rgb", None, 3)
            )
        if head in ("CalRGB",):
            return ("rgb", None, 3)
        if head in ("CalGray",):
            return ("gray", None, 1)
        if head == "Lab":
            ld = res(cs[1]) if len(cs) > 1 else {}
            wp = [float(res(v)) for v in res(ld.get("WhitePoint", [0.9505, 1.0, 1.089]))]
            rng = [float(res(v)) for v in res(ld.get("Range", [-100.0, 100.0, -100.0, 100.0]))]
            return ("lab", (wp, rng), 3)
        if head in ("Separation", "DeviceN"):
            names = res(cs[1])
            n_in = 1 if head == "Separation" else len(names)
            alt = _cs_struct(pdf, cs[2])
            fn = PG.parse_function(pdf, res(cs[3]))
            return ("tint", (alt, fn), n_in)
    return ("rgb", None, 3)


def _rgb_of_components(pdf, kind, payload, comps):
    """(h, w, n) float components -> (h, w, 3) float RGB in [0, 1]."""
    if kind == "gray":
        g = np.clip(comps[..., 0], 0.0, 1.0)
        return np.stack([g, g, g], axis=-1)
    if kind == "rgb":
        return np.clip(comps[..., :3], 0.0, 1.0)
    if kind == "cmyk":
        c = np.clip(comps, 0.0, 1.0)
        cy, m, y, k = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
        # render.ml:1476-1479 rgb_of_cmyk, vectorized.
        return np.stack(
            [
                1.0 - np.minimum(1.0, cy * (1.0 - k) + k),
                1.0 - np.minimum(1.0, m * (1.0 - k) + k),
                1.0 - np.minimum(1.0, y * (1.0 - k) + k),
            ],
            axis=-1,
        )
    if kind == "lab":
        # PDF 8.6.5.4: L* in [0,100], a*/b* clipped to Range, CIE 1976
        # inverse transform to XYZ, then linear-sRGB matrix + gamma encode.
        wp, rng = payload
        lab = comps[..., :3].astype(np.float64)
        lstar = np.clip(lab[..., 0], 0.0, 100.0)
        astar = np.clip(lab[..., 1], rng[0], rng[1])
        bstar = np.clip(lab[..., 2], rng[2], rng[3])
        m = (lstar + 16.0) / 116.0
        ell = m + astar / 500.0
        n = m - bstar / 200.0

        def g(t):
            return np.where(t >= 6.0 / 29.0, t**3, (108.0 / 841.0) * (t - 4.0 / 29.0))

        x = wp[0] * g(ell)
        y = wp[1] * g(m)
        z = wp[2] * g(n)
        rl = 3.2406 * x - 1.5372 * y - 0.4986 * z
        gl = -0.9689 * x + 1.8758 * y + 0.0415 * z
        bl = 0.0557 * x - 0.2040 * y + 1.0570 * z
        lin = np.clip(np.stack([rl, gl, bl], axis=-1), 0.0, 1.0)
        return np.where(
            lin <= 0.0031308, 12.92 * lin, 1.055 * np.power(lin, 1.0 / 2.4) - 0.055
        )
    if kind == "indexed":
        (bkind, bpayload, bn), hival, table = payload
        idx = np.clip(comps[..., 0].astype(np.int64), 0, hival)
        need = (hival + 1) * bn
        tab = np.frombuffer(
            table.ljust(need, b"\x00")[:need], dtype=np.uint8
        ).reshape(hival + 1, bn)
        base_comps = tab[idx].astype(np.float64) / 255.0
        return _rgb_of_components(pdf, bkind, bpayload, base_comps)
    if kind == "tint":
        (akind, apayload, an), fn = payload
        h, w, n_in = comps.shape
        flat = comps.reshape(-1, n_in)
        # Tint transforms are tiny polynomial/sampled functions; evaluate
        # on the distinct input tuples only (images repeat values heavily).
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        lut = np.empty((len(uniq), an), dtype=np.float64)
        for i, row in enumerate(uniq):
            out = PG.eval_function(fn, list(row))
            out = list(out) + [0.0] * (an - len(out))
            lut[i] = out[:an]
        alt = lut[inverse].reshape(h, w, an)
        return _rgb_of_components(pdf, akind, apayload, alt)
    raise ValueError(f"unsupported colourspace {kind}")


def _pil_rgb(codec: str, data: bytes, w: int, h: int):
    """Decode a DCT/JPX payload -> ((h, w, 3) float RGB, alpha?).

    Both image codecs are from-scratch now: DCTDecode via ``io/jpeg.py``
    (byte-identical to libjpeg — tests/test_jpeg.py) and JPXDecode via
    ``io/jp2.py`` (exact for reversible 5/3 streams, within 1 code of
    OpenJPEG for irreversible 9/7 — tests/test_jp2.py).  PIL remains a
    test-time oracle only."""
    if codec in ("DCTDecode", "DCT"):
        from . import jpeg as _jpeg

        dec = _jpeg.decode(data)
        px = dec.pixels.astype(np.float64) / 255.0
        if dec.n_components == 1:
            rgb = np.repeat(px, 3, axis=-1)
        elif dec.n_components == 3:
            rgb = px
        else:  # true (un-inverted) CMYK
            rgb = _rgb_of_components(None, "cmyk", None, px)
        alpha = None
    else:
        from . import jp2 as _jp2

        img = _jp2.decode(data)
        rgb, alpha = img.rgba8()
        ncolor = len(img.planes) - (1 if img.alpha_index is not None else 0)
        if ncolor == 4:  # CMYK JPX (no enumerated-CS match): convert
            cm = np.stack(
                [
                    p.astype(np.float64) / float((1 << d) - 1)
                    for i, (p, d) in enumerate(
                        zip(img.full_planes(), img.depths)
                    )
                    if i != img.alpha_index
                ],
                axis=-1,
            )
            rgb = _rgb_of_components(None, "cmyk", None, cm)
    if rgb.shape[:2] != (h, w):
        rgb = _resize_nearest(rgb, h, w)
        if alpha is not None:
            alpha = _resize_nearest(alpha[..., None], h, w)[..., 0]
    return rgb, alpha


def _resize_nearest(plane, h, w):
    sh, sw = plane.shape[:2]
    ys = np.minimum((np.arange(h) * sh) // max(1, h), sh - 1)
    xs = np.minimum((np.arange(w) * sw) // max(1, w), sw - 1)
    return plane[ys][:, xs]


def _smask_alpha(pdf, sm, w: int, h: int):
    """/SMask stream -> (h, w) float alpha in [0, 1] (nearest-resampled)."""
    res = pdf.resolve if pdf is not None else (lambda o: o)
    sm = res(sm)
    if not isinstance(sm, P.Stream):
        return None
    d = sm.dict
    sw = int(res(_norm_key(d, "Width", "W")))
    sh = int(res(_norm_key(d, "Height", "H")))
    bpc = int(res(_norm_key(d, "BitsPerComponent", "BPC", default=8)))
    data, codec = _decode_data(pdf, d, sm.raw)
    if codec is not None:
        rgb, _ = _pil_rgb(codec, data, sw, sh)
        a = rgb[..., 0]
    else:
        samples = _unpack_samples(data, sw, sh, 1, bpc)
        decode = res(_norm_key(d, "Decode", "D")) or [0.0, 1.0]
        a = np.clip(_apply_decode(samples, decode, bpc)[..., 0], 0.0, 1.0)
    if (sh, sw) != (h, w):
        a = _resize_nearest(a[..., None], h, w)[..., 0]
    return a


def rgba_of_image(pdf, d: dict, raw: bytes, mask_fill=None) -> np.ndarray:
    """Decode one image (XObject or inline dict + data) to a premultiplied
    ``(h, w, 4)`` int64 RGBA plane, row 0 = the image's top sample row.

    ``mask_fill`` is an ``(r, g, b)`` float triple painted through stencil
    masks (/ImageMask true): mask sample 0 paints, 1 leaves transparent
    (flipped by /Decode [1 0]), per PDF 8.9.6.2."""
    res = pdf.resolve if pdf is not None else (lambda o: o)
    w = int(res(_norm_key(d, "Width", "W")))
    h = int(res(_norm_key(d, "Height", "H")))
    if w <= 0 or h <= 0:
        raise ValueError("degenerate image dimensions")
    if res(_norm_key(d, "ImageMask", "IM")) is True:
        data, codec = _decode_data(pdf, d, raw)
        if codec is not None:
            raise ValueError("DCT-coded stencil mask")
        samples = _unpack_samples(data, w, h, 1, 1)
        decode = res(_norm_key(d, "Decode", "D")) or [0.0, 1.0]
        paint = (
            samples[..., 0] == 0
            if float(decode[0]) == 0.0
            else samples[..., 0] == 1
        )
        r, g, b = mask_fill if mask_fill is not None else (0.0, 0.0, 0.0)
        out = np.zeros((h, w, 4), dtype=np.int64)
        out[paint] = [
            int(round(r * 255.0)),
            int(round(g * 255.0)),
            int(round(b * 255.0)),
            255,
        ]
        return out

    bpc = int(res(_norm_key(d, "BitsPerComponent", "BPC", default=8)))
    kind, payload, nch = _cs_struct(pdf, _norm_key(d, "ColorSpace", "CS"))
    data, codec = _decode_data(pdf, d, raw)
    pil_alpha = None
    if codec is not None:
        rgb, pil_alpha = _pil_rgb(codec, data, w, h)
    else:
        samples = _unpack_samples(data, w, h, nch, bpc)
        decode = res(_norm_key(d, "Decode", "D"))
        if decode is None:
            if kind == "indexed":
                decode = [0.0, float((1 << bpc) - 1)]
            elif kind == "lab":
                decode = [0.0, 100.0] + list(payload[1])
            else:
                decode = [0.0, 1.0] * nch
        comps = _apply_decode(samples, decode, bpc)
        rgb = _rgb_of_components(pdf, kind, payload, comps)

    alpha = np.ones((h, w), dtype=np.float64)
    if pil_alpha is not None:
        alpha = pil_alpha
    sm = res(_norm_key(d, "SMask"))
    if sm is not None and not (isinstance(sm, P.Name) and sm.v == "None"):
        a = _smask_alpha(pdf, sm, w, h)
        if a is not None:
            alpha = alpha * a
    a8 = np.rint(np.clip(alpha, 0.0, 1.0) * 255.0).astype(np.int64)
    # Premultiply at 8-bit like colour_of_rgba_float does for fills.
    rgb8 = np.rint(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.int64)
    pre = (rgb8 * a8[..., None] + 127) // 255
    return np.concatenate([pre, a8[..., None]], axis=-1)


def image_stream_of_element(pdf, el):
    """(dict, raw bytes) for an ``Image`` or ``GraphicInlineImage`` element,
    or None when the referenced object is missing."""
    if isinstance(el, PG.GraphicInlineImage):
        return el.dict, el.data
    if isinstance(el, PG.Image):
        st = el.stream
        if st is None and pdf is not None:
            st = pdf.resolve(pdf.objects.get(el.objnum))
        if isinstance(st, P.Stream):
            return st.dict, st.raw
    return None
