"""The port's image decoders and PDF image path against the JAX package's,
on the same bytes: identical arrays, bit for bit.

  * ``io.jpeg``: PIL-made baseline and progressive JPEGs (subsampled, gray,
    CMYK, with restart markers) and the arithmetic-coded JPEGs of
    ``tests/_arithenc.py``;
  * ``io.jp2``: JP2 and raw J2K streams from the JAX package's encoder
    ``coherence_tpu.io.jp2enc`` (a test oracle, not ported);
  * ``io.jbig2``: whole segment streams (generic regions of each template,
    MMR, symbol dictionary and text region), and the port's native
    generic-region decoder against its own ``decode_generic``;
  * ``io.ccitt``: ``ccitt_encode_g4`` and ``ccitt_decode`` (G4, and G3 from
    libtiff through PIL);
  * ``io.pdfimages.rgba_of_image`` over the colour spaces, depths, masks and
    codecs, and ``scene.pdfscene.image_object_of_element`` through a page
    of image XObjects and inline images rendered on the CPU (tolerance 0).
"""

import io
import struct
import zlib

import numpy as np
import pytest

from coherence_tpu.io import ccitt as JCC
from coherence_tpu.io import jbig2 as JJB
from coherence_tpu.io import jp2 as JJ2
from coherence_tpu.io import jp2enc
from coherence_tpu.io import jpeg as JJP
from coherence_tpu.io import pdf as JP
from coherence_tpu.io import pdfgraphics as JPG
from coherence_tpu.io import pdfimages as JPI
from coherence_tpu.scene import pdfscene as JS

from coherence_tpu_torch import native_lib as t_native
from coherence_tpu_torch.io import ccitt as TCC
from coherence_tpu_torch.io import jbig2 as TJB
from coherence_tpu_torch.io import jp2 as TJ2
from coherence_tpu_torch.io import jpeg as TJP
from coherence_tpu_torch.io import pdf as TP
from coherence_tpu_torch.io import pdfgraphics as TPG
from coherence_tpu_torch.io import pdfimages as TPI
from coherence_tpu_torch.scene import pdfscene as TS

from _arithenc import encode_jpeg_arith
from _torch_general import JAX, PORT, both_sides, describe, same_raster  # noqa: F401
from _torch_pdf import canon
from _torch_threads import one_torch_thread  # noqa: F401
from test_jbig2 import generic_region_seg, page_info, seg, symbol_dict_seg, text_region_seg

PIL = pytest.importorskip("PIL.Image")


def _rng(seed):
    return np.random.default_rng(seed)


def _pil_jpeg(arr, mode, **kw):
    buf = io.BytesIO()
    PIL.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _smooth(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(1, w - 1), yy * 255 // max(1, h - 1), (xx + yy) % 256], -1)
    return np.clip(base + _rng(seed).integers(-20, 20, base.shape), 0, 255).astype(np.uint8)


JPEGS = {
    "baseline 4:2:0": lambda: _pil_jpeg(_smooth(37, 53, 1), "RGB", quality=85, subsampling=2),
    "baseline 4:4:4": lambda: _pil_jpeg(_smooth(16, 24, 2), "RGB", quality=95, subsampling=0),
    "baseline 4:2:2 restarts": lambda: _pil_jpeg(_smooth(40, 41, 3), "RGB", subsampling=1, restart_marker_blocks=2),
    "progressive": lambda: _pil_jpeg(_smooth(33, 65, 4), "RGB", progressive=True, quality=80),
    "gray progressive": lambda: _pil_jpeg(_smooth(29, 30, 5)[..., 0], "L", progressive=True),
    "cmyk adobe": lambda: _pil_jpeg(np.concatenate([_smooth(17, 19, 6), _smooth(17, 19, 7)[..., :1]], -1), "CMYK"),
    "arithmetic gray": lambda: encode_jpeg_arith(_rng(8).integers(0, 256, (24, 17), np.uint8)),
    "arithmetic rgb 4:2:0": lambda: encode_jpeg_arith(_rng(9).integers(0, 256, (33, 29, 3), np.uint8),
                                                      sampling=[(2, 2), (1, 1), (1, 1)]),
    "arithmetic progressive": lambda: encode_jpeg_arith(_smooth(24, 40, 10), progressive=True),
    "arithmetic restarts": lambda: encode_jpeg_arith(_smooth(32, 32, 11), restart_interval=3),
}


@pytest.mark.parametrize("name", list(JPEGS))
def test_jpeg_decodes_as_the_jax_package(name):
    data = JPEGS[name]()
    a, b = JJP.decode(data), TJP.decode(data)
    assert b.n_components == a.n_components and b.pixels.dtype == a.pixels.dtype
    assert np.array_equal(b.pixels, a.pixels)


@pytest.mark.parametrize("cut", [0.3, 0.7])
def test_jpeg_truncated_fails_as_the_jax_package(cut):
    data = JPEGS["progressive"]()
    data = data[: int(len(data) * cut)]
    outcomes = []
    for J in (JJP, TJP):
        try:
            outcomes.append(("ok", J.decode(data).pixels.tobytes()))
        except Exception as e:  # noqa: BLE001 - the kind of failure is what is compared
            outcomes.append((type(e).__name__, None))
    assert outcomes[0] == outcomes[1]


def _planes(img):
    return [np.asarray(p) for p in img.planes], img.alpha_index, img.depths


JP2S = {
    "gray lossless": lambda: jp2enc.encode([_rng(1).integers(0, 256, (21, 34))], levels=2),
    "rgb rct": lambda: jp2enc.encode([p for p in np.moveaxis(_smooth(30, 27, 2).astype(np.int64), -1, 0)],
                                     mct=True, levels=3),
    "raw codestream, tiles": lambda: jp2enc.encode([_rng(3).integers(0, 256, (40, 40))], tile=(16, 16),
                                                   container=False, levels=2),
    "bypass and termall, RPCL": lambda: jp2enc.encode([_rng(4).integers(0, 16, (24, 24))], depths=[4],
                                                      cbstyle=0x05, prog=2, levels=2),
    "subsampled chroma": lambda: jp2enc.encode(
        [_rng(5).integers(0, 256, (16, 16)), _rng(6).integers(0, 256, (8, 8)), _rng(7).integers(0, 256, (8, 8))],
        subs=[(1, 1), (2, 2), (2, 2)], levels=1),
    "palette": lambda: jp2enc.encode([_rng(8).integers(0, 4, (12, 10))], depths=[2], levels=1,
                                     palette=np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]])),
}


@pytest.mark.parametrize("name", list(JP2S))
def test_jp2_decodes_as_the_jax_package(name):
    data = JP2S[name]()
    a, b = JJ2.decode(data), TJ2.decode(data)
    pa, ia, da = _planes(a)
    pb, ib, db = _planes(b)
    assert ib == ia and list(db) == list(da) and len(pb) == len(pa)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    (rgb_a, al_a), (rgb_b, al_b) = a.rgba8(), b.rgba8()
    assert np.array_equal(rgb_a, rgb_b)
    assert (al_a is None and al_b is None) or np.array_equal(al_a, al_b)


def _jbig2_generic(template, tpgdon, seed):
    bm = (np.random.RandomState(seed).rand(24, 37) < 0.35).astype(np.uint8)
    return page_info(37, 24) + generic_region_seg(bm, template=template, tpgdon=tpgdon), None, 37, 24


def _jbig2_mmr():
    bm = np.zeros((16, 24), dtype=np.uint8)
    bm[4:12, 6:20] = 1
    bm[8, :] = 1
    enc = JCC.ccitt_encode_g4(np.asarray(bm, dtype=np.uint8), columns=24)
    data = struct.pack(">IIII", 24, 16, 0, 0) + bytes([0]) + bytes([1]) + enc
    return page_info(24, 16) + seg(2, 38, [], 1, data), None, 24, 16


def _jbig2_text():
    """A symbol dictionary in the globals and a text region placing its two
    symbols, the split a PDF's /JBIG2Globals makes."""
    box = np.ones((6, 4), dtype=np.uint8)
    ell = (np.random.RandomState(3).rand(6, 5) < 0.5).astype(np.uint8)
    dict_seg, _ = symbol_dict_seg([box, ell])
    text = text_region_seg(40, 30, [(2, [(1, 0), (10, 1)]), (12, [(0, 1)])], nsyms=2, widths=(4, 5))
    return text, page_info(40, 30) + dict_seg, 40, 30


JBIG2S = {
    **{f"generic template {t}{' tpgdon' if d else ''}": (lambda t=t, d=d: _jbig2_generic(t, d, 10 + t))
       for t in range(4) for d in (False, True)},
    "mmr generic": _jbig2_mmr,
    "symbol dictionary and text region": _jbig2_text,
}


@pytest.mark.parametrize("name", list(JBIG2S))
def test_jbig2_decodes_as_the_jax_package(name):
    stream, globals_data, w, h = JBIG2S[name]()
    assert TJB.decode_jbig2(stream, globals_data, w, h) == JJB.decode_jbig2(stream, globals_data, w, h)


@pytest.mark.parametrize("template", range(4))
@pytest.mark.parametrize("tpgdon", [False, True])
def test_native_generic_region_matches_decode_generic(template, tpgdon):
    """The port's C++ generic-region decoder against the Python one it
    transcribes, and against the JAX package's native decoder."""
    from coherence_tpu import native_lib as j_native

    rs = np.random.RandomState(20 + template)
    bm = (rs.rand(31, 45) < 0.3).astype(np.uint8)
    bm[10:14] = 1  # whole rows for TPGDON's typical-row prediction
    enc = TJB.MQEncoder()
    TJB.encode_generic(enc, TJB.Contexts(1 << 16), bm, template, None, tpgdon)
    data = enc.flush()
    at = TJB.NOMINAL_AT[template]
    native = t_native.jbig2_generic_region(data, 45, 31, template, at, tpgdon)
    python = TJB.decode_generic(TJB.MQDecoder(data), TJB.Contexts(1 << 16), 45, 31, template, at, tpgdon)
    assert native is not NotImplemented
    assert np.array_equal(native, python) and np.array_equal(native, bm)
    assert np.array_equal(native, j_native.jbig2_generic_region(data, 45, 31, template, at, tpgdon))


def _bitmap(seed, h, w):
    rs = np.random.default_rng(seed)
    return (rs.random((h, w)) < rs.random()).astype(int)


@pytest.mark.parametrize("seed", range(4))
def test_ccitt_g4_encodes_and_decodes_as_the_jax_package(seed):
    h, w = 9 + 7 * seed, 13 + 19 * seed
    rows = [list(r) for r in _bitmap(seed, h, w)]
    enc = TCC.ccitt_encode_g4(rows, w)
    assert enc == JCC.ccitt_encode_g4(rows, w)
    for black_is_1 in (False, True):
        kw = dict(k=-1, columns=w, rows=h, black_is_1=black_is_1)
        assert TCC.ccitt_decode(enc, **kw) == JCC.ccitt_decode(enc, **kw)


@pytest.mark.parametrize("compression,k", [("group3", 0), ("group4", -1)])
def test_ccitt_libtiff_streams_decode_as_the_jax_package(compression, k):
    from test_ccitt import _tiff_strips

    bm = _bitmap(7, 23, 61)
    strips, opts = _tiff_strips(bm, compression)
    if compression == "group3" and opts & 1:
        k = 1
    for raw, n in strips:
        assert TCC.ccitt_decode(raw, k=k, columns=61, rows=n) == JCC.ccitt_decode(raw, k=k, columns=61, rows=n)


# --- image dictionaries: (dict, raw) built with a side's own Name/Stream -----


def _bits(values, bpc):
    """Pack unsigned samples MSB first, each row padded to a byte."""
    out = []
    for row in values:
        acc, n = 0, 0
        buf = bytearray()
        for v in row:
            acc = (acc << bpc) | int(v)
            n += bpc
            while n >= 8:
                buf.append((acc >> (n - 8)) & 0xFF)
                n -= 8
        if n:
            buf.append((acc << (8 - n)) & 0xFF)
        out.append(bytes(buf))
    return b"".join(out)


def _image_dict(P, name):
    """An image XObject's (dict, raw) for one case, from the same numbers on
    either side."""
    N = P.Name
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "rgb 8 flate":
        raw = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8).tobytes()
        return {"Width": 7, "Height": 5, "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8,
                "Filter": N("FlateDecode")}, zlib.compress(raw)
    if name.startswith("gray "):
        bpc = int(name.split()[1])
        vals = rs.randint(0, 1 << bpc, (6, 5))
        raw = _bits(vals, bpc) if bpc < 16 else vals.astype(">u2").tobytes()
        d = {"Width": 5, "Height": 6, "ColorSpace": N("DeviceGray"), "BitsPerComponent": bpc}
        if bpc == 1:
            d["Decode"] = [1, 0]
        return d, raw
    if name == "cmyk":
        return {"Width": 4, "Height": 3, "ColorSpace": N("DeviceCMYK"), "BitsPerComponent": 8}, \
            rs.randint(0, 256, (3, 4, 4)).astype(np.uint8).tobytes()
    if name == "indexed 4bpc":
        lut = rs.randint(0, 256, 16 * 3).astype(np.uint8).tobytes()
        return {"Width": 5, "Height": 4, "BitsPerComponent": 4,
                "ColorSpace": [N("Indexed"), N("DeviceRGB"), 15, lut]}, _bits(rs.randint(0, 16, (4, 5)), 4)
    if name == "separation":
        fn = {"FunctionType": 2, "Domain": [0, 1], "C0": [1, 1, 1], "C1": [0.2, 0.5, 0.9], "N": 1}
        return {"Width": 6, "Height": 2, "BitsPerComponent": 8,
                "ColorSpace": [N("Separation"), N("Spot"), N("DeviceRGB"), fn]}, \
            rs.randint(0, 256, (2, 6)).astype(np.uint8).tobytes()
    if name == "lab":
        return {"Width": 3, "Height": 3, "BitsPerComponent": 8,
                "ColorSpace": [N("Lab"), {"WhitePoint": [0.9505, 1.0, 1.089], "Range": [-100, 100, -100, 100]}]}, \
            rs.randint(0, 256, (3, 3, 3)).astype(np.uint8).tobytes()
    if name == "image mask":
        return {"Width": 9, "Height": 4, "ImageMask": True, "BitsPerComponent": 1}, _bits(rs.randint(0, 2, (4, 9)), 1)
    if name == "smask":
        sm = P.Stream({"Width": 4, "Height": 4, "ColorSpace": N("DeviceGray"), "BitsPerComponent": 8},
                      rs.randint(0, 256, (4, 4)).astype(np.uint8).tobytes())
        return {"Width": 4, "Height": 4, "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8, "SMask": sm}, \
            rs.randint(0, 256, (4, 4, 3)).astype(np.uint8).tobytes()
    if name == "dct":
        return {"Width": 21, "Height": 13, "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8,
                "Filter": N("DCTDecode")}, _pil_jpeg(_smooth(13, 21, 3), "RGB")
    if name == "jpx":
        return {"Width": 10, "Height": 12, "Filter": N("JPXDecode")}, \
            jp2enc.encode([p for p in np.moveaxis(_smooth(12, 10, 4).astype(np.int64), -1, 0)], levels=2)
    if name == "jbig2":
        stream, _, w, h = _jbig2_generic(1, False, 5)
        return {"Width": w, "Height": h, "ColorSpace": N("DeviceGray"), "BitsPerComponent": 1,
                "Filter": N("JBIG2Decode")}, stream
    if name == "ccitt g4":
        bm = _bitmap(9, 11, 30)
        return {"Width": 30, "Height": 11, "ColorSpace": N("DeviceGray"), "BitsPerComponent": 1,
                "Filter": N("CCITTFaxDecode"), "DecodeParms": {"K": -1, "Columns": 30, "Rows": 11}}, \
            TCC.ccitt_encode_g4([list(r) for r in bm], 30)
    if name == "ascii85 and run length":
        raw = rs.randint(0, 256, (3, 5, 3)).astype(np.uint8).tobytes()
        rl = bytes([len(raw) - 1]) + raw + b"\x80"
        return {"Width": 5, "Height": 3, "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8,
                "Filter": [N("ASCII85Decode"), N("RunLengthDecode")]}, _a85(rl)
    if name == "unsupported depth":
        return {"Width": 2, "Height": 2, "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 3}, b"\x00" * 8
    raise KeyError(name)


def _a85(data: bytes) -> bytes:
    import base64

    return base64.a85encode(data) + b"~>"


IMAGES = ["rgb 8 flate", "gray 1", "gray 2", "gray 4", "gray 16", "cmyk", "indexed 4bpc", "separation", "lab",
          "image mask", "smask", "dct", "jpx", "jbig2", "ccitt g4", "ascii85 and run length", "unsupported depth"]


def _rgba(P, PI, name):
    d, raw = _image_dict(P, name)
    fill = (0.2, 0.4, 0.8) if name == "image mask" else None
    try:
        return PI.rgba_of_image(None, d, raw, mask_fill=fill)
    except Exception as e:  # noqa: BLE001 - the kind of failure is what is compared
        return type(e).__name__


@pytest.mark.parametrize("name", IMAGES)
def test_rgba_of_image_matches_jax(name):
    a, b = _rgba(JP, JPI, name), _rgba(TP, TPI, name)
    if isinstance(a, str):
        assert b == a
    else:
        assert b.dtype == a.dtype and np.array_equal(b, a)


def _image_page(P, name):
    """A page that paints one image XObject twice (one copy at half alpha
    under a clip), an inline image with abbreviated keys and an ASCIIHex
    filter, and a stencil inline image in the current fill colour."""
    d, raw = _image_dict(P, name)
    img = P.Stream(dict(d, Type=P.Name("XObject"), Subtype=P.Name("Image")), raw)
    content = (b"q 60 0 0 40 10 50 cm /Im0 Do Q "
               b"q 5 5 40 40 re W n /GS0 gs 50 0 0 30 2 8 cm /Im0 Do Q "
               b"q 12 0 0 8 70 10 cm BI /W 3 /H 2 /BPC 8 /CS /RGB /F /AHx ID "
               b"ff0000 00ff00 0000ff 808080 ffffff 000000> EI Q "
               b"0 0.5 1 rg q 16 0 0 16 70 70 cm BI /W 8 /H 2 /IM true ID \xa5\x3c EI Q")
    return P.mkpage(content, mediabox=(0, 0, 100, 100),
                    resources={"XObject": {"Im0": img}, "ExtGState": {"GS0": {"ca": 0.5}}})


def page_parity(build, dev_scene=None):
    """Both sides' graphic tree (canonical repr), scene (kinds in element
    order) and CPU raster of every page of build(P)."""
    from _torch_pdf import page_results

    a, b = page_results(JAX, JP, JPG, JS, build), page_results(PORT, TP, TPG, TS, build)
    assert len(a) == len(b) and a
    for i, (pa, pb) in enumerate(zip(a, b)):
        assert pb[0] == pa[0], f"page {i}: graphic trees differ"
        assert pb[1] == pa[1], f"page {i}: scenes differ"
        assert same_raster(pa[2], pb[2]), f"page {i}: {describe(pa[2], pb[2])}"
    return b


@pytest.mark.parametrize("name", IMAGES)
def test_image_page_renders_as_the_jax_package(name, both_sides):
    got = page_parity(lambda P: _image_page(P, name))
    assert got[0][2] is not None and len(got[0][1]) == 4


def test_image_element_stream_and_objnum_match(both_sides):
    """image_stream_of_element resolves a referenced XObject by number and
    an embedded one by its stream, on both sides."""
    out = []
    for P, PG, PI in ((JP, JPG, JPI), (TP, TPG, TPI)):
        pdf = _image_page(P, "rgb 8 flate")
        page = pdf.pages()[0]
        xobjects = pdf.resolve(page["Resources"])["XObject"]
        pdf.objects[9] = xobjects["Im0"]
        xobjects["Im1"] = P.Ref(9)
        page["Contents"] = P.Stream({}, b"q 9 0 0 9 1 1 cm /Im1 Do /Im0 Do Q")
        els = PG.graphic_of_page(pdf, page).elements
        out.append((canon(els), [canon(PI.image_stream_of_element(pdf, el)) for el in els]))
    assert out[0] == out[1] and len(out[1][0]) == 3
