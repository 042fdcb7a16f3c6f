"""Minimal PNG writer (pure stdlib: zlib + struct).

The display client and debug tooling dump window contents as images; PPM
needs external tools to view, so PNG (8-bit RGB/RGBA, filter 0) is offered
alongside.  No reference counterpart — the reference's only image outputs
are its debug PDFs (sprite.ml:1996-2165) and live wx windows.

The port's copy of ``coherence_tpu.utils.png``, unchanged.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def png_bytes(img: np.ndarray) -> bytes:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 into a PNG byte string."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, ch = a.shape
    colour_type = {1: 0, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    # Filter byte 0 per row.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), a.reshape(h, w * ch)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_png(data_or_path) -> np.ndarray:
    """Decode a PNG produced by this module (8-bit, filter 0 rows only) —
    enough for round-trip tests without external libraries."""
    if isinstance(data_or_path, (bytes, bytearray)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    ch = 0
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ct = struct.unpack(">IIBB", body[:10])
            assert depth == 8, "only 8-bit supported"
            ch = {0: 1, 2: 3, 6: 4}[ct]
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * ch + 1)
    assert (raw[:, 0] == 0).all(), "only filter 0 supported"
    out = raw[:, 1:].reshape(h, w, ch)
    return out[:, :, 0] if ch == 1 else out
