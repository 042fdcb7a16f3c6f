"""Debug-PDF visual channel (parity: sprite.ml:1996-2165 + render.ml:6-8).

Intermediate sprites/shapes accumulate onto debug pages; ``write_debug_pdf``
emits a multi-page PDF where every page images the fragments the renderer
produced — the reference's primary rendering-debug tool.  Sprites are imaged
as RGB rectangles of their bounding boxes (one image XObject per fragment)
so any PDF viewer shows exactly what was rasterized.

The port's copy of ``coherence_tpu.utils.debugpdf``: a fragment is read
back from its device with one host copy (one counted ``region.syncs``), and
the file's bytes equal the JAX package's for the same fragments.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np
import torch

from ..io import pdf as P
from ..raster import region

_current: List[Tuple[str, int, int, np.ndarray, np.ndarray]] = []  # label, dx, dy, rgb, alpha
_pages: List[Tuple[str, list]] = []


def clear_debug():
    _current.clear()
    _pages.clear()


def add_debug_sprite(spr, dx: int = 0, dy: int = 0, label: str = ""):
    if spr is None:
        return
    w, h = spr.wh
    # RGB and alpha as one uint8 plane on the device: one host copy.
    alpha = torch.where(spr.mask[:h, :w], 255, 0).to(torch.uint8)
    planes = torch.cat([spr.rgba[:h, :w, :3].to(torch.uint8), alpha[..., None]], dim=-1)
    region._sync()
    planes = planes.cpu().numpy()
    x0, y0, _, _ = spr.box
    _current.append((label, x0 + dx, y0 + dy, planes[..., :3], planes[..., 3]))


def add_debug_shape(shp, dx: int = 0, dy: int = 0, label: str = ""):
    if shp is None:
        return
    w, h = shp.wh
    region._sync()
    mask = shp.mask[:h, :w].cpu().numpy()
    rgb = np.where(mask[..., None], 0, 255).astype(np.uint8)
    alpha = np.where(mask, 255, 0).astype(np.uint8)
    x0, y0, _, _ = shp.box
    _current.append((label, x0 + dx, y0 + dy, rgb, alpha))


def write_debug_page(title: str):
    """Close the current fragment set into a page (sprite.ml write_debug_page)."""
    global _current
    if _current:
        _pages.append((title, _current))
        _current = []


def write_debug_pdf(path: str):
    """Emit all pages to a PDF file (sprite.ml write_debug_pdf)."""
    write_debug_page("final")
    objects = {}
    next_obj = 1

    def add(obj):
        nonlocal next_obj
        objects[next_obj] = obj
        next_obj += 1
        return P.Ref(next_obj - 1)

    catalog_ref = P.Ref(1)
    pages_ref = P.Ref(2)
    objects[1] = {"Type": P.Name("Catalog"), "Pages": pages_ref}
    objects[2] = {"Type": P.Name("Pages"), "Kids": [], "Count": 0}
    next_obj = 3
    for title, frags in _pages:
        ops = []
        xobjects = {}
        for k, (label, x, y, rgb, alpha) in enumerate(frags):
            h, w = rgb.shape[:2]
            name = f"Im{k}"
            img = P.Stream(
                {
                    "Type": P.Name("XObject"),
                    "Subtype": P.Name("Image"),
                    "Width": w,
                    "Height": h,
                    "ColorSpace": P.Name("DeviceRGB"),
                    "BitsPerComponent": 8,
                    "Filter": P.Name("FlateDecode"),
                },
                zlib.compress(np.ascontiguousarray(rgb).tobytes()),
            )
            xobjects[name] = add(img)
            # PDF images are placed bottom-up; flip into raster orientation.
            ops.append(f"q {w} 0 0 {h} {x} {1024 - y - h} cm /{name} Do Q")
        content = add(P.Stream({"Filter": P.Name("FlateDecode")}, zlib.compress("\n".join(ops).encode())))
        page = add(
            {
                "Type": P.Name("Page"),
                "Parent": pages_ref,
                "MediaBox": [0, 0, 2280, 1024],
                "Resources": {"XObject": xobjects},
                "Contents": content,
            }
        )
        objects[2]["Kids"].append(page)
        objects[2]["Count"] += 1
    pdf = P.Pdf(objects, {"Root": catalog_ref})
    P.pdf_to_file(pdf, path)
    clear_debug()
