"""The least time a kernel could take for its work, from its shapes: the
larger of its bytes over the H100 SXM's HBM rate and its operations over its
int32 rate.  Frozen from chip_smoke.py:342-366 (the peaks), 771-821
(pixel_sectors, dilated, blur_bound): bytes are counted per 32-byte sector,
each read pixel's sector and each written pixel's sector once."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # NVIDIA's data sheet, H100 SXM
SECTOR_BYTES = 32
# 32-bit integer multiply-adds (two operations each) at the H100 SXM's int32
# rate: compute capability 9.0 does 64 integer multiply-adds a clock per SM
# against 128 float32 FMAs, so half of the 67 T/s float32 peak.
INT_OPS_PER_S = 67e12 / 2


def pixel_sectors(mask, row0: int, col0: int, row_pixels: int, pixel_bytes: int) -> int:
    """32-byte sectors holding the pixels of `mask` (a 2D bool block at
    (row0, col0) of a row-major plane of `row_pixels` pixels a row)."""
    ys, xs = mask.nonzero(as_tuple=True)
    flat = ((ys + row0) * row_pixels + xs + col0) * pixel_bytes // SECTOR_BYTES
    return int(torch.unique(flat).numel())


def dilated(mask, ry: int, rx: int):
    """`mask` grown by ry rows and rx columns (a box window)."""
    pooled = torch.nn.functional.max_pool2d(mask[None, None].float(), (2 * ry + 1, 2 * rx + 1), stride=1,
                                            padding=(ry, rx))
    return pooled[0, 0] > 0


def blur_bound(f_alpha, content_cols: int, oy, ox, ry0, rx0, h, w, d_box, hb, wb, radius: int) -> dict:
    """What blur_blend must do for one window: the bytes (per sector) of the
    packed content it reads (the 2r + 1 square around each written pixel),
    of the alpha plane it must test (bloat(dirty, r) inside the window) and
    of the 16-byte pixels it writes (the changed ones); and its
    multiply-adds: 4 channels x (2r + 1) taps for each x-pass value the y
    pass reads and for each written pixel."""
    dev = f_alpha.device
    rows = torch.arange(hb, device=dev)[:, None]
    cols = torch.arange(wb, device=dev)[None, :]
    fa = f_alpha[oy : oy + hb, ox : ox + wb]
    d0, d1, d2, d3 = (int(v) for v in d_box)
    inwin = (rows >= ry0) & (rows < ry0 + h) & (cols >= rx0) & (cols < rx0 + w)
    in_blur = (rows >= d0 - radius) & (rows <= d2 + radius) & (cols >= d1 - radius) & (cols <= d3 + radius)
    in_d = (rows >= d0) & (rows <= d2) & (cols >= d1) & (cols <= d3)
    changed = (in_d | (in_blur & (fa > 0))) & inwin
    tested = in_blur & inwin
    x_values = dilated(changed, radius, 0)
    read = dilated(x_values, 0, radius) | changed
    alpha_w = f_alpha.shape[1]
    sectors = (pixel_sectors(read, oy, ox, content_cols, 4) + pixel_sectors(tested, oy, ox, alpha_w, 4)
               + pixel_sectors(changed, oy, ox, alpha_w, 16))
    n_bytes = sectors * SECTOR_BYTES
    ops = 2 * 4 * (2 * radius + 1) * (int(x_values.sum()) + int(changed.sum()))
    byte_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "operations": ops, "bound_ms": max(byte_ms, ops_ms),
            "bound_by": "bytes" if byte_ms >= ops_ms else "operations"}
