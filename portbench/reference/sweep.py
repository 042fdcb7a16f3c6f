"""The scanline sweep of a subbin edge list into pixel spans, in NumPy.

Frozen from coherence_tpu/raster/scanline.py:52-222, the NumPy form of the
sweep that the program's native library transcribes (the program keeps only
the native one).  Pixel row y covers subbins [32y - 47, 32y + 16]; crossings
at band boundaries round as the renderer does, compounded when an edge is
clipped top and bottom; even-odd and nonzero winding.
"""

from __future__ import annotations

import numpy as np

from .geometry import HALF, IPS, NONZERO, pix_of_sub


def _ceil_div(a, b):
    return -((-a) // b)


def edge_spans(edges: np.ndarray, winding: str, crossing_ext: int, rows_clip=None):
    """(cov_rows, cov_s, cov_e, cross_rows, cross_s, cross_e): inclusive
    pixel-column spans per pixel row, absolute, for the in-band coverage and
    the winding crossings, or None for nothing.  rows_clip = (lo, hi) keeps
    pixel rows lo..hi."""
    if edges.shape[0] == 0:
        return None
    ex0, ey0, ex1, ey1 = (edges[:, k].astype(np.int64) for k in range(4))
    ymin = np.minimum(ey0, ey1)
    ymax = np.maximum(ey0, ey1)
    up = ey1 > ey0
    down = ey0 > ey1
    x0in = np.where(down, ex1, np.where(up, ex0, np.minimum(ex0, ex1)))
    x1in = np.where(down, ex0, np.where(up, ex1, np.maximum(ex0, ex1)))
    dirs = np.where(up, 1, -1).astype(np.int64)
    denom = (ymax - ymin).astype(np.float64)
    grad = np.where(denom == 0.0, 0.0, (x1in - x0in) / np.where(denom == 0, 1, denom))
    ylo = _ceil_div(ymin - HALF, IPS)
    yhi = (ymax + (IPS + HALF - 1)) // IPS
    counts = (yhi - ylo + 1).astype(np.int64)
    eidx = np.repeat(np.arange(edges.shape[0]), counts)
    total = int(counts.sum())
    starts = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    rows = ylo[eidx] + (np.arange(total, dtype=np.int64) - np.repeat(starts, counts))
    if rows_clip is not None:
        keep = (rows >= rows_clip[0]) & (rows <= rows_clip[1])
        if not keep.all():
            eidx, rows = eidx[keep], rows[keep]
            if rows.size == 0:
                return None
    top = IPS * rows - (IPS + HALF - 1)
    bot = top + 2 * IPS - 1
    pe_ymin, pe_ymax = ymin[eidx], ymax[eidx]
    pe_x0 = x0in[eidx].astype(np.float64)
    pe_x1, pe_g, pe_dir = x1in[eidx], grad[eidx], dirs[eidx]
    has_top = pe_ymin < top
    has_bot = pe_ymax > bot
    x_t = np.trunc(pe_x0 + pe_g * ((top - 1 - pe_ymin) + 0.25) + 0.5).astype(np.int64)
    x_b_plain = np.trunc(pe_x0 + pe_g * ((bot - pe_ymin) + 0.25) + 0.5).astype(np.int64)
    x_b_comp = np.trunc(x_t.astype(np.float64) + pe_g * ((2 * IPS - 1) + 0.25) + 0.5).astype(np.int64)
    x_b = np.where(has_top, x_b_comp, x_b_plain)
    a = np.where(has_top, x_t, x0in[eidx])
    b = np.where(has_bot, x_b, pe_x1)
    cov_s = pix_of_sub(np.minimum(a, b) - HALF)
    cov_e = pix_of_sub(np.maximum(a, b) + HALF)

    def crossing_spans(sel, xs):
        r, x, d = rows[sel], xs[sel], pe_dir[sel]
        if r.size == 0:
            return r, x, x
        order = np.lexsort((x, r))
        r, x, d = r[order], x[order], d[order]
        same_row_next = np.zeros(len(r), dtype=bool)
        same_row_next[:-1] = r[:-1] == r[1:]
        new_row = np.ones(len(r), dtype=bool)
        new_row[1:] = r[1:] != r[:-1]
        if winding == NONZERO:
            csum = np.cumsum(d)
            base = (csum - d)[np.flatnonzero(new_row)]
            emit = same_row_next & ((csum - base[np.cumsum(new_row) - 1]) != 0)
        else:
            row_start = np.where(new_row, np.arange(len(r)), 0)
            np.maximum.accumulate(row_start, out=row_start)
            emit = same_row_next & ((np.arange(len(r)) - row_start) % 2 == 0)
        i = np.nonzero(emit)[0]
        return r[i], pix_of_sub(x[i] - crossing_ext), pix_of_sub(x[i + 1] + crossing_ext)

    t_rows, t_s, t_e = crossing_spans(has_top, x_t)
    b_rows, b_s, b_e = crossing_spans(has_bot, x_b)
    return (rows, cov_s, cov_e, np.concatenate([t_rows, b_rows]), np.concatenate([t_s, b_s]),
            np.concatenate([t_e, b_e]))


def scaled_spans(edges: np.ndarray, winding: str, scale: int, rows_clip=None):
    """The 16x anti-aliasing mask as (rows, s, e) spans in scaled pixels:
    the edges times `scale`, crossings not extended; None for nothing."""
    if edges.shape[0] == 0:
        return None
    spans = edge_spans(edges * scale, winding, 0, rows_clip=rows_clip)
    if spans is None:
        return None
    rows, cs, ce, xr, xs, xe = spans
    if rows.size + xr.size == 0:
        return None
    return np.concatenate([rows, xr]), np.concatenate([cs, xs]), np.concatenate([ce, xe])
