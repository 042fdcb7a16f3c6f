"""Scanline sweep of edge lists to pixel spans (parity: ``polygon.ml:306-705``).

The subset of ``coherence_tpu.raster.scanline`` that the tiled frame path
uses.  The sweep runs on the host, in the port's native library
(``native_lib``, a bit-exact transcription of the JAX package's NumPy
formulas; it builds with g++ on first use).  See the JAX module for the
semantics in full:

* pixel row y covers subbins [32y-47 .. 32y+16] (``polygon.ml:538-541``);
* crossings at band boundaries use the reference's rounding, compounded
  when an edge is clipped top and bottom (``polygon.ml:345-385``);
* even-odd and nonzero winding (``polygon.ml:456-512``);
* shape = crossings ∪ coverage, minshape = shape − coverage
  (``polygon.ml:520-528``).
"""

from __future__ import annotations

import numpy as np

from .. import coord, native_lib
from ..geometry.path import NONZERO, Path, edgelist_of_path

_HALF = coord.halfips  # 16


def _edge_spans(edges: np.ndarray, winding: str, crossing_ext: int, rows_clip=None):
    """The core sweep: ``(cov_rows, cov_s, cov_e, cross_rows, cross_s,
    cross_e)`` inclusive pixel-column spans per pixel row (absolute
    coordinates) for the in-band coverage and the winding crossings, or
    None for empty.  rows_clip = (lo, hi) keeps pixel rows lo..hi only."""
    if edges.shape[0] == 0:
        return None
    lo, hi = rows_clip if rows_clip is not None else (-(2**62), 2**62)
    return native_lib.edge_spans(edges, winding == NONZERO, crossing_ext, lo, hi)


def shapeminshape_polygon(path: Path):
    """(x0, y0, shape_mask, minshape_mask) of a path at 1x, with masks over
    the box that starts at pixel (x0, y0), or None when the path is empty
    (ref polygon.ml:582-606; the JAX package then tightens the box, which
    moves no pixel)."""
    spans = _edge_spans(np.asarray(edgelist_of_path(path), dtype=np.int64), path.winding, _HALF)
    if spans is None:
        return None
    rows, cov_s, cov_e, cross_rows, cross_s, cross_e = spans
    all_s = np.concatenate([cov_s, cross_s])
    all_e = np.concatenate([cov_e, cross_e])
    if rows.size == 0:
        return None
    y0, y1 = int(rows.min()), int(rows.max())
    x0, x1 = int(all_s.min()), int(all_e.max())
    h, w = y1 - y0 + 1, x1 - x0 + 1

    def spans_to_mask(rws, ss, ee) -> np.ndarray:
        diff = np.zeros((h, w + 1), dtype=np.int32)
        np.add.at(diff, (rws - y0, ss - x0), 1)
        np.add.at(diff, (rws - y0, ee - x0 + 1), -1)
        return np.cumsum(diff, axis=1)[:, :-1] > 0

    cov_mask = spans_to_mask(rows, cov_s, cov_e)
    shape_mask = cov_mask | spans_to_mask(cross_rows, cross_s, cross_e)
    return x0, y0, shape_mask, shape_mask & ~cov_mask


def scaled_spans_of_edgelist(edges: np.ndarray, winding: str, scale: int, rows_clip=None):
    """The AA supersampled mask (ref polygon.ml:673-692) as inclusive
    per-row column spans in absolute scaled-pixel coordinates: the edges
    scaled by `scale`, unextended crossings.  (rows, s, e) or None."""
    e = np.asarray(edges, dtype=np.int64)
    if e.shape[0] == 0:
        return None
    spans = _edge_spans(e * scale, winding, 0, rows_clip=rows_clip)
    if spans is None:
        return None
    rows, cov_s, cov_e, cross_rows, cross_s, cross_e = spans
    all_rows = np.concatenate([rows, cross_rows])
    if all_rows.size == 0:
        return None
    return all_rows, np.concatenate([cov_s, cross_s]), np.concatenate([cov_e, cross_e])
