"""Scanline sweep of edge lists to pixel spans (parity: ``polygon.ml:306-705``).

The PyTorch counterpart of ``coherence_tpu.raster.scanline``.  The sweep
runs on the host, in the port's native library (``native_lib``, a bit-exact
transcription of the JAX package's NumPy formulas; it builds with g++ on
first use; the NumPy fallback of the JAX module is not kept).  Shapes are
uploaded to the device the caller names.  See the JAX module for the
semantics in full:

* pixel row y covers subbins [32y-47 .. 32y+16] (``polygon.ml:538-541``);
* crossings at band boundaries use the reference's rounding, compounded
  when an edge is clipped top and bottom (``polygon.ml:345-385``);
* even-odd and nonzero winding (``polygon.ml:456-512``);
* shape = crossings ∪ coverage, minshape = shape − coverage
  (``polygon.ml:520-528``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import coord, native_lib
from ..geometry.path import NONZERO, Path, edgelist_of_path
from .region import NULL_SHAPE, Shape, shape_of_mask

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


def _rasterize_edges(
    edges: np.ndarray, winding: str, crossing_ext: int
) -> Optional[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Dense-mask form of the sweep, on the host.

    Returns (x0_pix, y0_pix, shape_mask, minshape_mask), with masks over
    the box that starts at pixel (x0, y0), or None for empty.
    """
    spans = _edge_spans(edges, winding, crossing_ext)
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


def _tighten(x0: int, y0: int, mask: np.ndarray, device) -> Optional[Shape]:
    if not mask.any():
        return NULL_SHAPE
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    r0, r1 = int(rows[0]), int(rows[-1])
    c0, c1 = int(cols[0]), int(cols[-1])
    sub = mask[r0 : r1 + 1, c0 : c1 + 1]
    return shape_of_mask((x0 + c0, y0 + r0, x0 + c1, y0 + r1), sub, device)


def shapeminshape_of_edgelist(edges: np.ndarray, winding: str, device):
    """Shape and minshape of an edge list (ref polygon.ml:582-603), each
    with a tight box."""
    res = _rasterize_edges(np.asarray(edges, dtype=np.int64), winding, _HALF)
    if res is None:
        return NULL_SHAPE, NULL_SHAPE
    x0, y0, smask, mmask = res
    return _tighten(x0, y0, smask, device), _tighten(x0, y0, mmask, device)


# Alias matching the reference name used for stroked paths
# (polygon.ml:608-609; sorting is irrelevant to the sweep).
def shapeminshape_of_unsorted_edgelist(edges: np.ndarray, winding: str, device):
    return shapeminshape_of_edgelist(edges, winding, device)


def shapeminshape_polygon(path: Path, device):
    """Shape/minshape of a path (ref polygon.ml:605-606)."""
    return shapeminshape_of_edgelist(edgelist_of_path(path), path.winding, device)


def scaled_mask_of_edgelist(edges: np.ndarray, winding: str, scale: int):
    """The AA supersampled coverage mask (ref polygon.ml:673-692), on the
    host: edge subbin coordinates times ``scale`` (= res/2 = 16), swept with
    unextended crossing spans but ordinary coverage spans.

    Returns (x0, y0, mask) in scaled-pixel coordinates, or None.
    """
    e = np.asarray(edges, dtype=np.int64)
    if e.shape[0] == 0:
        return None
    res = _rasterize_edges(e * scale, winding, 0)
    if res is None:
        return None
    x0, y0, smask, _ = res
    return x0, y0, smask


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
