"""The device window path: a framebuffer recomposited window by window
(parity: ``coherence_tpu.raster.framepath``).

Per frame the host does box arithmetic only: the layers whose boxes meet
the dirty window, front to back, and each one's offset in the window.  One
fold (``fold_layers_carry``) composites them with an occupancy plane, the
caf-over and newly-opaque semantics of render.ml:1291-1308, and the window
is written back into the framebuffer.  The same fold serves the batched
group compositor (``scene/fastframe.group_sprite_batched``).

``fold_layers_carry`` picks by device: on the CPU the plain version beside
it here, on a CUDA device the hand-written kernel ``fold_layers``
(``coherence_tpu_torch.kernels``) or an error.  Where the JAX package
donates the frame to a program that returns it, ``FrameBuffer`` updates
its window in place.

Also here: the blur filter's window geometry and blend, shared by every
blur path (render.ml:1248-1265).  ``blur_blend_into`` (a window, in place)
and ``blur_blend_rect`` (the whole frame) pick by device as the fold does:
the plain versions here (``blur``, ``conv_blend_window``,
``apply_blur_rect``) on the CPU, the hand-written kernel ``blur_blend`` on
a CUDA device or an error.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import colour as C
from .. import kernels
from .compositor import unpack_rgba
from .convolve import _conv1d_exact, _setcanvas_xy
from .region import Box, Sprite, box_intersect, box_wh, bucket_hw


def fold_layers_carry_torch(offs, layers, acc, open_mask, covered):
    """Plain version of ``fold_layers``: the front-to-back caf-over fold of
    `layers` ((rgba, mask) pairs, int32 (hs, ws, 4) and bool (hs, ws)),
    layer k's origin at offs[k] = (dy, dx) in window coordinates, into the
    carry (int32 (hb, wb, 4) acc, bool (hb, wb) open_mask and covered).  A
    pixel takes a layer where the layer's mask is set and the pixel is
    open, and closes once its alpha is 255.  Returns the new carry; the
    inputs are left as they were."""
    acc, open_mask, covered = acc.clone(), open_mask.clone(), covered.clone()
    hb, wb = open_mask.shape
    for (dy, dx), (rgba, mask) in zip(offs, layers):
        dy, dx = int(dy), int(dx)
        hs, ws = mask.shape
        y0, y1 = max(0, dy), min(hb, dy + hs)
        x0, x1 = max(0, dx), min(wb, dx + ws)
        if y0 >= y1 or x0 >= x1:
            continue
        a = acc[y0:y1, x0:x1]
        paint = mask[y0 - dy : y1 - dy, x0 - dx : x1 - dx] & open_mask[y0:y1, x0:x1]
        a.copy_(torch.where(paint[..., None], C.over_rgba(a, rgba[y0 - dy : y1 - dy, x0 - dx : x1 - dx]), a))
        covered[y0:y1, x0:x1] |= paint
        open_mask[y0:y1, x0:x1] &= ~(paint & (a[..., 3] == 255))
    return acc, open_mask, covered


def fold_layers_carry(offs, layers, acc, open_mask, covered):
    """The one fold body shared by the window recomposites and the batched
    group compositor; chunking with this carry is the identity for a left
    fold.  Returns (acc, open_mask, covered)."""
    if acc.device.type == "cpu":
        return fold_layers_carry_torch(offs, layers, acc, open_mask, covered)
    return kernels.fold_layers(offs, [(r.contiguous(), m.contiguous()) for r, m in layers], acc.contiguous(),
                               open_mask.contiguous(), covered.contiguous())


def _window_mask(hb: int, wb: int, ry0: int, rx0: int, h: int, w: int, device):
    """(rows, cols, inwin): the logical window [ry0, ry0+h) x [rx0, rx0+w)
    of a bucketed (hb, wb) block."""
    rows = torch.arange(hb, device=device)[:, None]
    cols = torch.arange(wb, device=device)[None, :]
    return rows, cols, (rows >= ry0) & (rows < ry0 + h) & (cols >= rx0) & (cols < rx0 + w)


def _fold_fresh(offs, layers: Sequence[Sprite], inwin):
    """A fresh fold of sprites clipped to the logical window."""
    hb, wb = inwin.shape
    acc = torch.zeros((hb, wb, 4), dtype=torch.int32, device=inwin.device)
    covered = torch.zeros((hb, wb), dtype=torch.bool, device=inwin.device)
    return fold_layers_carry(offs, [(s.rgba, s.mask) for s in layers], acc, inwin, covered)[0]


class FrameBuffer:
    """A framebuffer of (height, width, 4) int32 RGBA on `device`, with
    incremental window compositing."""

    def __init__(self, width: int, height: int, bg_colour: int, *, device):
        self.device = torch.device(device)
        self.width, self.height = width, height
        self.bg = torch.tensor(C.rgba_of_colour(bg_colour), dtype=torch.int32, device=self.device)
        self.rgba = self.bg.expand(height, width, 4).clone()
        # The framebuffer's box in scene coordinates (1-based, as the reference's).
        self.box: Box = (1, 1, width, height)

    def clear_window(self, box: Box) -> None:
        ib = box_intersect(box, self.box)
        if ib is None:
            return
        self.rgba[ib[1] - 1 : ib[3], ib[0] - 1 : ib[2]] = self.bg

    def _window(self, box: Box):
        """The bucketed window covering `box`, clamped to the framebuffer:
        (oy, ox, ry0, rx0, h, w, hb, wb)."""
        w, h = box_wh(box)
        hb, wb = bucket_hw(h, w)
        hb, wb = min(hb, self.height), min(wb, self.width)
        oy, ox = min(box[1] - 1, self.height - hb), min(box[0] - 1, self.width - wb)
        return oy, ox, box[1] - 1 - oy, box[0] - 1 - ox, h, w, hb, wb

    def composite(self, box: Box, layers: Sequence[Sprite]) -> None:
        """Composite sprites (front to back) over the window `box`, one fold
        for the whole list.  Painting is clipped to `box`, so sprites that
        reach into the bucket's padding never blend twice over content that
        already holds them."""
        ib = box_intersect(box, self.box)
        if ib is None or not layers:
            return
        oy, ox, ry0, rx0, h, w, hb, wb = self._window(ib)
        offs = [(s.box[1] - (oy + 1), s.box[0] - (ox + 1)) for s in layers]
        _, _, inwin = _window_mask(hb, wb, ry0, rx0, h, w, self.device)
        acc = _fold_fresh(offs, layers, inwin)
        win = self.rgba[oy : oy + hb, ox : ox + wb]
        win.copy_(C.over_rgba(acc, win))

    def read(self) -> np.ndarray:
        """(height, width, 4) int32 RGBA, a host copy."""
        return self.rgba.to("cpu", copy=True).numpy()

    def _layer_pack(self, layers: Sequence[Sprite], win: Box, oy: int, ox: int, prefilter: bool):
        """(offsets, sprites): the front-to-back layers meeting `win` (every
        layer with prefilter=False; one outside the window adds nothing)."""
        keep = [s for s in layers if s is not None and (not prefilter or box_intersect(s.box, win))]
        return [(s.box[1] - (oy + 1), s.box[0] - (ox + 1)) for s in keep], keep

    def _recomposited(self, box: Box, layers, prefilter: bool, oy, ox, ry0, rx0, h, w, hb, wb):
        """(window view, rows, cols, inwin, content): the window's content
        recomposited from the layer stack over the background colour inside
        the logical window, the framebuffer's pixels outside it."""
        offs, keep = self._layer_pack(layers, box, oy, ox, prefilter)
        rows, cols, inwin = _window_mask(hb, wb, ry0, rx0, h, w, self.device)
        acc = _fold_fresh(offs, keep, inwin)
        win = self.rgba[oy : oy + hb, ox : ox + wb]
        base = torch.where(inwin[..., None], self.bg, win)
        return win, rows, cols, inwin, C.over_rgba(acc, base)

    def recomposite(self, box: Box, layers: Sequence[Sprite], prefilter: bool = True) -> None:
        """Replace the window `box` with the front-to-back fold of `layers`
        over the background colour: the incremental re-render of a dirty
        region.  `layers` is the scene's whole front-to-back list (or any
        superset of those meeting the box).

        Integer `over` is not associative, so painting a moved sprite over a
        composited snapshot would differ by one wherever two translucent
        layers stack; the window is folded from the layer stack instead, as
        render_scene folds (render.ml:1310-1335)."""
        ib = box_intersect(box, self.box)
        if ib is None:
            return
        oy, ox, ry0, rx0, h, w, hb, wb = self._window(ib)
        win, _, _, _, content = self._recomposited(ib, layers, prefilter, oy, ox, ry0, rx0, h, w, hb, wb)
        win.copy_(content)

    def apply_blur(self, f_alpha: torch.Tensor, kernel) -> None:
        """Blend the blur of the whole frame into the filter geometry's
        alpha plane (the blur filter's first application, filters.ml:247-261
        and the blend' of render.ml:1248-1265)."""
        self.rgba = blur_blend_rect(self.rgba, f_alpha, tuple(kernel.values), kernel.total)

    def recomposite_blur(self, dirty: Box, layers: Sequence[Sprite], f_alpha: torch.Tensor, kernel,
                         prefilter: bool = True) -> None:
        """An animated frame under a live blur filter: the window (the dirty
        box bloated by 2 * radius) recomposited from the layer stack as in
        `recomposite`, the changed part re-blurred and blended by the filter
        geometry's alpha plane (f_alpha: (height, width) int32, the
        geometry's pure-AA alpha, fastframe.alpha_plane_of_object)."""
        got = blur_window(dirty, self.box, kernel.radius, self.height, self.width)
        if got is None:
            return
        _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = got
        logical = (ox + 1 + rx0, oy + 1 + ry0, ox + rx0 + w, oy + ry0 + h)
        content = self._recomposited(logical, layers, prefilter, oy, ox, ry0, rx0, h, w, hb, wb)[4]
        blur_blend_into(self.rgba, content, (0, 0), f_alpha, (oy, ox), hb, wb, ry0, rx0, h, w, d_box,
                        tuple(kernel.values), kernel.total)


def blur_window(dirty: Box, logical: Box, radius: int, height: int, width: int):
    """(d, oy, ox, ry0, rx0, h, w, hb, wb, d_box), or None when `dirty`
    misses `logical`.  The window is the dirty box bloated by 2*radius,
    clamped, bucketed and clamped to the frame; d_box is the dirty rect in
    WINDOW coordinates (row0, col0, row1, col1 inclusive)."""
    d = box_intersect(dirty, logical)
    if d is None:
        return None
    d2 = box_intersect(
        (d[0] - 2 * radius, d[1] - 2 * radius, d[2] + 2 * radius, d[3] + 2 * radius),
        logical,
    )
    w, h = box_wh(d2)
    hb, wb = bucket_hw(h, w)
    hb = min(hb, height)
    wb = min(wb, width)
    oy = min(d2[1] - 1, height - hb)
    ox = min(d2[0] - 1, width - wb)
    d_box = np.asarray(
        [d[1] - 1 - oy, d[0] - 1 - ox, d[3] - 1 - oy, d[2] - 1 - ox], np.int32
    )
    return d, oy, ox, d2[1] - 1 - oy, d2[0] - 1 - ox, h, w, hb, wb, d_box


def blur(content: torch.Tensor, weights: tuple, total: int) -> torch.Tensor:
    """The exact separable Gaussian of (H, W, 4) int32 content: the x pass,
    then the y pass, each divided and clamped (convolve.ml:115-158)."""
    cx = _setcanvas_xy(_conv1d_exact(content, weights, axis=1), total)
    return _setcanvas_xy(_conv1d_exact(cx, weights, axis=0), total)


def conv_blend_window(content, f_alpha_win, inwin, rows, cols, d_box, weights, total):
    """The blur filter's window pass: out = dissolve(scene, 255-a) +
    dissolve(blur, a) (render.ml:1248-1265), on the changed mask
    in_d | (bloat(in_d, r) & a > 0), clipped to the logical window.
    Returns (changed, blended)."""
    cy = blur(content, weights, total)
    radius = len(weights) // 2

    def rect(b0, b1, b2, b3):
        return (rows >= b0) & (rows <= b2) & (cols >= b1) & (cols <= b3)

    d0, d1, d2, d3 = (int(v) for v in d_box)
    in_d = rect(d0, d1, d2, d3)
    in_blur = rect(d0 - radius, d1 - radius, d2 + radius, d3 + radius)
    changed = (in_d | (in_blur & (f_alpha_win > 0))) & inwin
    blended = C.dissolve_rgba(content, 255 - f_alpha_win) + C.dissolve_rgba(cy, f_alpha_win)
    return changed, blended


def apply_blur_rect(frame: torch.Tensor, f_alpha: torch.Tensor, weights: tuple, total: int) -> torch.Tensor:
    """Full-frame pass: the blur of `frame` blended in by the filter
    geometry's alpha plane wherever it is positive."""
    cy = blur(frame, weights, total)
    blended = C.dissolve_rgba(frame, 255 - f_alpha) + C.dissolve_rgba(cy, f_alpha)
    return torch.where(f_alpha[..., None] > 0, blended, frame)


def blur_blend_into_torch(display, content, content_at, f_alpha, at, hb, wb, ry0, rx0, h, w, d_box, weights,
                          total):
    """Plain version of ``blur_blend`` in window mode: the hb x wb window of
    `display` ((H, W, 4) int32) at `at` = (oy, ox) takes conv_blend_window's
    blend where it changes, in place.  The content window is read at
    `content_at` from a packed (rows, cols) int32 plane or unpacked (rows,
    cols, 4) RGBA; `f_alpha` ((H, W) int32) at `at`."""
    (cy, cx), (oy, ox) = content_at, at
    win_c = content[cy : cy + hb, cx : cx + wb]
    if content.dim() == 2:
        win_c = unpack_rgba(win_c)
    rows, cols, inwin = _window_mask(hb, wb, ry0, rx0, h, w, display.device)
    changed, blended = conv_blend_window(win_c, f_alpha[oy : oy + hb, ox : ox + wb], inwin, rows, cols, d_box,
                                         weights, total)
    win = display[oy : oy + hb, ox : ox + wb]
    win.copy_(torch.where(changed[..., None], blended, win))
    return display


def blur_blend_into(display, content, content_at, f_alpha, at, hb, wb, ry0, rx0, h, w, d_box, weights, total):
    """The blur filter's window pass, in place in `display`
    (blur_blend_into_torch's function): the window [ry0, ry0 + h) x [rx0,
    rx0 + w) of the hb x wb block, d_box the dirty rect, both in window
    coordinates."""
    if display.device.type == "cpu":
        return blur_blend_into_torch(display, content, content_at, f_alpha, at, hb, wb, ry0, rx0, h, w, d_box,
                                     weights, total)
    return kernels.blur_blend_window(content, content_at, f_alpha, display, at, hb, wb, ry0, rx0, h, w, d_box,
                                     weights, total)


def blur_blend_rect(content, f_alpha, weights: tuple, total: int) -> torch.Tensor:
    """apply_blur_rect of the frame at the top left of `content` (a packed
    (rows, cols) int32 plane or unpacked (rows, cols, 4) RGBA) of f_alpha's
    (H, W) size, into a new (H, W, 4) plane."""
    if f_alpha.device.type == "cpu":
        height, width = f_alpha.shape
        frame = content[:height, :width]
        if content.dim() == 2:
            frame = unpack_rgba(frame)
        return apply_blur_rect(frame, f_alpha, weights, total)
    return kernels.blur_blend_rect(content, f_alpha, weights, total)
