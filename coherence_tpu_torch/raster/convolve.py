"""Convolution kernels over sprites (parity: reference ``convolve.ml``).

The PyTorch counterpart of ``coherence_tpu.raster.convolve``, whole.  Three
kernel classes with the reference's exact integer arithmetic:

* ``UnitKernel r``: box kernel; an exact box sum via two 1D passes, each
  divided by ``2r+1`` with no clamp (convolve.ml:160-204).
* ``XYKernel``: separable (e.g. Gaussian, convolve.ml:57-70): 1D x-pass then
  1D y-pass with per-pass integer division and the reference's channel
  clamping quirk (r and g clamped to alpha, b NOT; convolve.ml:115-119).
* ``FullKernel``: dense square kernel, one 2D sum, divided with no clamp.

Each pass is a sum of int32 shifted copies, one per tap, with SAME zero
padding.  The JAX package instead runs float convolutions and splits weights
into base-256 limbs so that a TPU's bf16 inputs stay exact; integer sums
need neither, and ``F.conv2d`` is avoided because cuDNN may round float32
through TF32.

Convolving "within a shape" (convolve.ml:207-232): the x-pass writes only
pixels inside the shape (reads may come from outside), and the y-pass reads
that mixed canvas.

On a CUDA device ``convolve_canvas`` launches the hand-written kernel of
``kernels/csrc/convolve.cu`` (CV1) on ``kernels.convolve_route``'s route
(one launch for both passes where the tile and its halo fit shared memory,
else one a pass), or raises; on the CPU it runs the plain version beside
it, ``convolve_canvas_torch``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union

import torch

from .. import colour as C
from .. import kernels
from . import region
from .region import NULL_SPRITE, Canvas


@dataclass(frozen=True)
class FullKernel:
    radius: int
    total: int
    values: tuple  # (2r+1, 2r+1) nested tuples of ints


@dataclass(frozen=True)
class XYKernel:
    radius: int
    total: int
    values: tuple  # (2r+1,) ints


@dataclass(frozen=True)
class UnitKernel:
    radius: int


Kernel = Union[FullKernel, XYKernel, UnitKernel]


def mkunit(r: int) -> UnitKernel:
    if r <= 0:
        raise ValueError("mkunit: radius must be positive")
    return UnitKernel(r)


def mkxy(r: int, f) -> XYKernel:
    if r <= 0:
        raise ValueError("mkxy: radius must be positive")
    vals = tuple(f(i - r) for i in range(2 * r + 1))
    return XYKernel(r, sum(vals), vals)


def mkfull(r: int, f) -> FullKernel:
    if r <= 0:
        raise ValueError("mkfull: radius must be positive")
    rows = tuple(tuple(f(i - r, j - r) for i in range(2 * r + 1)) for j in range(2 * r + 1))
    return FullKernel(r, sum(map(sum, rows)), rows)


def _gaussian(r: int, x: int, y: int) -> int:
    # convolve.ml:60-64: 4r^2 * exp(-(x/r)^2 - (y/r)^2) / 2, rounded.
    g = math.exp(-((x / r) ** 2 + (y / r) ** 2)) / 2.0
    return int(4 * r * r * g + 0.5)


def mkgaussian(r: int) -> XYKernel:
    """Gaussian separable kernel (convolve.ml:67-70)."""
    return mkxy(r, lambda x: _gaussian(r, x, 0))


def radius_of_kernel(k: Kernel) -> int:
    return k.radius


def _conv1d_exact(img: torch.Tensor, weights: tuple, axis: int) -> torch.Tensor:
    """Exact integer correlation of int32 (H, W, 4) along `axis` (0 = y,
    1 = x) with SAME zero padding: out[i] = sum_k w[k] * img[i + k - pad]."""
    n = len(weights)
    pad = (n - 1) // 2
    size = img.shape[axis]
    shape = list(img.shape)
    shape[axis] += 2 * pad
    padded = torch.zeros(shape, dtype=torch.int32, device=img.device)
    padded.narrow(axis, pad, size).copy_(img)
    out = torch.zeros_like(img, dtype=torch.int32)
    for k, wk in enumerate(weights):
        if wk:
            out += int(wk) * padded.narrow(axis, k, size)
    return out


def _conv2d_exact(img: torch.Tensor, weights: tuple) -> torch.Tensor:
    """Exact integer 2D correlation of int32 (H, W, 4) with SAME zero
    padding: out[i, j] = sum_kl w[k][l] * img[i + k - pad, j + l - pad]."""
    n = len(weights)
    pad = (n - 1) // 2
    H, W = img.shape[:2]
    padded = torch.zeros((H + 2 * pad, W + 2 * pad, 4), dtype=torch.int32, device=img.device)
    padded[pad : pad + H, pad : pad + W] = img
    out = torch.zeros_like(img, dtype=torch.int32)
    for k, row in enumerate(weights):
        for l, wkl in enumerate(row):
            if wkl:
                out += int(wkl) * padded[k : k + H, l : l + W]
    return out


def _setcanvas_xy(sums: torch.Tensor, total: int) -> torch.Tensor:
    """Integer divide and the reference's channel clamp (convolve.ml:115-119):
    r and g clamp to alpha; b deliberately does not (the `min tb tb` quirk)."""
    q = sums // total
    ta = q[..., 3]
    return torch.stack(
        [torch.minimum(ta, q[..., 0]), torch.minimum(ta, q[..., 1]), q[..., 2], ta], dim=-1
    )


def card_kernel(kernel: Kernel) -> tuple:
    """(kind, weights, total, radius) of `kernel` as CV1 takes it: a full
    kernel's weights row by row."""
    if isinstance(kernel, FullKernel):
        return "full", tuple(v for row in kernel.values for v in row), kernel.total, kernel.radius
    if isinstance(kernel, XYKernel):
        return "xy", kernel.values, kernel.total, kernel.radius
    n = 2 * kernel.radius + 1
    return "unit", (1,) * n, n, kernel.radius


def convolve_canvas(kernel: Kernel, canvas_rgba: torch.Tensor, shape_mask: torch.Tensor) -> torch.Tensor:
    """Convolve the int32 (H, W, 4) canvas within shape_mask (bool, at least
    (H, W); its top-left (H, W) corner is used) -- convolve.ml:207-232.  On
    a CUDA device CV1 (kernels.convolve_canvas) on kernels.convolve_route's
    route."""
    if canvas_rgba.is_cuda:
        return kernels.convolve_canvas(*card_kernel(kernel), canvas_rgba, shape_mask)
    return convolve_canvas_torch(kernel, canvas_rgba, shape_mask)


def convolve_canvas_torch(kernel: Kernel, canvas_rgba: torch.Tensor, shape_mask: torch.Tensor) -> torch.Tensor:
    """The plain version of convolve_canvas, on any device."""
    c = canvas_rgba.to(torch.int32)
    m = shape_mask[: c.shape[0], : c.shape[1], None]
    if isinstance(kernel, FullKernel):
        return torch.where(m, _conv2d_exact(c, kernel.values) // kernel.total, c)
    if isinstance(kernel, XYKernel):
        cx = torch.where(m, _setcanvas_xy(_conv1d_exact(c, kernel.values, 1), kernel.total), c)
        return torch.where(m, _setcanvas_xy(_conv1d_exact(cx, kernel.values, 0), kernel.total), cx)
    # UnitKernel: box blur, plain integer division, no clamping
    # (convolve.ml:160-204 uses rgba tuples + div4).
    n = 2 * kernel.radius + 1
    ones = (1,) * n
    cx = torch.where(m, _conv1d_exact(c, ones, 1) // n, c)
    return torch.where(m, _conv1d_exact(cx, ones, 0) // n, cx)


def convolve_sprite(kernel: Kernel, sprite):
    """Flatten -> convolve -> pick up (convolve.ml:239-258)."""
    if sprite is None:
        return NULL_SPRITE
    r = radius_of_kernel(kernel)
    canvas = region.flatten_sprite(2 * r, sprite, C.clear)
    shape = region.bloat(r, r, region.shape_of_sprite(sprite))
    return _convolve_pickup(kernel, canvas, shape, shape)


def convolve_sprite_in_shape(kernel: Kernel, sprite, shape, pickup_shape):
    """Partial variant for filters (convolve.ml:265-296)."""
    if sprite is None:
        return NULL_SPRITE
    r = radius_of_kernel(kernel)
    canvas = region.flatten_sprite(2 * r, sprite, C.clear)
    return _convolve_pickup(kernel, canvas, shape, pickup_shape)


def _convolve_pickup(kernel: Kernel, canvas: Canvas, shape, pickup_shape):
    if shape is None or pickup_shape is None:
        return NULL_SPRITE
    ox, oy = canvas.origin
    canvas_box = (ox, oy, ox + canvas.width - 1, oy + canvas.height - 1)
    # Shape mask expressed over the canvas extent.
    m = region._window(shape.mask, shape.box, canvas_box)
    out = convolve_canvas(kernel, canvas.rgba, m)
    # Pickup shape must lie within the canvas (guaranteed by flatten border).
    ps = region.shape_intersection(pickup_shape, region.shape_of_box(canvas_box, out.device))
    if ps is None:
        return NULL_SPRITE
    return region.pickup(ps, Canvas(out, canvas.origin))
