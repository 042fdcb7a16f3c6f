"""Packed pixels and the dense layer-stack compositor.

The PyTorch counterpart of ``coherence_tpu.raster.pallas_compositor``: its
pixel format, and ``composite_layers`` (which replaces the Pallas
``_kernel``).  Pixels are premultiplied RGBA packed in one 32-bit word,
``r | g << 8 | b << 16 | a << 24``.  PyTorch has no shifts or adds on
``uint32`` tensors, so the port stores the same bits in ``int32``.  A word
whose alpha is >= 128 is then negative and ``>>`` sign-extends, so every
field read masks with ``& 0xFF``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..colour import prelerp_arr

TILE_H = 64
TILE_W = 128


def pack_rgba(rgba: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 channels -> (...) int32 packed words.  The fields
    are OR-ed without a clamp, exactly as the JAX package packs them."""
    rgba = rgba.to(torch.int32)
    return (
        rgba[..., 0]
        | (rgba[..., 1] << 8)
        | (rgba[..., 2] << 16)
        | (rgba[..., 3] << 24)
    )


def unpack_rgba(packed: torch.Tensor) -> torch.Tensor:
    """(...) int32 packed words -> (..., 4) int32 channels 0..255."""
    return torch.stack(
        [(packed >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1
    )


def _over_packed(acc: torch.Tensor, layer: torch.Tensor) -> torch.Tensor:
    """Porter/Duff over on packed int32 planes, `acc` above `layer`.

    Bit-identical to the JAX package's uint32 form.  The reference's alpha
    0 / 255 early outs are redundant for a valid accumulator: prelerp(p, q,
    0) = p + q with q = 0, and prelerp(p, q, 255) = q for every byte p.  The
    fields pack with a bare OR and no clamp."""
    aa = (acc >> 24) & 0xFF
    ar, ag, ab = acc & 0xFF, (acc >> 8) & 0xFF, (acc >> 16) & 0xFF
    lr, lg, lb = layer & 0xFF, (layer >> 8) & 0xFF, (layer >> 16) & 0xFF
    la = (layer >> 24) & 0xFF
    r = prelerp_arr(lr, ar, aa)
    g = prelerp_arr(lg, ag, aa)
    b = prelerp_arr(lb, ab, aa)
    a = prelerp_arr(la, aa, aa)
    return r | (g << 8) | (b << 16) | (a << 24)


def composite_layers_torch(background: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    """Plain version of ``composite_layers`` (the JAX package's
    composite_layers_xla): fold the (K, H, W) stack front to back, layer 0
    topmost, under the per-pixel open mask, then `over` the background."""
    acc = torch.zeros_like(background)
    for layer in layers:
        open_mask = ((acc >> 24) & 0xFF) != 255
        acc = torch.where(open_mask, _over_packed(acc, layer), acc)
    return _over_packed(acc, background)


def composite_layers(background: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    """A dense (K, H, W) packed stack, layer 0 topmost, over a (H, W)
    packed background; H and W are tile multiples.  On the CPU the plain
    version runs; on a CUDA device the hand-written kernel launches or the
    wrapper raises."""
    if layers.device.type == "cpu":
        return composite_layers_torch(background, layers)
    return kernels.composite_layers(background, layers)
