"""JAX-side scene state, given as numpy, into the port's objects.

This system has no weights: its state is the scene, which the JAX package
holds as device arrays plus host piece lists.  These functions rebuild the
port's objects from that state once the caller has read it out as numpy
arrays and plain Python containers, so both sides can run from one
identical atlas and set of lists.  Packed uint32 words (atlas, frame,
background, layer stacks) keep their bits as int32.

A scene as objects (paths, fills, filters, transforms) is carried the other
way, as text: ``scene/checkpoint.py`` writes the same JSON in both packages,
so a scene saved by the JAX package's ``scene_to_json`` is read by the
port's ``scene_from_json`` and the reverse, with fresh ids on load.

Keys stay whatever hashable objects the JAX side used.  A converted view
carries no source objects (``DeviceView.objs``), so it cannot re-rasterize
a tiled-built object that has no materialized sprite.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .parallel.mesh import Mesh
from .raster.region import Canvas, Shape, Sprite
from .raster.tiled_scene import BandedAtlas, TiledScene
from .scene.fastframe import DeviceView, FilteredDisplay


def packed(words: np.ndarray, device) -> torch.Tensor:
    """uint32 packed pixels -> int32 tensor with the same bits."""
    words = np.ascontiguousarray(words)
    if words.dtype != np.uint32:
        raise ValueError(f"packed pixels must be uint32, got {words.dtype}")
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def layers(words: np.ndarray, device) -> torch.Tensor:
    """A packed uint32 (K, H, W) layer stack (the JAX package's
    composite_layers input) -> the port's int32 stack, same bits."""
    words = np.asarray(words)
    if words.ndim != 3:
        raise ValueError(f"a layer stack is (K, H, W), got shape {words.shape}")
    return packed(words, device)


def plane(values: np.ndarray, device) -> torch.Tensor:
    """An int32 plane (alpha plane, display) as a tensor."""
    return torch.from_numpy(np.array(values, dtype=np.int32)).to(device)


def sprite(box, mask: np.ndarray, rgba: np.ndarray, device) -> Sprite:
    """A Sprite from a JAX Sprite's box and its mask and colour plane,
    both cropped to the box's extent."""
    return Sprite(
        tuple(int(v) for v in box),
        torch.from_numpy(np.array(mask, dtype=bool)).to(device),
        plane(rgba, device),
    )


def shape(box, mask: np.ndarray, full_box: bool, device) -> Shape:
    """A Shape from a JAX Shape's state: its box, its mask cropped to the
    box's extent (``Shape.mask_np()`` there) and its ``full_box`` flag.
    Emptiness is left unknown, as after a device operation."""
    box = tuple(int(v) for v in box)
    mask = np.array(mask, dtype=bool)
    if mask.shape != (box[3] - box[1] + 1, box[2] - box[0] + 1):
        raise ValueError(f"mask of shape {mask.shape} over box {box}")
    return Shape(box, torch.from_numpy(mask).to(device), full_box=bool(full_box))


def canvas(rgba: np.ndarray, origin, device) -> Canvas:
    """A Canvas from a JAX Canvas's (H, W, 4) int32 plane and origin."""
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"a canvas is (H, W, 4), got shape {rgba.shape}")
    return Canvas(plane(rgba, device), (int(origin[0]), int(origin[1])))


def tiled_scene(width: int, height: int, *, atlas: np.ndarray,
                pieces: Dict[object, List[Tuple[int, int]]],
                reserved: Dict[object, Tuple[int, int]], n_pieces: int, device) -> TiledScene:
    """A TiledScene holding the given atlas (uint32 (cap, 64, 128)), piece
    lists (key -> [(tile, slot)]), reserved runs and slot count."""
    ts = TiledScene(width, height, device)
    ts._data = packed(atlas, device)
    ts._n_pieces = int(n_pieces)
    ts._reserved = {k: (int(b), int(c)) for k, (b, c) in reserved.items()}
    for key, entries in pieces.items():
        ts.pieces[key] = [(int(t), int(e)) for t, e in entries]
    return ts


def device_view(width: int, height: int, *, atlas, pieces, reserved, n_pieces,
                order, frame: np.ndarray, background: np.ndarray,
                sprites: Dict[object, tuple], device) -> DeviceView:
    """A DeviceView with the given scene, order (keys front to back),
    packed frame and background, and materialized sprites (key -> (box,
    mask, rgba) or None); nothing is marked dirty."""
    view = DeviceView(width, height, device=device)
    view.ts = tiled_scene(
        view.pw, view.ph, atlas=atlas, pieces=pieces, reserved=reserved,
        n_pieces=n_pieces, device=device,
    )
    view.order = list(order)
    view.frame = packed(frame, device)
    view.background = packed(background, device)
    view.sprites = {k: None if s is None else sprite(*s, device) for k, s in sprites.items()}
    view.dirty = set()
    return view


def filtered_display(view: DeviceView, *, f_alpha: np.ndarray, display: np.ndarray,
                     kernel) -> FilteredDisplay:
    """A FilteredDisplay over `view` with the given alpha plane and current
    display plane ((height, width, 4) int32)."""
    disp = FilteredDisplay(view, plane(f_alpha, view.device), kernel)
    disp.rgba = plane(display, view.device)
    return disp


def banded_atlas(mesh: Mesh, *, data: np.ndarray, g2l: List[Dict[int, int]],
                 reserved_local: Dict[object, int], local_cap: int, version: int) -> BandedAtlas:
    """A BandedAtlas holding a JAX BandedAtlas's state: data (n_bands,
    local_cap, 64, 128) uint32, each band's global-to-local slot map, the
    reserved blocks' local offsets, local_cap and the PieceMap version it
    matches.  Installed as a TiledScene's ``_banded`` with the same piece
    lists, both sides run from one banded state."""
    stack = packed(data, "cpu")
    if tuple(stack.shape) != (mesh.size, int(local_cap), 64, 128):
        raise ValueError(f"banded data of shape {tuple(stack.shape)} does not fit {mesh} at local_cap {local_cap}")
    return BandedAtlas.from_state(
        mesh, [stack[b0:b1].to(dev) for dev, b0, b1 in mesh.groups],
        [{int(g): int(l) for g, l in m.items()} for m in g2l], dict(reserved_local), int(local_cap), int(version),
    )
