"""The reference's renderer over a scene description: each object's layer,
the content frame, the displayed frame and the atlas pieces a tile route
should hold.  Imports nothing of the program: it works from the scene
description and the events alone."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import geometry as G
from .raster import TILE_H, TILE_W, Layer, alpha_plane, blur_blend, brush_layer, composite, gaussian, pack, path_layer
from .raster import unpack


def _brush_radius(radius: float, ops) -> float:
    """A Gaussian brush's radius under a transform list: each scale op,
    innermost first, multiplies it by the mean of |sx| and |sy|."""
    for op in reversed(list(ops)):
        if op[0] == "S":
            radius = radius * ((abs(op[3]) + abs(op[4])) / 2.0)
    return radius


class Reference:
    """Layers and frames of one scene description on `device`.  `dtype` is
    the type of the colour arithmetic (dissolve, over, the blur's sums):
    int32 is exact; anything lower is the control."""

    def __init__(self, desc: dict, device, dtype=torch.int32):
        self.device, self.dtype = torch.device(device), dtype
        self.width, self.height = desc["width"], desc["height"]
        self.pw = -(-self.width // TILE_W) * TILE_W
        self.ph = -(-self.height // TILE_H) * TILE_H
        bg = pack(torch.as_tensor(desc["background"], dtype=torch.int32))
        self.background = torch.full((self.ph, self.pw), int(bg), dtype=torch.int32, device=self.device)
        lens = desc["lens"]
        path = G.transform_path(lens["transform"], lens["path"])
        self.f_alpha = alpha_plane(G.edges_of_path(path), path[0], self.width, self.height, self.device)
        self._layers: Dict[tuple, List[Optional[Layer]]] = {}

    def layer(self, obj: dict, prefix=()) -> Optional[Layer]:
        """`obj` under the transform ops `prefix` (outermost first) and its own."""
        ops = list(prefix) + list(obj["transform"])
        path = G.transform_path(ops, obj["path"])
        if obj["kind"] == "brush":
            return brush_layer(_brush_radius(obj["radius"], ops), obj["opacity"], path, obj["rgba"], self.pw,
                               self.ph, self.device, self.dtype)
        return path_layer(G.edges_of_path(path), path[0], obj["rgba"], self.pw, self.ph, self.device, self.dtype)

    def layers(self, objs: List[dict], prefix=()) -> List[Optional[Layer]]:
        """Layers of `objs` under `prefix`, memoized by the prefix."""
        key = (id(objs[0]) if objs else None, len(objs), tuple(prefix))
        if key not in self._layers:
            self._layers[key] = [self.layer(o, prefix) for o in objs]
        return self._layers[key]

    def content(self, layers, base: Optional[torch.Tensor] = None, region=None) -> torch.Tensor:
        """The packed (ph, pw) content of `layers` front to back; with `base`
        and `region`, `base` recomposited over `region` only."""
        if base is None:
            return composite(layers, self.background, dtype=self.dtype)
        out = base.clone()
        y0, y1, x0, x1 = region
        out[y0:y1, x0:x1] = composite(layers, self.background, region, self.dtype)
        return out

    def display(self, content: torch.Tensor, radius: int) -> torch.Tensor:
        weights, total = gaussian(radius)
        frame = unpack(content[: self.height, : self.width])
        return blur_blend(frame, self.f_alpha, weights, total, self.dtype)

    def piece(self, lay: Optional[Layer], tile: int) -> torch.Tensor:
        """The (TILE_H, TILE_W) packed piece of `lay` at frame tile `tile`."""
        out = torch.zeros((TILE_H, TILE_W), dtype=torch.int32, device=self.device)
        if lay is None:
            return out
        ntx = self.pw // TILE_W
        ty0, tx0 = (tile // ntx) * TILE_H, (tile % ntx) * TILE_W
        h, w = lay.packed.shape
        y0, y1 = max(ty0, lay.y0), min(ty0 + TILE_H, lay.y0 + h)
        x0, x1 = max(tx0, lay.x0), min(tx0 + TILE_W, lay.x0 + w)
        if y0 < y1 and x0 < x1:
            out[y0 - ty0 : y1 - ty0, x0 - tx0 : x1 - tx0] = lay.packed[y0 - lay.y0 : y1 - lay.y0,
                                                                       x0 - lay.x0 : x1 - lay.x0]
        return out


def shifted(lay: Optional[Layer], dx: int, dy: int) -> Optional[Layer]:
    """A layer moved by whole pixels (a translated sprite)."""
    if lay is None:
        return None
    return Layer(lay.y0 + dy, lay.x0 + dx, lay.packed, lay.tiles)
