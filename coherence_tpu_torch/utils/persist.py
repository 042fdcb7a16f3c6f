"""Sprite/shape persistence (parity: sprite.ml:377-400 — OCaml Marshal of
sprites/shapes to files for toplevel inspection).  Saved as .npz so numpy or
any tool can inspect them; also the checkpoint substrate for caches.

The PyTorch counterpart of ``coherence_tpu.utils.persist``: the files are the
same (a sprite or shape saved by either package loads in the other), and a
load takes the device the raster is to live on."""

from __future__ import annotations

import numpy as np
import torch

from ..raster import region


def save_sprite(path: str, spr) -> None:
    if spr is None:
        np.savez_compressed(path, null=np.array(True))
        return
    region._sync()
    np.savez_compressed(
        path,
        box=np.array(spr.box, dtype=np.int64),
        mask=spr.mask.cpu().numpy(),
        rgba=spr.rgba.cpu().numpy().astype(np.int32),
    )


def load_sprite(path: str, device):
    d = np.load(path)
    if "null" in d:
        return region.NULL_SPRITE
    box = tuple(int(v) for v in d["box"])
    shp = region.shape_of_mask(box, d["mask"], device)
    if shp is None:
        return region.NULL_SPRITE
    rgba = torch.from_numpy(d["rgba"].astype(np.int32)).to(device)
    return region.sprite_of_mask_rgba(box, shp.mask, rgba)


def save_shape(path: str, shp) -> None:
    if shp is None:
        np.savez_compressed(path, null=np.array(True))
        return
    np.savez_compressed(
        path, box=np.array(shp.box, dtype=np.int64), mask=shp.mask_np()
    )


def load_shape(path: str, device):
    d = np.load(path)
    if "null" in d:
        return region.NULL_SHAPE
    return region.shape_of_mask(tuple(int(v) for v in d["box"]), d["mask"], device)
