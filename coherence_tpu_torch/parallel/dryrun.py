"""Multi-band dry run: the port's twin of ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n_bands, devices=None)`` splits a frame into n_bands row
bands over a mesh and runs the same checks as the JAX package's dry run:

  * one composite-and-blur step of a layer stack (the blur's band-border
    halos cross bands);
  * render_sharded of a one-object scene;
  * BandedAtlas memory scaling: 16 single-tile objects per band, so each
    band's local atlas must hold at most half the global atlas's slots,
    with one equal-sized local atlas per band;
  * the sharded blur equal to blur_pass at radii 2 and 5, on content that
    straddles every band border;
  * a meshed DeviceView: a full render and an animated move across a band
    border;
  * a meshed FilteredDisplay step.

The JAX package re-runs itself in a subprocess to force a virtual
n-device CPU platform; the port has no platform to force, so it runs in
the calling process.  With `devices` None the mesh takes n_bands distinct
CUDA cards (make_mesh raises if there are fewer); an explicit list may
repeat a device, such as ``["cpu"] * 8`` or ``["cuda:0"] * 2``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import colour as C
from .. import ident
from ..geometry import shapes as gshapes
from ..raster import fills as rfills
from ..raster import region
from ..raster.compositor import TILE_H, TILE_W, pack_rgba
from ..raster.convolve import mkgaussian
from ..raster.region import Sprite
from ..raster.tiled_scene import BandedAtlas, TiledScene, render_sharded
from ..scene import render as R
from ..scene.fastframe import DeviceView, FilteredDisplay, alpha_plane_of_object
from .mesh import blur_pass, make_mesh, sharded_blur, sharded_render_step


def _box_sprite(box, colour: int, device) -> Sprite:
    """A plain-filled box, as region.fillshape(shape_of_box(box), plain(colour))
    gives it."""
    x0, y0, x1, y1 = box
    h, w = y1 - y0 + 1, x1 - x0 + 1
    rgba = torch.tensor(C.rgba_of_colour(colour), dtype=torch.int32, device=device).expand(h, w, 4).contiguous()
    return Sprite(box, torch.ones((h, w), dtype=torch.bool, device=device), rgba)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_bands: int, devices=None) -> dict:
    """Run the checks above on an n_bands-band mesh; raises on the first
    that fails.  Returns a summary of what ran."""
    mesh = make_mesh(n_bands, devices)
    dev = mesh.devices[0]

    step, make_example_args = sharded_render_step(mesh)
    frame, open_mask = step(*make_example_args(h=8 * n_bands, w=256, n_layers=2))
    _require(tuple(frame.gather(dev).shape) == (8 * n_bands, 256, 4), "composite-and-blur step shape")
    _require(open_mask.gather(dev).dtype == torch.bool, "occupancy plane type")

    # Sharded sparse tiled-scene render.
    W, H = TILE_W, TILE_H * n_bands
    ts = TiledScene(W, H, dev)
    ts.add_object("a", _box_sprite((2, 2, 30, 30), C.red, dev))
    white = pack_rgba(torch.full((H, W, 4), 255, dtype=torch.int32, device=dev))
    out = render_sharded(ts, white, ["a"], mesh).gather(dev)
    _require(tuple(out.shape) == (H, W), "render_sharded shape")

    # BandedAtlas memory scaling: each band holds about 1/n of the atlas.
    per_band = 16
    ts2 = TiledScene(TILE_W * per_band, TILE_H * n_bands, dev)
    for d in range(n_bands):
        for i in range(per_band):
            x0, y0 = i * TILE_W + 2, d * TILE_H + 1
            ts2.add_object(("o", d, i), _box_sprite((x0, y0, x0 + 20, y0 + 4), C.red, dev))
    banded = BandedAtlas(ts2, mesh)
    n_global = int(ts2.atlas().shape[0])
    _require(banded.local_cap * 2 <= n_global,
             f"local_cap {banded.local_cap} against {n_global} global slots: the atlas is replicated")
    _require(sum(int(d.shape[0]) for d in banded.data) == n_bands, "one local atlas per band")
    _require({tuple(d.shape[1:]) for d in banded.data} == {(banded.local_cap, TILE_H, TILE_W)},
             "local atlases of equal size")

    # Blur-halo equality at two radii, on content straddling every border.
    rng = np.random.default_rng(7)
    fr = torch.from_numpy(rng.integers(0, 256, size=(TILE_H * n_bands, 64, 4)).astype(np.int32)).to(dev)
    for radius in (2, 5):
        weights = mkgaussian(radius).values
        want = blur_pass(blur_pass(fr, weights, 0), weights, 1)
        got = sharded_blur(mesh, fr, weights).gather(dev)
        _require(torch.equal(want, got),
                 f"sharded blur radius={radius}: {int((want != got).sum())} values differ at band borders")

    # A meshed DeviceView: full render, an animated move across a band border.
    view = DeviceView(TILE_W, TILE_H * n_bands, device=dev)
    blob = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.dissolve(C.crimson, delta=170)),
                                          R.PathShape(gshapes.circle(40.0, 30.0, 12.0))), (), R.OVER)
    rect = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.steelblue), R.rectangle(10.0, 10.0, 90.0, 100.0)),
                 (), R.OVER)
    view.set_scene([blob, rect])
    view.use_mesh(mesh)
    view.render(full=True)
    view.make_animated(blob.idset)
    view.render()
    view.translate_object(blob.idset, 5, TILE_H)  # crosses a band border
    view.render()
    img = view.read()
    _require(img.shape == (TILE_H * n_bands, TILE_W, 4), "meshed view shape")
    _require(bool((img[..., :3] != 255).any()), "the meshed dirty render drew nothing")

    # A live blur filter over the meshed content.
    f_geom = R.Obj(ident.new_ids(), R.Basic(rfills.plain(C.white), R.rectangle(8.0, 8.0, 100.0, 110.0)),
                   (), R.OVER)
    disp = FilteredDisplay(view, alpha_plane_of_object(f_geom, view.width, view.height, dev), mkgaussian(2))
    disp.full_refresh()
    prev = view.sprites[blob.idset].box
    view.translate_object(blob.idset, 3, 2)
    disp.step(region.box_union(prev, view.sprites[blob.idset].box))
    shown = disp.read()
    _require(shown.shape == (view.height, view.width, 4), "meshed display shape")
    _require(bool((shown[..., :3] != 255).any()), "the meshed display drew nothing")
    return {"n_bands": n_bands, "devices": [str(d) for d in mesh.devices],
            "local_cap": banded.local_cap, "global_slots": n_global}
