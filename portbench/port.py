"""The system under test: coherence_tpu_torch's tile route, built from a scene
description and driven one event at a time through the port's entry points.

Nothing here times anything.  An event kind (portbench/kinds/) builds the
session and applies each event's calls to it, each inside
`session.spans.span(<name>)`: a recorder that is a no-op outside a traced
run."""

from __future__ import annotations

import contextlib

from coherence_tpu_torch import colour as C
from coherence_tpu_torch import ident
from coherence_tpu_torch import transform as tr
from coherence_tpu_torch.geometry import path as gpath
from coherence_tpu_torch.raster import brush as rbrush
from coherence_tpu_torch.raster import convolve, fills
from coherence_tpu_torch.scene import fastframe
from coherence_tpu_torch.scene import render as R

from .check import Snapshot


class NoSpans:
    @contextlib.contextmanager
    def span(self, name: str):
        yield


def _op(op):
    if op[0] == "T":
        return tr.Translate(op[1], op[2])
    if op[0] == "S":
        return tr.Scale((op[1], op[2]), op[3], op[4])
    raise ValueError(f"no such transform op: {op!r}")


def _path(path) -> gpath.Path:
    winding, subpaths = path
    segs = {"S": gpath.Straight, "B": gpath.Bezier}
    return gpath.Path(winding, tuple(gpath.Subpath(False, closed, tuple(segs[s[0]](*s[1:]) for s in ss))
                                     for closed, ss in subpaths))


def port_object(o: dict) -> R.Obj:
    """The port's render object for a description's object."""
    fill = fills.plain(C.colour_of_rgba(*o["rgba"]))
    if o["kind"] == "brush":
        shape = R.BrushStroke((rbrush.mkround(o["radius"], o["opacity"]), _path(o["path"])))
    else:
        shape = R.PathShape(_path(o["path"]))
    return R.Obj(ident.new_ids(), R.Basic(fill, shape), tuple(_op(op) for op in o["transform"]), R.OVER)


class Session:
    """A view of the scene on `device` with its filtered display.  With
    `animated`, the blob is the animated object that drags move (the tile
    route's reserved slots); without, it is the front object of a scene that
    zooms replace whole (`base`, the unzoomed objects; `cur`, the shown)."""

    def __init__(self, desc: dict, device, animated: bool, spans=None):
        self.spans = spans or NoSpans()
        w, h = desc["width"], desc["height"]
        self.view = fastframe.DeviceView(w, h, atlas_cap=desc["atlas_cap"], device=device)
        blob = port_object(desc["blob"])
        self.base = [port_object(o) for o in desc["objects"]]
        if animated:
            self.view.set_scene(self.base, tiled=True)
            self.view.sprites[blob.idset] = fastframe.tiled_sprite_of_object(blob, self.view.pw, self.view.ph,
                                                                              device)
            self.view.order.insert(0, blob.idset)
            self.view.make_animated(blob.idset)
        else:
            self.base = [blob] + self.base
            self.view.set_scene(self.base, tiled=True)
        self.blob_key = blob.idset
        self.cur = self.base
        f_alpha = fastframe.alpha_plane_of_object(port_object(desc["lens"]), w, h, device)
        self.disp = fastframe.FilteredDisplay(self.view, f_alpha, convolve.mkgaussian(desc["blur_radius"]))
        self.disp.full_refresh()
        # The lens's support box (1-based, inclusive), as the fast server finds it: a
        # radius change alters pixels only where the filter's alpha is positive.
        ys = (f_alpha > 0).any(1).nonzero().flatten().cpu()
        xs = (f_alpha > 0).any(0).nonzero().flatten().cpu()
        self.lens_box = (int(xs[0]) + 1, int(ys[0]) + 1, int(xs[-1]) + 1, int(ys[-1]) + 1)

    def pieces(self):
        """Each object's [(tile, slot)], in the view's order."""
        return [list(self.view.ts.pieces.get(k, ())) for k in self.view.order]

    def snapshot(self, index: int, pieces: bool) -> Snapshot:
        """Copies of the content frame and the display after event `index`;
        with `pieces`, of the atlas and each object's piece list too."""
        return Snapshot(index, self.view.frame.clone(), self.disp.rgba.clone(), self.pieces() if pieces else None,
                        self.view.ts.atlas().clone() if pieces else None)
