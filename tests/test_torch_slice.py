"""The port's animated blur-filtered frame path against the JAX package's.

The scene is bench.py's, shrunk to 512x256: the lion scaled to the frame,
a translucent crimson blob (r=20) reserved for in-place moves, a radius-2
Gaussian blur over the band F_BOX (bench.py's band scaled to the frame),
and an atlas preallocated to 256 slots.  The same run goes three ways:

  * through the JAX package (Pallas kernels in interpret mode);
  * through the port, built from the same scene on its own;
  * through the port, starting from the JAX side's state after
    full_refresh, carried over with ``coherence_tpu_torch.convert``.

After full_refresh, each of three step_animated frames, one
translate_object + step, and a render(full=True), the display and the
content frame must be equal bit for bit (tolerance 0) all three ways.
"""

import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
from coherence_tpu import ident
from coherence_tpu import transform as tr
from coherence_tpu.geometry import shapes as gshapes
from coherence_tpu.raster import convolve as JV
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import region as JRG
from coherence_tpu.scene import examples as JE
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch import convert
from coherence_tpu_torch.raster import convolve as TV
from coherence_tpu_torch.raster import region as TRG
from coherence_tpu_torch.scene import examples as TE
from coherence_tpu_torch.scene import fastframe as TF

from _torch_threads import one_torch_thread  # noqa: F401

W, H = 512, 256
BLOB_R = 20
BLOB_AT = (32.0, 95.0)
RADIUS = 2
ATLAS_CAP = 256
F_BOX = (11, 76, 448, 251)
DELTAS = [(7, 3), (7, 3), (-7, -3)]
STEP_DELTA = (7, 3)

def jax_scene(width: int = W, height: int = H):
    """(lion objects front to back, blob, filter geometry) built through
    the JAX package's entry points, as bench.py builds them."""
    lion = JE.smalllion()
    xmin, xmax, ymin, ymax = JR.bounds_of_basicshape(lion)
    scale = min(width / (xmax - xmin), height / (ymax - ymin))
    lion = JR.transform_renderobject_many(
        [
            tr.Translate(0.0, float(height)),
            tr.Scale((0.0, 0.0), 1.0, -1.0),
            tr.Scale((0.0, 0.0), scale, scale),
            tr.Translate(-xmin, -ymin),
        ],
        lion,
    )
    blob = JR.Obj(
        ident.new_ids(),
        JR.Basic(JFL.plain(JC.dissolve(JC.crimson, delta=170)), JR.PathShape(gshapes.circle(0.0, 0.0, float(BLOB_R)))),
        (tr.Translate(*BLOB_AT),),
        JR.OVER,
    )
    x0, y0, x1, y1 = F_BOX
    f_geom = JR.Obj(
        ident.new_ids(),
        JR.Basic(JFL.plain(JC.white), JR.rectangle(float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1))),
        (),
        JR.OVER,
    )
    return list(lion.geometry.objects), blob, f_geom


def port_scene():
    return TE.bench_scene(W, H, blob_radius=BLOB_R, blob_at=BLOB_AT, f_box=F_BOX)


def _jax_run():
    objs, blob, f_geom = jax_scene()
    view = JF.DeviceView(W, H, atlas_cap=ATLAS_CAP)
    view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = JF.tiled_sprite_of_object(blob, view.pw, view.ph)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    disp = JF.FilteredDisplay(view, JF.alpha_plane_of_object(f_geom, W, H), JV.mkgaussian(RADIUS))
    disp.full_refresh()
    return view, disp, blob.idset


def _port_run():
    objs, blob, f_geom = port_scene()
    view = TF.DeviceView(W, H, atlas_cap=ATLAS_CAP, device="cpu")
    view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = TF.tiled_sprite_of_object(blob, view.pw, view.ph, "cpu")
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    disp = TF.FilteredDisplay(view, TF.alpha_plane_of_object(f_geom, W, H, "cpu"), TV.mkgaussian(RADIUS))
    disp.full_refresh()
    return view, disp, blob.idset


def _converted(jview, jdisp):
    """A port view and display holding the JAX side's state."""
    sprites = {}
    for key, spr in jview.sprites.items():
        if spr is None:
            sprites[key] = None
            continue
        w, h = spr.wh
        sprites[key] = (spr.box, np.asarray(spr.mask)[:h, :w], np.asarray(spr.rgba)[:h, :w])
    view = convert.device_view(
        W, H,
        atlas=np.asarray(jview.ts.atlas()),
        pieces={k: list(v) for k, v in jview.ts.pieces.items()},
        reserved=dict(jview.ts._reserved),
        n_pieces=jview.ts._n_pieces,
        order=jview.order,
        frame=np.asarray(jview.frame),
        background=np.asarray(jview.background),
        sprites=sprites,
        device="cpu",
    )
    return view, convert.filtered_display(
        view, f_alpha=np.asarray(jdisp.f_alpha), display=np.asarray(jdisp.rgba), kernel=TV.mkgaussian(RADIUS)
    )


def _state(view, disp):
    frame = view.frame.numpy() if isinstance(view.frame, torch.Tensor) else np.asarray(view.frame).view(np.int32)
    return frame.copy(), np.array(disp.read()), np.array(view.read())


STAGES = ["full_refresh", "step_animated_1", "step_animated_2", "step_animated_3", "step", "render_full"]


@pytest.fixture(scope="module")
def runs():
    """{stage: [(frame, display, view pixels) for JAX, port, converted port]}."""
    j, p = _jax_run(), _port_run()
    c = _converted(j[0], j[1]) + (j[2],)
    sides = [j, p, c]
    out = {"full_refresh": [_state(v, d) for v, d, _ in sides]}
    out["build"] = (j, p)
    for k, (dx, dy) in enumerate(DELTAS):
        for _, d, key in sides:
            d.step_animated(key, dx, dy)
        out[f"step_animated_{k + 1}"] = [_state(v, d) for v, d, _ in sides]
    for (v, d, key), rg in zip(sides, (JRG, TRG, TRG)):
        prev = v.sprites[key].box
        v.translate_object(key, *STEP_DELTA)
        d.step(rg.box_union(prev, v.sprites[key].box))
    out["step"] = [_state(v, d) for v, d, _ in sides]
    for v, _, _ in sides:
        v.render(full=True)
    out["render_full"] = [_state(v, d) for v, d, _ in sides]
    return out


def test_build_matches_jax(runs):
    (jv, jd, jkey), (pv, pd, pkey) = runs["build"]
    assert pv.ts._n_pieces == jv.ts._n_pieces
    assert pv.ts._reserved[pkey] == jv.ts._reserved[jkey]
    jp = [list(jv.ts.pieces[k]) for k in jv.order]
    pp = [list(pv.ts.pieces[k]) for k in pv.order]
    assert pp == jp
    assert np.array_equal(pv.ts.atlas().numpy(), np.asarray(jv.ts.atlas()).view(np.int32))
    assert np.array_equal(pd.f_alpha.numpy(), np.asarray(jd.f_alpha))


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(runs, stage):
    (jf, jdisp, jpix), (pf, pdisp, ppix), (cf, cdisp, cpix) = runs[stage]
    assert np.array_equal(pf, jf), "content frame (port build)"
    assert np.array_equal(cf, jf), "content frame (converted state)"
    assert np.array_equal(pdisp, jdisp), "display (port build)"
    assert np.array_equal(cdisp, jdisp), "display (converted state)"
    assert np.array_equal(ppix, jpix) and np.array_equal(cpix, jpix)
    if stage != "full_refresh":
        assert not np.array_equal(jdisp, runs["full_refresh"][0][1]), "the blob moved"
