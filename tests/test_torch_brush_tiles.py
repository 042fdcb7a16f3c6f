"""The port's brush strokes against the JAX package's, bit for bit.

Host math (the Gaussian stamp, the stamp points, bounds and transforms),
the box-window count that gives a stroke's shape mask, and the batched
brush-tile build: for each stroke layout of tests/test_brush_tiles.py the
same objects go through the JAX ``BrushTileBuild`` and the port's (the same
registry, every block equal), and through each side's whole scene build
(the same atlas and piece lists, the same full frame).  Tolerance 0: the
colour math is integer.
"""

import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
import jax.numpy as jnp
from coherence_tpu.raster import brush as JB
from coherence_tpu.raster import brush_tiles as JBT
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import region as JRG
from coherence_tpu.raster.pallas_compositor import pack_rgba as jpack
from coherence_tpu.raster.tiled_scene import TiledScene as JTiledScene
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch import colour as TC
from coherence_tpu_torch.raster import brush as TB
from coherence_tpu_torch.raster import brush_tiles as TBT
from coherence_tpu_torch.raster import fills as TFL
from coherence_tpu_torch.raster import region as TRG
from coherence_tpu_torch.raster.tiled_scene import TiledScene as TTiledScene
from coherence_tpu_torch.scene import fastframe as TF
from coherence_tpu_torch.scene import render as TR

from _torch_hosts import JAX, PORT, ops
from _torch_threads import one_torch_thread  # noqa: F401

W, H = 512, 256  # 4 x 4 tiles of 128 x 64


def _objs(specs, jax_side: bool):
    """Scene objects on one side from specs: ("stroke", cx, cy, r, radius,
    opacity, colour name, alpha, transform) or ("path", cx, cy, r, colour
    name)."""
    R, FL, B, C, h = (JR, JFL, JB, JC, JAX) if jax_side else (TR, TFL, TB, TC, PORT)
    out = []
    for spec in specs:
        if spec[0] == "path":
            _, cx, cy, r, name = spec
            geom = R.Basic(FL.plain(getattr(C, name)), R.PathShape(h.gshapes.circle(cx, cy, r)))
            out.append(R.Obj(h.ident.new_ids(), geom, (), R.OVER))
            continue
        _, cx, cy, r, radius, opacity, name, alpha, t = spec
        col = getattr(C, name)
        fill = FL.plain(C.dissolve(col, delta=alpha) if alpha != 255 else col)
        stroke = R.BrushStroke((B.mkround(radius, opacity), h.gshapes.circle(cx, cy, r)))
        out.append(R.Obj(h.ident.new_ids(), R.Basic(fill, stroke), ops(h, t), R.OVER))
    return out


def _stroke(cx, cy, r, radius=6.0, opacity=0.5, name="darkorange", alpha=255, t=()):
    return ("stroke", cx, cy, r, radius, opacity, name, alpha, t)


# The stroke layouts of tests/test_brush_tiles.py:64-121.
LAYOUTS = {
    "across_tile_borders": [_stroke(256.0, 128.0, 80.0)],
    "offscreen_topleft": [_stroke(10.0, 8.0, 60.0)],
    "offscreen_bottomright": [_stroke(500.0, 250.0, 70.0)],
    "wholly_offscreen": [_stroke(-400.0, -300.0, 40.0)],
    "overlapping_translucent": [
        _stroke(200.0, 120.0, 60.0, name="crimson", alpha=170),
        _stroke(250.0, 130.0, 55.0, name="steelblue"),
    ],
    "mixed_with_paths": [
        _stroke(300.0, 100.0, 50.0, radius=4.0, opacity=0.8),
        ("path", 300.0, 128.0, 90.0, "darkgreen"),
        _stroke(120.0, 180.0, 45.0, radius=9.0, opacity=0.4, name="black"),
    ],
    "transformed": [_stroke(128.0, 64.0, 40.0, t=(("Scale", (0.0, 0.0), 2.0, 2.0),))],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_brush_tile_build_matches_jax(layout):
    jobjs, tobjs = _objs(LAYOUTS[layout], True), _objs(LAYOUTS[layout], False)
    jb, tb = JBT.BrushTileBuild(H // 64, W // 128), TBT.BrushTileBuild(H // 64, W // 128, "cpu")
    n = 0
    for k, (jo, to) in enumerate(zip(jobjs, tobjs)):
        jext, text = JF._brush_extract(jo), TF._brush_extract(to)
        assert (jext is None) == (text is None)
        if jext is None:
            continue
        assert repr(text[0]) == repr(jext[0])
        assert jb.add_stroke(k, *jext) and tb.add_stroke(k, *text)
        n += 1
    assert n
    jblocks, jreg = jb.flush()
    tblocks, treg = tb.flush()
    assert treg == jreg
    assert [tuple(b.shape) for b in tblocks] == [tuple(b.shape) for b in jblocks]
    for tblk, jblk in zip(tblocks, jblocks):
        assert np.array_equal(tblk.numpy(), np.asarray(jblk).view(np.int32))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scene_build_with_strokes_matches_jax(layout):
    jobjs, tobjs = _objs(LAYOUTS[layout], True), _objs(LAYOUTS[layout], False)
    jts, tts = JTiledScene(W, H), TTiledScene(W, H, "cpu")
    JF.build_tiled_scene(jts, list(enumerate(jobjs)))
    TF.build_tiled_scene(tts, list(enumerate(tobjs)))
    assert tts._n_pieces == jts._n_pieces
    assert {k: list(v) for k, v in tts.pieces.items()} == {k: list(v) for k, v in jts.pieces.items()}
    assert np.array_equal(tts.atlas().numpy(), np.asarray(jts.atlas()).view(np.int32))
    order = list(range(len(jobjs)))
    jbg = jpack(jnp.asarray(np.full((H, W, 4), 255), jnp.int32))
    js, ji = jts.build_lists(order)
    ts_, ti = tts.build_lists(order)
    jframe = np.asarray(jts.render(jbg, js, ji)).view(np.int32)
    tframe = tts.render_full(torch.from_numpy(np.asarray(jbg).view(np.int32).copy()), ts_, ti)
    assert np.array_equal(tframe.numpy(), jframe)


@pytest.mark.parametrize("radius,opacity", [(1.0, 1.0), (4.0, 0.8), (6.0, 0.5), (9.0, 0.4), (12.0, 0.5), (9.3, 1.0),
                                            (24.0, 0.5)])
def test_drawround_alpha_matches_jax(radius, opacity):
    assert np.array_equal(TB.drawround_alpha(radius, opacity), JB.drawround_alpha(radius, opacity))


@pytest.mark.parametrize("radius,r,t", [
    (6.0, 80.0, ()),
    (12.0, 100.0, (("Translate", 10.5, -3.25),)),
    (4.0, 50.0, (("Translate", 256.0, 128.0), ("Scale", (0.0, 0.0), 2.0, 2.0), ("Translate", -256.0, -128.0))),
    (9.0, 45.0, (("Scale", (1.0, 2.0), 0.5, 3.0),)),
])
def test_stroke_host_math_matches_jax(radius, r, t):
    jt, tt = ops(JAX, t), ops(PORT, t)
    jbs = JB.transform_brushstroke(list(jt), (JB.mkround(radius, 0.5), JAX.gshapes.circle(200.0, 120.0, r)))
    tbs = TB.transform_brushstroke(list(tt), (TB.mkround(radius, 0.5), PORT.gshapes.circle(200.0, 120.0, r)))
    assert repr(tbs) == repr(jbs)
    assert TB.sizeof_brush(tbs[0]) == JB.sizeof_brush(jbs[0])
    assert TB.points_of_brushstroke(tbs) == JB.points_of_brushstroke(jbs)
    assert TB._int_points(TB.points_of_brushstroke(tbs)) == JB._int_points(JB.points_of_brushstroke(jbs))
    assert TB.bounds_brushstroke(tbs) == JB.bounds_brushstroke(jbs)
    jbs0 = (JB.mkround(radius, 0.5), JAX.gshapes.circle(200.0, 120.0, r))
    tbs0 = (TB.mkround(radius, 0.5), PORT.gshapes.circle(200.0, 120.0, r))
    jo = JR.Obj(JAX.ident.new_ids(), JR.Basic(JFL.plain(JC.gold), JR.BrushStroke(jbs0)), jt, JR.OVER)
    to = TR.Obj(PORT.ident.new_ids(), TR.Basic(TFL.plain(TC.gold), TR.BrushStroke(tbs0)), tt, TR.OVER)
    assert TR.bounds_of_basicshape(to) == JR.bounds_of_basicshape(jo)
    moved = TR.translate_renderobject(7, -3, to)
    assert TR.bounds_of_basicshape(moved) == JR.bounds_of_basicshape(JR.translate_renderobject(7, -3, jo))


@pytest.mark.parametrize("seed,h,w,rx,ry", [(0, 40, 130, 0, 0), (1, 40, 130, 3, 5), (2, 64, 256, 12, 12),
                                           (3, 17, 300, 200, 1), (4, 96, 128, 1, 90)])
def test_box_count_matches_jax(seed, h, w, rx, ry):
    rng = np.random.default_rng(seed)
    m = (rng.random((h, w)) < 0.05).astype(np.int32) * rng.integers(1, 3, (h, w)).astype(np.int32)
    want = np.asarray(JRG._box_count(jnp.asarray(m), rx, ry))
    assert np.array_equal(TRG._box_count(torch.from_numpy(m), rx, ry).numpy(), want)
