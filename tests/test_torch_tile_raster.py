"""The port's tile rasterizer and filter alpha plane against the JAX
package's, bit for bit.

TileBuild.flush on the lion at 512x256 must give the same piece blocks,
slot for slot, and the same registry; alpha_plane_of_object (full AA
coverage with no minshape interior) must give the same plane for
rectangles and circles, inside the frame and across its edges.
Tolerance 0: coverage counts are integers and the product that sums them
is exact.
"""

import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import tile_raster as JTR
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch.raster import aa as TA
from coherence_tpu_torch.raster import fills as TFL
from coherence_tpu_torch.raster import tile_raster as TTR
from coherence_tpu_torch.scene import fastframe as TF
from coherence_tpu_torch.scene import render as TR

from _torch_hosts import JAX, PORT
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_slice import jax_scene, port_scene

W, H = 512, 256


def _flush(side_objs, builder, extract):
    tb = builder()
    for i, o in enumerate(side_objs):
        assert tb.add_object(i, *extract(o))
    return tb


def test_tile_build_flush_matches_jax():
    # The lion, the blob and the filter band: the band's rectangle covers
    # whole tiles, which become interior items.
    jobjs, jblob, jband = jax_scene()
    pobjs, pblob, pband = port_scene()
    jtb = _flush(jobjs + [jblob, jband], lambda: JTR.TileBuild(H // 64, W // 128), JF._batch_extract)
    ptb = _flush(pobjs + [pblob, pband], lambda: TTR.TileBuild(H // 64, W // 128, "cpu"), TF._batch_extract)
    n_edge = sum(len(v) for v in ptb.edge_items.values())
    assert n_edge > TTR._EDGE_STEP and len(ptb.interior_items) > 0
    jblocks, jreg = jtb.flush(combined=False)
    pblocks, preg = ptb.flush()
    assert preg == jreg
    assert len(pblocks) == len(jblocks)
    for pb, jb in zip(pblocks, jblocks):
        assert pb.dtype == torch.int32
        assert np.array_equal(pb.numpy(), np.asarray(jb).view(np.int32))


def test_tiled_sprite_matches_jax():
    _, jblob, _ = jax_scene()
    _, pblob, _ = port_scene()
    js = JF.tiled_sprite_of_object(jblob, W, H)
    ps = TF.tiled_sprite_of_object(pblob, W, H, "cpu")
    w, h = js.wh
    assert ps.box == js.box
    assert np.array_equal(ps.mask.numpy(), np.asarray(js.mask)[:h, :w])
    assert np.array_equal(ps.rgba.numpy(), np.asarray(js.rgba)[:h, :w])


def _host(R):
    return JAX if R is JR else PORT


def _rect(x, y, w, h):
    return lambda R, fills, col: R.Obj(_host(R).ident.new_ids(), R.Basic(fills.plain(col), R.rectangle(x, y, w, h)),
                                       (), R.OVER)


def _circle(cx, cy, r):
    return lambda R, fills, col: R.Obj(
        _host(R).ident.new_ids(),
        R.Basic(fills.plain(col), R.PathShape(_host(R).gshapes.circle(0.0, 0.0, r))),
        (_host(R).tr.Translate(cx, cy),),
        R.OVER,
    )


SHAPES = {
    "rect": _rect(11.0, 76.0, 438.0, 176.0),
    "rect_fractional": _rect(20.3, 30.7, 101.25, 40.5),
    "rect_across_edges": _rect(-15.5, -9.0, 200.0, 300.0),
    "circle": _circle(200.0, 120.0, 70.0),
    "circle_across_edge": _circle(500.0, 10.0, 45.5),
}


@pytest.mark.parametrize("translucent", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_alpha_plane_matches_jax(shape, translucent):
    make = SHAPES[shape]
    jcol = JC.dissolve(JC.white, delta=140) if translucent else JC.white
    jo = make(JR, JFL, jcol)
    po = make(TR, TFL, jcol)
    want = np.asarray(JF.alpha_plane_of_object(jo, W, H))
    got = TF.alpha_plane_of_object(po, W, H, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # Full AA with no minshape interior: alpha < full just inside the edges.
    full = 140 if translucent else 255
    assert (want == full).any() and ((want > 0) & (want < full)).any()


def test_coverage_refuses_reduced_precision():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            TA.coverage_counts(torch.zeros((1, 2 * 16 + 16, 2 * 16 + 16), dtype=torch.bool), 2, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
