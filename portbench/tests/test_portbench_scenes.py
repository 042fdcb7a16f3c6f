"""The frozen scene generators against the program's own: the objects that
portbench builds from its descriptions carry the same edges, windings, fills,
brushes and transforms as coherence_tpu_torch's examples.bench_scene and
examples.interactive_4k_scene at the cells' sizes."""

import numpy as np
import pytest

from portbench import bench, port
from portbench.reference import geometry as G
from portbench.scenes import bench_lion, interactive_4k


def _same(mine, theirs):
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.scene import fastframe

    a, b = fastframe._batch_extract(mine), fastframe._batch_extract(theirs)
    if a is None:
        (ba, pa), fa = fastframe._brush_extract(mine)
        (bb, pb), fb = fastframe._brush_extract(theirs)
        assert ba == bb and np.array_equal(fa, fb)
        assert np.array_equal(gpath.edgelist_of_path(pa), gpath.edgelist_of_path(pb))
    else:
        assert np.array_equal(a[0], b[0]) and a[1:3] == b[1:3] and np.array_equal(a[3], b[3])
    assert mine.transform == theirs.transform


def _config(name):
    return bench.load_config(bench.cell_of(bench.load_benchmark(), name)[1])


def test_lion_scene_is_bench_py():
    from coherence_tpu_torch.scene import examples

    cfg = _config("lion_1080p.drag")
    desc = bench_lion.describe(cfg, 5)
    objs, blob, f_geom = examples.bench_scene(cfg["width"], cfg["height"], blob_radius=cfg["blob_radius"],
                                              blob_at=tuple(cfg["blob_at"]), f_box=tuple(cfg["lens_box"]))
    assert len(desc["objects"]) == len(objs) == 132
    for d, o in zip(desc["objects"], objs):
        _same(port.port_object(d), o)
    _same(port.port_object(desc["blob"]), blob)
    _same(port.port_object(desc["lens"]), f_geom)


def test_config5_scene_is_run_py():
    from coherence_tpu_torch.scene import examples

    cfg = _config("interactive_4k.drag")
    seed = 2**31 + 11
    desc = interactive_4k.describe(cfg, seed)
    objs, blob, f_geom = examples.interactive_4k_scene(cfg["width"], cfg["height"], seed=seed)
    assert len(desc["objects"]) == len(objs) == 1006
    for d, o in zip(desc["objects"], objs):
        _same(port.port_object(d), o)
    _same(port.port_object(desc["blob"]), blob)
    _same(port.port_object(desc["lens"]), f_geom)


@pytest.mark.parametrize("f", [2.0, 0.5])
def test_reference_transforms_match_the_port(f):
    """A zoom's transform list flattens to the same edges in the reference
    as in the port."""
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.scene import fastframe
    from coherence_tpu_torch.scene import render as R

    o = {"kind": "path", "path": G.circle(123.25, 77.5, 41.0), "rgba": (10, 20, 30, 255),
         "transform": [("T", 400.0, 700.0)]}
    zoom = [("T", 1000.0, 800.0), ("S", 0.0, 0.0, f, f), ("T", -1000.0, -800.0)]
    ported = R.transform_renderobject_many(fastframe.zoom_transform(1000.0, 800.0, f), port.port_object(o))
    sk = R.transform_shapekind(ported.transform, ported.geometry.shape)
    mine = G.edges_of_path(G.transform_path(zoom + o["transform"], o["path"]))
    assert np.array_equal(gpath.edgelist_of_path(sk.path), mine)
