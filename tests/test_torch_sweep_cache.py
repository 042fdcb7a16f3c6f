"""The port's sweep cache (raster/tile_raster.py) against the JAX package's.

TileBuild.add_object memoizes each object's host sweep by content (edge
bytes, windings, grid) in a byte-capped LRU, as the JAX package does
(coherence_tpu/raster/tile_raster.py:393-447): a re-staged object takes
the cached items, bit for bit, and a zoom back to a scale seen before
re-stages from the cache each object whose edges come back bit for bit.
Both packages' counts must agree over the same staging sequence, and the
atlas each builds with them.
"""

import numpy as np
import pytest

from coherence_tpu import colour as JC
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import tile_raster as JTR
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch import colour as TC
from coherence_tpu_torch.raster import fills as TFL
from coherence_tpu_torch.raster import tile_raster as TTR
from coherence_tpu_torch.scene import fastframe as TF
from coherence_tpu_torch.scene import render as TR

from _torch_hosts import JAX, PORT
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_slice import ATLAS_CAP, H, W, jax_scene, port_scene


def _poly(host, R, FL, C, points, alpha: int):
    path = host.gpath.path_of_pointlist(host.gpath.NONZERO, points)
    return R.Obj(host.ident.new_ids(), R.Basic(FL.plain(C.dissolve(C.crimson, delta=alpha)), R.PathShape(path)), (),
                 R.OVER)


@pytest.fixture
def cleared():
    for mod in (JTR, TTR):
        mod.sweep_cache_clear()
    for mod in (JF, TF):
        mod.scene_build_cache_clear()
    yield
    for mod in (JTR, TTR):
        mod.sweep_cache_clear()


def test_sweep_cache_hit_is_identical(cleared):
    """Re-staging the same geometry hits the content-addressed sweep cache
    and stages identical work items; another grid is another key (the
    sweep's rows_clip changes).  The port of tests/test_tile_raster.py's
    test of the same name."""
    o = _poly(PORT, TR, TFL, TC, [(10.0, 10.0), (500.0, 30.0), (250.0, 250.0)], 170)
    ext = TF._batch_extract(o)
    b1 = TTR.TileBuild(4, 4, "cpu")
    assert b1.add_object("a", *ext)
    assert TTR.sweep_cache_stats == {"hits": 0, "misses": 1}
    b2 = TTR.TileBuild(4, 4, "cpu")
    assert b2.add_object("b", *ext)
    assert TTR.sweep_cache_stats == {"hits": 1, "misses": 1}
    assert b1.edge_items.keys() == b2.edge_items.keys() and b1.edge_items
    for cls in b1.edge_items:
        assert len(b1.edge_items[cls]) == len(b2.edge_items[cls])
        for ia, ib in zip(b1.edge_items[cls], b2.edge_items[cls]):
            assert ia[1] == ib[1]  # same tile
            for fa, fb in zip(ia[2:5], ib[2:5]):
                for xa, xb in zip(fa, fb):
                    assert (xa == xb).all()
    b3 = TTR.TileBuild(2, 4, "cpu")
    b3.add_object("c", *ext)
    assert TTR.sweep_cache_stats["misses"] == 2
    # The flushed blocks of the hit equal the miss's.
    for (pa, ra), (pb, rb) in zip([b1.flush()], [b2.flush()]):
        assert all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(pa, pb))
        assert list(ra.values()) == list(rb.values())


def test_sweep_cache_counts_match_jax_and_cache_refusals(cleared):
    """The same staging sequence, with an object beyond every capacity
    class (a False result, cached too), gives both packages the same
    counts."""
    rng = np.random.default_rng(3)
    zigzag = [(float(x), 20.0 + 200.0 * (i % 2)) for i, x in enumerate(np.linspace(5.0, 505.0, 3001))]
    shapes = [[(10.0, 10.0), (500.0, 30.0), (250.0, 250.0)], zigzag,
              [tuple(p) for p in rng.uniform(0.0, 256.0, (7, 2)).tolist()]]
    sides = []
    for host, R, FL, C, mod, F, dev in ((JAX, JR, JFL, JC, JTR, JF, None), (PORT, TR, TFL, TC, TTR, TF, "cpu")):
        exts = [F._batch_extract(_poly(host, R, FL, C, pts, 200)) for pts in shapes]
        took, stats = [], []
        for grid in ((2, 4), (2, 4), (4, 4), (2, 4)):
            build = mod.TileBuild(*grid) if dev is None else mod.TileBuild(*grid, dev)
            took.append([build.add_object(k, *e) for k, e in enumerate(exts)])
            stats.append(dict(mod.sweep_cache_stats))
        sides.append((took, stats))
    assert sides[0] == sides[1]
    assert sides[1][0][0] == [True, False, True]  # the zigzag exceeds every class
    assert sides[1][1][-1] == {"hits": 6, "misses": 6}


def test_zoom_in_out_in_matches_jax(cleared):
    """The lion at 512x256 zoomed 2x, back, and 2x again on both packages,
    then the last scene staged once more: after each step the same
    sweep-cache counts and the same atlas and piece lists.  An object whose
    edges come back bit for bit at a scale seen before is staged from the
    cache (the transform chain's rounding decides which do, in both
    packages alike); the repeated step stages every object on the grid
    from it."""
    jobjs, _, _ = jax_scene()
    pobjs, _, _ = port_scene()
    jview = JF.DeviceView(W, H, atlas_cap=ATLAS_CAP)
    pview = TF.DeviceView(W, H, atlas_cap=ATLAS_CAP, device="cpu")
    jview.set_scene(jobjs, tiled=True)
    pview.set_scene(pobjs, tiled=True)
    assert JTR.sweep_cache_stats == TTR.sweep_cache_stats == {"hits": 0, "misses": len(pobjs)}
    jzoom = {f: [JAX.tr.Translate(W / 2.0, H / 2.0), JAX.tr.Scale((0.0, 0.0), f, f), JAX.tr.Translate(-W / 2.0, -H / 2.0)]
             for f in (2.0, 0.5)}
    pzoom = {f: TF.zoom_transform(W / 2.0, H / 2.0, f) for f in (2.0, 0.5)}
    gained = []
    for step, f in enumerate((2.0, 0.5, 2.0, None)):
        before = dict(TTR.sweep_cache_stats)
        if f is not None:
            jobjs = [JR.transform_renderobject_many(jzoom[f], o) for o in jobjs]
            pobjs = [TR.transform_renderobject_many(pzoom[f], o) for o in pobjs]
        jview.reset_scene(jobjs, tiled=True)
        pview.reset_scene(pobjs, tiled=True)
        assert TTR.sweep_cache_stats == JTR.sweep_cache_stats, step
        gained.append({k: TTR.sweep_cache_stats[k] - before[k] for k in before})
        assert np.array_equal(pview.ts.atlas().numpy(), np.asarray(jview.ts.atlas()).view(np.int32)), step
        assert [len(pview.ts.pieces[k]) for k in pview.order] == [len(jview.ts.pieces[k]) for k in jview.order]
    assert gained[0]["hits"] == 0 and gained[1]["hits"] > 0 and gained[2]["hits"] > 0
    assert gained[3] == {"hits": gained[2]["hits"] + gained[2]["misses"], "misses": 0}
