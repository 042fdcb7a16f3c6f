"""The port's interactive mixed-primitive scene against the JAX package's.

The scene is benchmarks/run.py config 5 shrunk to 1024x512: 120 circles
and rectangles and 2 Gaussian brush strokes from the same generator (the
strokes' centres keep 150 pixels from the edges, where run.py keeps 300 at
4K), a translucent crimson blob (r=30) reserved for in-place moves, a
radius-2 Gaussian blur over a band, and an atlas preallocated to 512
slots.  The same run goes three ways:

  * through the JAX package (Pallas kernels in interpret mode);
  * through the port, built from the same scene on its own;
  * through the port, starting from the JAX side's state after
    full_refresh, carried over with ``coherence_tpu_torch.convert``.

Stages, as run.py drives them: the build (atlas, piece lists, slot count);
full_refresh; 3 filtered frames (translate_object + step); 1 plain frame
(translate_object + render); render(full=True); render_runs; 2 zoom steps
(reset_scene + render(full=True), 2x then 0.5x about the frame centre);
prefetch_zoom_candidates and a 0.5x step.  At each, the content frame, the
display and the view's pixels must be equal bit for bit (tolerance 0) all
three ways, and after each zoom step the port's scene-build cache must
count the JAX package's hits and misses.  Each port run keeps a cache of
its own; the converted run's starts empty (its first scene was never built
by the port), so only its pixels are compared.
"""

import contextlib
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
from coherence_tpu.raster import brush as JB
from coherence_tpu.raster import convolve as JV
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import region as JRG
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch import colour as TC
from coherence_tpu_torch import convert
from coherence_tpu_torch.raster import brush as TB
from coherence_tpu_torch.raster import convolve as TV
from coherence_tpu_torch.raster import fills as TFL
from coherence_tpu_torch.raster import region as TRG
from coherence_tpu_torch.scene import examples as TE
from coherence_tpu_torch.scene import fastframe as TF
from coherence_tpu_torch.scene import render as TR

from _torch_hosts import JAX, PORT
from _torch_threads import one_torch_thread  # noqa: F401

W, H = 1024, 512
# Config 5's generator at run.py's size, and shrunk for these tests (the
# strokes' centres keep 150 pixels from the edges, where run.py keeps 300).
CONFIG5 = dict(width=3840, height=2160, n_objects=1000, n_strokes=6, stroke_margin=300, blob_r=70.0,
               blob_at=(400.0, 700.0), f_rect=(200.0, 500.0, 3000.0, 1300.0))
SHRUNK = dict(width=W, height=H, n_objects=120, n_strokes=2, stroke_margin=150, blob_r=30.0,
              blob_at=(200.0, 250.0), f_rect=(50.0, 120.0, 800.0, 340.0))
RADIUS = 2
ATLAS_CAP = 512

JAX_MODULES = SimpleNamespace(C=JC, R=JR, FL=JFL, B=JB, H=JAX)
PORT_MODULES = SimpleNamespace(C=TC, R=TR, FL=TFL, B=TB, H=PORT)


def config5_scene(m, width, height, n_objects, n_strokes, stroke_margin, blob_r, blob_at, f_rect):
    """(objects, blob, filter geometry) built through module set `m` (the
    JAX package's or the port's), draw for draw as benchmarks/run.py
    config 5 builds them."""
    rng = np.random.default_rng(0)
    ident, gshapes = m.H.ident, m.H.gshapes

    def rand_colour(k):
        alpha = 255 if k % 3 else 150
        return m.C.dissolve(m.C.colour_of_rgba(*(int(v) for v in rng.integers(0, 256, 3)), 255), delta=alpha)

    objs = []
    for k in range(n_objects):
        cx = float(rng.integers(60, width - 60))
        cy = float(rng.integers(60, height - 60))
        col = rand_colour(k)
        if k % 2 == 0:
            geom = m.R.PathShape(gshapes.circle(cx, cy, float(rng.integers(6, 30))))
        else:
            geom = m.R.rectangle(cx, cy, float(rng.integers(8, 56)), float(rng.integers(8, 56)))
        objs.append(m.R.Obj(ident.new_ids(), m.R.Basic(m.FL.plain(col), geom), (), m.R.OVER))
    for _ in range(n_strokes):
        cx = float(rng.integers(stroke_margin, width - stroke_margin))
        cy = float(rng.integers(stroke_margin, height - stroke_margin))
        pth = gshapes.circle(cx, cy, float(rng.integers(60, 140)))
        stroke = m.R.BrushStroke((m.B.mkround(12.0, 0.5), pth))
        objs.append(m.R.Obj(ident.new_ids(), m.R.Basic(m.FL.plain(m.C.dissolve(m.C.darkorange, delta=185)), stroke),
                            (), m.R.OVER))
    blob = m.R.Obj(
        ident.new_ids(),
        m.R.Basic(m.FL.plain(m.C.dissolve(m.C.crimson, delta=170)), m.R.PathShape(gshapes.circle(0.0, 0.0, blob_r))),
        (m.H.tr.Translate(*blob_at),),
        m.R.OVER,
    )
    f_geom = m.R.Obj(ident.new_ids(), m.R.Basic(m.FL.plain(m.C.white), m.R.rectangle(*f_rect)), (), m.R.OVER)
    return objs, blob, f_geom


def jax_scene():
    return config5_scene(JAX_MODULES, **SHRUNK)


def port_scene():
    return config5_scene(PORT_MODULES, **SHRUNK)


def _zoom(f, jax_side: bool):
    """The zoom about the frame centre: the port's zoom_transform, or the
    same ops of the JAX package's transform module."""
    if not jax_side:
        return TF.zoom_transform(W / 2.0, H / 2.0, f)
    return [JAX.tr.Translate(W / 2.0, H / 2.0), JAX.tr.Scale((0.0, 0.0), f, f), JAX.tr.Translate(-W / 2.0, -H / 2.0)]


class Side:
    """One of the three runs: its view, display, blob key, scene objects,
    its module set, and (for the port) its own scene-build cache."""

    def __init__(self, view, disp, key, objs, jax_side: bool, cache=None):
        self.view, self.disp, self.key, self.objs = view, disp, key, objs
        self.R, self.RG, self.F = (JR, JRG, JF) if jax_side else (TR, TRG, TF)
        self.jax_side = jax_side
        self.cache = cache

    @contextlib.contextmanager
    def active(self):
        """Run with this side's scene-build cache installed (port sides)."""
        if self.cache is None:
            yield
            return
        saved = TF._SCENE_BUILD_CACHE, TF._SCENE_BUILD_CACHE_STATS
        TF._SCENE_BUILD_CACHE, TF._SCENE_BUILD_CACHE_STATS = self.cache
        try:
            yield
        finally:
            TF._SCENE_BUILD_CACHE, TF._SCENE_BUILD_CACHE_STATS = saved

    def scene_state(self):
        """(slot count, the blob's reserved run, piece lists in order, atlas
        as int32)."""
        ts = self.view.ts
        atlas = ts.atlas()
        atlas = atlas.numpy() if isinstance(atlas, torch.Tensor) else np.asarray(atlas).view(np.int32)
        return (ts._n_pieces, ts._reserved.get(self.key), [list(ts.pieces[k]) for k in self.view.order],
                atlas.copy())

    def stats(self):
        with self.active():
            return self.F.scene_build_cache_stats()

    def state(self, frame=None):
        frame = self.view.frame if frame is None else frame
        frame = frame.numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame).view(np.int32)
        return frame.copy(), np.array(self.disp.read()), np.array(self.view.read())

    def filtered_frame(self, k):
        dxy = (9, 4) if (k // 100) % 2 == 0 else (-9, -4)
        prev = self.view.sprites[self.key].box
        self.view.translate_object(self.key, *dxy)
        self.disp.step(self.RG.box_union(prev, self.view.sprites[self.key].box))

    def plain_frame(self, k):
        dxy = (9, 4) if (k // 100) % 2 == 0 else (-9, -4)
        self.view.translate_object(self.key, *dxy)
        self.view.render()

    def zoom(self, f):
        with self.active():
            self.objs = [self.R.transform_renderobject_many(_zoom(f, self.jax_side), o) for o in self.objs]
            self.view.reset_scene(self.objs, tiled=True)
            self.view.render(full=True)

    def prefetch_and_half(self):
        with self.active():
            self.view.prefetch_zoom_candidates(self.objs)
        self.zoom(0.5)


def _new_cache():
    return OrderedDict(), {"hits": 0, "misses": 0}


def _jax_side():
    objs, blob, f_geom = jax_scene()
    view = JF.DeviceView(W, H, atlas_cap=ATLAS_CAP)
    view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = JF.tiled_sprite_of_object(blob, view.pw, view.ph)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    disp = JF.FilteredDisplay(view, JF.alpha_plane_of_object(f_geom, W, H), JV.mkgaussian(RADIUS))
    disp.full_refresh()
    return Side(view, disp, blob.idset, objs, True)


def _port_side():
    side = Side(None, None, None, None, False, _new_cache())
    objs, blob, f_geom = port_scene()
    with side.active():
        view = TF.DeviceView(W, H, atlas_cap=ATLAS_CAP, device="cpu")
        view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = TF.tiled_sprite_of_object(blob, view.pw, view.ph, "cpu")
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    disp = TF.FilteredDisplay(view, TF.alpha_plane_of_object(f_geom, W, H, "cpu"), TV.mkgaussian(RADIUS))
    disp.full_refresh()
    side.view, side.disp, side.key, side.objs = view, disp, blob.idset, objs
    return side


def _converted_side(j: Side):
    """A port run holding the JAX side's state after full_refresh."""
    jv = j.view
    sprites = {}
    for key, spr in jv.sprites.items():
        if spr is None:
            sprites[key] = None
            continue
        w, h = spr.wh
        sprites[key] = (spr.box, np.asarray(spr.mask)[:h, :w], np.asarray(spr.rgba)[:h, :w])
    view = convert.device_view(
        W, H,
        atlas=np.asarray(jv.ts.atlas()),
        pieces={k: list(v) for k, v in jv.ts.pieces.items()},
        reserved=dict(jv.ts._reserved),
        n_pieces=jv.ts._n_pieces,
        order=jv.order,
        frame=np.asarray(jv.frame),
        background=np.asarray(jv.background),
        sprites=sprites,
        device="cpu",
    )
    disp = convert.filtered_display(view, f_alpha=np.asarray(j.disp.f_alpha), display=np.asarray(j.disp.rgba),
                                    kernel=TV.mkgaussian(RADIUS))
    return Side(view, disp, j.key, port_scene()[0], False, _new_cache())


STAGES = ["full_refresh", "filtered_1", "filtered_2", "filtered_3", "plain", "render_full", "render_runs",
          "zoom_2x", "zoom_0.5x", "prefetch_then_0.5x"]


@pytest.fixture(scope="module")
def runs():
    """{stage: [(frame, display, view pixels) for JAX, port, converted]},
    plus the build sides and the cache counts after each zoom step."""
    old_max = JF._SCENE_BUILD_CACHE_MAX
    JF._SCENE_BUILD_CACHE_MAX = 4
    JF.scene_build_cache_clear()
    JF.scene_build_cache_stats(reset=True)
    try:
        j, p = _jax_side(), _port_side()
        c = _converted_side(j)
        sides = [j, p, c]
        out = {"build": [s.scene_state() for s in (j, p)], "f_alpha": (j.disp.f_alpha, p.disp.f_alpha),
               "full_refresh": [s.state() for s in sides], "stats": {}}
        for k in range(3):
            for s in sides:
                s.filtered_frame(k)
            out[f"filtered_{k + 1}"] = [s.state() for s in sides]
        for s in sides:
            s.plain_frame(3)
        out["plain"] = [s.state() for s in sides]
        dirty_frames = [s.state()[0] for s in sides]
        for s in sides:
            s.view.render(full=True)
        out["render_full"] = [s.state() for s in sides]
        out["dirty_content"] = dirty_frames
        runs_frames = []
        for s in sides:
            starts, idxs = s.view.ts.build_lists(s.view.order)
            runs_frames.append(s.state(s.view.ts.render_runs(s.view.background, starts, idxs)))
        out["render_runs"] = runs_frames
        for name, f in (("zoom_2x", 2.0), ("zoom_0.5x", 0.5)):
            for s in sides:
                s.zoom(f)
            out[name] = [s.state() for s in sides]
            out["stats"][name] = (j.stats(), p.stats())
        for s in sides:
            s.prefetch_and_half()
        out["prefetch_then_0.5x"] = [s.state() for s in sides]
        out["zoomed"] = [s.scene_state() for s in sides]
        out["stats"]["prefetch_then_0.5x"] = (j.stats(), p.stats())
        yield out
    finally:
        JF._SCENE_BUILD_CACHE_MAX = old_max
        JF.scene_build_cache_clear()


def _summary(R, objs):
    return [(type(o.geometry.shape).__name__, o.geometry.fill.colour, repr(o.transform), R.bounds_of_basicshape(o))
            for o in objs]


def test_example_scene_is_config5():
    """examples.interactive_4k_scene is run.py config 5 at 3840x2160: object
    for object (kind, colour, transform, bounds) what the generator above
    builds through the JAX package."""
    objs, blob, f_geom = TE.interactive_4k_scene(CONFIG5["width"], CONFIG5["height"])
    jobjs, jblob, jf_geom = config5_scene(JAX_MODULES, **CONFIG5)
    assert len(objs) == 1006
    assert _summary(TR, [*objs, blob, f_geom]) == _summary(JR, [*jobjs, jblob, jf_geom])


def test_build_matches_jax(runs):
    (jn, jres, jpieces, jatlas), (pn, pres, ppieces, patlas) = runs["build"]
    assert pn == jn and pres == jres
    assert ppieces == jpieces
    assert np.array_equal(patlas, jatlas)
    jalpha, palpha = runs["f_alpha"]
    assert np.array_equal(palpha.numpy(), np.asarray(jalpha))


def test_zoomed_scene_matches_jax(runs):
    """The scene after the last zoom step, built or restored from the
    cache: the same slot count, piece lists and atlas all three ways."""
    (jn, _, jpieces, jatlas), *ports = runs["zoomed"]
    for pn, _, ppieces, patlas in ports:
        assert pn == jn
        assert ppieces == jpieces
        assert np.array_equal(patlas, jatlas)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(runs, stage):
    (jf, jdisp, jpix), (pf, pdisp, ppix), (cf, cdisp, cpix) = runs[stage]
    assert np.array_equal(pf, jf), "content frame (port build)"
    assert np.array_equal(cf, jf), "content frame (converted state)"
    assert np.array_equal(pdisp, jdisp), "display (port build)"
    assert np.array_equal(cdisp, jdisp), "display (converted state)"
    assert np.array_equal(ppix, jpix) and np.array_equal(cpix, jpix)


def test_full_frames_equal_dirty_content(runs):
    for dirty, (full, _, _), (rr, _, _) in zip(runs["dirty_content"], runs["render_full"], runs["render_runs"]):
        assert np.array_equal(full, dirty)
        assert np.array_equal(rr, full)


@pytest.mark.parametrize("stage", ["zoom_2x", "zoom_0.5x", "prefetch_then_0.5x"])
def test_scene_build_cache_counts_match_jax(runs, stage):
    jstats, pstats = runs["stats"][stage]
    assert pstats == jstats


def test_zoom_changes_the_frame_and_prefetch_hits(runs):
    assert not np.array_equal(runs["zoom_2x"][0][0], runs["render_full"][0][0])
    assert not np.array_equal(runs["prefetch_then_0.5x"][0][0], runs["zoom_0.5x"][0][0])
    before, after = runs["stats"]["zoom_0.5x"][1], runs["stats"]["prefetch_then_0.5x"][1]
    assert after["hits"] == before["hits"] + 1, (before, after)
