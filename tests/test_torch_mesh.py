"""The port's banded multi-device path against the JAX package's, bit for bit.

The JAX package's mesh tests run on 8 virtual CPU devices
(tests/conftest.py) with its Pallas kernels in interpret mode.  The port's
counterpart is a mesh whose device list may repeat a device, so each case
runs on three port meshes against the JAX mesh of the same band count:

  * 8 bands on 8 distinct CPU devices ("cpu:0" .. "cpu:7"), one launch and
    one halo exchange per band;
  * 8 bands on one device (["cpu"] * 8), one launch over the stack;
  * 2 bands on one device.

The banded atlas's layout depends on the band count, so it is held to the
JAX package's mesh of as many devices; frames do not (a meshed frame equals
the unmeshed one), so they are held to the JAX package's 8-device mesh.

Frames are 2 x 8 tiles (256 x 512), as in the JAX package's tests.  Scenes
are built in the JAX package and carried over with
``coherence_tpu_torch.convert`` where a test holds the compositor alone;
view-level tests build the same scene on both sides through the tile
rasterizer.  Tolerance 0 throughout: the colour math is integer.  The
port's scene-build cache is off, as the suite's conftest turns the JAX
package's off, so that a meshed and an unmeshed build never restore one
from the other.
"""

import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
from coherence_tpu.parallel import make_mesh as jax_make_mesh
from coherence_tpu.parallel import mesh as JM
from coherence_tpu.raster import convolve as JV
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import region as JRG
from coherence_tpu.raster import tiled_scene as JT
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch import colour as TC
from coherence_tpu_torch import convert, kernels
from coherence_tpu_torch.parallel import mesh as TM
from coherence_tpu_torch.parallel.dryrun import dryrun_multichip
from coherence_tpu_torch.raster import convolve as TV
from coherence_tpu_torch.raster import fills as TFL
from coherence_tpu_torch.raster import region as TRG
from coherence_tpu_torch.raster import tiled_scene as T
from coherence_tpu_torch.raster.compositor import TILE_H, TILE_W
from coherence_tpu_torch.scene import fastframe as TF
from coherence_tpu_torch.scene import render as TR

from _torch_hosts import JAX, PORT
from _torch_threads import one_torch_thread  # noqa: F401

W, H = TILE_W * 2, TILE_H * 8
PORT_MESHES = {
    "8 devices": (8, [f"cpu:{i}" for i in range(8)]),
    "8 bands on one device": (8, ["cpu"] * 8),
    "2 bands on one device": (2, ["cpu"] * 2),
}
MESH_IDS = list(PORT_MESHES)
# The dirty sets of the JAX package's sharded dirty test
# (tests/test_tiled_scene.py): tile 0 alone, part of one band, every tile,
# the last band alone.
DIRTY_SETS = [{0}, {1, 3}, set(range(16)), {2 * 7 + 1}]


@pytest.fixture(autouse=True)
def _no_port_scene_cache():
    TF.scene_build_cache_clear()
    old = TF._SCENE_BUILD_CACHE_MAX
    TF._SCENE_BUILD_CACHE_MAX = 0
    yield
    TF._SCENE_BUILD_CACHE_MAX = old
    TF.scene_build_cache_clear()


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results by (case, band count), each computed once."""
    return {}


def _once(cache, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _i32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _port_mesh(mesh_id):
    n, devices = PORT_MESHES[mesh_id]
    return n, TM.make_mesh(n, devices)


def _random_plane(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (H, W), dtype=np.uint64).astype(np.uint32)


def jax_tiled_scene(seed: int):
    """A JAX TiledScene of 24 boxes (a third translucent, many crossing
    band borders) under an animated object reserved across a border."""
    rng = np.random.default_rng(seed)
    jts = JT.TiledScene(W, H)
    order = []
    for k in range(24):
        x0, y0 = int(rng.integers(-20, W - 10)), int(rng.integers(-20, H - 10))
        w, h = int(rng.integers(8, 150)), int(rng.integers(8, 90))
        col = JC.dissolve(JC.colour_of_rgba(*(int(v) for v in rng.integers(0, 256, 3)), 255),
                          delta=255 if k % 3 else 150)
        jts.add_object(k, JRG.fillshape(JRG.shape_of_box((x0, y0, x0 + w - 1, y0 + h - 1)), JFL.plain(col)))
        order.append(k)
    anim = JRG.fillshape(JRG.shape_of_box((30, 50, 129, 129)), JFL.plain(JC.dissolve(JC.crimson, delta=170)))
    jts.reserve_slots("anim", 6)
    jts.update_object_inplace("anim", anim)
    order.insert(0, "anim")
    return jts, order


def port_scene_of(jts) -> T.TiledScene:
    return convert.tiled_scene(
        W, H, atlas=np.asarray(jts.atlas()), pieces={k: list(v) for k, v in jts.pieces.items()},
        reserved=dict(jts._reserved), n_pieces=jts._n_pieces, device="cpu",
    )


def _port_sprite(spr):
    w, h = spr.wh
    return convert.sprite(spr.box, np.asarray(spr.mask)[:h, :w], np.asarray(spr.rgba)[:h, :w], "cpu")


# --- the compositor: render_sharded, BandedAtlas, render_dirty_sharded ------


def _jax_full(n: int):
    jts, order = jax_tiled_scene(3)
    bg = _random_plane(3)
    out = _i32(JT.render_sharded(jts, bg, order, jax_make_mesh(n), interpret=True))
    b = jts._banded
    state = dict(data=np.asarray(b.data), g2l=[dict(m) for m in b.g2l], reserved_local=dict(b.reserved_local),
                 local_cap=b.local_cap)
    return out, state


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_render_sharded_matches_jax(jax_runs, mesh_id):
    n, mesh = _port_mesh(mesh_id)
    want, _ = _once(jax_runs, ("full", n), lambda: _jax_full(n))
    jts, order = jax_tiled_scene(3)
    ts = port_scene_of(jts)
    bg = convert.packed(_random_plane(3), "cpu")
    before = dict(kernels.launches)
    got = T.render_sharded(ts, bg, order, mesh)
    assert kernels.launches == before  # CPU tensors take the plain versions
    assert len(got.parts) == len(mesh.groups)
    assert np.array_equal(got.gather("cpu").numpy(), want)
    assert torch.equal(got.gather("cpu"), ts.render_full(bg, *ts.build_lists(order)))


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_banded_atlas_matches_jax(jax_runs, mesh_id):
    n, mesh = _port_mesh(mesh_id)
    _, want = _once(jax_runs, ("full", n), lambda: _jax_full(n))
    jts, order = jax_tiled_scene(3)
    ts = port_scene_of(jts)
    banded = T._banded_of(ts, mesh)
    assert T._banded_of(ts, mesh) is banded  # cached while the pieces stand
    assert banded.local_cap == want["local_cap"]
    assert banded.g2l == want["g2l"] and banded.reserved_local == want["reserved_local"]
    assert [tuple(d.shape) for d in banded.data] == [(b1 - b0, banded.local_cap, TILE_H, TILE_W)
                                                     for _, b0, b1 in mesh.groups]
    assert np.array_equal(torch.cat(banded.data).numpy(), want["data"].view(np.int32))
    # Unused local slots hold copies of global slot 0, as the gather leaves them.
    used = max(banded.g2l[0].values()) + 1
    if used < banded.local_cap:
        assert torch.equal(banded.data[0][0, used], ts.atlas()[0])
    assert banded.local_cap * (2 if n == 8 else 1) <= ts.atlas().shape[0]  # a fraction of the atlas
    # The JAX side's banded state carried over renders the same frame.
    carried = convert.banded_atlas(mesh, version=ts.pieces.version, **want)
    ts2 = port_scene_of(jts)
    carried.version = ts2.pieces.version
    ts2._banded = carried
    bg = convert.packed(_random_plane(3), "cpu")
    got = T.render_sharded(ts2, bg, order, mesh)
    assert ts2._banded is carried
    assert torch.equal(got.gather("cpu"), T.render_sharded(ts, bg, order, mesh).gather("cpu"))


def _recolour(k: int, n_dirty: int):
    col = JC.dissolve(JC.colour_of_rgba(30 + n_dirty, 80, 160, 255), delta=200)
    x0, y0 = 5 + 3 * n_dirty, 9
    return JRG.fillshape(JRG.shape_of_box((x0, y0, x0 + 30, y0 + 70)), JFL.plain(col))


def _jax_dirty(n: int):
    jts, order = jax_tiled_scene(4)
    frame = _i32(jts.render_full(_random_plane(4), *jts.build_lists(order))).view(np.uint32)
    frames = []
    for dirty in DIRTY_SETS:
        jts.add_object(order[1], _recolour(order[1], len(dirty)))
        frame = JT.render_dirty_sharded(jts, frame, _random_plane(4), order, sorted(dirty), jax_make_mesh(n),
                                        interpret=True)
        frames.append(_i32(frame))
    return frames


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_render_dirty_sharded_matches_jax(jax_runs, mesh_id):
    n, mesh = _port_mesh(mesh_id)
    want = _once(jax_runs, "dirty", lambda: _jax_dirty(8))
    jts, order = jax_tiled_scene(4)
    ts = port_scene_of(jts)
    bg = convert.packed(_random_plane(4), "cpu")
    plain = ts.render_full(bg, *ts.build_lists(order))
    frame = TM.RowSharded.scatter(plain, mesh, H // n)
    for dirty, w in zip(DIRTY_SETS, want):
        ts.add_object(order[1], _port_sprite(_recolour(order[1], len(dirty))))
        got = T.render_dirty_sharded(ts, frame, bg, order, dirty, mesh)
        assert got is frame  # in place, band by band
        plain = ts.render_dirty(plain, bg, order, sorted(dirty))
        assert np.array_equal(frame.gather("cpu").numpy(), w), dirty
        assert torch.equal(frame.gather("cpu"), plain), dirty


def test_sharded_dirty_lists_pad_and_idle_bands():
    jts, order = jax_tiled_scene(4)
    ts = port_scene_of(jts)
    banded = T._banded_of(ts, TM.make_mesh(8, ["cpu"] * 8))
    coords, spans, idxs, n_slots = T.sharded_dirty_lists(ts, order, {0, 1, 3}, banded)
    assert n_slots == 8 and coords.shape == spans.shape == (8, 16) and idxs.shape[1] % 8 == 0
    # Band 0 lists tiles 0 and 1 (row 0), padded by repeating tile 1.
    assert list(coords[0, :4]) == [0, 0, 0, 1]
    assert (coords[0, 2::2] == 0).all() and (coords[0, 3::2] == 1).all()
    assert (spans[0, 2::2] == spans[0, 2]).all() and (spans[0, 3::2] == spans[0, 3]).all()
    # Band 1 lists its local tile (0, 1); bands 2-7 are idle: every slot
    # passes local tile (0, 0) through.
    assert list(coords[1, :2]) == [0, 1] and spans[1, 0] == 0
    assert (spans[2:] == -1).all() and (coords[2:] == 0).all()


# --- the blur and the composite-and-blur step --------------------------------


def _frame(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(H, 64, 4)).astype(np.int32)


@pytest.mark.parametrize("radius", [2, 5])
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_blur_pass_and_sharded_blur_match_jax(jax_runs, mesh_id, radius):
    n, mesh = _port_mesh(mesh_id)
    fr = _frame(radius)
    weights = tuple(JV.mkgaussian(radius).values)
    want = _once(jax_runs, ("blur", radius), lambda: np.asarray(JM.blur_pass(JM.blur_pass(fr, weights, 0), weights, 1)))
    want_sharded = _once(jax_runs, ("sharded_blur", n, radius),
                         lambda: np.asarray(JM.sharded_blur(jax_make_mesh(n), fr, weights)))
    assert np.array_equal(want_sharded, want)
    t = torch.from_numpy(fr)
    assert np.array_equal(TM.blur_pass(TM.blur_pass(t, weights, 0), weights, 1).numpy(), want)
    got = TM.sharded_blur(mesh, t, weights)
    assert np.array_equal(got.gather("cpu").numpy(), want)


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_sharded_render_step_matches_jax(jax_runs, mesh_id):
    n, mesh = _port_mesh(mesh_id)

    def jax_step():
        step, make_args = JM.sharded_render_step(jax_make_mesh(n))
        frame, open_mask = step(*make_args(h=8 * n, w=256, n_layers=3))
        return np.asarray(frame), np.asarray(open_mask)

    want_frame, want_open = _once(jax_runs, ("step", n), jax_step)
    step, make_args = TM.sharded_render_step(mesh)
    frame, open_mask = step(*make_args(h=8 * n, w=256, n_layers=3))
    assert np.array_equal(frame.gather("cpu").numpy(), want_frame)
    assert np.array_equal(open_mask.gather("cpu").numpy(), want_open)


def test_make_mesh_never_downsizes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only"):
        TM.make_mesh(2)
    with pytest.raises(ValueError):
        TM.make_mesh(3, ["cpu"] * 2)
    with pytest.raises(ValueError, match="contiguous"):
        TM.Mesh(["cpu:0", "cpu:1", "cpu:0"])
    mesh = TM.make_mesh(4, ["cpu:0", "cpu:0", "cpu:1", "cpu:1"])
    assert [(str(d), b0, b1) for d, b0, b1 in mesh.groups] == [("cpu:0", 0, 2), ("cpu:1", 2, 4)]


# --- the view and the display under a mesh -----------------------------------


def _objs(R, FL, Cm, specs):
    h = JAX if R is JR else PORT
    out = []
    for kind, args, col in specs:
        shape = R.PathShape(h.gshapes.circle(*args)) if kind == "circle" else R.rectangle(*args)
        out.append(R.Obj(h.ident.new_ids(), R.Basic(FL.plain(col(Cm)), shape), (), R.OVER))
    return out


VIEW_SCENE = [("circle", (60.0, 80.0, 25.0), lambda C: C.dissolve(C.crimson, delta=170)),
              ("rect", (20.0, 40.0, 150.0, 300.0), lambda C: C.steelblue)]
VIEW_FILTER = [("rect", (10.0, 30.0, 200.0, 380.0), lambda C: C.white)]
VIEW_STEPS = [(7, 30), (0, 64), (-3, -10)]


def _view_run(side, mesh):
    """Full render, make_animated, translate_object steps across band
    borders, then a FilteredDisplay refresh and step: the pixels after each
    stage."""
    R, FL, Cm, F, RG, V = side
    scene = _objs(R, FL, Cm, VIEW_SCENE)
    f_geom = _objs(R, FL, Cm, VIEW_FILTER)[0]
    jax_side = F is JF
    v = F.DeviceView(W, H) if jax_side else F.DeviceView(W, H, device="cpu")
    if jax_side:
        v.set_scene(scene, tiled=True)
        v.sprites[scene[0].idset] = F.tiled_sprite_of_object(scene[0], v.pw, v.ph)
    else:
        v.set_scene(scene, tiled=True)
        v.sprites[scene[0].idset] = F.tiled_sprite_of_object(scene[0], v.pw, v.ph, "cpu")
    if mesh is not None:
        if jax_side:
            v.use_mesh(mesh, interpret=True)
        else:
            v.use_mesh(mesh)
    out = []
    v.render(full=True)
    out.append(np.array(v.read()))
    key = scene[0].idset
    v.make_animated(key)
    v.render()
    out.append(np.array(v.read()))
    for step in VIEW_STEPS:
        v.translate_object(key, *step)
        v.render()
        out.append(np.array(v.read()))
    f_alpha = F.alpha_plane_of_object(f_geom, W, H) if jax_side else F.alpha_plane_of_object(f_geom, W, H, "cpu")
    d = F.FilteredDisplay(v, f_alpha, V.mkgaussian(2))
    d.full_refresh()
    out.append(np.array(d.read()))
    prev = v.sprites[key].box
    v.translate_object(key, 4, 9)
    d.step(RG.box_union(prev, v.sprites[key].box))
    out.append(np.array(d.read()))
    return out


JAX_SIDE = (JR, JFL, JC, JF, JRG, JV)
PORT_SIDE = (TR, TFL, TC, TF, TRG, TV)


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_meshed_view_matches_jax(jax_runs, mesh_id):
    _, mesh = _port_mesh(mesh_id)
    want = _once(jax_runs, "view", lambda: _view_run(JAX_SIDE, jax_make_mesh(8)))
    got = _view_run(PORT_SIDE, mesh)
    unmeshed = _view_run(PORT_SIDE, None)
    for k, (g, w, u) in enumerate(zip(got, want, unmeshed)):
        assert np.array_equal(g, w), f"stage {k}"
        assert np.array_equal(g, u), f"stage {k}"


ANIM_STATICS = [("rect", (20.0, 30.0, 180.0, 420.0), lambda C: C.steelblue),
                ("rect", (1.0, 1.0, float(W), float(H)), lambda C: C.white)]
ANIM_BLOB = [("circle", (60.0, 50.0, 22.0), lambda C: C.dissolve(C.crimson, delta=170))]
ANIM_FILTER = [("rect", (10.0, 20.0, 220.0, 460.0), lambda C: C.white)]
ANIM_STEPS = [(0, 40), (5, 40), (-3, 40), (2, 40), (0, 40)]  # each crosses band borders


def _animated(side, mesh):
    """The blob over two statics, reserved for in-place moves, under a
    radius-2 blur band: (view, display, blob key)."""
    R, FL, Cm, F, RG, V = side
    blob = _objs(R, FL, Cm, ANIM_BLOB)[0]
    scene = [blob] + _objs(R, FL, Cm, ANIM_STATICS)
    f_geom = _objs(R, FL, Cm, ANIM_FILTER)[0]
    if F is JF:
        v = F.DeviceView(W, H)
        v.set_scene(scene, tiled=True)
        v.sprites[blob.idset] = F.tiled_sprite_of_object(blob, v.pw, v.ph)
        f_alpha = F.alpha_plane_of_object(f_geom, W, H)
    else:
        v = F.DeviceView(W, H, device="cpu")
        v.set_scene(scene, tiled=True)
        v.sprites[blob.idset] = F.tiled_sprite_of_object(blob, v.pw, v.ph, "cpu")
        f_alpha = F.alpha_plane_of_object(f_geom, W, H, "cpu")
    v.make_animated(blob.idset)
    if mesh is not None and F is JF:
        v.use_mesh(mesh, interpret=True)
    elif mesh is not None:
        v.use_mesh(mesh)
    d = F.FilteredDisplay(v, f_alpha, V.mkgaussian(2))
    d.full_refresh()
    return v, d, blob.idset


def _jax_animated(n: int):
    v, d, key = _animated(JAX_SIDE, jax_make_mesh(n))
    out = [(np.array(d.read()), None)]
    for step in ANIM_STEPS:
        d.step_animated(key, *step)
        out.append((np.array(d.read()), np.asarray(v.ts._banded.data).view(np.int32)))
    return out


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_sharded_step_animated_crosses_bands_under_blur(jax_runs, mesh_id):
    n, mesh = _port_mesh(mesh_id)
    want = _once(jax_runs, "animated", lambda: _jax_animated(8))
    v, d, key = _animated(PORT_SIDE, mesh)
    uv, ud, ukey = _animated(PORT_SIDE, None)
    assert isinstance(d.rgba, TM.RowSharded) and len(d.rgba.parts) == len(mesh.groups)
    assert np.array_equal(d.read(), want[0][0]) and np.array_equal(ud.read(), want[0][0])
    banded_after_first = None
    for k, (step, (display, banded_data)) in enumerate(zip(ANIM_STEPS, want[1:])):
        d.step_animated(key, *step)
        ud.step_animated(ukey, *step)
        assert np.array_equal(d.read(), display), f"frame {k}"
        assert np.array_equal(ud.read(), display), f"frame {k}, unmeshed"
        # The banded atlas is updated in place, slot for slot as the JAX
        # package's (zeros in reserved slots of other bands), never rebuilt.
        if n == 8:
            assert np.array_equal(torch.cat(v.ts._banded.data).numpy(), banded_data), f"frame {k}"
        if banded_after_first is None:
            banded_after_first = v.ts._banded
        assert v.ts._banded is banded_after_first, "the banded atlas was rebuilt"
    assert torch.equal(v.content("cpu"), uv.frame)
    assert v.ts._banded.local_cap < v.ts.atlas().shape[0]


def test_reset_drops_the_banded_atlas():
    jts, order = jax_tiled_scene(5)
    ts = port_scene_of(jts)
    mesh = TM.make_mesh(2, ["cpu"] * 2)
    b1 = T._banded_of(ts, mesh)
    assert T._banded_of(ts, mesh) is b1
    assert T._banded_of(ts, TM.make_mesh(2, ["cpu:0", "cpu:1"])) is not b1  # another mesh
    b1 = T._banded_of(ts, mesh)
    n_assign = ts.pieces.version
    ts.reset()
    assert ts._banded is None and ts.pieces.version == 0
    # As many piece-list assignments as before: the version alone would
    # collide with the old banded atlas's.
    for k in range(n_assign):
        ts.add_object(("new", k), _port_sprite(JRG.fillshape(JRG.shape_of_box((5 + k, 5, 24 + k, 24)),
                                                             JFL.plain(JC.steelblue))))
    assert ts.pieces.version >= b1.version
    assert T._banded_of(ts, mesh) is not b1


SCENE_B = [("circle", (120.0, 300.0, 40.0), lambda C: C.dissolve(C.darkorange, delta=200)),
           ("rect", (40.0, 100.0, 120.0, 200.0), lambda C: C.wheat)]


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_reset_scene_under_mesh_matches_fresh_view(jax_runs, mesh_id):
    _, mesh = _port_mesh(mesh_id)

    def jax_fresh():
        fresh = JF.DeviceView(W, H)
        fresh.set_scene(_objs(JR, JFL, JC, SCENE_B), tiled=True)
        fresh.render(full=True)
        return np.array(fresh.read())

    want = _once(jax_runs, "scene_b", jax_fresh)
    v = TF.DeviceView(W, H, device="cpu")
    v.set_scene(_objs(TR, TFL, TC, VIEW_SCENE), tiled=True)
    v.use_mesh(mesh)
    v.render(full=True)
    old = v.ts._banded
    v.reset_scene(_objs(TR, TFL, TC, SCENE_B), tiled=True)
    v.render(full=True)
    assert v.ts._banded is not old
    assert np.array_equal(v.read(), want)
    fresh = TF.DeviceView(W, H, device="cpu")
    fresh.set_scene(_objs(TR, TFL, TC, SCENE_B), tiled=True)
    fresh.render(full=True)
    assert np.array_equal(v.read(), fresh.read())


# --- play_animated -----------------------------------------------------------

PLAY_DELTAS = [(7, 3), (7, 3), (-7, -3), (7, 3)]


def _jax_play():
    v, d, key = _animated(JAX_SIDE, None)
    frames = d.play_animated(key, PLAY_DELTAS, capture_every=2, require_scan=True)
    return np.array(d.read()), _i32(v.frame), np.asarray(frames)


def test_play_animated_matches_jax_and_sequential_steps(jax_runs):
    want_display, want_frame, want_frames = _once(jax_runs, "play", _jax_play)
    v, d, key = _animated(PORT_SIDE, None)
    frames = d.play_animated(key, PLAY_DELTAS, capture_every=2, require_scan=True)
    sv, sd, skey = _animated(PORT_SIDE, None)
    caps = []
    for i, step in enumerate(PLAY_DELTAS):
        sd.step_animated(skey, *step)
        if i % 2:
            caps.append(sd.read().astype(np.uint8))
    assert frames.dtype == np.uint8 and frames.shape == (2, H, W, 4)
    assert np.array_equal(frames, want_frames) and np.array_equal(frames, np.stack(caps))
    assert np.array_equal(d.read(), want_display) and np.array_equal(sd.read(), want_display)
    assert np.array_equal(v.frame.numpy(), want_frame) and torch.equal(v.frame, sv.frame)
    assert v.ts.pieces[key] == sv.ts.pieces[skey] and v.sprites[key].box == sv.sprites[skey].box
    # The host state stays consistent: one more step agrees.
    d.step_animated(key, 5, 2)
    sd.step_animated(skey, 5, 2)
    assert np.array_equal(d.read(), sd.read())


def test_play_animated_falls_back_under_a_mesh():
    v, d, key = _animated(PORT_SIDE, TM.make_mesh(2, ["cpu"] * 2))
    with pytest.raises(RuntimeError, match="scan unavailable"):
        d.play_animated(key, PLAY_DELTAS, require_scan=True)
    assert d.play_animated(key, PLAY_DELTAS) is None
    sv, sd, skey = _animated(PORT_SIDE, None)
    for step in PLAY_DELTAS:
        sd.step_animated(skey, *step)
    assert np.array_equal(d.read(), sd.read())


# --- the dry-run twin --------------------------------------------------------


@pytest.mark.parametrize("n,devices", [(8, [f"cpu:{i}" for i in range(8)]), (8, ["cpu"] * 8), (2, ["cpu"] * 2)])
def test_dryrun_multichip(n, devices):
    got = dryrun_multichip(n, devices)
    assert got["n_bands"] == n and got["local_cap"] * 2 <= got["global_slots"]
