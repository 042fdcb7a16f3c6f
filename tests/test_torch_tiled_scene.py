"""The port's tiled scene against the JAX package's, bit for bit.

One atlas and one set of lists, made from seeded numpy, go through the JAX
package's Pallas compositors (interpret mode on the CPU, as its own tests
run them) and through the port's plain PyTorch versions and their CPU
wrappers.  Host-side list building, dirty-slot packing and the in-place
shatter are compared array for array.  Tolerance 0 throughout: the
compositor is integer math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
from coherence_tpu.raster import fills as jfills
from coherence_tpu.raster import region as jregion
from coherence_tpu.raster import tiled_scene as JT

from coherence_tpu_torch import convert
from coherence_tpu_torch.raster import tiled_scene as T
from coherence_tpu_torch.raster.compositor import TILE_H, TILE_W
from coherence_tpu_torch.raster.region import translate_sprite

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import composite_case, dirty_case


def _i32(x) -> np.ndarray:
    """JAX uint32 words as int32 with the same bits."""
    return np.asarray(x).view(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_composite_full_matches_jax(seed):
    nty, ntx = 4, 4
    atlas, bg, starts, idxs = composite_case(seed, nty, ntx)
    jts = JT.TiledScene(ntx * TILE_W, nty * TILE_H)
    jts._data = jnp.asarray(atlas)
    k3 = _i32(jts.render(jnp.asarray(bg), jnp.asarray(starts), jnp.asarray(idxs)))
    k2 = _i32(jts.render_full(jnp.asarray(bg), jnp.asarray(starts), jnp.asarray(idxs)))
    assert np.array_equal(k2, k3)

    a, b = convert.packed(atlas, "cpu"), convert.packed(bg, "cpu")
    plain = T.composite_full_torch(_t(starts), _t(idxs), b, a, nty, ntx)
    assert np.array_equal(plain.numpy(), k3)
    wrapped = T.composite_full(_t(starts), _t(idxs), b, a, nty, ntx)
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("seed,n_real", [(0, 6), (1, 8), (2, 9), (3, 16)])
def test_composite_dirty_matches_jax(seed, n_real):
    atlas, bg, frame, coords, spans, idxs, n_slots = dirty_case(seed, n_real=n_real)
    want = _i32(JT._render_dirty_tiles(
        jnp.asarray(coords), jnp.asarray(spans), jnp.asarray(idxs), jnp.asarray(bg),
        jnp.asarray(frame), jnp.asarray(atlas), n_slots=n_slots, interpret=True,
    ))
    a, b = convert.packed(atlas, "cpu"), convert.packed(bg, "cpu")
    args = (_t(coords), _t(spans), _t(idxs), b)
    plain = convert.packed(frame, "cpu")
    T.composite_dirty_torch(*args, plain, a, n_slots)
    assert np.array_equal(plain.numpy(), want)
    wrapped = convert.packed(frame, "cpu")
    T.composite_dirty(*args, wrapped, a, n_slots)
    assert torch.equal(wrapped, plain)


def _scene_pair(seed: int, W: int, H: int, n_objs: int):
    """The same boxes added to a JAX TiledScene and to the port's, with
    one animated (reserved, updated in place) object on top."""
    rng = np.random.default_rng(seed)
    jts, pts = JT.TiledScene(W, H), T.TiledScene(W, H, "cpu")
    order = []
    for k in range(n_objs):
        x0, y0 = int(rng.integers(-20, W - 10)), int(rng.integers(-20, H - 10))
        w, h = int(rng.integers(8, 150)), int(rng.integers(8, 90))
        delta = 255 if k % 3 else 150
        col = JC.dissolve(JC.colour_of_rgba(*(int(v) for v in rng.integers(0, 256, 3)), 255), delta=delta)
        spr = jregion.fillshape(jregion.shape_of_box((x0, y0, x0 + w - 1, y0 + h - 1)), jfills.plain(col))
        jts.add_object(k, spr)
        pts.add_object(k, convert.sprite(spr.box, np.asarray(spr.mask)[:h, :w], np.asarray(spr.rgba)[:h, :w], "cpu"))
        order.append(k)
    box = (30, 20, 30 + 99, 20 + 79)
    spr = jregion.fillshape(jregion.shape_of_box(box), jfills.plain(JC.dissolve(JC.crimson, delta=170)))
    pspr = convert.sprite(spr.box, np.asarray(spr.mask)[:80, :100], np.asarray(spr.rgba)[:80, :100], "cpu")
    for ts, s in ((jts, spr), (pts, pspr)):
        ts.reserve_slots("anim", 6)
        ts.update_object_inplace("anim", s)
    order.insert(0, "anim")
    return jts, pts, order, spr, pspr


def test_scene_state_matches_jax():
    jts, pts, order, _, _ = _scene_pair(5, 4 * TILE_W, 3 * TILE_H, 12)
    assert pts._n_pieces == jts._n_pieces
    assert pts._reserved == jts._reserved
    assert {k: list(v) for k, v in pts.pieces.items()} == {k: list(v) for k, v in jts.pieces.items()}
    assert np.array_equal(pts.atlas().numpy(), _i32(jts.atlas()))


def test_build_lists_matches_jax():
    jts, pts, order, _, _ = _scene_pair(6, 4 * TILE_W, 3 * TILE_H, 12)
    js, ji = jts.build_lists(order)
    ps, pi = pts.build_lists(order)
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    # The full-frame composite of the lists, both ways.
    bg = np.full((3 * TILE_H, 4 * TILE_W), 0xFFFFFFFF, np.uint32)
    want = _i32(jts.render_full(jnp.asarray(bg), js, ji))
    got = pts.render_full(convert.packed(bg, "cpu"), ps, pi)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dirty", [[0], [1, 2, 5, 6], list(range(12))])
def test_dirty_args_match_jax(dirty):
    jts, pts, order, spr, pspr = _scene_pair(7, 4 * TILE_W, 3 * TILE_H, 12)
    j_oys, j_oxs, j_base, entries = jts._inplace_args("anim", jregion.translate_sprite(70, 30, spr))
    p_oys, p_oxs, p_base, p_entries = pts._inplace_args("anim", translate_sprite(70, 30, pspr))
    assert (list(p_oys), list(p_oxs), p_base, p_entries) == (list(j_oys), list(j_oxs), j_base, entries)
    for override in (None, {"anim": entries}):
        want = jts._dirty_args(order, dirty, pieces_override=override)
        got = pts._dirty_args(order, dirty, pieces_override=override)
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w)
        assert got[3] == want[3]


def test_dirty_render_matches_jax():
    jts, pts, order, _, _ = _scene_pair(8, 4 * TILE_W, 3 * TILE_H, 12)
    rng = np.random.default_rng(8)
    bg = np.full((3 * TILE_H, 4 * TILE_W), 0xFF336699, np.uint32)
    frame = rng.integers(0, 2**32, bg.shape, dtype=np.uint64).astype(np.uint32)
    dirty = [0, 3, 5, 6, 11]
    want = _i32(jts.render_dirty(jnp.asarray(frame), jnp.asarray(bg), order, dirty))
    got = pts.render_dirty(convert.packed(frame, "cpu"), convert.packed(bg, "cpu"), order, dirty)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_shatter_into_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cap, h, w = 16, 150, 300
    atlas = rng.integers(0, 2**32, (cap, TILE_H, TILE_W), dtype=np.uint64).astype(np.uint32)
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.int32)
    # Offsets inside, straddling and wholly outside the raster.
    oys = np.asarray([-70, -10, 0, 40, 100, 140, 200], np.int64)
    oxs = np.asarray([-200, -5, 0, 64, 200, 250, 0], np.int64)
    base = 5
    want = _i32(JT._shatter_into_kernel(jnp.asarray(atlas), jnp.asarray(rgba), oys, oxs, base))
    got = T.shatter_into(convert.packed(atlas, "cpu"), _t(rgba), oys, oxs, base)
    assert np.array_equal(got.numpy(), want)
