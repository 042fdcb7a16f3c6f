"""The port's run-contiguous full-frame compositor against the JAX
package's (K4: ``_kernel_runs_row`` after ``_gather_runs_kernel``, Pallas
in interpret mode), bit for bit.

``gather_runs`` against the JAX gather; ``render_runs`` against the JAX
``TiledScene.render_runs`` and the port's own ``render_full`` on the scene
of tests/test_tiled_scene.py:551; stacks whose tile depths run 1..9,
so the last chunk of four holds every count from 1 to 4, with and without
an opaque top piece (the early stop between chunks); and the lists whose
edges the card tests walk with the striped kernels (tests/test_torch_cuda.py
STRIPE_CASES but the deep ones), through composite_runs and, as a stack of
three bands with one band empty, through composite_full_banded_torch
against the JAX package's full-frame kernel per band.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
import jax.numpy as jnp
from coherence_tpu.raster import fills as JFL
from coherence_tpu.raster import tiled_scene as JTS
from coherence_tpu.raster.pallas_compositor import pack_rgba as jpack
from coherence_tpu.scene import fastframe as JF
from coherence_tpu.scene import render as JR

from coherence_tpu_torch import colour as TC
from coherence_tpu_torch import convert
from coherence_tpu_torch.raster import fills as TFL
from coherence_tpu_torch.raster import tiled_scene as T
from coherence_tpu_torch.scene import fastframe as TF
from coherence_tpu_torch.scene import render as TR

from _torch_hosts import JAX, PORT
from _torch_threads import one_torch_thread  # noqa: F401

from test_torch_cuda import STRIPE_CASES, banded_stripe_stack, random_atlas, random_plane, stripe_case, stripe_slots


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed,cap,n", [(0, 8, 8), (1, 64, 200), (2, 256, 256)])
def test_gather_runs_matches_jax(seed, cap, n):
    rng = np.random.default_rng(seed)
    atlas = random_atlas(rng, cap)
    idxs = rng.integers(0, cap, n).astype(np.int32)
    want = np.asarray(JTS._gather_runs_kernel(jnp.asarray(atlas), jnp.asarray(idxs)))
    got = T.gather_runs(convert.packed(atlas, "cpu"), torch.from_numpy(idxs))
    assert got.shape == (n + T._RUN_CHUNK - 1, 64, 128)
    assert np.array_equal(_u32(got), want)


def _polygon_scene(jax_side: bool):
    """The 12 polygons of tests/test_tiled_scene.py:551 (seed 11), opaque
    and translucent, some reaching past the frame."""
    R, FL, C, h = (JR, JFL, JC, JAX) if jax_side else (TR, TFL, TC, PORT)
    W, H = 512, 256
    rng = np.random.default_rng(11)
    objs = []
    for k in range(12):
        n = int(rng.integers(3, 6))
        pts = [(float(rng.uniform(-40, W + 40)), float(rng.uniform(-40, H + 40))) for _ in range(n)]
        colour = C.colour_of_rgba(*(int(v) for v in rng.integers(0, 256, 3)), 255)
        alpha = 255 if k % 2 else int(rng.integers(60, 256))
        fill = FL.plain(C.dissolve(colour, delta=alpha) if alpha != 255 else colour)
        if jax_side:
            path = h.gpath.path_of_pointlist(h.gpath.NONZERO, pts)
        else:  # the port has no path_of_pointlist: the same closed polygon
            ring = pts + pts[:1]
            segs = tuple(h.gpath.Straight(a, b) for a, b in zip(ring, ring[1:]))
            path = h.gpath.Path(h.gpath.NONZERO, (h.gpath.Subpath(False, True, segs),))
        objs.append(R.Obj(h.ident.new_ids(), R.Basic(fill, R.PathShape(path)), (), R.OVER))
    return objs


def test_render_runs_matches_jax_and_render_full():
    W, H = 512, 256
    jts = JTS.TiledScene(W, H)
    JF.build_tiled_scene(jts, list(enumerate(_polygon_scene(True))))
    tts = T.TiledScene(W, H, "cpu")
    TF.build_tiled_scene(tts, list(enumerate(_polygon_scene(False))))
    order = list(range(12))
    jbg = jpack(jnp.asarray(np.full((H, W, 4), 255), jnp.int32))
    js, ji = jts.build_lists(order)
    want = np.asarray(jts.render_runs(jbg, js, ji))
    assert np.array_equal(want, np.asarray(jts.render(jbg, js, ji)))
    ts_, ti = tts.build_lists(order)
    bg = convert.packed(np.asarray(jbg), "cpu")
    got = tts.render_runs(bg, ts_, ti)
    assert np.array_equal(_u32(got), want)
    assert torch.equal(got, tts.render_full(bg, ts_, ti))


def _depth_case(seed: int, opaque_top: bool):
    """A 3x3-tile frame whose tile t lists t + 1 pieces (depths 1..9), and
    a background of arbitrary words.  With `opaque_top`, every tile's first
    piece is opaque, so the walk stops after its first chunk."""
    rng = np.random.default_rng(seed)
    cap = 64
    atlas = random_atlas(rng, cap)
    per_tile = [list(rng.integers(0, cap, t + 1)) for t in range(9)]
    if opaque_top:
        for p in per_tile:
            p[0] = 4 * int(rng.integers(0, cap // 4))  # every fourth slot is opaque
    starts = np.zeros(10, np.int32)
    starts[1:] = np.cumsum([len(p) for p in per_tile])
    idxs = np.zeros(cap, np.int32)
    idxs[: starts[-1]] = [e for p in per_tile for e in p]
    return atlas, random_plane(rng, 3 * 64, 3 * 128), starts, idxs


@pytest.mark.parametrize("seed,opaque_top", [(0, False), (1, False), (2, True), (3, True)])
def test_composite_runs_depths_match_jax(seed, opaque_top):
    atlas, bg, starts, idxs = _depth_case(seed, opaque_top)
    runs = JTS._gather_runs_kernel(jnp.asarray(atlas), jnp.asarray(idxs))
    want = np.asarray(
        JTS._render_tiles_runs(jnp.asarray(starts), jnp.asarray(bg), runs, nty=3, ntx=3, interpret=True)
    )
    s, i = torch.from_numpy(starts), torch.from_numpy(idxs)
    a, b = convert.packed(atlas, "cpu"), convert.packed(bg, "cpu")
    got = T.composite_runs(s, b, T.gather_runs(a, i), 3, 3)
    assert np.array_equal(_u32(got), want)
    assert torch.equal(got, T.composite_full(s, i, b, a, 3, 3))
    if opaque_top:
        # Pieces under the opaque top never show: scramble them.
        scrambled = atlas.copy()
        keep = {int(idxs[starts[t]]) for t in range(9)}
        for slot in set(range(64)) - keep:
            scrambled[slot] = random_atlas(np.random.default_rng(slot), 1)[0]
        again = T.composite_runs(s, b, T.gather_runs(convert.packed(scrambled, "cpu"), i), 3, 3)
        assert torch.equal(again, got)


# The striped walk's edge cases; the deep ones (300 and 1100 pieces) are
# too slow for the reference kernels in interpret mode.
SHALLOW_STRIPE_CASES = [n for n in STRIPE_CASES if not n.startswith("deep")]


@pytest.mark.parametrize("name", SHALLOW_STRIPE_CASES)
def test_composite_runs_stripe_cases_match_jax(name):
    """Empty tiles, one piece, the ring plus one, an opaque first piece and
    partial coverage across stripe borders, through the run walk both
    ways."""
    atlas, lists = stripe_case(name)
    starts, idxs = stripe_slots(lists)[:2]
    ntx = len(lists) + 1
    bg = random_plane(np.random.default_rng(1), 64, ntx * 128)
    runs = JTS._gather_runs_kernel(jnp.asarray(atlas), jnp.asarray(idxs))
    want = np.asarray(
        JTS._render_tiles_runs(jnp.asarray(starts), jnp.asarray(bg), runs, nty=1, ntx=ntx, interpret=True)
    )
    s, i = torch.from_numpy(starts), torch.from_numpy(idxs)
    a, b = convert.packed(atlas, "cpu"), convert.packed(bg, "cpu")
    got = T.composite_runs(s, b, T.gather_runs(a, i), 1, ntx)
    assert np.array_equal(_u32(got), want)
    assert torch.equal(got, T.composite_full(s, i, b, a, 1, ntx))


@pytest.mark.parametrize("name", SHALLOW_STRIPE_CASES)
def test_composite_full_banded_stripe_cases_match_jax(name):
    """The three-band stack of the same lists (band 1 empty, band 2
    reversed): each band against the JAX package's _render_tiles_atlas on
    its lists, local atlas and rows; the empty band keeps its background."""
    atlas, bg, starts, idxs = banded_stripe_stack(name)
    ntx = starts.shape[1] - 1
    s, i = torch.from_numpy(starts), torch.from_numpy(idxs)
    a, b = convert.packed(atlas, "cpu"), convert.packed(bg, "cpu")
    got = T.composite_full_banded_torch(s, i, b, a, 1, ntx)
    for k in range(3):
        rows = slice(k * 64, (k + 1) * 64)
        want = JTS._render_tiles_atlas(jnp.asarray(starts[k]), jnp.asarray(idxs[k]), jnp.asarray(bg[rows]),
                                       jnp.asarray(atlas[k]), nty=1, ntx=ntx, interpret=True)
        assert np.array_equal(_u32(got[rows]), np.asarray(want)), k
    assert np.array_equal(_u32(got[64:128]), bg[64:128])
    assert torch.equal(T.composite_full_banded(s, i, b, a, 1, ntx), got)
