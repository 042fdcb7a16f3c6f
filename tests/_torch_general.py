"""The two sides of a parity test of the general renderer.

``JAX`` and ``PORT`` name the same modules of the JAX package and of the
port, and wrap the few calls whose signatures differ (the port's take the
device; a test passes ``"cpu"``), so that one scenario written against a
side runs on both.  Results come back as numpy (``np_shape``, ``np_sprite``)
cropped to the box's extent: the JAX package pads its planes to pow2
buckets, the port does not.

Each side has its own coherence cache, flags, counters and id counter: a
scenario builds its objects from the side it is given (hazard: no object of
one package reaches the other), and the ``both_sides`` fixture clears both
caches around every test.  Both sides run at their default flags: a group
renders through the batched raster on each.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import coherence_tpu.colour as j_C
import coherence_tpu.transform as j_tr
from coherence_tpu import ident as j_ident
from coherence_tpu.geometry import dash as j_dash
from coherence_tpu.geometry import path as j_gpath
from coherence_tpu.geometry import shapes as j_gshapes
from coherence_tpu.raster import aa as j_aa
from coherence_tpu.raster import blend as j_blend
from coherence_tpu.raster import brush as j_brush
from coherence_tpu.raster import convolve as j_convolve
from coherence_tpu.raster import fills as j_fills
from coherence_tpu.raster import region as j_region
from coherence_tpu.raster import scanline as j_scanline
from coherence_tpu.scene import cache as j_cache
from coherence_tpu.scene import examples as j_examples
from coherence_tpu.scene import filters as j_filters
from coherence_tpu.scene import icons as j_icons
from coherence_tpu.scene import render as j_R
from coherence_tpu.utils import flags as j_flags
from coherence_tpu.utils import profiling as j_profiling

import coherence_tpu_torch.colour as t_C
import coherence_tpu_torch.transform as t_tr
from coherence_tpu_torch import ident as t_ident
from coherence_tpu_torch.geometry import dash as t_dash
from coherence_tpu_torch.geometry import path as t_gpath
from coherence_tpu_torch.geometry import shapes as t_gshapes
from coherence_tpu_torch.raster import aa as t_aa
from coherence_tpu_torch.raster import blend as t_blend
from coherence_tpu_torch.raster import brush as t_brush
from coherence_tpu_torch.raster import convolve as t_convolve
from coherence_tpu_torch.raster import fills as t_fills
from coherence_tpu_torch.raster import region as t_region
from coherence_tpu_torch.raster import scanline as t_scanline
from coherence_tpu_torch.scene import cache as t_cache
from coherence_tpu_torch.scene import examples as t_examples
from coherence_tpu_torch.scene import filters as t_filters
from coherence_tpu_torch.scene import icons as t_icons
from coherence_tpu_torch.scene import render as t_R
from coherence_tpu_torch.utils import flags as t_flags
from coherence_tpu_torch.utils import profiling as t_profiling

DEV = "cpu"


def _crop(s, arr):
    w, h = s.wh
    return np.asarray(arr)[:h, :w]


def _np_shape(s, tensor_np):
    if s is None:
        return None
    return tuple(s.box), _crop(s, tensor_np(s.mask)), bool(s.full_box)


def _np_sprite(s, tensor_np):
    if s is None:
        return None
    return tuple(s.box), _crop(s, tensor_np(s.mask)), _crop(s, tensor_np(s.rgba))


def _side(name, dev, **mods):
    """dev is () for the JAX side and ("cpu",) for the port: appended to
    every call that builds a raster."""
    s = SimpleNamespace(name=name, **mods)
    tensor_np = np.asarray if not dev else (lambda t: t.numpy())
    R, region = s.R, s.region
    s.np_shape = lambda shp: _np_shape(shp, tensor_np)
    s.np_sprite = lambda spr: _np_sprite(spr, tensor_np)
    s.np_plane = tensor_np
    s.shape_of_box = lambda box: region.shape_of_box(box, *dev)
    s.shape_of_mask = lambda box, mask: region.shape_of_mask(box, mask, *dev)
    s.newcanvas = lambda w, h, c: region.newcanvas(w, h, c, *dev)
    s.render_simple_scene = lambda scene, shp: R.render_simple_scene(scene, shp, *dev)
    s.shape_of_basicshape = lambda o: R.shape_of_basicshape(o, *dev)
    s.shapeonly_of_basicshape = lambda o: R.shapeonly_of_basicshape(o, *dev)
    s.sprite_of_basicshape = lambda o, shp, scene: R.sprite_of_basicshape(o, shp, scene, *dev)
    s.dirty_region = lambda o, n: R.dirty_region(o, n, *dev)
    s.dirty_filter = lambda lmo, d, scene: R.dirty_filter(lmo, d, scene, *dev)
    s.view = lambda **kw: R.View(**kw, **({"device": dev[0]} if dev else {}))
    s.shapeminshape_of_edgelist = lambda e, w: s.scanline.shapeminshape_of_edgelist(e, w, *dev)
    s.shape_of_brushstroke = lambda b: s.brush.shape_of_brushstroke(b, *dev)
    s.sprite_of_brushstroke = lambda b, f, shp: s.brush.sprite_of_brushstroke(b, f, shp, *dev)
    s.smear = lambda spr, b: s.brush.smear(spr, b, *dev)
    s.icon_of_pdf = lambda f: s.icons.icon_of_pdf(f, *dev)
    return s


JAX = _side(
    "jax", (), C=j_C, tr=j_tr, ident=j_ident, dash=j_dash, gpath=j_gpath, gshapes=j_gshapes,
    aa=j_aa, blend=j_blend, brush=j_brush, convolve=j_convolve, fills=j_fills, region=j_region,
    scanline=j_scanline, cache=j_cache, examples=j_examples, filters=j_filters, icons=j_icons,
    R=j_R, flags=j_flags, profiling=j_profiling,
)
PORT = _side(
    "port", (DEV,), C=t_C, tr=t_tr, ident=t_ident, dash=t_dash, gpath=t_gpath, gshapes=t_gshapes,
    aa=t_aa, blend=t_blend, brush=t_brush, convolve=t_convolve, fills=t_fills, region=t_region,
    scanline=t_scanline, cache=t_cache, examples=t_examples, filters=t_filters, icons=t_icons,
    R=t_R, flags=t_flags, profiling=t_profiling,
)
SIDES = (JAX, PORT)


def same_raster(a, b) -> bool:
    """Two np_shape or np_sprite results: both null, or equal in box, in
    the mask over the box and in the third part (the full_box flag, or the
    colour plane, which is clear outside the mask on both sides)."""
    if a is None or b is None:
        return a is None and b is None
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


def describe(a, b) -> str:
    """Where two rasters first differ, for an assertion message."""
    if a is None or b is None:
        return f"null on one side: jax {None if a is None else a[0]}, port {None if b is None else b[0]}"
    if a[0] != b[0]:
        return f"boxes differ: jax {a[0]}, port {b[0]}"
    bad = a[1] != b[1]
    if np.ndim(a[2]) == 3:
        bad = bad | (a[2] != b[2]).any(-1)
    elif a[2] != b[2]:
        return f"full_box differs: jax {a[2]}, port {b[2]}"
    at = np.argwhere(bad)
    if len(at) == 0:
        return "equal"
    y, x = at[0]
    third = (a[2][y, x], b[2][y, x]) if np.ndim(a[2]) == 3 else ""
    return f"{len(at)} cells differ, first (row {y}, col {x}) of box {a[0]}: mask {a[1][y, x]}/{b[1][y, x]} {third}"


def assert_same_sprite(jax_sprite, port_sprite, what=""):
    a, b = JAX.np_sprite(jax_sprite), PORT.np_sprite(port_sprite)
    assert same_raster(a, b), f"{what}: {describe(a, b)}"


def assert_same_shape(jax_shape, port_shape, what=""):
    a, b = JAX.np_shape(jax_shape), PORT.np_shape(port_shape)
    assert same_raster(a, b), f"{what}: {describe(a, b)}"


def dense(side, spr, box) -> np.ndarray:
    """The sprite's defined pixels over `box` as an (h, w, 4) array; clear
    elsewhere."""
    x0, y0, x1, y1 = box
    out = np.zeros((y1 - y0 + 1, x1 - x0 + 1, 4), dtype=np.int32)
    got = side.np_sprite(spr)
    if got is None:
        return out
    (sx0, sy0, _, _), m, r = got
    h, w = m.shape
    sub = out[sy0 - y0 : sy0 - y0 + h, sx0 - x0 : sx0 - x0 + w]
    sub[m] = r[m]
    return out


@pytest.fixture
def both_sides():
    """Fresh caches and counters on both sides, and each side's flags as
    they were after the test."""
    sizes = (j_cache.properties.cachemaxsize, t_cache.properties.cachemaxsize)
    flags = (j_flags.all_flags(), t_flags.all_flags())
    for side in SIDES:
        side.cache.clear()
        side.cache.usecache = True
        side.profiling.reset()
    yield SIDES
    for side, was in zip(SIDES, flags):
        for name, value in was.items():
            side.flags.set_flag(name, value)
    for side, size in zip(SIDES, sizes):
        side.cache.usecache = True
        side.cache.setsize(size)
        side.cache.clear()
