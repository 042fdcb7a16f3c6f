"""Shapes and sprites as dense device rasters (parity: reference ``sprite.ml``).

The PyTorch counterpart of ``coherence_tpu.raster.region``, whole:

* a **Shape** (``sprite.ml:23-54``) is a pixel bounding box plus a dense
  boolean coverage mask on a device;
* a **Sprite** adds a premultiplied-RGBA ``int32`` plane over the same box;
  its mask records where it was rendered (which may include fully
  transparent AA pixels), mirroring the span structure's "defined" region.

Boxes are the reference's inclusive ``(x0, y0, x1, y1)`` pixel boxes in
1-based coordinates; ``mask[y - y0, x - x0]``.  Unlike the JAX package, a
mask or plane here is exactly the box's size: the pow2 padding there exists
to bound the number of compiled programs, which eager PyTorch does not have.
``bucket_hw`` stays, for the blur window and for the cache's byte counts
(``shapesize``/``spritesize`` report the reference's padded sizes, so both
sides evict at the same moments).

Boxes are part of the result: ``caf``, ``shape_union`` and ``bloat`` return
loose boxes exactly as the reference does, and ``boxshape`` tightens.

Tensors are never modified in place once they belong to a Shape or Sprite,
so crops may be views.  Every function that builds a tensor from host data
takes the device; binary operations on operands of different devices fail in
torch itself.  ``syncs`` counts the places where a raster's content is read
back to the host (emptiness, tight bounds, point membership, span lists).

On a CUDA device ``caf``, ``_tight_bounds`` (``boxshape``, ``boxsprite``),
``bloat`` and ``erode`` launch the hand-written kernels of
``kernels/csrc/region_ops.cu`` (CF1, TB1, MR1) or raise; on the CPU they run
the plain torch versions beside them (``caf_torch``, ``_tight_bounds_torch``,
``dilate_torch``, ``erode_torch``).

Operation parity map:
  shape_union / shape_difference / shape_intersection
                        <- sprite.ml:1172-1662
  caf                   <- sprite.ml:723-1170 (compose two sprites and report
                           the shape of result pixels satisfying a predicate)
  fillshape             <- sprite.ml:158-175
  shape_of_sprite       <- sprite.ml:177-189
  portion               <- sprite.ml:592-721
  translate_*           <- sprite.ml:469-501 (pure box shift)
  boxshape / boxsprite  <- sprite.ml:542-590
  bloat / erode         <- sprite.ml:1741-1877
  flatten_sprite/pickup <- sprite.ml:1664-1739
  point_in_shape        <- sprite.ml:1970-1994
  shapesize/spritesize  <- sprite.ml:402-457
  shapecheck/spritecheck<- sprite.ml:14-16,216-239
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import colour as C
from .. import kernels

Box = Tuple[int, int, int, int]  # x0, y0, x1, y1 inclusive

# Like the reference's Sprite.debug_spritecheck (sprite.ml:16): when set,
# structural invariants are verified on the results of major operations.
debug_spritecheck = False

# Host readbacks of raster content since the caller last zeroed it.
syncs = 0


def _sync():
    global syncs
    syncs += 1


# ---------------------------------------------------------------------------
# Box algebra.  This also subsumes the reference's only use of the GPC C
# clipper: every call site feeds it axis-aligned boxes (render.ml:328-349).
# ---------------------------------------------------------------------------


def box_union(a: Box, b: Box) -> Box:
    return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))


def box_intersect(a: Box, b: Box) -> Optional[Box]:
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    if x0 > x1 or y0 > y1:
        return None
    return (x0, y0, x1, y1)


def box_overlap(a: Box, b: Box) -> bool:
    return box_intersect(a, b) is not None


def box_wh(b: Box) -> Tuple[int, int]:
    return b[2] - b[0] + 1, b[3] - b[1] + 1


_MIN_H, _MIN_W = 8, 128


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def bucket_hw(h: int, w: int) -> Tuple[int, int]:
    """The JAX package's pow2 window buckets.  The blur window keeps them:
    the window size decides which pixels the blend may write, so the
    port's windows must match the reference's exactly.  The cache's byte
    counts keep them too."""
    return _bucket(h, _MIN_H), _bucket(w, _MIN_W)


def _box_count(m_int: torch.Tensor, rx: int, ry: int) -> torch.Tensor:
    """Separable box-window sum of an int32 (H, W) plane over [x-rx, x+rx]
    x [y-ry, y+ry]; cells outside the plane count as zero.  `> 0` of it is
    the box dilation of a mask (the reference's bloat)."""
    H, W = m_int.shape
    dev = m_int.device
    # Row pass: windowed sum over columns, from clipped prefix-sum reads.
    c = torch.cumsum(m_int, dim=1, dtype=torch.int32)
    xx = torch.arange(W, device=dev)
    hi = c[:, (xx + rx).clamp(0, W - 1)]
    lo_idx = xx - rx - 1
    lo = torch.where(lo_idx >= 0, c[:, lo_idx.clamp(0, W - 1)], 0)
    row = hi - lo
    # Column pass: windowed sum over rows.
    c2 = torch.cumsum(row, dim=0, dtype=torch.int32)
    yy = torch.arange(H, device=dev)
    hi2 = c2[(yy + ry).clamp(0, H - 1), :]
    lo_idx2 = yy - ry - 1
    lo2 = torch.where((lo_idx2 >= 0)[:, None], c2[lo_idx2.clamp(0, H - 1), :], 0)
    return hi2 - lo2


# ---------------------------------------------------------------------------
# Shape / Sprite containers
# ---------------------------------------------------------------------------


@dataclass
class Shape:
    box: Box
    mask: torch.Tensor  # bool (h, w), exactly the box's size
    # Memoized emptiness: None = unknown (computing it is a host<->device
    # sync, so it is deferred until control flow actually needs it).
    empty_known: Optional[bool] = None
    # True when the mask is KNOWN to cover the whole box (a filled
    # rectangle).  Window clips, master updates and bloated rectangles are
    # all full boxes, so set algebra against them reduces to box algebra
    # with no mask operation at all.  False merely means "unknown": every
    # fast path keyed on it is conservative.
    full_box: bool = False

    @property
    def wh(self) -> Tuple[int, int]:
        return box_wh(self.box)

    def mask_np(self) -> np.ndarray:
        _sync()
        return self.mask.cpu().numpy()


@dataclass
class Sprite:
    box: Box
    mask: torch.Tensor  # bool (h, w): where the sprite is defined
    rgba: torch.Tensor  # int32 (h, w, 4) premultiplied; 0 outside mask

    @property
    def wh(self) -> Tuple[int, int]:
        return box_wh(self.box)


NULL_SHAPE: Optional[Shape] = None
NULL_SPRITE: Optional[Sprite] = None


def is_null_shape(s) -> bool:
    """True for None or a shape whose mask is empty (memoized; this is the
    only place raster emptiness forces a device sync)."""
    if s is None:
        return True
    if s.empty_known is None:
        _sync()
        s.empty_known = not bool(s.mask.any())
    return s.empty_known


def is_null_sprite(s) -> bool:
    return s is None


def shape_of_mask(box: Box, mask: np.ndarray, device) -> Optional[Shape]:
    """Build a Shape from a host mask over `box` (tightening not applied).

    Rectangle detection is free here (host mask, one `all()`): every
    scanline-rasterized axis-aligned rectangle enters the set algebra
    flagged, so operations against it are box math and never a sync."""
    if mask.size == 0 or not mask.any():
        return NULL_SHAPE
    w, h = box_wh(box)
    if mask.shape != (h, w):
        raise ValueError(f"mask of shape {mask.shape} over box {box}")
    return Shape(
        box,
        torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(device),
        empty_known=False,
        full_box=bool(mask.all()),
    )


def shape_of_box(box: Box, device) -> Shape:
    """Fully-covered rectangular shape."""
    w, h = box_wh(box)
    return Shape(
        box, torch.ones((h, w), dtype=torch.bool, device=device), empty_known=False, full_box=True
    )


def shapecheck(s) -> bool:
    """Structural invariants (ref sprite.ml:216-239): the mask is exactly
    the box's size and the box is sane."""
    if s is None:
        return True
    w, h = s.wh
    return w > 0 and h > 0 and tuple(s.mask.shape) == (h, w) and s.mask.dtype == torch.bool


def spritecheck(s) -> bool:
    if s is None:
        return True
    if not shapecheck(s):
        return False
    if tuple(s.rgba.shape) != tuple(s.mask.shape) + (4,):
        return False
    _sync()
    # Colour must be clear outside the defined mask.
    return not bool(s.rgba[~s.mask].any())


# ---------------------------------------------------------------------------
# Realignment: a plane over one box expressed over another
# ---------------------------------------------------------------------------


def _window(t: torch.Tensor, src: Box, dst: Box) -> torch.Tensor:
    """The (h, w, ...) plane `t` over box `src`, expressed over box `dst`:
    zero (False) outside `src`.  A view of `t` where `dst` lies inside."""
    if src == dst:
        return t
    w, h = box_wh(dst)
    ib = box_intersect(src, dst)
    if ib is None:
        return t.new_zeros((h, w) + tuple(t.shape[2:]))
    sub = t[ib[1] - src[1] : ib[3] - src[1] + 1, ib[0] - src[0] : ib[2] - src[0] + 1]
    if ib == dst:
        return sub
    out = t.new_zeros((h, w) + tuple(t.shape[2:]))
    out[ib[1] - dst[1] : ib[3] - dst[1] + 1, ib[0] - dst[0] : ib[2] - dst[0] + 1] = sub
    return out


def shape_any(s) -> bool:
    return not is_null_shape(s)


def _box_inside(inner: Box, outer: Box) -> bool:
    return (
        inner[0] >= outer[0]
        and inner[1] >= outer[1]
        and inner[2] <= outer[2]
        and inner[3] <= outer[3]
    )


def shape_union(a, b):
    """a ||| b (ref sprite.ml:1172-1293)."""
    if a is None:
        return b
    if b is None:
        return a
    # Full-box absorption: anything inside a filled rectangle adds nothing.
    if a.full_box and _box_inside(b.box, a.box):
        return a
    if b.full_box and _box_inside(a.box, b.box):
        return b
    box = box_union(a.box, b.box)
    return Shape(box, _window(a.mask, a.box, box) | _window(b.mask, b.box, box))


def shape_difference(a, b):
    """a --- b (ref sprite.ml:1295-1512)."""
    if a is None:
        return NULL_SHAPE
    if b is None:
        return a
    if not box_overlap(a.box, b.box):
        return a
    # Subtracting a filled rectangle that covers all of `a` empties it.
    if b.full_box and _box_inside(a.box, b.box):
        return NULL_SHAPE
    # Emptiness is deferred: consumers that need it go through is_null_shape.
    return Shape(a.box, a.mask & ~_window(b.mask, b.box, a.box))


def _crop_shape(s, ibox: Box):
    """s's mask restricted to ibox ⊆ s.box (no second operand)."""
    if ibox == s.box:
        return s
    return Shape(
        ibox, _window(s.mask, s.box, ibox), empty_known=False if s.full_box else None,
        full_box=s.full_box,
    )


def shape_intersection(a, b):
    """a &&& b (ref sprite.ml:1514-1662)."""
    if a is None or b is None:
        return NULL_SHAPE
    ibox = box_intersect(a.box, b.box)
    if ibox is None:
        return NULL_SHAPE
    # Intersecting with a filled rectangle is a crop: the everyday case
    # (window clips, master updates) costs box math and a view.
    if b.full_box:
        return _crop_shape(a, ibox)
    if a.full_box:
        return _crop_shape(b, ibox)
    return Shape(ibox, _window(a.mask, a.box, ibox) & _window(b.mask, b.box, ibox))


def shape_intersects(a, b) -> bool:
    if a is None or b is None:
        return False
    if not box_overlap(a.box, b.box):
        return False
    return not is_null_shape(shape_intersection(a, b))


def translate_shape(dx: int, dy: int, s):
    """Translate: a pure box shift (ref sprite.ml:469-501)."""
    if s is None:
        return NULL_SHAPE
    x0, y0, x1, y1 = s.box
    return Shape((x0 + dx, y0 + dy, x1 + dx, y1 + dy), s.mask, s.empty_known, s.full_box)


def translate_sprite(dx: int, dy: int, s: Optional[Sprite]) -> Optional[Sprite]:
    """A pure box shift (ref sprite.ml:469-501)."""
    if s is None:
        return NULL_SPRITE
    x0, y0, x1, y1 = s.box
    return Sprite((x0 + dx, y0 + dy, x1 + dx, y1 + dy), s.mask, s.rgba)


def _tight_bounds(mask: torch.Tensor):
    """(x0, y0, x1, y1) of the True cells, relative to the mask; x1 < x0
    when there is none.  One readback; on the card one launch of TB1,
    which writes the result straight into a pinned host word
    (kernels.bounds_word), read after a stream synchronize: no copy is
    issued."""
    if mask.is_cuda:
        word = kernels.bounds_word(mask.device)
        kernels.tight_bounds(mask, word)
        torch.cuda.current_stream(mask.device).synchronize()
        _sync()
        return tuple(word.host.tolist())
    return _tight_bounds_torch(mask)


def _tight_bounds_torch(mask: torch.Tensor):
    """The plain version of _tight_bounds, on any device."""
    rows = mask.any(dim=1)
    cols = mask.any(dim=0)
    ny = torch.arange(mask.shape[0], device=mask.device)
    nx = torch.arange(mask.shape[1], device=mask.device)
    y0 = torch.where(rows, ny, mask.shape[0]).min()
    y1 = torch.where(rows, ny, -1).max()
    x0 = torch.where(cols, nx, mask.shape[1]).min()
    x1 = torch.where(cols, nx, -1).max()
    _sync()
    return tuple(torch.stack([x0, y0, x1, y1]).tolist())


def boxshape(s):
    """Recompute a tight bounding box (ref sprite.ml:542-590)."""
    if s is None:
        return NULL_SHAPE
    if s.full_box:  # already tight by definition
        s.empty_known = False
        return s
    bx0, by0, bx1, by1 = _tight_bounds(s.mask)
    if bx1 < bx0:
        return NULL_SHAPE
    x0, y0, _, _ = s.box
    newbox = (x0 + bx0, y0 + by0, x0 + bx1, y0 + by1)
    if newbox == s.box:
        s.empty_known = False
        return s
    return Shape(newbox, _window(s.mask, s.box, newbox), empty_known=False)


def boxsprite(s):
    if s is None:
        return NULL_SPRITE
    bx0, by0, bx1, by1 = _tight_bounds(s.mask)
    if bx1 < bx0:
        return NULL_SPRITE
    x0, y0, _, _ = s.box
    newbox = (x0 + bx0, y0 + by0, x0 + bx1, y0 + by1)
    if newbox == s.box:
        return s
    return Sprite(newbox, _window(s.mask, s.box, newbox), _window(s.rgba, s.box, newbox))


# ---------------------------------------------------------------------------
# Sprites
# ---------------------------------------------------------------------------


def shape_of_sprite(s):
    """Defined region of a sprite (ref sprite.ml:177-189)."""
    if s is None:
        return NULL_SHAPE
    return Shape(s.box, s.mask)


def sprite_of_mask_rgba(box: Box, mask: torch.Tensor, rgba: torch.Tensor) -> Sprite:
    """`rgba` may be anything that broadcasts to (h, w, 4)."""
    return Sprite(box, mask, torch.where(mask[..., None], rgba, 0))


def fillshape(shape, fill) -> Optional[Sprite]:
    """Fill every pixel of a shape with a fill (ref sprite.ml:158-175), on
    the shape's device.

    `fill` is a Fill from raster.fills: its ``image_device(box, h, w,
    device)`` returns the int32 colour plane for the box's pixel grid.
    """
    if shape is None:
        return NULL_SPRITE
    h, w = shape.mask.shape
    rgba = fill.image_device(shape.box, h, w, shape.mask.device)
    return sprite_of_mask_rgba(shape.box, shape.mask, rgba)


def portion(s, shp):
    """Restrict a sprite to a shape (ref sprite.ml:592-721)."""
    if s is None or shp is None:
        return NULL_SPRITE
    ibox = box_intersect(s.box, shp.box)
    if ibox is None:
        return NULL_SPRITE
    mask = _window(s.mask, s.box, ibox) & _window(shp.mask, shp.box, ibox)
    return sprite_of_mask_rgba(ibox, mask, _window(s.rgba, s.box, ibox))


def sprite_map(f: Callable, s):
    """Map a colour-tensor function over a sprite (ref sprite.ml:245-374)."""
    if s is None:
        return NULL_SPRITE
    return sprite_of_mask_rgba(s.box, s.mask, f(s.rgba).to(torch.int32))


def map_coords(f: Callable, s):
    """Map f(ygrid, xgrid, rgba) over a sprite (ref sprite.ml map_coords,
    used by the CPG fill application render.ml:976-981)."""
    if s is None:
        return NULL_SPRITE
    h, w = s.mask.shape
    x0, y0, _, _ = s.box
    dev = s.mask.device
    ys = (y0 + torch.arange(h, dtype=torch.int32, device=dev))[:, None].expand(h, w)
    xs = (x0 + torch.arange(w, dtype=torch.int32, device=dev))[None, :].expand(h, w)
    return sprite_of_mask_rgba(s.box, s.mask, f(ys, xs, s.rgba).to(torch.int32))


# ---------------------------------------------------------------------------
# caf: compose and filter (ref sprite.ml:723-1170)
# ---------------------------------------------------------------------------

# Named compositing operators.  Each maps (a_rgba, b_rgba) -> rgba on int32
# (..., 4) tensors; `a` is the upper operand as in Colour.over a b.
_CAF_OPS = {}


def register_caf_op(name: str, fn: Callable):
    _CAF_OPS[name] = fn


register_caf_op("over", C.over_rgba)
register_caf_op("alpha_over", C.alpha_over_rgba)
register_caf_op("plus", C.pd_plus_rgba)
# 'nocover' asserts disjointness (checked on host when debug_spritecheck);
# the overlap region is empty so any value works: use b.
register_caf_op("nocover", lambda a, b: b)
# The entries registered at import: CF1 computes these itself while the
# table still holds them (a caller may re-register a name).
_BUILTIN_CAF_OPS = dict(_CAF_OPS)


def _pred_opaque(rgba):
    return rgba[..., 3] == 255


_CAF_PREDS = {"opaque": _pred_opaque}


def _caf_planes(ma, ra, mb, rb, op: str, pred: str):
    both = ma & mb
    any_ = ma | mb
    composed = _CAF_OPS[op](ra, rb)
    rgba = torch.where(
        both[..., None], composed, torch.where(ma[..., None], ra, torch.where(mb[..., None], rb, 0))
    )
    return rgba, any_, any_ & _CAF_PREDS[pred](rgba)


def caf(op: str, pred: str, a, b):
    """Composite sprite `a` onto sprite `b` with operator `op`, returning
    (result sprite, shape of result pixels satisfying `pred`).

    Mirrors ``Sprite.caf`` (sprite.ml:723-1170): the predicate (e.g. "now
    opaque") is evaluated over every defined pixel of the result, which is
    what drives the renderer's early termination (render.ml:1291-1308).
    The result's box is the union of the operands' boxes, untightened.
    On a CUDA device every call with an operand is one launch of CF1
    (_caf_card).
    """
    if a is None and b is None:
        return NULL_SPRITE, NULL_SHAPE
    if (b if a is None else a).mask.is_cuda:
        return _caf_card(op, pred, a, b)
    return caf_torch(op, pred, a, b)


def _caf_op_code(op: str) -> Optional[int]:
    """CF1's built-in code for `op` (kernels.CAF_OPS), or None where the
    table's entry is not the function registered under that name at import:
    the composed plane is then given (_caf_composed).  KeyError for an
    operator that is not registered, as the plain version."""
    fn = _CAF_OPS[op]
    return kernels.CAF_OPS[op] if op in kernels.CAF_OPS and fn is _BUILTIN_CAF_OPS[op] else None


def _caf_plane(s: Sprite, box: Box) -> kernels.CafPlane:
    """Sprite `s` as an operand of CF1 over `box`, which holds its box: its
    offset there, its own mask and RGBA in place."""
    return kernels.CafPlane(s.box[1] - box[1], s.box[0] - box[0], s.mask, s.rgba)


def _caf_composed(op: str, a: Sprite, b: Sprite) -> Optional[kernels.CafPlane]:
    """`op`'s colours over the intersection of a's and b's boxes, from the
    registered function on views of their RGBA, as a plane of CF1 over
    their union box; None where the boxes do not meet.  Exact where every
    operator is per pixel: the composed colour is read only where both
    masks are set, all inside the intersection."""
    ib = box_intersect(a.box, b.box)
    if ib is None:
        return None
    box = box_union(a.box, b.box)
    w, h = box_wh(ib)
    crop = lambda s: s.rgba[ib[1] - s.box[1] : ib[3] - s.box[1] + 1, ib[0] - s.box[0] : ib[2] - s.box[0] + 1]
    return kernels.CafPlane(ib[1] - box[1], ib[0] - box[0], None, _CAF_OPS[op](crop(a), crop(b)).expand(h, w, 4))


def _caf_card(op: str, pred: str, a, b):
    """caf on a CUDA device: one launch of CF1 (kernels.caf); one operand
    gives its own sprite and the f plane alone."""
    if _CAF_PREDS[pred] is not _pred_opaque:
        raise ValueError(f"caf on the card: the predicate {pred!r} is not the built-in 'opaque'")
    if a is None or b is None:
        s = b if a is None else a
        w, h = s.wh
        f = kernels.caf(h, w, kernels.CAF_OPS["nocover"], _caf_plane(s, s.box), f_only=True)
        return Sprite(s.box, s.mask, s.rgba), Shape(s.box, f)
    box = box_union(a.box, b.box)
    if debug_spritecheck and op == "nocover":
        _sync()
        ib = box_intersect(a.box, b.box)
        if ib is not None and bool((_window(a.mask, a.box, ib) & _window(b.mask, b.box, ib)).any()):
            raise C.Nocover("caf nocover: operands overlap")
    code = _caf_op_code(op)
    w, h = box_wh(box)
    rgba, mask, f = kernels.caf(h, w, kernels.CAF_GIVEN if code is None else code, _caf_plane(a, box),
                                _caf_plane(b, box), _caf_composed(op, a, b) if code is None else None)
    return Sprite(box, mask, rgba), Shape(box, f)


def caf_torch(op: str, pred: str, a, b):
    """The plain version of caf, on any device."""
    if a is None and b is None:
        return NULL_SPRITE, NULL_SHAPE
    if a is None or b is None:
        # One operand: the result is that sprite over its own box (its
        # colour is already clear outside its mask).
        s = b if a is None else a
        return Sprite(s.box, s.mask, s.rgba), Shape(s.box, s.mask & _CAF_PREDS[pred](s.rgba))
    box = box_union(a.box, b.box)
    ma, ra = _window(a.mask, a.box, box), _window(a.rgba, a.box, box)
    mb, rb = _window(b.mask, b.box, box), _window(b.rgba, b.box, box)
    if debug_spritecheck and op == "nocover":
        _sync()
        if bool((ma & mb).any()):
            raise C.Nocover("caf nocover: operands overlap")
    rgba, mask, f = _caf_planes(ma, ra, mb, rb, op, pred)
    return Sprite(box, mask, rgba), Shape(box, f)


# ---------------------------------------------------------------------------
# bloat / erode (ref sprite.ml:1741-1877)
# ---------------------------------------------------------------------------


def bloat(rx: int, ry: int, s):
    """Morphological dilation by a (2rx+1, 2ry+1) box kernel
    (ref sprite.ml:1741-1864).  The result box grows by (rx, ry)."""
    if s is None:
        return NULL_SHAPE
    if rx == 0 and ry == 0:
        return s
    x0, y0, x1, y1 = s.box
    nbox = (x0 - rx, y0 - ry, x1 + rx, y1 + ry)
    if s.full_box:
        # Dilation of a filled rectangle by a box kernel is the expanded
        # filled rectangle, exactly.
        return shape_of_box(nbox, s.mask.device)
    if s.mask.is_cuda:
        return Shape(nbox, kernels.box_morph(s.mask, rx, ry, erode=False))
    return Shape(nbox, dilate_torch(s.mask, rx, ry))


def dilate_torch(mask: torch.Tensor, rx: int, ry: int) -> torch.Tensor:
    """The plain version of bloat's mask, on any device: the (h + 2ry, w +
    2rx) dilation of `mask` placed at (ry, rx)."""
    h, w = mask.shape
    m = _window(mask, (0, 0, w - 1, h - 1), (-rx, -ry, w - 1 + rx, h - 1 + ry))
    return _box_count(m.to(torch.int32), rx, ry) > 0


def erode(rx: int, ry: int, s):
    """Morphological erosion (ref sprite.ml:1866-1877, via complement).
    Outside the box counts as uncovered: a window that contains an
    uncovered cell, or sticks past the box (the `interior` term), erodes
    away."""
    if s is None:
        return NULL_SHAPE
    if rx == 0 and ry == 0:
        return s
    if s.mask.is_cuda:
        return Shape(s.box, kernels.box_morph(s.mask, rx, ry, erode=True))
    return Shape(s.box, erode_torch(s.mask, rx, ry))


def erode_torch(mask: torch.Tensor, rx: int, ry: int) -> torch.Tensor:
    """The plain version of erode's mask, on any device."""
    h, w = mask.shape
    dev = mask.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    interior = (yy >= ry) & (yy < h - ry) & (xx >= rx) & (xx < w - rx)
    uncovered = (~mask).to(torch.int32)
    return (_box_count(uncovered, rx, ry) == 0) & interior


# ---------------------------------------------------------------------------
# Canvas interop (ref sprite.ml:1664-1739, canvas.ml)
# ---------------------------------------------------------------------------


@dataclass
class Canvas:
    """Dense premultiplied-RGBA canvas (ref canvas.ml).

    ``rgba`` is (H, W, 4) int32.  ``origin`` gives the scene coordinates of
    pixel (0, 0) (the reference's canvases are 1-based with external origin
    bookkeeping; it is carried explicitly here)."""

    rgba: torch.Tensor
    origin: Tuple[int, int] = (1, 1)  # (x, y) scene coords of rgba[0, 0]

    @property
    def width(self) -> int:
        return self.rgba.shape[1]

    @property
    def height(self) -> int:
        return self.rgba.shape[0]


def newcanvasclear(w: int, h: int, device) -> Canvas:
    return Canvas(torch.zeros((h, w, 4), dtype=torch.int32, device=device))


def newcanvas(w: int, h: int, colour: int, device) -> Canvas:
    """Canvas filled with a colour (ref canvas.ml newcanvas)."""
    vec = C.rgba_array_of_colour(colour, device)
    return Canvas(vec.expand(h, w, 4).contiguous())


def copycanvas(c: Canvas) -> Canvas:
    """Independent copy (ref canvas.ml:41-47)."""
    return Canvas(c.rgba.clone(), c.origin)


def subcopy(src: Canvas, dst: Canvas, x: int, y: int, w: int, h: int) -> Canvas:
    """Copy a w*h window of `src` starting at its 1-based (x, y) into a new
    canvas shaped like `dst` (ref canvas.ml:49-58 subcopy).  Raises if the
    window exceeds the source, like the reference."""
    if x < 1 or y < 1 or x - 1 + w > src.width or y - 1 + h > src.height:
        raise ValueError("subcopy: window outside source canvas")
    out = dst.rgba.clone()
    out[:h, :w] = src.rgba[y - 1 : y - 1 + h, x - 1 : x - 1 + w]
    return Canvas(out, dst.origin)


def flatten_sprite(border: int, s, bg_colour: int) -> Canvas:
    """Sprite -> canvas with a border of bg pixels (ref sprite.ml:1664-1704).

    The canvas origin is (x0 - border, y0 - border) in scene coordinates.
    """
    if s is None:
        raise ValueError("flatten_sprite: null sprite")
    x0, y0, _, _ = s.box
    w, h = box_wh(s.box)
    bgvec = C.rgba_array_of_colour(bg_colour, s.mask.device)
    out = bgvec.expand(h + 2 * border, w + 2 * border, 4).contiguous()
    out[border : border + h, border : border + w] = torch.where(s.mask[..., None], s.rgba, bgvec)
    return Canvas(out, origin=(x0 - border, y0 - border))


def pickup(shape, canvas: Canvas):
    """Pick up pixels of `shape` from a canvas (ref sprite.ml:1706-1739).

    The canvas carries its scene-space ``origin``, so scene pixel (x, y) is
    read at ``canvas.rgba[y - oy, x - ox]``.  The shape must lie within the
    canvas extent.
    """
    if shape is None:
        return NULL_SPRITE
    x0, y0, _, _ = shape.box
    ox, oy = canvas.origin
    col0, row0 = x0 - ox, y0 - oy
    w, h = box_wh(shape.box)
    if not (0 <= col0 and 0 <= row0 and col0 + w <= canvas.width and row0 + h <= canvas.height):
        raise ValueError(
            f"pickup: shape {shape.box} outside canvas at {canvas.origin} "
            f"of size {(canvas.width, canvas.height)}"
        )
    rgba = canvas.rgba[row0 : row0 + h, col0 : col0 + w]
    return sprite_of_mask_rgba(shape.box, shape.mask, rgba)


def point_in_shape(s, pt: Tuple[int, int]) -> bool:
    """Point membership (ref sprite.ml:1970-1994)."""
    if s is None:
        return False
    x, y = pt
    x0, y0, x1, y1 = s.box
    if not (x0 <= x <= x1 and y0 <= y <= y1):
        return False
    if s.full_box:
        return True
    _sync()
    return bool(s.mask[y - y0, x - x0])


# ---------------------------------------------------------------------------
# Span extraction (ref sprite.ml:1879-1968: the spanlist views Convolve
# consumed; here for diagnostics and host-side tools)
# ---------------------------------------------------------------------------


def _runs(m: np.ndarray):
    """(major, minor_start, length) of the runs of True along each row of
    a host mask, in row order."""
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return []
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    new_run = np.ones(len(ys), dtype=bool)
    new_run[1:] = (ys[1:] != ys[:-1]) | (xs[1:] != xs[:-1] + 1)
    first = np.flatnonzero(new_run)
    last = np.append(first[1:] - 1, len(xs) - 1)
    return [(int(ys[f]), int(xs[f]), int(l - f) + 1) for f, l in zip(first, last)]


def spanlist_of_shape(s) -> list:
    """Horizontal spans [(x, y, length), ...] of a shape
    (ref sprite.ml spanlist_of_shape)."""
    if s is None:
        return []
    x0, y0, _, _ = s.box
    return [(x + x0, y + y0, n) for y, x, n in _runs(s.mask_np())]


def depthspanlist_of_shape(s) -> list:
    """Vertical spans [(x, y, depth), ...] (ref depthspanlist_of_shape)."""
    if s is None:
        return []
    x0, y0, _, _ = s.box
    return [(x + x0, y + y0, n) for x, y, n in _runs(s.mask_np().T)]


def shapespan_iter(minx, maxx, miny, maxy, f, s) -> None:
    """Iterate spans clipped to a window, calling f(x, y, length)
    (ref sprite.ml:147-154)."""
    for (x, y, l) in spanlist_of_shape(s):
        if y < miny or y > maxy:
            continue
        e = x + l - 1
        cs, ce = max(x, minx), min(e, maxx)
        if cs <= ce:
            f(cs, y, ce - cs + 1)


# ---------------------------------------------------------------------------
# Size estimators for cache accounting (ref sprite.ml:402-457).  They count
# the JAX package's padded planes, although the tensors here are not padded:
# the counts decide what the cache evicts and when.
# ---------------------------------------------------------------------------


def _bucket_area(s) -> int:
    h, w = s.mask.shape
    hb, wb = bucket_hw(h, w)
    return hb * wb


def shapesize(s) -> int:
    if s is None:
        return 0
    return _bucket_area(s)  # 1 byte per bool


def spritesize(s) -> int:
    if s is None:
        return 0
    return _bucket_area(s) * 17  # mask + 4 int32 channels
