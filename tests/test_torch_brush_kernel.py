"""The brush kernels' host side and their plain versions, on the CPU.

``brush_stamp`` (plane and piece modes) and ``smear_walk`` run only on the
card (tests/test_torch_cuda.py holds them to their plain versions there).
Here, at the same cases (``brush_case``, ``smear_case`` from that file):

  * the host lists the kernels read (``kernels.brush_plane_lists`` and
    ``brush_piece_lists``' stroke table and per-bin lists, ``smear_steps``,
    the group lists of ``brush_tiles._group_lists``) against brute force in
    numpy, the per-bin lists also by hypothesis;
  * a numpy model of what one block walks (its strip's stamp list, in
    stamp order, folded warp by warp, a warp skipping an entry that misses
    its 8 x 32 pixels; in piece mode its point list's mask, a block with no
    stamp or no point writing zeros) against a per-pixel brute force,
    against ``region._box_count(...) > 0`` and against the plain versions;
  * smear_walk's packed blend (window mode: two channels a 32-bit word)
    against its exact blend at every (d, s, al);
  * the plain versions (``_stamp_alpha_torch``, ``_group_block_torch``
    through ``BrushTileBuild.flush``, ``_smear_walk_torch``) against the
    JAX package's ``_stamp_scan_alpha``, ``_brush_group_kernel`` and
    ``_smear_scan``.

Tolerance 0 everywhere: the colour math is integer.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp
from coherence_tpu.raster import brush as JB
from coherence_tpu.raster import brush_tiles as JBT

from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import brush as TB
from coherence_tpu_torch.raster import brush_tiles as TBT
from coherence_tpu_torch.raster import region as TRG

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import (BRUSH_FAR, BRUSH_RADII, SMEAR_DIRS, SMEAR_WALKS, brush_case, plane_inputs, smear_case,
                             smear_walk_case)

TH, TW = kernels.BRUSH_TILE
BH, BW = kernels.BRUSH_BLOCK  # the strip a block owns
NH, NW = kernels.BRUSH_BIN  # the bin whose lists it reads
ROWS = 8  # brush_stamp.cu's kRows: rows of one column a thread owns; a warp owns ROWS x WARP_COLS pixels
WARP_COLS = 32


def _cases():
    return [pytest.param(r, id=f"r{r:g}") for r in BRUSH_RADII]


def _patches(strokes, words):
    """The cropped patch of each stroke, read back from the packed bytes."""
    raw = words.view(np.uint8)
    return [raw[at : at + kh * kw].reshape(kh, kw).astype(np.int64) for _, _, kh, kw, _, _, at in strokes[:, :7]]


def _fold(alpha, texels):
    """One stamp over the pixels it covers: the kernel's (and colour.py's
    prelerp_arr) arithmetic."""
    t = texels
    lerp = alpha + t - ((((t * alpha + 128) >> 8) + (t * alpha + 128)) >> 8)
    return np.where(t == 0, alpha, np.where(t == 255, 255, lerp))


def _unpack(entries):
    """List entries (row & 0xFFFF | col << 16, int32) as (row, col) pairs."""
    e = np.asarray(entries, np.int64)
    return np.stack([((e & 0xFFFF) ^ 0x8000) - 0x8000, e >> 16], axis=1).reshape(-1, 2)


def block_origin(lists, b):
    """(stroke, row, col) of block b's strip, and the row of its strip in
    its bin."""
    if lists.piece:
        si, oy, ox = (int(v) for v in lists.meta[b // (TH // BH)])
        return si, oy + b % (TH // BH) * BH, ox, b % (TH // BH) * BH
    across, down = -(-lists.wp // BW), -(-lists.hp // BH)
    at = b % (across * down)
    return b // (across * down), at // across * BH, at % across * BW, at // across * BH % NH


def bin_entries(lists, b):
    """Block b's stamp and point entries, unpacked, relative to its bin."""
    r = lists.ranges[b]
    return _unpack(lists.stamps[r[0] : r[1]]), _unpack(lists.points[r[2] : r[3]])


def block_entries(lists, b):
    """Block b's stamp and point entries, unpacked, relative to its
    strip (the lists hold them relative to its bin)."""
    sub = np.array([block_origin(lists, b)[3], 0])
    return tuple(e - sub for e in bin_entries(lists, b))


def _warps():
    return [(r0, wx) for r0 in range(0, BH, ROWS) for wx in range(0, BW, WARP_COLS)]


def block_alpha(lists, b):
    """The block's BH x BW alpha as its warps fold its stamp list: a warp
    skips an entry whose patch extent misses its ROWS x WARP_COLS pixels and
    folds the others into the pixels under them, in list order."""
    si = block_origin(lists, b)[0]
    kh, kw = (int(v) for v in lists.strokes[si, 2:4])
    patch = _patches(lists.strokes, lists.patches)[si]
    alpha = np.zeros((BH, BW), np.int64)
    for r0, wx in _warps():
        for ry, rx in block_entries(lists, b)[0]:
            if ry >= r0 + ROWS or ry + kh <= r0 or rx >= wx + WARP_COLS or rx + kw <= wx:
                continue
            ys = slice(max(ry, r0), min(ry + kh, r0 + ROWS))
            xs = slice(max(rx, wx), min(rx + kw, wx + WARP_COLS))
            alpha[ys, xs] = _fold(alpha[ys, xs], patch[ys.start - ry : ys.stop - ry, xs.start - rx : xs.stop - rx])
    return alpha


def block_mask(lists, b):
    """The strip's mask as the block makes it: each warp sets, for each of
    its point entries whose (2 hr + 1) x (2 wr + 1) window reaches its
    pixels, the rows of its ROWS that the window covers in the columns
    within wr of the point."""
    si = block_origin(lists, b)[0]
    wr, hr = (int(v) for v in lists.strokes[si, 4:6])
    mask = np.zeros((BH, BW), bool)
    cols = np.arange(BW)
    for r0, wx in _warps():
        for py, px in block_entries(lists, b)[1]:
            if py - hr >= r0 + ROWS or py + hr < r0 or px - wr >= wx + WARP_COLS or px + wr < wx:
                continue
            near = (np.abs(cols - px) <= wr) & (cols >= wx) & (cols < wx + WARP_COLS)
            mask[max(py - hr, r0) : min(py + hr, r0 + ROWS - 1) + 1, near] = True
    return mask


def brute_lists(brushes, offsets, valid, points, radii, si, ty0, tx0, hp, wp, rows=NH, cols=NW):
    """Per record, in order: the valid stamps whose patch extent touches the
    rows x cols bin at (ty0, tx0), as (extent corner - bin origin), and the
    stamp points in the plane whose (2 hr + 1) x (2 wr + 1) window touches
    it, as (point - bin origin); a brute force of kernels.brush_*_lists."""
    stamps, pts = [], []
    patch = brushes[si] != 0
    if patch.any():
        (ky0, kx0), (ky1, kx1) = np.argwhere(patch).min(axis=0), np.argwhere(patch).max(axis=0)
        for i in range(offsets.shape[1]):
            sy, sx = int(offsets[si, i, 0]) + ky0, int(offsets[si, i, 1]) + kx0
            if valid[si, i] and sy < ty0 + rows and sy + ky1 - ky0 >= ty0 and sx < tx0 + cols and sx + kx1 - kx0 >= tx0:
                stamps.append((sy - ty0, sx - tx0))
    if points is not None:
        wr, hr = (int(v) for v in radii[si])
        for py, px in points[si].astype(np.int64):
            inside = 0 <= py < hp and 0 <= px < wp
            if inside and py - hr < ty0 + rows and py + hr >= ty0 and px - wr < tx0 + cols and px + wr >= tx0:
                pts.append((py - ty0, px - tx0))
    return stamps, pts


def brute_alpha(brushes, offsets, valid, si, ty0, tx0):
    """Per pixel of the strip: every valid stamp of the stroke that covers
    it, in stamp order, folded from 0 (the padded patch, no extent, no
    lists)."""
    bhb, bwb = brushes.shape[1:]
    yy, xx = np.mgrid[ty0 : ty0 + BH, tx0 : tx0 + BW]
    alpha = np.zeros((BH, BW), np.int64)
    for i in range(offsets.shape[1]):
        if not valid[si, i]:
            continue
        ky, kx = yy - offsets[si, i, 0], xx - offsets[si, i, 1]
        inside = (ky >= 0) & (ky < bhb) & (kx >= 0) & (kx < bwb)
        alpha = _fold(alpha, np.where(inside, brushes[si][np.clip(ky, 0, bhb - 1), np.clip(kx, 0, bwb - 1)], 0))
    return alpha


def piece_model(lists, j, f):
    """One TH x TW piece as its TH // BH blocks make it: a block with no
    stamp or no point entry writes zeros; else its list's alpha and its
    point mask, the fill dissolved by the alpha inside the mask, packed."""
    parts = []
    for b in range(j * (TH // BH), (j + 1) * (TH // BH)):
        stamps, pts = block_entries(lists, b)
        live = len(stamps) and len(pts)
        parts.append((block_alpha(lists, b), block_mask(lists, b) if live else np.zeros((BH, BW), bool)))
    alpha = np.concatenate([a for a, _ in parts])
    mask = np.concatenate([m for _, m in parts])
    f = f.astype(np.int64)
    dis = np.where(alpha[..., None] == 0, 0, np.where(alpha[..., None] == 255, f,
                   (f * alpha[..., None] + ((f * alpha[..., None]) >> 8) + 1) >> 8))
    packed = dis[..., 0] | (dis[..., 1] << 8) | (dis[..., 2] << 16) | (dis[..., 3] << 24)
    return np.where(mask, packed, 0).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("radius", _cases())
def test_stamp_and_point_records_pack_as_brute_force(radius):
    """The lists' stroke table (each patch's nonzero extent, radii, fill and
    cropped bytes, each distinct patch once on 16 bytes), and the records
    behind the entries: over pieces that tile each stroke's plane, the
    stamp entries give back exactly the valid stamps' corners and the point
    entries exactly the stamp points inside the plane (an invalid stamp
    and a dropped point, _FAR, are in no list)."""
    hp, wp, bhb, bwb, npb, items = brush_case(radius)
    brushes, offsets, valid, points, fills, radii, meta = TBT._group_lists(npb, items)
    lists = kernels.brush_piece_lists(brushes, offsets, valid, points, fills, radii, meta, hp, wp)
    strokes, words = lists.strokes, lists.patches
    assert lists.ranges.dtype == lists.stamps.dtype == lists.points.dtype == strokes.dtype == words.dtype == np.int32
    assert strokes.shape == (len(items), kernels.STROKE_WORDS) and lists.ranges.shape == (len(meta) * (TH // BH), 4)
    for si in range(len(items)):
        nz = np.argwhere(brushes[si] != 0)
        (ky0, kx0), (ky1, kx1) = nz.min(axis=0), nz.max(axis=0)
        assert tuple(strokes[si, :6]) == (ky0, kx0, ky1 - ky0 + 1, kx1 - kx0 + 1, *items[si][6])
        assert tuple(strokes[si, 8:]) == tuple(items[si][5])
        assert np.array_equal(_patches(strokes, words)[si], brushes[si, ky0 : ky1 + 1, kx0 : kx1 + 1])
        assert strokes[si, 6] % 16 == 0  # each patch on 16 bytes: the kernel stages it 16 bytes a copy
    # One copy of each distinct patch (stroke 3 has its own opacity; none repeats here), padded to 16 bytes.
    assert len(set(strokes[:, 6])) == len({b.tobytes() for b in brushes})
    sizes = {int(at): int(kh * kw) for _, _, kh, kw, _, _, at in strokes[:, :7]}
    assert words.size * 4 == sum(-(-v // 16) * 16 for v in sizes.values())
    # The plane lists carry the same table and patches.
    planes = kernels.brush_plane_lists(brushes, offsets, valid, hp, wp)
    assert np.array_equal(planes.strokes[:, :4], strokes[:, :4]) and np.array_equal(planes.patches, words)
    windows = [(si, min(oy, hp - TH), min(ox, wp - TW)) for si in range(len(items)) for oy in range(0, hp, TH)
               for ox in range(0, wp, TW)]
    whole = kernels.brush_piece_lists(brushes, offsets, valid, points, fills, radii, np.array(windows), hp, wp)
    for si in range(len(items)):
        corners, kept = set(), set()
        for j, (sj, oy, ox) in enumerate(windows):
            if sj == si:
                stamps, pts = bin_entries(whole, j * (TH // BH))
                corners |= {(y + oy - strokes[si, 0], x + ox - strokes[si, 1]) for y, x in stamps}
                kept |= {(y + oy, x + ox) for y, x in pts}
        assert corners == {tuple(offsets[si, i]) for i in range(npb) if valid[si, i]}, si
        assert kept == {(py, px) for py, px in points[si].tolist() if 0 <= py < hp and 0 <= px < wp}, si


def test_pack_records_shares_a_patch_and_refuses_what_leaves_the_plane():
    brushes = np.zeros((3, 8, 128), np.int32)
    brushes[:, 2:5, 3:6] = TB.drawround_alpha(1.0, 0.5)
    brushes[2] = 0  # an empty patch: no extent
    offsets = np.array([[(0, 0), (40, 500)], [(3, 4), (1 << 20, -5)], [(7, 7), (0, 0)]], np.int32)
    valid = np.array([[True, True], [True, False], [False, True]])
    lists = kernels.brush_plane_lists(brushes, offsets, valid, 48, 640)
    strokes, words = lists.strokes, lists.patches
    assert strokes[0, 6] == strokes[1, 6] == 0 and words.size == 4  # 9 bytes, one copy, on 16
    assert tuple(strokes[2, :4]) == (0, 0, 0, 0)
    # Three valid stamps of a nonzero patch, each in one bin; the invalid ones and the empty patch in none.
    assert len(lists.stamps) == 3 and not len(lists.points)
    assert kernels.brush_patch_bytes(3, 3) == 2 * 32 + 16  # 8 zero rows of 3 bytes above and below, on 16
    assert lists.patch_smem == 2 * 32 + 16 and lists.shape == (3, 48, 640)
    assert len(lists.ranges) == 3 * -(-48 // BH) * 5
    for bad in ((40 + 1, 0), (-1, 3), (0, 640 - 128 + 1), (0, -2)):
        moved = offsets.copy()
        moved[0, 1] = bad
        with pytest.raises(ValueError, match="stroke 0's stamp 1"):
            kernels.brush_plane_lists(brushes, moved, valid, 48, 640)
    with pytest.raises(ValueError):
        kernels.brush_plane_lists(brushes + 256 * (brushes > 0), offsets, valid, 48, 640)
    with pytest.raises(ValueError):
        kernels.brush_plane_lists(brushes, offsets[:, :1], valid, 48, 640)
    with pytest.raises(ValueError):
        kernels.brush_plane_lists(brushes, offsets.astype(np.int64) + (1 << 32), valid, 48, 640)


@pytest.mark.parametrize("radius", _cases())
def test_block_stamp_lists_fold_as_per_pixel_brute_force(radius):
    """For every strip of every plane: the block's stamp list (its bin's)
    holds exactly the valid stamps whose patch extent touches the bin, in
    stamp order (every stamp that covers a pixel of the strip among them),
    the strips of a bin share it, and the strip's fold, warp by warp as
    the kernel skips, equals the per-pixel brute force and the plain
    version's plane."""
    case = brush_case(radius)
    brushes, offsets, valid, hp, wp = plane_inputs(case)
    lists = kernels.brush_plane_lists(brushes, offsets, valid, hp, wp)
    planes = TB._stamp_alpha_torch(brushes, offsets, valid, hp, wp, "cpu").numpy()
    assert len(lists.ranges) == len(brushes) * -(-hp // BH) * -(-wp // BW)
    bins = {}
    for b in range(len(lists.ranges)):
        si, ty0, tx0, sub = block_origin(lists, b)
        assert bins.setdefault((si, ty0 - sub, tx0), tuple(lists.ranges[b])) == tuple(lists.ranges[b])
        stamps, _ = bin_entries(lists, b)
        assert [tuple(e) for e in stamps] == brute_lists(brushes, offsets, valid, None, None, si, ty0 - sub, tx0, hp,
                                                         wp)[0]
        got = block_alpha(lists, b)
        assert np.array_equal(got, brute_alpha(brushes, offsets, valid, si, ty0, tx0))
        plane = np.zeros((BH, BW), np.int64)
        part = planes[si, ty0 : ty0 + BH, tx0 : tx0 + BW]
        plane[: part.shape[0], : part.shape[1]] = part
        assert np.array_equal(np.where(_in_plane(hp, wp, ty0, tx0), got, 0), plane)
    assert sum(r[1] - r[0] for r in bins.values()) == len(lists.stamps) > 0


def test_blend_needs_no_test_of_its_texel():
    """brush_stamp.cu folds every texel under a stamp, its masked zeros
    included, with no test of the texel: prelerp(p, 0) == p and prelerp(p,
    255) == 255 for every p in 0..255, as the plain version's selects make
    them, and every blend stays in 0..255."""
    p = np.arange(256)[:, None]
    t = np.arange(256)[None, :]
    lerp = p + t - ((((t * p + 128) >> 8) + (t * p + 128)) >> 8)
    assert np.array_equal(lerp[:, 0], p[:, 0]) and (lerp[:, 255] == 255).all()
    pp, tt = np.broadcast_arrays(p, t)
    assert np.array_equal(lerp, _fold(pp, tt))
    assert lerp.min() >= 0 and lerp.max() <= 255


def _in_plane(hp, wp, ty0, tx0):
    yy, xx = np.mgrid[ty0 : ty0 + BH, tx0 : tx0 + BW]
    return (yy < hp) & (xx < wp)


@pytest.mark.parametrize("radius", _cases())
def test_block_mask_matches_box_count(radius):
    """Each piece's mask as its blocks make it (strip by strip, warp by
    warp) equals region._box_count of the stroke's point plane > 0, over
    the same window, at the group's pieces and at the plane's corners;
    points at the plane's edges, dropped and repeated."""
    hp, wp, _, _, npb, items = brush_case(radius)
    brushes, offsets, valid, points, fills, radii, meta = TBT._group_lists(npb, items)
    corners = [(si, oy, ox) for si in range(len(items)) for oy, ox in ((0, 0), (hp - TH, wp - TW))]
    windows = np.concatenate([meta, np.array(corners, np.int32)])
    lists = kernels.brush_piece_lists(brushes, offsets, valid, points, fills, radii, windows, hp, wp)
    for si, (_, _, _, _, pt, _, (wr, hr), _) in enumerate(items):
        keep = pt[pt[:, 0] != BRUSH_FAR].astype(np.int64)
        plane = torch.zeros((hp, wp), dtype=torch.int32)
        plane.index_put_((torch.from_numpy(keep[:, 0]), torch.from_numpy(keep[:, 1])),
                         torch.ones(len(keep), dtype=torch.int32), accumulate=True)
        want = (TRG._box_count(plane, wr, hr) > 0).numpy()
        for j in np.nonzero(windows[:, 0] == si)[0]:
            _, oy, ox = windows[j]
            got = np.concatenate([block_mask(lists, b) for b in range(j * (TH // BH), (j + 1) * (TH // BH))])
            assert np.array_equal(got, want[oy : oy + TH, ox : ox + TW]), (si, oy, ox)
        assert want.any() == (len(keep) > 0)


@pytest.mark.parametrize("radius", _cases())
def test_piece_lists_and_padding_pieces(radius):
    """The group's piece metadata lists each stroke's pieces in staging
    order, then padding pieces (stroke 0 at the plane origin) up to the
    pow2 bucket of at least 8, whose blocks share one strip's lists; each
    block's lists hold exactly the stamps and points that touch its strip,
    in order; the block model (mask, alpha, dissolve, pack; zeros without
    a stamp or a point) of every piece, padding included, equals
    _group_block_torch."""
    hp, wp, bhb, bwb, npb, items = brush_case(radius)
    brushes, offsets, valid, points, fills, radii, meta = TBT._group_lists(npb, items)
    listed = [(si, oy, ox) for si, it in enumerate(items) for _, oy, ox in it[7]]
    pb = max(8, 1 << (len(listed) - 1).bit_length())
    assert meta.dtype == np.int32 and meta.shape == (pb, 3)
    assert [tuple(m) for m in meta[: len(listed)]] == listed
    assert not meta[len(listed) :].any() and pb > len(listed)
    assert np.array_equal(points[2], np.full((npb, 2), BRUSH_FAR))  # the empty stroke, padded with _FAR
    assert radii.tolist() == [list(it[6]) for it in items]
    lists = kernels.brush_piece_lists(brushes, offsets, valid, points, fills, radii, meta, hp, wp)
    strips = TH // BH
    pad = lists.ranges[len(listed) * strips :].reshape(-1, strips, 4)
    assert (pad == pad[:1]).all()  # one copy of the origin's lists for every padding piece
    for b in range(len(lists.ranges)):
        si, ty0, tx0, sub = block_origin(lists, b)
        stamps, pts = bin_entries(lists, b)
        want = brute_lists(brushes, offsets, valid, points, radii, si, ty0 - sub, tx0, hp, wp)
        assert ([tuple(e) for e in stamps], [tuple(e) for e in pts]) == want, b
    want = TBT.BrushTileBuild(1, 1, "cpu")._group_block_torch(hp, wp, bhb, bwb, npb, items).numpy()
    assert want.shape == (pb, TH, TW)
    for j, (si, oy, ox) in enumerate(meta):
        assert np.array_equal(piece_model(lists, j, fills[si]), want[j]), j
    assert all(np.array_equal(p, want[len(listed)]) for p in want[len(listed) :])


_EXTENTS = st.sampled_from([(8, 8), (16, 32), (32, 128), (40, 136)])


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.data())
def test_strip_lists_hold_exactly_the_touching_records_in_order(data):
    """kernels.brush_plane_lists and brush_piece_lists against brute force
    (brute_lists) on random strokes: patches of any nonzero extent (or
    none), stamps at the plane's edges, invalid and repeated, points at the
    edges, outside the plane and dropped (_FAR), any mask radii, pieces on
    and off the piece grid and repeated.  Every record whose patch extent or
    point window touches a strip is in that strip's list, in record order,
    and no other record is."""
    bhb, bwb = data.draw(_EXTENTS)
    s, n = data.draw(st.integers(1, 3)), data.draw(st.integers(1, 10))
    hp, wp = data.draw(st.integers(max(bhb, TH), 3 * TH)), data.draw(st.integers(max(bwb, TW), 3 * TW))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    brushes = np.zeros((s, bhb, bwb), np.int32)
    for k in range(s):
        if data.draw(st.booleans()) or k == 0:
            y0, x0 = rng.integers(0, bhb), rng.integers(0, bwb)
            y1, x1 = rng.integers(y0, bhb), rng.integers(x0, bwb)
            brushes[k, y0 : y1 + 1, x0 : x1 + 1] = rng.integers(0, 256, (y1 - y0 + 1, x1 - x0 + 1))
            brushes[k, y0, x0] = brushes[k, y1, x1] = 255
    offsets = np.stack([rng.choice([0, hp - bhb, *rng.integers(0, hp - bhb + 1, 3)], (s, n)),
                        rng.choice([0, wp - bwb, *rng.integers(0, wp - bwb + 1, 3)], (s, n))], axis=-1)
    offsets[:, n // 2 :] = offsets[:, : n - n // 2]  # repeated stamps
    valid = rng.random((s, n)) < 0.8
    points = offsets + rng.integers(-20, 40, (s, n, 2))
    points[rng.random((s, n)) < 0.2] = BRUSH_FAR
    points[:, 0] = (0, wp - 1)  # the plane's corners
    points[:, -1] = (hp - 1, 0)
    radii = rng.integers(0, 20, (s, 2))
    lists = kernels.brush_plane_lists(brushes, offsets.astype(np.int32), valid, hp, wp)
    for b in range(len(lists.ranges)):
        si, ty0, tx0, sub = block_origin(lists, b)
        got = [tuple(e) for e in bin_entries(lists, b)[0]]
        assert got == brute_lists(brushes, offsets, valid, None, None, si, ty0 - sub, tx0, hp, wp)[0], b
    meta = np.stack([rng.integers(0, s, 6), rng.choice([0, hp - TH, *rng.integers(0, hp - TH + 1, 2)], 6),
                     rng.choice([0, wp - TW, *rng.integers(0, wp - TW + 1, 2)], 6)], axis=1)
    meta[5] = meta[0]  # a repeated window
    fills = rng.integers(0, 256, (s, 4))
    lists = kernels.brush_piece_lists(brushes, offsets.astype(np.int32), valid, points.astype(np.int32), fills,
                                      radii, meta, hp, wp)
    for b in range(len(lists.ranges)):
        si, ty0, tx0, sub = block_origin(lists, b)
        got = tuple([tuple(e) for e in kinds] for kinds in bin_entries(lists, b))
        assert got == brute_lists(brushes, offsets, valid, points, radii, si, ty0 - sub, tx0, hp, wp), b


@pytest.mark.parametrize("radius", _cases())
def test_stamp_alpha_plain_matches_jax(radius):
    """_stamp_alpha_torch against _stamp_scan_alpha, stroke by stroke."""
    brushes, offsets, valid, hp, wp = plane_inputs(brush_case(radius))
    got = TB._stamp_alpha_torch(brushes, offsets, valid, hp, wp, "cpu").numpy()
    bhb, bwb = brushes.shape[1:]
    for si in range(len(brushes)):
        want = JB._stamp_scan_alpha(jnp.zeros((hp, wp), jnp.int32), jnp.asarray(brushes[si]),
                                    jnp.asarray(offsets[si]), jnp.asarray(valid[si]), bh=bhb, bw=bwb)
        assert np.array_equal(got[si], np.asarray(want)), si


@pytest.mark.parametrize("radius", _cases())
def test_group_block_plain_matches_jax_flush(radius):
    """The same group through the JAX package's BrushTileBuild.flush
    (_brush_group_kernel) and the port's (_group_block_torch): the same
    registry and block."""
    hp, wp, bhb, bwb, npb, items = brush_case(radius)
    jb, tb = JBT.BrushTileBuild(1, 1), TBT.BrushTileBuild(1, 1, "cpu")
    jb.groups[(hp, wp, bhb, bwb, npb)] = [tuple(np.copy(v) if isinstance(v, np.ndarray) else v for v in it)
                                          for it in items]
    tb.groups[(hp, wp, bhb, bwb, npb)] = items
    (jblock,), jreg = jb.flush()
    (tblock,), treg = tb.flush()
    assert treg == jreg
    assert np.array_equal(tblock.numpy(), np.asarray(jblock).view(np.int32))


@pytest.mark.parametrize("radius", [1.0, 12.0, 15.0, 120.0])
def test_smear_walk_plain_matches_jax(radius):
    """_smear_walk_torch's two passes against _smear_scan run twice: all
    nine directions, the 0 texels of the opacity plane writing the source."""
    canvas, opac, offsets, dirs = smear_case(radius, n=20 if radius > 100 else 60)
    bh, bw = opac.shape
    assert (opac == 0).any() and (opac == 255).any() and set(dirs) == set(SMEAR_DIRS)
    got = TB._smear_walk_torch(torch.from_numpy(canvas.copy()), torch.from_numpy(opac), offsets, dirs, bh, bw)
    cv = jnp.asarray(canvas.copy())
    args = (jnp.asarray(opac), jnp.asarray(np.array(offsets, np.int32)), jnp.asarray(np.array(dirs, np.int32)),
            jnp.ones(len(offsets), bool))
    for _ in range(2):
        cv = JB._smear_scan(cv, *args, bh=bh, bw=bw, lbh=bh, lbw=bw)
    assert np.array_equal(got.numpy(), np.asarray(cv))
    assert not np.array_equal(got.numpy(), canvas)


@pytest.mark.parametrize("kind,radius", SMEAR_WALKS)
def test_smear_walks_plain_match_jax(kind, radius):
    """_smear_walk_torch against _smear_scan run twice on the card tests'
    walks: dense, with jumps, each step's source the last step's patch,
    over channels or under an opacity outside 0..255."""
    canvas, opac, offsets, dirs = smear_walk_case(kind, radius)
    bh, bw = opac.shape
    got = TB._smear_walk_torch(torch.from_numpy(canvas.copy()), torch.from_numpy(opac), offsets, dirs, bh, bw)
    cv = jnp.asarray(canvas.copy())
    args = (jnp.asarray(opac), jnp.asarray(np.array(offsets, np.int32)), jnp.asarray(np.array(dirs, np.int32)),
            jnp.ones(len(offsets), bool))
    for _ in range(2):
        cv = JB._smear_scan(cv, *args, bh=bh, bw=bw, lbh=bh, lbw=bw)
    assert np.array_equal(got.numpy(), np.asarray(cv))


def _wrap(x):
    """int64 values wrapped to int32, as the kernel's and torch's int32 sums wrap."""
    return ((x + 2**31) % 2**32) - 2**31


def _blend(d, s, al):
    """smear.cu's exact blend of destination and source pixels by opacity
    (int64 arrays holding int32 values, every product and sum wrapped)."""
    def div255(i):
        return _wrap(i + (i >> 8) + 1) >> 8

    mixed = _wrap(div255(_wrap(d * al)) + div255(_wrap(s * _wrap(255 - al))))
    return np.where(al == 0, s, np.where(al == 255, d, mixed))


def _div255x2(x):
    """smear.cu's div255x2 on uint64 arrays holding 32-bit words."""
    return ((x + ((x >> 8) & 0x00FF00FF) + 0x00010001) >> 8) & 0x00FF00FF


def test_packed_blend_matches_the_exact_blend():
    """smear.cu's packed blend (two channels a 32-bit word, div255x2 on each
    16-bit lane) equals the exact blend, al == 0 and al == 255 selects
    included, at every (d, s, al) in 0..255, lane by lane, with the other
    lane holding any channel; and every result lies in 0..255, so that the
    packed walk stays packed."""
    rng = np.random.default_rng(16)
    d = np.arange(256, dtype=np.uint64)[:, None]
    s = np.arange(256, dtype=np.uint64)[None, :]
    for al in range(256):
        od, os_ = (rng.integers(0, 256, (256, 256)).astype(np.uint64) for _ in range(2))
        words = []
        for lo, hi in ((d, od), (s, os_)):
            words.append((lo | (hi << 16)) & 0xFFFFFFFF)
        got = (_div255x2((words[0] * al) & 0xFFFFFFFF) + _div255x2((words[1] * (255 - al)) & 0xFFFFFFFF)) & 0xFFFFFFFF
        want = _blend(d.astype(np.int64), s.astype(np.int64), np.int64(al))
        want_hi = _blend(od.astype(np.int64), os_.astype(np.int64), np.int64(al))
        assert np.array_equal(got & 0xFFFF, want) and np.array_equal(got >> 16, want_hi)
        assert want.max() <= 255 and want.min() >= 0


@pytest.mark.parametrize("radius", BRUSH_RADII)
def test_smear_steps_pack_and_refuse_what_leaves_the_canvas(radius):
    canvas, opac, offsets, dirs = smear_case(radius)
    bh, bw = opac.shape
    height, width = canvas.shape[:2]
    steps = kernels.smear_steps(offsets, dirs, bh, bw, height, width)
    assert steps.dtype == np.int32 and steps.tolist() == [[r, c, dx, dy] for (r, c), (dx, dy) in zip(offsets, dirs)]
    assert kernels.smear_steps([], [], bh, bw, height, width).shape == (0, 4)
    for k, (off, d) in enumerate((((0, 5), (0, 1)), ((5, 0), (1, 0)), ((height - bh, 5), (0, -1)),
                                  ((5, width - bw), (-1, 0)), ((height - bh + 1, 5), (0, 0)))):
        with pytest.raises(ValueError, match="step 1 "):
            kernels.smear_steps([offsets[0], off], [dirs[0], d], bh, bw, height, width)
    for d in ((2, 0), (0, -2)):  # not a unit step: window mode's margin holds a shift of one pixel
        with pytest.raises(ValueError, match="step 1 .* not a unit step"):
            kernels.smear_steps([offsets[0], (8, 8)], [dirs[0], d], bh, bw, height, width)


def test_wrappers_refuse_the_cpu():
    """On the CPU the dispatch sites run the plain versions and launch
    nothing; the kernels' wrappers themselves refuse a CPU device or
    tensor."""
    brushes, offsets, valid, hp, wp = plane_inputs(brush_case(1.0))
    with pytest.raises(ValueError):
        kernels.brush_stamp_planes(brushes, offsets, valid, hp, wp, "cpu")
    canvas, opac, steps, dirs = smear_case(1.0)
    with pytest.raises(ValueError):
        kernels.smear_walk(torch.from_numpy(canvas), torch.from_numpy(opac), steps, dirs, *opac.shape)
    before = dict(kernels.launches)
    TB._stamp_alpha(brushes, offsets, valid, hp, wp, "cpu")
    TB._smear_walk(torch.from_numpy(canvas), torch.from_numpy(opac), steps, dirs, *opac.shape)
    assert kernels.launches == before
