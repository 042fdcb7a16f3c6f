"""The brush kernels' host side and their plain versions, on the CPU.

``brush_stamp`` (plane and piece modes) and ``smear_walk`` run only on the
card (tests/test_torch_cuda.py holds them to their plain versions there).
Here, at the same cases (``brush_case``, ``smear_case`` from that file):

  * the host lists the kernels read (``kernels.pack_brush_records``,
    ``smear_steps``, the group lists of ``brush_tiles._group_lists``)
    against brute force in numpy;
  * a numpy model of what one block walks (its rounds of 256 records, the
    ordered list of the stamps whose patch touches its tile, the fold of
    that list; in piece mode the points whose window touches the piece and
    each thread's covered rows) against a per-pixel brute force, against
    ``region._box_count(...) > 0`` and against the plain versions;
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
ROUND = 256  # brush_stamp.cu's kThreads: records a round
ROWS = BH * BW // ROUND  # rows of one column a thread owns


def _cases():
    return [pytest.param(r, id=f"r{r:g}") for r in BRUSH_RADII]


def _patches(records):
    """The cropped patch of each stroke, read back from the packed bytes."""
    _, _, strokes, words = records
    raw = words.view(np.uint8)
    return [raw[at : at + kh * kw].reshape(kh, kw).astype(np.int64) for _, _, kh, kw, _, _, at in strokes[:, :7]]


def _fold(alpha, texels):
    """One stamp over the pixels it covers: the kernel's (and colour.py's
    prelerp_arr) arithmetic."""
    t = texels
    lerp = alpha + t - ((((t * alpha + 128) >> 8) + (t * alpha + 128)) >> 8)
    return np.where(t == 0, alpha, np.where(t == 255, 255, lerp))


def block_stamp_list(records, si, ty0, tx0):
    """The stamps one block walks for stroke si's strip at (ty0, tx0): its
    rounds of ROUND records, each compacted in record order to those whose
    patch extent touches the BH x BW strip."""
    stamps, _, strokes, _ = records
    ky0, kx0, kh, kw = strokes[si, :4]
    out = []
    for base in range(0, stamps.shape[1], ROUND):
        rec = stamps[si, base : base + ROUND].astype(np.int64)
        sy, sx = rec[:, 0] + ky0, rec[:, 1] + kx0
        hit = (sy < ty0 + BH) & (sy + kh > ty0) & (sx < tx0 + BW) & (sx + kw > tx0)
        out.extend(base + np.nonzero(hit)[0])
    return out


def block_alpha(records, si, ty0, tx0, order):
    """The block's BH x BW alpha from its stamp list: each listed stamp's
    texels folded into the pixels under them, in list order."""
    stamps, _, strokes, _ = records
    ky0, kx0, kh, kw = strokes[si, :4]
    patch = _patches(records)[si]
    alpha = np.zeros((BH, BW), np.int64)
    for i in order:
        oy, ox = (int(v) for v in stamps[si, i])
        y0, x0 = oy + ky0 - ty0, ox + kx0 - tx0
        ys, xs = slice(max(y0, 0), min(y0 + kh, BH)), slice(max(x0, 0), min(x0 + kw, BW))
        sub = patch[ys.start - y0 : ys.stop - y0, xs.start - x0 : xs.stop - x0]
        alpha[ys, xs] = _fold(alpha[ys, xs], sub)
    return alpha


def brute_alpha(brushes, offsets, valid, si, ty0, tx0):
    """Per pixel of the strip: every valid stamp of the stroke that covers
    it, in stamp order, folded from 0 (the padded patch, no extent, no
    lists).  Returns (alpha, the stamps that cover a pixel of the strip
    with a nonzero texel)."""
    bhb, bwb = brushes.shape[1:]
    yy, xx = np.mgrid[ty0 : ty0 + BH, tx0 : tx0 + BW]
    alpha = np.zeros((BH, BW), np.int64)
    touching = []
    for i in range(offsets.shape[1]):
        if not valid[si, i]:
            continue
        ky, kx = yy - offsets[si, i, 0], xx - offsets[si, i, 1]
        inside = (ky >= 0) & (ky < bhb) & (kx >= 0) & (kx < bwb)
        t = np.where(inside, brushes[si][np.clip(ky, 0, bhb - 1), np.clip(kx, 0, bwb - 1)], 0).astype(np.int64)
        if (t != 0).any():
            touching.append(i)
        alpha = _fold(alpha, t)
    return alpha, touching


def block_mask(records, si, ty0, tx0):
    """The strip's mask as the block makes it: the points of each round
    whose (2 hr + 1) x (2 wr + 1) window touches the strip, then per thread
    (one column, ROWS rows) the bits of its rows that a listed point within
    wr of its column covers."""
    _, points, strokes, _ = records
    wr, hr = strokes[si, 4:6]
    mask = np.zeros((BH, BW), bool)
    for base in range(0, points.shape[1], ROUND):
        rec = points[si, base : base + ROUND].astype(np.int64)
        near = (rec[:, 0] - hr < ty0 + BH) & (rec[:, 0] + hr >= ty0) & (rec[:, 1] - wr < tx0 + BW) & \
            (rec[:, 1] + wr >= tx0)
        for py, px in rec[near]:
            for r0 in range(0, BH, ROWS):
                y0 = ty0 + r0
                lo, hi = max(py - hr - y0, 0), min(py + hr - y0, ROWS - 1)
                if lo > hi:
                    continue
                bits = ((0xFFFFFFFF >> (31 - (hi - lo))) << lo) & 0xFFFFFFFF
                rows = [j for j in range(ROWS) if (bits >> j) & 1]
                cols = np.nonzero(np.abs(np.arange(tx0, tx0 + BW) - px) <= wr)[0]
                mask[np.ix_([r0 + j for j in rows], cols)] = True
    return mask


def _strips(hp, wp):
    return [(ty0, tx0) for ty0 in range(0, hp, BH) for tx0 in range(0, wp, BW)]


def piece_model(records, si, oy, ox, f):
    """One TH x TW piece as its TH // BH blocks make it: per strip the
    stamp list's alpha and the point mask, then the fill dissolved by the
    alpha inside the mask and packed."""
    alpha = np.concatenate([block_alpha(records, si, oy + k, ox, block_stamp_list(records, si, oy + k, ox))
                            for k in range(0, TH, BH)])
    mask = np.concatenate([block_mask(records, si, oy + k, ox) for k in range(0, TH, BH)])
    f = f.astype(np.int64)
    dis = np.where(alpha[..., None] == 0, 0, np.where(alpha[..., None] == 255, f,
                   (f * alpha[..., None] + ((f * alpha[..., None]) >> 8) + 1) >> 8))
    packed = dis[..., 0] | (dis[..., 1] << 8) | (dis[..., 2] << 16) | (dis[..., 3] << 24)
    return np.where(mask, packed, 0).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("radius", _cases())
def test_stamp_and_point_records_pack_as_brute_force(radius):
    hp, wp, bhb, bwb, npb, items = brush_case(radius)
    brushes, offsets, valid, points, fills, radii, meta = TBT._group_lists(npb, items)
    records = kernels.pack_brush_records(brushes, offsets, valid, hp, wp, points, fills, radii)
    stamps, pts, strokes, words = records
    assert stamps.dtype == pts.dtype == strokes.dtype == words.dtype == np.int32
    assert stamps.shape == pts.shape == (len(items), npb, 2) and strokes.shape == (len(items), kernels.STROKE_WORDS)
    for si in range(len(items)):
        for i in range(npb):
            want = tuple(offsets[si, i]) if valid[si, i] else (kernels.FAR_RECORD,) * 2
            assert tuple(stamps[si, i]) == want
            py, px = (int(v) for v in points[si, i])
            inside = 0 <= py < hp and 0 <= px < wp
            assert tuple(pts[si, i]) == ((py, px) if inside else (kernels.FAR_RECORD,) * 2)
        nz = np.argwhere(brushes[si] != 0)
        (ky0, kx0), (ky1, kx1) = nz.min(axis=0), nz.max(axis=0)
        assert tuple(strokes[si, :6]) == (ky0, kx0, ky1 - ky0 + 1, kx1 - kx0 + 1, *items[si][6])
        assert tuple(strokes[si, 8:]) == tuple(items[si][5])
        assert np.array_equal(_patches(records)[si], brushes[si, ky0 : ky1 + 1, kx0 : kx1 + 1])
    # One copy of each distinct patch (stroke 3 has its own opacity; none repeats here), four bytes to a word.
    assert len(set(strokes[:, 6])) == len({b.tobytes() for b in brushes})
    assert words.size * 4 >= sum(int(kh * kw) for kh, kw in strokes[:, 2:4])


def test_pack_records_shares_a_patch_and_refuses_what_leaves_the_plane():
    brushes = np.zeros((3, 8, 128), np.int32)
    brushes[:, 2:5, 3:6] = TB.drawround_alpha(1.0, 0.5)
    brushes[2] = 0  # an empty patch: no extent
    offsets = np.array([[(0, 0), (40, 500)], [(3, 4), (1 << 20, -5)], [(7, 7), (0, 0)]], np.int32)
    valid = np.array([[True, True], [True, False], [False, True]])
    stamps, pts, strokes, words = kernels.pack_brush_records(brushes, offsets, valid, 48, 640)
    assert pts is None and strokes[0, 6] == strokes[1, 6] == 0 and words.size == 3  # 9 bytes, one copy
    assert tuple(strokes[2, :4]) == (0, 0, 0, 0)
    assert tuple(stamps[1, 1]) == tuple(stamps[2, 0]) == (kernels.FAR_RECORD,) * 2  # invalid: anywhere
    for bad in ((40 + 1, 0), (-1, 3), (0, 640 - 128 + 1), (0, -2)):
        moved = offsets.copy()
        moved[0, 1] = bad
        with pytest.raises(ValueError, match="stroke 0's stamp 1"):
            kernels.pack_brush_records(brushes, moved, valid, 48, 640)
    with pytest.raises(ValueError):
        kernels.pack_brush_records(brushes + 256 * (brushes > 0), offsets, valid, 48, 640)
    with pytest.raises(ValueError):
        kernels.pack_brush_records(brushes, offsets[:, :1], valid, 48, 640)


@pytest.mark.parametrize("radius", _cases())
def test_block_stamp_lists_fold_as_per_pixel_brute_force(radius):
    """For every strip of every plane: the block's ordered stamp list holds
    every stamp that covers a pixel of the strip with a nonzero texel, in
    stamp order, and its fold equals the per-pixel brute force and the
    plain version's plane."""
    case = brush_case(radius)
    brushes, offsets, valid, hp, wp = plane_inputs(case)
    records = kernels.pack_brush_records(brushes, offsets, valid, hp, wp)
    planes = TB._stamp_alpha_torch(brushes, offsets, valid, hp, wp, "cpu").numpy()
    listed = 0
    for si in range(len(brushes)):
        for ty0, tx0 in _strips(hp, wp):
            order = block_stamp_list(records, si, ty0, tx0)
            want, touching = brute_alpha(brushes, offsets, valid, si, ty0, tx0)
            assert order == sorted(order) and set(touching) <= set(order)
            assert all(valid[si, i] for i in order)
            got = block_alpha(records, si, ty0, tx0, order)
            assert np.array_equal(got, want)
            plane = np.zeros((BH, BW), np.int64)
            part = planes[si, ty0 : ty0 + BH, tx0 : tx0 + BW]
            plane[: part.shape[0], : part.shape[1]] = part
            assert np.array_equal(np.where(_in_plane(hp, wp, ty0, tx0), got, 0), plane)
            listed += len(order)
    assert listed


def _in_plane(hp, wp, ty0, tx0):
    yy, xx = np.mgrid[ty0 : ty0 + BH, tx0 : tx0 + BW]
    return (yy < hp) & (xx < wp)


@pytest.mark.parametrize("radius", _cases())
def test_block_mask_matches_box_count(radius):
    """Each piece's mask as its blocks make it (strip by strip) equals
    region._box_count of the stroke's point plane > 0, over the same
    window; points at the plane's edges, dropped and repeated."""
    hp, wp, _, _, npb, items = brush_case(radius)
    brushes, offsets, valid, points, fills, radii, meta = TBT._group_lists(npb, items)
    records = kernels.pack_brush_records(brushes, offsets, valid, hp, wp, points, fills, radii)
    for si, (_, _, _, _, pt, _, (wr, hr), _) in enumerate(items):
        keep = pt[pt[:, 0] != BRUSH_FAR].astype(np.int64)
        plane = torch.zeros((hp, wp), dtype=torch.int32)
        plane.index_put_((torch.from_numpy(keep[:, 0]), torch.from_numpy(keep[:, 1])),
                         torch.ones(len(keep), dtype=torch.int32), accumulate=True)
        want = (TRG._box_count(plane, wr, hr) > 0).numpy()
        windows = {(oy, ox) for s_, oy, ox in meta if s_ == si} | {(0, 0), (hp - TH, wp - TW)}
        for oy, ox in windows:
            got = np.concatenate([block_mask(records, si, oy + k, ox) for k in range(0, TH, BH)])
            assert np.array_equal(got, want[oy : oy + TH, ox : ox + TW]), (si, oy, ox)
        assert want.any() == (len(keep) > 0)


@pytest.mark.parametrize("radius", _cases())
def test_piece_lists_and_padding_pieces(radius):
    """The group's piece metadata lists each stroke's pieces in staging
    order, then padding pieces (stroke 0 at the plane origin) up to the
    pow2 bucket of at least 8; the block model (alpha, mask, dissolve,
    pack) of every piece, padding included, equals _group_block_torch."""
    hp, wp, bhb, bwb, npb, items = brush_case(radius)
    brushes, offsets, valid, points, fills, radii, meta = TBT._group_lists(npb, items)
    listed = [(si, oy, ox) for si, it in enumerate(items) for _, oy, ox in it[7]]
    pb = max(8, 1 << (len(listed) - 1).bit_length())
    assert meta.dtype == np.int32 and meta.shape == (pb, 3)
    assert [tuple(m) for m in meta[: len(listed)]] == listed
    assert not meta[len(listed) :].any() and pb > len(listed)
    assert np.array_equal(points[2], np.full((npb, 2), BRUSH_FAR))  # the empty stroke, padded with _FAR
    assert radii.tolist() == [list(it[6]) for it in items]
    records = kernels.pack_brush_records(brushes, offsets, valid, hp, wp, points, fills, radii)
    want = TBT.BrushTileBuild(1, 1, "cpu")._group_block_torch(hp, wp, bhb, bwb, npb, items).numpy()
    assert want.shape == (pb, TH, TW)
    for j, (si, oy, ox) in enumerate(meta):
        assert np.array_equal(piece_model(records, si, oy, ox, fills[si]), want[j]), j
    assert all(np.array_equal(pad, want[len(listed)]) for pad in want[len(listed) :])


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
