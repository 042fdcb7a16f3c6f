"""chip_smoke.py's byte counts against a brute-force count.

Every share of the bound that chip_smoke.py prints rests on these
functions: walked_depths (the pieces each 32-byte sector of a tile walks
through an atlas list), layer_walk (the same for a dense layer stack),
bound (the bytes those walks must move) and, for the layer fold,
fold_bound (the sectors each open pixel reads until it closes) and
fold_visits (the host's model of a tiled fold's layer lists); and, for
the animated frame's kernels, pixel_sectors, blur_bound and shatter_bound
(the sectors and multiply-adds of blur_blend and shatter_into).  Here
each is held, on small random atlases, stacks and layer packs made from a
seed with numpy, to a count written out pixel by pixel: a sector reads a
layer while any of its 8 pixels is still translucent, reads its background
if one still is after the walk, and is written once.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_cuda import fold_case  # noqa: E402

TILE_H, TILE_W, SECTOR = 64, 128, 8


def _layers(rng, n: int, shape) -> np.ndarray:
    """n uint32 packed layers of `shape`: opaque, translucent, sparse and
    clear pixels mixed, so that sectors turn opaque at many depths."""
    kind = rng.integers(0, 4, (n,) + tuple(shape))
    alpha = np.where(kind == 0, 255, np.where(kind == 1, rng.integers(1, 255, kind.shape), 0))
    alpha = np.where(kind == 2, rng.integers(200, 256, kind.shape), alpha)
    rgb = np.minimum(rng.integers(0, 256, kind.shape + (3,)), alpha[..., None])
    return (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (alpha << 24)).astype(np.uint32)


def _brute_walk(tiles):
    """(reads, still_open) for a list of tiles, each a list of (64, 128)
    uint32 layers front to back, sector by sector: the alpha of every pixel
    folded with over_packed's integer formula."""
    reads = np.zeros((len(tiles), TILE_H * TILE_W // SECTOR), np.int64)
    still_open = np.ones_like(reads, dtype=bool)
    for t, layers in enumerate(tiles):
        for sec in range(reads.shape[1]):
            y, x0 = divmod(sec * SECTOR, TILE_W)
            acc = [0] * SECTOR
            for layer in layers:
                if all(a == 255 for a in acc):
                    break
                reads[t, sec] += 1
                for i in range(SECTOR):
                    la = int(layer[y, x0 + i]) >> 24
                    q = la * acc[i] + 128
                    acc[i] = la + acc[i] - (((q >> 8) + q) >> 8)
            still_open[t, sec] = not all(a == 255 for a in acc)
    return reads, still_open


def _brute_bytes(reads, still_open) -> int:
    return int(reads.sum() + still_open.sum() + reads.size) * 32


def _as_int32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_walked_depths_matches_a_brute_force_count(seed):
    rng = np.random.default_rng(seed)
    atlas = _layers(rng, 12, (TILE_H, TILE_W))
    depths = [0, 1, 5, int(rng.integers(2, 10))]
    lists = [list(rng.integers(0, 12, d)) for d in depths]
    idxs = np.array([e for p in lists for e in p] + [0] * 3, np.int32)
    starts = np.concatenate([[0], np.cumsum(depths)]).astype(np.int32)
    reads, still_open = chip_smoke.walked_depths(torch, _as_int32(atlas), torch.from_numpy(idxs),
                                                 chip_smoke.full_spans(torch, torch.from_numpy(starts)))
    want_reads, want_open = _brute_walk([[atlas[e] for e in p] for p in lists])
    np.testing.assert_array_equal(reads.numpy(), want_reads)
    np.testing.assert_array_equal(still_open.numpy(), want_open)


@pytest.mark.parametrize("seed", [0, 1])
def test_walked_depths_of_a_dirty_list_skips_passthrough_and_padding(seed):
    """dirty_spans keeps each real tile once: passthrough slots (span -1)
    and padding slots repeating the last real slot drop out."""
    rng = np.random.default_rng(seed)
    atlas = _layers(rng, 10, (TILE_H, TILE_W))
    lists = [list(rng.integers(0, 10, d)) for d in (3, 6)]
    idxs = np.array(lists[0] + lists[1], np.int32)
    coords = np.array([0, 0, 0, 1, 0, 2] + [0, 2] * 5, np.int32)
    spans = np.array([-1, -1, 0, 3, 3, 9] + [3, 9] * 5, np.int32)
    dspans = chip_smoke.dirty_spans(torch, coords, spans, 8, "cpu")
    assert dspans.tolist() == [[0, 3], [3, 9]]
    reads, still_open = chip_smoke.walked_depths(torch, _as_int32(atlas), torch.from_numpy(idxs), dspans)
    want_reads, want_open = _brute_walk([[atlas[e] for e in p] for p in lists])
    np.testing.assert_array_equal(reads.numpy(), want_reads)
    np.testing.assert_array_equal(still_open.numpy(), want_open)


@pytest.mark.parametrize("seed,k,nty,ntx", [(0, 1, 1, 1), (1, 4, 2, 1), (2, 9, 1, 2), (3, 0, 1, 1)])
def test_layer_walk_matches_a_brute_force_count(seed, k, nty, ntx):
    rng = np.random.default_rng(seed)
    stack = _layers(rng, k, (nty * TILE_H, ntx * TILE_W))
    reads, still_open = chip_smoke.layer_walk(torch, _as_int32(stack))
    tiles = [[layer[ty * TILE_H : (ty + 1) * TILE_H, tx * TILE_W : (tx + 1) * TILE_W] for layer in stack]
             for ty in range(nty) for tx in range(ntx)]
    want_reads, want_open = _brute_walk(tiles)
    np.testing.assert_array_equal(reads.numpy(), want_reads)
    np.testing.assert_array_equal(still_open.numpy(), want_open)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bound_counts_each_sector_once(seed):
    """bound's bytes over several walks: every walked layer, every
    background still needed and every write, 32 bytes each; its time at the
    HBM rate; the per-tile count and the deepest walk beside them."""
    rng = np.random.default_rng(seed)
    stack = _layers(rng, 6, (2 * TILE_H, TILE_W))
    atlas = _layers(rng, 8, (TILE_H, TILE_W))
    idxs = rng.integers(0, 8, 7).astype(np.int32)
    walks = [chip_smoke.layer_walk(torch, _as_int32(stack)),
             chip_smoke.walked_depths(torch, _as_int32(atlas), torch.from_numpy(idxs),
                                      torch.tensor([[0, 7], [2, 4]], dtype=torch.int64))]
    got = chip_smoke.bound(walks)
    brute = [_brute_walk([[layer[ty * TILE_H : (ty + 1) * TILE_H] for layer in stack] for ty in range(2)]),
             _brute_walk([[atlas[e] for e in idxs[0:7]], [atlas[e] for e in idxs[2:4]]])]
    n_bytes = sum(_brute_bytes(r, o) for r, o in brute)
    assert got["bytes"] == n_bytes
    assert got["bound_ms"] == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)
    assert got["tiles"] == 4
    assert got["depth"] == max(int(r.max()) for r, _ in brute)
    assert got["piece_reads"] == sum(int(r.sum()) for r, _ in brute) * 32 / (TILE_H * TILE_W * 4)
    tile_pieces = sum(int(r.max(1).sum()) for r, _ in brute)
    assert got["tile_count_bytes"] == (tile_pieces + 2 * 4) * TILE_H * TILE_W * 4
    # A 4-row stripe is 64 sectors of a tile's 1024.
    stripe_pieces = sum(int(r.reshape(r.shape[0], 16, 64).max(2).sum()) for r, _ in brute)
    assert got["stripe_count_bytes"] == (stripe_pieces + 2 * 4 * 16) * 4 * TILE_W * 4


def _brute_fold_bytes(offs, layers, acc, open_mask) -> int:
    """fold_bound's bytes, pixel by pixel: for each layer front to back, the
    mask sector (32 one-byte pixels of the layer) of every pixel over it
    that is still open, and the RGBA sector (2 pixels) of each of those
    where the mask is set; the alpha blended as over_rgba blends it and the
    pixel closed at 255; the carry read and written, 32 bytes a record."""
    hb, wb = open_mask.shape
    alpha = acc[..., 3].astype(np.int64).copy()
    still = open_mask.copy()
    sectors = 0
    for (dy, dx), (rgba, mask) in zip(offs, layers):
        hs, ws = mask.shape
        mask_sectors, rgba_sectors = set(), set()
        for y in range(hb):
            for x in range(wb):
                iy, ix = y - dy, x - dx
                if not (0 <= iy < hs and 0 <= ix < ws and still[y, x]):
                    continue
                q = iy * ws + ix
                mask_sectors.add(q // 32)
                if not mask[iy, ix]:
                    continue
                rgba_sectors.add(q // 2)
                a, la = int(alpha[y, x]), int(rgba[iy, ix, 3])
                t = la * a + 128
                alpha[y, x] = la if a == 0 else a if a == 255 else la + a - (((t >> 8) + t) >> 8)
                still[y, x] = alpha[y, x] != 255
        sectors += len(mask_sectors) + len(rgba_sectors)
    return sectors * 32 + 2 * 18 * hb * wb + 32 * len(layers)


@pytest.mark.parametrize("seed,k,hb,wb,case", [(0, 7, 24, 40, "random"), (5, 9, 65, 57, "random"),
                                               (7, 6, 40, 90, "larger"), (9, 10, 65, 77, "ragged_open"),
                                               (10, 8, 33, 60, "opaque_front"), (11, 8, 30, 70, "clear_mask")])
def test_fold_bound_counts_from_the_carry(seed, k, hb, wb, case):
    """fold_bound starts from the carry: only the pixels it holds open read
    layers, and their alpha starts from its acc (some pixels already
    opaque), so a window that opens only part of itself costs less."""
    offs, layers, open_mask = fold_case(seed, k, hb, wb, case)
    acc = np.random.default_rng(seed).integers(0, 256, (hb, wb, 4)).astype(np.int32)
    acc[::5, ::3, 3] = 255
    tl = [(torch.from_numpy(r), torch.from_numpy(m)) for r, m in layers]
    got = chip_smoke.fold_bound(torch, offs.tolist(), tl, torch.from_numpy(acc), torch.from_numpy(open_mask))
    n_bytes = _brute_fold_bytes(offs.tolist(), layers, acc, open_mask)
    assert got["bytes"] == n_bytes
    assert got["bound_ms"] == pytest.approx(n_bytes / 3.35e12 * 1e3, rel=1e-12)
    everything = chip_smoke.fold_bound(torch, offs.tolist(), tl, torch.zeros((hb, wb, 4), dtype=torch.int32),
                                       torch.ones((hb, wb), dtype=torch.bool))
    assert everything["bytes"] == _brute_fold_bytes(offs.tolist(), layers, np.zeros((hb, wb, 4), np.int32),
                                                    np.ones((hb, wb), bool))
    assert got["bytes"] <= everything["bytes"]


@pytest.mark.parametrize("seed,k,hb,wb,case,tile", [(0, 7, 24, 40, "random", (8, 32)),
                                                    (4, 9, 17, 129, "random", (8, 32)),
                                                    (6, 8, 33, 70, "outside", (8, 32)),
                                                    (8, 30, 40, 70, "one_tile", (8, 32)),
                                                    (9, 10, 65, 257, "ragged_open", (16, 32)),
                                                    (9, 10, 65, 257, "ragged_open", (8, 64)),
                                                    (3, 12, 1, 1, "random", (8, 32))])
def test_fold_visits_counts_each_open_tile_s_list(seed, k, hb, wb, case, tile):
    """fold_visits tile by tile: a tile with an open pixel lists each layer
    whose box meets the tile's part of the window, and each of the tile's
    pixels in the window visits each listed layer."""
    offs, layers, open_mask = fold_case(seed, k, hb, wb, case)
    th, tw = tile
    want = {"tiles": 0, "open_tiles": 0, "tile_list_entries": 0, "deepest_list": 0,
            "listed_visits_upper_bound": 0}
    for ty in range(0, hb, th):
        for tx in range(0, wb, tw):
            want["tiles"] += 1
            y1, x1 = min(hb, ty + th), min(wb, tx + tw)
            if not open_mask[ty:y1, tx:x1].any():
                continue
            want["open_tiles"] += 1
            listed = sum(1 for (dy, dx), (_, m) in zip(offs.tolist(), layers)
                         if max(dy, ty) < min(dy + m.shape[0], y1) and max(dx, tx) < min(dx + m.shape[1], x1))
            want["tile_list_entries"] += listed
            want["deepest_list"] = max(want["deepest_list"], listed)
            want["listed_visits_upper_bound"] += listed * (y1 - ty) * (x1 - tx)
    got = chip_smoke.fold_visits(offs.tolist(), [m.shape for _, m in layers], torch.from_numpy(open_mask), tile)
    assert {key: got[key] for key in want} == want
    assert got["tile"] == [th, tw] and got["all_pairs"] == k * hb * wb
    assert got["listed_visits_upper_bound"] <= got["all_pairs"]


def _sectors(pixels, row_pixels: int, pixel_bytes: int) -> int:
    """32-byte sectors holding the (row, col) pixels, one by one."""
    return len({((y * row_pixels + x) * pixel_bytes) // 32 for y, x in pixels})


@pytest.mark.parametrize("row0,col0,rows,cols,row_pixels,pixel_bytes", [
    (0, 0, 5, 7, 9, 4), (3, 5, 4, 13, 21, 4), (1, 3, 6, 5, 11, 16), (2, 1, 7, 30, 33, 16)])
def test_pixel_sectors_match_a_brute_count(row0, col0, rows, cols, row_pixels, pixel_bytes):
    """pixel_sectors (the blur's and the shatter's byte counts) against the
    sectors of each pixel, one by one, for a whole block and a sparse one,
    on rows whose starts fall anywhere in a sector (and share sectors)."""
    block = [(row0 + y, col0 + x) for y in range(rows) for x in range(cols)]
    want = _sectors(block, row_pixels, pixel_bytes)
    mask = torch.ones((rows, cols), dtype=torch.bool)
    assert chip_smoke.pixel_sectors(torch, mask, row0, col0, row_pixels, pixel_bytes) == want
    mask = torch.from_numpy(np.random.default_rng(rows * cols).random((rows, cols)) < 0.3)
    some = [(row0 + int(y), col0 + int(x)) for y, x in mask.nonzero().tolist()]
    assert chip_smoke.pixel_sectors(torch, mask, row0, col0, row_pixels, pixel_bytes) == _sectors(some, row_pixels,
                                                                                                    pixel_bytes)


@pytest.mark.parametrize("place", ["centre", "bottom_right"])
def test_blur_bound_matches_a_brute_count(place):
    """blur_bound's changed pixels equal the plain window pass's changed
    mask, and its bytes and multiply-adds a count written out pixel by
    pixel: the content within r of a written pixel, the alpha the changed
    test reads, the written pixels; 4 x (2r + 1) multiply-adds for each
    x-pass value within r rows of a written pixel and for each written
    pixel."""
    from coherence_tpu_torch.raster import convolve as V
    from coherence_tpu_torch.raster import framepath as FP
    from test_torch_cuda import BLUR_FW, blur_case, unpacked_rgba

    r = 3
    packed, _, alpha, win = blur_case(r, place, "mixed")
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    fa = torch.from_numpy(alpha)
    got = chip_smoke.blur_bound(torch, fa, packed.shape[1], oy, ox, ry0, rx0, h, w, d_box, hb, wb, r)
    rows, cols, inwin = FP._window_mask(hb, wb, ry0, rx0, h, w, "cpu")
    k = V.mkgaussian(r)
    content = torch.from_numpy(unpacked_rgba(packed)[oy : oy + hb, ox : ox + wb].copy())
    changed, _ = FP.conv_blend_window(content, fa[oy : oy + hb, ox : ox + wb], inwin, rows, cols, d_box, k.values,
                                      k.total)
    ch = {(int(y), int(x)) for y, x in changed.nonzero().tolist()}
    assert got["changed_pixels"] == len(ch)
    x_values = {(y + dy, x) for y, x in ch for dy in range(-r, r + 1) if 0 <= y + dy < hb}
    read = {(y, x + dx) for y, x in x_values for dx in range(-r, r + 1) if 0 <= x + dx < wb} | ch
    d0, d1, d2, d3 = (int(v) for v in d_box)
    tested = {(y, x) for y in range(hb) for x in range(wb) if d0 - r <= y <= d2 + r and d1 - r <= x <= d3 + r
              and bool(inwin[y, x])}
    at = lambda px: [(oy + y, ox + x) for y, x in px]  # noqa: E731
    want = (_sectors(at(read), packed.shape[1], 4) + _sectors(at(tested), BLUR_FW, 4)
            + _sectors(at(ch), BLUR_FW, 16)) * 32
    assert got["bytes"] == want
    assert got["operations"] == 2 * 4 * (2 * r + 1) * (len(x_values) + len(ch))


def test_shatter_bound_matches_a_brute_count():
    """shatter_bound: every listed piece written whole, each raster pixel
    under a piece read once (16 bytes), counted pixel by pixel."""
    from test_torch_cuda import shatter_case

    _, rgba, oys, oxs, _ = shatter_case(0)
    hs, ws = rgba.shape[:2]
    got = chip_smoke.shatter_bound(torch, torch.from_numpy(rgba), oys, oxs)
    covered = {(y, x) for oy, ox in zip(oys.tolist(), oxs.tolist()) for y in range(max(0, oy), min(hs, oy + 64))
               for x in range(max(0, ox), min(ws, ox + 128))}
    assert got["pieces"] == len(oys)
    assert got["bytes"] == len(oys) * 64 * 128 * 4 + _sectors(covered, ws, 16) * 32


def _brute_smear(opac, offsets, dirs):
    """(pixels read before the walk writes them, pixels written, mixed
    texel-steps) of the smear's two passes, texel by texel: a texel of
    al == 255 reads nothing, one of al == 0 its source, any other its
    source and its destination; every step reads before it writes."""
    bh, bw = opac.shape
    read, written, mixed = set(), set(), 0
    for _ in range(2):
        for (r, c), (dx, dy) in zip(offsets, dirs):
            step_writes = set()
            for i in range(bh):
                for j in range(bw):
                    al = int(opac[i, j])
                    if al == 255:
                        continue
                    wanted = [(r - dy + i, c - dx + j)] + ([(r + i, c + j)] if al else [])
                    read |= {px for px in wanted if px not in written}
                    step_writes.add((r + i, c + j))
                    mixed += al != 0
            written |= step_writes
    return read, written, mixed


@pytest.mark.parametrize("radius", [1.0, 12.0, 15.0])
def test_smear_bound_matches_a_brute_count(radius):
    """smear_bound: each pixel read before the walk writes it and each
    pixel written, 16 bytes once; the mixed texels' operations; and the
    step-by-step traffic of the union of source and destination."""
    from test_torch_cuda import smear_case

    canvas, opac, offsets, dirs = smear_case(radius, n=20)
    got = chip_smoke.smear_bound(opac, offsets, dirs, *canvas.shape[:2])
    read, written, mixed = _brute_smear(opac, offsets, dirs)
    bh, bw = opac.shape
    assert got["bytes"] == 16 * (len(read) + len(written))
    assert got["operations"] == chip_smoke.SMEAR_OPS * 4 * mixed
    assert got["serial_steps"] == 2 * len(offsets)
    assert got["step_bytes"] == 2 * 16 * sum((bh + abs(dy)) * (bw + abs(dx)) + bh * bw for dx, dy in dirs)
    assert got["bytes"] < got["step_bytes"]


@pytest.mark.parametrize("radius", [1.0, 12.0])
def test_smear_bound_reads_all_the_walk_needs(radius):
    """The pixels the brute count leaves unread do not change the walk's
    result, and those it leaves unwritten keep their values: changing every
    other pixel of the canvas changes only them."""
    from test_torch_cuda import smear_case

    from coherence_tpu_torch.raster import brush as TB

    canvas, opac, offsets, dirs = smear_case(radius, n=20)
    read, written, _ = _brute_smear(opac, offsets, dirs)
    bh, bw = opac.shape
    other = np.ones(canvas.shape[:2], bool)
    other[tuple(np.array(sorted(read)).T)] = False
    changed = canvas.copy()
    changed[other] = 255 - changed[other]
    walk = [TB._smear_walk_torch(torch.from_numpy(cv.copy()), torch.from_numpy(opac), offsets, dirs, bh, bw).numpy()
            for cv in (canvas, changed)]
    mask = np.zeros(canvas.shape[:2], bool)
    mask[tuple(np.array(sorted(written)).T)] = True
    assert np.array_equal(walk[0][mask], walk[1][mask])
    assert np.array_equal(walk[0][~mask], canvas[~mask]) and np.array_equal(walk[1][~mask], changed[~mask])
    assert other.any() and (other & mask).any()


@pytest.mark.parametrize("radius", [1.0, 12.0, 15.0])
def test_smear_chain_floor_matches_a_brute_count(radius):
    """smear_bound's chain_floor_ms: every serial step's mixed-texel int32
    operations (SMEAR_OPS a channel, counted texel by texel) at one SM's
    share of the int32 rate: the least time a walk on one block can take."""
    from test_torch_cuda import smear_case

    canvas, opac, offsets, dirs = smear_case(radius, n=20)
    got = chip_smoke.smear_bound(opac, offsets, dirs, *canvas.shape[:2])
    _, _, mixed = _brute_smear(opac, offsets, dirs)
    assert chip_smoke.SMS == 132
    want = chip_smoke.SMEAR_OPS * 4 * mixed / (chip_smoke.INT_OPS_PER_S / 132) * 1e3
    assert got["chain_floor_ms"] == pytest.approx(want, rel=1e-12)
    assert got["chain_floor_ms"] > got["bound_ms"]


def test_smear_chain_floor_at_the_demo(monkeypatch):
    """At profile_general.py's smear program (1024 steps of a 31x31 patch,
    two passes: the walk that chip_smoke.py times) the chain floor is 0.311
    ms, 132 times the operations' share of the bound."""
    import profile_general

    from coherence_tpu_torch.raster import brush as TB

    calls = []

    def recorded(cv, opac, offsets, dirs, bh, bw):
        calls.append((cv.shape[:2], opac.numpy(), offsets, dirs, bh, bw))
        return cv

    monkeypatch.setattr(TB, "_smear_walk", recorded)
    profile_general.programs(torch, "cpu")["smear"][2]()
    (height, width), opac, offsets, dirs, bh, bw = calls[0]
    got = chip_smoke.smear_bound(opac, offsets, dirs, height, width)
    assert (bh, bw, len(offsets), got["serial_steps"]) == (31, 31, 1024, 2048)
    assert got["operations"] == 78_938_112 and got["bound_by"] == "operations"
    assert got["chain_floor_ms"] == pytest.approx(0.3110397, abs=1e-6)
    assert got["chain_floor_ms"] == pytest.approx(chip_smoke.SMS * got["bound_ms"], rel=1e-12)


def _brute_t_mask(box, scaled) -> np.ndarray:
    """A matte's whole t-plane (16 h + 16, 16 w + 16) as the scatter makes
    it: rows off the plane dropped, columns clipped, a running count > 0."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0 + 1, y1 - y0 + 1
    th, tw = 16 * h + 16, 16 * w + 16
    diff = np.zeros((th, tw + 1), np.int64)
    if scaled is not None:
        rows, ss, ee = (np.asarray(a, np.int64) for a in scaled)
        r = rows - (16 * y0 - 32)
        keep = (r >= 0) & (r < th)
        np.add.at(diff, (r[keep], np.clip(ss[keep] - (16 * x0 - 32), 0, tw)), 1)
        np.add.at(diff, (r[keep], np.clip(ee[keep] + 1 - (16 * x0 - 32), 0, tw)), -1)
    return np.cumsum(diff, axis=1)[:, :tw] > 0


@pytest.mark.parametrize("name", ["wide", "odd", "pixel", "empty", "circle"])
def test_mixed_pixels_match_a_brute_count(name):
    """mixed_pixels counts the pixels whose 32 x 32 footprint holds set and
    clear samples both, footprint by footprint."""
    from test_torch_cuda import sprite_opacity_case

    box, scaled = sprite_opacity_case(name)
    t = _brute_t_mask(box, scaled)
    x0, y0, x1, y1 = box
    mixed = sum(0 < int(t[16 * y : 16 * y + 32, 16 * x : 16 * x + 32].sum()) < 1024
                for y in range(y1 - y0 + 1) for x in range(x1 - x0 + 1))
    assert chip_smoke.mixed_pixels(torch, box, scaled, "cpu") == mixed
    assert name == "empty" or mixed > 0


@pytest.mark.parametrize("name", ["ragged", "heavy", "tall"])
def test_sprite_span_reads_match_a_brute_count(name):
    """sprite_span_reads counts, unit by unit, the spans on its band's rows
    of its member's three families: a 1x band's 16 rows, an AA band's 272
    t-rows (those of its plane only)."""
    from coherence_tpu_torch import kernels
    from test_torch_cuda import sprite_case

    boxes, fills, cov, cross, aa = sprite_case(name)
    lists = kernels.sprite_raster_lists(boxes, fills, cov, cross, aa)
    brute = 0
    for m, b, _, _ in lists.units.tolist():
        x0, y0, w, h = boxes[m]
        for fam, r0, height, first, n in ((cov, y0, h, 16 * b, 16), (cross, y0, h, 16 * b, 16),
                                          (aa, 16 * y0 - 32, 16 * h + 16, 256 * b, 272)):
            if fam[m] is not None:
                r = np.asarray(fam[m][0], np.int64) - r0
                brute += int(((r >= first) & (r < first + n) & (r < height)).sum())
    assert chip_smoke.sprite_span_reads(lists) == brute > 0


def test_sprite_bound_counts_the_mixed_pixels_of_a_matte():
    """In opacity mode the bound counts the multiply-adds at the mixed
    pixels alone, and bound_all_pixels_ms at every pixel beside it; group
    mode counts its fringe."""
    from coherence_tpu_torch import kernels
    from test_torch_cuda import sprite_opacity_case

    box, scaled = sprite_opacity_case("circle")
    lists = kernels.sprite_opacity_lists(box, scaled)
    pixels = int(lists.members[0, 0]) * int(lists.members[0, 1])
    mixed = chip_smoke.mixed_pixels(torch, box, scaled, "cpu")
    got = chip_smoke.sprite_bound(lists, pixels, mixed)
    list_ms = (got["list_bytes"] + 4 * pixels) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert got["operations"] == 2 * 1024 * mixed and got["mixed_pixels"] == mixed < pixels
    assert got["bound_ms"] == max(list_ms, 2048 * mixed / chip_smoke.INT_OPS_PER_S * 1e3)
    assert got["bound_all_pixels_ms"] == max(list_ms, 2048 * pixels / chip_smoke.INT_OPS_PER_S * 1e3)
    assert got["list_bytes"] == sum(a.nbytes for a in (lists.spans, lists.bands, lists.fills, lists.members,
                                                       lists.units))


def _views():
    """name -> a view of a CPU tensor for tensor_sectors: contiguous at an
    offset, a window of a canvas, every other column, an expanded colour
    and mask row, a transposed mask."""
    rgba = torch.arange(23 * 41 * 4, dtype=torch.int32).reshape(23, 41, 4)
    mask = torch.ones((31, 77), dtype=torch.bool)
    return {"contiguous": rgba[3:9], "window": rgba[2:17, 5:30], "columns": rgba[:, ::2], "rgba_expanded":
            rgba[0, 0].expand(9, 11, 4), "mask_window": mask[4:20, 3:70], "mask_expanded": mask[0].expand(6, 77),
            "mask_transposed": mask.t(), "mask_one": mask[5:6, 7:8]}


@pytest.mark.parametrize("name", list(_views()))
def test_tensor_sectors_match_a_brute_count(name):
    """region_bound's read bytes: the 32-byte sectors of a view's elements,
    each element's bytes counted at its address, repeated ones once."""
    t = _views()[name]
    sectors = set()
    for idx in np.ndindex(*t.shape):
        first = t.data_ptr() + sum(i * s for i, s in zip(idx, t.stride())) * t.element_size()
        sectors.update(range(first // 32, (first + t.element_size() - 1) // 32 + 1))
    assert chip_smoke.tensor_sectors(torch, t) == len(sectors)


def test_region_bound_adds_reads_writes_and_operations():
    """region_bound: the reads' sectors, the writes' bytes, over the
    memory rate; the operations over the int32 rate; the larger."""
    views = _views()
    row = chip_smoke.region_bound(torch, [views["window"], views["mask_window"]], 1000)
    want = (chip_smoke.tensor_sectors(torch, views["window"]) + chip_smoke.tensor_sectors(torch, views["mask_window"])) * 32
    assert row["bytes"] == want + 1000 and row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(row["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3)
    row = chip_smoke.region_bound(torch, [views["mask_one"]], 0, ops=10**9)
    assert row["bound_by"] == "operations" and row["bound_ms"] == pytest.approx(1e9 / chip_smoke.INT_OPS_PER_S * 1e3)
