"""chip_smoke.py's byte counts against a brute-force count.

Every share of the bound that chip_smoke.py prints rests on three
functions: walked_depths (the pieces each 32-byte sector of a tile walks
through an atlas list), layer_walk (the same for a dense layer stack) and
bound (the bytes those walks must move).  Here each is held, on small random
atlases and stacks made from a seed with numpy, to a count written out pixel
by pixel: a sector reads a layer while any of its 8 pixels is still
translucent, reads its background if one still is after the walk, and is
written once.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

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
