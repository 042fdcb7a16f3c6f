"""The hand-written CUDA compositors against their plain PyTorch versions,
on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels are
compiled from ``coherence_tpu_torch/kernels/csrc`` at first use), so they
carry the ``cuda`` marker and skip elsewhere.  This file imports no JAX: on
a machine with a card and no JAX, run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The random compositor cases and the striped walk's edge cases below are
shared with the CPU comparisons against the JAX package
(tests/test_torch_tiled_scene.py, tests/test_torch_runs.py).  Every
comparison is bit for bit (tolerance 0): the compositor is integer math.
"""

import numpy as np
import pytest
import torch

from coherence_tpu_torch import convert, kernels
from coherence_tpu_torch.raster import compositor as PC
from coherence_tpu_torch.raster import tiled_scene as T
from coherence_tpu_torch.raster.compositor import TILE_H, TILE_W
from coherence_tpu_torch.scene import examples


def _pow2(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def random_atlas(rng, cap: int) -> np.ndarray:
    """(cap, TILE_H, TILE_W) uint32 premultiplied pieces: every fourth slot
    opaque, the others translucent, sparse (alpha 0 on about half the
    pixels) or mixed."""
    alpha = rng.integers(0, 256, (cap, TILE_H, TILE_W))
    alpha[0::4] = 255
    alpha[1::4] = rng.integers(1, 255, (len(range(1, cap, 4)), TILE_H, TILE_W))
    sparse = alpha[2::4]
    sparse[rng.random(sparse.shape) < 0.5] = 0
    rgb = (rng.random((cap, TILE_H, TILE_W, 3)) * (alpha[..., None] + 1)).astype(np.int64)
    rgb = np.minimum(rgb, alpha[..., None])
    return (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (alpha << 24)).astype(np.uint32)


def random_plane(rng, ph: int, pw: int) -> np.ndarray:
    """(ph, pw) uint32 plane of arbitrary words (alpha >= 128 included)."""
    return rng.integers(0, 2**32, (ph, pw), dtype=np.uint64).astype(np.uint32)


def composite_case(seed: int, nty: int = 4, ntx: int = 4, cap: int = 64):
    """A full-frame case: (atlas, background, starts, idxs).  Per-tile
    depths run 0..12; tile 0 is empty, tile 1 holds 12 pieces with an
    opaque one third (the stack turns opaque early), tile 2 holds 9.
    idxs is zero-padded to a pow2 no smaller than `cap`, as the scene's
    build_lists pads it."""
    rng = np.random.default_rng(seed)
    n_tiles = nty * ntx
    atlas = random_atlas(rng, cap)
    depth = rng.integers(0, 13, n_tiles)
    depth[0], depth[1], depth[2] = 0, 12, 9
    per_tile = [list(rng.integers(0, cap, d)) for d in depth]
    per_tile[1][2] = 4  # slot 4 is opaque (every fourth slot is)
    starts = np.zeros(n_tiles + 1, np.int32)
    starts[1:] = np.cumsum(depth)
    idxs = np.zeros(max(_pow2(int(starts[-1])), cap), np.int32)
    idxs[: starts[-1]] = [e for p in per_tile for e in p]
    return atlas, random_plane(rng, nty * TILE_H, ntx * TILE_W), starts, idxs


def dirty_case(seed: int, nty: int = 4, ntx: int = 4, cap: int = 64, n_real: int = 6):
    """A dirty-tile case: (atlas, background, frame, coords, spans, idxs,
    n_slots).  Slot 2 is a passthrough slot (span -1) for a tile no other
    slot lists; one slot has an empty list; padding slots repeat the last
    real slot, as the scene's _dirty_args pads them."""
    rng = np.random.default_rng(seed)
    atlas = random_atlas(rng, cap)
    tiles = rng.permutation(nty * ntx)[: n_real]
    n_slots = _pow2(n_real)
    coords = np.zeros(2 * n_slots, np.int32)
    spans = np.zeros(2 * n_slots, np.int32)
    flat = []
    for j, t in enumerate(tiles):
        coords[2 * j], coords[2 * j + 1] = t // ntx, t % ntx
        if j == 2:
            spans[2 * j] = spans[2 * j + 1] = -1
            continue
        depth = 0 if j == 1 else int(rng.integers(1, 13))
        spans[2 * j] = len(flat)
        flat.extend(int(v) for v in rng.integers(0, cap, depth))
        spans[2 * j + 1] = len(flat)
    n = n_real
    coords[2 * n :: 2], coords[2 * n + 1 :: 2] = coords[2 * n - 2], coords[2 * n - 1]
    spans[2 * n :: 2], spans[2 * n + 1 :: 2] = spans[2 * n - 2], spans[2 * n - 1]
    idxs = np.zeros(_pow2(len(flat)), np.int32)
    idxs[: len(flat)] = flat
    ph, pw = nty * TILE_H, ntx * TILE_W
    return atlas, random_plane(rng, ph, pw), random_plane(rng, ph, pw), coords, spans, idxs, n_slots


def layer_stack(rng, k: int, nty: int, ntx: int, opaque_top: bool = False) -> np.ndarray:
    """(k, ph, pw) uint32 packed premultiplied layers: random rectangles of
    opaque, translucent and sparse pixels, zero elsewhere."""
    ph, pw = nty * TILE_H, ntx * TILE_W
    out = np.zeros((k, ph, pw), np.uint32)
    for j in range(k):
        piece = random_atlas(rng, 4)[j % 4]
        y0, x0 = int(rng.integers(0, ph)), int(rng.integers(0, pw))
        h, w = int(rng.integers(1, ph - y0 + 1)), int(rng.integers(1, pw - x0 + 1))
        out[j, y0 : y0 + h, x0 : x0 + w] = np.resize(piece, (h, w))
    if opaque_top:
        out[0] = random_atlas(rng, 1)[0, np.arange(ph) % TILE_H][:, np.arange(pw) % TILE_W]
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile compositor kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,nty,ntx", [(0, 4, 4), (1, 4, 4), (2, 3, 7), (3, 17, 15)])
def test_composite_full_kernel_matches_plain(cuda_device, seed, nty, ntx):
    atlas, bg, starts, idxs = composite_case(seed, nty, ntx)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    before = kernels.launches["composite_full"]
    got = T.composite_full(s, i, b, a, nty, ntx)
    assert kernels.launches["composite_full"] == before + 1
    want = T.composite_full_torch(s, i, b, a, nty, ntx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # The CPU plain version on the same inputs.
    cpu = T.composite_full(s.cpu(), i.cpu(), b.cpu(), a.cpu(), nty, ntx)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_real", [(0, 6), (1, 8), (2, 9), (3, 16)])
def test_composite_dirty_kernel_matches_plain(cuda_device, seed, n_real):
    atlas, bg, frame, coords, spans, idxs, n_slots = dirty_case(seed, n_real=n_real)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    f = convert.packed(frame, cuda_device)
    c, sp, i = _ints((coords, spans, idxs), cuda_device)
    got, want = f.clone(), f.clone()
    before = kernels.launches["composite_dirty"]
    T.composite_dirty(c, sp, i, b, got, a, n_slots)
    assert kernels.launches["composite_dirty"] == before + 1
    T.composite_dirty_torch(c, sp, i, b, want, a, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ty, tx = int(coords[4]), int(coords[5])  # slot 2: passthrough
    tile = (slice(ty * TILE_H, (ty + 1) * TILE_H), slice(tx * TILE_W, (tx + 1) * TILE_W))
    assert torch.equal(got[tile], f[tile])


def _ring_depth() -> int:
    """kStages of stripe_ring.cuh: the layers a stripe keeps in flight."""
    import os
    import re

    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "stripe_ring.cuh")
    with open(src) as f:
        return int(re.search(r"constexpr int kStages = (\d+);", f.read()).group(1))


def _faint_atlas(rng, cap: int) -> np.ndarray:
    """(cap, TILE_H, TILE_W) pieces of alpha 0..3: hundreds of them stacked
    stay translucent, so a walk over them never stops early."""
    alpha = rng.integers(0, 4, (cap, TILE_H, TILE_W))
    rgb = np.minimum(rng.integers(0, 256, (cap, TILE_H, TILE_W, 3)), alpha[..., None])
    return (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (alpha << 24)).astype(np.uint32)


def _banded_piece(rng, rows: slice, cols: slice, alpha: int) -> np.ndarray:
    """A piece covering only rows x cols, at `alpha` (255: opaque there)."""
    piece = np.zeros((TILE_H, TILE_W), np.uint32)
    h, w = rows.stop - rows.start, cols.stop - cols.start
    rgb = rng.integers(0, alpha + 1, (h, w, 3))
    piece[rows, cols] = (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (alpha << 24)).astype(np.uint32)
    return piece


def stripe_case(name: str, seed: int = 0):
    """(atlas, background, per-tile lists) for the striped walk's edges:
    one tile per list, in a one-row frame."""
    rng = np.random.default_rng(seed)
    ring = _ring_depth()
    if name in ("deep_300", "deep_past_index_cap"):
        n = 300 if name == "deep_300" else 1100  # past the 1024 indices staged in shared memory
        atlas = _faint_atlas(rng, 64)
        return atlas, [list(rng.integers(0, 64, n)), list(rng.integers(0, 64, 7))]
    atlas = random_atlas(rng, 64)  # every fourth slot opaque
    translucent = [k for k in range(64) if k % 4 == 1]
    if name == "empty_and_one":
        return atlas, [[], [5], []]
    if name == "ring_plus_one":
        return atlas, [list(rng.choice(translucent, ring + 1)), list(rng.choice(translucent, ring))]
    if name == "opaque_first":
        return atlas, [[8] + list(rng.choice(translucent, 2 * ring + 3)), [4, 12, 16]]
    if name == "stripe_boundary":
        # Partial coverage across stripe borders (rows 4, 8, 32, 36, ...)
        # and down the tile: an opaque band over rows 5..11, translucent
        # bands over rows 0..9 and 30..40, then pieces that show only where
        # the bands leave rows open.
        extra = np.stack([_banded_piece(rng, slice(5, 12), slice(0, 128), 255),
                          _banded_piece(rng, slice(0, 10), slice(17, 90), 140),
                          _banded_piece(rng, slice(30, 41), slice(3, 128), 200),
                          _banded_piece(rng, slice(7, 9), slice(0, 128), 255)])
        atlas = np.concatenate([atlas, extra])
        return atlas, [[64, 65, 66, 1, 5, 0], [67, 66, 9, 13], [65, 67, 64, 0]]
    raise ValueError(name)


STRIPE_CASES = ["empty_and_one", "ring_plus_one", "opaque_first", "stripe_boundary", "deep_300",
                "deep_past_index_cap"]


def stripe_slots(lists):
    """(starts, idxs, coords, spans, n_slots, n_real) for a one-row frame of
    len(lists) + 1 tiles: tile j lists lists[j], and the last tile is the
    dirty list's passthrough slot; the padding slots after it repeat the
    last real slot."""
    ntx = len(lists) + 1
    starts = np.zeros(ntx + 1, np.int32)
    starts[1 : len(lists) + 1] = np.cumsum([len(p) for p in lists])
    starts[-1] = starts[-2]
    idxs = np.zeros(_pow2(max(int(starts[-1]), 1)), np.int32)
    idxs[: starts[-1]] = [e for p in lists for e in p]
    n_slots = _pow2(ntx)
    coords = np.zeros(2 * n_slots, np.int32)
    spans = np.zeros(2 * n_slots, np.int32)
    coords[1 : 2 * ntx : 2] = np.arange(ntx)
    spans[0 : 2 * ntx : 2], spans[1 : 2 * ntx : 2] = starts[:-1], starts[1:]
    spans[2 * len(lists) : 2 * ntx] = -1
    real = 2 * len(lists)
    coords[2 * ntx :: 2], coords[2 * ntx + 1 :: 2] = coords[real - 2], coords[real - 1]
    spans[2 * ntx :: 2], spans[2 * ntx + 1 :: 2] = spans[real - 2], spans[real - 1]
    return starts, idxs, coords, spans, n_slots, len(lists)


def banded_stripe_stack(name: str):
    """A stack of three one-row bands at the edges of the striped ring walk:
    band 0 lists the case's tiles (stripe_slots: the last tile empty), band
    1 lists nothing, band 2 lists the case's tiles in reverse order.
    Returns (atlas (3, cap, TILE_H, TILE_W), background (3 * TILE_H, ntx *
    TILE_W), starts (3, ntx + 1), idxs (3, width)), each band's idxs
    zero-padded to the widest."""
    atlas, lists = stripe_case(name)
    ntx = len(lists) + 1
    (s0, i0), (s2, i2) = stripe_slots(lists)[:2], stripe_slots(lists[::-1])[:2]
    idxs = np.zeros((3, max(i0.shape[0], i2.shape[0])), np.int32)
    idxs[0, : i0.shape[0]], idxs[2, : i2.shape[0]] = i0, i2
    starts = np.stack([s0, np.zeros(ntx + 1, np.int32), s2])
    rng = np.random.default_rng(4)
    atlases = np.stack([atlas, random_atlas(rng, atlas.shape[0]), atlas])
    return atlases, random_plane(rng, 3 * TILE_H, ntx * TILE_W), starts, idxs


@pytest.mark.cuda
@pytest.mark.parametrize("name", STRIPE_CASES)
def test_striped_runs_match_plain(cuda_device, name):
    """composite_runs at the edges of the striped ring walk, over the runs
    gathered from the case's lists: against its plain version and against
    composite_full on the same lists."""
    atlas, lists = stripe_case(name)
    starts, idxs = stripe_slots(lists)[:2]
    ntx = len(lists) + 1
    a = convert.packed(atlas, cuda_device)
    b = convert.packed(random_plane(np.random.default_rng(1), TILE_H, ntx * TILE_W), cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    runs = T.gather_runs(a, i)
    before = kernels.launches["composite_runs"]
    got = T.composite_runs(s, b, runs, 1, ntx)
    assert kernels.launches["composite_runs"] == before + 1
    want = T.composite_runs_torch(s, b, runs, 1, ntx)
    full = T.composite_full(s, i, b, a, 1, ntx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, full)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bands", [1, 3])
@pytest.mark.parametrize("name", STRIPE_CASES)
def test_striped_banded_full_matches_plain(cuda_device, name, n_bands):
    """composite_full_banded at the edges of the striped ring walk, over
    the first `n_bands` bands of banded_stripe_stack: against its plain
    version and against composite_full on each band's lists; every empty
    tile, and so the empty band 1 whole, keeps its background unchanged."""
    atlas, bg, starts, idxs = banded_stripe_stack(name)
    ntx = starts.shape[1] - 1
    a = convert.packed(atlas[:n_bands], cuda_device)
    b = convert.packed(bg[: n_bands * TILE_H], cuda_device)
    s, i = _ints((starts[:n_bands], idxs[:n_bands]), cuda_device)
    before = kernels.launches["composite_full_banded"]
    got = T.composite_full_banded(s, i, b, a, 1, ntx)
    assert kernels.launches["composite_full_banded"] == before + 1
    want = T.composite_full_banded_torch(s, i, b, a, 1, ntx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in range(n_bands):
        rows = slice(k * TILE_H, (k + 1) * TILE_H)
        one = T.composite_full(s[k].clone(), i[k].clone(), b[rows].clone(), a[k].clone(), 1, ntx)
        assert torch.equal(got[rows], one), k
        for t in np.flatnonzero(starts[k, :-1] == starts[k, 1:]).tolist():
            cols = slice(t * TILE_W, (t + 1) * TILE_W)
            assert torch.equal(got[rows, cols], b[rows, cols]), f"empty tile {t} of band {k} changed"


@pytest.mark.cuda
@pytest.mark.parametrize("name", STRIPE_CASES)
def test_striped_kernels_match_plain(cuda_device, name):
    """composite_full and composite_dirty (each slot padded out by
    repeating the last real slot, one passthrough slot) against their plain
    versions at the edges of the striped ring walk."""
    atlas, lists = stripe_case(name)
    starts, idxs, coords, spans, n_slots, n_real = stripe_slots(lists)
    ntx = len(lists) + 1
    rng = np.random.default_rng(1)
    a = convert.packed(atlas, cuda_device)
    b = convert.packed(random_plane(rng, TILE_H, ntx * TILE_W), cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    got = T.composite_full(s, i, b, a, 1, ntx)
    assert torch.equal(got, T.composite_full_torch(s, i, b, a, 1, ntx))
    f = convert.packed(random_plane(rng, TILE_H, ntx * TILE_W), cuda_device)
    c, sp = _ints((coords, spans), cuda_device)
    k, p = f.clone(), f.clone()
    T.composite_dirty(c, sp, i, b, k, a, n_slots)
    T.composite_dirty_torch(c, sp, i, b, p, a, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert torch.equal(k[:, : n_real * TILE_W], got[:, : n_real * TILE_W])
    assert torch.equal(k[:, n_real * TILE_W :], f[:, n_real * TILE_W :]), "the passthrough tile changed"


@pytest.mark.cuda
@pytest.mark.parametrize("name", STRIPE_CASES)
def test_striped_banded_dirty_matches_plain(cuda_device, name):
    """composite_dirty_banded over 3 one-row bands at the edges of the
    striped ring walk: band 0 lists the case's tiles, band 1 is idle (every
    slot passthrough), band 2 lists them in reverse order; each band has a
    passthrough slot and padding slots repeating its last real slot."""
    atlas, lists = stripe_case(name)
    ntx = len(lists) + 1
    band0, band2 = stripe_slots(lists), stripe_slots(lists[::-1])
    n_slots = band0[4]
    width = max(band0[1].shape[0], band2[1].shape[0])
    idxs = np.zeros((3, width), np.int32)
    idxs[0, : band0[1].shape[0]], idxs[2, : band2[1].shape[0]] = band0[1], band2[1]
    coords = np.stack([band0[2], np.zeros(2 * n_slots, np.int32), band2[2]])
    spans = np.stack([band0[3], np.full(2 * n_slots, -1, np.int32), band2[3]])
    rng = np.random.default_rng(2)
    a = convert.packed(np.stack([atlas, random_atlas(rng, atlas.shape[0]), atlas]), cuda_device)
    b = convert.packed(random_plane(rng, 3 * TILE_H, ntx * TILE_W), cuda_device)
    f = convert.packed(random_plane(rng, 3 * TILE_H, ntx * TILE_W), cuda_device)
    c, sp, i = _ints((coords, spans, idxs), cuda_device)
    got, want = f.clone(), f.clone()
    before = kernels.launches["composite_dirty_banded"]
    T.composite_dirty_banded(c, sp, i, b, got, a, n_slots)
    assert kernels.launches["composite_dirty_banded"] == before + 1
    T.composite_dirty_banded_torch(c, sp, i, b, want, a, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[TILE_H : 2 * TILE_H], f[TILE_H : 2 * TILE_H]), "the idle band changed"
    for k in (0, 2):
        rows = slice(k * TILE_H, (k + 1) * TILE_H)
        one = f[rows].clone()
        T.composite_dirty(c[k].clone(), sp[k].clone(), i[k].clone(), b[rows].clone(), one, a[k].clone(), n_slots)
        assert torch.equal(got[rows], one), k


@pytest.mark.cuda
def test_composite_dirty_all_passthrough_leaves_the_frame(cuda_device):
    atlas, bg, frame, coords, spans, idxs, n_slots = dirty_case(0)
    spans[:] = -1
    a, b, f = (convert.packed(x, cuda_device) for x in (atlas, bg, frame))
    c, sp, i = _ints((coords, spans, idxs), cuda_device)
    got = f.clone()
    T.composite_dirty(c, sp, i, b, got, a, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(got, f)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_tensors(cuda_device):
    atlas, bg, starts, idxs = composite_case(0)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    with pytest.raises(ValueError):
        kernels.composite_full(s.long(), i, b, a, 4, 4)
    with pytest.raises(ValueError):
        kernels.composite_full(s, i, b.t(), a, 4, 4)
    with pytest.raises(ValueError):
        kernels.composite_full(s, i, b, a, 4, 5)
    with pytest.raises(ValueError):
        kernels.composite_full(s.cpu(), i, b, a, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,nty,ntx", [(0, 4, 4), (1, 3, 7), (2, 17, 15), (3, 34, 30)])
def test_composite_runs_kernel_matches_plain(cuda_device, seed, nty, ntx):
    atlas, bg, starts, idxs = composite_case(seed, nty, ntx)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    runs = T.gather_runs(a, i)
    before = kernels.launches["composite_runs"]
    got = T.composite_runs(s, b, runs, nty, ntx)
    assert kernels.launches["composite_runs"] == before + 1
    want = T.composite_runs_torch(s, b, runs, nty, ntx)
    full = T.composite_full(s, i, b, a, nty, ntx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, full)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,nty,ntx,opaque_top", [
    (0, 1, 1, 1, False), (1, 5, 2, 2, False), (2, 13, 5, 3, False), (3, 9, 4, 4, True),
])
def test_composite_layers_kernel_matches_plain(cuda_device, seed, k, nty, ntx, opaque_top):
    rng = np.random.default_rng(seed)
    layers = convert.layers(layer_stack(rng, k, nty, ntx, opaque_top), cuda_device)
    bg = convert.packed(random_plane(rng, nty * TILE_H, ntx * TILE_W), cuda_device)
    before = kernels.launches["composite_layers"]
    got = PC.composite_layers(bg, layers)
    assert kernels.launches["composite_layers"] == before + 1
    want = PC.composite_layers_torch(bg, layers)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if opaque_top:
        assert torch.equal(got, layers[0])


@pytest.mark.cuda
def test_composite_layers_kernel_on_the_config2_stack(cuda_device):
    layers = examples.hsr_layers(100, 1088, 1920, device=cuda_device)
    white = torch.full((1088, 1920), -1, dtype=torch.int32, device=cuda_device)
    got = PC.composite_layers(white, layers)
    want = PC.composite_layers_torch(white, layers)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _plane_layer(rng, ph: int, pw: int, alpha_lo: int, alpha_hi: int, rows=None) -> np.ndarray:
    """(ph, pw) uint32 premultiplied layer of alpha alpha_lo..alpha_hi,
    covering only `rows` of every tile (all rows when None)."""
    alpha = rng.integers(alpha_lo, alpha_hi + 1, (ph, pw))
    rgb = np.minimum(rng.integers(0, 256, (ph, pw, 3)), alpha[..., None])
    out = (rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16) | (alpha << 24)).astype(np.uint32)
    if rows is not None:
        out[(np.arange(ph) % TILE_H < rows.start) | (np.arange(ph) % TILE_H >= rows.stop)] = 0
    return out


def layer_ring_case(name: str, nty: int = 2, ntx: int = 2) -> np.ndarray:
    """(K, ph, pw) uint32 stacks at the edges of the striped ring walk."""
    rng = np.random.default_rng(7)
    ph, pw = nty * TILE_H, ntx * TILE_W
    ring = _ring_depth()
    if name == "no_layers":
        return np.zeros((0, ph, pw), np.uint32)
    if name == "one_layer":
        return _plane_layer(rng, ph, pw, 0, 255)[None]
    if name == "ring_plus_one":
        return np.stack([_plane_layer(rng, ph, pw, 1, 200) for _ in range(ring + 1)])
    if name == "faint_301":
        return np.stack([_plane_layer(rng, ph, pw, 0, 3) for _ in range(301)])
    if name == "opaque_rows_5_11":
        # Rows 5..11 of every tile turn opaque at layer 1: stripe 2 (rows
        # 8..11) stops there, stripe 1 (rows 4..7) keeps row 4 open; every
        # stripe stops at the full opaque layer ring + 3, with layers after it.
        stack = [_plane_layer(rng, ph, pw, 1, 254), _plane_layer(rng, ph, pw, 255, 255, slice(5, 12))]
        stack += [_plane_layer(rng, ph, pw, 0, 200) for _ in range(ring + 1)]
        stack += [_plane_layer(rng, ph, pw, 255, 255)] + [_plane_layer(rng, ph, pw, 0, 255) for _ in range(3)]
        return np.stack(stack)
    raise ValueError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["no_layers", "one_layer", "ring_plus_one", "faint_301", "opaque_rows_5_11"])
def test_composite_layers_ring_edges_match_plain(cuda_device, name):
    """composite_layers against its plain version at the edges of the
    striped ring walk: K = 0 (the background over zero), K = 1, a stack one
    deeper than the ring, 301 faint layers, and stripes that stop at
    different depths."""
    stack = layer_ring_case(name)
    layers = convert.layers(stack, cuda_device)
    bg = convert.packed(random_plane(np.random.default_rng(8), stack.shape[1], stack.shape[2]), cuda_device)
    before = kernels.launches["composite_layers"]
    got = PC.composite_layers(bg, layers)
    assert kernels.launches["composite_layers"] == before + 1
    want = PC.composite_layers_torch(bg, layers)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if name == "no_layers":
        assert torch.equal(got, bg)


@pytest.mark.cuda
def test_new_kernel_wrappers_reject_bad_tensors(cuda_device):
    atlas, bg, starts, idxs = composite_case(0)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    runs = T.gather_runs(a, i)
    with pytest.raises(ValueError):
        kernels.composite_runs(s, b, runs, 4, 5)
    with pytest.raises(ValueError):
        kernels.composite_runs(s.cpu(), b, runs, 4, 4)
    layers = a[:3].reshape(3, TILE_H, TILE_W)
    with pytest.raises(ValueError):
        kernels.composite_layers(b, layers)  # background of another size
    with pytest.raises(ValueError):
        kernels.composite_layers(b[:TILE_H, :TILE_W], layers.long())


def banded_full_case(seed: int, n_bands: int = 3, band_ty: int = 2, ntx: int = 5, cap: int = 64):
    """A band stack for one device: composite_case per band, stacked as the
    mesh path stacks them: (atlas (n_bands, cap, TILE_H, TILE_W), background
    (n_bands * band_ty * TILE_H, ntx * TILE_W), starts (n_bands, band_ty *
    ntx + 1), idxs (n_bands, k)), each band's idxs zero-padded to the
    longest."""
    cases = [composite_case(seed * 10 + b, band_ty, ntx, cap) for b in range(n_bands)]
    idxs = np.zeros((n_bands, max(c[3].shape[0] for c in cases)), np.int32)
    for b, c in enumerate(cases):
        idxs[b, : c[3].shape[0]] = c[3]
    return (np.stack([c[0] for c in cases]), np.concatenate([c[1] for c in cases]),
            np.stack([c[2] for c in cases]), idxs)


def banded_dirty_case(seed: int, n_reals=(6, 8, 0, 5), nty: int = 4, ntx: int = 4, cap: int = 64):
    """A band stack of dirty lists: dirty_case per band (a passthrough slot,
    an empty list, padding slots repeating the last real slot), and an idle
    band (n_real 0: every span -1 on local tile (0, 0)), padded to one
    n_slots and one idxs width.  Returns (atlas, background, frame, coords,
    spans, idxs, n_slots)."""
    n_slots = max(_pow2(n) for n in n_reals)
    cases = []
    for b, n_real in enumerate(n_reals):
        if n_real == 0:
            rng = np.random.default_rng(seed * 10 + b)
            ph, pw = nty * TILE_H, ntx * TILE_W
            cases.append((random_atlas(rng, cap), random_plane(rng, ph, pw), random_plane(rng, ph, pw),
                          np.zeros(2 * n_slots, np.int32), np.full(2 * n_slots, -1, np.int32),
                          np.zeros(8, np.int32), n_slots))
            continue
        c = dirty_case(seed * 10 + b, nty, ntx, cap, n_real)
        coords, spans = np.empty(2 * n_slots, np.int32), np.empty(2 * n_slots, np.int32)
        coords[: len(c[3])], spans[: len(c[4])] = c[3], c[4]
        coords[len(c[3]) :: 2], coords[len(c[3]) + 1 :: 2] = c[3][-2], c[3][-1]
        spans[len(c[4]) :: 2], spans[len(c[4]) + 1 :: 2] = c[4][-2], c[4][-1]
        cases.append(c[:3] + (coords, spans, c[5], n_slots))
    idxs = np.zeros((len(n_reals), max(c[5].shape[0] for c in cases)), np.int32)
    for b, c in enumerate(cases):
        idxs[b, : c[5].shape[0]] = c[5]
    return (np.stack([c[0] for c in cases]), np.concatenate([c[1] for c in cases]),
            np.concatenate([c[2] for c in cases]), np.stack([c[3] for c in cases]),
            np.stack([c[4] for c in cases]), idxs, n_slots)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_bands,band_ty,ntx", [(0, 1, 1, 3), (1, 3, 2, 5), (2, 2, 17, 30), (3, 17, 1, 15)])
def test_composite_full_banded_kernel_matches_plain(cuda_device, seed, n_bands, band_ty, ntx):
    atlas, bg, starts, idxs = banded_full_case(seed, n_bands, band_ty, ntx)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    before = dict(kernels.launches)
    got = T.composite_full_banded(s, i, b, a, band_ty, ntx)
    assert kernels.launches["composite_full_banded"] == before["composite_full_banded"] + 1  # one launch
    want = T.composite_full_banded_torch(s, i, b, a, band_ty, ntx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # Each band equals the unbanded kernel on that band's lists and atlas.
    band_h = band_ty * TILE_H
    for k in range(n_bands):
        rows = slice(k * band_h, (k + 1) * band_h)
        one = T.composite_full(s[k].clone(), i[k].clone(), b[rows].clone(), a[k].clone(), band_ty, ntx)
        assert torch.equal(got[rows], one), k


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_reals", [(0, (6,)), (1, (6, 8, 0, 5)), (2, (0, 0)), (3, (16, 0, 9))])
def test_composite_dirty_banded_kernel_matches_plain(cuda_device, seed, n_reals):
    atlas, bg, frame, coords, spans, idxs, n_slots = banded_dirty_case(seed, n_reals)
    a, b, f = (convert.packed(x, cuda_device) for x in (atlas, bg, frame))
    c, sp, i = _ints((coords, spans, idxs), cuda_device)
    got, want = f.clone(), f.clone()
    before = dict(kernels.launches)
    T.composite_dirty_banded(c, sp, i, b, got, a, n_slots)
    assert kernels.launches["composite_dirty_banded"] == before["composite_dirty_banded"] + 1
    T.composite_dirty_banded_torch(c, sp, i, b, want, a, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    band_h = frame.shape[0] // len(n_reals)
    for k, n_real in enumerate(n_reals):
        rows = slice(k * band_h, (k + 1) * band_h)
        if n_real == 0:
            assert torch.equal(got[rows], f[rows]), "an idle band changed"
            continue
        one = f[rows].clone()
        T.composite_dirty(c[k].clone(), sp[k].clone(), i[k].clone(), b[rows].clone(), one, a[k].clone(), n_slots)
        assert torch.equal(got[rows], one), k


@pytest.mark.cuda
def test_banded_kernel_wrappers_reject_bad_tensors(cuda_device):
    atlas, bg, starts, idxs = banded_full_case(0, 2, 2, 3)
    a, b = convert.packed(atlas, cuda_device), convert.packed(bg, cuda_device)
    s, i = _ints((starts, idxs), cuda_device)
    with pytest.raises(ValueError):
        kernels.composite_full_banded(s, i, b, a[0], 2, 3)  # not a stack
    with pytest.raises(ValueError):
        kernels.composite_full_banded(s, i, b, a, 3, 3)  # band rows
    with pytest.raises(ValueError):
        kernels.composite_full_banded(s[:1], i, b, a, 2, 3)
    with pytest.raises(ValueError):
        kernels.composite_dirty_banded(i, i, i, b, b.clone(), a, 8)


@pytest.mark.cuda
def test_meshed_scene_on_one_card_matches_unmeshed(cuda_device):
    """Two bands sharing one card: render_sharded and render_dirty_sharded
    launch the banded kernels once each and equal the unsharded renders."""
    from coherence_tpu_torch.parallel import RowSharded, make_mesh
    from coherence_tpu_torch.raster.region import Sprite

    rng = np.random.default_rng(5)
    nty, ntx = 6, 4
    ts = T.TiledScene(ntx * TILE_W, nty * TILE_H, cuda_device)
    order = []
    for k in range(30):
        x0, y0 = int(rng.integers(-20, ntx * TILE_W - 10)), int(rng.integers(-20, nty * TILE_H - 10))
        w, h = int(rng.integers(8, 200)), int(rng.integers(8, 150))
        alpha = 255 if k % 3 else 150
        rgba = torch.tensor([int(v) * alpha // 255 for v in rng.integers(0, 256, 3)] + [alpha], dtype=torch.int32,
                            device=cuda_device).expand(h, w, 4).contiguous()
        ts.add_object(k, Sprite((x0, y0, x0 + w - 1, y0 + h - 1), torch.ones((h, w), dtype=torch.bool,
                                                                           device=cuda_device), rgba))
        order.append(k)
    bg = convert.packed(random_plane(rng, nty * TILE_H, ntx * TILE_W), cuda_device)
    mesh = make_mesh(2, ["cuda:0", "cuda:0"])
    before = dict(kernels.launches)
    frame = T.render_sharded(ts, bg, order, mesh)
    assert kernels.launches["composite_full_banded"] == before["composite_full_banded"] + 1
    full = ts.render_full(bg, *ts.build_lists(order))
    assert torch.equal(frame.gather(cuda_device), full)
    dirty = [0, 5, 13]  # band 1 (tiles 12-23) is partly dirty, then idle below
    T.render_dirty_sharded(ts, frame, bg, order, [0], mesh)  # band 1 idle
    T.render_dirty_sharded(ts, frame, bg, order, dirty, mesh)
    plain = ts.render_dirty(full.clone(), bg, order, dirty)
    torch.cuda.synchronize()
    assert kernels.launches["composite_dirty_banded"] == before["composite_dirty_banded"] + 2
    assert torch.equal(frame.gather(cuda_device), plain)
    assert isinstance(frame, RowSharded) and len(frame.parts) == 1


def _small_session_scene():
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import fills
    from coherence_tpu_torch.scene import render as R

    def obj(shape, col, t=()):
        return R.Obj(ident.new_ids(), R.Basic(fills.plain(col), shape), t, R.OVER)

    objs = [obj(R.rectangle(20.0, 30.0, 180.0, 120.0), C.dissolve(C.teal, delta=200)),
            obj(R.PathShape(gshapes.circle(220.0, 120.0, 45.0)), C.gold)]
    blob = obj(R.PathShape(gshapes.circle(0.0, 0.0, 22.0)), C.dissolve(C.crimson, delta=170), (tr.Translate(80.0, 100.0),))
    return objs, blob, obj(R.rectangle(120.0, 60.0, 120.0, 80.0), C.white)


def _serve_small_session(device, scene, mesh=None):
    """A FastSession on `device` behind a localhost socket (its view split
    over `mesh` after the first frame when one is given), a drag and a
    slider step; the client's final image."""
    from types import SimpleNamespace

    from _torch_sockets import DEADLINE, ServedClient, in_thread, socket_pair

    from coherence_tpu_torch.gui import client, fastserver, talk

    port = SimpleNamespace(talk=talk, client=client)
    sconn, cconn = socket_pair(port, port)

    def serve():
        try:
            sess = fastserver.FastSession(sconn, 320, 200, *scene, blur_radius=3, device=device)
            if mesh is not None:
                sess.view.use_mesh(mesh)
                sess.disp.full_refresh()
                sess.ship_full()
            sess.run()
        finally:
            sconn.close()  # a failed server ends the client's wait

    t, fail = in_thread(serve)
    sc = ServedClient(port, cconn)
    c = sc.c
    c.app_start()
    c.send_event("LeftDown", 1, 80, 100)
    c.send_event("LeftDragging", 1, 95, 108)
    c.send_event("LeftUp", 1, 95, 108)
    c.send_event("BlurSlider", 1, 5)
    try:
        sc.finish()
    except (ConnectionError, OSError):
        pass
    t.join(DEADLINE)
    cconn.close()
    if fail:
        raise fail[0]
    return c.windows[1].image


@pytest.mark.cuda
def test_fast_session_on_the_card_matches_the_cpu(cuda_device):
    """The same scene objects served from the CPU, then from the card: the
    second build hits the scene-build cache with a snapshot made on the
    other device, and the client's pixels are equal."""
    from coherence_tpu_torch.scene import cache, fastframe

    fastframe.scene_build_cache_clear()
    scene = _small_session_scene()
    cache.clear()
    want = _serve_small_session("cpu", scene)
    cache.clear()
    before = dict(kernels.launches)
    hits = fastframe.scene_build_cache_stats()["hits"]
    got = _serve_small_session(cuda_device, scene)
    cache.clear()
    assert fastframe.scene_build_cache_stats()["hits"] == hits + 1
    assert np.array_equal(got, want) and (got != got[0, 0]).any()
    # The first frame, the drag and the slider step each composite through the dirty kernel.
    assert kernels.launches["composite_dirty"] == before["composite_dirty"] + 3
    fastframe.scene_build_cache_clear()


@pytest.mark.cuda
def test_meshed_fast_session_on_the_card_matches_unsharded(cuda_device):
    """A FastSession whose view is split over a 2-band mesh on one card
    ships its windows from the bands: the client's pixels equal those of
    the same session unsharded."""
    from coherence_tpu_torch.parallel import mesh as TM
    from coherence_tpu_torch.scene import cache

    scene = _small_session_scene()
    cache.clear()
    want = _serve_small_session(cuda_device, scene)
    cache.clear()
    got = _serve_small_session(cuda_device, scene, TM.make_mesh(2, [cuda_device] * 2))
    cache.clear()
    assert np.array_equal(got, want) and (got != got[0, 0]).any()


@pytest.mark.cuda
def test_pdf_pages_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """chip_smoke.py's three-page document (graphics on page 1, images on
    page 2, text on page 3) through Engine.openfile and goto_page on the CPU
    and on the card: equal framebuffers, and the transparency groups, among
    them page 3's group of text, fold through fold_layers on the card."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from coherence_tpu_torch.gui import app
    from coherence_tpu_torch.gui import window as W
    from coherence_tpu_torch.io import pdf as P
    from coherence_tpu_torch.scene import cache

    path = str(tmp_path / "pages.pdf")
    P.pdf_to_file(P.Pdf(*chip_smoke.pdf_document(P, 480, 270, image_wh=(64, 48))), path)
    shown = []
    for device in ("cpu", cuda_device):
        cache.clear()
        eng = app.Engine(device=device)
        eng.event_handler((W.OPEN_FILE, path))
        view = eng.views[0]
        eng.event_handler((W.PAINT_RECT, view.window, 0, 0, 600, 400))
        pages, folds = [eng.wx.framebuffers[view.window].copy()], []
        for _ in range(2):
            before = kernels.launches["fold_layers"]
            eng.event_handler((W.KEY_DOWN, view.window, W.PageDown))
            torch.cuda.synchronize()
            pages.append(eng.wx.framebuffers[view.window].copy())
            folds.append(kernels.launches["fold_layers"] - before)
        shown.append((pages, folds))
    cache.clear()
    (a, _), (b, folds) = shown
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(b[0], b[1]) and not np.array_equal(b[2], b[0]) and not np.array_equal(b[2], b[1])
    assert folds[1] >= 1


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda_device):
    from coherence_tpu_torch.gui import app
    from coherence_tpu_torch.gui import window as W
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R

    objs, blob, lens = _small_session_scene()
    shown = []
    for device in ("cpu", cuda_device):
        cache.clear()
        eng = app.Engine(device=device)
        view = R.View(device=eng.device, scene=[blob] + objs, pages=[], background=[app.background_obj()],
                      master_update=region.shape_of_box((0, 0, 320, 200), eng.device))
        eng.views.append(view)
        view.window = eng.wx.make_window("w", 320, 200, 0, 0, 0, 0)
        eng.wx.display.post(W.PAINT_RECT, view.window, 0, 0, 320, 200)
        for kind, x, y in ((W.LEFT_DOWN, 80, 100), (W.LEFT_DRAGGING, 95, 108), (W.LEFT_UP, 95, 108)):
            eng.wx.display.mouse = (x, y)
            eng.wx.display.post(kind, view.window, x, y)
            eng.run(max_events=2 if kind == W.LEFT_DOWN else 1, resilient=False)
        eng.wx.display.post(W.BLUR_SLIDER, view.window, 2)
        eng.run(max_events=1, resilient=False)
        assert eng.device.type == torch.device(device).type
        shown.append((eng.wx.framebuffers[view.window].copy(), list(eng.wx.display.refreshed)))
    cache.clear()
    (a, ra), (b, rb) = shown
    assert np.array_equal(a, b) and ra == rb and len(rb) >= 4


def _fold_layer(rng, hs: int, ws: int, opaque: float = 0.2, density: float = 0.85, alpha_max: int = 256):
    """One premultiplied (rgba, mask) layer: alpha below alpha_max, 255 on
    an `opaque` share of the pixels, the mask set on a `density` share."""
    alpha = rng.integers(0, alpha_max, (hs, ws))
    alpha[rng.random((hs, ws)) < opaque] = 255
    rgb = (rng.integers(0, 256, (hs, ws, 3)) * alpha[..., None]) // 255
    mask = rng.random((hs, ws)) < density
    rgba = np.where(mask[..., None], np.concatenate([rgb, alpha[..., None]], -1), 0).astype(np.int32)
    return rgba, mask


def fold_case(seed: int, k: int, hb: int, wb: int, case: str = "random"):
    """Seeded layers for the window fold: translucent (some pixels opaque,
    so pixels close part way down), masks with holes, each hanging off an
    edge of the (hb, wb) window or inside it; and an open mask with a
    closed band (on windows at least 3 wide).  Returns (offsets (k, 2)
    int32, [(rgba, mask)], open).  `case` alters the random case at the
    edges that a tiled fold can get wrong:

      outside       layer 0 wholly above the window, layer 1 wholly right
                    of it, each touching its edge;
      larger        layer k // 2 larger than the window on every side;
      one_tile      every layer inside the window's first 8x32 pixels (one
                    tile of the kernel's), faint and sparse with a few
                    opaque pixels, so that pixels close at many depths and
                    most stay open to the end (K = 300: the tile's list
                    spans several cull chunks; nine layer shapes, so that
                    the JAX side compiles few);
      ragged_open   the open mask a rectangle that closes whole tiles and
                    leaves a ragged region open, as a window's inwin does;
      opaque_front  layer 0 opaque over the whole window: every open pixel
                    closes at k = 0;
      clear_mask    masks set where the layer's alpha is 0.
    """
    rng = np.random.default_rng(seed)
    layers, offs = [], []
    for _ in range(k):
        if case == "one_tile":
            hs, ws = int(rng.choice([1, 4, 8])), int(rng.choice([1, 8, 32]))
            layers.append(_fold_layer(rng, hs, ws, opaque=0.01, density=0.15, alpha_max=40))
            offs.append((int(rng.integers(0, 9 - hs)), int(rng.integers(0, 33 - ws))))
            continue
        hs, ws = int(rng.integers(3, hb + 8)), int(rng.integers(3, wb + 8))
        layers.append(_fold_layer(rng, hs, ws))
        offs.append((int(rng.integers(-hs + 1, hb)), int(rng.integers(-ws + 1, wb))))
    open_mask = np.ones((hb, wb), bool)
    if wb >= 3:
        open_mask[:, wb // 3 : wb // 3 + 2] = False
    if case == "outside":
        offs[0] = (-layers[0][1].shape[0], offs[0][1])
        offs[1] = (offs[1][0], wb)
    elif case == "larger":
        layers[k // 2] = _fold_layer(rng, hb + 9, wb + 11)
        offs[k // 2] = (-4, -5)
    elif case == "ragged_open":
        open_mask[:] = False
        open_mask[17 : hb - 5, 37 : wb - 9] = True
    elif case == "opaque_front":
        layers[0] = _fold_layer(rng, hb, wb, opaque=1.0, density=1.0)
        offs[0] = (0, 0)
    elif case == "clear_mask":
        for rgba, mask in layers:
            clear = rng.random(mask.shape) < 0.3
            mask |= clear
            rgba[clear] = 0
    return np.asarray(offs, np.int32), layers, open_mask


# (seed, k, hb, wb, case): windows that are not a multiple of the kernel's
# tile, then each of fold_case's edge cases; shared with the CPU
# comparison against the JAX package (tests/test_torch_framepath.py).
FOLD_EDGE_CASES = [
    (3, 12, 1, 1, "random"),
    (4, 9, 17, 129, "random"),
    (5, 9, 65, 257, "random"),
    (6, 8, 33, 70, "outside"),
    (7, 6, 40, 90, "larger"),
    (8, 300, 40, 70, "one_tile"),
    (9, 10, 65, 257, "ragged_open"),
    (10, 8, 33, 100, "opaque_front"),
    (11, 8, 30, 70, "clear_mask"),
]


def fold_params(*cases):
    """The (seed, k, hb, wb) cases as parameters of a random fold_case, with
    pytest's own ids, then FOLD_EDGE_CASES."""
    return ([pytest.param(*c, "random", id="-".join(map(str, c))) for c in cases]
            + [pytest.param(*c, id="-".join(map(str, c))) for c in FOLD_EDGE_CASES])


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,hb,wb,case", fold_params((0, 7, 24, 40), (1, 7, 61, 300), (2, 200, 33, 130)))
def test_fold_layers_kernel_matches_plain(cuda_device, seed, k, hb, wb, case):
    """fold_layers against fold_layers_carry_torch, carry and all, on a
    translucent stack with closing pixels and offsets off every edge; over
    128 layers the records come in two chunks; then the edge cases.  Then
    the same fold in two calls with the carry."""
    from coherence_tpu_torch.raster import framepath as FP

    offs, layers, open_mask = fold_case(seed, k, hb, wb, case)
    acc = np.random.default_rng(seed).integers(0, 3, (hb, wb, 4)).astype(np.int32)
    carry = [torch.from_numpy(acc), torch.from_numpy(open_mask), torch.from_numpy(open_mask[::-1].copy())]
    cpu_layers = [(torch.from_numpy(r), torch.from_numpy(m)) for r, m in layers]
    want = FP.fold_layers_carry_torch(offs.tolist(), cpu_layers, *carry)
    card = [(r.to(cuda_device), m.to(cuda_device)) for r, m in cpu_layers]
    before = kernels.launches["fold_layers"]
    got = FP.fold_layers_carry(offs.tolist(), card, *(t.to(cuda_device) for t in carry))
    cut = k // 2
    first = FP.fold_layers_carry(offs[:cut].tolist(), card[:cut], *(t.to(cuda_device) for t in carry))
    chunked = FP.fold_layers_carry(offs[cut:].tolist(), card[cut:], *first)
    torch.cuda.synchronize()
    assert kernels.launches["fold_layers"] == before + 3
    for w, g, c in zip(want, got, chunked):
        assert torch.equal(g.cpu(), w) and torch.equal(c.cpu(), w)
    assert bool(want[2].any()) and not bool(want[1].all())


def _edited_frames(device):
    """The scene edits on a small view on `device`: the sprite route's
    build, add, replace, remove, restack, then a group (its members through
    the batched raster and the fold) added on top; the frame after each."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import fills
    from coherence_tpu_torch.scene import fastframe
    from coherence_tpu_torch.scene import render as R

    def circle(x, y, r, col, alpha=255):
        return R.Obj(ident.new_ids(), R.Basic(fills.plain(C.dissolve(col, delta=alpha)),
                                              R.PathShape(gshapes.circle(float(x), float(y), float(r)))), (), R.OVER)

    base = [circle(100, 64, 40, C.green), circle(150, 50, 30, C.blue, 150), circle(60, 70, 25, C.red, 200)]
    v = fastframe.DeviceView(2 * TILE_W, 2 * TILE_H, device=device)
    v.set_scene(base)
    v.render(full=True)
    frames = [v.read()]
    edits = [lambda: v.add_object(circle(120, 50, 20, C.gold, 180), 0),
             lambda: v.replace_object(base[0].idset, circle(100, 64, 40, C.purple, 230)),
             lambda: v.remove_object(base[2].idset),
             lambda: v.restack([v.order[0], v.order[2], v.order[1]]),
             lambda: v.add_object(R.mkgroup([circle(200, 90, 20, C.teal, 160), circle(215, 80, 15, C.red)]), 0)]
    for edit in edits:
        edit()
        v.render()
        frames.append(v.read())
    return frames


@pytest.mark.cuda
def test_scene_edits_on_the_card_match_the_cpu(cuda_device):
    from coherence_tpu_torch.scene import cache

    cache.clear()
    want = _edited_frames("cpu")
    cache.clear()
    before = dict(kernels.launches)
    got = _edited_frames(cuda_device)
    cache.clear()
    for k, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(a, b), f"frame {k}"
    assert kernels.launches["composite_full"] == before["composite_full"] + 1
    assert kernels.launches["composite_dirty"] == before["composite_dirty"] + 5
    assert kernels.launches["fold_layers"] == before["fold_layers"] + 1


@pytest.mark.cuda
def test_trace_records_the_card(cuda_device, tmp_path):
    """utils.trace, the counterpart of the JAX package's profiler hook,
    writes one Chrome trace of CPU and CUDA activity into log_dir."""
    import glob
    import json

    from coherence_tpu_torch import utils

    with utils.trace(str(tmp_path)):
        x = torch.ones(1 << 20, device=cuda_device)
        (x * 2).sum().item()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cuda_runtime" or e.get("cat") == "kernel" for e in events)


# ---------------------------------------------------------------------------
# The animated frame's kernels: blur_blend (B1) and shatter_into (S1), the
# staged upload, and the frame they make.  The blur cases are shared with
# the CPU comparison against the JAX package
# (tests/test_torch_animated_frame.py).
# ---------------------------------------------------------------------------

# The blur cases' frame, its packed content plane padded to whole tiles.
BLUR_FH, BLUR_FW = 136, 264
BLUR_PH, BLUR_PW = 192, 384
BLUR_RADII = [1, 5, 16, 64]
# Dirty boxes (x0, y0, x1, y1, 1-based) at every edge and corner of the
# frame and inside it; those reaching past the frame clip to it.
BLUR_PLACES = {
    "top_left": (-6, -4, 30, 18),
    "top": (110, 1, 150, 22),
    "top_right": (240, -3, BLUR_FW + 7, 20),
    "left": (1, 60, 25, 80),
    "centre": (120, 60, 150, 78),
    "right": (BLUR_FW - 30, 55, BLUR_FW, 90),
    "bottom_left": (-2, BLUR_FH - 15, 40, BLUR_FH + 4),
    "bottom": (100, BLUR_FH - 20, 140, BLUR_FH),
    "bottom_right": (BLUR_FW - 35, BLUR_FH - 25, BLUR_FW + 3, BLUR_FH + 9),
}
BLUR_ALPHAS = ["zero", "opaque", "mixed"]


def blur_content(seed: int, h: int, w: int) -> np.ndarray:
    """(h, w, 4) int32 premultiplied RGBA with opaque, clear and
    translucent regions."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w))
    a[: h // 3, : w // 2] = 255
    a[h // 3 : h // 2, w // 2 :] = 0
    rgb = np.minimum((rng.random((h, w, 3)) * (a[..., None] + 1)).astype(np.int64), a[..., None])
    return np.concatenate([rgb, a[..., None]], axis=-1).astype(np.int32)


def packed_rgba(rgba: np.ndarray) -> np.ndarray:
    """(..., 4) channels as packed int32 words."""
    r, g, b, a = (rgba[..., i].astype(np.uint32) for i in range(4))
    return (r | (g << 8) | (b << 16) | (a << 24)).view(np.int32)


def unpacked_rgba(packed: np.ndarray) -> np.ndarray:
    u = packed.view(np.uint32)
    return np.stack([(u >> s) & 0xFF for s in (0, 8, 16, 24)], axis=-1).astype(np.int32)


def blur_alpha(kind: str, seed: int, h: int, w: int) -> np.ndarray:
    """A filter alpha plane: all 0, all 255, or 0, 255 and partial bands."""
    if kind == "zero":
        return np.zeros((h, w), np.int32)
    if kind == "opaque":
        return np.full((h, w), 255, np.int32)
    rng = np.random.default_rng(seed)
    fa = rng.integers(0, 256, (h, w)).astype(np.int32)
    fa[: h // 4] = 0
    fa[h // 2 :, w // 3 :] = 255
    fa[h // 2 : h // 2 + 3] = rng.integers(1, 255, (3, w))
    return fa


def blur_case(radius: int, place: str, kind: str):
    """(packed content plane, display, alpha plane, blur_window geometry)."""
    from coherence_tpu_torch.raster import framepath as FP

    seed = radius * 100 + list(BLUR_PLACES).index(place) * 10 + BLUR_ALPHAS.index(kind)
    content = np.full((BLUR_PH, BLUR_PW, 4), 200, np.int32)  # padding the window never reads
    content[:BLUR_FH, :BLUR_FW] = blur_content(seed, BLUR_FH, BLUR_FW)
    display = np.random.default_rng(seed + 1).integers(0, 256, (BLUR_FH, BLUR_FW, 4)).astype(np.int32)
    win = FP.blur_window(BLUR_PLACES[place], (1, 1, BLUR_FW, BLUR_FH), radius, BLUR_FH, BLUR_FW)
    return packed_rgba(content), display, blur_alpha(kind, seed + 2, BLUR_FH, BLUR_FW), win


def wrapped_blur_case(radius: int):
    """A case whose int32 blur sums wrap (255 x total >= 2^31 above r =
    140): a frame wider than the kernel, its top rows opaque white under an
    opaque filter.  (packed content plane, display, alpha plane, the window
    of a dirty box in those rows)."""
    from coherence_tpu_torch.raster import framepath as FP

    fh, fw = 48, 2 * radius + 100
    content = np.full((64, 1024, 4), 200, np.int32)
    content[:fh, :fw] = blur_content(radius, fh, fw)
    content[:8, :fw] = 255
    alpha = blur_alpha("mixed", radius, fh, fw)
    alpha[:8] = 255
    display = np.random.default_rng(radius).integers(0, 256, (fh, fw, 4)).astype(np.int32)
    win = FP.blur_window((fw // 2 - 10, 1, fw // 2 + 10, 12), (1, 1, fw, fh), radius, fh, fw)
    return packed_rgba(content), display, alpha, win


# The tiling cases: windows whose changed pixels (kernels.blur_launch_rect)
# are one pixel, one row or one column, or end exactly on a block tile's
# edge (32 x 64 pixels, 2 x 2 tiles of kernels.BLUR_TILE) and one pixel past
# it; every window at an odd column of the packed plane, so that its rows
# start off a 16-byte boundary.  name -> (oy, ox, ry0, rx0, h, w, hb, wb,
# d_box).
BLUR_TILE_FH, BLUR_TILE_FW = 80, 200
BLUR_TILE_PH, BLUR_TILE_PW = 96, 256
BLUR_TILING = {
    "one_pixel": (7, 9, 0, 0, 1, 1, 1, 1, (0, 0, 0, 0)),
    "one_row": (40, 3, 0, 5, 1, 140, 1, 150, (0, 30, 0, 70)),
    "one_column": (2, 101, 3, 0, 60, 1, 70, 1, (20, 0, 35, 0)),
    "tile_edge": (9, 21, 5, 3, 32, 64, 64, 128, (5, 3, 35, 65)),
    "tile_edge_plus_one": (9, 21, 5, 3, 33, 65, 64, 128, (5, 3, 36, 66)),
}
BLUR_TILING_RADII = [1, 4, 5, 31, 150, 200]
# Whole frames for rect mode: one pixel, one row, one column, 2 x 2 tiles and one pixel past them.
BLUR_TINY_FRAMES = [(1, 1), (1, 150), (70, 1), (32, 64), (33, 65)]


def tiling_case(name: str, radius: int):
    """(packed content plane, display, alpha plane, window geometry as
    blur_window gives it) of BLUR_TILING's case `name`."""
    oy, ox, ry0, rx0, h, w, hb, wb, d_box = BLUR_TILING[name]
    seed = 7000 + radius * 10 + list(BLUR_TILING).index(name)
    content = np.full((BLUR_TILE_PH, BLUR_TILE_PW, 4), 200, np.int32)  # padding the window never reads
    content[:BLUR_TILE_FH, :BLUR_TILE_FW] = blur_content(seed, BLUR_TILE_FH, BLUR_TILE_FW)
    display = np.random.default_rng(seed + 1).integers(0, 256, (BLUR_TILE_FH, BLUR_TILE_FW, 4)).astype(np.int32)
    alpha = blur_alpha("mixed", seed + 2, BLUR_TILE_FH, BLUR_TILE_FW)
    win = (None, oy, ox, ry0, rx0, h, w, hb, wb, np.asarray(d_box, np.int32))
    return packed_rgba(content), display, alpha, win


def speckled_alpha(seed: int, h: int, w: int) -> np.ndarray:
    """A filter alpha plane of any size: about a third each 0, 255 and
    partial."""
    rng = np.random.default_rng(seed)
    return np.choose(rng.integers(0, 3, (h, w)), [0, 255, rng.integers(1, 255, (h, w))]).astype(np.int32)


def tiny_frame_case(fh: int, fw: int, radius: int):
    """(packed, padded content plane, (fh, fw, 4) unpacked frame, alpha
    plane) of a whole fh x fw frame for rect mode."""
    seed = 8000 + radius * 10 + BLUR_TINY_FRAMES.index((fh, fw))
    content = np.full((fh + 5, fw + 7, 4), 200, np.int32)
    content[:fh, :fw] = blur_content(seed, fh, fw)
    return packed_rgba(content), np.ascontiguousarray(content[:fh, :fw]), speckled_alpha(seed + 1, fh, fw)


def _blur_window_both(device, packed, display, alpha, win, kernel):
    """(plain, card) blur_blend_into over the packed plane and over the
    unpacked window, each [display after the packed form, after the
    unpacked one]."""
    from coherence_tpu_torch.raster import framepath as FP

    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    window = np.ascontiguousarray(unpacked_rgba(packed)[oy : oy + hb, ox : ox + wb])
    out = []
    for dev in ("cpu", device):
        t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
        fn = FP.blur_blend_into_torch if dev == "cpu" else FP.blur_blend_into
        a = fn(t(display), t(packed), (oy, ox), t(alpha), (oy, ox), hb, wb, ry0, rx0, h, w, d_box, kernel.values,
               kernel.total)
        b = fn(t(display), t(window), (0, 0), t(alpha), (oy, ox), hb, wb, ry0, rx0, h, w, d_box, kernel.values,
               kernel.total)
        out.append([a.cpu(), b.cpu()])
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("place", list(BLUR_PLACES))
@pytest.mark.parametrize("radius", BLUR_RADII)
def test_blur_blend_window_kernel_matches_plain(cuda_device, radius, place):
    """blur_blend in window mode against blur_blend_into_torch at every
    edge and corner, each alpha plane, over the packed content plane and
    over an unpacked window, bit for bit; one launch a call."""
    from coherence_tpu_torch.raster import convolve as V

    kernel = V.mkgaussian(radius)
    for kind in BLUR_ALPHAS:
        packed, display, alpha, win = blur_case(radius, place, kind)
        before = kernels.launches["blur_blend"]
        (want, want_u), (got, got_u) = _blur_window_both(cuda_device, packed, display, alpha, win, kernel)
        assert kernels.launches["blur_blend"] == before + 2
        assert torch.equal(want, want_u), kind
        assert torch.equal(got, want) and torch.equal(got_u, want), kind


@pytest.mark.cuda
@pytest.mark.parametrize("kind", BLUR_ALPHAS)
@pytest.mark.parametrize("radius", BLUR_RADII)
def test_blur_blend_rect_kernel_matches_plain(cuda_device, radius, kind):
    """blur_blend in rect mode against apply_blur_rect over the whole frame,
    from unpacked RGBA and from the packed, padded plane, bit for bit."""
    from coherence_tpu_torch.raster import convolve as V
    from coherence_tpu_torch.raster import framepath as FP

    kernel = V.mkgaussian(radius)
    packed, _, alpha, _ = blur_case(radius, "centre", kind)
    frame = np.ascontiguousarray(unpacked_rgba(packed)[:BLUR_FH, :BLUR_FW])
    want = FP.apply_blur_rect(torch.from_numpy(frame), torch.from_numpy(alpha), kernel.values, kernel.total)
    fa = torch.from_numpy(alpha).to(cuda_device)
    got = FP.blur_blend_rect(torch.from_numpy(frame).to(cuda_device), fa, kernel.values, kernel.total)
    got_p = FP.blur_blend_rect(torch.from_numpy(packed).to(cuda_device), fa, kernel.values, kernel.total)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got_p.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BLUR_TILING))
@pytest.mark.parametrize("radius", BLUR_TILING_RADII)
def test_blur_blend_window_kernel_matches_plain_on_tiles(cuda_device, radius, case):
    """blur_blend in window mode against blur_blend_into_torch where the
    grid of changed pixels is one pixel, one row or one column, or ends on
    a tile's edge and one pixel past it, at odd columns of the packed plane,
    over both content forms, bit for bit; one launch a call."""
    from coherence_tpu_torch.raster import convolve as V

    kernel = V.mkgaussian(radius)
    packed, display, alpha, win = tiling_case(case, radius)
    before = kernels.launches["blur_blend"]
    (want, want_u), (got, got_u) = _blur_window_both(cuda_device, packed, display, alpha, win, kernel)
    assert kernels.launches["blur_blend"] == before + 2
    assert torch.equal(want, want_u) and not torch.equal(want, torch.from_numpy(display))
    assert torch.equal(got, want) and torch.equal(got_u, want)


@pytest.mark.cuda
@pytest.mark.parametrize("frame_hw", BLUR_TINY_FRAMES)
@pytest.mark.parametrize("radius", BLUR_TILING_RADII)
def test_blur_blend_rect_kernel_matches_plain_on_tiny_frames(cuda_device, radius, frame_hw):
    """blur_blend in rect mode against apply_blur_rect over frames of one
    pixel, one row, one column, 2 x 2 tiles and one pixel past them, from
    unpacked RGBA and from a wider packed plane, bit for bit."""
    from coherence_tpu_torch.raster import convolve as V
    from coherence_tpu_torch.raster import framepath as FP

    kernel = V.mkgaussian(radius)
    packed, frame, alpha = tiny_frame_case(*frame_hw, radius)
    want = FP.apply_blur_rect(torch.from_numpy(frame), torch.from_numpy(alpha), kernel.values, kernel.total)
    fa = torch.from_numpy(alpha).to(cuda_device)
    got = FP.blur_blend_rect(torch.from_numpy(frame).to(cuda_device), fa, kernel.values, kernel.total)
    got_p = FP.blur_blend_rect(torch.from_numpy(packed).to(cuda_device), fa, kernel.values, kernel.total)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got_p.cpu(), want)


@pytest.mark.cuda
def test_launch_floor_runs(cuda_device):
    """The empty kernel launches and is not counted."""
    before = dict(kernels.launches)
    kernels.launch_floor(cuda_device)
    torch.cuda.synchronize()
    assert kernels.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [150, 200])
def test_blur_blend_kernel_wraps_as_the_plain_version(cuda_device, radius):
    """Where 255 x total passes 2^31 the kernel's unsigned sums wrap as the
    plain version's int32 sums do (and the JAX package's), in both modes."""
    from coherence_tpu_torch.raster import convolve as V
    from coherence_tpu_torch.raster import framepath as FP

    kernel = V.mkgaussian(radius)
    packed, display, alpha, win = wrapped_blur_case(radius)
    fh, fw = alpha.shape
    want = FP.blur_blend_rect(torch.from_numpy(packed), torch.from_numpy(alpha), kernel.values, kernel.total)
    got = FP.blur_blend_rect(torch.from_numpy(packed).to(cuda_device), torch.from_numpy(alpha).to(cuda_device),
                             kernel.values, kernel.total)
    assert int(want.min()) < 0 and torch.equal(got.cpu(), want)
    (want, want_u), (got, got_u) = _blur_window_both(cuda_device, packed, display, alpha, win, kernel)
    assert int(want.min()) < 0 and torch.equal(got, want) and torch.equal(got_u, want)


def shatter_case(seed: int, cap: int = 24, h: int = 150, w: int = 300):
    """(atlas, raster, offsets, base): offsets below the raster, past it,
    straddling its edges and inside, the last piece repeated as
    _inplace_args pads a list."""
    rng = np.random.default_rng(seed)
    atlas = rng.integers(0, 2**32, (cap, TILE_H, TILE_W), dtype=np.uint64).astype(np.uint32)
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.int32)
    oys = np.asarray([-70, -64, -10, 0, 40, 100, 149, 150, 1 << 20, 40, 40, 40], np.int64)
    oxs = np.asarray([-200, 5, -5, 0, 64, 200, 299, 0, 0, 64, 64, 64], np.int64)
    return atlas, rgba, oys, oxs, 3 + seed


def banded_shatter_case(seed: int):
    """(band atlases, raster, (n_bands, n) offsets, base) as
    BandedAtlas.update_inplace makes them: band 1 all out of range, band 2
    its last piece repeated."""
    n_bands, cap, n = 3, 16, 6
    atlases = np.stack([shatter_case(seed * 10 + b, cap)[0] for b in range(n_bands)])
    rgba = shatter_case(seed)[1]
    oys = np.full((n_bands, n), 1 << 20, np.int32)
    oxs = np.full((n_bands, n), 1 << 20, np.int32)
    oys[0, :3], oxs[0, :3] = [-20, 0, 64], [10, -100, 128]
    oys[2, 3:], oxs[2, 3:] = [100, 100, 100], [250, 250, 250]
    return atlases, rgba, oys, oxs, 2


@pytest.mark.cuda
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shatter_kernel_matches_plain(cuda_device, seed, banded):
    """shatter_into against shatter_into_torch, both forms, bit for bit:
    host offsets (staged inside) and staged tensors."""
    from coherence_tpu_torch.raster.staging import stage

    atlas, rgba, oys, oxs, base = banded_shatter_case(seed) if banded else shatter_case(seed)
    want = T.shatter_into_torch(convert.packed(atlas, "cpu"), torch.from_numpy(rgba), oys, oxs, base)
    r = torch.from_numpy(rgba).to(cuda_device)
    before = kernels.launches["shatter_into"]
    got = T.shatter_into(convert.packed(atlas, cuda_device), r, oys, oxs, base)
    got_s = T.shatter_into(convert.packed(atlas, cuda_device), r, *stage(cuda_device, oys, oxs), base)
    torch.cuda.synchronize()
    assert kernels.launches["shatter_into"] == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(got_s.cpu(), want)


@pytest.mark.cuda
def test_blur_and_shatter_wrappers_reject_bad_tensors(cuda_device):
    from coherence_tpu_torch.raster import convolve as V

    k = V.mkgaussian(5)
    packed, display, alpha, win = blur_case(5, "centre", "mixed")
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    c, d, a = (torch.from_numpy(x).to(cuda_device) for x in (packed, display, alpha))

    def window(content=c, f_alpha=a, disp=d, content_at=(oy, ox), at=(oy, ox)):
        kernels.blur_blend_window(content, content_at, f_alpha, disp, at, hb, wb, ry0, rx0, h, w, d_box, k.values,
                                  k.total)

    window()
    for bad in (dict(content=c.cpu()), dict(content=c.long()), dict(f_alpha=a.float()), dict(disp=d[:, :, :3]),
                dict(content=c.t()), dict(f_alpha=a[:, 1:]), dict(disp=d[:-1]),
                dict(content=c.view(-1)[1 : 1 + (BLUR_PH - 1) * BLUR_PW].view(BLUR_PH - 1, BLUR_PW)),  # misaligned
                dict(content_at=(BLUR_PH - hb + 1, 0)), dict(at=(-1, ox)), dict(at=(oy, BLUR_FW - wb + 1))):
        with pytest.raises(ValueError):
            window(**bad)
    with pytest.raises(ValueError):
        kernels.blur_blend_window(c, (oy, ox), a, d, (oy, ox), hb, wb, ry0, rx0, h, w, d_box, (1, 2), 3)
    with pytest.raises(ValueError):
        kernels.blur_blend_rect(c, a.cpu(), k.values, k.total)
    with pytest.raises(ValueError):
        kernels.blur_blend_rect(c[:100], a, k.values, k.total)  # fewer rows than the frame

    atlas, rgba, oys, oxs, base = shatter_case(0)
    at = convert.packed(atlas, cuda_device)
    r = torch.from_numpy(rgba).to(cuda_device)
    y, x = (torch.from_numpy(v.astype(np.int32)).to(cuda_device) for v in (oys, oxs))
    kernels.shatter_into(at, r, y, x, base)
    for args in ((at, r, y.long(), x, base), (at, r.cpu(), y, x, base), (at, r[:, :, :3], y, x, base),
                 (at, r, y, x[:-1], base), (at, r, y, x, at.shape[0] - 2), (at, r, y, x, -1),
                 (at[:, :, :64], r, y, x, base), (at, r[:, 1:], y, x, base),
                 (at, r, y[None], x[None], base),
                 (at, r, y.new_zeros(13)[1:], x, base)):  # the last: a misaligned view
        with pytest.raises(ValueError):
            kernels.shatter_into(*args)


def _animated_scene(device, mesh=None):
    """test_torch_slice's shrunk bench scene (the lion at 512x256, a
    translucent blob of r=20 reserved for in-place moves, a radius-2 blur
    band) on `device`, split over `mesh` if one is given: (view, display,
    blob key)."""
    from coherence_tpu_torch.raster import convolve as V
    from coherence_tpu_torch.scene import fastframe as F

    objs, blob, f_geom = examples.bench_scene(512, 256, blob_radius=20, blob_at=(32.0, 95.0),
                                              f_box=(11, 76, 448, 251))
    view = F.DeviceView(512, 256, atlas_cap=256, device=device)
    view.set_scene(objs, tiled=True)
    view.sprites[blob.idset] = F.tiled_sprite_of_object(blob, view.pw, view.ph, device)
    view.order.insert(0, blob.idset)
    view.make_animated(blob.idset)
    if mesh is not None:
        view.use_mesh(mesh)
    disp = F.FilteredDisplay(view, F.alpha_plane_of_object(f_geom, 512, 256, device), V.mkgaussian(2))
    disp.full_refresh()
    return view, disp, blob.idset


def _animated_delta(k: int):
    return (7, 3) if (k // 20) % 2 == 0 else (-7, -3)


@pytest.mark.cuda
def test_400_unsynced_frames_equal_the_cpu(cuda_device):
    """400 step_animated frames queued behind a long device-side wait, with
    no host sync between them, so that the host runs far ahead of the card
    and the staging ring must keep every pinned buffer until its copy has
    run: display, content and atlas equal to the CPU's after the 400."""
    from coherence_tpu_torch.raster import staging

    cv, cd, ck = _animated_scene("cpu")
    for k in range(400):
        cd.step_animated(ck, *_animated_delta(k))
    gv, gd, gk = _animated_scene(cuda_device)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s: the host queues many frames meanwhile
    for k in range(400):
        gd.step_animated(gk, *_animated_delta(k))
    torch.cuda.synchronize()
    assert len(staging._ring(torch.device(cuda_device.type, torch.cuda.current_device())).host) > 1
    assert torch.equal(gd.rgba.cpu(), cd.rgba)
    assert torch.equal(gv.frame.cpu(), cv.frame)
    assert torch.equal(gv.ts.atlas().cpu(), cv.ts.atlas())


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [1, 2])
def test_queued_frames_equal_the_cpu_after_every_frame(cuda_device, bands):
    """40 step_animated frames queued behind a long device-side wait, so
    that each frame's launches wait on the card's queue before the kernel
    ahead of them runs.  Programmatic dependent launch then starts
    composite_dirty (composite_dirty_banded on a 2-band mesh) as
    shatter_into ends, and blur_blend as composite_dirty ends; each must
    wait for the writes of the kernel before it.  The display after
    every frame equals the CPU plain path's, bit for bit; unmeshed, a
    steady frame still issues one copy and three launches."""
    from coherence_tpu_torch.parallel import make_mesh

    n = 40
    cv, cd, ck = _animated_scene("cpu")
    want = []
    for k in range(n):
        cd.step_animated(ck, *_animated_delta(k))
        want.append(cd.rgba.clone())
    count = torch.cuda.device_count()
    mesh = make_mesh(2, [f"cuda:{b * count // 2}" for b in range(2)]) if bands == 2 else None
    gv, gd, gk = _animated_scene(cuda_device, mesh)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s: the host queues every frame meanwhile
    got = []
    for k in range(n):
        gd.step_animated(gk, *_animated_delta(k))
        got.append(gd.rgba.gather(cuda_device) if mesh is not None else gd.rgba.clone())
    torch.cuda.synchronize()
    for k in range(n):
        assert torch.equal(got[k].cpu(), want[k]), f"frame {k} differs from the CPU's"
    if mesh is None:
        assert _issued_per_frame(gd, gk, n) == (1, 3)


def _issued_per_frame(disp, key, k: int):
    """(copies, launches) that one step_animated issues, as the CUDA
    runtime's rows of the profiler count them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        disp.step_animated(key, *_animated_delta(k))
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return (sum(n.startswith(("cudaMemcpy", "cudaMemset")) for n in names),
            sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for n in names))


@pytest.mark.cuda
def test_steady_frame_is_one_copy_and_three_launches(cuda_device):
    """A steady animated frame on the card issues exactly one host-to-device
    copy and three kernel launches (shatter_into, composite_dirty,
    blur_blend), as the runtime's rows of the profiler count them."""
    from torch.profiler import ProfilerActivity, profile

    view, disp, key = _animated_scene(cuda_device)
    for k in range(3):
        disp.step_animated(key, *_animated_delta(k))
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        disp.step_animated(key, *_animated_delta(3))
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    launches = [n for n in names if n.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    copies = [n for n in names if n.startswith(("cudaMemcpy", "cudaMemset"))]
    assert len(copies) == 1 and copies[0].startswith("cudaMemcpyAsync"), copies
    assert len(launches) == 3, launches
    assert {k: kernels.launches[k] - before[k] for k in before if kernels.launches[k] != before[k]} == {
        "shatter_into": 1, "composite_dirty": 1, "blur_blend": 1}


@pytest.mark.cuda
def test_no_card_frame_reaches_a_plain_version(cuda_device, monkeypatch):
    """With the plain versions of blur_blend and shatter_into patched to
    raise, the card builds the scene, refreshes the display, steps and
    plays: no path on CUDA reaches them."""
    from coherence_tpu_torch.raster import framepath as FP
    from coherence_tpu_torch.raster import tiled_scene as TS

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((FP, "blur_blend_into_torch"), (FP, "apply_blur_rect"), (FP, "conv_blend_window"),
                      (FP, "blur"), (TS, "shatter_into_torch")):
        monkeypatch.setattr(mod, name, refuse)
    view, disp, key = _animated_scene(cuda_device)
    for k in range(5):
        disp.step_animated(key, *_animated_delta(k))
    disp.play_animated(key, [_animated_delta(k) for k in range(5, 10)], require_scan=True)
    torch.cuda.synchronize()
    assert bool((disp.rgba >= 0).all())


# ---------------------------------------------------------------------------
# The brush kernels: brush_stamp (BR1, plane and piece modes) and smear_walk
# (SM1) against their plain versions.  The cases are shared with the CPU
# tests of tests/test_torch_brush_kernel.py, which hold the plain versions
# to the JAX package and the kernels' host side to brute force.
# ---------------------------------------------------------------------------

BRUSH_RADII = [1.0, 12.0, 15.0, 20.0, 120.0]
BRUSH_FAR = 32767  # raster/brush_tiles.py _FAR: a point the scatter drops


def brush_case(radius: float, seed: int = 0):
    """A brush-tile group of four strokes of mkround(radius, .) brushes as
    BrushTileBuild stages it: (hp, wp, bhb, bwb, npb, items), each item
    (key, padded patch, offsets, valid, points, fill, (wr, hr), pieces).
    Stroke 0 stamps at the plane's four corners and along it, some stamps
    invalid, points at every edge of the plane, dropped (_FAR) and
    repeated; stroke 1 a second opacity with more stamps than one round of
    the kernel (256) where the radius allows; stroke 2 is empty (no valid
    stamp, every point dropped); stroke 3 has half its stamps invalid and
    every point twice.  Pieces: the 2x2 real tiles after the bhb x bwb
    margin, the plane's origin and its bottom-right corner."""
    from coherence_tpu_torch.raster import aa as raa
    from coherence_tpu_torch.raster import brush as TB
    from coherence_tpu_torch.raster import region as TRG

    rng = np.random.default_rng(seed * 1000 + int(radius * 10))
    bh = bw = 2 * int(np.ceil(radius)) + 1
    wr = hr = (bw - 1) // 2
    bhb, bwb = TRG.bucket_hw(bh, bw)
    hp, wp = 3 * bhb + 2 * TILE_H, 3 * bwb + 2 * TILE_W
    n_stamps = [40, 300, 12, 60] if radius < 100 else [16, 24, 4, 10]
    items = []
    for si, n in enumerate(n_stamps):
        offs = np.stack([rng.integers(0, hp - bhb + 1, n), rng.integers(0, wp - bwb + 1, n)], axis=1)
        if si == 0:
            offs[:4] = [(0, 0), (0, wp - bwb), (hp - bhb, 0), (hp - bhb, wp - bwb)]
        val = np.ones(n, bool)
        if si in (0, 3):
            val[rng.random(n) < (0.2 if si == 0 else 0.5)] = False
            val[:4] = True
        if si == 2:
            val[:] = False
        pts = offs + (hr, wr)
        if si == 0:
            pts[4:10] = [(0, 5), (hp - 1, 7), (9, 0), (11, wp - 1), (0, 0), (hp - 1, wp - 1)]
            pts[10:13] = BRUSH_FAR
            pts[13] = pts[12] = pts[14]
        if si == 2:
            pts[:] = BRUSH_FAR
        if si == 3:
            pts[n // 2 :] = pts[: n - n // 2]
        patch = np.zeros((bhb, bwb), np.int32)
        patch[:bh, :bw] = TB.drawround_alpha(radius, [0.5, 0.8, 0.3, 1.0][si])
        a = int(rng.integers(1, 256))
        fill = np.append(rng.integers(0, a + 1, 3), a).astype(np.int32)
        pieces = [(si * 4 + ty * 2 + tx, bhb + ty * TILE_H, bwb + tx * TILE_W) for ty in range(2) for tx in range(2)]
        if si == 0:
            pieces += [(100, 0, 0), (101, hp - TILE_H, wp - TILE_W)]
        if si == 2:
            pieces = pieces[:1]
        items.append((f"stroke{si}", patch, offs.astype(np.int32), val, pts.astype(np.int32), fill, (wr, hr), pieces))
    npb = raa.span_bucket(max(n_stamps), floor=8)
    return hp, wp, bhb, bwb, npb, items


def plane_inputs(case):
    """brush_case's plane-mode inputs: (brushes, offsets, valid, hp, wp)."""
    from coherence_tpu_torch.raster.brush_tiles import _group_lists

    hp, wp, _, _, npb, items = case
    brushes, offsets, valid = _group_lists(npb, items)[:3]
    return brushes, offsets, valid, hp, wp


SMEAR_DIRS = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def smear_case(radius: float, seed: int = 0, n: int = 60):
    """(canvas (H, W, 4) int32 premultiplied, opacity (bh, bw) int32,
    offsets [(row, col)], dirs [(dx, dy)]): a walk of n steps over all nine
    directions (each at least once, then at random) that touches the
    canvas's every edge, the opacity drawround_alpha(radius, 1.0) with its
    0 corners (al == 0 writes the source) and its 255 centre."""
    from coherence_tpu_torch.raster import brush as TB

    rng = np.random.default_rng(seed * 1000 + int(radius * 10))
    opac = TB.drawround_alpha(radius, 1.0)
    bh, bw = opac.shape
    height, width = bh + 40, bw + 56
    canvas = blur_content(seed + 7, height, width)
    dirs = SMEAR_DIRS + [SMEAR_DIRS[k] for k in rng.integers(0, 9, n - 9)]
    offsets = []
    for k, (dx, dy) in enumerate(dirs):
        if k < 4:  # the four corners of the range a step may take
            r = [1, height - bh - 1][k % 2]
            c = [1, width - bw - 1][k // 2]
        else:
            r, c = int(rng.integers(1, height - bh)), int(rng.integers(1, width - bw))
        offsets.append((r, c))
    return canvas, opac.astype(np.int32), offsets, dirs


# smear_walk's walks beside smear_case's: (kind, radius).  Window mode at
# radius 15 (the demo's 31x31 patch) and at 44 (89x89, the largest patch of
# window mode: smear.cu window_shape); global mode at 45, just past it.
SMEAR_WALKS = [("dense", 15.0), ("jumps", 15.0), ("carry", 15.0), ("wide", 15.0), ("wide_opacity", 12.0),
               ("dense", 44.0), ("jumps", 45.0)]


def _stroke_walk(radius: float, points, height: int, width: int):
    """smear()'s steps for a brush of `radius` along `points` over an
    (height, width) canvas at the origin: (offsets, dirs), each point's
    patch corner and direction (find_smear_directions), the points whose
    patch or source leaves the canvas clipped as smear() clips them."""
    from coherence_tpu_torch.raster import brush as TB

    bh = bw = 2 * int(np.ceil(radius)) + 1
    rad = (bh - 1) // 2
    offsets, dirs = [], []
    for (x, y), (dx, dy) in TB.find_smear_directions(points):
        row, col = y - rad + 1, x - rad + 1
        if 0 <= row - 1 - abs(dy) and 0 <= col - 1 - abs(dx) and row + bh + 1 <= height and col + bw + 1 <= width:
            offsets.append((row, col))
            dirs.append((dx, dy))
    return offsets, dirs


def _polyline_points(corners):
    """points_of_brushstroke_smear of a polyline through `corners`."""
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.raster import brush as TB

    segs = tuple(gpath.Straight(a, b) for a, b in zip(corners, corners[1:]))
    path = gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, False, segs),))
    return TB.points_of_brushstroke_smear((TB.mkround(1.0, 1.0), path))


def smear_walk_case(kind: str, radius: float, seed: int = 0):
    """(canvas, opacity, offsets, dirs) of a smear walk over a canvas larger
    than window mode's window, so that the window moves:
      * dense: a zigzag stroke, every point on the canvas: the walk drifts
        past the window's margin again and again, and the second pass
        restarts at step 0, far from the last step;
      * jumps: a stroke that leaves the canvas twice and comes back, its
        points clipped as smear() clips them, so that the walk jumps;
      * carry: unit moves along each step's own direction, turning now and
        then, so that each step's source is the last step's patch, which
        that step just wrote;
      * wide: the dense walk over a canvas whose middle band holds channels
        outside 0..255 (negative, and up to 2^20): window mode's packed walk
        meets it partway and the walk goes on in device memory;
      * wide_opacity: the dense walk under an opacity plane outside 0..255:
        in device memory from the start."""
    from coherence_tpu_torch.raster import brush as TB

    rng = np.random.default_rng(seed * 1000 + int(radius * 10) + len(kind))
    opac = TB.drawround_alpha(radius, 1.0).astype(np.int32)
    bh, bw = opac.shape
    span = 3 if radius < 30 else 1  # zigzag legs
    height, width = bh + 180, bw + 300 * span
    canvas = blur_content(seed + 11, height, width)
    if kind == "carry":
        units = [(dx, dy) for dx, dy in SMEAR_DIRS if (dx, dy) != (0, 0)]
        row, col = height // 2, width // 2
        (dx, dy), offsets, dirs = units[0], [], []
        for _ in range(600):
            if rng.random() < 0.08:
                dx, dy = units[int(rng.integers(0, len(units)))]
            if not (2 <= row + dy <= height - bh - 2 and 2 <= col + dx <= width - bw - 2):
                dx, dy = -dx, -dy
            row, col = row + dy, col + dx
            offsets.append((row, col))
            dirs.append((dx, dy))
        return canvas, opac, offsets, dirs
    if kind == "wide":
        band = canvas[:, 2 * width // 5 : 3 * width // 5]
        band[...] = rng.integers(-(2**10), 2**20, band.shape)
    if kind == "wide_opacity":
        opac = opac * 3 - 100
    lo_x, hi_x = bw, width - bw
    if kind in ("dense", "wide", "wide_opacity"):
        corners = [(lo_x, bh + 10.0)] + [(hi_x if k % 2 == 0 else lo_x, bh + 10.0 + 150.0 * (k + 1) / (2 * span))
                                         for k in range(2 * span)]
    else:
        corners = [(lo_x, height / 2), (width + 60.0, height / 3), (width / 2, height - bh - 2.0), (-70.0, bh / 2),
                   (hi_x, height / 2)]
    offsets, dirs = _stroke_walk(radius, _polyline_points(corners), height, width)
    return canvas, opac, offsets, dirs


@pytest.mark.cuda
@pytest.mark.parametrize("radius", BRUSH_RADII)
def test_brush_stamp_plane_mode_matches_plain(cuda_device, radius):
    """brush_stamp in plane mode against _stamp_alpha_torch, bit for bit,
    each launch counted once."""
    from coherence_tpu_torch.raster import brush as TB

    brushes, offsets, valid, hp, wp = plane_inputs(brush_case(radius))
    want = TB._stamp_alpha_torch(brushes, offsets, valid, hp, wp, "cpu")
    before = kernels.launches["brush_stamp"]
    got = TB._stamp_alpha(brushes, offsets, valid, hp, wp, cuda_device)
    one = TB._stamp_alpha(brushes[:1], offsets[:1, :5], valid[:1, :5], hp, wp, cuda_device)
    torch.cuda.synchronize()
    assert kernels.launches["brush_stamp"] == before + 2
    assert torch.equal(got.cpu(), want) and bool((want > 0).any())
    assert torch.equal(one.cpu(), TB._stamp_alpha_torch(brushes[:1], offsets[:1, :5], valid[:1, :5], hp, wp, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", BRUSH_RADII)
def test_brush_stamp_piece_mode_matches_plain(cuda_device, radius):
    """brush_stamp in piece mode against _group_block_torch, bit for bit:
    every piece, the padding pieces, a stroke of more stamps than one round
    of records where the radius allows; one launch a group."""
    from coherence_tpu_torch.raster import brush_tiles as TBT

    hp, wp, bhb, bwb, npb, items = brush_case(radius)
    want = TBT.BrushTileBuild(1, 1, "cpu")._group_block_torch(hp, wp, bhb, bwb, npb, items)
    before = kernels.launches["brush_stamp"]
    got = TBT.BrushTileBuild(1, 1, cuda_device)._group_block(hp, wp, bhb, bwb, npb, items)
    torch.cuda.synchronize()
    assert kernels.launches["brush_stamp"] == before + 1
    assert got.shape == want.shape and torch.equal(got.cpu(), want)
    assert bool((want != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [105.0, 120.0, 250.0])
def test_brush_stamp_patch_paths(cuda_device, radius):
    """Both modes against the plain versions on each of the patch's paths:
    radius 105's 211x211 patch (47,920 bytes: under 48 KB alone, past it
    with the block's static lists) and radius 120's 241x241 patch fold from
    shared memory, radius 250's 501x501 one (past kernels.BRUSH_PATCH_SMEM)
    from device memory; the blocks an SM holds with the launch's shared
    memory."""
    from coherence_tpu_torch.raster import brush as TB
    from coherence_tpu_torch.raster import brush_tiles as TBT

    case = brush_case(radius)
    brushes, offsets, valid, hp, wp = plane_inputs(case)
    lists = kernels.brush_plane_lists(brushes, offsets, valid, hp, wp)
    need = int(kernels.brush_patch_bytes(*(int(v) for v in lists.strokes[0, 2:4])))
    in_shared = need <= kernels.BRUSH_PATCH_SMEM
    assert in_shared == (radius < 200) and lists.patch_smem == (need if in_shared else 0)
    assert radius != 105.0 or 48 * 1024 - 3072 < need <= 48 * 1024
    assert kernels.brush_stamp_blocks_per_sm(False, lists.patch_smem) >= 1
    got = TB._stamp_alpha(brushes, offsets, valid, hp, wp, cuda_device)
    block = TBT.BrushTileBuild(1, 1, cuda_device)._group_block(*case[:5], case[5])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), TB._stamp_alpha_torch(brushes, offsets, valid, hp, wp, "cpu"))
    assert torch.equal(block.cpu(), TBT.BrushTileBuild(1, 1, "cpu")._group_block_torch(*case[:5], case[5]))


@pytest.mark.cuda
def test_brush_stamp_many_pieces_and_records(cuda_device):
    """A group of one long stroke over 24 x 20 tiles (480 pieces, 7,848
    stamps in 8,192 records: 32 rounds) in piece mode, and its plane in
    plane mode, against the plain versions."""
    from coherence_tpu_torch.raster import brush as TB
    from coherence_tpu_torch.raster import brush_tiles as TBT

    build = TBT.BrushTileBuild(24, 20, "cpu")
    stroke = (TB.mkround(12.0, 0.5), _long_stroke_path())
    assert build.add_stroke("long", stroke, np.array([120, 40, 10, 185], np.int32))
    (gkey, items), = build.groups.items()
    want = build._group_block_torch(*gkey, items)
    got = TBT.BrushTileBuild(24, 20, cuda_device)._group_block(*gkey, items)
    brushes, offsets, valid = TBT._group_lists(gkey[4], items)[:3]
    plane = TB._stamp_alpha(brushes, offsets, valid, gkey[0], gkey[1], cuda_device)
    torch.cuda.synchronize()
    assert len(items[0][7]) == 480 and offsets.shape[1] == 8192
    assert torch.equal(got.cpu(), want)
    assert torch.equal(plane.cpu(), TB._stamp_alpha_torch(brushes, offsets, valid, gkey[0], gkey[1], "cpu"))


def _long_stroke_path():
    """A zigzag over a 2560 x 1536 frame: 7,848 stamps of a radius-12 brush."""
    from coherence_tpu_torch.geometry import path as gpath

    pts = [(40.0, 40.0), (2500.0, 300.0), (60.0, 700.0), (2480.0, 1100.0), (100.0, 1490.0)]
    segs = tuple(gpath.Straight(a, b) for a, b in zip(pts, pts[1:]))
    return gpath.Path(gpath.EVEN_ODD, (gpath.Subpath(False, False, segs),))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", BRUSH_RADII)
def test_smear_walk_matches_plain(cuda_device, radius):
    """smear_walk against _smear_walk_torch, both passes in one launch, bit
    for bit: every direction, al == 0 texels, a patch beyond the pixels the
    kernel holds in registers at radius 120."""
    from coherence_tpu_torch.raster import brush as TB

    canvas, opac, offsets, dirs = smear_case(radius)
    bh, bw = opac.shape
    want = TB._smear_walk_torch(torch.from_numpy(canvas.copy()), torch.from_numpy(opac), offsets, dirs, bh, bw)
    cv = torch.from_numpy(canvas).to(cuda_device)
    before = kernels.launches["smear_walk"]
    got = TB._smear_walk(cv, torch.from_numpy(opac).to(cuda_device), offsets, dirs, bh, bw)
    torch.cuda.synchronize()
    assert kernels.launches["smear_walk"] == before + 1
    assert got.data_ptr() == cv.data_ptr()  # in place
    assert torch.equal(got.cpu(), want) and not np.array_equal(want.numpy(), canvas)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,radius", SMEAR_WALKS)
def test_smear_walk_modes_match_plain(cuda_device, kind, radius):
    """smear_walk in the mode its kernel picks (window mode up to radius 44,
    global mode from 45) against _smear_walk_torch, bit for bit, in place,
    one launch: a long dense walk that moves its window many times, a walk
    with jumps, a walk whose every step's source is the last step's patch,
    walks over channels or under an opacity outside 0..255 (window mode
    goes on in device memory); the pass restart in each.  The launch's
    stats say which mode ran, how often the window loaded and from which
    step the walk ran in device memory."""
    from coherence_tpu_torch.raster import brush as TB

    canvas, opac, offsets, dirs = smear_walk_case(kind, radius)
    bh, bw = opac.shape
    total = kernels.SMEAR_PASSES * len(offsets)
    assert (kind.startswith("wide")) == bool(((canvas < 0) | (canvas > 255)).any() or ((opac < 0) | (opac > 255)).any())
    want = TB._smear_walk_torch(torch.from_numpy(canvas.copy()), torch.from_numpy(opac), offsets, dirs, bh, bw)
    cv = torch.from_numpy(canvas).to(cuda_device)
    stats = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
    before = kernels.launches["smear_walk"]
    got = kernels.smear_walk(cv, torch.from_numpy(opac).to(cuda_device), offsets, dirs, bh, bw, stats=stats)
    torch.cuda.synchronize()
    assert kernels.launches["smear_walk"] == before + 1
    assert got.data_ptr() == cv.data_ptr()  # in place
    assert torch.equal(got.cpu(), want) and not np.array_equal(want.numpy(), canvas)
    wh, ww, loads, device_from = stats.tolist()
    if radius > 44:
        assert (wh, ww, loads, device_from) == (0, 0, 0, 0)
        return
    assert (wh, ww) == (bh + 64, bw + 64)  # a margin of 32 pixels
    if kind == "wide_opacity":
        assert (loads, device_from) == (0, 0)
    elif kind == "wide":
        assert 0 < device_from < total and loads >= 1
    else:
        assert device_from == total and loads >= {"dense": 10, "jumps": 3}.get(kind, 1)


@pytest.mark.cuda
def test_smear_walk_stats_modes_by_patch(cuda_device):
    """smear.cu's window_shape, read through the stats of a one-step walk:
    window mode up to the 89x89 patch with a margin of 32 pixels, the
    window cut to a small canvas; global mode from the 91x91 patch and for
    a 1 x 8193 patch (more than 16 pixels a thread)."""
    def window(bh, bw, height, width):
        cv = torch.zeros((height, width, 4), dtype=torch.int32, device=cuda_device)
        opac = torch.full((bh, bw), 128, dtype=torch.int32, device=cuda_device)
        stats = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
        kernels.smear_walk(cv, opac, [(1, 1)], [(1, 1)], bh, bw, stats=stats)
        return tuple(stats.tolist()[:2])

    assert window(31, 31, 400, 400) == (95, 95)
    assert window(89, 89, 400, 400) == (153, 153)
    assert window(31, 31, 40, 70) == (40, 70)
    assert window(91, 91, 400, 400) == (0, 0)
    assert window(1, 8193, 8, 8300) == (0, 0)


@pytest.mark.cuda
def test_brush_wrappers_reject_bad_inputs(cuda_device):
    from coherence_tpu_torch.raster import brush as TB

    brushes, offsets, valid, hp, wp = plane_inputs(brush_case(12.0))
    moved = offsets.copy()
    moved[1, 3] = (hp - brushes.shape[1] + 1, 0)  # a valid stamp whose padded patch leaves the plane
    with pytest.raises(ValueError):
        TB._stamp_alpha(brushes, moved, valid, hp, wp, cuda_device)
    moved[1, 3] = (-1, 0)
    with pytest.raises(ValueError):
        kernels.brush_stamp_planes(brushes, moved, valid, hp, wp, cuda_device)
    off = valid.copy()
    off[1, 3] = False  # the same stamp invalid: no fault
    TB._stamp_alpha(brushes, moved, off, hp, wp, cuda_device)
    with pytest.raises(ValueError):
        kernels.brush_stamp_planes(brushes, offsets, valid, hp, wp, "cpu")
    with pytest.raises(ValueError):
        kernels.brush_stamp_planes(brushes, offsets[:, :-1], valid, hp, wp, cuda_device)
    hp_, wp_, bhb, bwb, npb, items = brush_case(12.0)
    from coherence_tpu_torch.raster.brush_tiles import _group_lists

    lists = list(_group_lists(npb, items))
    lists[6] = lists[6].copy()
    lists[6][0] = (0, hp_ - TILE_H + 1, 0)  # a piece past the plane's last row
    with pytest.raises(ValueError):
        kernels.brush_stamp_pieces(*lists, hp_, wp_, cuda_device)

    canvas, opac, offsets, dirs = smear_case(12.0)
    bh, bw = opac.shape
    cv, op = torch.from_numpy(canvas).to(cuda_device), torch.from_numpy(opac).to(cuda_device)
    for bad_off, bad_dir in (((0, 5), (0, 1)), ((5, 0), (1, 0)), ((cv.shape[0] - bh, 5), (0, -1)),
                             ((5, cv.shape[1] - bw), (-1, 0))):
        with pytest.raises(ValueError):
            TB._smear_walk(cv, op, [bad_off], [bad_dir], bh, bw)
    for args in ((cv.cpu(), op), (cv, op.cpu()), (cv.long(), op), (cv, op[:, 1:]), (cv[:, :, :3], op),
                 (cv.transpose(0, 1), op)):
        with pytest.raises(ValueError):
            kernels.smear_walk(*args, offsets, dirs, bh, bw)


@pytest.mark.cuda
def test_no_card_brush_reaches_a_plain_version(cuda_device, monkeypatch):
    """With the brush kernels' plain versions patched to raise, a brush
    sprite, a smear and a brush-tile build run on the card: each reaches
    brush_stamp or smear_walk, one launch each, and no per-stamp loop of
    torch operations.  Their region programs (the stroke's bloat, the
    smear's caf) launch the region kernels besides."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.geometry import shapes as gshapes
    from coherence_tpu_torch.raster import brush as TB
    from coherence_tpu_torch.raster import brush_tiles as TBT
    from coherence_tpu_torch.raster import fills, region

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((TB, "_stamp_alpha_torch"), (TB, "_smear_walk_torch"), (TBT, "_stamp_alpha_torch"),
                      (TBT.BrushTileBuild, "_group_block_torch")):
        monkeypatch.setattr(mod, name, refuse)
    stroke = (TB.mkround(6.0, 0.5), gshapes.circle(60.0, 50.0, 30.0))
    before = dict(kernels.launches)
    shp, _ = TB.shape_of_brushstroke(stroke, cuda_device)
    spr = TB.sprite_of_brushstroke(stroke, fills.plain(C.darkorange), shp, cuda_device)
    base = region.fillshape(region.shape_of_box((1, 1, 120, 90), cuda_device), fills.plain(C.dissolve(C.blue, delta=90)))
    smeared = TB.smear(base, stroke, cuda_device)
    build = TBT.BrushTileBuild(2, 2, cuda_device)
    assert build.add_stroke("s", stroke, np.array([120, 40, 10, 185], np.int32))
    blocks, registry = build.flush()
    torch.cuda.synchronize()
    launched = {k: kernels.launches[k] - before[k] for k in before if kernels.launches[k] != before[k]}
    region_kernels = ("caf", "tight_bounds", "box_morph", "convolve_canvas")
    assert {k: n for k, n in launched.items() if k not in region_kernels} == {"brush_stamp": 2, "smear_walk": 1}
    assert bool((spr.rgba > 0).any()) and smeared is not None and len(blocks) == 1 and registry["s"]


# --- TR1, the tile rasterizer ------------------------------------------------
# Items as raster/tile_raster.py's TileBuild stages them: per family a
# (rows, starts, ends) triple of inclusive, tile-relative spans (1x coverage
# and crossing over 64 x 128, 16x AA over the 1040 x 2064 t-plane) and a
# premultiplied fill.  The fills: translucent, opaque, alpha 0, and a second
# translucent one for the empty item.
TILE_FILLS = [(90, 40, 10, 170), (200, 120, 30, 255), (0, 0, 0, 0), (17, 34, 51, 68)]
# Spans at the planes' edges (tile column 0 and 127, scaled column 2063) and
# on rows the scatter drops (the last two of each list).
TILE_EDGE_SPANS = [(0, 0, 0), (1, 127, 127), (2, 0, 127), (63, 126, 127), (64, 3, 9), (70, 0, 127)]
AA_EDGE_SPANS = [(0, 0, 0), (5, 2063, 2063), (1039, 2000, 2063), (16, 0, 2063), (1040, 0, 100), (1100, 5, 9)]


def tile_spans(rng, k: int, h: int, w: int, edge_spans=()):
    """k spans over an (h, w) plane: `edge_spans` first, then random ones in
    shuffled row order, about one in eight reversed (end < start: the
    scatter's count goes negative between them) and many overlapping."""
    k_rand = max(0, k - len(edge_spans))
    rows = rng.integers(0, h, k_rand)
    a, b = rng.integers(0, w, k_rand), rng.integers(0, w, k_rand)
    s, e = np.minimum(a, b), np.maximum(a, b)
    flip = rng.random(k_rand) < 0.125
    s[flip], e[flip] = e[flip], s[flip]
    fixed = np.asarray(list(edge_spans), np.int64).reshape(-1, 3)[:k]
    return tuple(np.concatenate([fixed[:, i], part]).astype(np.int64) for i, part in enumerate((rows, s, e)))


def tile_edge_items(cls: int, seed: int = 0):
    """Four edge items of capacity class `cls` (raster/tile_raster.py
    _CLASSES): [(cov, cross, aa, fill)].  Item 0 is at the class's capacity,
    item 1 at a quarter of it, item 2 small, item 3 empty (no span at
    all)."""
    from coherence_tpu_torch.raster import tile_raster as TTR

    k1, ka = TTR._CLASSES[cls]
    rng = np.random.default_rng(100 + 17 * cls + seed)
    items = []
    for j, (n1, na) in enumerate(((k1 // 2, ka // 2), (k1 // 8, ka // 8), (9, 40), (0, 0))):
        cov = tile_spans(rng, n1, 64, 128, TILE_EDGE_SPANS if j < 2 else ())
        cross = tile_spans(rng, n1, 64, 128, TILE_EDGE_SPANS[::-1] if j < 2 else ())
        aa = tile_spans(rng, na, 1040, 2064, AA_EDGE_SPANS if j < 2 else ())
        items.append((cov, cross, aa, TILE_FILLS[j]))
    return items


def tile_interior_items(seed: int = 0):
    """Four interior items: [(cross, fill)], up to _K_INTERIOR / 2 spans."""
    rng = np.random.default_rng(200 + seed)
    return [(tile_spans(rng, n, 64, 128, TILE_EDGE_SPANS if j < 2 else ()), TILE_FILLS[j])
            for j, n in enumerate((128, 40, 3, 0))]


def _full_rows(rows, w: int):
    """Full-width spans on `rows` of a w-column plane."""
    rows = np.asarray(rows, np.int64)
    return rows, np.zeros_like(rows), np.full_like(rows, w - 1)


def _joined(*parts):
    return tuple(np.concatenate([p[i] for p in parts]).astype(np.int64) for i in range(3))


def _odd_spans(rng, rows, w: int, k: int):
    """k spans on `rows` (cycled) that the scatter counts in every way:
    duplicated, overlapping, reversed, zero-length (end = start - 1), and
    at columns 0, w - 1 and w (a start there adds only past the mask)."""
    rows = np.resize(np.asarray(rows, np.int64), k)
    a, b = rng.integers(0, w, k), rng.integers(0, w, k)
    s, e = np.minimum(a, b), np.maximum(a, b)
    kind = np.arange(k) % 6
    s[kind == 1], e[kind == 1] = e[kind == 1], s[kind == 1]  # reversed
    e[kind == 2] = s[kind == 2] - 1  # zero-length
    s[kind == 3], e[kind == 3] = 0, w - 1
    s[kind == 4] = w  # +1 at column w: nothing in the row, -1 at end + 1 before it
    dup = kind == 5
    s[dup], e[dup], rows[dup] = np.roll(s, 1)[dup], np.roll(e, 1)[dup], np.roll(rows, 1)[dup]
    return rows, s, e


# tile_raster.cu's kLaneCap and kBinCap: a row of more spans than kLaneCap is
# built by a warp, one of more than kBinCap by the block, and a band of more
# than kBinCap binned in runs (tests/test_torch_tile_kernel.py reads both
# from the source).
TILE_LANE_CAP, TILE_BIN_CAP = 32, 6144


def tile_capacity_items(seed: int = 0):
    """Edge items at the limits of TR1's paths: [(cov, cross, aa, fill)].

      * item 0 is at the last capacity class's limit (2048 coverage, 2048
        crossing and 32,768 AA spans), every AA span in band 1's t-rows
        (256..527, the first and last 16 shared with bands 0 and 2): t-row
        300 holds TILE_BIN_CAP + 900 spans, 301 holds 5 x TILE_LANE_CAP,
        302 TILE_LANE_CAP + 1 and 303 exactly TILE_LANE_CAP, the rest
        spread over the band; its coverage reaches every word of those
        t-rows;
      * item 1 puts its AA spans on the t-rows two bands share (256..271,
        512..527, 768..783) and its coverage on the pixel rows over them;
      * item 2 holds odd 1x spans (duplicated, reversed, zero-length,
        columns 0, 127 and 128) and rows the scatter drops;
      * item 3 has coverage but no AA span at all.
    All four fit the last capacity class (raster/tile_raster.py _CLASSES)."""
    rng = np.random.default_rng(300 + seed)
    big = TILE_BIN_CAP + 900
    heavy = [(300, big), (301, 5 * TILE_LANE_CAP), (302, TILE_LANE_CAP + 1), (303, TILE_LANE_CAP)]
    rest = 32768 - sum(k for _, k in heavy)
    aa0 = _joined(*(_odd_spans(rng, [r], 2064, k) for r, k in heavy),
                  _odd_spans(rng, rng.integers(256, 528, rest), 2064, rest))
    cov0 = _joined(_full_rows(range(15, 34), 128), tile_spans(rng, 2048 - 19, 64, 128, TILE_EDGE_SPANS))
    cross0 = tile_spans(rng, 2048, 64, 128, TILE_EDGE_SPANS[::-1])
    shared = np.concatenate([np.arange(256, 272), np.arange(512, 528), np.arange(768, 784)])
    aa1 = _joined(_odd_spans(rng, shared, 2064, 3000), _full_rows(shared[::5], 2064))
    cov1 = _joined(_full_rows([15, 16, 31, 32, 47, 48], 128), _odd_spans(rng, [15, 16, 31, 32, 47, 48], 128, 60))
    cross1 = tile_spans(rng, 300, 64, 128)
    cov2 = _joined(_odd_spans(rng, rng.integers(0, 64, 600), 128, 600), tile_spans(rng, 6, 64, 128, TILE_EDGE_SPANS))
    cross2 = _joined(_odd_spans(rng, rng.integers(0, 64, 600), 128, 600), tile_spans(rng, 6, 64, 128, TILE_EDGE_SPANS))
    aa2 = _joined(_odd_spans(rng, rng.integers(0, 1040, 5000), 2064, 5000), tile_spans(rng, 6, 1040, 2064, AA_EDGE_SPANS))
    cov3, cross3 = tile_spans(rng, 200, 64, 128), tile_spans(rng, 200, 64, 128)
    return [(cov0, cross0, aa0, TILE_FILLS[0]), (cov1, cross1, aa1, TILE_FILLS[1]),
            (cov2, cross2, aa2, TILE_FILLS[3]), (cov3, cross3, tile_spans(rng, 0, 1040, 2064), TILE_FILLS[0])]


def tile_build_items(items, edge: bool):
    """The items as TileBuild stages them: (key, tile, cov, cross, aa, fill)
    or (key, tile, cross, fill)."""
    if edge:
        return [(f"k{j}", j, cov, cross, aa, fill) for j, (cov, cross, aa, fill) in enumerate(items)]
    return [(f"k{j}", j, cross, fill) for j, (cross, fill) in enumerate(items)]


def _tile_block(device, items, nb: int, edge: bool):
    """TR1's block for `items` on `device` and the plain version's."""
    from coherence_tpu_torch.raster import tile_raster as TTR

    staged = tile_build_items(items, edge)
    build = TTR.TileBuild(1, 1, device)
    return build.block(staged, nb, edge), build.block_torch(staged, nb, edge)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["class0", "class1", "class2", "class3", "class4", "interior"])
def test_tile_raster_matches_plain(cuda_device, case):
    """TR1 at every capacity class (items at capacity, reversed and
    overlapping spans, spans at the planes' edges, dropped rows, an empty
    item, fills with alpha 0 and 255) and in interior mode, against the
    plain version on the card, bit for bit; padding slots zero."""
    edge = case != "interior"
    items = tile_edge_items(int(case[-1])) if edge else tile_interior_items()
    before = kernels.launches["tile_raster"]
    got, want = _tile_block(cuda_device, items, 8, edge)
    torch.cuda.synchronize()
    assert kernels.launches["tile_raster"] == before + 1
    assert torch.equal(got, want)
    assert not bool(got[len(items):].any()) and bool(got[0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb", [(0, 8), (5, 8), (3, 16)])
def test_tile_raster_empty_and_padded_blocks(cuda_device, n, nb):
    """A block with no item is all zero; one with padding slots has them
    zero, in both modes (the block starts from torch.empty: TR1 writes
    every slot)."""
    items = (tile_edge_items(0) + tile_edge_items(1, seed=1))[:n]
    for edge, its in ((True, items), (False, [(cross, fill) for _, cross, _, fill in items])):
        torch.full((64 * nb, 8192), -1, dtype=torch.int32, device=cuda_device)  # leave garbage in the allocator
        got, want = _tile_block(cuda_device, its, nb, edge)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not bool(got[n:].any())


def _tile_flush_scene(name: str, device):
    """A staged TileBuild on `device`: the bench.py lion at 1920x1080, or a
    strip of config 5 (its top 4 tile rows at 3840 wide)."""
    from coherence_tpu_torch.scene import fastframe

    if name == "lion":
        objs, _, _ = examples.bench_scene(1920, 1080, blob_radius=60, blob_at=(120, 400), f_box=(40, 320, 1680, 1060))
        nty, ntx, w, h = 17, 15, 1920, 1088
    else:
        objs, _, _ = examples.interactive_4k_scene(3840, 2160)
        nty, ntx, w, h = 4, 30, 3840, 256
    return fastframe.stage_tiled_scene(nty, ntx, w, h, [(o.idset, o) for o in objs], device)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lion", "config5_strip"])
def test_tile_build_flush_matches_plain(cuda_device, name):
    """A whole TileBuild.flush on the card equals the plain version of each
    of its blocks, and issues exactly one copy and one launch."""
    tb = _tile_flush_scene(name, cuda_device)
    batches = list(tb.batches())
    assert len(batches) >= 2
    before = kernels.launches["tile_raster"]
    blocks, registry = tb.flush()
    torch.cuda.synchronize()
    assert kernels.launches["tile_raster"] == before + 1
    assert len(blocks) == len(batches)
    for block, (items, nb, edge) in zip(blocks, batches):
        assert torch.equal(block, tb.block_torch(items, nb, edge))
    assert sum(len(v) for v in registry.values()) == sum(len(items) for items, _, _ in batches)
    assert _issued_by(tb.flush) == (1, 1)


def tile_flush_batches():
    """One flush of every capacity class, tile_capacity_items and interior
    items: [(items, nb, edge)], as TileBuild.batches() gives them."""
    edge = [(tile_build_items(tile_edge_items(c), True), 8, True) for c in range(5)]
    return edge + [(tile_build_items(tile_capacity_items(), True), 8, True),
                   (tile_build_items(tile_interior_items(), False), 16, False)]


@pytest.mark.cuda
def test_tile_raster_one_launch_of_every_class(cuda_device):
    """A TileBuild holding every capacity class, the limits' items and
    interior items flushes in one launch and one copy (2 issued operations,
    profile_general.issued), equal to the plain version block by block; its
    blocks are views of one tensor."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from coherence_tpu_torch.raster import tile_raster as TTR
    from profile_general import issued

    batches = tile_flush_batches()
    tb = TTR.TileBuild(1, 1, cuda_device)
    tb.batches = lambda: iter(batches)
    before = kernels.launches["tile_raster"]
    blocks, _ = tb.flush()
    torch.cuda.synchronize()
    assert kernels.launches["tile_raster"] == before + 1
    assert len({b.untyped_storage().data_ptr() for b in blocks}) == 1
    for block, (items, nb, edge) in zip(blocks, batches):
        assert torch.equal(block, tb.block_torch(items, nb, edge))
    assert issued(torch, tb.flush) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("item", range(4))
def test_tile_raster_at_its_limits(cuda_device, item):
    """Each of tile_capacity_items alone in a padded block (the item at
    capacity with a row past the bins and rows past a lane; the t-rows two
    bands share; odd 1x spans; coverage without AA spans), and all four in
    one block, against the plain version, bit for bit."""
    items = tile_capacity_items()
    for its in ([items[item]], items):
        got, want = _tile_block(cuda_device, its, 8, True)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not bool(got[len(its):].any())


@pytest.mark.cuda
def test_tile_raster_fits_two_blocks_an_sm(cuda_device):
    """The occupancy the design is built for: two blocks an SM."""
    assert kernels.tile_raster_blocks_per_sm() >= 2


def _issued_by(fn):
    """(copies, launches) that fn() issues, as the CUDA runtime's rows of
    the profiler count them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return (sum(n.startswith(("cudaMemcpy", "cudaMemset")) for n in names),
            sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for n in names))


@pytest.mark.cuda
def test_tile_raster_reaches_no_plain_version(cuda_device, monkeypatch):
    """With the plain versions patched to raise, a tiled sprite and a scene
    build on the card rasterize through TR1 alone."""
    from coherence_tpu_torch.raster import tile_raster as TTR
    from coherence_tpu_torch.scene import fastframe

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("_edge_impl", "_interior_impl"):
        monkeypatch.setattr(TTR, name, refuse)
    monkeypatch.setattr(TTR.TileBuild, "block_torch", refuse)
    objs, blob, _ = examples.bench_scene(640, 384, blob_radius=60, blob_at=(120, 200), f_box=(40, 100, 600, 380))
    before = kernels.launches["tile_raster"]
    spr = fastframe.tiled_sprite_of_object(blob, 640, 384, cuda_device)
    view = fastframe.DeviceView(640, 384, atlas_cap=512, device=cuda_device)
    fastframe.scene_build_cache_clear()
    view.set_scene(objs, tiled=True)
    torch.cuda.synchronize()
    assert kernels.launches["tile_raster"] - before >= 2 and bool((spr.rgba > 0).any())


@pytest.mark.cuda
def test_tile_raster_wrappers_reject_bad_input(cuda_device):
    """CPU devices, columns outside the plane and mismatched families are
    refused before any launch."""
    items = tile_edge_items(0)
    cov, cross, aa, fills = ([it[k] for it in items] for k in range(4))
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([(cov, cross, aa, fills, 8)], "cpu")
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([(None, cross, None, fills, 8)], torch.device("cpu"))
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([(cov, cross, aa[:2], fills, 8)], cuda_device)
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([(cov, cross, aa, fills, 2)], cuda_device)
    wide = (np.array([3]), np.array([5]), np.array([128]))  # end + 1 = 129 > 128
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([(None, [wide], None, [fills[0]], 8)], cuda_device)
    wide_aa = (np.array([3]), np.array([-1]), np.array([5]))
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([([cov[0]], [cross[0]], [wide_aa], [fills[0]], 8)], cuda_device)

# --- SR1, the sprite rasterizer ----------------------------------------------
# Members as scene/fastframe.py's batched build gives them: a pixel box
# (x0, y0, w, h), a premultiplied fill, and per family a (rows, starts, ends)
# triple of inclusive spans in absolute coordinates (1x coverage and
# crossing; 16x AA, its t-plane's origin at 16 y0 - 32, 16 x0 - 32).  The
# fills: translucent, opaque, alpha 0, a second translucent one.
SPRITE_FILLS = [(90, 40, 10, 170), (200, 120, 30, 255), (0, 0, 0, 0), (17, 34, 51, 68)]
# Boxes that are not multiples of 16 or 128, one pixel wide, one pixel
# tall, one pixel, more than one band and strip, exactly one band and strip.
SPRITE_BOXES = [(-7, 5, 150, 37), (3, -20, 1, 40), (100, 100, 60, 1), (0, 0, 1, 1), (12, 30, 129, 17),
                (40, 8, 128, 16), (-300, 2, 301, 45)]


def sprite_spans(rng, k: int, r0: int, h: int, c0: int, w: int, margin: int):
    """k spans around a plane of h x w at (r0, c0): rows up to `margin`
    above and below it (the scatter drops those), columns up to `margin`
    past either side (it clips those), and _odd_spans' kinds: reversed,
    zero-length, full-width, starting at w, duplicated."""
    rows, s, e = _odd_spans(rng, rng.integers(-margin, h + margin, k), w + 2 * margin, k)
    return rows + r0, s + c0 - margin, e + c0 - margin


def sprite_member_spans(rng, box, n1: int, na: int):
    """(cov, cross, aa) of a member over `box`: n1 spans in each 1x family,
    na in the AA one; the coverage's first span covers the box's top row."""
    x0, y0, w, h = box
    cov = _joined(([y0], [x0], [x0 + w - 1]), sprite_spans(rng, n1, y0, h, x0, w, 3))
    cross = sprite_spans(rng, n1, y0, h, x0, w, 3)
    aa = sprite_spans(rng, na, 16 * y0 - 32, 16 * h + 16, 16 * x0 - 32, 16 * w + 16, 40)
    return cov, cross, aa


def sprite_case(name: str, seed: int = 0):
    """A group-mode case: (boxes, fills, cov, cross, aa), per member.

      * "ragged": SPRITE_BOXES with random spans on and off their planes;
        member 2 has no AA span (its family None), member 3 an empty
        minshape (its crossing spans are its coverage spans);
      * "heavy": two members wider than a strip whose AA family holds a
        t-row of TILE_BIN_CAP + 900 spans (the block's row of counts),
        rows of 5 x TILE_LANE_CAP and TILE_LANE_CAP + 1 spans (a warp's)
        and a band of more than TILE_BIN_CAP spans in all (binned in runs),
        their coverage over those rows;
      * "tall": members of 13, 10 and 3 bands with random spans on and off
        their planes (each band reads its own ranges of them)."""
    rng = np.random.default_rng(500 + seed)
    if name == "tall":
        boxes = [(3, -5, 60, 200), (-2, 11, 20, 150), (7, 3, 130, 40)]
        fams = [sprite_member_spans(rng, box, 4 * box[3] + 3, 40 * box[3] + 9) for box in boxes]
    elif name == "ragged":
        boxes, fams = list(SPRITE_BOXES), []
        for j, box in enumerate(boxes):
            x0, y0, w, h = box
            cov, cross, aa = sprite_member_spans(rng, box, 4 * h + 3, 40 * h + 9)
            if j == 2:
                aa = None
            if j == 3:
                cross = cov
            fams.append((cov, cross, aa))
    elif name == "heavy":
        boxes, fams = [(5, -9, 300, 40), (0, 0, 140, 20)], []
        for x0, y0, w, h in boxes:
            tw, t0 = 16 * w + 16, 16 * y0 - 32
            heavy = [(300, TILE_BIN_CAP + 900), (301, 5 * TILE_LANE_CAP), (302, TILE_LANE_CAP + 1),
                     (303, TILE_LANE_CAP)]
            aa = _joined(*(_odd_spans(rng, [r], tw, k) for r, k in heavy),
                         _odd_spans(rng, rng.integers(256, 528, 9000), tw, 9000),
                         _odd_spans(rng, rng.integers(0, 16 * h + 16, 2000), tw, 2000))
            aa = (aa[0] + t0, aa[1] + 16 * x0 - 32, aa[2] + 16 * x0 - 32)
            cov = _joined(_full_rows(range(15, 22), w), _odd_spans(rng, rng.integers(0, h, 300), w, 300))
            cov = (cov[0] + y0, cov[1] + x0, cov[2] + x0)
            cross = sprite_spans(rng, 200, y0, h, x0, w, 2)
            fams.append((cov, cross, aa))
    else:
        raise ValueError(name)
    fills = [SPRITE_FILLS[j % len(SPRITE_FILLS)] for j in range(len(boxes))]
    cov, cross, aa = (list(f) for f in zip(*fams))
    return boxes, fills, cov, cross, aa


def sprite_paths(device="cpu"):
    """Plain-filled paths and stroked paths of the port (a circle, a
    translucent rotated rectangle, a round-capped stroked circle, a
    hairline whose minshape is empty, fills of alpha 0 and 255), as the
    batched build groups them: (boxes, fills, cov, cross, aa) of every
    member, groups in order."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch import ident
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.geometry import shapes as gs
    from coherence_tpu_torch.raster import fills
    from coherence_tpu_torch.scene import fastframe
    from coherence_tpu_torch.scene import render as R

    def obj(fill, shape, t=()):
        return R.Obj(ident.new_ids(), R.Basic(fills.plain(fill), shape), tuple(t), R.OVER)

    round_spec = gs.StrokeSpec(startcap=gs.RoundCap, join=gs.RoundJoin, endcap=gs.ButtCap, mitrelimit=10.0,
                               linewidth=3.0)
    hairline = gs.StrokeSpec(startcap=gs.ButtCap, join=gs.BevelJoin, endcap=gs.ButtCap, mitrelimit=10.0,
                             linewidth=0.6)
    objs = [obj(C.red, R.PathShape(gs.circle(30.0, 30.0, 20.0))),
            obj(C.dissolve(C.blue, delta=120), R.PathShape(gs.rectangle(5.0, 5.0, 240.0, 25.0)),
                [tr.Rotate((90.0, 20.0), 0.3)]),
            obj(C.green, R.StrokedPathShape(gs.circle(160.0, 40.0, 35.0), round_spec)),
            obj(C.red, R.StrokedPathShape(gs.circle(30.0, 30.0, 12.0), hairline)),
            obj(C.dissolve(C.gold, delta=0), R.PathShape(gs.circle(33.5, 70.25, 19.0))),
            obj(C.dissolve(C.teal, delta=200), R.PathShape(gs.circle(133.5, 170.25, 61.0)))]
    return sprite_of_members(fastframe._group_members(objs, device)[1])


def sprite_of_members(groups):
    """(boxes, fills, cov, cross, aa) of the members of fastframe's groups,
    in order."""
    ms = [m for members in groups.values() for m in members]
    return ([(m.x0, m.y0, m.w, m.h) for m in ms], [m.fill for m in ms], [m.cov for m in ms],
            [m.cross for m in ms], [m.aa for m in ms])


def sprite_as_members(case):
    """A case's members as fastframe's _Member records, for its plain
    version (_raster_members)."""
    from coherence_tpu_torch.scene import fastframe

    boxes, fills, cov, cross, aa = case
    return [fastframe._Member(j, c, x, a, x0, y0, w, h, tuple(f), (x0, y0, x0 + w - 1, y0 + h - 1), False)
            for j, ((x0, y0, w, h), f, c, x, a) in enumerate(zip(boxes, fills, cov, cross, aa))]


def sprite_opacity_case(name: str, seed: int = 0):
    """An opacity-mode case: (box (x0, y0, x1, y1), scaled spans or None).
    "wide": 1920 x 24, taller than one band; "odd": 37 x 300; "pixel": one
    pixel; "empty": no span; "circle": a circle's matte from the sweep."""
    rng = np.random.default_rng(600 + seed)
    boxes = {"wide": (3, -4, 1922, 19), "odd": (-5, 7, 31, 306), "pixel": (9, 9, 9, 9), "empty": (0, 0, 19, 21)}
    if name == "circle":
        from coherence_tpu_torch.geometry import path as gpath
        from coherence_tpu_torch.geometry import shapes as gs
        from coherence_tpu_torch.raster import scanline

        circle = gs.circle(100.3, 90.7, 70.0)
        edges = gpath.edgelist_of_path(circle)
        shp, _ = scanline.shapeminshape_of_edgelist(edges, circle.winding, "cpu")
        return shp.box, scanline.scaled_spans_of_edgelist(edges, circle.winding, 16)
    box = boxes[name]
    if name == "empty":
        return box, None
    x0, y0, x1, y1 = box
    w, h = x1 - x0 + 1, y1 - y0 + 1
    return box, sprite_spans(rng, 60 * h * max(1, w // 64), 16 * y0 - 32, 16 * h + 16, 16 * x0 - 32, 16 * w + 16, 40)


def sprite_h61_case():
    """A matte past the first design's span packing (H61): a rectangle's
    16x spans over a box 131,071 pixels wide and 2 tall, (box, scaled);
    its footprints are empty at the left end, mixed at both ends and full
    between."""
    from coherence_tpu_torch.geometry import path as gpath
    from coherence_tpu_torch.geometry import shapes as gs
    from coherence_tpu_torch.raster import scanline

    rect = gs.rectangle(6.3, 0.0, 131066.9, 10.0)
    scaled = scanline.scaled_spans_of_edgelist(gpath.edgelist_of_path(rect), rect.winding, 16)
    return (3, 5, 3 + 131070, 6), scaled


def lion_group(fit: int = 1024):
    """chip_smoke.py's general_lion object: the lion as one group, fitted
    to `fit` pixels and flipped upright."""
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.scene import render as R

    lion = examples.smalllion()
    xmin, xmax, ymin, ymax = R.bounds_of_basicshape(lion)
    scale = float(fit) / max(xmax - xmin, ymax - ymin)
    return R.transform_renderobject_many(
        [tr.Translate(0.0, float(fit)), tr.Scale((0.0, 0.0), 1.0, -1.0), tr.Scale((0.0, 0.0), scale, scale),
         tr.Translate(-xmin, -ymin)], lion)


def lion_objects(fit: int = 1024):
    """The lion group's member objects as render.py makes them for
    chip_smoke.py's general_lion (the lion fitted to `fit` pixels and
    flipped upright)."""
    from coherence_tpu_torch import ident
    from coherence_tpu_torch import transform as tr
    from coherence_tpu_torch.scene import render as R

    o = lion_group(fit)
    return [R.Obj(ident.new_ids(), x.geometry, tuple(tr.append(list(o.transform), list(x.transform))), x.compop)
            for x in o.geometry.objects]


def _sprite_group(device, case):
    """SR1's planes of a group-mode case on `device` (one launch) and the
    plain version's, member by member."""
    from coherence_tpu_torch.scene import fastframe

    lists = kernels.sprite_raster_lists(*case)
    before = kernels.launches["sprite_raster"]
    got = kernels.sprite_raster(lists, kernels.stage_sprite_lists(lists, device))
    torch.cuda.synchronize()
    assert kernels.launches["sprite_raster"] == before + 1
    members = sprite_as_members(case)
    want = [p for m in members for p in zip(*fastframe._raster_members([m], device))]
    return got, want


def _assert_sprite_planes(got, want):
    assert len(got) == len(want)
    for (mask, minmask, rgba), (wmask, wminmask, wrgba) in zip(got, want):
        for g, w in ((mask, wmask), (minmask, wminmask), (rgba, wrgba)):
            assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous() and g.data_ptr() % 16 == 0
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "heavy", "paths", "tall"])
def test_sprite_raster_matches_plain(cuda_device, case):
    """SR1 in group mode against _raster_members on the card, bit for bit:
    ragged boxes with spans off their planes, reversed and overlapping; a
    member with no AA span and one with an empty minshape; fills of alpha 0
    and 255; rows past a lane's and a bin's capacity and a band binned in
    runs; real paths and stroked paths; members of many bands.  Every
    plane is a contiguous view on 16 bytes."""
    got, want = _sprite_group(cuda_device, sprite_paths() if case == "paths" else sprite_case(case))
    _assert_sprite_planes(got, want)
    assert any(bool(m.any()) for m, _, _ in got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wide", "odd", "pixel", "empty", "circle"])
def test_sprite_raster_opacity_matches_plain(cuda_device, case):
    """SR1 in opacity mode (one launch, whatever the box) against
    coverage_opacity_torch's row bands, bit for bit."""
    from coherence_tpu_torch.raster import aa

    box, scaled = sprite_opacity_case(case)
    before = kernels.launches["sprite_raster"]
    got = aa.coverage_opacity(box, scaled, cuda_device)
    torch.cuda.synchronize()
    assert kernels.launches["sprite_raster"] == before + 1
    want = aa.coverage_opacity_torch(box, scaled, "cpu")
    assert got.dtype == torch.int32 and got.is_contiguous() and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sprite_raster_h61_matte(cuda_device):
    """H61: a matte 131,071 pixels wide, past the first design's packing,
    through aa.coverage_opacity on the card (one launch) equals
    coverage_opacity_torch bit for bit."""
    from coherence_tpu_torch.raster import aa

    box, scaled = sprite_h61_case()
    before = kernels.launches["sprite_raster"]
    got = aa.coverage_opacity(box, scaled, cuda_device)
    torch.cuda.synchronize()
    assert kernels.launches["sprite_raster"] == before + 1
    want = aa.coverage_opacity_torch(box, scaled, "cpu")
    assert got.shape == (2, 131071) and torch.equal(got.cpu(), want) and bool((want == 255).any())


@pytest.mark.cuda
def test_sprite_raster_lion(cuda_device, monkeypatch):
    """The lion at chip_smoke.py's general_lion size: its 130 batched
    members (24 groups) in one launch and its two scalar members' mattes,
    each against its plain version, bit for bit; then
    full_sprites_of_objects on the card equal to the CPU's, in one launch
    for the batched members and one a scalar matte, with no plain version
    reached."""
    from coherence_tpu_torch.raster import aa
    from coherence_tpu_torch.scene import cache, fastframe

    objs = lion_objects()
    cache.clear()  # the scalar members' shapes are cached on the device that computed them
    mattes, real = [], kernels.sprite_raster_opacity
    monkeypatch.setattr(kernels, "sprite_raster_opacity", lambda box, scaled, device: (
        mattes.append((box, scaled)), real(box, scaled, device))[1])
    _, groups = fastframe._group_members(objs, cuda_device)
    assert len(groups) == 24 and sum(len(m) for m in groups.values()) == 130 and len(mattes) == 2
    got, want = _sprite_group(cuda_device, sprite_of_members(groups))
    _assert_sprite_planes(got, want)
    for box, scaled in mattes:
        assert torch.equal(real(box, scaled, cuda_device).cpu(), aa.coverage_opacity_torch(box, scaled, "cpu"))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    cache.clear()
    cpu = fastframe.full_sprites_of_objects(objs, "cpu")
    cache.clear()
    monkeypatch.setattr(fastframe, "_raster_members", refuse)
    monkeypatch.setattr(aa, "coverage_opacity_torch", refuse)
    before = kernels.launches["sprite_raster"]
    card = fastframe.full_sprites_of_objects(objs, cuda_device)
    torch.cuda.synchronize()
    cache.clear()
    assert kernels.launches["sprite_raster"] == before + 3
    for c, g in zip(cpu, card):
        assert (c is None) == (g is None)
        if c is not None:
            assert c.box == g.box and torch.equal(c.mask, g.mask.cpu()) and torch.equal(c.rgba, g.rgba.cpu())


@pytest.mark.cuda
def test_sprite_raster_fits_two_blocks_an_sm(cuda_device):
    """The occupancy the design is built for: two blocks an SM."""
    assert kernels.sprite_raster_blocks_per_sm() >= 2


@pytest.mark.cuda
def test_sprite_raster_wrappers_reject_bad_input(cuda_device):
    """CPU devices and lists that do not match are refused before any
    launch."""
    lists = kernels.sprite_raster_lists(*sprite_case("ragged"))
    with pytest.raises(ValueError):
        kernels.stage_sprite_lists(lists, "cpu")
    staged = [t.cpu() for t in kernels.stage_sprite_lists(lists, cuda_device)]
    with pytest.raises(ValueError):
        kernels.sprite_raster(lists, staged)
    with pytest.raises(ValueError):
        kernels.sprite_raster_opacity((0, 0, 9, 9), None, "cpu")
    other = kernels.sprite_raster_lists(*sprite_case("heavy"))
    with pytest.raises(ValueError):
        kernels.sprite_raster(lists, kernels.stage_sprite_lists(other, cuda_device))


# ---------------------------------------------------------------------------
# The general renderer's region programs: CF1 caf, TB1 tight_bounds, MR1
# box_morph (kernels/csrc/region_ops.cu) and CV1 convolve_canvas
# (kernels/csrc/convolve.cu), each against its plain version on the card.
# ---------------------------------------------------------------------------

# (x0, y0, w, h) of caf's second operand against a first at (5, 7, 40, 23).
CAF_PLACES = {"disjoint": (90, 70, 10, 10), "nested": (10, 9, 12, 9), "around": (1, 2, 70, 50),
              "overlap": (20, 12, 40, 30)}
CAF_LAYOUTS = ("dense", "view", "expanded", "empty_mask", "wide_sums")
CAF_BUILTIN = ("over", "alpha_over", "plus", "nocover")


def caf_registered():
    """The operators other than the built-in four that the renderer
    registers (render.py's CPG ops and blend_prime's, blend.py's PDF blend
    modes), registered; their names."""
    from coherence_tpu_torch.raster import blend, region
    from coherence_tpu_torch.scene import render as R

    region.register_caf_op("blend_att_out", R._att_out)
    region.register_caf_op("blend_att_in", R._att_in)
    return ["cpg_add", "cpg_sub", "cpg_min", "cpg_eor", "blend_att_out", "blend_att_in"] + [
        "pdfblend_" + name for name in blend.BLEND_MODES]


def caf_sprite(device, seed: int, place, layout: str):
    """A sprite over the box at place = (x0, y0, w, h) on `device`, its
    planes laid out as `layout` says: "dense" (contiguous), "view" (slices
    of larger planes, as pickup cuts a canvas), "expanded" (one colour and
    one mask row expanded, strides 0), "empty_mask" (no pixel set),
    "wide_sums" (channels up to 600, as plus sums past 255 are)."""
    from coherence_tpu_torch.raster import region

    x0, y0, w, h = place
    rng = np.random.default_rng(seed)
    box = (x0, y0, x0 + w - 1, y0 + h - 1)
    if layout == "expanded":
        colour = torch.tensor([40, 90, 12, int(rng.choice([90, 255]))], dtype=torch.int32)
        row = torch.from_numpy(rng.random(w) < 0.7)
        return region.Sprite(box, row.to(device)[None, :].expand(h, w), colour.to(device).expand(h, w, 4))
    top = 600 if layout == "wide_sums" else 255
    alpha = rng.choice([0, 1, 90, 254, 255, top], (h + 5, w + 9, 1))
    rgb = (rng.integers(0, top + 1, (h + 5, w + 9, 3)) * alpha) // max(top, 255)
    mask = rng.random((h + 5, w + 9)) < (0.0 if layout == "empty_mask" else 0.6)
    rgba = np.where(mask[..., None], np.concatenate([rgb, alpha], -1), 0).astype(np.int32)
    rgba_t, mask_t = torch.from_numpy(rgba).to(device), torch.from_numpy(mask).to(device)
    if layout == "view":
        return region.Sprite(box, mask_t[3 : 3 + h, 5 : 5 + w], rgba_t[3 : 3 + h, 5 : 5 + w])
    return region.Sprite(box, mask_t[:h, :w].contiguous(), rgba_t[:h, :w].contiguous())


WORDS_LAYOUTS = ("dense", "rows16", "strided", "expanded")


def words_case(device, layout: str, width: int, column: int, offset: int):
    """A 5-row sprite of `width` columns whose box starts at column 100 +
    `offset` (a caf operand beside one at column 100: its offset in the
    union box), its mask laid out as `layout`: "dense" (contiguous),
    "rows16" (a view from `column` of a mask whose rows are 16 bytes
    apart), "strided" (every other column), "expanded" (one row from
    `column`, strides (0, 1)); its RGBA contiguous."""
    from coherence_tpu_torch.raster import region

    rng = np.random.default_rng(width * 31 + column)
    base = torch.from_numpy(rng.random((5, 32)) < 0.6).to(device)
    mask = {"dense": lambda: base[:, :width].contiguous(),
            "rows16": lambda: base[:, :16].contiguous()[:, column : column + width],
            "strided": lambda: base[:, column : column + 2 * width : 2],
            "expanded": lambda: base[0].contiguous()[column : column + width][None, :].expand(5, width)}[layout]()
    rgba = torch.where(mask[..., None], torch.tensor([10, 20, 30, 255], dtype=torch.int32, device=device), 0)
    return region.Sprite((100 + offset, 7, 100 + offset + width - 1, 11), mask, rgba.contiguous())


def assert_same_caf(got, want, what: str):
    (gs, gf), (ws, wf) = got, want
    assert (gs is None) == (ws is None) and (gf is None) == (wf is None), what
    if gs is not None:
        assert gs.box == ws.box, what
        assert torch.equal(gs.mask.cpu(), ws.mask.cpu()), f"{what}: mask"
        assert torch.equal(gs.rgba.cpu(), ws.rgba.cpu()), f"{what}: rgba"
    if gf is not None:
        assert gf.box == wf.box and torch.equal(gf.mask.cpu(), wf.mask.cpu()), f"{what}: f"


@pytest.mark.cuda
@pytest.mark.parametrize("place", list(CAF_PLACES))
@pytest.mark.parametrize("op", [*CAF_BUILTIN, "registered"])
def test_caf_matches_plain(cuda_device, op, place):
    """CF1 against caf_torch on the card, bit for bit: every operator (the
    registered ones through the given-plane route) on disjoint, nested,
    containing and overlapping operands, each laid out dense, as views, as
    expanded planes, with an empty mask and with channels past 255; one
    launch a call, one operand included."""
    from coherence_tpu_torch.raster import region

    ops = caf_registered() if op == "registered" else [op]
    for name in ops:
        for la in CAF_LAYOUTS:
            for lb in CAF_LAYOUTS:
                a = caf_sprite(cuda_device, 1, (5, 7, 40, 23), la)
                b = caf_sprite(cuda_device, 2, CAF_PLACES[place], lb)
                for x, y in ((a, b), (b, a), (a, None), (None, b)):
                    before = kernels.launches["caf"]
                    got = region.caf(name, "opaque", x, y)
                    assert kernels.launches["caf"] == before + 1
                    assert_same_caf(got, region.caf_torch(name, "opaque", x, y), f"{name} {place} {la} {lb}")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", WORDS_LAYOUTS)
def test_caf_tails_and_alignments_match_plain(cuda_device, monkeypatch, layout):
    """CF1 against caf_torch on the card at union widths 1-9 (a block's
    last columns), operand offsets 0-3 in the union box, mask columns 0-3
    bytes into their rows, dense, as views, strided and expanded
    (words_case); both orders, built-in and registered operators, one
    operand; both ways of reading the colours."""
    from coherence_tpu_torch.raster import region

    caf_registered()
    b = caf_sprite(cuda_device, 4, (100, 7, 12, 5), "dense")
    for limit in (kernels.CAF_ONE_TRIP_PIXELS, 0):
        monkeypatch.setattr(kernels, "CAF_ONE_TRIP_PIXELS", limit)
        for width in range(1, 10):
            for column in range(4):
                for offset in range(4):
                    a = words_case(cuda_device, layout, width, column, offset)
                    for op in ("over", "plus", "cpg_eor"):
                        for x, y in ((a, b), (b, a), (a, None)):
                            assert_same_caf(region.caf(op, "opaque", x, y), region.caf_torch(op, "opaque", x, y),
                                            f"{op} {layout} {width} {column} {offset} {limit}")


@pytest.mark.cuda
@pytest.mark.parametrize("place", list(CAF_PLACES))
def test_caf_after_the_masks_matches_plain(cuda_device, monkeypatch, place):
    """CF1 reading its colours after the masks, only where the result takes
    them (the way of union boxes past CAF_ONE_TRIP_PIXELS, here forced at
    every size), against caf_torch: test_caf_matches_plain's operators,
    places and layouts."""
    from coherence_tpu_torch.raster import region

    monkeypatch.setattr(kernels, "CAF_ONE_TRIP_PIXELS", 0)
    for name in [*CAF_BUILTIN, *caf_registered()]:
        for la in CAF_LAYOUTS:
            for lb in CAF_LAYOUTS:
                a = caf_sprite(cuda_device, 1, (5, 7, 40, 23), la)
                b = caf_sprite(cuda_device, 2, CAF_PLACES[place], lb)
                for x, y in ((a, b), (b, a), (a, None), (None, b)):
                    assert_same_caf(region.caf(name, "opaque", x, y), region.caf_torch(name, "opaque", x, y),
                                    f"{name} {place} {la} {lb}")


@pytest.mark.cuda
def test_caf_plus_sums_feed_over(cuda_device):
    """plus's sums past 255, unclamped, composed again by over on both
    sides, and over's result through plus: the card's chain equal to the
    plain chain."""
    from coherence_tpu_torch.raster import region

    a, b = caf_sprite(cuda_device, 3, (5, 7, 40, 23), "dense"), caf_sprite(cuda_device, 4, (20, 12, 40, 30), "view")
    c = caf_sprite(cuda_device, 5, (1, 2, 70, 50), "wide_sums")
    card, plain = region.caf("plus", "opaque", a, b)[0], region.caf_torch("plus", "opaque", a, b)[0]
    assert int(card.rgba.max()) > 255
    for op in ("over", "alpha_over", "plus"):
        for x, y, px, py in ((card, c, plain, c), (c, card, c, plain)):
            assert_same_caf(region.caf(op, "opaque", x, y), region.caf_torch(op, "opaque", px, py), f"plus then {op}")


@pytest.mark.cuda
def test_caf_reregistered_over_takes_the_given_plane(cuda_device, monkeypatch):
    """A caller's own `over` (render.py re-registers table entries) is not
    the built-in: CF1 takes its composed plane, and the result still
    equals the plain version's."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.raster import region

    monkeypatch.setitem(region._CAF_OPS, "over", lambda a, b: C.alpha_over_rgba(a, b))
    assert region._caf_op_code("over") is None
    a, b = caf_sprite(cuda_device, 6, (5, 7, 40, 23), "view"), caf_sprite(cuda_device, 7, (20, 12, 40, 30), "dense")
    assert_same_caf(region.caf("over", "opaque", a, b), region.caf_torch("over", "opaque", a, b), "re-registered over")


@pytest.mark.cuda
def test_caf_nocover_spritecheck_on_the_card(cuda_device, monkeypatch):
    """debug_spritecheck's overlap check stays a host check: overlapping
    nocover operands raise before any launch, disjoint ones launch."""
    from coherence_tpu_torch import colour as C
    from coherence_tpu_torch.raster import region

    monkeypatch.setattr(region, "debug_spritecheck", True)
    a, b = caf_sprite(cuda_device, 8, (5, 7, 40, 23), "dense"), caf_sprite(cuda_device, 9, (20, 12, 40, 30), "dense")
    before = kernels.launches["caf"]
    with pytest.raises(C.Nocover):
        region.caf("nocover", "opaque", a, b)
    assert kernels.launches["caf"] == before
    far = caf_sprite(cuda_device, 9, CAF_PLACES["disjoint"], "dense")
    assert_same_caf(region.caf("nocover", "opaque", a, far), region.caf_torch("nocover", "opaque", a, far), "nocover")


def bounds_masks(device):
    """name -> a bool mask on `device` for TB1: empty, one pixel (at each
    corner and inside), full, random, sparse, strided views, 1080 x 1920."""
    rng = np.random.default_rng(11)
    out = {"empty": torch.zeros((37, 53), dtype=torch.bool), "full": torch.ones((37, 53), dtype=torch.bool),
           "random": torch.from_numpy(rng.random((37, 53)) < 0.3), "one_by_one": torch.ones((1, 1), dtype=torch.bool)}
    for name, (y, x) in {"pixel_tl": (0, 0), "pixel_br": (36, 52), "pixel_in": (17, 3)}.items():
        m = torch.zeros((37, 53), dtype=torch.bool)
        m[y, x] = True
        out[name] = m
    big = np.zeros((1080, 1920), bool)
    big[rng.integers(0, 1080, 40), rng.integers(0, 1920, 40)] = True
    out["sparse_1080p"] = torch.from_numpy(big)
    out["random_1080p"] = torch.from_numpy(rng.random((1080, 1920)) < 0.5)
    out["empty_1080p"] = torch.zeros((1080, 1920), dtype=torch.bool)
    out = {k: v.to(device) for k, v in out.items()}
    wide = torch.from_numpy(rng.random((90, 130)) < 0.02).to(device)
    out["view"] = wide[7:60, 11:100]
    out["strided"] = wide[::3, 5::2]
    out["transposed"] = wide.t()
    return out


BOUNDS_ROUTES = {"one": kernels.BOUNDS_ONE, "ticket": kernels.BOUNDS_TICKET}


def forced_bounds_route(h: int, w: int, sy: int, sx: int, route: int, picked=None):
    """tight_bounds_route's (or `picked`'s) layout and segments with the
    route `route` forced: one block over every row (its rounds as many as
    they take), or the ticket over blocks of TIGHT_BOUNDS_WARPS rows."""
    r = (picked or kernels.tight_bounds_route)(h, w, sy, sx)
    warps = kernels.TIGHT_BOUNDS_WARPS
    if route == kernels.BOUNDS_ONE:
        return r._replace(route=route, rows=h, blocks=1)
    return r._replace(route=route, rows=warps, blocks=-(-h // warps))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["picked", *BOUNDS_ROUTES])
def test_tight_bounds_matches_plain(cuda_device, monkeypatch, route):
    """TB1 against _tight_bounds_torch on the card at every mask of
    bounds_masks, three times over (the ticket route's ticket is reset by
    each launch), on the route tight_bounds_route picks and on each route
    forced: through region._tight_bounds (the mapped host word) one launch,
    one sync and no copy a call; through kernels.tight_bounds with no word,
    a device tensor."""
    from coherence_tpu_torch.raster import region

    if route != "picked":
        picked = kernels.tight_bounds_route
        monkeypatch.setattr(kernels, "tight_bounds_route",
                            lambda h, w, sy, sx: forced_bounds_route(h, w, sy, sx, BOUNDS_ROUTES[route], picked))
    for _ in range(3):
        for name, m in bounds_masks(cuda_device).items():
            want = region._tight_bounds_torch(m)
            before, syncs = kernels.launches["tight_bounds"], region.syncs
            assert region._tight_bounds(m) == want, name
            assert kernels.launches["tight_bounds"] == before + 1 and region.syncs == syncs + 1, name
            on_card = kernels.tight_bounds(m)
            assert on_card.is_cuda and tuple(on_card.tolist()) == want, name
    assert region._tight_bounds(bounds_masks(cuda_device)["empty"]) == (53, 37, -1, -1)


@pytest.mark.cuda
def test_tight_bounds_issues_no_copy(cuda_device):
    """region._tight_bounds issues one launch and no copy (its result comes
    through the mapped host word); the word is one per stream and thread."""
    from profile_general import issued
    from coherence_tpu_torch.raster import region

    m = bounds_masks(cuda_device)["random"]
    got = []
    assert issued(torch, lambda: got.append(region._tight_bounds(m))) == 1
    assert got == [region._tight_bounds_torch(m)]
    assert kernels.bounds_word(cuda_device) is kernels.bounds_word(cuda_device)


@pytest.mark.cuda
def test_boxshape_boxsprite_on_the_card(cuda_device):
    """boxshape and boxsprite through TB1 equal their CPU results."""
    from coherence_tpu_torch.raster import region

    for name, m in bounds_masks(cuda_device).items():
        h, w = m.shape
        s = region.Shape((4, 9, 4 + w - 1, 9 + h - 1), m)
        got, want = region.boxshape(s), region.boxshape(region.Shape(s.box, m.cpu()))
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.box == want.box and torch.equal(got.mask.cpu(), want.mask), name
        spr = region.Sprite(s.box, m, torch.where(m[..., None], 7, 0).to(torch.int32))
        got = region.boxsprite(spr)
        want = region.boxsprite(region.Sprite(s.box, m.cpu(), spr.rgba.cpu()))
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.box == want.box and torch.equal(got.rgba.cpu(), want.rgba), name


MORPH_RADII = [(0, 1), (1, 0), (1, 1), (5, 5), (11, 11), (64, 64), (40, 3), (2, 33)]


def morph_masks(device):
    """name -> a bool mask on `device` for MR1: random, sparse, full,
    empty, one pixel, a view of a larger mask, and general_filters' sizes."""
    rng = np.random.default_rng(12)
    out = {"random": rng.random((17, 29)) < 0.5, "sparse": rng.random((17, 29)) < 0.03,
           "full": np.ones((17, 29), bool), "empty": np.zeros((17, 29), bool), "pixel": np.ones((1, 1), bool),
           "filters_125x129": rng.random((129, 125)) < 0.9, "wide_1x300": rng.random((1, 300)) < 0.1}
    out = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    out["view"] = torch.from_numpy(rng.random((60, 300)) < 0.4).to(device)[5:50, 7:290:2]
    wide = torch.from_numpy(rng.random((40, 260)) < 0.3).to(device)
    out["rows_on_4_bytes"] = wide[:33, :200]  # 4 source bytes a lane
    out["rows_off_4_bytes"] = wide[2:35, 3:203]  # contiguous rows, not on 4 bytes
    out["transposed"] = wide[:, :37].t()
    return out


def _random_mask(shape, density: float, rx: int, ry: int, seed: int):
    return lambda device: (torch.from_numpy(np.random.default_rng(seed).random(shape) < density).to(device), rx, ry)


def _chip_smoke_second_route(device):
    import chip_smoke

    return chip_smoke.morph_second_route(torch, device)[0]


# name -> fn(device) -> (mask, rx, ry) past MR1's staged route: a tall mask
# at ry = 20000, a wide one at rx = 3000, one whose 32 rows' reach is past a
# block's shared memory (1 row a row-pass block), and
# chip_smoke.MORPH_SECOND_ROUTE's.
MORPH_SECOND_ROUTE_CASES = {"tall_ry20000": _random_mask((30000, 3), 0.0005, 0, 20000, 1),
                            "wide_rx3000": _random_mask((40, 7000), 0.002, 3000, 1, 2),
                            "one_row_tiles": _random_mask((33, 29500), 0.0003, 14750, 0, 3),
                            "chip_smoke": _chip_smoke_second_route}


@pytest.mark.cuda
@pytest.mark.parametrize("radii", MORPH_RADII, ids=[f"rx{a}ry{b}" for a, b in MORPH_RADII])
def test_box_morph_matches_plain(cuda_device, radii):
    """MR1 against dilate_torch and erode_torch on the card, both modes,
    at every mask of morph_masks (strided, transposed, rows on 4 bytes and
    off them), radii 0 on one axis and past the box: the staged route, one
    counted launch a call."""
    from coherence_tpu_torch.raster import region

    rx, ry = radii
    for name, m in morph_masks(cuda_device).items():
        before = kernels.launches["box_morph"]
        assert torch.equal(kernels.box_morph(m, rx, ry, erode=False), region.dilate_torch(m, rx, ry)), f"bloat {name}"
        assert torch.equal(kernels.box_morph(m, rx, ry, erode=True), region.erode_torch(m, rx, ry)), f"erode {name}"
        assert kernels.launches["box_morph"] == before + 2
        s = region.Shape((3, 5, 3 + m.shape[1] - 1, 5 + m.shape[0] - 1), m)
        cpu = region.Shape(s.box, m.cpu())
        for fn in (region.bloat, region.erode):
            got, want = fn(rx, ry, s), fn(rx, ry, cpu)
            assert got.box == want.box and torch.equal(got.mask.cpu(), want.mask), f"{fn.__name__} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MORPH_SECOND_ROUTE_CASES))
def test_box_morph_second_route_matches_plain(cuda_device, case):
    """MR1's second route (a row-pass launch into a bit plane, then the
    column-pass launch: two counted launches) against dilate_torch and
    erode_torch on the card, both modes, at MORPH_SECOND_ROUTE_CASES, and
    on a strided view of the same mask."""
    from coherence_tpu_torch.raster import region

    mask, rx, ry = MORPH_SECOND_ROUTE_CASES[case](cuda_device)
    wider = torch.zeros((mask.shape[0], 2 * mask.shape[1] + 1), dtype=torch.bool, device=cuda_device)
    wider[:, 1::2] = mask
    for m in (mask, wider[:, 1::2]):
        for erode in (False, True):
            assert kernels.box_morph_route(*m.shape, rx, ry, erode).launches == 2
            before = kernels.launches["box_morph"]
            got = kernels.box_morph(m, rx, ry, erode=erode)
            assert kernels.launches["box_morph"] == before + 2
            want = (region.erode_torch if erode else region.dilate_torch)(m, rx, ry)
            assert torch.equal(got, want), f"{case} erode={erode} strides {m.stride()}"


def convolve_masks(device, h: int, w: int):
    """name -> a bool mask of at least (h, w) on `device`: full, empty,
    random, a ring, one wider than the canvas and a transposed one."""
    rng = np.random.default_rng(h * 7919 + w)
    yy, xx = np.mgrid[:h, :w]
    d = np.hypot(yy - h / 2, xx - w / 2)
    out = {"full": np.ones((h, w), bool), "empty": np.zeros((h, w), bool), "random": rng.random((h, w)) < 0.6,
           "ring": (d > min(h, w) / 6) & (d < min(h, w) / 3), "wider": rng.random((h + 3, w + 13)) < 0.6}
    out = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    out["transposed"] = torch.from_numpy(rng.random((w, h)) < 0.6).to(device).t()
    return out


def convolve_kernels():
    """name -> a kernel of raster/convolve.py: each kind at r = 1, 5 and
    16, and past the int32 wrap (r = 150, H52)."""
    from coherence_tpu_torch.raster import convolve as V

    out = {}
    for r in (1, 5, 16):
        out[f"gaussian{r}"] = V.mkgaussian(r)
        out[f"unit{r}"] = V.mkunit(r)
    out["full_cone1"] = V.mkfull(1, lambda x, y: 5 - abs(x) - abs(y))
    out["full_cone5"] = V.mkfull(5, lambda x, y: 11 - abs(x) - abs(y))
    out["full_skew16"] = V.mkfull(16, lambda x, y: 1 + (x + 16) + 3 * (y + 16))
    out["gaussian150"] = V.mkgaussian(150)
    out["unit150"] = V.mkunit(150)
    return out


def convolve_canvas_case(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 1))
    rgb = (rng.integers(0, 256, (h, w, 3)) * a) // 255
    return np.concatenate([rgb, a], -1).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1, 1), (13, 7), (177, 181)])
@pytest.mark.parametrize("kernel", ["gaussian1", "gaussian5", "gaussian16", "unit1", "unit5", "unit16", "full_cone1",
                                    "full_cone5", "full_skew16", "gaussian150", "unit150"])
def test_convolve_canvas_matches_plain(cuda_device, kernel, size):
    """CV1 against convolve_canvas_torch on the card, bit for bit, at every
    mask of convolve_masks: the launches convolve_route gives a call (one
    on the staged route and for a full kernel, two past the staged route's
    shared memory, r = 150); the sums past the int32 wrap at r = 150."""
    from coherence_tpu_torch.raster import convolve as V

    k = convolve_kernels()[kernel]
    canvas = torch.from_numpy(convolve_canvas_case(3, *size)).to(cuda_device)
    for name, m in convolve_masks(cuda_device, *size).items():
        before = kernels.launches["convolve_canvas"]
        got = V.convolve_canvas(k, canvas, m)
        kind, _, _, radius = V.card_kernel(k)
        route = kernels.convolve_route(kind, *size, radius)
        assert route.launches == (2 if k.radius > 22 else 1)
        assert kernels.launches["convolve_canvas"] == before + route.launches
        want = V.convolve_canvas_torch(k, canvas, m)
        assert torch.equal(got, want), f"{kernel} {size} {name}: {int((got != want).any(-1).sum())} pixels differ"


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1, 1), (13, 7), (41, 37), (177, 181)])
@pytest.mark.parametrize("kernel", ["gaussian5", "unit5", "gaussian22", "unit22", "gaussian23"])
def test_convolve_canvas_on_each_route(cuda_device, monkeypatch, kernel, size):
    """xy and unit kernels on their route (the staged route's one launch up
    to r = 22, the two passes past its shared memory at r = 23) and forced
    onto the two passes, each equal to convolve_canvas_torch at every mask
    of convolve_masks; the staged route's shared memory as the kernel
    counts it."""
    from coherence_tpu_torch.raster import convolve as V

    r = int(kernel[-2:]) if kernel[-2:].isdigit() else int(kernel[-1])
    k = (V.mkgaussian if kernel.startswith("gaussian") else V.mkunit)(r)
    assert kernels.load()["convolve_staged_smem"](r) == kernels.convolve_staged_smem(r)
    canvas = torch.from_numpy(convolve_canvas_case(5, *size)).to(cuda_device)
    passes = kernels.ConvRoute((kernels.CONV_PASS_X, kernels.CONV_PASS_Y), 0)
    for forced in (None, passes):
        if forced is not None:
            monkeypatch.setattr(kernels, "convolve_route", lambda *args: forced)
        for name, m in convolve_masks(cuda_device, *size).items():
            before = kernels.launches["convolve_canvas"]
            got = V.convolve_canvas(k, canvas, m)
            assert kernels.launches["convolve_canvas"] == before + (1 if forced is None and r <= 22 else 2)
            want = V.convolve_canvas_torch(k, canvas, m)
            assert torch.equal(got, want), f"{kernel} {size} {name} {forced}"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian5", "unit1"])
def test_convolve_canvas_1088x1920(cuda_device, kernel):
    """CV1 at config 4's size against the plain version, full and random
    masks, three chained calls."""
    from coherence_tpu_torch.raster import convolve as V

    k = convolve_kernels()[kernel]
    x = y = torch.from_numpy(convolve_canvas_case(0, 1088, 1920)).to(cuda_device)
    masks = convolve_masks(cuda_device, 1088, 1920)
    for name in ("full", "random"):
        for _ in range(3):
            x, y = V.convolve_canvas(k, x, masks[name]), V.convolve_canvas_torch(k, y, masks[name])
            assert torch.equal(x, y), f"{kernel} {name}"


@pytest.mark.cuda
def test_region_kernels_reject_bad_input(cuda_device, monkeypatch):
    """CPU tensors, other dtypes, strides the kernel does not take, a total
    of 0 and planes outside the union box are refused before any launch."""
    from coherence_tpu_torch.raster import region

    before = dict(kernels.launches)
    m = torch.ones((5, 7), dtype=torch.bool, device=cuda_device)
    rgba = torch.zeros((5, 7, 4), dtype=torch.int32, device=cuda_device)
    plane = kernels.CafPlane(0, 0, m, rgba)
    bad = [
        lambda: kernels.caf(5, 7, 0, kernels.CafPlane(0, 0, m.cpu(), rgba.cpu())),
        lambda: kernels.caf(5, 7, 0, kernels.CafPlane(0, 0, m, rgba.long())),
        lambda: kernels.caf(5, 7, 0, kernels.CafPlane(0, 0, m.to(torch.uint8), rgba)),
        lambda: kernels.caf(5, 7, 0, kernels.CafPlane(1, 0, m, rgba)),
        lambda: kernels.caf(5, 7, 0, plane, composed=kernels.CafPlane(0, 0, None, rgba)),
        lambda: kernels.caf(5, 7, 9, plane),
        lambda: kernels.tight_bounds(m.cpu()),
        lambda: kernels.tight_bounds(m.to(torch.uint8)),
        lambda: kernels.box_morph(m.cpu(), 1, 1, erode=False),
        lambda: kernels.box_morph(m, -1, 1, erode=True),
        lambda: kernels.box_morph(torch.ones((1, 10**6), dtype=torch.bool, device=cuda_device), 5 * 10**5, 0,
                                  erode=False),
        lambda: kernels.convolve_canvas("xy", (1, 2, 1), 4, 1, rgba.cpu(), m.cpu()),
        lambda: kernels.convolve_canvas("xy", (1, 2, 1), 4, 1, rgba.transpose(0, 1).contiguous().transpose(0, 1), m),
        lambda: kernels.convolve_canvas("xy", (1, 2, 1), 4, 1, rgba.float(), m),
        lambda: kernels.convolve_canvas("xy", (0, 0, 0), 0, 1, rgba, m),
        lambda: kernels.convolve_canvas("xy", (1, 2, 1), 4, 1, rgba, m[:4]),
        lambda: kernels.convolve_canvas("cone", (1, 2, 1), 4, 1, rgba, m),
    ]
    for k, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
    monkeypatch.setitem(region._CAF_PREDS, "opaque_again", lambda t: t[..., 3] == 255)
    with pytest.raises(ValueError):
        region.caf("over", "opaque_again", region.Sprite((1, 1, 7, 5), m, rgba), None)
    assert kernels.launches == before


def filters_frame_scene(w: int = 640, h: int = 384):
    """(lens, blob, objs): bench.py's scene at w x h under a radius-5
    filters.blur lens, as chip_smoke.py's general_filters builds it."""
    from coherence_tpu_torch import ident
    from coherence_tpu_torch.raster import convolve
    from coherence_tpu_torch.scene import filters
    from coherence_tpu_torch.scene import render as R

    objs, blob, f_geom = examples.bench_scene(w, h, blob_radius=60, blob_at=(120, 200), f_box=(40, 100, 600, 380))
    lens = R.Obj(ident.new_ids(), filters.blur(f_geom.geometry, convolve.mkgaussian(5)), (), R.OVER)
    return lens, blob, objs


@pytest.mark.cuda
def test_filters_frame_through_the_region_kernels(cuda_device, monkeypatch):
    """A general_filters frame (the whole render, then one dragged frame's
    incremental render) on the card equal to the CPU's, with the plain
    versions patched to raise on the card and each of CF1, TB1, MR1 and
    CV1 launched."""
    from coherence_tpu_torch.raster import convolve, region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R

    lens, blob, objs = filters_frame_scene()
    frames = {}
    for device in ("cpu", cuda_device):
        cache.clear()
        before = dict(kernels.launches)
        master = region.shape_of_box((1, 1, 640, 384), device)
        first = R.render_simple_scene([lens, blob] + objs, master, device)
        moved = R.translate_renderobject(7, 3, blob)
        scene = [lens, moved] + objs
        d = R.dirty_filter(moved.idset, R.dirty_region(blob, moved, device)(master), scene, device)
        patch, _, _ = R.render_scene(moved.idset, False, (d, None), scene, scene, master, device)
        frames[str(device)] = (first, region.caf("over", "opaque", patch,
                                                 region.portion(first, region.shape_difference(master, d)))[0])
        launched = {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]}
        if device == "cpu":
            assert not launched
            for name in ("caf_torch", "_tight_bounds_torch", "dilate_torch", "erode_torch"):
                monkeypatch.setattr(region, name, _refuse)
            monkeypatch.setattr(convolve, "convolve_canvas_torch", _refuse)
        else:
            for name in ("caf", "tight_bounds", "box_morph", "convolve_canvas"):
                assert launched.get(name, 0) >= 1, name
    cache.clear()
    for k in range(2):
        a, b = frames["cpu"][k], frames[str(cuda_device)][k]
        assert a.box == b.box and torch.equal(a.mask, b.mask.cpu()) and torch.equal(a.rgba, b.rgba.cpu()), k


def _refuse(*args, **kwargs):
    raise AssertionError("a plain version ran on the card")


@pytest.mark.cuda
def test_lion_fold_route_through_the_region_kernels(cuda_device, monkeypatch):
    """general_lion's per-member fold route (the lion at 512 pixels) on the
    card equal to the CPU's, its cafs through CF1 with caf_torch patched to
    raise."""
    from coherence_tpu_torch.raster import region
    from coherence_tpu_torch.scene import cache
    from coherence_tpu_torch.scene import render as R
    from coherence_tpu_torch.utils import flags

    lion = lion_group(512)
    n_members = len(lion.geometry.objects)
    got = {}
    flags.set_flag("batch_group_raster", False)
    try:
        for device in ("cpu", cuda_device):
            cache.clear()
            if device != "cpu":
                monkeypatch.setattr(region, "caf_torch", _refuse)
            before = kernels.launches["caf"]
            got[str(device)] = R.render_simple_scene([lion], region.shape_of_box((1, 1, 640, 540), device), device)
            if device != "cpu":
                assert kernels.launches["caf"] - before >= n_members
    finally:
        flags.set_flag("batch_group_raster", True)
        cache.clear()
    a, b = got["cpu"], got[str(cuda_device)]
    assert a.box == b.box and torch.equal(a.mask, b.mask.cpu()) and torch.equal(a.rgba, b.rgba.cpu())
