"""TR1, the tile rasterizer kernel (kernels/csrc/tile_raster.cu), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain version there).  Here:

  * its host lists (kernels.tile_span_lists: span words grouped by item
    and row, per-row offsets, dropped rows, refused columns) against the
    items they pack;
  * its Gaussian table against raster/aa.py's, and its integer footprint
    count, transcribed to numpy word for word (the 32-bit rows, the funnel
    shift, 1024 multiply-adds a pixel), against the JAX package's
    ``raa._coverage_counts`` and the port's plain ``coverage_counts`` at
    random masks, half planes, an empty and a full plane;
  * its row scan (the span counts of one row from a word-aligned first
    column, those left of it carried in) against the plain scatter's mask,
    with reversed and overlapping spans;
  * the plain versions (raster/tile_raster.py _edge_impl, _interior_impl)
    against the JAX package's, bit for bit, at every capacity class (an
    item at capacity, reversed and overlapping spans, spans at tile column
    0 and 127 and at scaled column 2063, rows the scatter drops, an empty
    item, fills with alpha 0 and 255) and in interior mode;
  * a numpy model of the whole kernel (the masks built row by row, the
    t-plane band by band over each band's fringe box, the opacity, dissolve
    and pack) against the plain version on those items and on the lion's.

Tolerance 0 throughout: every step is integer math.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from coherence_tpu.raster import aa as JAA
from coherence_tpu.raster import tile_raster as JTR

from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import aa as TA
from coherence_tpu_torch.raster import tile_raster as TTR
from coherence_tpu_torch.scene import examples, fastframe

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import AA_EDGE_SPANS, TILE_EDGE_SPANS, tile_build_items, tile_edge_items, tile_interior_items

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc", "tile_raster.cu")
TABLE = TA.maintable.T.astype(np.int64)  # tile_raster.cu's kTable[v][u]
CASES = ["class0", "class1", "class2", "class3", "class4", "interior"]


def _items(case):
    return (tile_edge_items(int(case[-1])), True) if case != "interior" else (tile_interior_items(), False)


# --- the host lists ---------------------------------------------------------

@pytest.mark.parametrize("h,w,edge_spans", [(64, 128, TILE_EDGE_SPANS), (1040, 2064, AA_EDGE_SPANS)])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_span_lists_group_each_item_by_row(h, w, edge_spans, seed):
    """Every kept span of item i on row r, and no other, lies in words
    [offsets[i, r] - base, offsets[i, r + 1] - base) as start | (end + 1)
    << 16, in the item's order; rows outside 0..h-1 are dropped."""
    from test_torch_cuda import tile_spans

    rng = np.random.default_rng(seed)
    items = [tile_spans(rng, k, h, w, edge_spans if k > 10 else ()) for k in (300, 0, 7, 41)]
    words, offsets = kernels.tile_span_lists(items, h, w, base=1000)
    assert words.dtype == np.int32 and offsets.dtype == np.int32 and offsets.shape == (4, h + 1)
    assert offsets[0, 0] == 1000 and offsets[-1, -1] == 1000 + len(words)
    assert (np.diff(offsets, axis=1) >= 0).all() and (offsets[1:, 0] == offsets[:-1, -1]).all()
    for i, (rows, starts, ends) in enumerate(items):
        for r in range(h):
            got = words[offsets[i, r] - 1000 : offsets[i, r + 1] - 1000]
            on_row = rows == r
            want = starts[on_row] | ((ends[on_row] + 1) << 16)
            assert np.array_equal(got, want.astype(np.int32)), (i, r)
    kept = sum(int(((rows >= 0) & (rows < h)).sum()) for rows, _, _ in items)
    assert len(words) == kept < sum(len(r) for r, _, _ in items)


@pytest.mark.parametrize("span", [(3, -1, 5), (3, 5, 128), (3, 129, 140), (3, 7, -2)])
def test_tile_span_lists_refuse_columns_outside_the_plane(span):
    """A kept span whose start or end + 1 leaves 0..w is refused; the same
    span on a dropped row is not."""
    r, s, e = span
    with pytest.raises(ValueError):
        kernels.tile_span_lists([(np.array([r]), np.array([s]), np.array([e]))], 64, 128)
    words, offsets = kernels.tile_span_lists([(np.array([64]), np.array([s]), np.array([e]))], 64, 128)
    assert len(words) == 0 and not offsets.any()


def test_stage_tile_lists_refuses_the_cpu():
    items = tile_interior_items()
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([c for c, _ in items], [f for _, f in items], "cpu")
    with pytest.raises(ValueError):
        kernels.tile_raster_interior([c for c, _ in items], [f for _, f in items], 8, torch.device("cpu"))


# --- the count --------------------------------------------------------------

def test_kernel_table_and_volume_are_the_references():
    src = open(CSRC).read()
    body = src[src.index("kTable[kFoot][kFoot] = {") :]
    body = body[: body.index("};")]
    table = np.array([int(v) for v in re.findall(r"\d+", body.split("=", 1)[1])]).reshape(32, 32)
    assert np.array_equal(table, TABLE)
    assert int(re.search(r"kVolume = (\d+);", src).group(1)) == TA.volume == JAA.volume


def row_words(mask: np.ndarray) -> np.ndarray:
    """(rows, cols) bool -> (rows, ceil(cols / 32)) uint32: bit b of word s
    is column 32 s + b (the ballot's layout)."""
    rows, cols = mask.shape
    padded = np.zeros((rows, -(-cols // 32) * 32), bool)
    padded[:, :cols] = mask
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(np.uint64)


def footprint_opacity(words: np.ndarray, dys: np.ndarray, xs: np.ndarray, c0: int) -> np.ndarray:
    """tile_raster.cu's count at pixels (dys, xs) of a band whose t-rows are
    `words` (row 16 dy is the pixel row's first), column c0 at bit 0: per
    footprint row v the 32 bits from column 16 x (a funnel shift of two
    words where 16 x is not word-aligned), 32 multiply-adds with the table,
    then (count * 256 + volume / 2) / volume."""
    col = 16 * xs - c0
    wi, sh = col >> 5, (col & 31).astype(np.uint64)
    count = np.zeros(len(xs), np.int64)
    nwords = words.shape[1]
    for v in range(32):
        lo = words[16 * dys + v, wi]
        hi = words[16 * dys + v, np.minimum(wi + 1, nwords - 1)]
        bits = np.where(sh == 0, lo, ((lo >> sh) | (hi << (np.uint64(32) - sh))) & np.uint64(0xFFFFFFFF))
        for u in range(32):
            count += ((bits >> np.uint64(u)) & np.uint64(1)).astype(np.int64) * TABLE[v, u]
    return (count * 256 + TA.volume // 2) // TA.volume


def _t_mask(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    shape = (1040, 2064)
    if kind.startswith("density"):
        return rng.random(shape) < float(kind[7:])
    rows, cols = np.indices(shape)
    return {"empty": np.zeros(shape, bool), "full": np.ones(shape, bool), "half_rows": rows < 517,
            "half_cols": cols >= 1031, "diagonal": 2 * rows + cols < 2700}[kind]


@pytest.mark.parametrize("kind", ["density0.05", "density0.5", "density0.95", "empty", "full", "half_rows",
                                  "half_cols", "diagonal"])
def test_footprint_count_matches_coverage_counts(kind):
    """The kernel's integer count over a whole piece's t-plane equals the
    JAX package's float32 table product and the port's plain one."""
    mask = _t_mask(kind)
    ys, xs = (a.reshape(-1) for a in np.indices((64, 128)))
    got = footprint_opacity(row_words(mask), ys, xs, 0).reshape(64, 128)
    want_jax = np.asarray(JAA._coverage_counts(jnp.asarray(mask), h=64, w=128, bf16=False))
    want_port = TA.coverage_counts(torch.from_numpy(mask)[None], 64, 128)[0].numpy()
    assert np.array_equal(want_jax, want_port)
    assert np.array_equal(got, want_jax)
    if kind == "full":
        assert (got == 255).all()


# --- the row scan -----------------------------------------------------------

def scan_row(words: np.ndarray, c0: int, steps: int) -> np.ndarray:
    """tile_raster.cu's scan_row: the mask of one row over columns [c0, c0 +
    32 steps) from its span words.  Spans that start or end left of c0
    only carry their count in; +1 / -1 at the columns in range, then the
    running sum > 0."""
    s = (words.astype(np.int64) & 0xFFFF)
    e = (words.astype(np.int64) >> 16) & 0xFFFF
    cend = c0 + 32 * steps
    carry = int((s < c0).sum()) - int((e < c0).sum())
    diff = np.zeros(32 * steps, np.int64)
    inside = (s >= c0) & (s < cend)
    np.add.at(diff, s[inside] - c0, 1)
    inside = (e >= c0) & (e < cend)
    np.add.at(diff, e[inside] - c0, -1)
    return np.cumsum(diff) + carry > 0


@pytest.mark.parametrize("seed", range(4))
def test_row_scan_from_any_word_matches_the_scatter(seed):
    """At random first words and widths, over rows of reversed and
    overlapping spans, the scan equals the plain scatter's mask (raster/aa.py
    mask_of_spans) on those columns."""
    from test_torch_cuda import tile_spans

    rng = np.random.default_rng(seed)
    spans = tile_spans(rng, 400, 16, 2064, AA_EDGE_SPANS[:4])
    words, offsets = kernels.tile_span_lists([spans], 16, 2064)
    rows, s, e = spans
    plain = TA.mask_of_spans(1, 16, 2064, np.zeros_like(rows), rows, s, e + 1, "cpu")[0].numpy()
    for r in range(16):
        for _ in range(6):
            c0 = 32 * int(rng.integers(0, 65))
            steps = int(rng.integers(1, 66 - c0 // 32))
            got = scan_row(words[offsets[0, r] : offsets[0, r + 1]], c0, steps)
            want = np.zeros(32 * steps, bool)
            cols = min(2064, c0 + 32 * steps) - c0
            want[:cols] = plain[r, c0 : c0 + cols]
            assert np.array_equal(got[:cols], want[:cols]), (r, c0, steps)


# --- the plain versions against the JAX package --------------------------------

@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case):
    """_edge_impl / _interior_impl against the JAX package's, bit for bit."""
    items, edge = _items(case)
    nb = 8
    fills = np.zeros((nb, 4), np.int32)
    fills[: len(items)] = [it[-1] for it in items]
    tfills = torch.from_numpy(fills[: len(items)])
    if edge:
        k1, ka = TTR._CLASSES[int(case[-1])]
        pairs = [jnp.asarray(JTR._pairs_stack([it[f] for it in items], nb, k)) for f, k in ((0, k1), (1, k1), (2, ka))]
        want = np.asarray(JTR._edge_tile_kernel(*pairs, jnp.asarray(fills), n=nb)).view(np.int32)
        got = TTR._edge_impl(*([it[f] for it in items] for f in range(3)), tfills).numpy()
    else:
        pairs = jnp.asarray(JTR._pairs_stack([it[0] for it in items], nb, TTR._K_INTERIOR))
        want = np.asarray(JTR._interior_tile_kernel(pairs, jnp.asarray(fills), n=nb)).view(np.int32)
        got = TTR._interior_impl([it[0] for it in items], tfills).numpy()
    assert np.array_equal(got, want[: len(items)])
    assert not want[len(items):].any() and want[0].any()
    # The items reach every branch: solid fill, dissolved fringe, alpha 0 and 255.
    alpha = (got[:2].view(np.uint32) >> 24).astype(np.int64)
    assert (alpha == 170).any() and (alpha == 255).any()
    if edge:
        assert ((alpha > 0) & (alpha < 170)).any()


# --- a model of the whole kernel ----------------------------------------------

def kernel_model(lists, nb: int) -> np.ndarray:
    """tile_raster.cu step by step in numpy, from the host lists (words and
    per-row offsets, as kernels.stage_tile_lists lays them out)."""
    words, cov_off, cross_off, aa_off, fills, n = lists
    out = np.zeros((nb, 64, 128), np.uint32)
    for i in range(n):
        def mask(off, rows=64, c0=0, steps=4, r0=0):
            if off is None:
                return np.zeros((rows, 32 * steps), bool)
            return np.stack([scan_row(words[off[i, r0 + t] : off[i, r0 + t + 1]], c0, steps) for t in range(rows)])

        cov, cross = mask(cov_off), mask(cross_off)
        opac = np.zeros((64, 128), np.int64)
        for band in range(4 if aa_off is not None else 0):
            ys, xs = np.nonzero(cov[16 * band : 16 * band + 16])
            if not len(ys):
                continue
            y0, y1, x0, x1 = 16 * band + ys.min(), 16 * band + ys.max(), xs.min(), xs.max()
            c0 = (16 * x0) & ~31
            steps = (16 * x1 + 32 - c0 + 31) // 32
            t = mask(aa_off, 16 * (y1 - y0) + 32, c0, steps, 16 * y0)
            fy, fx = np.nonzero(cov[y0 : y1 + 1, x0 : x1 + 1])
            opac[y0 + fy, x0 + fx] = footprint_opacity(row_words(t), fy, x0 + fx, c0)
        f = fills[i].astype(np.int64)
        d = opac[..., None]
        prod = (f * d) & 0xFFFFFFFF
        prod = np.where(prod >= 2**31, prod - 2**32, prod)
        dissolved = np.where(d == 0, 0, np.where(d == 255, f, (prod + (prod >> 8) + 1) >> 8))
        solid = f[None, None, :]
        rgba = np.where(cov[..., None], dissolved, np.where(cross[..., None], solid, 0)) & 0xFFFFFFFF
        out[i] = (rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16) | (rgba[..., 3] << 24)).astype(np.uint32)
    return out.view(np.int32)


def host_lists(items, edge: bool):
    """stage_tile_lists' lists, on the host: (words, cov offsets, cross
    offsets, aa offsets, fills, n), offsets as (n, rows + 1) arrays."""
    # In stage_tile_lists' order: cross, then cov and aa in edge mode.
    fams = [[it[c] for it in items] for c in ((3, 2, 4) if edge else (2,))]
    planes = [kernels.TILE_PLANE, kernels.TILE_PLANE, kernels.AA_PLANE]
    words, offsets, base = [], [], 0
    for spans, (h, w) in zip(fams, planes):
        wd, off = kernels.tile_span_lists(spans, h, w, base)
        words.append(wd)
        offsets.append(off)
        base += len(wd)
    fills = np.asarray([it[-1] for it in items], np.int32).reshape(-1, 4)
    words = np.concatenate(words)
    if not edge:
        return words, None, offsets[0], None, fills, len(items)
    return words, offsets[1], offsets[0], offsets[2], fills, len(items)


@pytest.mark.parametrize("case", CASES)
def test_kernel_model_matches_plain(case):
    items, edge = _items(case)
    staged = tile_build_items(items, edge)
    want = TTR.TileBuild(1, 1, "cpu").block_torch(staged, 8, edge).numpy()
    assert np.array_equal(kernel_model(host_lists(staged, edge), 8), want)


def test_kernel_model_matches_plain_on_the_lion():
    """The lion's staged items at 512x256 (thin fringe bands: each band's
    box is cropped) through the model and the plain version."""
    objs, _, _ = examples.bench_scene(512, 256, blob_radius=40, blob_at=(100, 120), f_box=(20, 60, 480, 250))
    tb = fastframe.stage_tiled_scene(4, 4, 512, 256, [(o.idset, o) for o in objs], "cpu")[0]
    n = 0
    for items, nb, edge in tb.batches():
        items = items[:24]
        want = tb.block_torch(items, nb, edge).numpy()
        assert np.array_equal(kernel_model(host_lists(items, edge), nb), want)
        n += len(items)
    assert n > 40
