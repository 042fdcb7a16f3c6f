"""TR1, the tile rasterizer kernel (kernels/csrc/tile_raster.cu), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain version there).  Here:

  * its host lists (kernels.tile_span_lists: each item's spans in their
    order, rows and packed columns, per-item offsets, refused columns;
    kernels.tile_raster_lists: the families of every block of a flush and
    the unit table, heaviest edge items first, every slot once) against the
    items they pack;
  * its Gaussian table against raster/aa.py's, and its integer footprint
    count, transcribed to numpy word for word (the 32-bit t-row words, the
    funnel shift, the table's nibble sums: 256 lookups a pixel), against
    the JAX package's ``raa._coverage_counts`` and the port's plain
    ``coverage_counts`` at random masks, half planes, an empty and a full
    plane;
  * its three row builders (one lane's bit-sliced counts of the spans and
    the reversed spans over each column, one warp's count at a word's
    first column and window of steps, the block's row of counts)
    against the plain scatter's mask on random rows with reversed,
    overlapping, duplicate and zero-length spans and columns 0 and w, and
    the lane builder under hypothesis (a fixed seed);
  * the plain versions (raster/tile_raster.py _edge_impl, _interior_impl)
    against the JAX package's, bit for bit, at every capacity class (an
    item at capacity, reversed and overlapping spans, spans at tile column
    0 and 127 and at scaled column 2063, rows the scatter drops, an empty
    item, fills with alpha 0 and 255), in interior mode and at the limits of
    the kernel's paths (tests/test_torch_cuda.py tile_capacity_items);
  * a numpy model of the whole kernel (a unit per band or interior piece;
    each unit binning the rows it needs by a count, a scan and runs of at
    most kBinCap spans; only the t-row words under the fringe pixels'
    footprints built, every other word left as garbage; the count, dissolve
    and pack) against the plain version on those items, on one flush of
    every class and on the lion's.

Tolerance 0 throughout: every step is integer math.
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp
from coherence_tpu.raster import aa as JAA
from coherence_tpu.raster import tile_raster as JTR

from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import aa as TA
from coherence_tpu_torch.raster import tile_raster as TTR
from coherence_tpu_torch.scene import examples, fastframe

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import (AA_EDGE_SPANS, TILE_BIN_CAP, TILE_EDGE_SPANS, TILE_LANE_CAP, tile_build_items,
                             tile_capacity_items, tile_edge_items, tile_flush_batches, tile_interior_items,
                             tile_spans)

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")
SRC = "".join(open(os.path.join(CSRC, f)).read() for f in ("span_rows.cuh", "tile_raster.cu"))  # TR1 and its row builders
TABLE = TA.maintable.T.astype(np.int64)  # tile_raster.cu's kTable[v][u]
LANE_CAP = int(re.search(r"kLaneCap = (\d+);", SRC).group(1))
BIN_CAP = int(re.search(r"kBinCap = (\d+);", SRC).group(1))
PLANES = LANE_CAP.bit_length()  # kPlanes = planes_for(kLaneCap): enough bits to count kLaneCap
ROW_WORDS = 65  # a t-row's words: columns 0..2079
CASES = ["class0", "class1", "class2", "class3", "class4", "interior"]
LIMITS = ["capacity", "shared_band", "odd_1x", "no_aa"]


def _items(case):
    if case in LIMITS:
        return [tile_capacity_items()[LIMITS.index(case)]], True
    return (tile_edge_items(int(case[-1])), True) if case != "interior" else (tile_interior_items(), False)


def test_kernel_constants_match_the_cases():
    """The card tests' items are built around the kernel's two capacities,
    and the unit codes are the kernel's."""
    assert (LANE_CAP, BIN_CAP) == (TILE_LANE_CAP, TILE_BIN_CAP) and LANE_CAP < 2**PLANES
    assert "kPlanes = planes_for(kLaneCap);" in SRC and "return n < 2 ? 1 : 1 + planes_for(n / 2);" in SRC
    assert "kBand = 16;" in SRC and "kBands = kTileH / kBand;" in SRC and "kWhole = kBands;" in SRC
    assert kernels.TILE_BANDS == 64 // 16 == kernels.TILE_WHOLE


# --- the host lists ---------------------------------------------------------

@pytest.mark.parametrize("h,w,edge_spans", [(64, 128, TILE_EDGE_SPANS), (1040, 2064, AA_EDGE_SPANS)])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_span_lists_keep_each_item_in_order(h, w, edge_spans, seed):
    """Item i's spans are rows and cols [offsets[i] - base, offsets[i + 1] -
    base), in the item's order, cols start | (end + 1) << 16; spans on rows
    outside 0..h-1 are kept (the kernel reads no such row)."""
    rng = np.random.default_rng(seed)
    items = [tile_spans(rng, k, h, w, edge_spans if k > 10 else ()) for k in (300, 0, 7, 41)]
    rows, cols, offsets = kernels.tile_span_lists(items, h, w, base=1000)
    assert rows.dtype == cols.dtype == offsets.dtype == np.int32 and offsets.shape == (5,)
    assert offsets[0] == 1000 and offsets[-1] == 1000 + len(rows) == 1000 + len(cols)
    for i, (r, s, e) in enumerate(items):
        lo, hi = offsets[i] - 1000, offsets[i + 1] - 1000
        assert np.array_equal(rows[lo:hi], r) and np.array_equal(cols[lo:hi], s | ((e + 1) << 16)), i
    assert len(rows) == sum(len(r) for r, _, _ in items) > sum(int(((r >= 0) & (r < h)).sum()) for r, _, _ in items)


@pytest.mark.parametrize("span", [(3, -1, 5), (3, 5, 128), (3, 129, 140), (3, 7, -2)])
def test_tile_span_lists_refuse_columns_outside_the_plane(span):
    """A span on a row of the plane whose start or end + 1 leaves 0..w is
    refused; the same span on a row outside the plane is not."""
    r, s, e = span
    with pytest.raises(ValueError):
        kernels.tile_span_lists([(np.array([r]), np.array([s]), np.array([e]))], 64, 128)
    rows, cols, offsets = kernels.tile_span_lists([(np.array([64]), np.array([s]), np.array([e]))], 64, 128)
    assert list(rows) == [64] and list(offsets) == [0, 1]


def test_stage_tile_lists_refuses_the_cpu():
    items = tile_interior_items()
    block = (None, [c for c, _ in items], None, [f for _, f in items], 8)
    with pytest.raises(ValueError):
        kernels.stage_tile_lists([block], "cpu")
    *arrays, n_items, slots = kernels.tile_raster_lists([block])
    with pytest.raises(ValueError):
        kernels.tile_raster((*(torch.from_numpy(a) for a in arrays), n_items, slots))


def test_tile_raster_lists_cover_every_slot_once():
    """The unit table: four band units an edge item, the items with the
    most AA spans first; one whole unit an interior item; one zero unit a
    slot no item owns; every slot once; the families' offsets in order."""
    blocks = tile_flush_batches()
    tb = TTR.TileBuild(1, 1, "cpu")
    rows, cols, offsets, fills, units, n_items, slots = kernels.tile_raster_lists([tb.kernel_lists(*b) for b in blocks])
    assert slots == sum(nb for _, nb, _ in blocks) and n_items == sum(len(it) for it, _, _ in blocks)
    assert offsets.shape == (3, n_items + 1) and (np.diff(offsets.reshape(-1)) >= 0).all()
    assert offsets[0, 0] == 0 and offsets[2, -1] == len(rows) == len(cols)
    assert fills.shape == (n_items, 4) and units.dtype == np.int32
    slot_of, edge_of, base = [], [], 0
    for items, nb, edge in blocks:
        slot_of += [base + i for i in range(len(items))]
        edge_of += [edge] * len(items)
        base += nb
    per_slot = {}
    for slot, code in units:
        per_slot.setdefault(int(slot), []).append(int(code))
    assert sorted(per_slot) == list(range(slots))
    aa_lens = np.diff(offsets[2])
    band_items = [int(c) >> 3 for c in units[:, 1] if c >= 0 and c & 7 < 4]
    assert band_items[::4] == band_items[3::4] and list(aa_lens[band_items[::4]]) == sorted(aa_lens[band_items[::4]],
                                                                                          reverse=True)
    for g, (slot, edge) in enumerate(zip(slot_of, edge_of)):
        want = [g << 3 | b for b in range(4)] if edge else [g << 3 | kernels.TILE_WHOLE]
        assert sorted(per_slot.pop(slot)) == want
    assert all(codes == [-1] for codes in per_slot.values()) and per_slot


# --- the count --------------------------------------------------------------

def test_kernel_table_and_volume_are_the_references():
    body = SRC[SRC.index("kTable[kFoot][kFoot] = {") :]
    body = body[: body.index("};")]
    table = np.array([int(v) for v in re.findall(r"\d+", body.split("=", 1)[1])]).reshape(32, 32)
    assert np.array_equal(table, TABLE)
    assert int(re.search(r"kVolume = (\d+);", SRC).group(1)) == TA.volume == JAA.volume


def nibble_table() -> np.ndarray:
    """tile_raster.cu's table of nibble sums, (32, 8, 16): [v][k][m] sums
    kTable[v][4k + j] over the set bits j of m."""
    m = np.arange(16)
    bits = (m[:, None] >> np.arange(4)) & 1
    return np.einsum("mj,vkj->vkm", bits, TABLE.reshape(32, 8, 4))


def test_nibble_table_sums_the_table():
    """Every 32-bit footprint row summed through the nibble table equals
    the table's product with its bits (all 2^16 patterns of a half row, at
    every row and half), and every entry fits the kernel's uint16."""
    table = nibble_table()
    assert table.max() <= 4 * 255 and table.min() == 0
    pats = np.arange(1 << 16)
    bits = (pats[:, None] >> np.arange(16)) & 1
    for v in range(32):
        for half in range(2):
            want = bits @ TABLE[v, 16 * half : 16 * half + 16]
            got = sum(table[v, 4 * half + k][(pats >> (4 * k)) & 15] for k in range(4))
            assert np.array_equal(got, want), (v, half)


def row_words(mask: np.ndarray) -> np.ndarray:
    """(rows, cols) bool -> (rows, ceil(cols / 32)) uint32: bit b of word s
    is column 32 s + b (the ballot's layout)."""
    rows, cols = mask.shape
    padded = np.zeros((rows, -(-cols // 32) * 32), bool)
    padded[:, :cols] = mask
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(np.uint64)


def footprint_opacity(words: np.ndarray, dys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """tile_raster.cu's count at pixels (dys, xs) of a band whose t-rows are
    `words` (row 16 dy is the pixel row's first, column 0 at bit 0): per
    footprint row v the 32 bits from column 16 x (word x / 2, a funnel
    shift of 16 into the next word where x is odd), 8 nibble lookups, then
    (count * 256 + volume / 2) / volume."""
    table = nibble_table()
    wi, odd = xs >> 1, (xs & 1).astype(bool)
    count = np.zeros(len(xs), np.int64)
    nwords = words.shape[1]
    for v in range(32):
        lo = words[16 * dys + v, wi]
        hi = words[16 * dys + v, np.minimum(wi + 1, nwords - 1)]
        bits = np.where(odd, ((lo >> np.uint64(16)) | (hi << np.uint64(16))) & np.uint64(0xFFFFFFFF), lo)
        for k in range(8):
            count += table[v, k][((bits >> np.uint64(4 * k)) & np.uint64(15)).astype(np.int64)]
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
    words = np.zeros((1040, ROW_WORDS), np.uint64)
    words[:, :65] = row_words(mask)
    got = footprint_opacity(words, ys, xs).reshape(64, 128)
    want_jax = np.asarray(JAA._coverage_counts(jnp.asarray(mask), h=64, w=128, bf16=False))
    want_port = TA.coverage_counts(torch.from_numpy(mask)[None], 64, 128)[0].numpy()
    assert np.array_equal(want_jax, want_port)
    assert np.array_equal(got, want_jax)
    if kind == "full":
        assert (got == 255).all()


# --- the row builders ---------------------------------------------------------

def run_bits(a: int, b: int) -> int:
    return ((1 << b) - 1) & ~((1 << a) - 1)


def slice_words(starts, stops, words) -> dict:
    """tile_raster.cu's lane_row: per needed word, the spans over each of its
    columns counted bit-sliced in PLANES planes, up those with start < end +
    1 and down the reversed ones, and the word's bits where up > down (the
    planes compared from the top).  {word: bits}."""
    planes = PLANES
    out = {}
    for w in words:
        c0 = 32 * w
        up, down = [0] * planes, [0] * planes
        for s, e in zip(starts, stops):
            s, e = int(s) - c0, int(e) - c0
            a, b = max(min(s, e), 0), min(max(s, e), 32)
            if a < b:
                counts, m = (up if s < e else down), run_bits(a, b)
                for p in range(planes):
                    counts[p], m = counts[p] ^ m, counts[p] & m
        gt, eq = 0, 0xFFFFFFFF
        for p in reversed(range(planes)):
            gt |= eq & up[p] & ~down[p]
            eq &= ~(up[p] ^ down[p]) & 0xFFFFFFFF
        out[w] = gt
    return out


def window_words(starts, stops, words) -> dict:
    """tile_raster.cu's warp_row: per needed word, the count at its first
    column c0 summed over the spans, plus the scan of its window of steps
    at columns c0 + 1 .. c0 + 31, > 0.  {word: bits}."""
    S, E = np.asarray(starts, np.int64), np.asarray(stops, np.int64)
    out = {}
    for w in words:
        c0 = 32 * w
        base = int((S <= c0).sum()) - int((E <= c0).sum())
        win = np.zeros(32, np.int64)
        inside = (S > c0) & (S < c0 + 32)
        np.add.at(win, S[inside] - c0, 1)
        inside = (E > c0) & (E < c0 + 32)
        np.add.at(win, E[inside] - c0, -1)
        on = base + np.cumsum(win) > 0
        out[w] = int((on.astype(np.int64) << np.arange(32)).sum())
    return out


def count_words(starts, stops, words) -> dict:
    """tile_raster.cu's one_row: +1 / -1 into a row of counts, scanned."""
    diff = np.zeros(32 * ROW_WORDS, np.int64)
    np.add.at(diff, np.asarray(starts, np.int64), 1)
    np.add.at(diff, np.asarray(stops, np.int64), -1)
    on = (np.cumsum(diff) > 0).reshape(ROW_WORDS, 32)
    return {w: int((on[w].astype(np.int64) << np.arange(32)).sum()) for w in words}


def scatter_words(starts, stops, w: int) -> np.ndarray:
    """The plain scatter's mask of one row over w columns, as words."""
    k = len(starts)
    mask = TA.mask_of_spans(1, 1, w, np.zeros(k, np.int64), np.zeros(k, np.int64), np.asarray(starts, np.int64),
                            np.asarray(stops, np.int64), "cpu")[0].numpy()
    return row_words(mask)[0]


@pytest.mark.parametrize("seed", range(4))
def test_row_builders_match_the_scatter(seed):
    """Each row builder on random rows of 0 to 3 x kLaneCap spans (the
    lane's up to kLaneCap; reversed, overlapping, duplicate, zero-length,
    starting at w or ending at column 0 or w - 1), on 1x and t-row widths
    and random word sets, equals the plain scatter's mask on those
    words."""
    from test_torch_cuda import _odd_spans

    rng = np.random.default_rng(seed)
    for w in (128, 2064):
        for k in list(range(0, 8)) + [LANE_CAP, LANE_CAP + 1, 3 * LANE_CAP]:
            _, s, e = _odd_spans(rng, [0], w, k)
            words = sorted({int(v) for v in rng.integers(0, -(-w // 32), int(rng.integers(1, 8)))})
            want = scatter_words(s, e + 1, w)
            for build in (slice_words, window_words, count_words)[k > LANE_CAP:]:  # a lane takes at most LANE_CAP
                got = build(s, e + 1, words)
                assert all(got[v] == want[v] for v in words), (build.__name__, w, k)


@pytest.mark.parametrize("up,down", [(LANE_CAP, 0), (LANE_CAP // 2, LANE_CAP // 2), (LANE_CAP // 2 + 1, LANE_CAP // 2 - 1),
                                     (0, LANE_CAP)])
def test_lane_rows_at_full_depth(up, down):
    """kLaneCap spans stacked over the same columns of a t-row, `up` of them
    forward (5..2000) and `down` reversed (2001..4): the lane's planes count
    up to kLaneCap, and the word bits are the scatter's."""
    starts = [5] * up + [2001] * down
    stops = [2001] * up + [5] * down
    words = list(range(ROW_WORDS))
    want = scatter_words(starts, stops, 2064)
    got = slice_words(starts, stops, words)
    assert all(got[w] == want[w] for w in words)
    assert bool(want[1]) == (up > down)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(0, 2064), st.integers(-1, 2063)), max_size=TILE_LANE_CAP),
       st.sets(st.integers(0, 64), min_size=1, max_size=65))
def test_lane_rows_match_the_scatter(spans, words):
    """The lane builder (lane_row's bit-sliced counts) against the plain
    scatter on random rows of any spans up to kLaneCap, in any order, and
    any needed words."""
    starts = [s for s, _ in spans]
    stops = [e + 1 for _, e in spans]
    want = scatter_words(starts, stops, 2064)
    got = slice_words(starts, stops, words)
    assert all(got[w] == want[w] for w in words)


# --- the plain versions against the JAX package --------------------------------

@pytest.mark.parametrize("case", CASES + LIMITS)
def test_plain_matches_jax(case):
    """_edge_impl / _interior_impl against the JAX package's, bit for bit."""
    items, edge = _items(case)
    nb = 8
    fills = np.zeros((nb, 4), np.int32)
    fills[: len(items)] = [it[-1] for it in items]
    tfills = torch.from_numpy(fills[: len(items)])
    if edge:
        k1, ka = TTR._CLASSES[4 if case in LIMITS else int(case[-1])]
        pairs = [jnp.asarray(JTR._pairs_stack([it[f] for it in items], nb, k)) for f, k in ((0, k1), (1, k1), (2, ka))]
        want = np.asarray(JTR._edge_tile_kernel(*pairs, jnp.asarray(fills), n=nb)).view(np.int32)
        got = TTR._edge_impl(*([it[f] for it in items] for f in range(3)), tfills).numpy()
    else:
        pairs = jnp.asarray(JTR._pairs_stack([it[0] for it in items], nb, TTR._K_INTERIOR))
        want = np.asarray(JTR._interior_tile_kernel(pairs, jnp.asarray(fills), n=nb)).view(np.int32)
        got = TTR._interior_impl([it[0] for it in items], tfills).numpy()
    assert np.array_equal(got, want[: len(items)])
    assert not want[len(items):].any() and want[0].any()
    if case in LIMITS:
        return
    # The items reach every branch: solid fill, dissolved fringe, alpha 0 and 255.
    alpha = (got[:2].view(np.uint32) >> 24).astype(np.int64)
    assert (alpha == 170).any() and (alpha == 255).any()
    if edge:
        assert ((alpha > 0) & (alpha < 170)).any()


# --- a model of the whole kernel ----------------------------------------------

def build_rows(rows, cols, ranges, nt, need, out, paths):
    """tile_raster.cu's build_rows: rows 0 .. nt - 1 of the spans of `ranges`
    (each ((lo, hi), r0, nr, t0): its rows r0 .. r0 + nr - 1 are rows t0 ..)
    that `need` names words of, counted, scanned and binned in runs of at
    most BIN_CAP spans (a row of more by the block's row of counts), each row
    by a lane (at most LANE_CAP spans) or a warp; out[t][w] set for each
    needed word w.  A row's spans are binned in any order: no builder depends
    on it."""
    ts, ks = [], []
    for (lo, hi), r0, nr, t0 in ranges:
        t = rows[lo:hi].astype(np.int64) - r0
        keep = (t >= 0) & (t < nr)
        ts.append(t[keep] + t0)
        ks.append(np.arange(lo, hi)[keep])
    needs = [need(v) for v in range(nt)]
    t, k = np.concatenate(ts), np.concatenate(ks)
    keep = np.array([bool(needs[v]) for v in t], bool) if len(t) else np.zeros(0, bool)
    t, k = t[keep], k[keep]
    first = np.zeros(nt + 1, np.int64)
    np.cumsum(np.bincount(t, minlength=nt), out=first[1:])
    binned = k[np.argsort(t, kind="stable")]
    ra = 0
    while ra < nt:
        if first[ra + 1] - first[ra] > BIN_CAP:
            rb = ra + 1
        else:
            rb = min(int(np.searchsorted(first, first[ra] + BIN_CAP, "right")) - 1, nt)
            paths["runs"] += 1
        for r in range(ra, rb):
            if not needs[r]:
                continue
            spans = cols[binned[first[r] : first[r + 1]]].astype(np.int64)
            n = len(spans)
            builder = count_words if n > BIN_CAP else slice_words if n <= LANE_CAP else window_words
            paths["block" if n > BIN_CAP else "lane" if n <= LANE_CAP else "warp"] += 1
            for w, bits in builder(spans & 0xFFFF, spans >> 16, needs[r]).items():
                out[r][w] = bits
        ra = rb


def unit_model(lists, slot: int, code: int, piece: np.ndarray, paths) -> None:
    """One block of the kernel: its unit's rows of `piece`: its 1x rows
    (coverage, then crossing) built from one binning, the fringe listed, then
    the band's 272 t-rows from another, only the words a footprint reads
    (every other word left as garbage)."""
    rows, cols, offsets, fills = lists[:4]
    rng = np.random.default_rng(slot)
    if code < 0:
        piece[:] = 0
        return
    item, mode = code >> 3, code & 7
    whole = mode == kernels.TILE_WHOLE
    y0, ny = (0, 64) if whole else (16 * mode, 16)
    masks = rng.integers(0, 2**32, (2 * ny, 4), dtype=np.uint64)  # shared memory starts as garbage
    cov_range = (0, 0) if whole else (offsets[0, item], offsets[0, item + 1])
    build_rows(rows, cols, [(cov_range, y0, ny, 0), ((offsets[1, item], offsets[1, item + 1]), y0, ny, ny)], 2 * ny,
               lambda t: [0, 1, 2, 3], masks, paths)
    bits = (masks[..., None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    cov, cross = bits.reshape(2 * ny, 128).astype(bool)[:ny], bits.reshape(2 * ny, 128).astype(bool)[ny:]
    opac = np.zeros((ny, 128), np.int64)
    if not whole and cov.any():
        padded = np.zeros((16, 130), bool)
        padded[:, 1:129] = cov
        need = [[j for j in range(ROW_WORDS) if padded[y, 2 * j : 2 * j + 3].any()] for y in range(16)]

        def need_aa(t):
            y = t >> 4
            return sorted(set(need[y] if y < 16 else []) | set(need[y - 1] if y > 0 else []))

        tbits = rng.integers(0, 2**32, (272, ROW_WORDS), dtype=np.uint64)  # words no footprint reads stay garbage
        build_rows(rows, cols, [((offsets[2, item], offsets[2, item + 1]), 16 * y0, 272, 0)], 272, need_aa, tbits,
                   paths)
        fy, fx = np.nonzero(cov)
        opac[fy, fx] = footprint_opacity(tbits, fy, fx)
    f = fills[item].astype(np.int64)
    d = opac[..., None]
    prod = (f * d) & 0xFFFFFFFF
    prod = np.where(prod >= 2**31, prod - 2**32, prod)
    dissolved = np.where(d == 0, 0, np.where(d == 255, f, (prod + (prod >> 8) + 1) >> 8))
    rgba = np.where(cov[..., None], dissolved, np.where(cross[..., None], f[None, None, :], 0)) & 0xFFFFFFFF
    piece[y0 : y0 + ny] = (rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16) | (rgba[..., 3] << 24)).astype(
        np.uint32).view(np.int32)


def kernel_model(lists):
    """tile_raster.cu unit by unit in numpy, from kernels.tile_raster_lists'
    host lists: ((slots, 64, 128) int32, {path: rows built there})."""
    units, slots = lists[4], lists[6]
    out = np.full((slots, 64, 128), 0x5A5A5A5A, np.int32)  # torch.empty: the kernel writes every slot
    paths = {"lane": 0, "warp": 0, "block": 0, "runs": 0}
    for slot, code in units:
        unit_model(lists, int(slot), int(code), out[slot], paths)
    return out, paths


def model_flush(batches):
    """(the model's blocks, the plain version's, paths) for one flush."""
    tb = TTR.TileBuild(1, 1, "cpu")
    got, paths = kernel_model(kernels.tile_raster_lists([tb.kernel_lists(*b) for b in batches]))
    want = np.concatenate([tb.block_torch(*b).numpy() for b in batches])
    return got, want, paths


@pytest.mark.parametrize("case", CASES + ["limits"])
def test_kernel_model_matches_plain(case):
    """The model at every capacity class, in interior mode and at the
    limits of its paths (an item at capacity with every AA span in one band:
    a row past the bins, rows past a lane, runs of rows; the t-rows two bands
    share; odd 1x spans; coverage with no AA span)."""
    items, edge = (tile_capacity_items(), True) if case == "limits" else _items(case)
    got, want, paths = model_flush([(tile_build_items(items, edge), 8, edge)])
    assert np.array_equal(got, want)
    if case == "limits":
        assert paths["block"] >= 1 and paths["warp"] >= 3 and paths["runs"] >= 3, paths


def test_kernel_model_matches_plain_on_one_flush():
    """Every class, the limits and interior items in one launch's lists."""
    got, want, paths = model_flush(tile_flush_batches())
    assert np.array_equal(got, want)
    assert min(paths.values()) >= 1


def test_kernel_model_matches_plain_on_the_lion():
    """The lion's staged items at 512x256 (thin fringe bands: few t-row
    words read) through the model and the plain version."""
    objs, _, _ = examples.bench_scene(512, 256, blob_radius=40, blob_at=(100, 120), f_box=(20, 60, 480, 250))
    tb = fastframe.stage_tiled_scene(4, 4, 512, 256, [(o.idset, o) for o in objs], "cpu")[0]
    batches = [(items[:24], nb, edge) for items, nb, edge in tb.batches()]
    got, want, _ = model_flush(batches)
    assert np.array_equal(got, want)
    assert sum(len(items) for items, _, _ in batches) > 40
