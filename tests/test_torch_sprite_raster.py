"""SR1, the sprite rasterizer kernel (kernels/csrc/sprite_raster.cu), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain versions there).  Here:

  * its host lists (kernels.sprite_raster_lists, sprite_opacity_lists: each
    member's three span families sorted by 16-row groups, in the sweep's
    order inside a group, 8 bytes a span with its row's low 9 bits, rows
    off the plane dropped and columns clipped; each band's ranges of each
    family, the output layout and the unit table, the units that read the
    most spans first, every band and strip once) against the spans they
    pack, by hypothesis too (each span in the range of exactly the units
    whose rows hold it), and their refusals;
  * a numpy model of the kernel read from those lists alone (a unit per
    band of 16 rows and strip of 128 columns of a member; each unit's rows
    from its band's ranges alone, completed from the band's first row,
    moved into the strip and clamped to it, the t-rows under its fringe by
    tests/test_torch_tile_kernel.py's footprint count, in opacity mode
    only the mixed footprints counted and the others 0 or the full
    table's opacity, the dissolve; every pixel written once, into one
    output buffer whose views kernels.sprite_views makes) against the JAX
    package's
    _build_group_kernel (group mode) and aa.coverage_opacity (opacity
    mode), and against the port's plain versions (_raster_members,
    coverage_opacity_torch): ragged boxes with spans off their planes,
    reversed and overlapping, a member with no AA span and one with an
    empty minshape, fills of alpha 0 and 255, rows past a lane's and a
    bin's capacity, plain-filled and stroked paths, a 1920-wide matte
    taller than a band, the lion's groups, and a 131,071 x 2 matte past
    the first design's packing (H61);
  * the shortcut of opacity mode (an all-clear footprint 0, an all-set one
    the full table's 255) against the count at every pixel of every
    opacity case and of the lion's two scalar mattes;
  * the kernel's one-pass union of a band's spans against their running
    count > 0, unit by unit, wherever no span is reversed (every real
    path's lists; the random cases hold reversed spans, which the kernel
    builds by their counts);
  * the CPU path: no kernel wrapper is reached.

Tolerance 0 throughout: every step is integer math.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from coherence_tpu.raster import aa as JAA
from coherence_tpu.raster import region as JR
from coherence_tpu.scene import fastframe as JF

from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import aa as TA
from coherence_tpu_torch.scene import fastframe as TF

from _torch_threads import one_torch_thread  # noqa: F401
from hypothesis import given, settings, strategies as st

from test_torch_cuda import lion_objects, sprite_as_members, sprite_case, sprite_h61_case, sprite_of_members, \
    sprite_opacity_case, sprite_paths, sprite_spans
from test_torch_tile_kernel import TABLE, footprint_opacity, row_words

GROUP_CASES = ["ragged", "heavy", "paths", "tall"]
OPACITY_CASES = ["wide", "odd", "pixel", "empty", "circle"]


def group_case(name: str):
    return sprite_paths() if name == "paths" else sprite_case(name)


def decoded(lists):
    """Every span of `lists` as int64 (row's low 9 bits, starts, ends + 1)."""
    v = lists.spans.view(np.uint64).reshape(-1)
    return (v >> np.uint64(54)).astype(np.int64), ((v >> np.uint64(27)) & np.uint64(2**27 - 1)).astype(np.int64), \
        (v & np.uint64(2**27 - 1)).astype(np.int64)


def band_rows(spans, lo: int, hi: int, base: int):
    """Spans [lo, hi) of a band's range with their rows counted from the
    band's first row `base` (the kernel's (9 bits - base) mod 512)."""
    rows, starts, stops = (a[lo:hi] for a in spans)
    return (rows - base) & 511, starts, stops


def strip_rows(spans, nr: int, c0: int, cmax: int, width: int) -> np.ndarray:
    """bool (nr, width): rows 0 .. nr - 1 of a band's spans, their columns
    moved to c0 and clamped to 0..cmax, as a running count > 0."""
    rows, starts, stops = spans
    assert ((rows >= 0) & (rows < nr)).all()  # a range holds its band's rows only
    diff = np.zeros((nr, width + 1), np.int64)
    np.add.at(diff, (rows, np.clip(starts - c0, 0, cmax)), 1)
    np.add.at(diff, (rows, np.clip(stops - c0, 0, cmax)), -1)
    return np.cumsum(diff, axis=1)[:, :width] > 0


# The opacity of a footprint whose 32 x 32 samples are all set: the table's
# sum through the opacity formula, as the kernel computes it.
FULL = (int(TABLE.sum()) * 256 + TA.volume // 2) // TA.volume


def footprint_kinds(words: np.ndarray, dys: np.ndarray, xs: np.ndarray):
    """(all set, all clear) of each pixel's footprint, read from its 32
    t-rows' 32-bit rows as footprint_opacity reads them."""
    wi, odd = xs >> 1, (xs & 1).astype(bool)
    nwords = words.shape[1]
    every, some = np.full(len(xs), 0xFFFFFFFF, np.uint64), np.zeros(len(xs), np.uint64)
    for v in range(32):
        lo = words[16 * dys + v, wi]
        hi = words[16 * dys + v, np.minimum(wi + 1, nwords - 1)]
        bits = np.where(odd, ((lo >> np.uint64(16)) | (hi << np.uint64(16))) & np.uint64(0xFFFFFFFF), lo)
        every &= bits
        some |= bits
    return every == 0xFFFFFFFF, some == 0


def div255(i):
    return (i + (i >> 8) + 1) >> 8


def dissolve(c, d):
    return np.where(d == 0, 0, np.where(d == 255, c, div255(c * d)))


def model(lists, shortcut: bool = True) -> np.ndarray:
    """sprite_raster's output buffer for `lists`, unit by unit as the kernel
    computes it, each unit from its band's ranges alone; in opacity mode
    with `shortcut` only the mixed footprints counted (else every pixel).
    Every pixel of every member written exactly once."""
    buf = np.zeros(lists.out_bytes, np.uint8)
    spans = decoded(lists)
    hits = [np.zeros((h, w), np.int64) for h, w in lists.members[:, :2]]
    for m, band, strip, row in lists.units:
        h, w, mask_at, minmask_at, rgba_at = (int(v) for v in lists.members[m, :5])
        cov_lo, cov_hi, cross_lo, cross_hi, aa_lo, aa_hi = (int(v) for v in lists.bands[row, :6])
        y0, x0 = 16 * band, 128 * strip
        ny, cw = min(16, h - y0), min(128, w - x0)
        hits[m][y0 : y0 + ny, x0 : x0 + cw] += 1
        if lists.opacity:
            fringe = np.ones((ny, cw), bool)
        else:
            cov = strip_rows(band_rows(spans, cov_lo, cov_hi, y0), ny, x0, cw, 128)[:, :cw]
            cross = strip_rows(band_rows(spans, cross_lo, cross_hi, y0), ny, x0, cw, 128)[:, :cw]
            fringe = cov
        t0 = 2048 * strip
        t = strip_rows(band_rows(spans, aa_lo, aa_hi, 16 * y0), 16 * ny + 16, t0, min(2064, 16 * w + 16 - t0), 2080)
        words = row_words(t)
        ys, xs = np.nonzero(fringe)
        opac = np.zeros((ny, cw), np.int64)
        if lists.opacity and shortcut:
            full, clear = footprint_kinds(words, ys, xs)
            mixed = ~full & ~clear
            opac[ys[full], xs[full]] = FULL
            opac[ys[mixed], xs[mixed]] = footprint_opacity(words, ys[mixed], xs[mixed])
        else:
            opac[ys, xs] = footprint_opacity(words, ys, xs)
        if lists.opacity:
            plane = buf[16 * rgba_at : 16 * rgba_at + 4 * h * w].view(np.int32).reshape(h, w)
            plane[y0 : y0 + ny, x0 : x0 + cw] = opac
            continue
        fill = lists.fills[m].astype(np.int64)
        rgba = np.where(cov[..., None], dissolve(fill, opac[..., None]), np.where(cross[..., None], fill, 0))
        buf[16 * mask_at : 16 * mask_at + h * w].reshape(h, w)[y0 : y0 + ny, x0 : x0 + cw] = cov | cross
        buf[16 * minmask_at : 16 * minmask_at + h * w].reshape(h, w)[y0 : y0 + ny, x0 : x0 + cw] = cross & ~cov
        buf[16 * rgba_at : 16 * rgba_at + 16 * h * w].view(np.int32).reshape(h, w, 4)[y0 : y0 + ny, x0 : x0 + cw] = rgba
    assert all(bool((hit == 1).all()) for hit in hits)
    return buf


def modelled(lists):
    """The model's planes as sprite_raster returns them (sprite_views)."""
    return kernels.sprite_views(lists, torch.from_numpy(model(lists)))


def jax_group(case):
    """The JAX package's _build_group_kernel over the case's members in one
    call (their buckets' largest, as a group of one key would be), cropped
    to each box: [(mask, minmask, rgba)] numpy."""
    boxes, fills, cov, cross, aa = case
    n = len(boxes)
    B = JF._group_b(n)
    hb, wb = (max(JR.bucket_hw(h, w)[k] for _, _, w, h in boxes) for k in range(2))

    def stacked(fam):
        kb = JAA.span_bucket(2 * max(0 if sp is None else len(sp[0]) for sp in fam))
        arrays = [np.stack(JAA.spans_to_scatter_np(sp, kb)) for sp in fam]
        return jnp.asarray(np.stack(arrays + [np.stack(JAA.spans_to_scatter_np(None, kb))] * (B - n)))

    geo = np.array(list(boxes) + [(0, 0, 1, 1)] * (B - n), np.int32)
    fill = np.array(list(fills) + [(0, 0, 0, 0)] * (B - n), np.int32)
    masks, minmasks, rgbas = JF._build_group_kernel(stacked(cov), stacked(cross), stacked(aa), jnp.asarray(geo),
                                                    jnp.asarray(fill), hb=hb, wb=wb, B=B)
    return [(np.asarray(masks[j])[:h, :w], np.asarray(minmasks[j])[:h, :w], np.asarray(rgbas[j])[:h, :w])
            for j, (_, _, w, h) in enumerate(boxes)]


def packed_family(sp, r0: int, h: int, c0: int, w: int):
    """A family of one member as the host packs it: (rows' low 9 bits,
    starts, ends + 1, rows in the plane), rows off the plane dropped,
    columns clipped, sorted stably by 16-row groups."""
    if sp is None:
        return (np.zeros(0, np.int64),) * 4
    rows, s, e = (np.asarray(a, np.int64) for a in sp)
    r = rows - r0
    keep = (r >= 0) & (r < h)
    order = np.argsort(r[keep] >> 4, kind="stable")
    r, s, e = r[keep][order], s[keep][order], e[keep][order]
    return r & 511, np.clip(s - c0, 0, w), np.clip(e + 1 - c0, 0, w), r


def check_lists(lists, boxes, fams):
    """`lists` hold each member's families as packed_family packs them, and
    each band's range of a family holds exactly the spans on its rows (a
    1x band's 16, an AA band's 272 t-rows); the units are every band and
    strip of every member once, those that read the most spans first."""
    spans, units = decoded(lists), lists.units.astype(np.int64)
    want = {(m, b, s) for m, (_, _, w, h) in enumerate(boxes) for b in range(-(-h // 16)) for s in range(-(-w // 128))}
    assert len(units) == len(want) and {tuple(u[:3]) for u in units.tolist()} == want
    reads = (lists.bands[units[:, 3], 1:6:2].astype(np.int64) - lists.bands[units[:, 3], 0:6:2]).sum(1)
    assert (np.diff(reads) <= 0).all()
    for m, (x0, y0, w, h) in enumerate(boxes):
        mine = units[units[:, 0] == m]
        rows = [int(mine[mine[:, 1] == b][0, 3]) for b in range(-(-h // 16))]
        assert all((mine[mine[:, 1] == b][:, 3] == row).all() for b, row in enumerate(rows))
        planes = ((y0, h, x0, w), (y0, h, x0, w), (16 * y0 - 32, 16 * h + 16, 16 * x0 - 32, 16 * w + 16))
        for f, plane in enumerate(planes):
            *packed, r = packed_family(fams[f][m], *plane)
            lo, hi = int(lists.bands[rows[0], 2 * f]), int(lists.bands[rows[-1], 2 * f + 1])
            assert hi - lo == len(r) and all(np.array_equal(g[lo:hi], p) for g, p in zip(spans, packed)), (m, f)
            for b, row in enumerate(rows):
                a, z = (16 * b, 16 * b + 16) if f < 2 else (256 * b, 256 * b + 272)
                assert lists.bands[row, 2 * f] == lo + int((r < a).sum()), (m, f, b)
                assert lists.bands[row, 2 * f + 1] == lo + int((r < z).sum()), (m, f, b)


def opacity_fams(scaled):
    return [None], [None], [scaled]


def opacity_boxes(box):
    x0, y0, x1, y1 = box
    return [(x0, y0, x1 - x0 + 1, y1 - y0 + 1)]


@pytest.mark.parametrize("name", GROUP_CASES)
def test_sprite_lists_pack_every_span(name):
    """Each member's families by 16-row groups, in their order inside a
    group, moved to its planes, rows off them dropped and columns clipped;
    each band's ranges, the units (every band and strip of every member
    once, those that read the most spans first) and the output layout
    (16-byte segments, no overlap)."""
    case = group_case(name)
    boxes, fills, *fams = case
    lists = kernels.sprite_raster_lists(*case)
    assert lists.spans.dtype == np.int32 and lists.spans.shape[1] == 2 and lists.bands.shape[1] == 8
    check_lists(lists, boxes, fams)
    assert np.array_equal(lists.fills, np.asarray(fills, np.int32))
    segments = sorted((16 * int(at), size) for (h, w), ats in zip(lists.members[:, :2], lists.members[:, 2:5])
                      for at, size in zip(ats, (h * w, h * w, 16 * h * w)))
    assert all(a + size <= b for (a, size), (b, _) in zip(segments, segments[1:]))
    assert segments[-1][0] + segments[-1][1] <= lists.out_bytes


@pytest.mark.parametrize("name", OPACITY_CASES)
def test_sprite_opacity_lists_pack_every_span(name):
    """Opacity mode's lists: one member, its AA family alone, packed and
    ranged as group mode's."""
    box, scaled = sprite_opacity_case(name)
    lists = kernels.sprite_opacity_lists(box, scaled)
    check_lists(lists, opacity_boxes(box), opacity_fams(scaled))
    assert not lists.bands[:, :4].any() and lists.opacity


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(-40, 40), st.integers(-40, 40), st.integers(1, 300), st.integers(1, 50),
                          st.integers(0, 60), st.integers(0, 400)), min_size=1, max_size=3),
       st.integers(0, 2**32 - 1))
def test_sprite_band_ranges_hold_exactly_their_rows(members, seed):
    """Ragged boxes whose spans are reversed, overlapping, duplicated and
    off their planes: every span lies in the range of exactly the bands
    whose rows hold it, and nowhere else (check_lists)."""
    rng = np.random.default_rng(seed)
    boxes = [(x0, y0, w, h) for x0, y0, w, h, _, _ in members]
    fams = ([], [], [])
    for x0, y0, w, h, n1, na in members:
        fams[0].append(sprite_spans(rng, n1, y0, h, x0, w, 20))
        fams[1].append(sprite_spans(rng, n1, y0, h, x0, w, 20) if n1 % 3 else None)
        fams[2].append(sprite_spans(rng, na, 16 * y0 - 32, 16 * h + 16, 16 * x0 - 32, 16 * w + 16, 300))
    lists = kernels.sprite_raster_lists(boxes, [(1, 2, 3, 4)] * len(boxes), *fams)
    check_lists(lists, boxes, fams)


@pytest.mark.parametrize("name", GROUP_CASES)
def test_sprite_model_matches_jax_and_plain(name):
    """The kernel's model in group mode against the JAX package's
    _build_group_kernel and the port's _raster_members, bit for bit; every
    plane a contiguous view on 16 bytes of one buffer."""
    case = group_case(name)
    got = modelled(kernels.sprite_raster_lists(*case))
    plain = [p for m in sprite_as_members(case) for p in zip(*TF._raster_members([m], "cpu"))]
    for (mask, minmask, rgba), (jm, jmin, jrgba), (pm, pmin, prgba) in zip(got, jax_group(case), plain):
        assert mask.dtype == torch.bool and minmask.dtype == torch.bool and rgba.dtype == torch.int32
        for g in (mask, minmask, rgba):
            assert g.is_contiguous() and g.data_ptr() % 16 == 0
        assert np.array_equal(mask.numpy(), jm) and np.array_equal(minmask.numpy(), jmin)
        assert np.array_equal(rgba.numpy(), jrgba)
        assert torch.equal(mask, pm) and torch.equal(minmask, pmin) and torch.equal(rgba, prgba)
    assert len({g.untyped_storage().data_ptr() for planes in got for g in planes}) == 1


def test_sprite_cases_reach_every_kind():
    """The cases hold what they are for: alpha 0 and 255 fills, a member
    with no AA span, an empty minshape, a fringe, rows off the planes."""
    boxes, fills, cov, cross, aa = sprite_case("ragged")
    assert {f[3] for f in fills} >= {0, 255} and aa[2] is None and cross[3] is cov[3]
    got = modelled(kernels.sprite_raster_lists(boxes, fills, cov, cross, aa))
    assert not bool(got[3][1].any()) and all(bool(m.any()) for m, _, _ in got)
    assert any(bool((m & ~mm).any()) for m, mm, _ in got)
    lists = kernels.sprite_raster_lists(boxes, fills, cov, cross, aa)
    given_spans = sum(len(sp[0]) for fam in (cov, cross, aa) for sp in fam if sp is not None)
    assert len(lists.spans) < given_spans  # rows off the planes are not packed
    _, _, _, _, paths_aa = sprite_paths()
    assert len(paths_aa) == 6


@pytest.mark.parametrize("name", OPACITY_CASES)
def test_sprite_opacity_model_matches_jax_and_plain(name):
    """The kernel's model in opacity mode against the JAX package's
    aa.coverage_opacity and the port's coverage_opacity_torch, bit for
    bit: a 1920-wide box taller than a band, a 37 x 300 box, one pixel, no
    span, a circle's matte."""
    box, scaled = sprite_opacity_case(name)
    lists = kernels.sprite_opacity_lists(box, scaled)
    got = modelled(lists)
    x0, y0, x1, y1 = box
    assert lists.opacity and got.shape == (y1 - y0 + 1, x1 - x0 + 1) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(JAA.coverage_opacity(box, scaled)))
    assert torch.equal(got, TA.coverage_opacity_torch(box, scaled, "cpu"))
    if name != "empty":
        assert bool((got > 0).any())


def test_sprite_model_matches_the_lion():
    """The lion (fitted to 384 pixels) as the batched build groups it: all
    its groups' members in one model launch, against _raster_members over
    each group's sub-batches, bit for bit."""
    out, groups = TF._group_members(lion_objects(384), "cpu")
    assert len(groups) > 4 and all(s is None for s in out)
    got = modelled(kernels.sprite_raster_lists(*sprite_of_members(groups)))
    want = [p for members in groups.values() for run in TF._sub_batches(members)
            for p in zip(*TF._raster_members(run, "cpu"))]
    assert len(got) == len(want) == sum(len(m) for m in groups.values())
    for planes, wants in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(planes, wants))


def test_cpu_path_reaches_no_kernel(monkeypatch):
    """On the CPU the batched build and the AA matte take their plain
    versions: no wrapper of SR1 is called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on the CPU")

    for name in ("sprite_raster", "stage_sprite_lists", "sprite_raster_opacity"):
        monkeypatch.setattr(kernels, name, refuse)
    box, scaled = sprite_opacity_case("circle")
    assert torch.equal(TA.coverage_opacity(box, scaled, "cpu"), TA.coverage_opacity_torch(box, scaled, "cpu"))
    sprites = TF.full_sprites_of_objects(lion_objects(128), "cpu")
    assert sum(s is not None for s in sprites) > 100


def union_rows(spans, nr: int, c0: int, cmax: int, width: int):
    """sprite_raster.cu's union_rows on a band's spans (rows counted from
    the band's first): (the union of each row's forward spans, their
    columns moved to c0 and clamped to 0..cmax, as bool (nr, width);
    whether a span is reversed in the strip)."""
    rows, starts, stops = spans
    a, b = np.clip(starts - c0, 0, cmax), np.clip(stops - c0, 0, cmax)
    mask = np.zeros((nr, width), bool)
    for r, lo, hi in zip(rows, a, b):
        mask[r, lo:hi] = True
    return mask, bool((a > b).any())


def unit_rows(lists):
    """Per unit of `lists`, its families' band spans as union_rows and
    strip_rows take them: (spans, nr, c0, cmax, width) each."""
    spans = decoded(lists)
    for m, band, strip, row in lists.units:
        h, w = (int(v) for v in lists.members[m, :2])
        lo = lists.bands[row]
        y0, x0, ny, cw = 16 * band, 128 * strip, min(16, h - 16 * band), min(128, w - 128 * strip)
        t0 = 2048 * strip
        if not lists.opacity:
            yield band_rows(spans, lo[0], lo[1], y0), ny, x0, cw, 128
            yield band_rows(spans, lo[2], lo[3], y0), ny, x0, cw, 128
        yield band_rows(spans, lo[4], lo[5], 16 * y0), 16 * ny + 16, t0, min(2064, 16 * w + 16 - t0), 2080


@pytest.mark.parametrize("name", GROUP_CASES + ["lion"] + ["opacity_" + c for c in OPACITY_CASES])
def test_union_of_spans_is_their_count_where_none_is_reversed(name):
    """union_rows' one pass (each forward span OR'ed into its row) equals
    the running count > 0 at every unit's rows where no span is reversed
    in the strip, as in every real path's lists; the random cases also
    reach the count that a reversed span needs (the kernel's build_rows)."""
    if name == "lion":
        lists = kernels.sprite_raster_lists(*sprite_of_members(TF._group_members(lion_objects(384), "cpu")[1]))
    elif name.startswith("opacity_"):
        lists = kernels.sprite_opacity_lists(*sprite_opacity_case(name[len("opacity_"):]))
    else:
        lists = kernels.sprite_raster_lists(*group_case(name))
    reversed_units = 0
    for spans, nr, c0, cmax, width in unit_rows(lists):
        union, rev = union_rows(spans, nr, c0, cmax, width)
        reversed_units += rev
        if not rev:
            assert np.array_equal(union, strip_rows(spans, nr, c0, cmax, width))
    assert (reversed_units == 0) == (name in ("paths", "lion", "opacity_circle", "opacity_empty"))


def lion_mattes():
    """The (box, scaled spans) and plain opacity of each matte that the
    lion's scalar members (fitted to 1024 pixels, as general_lion) take
    through aa.coverage_opacity on the CPU."""
    from coherence_tpu_torch.scene import cache

    mattes, real = [], TA.coverage_opacity

    def recording(box, scaled, device):
        out = real(box, scaled, device)
        mattes.append((box, scaled, out))
        return out

    cache.clear()
    TA.coverage_opacity = recording
    try:
        TF._group_members(lion_objects(), "cpu")
    finally:
        TA.coverage_opacity = real
        cache.clear()
    return mattes


@pytest.mark.parametrize("name", OPACITY_CASES + ["lion_mattes"])
def test_sprite_opacity_shortcut_equals_the_count(name):
    """Opacity mode's shortcut (an all-clear footprint 0, an all-set one
    the table's full opacity, 255; only the others counted) equals the
    count at every pixel: of every opacity case and of the lion's two
    scalar mattes, which also equal their plain version."""
    assert FULL == 255
    if name == "lion_mattes":
        cases = lion_mattes()
        assert len(cases) == 2
    else:
        cases = [(*sprite_opacity_case(name), None)]
    for box, scaled, plain in cases:
        lists = kernels.sprite_opacity_lists(box, scaled)
        got = model(lists)
        assert np.array_equal(got, model(lists, shortcut=False))
        if plain is not None:
            assert torch.equal(kernels.sprite_views(lists, torch.from_numpy(got)), plain)


def test_sprite_lists_take_a_box_past_the_first_packing():
    """H61: a matte 131,071 pixels wide and 2 tall with a real shape's 16x
    spans (past the first design's 21-bit columns) builds its lists, and
    the kernel's model over them equals coverage_opacity_torch."""
    box, scaled = sprite_h61_case()
    x0, y0, x1, y1 = box
    assert (x1 - x0 + 1, y1 - y0 + 1) == (131071, 2) and 16 * 131071 + 16 >= 1 << 21
    lists = kernels.sprite_opacity_lists(box, scaled)
    check_lists(lists, opacity_boxes(box), opacity_fams(scaled))
    got = modelled(lists)
    want = TA.coverage_opacity_torch(box, scaled, "cpu")
    assert torch.equal(got, want) and bool((want == 0).any()) and bool((want == 255).any())
    assert bool(((want > 0) & (want < 255)).any())


def test_sprite_lists_refuse_what_the_kernel_cannot_take():
    """An empty box, a box past the packing's 27-bit columns (16 w + 16 >=
    2^27) or its int32 t-rows (16 h + 16 >= 2^31), families of another
    length and a fill past int32 are refused; so is the CPU in the staging
    and the opacity wrapper.  A box 2^17 columns wide, past the first
    design's packing, is taken."""
    boxes, fills, cov, cross, aa = sprite_case("ragged")
    for bad in ([(0, 0, 0, 5)], [(0, 0, (1 << 23) - 1, 1)], [(0, 0, 1, (1 << 27) - 1)]):
        with pytest.raises(ValueError):
            kernels.sprite_raster_lists(bad, fills[:1], cov[:1], cross[:1], aa[:1])
        x0, y0, w, h = bad[0]
        with pytest.raises(ValueError):
            kernels.sprite_opacity_lists((x0, y0, x0 + w - 1, y0 + h - 1), None)
    wide = kernels.sprite_raster_lists([(0, 0, 1 << 17, 1)], fills[:1], cov[:1], cross[:1], aa[:1])
    assert len(wide.units) == (1 << 17) // 128 and wide.members[0, 1] == 1 << 17
    assert len(kernels.sprite_raster_lists([(0, 0, (1 << 23) - 2, 1)], fills[:1], [None], [None], [None]).units)
    with pytest.raises(ValueError):
        kernels.sprite_raster_lists(boxes, fills, cov, cross, aa[:-1])
    with pytest.raises(ValueError):
        kernels.sprite_raster_lists(boxes[:1], [(0, 0, 0, 2**31)], cov[:1], cross[:1], aa[:1])
    lists = kernels.sprite_raster_lists(boxes, fills, cov, cross, aa)
    with pytest.raises(ValueError):
        kernels.stage_sprite_lists(lists, "cpu")
    with pytest.raises(ValueError):
        kernels.sprite_raster_opacity((0, 0, 3, 3), None, "cpu")
    assert kernels.sprite_raster_lists([], [], [], [], []).units.shape == (0, 4)
