"""SR1, the sprite rasterizer kernel (kernels/csrc/sprite_raster.cu), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain versions there).  Here:

  * its host lists (kernels.sprite_raster_lists, sprite_opacity_lists: each
    member's three span families in the sweep's order, 8 bytes a span,
    rows off the plane dropped and columns clipped; the per-member offsets,
    the output layout and the unit table, heaviest members first, every
    band and strip once) against the spans they pack, and their refusals;
  * a numpy model of the kernel read from those lists alone (a unit per
    band of 16 rows and strip of 128 columns of a member; each unit's rows
    from its member's spans moved into the strip and clamped to it, the
    t-rows under its fringe by tests/test_torch_tile_kernel.py's footprint
    count, the dissolve; every pixel written once, into one output buffer
    whose views kernels.sprite_views makes) against the JAX package's
    _build_group_kernel (group mode) and aa.coverage_opacity (opacity
    mode), and against the port's plain versions (_raster_members,
    coverage_opacity_torch): ragged boxes with spans off their planes,
    reversed and overlapping, a member with no AA span and one with an
    empty minshape, fills of alpha 0 and 255, rows past a lane's and a
    bin's capacity, plain-filled and stroked paths, a 1920-wide matte
    taller than a band, and the lion's groups;
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
from test_torch_cuda import lion_objects, sprite_as_members, sprite_case, sprite_of_members, sprite_opacity_case, \
    sprite_paths
from test_torch_tile_kernel import footprint_opacity, row_words

GROUP_CASES = ["ragged", "heavy", "paths"]
OPACITY_CASES = ["wide", "odd", "pixel", "empty", "circle"]


def group_case(name: str):
    return sprite_paths() if name == "paths" else sprite_case(name)


def decoded(lists):
    """Every span of `lists` as int64 (rows, starts, ends + 1)."""
    v = lists.spans.view(np.uint64).reshape(-1)
    return (v >> np.uint64(42)).astype(np.int64), ((v >> np.uint64(21)) & np.uint64(0x1FFFFF)).astype(np.int64), \
        (v & np.uint64(0x1FFFFF)).astype(np.int64)


def strip_rows(spans, lo: int, hi: int, r0: int, nr: int, c0: int, cmax: int, width: int) -> np.ndarray:
    """bool (nr, width): rows r0 .. r0 + nr - 1 of spans [lo, hi), their
    columns moved to c0 and clamped to 0..cmax, as a running count > 0."""
    rows, starts, stops = (a[lo:hi] for a in spans)
    keep = (rows >= r0) & (rows < r0 + nr)
    diff = np.zeros((nr, width + 1), np.int64)
    np.add.at(diff, (rows[keep] - r0, np.clip(starts[keep] - c0, 0, cmax)), 1)
    np.add.at(diff, (rows[keep] - r0, np.clip(stops[keep] - c0, 0, cmax)), -1)
    return np.cumsum(diff, axis=1)[:, :width] > 0


def div255(i):
    return (i + (i >> 8) + 1) >> 8


def dissolve(c, d):
    return np.where(d == 0, 0, np.where(d == 255, c, div255(c * d)))


def model(lists) -> np.ndarray:
    """sprite_raster's output buffer for `lists`, unit by unit as the kernel
    computes it; every pixel of every member written exactly once."""
    buf = np.zeros(lists.out_bytes, np.uint8)
    spans, off = decoded(lists), lists.offsets
    hits = [np.zeros((h, w), np.int64) for h, w in lists.members[:, :2]]
    for m, band, strip, _ in lists.units:
        h, w, mask_at, minmask_at, rgba_at = (int(v) for v in lists.members[m, :5])
        y0, x0 = 16 * band, 128 * strip
        ny, cw = min(16, h - y0), min(128, w - x0)
        hits[m][y0 : y0 + ny, x0 : x0 + cw] += 1
        if lists.opacity:
            fringe = np.ones((ny, cw), bool)
        else:
            cov = strip_rows(spans, off[0, m], off[0, m + 1], y0, ny, x0, cw, 128)[:, :cw]
            cross = strip_rows(spans, off[1, m], off[1, m + 1], y0, ny, x0, cw, 128)[:, :cw]
            fringe = cov
        t0 = 2048 * strip
        t = strip_rows(spans, off[2, m], off[2, m + 1], 16 * y0, 16 * ny + 16, t0, min(2064, 16 * w + 16 - t0), 2080)
        ys, xs = np.nonzero(fringe)
        opac = np.zeros((ny, cw), np.int64)
        opac[ys, xs] = footprint_opacity(row_words(t), ys, xs)
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


def _clipped(sp, r0, h, c0, w):
    """(rows, starts, ends + 1) as the host packs them."""
    rows, s, e = (np.asarray(a, np.int64) for a in sp)
    r = rows - r0
    r = np.where((r >= 0) & (r < h), r, kernels.SPRITE_ROW_DROPPED)
    return r, np.clip(s - c0, 0, w), np.clip(e + 1 - c0, 0, w)


@pytest.mark.parametrize("name", GROUP_CASES)
def test_sprite_lists_pack_every_span(name):
    """Each member's families in their order, moved to its planes, rows off
    them dropped and columns clipped; the offsets, units (every band and
    strip of every member once, the members with the most AA spans first)
    and the output layout (16-byte segments, no overlap)."""
    case = group_case(name)
    boxes, fills, *fams = case
    lists = kernels.sprite_raster_lists(*case)
    spans, off = decoded(lists), lists.offsets
    assert lists.spans.dtype == np.int32 and lists.spans.shape[1] == 2 and off.shape == (3, len(boxes) + 1)
    for m, (x0, y0, w, h) in enumerate(boxes):
        planes = ((y0, h, x0, w), (y0, h, x0, w), (16 * y0 - 32, 16 * h + 16, 16 * x0 - 32, 16 * w + 16))
        for f, (fam, plane) in enumerate(zip(fams, planes)):
            got = tuple(a[off[f, m] : off[f, m + 1]] for a in spans)
            want = _clipped(fam[m], *plane) if fam[m] is not None else (np.zeros(0),) * 3
            assert all(np.array_equal(g, w_) for g, w_ in zip(got, want)), (m, f)
    assert np.array_equal(lists.fills, np.asarray(fills, np.int32))
    units = [tuple(u[:3]) for u in lists.units.tolist()]
    want = {(m, b, s) for m, (_, _, w, h) in enumerate(boxes) for b in range(-(-h // 16)) for s in range(-(-w // 128))}
    assert len(units) == len(want) and set(units) == want
    aa_count = off[2, 1:] - off[2, :-1]
    order = [m for m, _, _ in units]
    assert all(aa_count[a] >= aa_count[b] for a, b in zip(order, order[1:]))
    segments = sorted((16 * int(at), size) for (h, w), ats in zip(lists.members[:, :2], lists.members[:, 2:5])
                      for at, size in zip(ats, (h * w, h * w, 16 * h * w)))
    assert all(a + size <= b for (a, size), (b, _) in zip(segments, segments[1:]))
    assert segments[-1][0] + segments[-1][1] <= lists.out_bytes


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
    assert (decoded(lists)[0] == kernels.SPRITE_ROW_DROPPED).any()
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


def test_sprite_lists_refuse_what_the_kernel_cannot_take():
    """An empty box, a box past the packing's 21-bit columns, families of
    another length and a fill past int32 are refused; so is the CPU in the
    staging and the opacity wrapper."""
    boxes, fills, cov, cross, aa = sprite_case("ragged")
    for bad in ([(0, 0, 0, 5)], [(0, 0, 1 << 17, 1)]):
        with pytest.raises(ValueError):
            kernels.sprite_raster_lists(bad, fills[:1], cov[:1], cross[:1], aa[:1])
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
