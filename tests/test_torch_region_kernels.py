"""The host side of the region kernels, on the CPU: CF1 ``caf``, TB1
``tight_bounds``, MR1 ``box_morph`` (kernels/csrc/region_ops.cu) and CV1
``convolve_canvas`` (kernels/csrc/convolve.cu).

The kernels run only on a card (tests/test_torch_cuda.py holds each to its
plain version there).  Here each wrapper's host side is held to the plain
versions through a model of its kernel, written from the kernel's source:
CF1 reading its operand planes at their offsets in the union box, with the
operator code or the composed plane the card route picks; MR1's walk of a
block over its tile, chunk by chunk, as box_morph_kernel does it; TB1's
rows, lanes and loads and each route's fold as tight_bounds_kernel walks
them; CV1's staged tile, halo rows and edge zeros as convolve_staged_kernel
stages them, and its passes from convolve_route, divided by blur_divider's
multiply and shift on sums that wrap.  Then the refusals, and that on the CPU no launch counter
moves.  Tolerance 0: the colour math is integer.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from coherence_tpu_torch import colour as C
from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import convolve as V
from coherence_tpu_torch.raster import region

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import (BOUNDS_ROUTES, CAF_BUILTIN, CAF_LAYOUTS, CAF_PLACES, MORPH_RADII,
                             MORPH_SECOND_ROUTE_CASES, assert_same_caf, bounds_masks, caf_registered, caf_sprite,
                             convolve_canvas_case, convolve_kernels, convolve_masks, forced_bounds_route, morph_masks,
                             WORDS_LAYOUTS, words_case)

# CF1's built-in operators by code, as caf_kernel's `compose` computes them.
CF1_OPS = {0: C.over_rgba, 1: C.alpha_over_rgba, 2: C.pd_plus_rgba, 3: lambda a, b: b}


def storage_bytes(t: torch.Tensor):
    """(t's whole storage as flat uint8, the address of its first byte)."""
    st = t.untyped_storage()
    return torch.empty(0, dtype=torch.uint8).set_(st, 0, (st.nbytes(),), (1,)), st.data_ptr()


def wide_reads(t: torch.Tensor, addr: np.ndarray, size: int) -> torch.Tensor:
    """`size` bytes at each address of `addr` (within t's storage, each on
    `size` bytes, as the kernel's wide loads require), as (..., size)
    uint8."""
    assert (addr % size == 0).all(), "a wide load off its alignment"
    flat, base = storage_bytes(t)
    return flat[torch.from_numpy(addr - base)[..., None] + torch.arange(size)]


def cf1_plane(h, w, plane, geom, what, read=None):
    """What CF1 reads of `plane`'s mask or RGBA over the h x w union box
    (False and 0 outside its box; for RGBA also outside `read`, the pixels
    whose colour the kernel loads): where `vec` holds, a pixel's RGBA as 16
    bytes read from the plane's storage at the address the kernel computes,
    the rest element by element."""
    out = torch.zeros((h, w), dtype=torch.bool) if what == "mask" else torch.zeros((h, w, 4), dtype=torch.int32)
    if plane is None:
        return out
    y0, x0, ph, pw, msy, msx, rsy, rsx, rsc, vec = geom
    t = getattr(plane, what)
    out[y0 : y0 + ph, x0 : x0 + pw] = t
    if what == "rgba" and vec:
        yo, xo = np.arange(ph)[:, None], np.arange(pw)[None, :]
        out[y0 : y0 + ph, x0 : x0 + pw] = wide_reads(t, t.data_ptr() + 4 * (yo * rsy + xo * rsx), 16).view(torch.int32)
    return out if read is None else torch.where(read[..., None], out, 0)


def cf1_model(h, w, op, a, b=None, composed=None, f_only=False, calls=None):
    """CF1 on the CPU from kernels.caf's arguments: each plane's geometry as
    the wrapper sends it (kernels._caf_geometry), its mask and RGBA read
    over its box at its offset as the kernel reads them (cf1_plane: 16-byte
    loads at their addresses), False and 0 outside; with caf_one_trip every
    colour over its box, else only the colours the result takes; the
    built-in operator of `op`, or the composed plane where both masks are
    set."""
    geoms = [kernels._caf_geometry(h, w, p, torch.device("cpu")) for p in (a, b, composed)]
    one_trip = kernels.caf_one_trip(h, w)
    if calls is not None:
        calls.append((op, geoms, one_trip))
    ma, mb = cf1_plane(h, w, a, geoms[0], "mask"), cf1_plane(h, w, b, geoms[1], "mask")
    given = op == kernels.CAF_GIVEN
    reads = [None] * 3 if one_trip else [ma & ~mb if given else ma, mb & ~ma if given else mb, ma & mb]
    ra, rb = cf1_plane(h, w, a, geoms[0], "rgba", reads[0]), cf1_plane(h, w, b, geoms[1], "rgba", reads[1])
    comp = cf1_plane(h, w, composed, geoms[2], "rgba", reads[2]) if given else CF1_OPS[op](ra, rb)
    rgba = torch.where((ma & mb)[..., None], comp, torch.where(ma[..., None], ra, torch.where(mb[..., None], rb, 0)))
    f = (ma | mb) & (rgba[..., 3] == 255)
    return f if f_only else (rgba, ma | mb, f)


@pytest.fixture
def cf1_on_the_cpu(monkeypatch):
    """kernels.caf replaced by cf1_model, recording (op, geometries,
    one_trip) per call; yields the record."""
    calls = []
    monkeypatch.setattr(kernels, "caf", lambda *args, **kw: cf1_model(*args, **kw, calls=calls))
    yield calls


@pytest.mark.parametrize("place", list(CAF_PLACES))
@pytest.mark.parametrize("op", [*CAF_BUILTIN, "registered"])
def test_caf_card_route_matches_plain(cf1_on_the_cpu, op, place):
    """The card route's host side (_caf_card: the operands at their offsets
    in the union box, the op code or the composed plane over the
    intersection) through the model of CF1, against caf_torch: every
    operator, place and layout of the card test, and one operand."""
    ops = caf_registered() if op == "registered" else [op]
    for name in ops:
        for la in CAF_LAYOUTS:
            for lb in CAF_LAYOUTS:
                a = caf_sprite("cpu", 1, (5, 7, 40, 23), la)
                b = caf_sprite("cpu", 2, CAF_PLACES[place], lb)
                for x, y in ((a, b), (b, a), (a, None), (None, b)):
                    got = region._caf_card(name, "opaque", x, y)
                    assert_same_caf(got, region.caf_torch(name, "opaque", x, y), f"{name} {place} {la} {lb}")
                    code, geoms, _ = cf1_on_the_cpu[-1]
                    if x is not None and y is not None:
                        assert code == kernels.CAF_OPS.get(name, kernels.CAF_GIVEN)
                        assert (geoms[2][2] > 0) == (code == kernels.CAF_GIVEN and region.box_overlap(x.box, y.box))


def test_caf_operand_offsets_in_the_union_box(cf1_on_the_cpu):
    """Each operand's offset is its box's corner less the union box's, its
    strides its tensors' own: a view keeps its canvas's row stride, an
    expanded plane strides 0; a dense contiguous plane on 16 bytes takes
    one 16-byte load a pixel."""
    a = caf_sprite("cpu", 1, (5, 7, 40, 23), "view")
    b = caf_sprite("cpu", 2, (1, 2, 70, 50), "expanded")
    region._caf_card("over", "opaque", a, b)
    _, (ga, gb, gc), _ = cf1_on_the_cpu[-1]
    assert ga[:4] == [5, 4, 23, 40] and gb[:4] == [0, 0, 50, 70] and gc == [0] * 10
    assert ga[4:9] == [a.mask.stride(0), 1, a.rgba.stride(0), 4, 1] and a.rgba.stride(0) == 4 * (40 + 9)
    assert gb[4:9] == [0, 1, 0, 0, 1] and gb[9] == 0
    d = caf_sprite("cpu", 3, (20, 12, 40, 30), "dense")
    region._caf_card("plus", "opaque", d, None)
    code, (gd, gn, _), _ = cf1_on_the_cpu[-1]
    assert gd[:4] == [0, 0, 30, 40] and gn == [0] * 10 and gd[9] == int(d.rgba.data_ptr() % 16 == 0)


def test_caf_one_trip_by_area(cf1_on_the_cpu, monkeypatch):
    """caf_one_trip: a union box of at most CAF_ONE_TRIP_PIXELS pixels reads
    its colours in one round trip with the masks, a larger one after them;
    the model of each way gives the plain version's result, the built-ins
    and a registered operator alike."""
    n = kernels.CAF_ONE_TRIP_PIXELS
    assert kernels.caf_one_trip(1, n) and kernels.caf_one_trip(256, 256) and not kernels.caf_one_trip(1, n + 1)
    assert kernels.caf_one_trip(133, 151) and not kernels.caf_one_trip(1080, 689)
    a, b = caf_sprite("cpu", 6, (5, 7, 40, 23), "view"), caf_sprite("cpu", 7, (20, 12, 40, 30), "wide_sums")
    for limit in (n, 0):
        monkeypatch.setattr(kernels, "CAF_ONE_TRIP_PIXELS", limit)
        for op in ("over", "plus", "cpg_eor"):
            caf_registered()
            for x, y in ((a, b), (b, a), (a, None)):
                assert_same_caf(region._caf_card(op, "opaque", x, y), region.caf_torch(op, "opaque", x, y), f"{op} {limit}")
                assert cf1_on_the_cpu[-1][2] == (limit > 0)


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("layout", WORDS_LAYOUTS)
def test_caf_tails_and_alignments_through_the_model(cf1_on_the_cpu, monkeypatch, layout, offset):
    """The card route through the model of CF1 against caf_torch at union
    widths 1-9 (a block's last columns), at each operand offset mod 4 in
    the union box, masks from 0 to 3 bytes into their rows, as views,
    strided and expanded (words_case); both operand orders, both ways of
    reading the colours."""
    b = caf_sprite("cpu", 4, (100, 7, 12, 5), "dense")
    for limit in (kernels.CAF_ONE_TRIP_PIXELS, 0):
        monkeypatch.setattr(kernels, "CAF_ONE_TRIP_PIXELS", limit)
        for width in range(1, 10):
            for column in range(4):
                a = words_case("cpu", layout, width, column, offset)
                for x, y in ((a, b), (b, a)):
                    got = region._caf_card("over", "opaque", x, y)
                    want = region.caf_torch("over", "opaque", x, y)
                    assert_same_caf(got, want, f"{layout} {width} {column} {offset} {limit}")
                    assert cf1_on_the_cpu[-1][1][0 if x is a else 1][1] == offset


def test_caf_op_code_is_the_builtin_only_while_registered(monkeypatch):
    """The four built-in names take their codes while the table holds the
    functions registered at import; a re-registered `over` takes the
    given-plane route, and so does every other operator; an unknown name
    raises KeyError as the plain version does."""
    for name, code in kernels.CAF_OPS.items():
        assert region._caf_op_code(name) == code
    for name in caf_registered():
        assert region._caf_op_code(name) is None
    monkeypatch.setitem(region._CAF_OPS, "over", lambda a, b: C.over_rgba(a, b))
    assert region._caf_op_code("over") is None and region._caf_op_code("plus") == kernels.CAF_OPS["plus"]
    with pytest.raises(KeyError):
        region._caf_op_code("no such operator")


def test_caf_reregistered_over_through_the_model(cf1_on_the_cpu, monkeypatch):
    """A re-registered `over`'s composed plane is its own colours: the card
    route gives the plain version's result with it, and the old code's
    colours where they differ."""
    monkeypatch.setitem(region._CAF_OPS, "over", lambda a, b: C.alpha_over_rgba(a, b))
    a, b = caf_sprite("cpu", 6, (5, 7, 40, 23), "view"), caf_sprite("cpu", 7, (20, 12, 40, 30), "dense")
    assert_same_caf(region._caf_card("over", "opaque", a, b), region.caf_torch("over", "opaque", a, b), "re-registered")
    assert cf1_on_the_cpu[-1][0] == kernels.CAF_GIVEN


def test_caf_composed_plane_is_the_operator_over_the_intersection():
    """_caf_composed: the registered function's colours on views of both
    operands over the intersection, at its offset in the union box; None
    for disjoint boxes."""
    a = caf_sprite("cpu", 1, (5, 7, 40, 23), "dense")
    b = caf_sprite("cpu", 2, (20, 12, 40, 30), "view")
    y0, x0, mask, plane = region._caf_composed("over", a, b)
    assert (y0, x0, mask) == (5, 15, None) and tuple(plane.shape) == (18, 25, 4)
    assert torch.equal(plane, C.over_rgba(a.rgba[5:, 15:], b.rgba[:18, :25]))
    assert region._caf_composed("over", a, caf_sprite("cpu", 2, CAF_PLACES["disjoint"], "dense")) is None


def tb1_model(mask: torch.Tensor, route=None) -> tuple:
    """TB1 on the CPU from kernels.tight_bounds' arguments, as region_ops.cu's
    tight_bounds_kernel walks, on tight_bounds_route's route (or `route`):
    block b walks rows [b rows, (b + 1) rows), its warp wp the rows b rows +
    wp, + TIGHT_BOUNDS_WARPS, ..., each row's segs segments in turn, in
    rounds of TIGHT_BOUNDS_LOADS items a lane (a round runs while the
    warp's next item is in the block's rows).  In the granule layout lane
    l's unit of item (y, s) is the 16-byte granule 32 s + l of row y's,
    read from the mask's storage at the kernel's address (wide_reads: on 16
    bytes, inside the storage), skipped past the row and where it holds a
    byte outside the mask's span [lo, hi); those edge granules block 0's
    thread 0 reads byte by byte, each set byte's (y, x) from its offset.
    Its set columns are the granule's nonzero bytes within the row.  In the
    byte layout a unit is the cell at column 32 s + l.  Each block folds
    its threads' bounds and the route folds every block's."""
    h, w = mask.shape
    sy, sx = mask.stride()
    r = route or kernels.tight_bounds_route(h, w, sy, sx)
    granules = r.layout == kernels.BOUNDS_GRANULES
    if granules and h == 1:
        sy = w
    assert r.blocks * r.rows >= h and (r.route != kernels.BOUNDS_ONE or r.blocks == 1)
    flat, base = storage_bytes(mask)
    lo = mask.data_ptr()
    hi = lo + (h - 1) * sy + w
    lanes = np.arange(32)
    out = [w, h, -1, -1]

    def take(ys, xs):
        if len(xs):
            out[:] = [min(out[0], int(xs.min())), min(out[1], int(ys.min())), max(out[2], int(xs.max())),
                      max(out[3], int(ys.max()))]

    for b in range(r.blocks):
        y_end = min(h, (b + 1) * r.rows)
        for warp in range(kernels.TIGHT_BOUNDS_WARPS):
            y, seg = b * r.rows + warp, 0
            while True:
                items = []
                for _ in range(kernels.TIGHT_BOUNDS_LOADS):
                    items.append((y, seg))
                    seg += 1
                    if seg == r.segs:
                        seg, y = 0, y + kernels.TIGHT_BOUNDS_WARPS
                for yy, ss in items:
                    if yy >= y_end:
                        continue
                    if granules:
                        row = lo + yy * sy
                        a = (row & ~15) + 16 * (32 * ss + lanes)
                        ok = (a >= lo) & (a + 16 <= hi) & (a < row + w)
                        v = np.zeros((32, 16), np.uint8)
                        if ok.any():
                            v[ok] = wide_reads(mask, a[ok], 16).numpy()
                        byte = np.arange(16)
                        inside = (a[:, None] + byte >= row) & (a[:, None] + byte < row + w)
                        li, bi = np.nonzero((v != 0) & inside)
                        take(np.full(len(li), yy), a[li] + bi - row)
                    else:
                        x = 32 * ss + lanes
                        x = x[x < w]
                        v = flat[torch.from_numpy(lo - base + yy * sy + x * sx)].numpy()
                        take(np.full(int((v != 0).sum()), yy), x[v != 0])
                if y >= y_end:
                    break
    if granules:
        first, last = lo & ~15, (hi - 1) & ~15
        edges = [g for g, edge in ((first, first != lo or first + 16 > hi), (last, last != first and last + 16 > hi))
                 if edge]
        for g in edges:
            addr = np.arange(max(g, lo), min(g + 16, hi))
            v = flat[torch.from_numpy(addr - base)].numpy()
            off = addr[v != 0] - lo
            ys, xs = off // sy, off % sy
            take(ys[xs < w], xs[xs < w])
    return tuple(out)


def test_tight_bounds_blocks():
    """TB1's grid (tight_bounds_route): its blocks' rows cover the mask,
    one block where one round of one block's items covers it, else the
    ticket route within TIGHT_BOUNDS_MAX_BLOCKS blocks, each a multiple of
    the warps' rows, one round a block where the cap allows."""
    warps, loads = kernels.TIGHT_BOUNDS_WARPS, kernels.TIGHT_BOUNDS_LOADS
    for h, w in [(1, 1), (37, 53), (53, 68), (1073, 522), (1, 8000), (1080, 1920), (10**5, 10**4), (4096, 3)]:
        for sy, sx in [(w, 1), (1, h), (w + 5, 2)]:
            r = kernels.tight_bounds_route(h, w, sy, sx)
            units = (w + 30) // 16 if r.layout == kernels.BOUNDS_GRANULES else w
            assert r.segs == -(-units // 32)
            per_round = warps * max(1, loads // r.segs)
            assert r.blocks * r.rows >= h > (r.blocks - 1) * r.rows
            if h <= per_round:
                assert (r.route, r.blocks, r.rows) == (kernels.BOUNDS_ONE, 1, h)
            else:
                assert r.route == kernels.BOUNDS_TICKET and r.blocks <= kernels.TIGHT_BOUNDS_MAX_BLOCKS
                assert r.rows % warps == 0
                # a round a block, or the fewest rows a block within the cap
                assert r.rows <= per_round or -(-h // (r.rows - warps)) > kernels.TIGHT_BOUNDS_MAX_BLOCKS


def test_tight_bounds_route_at_its_limits():
    """The layout: granules where a row's cells are adjacent and rows do
    not overlap (sx 1, sy >= w, or one row), else bytes; the routes at
    their edges: one round of one block, past it the ticket over blocks of
    one round, past TIGHT_BOUNDS_MAX_BLOCKS of them more rows a block."""
    route = kernels.tight_bounds_route
    assert route(37, 53, 53, 1).layout == kernels.BOUNDS_GRANULES
    assert route(1, 53, 0, 1).layout == kernels.BOUNDS_GRANULES
    for sy, sx in [(1, 37), (53, 2), (40, 1), (0, 1)]:
        assert route(37, 53, sy, sx).layout == kernels.BOUNDS_BYTES
    # 68 columns: 6 granules a row at most, one segment, 64 rows a round.
    assert route(64, 68, 68, 1)[:2] == (kernels.BOUNDS_ONE, kernels.BOUNDS_GRANULES)
    assert route(65, 68, 68, 1) == kernels.BoundsRoute(kernels.BOUNDS_TICKET, kernels.BOUNDS_GRANULES, 1, 40, 2)
    assert route(64 * 528, 68, 68, 1)[3:] == (64, 528)
    assert route(64 * 528 + 1, 68, 68, 1)[3:] == (72, 470)
    # 522 columns: 34 granules, two segments, 32 rows a round: the largest mask of
    # general_filters in 34 blocks.
    assert route(1073, 522, 522, 1) == kernels.BoundsRoute(kernels.BOUNDS_TICKET, kernels.BOUNDS_GRANULES, 2, 32, 34)
    assert route(53, 68, 68, 1) == kernels.BoundsRoute(kernels.BOUNDS_ONE, kernels.BOUNDS_GRANULES, 1, 53, 1)


def test_tight_bounds_constants_match_the_source():
    """kernels' TB1 constants are region_ops.cu's: a thread's loads a
    round, the ticket route's blocks at most (the scratch the wrapper
    makes holds that many partials), a block's warps, and the numbers of
    the routes and layouts."""
    import os
    import re

    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc", "region_ops.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))

    assert const("kTbLoads") == kernels.TIGHT_BOUNDS_LOADS
    assert const("kTbMaxBlocks") == kernels.TIGHT_BOUNDS_MAX_BLOCKS
    assert const("kTbThreads") == 32 * kernels.TIGHT_BOUNDS_WARPS
    assert "enum TbRoute { kTbOne = %d, kTbTicket = %d };" % (kernels.BOUNDS_ONE, kernels.BOUNDS_TICKET) in src
    assert "enum TbLayout { kTbGranules = %d, kTbBytes = %d };" % (kernels.BOUNDS_GRANULES, kernels.BOUNDS_BYTES) in src


@pytest.mark.parametrize("route", ["picked", *BOUNDS_ROUTES])
def test_tight_bounds_model_at_the_card_test_masks(route):
    """The model of TB1 against _tight_bounds_torch at every mask of the
    card test (empty, single pixels, full, random, sparse and random
    1080p, views, strided, transposed), on the route tight_bounds_route
    picks and on each route forced."""
    for name, m in bounds_masks("cpu").items():
        forced = None if route == "picked" else forced_bounds_route(*m.shape, *m.stride(), BOUNDS_ROUTES[route])
        assert tb1_model(m, forced) == region._tight_bounds_torch(m), name


@st.composite
def bounds_cases(draw):
    """A bool mask as a view of a larger plane: odd strides, rows starting
    off their 16 bytes, transposed, wider than a segment, set cells only
    at the edges or none; and a route to force, or None."""
    h, w = draw(st.integers(1, 70)), draw(st.integers(1, 600))
    sy, sx = draw(st.sampled_from([1, 1, 1, 2, 3])), draw(st.sampled_from([1, 1, 2, 5]))
    oy, ox = draw(st.integers(0, 3)), draw(st.integers(0, 17))
    transposed = draw(st.booleans())
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    row = ox + sx * w + draw(st.integers(0, 20))  # a row's elements of the plane, past the view's
    shape = (row, oy + sy * h) if transposed else (oy + sy * h, row)
    base = np.zeros(shape, bool)
    kind = draw(st.sampled_from(["random", "sparse", "empty", "corners", "outside_only"]))
    if kind == "random":
        base = rng.random(shape) < 0.3
    elif kind == "sparse":
        base[tuple(rng.integers(0, n, 3) for n in shape)] = True
    elif kind == "outside_only":  # set cells of the plane around the view only
        base = rng.random(shape) < 0.5
    t = torch.from_numpy(base)
    view = t.t()[oy :: sy, ox :: sx][:h, :w] if transposed else t[oy :: sy, ox :: sx][:h, :w]
    if kind == "outside_only":
        view[...] = False
    elif kind == "corners":
        view[0, 0] = view[-1, -1] = True
    return view, draw(st.sampled_from([None, *BOUNDS_ROUTES.values()]))


@settings(max_examples=150, deadline=None, derandomize=True)
@given(bounds_cases())
def test_tight_bounds_model_on_random_views(case):
    """The model of TB1 on random views (offsets, strides, transposed,
    unaligned rows, cells set only outside the view) on the picked route
    and each route forced, against _tight_bounds_torch."""
    mask, route = case
    forced = None if route is None else forced_bounds_route(*mask.shape, *mask.stride(), route)
    assert tb1_model(mask, forced) == region._tight_bounds_torch(mask)


def test_tight_bounds_plain_at_the_card_test_masks():
    """The card test's masks through the plain version: the empty mask's
    (w, h, -1, -1), one pixel's own cell, a view's bounds in its own
    coordinates."""
    masks = bounds_masks("cpu")
    assert region._tight_bounds(masks["empty"]) == (53, 37, -1, -1)
    assert region._tight_bounds(masks["pixel_in"]) == (3, 17, 3, 17)
    for name, m in masks.items():
        ys, xs = np.nonzero(m.numpy())
        want = (53, 37, -1, -1) if name == "empty" else (
            (m.shape[1], m.shape[0], -1, -1) if len(ys) == 0 else (xs.min(), ys.min(), xs.max(), ys.max()))
        assert region._tight_bounds(m) == tuple(int(v) for v in want), name


U32 = np.uint32


def popc(words: np.ndarray) -> np.ndarray:
    """__popc of each uint32."""
    words = np.ascontiguousarray(words, dtype="<u4")
    return np.unpackbits(words.view(np.uint8).reshape(*words.shape, 4), axis=-1).sum(-1).astype(np.int64)


def ballot(bits: np.ndarray) -> np.ndarray:
    """__ballot_sync over the last axis, 32 lanes: bit t from lane t."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(U32)


def mr1_stage(mask: np.ndarray, want: bool, rows: np.ndarray, sb: int, sw: int) -> np.ndarray:
    """region_ops.cu stage(): the source rows `rows`, columns sb .. sb + 32
    sw - 1, as (len(rows), sw) words of "cell == want", 0 outside the
    source: lane l of item g (4 words of a row) reads the 4 cells from
    column sb + 128 g + 4 l (one 4-byte load or 4 byte loads: the same
    cells), makes their nibble, shifts it by 4 (l % 8) and ORs it across
    its 8 lanes (three xor shuffles)."""
    w = mask.shape[1]
    groups = -(-sw // 4)
    cols = sb + np.arange(128 * groups)
    inside = cols < w
    cells = np.zeros((len(rows), 128 * groups), bool)
    cells[:, inside] = mask[rows][:, cols[inside]] == want
    lane = np.arange(32)
    nib = (cells.reshape(len(rows), groups, 32, 4) << np.arange(4)).sum(-1).astype(U32)
    v = nib << (4 * (lane % 8)).astype(U32)
    words = np.bitwise_or.reduce(v.reshape(len(rows), groups, 4, 8), axis=-1)
    return words.reshape(len(rows), 4 * groups)[:, :sw]


def mr1_row_pass(staged: np.ndarray, X0: int, dx0: int, dx1: int, sb: int) -> np.ndarray:
    """The row pass over staged words (rows, sw): word j of a row holds, at
    bit t, whether the count of set bits before column X + dx1 + 1 exceeds
    that before X + dx0 (X = X0 + 32 j + t), both clamped to the staged
    words; the counts are each row's exclusive prefix of its words'
    popcounts and __popc of the masked word."""
    sw = staged.shape[1]
    pre = np.concatenate([np.zeros((len(staged), 1), np.int64), np.cumsum(popc(staged), 1)[:, :-1]], 1)
    X = X0 + np.arange(kernels.MORPH_TILE[1])
    a = np.clip(X + dx0 - sb, 0, 32 * (sw - 1))
    b = np.clip(X + dx1 + 1 - sb, 0, 32 * (sw - 1))

    def before(q):
        low = ((U32(1) << (q & 31).astype(U32)) - U32(1)).astype(U32)
        return pre[:, q >> 5] + popc(staged[:, q >> 5] & low)

    return ballot((before(b) > before(a)).reshape(len(staged), -1, 32))


def shfl(v: np.ndarray, d: int, down: bool) -> np.ndarray:
    """__shfl_down_sync / __shfl_up_sync over 32 lanes: a lane whose source
    lane is out of range gets its own value."""
    src = np.arange(32) + (d if down else -d)
    ok = (src >= 0) & (src < 32)
    return np.where(ok, v[np.clip(src, 0, 31)], v)


def mr1_columns(rowp: np.ndarray, lo: int, hi: int, Ly: int) -> np.ndarray:
    """The column pass of a staged tile for one column word: rowp (hi - lo
    + 1,) words of staged rows lo .. hi (others 0); lane i's word is the OR
    of rows [i, i + Ly], van Herk's suffix of i's block of n = Ly + 1 rows
    and prefix of the next, by segmented shuffle scans, the rows of lane
    31's block past row 31 ORed in by the warp."""
    n, i = Ly + 1, np.arange(32)

    def row(s):
        s = np.asarray(s)
        ok = (s >= lo) & (s <= hi)
        return np.where(ok, rowp[np.clip(s - lo, 0, max(len(rowp) - 1, 0))] if len(rowp) else 0, 0).astype(U32)

    end_i, end_31 = i - i % n + n - 1, 31 - 31 % n + n - 1
    suffix = row(i)
    for d in (1, 2, 4, 8, 16):
        suffix = np.where((i + d < 32) & (i + d <= end_i), suffix | shfl(suffix, d, True), suffix)
    rest = np.bitwise_or.reduce(row(np.arange(max(32, lo), min(end_31, hi) + 1)), initial=U32(0))
    suffix = np.where(end_i == end_31, suffix | rest, suffix)
    before = (Ly + i) % n
    prefix = row(Ly + i)
    for d in (1, 2, 4, 8, 16):
        prefix = np.where((i >= d) & (d <= before), prefix | shfl(prefix, d, False), prefix)
    return np.where(i % n == 0, suffix, suffix | prefix).astype(U32)


def mr1_staged(mask, H, W, dx0, dx1, dy0, dy1, want, route) -> np.ndarray:
    """box_morph_kernel on the CPU, tile by tile: (H, ww) words, bit X % 32
    of word X // 32 for output (Y, X) (for the row pass, H = h and dy0 =
    dy1 = 0).  Each tile's staged rows must fit the route's `rows`."""
    h, w = mask.shape
    TR, TW = route.tile_rows, kernels.MORPH_TILE[1]
    Ly = dy1 - dy0
    out = np.zeros((-(-H // TR) * TR + 32, -(-W // TW) * TW // 32), U32)
    for X0 in range(0, W, TW):
        sb = max(X0 + dx0, 0) & ~31
        for Y0 in range(0, H, TR):
            r0 = Y0 + dy0
            lo, hi = max(0, -r0), min(TR + Ly - 1, h - 1 - r0)
            held = max(hi - lo + 1, 0)
            assert held <= route.rows
            staged = mr1_stage(mask, want, np.arange(r0 + lo, r0 + lo + held), sb, route.words)
            rowp = mr1_row_pass(staged, X0, dx0, dx1, sb) if held else np.zeros((0, TW // 32), U32)
            for j in range(TW // 32):
                out[Y0 : Y0 + TR, X0 // 32 + j] = mr1_columns(rowp[:, j], lo, hi, Ly)[:TR]
    return out[:H]


def mr1_cols(words: np.ndarray, h: int, H: int, dy0: int, dy1: int) -> np.ndarray:
    """box_morph_cols_kernel on the CPU: output row Y = b n + t's word is
    block b's suffix from window row Y + dy0 to the block's end, ORed (t >
    0) with block b + 1's prefix up to row Y + dy1 (n = dy1 - dy0 + 1)."""
    n = dy1 - dy0 + 1
    nb = -(-H // n)
    s = np.arange(dy0, dy0 + (nb + 1) * n)
    rows = np.zeros((len(s), words.shape[1]), U32)
    inside = (s >= 0) & (s < h)
    rows[inside] = words[s[inside]]
    blocks = rows.reshape(nb + 1, n, -1)
    prefix = np.bitwise_or.accumulate(blocks, axis=1)
    suffix = np.bitwise_or.accumulate(blocks[:, ::-1], axis=1)[:, ::-1]
    out = suffix[:nb].copy()
    out[:, 1:] |= prefix[1:, :-1]
    return out.reshape(nb * n, -1)[:H]


def mr1_model(mask: np.ndarray, rx: int, ry: int, erode: bool, route=None) -> np.ndarray:
    """MR1 on the CPU at kernels.box_morph_route's route (or `route`): the
    staged route's tiles, or the second route's row pass into a bit plane
    and its column pass; then the bits as bools, erode's interior and
    complement."""
    h, w = mask.shape
    (H, W), (dx0, dx1, dy0, dy1) = kernels.box_morph_geometry(h, w, rx, ry, erode)
    route = route or kernels.box_morph_route(h, w, rx, ry, erode)
    if route.launches == 1:
        words = mr1_staged(mask, H, W, dx0, dx1, dy0, dy1, not erode, route)
    else:
        plane = mr1_staged(mask, h, W, dx0, dx1, 0, 0, not erode, route)
        words = mr1_cols(plane, h, H, dy0, dy1)
    bits = np.unpackbits(np.ascontiguousarray(words, dtype="<u4").view(np.uint8), axis=1, bitorder="little")
    bits = bits[:, :W].astype(bool)
    if erode:
        yy, xx = np.mgrid[:H, :W]
        bits = ~bits & (yy >= ry) & (yy < h - ry) & (xx >= rx) & (xx < w - rx)
    return bits


def second_route(h: int, w: int, rx: int, ry: int, erode: bool, tile_rows: int = 32):
    """The second route at this shape, whatever box_morph_route picks."""
    (_, _), (dx0, dx1, _, _) = kernels.box_morph_geometry(h, w, rx, ry, erode)
    words = -(-(min(kernels.MORPH_TILE[1] + dx1 - dx0, w) + 31) // 32) + 1
    rows = min(tile_rows, h)
    return kernels.MorphRoute(2, tile_rows, rows, words, kernels._morph_smem(rows, words))


@pytest.mark.parametrize("radii", MORPH_RADII, ids=[f"rx{a}ry{b}" for a, b in MORPH_RADII])
def test_box_morph_walk_matches_plain(radii):
    """The model of MR1's passes (bit packing, 4 cells a lane; the
    prefix-popcount row pass, one ballot a word; the van Herk column pass)
    against
    dilate_torch and erode_torch at every mask of the card test, radius 0
    on one axis and past the box: on the route box_morph_route picks and on
    the second route with 32 and with 1 row a block."""
    rx, ry = radii
    for name, m in morph_masks("cpu").items():
        mask = m.numpy()
        want = {False: region.dilate_torch(m, rx, ry).numpy(), True: region.erode_torch(m, rx, ry).numpy()}
        for erode in (False, True):
            h, w = mask.shape
            for route in (None, second_route(h, w, rx, ry, erode), second_route(h, w, rx, ry, erode, 1)):
                got = mr1_model(mask, rx, ry, erode, route)
                assert np.array_equal(got, want[erode]), f"{'erode' if erode else 'bloat'} {name} {route}"


def test_box_morph_geometry():
    """Bloat's output is nbox's and its window ends at the cell; erode's is
    the mask's, its window centred; radii under 0 and outputs past 2^31 - 1
    rows or columns refused.  The kernel's tiles take rows in a grid-stride
    loop, so a 2^20-row mask is no longer past its grid."""
    assert kernels.box_morph_geometry(17, 29, 2, 5, False) == ((27, 33), (-4, 0, -10, 0))
    assert kernels.box_morph_geometry(17, 29, 2, 5, True) == ((17, 29), (-2, 2, -5, 5))
    assert kernels.box_morph_geometry(17, 29, 0, 0, True) == ((17, 29), (0, 0, 0, 0))
    assert kernels.box_morph_geometry(2**20, 1, 0, 0, True) == ((2**20, 1), (0, 0, 0, 0))
    for args in [(17, 29, -1, 0, False), (17, 29, 0, -1, True), (2**31, 1, 0, 0, True), (1, 2**31, 0, 0, True),
                 (1, 1, 2**30, 0, False), (1, 1, 0, 2**30, False)]:
        with pytest.raises(ValueError):
            kernels.box_morph_geometry(*args)


def test_box_morph_route():
    """box_morph_route from the shape alone: general_filters' bloats and
    erosions on the staged route, their staged rows and words the tile's
    reach clipped to the mask; past MORPH_SMEM bytes the second route, 32
    rows a row-pass block (a tall mask at ry in the tens of thousands, a
    wide one at rx in the thousands, chip_smoke's synthetic call), or 1
    where 32 rows' reach is past MORPH_SMEM_MAX; past that too ValueError.
    A radius past the box costs no more than the box."""
    R = kernels.box_morph_route
    assert R(129, 125, 5, 5, False) == (1, 32, 42, 6, kernels._morph_smem(42, 6))
    assert R(161, 157, 5, 5, False) == (1, 32, 42, 7, kernels._morph_smem(42, 7))
    assert R(139, 135, 11, 11, False) == (1, 32, 54, 7, kernels._morph_smem(54, 7))
    assert R(657, 765, 5, 5, True) == (1, 32, 42, 7, kernels._morph_smem(42, 7))
    assert R(17, 29, 10**6, 10**6, False) == R(17, 29, 10**3, 10**3, False) == (1, 32, 17, 3, kernels._morph_smem(17, 3))
    for h, w, rx, ry in [(30000, 3, 0, 20000), (40, 7000, 3000, 1), (2400, 96, 3, 900)]:
        route = R(h, w, rx, ry, False)
        assert route.launches == 2 and route.tile_rows == 32 and route.rows == 32, (h, w, route)
        assert kernels._morph_smem(min(32 + 2 * ry, h), route.words) > kernels.MORPH_SMEM >= 0
    assert R(40, 40000, 20000, 0, False) == (2, 1, 1, 1252, kernels._morph_smem(1, 1252))
    assert kernels._morph_smem(32, 1252) > kernels.MORPH_SMEM_MAX
    with pytest.raises(ValueError):
        R(1, 10**6, 5 * 10**5, 0, False)
    # The limit of the staged route, row by row: one more staged row takes the second route.
    rows = max(r for r in range(1, 2000) if kernels._morph_smem(r, 6) <= kernels.MORPH_SMEM)
    assert R(rows, 125, 5, (rows - 32) // 2, False).launches == 1
    assert R(rows + 2, 125, 5, (rows + 2 - 32) // 2, False).launches == 2


@pytest.mark.parametrize("case", ["tall_ry20000", "wide_rx3000", "chip_smoke"])
def test_box_morph_past_the_staged_route_matches_plain(case):
    """Radii past the staged route on each axis, on the second route that
    box_morph_route picks (of MORPH_SECOND_ROUTE_CASES: a tall mask at ry =
    20000, a wide one at rx = 3000, chip_smoke.MORPH_SECOND_ROUTE's; the
    1-row tiles of one_row_tiles, 15,000 tiles, run in the model at every
    mask of test_box_morph_walk_matches_plain instead): both modes through
    the model against dilate_torch and erode_torch."""
    mask, rx, ry = MORPH_SECOND_ROUTE_CASES[case]("cpu")
    h, w = mask.shape
    for erode in (False, True):
        assert kernels.box_morph_route(h, w, rx, ry, erode).launches == 2
        want = (region.erode_torch if erode else region.dilate_torch)(mask, rx, ry).numpy()
        assert np.array_equal(mr1_model(mask.numpy(), rx, ry, erode), want), f"{case} erode={erode}"


@st.composite
def morph_cases(draw):
    """A random bool mask as a view (offset, strides, transposed), radii
    and mode, and whether to force the second route."""
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 70))
    sy, sx = draw(st.integers(1, 3)), draw(st.integers(1, 3))
    oy, ox = draw(st.integers(0, 3)), draw(st.integers(0, 5))
    transposed = draw(st.booleans())
    seed = draw(st.integers(0, 2**32 - 1))
    density = draw(st.sampled_from([0.02, 0.3, 0.7, 0.98]))
    rng = np.random.default_rng(seed)
    shape = (ox + sx * w, oy + sy * h) if transposed else (oy + sy * h, ox + sx * w)
    base = torch.from_numpy(rng.random(shape) < density)
    mask = base.t()[oy :: sy, ox :: sx][:h, :w] if transposed else base[oy :: sy, ox :: sx][:h, :w]
    rx, ry = draw(st.integers(0, 45)), draw(st.integers(0, 45))
    return mask, rx, ry, draw(st.booleans()), draw(st.sampled_from([None, 32, 1]))


@settings(max_examples=150, deadline=None, derandomize=True)
@given(morph_cases())
def test_box_morph_model_on_random_views(case):
    """The model of MR1 on random views (offsets, strides, transposed),
    radii 0-45 and both modes, on the route box_morph_route picks or the
    second with 32 or 1 row a block, against dilate_torch and
    erode_torch."""
    mask, rx, ry, erode, second = case
    h, w = mask.shape
    route = None if second is None else second_route(h, w, rx, ry, erode, second)
    want = (region.erode_torch if erode else region.dilate_torch)(mask, rx, ry).numpy()
    assert np.array_equal(mr1_model(mask.numpy(), rx, ry, erode, route), want)


def cv1_passes(kind: str, r: int) -> tuple:
    """convolve_route's modes where a canvas takes no staged launch: one
    row tile past the staged grid's (xy and unit the x pass and the y
    pass; full its one 2D pass)."""
    return kernels.convolve_route(kind, kernels.CONV_TILE[0] * kernels.CONV_ROW_TILES_MAX + 1, 1, r).modes


def cv1_model(kernel, canvas: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """CV1's passes on the CPU from convolve_plan, convolve_route's passes
    (cv1_passes) and blur_divider: each pass a sum of the taps inside the
    canvas in uint32 (wrapping), the floor division by the multiply and
    shift on its magnitude, the clamp, written where the mask holds and
    copied elsewhere."""
    kind, weights, total, r = V.card_kernel(kernel)
    passes = cv1_passes(kind, r)
    weights, total, clamp = kernels.convolve_plan(kind, weights, total, r)
    magic, shift = kernels.blur_divider(total)
    H, W = canvas.shape[:2]
    m = mask[:H, :W, None]
    n = 2 * r + 1
    src = canvas.astype(np.int64)
    for mode in passes:
        padded = np.zeros((H + 2 * r, W + 2 * r, 4), np.uint64)
        padded[r : r + H, r : r + W] = src.astype(np.uint32)
        acc = np.zeros((H, W, 4), np.uint64)
        taps = ([(ky, kx, weights[ky * n + kx]) for ky in range(n) for kx in range(n)] if mode == kernels.CONV_FULL
                else [(k, r, v) if mode == kernels.CONV_PASS_Y else (r, k, v) for k, v in enumerate(weights)])
        for ky, kx, v in taps:
            acc = (acc + np.uint64(v) * padded[ky : ky + H, kx : kx + W]) % 2**32
        s = acc.astype(np.uint32).view(np.int32).astype(np.int64)
        sign = s >> 31
        q = ((magic * (s ^ sign)) >> shift) ^ sign
        if clamp:
            q[..., 0] = np.minimum(q[..., 0], q[..., 3])
            q[..., 1] = np.minimum(q[..., 1], q[..., 3])
        src = np.where(m, q, src)
    return src.astype(np.int32)


def cv1_divided(acc: np.ndarray, magic: int, shift: int, clamp: int) -> np.ndarray:
    """convolve.cu divided(): each uint32 sum as int32, floored by the
    multiply and shift on its magnitude, r and g clamped to a with
    `clamp`."""
    s = acc.astype(np.uint32).view(np.int32).astype(np.int64)
    sign = s >> 31
    q = ((magic * (s ^ sign)) >> shift) ^ sign
    if clamp:
        q[..., 0] = np.minimum(q[..., 0], q[..., 3])
        q[..., 1] = np.minimum(q[..., 1], q[..., 3])
    return q


def cv1_staged_model(kernel, canvas: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """CV1's staged route on the CPU, block by block as
    convolve_staged_kernel runs: each 16 x 64 tile stages the canvas over
    its rows and columns +- r (zero outside the canvas) and the mask over
    its staged rows and its own columns; the x pass over every staged row
    and the tile's columns into cx (the canvas where the mask is unset,
    zero on rows outside the canvas and on columns past it); the y pass
    over cx, written where the tile lies in the canvas (the canvas where
    the mask is unset).  Sums in uint32, wrapping."""
    kind, weights, total, r = V.card_kernel(kernel)
    H, W = canvas.shape[:2]
    assert kernels.convolve_route(kind, H, W, r).modes == (kernels.CONV_STAGED,)
    weights, total, clamp = kernels.convolve_plan(kind, weights, total, r)
    magic, shift = kernels.blur_divider(total)
    TH, TW = kernels.CONV_TILE
    S = TH + 2 * r
    w64 = [np.uint64(v) for v in weights]
    out = np.zeros_like(canvas)
    for ty0 in range(0, H, TH):
        for tx0 in range(0, W, TW):
            ys, xs = ty0 - r + np.arange(S), tx0 - r + np.arange(TW + 2 * r)
            yin, xin = (ys >= 0) & (ys < H), (xs >= 0) & (xs < W)
            cs = np.zeros((S, TW + 2 * r, 4), np.uint64)
            cs[np.ix_(yin, xin)] = canvas[np.ix_(ys[yin], xs[xin])].astype(np.uint32)
            cols = tx0 + np.arange(TW)
            m = np.zeros((S, TW), bool)
            m[np.ix_(yin, cols < W)] = mask[np.ix_(ys[yin], cols[cols < W])]
            acc = sum(w64[k] * cs[:, k : k + TW] for k in range(2 * r + 1)) % 2**32
            cx = np.where(m[..., None], cv1_divided(acc, magic, shift, clamp), cs[:, r : r + TW].astype(np.int64))
            cx[~yin] = 0
            cx[:, cols >= W] = 0
            cx = cx.astype(np.uint32).astype(np.uint64)
            acc = sum(w64[k] * cx[k : k + TH] for k in range(2 * r + 1)) % 2**32
            o = np.where(m[r : r + TH, :, None], cv1_divided(acc, magic, shift, clamp),
                         cs[r : r + TH, r : r + TW].astype(np.int64))
            hh, ww = min(TH, H - ty0), min(TW, W - tx0)
            out[ty0 : ty0 + hh, tx0 : tx0 + ww] = o[:hh, :ww]
    return out


STAGED_KERNELS = ["gaussian1", "gaussian5", "unit1", "unit5", "gaussian16", "unit22"]


def staged_kernel(name: str):
    """convolve_kernels()'s kernel, or mkunit at r = 22 (the staged route's
    largest radius)."""
    return V.mkunit(22) if name == "unit22" else convolve_kernels()[name]


@pytest.mark.parametrize("kernel", STAGED_KERNELS)
def test_convolve_staged_model_matches_plain(kernel):
    """The model of CV1's staged route against convolve_canvas_torch at
    every mask of the card test over 1 x 1, 13 x 7, 41 x 37 and 70 x 130
    canvases (tiles cut by the canvas's edge, more than one tile each way,
    r past the canvas)."""
    k = staged_kernel(kernel)
    for size in ((1, 1), (13, 7), (41, 37), (70, 130)):
        canvas = convolve_canvas_case(3, *size)
        for name, m in convolve_masks("cpu", *size).items():
            want = V.convolve_canvas_torch(k, torch.from_numpy(canvas), m).numpy()
            assert np.array_equal(cv1_staged_model(k, canvas, m.numpy()), want), f"{kernel} {size} {name}"


@st.composite
def staged_cases(draw):
    """A canvas and a mask of at least its size as a view (offset, strides,
    transposed, wider and taller than the canvas), set at random, nowhere,
    or only on rows that are some tile's halo (within r of a tile's top or
    bottom edge), with channels past 255 (plus sums) or any int32."""
    H, W = draw(st.integers(1, 50)), draw(st.integers(1, 140))
    kernel = draw(st.sampled_from(STAGED_KERNELS))
    r = staged_kernel(kernel).radius
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    extra_h, extra_w = draw(st.integers(0, 4)), draw(st.integers(0, 9))
    sy, sx = draw(st.sampled_from([1, 2])), draw(st.sampled_from([1, 3]))
    transposed = draw(st.booleans())
    mh, mw = H + extra_h, W + extra_w
    kind = draw(st.sampled_from(["random", "empty", "halo_rows"]))
    m = rng.random((mh, mw)) < 0.6 if kind == "random" else np.zeros((mh, mw), bool)
    if kind == "halo_rows":
        rows = np.arange(mh)
        near = np.minimum(rows % kernels.CONV_TILE[0], kernels.CONV_TILE[0] - 1 - rows % kernels.CONV_TILE[0]) < r
        m[near] = rng.random((int(near.sum()), mw)) < 0.7
    big = np.zeros((mw * sx + 1, mh * sy + 2) if transposed else (mh * sy + 2, mw * sx + 1), bool)
    t = torch.from_numpy(big)
    view = (t.t() if transposed else t)[1 :: sy, :: sx][:mh, :mw]
    view[...] = torch.from_numpy(m)
    scale = draw(st.sampled_from(["rgba", "wide", "any"]))
    canvas = convolve_canvas_case(draw(st.integers(0, 99)), H, W)
    if scale == "wide":
        canvas = (canvas * rng.integers(1, 4, canvas.shape)).astype(np.int32)
    elif scale == "any":
        canvas = rng.integers(-(2**31), 2**31, canvas.shape, dtype=np.int64).astype(np.int32)
    return staged_kernel(kernel), canvas, view


@settings(max_examples=60, deadline=None, derandomize=True)
@given(staged_cases())
def test_convolve_staged_model_on_random_views(case):
    """The model of CV1's staged route on random canvases and mask views
    (strided, transposed, larger than the canvas, set only on halo rows,
    channels past 255 and any int32, so that sums wrap) against
    convolve_canvas_torch."""
    k, canvas, mask = case
    want = V.convolve_canvas_torch(k, torch.from_numpy(canvas), mask).numpy()
    assert np.array_equal(cv1_staged_model(k, canvas, mask.numpy()), want)


def test_convolve_route_at_its_limits():
    """xy and unit take the staged route up to the radius whose tile fits
    CONV_SMEM (22: two blocks an SM), the two passes past it or past the
    grid's row tiles; full its one 2D launch; the shared memory as
    convolve.cu's StagedLayout counts it."""
    assert kernels.convolve_staged_smem(5) == -(-(16 * 27 * 75 + 4 * 11 + 26 * 64) // 8) * 8 + 8 + 128
    for kind in ("xy", "unit"):
        assert kernels.convolve_route(kind, 1088, 1920, 5) == kernels.ConvRoute((kernels.CONV_STAGED,), 34248)
        assert kernels.convolve_route(kind, 1, 1, 22).modes == (kernels.CONV_STAGED,)
        assert kernels.convolve_staged_smem(22) <= kernels.CONV_SMEM < kernels.convolve_staged_smem(23)
        for r in (23, 24, 150):
            assert kernels.convolve_route(kind, 177, 181, r).modes == (kernels.CONV_PASS_X, kernels.CONV_PASS_Y)
        assert kernels.convolve_route(kind, 16 * 65535, 3, 5).launches == 1
        assert kernels.convolve_route(kind, 16 * 65535 + 1, 3, 5).launches == 2
    assert kernels.convolve_route("full", 1088, 1920, 5) == kernels.ConvRoute((kernels.CONV_FULL,), 0)
    assert 2 * (kernels.convolve_staged_smem(22) + 1024) <= 233472  # two blocks in an SM's 228 KiB


@pytest.mark.parametrize("kernel", ["gaussian1", "gaussian5", "unit5", "full_cone5", "gaussian150", "unit150"])
def test_convolve_passes_match_plain(kernel):
    """The model of CV1's passes against convolve_canvas_torch at every
    mask of the card test over 13 x 7 and 41 x 37 canvases; past the int32
    wrap at r = 150."""
    k = convolve_kernels()[kernel]
    for size in ((13, 7), (41, 37)):
        canvas = convolve_canvas_case(3, *size)
        for name, m in convolve_masks("cpu", *size).items():
            want = V.convolve_canvas_torch(k, torch.from_numpy(canvas), m).numpy()
            assert np.array_equal(cv1_model(k, canvas, m.numpy()), want), f"{kernel} {size} {name}"


def test_convolve_plan_and_card_kernel():
    """Each kind's weights (a full kernel's row by row; a unit kernel's
    ones) and clamp, and its passes off the staged route (convolve_route); the refusals: another kind, a radius under 1,
    another count of weights, a weight outside [0, 2^31), a total of 0."""
    ks = convolve_kernels()
    g = V.card_kernel(ks["gaussian5"])
    assert g == ("xy", ks["gaussian5"].values, ks["gaussian5"].total, 5)
    assert kernels.convolve_plan(*g) == (g[1], g[2], 1)
    assert cv1_passes("xy", 5) == (kernels.CONV_PASS_X, kernels.CONV_PASS_Y)
    assert kernels.convolve_plan(*V.card_kernel(ks["unit5"])) == ((1,) * 11, 11, 0)
    assert cv1_passes("unit", 5) == (0, 1)
    kind, weights, total, r = V.card_kernel(ks["full_cone1"])
    assert (kind, weights, r) == ("full", (3, 4, 3, 4, 5, 4, 3, 4, 3), 1)
    assert kernels.convolve_plan(kind, weights, total, r) == (weights, total, 0)
    assert cv1_passes(kind, r) == kernels.convolve_route(kind, 3, 3, r).modes == (kernels.CONV_FULL,)
    for args in [("cone", (1, 2, 1), 4, 1), ("xy", (1, 2, 1), 4, 0), ("xy", (1, 2, 1, 1), 5, 1),
                 ("full", (1, 2, 1), 4, 1), ("xy", (1, -2, 1), 4, 1), ("xy", (1, 2**31, 1), 4, 1),
                 ("xy", (0, 0, 0), 0, 1), ("xy", (1, 2, 1), 2**31, 1)]:
        with pytest.raises(ValueError):
            kernels.convolve_plan(*args)


def test_blur_divider_floors_wrapped_sums():
    """The divider CV1 shares with B1 floors every int32 sum, the
    negative ones a wrapped sum gives included, at the kernels' totals."""
    rng = np.random.default_rng(5)
    sums = np.concatenate([rng.integers(-(2**31), 2**31, 20000), [-(2**31), -1, 0, 1, 2**31 - 1]])
    for kernel in convolve_kernels().values():
        total = V.card_kernel(kernel)[2]
        magic, shift = kernels.blur_divider(total)
        sign = sums >> 31
        assert np.array_equal(((magic * (sums ^ sign)) >> shift) ^ sign, sums // total)


def test_wrappers_refuse_the_cpu_and_bad_planes():
    """Each wrapper refuses CPU tensors before it loads anything; caf's
    geometry refuses other dtypes, planes outside the union box and a
    composed plane with a mask."""
    m = torch.ones((5, 7), dtype=torch.bool)
    rgba = torch.zeros((5, 7, 4), dtype=torch.int32)
    plane = kernels.CafPlane(0, 0, m, rgba)
    cpu = torch.device("cpu")
    for fn in [lambda: kernels.caf(5, 7, 0, plane), lambda: kernels.tight_bounds(m),
               lambda: kernels.box_morph(m, 1, 1, erode=False), lambda: kernels.box_morph(m, 1, 1, erode=True),
               lambda: kernels.convolve_canvas("xy", (1, 2, 1), 4, 1, rgba, m),
               lambda: kernels.convolve_canvas("unit", (), 3, 1, rgba.transpose(0, 1), m),
               lambda: kernels.tight_bounds(m.to(torch.uint8)),
               lambda: kernels._caf_geometry(5, 7, kernels.CafPlane(0, 0, m, rgba.long()), cpu),
               lambda: kernels._caf_geometry(5, 7, kernels.CafPlane(0, 0, m.to(torch.uint8), rgba), cpu),
               lambda: kernels._caf_geometry(5, 7, kernels.CafPlane(0, 1, m, rgba), cpu),
               lambda: kernels._caf_geometry(4, 7, plane, cpu)]:
        with pytest.raises(ValueError):
            fn()
    assert kernels._caf_geometry(6, 9, kernels.CafPlane(1, 2, m, rgba), cpu)[:4] == [1, 2, 5, 7]


def test_cpu_calls_launch_nothing():
    """caf, boxshape, boxsprite, bloat, erode and convolve_canvas on CPU
    tensors run the plain versions: no launch counter moves."""
    before = dict(kernels.launches)
    a, b = caf_sprite("cpu", 1, (5, 7, 40, 23), "dense"), caf_sprite("cpu", 2, (20, 12, 40, 30), "view")
    for op in (*CAF_BUILTIN, *caf_registered()):
        region.caf(op, "opaque", a, b)
    region.caf("over", "opaque", a, None)
    s = region.shape_of_sprite(a)
    region.boxshape(region.shape_union(s, region.shape_of_sprite(b)))
    region.boxsprite(a)
    region.bloat(5, 3, s)
    region.erode(1, 2, s)
    canvas = torch.from_numpy(convolve_canvas_case(1, 13, 7))
    for k in convolve_kernels().values():
        V.convolve_canvas(k, canvas, torch.ones((13, 7), dtype=torch.bool))
    assert kernels.launches == before
