"""The host side of the region kernels, on the CPU: CF1 ``caf``, TB1
``tight_bounds``, MR1 ``box_morph`` (kernels/csrc/region_ops.cu) and CV1
``convolve_canvas`` (kernels/csrc/convolve.cu).

The kernels run only on a card (tests/test_torch_cuda.py holds each to its
plain version there).  Here each wrapper's host side is held to the plain
versions through a model of its kernel, written from the kernel's source:
CF1 reading its operand planes at their offsets in the union box, with the
operator code or the composed plane the card route picks; MR1's walk of a
block over its tile, chunk by chunk, as box_morph_kernel does it; CV1's
passes from convolve_plan, divided by blur_divider's multiply and shift on
sums that wrap.  Then the refusals, and that on the CPU no launch counter
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
from test_torch_cuda import (CAF_BUILTIN, CAF_LAYOUTS, CAF_PLACES, MORPH_RADII, MORPH_SECOND_ROUTE_CASES,
                             assert_same_caf, bounds_masks, caf_registered, caf_sprite, convolve_canvas_case,
                             convolve_kernels, convolve_masks, morph_masks, WORDS_LAYOUTS,
                             words_case)

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


def test_tight_bounds_blocks():
    """TB1's grid: one block a TIGHT_BOUNDS_CELLS cells, at least one, at
    most the scratch's partials."""
    cells = kernels.TIGHT_BOUNDS_CELLS
    for h, w in [(1, 1), (37, 53), (1, cells), (1, cells + 1), (1080, 1920), (10**5, 10**4)]:
        n = kernels.tight_bounds_blocks(h, w, 528)
        assert 1 <= n <= 528 and (n == 528 or n * cells >= h * w > (n - 1) * cells)


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


def cv1_model(kernel, canvas: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """CV1's passes on the CPU from convolve_plan and blur_divider: each
    pass a sum of the taps inside the canvas in uint32 (wrapping), the
    floor division by the multiply and shift on its magnitude, the clamp,
    written where the mask holds and copied elsewhere."""
    kind, weights, total, r = V.card_kernel(kernel)
    passes, weights, total, clamp = kernels.convolve_plan(kind, weights, total, r)
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
    """Each kind's passes, weights (a full kernel's row by row; a unit
    kernel's ones) and clamp; the refusals: another kind, a radius under 1,
    another count of weights, a weight outside [0, 2^31), a total of 0."""
    ks = convolve_kernels()
    g = V.card_kernel(ks["gaussian5"])
    assert g == ("xy", ks["gaussian5"].values, ks["gaussian5"].total, 5)
    assert kernels.convolve_plan(*g) == ((kernels.CONV_PASS_X, kernels.CONV_PASS_Y), g[1], g[2], 1)
    assert kernels.convolve_plan(*V.card_kernel(ks["unit5"])) == ((0, 1), (1,) * 11, 11, 0)
    kind, weights, total, r = V.card_kernel(ks["full_cone1"])
    assert (kind, weights, r) == ("full", (3, 4, 3, 4, 5, 4, 3, 4, 3), 1)
    assert kernels.convolve_plan(kind, weights, total, r) == ((kernels.CONV_FULL,), weights, total, 0)
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
