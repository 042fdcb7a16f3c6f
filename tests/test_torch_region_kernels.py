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

from coherence_tpu_torch import colour as C
from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import convolve as V
from coherence_tpu_torch.raster import region

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import (CAF_BUILTIN, CAF_LAYOUTS, CAF_PLACES, MORPH_RADII, assert_same_caf, bounds_masks,
                             caf_registered, caf_sprite, convolve_canvas_case, convolve_kernels, convolve_masks,
                             morph_masks)

# CF1's built-in operators by code, as caf_kernel's `compose` computes them.
CF1_OPS = {0: C.over_rgba, 1: C.alpha_over_rgba, 2: C.pd_plus_rgba, 3: lambda a, b: b}


def cf1_model(h, w, op, a, b=None, composed=None, f_only=False, calls=None):
    """CF1 on the CPU from kernels.caf's arguments: each plane's geometry as
    the wrapper sends it (kernels._caf_geometry), its mask and RGBA read
    over its box at its offset, False and 0 outside; the built-in operator
    of `op`, or the composed plane where both masks are set."""
    geoms = [kernels._caf_geometry(h, w, p, torch.device("cpu")) for p in (a, b, composed)]
    if calls is not None:
        calls.append((op, geoms))

    def placed(plane, geom, what):
        y0, x0, ph, pw = geom[:4]
        out = (torch.zeros((h, w), dtype=torch.bool) if what == "mask" else torch.zeros((h, w, 4), dtype=torch.int32))
        if plane is not None:
            out[y0 : y0 + ph, x0 : x0 + pw] = getattr(plane, what)
        return out

    ma, mb = placed(a, geoms[0], "mask"), placed(b, geoms[1], "mask")
    ra, rb = placed(a, geoms[0], "rgba"), placed(b, geoms[1], "rgba")
    comp = placed(composed, geoms[2], "rgba") if op == kernels.CAF_GIVEN else CF1_OPS[op](ra, rb)
    rgba = torch.where((ma & mb)[..., None], comp, torch.where(ma[..., None], ra, torch.where(mb[..., None], rb, 0)))
    f = (ma | mb) & (rgba[..., 3] == 255)
    return f if f_only else (rgba, ma | mb, f)


@pytest.fixture
def cf1_on_the_cpu(monkeypatch):
    """kernels.caf replaced by cf1_model, recording (op, geometries) per
    call; yields the record."""
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
                    code, geoms = cf1_on_the_cpu[-1]
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
    _, (ga, gb, gc) = cf1_on_the_cpu[-1]
    assert ga[:4] == [5, 4, 23, 40] and gb[:4] == [0, 0, 50, 70] and gc == [0] * 10
    assert ga[4:9] == [a.mask.stride(0), 1, a.rgba.stride(0), 4, 1] and a.rgba.stride(0) == 4 * (40 + 9)
    assert gb[4:9] == [0, 1, 0, 0, 1] and gb[9] == 0
    d = caf_sprite("cpu", 3, (20, 12, 40, 30), "dense")
    region._caf_card("plus", "opaque", d, None)
    code, (gd, gn, _) = cf1_on_the_cpu[-1]
    assert gd[:4] == [0, 0, 30, 40] and gn == [0] * 10 and gd[9] == int(d.rgba.data_ptr() % 16 == 0)


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


def mr1_model(mask: np.ndarray, rx: int, ry: int, erode: bool) -> np.ndarray:
    """box_morph_kernel's walk on the CPU, a block's threads as a vector:
    for each MORPH_TILE tile, each source row its windows reach, each
    128-column chunk of its reach, the inclusive max-scan of the last
    column holding the value with the carry, each column's window test;
    the last row whose row window held it, carried down each column; the
    tile rows' bits as their windows' last rows pass; erode's interior."""
    h, w = mask.shape
    TH, TW = kernels.MORPH_TILE
    (H, W), (dx0, dx1, dy0, dy1) = kernels.box_morph_geometry(h, w, rx, ry, erode)
    want = not erode
    out = np.zeros((H, W), bool)
    t = np.arange(TW)
    for Y0 in range(0, H, TH):
        for X0 in range(0, W, TW):
            X = X0 + t
            s0, s_end = max(0, X0 + dx0), min(w - 1, X0 + TW - 1 + dx1)
            a = np.maximum(X + dx0, s0) - s0
            b = np.minimum(X + dx1, w - 1) - s0
            ys, ye = max(0, Y0 + dy0), min(h - 1, Y0 + TH - 1 + dy1)
            last_row = np.full(TW, -1)
            bits = np.zeros((TH, TW), bool)
            for y in range(ys, ye + 1):
                held = np.zeros(TW, bool)
                carry = -1
                for cs in range(0, s_end - s0 + 1, TW):
                    c = cs + t
                    v = np.where(c <= s_end - s0, c, -1)
                    ok = c <= s_end - s0
                    v[ok] = np.where(mask[y, c[ok] + s0] == want, c[ok], -1)
                    last = np.maximum(np.maximum.accumulate(v), carry)
                    here = (b >= cs) & (b < cs + TW) & (b >= a)
                    held[here] = last[b[here] - cs] >= a[here]
                    carry = last[-1]
                last_row[held] = y
                final = Y0 + TH - 1 if y == h - 1 else y - dy1
                for Y in range(max(Y0, y - dy1), min(Y0 + TH - 1, final) + 1):
                    bits[Y - Y0] |= last_row >= max(Y + dy0, ys)
            rows, cols = slice(Y0, min(Y0 + TH, H)), slice(X0, min(X0 + TW, W))
            got = bits[: rows.stop - Y0, : cols.stop - X0]
            if erode:
                yy, xx = np.mgrid[rows, cols]
                got = ~got & (yy >= ry) & (yy < h - ry) & (xx >= rx) & (xx < w - rx)
            out[rows, cols] = got
    return out


@pytest.mark.parametrize("radii", MORPH_RADII, ids=[f"rx{a}ry{b}" for a, b in MORPH_RADII])
def test_box_morph_walk_matches_plain(radii):
    """The model of MR1's walk against dilate_torch and erode_torch at
    every mask of the card test, radius 0 on one axis and past the box."""
    rx, ry = radii
    for name, m in morph_masks("cpu").items():
        mask = m.numpy()
        assert np.array_equal(mr1_model(mask, rx, ry, False), region.dilate_torch(m, rx, ry).numpy()), f"bloat {name}"
        assert np.array_equal(mr1_model(mask, rx, ry, True), region.erode_torch(m, rx, ry).numpy()), f"erode {name}"


def test_box_morph_geometry():
    """Bloat's output is nbox's and its window ends at the cell; erode's is
    the mask's, its window centred; radii under 0 and outputs past the grid
    refused."""
    assert kernels.box_morph_geometry(17, 29, 2, 5, False) == ((27, 33), (-4, 0, -10, 0))
    assert kernels.box_morph_geometry(17, 29, 2, 5, True) == ((17, 29), (-2, 2, -5, 5))
    assert kernels.box_morph_geometry(17, 29, 0, 0, True) == ((17, 29), (0, 0, 0, 0))
    for args in [(17, 29, -1, 0, False), (17, 29, 0, -1, True), (2**20, 1, 0, 0, True), (1, 2**31, 0, 0, True),
                 (1, 1, 2**30, 0, False)]:
        with pytest.raises(ValueError):
            kernels.box_morph_geometry(*args)


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
