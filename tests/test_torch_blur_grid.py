"""The blur kernel's tiling, held on the CPU.

blur_blend.cu (B1) launches its window mode over only the pixels that can
change, ``kernels.blur_launch_rect``, and divides its sums by the weights'
total with a multiply and a shift, ``kernels.blur_divider``.  Both are
host arithmetic, held here:

  * the launch rect: for random window geometry (dirty boxes at and past
    the window's edges and corners, radii 1 to 200, hypothesis with a fixed
    seed), every pixel the plain window pass changes lies inside it, and it
    lies inside the logical window and the hb x wb block;
  * the divider: a numpy copy of the kernel's division equals ``//`` at
    exact multiples of the total and one either side, for negative
    (wrapped) sums and at INT32_MIN and INT32_MAX, for the blur's totals at
    radii 1 to 200 and for edge and random totals;
  * the card tests' tiling cases (tests/test_torch_cuda.py: one pixel, one
    row, one column, a rect ending on a tile's edge and one pixel past it)
    reach what they name, and their plain versions equal the JAX package's
    programs.

Tolerance 0 throughout: the colour math is integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from coherence_tpu.raster import framepath as JFP
from coherence_tpu.scene import fastframe as JF
from coherence_tpu_torch import kernels
from coherence_tpu_torch.raster import convolve as TV
from coherence_tpu_torch.raster import framepath as TFP

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_cuda import (BLUR_TILING, BLUR_TINY_FRAMES, blur_content, packed_rgba, speckled_alpha, tiling_case,
                             tiny_frame_case, unpacked_rgba)

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def floordiv_by(s: np.ndarray, total: int) -> np.ndarray:
    """blur_blend.cu's floordiv over int32 sums `s`, in numpy: the sign's
    mask m = s >> 31, then m ^ ((magic * (s ^ m)) >> shift)."""
    magic, shift = kernels.blur_divider(total)
    s = np.asarray(s, np.int32)
    sign = s >> 31
    n = (s ^ sign).astype(np.uint64)
    q = (np.uint64(magic) * n) >> np.uint64(shift)
    return q.astype(np.int64) ^ sign.astype(np.int64)


def edge_sums(total: int) -> np.ndarray:
    """int32 sums at the edges of the division by `total`: exact multiples
    of it and one either side (positive and negative), small values,
    INT32_MIN and INT32_MAX and their neighbours."""
    q = np.array([0, 1, 2, 3, 255, 256, 1000, INT32_MAX // total - 1, INT32_MAX // total], np.int64)
    multiples = np.concatenate([q * total, -q * total])
    sums = np.concatenate([multiples - 1, multiples, multiples + 1, np.arange(-300, 301),
                           [INT32_MIN, INT32_MIN + 1, INT32_MIN + 2, INT32_MAX - 1, INT32_MAX]])
    return np.unique(sums[(sums >= INT32_MIN) & (sums <= INT32_MAX)]).astype(np.int32)


EDGE_TOTALS = [1, 2, 3, 5, 7, 255, 256, 257, 65535, 65536, 65537, 2**30 - 1, 2**30, 2**30 + 1, 2**31 - 2,
               2**31 - 1]


def test_divider_magic_fits_32_bits():
    """magic < 2^32 and shift <= 62 for every total the wrapper admits (the
    kernel's operands), at the edges and at every power of two."""
    for total in EDGE_TOTALS + [2**k for k in range(31)] + [2**k + 1 for k in range(31)]:
        magic, shift = kernels.blur_divider(total)
        assert 0 < magic < 2**32 and 31 <= shift <= 62, total


@pytest.mark.parametrize("total", EDGE_TOTALS)
def test_divider_floors_at_edge_totals(total):
    sums = edge_sums(total)
    assert np.array_equal(floordiv_by(sums, total), sums.astype(np.int64) // total)


def test_divider_floors_for_every_blur_total():
    """The totals of mkgaussian at radii 1 to 200 (past r = 140 the sums
    wrap, so negative sums are real inputs there)."""
    for radius in range(1, 201):
        total = TV.mkgaussian(radius).total
        sums = np.concatenate([edge_sums(total), np.random.default_rng(radius).integers(
            INT32_MIN, INT32_MAX, 4000, endpoint=True).astype(np.int32)])
        assert np.array_equal(floordiv_by(sums, total), sums.astype(np.int64) // total), radius


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.integers(1, INT32_MAX), st.lists(st.integers(INT32_MIN, INT32_MAX), min_size=1, max_size=50))
def test_divider_floors_for_random_totals(total, sums):
    sums = np.concatenate([np.asarray(sums, np.int32), edge_sums(total)])
    assert np.array_equal(floordiv_by(sums, total), sums.astype(np.int64) // total)


# Window geometry in window coordinates: an hb x wb block, a logical window
# inside it, a dirty box anywhere from past its top left to past its bottom
# right (blur_window keeps it inside; the rect must not rely on that).
@st.composite
def window_geometry(draw):
    hb, wb = draw(st.integers(1, 40)), draw(st.integers(1, 72))
    ry0, rx0 = draw(st.integers(0, hb - 1)), draw(st.integers(0, wb - 1))
    h, w = draw(st.integers(1, hb - ry0)), draw(st.integers(1, wb - rx0))
    rows = st.sampled_from(sorted({-3, 0, ry0, ry0 + h - 1, hb - 1, hb + 2})) | st.integers(-3, hb + 2)
    cols = st.sampled_from(sorted({-3, 0, rx0, rx0 + w - 1, wb - 1, wb + 2})) | st.integers(-3, wb + 2)
    d0, d2 = sorted((draw(rows), draw(rows)))
    d1, d3 = sorted((draw(cols), draw(cols)))
    radius = draw(st.sampled_from([1, 2, 5, 16, 31, 150, 200]) | st.integers(1, 200))
    return hb, wb, ry0, rx0, h, w, (d0, d1, d2, d3), radius, draw(st.integers(0, 2**31 - 1))


@settings(max_examples=120, deadline=None, derandomize=True)
@given(window_geometry())
def test_launch_rect_holds_every_changed_pixel(geometry):
    """Every pixel blur_blend_into_torch writes lies in blur_launch_rect,
    and the rect lies in the logical window and in the block."""
    hb, wb, ry0, rx0, h, w, d_box, radius, seed = geometry
    rng = np.random.default_rng(seed)
    oy, ox = int(rng.integers(0, 4)), int(rng.integers(0, 4))
    rgba = blur_content(seed % 1000, oy + hb, ox + wb)
    alpha = speckled_alpha(seed % 997, oy + hb, ox + wb)
    display = np.full((oy + hb, ox + wb, 4), -1, np.int32)  # no blend gives -1: every write shows
    kernel = TV.mkgaussian(radius)
    out = TFP.blur_blend_into_torch(torch.from_numpy(display), torch.from_numpy(packed_rgba(rgba)), (oy, ox),
                                    torch.from_numpy(alpha), (oy, ox), hb, wb, ry0, rx0, h, w,
                                    np.asarray(d_box, np.int32), kernel.values, kernel.total).numpy()
    written = (out[oy:, ox:] != -1).any(axis=-1)
    y0, x0, y1, x1 = kernels.blur_launch_rect(hb, wb, ry0, rx0, h, w, d_box, radius)
    inside = np.zeros((hb, wb), bool)
    inside[max(y0, 0) : max(y1, 0), max(x0, 0) : max(x1, 0)] = True
    assert not (written & ~inside).any()
    if y1 > y0 and x1 > x0:
        assert ry0 <= y0 and rx0 <= x0 and y1 <= ry0 + h and x1 <= rx0 + w
        assert 0 <= y0 and 0 <= x0 and y1 <= hb and x1 <= wb
    assert (out[:oy] == -1).all() and (out[:, :ox] == -1).all()


def test_tiling_cases_reach_the_tile_edges():
    """The card tests' cases launch over what they name: one pixel, one
    row, one column, 2 x 2 whole tiles, and one pixel past them (a third
    row and column of tiles); each at an odd column of the packed plane."""
    ty, tx = kernels.BLUR_TILE
    sizes = {}
    for name, (oy, ox, ry0, rx0, h, w, hb, wb, d_box) in BLUR_TILING.items():
        assert ox % 2 == 1, name
        for radius in (1, 200):
            y0, x0, y1, x1 = kernels.blur_launch_rect(hb, wb, ry0, rx0, h, w, d_box, radius)
            sizes.setdefault(name, set()).add((y1 - y0, x1 - x0))
    assert sizes["one_pixel"] == {(1, 1)}
    assert {s[0] for s in sizes["one_row"]} == {1} and {s[1] for s in sizes["one_column"]} == {1}
    assert sizes["tile_edge"] == {(2 * ty, 2 * tx)}
    assert sizes["tile_edge_plus_one"] == {(2 * ty + 1, 2 * tx + 1)}


def _jax_window(packed, display, alpha, win, kernel):
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    return np.asarray(JF._blur_blend_window_kernel(
        jnp.asarray(display.copy()), jnp.asarray(packed.view(np.uint32)), jnp.asarray(alpha), oy, ox, ry0, rx0, h, w,
        d_box, hb=hb, wb=wb, weights=tuple(kernel.values), total=kernel.total))


@pytest.mark.parametrize("case", list(BLUR_TILING))
@pytest.mark.parametrize("radius", [1, 5, 31])
def test_tiling_cases_match_jax(radius, case):
    """The card tests' tiling cases, plain, over both content forms, equal
    to the JAX package's window program."""
    kernel = TV.mkgaussian(radius)
    packed, display, alpha, win = tiling_case(case, radius)
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    want = _jax_window(packed, display, alpha, win, kernel)
    assert not np.array_equal(want, display)
    got = TFP.blur_blend_into(torch.from_numpy(display.copy()), torch.from_numpy(packed), (oy, ox),
                              torch.from_numpy(alpha), (oy, ox), hb, wb, ry0, rx0, h, w, d_box, kernel.values,
                              kernel.total)
    assert np.array_equal(got.numpy(), want)
    window = torch.from_numpy(np.ascontiguousarray(unpacked_rgba(packed)[oy : oy + hb, ox : ox + wb]))
    got = TFP.blur_blend_into(torch.from_numpy(display.copy()), window, (0, 0), torch.from_numpy(alpha), (oy, ox),
                              hb, wb, ry0, rx0, h, w, d_box, kernel.values, kernel.total)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("frame_hw", BLUR_TINY_FRAMES)
def test_tiny_frames_match_jax(frame_hw):
    """The card tests' tiny rect-mode frames, plain, from both content
    forms, equal to the JAX package's rect program (radius 4)."""
    kernel = TV.mkgaussian(4)
    packed, frame, alpha = tiny_frame_case(*frame_hw, 4)
    want = np.asarray(JFP._apply_blur_rect_kernel(jnp.asarray(frame), jnp.asarray(alpha),
                                                  weights=tuple(kernel.values), total=kernel.total))
    for content in (frame, packed):
        got = TFP.blur_blend_rect(torch.from_numpy(content), torch.from_numpy(alpha), kernel.values, kernel.total)
        assert np.array_equal(got.numpy(), want)


def test_launch_floor_and_blur_refuse_the_cpu():
    """The empty kernel's wrapper and the blur wrappers raise on the CPU
    (the plain versions serve it), and count nothing."""
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.launch_floor("cpu")
    packed, display, alpha, win = tiling_case("tile_edge", 5)
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    k = TV.mkgaussian(5)
    with pytest.raises(ValueError):
        kernels.blur_blend_window(torch.from_numpy(packed), (oy, ox), torch.from_numpy(alpha),
                                  torch.from_numpy(display), (oy, ox), hb, wb, ry0, rx0, h, w, d_box, k.values,
                                  k.total)
    with pytest.raises(ValueError):
        kernels.blur_blend_rect(torch.from_numpy(packed), torch.from_numpy(alpha), k.values, k.total)
    assert kernels.launches == before
