"""The port's animated frame against the JAX package's one-program frame.

The JAX package runs an animated frame under a live blur filter as one
device program (scene/fastframe.py _animated_blur_frame_kernel: the
shatter, the dirty-tile compositor, the blurred window) and a whole
animation as a scan of it (_play_animated_kernel).  On a CUDA device the
port runs the same frame as one staged copy of the frame's lists
(raster/staging.py) and three launches: shatter_into (S1), composite_dirty
(K1) and blur_blend (B1).  On the CPU each launch is its plain version,
held here to the JAX package on seeded numpy inputs:

  * B1's window mode (fastframe.blur_blend_window over a packed content
    plane, framepath.blur_blend_into over unpacked content) against
    _blur_blend_window_kernel, and its rect mode (framepath.blur_blend_rect)
    against _apply_blur_rect_kernel: radii 1, 5, 16 and 64, windows at
    every frame edge and corner (d_box on the window's edge), alpha planes
    all 0, all 255 and mixed; and at radii 150 and 200, where 255 x total
    passes 2^31 and both packages' int32 sums wrap alike;
  * S1 (tiled_scene.shatter_into) against _shatter_into_kernel: negative
    offsets, offsets past the raster, repeated padding slots, and the
    banded (n_bands, n) form against the JAX package's banded update;
  * the staged step_animated for 20 frames of test_torch_slice's shrunk
    bench scene against the JAX package's (its Pallas kernel in interpret
    mode), and play_animated over the same 20 deltas against the scan:
    display, content and atlas equal after every frame;
  * the staging layout: every segment 16-byte aligned, the round trip exact.

Tolerance 0 throughout: the colour math is integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherence_tpu.raster import framepath as JFP
from coherence_tpu.raster import tiled_scene as JT
from coherence_tpu.scene import fastframe as JF

from coherence_tpu_torch import convert
from coherence_tpu_torch.raster import convolve as TV
from coherence_tpu_torch.raster import framepath as TFP
from coherence_tpu_torch.raster import staging
from coherence_tpu_torch.raster import tiled_scene as T
from coherence_tpu_torch.scene import fastframe as TF

from _torch_threads import one_torch_thread  # noqa: F401
import test_torch_slice as slice_scene
from test_torch_cuda import (BLUR_ALPHAS, BLUR_FH, BLUR_FW, BLUR_PLACES, BLUR_RADII, banded_shatter_case, blur_case,
                             shatter_case, unpacked_rgba, wrapped_blur_case)

def _i32(x) -> np.ndarray:
    """JAX uint32 words as int32 with the same bits."""
    return np.asarray(x).view(np.int32)


def _t(a) -> torch.Tensor:
    """A tensor of a copy: the port updates displays and atlases in place."""
    return torch.from_numpy(np.array(a))


def _jax_window(packed, display, alpha, win, kernel):
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    # A copy: the program donates the display, which on the CPU may alias the numpy array.
    return np.asarray(JF._blur_blend_window_kernel(
        jnp.asarray(display.copy()), jnp.asarray(packed.view(np.uint32)), jnp.asarray(alpha), oy, ox, ry0, rx0, h, w,
        d_box, hb=hb, wb=wb, weights=tuple(kernel.values), total=kernel.total))


@pytest.mark.parametrize("place", list(BLUR_PLACES))
@pytest.mark.parametrize("radius", BLUR_RADII)
def test_blur_blend_window_matches_jax(radius, place):
    """B1's window mode, plain, at every edge and corner: over the packed
    content plane (FilteredDisplay's form) and over the unpacked window
    (FrameBuffer's), each alpha plane, equal to the JAX program."""
    kernel = TV.mkgaussian(radius)
    for kind in BLUR_ALPHAS:
        packed, display, alpha, win = blur_case(radius, place, kind)
        _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
        want = _jax_window(packed, display, alpha, win, kernel)
        got = TF.blur_blend_window(_t(display), _t(packed), _t(alpha), oy, ox, ry0, rx0, h, w, d_box, hb, wb,
                                   kernel.values, kernel.total)
        assert np.array_equal(got.numpy(), want), kind
        unpacked = _t(np.ascontiguousarray(unpacked_rgba(packed)[oy : oy + hb, ox : ox + wb]))
        got = TFP.blur_blend_into(_t(display), unpacked, (0, 0), _t(alpha), (oy, ox), hb, wb, ry0, rx0, h, w,
                                  d_box, kernel.values, kernel.total)
        assert np.array_equal(got.numpy(), want), kind
        if kind == "mixed":
            assert not np.array_equal(want, display), "the window changed"


def test_window_geometry_reaches_every_edge():
    """The cases put the window against each frame edge (oy or ox at 0, or
    the window's far side on the frame's), with ry0 or rx0 non-zero where
    the window is clamped, and d_box on the window's edge."""
    wins = {p: TFP.blur_window(b, (1, 1, BLUR_FW, BLUR_FH), 5, BLUR_FH, BLUR_FW) for p, b in BLUR_PLACES.items()}
    assert wins["top_left"][1:3] == (0, 0) and list(wins["top_left"][9][:2]) == [0, 0]
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = wins["bottom_right"]
    assert (oy + hb, ox + wb) == (BLUR_FH, BLUR_FW) and ry0 > 0 and rx0 > 0
    assert (d_box[2], d_box[3]) == (hb - 1, wb - 1)
    assert wins["top"][1] == 0 and wins["left"][2] == 0
    assert wins["bottom"][1] + wins["bottom"][7] == BLUR_FH and wins["right"][2] + wins["right"][8] == BLUR_FW


@pytest.mark.parametrize("kind", BLUR_ALPHAS)
@pytest.mark.parametrize("radius", BLUR_RADII)
def test_blur_blend_rect_matches_jax(radius, kind):
    """B1's rect mode, plain, over the whole frame: from unpacked RGBA
    (FrameBuffer.apply_blur) and from the packed, padded plane
    (FilteredDisplay.full_refresh), equal to the JAX program."""
    kernel = TV.mkgaussian(radius)
    packed, _, alpha, _ = blur_case(radius, "centre", kind)
    frame = unpacked_rgba(packed)[:BLUR_FH, :BLUR_FW]
    want = np.asarray(JFP._apply_blur_rect_kernel(jnp.asarray(frame), jnp.asarray(alpha),
                                                  weights=tuple(kernel.values), total=kernel.total))
    assert np.array_equal(TFP.blur_blend_rect(_t(frame), _t(alpha), kernel.values, kernel.total).numpy(), want)
    assert np.array_equal(TFP.blur_blend_rect(_t(packed), _t(alpha), kernel.values, kernel.total).numpy(), want)


@pytest.mark.parametrize("radius", [150, 200])
def test_blur_sums_wrap_as_the_jax_package_does(radius):
    """Above r = 140, 255 x total passes 2^31: over a frame wider than the
    kernel whose top rows are opaque white, both packages' int32 sums wrap
    in two's complement, and the reference gives channels below 0.  The
    port gives the same integers in both modes."""
    kernel = TV.mkgaussian(radius)
    assert 255 * kernel.total >= 2**31
    packed, display, alpha, win = wrapped_blur_case(radius)
    fh, fw = alpha.shape
    frame = unpacked_rgba(packed)[:fh, :fw]
    want = np.asarray(JFP._apply_blur_rect_kernel(jnp.asarray(frame), jnp.asarray(alpha),
                                                  weights=tuple(kernel.values), total=kernel.total))
    assert want.min() < 0, "the reference's sums wrapped"
    assert np.array_equal(TFP.blur_blend_rect(_t(packed), _t(alpha), kernel.values, kernel.total).numpy(), want)
    _, oy, ox, ry0, rx0, h, w, hb, wb, d_box = win
    want = _jax_window(packed, display, alpha, win, kernel)
    assert want.min() < 0
    got = TF.blur_blend_window(_t(display), _t(packed), _t(alpha), oy, ox, ry0, rx0, h, w, d_box, hb, wb,
                               kernel.values, kernel.total)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shatter_matches_jax(seed, staged):
    """S1, plain, against _shatter_into_kernel: offsets below the raster,
    past it, straddling its edges and inside, the last piece repeated to
    pad the list as _inplace_args pads it; host offsets and staged int32
    tensors alike."""
    atlas, rgba, oys, oxs, base = shatter_case(seed)
    want = _i32(JT._shatter_into_kernel(jnp.asarray(atlas), jnp.asarray(rgba), oys, oxs, base))
    if staged:
        oys, oxs = staging.stage("cpu", oys, oxs)
    got = T.shatter_into(convert.packed(atlas, "cpu"), _t(rgba), oys, oxs, base)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want[base + 9], want[base + 11]), "padding slots repeat a piece"


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_shatter_matches_jax(seed):
    """S1's (n_bands, n) form against the JAX package's banded update (one
    _shatter_into_kernel per band of the stack, as its shard_map runs it),
    with the out-of-range offsets that write a band's zero pieces."""
    atlases, rgba, oys, oxs, rb = banded_shatter_case(seed)
    want = np.stack([_i32(JT._shatter_into_kernel.__wrapped__(jnp.asarray(a), jnp.asarray(rgba), oys[b], oxs[b], rb))
                     for b, a in enumerate(atlases)])
    got = T.shatter_into(convert.packed(atlases, "cpu"), _t(rgba), oys, oxs, rb)
    assert np.array_equal(got.numpy(), want)
    assert not want[1, rb : rb + oys.shape[1]].any(), "band 1's pieces are zero"


N_FRAMES = 20
DELTAS = [(7, 3)] * 10 + [(-7, -3)] * 10


def _jax_side():
    view, disp, key = slice_scene._jax_run()
    return view, disp, key


def _port_side():
    return slice_scene._port_run()


def _state(view, disp):
    atlas = view.ts.atlas()
    if isinstance(atlas, torch.Tensor):
        return atlas.numpy().copy(), view.frame.numpy().copy(), disp.rgba.numpy().copy()
    return _i32(atlas).copy(), _i32(view.frame).copy(), np.asarray(disp.rgba).copy()


@pytest.fixture(scope="module")
def stepped():
    """The state after each of 20 step_animated frames, both packages, and
    how many staged uploads each of the port's frames made."""
    (jv, jd, jk), (pv, pd, pk) = _jax_side(), _port_side()
    calls = []
    real_stage = TF.stage

    def counting(device, *arrays):
        calls.append(len(arrays))
        return real_stage(device, *arrays)

    TF.stage = counting
    try:
        states = []
        for dx, dy in DELTAS:
            jd.step_animated(jk, dx, dy)
            n = len(calls)
            pd.step_animated(pk, dx, dy)
            states.append((_state(jv, jd), _state(pv, pd), calls[n:]))
    finally:
        TF.stage = real_stage
    return states


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_animated_matches_jax(stepped, frame):
    """Atlas, content and display after each staged frame equal the JAX
    package's one-program frame; the port staged the frame's five lists
    in one upload."""
    (ja, jf, jd), (pa, pf, pdisp), calls = stepped[frame]
    assert np.array_equal(pa, ja), "atlas"
    assert np.array_equal(pf, jf), "content"
    assert np.array_equal(pdisp, jd), "display"
    assert calls == [5], "one staged upload of oys, oxs, coords, spans, idxs"


def test_play_animated_matches_the_scan():
    """play_animated over the 20 deltas: the port's staged steps against the
    JAX package's scan (require_scan on both), the captured frames and the
    final atlas, content and display equal, and equal to the sequential
    steps."""
    (jv, jd, jk), (pv, pd, pk) = _jax_side(), _port_side()
    jframes = jd.play_animated(jk, DELTAS, capture_every=5, require_scan=True)
    pframes = pd.play_animated(pk, DELTAS, capture_every=5, require_scan=True)
    assert pframes.shape == (4, slice_scene.H, slice_scene.W, 4)
    assert np.array_equal(pframes, np.asarray(jframes))
    for got, want in zip(_state(pv, pd), _state(jv, jd)):
        assert np.array_equal(got, want)
    sv, sd, sk = _port_side()
    for dx, dy in DELTAS:
        sd.step_animated(sk, dx, dy)
    for got, want in zip(_state(pv, pd), _state(sv, sd)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("sizes", [[0], [1, 2, 3, 4, 5], [7, 0, 8, 9], [4096, 1, 33]])
def test_staging_layout_is_aligned_and_exact(sizes):
    """Every staged view starts on 16 bytes and holds its array exactly,
    in its shape; segments are padded to multiples of 4 words."""
    rng = np.random.default_rng(sum(sizes))
    arrays = [rng.integers(-(2**31), 2**31, n).astype(np.int64) for n in sizes]
    arrays.append(rng.integers(-50, 50, (3, 5)).astype(np.int32))  # a banded (n_bands, n) list
    arrays.append([1 << 20, -7, 0])  # a plain list
    offsets, words = staging.layout([np.asarray(a).size for a in arrays])
    assert all(o % staging.WORDS == 0 for o in offsets) and words % staging.WORDS == 0
    views = staging.stage("cpu", *arrays)
    base = views[-1].data_ptr() - offsets[-1] * 4
    for a, v, o in zip(arrays, views, offsets):
        a = np.asarray(a)
        assert v.dtype == torch.int32 and tuple(v.shape) == a.shape and v.is_contiguous()
        assert np.array_equal(v.numpy(), a)
        if a.size:  # an empty view has no address
            assert v.data_ptr() % 16 == 0 and v.data_ptr() == base + 4 * o


def test_staging_refuses_values_beyond_int32():
    with pytest.raises(ValueError):
        staging.stage("cpu", np.asarray([2**31], np.int64))
