"""The port's exact integer blur against the JAX package's, bit for bit.

The JAX package convolves in float and splits weights into base-256 limbs
so that bf16 inputs stay exact; the port sums int32 shifted copies.  Both
must give the same integers at every radius, including 16, whose Gaussian
weights exceed 255 and so take the JAX package's limb split.  Inputs are
seeded premultiplied bytes.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherence_tpu.raster import convolve as JV
from coherence_tpu.raster import framepath as JFP

from coherence_tpu_torch.raster import convolve as TV
from coherence_tpu_torch.raster import framepath as TFP

from _torch_threads import one_torch_thread  # noqa: F401

RADII = [1, 2, 5, 16]


def _content(seed: int, h: int, w: int) -> np.ndarray:
    """(h, w, 4) int32 premultiplied RGBA with opaque, clear and
    translucent regions."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w))
    a[: h // 3] = 255
    a[h // 3 : h // 2, : w // 2] = 0
    rgb = np.minimum((rng.random((h, w, 3)) * (a[..., None] + 1)).astype(np.int64), a[..., None])
    return np.concatenate([rgb, a[..., None]], axis=-1).astype(np.int32)


def _alpha(seed: int, h: int, w: int) -> np.ndarray:
    """A filter alpha plane: zero, 255 and partial bands."""
    rng = np.random.default_rng(seed)
    fa = np.zeros((h, w), np.int32)
    fa[h // 4 :, w // 5 :] = 255
    fa[h // 4 : h // 4 + 3, w // 5 :] = rng.integers(1, 255, (3, w - w // 5))
    fa[-4:] = 0
    return fa


@pytest.mark.parametrize("radius", RADII)
def test_gaussian_kernel_matches_jax(radius):
    j, t = JV.mkgaussian(radius), TV.mkgaussian(radius)
    assert (t.radius, t.total, tuple(t.values)) == (j.radius, j.total, tuple(j.values))
    if radius == 16:
        assert max(t.values) > 255  # the JAX side takes its limb split


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("radius", RADII)
def test_conv1d_exact_matches_jax(radius, axis):
    img = _content(radius, 40, 70)
    weights = tuple(TV.mkgaussian(radius).values)
    want = JV._conv1d_exact(jnp.asarray(img), weights=weights, axis=axis)
    got = TV._conv1d_exact(torch.from_numpy(img), weights, axis)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("radius", RADII)
def test_setcanvas_xy_matches_jax(radius):
    k = TV.mkgaussian(radius)
    sums = TV._conv1d_exact(torch.from_numpy(_content(radius + 1, 30, 50)), k.values, 1)
    want = JV._setcanvas_xy(jnp.asarray(sums.numpy()), k.total)
    got = TV._setcanvas_xy(sums, k.total)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # r and g clamp to alpha; b does not (the reference's quirk).
    odd = np.asarray([[[900, 900, 900, 300]]], np.int32)
    assert TV._setcanvas_xy(torch.from_numpy(odd), 3).tolist() == [[[100, 100, 300, 100]]]
    assert np.asarray(JV._setcanvas_xy(jnp.asarray(odd), 3)).tolist() == [[[100, 100, 300, 100]]]


@pytest.mark.parametrize("radius", RADII)
def test_conv_blend_window_matches_jax(radius):
    hb, wb = 48, 128
    content = _content(10 + radius, hb, wb)
    fa = _alpha(radius, hb, wb)
    rows, cols = np.arange(hb)[:, None], np.arange(wb)[None, :]
    ry0, rx0, h, w = 2, 3, 40, 120
    inwin = (rows >= ry0) & (rows < ry0 + h) & (cols >= rx0) & (cols < rx0 + w)
    d_box = np.asarray([10, 20, 30, 90], np.int32)
    k = TV.mkgaussian(radius)
    jc, jb = JFP.conv_blend_window(
        jnp.asarray(content), jnp.asarray(fa), jnp.asarray(inwin), jnp.asarray(rows), jnp.asarray(cols),
        d_box, tuple(k.values), k.total,
    )
    tr, tcl = torch.from_numpy(rows), torch.from_numpy(cols)
    tc, tb = TFP.conv_blend_window(
        torch.from_numpy(content), torch.from_numpy(fa), torch.from_numpy(inwin), tr, tcl,
        d_box, k.values, k.total,
    )
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("radius", RADII)
def test_apply_blur_rect_matches_jax(radius):
    content = _content(20 + radius, 60, 90)
    fa = _alpha(radius + 3, 60, 90)
    k = TV.mkgaussian(radius)
    want = JFP._apply_blur_rect_kernel(jnp.asarray(content), jnp.asarray(fa), weights=tuple(k.values), total=k.total)
    got = TFP.apply_blur_rect(torch.from_numpy(content), torch.from_numpy(fa), k.values, k.total)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_blur_window_matches_jax(seed):
    rng = np.random.default_rng(seed)
    height, width = 256, 512
    logical = (1, 1, width - 10, height - 3)
    for _ in range(50):
        x0, y0 = int(rng.integers(-40, width + 20)), int(rng.integers(-40, height + 20))
        dirty = (x0, y0, x0 + int(rng.integers(0, 300)), y0 + int(rng.integers(0, 200)))
        radius = int(rng.choice(RADII))
        want = JFP.blur_window(dirty, logical, radius, height, width)
        got = TFP.blur_window(dirty, logical, radius, height, width)
        if want is None:
            assert got is None
            continue
        assert got[:9] == want[:9]
        assert np.array_equal(got[9], want[9])
