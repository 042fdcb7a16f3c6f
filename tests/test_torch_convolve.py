"""The port's convolution (raster/convolve.py) against the JAX package's,
bit for bit: the three kernel kinds over a canvas within a shape, a sprite
flattened, convolved and picked up, and the 1080p Gaussian benchmark's
inputs shrunk to 136 x 240.  The port sums int32 shifted copies; the JAX
package runs float convolutions on byte limbs; both are exact.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherence_tpu.raster import convolve as JV

from coherence_tpu_torch.raster import convolve as TV

from _torch_general import SIDES, assert_same_sprite
from _torch_threads import one_torch_thread  # noqa: F401


def _kernels(V):
    return {
        "gaussian1": V.mkgaussian(1),
        "gaussian3": V.mkgaussian(3),
        "gaussian5": V.mkgaussian(5),
        "xy_ramp": V.mkxy(2, lambda x: 3 + x),
        "unit1": V.mkunit(1),
        "unit4": V.mkunit(4),
        "full_cone": V.mkfull(2, lambda x, y: 5 - abs(x) - abs(y)),
        "full_skew": V.mkfull(1, lambda x, y: 1 + (x + 1) + 3 * (y + 1)),
    }


KERNELS = list(_kernels(JV))


def test_kernels_are_the_same_values():
    for name in KERNELS:
        j, t = _kernels(JV)[name], _kernels(TV)[name]
        assert type(j).__name__ == type(t).__name__
        assert JV.radius_of_kernel(j) == TV.radius_of_kernel(t)
        if not isinstance(j, JV.UnitKernel):
            assert (j.total, tuple(map(tuple, np.atleast_2d(j.values)))) == (t.total, tuple(map(tuple, np.atleast_2d(t.values))))
    for V in (JV, TV):
        for mk in (V.mkunit, lambda r: V.mkxy(r, abs), lambda r: V.mkfull(r, max)):
            with pytest.raises(Exception):
                mk(0)


def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 1))
    rgb = (rng.integers(0, 256, (h, w, 3)) * a) // 255
    return np.concatenate([rgb, a], -1).astype(np.int32)


def _ring(h, w):
    yy, xx = np.mgrid[:h, :w]
    d = np.hypot(yy - h / 2, xx - w / 2)
    return (d > min(h, w) / 6) & (d < min(h, w) / 3)


@pytest.mark.parametrize("mask_kind", ["all", "random", "none", "ring", "wider"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_convolve_canvas_matches_jax(kernel, mask_kind):
    """Each kind over a 37 x 53 canvas, inside a full, random, empty or
    ring mask, or a random one wider and taller than the canvas (its
    top-left corner used)."""
    h, w = 37, 53
    frame = _frame(1, h, w)
    mask = {"all": np.ones((h, w), bool), "none": np.zeros((h, w), bool),
            "random": np.random.default_rng(2).random((h, w)) < 0.6, "ring": _ring(h, w),
            "wider": np.random.default_rng(3).random((h + 3, w + 13)) < 0.6}[mask_kind]
    want = np.asarray(JV.convolve_canvas(_kernels(JV)[kernel], jnp.asarray(frame), jnp.asarray(mask)))
    got = TV.convolve_canvas(_kernels(TV)[kernel], torch.from_numpy(frame), torch.from_numpy(mask))
    assert got.dtype == torch.int32
    bad = np.argwhere((want != got.numpy()).any(-1))
    assert len(bad) == 0, f"{len(bad)} pixels differ, first {bad[0]}: jax {want[tuple(bad[0])]}, port {got.numpy()[tuple(bad[0])]}"


def test_gaussian_benchmark_inputs_chained_match_jax():
    """The 1080p Gaussian benchmark as the JAX package's benchmarks/run.py
    defines it (seed 0, radius 5, whole-frame mask, chained calls), at
    136 x 240: three chained calls."""
    rng = np.random.default_rng(0)
    H, W = 136, 240
    a = rng.integers(0, 256, (H, W, 1))
    rgb = (rng.integers(0, 256, (H, W, 3)) * a) // 255
    frame = np.concatenate([rgb, a], -1).astype(np.int32)
    jx, tx = jnp.asarray(frame), torch.from_numpy(frame)
    jm, tm = jnp.ones((H, W), dtype=bool), torch.ones((H, W), dtype=torch.bool)
    for _ in range(3):
        jx = JV.convolve_canvas(JV.mkgaussian(5), jx, jm)
        tx = TV.convolve_canvas(TV.mkgaussian(5), tx, tm)
        assert np.array_equal(np.asarray(jx), tx.numpy())


def _sprite(side, seed, x0, y0, w, h):
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < 0.7
    mask[0, 0] = mask[-1, -1] = True
    shp = side.shape_of_mask((x0, y0, x0 + w - 1, y0 + h - 1), mask)
    return side.region.fillshape(shp, side.fills.gradient((x0, y0), (x0 + w, y0 + h), True, True, side.C.red,
                                                          side.C.dissolve(side.C.blue, delta=120)))


@pytest.mark.parametrize("kernel", KERNELS)
def test_convolve_sprite_matches_jax(kernel):
    got = [side.convolve.convolve_sprite(_kernels(side.convolve)[kernel], _sprite(side, 3, -4, 6, 41, 23)) for side in SIDES]
    assert_same_sprite(got[0], got[1], kernel)
    assert all(side.convolve.convolve_sprite(_kernels(side.convolve)[kernel], None) is None for side in SIDES)


@pytest.mark.parametrize("kernel", ["gaussian3", "unit1", "full_cone"])
def test_convolve_sprite_in_shape_matches_jax(kernel):
    got = []
    for side in SIDES:
        spr = _sprite(side, 4, 10, 12, 50, 30)
        inner = side.shape_of_mask((20, 15, 49, 34), np.random.default_rng(5).random((20, 30)) < 0.8)
        pick = side.shape_of_box((15, 14, 70, 36))
        k = _kernels(side.convolve)[kernel]
        got.append((side.convolve.convolve_sprite_in_shape(k, spr, inner, pick),
                    side.convolve.convolve_sprite_in_shape(k, spr, inner, inner),
                    side.convolve.convolve_sprite_in_shape(k, spr, None, pick)))
    for k in range(3):
        assert_same_sprite(got[0][k], got[1][k], f"{kernel} {k}")
