"""The port's dense layer-stack compositor against the JAX package's (K5:
``composite_layers_packed`` in interpret mode, and its XLA twin
``composite_layers_xla``), bit for bit.

Inputs: the random stacks of tests/test_pallas.py, a stack with an opaque
top layer, and benchmarks/run.py config 2's stack of rectangles at a small
size (``examples.hsr_layers``), which is also held against run.py's own
numpy construction.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from coherence_tpu.raster import pallas_compositor as PC

from coherence_tpu_torch import convert
from coherence_tpu_torch.raster import compositor as TPC
from coherence_tpu_torch.scene import examples as TE

from _torch_threads import one_torch_thread  # noqa: F401


def random_layers(rng, K, H, W, density=0.6):
    """tests/test_pallas.py's random premultiplied stack, (K, H, W, 4)."""
    a = rng.integers(0, 256, (K, H, W, 1))
    rgb = (rng.integers(0, 256, (K, H, W, 3)) * a) // 255
    layers4 = np.concatenate([rgb, a], -1).astype(np.int32)
    m = rng.random((K, H, W)) < density
    return np.where(m[..., None], layers4, 0)


def _both(bg_words: np.ndarray, layer_words: np.ndarray):
    """(port output, JAX Pallas output, JAX XLA output) as uint32 arrays."""
    bg, layers = jnp.asarray(bg_words), jnp.asarray(layer_words)
    pallas = np.asarray(PC.composite_layers_packed(bg, layers, interpret=True))
    xla = np.asarray(PC.composite_layers_xla(bg, layers))
    got = TPC.composite_layers(convert.packed(bg_words, "cpu"), convert.layers(layer_words, "cpu"))
    return got.numpy().view(np.uint32), pallas, xla


@pytest.mark.parametrize("seed,K,nty,ntx,opaque_bg", [
    (2, 5, 2, 2, True), (3, 1, 1, 1, True), (4, 8, 1, 3, False), (5, 3, 3, 1, True),
])
def test_composite_layers_matches_jax(seed, K, nty, ntx, opaque_bg):
    rng = np.random.default_rng(seed)
    H, W = nty * PC.TILE_H, ntx * PC.TILE_W
    layers4 = random_layers(rng, K, H, W)
    bg4 = random_layers(rng, 1, H, W, density=1.0)[0]
    if opaque_bg:
        bg4[..., 3] = 255
    got, pallas, xla = _both(np.asarray(PC.pack_rgba(jnp.asarray(bg4))), np.asarray(PC.pack_rgba(jnp.asarray(layers4))))
    assert np.array_equal(pallas, xla)
    assert np.array_equal(got, xla)


def test_composite_layers_opaque_top_matches_jax():
    rng = np.random.default_rng(7)
    K, H, W = 4, PC.TILE_H, 2 * PC.TILE_W
    layers4 = random_layers(rng, K, H, W)
    layers4[0, :, :, 3] = 255
    layers4[0, :, :, :3] = np.minimum(layers4[0, :, :, :3], 255)
    words = np.asarray(PC.pack_rgba(jnp.asarray(layers4)))
    bg = np.zeros((H, W), np.uint32)
    got, pallas, xla = _both(bg, words)
    assert np.array_equal(got, xla) and np.array_equal(pallas, xla)
    assert np.array_equal(got, words[0])


def _run_py_stack(K, H, W, seed=0):
    """benchmarks/run.py config 2's construction in numpy, with its
    rectangle bounds scaled to an H x W frame as hsr_rects scales them."""
    rng = np.random.default_rng(seed)
    sx, sy = (lambda v: v * W // 1920), (lambda v: v * H // 1088)
    layers4 = np.zeros((K, H, W, 4), np.int32)
    for k in range(K):
        x0, y0 = rng.integers(0, W - sx(600)), rng.integers(0, H - sy(500))
        w, h = rng.integers(sx(150), sx(600)), rng.integers(sy(150), sy(500))
        a = 255 if k % 2 == 0 else 128
        col = (rng.integers(0, 256, 3) * a) // 255
        layers4[k, y0 : y0 + h, x0 : x0 + w, :3] = col
        layers4[k, y0 : y0 + h, x0 : x0 + w, 3] = a
    return np.asarray(PC.pack_rgba(jnp.asarray(layers4)))


@pytest.mark.parametrize("seed", [0, 1])
def test_hsr_layers_matches_run_py_and_jax(seed):
    K, H, W = 12, 128, 256
    want = _run_py_stack(K, H, W, seed)
    stack = TE.hsr_layers(K, H, W, seed, device="cpu")
    assert np.array_equal(stack.numpy().view(np.uint32), want)
    white = np.full((H, W), 0xFFFFFFFF, np.uint32)
    got, pallas, xla = _both(white, want)
    assert np.array_equal(got, xla) and np.array_equal(pallas, xla)


def test_hsr_rects_at_full_size_are_run_py_draws():
    """At 1920x1088 the stack's rectangles are run.py config 2's, draw for
    draw (only the draws: the full stack takes 835.6 MB)."""
    rng = np.random.default_rng(0)
    want = []
    for k in range(100):
        x0, y0 = rng.integers(0, 1920 - 600), rng.integers(0, 1088 - 500)
        w, h = rng.integers(150, 600), rng.integers(150, 500)
        a = 255 if k % 2 == 0 else 128
        col = (rng.integers(0, 256, 3) * a) // 255
        want.append((int(x0), int(y0), int(w), int(h), tuple(int(v) for v in col), a))
    assert TE.hsr_rects(100, 1088, 1920) == want


def test_convert_layers_keeps_the_bits():
    words = np.random.default_rng(0).integers(0, 2**32, (3, 64, 128), dtype=np.uint64).astype(np.uint32)
    t = convert.layers(words, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(t.numpy().view(np.uint32), words)
    with pytest.raises(ValueError):
        convert.layers(words[0], "cpu")
