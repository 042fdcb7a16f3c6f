"""The port's colour arithmetic against the JAX package's, bit for bit.

Every pair of bytes (x, y) in 0..255 x 0..255 feeds the tensor functions,
alpha >= 128 included (where an int32 packed word is negative and every
field read must mask).  Tolerance 0: the arithmetic is exact integer math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coherence_tpu.colour as JC
from coherence_tpu.raster import pallas_compositor as JP

import coherence_tpu_torch.colour as TC
from coherence_tpu_torch.raster import compositor as TP

from _torch_threads import one_torch_thread  # noqa: F401

_X, _Y = (a.reshape(-1) for a in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
_X = _X.astype(np.int32)
_Y = _Y.astype(np.int32)


def _pair_rgba(kind: int) -> np.ndarray:
    """(65536, 4) int32 channels built from every byte pair; alpha runs
    over all 256 values in each."""
    if kind == 0:
        return np.stack([_Y, (_X * 7 + _Y) & 255, _X ^ _Y, _X], axis=-1)
    return np.stack([_X, _Y, 255 - _X, _Y], axis=-1)


def _same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), torch_out.numpy())


def test_div255_matches_jax():
    i = np.arange(65535, dtype=np.int32)
    assert _same(JC.div255_arr(jnp.asarray(i)), TC.div255_arr(torch.from_numpy(i)))
    assert [TC.div255(int(v)) for v in i[::97]] == [JC.div255(int(v)) for v in i[::97]]


@pytest.mark.parametrize("alpha", ["pair", 0, 1, 127, 128, 254, 255])
def test_prelerp_matches_jax(alpha):
    a = (_X * 31 + _Y) & 255 if alpha == "pair" else np.full_like(_X, alpha)
    want = JC.prelerp_arr(jnp.asarray(_X), jnp.asarray(_Y), jnp.asarray(a))
    got = TC.prelerp_arr(torch.from_numpy(_X), torch.from_numpy(_Y), torch.from_numpy(a))
    assert _same(want, got)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_over_rgba_matches_jax(order):
    a, b = _pair_rgba(order[0]), _pair_rgba(order[1])
    assert _same(JC.over_rgba(jnp.asarray(a), jnp.asarray(b)), TC.over_rgba(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("kind", [0, 1])
def test_dissolve_rgba_matches_jax(kind):
    col = _pair_rgba(kind)
    # Per-pixel delta over every byte, including the 0 and 255 early outs.
    delta = (_X + _Y) & 255
    want = JC.dissolve_rgba(jnp.asarray(col), jnp.asarray(delta))
    assert _same(want, TC.dissolve_rgba(torch.from_numpy(col), torch.from_numpy(delta)))
    for d in (0, 1, 170, 255):
        assert _same(JC.dissolve_rgba(jnp.asarray(col), d), TC.dissolve_rgba(torch.from_numpy(col), d))


@pytest.mark.parametrize("kind", [0, 1])
def test_pack_unpack_matches_jax(kind):
    rgba = _pair_rgba(kind)
    want = np.asarray(JP.pack_rgba(jnp.asarray(rgba))).view(np.int32)
    got = TP.pack_rgba(torch.from_numpy(rgba))
    assert np.array_equal(got.numpy(), want)
    assert (got < 0).any()  # alpha >= 128: negative int32 words are exercised
    assert _same(JP.unpack_rgba(jnp.asarray(want.view(np.uint32))), TP.unpack_rgba(got))
    assert torch.equal(TP.unpack_rgba(got), torch.from_numpy(rgba))


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_over_packed_matches_jax(order):
    acc, layer = (np.array(JP.pack_rgba(jnp.asarray(_pair_rgba(k)))) for k in order)
    want = np.asarray(JP._over_packed(jnp.asarray(acc), jnp.asarray(layer))).view(np.int32)
    got = TP._over_packed(torch.from_numpy(acc.view(np.int32)), torch.from_numpy(layer.view(np.int32)))
    assert np.array_equal(got.numpy(), want)


def test_scalar_colours_match_jax():
    rng = np.random.default_rng(0)
    for r, g, b, a in rng.integers(0, 256, (2000, 4)):
        r, g, b, a = int(r), int(g), int(b), int(a)
        c = JC.colour_of_rgba(r, g, b, a)
        assert TC.colour_of_rgba(r, g, b, a) == c
        assert TC.rgba_of_colour(c) == JC.rgba_of_colour(c)
        d = int(rng.integers(0, 256))
        assert TC.dissolve(c, delta=d) == JC.dissolve(c, delta=d)
        # Premultiplied colours (channels <= alpha) round-trip exactly.
        r, g, b = min(r, a), min(g, a), min(b, a)
        assert TC.rgba_of_colour(TC.colour_of_rgba(r, g, b, a)) == (r, g, b, a)
    assert TC.colour_of_rgba_float(0.2, 0.5, 1.0, 0.7) == JC.colour_of_rgba_float(0.2, 0.5, 1.0, 0.7)


def test_named_colours_match_jax():
    for name in TC._NAMED:
        assert getattr(TC, name) == getattr(JC, name), name
    assert TC.white == JC.white and TC.black == JC.black and TC.clear == JC.clear
    with pytest.raises(AttributeError):
        TC.no_such_colour


_ARRAY_OPS = {
    "alpha_over": lambda C, a, b, al: C.alpha_over_rgba(a, b),
    "pd_plus": lambda C, a, b, al: C.pd_plus_rgba(a, b),
    "dissolve_between": lambda C, a, b, al: C.dissolve_between_rgba(a, b, al),
    "dissolve_between_scalar": lambda C, a, b, al: C.dissolve_between_rgba(a, b, 77),
    "monochrome": lambda C, a, b, al: C.monochrome_rgba(a),
}


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
@pytest.mark.parametrize("op", list(_ARRAY_OPS))
def test_array_ops_match_jax(op, order):
    a, b = _pair_rgba(order[0]), _pair_rgba(order[1])
    # Per-pixel alpha over every byte, with the 0 and 255 early outs.
    al = ((_X * 3 + _Y) & 255)[:, None]
    want = _ARRAY_OPS[op](JC, jnp.asarray(a), jnp.asarray(b), jnp.asarray(al))
    got = _ARRAY_OPS[op](TC, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(al))
    assert got.dtype == torch.int32
    assert _same(want, got)


def test_rgba_array_of_colour_matches_jax():
    for name in ("red", "teal", "clear", "white"):
        c = getattr(JC, name)
        assert _same(JC.rgba_array_of_colour(c), TC.rgba_array_of_colour(c, "cpu"))
    half = JC.dissolve(JC.gold, delta=128)
    assert _same(JC.rgba_array_of_colour(half), TC.rgba_array_of_colour(half, "cpu"))


_SCALAR_OPS = ["over", "alpha_over", "monochrome", "opaque", "transparent", "red_channel", "green_channel",
               "blue_channel", "unpremul_rgb", "unpremul_components", "alpha_of_colour"]


@pytest.mark.parametrize("op", _SCALAR_OPS)
def test_scalar_ops_match_jax(op):
    rng = np.random.default_rng(1)
    cols = []
    for r, g, b, a in rng.integers(0, 256, (600, 4)):
        a = int(rng.choice([0, 255, int(a)]))
        cols.append(JC.colour_of_rgba(min(int(r), a), min(int(g), a), min(int(b), a), a))
    binary = op in ("over", "alpha_over")
    for k, c in enumerate(cols):
        args = (c, cols[(k * 7 + 3) % len(cols)]) if binary else (c,)
        assert getattr(TC, op)(*args) == getattr(JC, op)(*args), (op, args)


def test_scalar_plus_dissolve_between_premul_match_jax():
    rng = np.random.default_rng(2)
    for r, g, b, a in rng.integers(0, 256, (600, 4)):
        r, g, b, a = int(r), int(g), int(b), int(a)
        assert TC.premul(r, g, b, a) == JC.premul(r, g, b, a)
        assert TC.int_mult(r, a) == JC.int_mult(r, a)
        assert TC.prelerp(r, g, a) == JC.prelerp(r, g, a)
        x = JC.colour_of_rgba(*JC.premul(r, g, b, a))
        y = JC.colour_of_rgba(*JC.premul(b, r, g, 255 - a))
        assert TC.pd_plus(x, y) == JC.pd_plus(x, y)
        al = int(rng.choice([0, 255, g]))
        assert TC.dissolve_between(a=x, b=y, alpha=al) == JC.dissolve_between(a=x, b=y, alpha=al)
    with pytest.raises(TC.Nocover):
        TC.nocover(0, 0)
    with pytest.raises(JC.Nocover):
        JC.nocover(0, 0)
