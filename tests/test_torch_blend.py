"""The port's PDF blend modes (raster/blend.py) against the JAX package's,
bit for bit.

Every separable mode sees all 256 x 256 backdrop/source byte pairs, through
the blend function itself and through the registered caf operator (the
full-coverage mix, which un-premultiplies first) at three backdrop alphas.
The float modes (SoftLight and the four non-separable ones) compute in
float32 on both sides; they must round to the same bytes.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherence_tpu.raster import blend as JB
from coherence_tpu.raster import region as JR

from coherence_tpu_torch.raster import blend as TB
from coherence_tpu_torch.raster import region as TR

from _torch_threads import one_torch_thread  # noqa: F401

_X, _Y = (a.reshape(-1).astype(np.int32) for a in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
SEPARABLE = ["Multiply", "Screen", "Overlay", "Darken", "Lighten", "ColorDodge", "ColorBurn", "HardLight",
             "SoftLight", "Difference", "Exclusion"]
NONSEPARABLE = ["Hue", "Saturation", "Color", "Luminosity"]


def _same(jax_out, torch_out):
    j, t = np.asarray(jax_out), torch_out.numpy()
    assert t.dtype == np.int32
    bad = np.argwhere(j != t)
    assert len(bad) == 0, f"{len(bad)} values differ, first at {bad[0]}: jax {j[tuple(bad[0])]}, port {t[tuple(bad[0])]}"


def test_the_same_modes_are_registered():
    assert list(TB.BLEND_MODES) == list(JB.BLEND_MODES) == SEPARABLE[:9] + SEPARABLE[9:] + NONSEPARABLE
    for name in TB.BLEND_MODES:
        assert "pdfblend_" + name in TR._CAF_OPS and "pdfblend_" + name in JR._CAF_OPS


@pytest.mark.parametrize("mode", SEPARABLE)
def test_separable_mode_all_byte_pairs(mode):
    cb, cs = _X[:, None], _Y[:, None]
    _same(JB.BLEND_MODES[mode](jnp.asarray(cb), jnp.asarray(cs)),
          TB.BLEND_MODES[mode](torch.from_numpy(cb), torch.from_numpy(cs)))


def _triples(seed):
    """(65536, 3) channel triples: every byte pair in the first two
    channels, a third that runs over all bytes too."""
    return np.stack([_X, _Y, (_X * 5 + _Y * 3 + seed) & 255], axis=-1).astype(np.int32)


@pytest.mark.parametrize("mode", NONSEPARABLE)
def test_nonseparable_mode_byte_triples(mode):
    for cb, cs in [(_triples(0), _triples(91)[:, ::-1].copy()), (_triples(17)[:, [2, 0, 1]].copy(), _triples(3))]:
        _same(JB.BLEND_MODES[mode](jnp.asarray(cb), jnp.asarray(cs)),
              TB.BLEND_MODES[mode](torch.from_numpy(cb), torch.from_numpy(cs)))


def _premul(rgb, a):
    return np.concatenate([(rgb * a) // 255, np.broadcast_to(a, rgb[..., :1].shape)], axis=-1).astype(np.int32)


@pytest.mark.parametrize("alpha", [255, 128, 37])
@pytest.mark.parametrize("mode", SEPARABLE + NONSEPARABLE)
def test_caf_operator_all_byte_pairs(mode, alpha):
    """The registered operator on premultiplied pixels: the backdrop at
    `alpha`, the source at every alpha in turn."""
    src_a = ((_X + 2 * _Y) & 255)[:, None]
    src = _premul(np.stack([_Y, _X, _Y ^ _X], axis=-1), src_a)
    back = _premul(np.stack([_X, (_X + _Y) & 255, _Y], axis=-1), np.int32(alpha))
    name = "pdfblend_" + mode
    _same(JR._CAF_OPS[name](jnp.asarray(src), jnp.asarray(back)),
          TR._CAF_OPS[name](torch.from_numpy(src), torch.from_numpy(back)))


def test_blend_through_caf_matches_jax():
    rng = np.random.default_rng(5)
    h, w = 19, 33
    out = []
    for R, mk in ((JR, lambda m, c: JR.Sprite((2, 3, 2 + w - 1, 3 + h - 1), JR._pad_mask(m), jnp.where(JR._pad_mask(m)[..., None], jnp.pad(jnp.asarray(c), ((0, JR.bucket_hw(h, w)[0] - h), (0, JR.bucket_hw(h, w)[1] - w), (0, 0))), 0))),
                  (TR, lambda m, c: TR.sprite_of_mask_rgba((2, 3, 2 + w - 1, 3 + h - 1), torch.from_numpy(m), torch.from_numpy(c)))):
        r2 = np.random.default_rng(5)
        ma, mb = r2.random((h, w)) < 0.7, r2.random((h, w)) < 0.7
        aa, ab = r2.integers(0, 256, (h, w, 1)), r2.integers(0, 256, (h, w, 1))
        ca = _premul(r2.integers(0, 256, (h, w, 3)), aa)
        cb = _premul(r2.integers(0, 256, (h, w, 3)), ab)
        spr, shp = R.caf("pdfblend_SoftLight", "opaque", mk(ma, ca), mk(mb, cb))
        out.append((spr.box, np.asarray(spr.mask)[:h, :w] if R is JR else spr.mask.numpy(),
                    np.asarray(spr.rgba)[:h, :w] if R is JR else spr.rgba.numpy(),
                    np.asarray(shp.mask)[:h, :w] if R is JR else shp.mask.numpy()))
    for j, t in zip(*out):
        assert np.array_equal(j, t)
