"""LLaVA-OneVision in the port against the JAX package on the CPU: the
host-side anyres helpers, the packing of an image's crops (unpad, newline,
the antialiased shrink of ``anyres_max``), the image forward, and the video
branch plain, with PruneVid and with DyCoke."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import llava_onevision as JOV
from llmc_tpu_torch.models import llava_onevision as TOV
from torch_port_helpers import rel_err, vlm2_pair

torch.set_num_threads(1)

IMG_TOK, VID_TOK = 126, 127
PINPOINTS = tuple((384 * i, 384 * j) for i in range(1, 7)
                  for j in range(1, 7))


def test_anyres_helpers_equal_reference():
    """``select_best_resolution`` / ``anyres_grid_shape`` /
    ``num_patches_for`` over a grid of image sizes and OneVision's 36
    pinpoints, value for value."""
    sizes = [(h, w) for h, w in itertools.product(
        (100, 384, 500, 768, 1000, 1536, 2304), (90, 384, 640, 768, 1920))]
    for size in sizes:
        assert (TOV.select_best_resolution(size, PINPOINTS)
                == JOV.select_best_resolution(size, PINPOINTS)), size
        assert (TOV.anyres_grid_shape(size, PINPOINTS, 384)
                == JOV.anyres_grid_shape(size, PINPOINTS, 384)), size
        assert (TOV.num_patches_for(size, PINPOINTS, 384)
                == JOV.num_patches_for(size, PINPOINTS, 384)), size


def _cfgs(pinpoints, aspect='anyres_max_9'):
    jm, tm = vlm2_pair('LlavaOneVision', seed=5)
    kw = dict(image_grid_pinpoints=pinpoints, vision_aspect_ratio=aspect)
    return (dataclasses.replace(jm.vl_cfg, **kw),
            dataclasses.replace(tm.vl_cfg, **kw))


@pytest.mark.parametrize('size,pinpoints,aspect', [
    ((16, 16), ((16, 16),), 'anyres_max_9'),
    ((16, 9), ((16, 32), (32, 16), (32, 32)), 'anyres_max_9'),
    ((11, 16), ((16, 32), (32, 16), (32, 32)), 'anyres_max_9'),
    ((16, 16), ((32, 32), (48, 48)), 'anyres_max_1'),
    ((20, 40), ((16, 48), (32, 64)), 'anyres_max_2')])
def test_pack_image_features_equals_reference(size, pinpoints, aspect):
    """One image's crops packed (base, unpadded grid, newline per row; the
    grid shrunk by the reference's antialiased bilinear resize where it
    holds more than ``anyres_max_N`` crops' worth) within 1e-5."""
    jcfg, tcfg = _cfgs(pinpoints, aspect)
    n = TOV.num_patches_for(size, pinpoints, 16)
    rng = np.random.RandomState(n)
    f = rng.randn(n, 16, 24).astype(np.float32)
    nl = rng.randn(24).astype(np.float32)
    want = np.asarray(JOV.pack_image_features(jnp.asarray(f), jcfg, size,
                                              jnp.asarray(nl)))
    got = TOV.pack_image_features(torch.as_tensor(f), tcfg, size,
                                  torch.as_tensor(nl)).numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5


def test_image_forward_equals_reference():
    """The anyres image forward (a 1x2 crop grid of a 16x24 image) within
    1e-5."""
    jm, tm = vlm2_pair('LlavaOneVision', seed=6)
    pins = ((16, 16), (16, 32))
    for m in (jm, tm):
        m.vl_cfg = dataclasses.replace(m.vl_cfg, image_grid_pinpoints=pins)
    size = (16, 24)
    n = TOV.num_patches_for(size, pins, 16)
    rng = np.random.RandomState(6)
    px = rng.randn(1, n, 3, 16, 16).astype(np.float32)
    span = TOV.image_features(tm.params, tm.vl_cfg, torch.as_tensor(px[0]),
                              size).shape[0]
    ids = rng.randint(0, 120, size=(1, span + 8))
    ids[:, 2:2 + span] = IMG_TOK
    want = jm.forward_logits(jnp.asarray(ids), pixel_values=jnp.asarray(px),
                             image_sizes=[size])
    got = tm.forward_logits(ids, pixel_values=px, image_sizes=[size])
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


# tests/test_llava_onevision.py's video cases: 3 frames of 4x4 patches
# (plain, :127), 4 identical frames under PruneVid and DyCoke (:153)
@pytest.mark.parametrize('reduction,frames,same', [
    (None, 3, False),
    (dict(method='PruneVid', taus=0.5, cluster_ratios=0.5,
          temporal_segment_ratios=0.25), 4, True),
    (dict(method='PruneVid', taus=0.8, cluster_ratios=0.5,
          temporal_segment_ratios=0.5), 4, False),
    (dict(method='DyCoke', merging_ratio=0.5), 4, True),
    (dict(method='DyCoke', merging_ratio=0.3), 5, False)])
def test_video_features_equal_reference(reduction, frames, same):
    """The pooled frames (+ one newline), reduced or not: the kept-token
    count exact, the features and the forward's logits within 1e-5.  On
    identical frames DyCoke's similarities all tie at 1, so which of the
    equal tokens it keeps rests on last-bit rounding: there the count
    alone is held."""
    jm, tm = vlm2_pair('LlavaOneVision', seed=7)
    rng = np.random.RandomState(frames)
    if same:
        vids = np.repeat(rng.randn(1, 1, 3, 16, 16), frames, axis=1)
    else:
        vids = rng.randn(1, frames, 3, 16, 16)
    vids = vids.astype(np.float32)
    jf = np.asarray(JOV.video_features(jm.params, jm.vl_cfg,
                                       jnp.asarray(vids),
                                       reduction=reduction))
    tf = TOV.video_features(tm.params, tm.vl_cfg, torch.as_tensor(vids),
                            reduction=reduction).numpy()
    assert tf.shape == jf.shape
    ties = same and reduction['method'] == 'DyCoke'
    assert ties or rel_err(tf, jf) < 1e-5
    full = frames * 4 + 1
    if same:
        assert tf.shape[1] < full
    ids = np.full((1, full + 5), 3, np.int32)
    ids[0, 1:1 + full] = VID_TOK
    want = jm.forward_logits(jnp.asarray(ids), None,
                             pixel_values_videos=jnp.asarray(vids),
                             token_reduction=reduction)
    got = tm.forward_logits(ids, pixel_values_videos=vids,
                            token_reduction=reduction)
    assert got.shape == want.shape == (1, ids.shape[1] - full + tf.shape[1],
                                       128)
    assert ties or rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_unwired_video_method_raises():
    _, tm = vlm2_pair('LlavaOneVision')
    vids = np.zeros((1, 2, 3, 16, 16), np.float32)
    ids = np.full((1, 12), 3, np.int32)
    with pytest.raises(NotImplementedError, match='FastV'):
        tm.forward_logits(ids, pixel_values_videos=vids,
                          token_reduction=dict(method='FastV', keep=2))


def test_a_crop_off_the_patch_grid_raises_in_both():
    """A crop whose side is no whole number of patches (OneVision's 384
    pixels of 14: HF's patch conv reads 27 x 14 = 378 of them and drops the
    rest) raises in the reference's patch unfold, and in the port's
    (ROADMAP C)."""
    jm, tm = vlm2_pair('LlavaOneVision')
    px = np.zeros((1, 3, 18, 18), np.float32)    # 16 pixels are 4 patches
    with pytest.raises(TypeError, match='reshape'):
        JOV.siglip_embed(jm.params['vision'], jm.vl_cfg, jnp.asarray(px))
    with pytest.raises(RuntimeError, match='shape'):
        TOV.siglip_embed(tm.params['vision'], tm.vl_cfg, torch.as_tensor(px))
