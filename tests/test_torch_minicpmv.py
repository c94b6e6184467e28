"""MiniCPM-V in the port against the JAX package on the CPU: the 2-D
sincos positions, the perceiver resampler, the image embeddings and the
merged-modal forward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import minicpmv as JMV
from llmc_tpu_torch.models import minicpmv as TMV
from torch_port_helpers import rel_err, vlm2_pair

torch.set_num_threads(1)


@pytest.mark.parametrize('dim,grid', [(16, 3), (64, 2), (4096, 32)])
def test_pos_2d_sincos_equals_reference(dim, grid):
    np.testing.assert_allclose(TMV.pos_2d_sincos(dim, grid),
                               JMV.pos_2d_sincos(dim, grid), atol=1e-6)


def test_resample_and_image_embeds_equal_reference():
    """The resampler over random features and over the tower's within
    1e-5."""
    jm, tm = vlm2_pair('MiniCPMV', seed=8)
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 4, 32).astype(np.float32)
    want = JMV.resample(jm.params['resampler'], jm.mv_cfg,
                        jnp.asarray(feats))
    got = TMV.resample(tm.params['resampler'], tm.vl_cfg,
                       torch.as_tensor(feats))
    assert got.shape == (2, 4, 32)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
    px = rng.randn(2, 3, 28, 28).astype(np.float32)
    want = JMV.image_embeds(jm.params, jm.mv_cfg, jnp.asarray(px))
    got = TMV.image_embeds(tm.params, tm.vl_cfg, torch.as_tensor(px))
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_forward_equals_reference():
    """The forward with an image, and without, within 1e-5; the vision
    modality refused, as the reference refuses it."""
    jm, tm = vlm2_pair('MiniCPMV', seed=9)
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 68, size=(1, 10))
    ids[0, 1:5] = 70
    px = rng.randn(1, 3, 28, 28).astype(np.float32)
    want = jm.forward_logits(jnp.asarray(ids), pixel_values=jnp.asarray(px))
    got = tm.forward_logits(ids, pixel_values=px)
    assert got.shape == (1, 10, 72)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
    assert rel_err(tm.forward_logits(ids).numpy(),
                   np.asarray(jm.forward_logits(jnp.asarray(ids)))) < 1e-5
    with pytest.raises(ValueError, match='language model only'):
        tm.set_modality('vision')
