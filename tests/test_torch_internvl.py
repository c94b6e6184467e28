"""InternVL in the port against the JAX package on the CPU: the pixel
shuffle, InternViT's blocks with layer scale and with the full-width
qk-norm, the tower, and the forward with images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import internvl as JIV
from llmc_tpu.models import llama as JL
from llmc_tpu_torch.models import internvl as TIV
from llmc_tpu_torch.models import llama as TL
from torch_port_helpers import rel_err, vlm2_pair

torch.set_num_threads(1)

IMG_TOK = 126


@pytest.mark.parametrize('shape,scale', [((2, 16, 32), 0.5),
                                         ((1, 64, 12), 0.5),
                                         ((1, 36, 8), 1 / 3)])
def test_pixel_shuffle_equals_reference(shape, scale):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(JIV.pixel_shuffle(jnp.asarray(x), scale))
    got = TIV.pixel_shuffle(torch.as_tensor(x), scale).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('qk_norm', [False, True])
def test_internvit_block_equals_reference(qk_norm):
    """One InternViT block (layer scale; with the full-width qk-norm of
    InternViT-6B, RMSNorm and no attention bias too: the case of
    tests/test_internvl.py::test_internvl_qk_norm_parity) within 1e-5."""
    jm, tm = vlm2_pair('InternVL2', seed=3, vision=dict(use_qk_norm=qk_norm))
    vc = tm.vl_cfg.vision
    assert vc.layer_scale and vc.qk_norm_full == qk_norm
    x = np.random.RandomState(3).randn(2, 17, 32).astype(np.float32)
    bp_j = jm.params['vision']['blocks'][0]
    bp_t = tm.params['vision']['blocks'][0]
    if qk_norm:
        assert bp_t['self_attn']['q_norm']['w'].shape == (32,)
    z = np.zeros((1, 1, 1, 1), np.float32)
    want = JL.block_apply(bp_j, jm.vl_cfg.vision, jnp.asarray(x), None, None,
                          attn_bias=jnp.asarray(z))[0]
    got = TL.block_apply(bp_t, vc, torch.as_tensor(x), None, None,
                         attn_bias=torch.as_tensor(z))[0]
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


@pytest.mark.parametrize('qk_norm', [False, True])
def test_forward_with_image_equals_reference(qk_norm):
    """The tower's features, the projected image tokens and the
    merged-modal forward of two prompts within 1e-5."""
    jm, tm = vlm2_pair('InternVL2', seed=4, vision=dict(use_qk_norm=qk_norm))
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 120, size=(2, 12))
    ids[:, 2:6] = IMG_TOK
    px = rng.randn(2, 3, 16, 16).astype(np.float32)
    assert tm.vl_cfg.image_seq_length == 4
    jf = JIV.image_features(jm.params, jm.vl_cfg, jnp.asarray(px))
    tf = TIV.image_features(tm.params, tm.vl_cfg, torch.as_tensor(px))
    assert tf.shape == (2, 4, 64)
    assert rel_err(tf.numpy(), np.asarray(jf)) < 1e-5
    want = jm.forward_logits(jnp.asarray(ids), pixel_values=jnp.asarray(px))
    got = tm.forward_logits(ids, pixel_values=px)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
