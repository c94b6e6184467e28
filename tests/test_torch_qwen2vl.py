"""Qwen2-VL in the port against the JAX package on the CPU: the host-side
3-D positions, M-RoPE, the 2-D-rope tower with its patch merger, the
forward with an image, a checkpoint written by ``transformers``, and a
loaded ``mrope`` config serving text through the engine."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import llama as JL
from llmc_tpu.models import qwen2vl as JQV
from llmc_tpu_torch.models import LlamaConfig
from llmc_tpu_torch.models import llama as TL
from llmc_tpu_torch.models import qwen2vl as TQV
from torch_port_helpers import VLM2_LM, rel_err, vlm2_pair

torch.set_num_threads(1)

GRID = (1, 4, 4)       # 16 patches of 4 pixels, 4 merged tokens
IMG_TOK, VSTART = 126, 125


def _inputs(rng, S=14, grid=GRID):
    n = grid[0] * grid[1] * grid[2]
    ids = rng.randint(0, 120, size=(1, S))
    ids[:, 1] = VSTART
    ids[:, 2:2 + n // 4] = IMG_TOK
    return ids, rng.randn(n, 3 * 2 * 4 * 4).astype(np.float32)


@pytest.mark.parametrize('grids', [[(1, 4, 4)], [(1, 2, 6), (2, 4, 2)],
                                   [(1, 8, 8)]])
def test_rope_index_equals_reference(grids):
    """The host-side [3, B, S] positions, bit for bit, with one image a
    row spliced at a row-dependent offset (a temporal grid too)."""
    cfg = TQV.Qwen2VLConfig(text=LlamaConfig(), vision=LlamaConfig(),
                            image_token_id=IMG_TOK)
    jcfg = JQV.Qwen2VLConfig(text=JL.LlamaConfig(), vision=JL.LlamaConfig(),
                             image_token_id=IMG_TOK)
    rng = np.random.RandomState(len(grids))
    rows = []
    S = 12 + max(t * (h // 2) * (w // 2) for t, h, w in grids)
    for b, (t, h, w) in enumerate(grids):
        n = t * (h // 2) * (w // 2)
        row = rng.randint(0, 120, size=(S,))
        row[2 + b:2 + b + n] = IMG_TOK
        rows.append(row)
    ids = np.stack(rows)
    want = JQV.rope_index(ids, grids, jcfg)
    got = TQV.rope_index(ids, grids, cfg)
    np.testing.assert_array_equal(got, want)


def test_mrope_cos_sin_and_text_rope():
    """M-RoPE's tables from three random position streams within 1e-6 of
    the reference's; on text (one position in all three streams) they
    equal the LM's plain rope bit for bit, which the cached decode of a
    ``mrope`` config runs."""
    kw = dict(VLM2_LM, rope_theta=1e6)
    tc, jc = LlamaConfig(**kw), JL.LlamaConfig(**kw)
    pos3 = np.random.RandomState(0).randint(0, 300, (3, 2, 9))
    got = TQV.mrope_cos_sin(tc, torch.as_tensor(pos3), (2, 3, 3))
    want = JQV.mrope_cos_sin(jc, jnp.asarray(pos3), (2, 3, 3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    ids = torch.zeros((2, 9), dtype=torch.long)
    text = TQV.mrope_cos_sin(tc, TQV.text_pos3(ids), (2, 3, 3))
    mcfg = LlamaConfig(**dict(kw, rope_scaling_type='mrope'))
    plain = TL.rope_cos_sin(mcfg, torch.arange(9)[None, :])
    for g, w in zip(text, plain):
        assert torch.equal(g[:1], w)


def test_vision_forward_equals_reference():
    """The tower and merger (f32) within 1e-5, the 2-D rotary tables in
    merge-window order too."""
    jm, tm = vlm2_pair('Qwen2vl', seed=1)
    _, patches = _inputs(np.random.RandomState(1))
    want = JQV.vision_forward(jm.params['vision'], jm.vl_cfg,
                              jnp.asarray(patches), GRID)
    got = TQV.vision_forward(tm.params['vision'], tm.vl_cfg,
                             torch.as_tensor(patches), GRID)
    assert got.shape == (4, 64)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
    jcs = JQV.vision_rot_cos_sin((2, 4, 6), 16, 2)
    tcs = TQV.vision_rot_cos_sin((2, 4, 6), 16, 2)
    for g, w in zip(tcs, jcs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_forward_with_image_equals_reference():
    """The merged-modal forward (image, then text only) within 1e-5."""
    jm, tm = vlm2_pair('Qwen2vl', seed=2)
    ids, patches = _inputs(np.random.RandomState(2))
    want = jm.forward_logits(jnp.asarray(ids),
                             pixel_patches=jnp.asarray(patches),
                             grid_thw=GRID)
    got = tm.forward_logits(ids, pixel_patches=patches,
                            grid_thw=np.asarray(GRID))
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5
    assert rel_err(tm.forward_logits(ids).numpy(),
                   np.asarray(jm.forward_logits(jnp.asarray(ids)))) < 1e-5


def _hf_checkpoint(path, rope_type='mrope'):
    """A tiny Qwen2VLForConditionalGeneration written by ``transformers``
    (tests/test_qwen2vl.py's shapes), its text config's rope scaling
    rewritten to the published checkpoints' form ``{type: mrope, ...}``
    (``rope_type`` names another type)."""
    tr = pytest.importorskip('transformers')
    from transformers.models.qwen2_vl.configuration_qwen2_vl import (
        Qwen2VLConfig, Qwen2VLTextConfig, Qwen2VLVisionConfig)
    vision = Qwen2VLVisionConfig(
        depth=2, embed_dim=32, num_heads=2, hidden_size=64, mlp_ratio=2,
        in_channels=3, patch_size=4, temporal_patch_size=2,
        spatial_merge_size=2)
    text = Qwen2VLTextConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_scaling={'type': 'mrope', 'mrope_section': [2, 3, 3]},
        tie_word_embeddings=False)
    cfg = Qwen2VLConfig(vision_config=vision.to_dict(),
                        text_config=text.to_dict(), image_token_id=IMG_TOK,
                        video_token_id=124, vision_start_token_id=VSTART)
    torch.manual_seed(0)
    tr.Qwen2VLForConditionalGeneration(cfg).eval().save_pretrained(
        path, safe_serialization=True)
    fn = os.path.join(path, 'config.json')
    with open(fn) as f:
        hf = json.load(f)
    for c in (hf, hf.get('text_config', {})):
        if 'rope_scaling' in c:
            c['rope_scaling'] = {'type': rope_type,
                                 'mrope_section': [2, 3, 3]}
    with open(fn, 'w') as f:
        json.dump(hf, f)
    return str(path)


@pytest.fixture(scope='module')
def qwen2vl_dir(tmp_path_factory):
    return _hf_checkpoint(tmp_path_factory.mktemp('tiny_qwen2vl'))


def test_from_pretrained_equals_reference(qwen2vl_dir):
    """Both packages' loaders on one ``transformers`` checkpoint (the fused
    ``attn.qkv`` split, the 5-D patch conv flattened): the same weights,
    and the logits with an image within 1e-5 of each other."""
    from llmc_tpu.models.adapter import Qwen2VLAdapter as JAdapter
    from llmc_tpu_torch.convert import params_to_numpy
    from llmc_tpu_torch.models.adapter import Qwen2VLAdapter
    from torch_port_helpers import assert_trees_equal, to_np
    jm = JAdapter.from_pretrained(qwen2vl_dir, dtype=jnp.float32)
    tm = Qwen2VLAdapter.from_pretrained(qwen2vl_dir, dtype=torch.float32,
                                        device='cpu')
    assert tm.cfg.rope_scaling_type == jm.cfg.rope_scaling_type == 'mrope'
    assert tm.vl_cfg.mrope_section == (2, 3, 3)
    assert_trees_equal(params_to_numpy(tm.params), to_np(jm.params))
    ids, patches = _inputs(np.random.RandomState(3))
    want = jm.forward_logits(jnp.asarray(ids),
                             pixel_patches=jnp.asarray(patches),
                             grid_thw=GRID)
    got = tm.forward_logits(ids, pixel_patches=patches, grid_thw=GRID)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_mrope_config_serves_text(qwen2vl_dir, tmp_path):
    """A loaded config whose text rope scaling is ``{type: mrope}`` serves
    text prompts through ``ServingEngine`` (an int8 cache) with the
    reference's ``greedy_generate`` tokens; a checkpoint naming an unknown
    type raises at the cached decode's rope tables
    (``test_torch_llama.py::test_unknown_rope_scaling_raises``)."""
    from llmc_tpu_torch.serve.decode import greedy_generate as t_generate
    from llmc_tpu.models.adapter import Qwen2VLAdapter as JAdapter
    from llmc_tpu.serve.decode import greedy_generate
    from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
    from llmc_tpu_torch.models.adapter import Qwen2VLAdapter
    from llmc_tpu_torch.serve import KVCachePolicy, Request, ServingEngine
    jm = JAdapter.from_pretrained(qwen2vl_dir, dtype=jnp.float32)
    tm = Qwen2VLAdapter.from_pretrained(qwen2vl_dir, dtype=torch.float32,
                                        device='cpu')
    prompts = np.random.RandomState(4).randint(0, 120, (2, 7))
    want = np.asarray(greedy_generate(jm, jnp.asarray(prompts), 6,
                                      kv_policy=JPolicy(method='naive',
                                                        bit=8)))
    eng = ServingEngine(tm, kv_policy=KVCachePolicy(method='naive', bit=8),
                        max_batch=2, max_len=16, device='cpu')
    got = eng.run([Request(uid=i, prompt_ids=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    assert [r.output_ids for r in got] == [list(w[7:]) for w in want]
    bad = Qwen2VLAdapter.from_pretrained(
        _hf_checkpoint(tmp_path, rope_type='yarn'), dtype=torch.float32,
        device='cpu')
    assert bad.cfg.rope_scaling_type == 'yarn'
    with pytest.raises(NotImplementedError, match='yarn'):
        t_generate(bad, prompts, 2, device='cpu')
