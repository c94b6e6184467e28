"""Packed serving of Qwen2-VL, InternVL, LLaVA-OneVision and MiniCPM-V in
the port on the CPU, where every kernel wrapper runs its plain version:
``pack_model`` packs the LM's blocks (W4 g16, fused qkv / gate_up) and its
head and leaves the tower as it is; the packed eager forward with an image
(or a video) gives the logits of the same weights under the fake-quant
QMap within 1e-5; Qwen2-VL's packed LM serves text through the engine
with the twin's tokens."""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import vlm_fake_quant_twin
from torch_port_helpers import vlm2_pair

torch.set_num_threads(1)


def image_inputs(model_type, cfg, seed=0):
    """(ids, the forward's image kwargs) of one prompt, numpy."""
    rng = np.random.RandomState(seed)
    if model_type == 'Qwen2vl':
        ids = rng.randint(0, 120, (1, 14))
        ids[:, 1] = cfg.vision_start_token_id
        ids[:, 2:6] = cfg.image_token_id
        return ids, dict(pixel_patches=rng.randn(16, cfg.patch_dim).astype(
            np.float32), grid_thw=(1, 4, 4))
    if model_type == 'LlavaOneVision-video':
        span = 3 * 4 + 1
        ids = rng.randint(0, 120, (1, span + 5))
        ids[:, 1:1 + span] = cfg.video_token_index
        return ids, dict(pixel_values_videos=rng.randn(
            1, 3, 3, 16, 16).astype(np.float32))
    if model_type == 'LlavaOneVision':
        span = 16 + 4 * 5       # the base crop and one 1x1 grid crop
        ids = rng.randint(0, 120, (1, span + 6))
        ids[:, 2:2 + span] = cfg.image_token_index
        return ids, dict(pixel_values=rng.randn(1, 2, 3, 16, 16).astype(
            np.float32), image_sizes=[(16, 16)])
    tok = getattr(cfg, 'image_token_id', None) or cfg.image_token_index
    span = 4
    ids = rng.randint(0, 68, (1, span + 7))
    ids[:, 1:1 + span] = tok
    return ids, dict(pixel_values=rng.randn(
        1, 3, cfg.image_size, cfg.image_size).astype(np.float32))


def _pair(case, seed=0):
    """(JAX, port) models of a case; OneVision with one 16-pixel
    pinpoint (a base crop and a 1x1 grid)."""
    import dataclasses
    jm, tm = vlm2_pair(case.split('-')[0], seed=seed)
    if case.startswith('LlavaOneVision'):
        for m in (jm, tm):
            m.vl_cfg = dataclasses.replace(m.vl_cfg,
                                           image_grid_pinpoints=((16, 16),))
    return jm, tm


CASES = ('Qwen2vl', 'InternVL2', 'LlavaOneVision', 'LlavaOneVision-video',
         'MiniCPMV')


def _wspec():
    from llmc_tpu_torch.quant.qspec import QuantSpec
    return QuantSpec(bit=4, symmetric=False, granularity='per_group',
                     group_size=16)


@pytest.mark.parametrize('case', CASES)
def test_packed_forward_equals_the_weights_packing_holds(case):
    """The packed LM (fused qkv / gate_up, the head packed) in the eager
    forward with an image: the fake-quant twin's logits within 1e-5; the
    tower stays unpacked."""
    from llmc_tpu_torch.serve import pack_model
    _, tm = _pair(case, seed=3)
    twin, fq_map = vlm_fake_quant_twin(tm, _wspec())
    twin.params = dict(twin.params, blocks=[copy.copy(b)
                                            for b in twin.params['blocks']])
    qmap = pack_model(tm, _wspec(), fuse=True, head=True)
    assert 'qweight' in tm.params['blocks'][0]['self_attn']['qkv_proj']
    assert 'qweight' in tm.params['lm_head']
    assert 'w' in tm.params['vision']['blocks'][0]['self_attn']['q_proj']
    ids, img = image_inputs(case, tm.vl_cfg, seed=4)
    with torch.no_grad():
        got = tm.forward_logits(ids, qmap=qmap, **img)
        want = twin.forward_logits(ids, qmap=fq_map, **img)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_packed_qwen2vl_serves_text():
    """Qwen2-VL's packed LM (an ``mrope`` config) through the engine over
    an int8 cache: the fake-quant twin's tokens."""
    from llmc_tpu_torch.serve import (KVCachePolicy, Request, ServingEngine,
                                      pack_model)
    import dataclasses
    _, tm = _pair('Qwen2vl', seed=5)
    cfg = dataclasses.replace(tm.vl_cfg, text=dataclasses.replace(
        tm.vl_cfg.text, rope_scaling_type='mrope'))
    tm = type(tm)(cfg, tm.params)
    twin, fq_map = vlm_fake_quant_twin(tm, _wspec())
    twin.params = dict(twin.params, blocks=[copy.copy(b)
                                            for b in twin.params['blocks']])
    qmap = pack_model(tm, _wspec(), fuse=True, head=True)
    prompts = np.random.RandomState(6).randint(0, 120, (2, 9))
    outs = []
    for m, q in ((tm, qmap), (twin, fq_map)):
        eng = ServingEngine(m, qmap=q, kv_policy=KVCachePolicy(
            method='naive', bit=8), max_batch=2, max_len=24, device='cpu')
        outs.append([r.output_ids for r in eng.run(
            [Request(uid=i, prompt_ids=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])])
    assert outs[0] == outs[1] and all(len(o) == 6 for o in outs[0])
