"""KV-cached VLM serving in the port (``serve/decode.py::
vlm_greedy_generate``) on the CPU, where every kernel wrapper runs its
plain version: its tokens equal the eager re-forward's and the
reference's, with no reduction and with VisionZip (a tower-side method);
an LM-side method raises; and a packed LLaVA (W4, fused qkv / gate_up, the
head packed too) serves the tokens of the same weights under the
fake-quant QMap, its prefill logits within 1e-5."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import vlm_fake_quant_twin, vlm_prefill_logits
from llmc_tpu_torch.serve.decode import vlm_greedy_generate
from torch_port_helpers import vlm_pair

torch.set_num_threads(1)
NEW = 6
VISIONZIP = {'method': 'VisionZip', 'dominant': 4, 'contextual': 2}


@pytest.fixture(scope='module')
def llava():
    return vlm_pair('Llava')


def _prompt(cfg, B=1, seed=5):
    rng = np.random.RandomState(seed)
    span = cfg.image_seq_length
    ids = rng.randint(0, 69, size=(B, span + 6)).astype(np.int32)
    ids[:, 1:1 + span] = cfg.image_token_index
    px = rng.randn(B, 3, cfg.image_size, cfg.image_size).astype(np.float32)
    return ids, px


def _eager(model, ids, px, tr, n=NEW):
    cur, toks = torch.as_tensor(ids), []
    for _ in range(n):
        nxt = model.forward_logits(cur, None, pixel_values=torch.as_tensor(px),
                                   token_reduction=tr)[:, -1].argmax(-1)
        toks.append(nxt)
        cur = torch.cat([cur, nxt[:, None].to(cur.dtype)], dim=1)
    return torch.stack(toks, 1).numpy()


@pytest.mark.parametrize('tr', [None, VISIONZIP], ids=['none', 'VisionZip'])
def test_cached_generation_matches_eager_and_reference(llava, tr):
    from llmc_tpu.serve.decode import vlm_greedy_generate as j_generate
    jm, tm = llava
    ids, px = _prompt(tm.llava_cfg)
    t = {}
    out = vlm_greedy_generate(tm, ids, NEW, pixel_values=torch.as_tensor(px),
                              token_reduction=tr, timings=t, device='cpu')
    want = np.asarray(j_generate(jm, jnp.asarray(ids), NEW,
                                 pixel_values=jnp.asarray(px),
                                 token_reduction=tr))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out[:, -NEW:].numpy(),
                                  _eager(tm, ids, px, tr))
    shrink = 0 if tr is None else tm.llava_cfg.image_seq_length - 6
    assert out.shape[1] == ids.shape[1] - shrink + NEW
    assert t['prefill_s'] > 0 and t['decode_s'] > 0


def test_cached_generation_batches_prompts(llava):
    """Two prompts at once decode as each alone."""
    _, tm = llava
    ids, px = _prompt(tm.llava_cfg, B=2, seed=6)
    both = vlm_greedy_generate(tm, ids, NEW, pixel_values=torch.as_tensor(px),
                               device='cpu')
    for b in range(2):
        one = vlm_greedy_generate(tm, ids[b:b + 1], NEW,
                                  pixel_values=torch.as_tensor(px[b:b + 1]),
                                  device='cpu')
        np.testing.assert_array_equal(both[b:b + 1].numpy(), one.numpy())


@pytest.mark.parametrize('tr', [
    {'method': 'FastV', 'prune_layer': 1, 'keep': 2},
    {'prune_layer': 1, 'keep': 2},
    {'method': 'SparseVLM', 'pruning_loc': [1]},
    {'method': 'PyramidDrop', 'layer_list': [1]},
    {'method': 'DART', 'pruning_loc': 1}])
def test_lm_side_methods_raise(llava, tr):
    _, tm = llava
    ids, px = _prompt(tm.llava_cfg)
    with pytest.raises(NotImplementedError, match='LM forward'):
        vlm_greedy_generate(tm, ids, 2, pixel_values=torch.as_tensor(px),
                            token_reduction=tr, device='cpu')


@pytest.mark.parametrize('tr', [None, VISIONZIP], ids=['none', 'VisionZip'])
def test_packed_llava_serves_the_weights_packing_holds(tr):
    """W4 g16 with fused qkv / gate_up and the head packed: the tokens of
    the fake-quant twin over the same grid, prefill logits within 1e-5
    (both plain on the CPU); the tower stays unpacked and unquantized."""
    from llmc_tpu_torch.quant.qspec import QuantSpec
    from llmc_tpu_torch.serve import pack_model
    _, tm = vlm_pair('Llava', seed=3)
    wspec = QuantSpec(bit=4, symmetric=False, granularity='per_group',
                      group_size=16)
    twin, fq_map = vlm_fake_quant_twin(tm, wspec)
    twin.params = dict(twin.params, blocks=[copy.copy(b)
                                            for b in twin.params['blocks']])
    qmap = pack_model(tm, wspec, fuse=True, head=True)
    assert 'qweight' in tm.params['blocks'][0]['self_attn']['qkv_proj']
    assert 'w' in tm.params['vision']['blocks'][0]['self_attn']['q_proj']
    ids, px = _prompt(tm.llava_cfg, seed=7)
    pxt = torch.as_tensor(px)
    got = vlm_greedy_generate(tm, ids, NEW, qmap=qmap, pixel_values=pxt,
                              token_reduction=tr, device='cpu')
    want = vlm_greedy_generate(twin, ids, NEW, qmap=fq_map, pixel_values=pxt,
                               token_reduction=tr, device='cpu')
    np.testing.assert_array_equal(got.numpy(), want.numpy())

    np.testing.assert_allclose(
        vlm_prefill_logits(tm, ids, px, qmap, tr).numpy(),
        vlm_prefill_logits(twin, ids, px, fq_map, tr).numpy(), rtol=1e-5,
        atol=1e-5)
