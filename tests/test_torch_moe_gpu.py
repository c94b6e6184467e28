"""The MoE and MLA families on the card (``gpu`` marker; each test skips
without a card): each family at 2 layers, bf16, the card's logits against
the port's CPU logits on the same weights and ids, the tokens whose routed
top-k set differs between the devices counted and shown, the logits of the
others within 3e-2 of the largest; Mixtral served through B2 and through B5
with their launches counted (once a layer a host decode step) and the
captured step's tokens equal to the eager step's; DeepSeek's captured
latent-cache step (fixed trip count) equal to the eager one, int8 and fp;
each family's decode held to a prefill of the same tokens as phase 18
holds it; and a planted router tie picking the lower expert index on the
card.  The comparisons are with the port's own paths: no JAX here."""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device  # noqa: F401

# two layers at widths the decode kernels take (heads of 64, GQA 2)
MX_CARD = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=64, num_local_experts=8,
               num_experts_per_tok=2, dtype='bfloat16')
QM_CARD = dict(MX_CARD, num_key_value_heads=4, intermediate_size=128,
               shared_expert_intermediate_size=512, num_local_experts=16,
               num_experts_per_tok=4)
DS_CARD = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
               moe_intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, q_lora_rank=None, kv_lora_rank=128,
               qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
               n_routed_experts=16, n_shared_experts=2, num_experts_per_tok=6,
               first_k_dense_replace=1, dtype='bfloat16')
FAMILIES = {'mixtral': ('Mixtral', MX_CARD), 'qwen2moe': ('Qwen2Moe', QM_CARD),
            'deepseek': ('DeepseekV2', DS_CARD)}
TOL = 3e-2


def _model(name, dev, seed=0):
    from llmc_tpu_torch.models import build_model
    typ, arch = FAMILIES[name]
    return build_model({'model': {'type': typ, 'arch': arch, 'seed': seed}},
                       device=dev)


def _to(model, dev):
    from llmc_tpu_torch.utils.offload import tree_to_device
    model.params = tree_to_device(model.params, dev)
    return model


def _routed_forward(model, ids):
    """The logits, and the top-k sets the routers picked (a list over the
    router calls of [tokens, k] index tensors, sorted)."""
    from chip_smoke import routed_sets
    with torch.no_grad(), routed_sets() as picks:
        logits = model.forward_logits(ids).float().cpu()
    return logits, picks


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_family_on_card_equals_cpu_on_card(cuda_device, name):
    """The same bf16 weights and ids on both devices: every token's logits
    within 3e-2 of the largest where its routing agrees in every layer;
    the tokens routed differently are counted and shown (a bf16 router's
    near-ties may flip between the devices' roundings), at most 1 in 20."""
    model = _model(name, 'cpu', seed=1)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (4, 48)))
    want, picks_cpu = _routed_forward(model, ids)
    got, picks_card = _routed_forward(_to(model, cuda_device),
                                      ids.to(cuda_device))
    assert len(picks_cpu) == len(picks_card) > 0
    same = torch.ones(ids.numel(), dtype=torch.bool)
    for a, b in zip(picks_cpu, picks_card):
        same &= (a == b).all(-1)
    n_diff = int((~same).sum())
    print(f'{name}: {n_diff} of {ids.numel()} tokens routed differently')
    assert n_diff <= ids.numel() // 20, n_diff
    rows = same.reshape(ids.shape)
    err = (got - want).abs()[rows].max() / want.abs().max()
    assert float(err) <= TOL, float(err)


def _requests(n=6, seed=0, vocab=256):
    from llmc_tpu_torch.serve import Request
    rng = np.random.RandomState(seed)
    return [Request(uid=i, prompt_ids=rng.randint(0, vocab, (int(p),)),
                    max_new_tokens=int(6 + (i * 5) % 11))
            for i, p in enumerate(rng.randint(3, 60, n))]


def _serve(model, dev, attn, eager, kv):
    from chip_smoke import attn_impl, host_decode_steps
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from llmc_tpu_torch.serve import (EagerServingEngine, KVCachePolicy,
                                      ServingEngine)
    with attn_impl(attn):
        eng = (EagerServingEngine if eager else ServingEngine)(
            model, max_batch=4, max_len=256, prefill_buckets=(16, 64),
            kv_policy=KVCachePolicy(**kv), device=dev)
        reqs = _requests()
        reset_launch_counts()
        eng.run(reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
    assert all(r.done and len(r.output_ids) == r.max_new_tokens
               for r in reqs)
    return [r.output_ids for r in reqs], counts, host_decode_steps(eng), eng


@pytest.mark.gpu
@pytest.mark.parametrize('attn,kernel', [('auto', 'flash_decode'),
                                         ('batch', 'batch_decode')])
def test_mixtral_serves_through_b2_and_b5_on_card(cuda_device, attn, kernel):
    """The attention above the MoE blocks launches B2 (``auto``) or B5
    (``batch``) once a layer a host decode step and nothing else; the
    captured step's tokens equal the eager step's."""
    model = _model('mixtral', cuda_device)
    kv = dict(method='naive', bit=8)
    out = {}
    for eager in (False, True):
        toks, counts, steps, eng = _serve(model, cuda_device, attn, eager, kv)
        assert eng.graphed != eager
        want = dict.fromkeys(counts, 0)
        want[kernel] = MX_CARD['num_hidden_layers'] * steps
        assert counts == want
        out[eager] = toks
    assert out[False] == out[True]


@pytest.mark.gpu
@pytest.mark.parametrize('kv', [dict(method='naive', bit=8),
                                dict(method='fp')], ids=['int8', 'fp'])
def test_captured_mla_step_equals_eager_on_card(cuda_device, kv):
    """DeepSeek through the latent cache: the captured step (the read
    loops over every chunk of the buffer) gives the eager step's tokens,
    and no port kernel launches."""
    model = _model('deepseek', cuda_device)
    out = {}
    for eager in (False, True):
        toks, counts, steps, eng = _serve(model, cuda_device, 'auto', eager,
                                          kv)
        assert eng.mla and eng.graphed != eager and steps > 0
        assert not any(counts.values()), counts
        out[eager] = toks
    assert out[False] == out[True]


@pytest.mark.gpu
def test_planted_router_tie_on_card(cuda_device):
    """Ties across the k-th place pick the lower expert index on the card,
    as on the CPU, in bf16 and f32."""
    from llmc_tpu_torch.models.base import top_k
    rng = np.random.RandomState(0)
    for E, K in ((8, 2), (60, 4), (64, 6)):
        x = rng.randn(512, E).astype(np.float32)
        for r in range(512):
            hi = np.sort(x[r])[::-1]
            a, b = rng.choice(E, 2, replace=False)
            x[r, a] = x[r, b] = hi[K - 1]
        for dt in (torch.float32, torch.bfloat16):
            t = torch.as_tensor(x).to(dt)
            vc, ic = top_k(t, K)
            vg, ig = top_k(t.to(cuda_device), K)
            assert torch.equal(ig.cpu(), ic)
            assert torch.equal(vg.cpu(), vc)


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_decode_equals_prefill_on_card(cuda_device, name):
    """Each family's decode over its fp and int8 caches (per-head through
    B2, DeepSeek's latent read) against one prefill of the same tokens on
    the card, as phase 18 checks it at full width: the steps routed as
    the prefill routes within the phase's bound, the 4-bit cache at least
    twice that off, B2 once a layer a step on the per-head caches."""
    from chip_smoke import moe_decode_checks
    rec = moe_decode_checks(cuda_device, _model(name, cuda_device))
    assert rec['ok'], rec
