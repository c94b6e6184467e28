"""The Llama-family adapters and the generalized graph on the card (``gpu``
marker; each test skips without a card): tiny packed Qwen2, Qwen3, Gemma2
and Bloom (W4 g128, fused, packed head: Gemma2's and Bloom's tied heads as
a copy of the embedding) at 2 layers, bf16, the same weights on the card
and on the CPU.  Served on the card by the eager engine over an int8
cache: every token the card picks is within bf16's reach of the CPU's
best under teacher forcing, B1 launches once a packed linear and the head
a forward, B2 once a layer a decode step only where the reference's
attn_ok lets a kernel take it (none on Gemma2's softcap and window, none
on Bloom's ALiBi), and nothing runs the XLA branch.  The captured step's
tokens equal the eager step's, under the chunked read too (whose
captured loop reads every chunk); the chunked and full reads and B5 give
B2's logits.  The comparisons are with the port's own paths: no JAX
here."""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device  # noqa: F401

# two layers at widths B1 (K a multiple of 128) and the decode kernels
# (heads of 64) take
CARD = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, dtype='bfloat16')
FAMILIES = {
    'qwen25_7b': dict(CARD, attention_bias=True, rope_theta=1e6),
    'qwen3_8b': dict(CARD, use_qk_norm=True),
    'gemma2_9b': dict(CARD, attn_logit_softcap=50.0, final_logit_softcap=30.0,
                      query_pre_attn_scalar=64.0, sliding_window=8),
    'bloom_7b1': dict(CARD, num_key_value_heads=4),
}
TAKES = ('qwen25_7b', 'qwen3_8b')
# a card token's CPU logit against the CPU's best, relative to the
# largest logit: bf16 roundings that fall otherwise through two layers
TOL = 3e-2
PROMPTS = [np.random.RandomState(3).randint(0, 256, (n,))
           for n in (5, 19, 12, 30)]


def _pair(name, dev):
    """(CPU model, card model, QMap): one packed model, copied to the
    card."""
    import chip_smoke
    from llmc_tpu_torch.utils.offload import tree_to_device
    from llmc_tpu_torch.serve import pack_model
    cpu, _ = chip_smoke.family_model(torch.device('cpu'), name, 2,
                                     FAMILIES[name])
    qmap = pack_model(cpu, chip_smoke._wspec(4), fuse=True, head=True)
    card = type(cpu)(cpu.cfg, tree_to_device(cpu.params, dev))
    return cpu, card, qmap


def _serve(model, qmap, dev, eager=True, attn='auto', K=1):
    from llmc_tpu_torch.serve import (EagerServingEngine, KVCachePolicy,
                                      Request, ServingEngine)
    from llmc_tpu_torch.serve import decode
    old, decode.ATTN_IMPL = decode.ATTN_IMPL, attn
    try:
        eng = (EagerServingEngine if eager else ServingEngine)(
            model, qmap=qmap, max_batch=2, max_len=64,
            prefill_buckets=(16, 32), kv_policy=KVCachePolicy(
                method='naive', bit=8), decode_steps_per_sync=K, device=dev)
        reqs = [Request(uid=i, prompt_ids=p, max_new_tokens=6)
                for i, p in enumerate(PROMPTS)]
        eng.run(reqs)
    finally:
        decode.ATTN_IMPL = old
    return eng, [list(r.output_ids) for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_family_served_on_card_against_cpu(cuda_device, name):
    from llmc_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                    xla_branch_calls)
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    cpu, card, qmap = _pair(name, cuda_device)
    reset_launch_counts()
    eng, toks = _serve(card, qmap, cuda_device)
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = eng.stats['decode_steps']
    forwards = eng.stats['prefill_forwards'] + steps
    assert counts['w4_dequant_matmul'] == (4 * 2 + 1) * forwards
    assert counts['flash_decode'] == (2 * steps if name in TAKES else 0)
    assert counts['batch_decode'] == 0 and xla_branch_calls() == 0
    # teacher forcing on the CPU over the same int8 cache
    policy = KVCachePolicy(method='naive', bit=8)
    for prompt, out in zip(PROMPTS, toks):
        seq = np.concatenate([prompt, out[:-1]])[None]
        cache = init_cache(cpu, 1, seq.shape[1], policy, device='cpu')
        with torch.no_grad():
            logits = forward_cached(cpu.params, cpu.cfg, torch.as_tensor(seq),
                                    cache, policy, qmap)[0][0].float()
        rows = logits[len(prompt) - 1:]
        picked = rows[torch.arange(len(out)), torch.as_tensor(out)]
        gap = (rows.max(-1).values - picked) / rows.abs().max()
        assert float(gap.max()) <= TOL, (name, gap)


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 4])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_family_graph_tokens_equal_eager_on_card(cuda_device, name, K):
    """The captured decode step, and the captured window of K = 4 steps,
    give the eager step's tokens (Gemma2's and Bloom's through the plain
    masked read inside the graph)."""
    _, card, qmap = _pair(name, cuda_device)
    eng, graph = _serve(card, qmap, cuda_device, eager=False, K=K)
    assert eng.graphed and sum(g.replays for g in eng._graphs.values()) > 0
    assert K in eng._graphs
    assert graph == _serve(card, qmap, cuda_device)[1]


@pytest.mark.gpu
@pytest.mark.parametrize('K', [1, 4])
@pytest.mark.parametrize('name', TAKES)
def test_chunked_read_graph_tokens_equal_eager_on_card(cuda_device, name, K):
    """Under ``LLMC_ATTN=chunked`` the captured step (and window of K = 4
    steps) reads every chunk of the 64-position cache, its masked tail
    included, where the eager step stops at the largest position's chunk:
    the tokens are the same, and no attention kernel launches."""
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
    _, card, qmap = _pair(name, cuda_device)
    reset_launch_counts()
    eng, graph = _serve(card, qmap, cuda_device, eager=False,
                        attn='chunked', K=K)
    torch.cuda.synchronize()
    c = launch_counts()
    assert eng.graphed and sum(g.replays for g in eng._graphs.values()) > 0
    assert K in eng._graphs
    assert c['flash_decode'] == 0 and c['batch_decode'] == 0
    assert graph == _serve(card, qmap, cuda_device, attn='chunked')[1]


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_no_attention_kernel_where_attn_ok_is_false(cuda_device, name):
    """The decode of 12 tokens under ``auto`` and ``batch``: B2 or B5 once
    a layer a step on Qwen2 and Qwen3, no attention kernel on Gemma2 and
    Bloom; ``chunked`` and ``full`` launch none and give B2's logits."""
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve import decode
    _, card, qmap = _pair(name, cuda_device)
    ids = torch.as_tensor(PROMPTS[2][None], device=cuda_device)
    outs = {}
    for attn in ('auto', 'batch', 'chunked', 'full'):
        old, decode.ATTN_IMPL = decode.ATTN_IMPL, attn
        try:
            reset_launch_counts()
            outs[attn] = decode.decode_logits(
                card, ids, qmap=qmap, device=cuda_device,
                kv_policy=KVCachePolicy(method='naive', bit=8)).float()
            torch.cuda.synchronize()
        finally:
            decode.ATTN_IMPL = old
        c = launch_counts()
        want = 2 * ids.shape[1] if name in TAKES and attn in ('auto',
                                                              'batch') else 0
        assert c['flash_decode'] == (want if attn == 'auto' else 0), attn
        assert c['batch_decode'] == (want if attn == 'batch' else 0), attn
    for attn in ('batch', 'chunked', 'full'):
        d = (outs[attn] - outs['auto']).abs().max()
        assert float(d / outs['auto'].abs().max()) <= TOL, attn
