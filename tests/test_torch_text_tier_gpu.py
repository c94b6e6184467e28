"""OPT, the engine's SinkKV, ShadowKV and the latency eval on the card
(``gpu`` marker; each test skips without a card), at 2 layers and widths
the kernels take, the same weights on the card and on the CPU.  A packed
OPT (through its generalized view) served by the engine over an int8
cache and a packed Llama served under SinkKV: every token the card picks
is within bf16's reach of the CPU's best under teacher forcing, B1
launches once a packed linear and the head a forward, B2 once a layer a
decode step on OPT and never under SinkKV, and the captured steps give
the eager steps' tokens.  ShadowKV's PPL on the card equals the CPU's in
float32.  ``LatencyEval``'s captured decode gives its eager warm-up's
tokens, within bf16's reach of the CPU's best.  The comparisons are with
the port's own paths: no JAX here."""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device  # noqa: F401

OPT_CARD = dict(vocab_size=256, hidden_size=256, ffn_dim=512,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128, dtype='bfloat16')
LLAMA_CARD = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=64, dtype='bfloat16')
SINK = dict(method='sink', num_sink_tokens=2, window_length=8)
# a card token's CPU logit against the CPU's best, relative to the
# largest logit (tests/test_torch_families_gpu.py's bound)
TOL = 3e-2
PROMPTS = [np.random.RandomState(3).randint(0, 256, (n,))
           for n in (5, 19, 12, 30)]


def _wspec():
    from llmc_tpu_torch.quant import QuantSpec
    return QuantSpec(bit=4, symmetric=True, granularity='per_group',
                     group_size=128)


def _opt_pair(dev):
    """(CPU model, card model, QMap): a random OPT's generalized view,
    packed on the CPU and copied to the card."""
    from llmc_tpu_torch.models.adapter import OptAdapter
    from llmc_tpu_torch.utils.offload import tree_to_device
    from llmc_tpu_torch.models.opt import OptConfig
    from llmc_tpu_torch.serve import pack_model
    cpu = OptAdapter.random(OptConfig(**OPT_CARD), seed=1,
                            device='cpu').as_generalized()
    qmap = pack_model(cpu, _wspec(), fuse=True, head=True)
    return cpu, type(cpu)(cpu.cfg, tree_to_device(cpu.params, dev)), qmap


def _llama_pair(dev):
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.utils.offload import tree_to_device
    from llmc_tpu_torch.serve import pack_model
    cpu = LlamaAdapter.random(LlamaConfig(**LLAMA_CARD), seed=2,
                              device='cpu')
    qmap = pack_model(cpu, _wspec(), fuse=True, head=True)
    return cpu, type(cpu)(cpu.cfg, tree_to_device(cpu.params, dev)), qmap


def _serve(model, qmap, dev, policy, eager=True, attn='auto'):
    from llmc_tpu_torch.serve import (EagerServingEngine, Request,
                                      ServingEngine)
    from llmc_tpu_torch.serve import decode
    old, decode.ATTN_IMPL = decode.ATTN_IMPL, attn
    try:
        eng = (EagerServingEngine if eager else ServingEngine)(
            model, qmap=qmap, max_batch=2, max_len=64,
            prefill_buckets=(16, 32), kv_policy=policy, device=dev)
        reqs = [Request(uid=i, prompt_ids=p, max_new_tokens=6)
                for i, p in enumerate(PROMPTS)]
        eng.run(reqs)
    finally:
        decode.ATTN_IMPL = old
    return eng, [list(r.output_ids) for r in reqs]


def _within_reach_of_cpu(cpu, qmap, policy, toks, prompts=PROMPTS):
    """Each request teacher-forced on the CPU (one forward of its prompt
    and tokens): the tokens the card picked are within ``TOL`` of the
    CPU's best."""
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    for prompt, out in zip(prompts, toks):
        seq = np.concatenate([prompt, out[:-1]])[None]
        cache = init_cache(cpu, 1, seq.shape[1], policy, device='cpu')
        with torch.no_grad():
            logits = forward_cached(cpu.params, cpu.cfg, torch.as_tensor(seq),
                                    cache, policy, qmap)[0][0].float()
        rows = logits[len(prompt) - 1:]
        picked = rows[torch.arange(len(out)), torch.as_tensor(out)]
        gap = (rows.max(-1).values - picked) / rows.abs().max()
        assert float(gap.max()) <= TOL, gap


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['opt', 'sink'])
def test_served_on_card_against_cpu(cuda_device, case):
    """The packed OPT over an int8 cache (B2 once a layer a step) and the
    packed Llama under SinkKV (no attention kernel), each served by the
    eager engine on the card: the launches the path implies, the tokens
    within bf16's reach of the CPU's, and the captured steps' tokens equal
    to the eager ones under ``auto`` and ``batch``."""
    from llmc_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                    xla_branch_calls)
    from llmc_tpu_torch.serve import KVCachePolicy
    cpu, card, qmap = (_opt_pair if case == 'opt' else _llama_pair)(
        cuda_device)
    policy = (KVCachePolicy(method='naive', bit=8) if case == 'opt'
              else KVCachePolicy(**SINK))
    reset_launch_counts()
    eng, toks = _serve(card, qmap, cuda_device, policy)
    torch.cuda.synchronize()
    c = launch_counts()
    steps = eng.stats['decode_steps']
    assert c['w4_dequant_matmul'] == 9 * (eng.stats['prefill_forwards']
                                          + steps)
    assert c['flash_decode'] == (2 * steps if case == 'opt' else 0)
    assert c['batch_decode'] == 0 and xla_branch_calls() == 0
    _within_reach_of_cpu(cpu, qmap, policy, toks)
    for attn in ('auto', 'batch'):
        reset_launch_counts()
        graphed, graph_toks = _serve(card, qmap, cuda_device, policy,
                                     eager=False, attn=attn)
        torch.cuda.synchronize()
        assert graphed.graphed and graph_toks == _serve(
            card, qmap, cuda_device, policy, attn=attn)[1]
        if case == 'sink':
            c = launch_counts()
            assert c['flash_decode'] == 0 and c['batch_decode'] == 0


@pytest.mark.gpu
def test_shadowkv_on_card_against_cpu(cuda_device):
    """``shadowkv_decode_nll`` of a float32 model (the SVD, the retrieval's
    top-k and gathers, the re-rope) on the card equals the CPU's within
    1e-4, at a policy whose retrieval selects 4 of 11 chunks."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.utils.offload import tree_to_device
    from llmc_tpu_torch.serve.shadowkv import (ShadowKVPolicy,
                                               shadowkv_decode_nll)
    cpu = LlamaAdapter.random(LlamaConfig(**dict(LLAMA_CARD,
                                                 dtype='float32')),
                              seed=4, device='cpu')
    card = LlamaAdapter(cpu.cfg, tree_to_device(cpu.params, cuda_device))
    ids = np.random.RandomState(5).randint(0, 256, (1, 128))
    pol = ShadowKVPolicy(sparse_budget=16, chunk_size=4, rank=8,
                         outlier_chunk=3, local_chunk=2, max_gen=64)
    got, n = shadowkv_decode_nll(card, ids, pol)
    want, m = shadowkv_decode_nll(cpu, ids, pol)
    assert n == m == 64 and abs(got - want) / want <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize('batch', [1, 3])
def test_latency_captured_decode_equals_eager_on_card(cuda_device, batch):
    """``LatencyEval`` on the packed Llama: the captured G-step decode's
    tokens equal its eager warm-up's and the CPU eval's on the same
    weights, up to bf16's reach of the CPU's best; B1 (4L + 1) a
    forward and B2 once a layer a step of the counted passes (the eager
    warm-up and the capture; a replay counts nothing)."""
    from llmc_tpu_torch.eval.latency import LatencyEval
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    cpu, card, qmap = _llama_pair(cuda_device)
    P, G, iters = 12, 6, 2
    reset_launch_counts()
    ev = LatencyEval(prompt_len=P, gen_len=G, batch=batch, iters=iters)
    stats = ev.eval(card, qmap=qmap)
    torch.cuda.synchronize()
    c = launch_counts()
    assert c['w4_dequant_matmul'] == 9 * (1 + iters + 2 * G)
    assert c['flash_decode'] == 2 * 2 * G
    assert torch.equal(ev.first_tokens, ev.tokens)
    # the eval's prompts: np.random.RandomState(0), as it draws them
    prompts = np.random.RandomState(0).randint(0, 256, (batch, P))
    _within_reach_of_cpu(cpu, qmap, KVCachePolicy(method='fp'),
                         ev.tokens.tolist(), prompts)
    assert stats['ttft_p50_ms'] > 0 and stats['decode_tokens_per_s'] > 0
