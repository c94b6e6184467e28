"""Port parity of packed serving on the Llama-family adapters' graphs and
the generalized block graph: ``pack_model(fuse=True, head=True)`` on the
same fp weights in both packages, then the engine over an int8 cache, on
the CPU.  Qwen2 (biases in the fused q/k/v) and Starcoder untied (a
non-gated MLP: no gate / gate_up, LayerNorms with biases, learned
positions) against the reference as it is.  A tied head (Bloom, Gemma2) the
port packs as a copy of the embedding, where the reference leaves it
unpacked (ROADMAP C, "Departures the port makes on purpose"): it is held
against the reference's packing of the same model untied, its head a copy
of the embedding."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve.decode import forward_cached as j_forward_cached
from llmc_tpu.serve.decode import init_cache as j_init_cache
from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu.serve.packed import pack_model as j_pack_model
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve import (KVCachePolicy, Request, ServingEngine,
                                  pack_model)
from llmc_tpu_torch.serve.decode import forward_cached, init_cache
from torch_port_helpers import family_pair, rel_err, to_np

torch.set_num_threads(1)

INT8 = dict(method='naive', bit=8)
# BASE's widths are 32 and 64: groups of 16
WSPEC = dict(bit=4, symmetric=True, granularity='per_group', group_size=16)
# (arch, overrides): the untied cases as the reference packs them, and
# the tied ones
UNTIED = {'qwen2': ('qwen2', {}),
          'starcoder_untied': ('starcoder', dict(tie_word_embeddings=False))}
TIED = {'bloom': ('bloom', {}), 'gemma2': ('gemma2', {})}
CASES = dict(UNTIED, **TIED)
PROMPTS = [np.random.RandomState(3).randint(0, 96, (n,)) for n in (5, 9, 12)]
PACKED = ('qweight', 'scales', 'zeros', 'b')


def _untied(jm):
    """The reference's model with its tied head untied into a copy of the
    embedding (the same function unpacked)."""
    cfg = dataclasses.replace(jm.cfg, tie_word_embeddings=False)
    return JAdapter(cfg, dict(jm.params, lm_head={
        'w': jm.params['embed_tokens']['w'], 'b': None}))


_PACKED = {}


@pytest.fixture(scope='module')
def packed():
    """One packed pair per case, shared by the module's tests: (JAX model,
    its QMap, port model, its QMap)."""
    def get(name):
        if name not in _PACKED:
            arch, over = CASES[name]
            jm, tm, _ = family_pair(arch, **over)
            if name in TIED:
                assert tm.cfg.tie_word_embeddings
                jm = _untied(jm)
            jq = j_pack_model(jm, JSpec(**WSPEC), fuse=True, head=True)
            tq = pack_model(tm, QuantSpec(**WSPEC), fuse=True, head=True)
            _PACKED[name] = (jm, jq, tm, tq)
        return _PACKED[name]
    yield get
    _PACKED.clear()


@pytest.mark.parametrize('name', sorted(CASES))
def test_packed_trees_bit_equal_to_jax(packed, name):
    """The same packed bytes, scales, folded zeros and biases in every
    block linear and the head, and the same QMeta: a fused q/k/v carries
    Qwen2's biases, a non-gated MLP has no gate and no gate_up."""
    jm, jq, tm, tq = packed(name)
    jp = to_np(jm.params)
    for i, (tb, jb) in enumerate(zip(tm.blocks, jp['blocks'])):
        for comp in ('self_attn', 'mlp'):
            assert sorted(tb[comp]) == sorted(jb[comp]), (i, comp)
            for lname, lin in tb[comp].items():
                if 'qweight' not in lin:
                    continue
                path = f'{comp}.{lname}'
                for k in PACKED:
                    if jb[comp][lname].get(k) is None:
                        assert lin.get(k) is None, (i, path, k)
                    else:
                        np.testing.assert_array_equal(
                            lin[k].numpy(), jb[comp][lname][k])
                assert (tq.get(path).qmeta.__dict__
                        == jq.get(path).qmeta.__dict__), path
    if tm.cfg.gated_mlp:
        assert 'gate_up_proj' in tm.blocks[0]['mlp']
    else:
        assert 'gate_proj' not in tm.blocks[0]['mlp']
        assert 'gate_up_proj' not in tm.blocks[0]['mlp']
    if tm.cfg.attention_bias:
        assert tm.blocks[0]['self_attn']['qkv_proj']['b'] is not None
    for k in ('qweight', 'scales', 'zeros'):
        np.testing.assert_array_equal(tm.params['lm_head'][k].numpy(),
                                      jp['lm_head'][k])
    assert (tq.get('lm_head').qmeta.__dict__
            == jq.get('lm_head').qmeta.__dict__)


@pytest.mark.parametrize('name', sorted(CASES))
def test_packed_prefill_decode_logits_match_jax(packed, name):
    """A prefill and three decode steps over the int8 cache through the
    packed linears and the packed head: within 1e-5 relative."""
    jm, jq, tm, tq = packed(name)
    ids = np.random.RandomState(0).randint(0, 96, (2, 6))
    jp, tp = JPolicy(**INT8), KVCachePolicy(**INT8)
    jc = j_init_cache(jm, 2, 16, jp)
    tc = init_cache(tm, 2, 16, tp, device='cpu')
    jl, jc = j_forward_cached(jm.params, jm.cfg, jnp.asarray(ids), jc, jp,
                              jq)
    tl, tc = forward_cached(tm.params, tm.cfg, torch.as_tensor(ids), tc, tp,
                            tq)
    assert rel_err(tl.numpy(), jl) < 1e-5
    for _ in range(3):
        tok = np.asarray(jl[:, -1].argmax(-1))[:, None]
        jl, jc = j_forward_cached(jm.params, jm.cfg, jnp.asarray(tok), jc,
                                  jp, jq)
        tl, tc = forward_cached(tm.params, tm.cfg, torch.as_tensor(tok), tc,
                                tp, tq)
        assert rel_err(tl.numpy(), jl) < 1e-5


@pytest.mark.parametrize('name', sorted(CASES))
def test_packed_engine_tokens_equal_jax(packed, name):
    """The engine over an int8 cache (bucketed admission, per-slot
    positions, retirement) on the packed model gives the JAX engine's
    greedy tokens on its packed model."""
    jm, jq, tm, tq = packed(name)
    kw = dict(max_batch=2, max_len=32, prefill_buckets=(8, 16))
    want = JEngine(jm, qmap=jq, kv_policy=JPolicy(**INT8), **kw).run(
        [JRequest(uid=i, prompt_ids=p, max_new_tokens=5 + i)
         for i, p in enumerate(PROMPTS)])
    got = ServingEngine(tm, qmap=tq, kv_policy=KVCachePolicy(**INT8),
                        device='cpu', **kw).run(
        [Request(uid=i, prompt_ids=p, max_new_tokens=5 + i)
         for i, p in enumerate(PROMPTS)])
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert all(r.done for r in got)


@pytest.mark.parametrize('head', [True, False])
def test_random_packed_llama_packs_a_tied_head(head):
    """``random_packed_llama`` follows ``pack_model``'s rule: ``head``
    packs the head of a tied model too, and its QMap names it; without
    ``head`` the tied head reads the embedding."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.serve import random_packed_llama
    from torch_port_helpers import BASE
    cfg = LlamaConfig(**dict(BASE, tie_word_embeddings=True))
    m, q = random_packed_llama(cfg, QuantSpec(**WSPEC), fuse=True,
                               head=head, device='cpu')
    assert ('qweight' in m.params['lm_head']) is head
    assert (q.get('lm_head') is not None) is head
    ids = torch.as_tensor(PROMPTS[0][None])
    cache = init_cache(m, 1, 8, KVCachePolicy(**INT8), device='cpu')
    logits, _ = forward_cached(m.params, m.cfg, ids, cache,
                               KVCachePolicy(**INT8), q)
    assert logits.shape == (1, 5, 96) and bool(torch.isfinite(logits).all())
