"""Port parity of the serving slice (llmc_tpu_torch.serve): packed
weights, forward_cached prefill/decode, greedy_generate and the
ServingEngine, held against llmc_tpu on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve.decode import forward_cached as j_forward_cached
from llmc_tpu.serve.decode import greedy_generate as j_greedy
from llmc_tpu.serve.decode import init_cache as j_init_cache
from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu.serve.packed import pack_model as j_pack_model
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve import (KVCachePolicy, Request, ServingEngine,
                                  greedy_generate, pack_model,
                                  random_packed_llama)
from llmc_tpu_torch.serve.decode import forward_cached, init_cache
from llmc_tpu_torch.serve.packed import packed_qmap
from torch_port_helpers import (TINY, WSPEC, cuda_device,  # noqa: F401
                                port_params, rel_err, to_np)

torch.set_num_threads(1)

POLICIES = {'fp': dict(method='fp'), 'int8': dict(method='naive', bit=8)}


@pytest.fixture(scope='module')
def packed_pair():
    """One JAX packed model (fuse, pre_t, head) and the port's copy of
    the same packed tree, carried across by the converter."""
    jm = JAdapter.random(JConfig(**TINY), seed=0)
    jq = j_pack_model(jm, JSpec(**WSPEC), fuse=True, head=True)
    cfg = LlamaConfig(**TINY)
    tm = LlamaAdapter(cfg, port_params(jm.params))
    tq = packed_qmap(cfg, QuantSpec(**WSPEC), fuse=True, pre_t=True,
                     head=True)
    return jm, jq, tm, tq


def test_port_pack_model_bit_equal_to_jax():
    """pack_model(fuse, head) on the same fp weights gives the same
    packed bytes, scales and folded zeros, and the same QMap."""
    jm = JAdapter.random(JConfig(**TINY), seed=1)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    jq = j_pack_model(jm, JSpec(**WSPEC), fuse=True, head=True)
    tq = pack_model(tm, QuantSpec(**WSPEC), fuse=True, head=True)
    jp = to_np(jm.params)
    for path in ('self_attn.qkv_proj', 'self_attn.o_proj',
                 'mlp.gate_up_proj', 'mlp.down_proj'):
        a, b = path.split('.')
        for i in range(TINY['num_hidden_layers']):
            for k in ('qweight', 'scales', 'zeros'):
                np.testing.assert_array_equal(
                    tm.blocks[i][a][b][k].numpy(), jp['blocks'][i][a][b][k])
        assert tq.get(path).qmeta.__dict__ == jq.get(path).qmeta.__dict__
    for k in ('qweight', 'scales', 'zeros'):
        np.testing.assert_array_equal(tm.params['lm_head'][k].numpy(),
                                      jp['lm_head'][k])


@pytest.mark.parametrize('kv', ['fp', 'int8'])
def test_forward_cached_prefill_decode_logits(packed_pair, kv):
    """Prefill then two decode steps: f32 logits within 1e-5 relative
    (plain f32 math in both; only summation order differs)."""
    jm, jq, tm, tq = packed_pair
    jp, tp = JPolicy(**POLICIES[kv]), KVCachePolicy(**POLICIES[kv])
    ids = np.random.RandomState(0).randint(0, 128, (2, 6))
    jc = j_init_cache(jm, 2, 10, jp)
    tc = init_cache(tm, 2, 10, tp, device='cpu')
    jl, jc = j_forward_cached(jm.params, jm.cfg, jnp.asarray(ids), jc, jp,
                              jq)
    tl, tc = forward_cached(tm.params, tm.cfg, torch.as_tensor(ids), tc, tp,
                            tq)
    assert rel_err(tl.numpy(), jl) < 1e-5
    tok = np.asarray(jl[:, -1].argmax(-1))
    for _ in range(2):
        jl, jc = j_forward_cached(jm.params, jm.cfg,
                                  jnp.asarray(tok)[:, None], jc, jp, jq)
        tl, tc = forward_cached(tm.params, tm.cfg,
                                torch.as_tensor(tok)[:, None], tc, tp, tq)
        assert rel_err(tl.numpy(), jl) < 1e-5
        tok = np.asarray(jl[:, -1].argmax(-1))
    assert tc['pos'] == 8


@pytest.mark.parametrize('kv', ['fp', 'int8'])
def test_greedy_generate_tokens_equal_jax(packed_pair, kv):
    jm, jq, tm, tq = packed_pair
    ids = np.random.RandomState(0).randint(0, 128, (2, 7))
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), 6, qmap=jq,
                               kv_policy=JPolicy(**POLICIES[kv])))
    got = greedy_generate(tm, torch.as_tensor(ids), 6, qmap=tq,
                          kv_policy=KVCachePolicy(**POLICIES[kv]),
                          device='cpu')
    np.testing.assert_array_equal(got.numpy(), want)


# Fixed prompts.  An int8 KV code is a rounding of k / s: a one-ulp
# difference in an f32 reduction (rms_norm's mean, which XLA and torch
# sum in different orders) can flip a code that sits on a rounding tie,
# so token equality is asserted on fixed data.
ENGINE_PROMPT_LENS = (5, 9, 12, 6, 14)


def _prompts(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)) for n in ENGINE_PROMPT_LENS]


def test_engine_greedy_tokens_equal_jax(packed_pair):
    """ServingEngine with int8 KV: per-slot positions, bucketed admission
    (batched same-bucket prefill) and retirement give the JAX engine's
    tokens, request for request."""
    jm, jq, tm, tq = packed_pair
    prompts = _prompts()
    je = JEngine(jm, qmap=jq, max_batch=3, max_len=48,
                 prefill_buckets=(8, 16), kv_policy=JPolicy(**POLICIES['int8']))
    want = je.run([JRequest(uid=i, prompt_ids=p, max_new_tokens=5 + i)
                   for i, p in enumerate(prompts)])
    te = ServingEngine(tm, qmap=tq, max_batch=3, max_len=48,
                       prefill_buckets=(8, 16),
                       kv_policy=KVCachePolicy(**POLICIES['int8']),
                       device='cpu')
    got = te.run([Request(uid=i, prompt_ids=p, max_new_tokens=5 + i)
                  for i, p in enumerate(prompts)])
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert all(r.done for r in got)
    assert te.stats['prefill_forwards'] < len(prompts)   # a batched group


def _engine(tm, tq, K=1, temperature=0.0, max_batch=2):
    return ServingEngine(tm, qmap=tq, max_batch=max_batch, max_len=48,
                         prefill_buckets=(8, 16), seed=11,
                         temperature=temperature, top_p=0.9,
                         kv_policy=KVCachePolicy(**POLICIES['int8']),
                         decode_steps_per_sync=K, device='cpu')


@pytest.mark.parametrize('temperature', [0.0, 0.8])
def test_engine_window_equals_single_steps(packed_pair, temperature):
    """K-step windows emit exactly the tokens of K single steps."""
    _, _, tm, tq = packed_pair
    outs = []
    for K in (1, 4):
        reqs = [Request(uid=i, prompt_ids=p, max_new_tokens=9)
                for i, p in enumerate(_prompts(5)[:3])]
        _engine(tm, tq, K, temperature).run(reqs)
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]


def test_engine_sampling_independent_of_co_scheduling(packed_pair):
    """A request's sampled tokens depend on (seed, admission nonce,
    generated index) only: alone or beside another request, the first
    admitted request samples the same tokens."""
    _, _, tm, tq = packed_pair
    p = _prompts(7)
    alone = [Request(uid=0, prompt_ids=p[0], max_new_tokens=8)]
    _engine(tm, tq, temperature=1.0, max_batch=1).run(alone)
    both = [Request(uid=0, prompt_ids=p[0], max_new_tokens=8),
            Request(uid=1, prompt_ids=p[1], max_new_tokens=8)]
    _engine(tm, tq, temperature=1.0, max_batch=2).run(both)
    assert alone[0].output_ids == both[0].output_ids


@pytest.mark.parametrize('kw', [dict(prefill_chunk=8), dict(mesh=object()),
                                dict(prefill_w8=True), dict(decode_w8=True)])
def test_engine_unported_options_raise(packed_pair, kw):
    """Unported engine options raise instead of being ignored; so do
    prefill_w8 / decode_w8 with qmap=None (ValueError), which the
    reference ignores silently."""
    _, _, tm, _ = packed_pair
    err = (ValueError if 'prefill_w8' in kw or 'decode_w8' in kw
           else NotImplementedError)
    with pytest.raises(err):
        ServingEngine(tm, qmap=None, max_batch=2, max_len=48, device='cpu',
                      **kw)


def test_device_none_raises_without_card(packed_pair):
    """device=None means the card; without one the entry points raise
    rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: device=None is valid here')
    _, _, tm, tq = packed_pair
    cfg = LlamaConfig(**TINY)
    with pytest.raises(RuntimeError, match='CUDA'):
        ServingEngine(tm, qmap=tq, max_batch=2, max_len=48)
    with pytest.raises(RuntimeError, match='CUDA'):
        greedy_generate(tm, torch.zeros((1, 3), dtype=torch.long), 2,
                        qmap=tq)
    with pytest.raises(RuntimeError, match='CUDA'):
        random_packed_llama(cfg, QuantSpec(**WSPEC))
    with pytest.raises(RuntimeError, match='CUDA'):
        init_cache(tm, 1, 8)


def test_random_packed_llama_is_unsigned_and_seeded():
    cfg = dataclasses.replace(LlamaConfig(**TINY), dtype='bfloat16')
    m1, q1 = random_packed_llama(cfg, QuantSpec(**WSPEC), seed=3,
                                 fuse=True, device='cpu')
    m2, _ = random_packed_llama(cfg, QuantSpec(**WSPEC), seed=3, fuse=True,
                                device='cpu')
    qkv = m1.blocks[0]['self_attn']['qkv_proj']
    assert qkv['qweight'].dtype == torch.uint8
    assert qkv['qweight'].shape == (128, 32)
    assert torch.equal(qkv['qweight'],
                       m2.blocks[0]['self_attn']['qkv_proj']['qweight'])
    assert q1.get('lm_head').qmeta.pre_t
    torch.testing.assert_close(qkv['zeros'], qkv['scales'] * 8.0)


@pytest.mark.gpu
@pytest.mark.parametrize('impl, kernel', [('flash', 'flash_decode'),
                                          ('batch', 'batch_decode')])
def test_float32_model_decodes_on_card(cuda_device, monkeypatch, impl,
                                       kernel):
    """A float32 Llama keeps a float32 KV cache (the fp policy caches in
    the model's dtype, and greedy_generate takes it by default): on the
    card each decode step's attention launches the hand kernel on that
    cache (it raised before), and the greedy tokens equal the CPU's, under
    ``serve.decode.ATTN_IMPL`` = 'flash' and then 'batch'."""
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
    from llmc_tpu_torch.serve import decode as D
    cfg = LlamaConfig(**TINY)
    assert cfg.dtype == 'float32'
    from llmc_tpu_torch.convert import params_from_numpy
    jm = JAdapter.random(JConfig(**TINY), seed=5)
    cpu = LlamaAdapter(cfg, port_params(jm.params))
    card = LlamaAdapter(cfg, params_from_numpy(to_np(jm.params),
                                               device=cuda_device))
    ids = np.random.RandomState(6).randint(0, 128, (2, 9))
    monkeypatch.setattr(D, 'ATTN_IMPL', impl)
    want = greedy_generate(cpu, torch.as_tensor(ids), 6, device='cpu')
    reset_launch_counts()
    got = greedy_generate(card, torch.as_tensor(ids), 6,
                          device=cuda_device)
    torch.cuda.synchronize()
    layers = TINY['num_hidden_layers']
    assert launch_counts()[kernel] == 5 * layers
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())

