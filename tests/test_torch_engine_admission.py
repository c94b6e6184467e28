"""Port parity of the serving engine's admission (llmc_tpu_torch.serve
.engine): chunked prefill and the paged KV pool, held against
llmc_tpu's ServingEngine on the CPU (the same float32 weights, carried
across by convert.py; prompts from a seed with numpy), and the port's
paged engine against its own dense one."""

import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu.serve.paged_cache import PagedKVPolicy as JPaged
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.serve import (KVCachePolicy, PagedKVPolicy, Request,
                                  ServingEngine)
from torch_port_helpers import TINY, cuda_device, port_params  # noqa: F401

torch.set_num_threads(1)

POLICIES = {'fp': dict(method='fp'), 'int8': dict(method='naive', bit=8)}
BUCKETS = (16, 32)


@pytest.fixture(scope='module')
def models():
    """A float32 random Llama (TINY) in the JAX package and its port."""
    jm = JAdapter.random(JConfig(**TINY), seed=21)
    return jm, LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))


def _prompts(seed, lens=(5, 19, 30)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (p,)) for p in lens]


def _serve(engine, prompts, max_new=6, jax=False):
    """Each prompt through ``engine.run``; every request finishes with
    ``max_new`` tokens.  Returns the output ids."""
    R = JRequest if jax else Request
    reqs = [R(uid=i, prompt_ids=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    engine.run(reqs)
    assert all(r.done and len(r.output_ids) == max_new for r in reqs)
    return [[int(t) for t in r.output_ids] for r in reqs]


def _engines(models, jpol, tpol, max_len=64, **kw):
    jm, tm = models
    return (JEngine(jm, max_batch=2, max_len=max_len, kv_policy=jpol,
                    prefill_buckets=BUCKETS, **kw),
            ServingEngine(tm, max_batch=2, max_len=max_len, kv_policy=tpol,
                          prefill_buckets=BUCKETS, device='cpu', **kw))


@pytest.mark.parametrize('kv', ['fp', 'int8'])
@pytest.mark.parametrize('chunk', [8, 16])
@pytest.mark.parametrize('per_step', [1, 2])
def test_chunked_admission_tokens_equal_jax(models, kv, chunk, per_step):
    """prefill_chunk 8 and 16, one or two chunks an engine step, on fp and
    naive-int8 caches: the JAX engine's tokens, request for request, and
    the port's monolithic admission's."""
    je, te = _engines(models, JPolicy(**POLICIES[kv]),
                      KVCachePolicy(**POLICIES[kv]), prefill_chunk=chunk,
                      prefill_chunks_per_step=per_step)
    prompts = _prompts(23)
    got = _serve(te, prompts)
    assert got == _serve(je, prompts, jax=True)
    _, mono = _engines(models, JPolicy(**POLICIES[kv]),
                       KVCachePolicy(**POLICIES[kv]))
    assert got == _serve(mono, prompts)
    assert not te.pending and te.stats['prefill_forwards'] > len(prompts)


def test_chunked_admission_no_decode_stall(models):
    """While a long prompt admits chunk by chunk, an active slot emits one
    token on every engine step (the reference's test_engine.py:226)."""
    _, tm = models
    rng = np.random.RandomState(27)
    eng = ServingEngine(tm, max_batch=2, max_len=96, prefill_buckets=(8, 64),
                        prefill_chunk=8, device='cpu')
    a = Request(uid=0, prompt_ids=rng.randint(0, 128, (5,)),
                max_new_tokens=20)
    eng.submit(a)
    eng.step()                      # A admitted (one chunk) + a decode
    assert len(a.output_ids) >= 1
    b = Request(uid=1, prompt_ids=rng.randint(0, 128, (60,)),
                max_new_tokens=4)
    eng.submit(b)
    counts = []
    for _ in range(8):              # B's eight chunks of 8
        before = len(a.output_ids)
        eng.step()
        counts.append(len(a.output_ids) - before)
    assert counts == [1] * 8, counts
    assert b.output_ids, 'B got its first token when its admission ended'
    eng.run([])
    assert a.done and b.done and len(b.output_ids) == 4


@pytest.mark.parametrize('bit, n_pages', [(0, 6), (8, 8)])
def test_paged_pool_tokens_equal_jax_and_dense(models, bit, n_pages):
    """A paged pool smaller than the dense [B, max_len] allocation (8
    pages of 16), fp and int8: the JAX paged engine's tokens, the port's
    dense engine's (fp, or naive int8 for the int8 pool), and every page
    back in the free list at the end."""
    _, tm = models
    kw = dict(page_size=16, n_pages=n_pages, max_pages=4, bit=bit)
    je, te = _engines(models, JPaged(**kw), PagedKVPolicy(**kw))
    prompts = _prompts(9)
    got = _serve(te, prompts)
    assert got == _serve(je, prompts, jax=True)
    dense = ServingEngine(tm, max_batch=2, max_len=64,
                          kv_policy=KVCachePolicy(
                              **POLICIES['int8' if bit else 'fp']),
                          prefill_buckets=BUCKETS, device='cpu')
    assert got == _serve(dense, prompts)
    assert sorted(te.allocator.free) == list(range(n_pages - 1))
    assert bool((te.cache['table'] == -1).all())


def test_paged_pool_at_bit4_equals_jax(models):
    """A 4-bit paged pool (codes in -8..7 in int8 storage), which the port
    refused before: the JAX paged engine's tokens on the same requests,
    which are the ones written down for this input, and every page free
    again."""
    kw = dict(page_size=16, n_pages=32, max_pages=4, bit=4)
    je, te = _engines(models, JPaged(**kw), PagedKVPolicy(**kw))
    prompts = _prompts(3)
    got = _serve(te, prompts)
    assert got == [[120, 25, 47, 47, 47, 80], [89, 100, 100, 100, 100, 100],
                   [45, 60, 106, 125, 31, 60]]
    assert got == _serve(je, prompts, jax=True)
    assert sorted(te.allocator.free) == list(range(kw['n_pages'] - 1))


@pytest.mark.parametrize('chunk', [None, 16])
def test_paged_admission_past_max_len_serves_and_frees(models, chunk):
    """A 10-token prompt asking for 100 tokens at max_len 64: the page
    budget is capped at max_len (the reference asks for 7 of the table's 4
    pages, raises and keeps them off the free list), so the paged engine
    gives the dense engine's 54 tokens, retired at max_len - 1, and every
    page goes back; an allocation past the table row raises before any
    page leaves the free list."""
    _, tm = models
    kw = dict(page_size=16, n_pages=32, max_pages=4)
    extra = {} if chunk is None else dict(prefill_chunk=chunk)
    _, te = _engines(models, JPaged(**kw), PagedKVPolicy(**kw), **extra)
    prompt = _prompts(5, (10,))[0]
    req = Request(uid=0, prompt_ids=prompt, max_new_tokens=100)
    te.run([req])
    dense = ServingEngine(tm, max_batch=2, max_len=64,
                          kv_policy=KVCachePolicy(method='fp'),
                          prefill_buckets=BUCKETS, device='cpu', **extra)
    dreq = Request(uid=0, prompt_ids=prompt, max_new_tokens=100)
    dense.run([dreq])
    assert req.done and len(req.output_ids) == 54
    assert list(req.output_ids) == list(dreq.output_ids)
    assert sorted(te.allocator.free) == list(range(kw['n_pages'] - 1))
    with pytest.raises(ValueError, match='pages'):
        te.allocator.allocate(0, 110, te.cache['table'])
    assert sorted(te.allocator.free) == list(range(kw['n_pages'] - 1))


def test_paged_pool_exhaustion_waits(models):
    """Three usable pages, two pages a request: admission waits instead
    of overwriting live pages, every request finishes later with the JAX
    engine's tokens, and the pool is whole again."""
    kw = dict(page_size=16, n_pages=4, max_pages=4)
    je, te = _engines(models, JPaged(**kw), PagedKVPolicy(**kw), max_len=48)
    prompts = _prompts(11, (12, 14, 13))
    te.submit(Request(uid=9, prompt_ids=prompts[0], max_new_tokens=5))
    te.submit(Request(uid=8, prompt_ids=prompts[1], max_new_tokens=5))
    te.step()
    assert te.active.sum() == 1 and len(te.queue) == 1   # the second waits
    assert te.stats['pool_waits'] > 0
    te.run([])
    got = _serve(te, prompts, max_new=5)
    assert got == _serve(je, prompts, max_new=5, jax=True)
    assert len(te.allocator.free) == kw['n_pages'] - 1


@pytest.mark.parametrize('bit', [0, 8])
@pytest.mark.parametrize('K', [1, 3])
def test_paged_chunked_window_compose(models, bit, K):
    """The paged pool (fp and int8), chunked admission (a chunk of 8
    rounded up to one page) and K-step windows at once: the JAX engine's
    tokens, and the port's monolithic paged engine's (the reference's
    test_engine.py:252 and :308)."""
    kw = dict(page_size=16, n_pages=10, max_pages=4, bit=bit)
    je, te = _engines(models, JPaged(**kw), PagedKVPolicy(**kw),
                      prefill_chunk=8, decode_steps_per_sync=K)
    prompts = _prompts(31)
    got = _serve(te, prompts)
    assert got == _serve(je, prompts, jax=True)
    _, mono = _engines(models, JPaged(**kw), PagedKVPolicy(**kw))
    assert got == _serve(mono, prompts)


def test_paged_engine_refuses_buckets_off_the_page(models):
    _, tm = models
    with pytest.raises(ValueError, match='page_size'):
        ServingEngine(tm, max_batch=2, max_len=64,
                      kv_policy=PagedKVPolicy(page_size=16, n_pages=8,
                                              max_pages=4),
                      prefill_buckets=(8, 32), device='cpu')


@pytest.mark.gpu
@pytest.mark.parametrize('kv', ['paged_fp', 'paged_int8', 'int8'])
def test_engine_on_card_equals_cpu(cuda_device, models, kv):
    """The tiny float32 model (its linears torch matmuls on both devices)
    with chunked admission and K=3 windows: the card's tokens (the eager
    paged step for the pools, the captured step for the dense int8 cache)
    equal the CPU's."""
    from llmc_tpu_torch.convert import params_from_numpy
    from torch_port_helpers import to_np
    jm, tm = models
    card = LlamaAdapter(LlamaConfig(**TINY),
                        params_from_numpy(to_np(jm.params),
                                          device=cuda_device))
    pages = dict(page_size=16, n_pages=10, max_pages=4)
    pol = {'paged_fp': PagedKVPolicy(**pages),
           'paged_int8': PagedKVPolicy(bit=8, **pages),
           'int8': KVCachePolicy(**POLICIES['int8'])}[kv]
    kw = dict(max_batch=2, max_len=64, kv_policy=pol,
              prefill_buckets=BUCKETS, prefill_chunk=8,
              decode_steps_per_sync=3)
    prompts = _prompts(37)
    want = _serve(ServingEngine(tm, device='cpu', **kw), prompts)
    eng = ServingEngine(card, device=cuda_device, **kw)
    assert eng.graphed == (kv == 'int8')
    assert _serve(eng, prompts) == want
