"""The serving engine under the SinkKV policy (llmc_tpu_torch.serve.engine
with ``KVCachePolicy(method='sink')``) against the JAX package's engine
on the CPU at float32: the port's counterpart of
``tests/test_engine.py::test_engine_sink_policy_matches_lockstep``.  Each
slot masks the sinks and its own recent window at its own offset, so a
request's tokens equal the lockstep greedy decode of its prompt alone
under the same policy, whatever shares the batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve.decode import greedy_generate as j_greedy
from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu.serve.packed import pack_model as j_pack_model
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve import (KVCachePolicy, Request, ServingEngine,
                                  greedy_generate)
from llmc_tpu_torch.serve.packed import packed_qmap
from torch_port_helpers import TINY, WSPEC, port_params

torch.set_num_threads(1)

SINK = dict(method='sink', num_sink_tokens=2, window_length=8)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (p,)) for p in lengths]


def _serve(engine_cls, req_cls, model, prompts, new, **kw):
    reqs = [req_cls(uid=i, prompt_ids=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    engine_cls(model, **kw).run(reqs)
    assert all(r.done for r in reqs)
    return [list(r.output_ids) for r in reqs]


def test_engine_sink_policy_matches_jax_and_lockstep():
    """The JAX test's model, policy and prompts (long enough that the
    window evicts mid-decode): every slot's tokens equal the JAX engine's
    and the port's own lockstep greedy decode."""
    jm = JAdapter.random(JConfig(**TINY), seed=33)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    prompts = _prompts(35, (12, 15))
    kw = dict(max_batch=2, max_len=40, prefill_buckets=(16,))
    want = _serve(JEngine, JRequest, jm, prompts, 8,
                  kv_policy=JPolicy(**SINK), **kw)
    got = _serve(ServingEngine, Request, tm, prompts, 8,
                 kv_policy=KVCachePolicy(**SINK), device='cpu', **kw)
    assert got == want
    for p, toks in zip(prompts, got):
        ref = greedy_generate(tm, torch.as_tensor(p[None]), 8,
                              kv_policy=KVCachePolicy(**SINK), device='cpu')
        assert toks == ref[0, len(p):].tolist()


@pytest.mark.parametrize('window', [1, 3])
def test_packed_engine_sink_windows_match_jax(window):
    """A packed model (fused, head packed) under the sink policy, three
    requests over two slots (a slot admitted mid-decode, at another
    offset), in K-step decode windows: the tokens equal the JAX engine's
    on the same packed tree and the port's lockstep decode."""
    jm = JAdapter.random(JConfig(**TINY), seed=1)
    jq = j_pack_model(jm, JSpec(**WSPEC), fuse=True, head=True)
    cfg = LlamaConfig(**TINY)
    tm = LlamaAdapter(cfg, port_params(jm.params))
    tq = packed_qmap(cfg, QuantSpec(**WSPEC), fuse=True, pre_t=True,
                     head=True)
    prompts = _prompts(7, (14, 5, 11))
    kw = dict(max_batch=2, max_len=48, prefill_buckets=(16,),
              decode_steps_per_sync=window)
    want = _serve(JEngine, JRequest, jm, prompts, 10, qmap=jq,
                  kv_policy=JPolicy(**SINK), **kw)
    got = _serve(ServingEngine, Request, tm, prompts, 10, qmap=tq,
                 kv_policy=KVCachePolicy(**SINK), device='cpu', **kw)
    assert got == want
    for p, toks in zip(prompts, got):
        ref = j_greedy(jm, jnp.asarray(p[None]), 10, qmap=jq,
                       kv_policy=JPolicy(**SINK))
        assert toks == np.asarray(ref)[0, len(p):].tolist()
