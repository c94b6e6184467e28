"""Port parity of the serving engine on the Llama-family adapters' graphs
and the generalized block graph: for every arch of
tests/test_torch_families.py, the engine over an int8 cache gives the JAX
package's engine's greedy tokens on the same weights, on the CPU."""

import numpy as np
import pytest
import torch

from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu_torch.serve import KVCachePolicy, Request, ServingEngine
from torch_port_helpers import ARCHS, family_pair

torch.set_num_threads(1)

INT8 = dict(method='naive', bit=8)
# fixed prompts: an int8 code on a rounding tie may flip between the two
# packages' f32 reductions (tests/test_torch_serve.py)
PROMPTS = [np.random.RandomState(3).randint(0, 96, (n,)) for n in (5, 9, 12)]


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_engine_greedy_tokens_equal_jax(name):
    """The engine over an int8 cache (bucketed admission, per-slot
    positions, retirement) gives the JAX engine's tokens."""
    jm, tm, _ = family_pair(name)
    kw = dict(max_batch=2, max_len=32, prefill_buckets=(8, 16))
    want = JEngine(jm, kv_policy=JPolicy(**INT8), **kw).run(
        [JRequest(uid=i, prompt_ids=p, max_new_tokens=5 + i)
         for i, p in enumerate(PROMPTS)])
    eng = ServingEngine(tm, kv_policy=KVCachePolicy(**INT8),
                        device='cpu', **kw)
    got = eng.run([Request(uid=i, prompt_ids=p, max_new_tokens=5 + i)
                   for i, p in enumerate(PROMPTS)])
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert all(r.done for r in got)
