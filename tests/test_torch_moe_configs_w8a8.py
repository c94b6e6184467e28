"""The shipped MoE configs through both pipelines on the tiny checkpoints,
part 2: DeepSeek-V3's W8A8 and RTN configs (``deepseekv3/osplus_w_a_dsv3``,
``quarot_w_a_dsv3``, ``rtn_w_a_dsv3``, ``rtn_w_only_dsv3``,
``smoothquant_w_a_dsv3``), each PPL within 1e-3 of the JAX package's, or
both packages raising for the cause that ``RAISES`` records (QuaRot: the
reference's rotation looks up every subset's linears in every block, and
DeepSeek's dense first block has no experts: a ``KeyError`` there, a
``NotImplementedError`` naming the path in the port); and the serving
engine's DeepSeek tokens against the JAX engine's in the scenarios of the
JAX package's MoE engine tests (the MLA latent cache, monolithic and
chunked admission).  Part 1 and the shared pieces:
``test_torch_moe_configs.py``."""

import numpy as np
import pytest

from test_torch_moe_configs import checkpoints  # noqa: F401 (a fixture)
from test_torch_moe_configs import RAISES, check_ppls_or_raises, run_both
from torch_port_helpers import (DS_TINY, load_moe_checkpoints_in_f32,
                                port_params)

CONFIGS = {'deepseekv3/osplus_w_a_dsv3.yml': True,
           'deepseekv3/quarot_w_a_dsv3.yml': False,
           'deepseekv3/rtn_w_a_dsv3.yml': True,
           'deepseekv3/rtn_w_only_dsv3.yml': True,
           'deepseekv3/smoothquant_w_a_dsv3.yml': True}


@pytest.mark.parametrize('rel', sorted(CONFIGS))
def test_shipped_moe_config_ppls_match_jax(checkpoints, monkeypatch, rel):
    """RTN, SmoothQuant and OS+ (no shift) are equivalences: their
    transformed model keeps pretrain's PPL within 2e-4."""
    load_moe_checkpoints_in_f32(monkeypatch)
    jres, tres = run_both(checkpoints, rel)
    check_ppls_or_raises(jres, tres, equivalence=CONFIGS[rel],
                         raises=RAISES.get(rel))


def _requests(cls, n=3, seed=5, max_new=5):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt_ids=rng.randint(0, 128, (4 + i,)),
                max_new_tokens=max_new) for i in range(n)]


@pytest.mark.parametrize('scenario', ['monolithic', 'chunked'])
def test_engine_deepseek_tokens_equal_jax_engine(scenario):
    """``test_engine_deepseek_mla`` (two slots, max_len 48, buckets 8 and
    16, seed 4) and ``test_engine_deepseek_chunked_prefill`` (seed 7, one
    bucket of 16, chunks of 4, two requests of seed 9): the port's engine
    gives the JAX engine's tokens."""
    from llmc_tpu.models.adapter import DeepseekV2Adapter as JAdapter
    from llmc_tpu.models.deepseek import DeepseekConfig as JConfig
    from llmc_tpu.serve.engine import Request as JRequest
    from llmc_tpu.serve.engine import ServingEngine as JEngine
    from llmc_tpu_torch.models.adapter import DeepseekV2Adapter
    from llmc_tpu_torch.models.deepseek import DeepseekConfig
    from llmc_tpu_torch.serve import Request, ServingEngine
    seed, kw, rq = ((4, dict(prefill_buckets=(8, 16)), dict())
                    if scenario == 'monolithic' else
                    (7, dict(prefill_buckets=(16,), prefill_chunk=4),
                     dict(n=2, seed=9)))
    jm = JAdapter.random(JConfig(**DS_TINY), seed=seed)
    tm = DeepseekV2Adapter(DeepseekConfig(**DS_TINY), port_params(jm.params))
    jreqs, treqs = _requests(JRequest, **rq), _requests(Request, **rq)
    jeng = JEngine(jm, max_batch=2, max_len=48, **kw)
    jeng.run(jreqs)
    eng = ServingEngine(tm, max_batch=2, max_len=48, device='cpu', **kw)
    assert eng.mla and jeng.mla
    eng.run(treqs)
    assert all(r.done and len(r.output_ids) == 5 for r in treqs)
    assert [r.output_ids for r in treqs] == [list(r.output_ids)
                                              for r in jreqs]
