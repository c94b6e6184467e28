"""The shipped MoE configs through both pipelines on the tiny checkpoints,
part 1: the AWQ W4 configs of DeepSeek-V3
(``deepseekv3/awq_w_only_dsv3.yml``, ``awq_w_only_dsv3_bf16.yml``,
``models/deepseekv3_awq_w4.yml``) and Mixtral's GPTQ W4
(``models/mixtral_gptq_w4.yml``: per-expert subsets, act-order with
static groups, true-sequential, quant_out), their ``quant`` sections on
checkpoints written with transformers, each PPL within 1e-3 of the JAX
package's; and the serving engine's Mixtral tokens against the JAX
engine's, in the scenario of the JAX package's MoE engine test.  The
configs' ``save`` sections are left out: the exports are held in
``test_torch_export*.py``.  Part 2: ``test_torch_moe_configs_w8a8.py``."""

import json

import numpy as np
import pytest

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu_torch.main import run_pipeline
from torch_port_helpers import (load_moe_checkpoints_in_f32, moe_config,
                                port_params, write_hf_moe_checkpoint)

PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')
CONFIGS = ('deepseekv3/awq_w_only_dsv3.yml',
           'deepseekv3/awq_w_only_dsv3_bf16.yml',
           'models/deepseekv3_awq_w4.yml', 'models/mixtral_gptq_w4.yml')


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    return {k: write_hf_moe_checkpoint(k, str(tmp_path_factory.mktemp(k)))
            for k in ('mixtral', 'deepseek')}


_RUNS = {}


def run_both(checkpoints, rel):
    """Both packages' results of one config, each quant section run once
    (the two DeepSeek AWQ files share theirs); an exception stands in for
    a result."""
    kind = 'mixtral' if 'mixtral' in rel else 'deepseek'
    config = moe_config(rel, checkpoints[kind])
    key = json.dumps([kind, config['quant']], sort_keys=True)
    if key not in _RUNS:
        out = []
        for run in (j_run_pipeline,
                    lambda c: run_pipeline(c, device='cpu')):
            try:
                out.append(run(config))
            except Exception as e:   # compared between the packages below
                out.append(e)
        _RUNS[key] = out
    return _RUNS[key]


# the shipped configs whose quant section raises in both packages on the
# tiny models, each with its recorded cause (ROADMAP C): the JAX package's
# exception type, the port's, and a text of the port's message.  QuaRot's
# rotation looks up every subset's linears in every block, and DeepSeek's
# dense first block has no experts.
RAISES = {'deepseekv3/quarot_w_a_dsv3.yml':
          (KeyError, NotImplementedError, 'mlp.experts.0.gate_proj')}


def check_ppls_or_raises(jres, tres, equivalence, raises=None):
    """Each PPL within 1e-3 of the JAX package's; an equivalence transform
    keeps 'transformed' within 2e-4 of pretrain.  Where ``raises`` gives
    a config's recorded cause (``RAISES``), both packages raise so, and
    nothing else is accepted."""
    if raises is not None:
        jtype, ttype, text = raises
        assert isinstance(jres, jtype), jres
        assert isinstance(tres, ttype) and text in str(tres), tres
        return
    assert not isinstance(jres, Exception), jres
    assert not isinstance(tres, Exception), tres
    for ppl in PPLS:
        assert np.isfinite(tres[ppl]), ppl
        assert abs(tres[ppl] - jres[ppl]) / jres[ppl] <= 1e-3, (
            ppl, tres[ppl], jres[ppl])
    if equivalence:
        assert abs(tres['ppl_transformed'] - tres['ppl_pretrain']) \
            <= 2e-4 * tres['ppl_pretrain']


@pytest.mark.parametrize('rel', CONFIGS)
def test_shipped_moe_config_ppls_match_jax(checkpoints, monkeypatch, rel):
    """AWQ on DeepSeek is no equivalence here: its ``moe_gu`` subset
    scales the post-attention norm into every expert's gate and up, but
    the router reads that norm too, so the routing moves (in both
    packages); GPTQ's compensated weights are none either."""
    load_moe_checkpoints_in_f32(monkeypatch)
    jres, tres = run_both(checkpoints, rel)
    check_ppls_or_raises(jres, tres, equivalence=False,
                         raises=RAISES.get(rel))


def _requests(cls, n=3, seed=5, max_new=5):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt_ids=rng.randint(0, 128, (4 + i,)),
                max_new_tokens=max_new) for i in range(n)]


def test_engine_mixtral_tokens_equal_jax_engine():
    """The JAX package's ``test_engine_mixtral_moe``: two slots, max_len
    48, buckets 8 and 16, three requests of 5 tokens; the port's engine
    gives the JAX engine's tokens and the uncached greedy ones."""
    import torch
    from llmc_tpu.models.adapter import MixtralAdapter as JAdapter
    from llmc_tpu.models.mixtral import MixtralConfig as JConfig
    from llmc_tpu.serve.engine import Request as JRequest
    from llmc_tpu.serve.engine import ServingEngine as JEngine
    from llmc_tpu_torch.models.adapter import MixtralAdapter
    from llmc_tpu_torch.models.mixtral import MixtralConfig
    from llmc_tpu_torch.serve import Request, ServingEngine
    from torch_port_helpers import MX_TINY
    jm = JAdapter.random(JConfig(**MX_TINY), seed=3)
    tm = MixtralAdapter(MixtralConfig(**MX_TINY), port_params(jm.params))
    jreqs, treqs = _requests(JRequest), _requests(Request)
    JEngine(jm, max_batch=2, max_len=48, prefill_buckets=(8, 16)).run(jreqs)
    eng = ServingEngine(tm, max_batch=2, max_len=48, prefill_buckets=(8, 16),
                        device='cpu')
    assert not eng.mla
    eng.run(treqs)
    assert all(r.done and len(r.output_ids) == 5 for r in treqs)
    assert [r.output_ids for r in treqs] == [list(r.output_ids)
                                              for r in jreqs]
    for r in treqs:
        ids = torch.as_tensor(r.prompt_ids)[None]
        for t in r.output_ids:
            assert int(tm.forward_logits(ids)[0, -1].argmax()) == t
            ids = torch.cat([ids, torch.tensor([[t]])], 1)


def test_awq_clip_off_the_group_raises_in_both():
    """``awq_w_only_dsv3.yml``'s clip search (asymmetric W4, groups of 128)
    on DeepSeek-V2-Lite's dense ``down_proj`` (10944 inputs, no whole
    number of groups): both packages reshape the weight into whole groups
    (``auto_clip.py::auto_clip_layer``) and raise, so the shipped config
    runs in neither on V2-Lite's dense first layer (the weight quantizer
    itself pads the last group).  A 64 x 10944 slice stands in for the
    weight."""
    import jax.numpy as jnp
    import torch
    from llmc_tpu.compression.quantization.auto_clip import \
        AutoClipper as JClipper
    from llmc_tpu.quant.qspec import QuantSpec as JSpec
    from llmc_tpu_torch.compression.quantization.auto_clip import AutoClipper
    from llmc_tpu_torch.quant.qspec import QuantSpec
    spec = dict(bit=4, symmetric=False, granularity='per_group',
                group_size=128)
    rng = np.random.RandomState(0)
    w = rng.randn(64, 10944).astype(np.float32)
    x = rng.randn(32, 10944).astype(np.float32)
    kw = dict(w_only=True, aspec=None, clip_version='v1', clip_sym=False,
              save_clip=False)
    with pytest.raises(TypeError):
        JClipper(wspec=JSpec(**spec), **kw).auto_clip_layer(
            jnp.asarray(w), jnp.asarray(x))
    with pytest.raises(RuntimeError, match='invalid for input'):
        AutoClipper(wspec=QuantSpec(**spec), **kw).auto_clip_layer(
            torch.as_tensor(w), torch.as_tensor(x))
