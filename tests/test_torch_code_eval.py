"""The port's code, lm-eval and opencompass evals against the JAX
package's, on the CPU at float32: HumanEval completions of a problems file
through ``EvalOrchestrator`` (``samples.jsonl`` equal to the reference's,
pretrained and under a fake-quant QMap), ``LMEvalAdapter``'s log
likelihoods and generations on the same weights (both objects built past
their ``lm_eval`` gate), and the gates themselves: ``lm_eval`` and the
``opencompass`` binary missing raise as the reference raises (the
counterparts of ``tests/test_eval_orchestration.py::
test_humaneval_dispatch``)."""

import importlib.util
import json
import os
import shutil

import pytest
import torch

import llmc_tpu.main as jmain
import llmc_tpu_torch.main as tmain
from llmc_tpu.eval import harness as jharness
from llmc_tpu.eval.orchestrate import EvalOrchestrator as JOrchestrator
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models.adapter import QMap as JQMap
from llmc_tpu.models.base import LinearQcfg as JLinearQcfg
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.utils import Cfg as JCfg
from llmc_tpu_torch.eval import harness as tharness
from llmc_tpu_torch.eval.orchestrate import EvalOrchestrator
from llmc_tpu_torch.models import LlamaAdapter
from llmc_tpu_torch.models.adapter import QMap
from llmc_tpu_torch.models.base import LinearQcfg
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.utils import Cfg
from test_torch_export import checkpoint  # noqa: F401
from test_torch_offload import config

torch.set_num_threads(1)

W4 = dict(bit=4, symmetric=True, granularity='per_group', group_size=32)
PROBLEMS = [{'task_id': 't/0', 'prompt': 'def add(a, b):\n'},
            {'task_id': 't/1', 'prompt': 'class Stack:\n    def pop('}]


class ByteTok:
    """Bytes as ids, modulo the tiny vocab (the reference test's)."""

    def __call__(self, text):
        return {'input_ids': [b % 128 for b in text.encode()]}

    def decode(self, ids, skip_special_tokens=True):
        return ''.join(chr(int(i) % 128) for i in ids)


@pytest.fixture(scope='module')
def models(checkpoint):  # noqa: F811
    """(JAX model, port model) of the tiny checkpoint with the byte
    tokenizer, and the RTN W4 fake-quant QMap of each."""
    import jax.numpy as jnp
    jm = JAdapter.from_pretrained(checkpoint, dtype=jnp.float32)
    tm = LlamaAdapter.from_pretrained(checkpoint, dtype=torch.float32,
                                      device='cpu')
    jm.tokenizer = tm.tokenizer = ByteTok()
    linears = tm.get_layout().linears
    jq = JQMap({p: JLinearQcfg(w_spec=JSpec(**W4)) for p in linears})
    tq = QMap({p: LinearQcfg(w_spec=QuantSpec(**W4)) for p in linears})
    return jm, tm, jq, tq


@pytest.mark.parametrize('position', ['pretrain', 'fake_quant'])
def test_humaneval_samples_match_the_reference(models, tmp_path, position):
    jm, tm, jq, tq = models
    problems = tmp_path / 'problems.jsonl'
    problems.write_text(''.join(json.dumps(p) + '\n' for p in PROBLEMS))
    out = {}
    for name, orch_cls, cfg_cls, model, qmap in (
            ('jax', JOrchestrator, JCfg, jm, jq),
            ('port', EvalOrchestrator, Cfg, tm, tq)):
        cfg = cfg_cls({'model': {'type': 'Llama'}, 'eval': {
            'type': 'code', 'path': str(problems), 'max_new_tokens': 12,
            'res_path': str(tmp_path / name), 'eval_pos': [position]}})
        res = orch_cls(cfg, model).run(
            position, model, qmap=qmap if position == 'fake_quant' else None)
        out[name] = res[f'code_{position}']
    assert out['port']['note'] == out['jax']['note']
    assert out['port']['samples'] == str(tmp_path / 'port' / 'samples.jsonl')
    with open(out['port']['samples']) as f:
        got = [json.loads(ln) for ln in f]
    with open(out['jax']['samples']) as f:
        want = [json.loads(ln) for ln in f]
    assert [s['task_id'] for s in got] == ['t/0', 't/1']
    assert got == want


def _adapters(models, fake_quant):
    """Both ``LMEvalAdapter``s built past their ``lm_eval`` gate."""
    jm, tm, jq, tq = models
    ja = object.__new__(jharness.LMEvalAdapter)
    ta = object.__new__(tharness.LMEvalAdapter)
    ja._model, ja._qmap = jm, jq if fake_quant else None
    ta._model, ta._qmap = tm, tq if fake_quant else None
    return ja, ta


@pytest.mark.parametrize('fake_quant', [False, True])
def test_lm_eval_adapter_matches_the_reference(models, fake_quant):
    ja, ta = _adapters(models, fake_quant)
    for ctx, cont in (('def f(x):', ' return x'), ('ab', 'c')):
        got, want = ta._loglikelihood(ctx, cont), ja._loglikelihood(ctx, cont)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        assert got[1] == want[1]
    text = 'the quick brown fox'
    assert ta._rolling_ll(text) == pytest.approx(ja._rolling_ll(text),
                                                  rel=1e-5)
    for kw in ({'max_gen_toks': 8}, {'max_gen_toks': 8, 'until': ['\n']}):
        assert ta._generate('def g(', kw) == ja._generate('def g(', kw)


def test_lm_eval_gate_raises_as_the_reference(models):
    """``lm_eval`` is not installed here: building the adapter and
    ``run_lm_eval`` raise ``ImportError`` in both packages."""
    assert importlib.util.find_spec('lm_eval') is None
    jm, tm, _, _ = models
    for mod, model in ((jharness, jm), (tharness, tm)):
        with pytest.raises(ImportError):
            mod.LMEvalAdapter(model)
        with pytest.raises(ImportError):
            mod.run_lm_eval(model, ['wikitext'])


def test_opencompass_gates_raise_as_the_reference(checkpoint, tmp_path,
                                                  monkeypatch):  # noqa: F811
    """Without ``save.save_trans`` both raise ``ValueError`` (the port
    before any work); with it and no ``opencompass`` binary both raise
    ``RuntimeError`` naming the command line, after the save."""
    monkeypatch.setattr(shutil, 'which', lambda *a, **k: None)
    cfg = config(checkpoint)
    del cfg['eval']
    cfg['opencompass'] = dict(cfg_path='oc.py', output_path='oc_out')
    for run, kw in ((jmain.run_pipeline, {}),
                    (tmain.run_pipeline, dict(device='cpu'))):
        with pytest.raises(ValueError, match='save_trans'):
            run(dict(cfg), **kw)
    for name, run, kw in (('jax', jmain.run_pipeline, {}),
                          ('port', tmain.run_pipeline, dict(device='cpu'))):
        out = str(tmp_path / name)
        with pytest.raises(RuntimeError, match='opencompass oc.py -w oc_out '
                           '--llmc_eval_mode quant --llmc_model_path '
                           + out):
            run(dict(cfg, save=dict(save_trans=True, save_path=out)), **kw)
        assert os.path.exists(os.path.join(out, 'model.safetensors'))
