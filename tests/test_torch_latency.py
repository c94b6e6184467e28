"""The latency and custom-generation evals of the port
(llmc_tpu_torch.eval.latency, eval.harness, and their entries in
eval.orchestrate) against the JAX package's on the CPU at float32: the
port's counterpart of ``tests/test_eval_orchestration.py::
test_eval_list_multi_entry``, a three-entry eval list (ppl with token
consistency, latency, custom_gen) through both ``run_pipeline``s on the
same weights.  ``LatencyEval``'s tokens and counts are held to the
reference's greedy decode of the same ids; its times are not a parity
target."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.eval.harness import CustomGenerate as JCustomGenerate
from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.serve.decode import greedy_generate as j_greedy
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu_torch.eval.harness import CustomGenerate
from llmc_tpu_torch.eval.latency import LatencyEval
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.serve import KVCachePolicy
from torch_port_helpers import TINY, port_params, same_random_weights

torch.set_num_threads(1)

LATENCY = dict(type='latency', prompt_len=8, gen_len=4, bs=1, iters=2,
               eval_pos=['fake_quant'])
CUSTOM = dict(type='custom_gen', prompts=['ab', 'cd'], max_new_tokens=3,
              eval_pos=['fake_quant'])


def multi_entry_config():
    """tests/test_pipeline.py's tiny RTN W8 config with the eval list of
    the JAX package's multi-entry test."""
    return dict(
        base=dict(seed=7), model=dict(type='Llama', arch=dict(TINY)),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=[dict(name='synthetic', num_tokens=768, seq_len=32,
                   vocab_size=128, bs=2, eval_token_consist=True,
                   eval_pos=['pretrain', 'transformed', 'fake_quant']),
              dict(LATENCY), dict(CUSTOM)],
        quant=dict(method='RTN', weight=dict(
            bit=8, symmetric=False, granularity='per_group', group_size=32)))


@pytest.fixture(scope='module')
def runs():
    with pytest.MonkeyPatch.context() as mp:
        same_random_weights(mp)
        jres = j_run_pipeline(copy.deepcopy(multi_entry_config()))
        tres = run_pipeline(copy.deepcopy(multi_entry_config()),
                            device='cpu')
    return jres, tres


def test_eval_list_multi_entry(runs):
    """Every entry is honoured: the PPLs within 1e-3 of the reference's
    (transformed equal to pretrain), the token consistency within 1e-3,
    positive latency statistics, and custom_gen's generated ids equal."""
    jres, tres = runs
    for k in ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant'):
        assert abs(tres[k] - jres[k]) / jres[k] <= 1e-3
    assert tres['ppl_transformed'] == tres['ppl_pretrain']
    assert abs(tres['token_consistency'] - jres['token_consistency']) <= 1e-3
    lat = tres['latency_fake_quant']
    assert sorted(lat) == sorted(jres['latency_fake_quant'])
    assert lat['ttft_p50_ms'] > 0 and lat['decode_tokens_per_s'] > 0
    assert tres['custom_gen_fake_quant'] == jres['custom_gen_fake_quant']
    assert [len(g) for g in tres['custom_gen_fake_quant']] == [3, 3]


@pytest.fixture(scope='module')
def pair():
    jm = JAdapter.random(JConfig(**TINY), seed=2)
    return jm, LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))


@pytest.mark.parametrize('batch,kv', [(1, 'fp'), (2, 'int8')])
def test_latency_tokens_and_counts(pair, batch, kv):
    """The prefill's and the G decode steps' greedy tokens of every run
    equal the reference's greedy decode of ``RandomState(0)``'s ids (the
    ids the reference's ``LatencyEval`` draws), over an fp and an int8
    cache; one warm-up and ``iters`` timed runs of each program."""
    jm, tm = pair
    policy = dict(method='naive', bit=8) if kv == 'int8' else {}
    P, G, iters = 7, 5, 3
    ev = LatencyEval(prompt_len=P, gen_len=G, batch=batch, iters=iters)
    out = ev.eval(tm, kv_policy=KVCachePolicy(**policy))
    ids = np.random.RandomState(0).randint(0, 128, (batch, P))
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), G + 1,
                               kv_policy=JPolicy(**policy)))[:, P:]
    np.testing.assert_array_equal(ev.tokens.numpy(), want)
    assert ev.stats == {'prefill_forwards': 1 + iters,
                        'decode_steps': G * (1 + iters)}
    assert all(v > 0 for v in out.values())


def test_custom_generate_matches_jax(pair):
    """Greedy continuations of byte-id prompts (no tokenizer) equal the
    reference's, a prompt's ids cut at 32 bytes."""
    jm, tm = pair
    prompts = ['hello', 'a longer prompt of more than thirty-two bytes']
    want = JCustomGenerate(prompts, max_new_tokens=4).eval(jm)
    assert CustomGenerate(prompts, max_new_tokens=4).eval(tm) == want
