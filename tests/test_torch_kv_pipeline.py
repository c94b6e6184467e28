"""The KV-cache quantization configs the repository ships
(configs/quantization/methods/kvquant_*.yml) end to end through both
pipelines on the CPU at float32: their ``quant`` sections (group size 128
cut to 32 for TINY) on TINY, with a PPL entry that also scores token
consistency and a decode-PPL entry at ``pretrain``, ``fake_quant`` and
``fake_quant_wo_kv``; every result within 1e-3 of the JAX package's."""

import numpy as np
import pytest
import torch

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.hf_loader import \
    save_llama_params_to_hf as j_save_params
from llmc_tpu_torch.main import run_pipeline
from torch_port_helpers import TINY, method_quant

torch.set_num_threads(1)

HF = dict({k: v for k, v in TINY.items() if k != 'dtype'},
          torch_dtype='float32', rms_norm_eps=1e-5)
POSITIONS = ['pretrain', 'fake_quant', 'fake_quant_wo_kv']
CONFIGS = ('kvquant_int8', 'kvquant_kivi', 'kvquant_pertensor_static')


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'tiny')
    j_save_params(JAdapter.random(JConfig(**TINY), seed=3).params, path, HF)
    return path


def kv_config(path, quant):
    """A pipeline config with a PPL entry (token consistency on) and a
    decode-PPL entry of two 32-token chunks at every position."""
    synthetic = dict(name='synthetic', vocab_size=128, seed=1)
    return dict(
        base=dict(seed=7),
        model=dict(type='Llama', path=path, torch_dtype='float32'),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=[dict(synthetic, num_tokens=480, seq_len=48, bs=2,
                   eval_pos=['pretrain', 'fake_quant'],
                   eval_token_consist=True),
              dict(synthetic, type='decode_ppl', num_tokens=96, seq_len=32,
                   num_samples=2, eval_pos=POSITIONS)],
        quant=quant)


@pytest.mark.parametrize('name', CONFIGS)
def test_kv_config_results_match_jax(checkpoint, name):
    """Every result (PPLs, decode PPLs at the three positions, token
    consistency) within 1e-3 of the JAX package's; the KV quantizer acts
    at fake_quant alone (fake_quant_wo_kv is the same deploy over an fp
    cache), and KIVI's fp ring, longer than the sequence, reads fp."""
    quant = method_quant(name)
    jres = j_run_pipeline(kv_config(checkpoint, quant))
    tres = run_pipeline(kv_config(checkpoint, quant), device='cpu')
    keys = ['ppl_pretrain', 'ppl_fake_quant', 'token_consistency'] + \
        [f'decode_ppl_{p}' for p in POSITIONS]
    for k in keys:
        assert np.isfinite(tres[k]), k
        assert abs(tres[k] - jres[k]) <= 1e-3 * abs(jres[k]), (
            k, tres[k], jres[k])
    kv = tres['opt'].kv_module
    assert kv.method == quant['kvcache']['method'].lower()
    with_kv, wo_kv = (tres['decode_ppl_fake_quant'],
                      tres['decode_ppl_fake_quant_wo_kv'])
    if kv.method == 'kivi':
        # the shipped ring of 128 tokens holds each 32-token chunk whole:
        # only fp values are read
        assert kv.residual_length >= 32
        assert abs(with_kv - wo_kv) <= 1e-5 * wo_kv
    else:
        assert with_kv != wo_kv
