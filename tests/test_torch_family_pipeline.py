"""The compression pipeline on the families' graphs, the port against the
JAX package on the CPU at float32: AWQ (scale transform and clip v1) per
family through both ``run_pipeline``s on the same weights
(``same_random_weights``), and GPTQ on the Falcon arch, the port's
counterpart of tests/test_model_families.py's
``test_gptq_pipeline_on_falcon_arch``.  RTN per family:
tests/test_torch_family_rtn.py."""

import numpy as np
import pytest
import torch

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu_torch.main import run_pipeline
from torch_port_helpers import (PIPELINE_FAMILIES, family_pipeline_config,
                                same_random_weights)

torch.set_num_threads(1)

PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')
AWQ_CLIP = dict(trans=True, weight_clip=True, clip_version='v1')


def both_pipelines(monkeypatch, config):
    same_random_weights(monkeypatch)
    jres = j_run_pipeline(config)
    tres = run_pipeline(config, device='cpu')
    return jres, tres


@pytest.mark.parametrize('family', sorted(PIPELINE_FAMILIES))
def test_awq_pipeline_ppls_match_jax(family, monkeypatch):
    """AWQ's searched scales fold into each family's norms (LayerNorm
    biases, Gemma2's pre-ffn norm, the shared LayerNorm of a parallel
    block) and its fcs: the three PPLs within 1e-3 of the JAX package's,
    the searched scales of the first block's subsets within 1e-3."""
    jres, tres = both_pipelines(monkeypatch, family_pipeline_config(
        family, 'Awq', AWQ_CLIP))
    for k in PPLS:
        assert np.isfinite(tres[k])
        assert abs(tres[k] - jres[k]) / jres[k] < 1e-3, k
    jl, tl = jres['model'].get_layout(), tres['model'].get_layout()
    assert jl.layernorms == tl.layernorms
    j0, t0 = jres['model'].blocks[0], tres['model'].blocks[0]
    for ln in tl.layernorms:
        want = np.asarray(j0[ln]['w'])
        got = t0[ln]['w'].numpy()
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), ln


def test_gptq_pipeline_on_falcon_arch(monkeypatch):
    """GPTQ (act-order, static groups off) over the parallel-residual
    shared-LayerNorm layout, the config of the JAX package's own test
    with PPL evals: the PPLs within 1e-3 of the JAX package's."""
    config = family_pipeline_config(
        'Falcon', 'GPTQ', dict(actorder=True, percdamp=0.01),
        weight=dict(bit=4, symmetric=True, granularity='per_group',
                    group_size=16))
    config['model']['arch'] = dict(vocab_size=96, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=2, head_dim=16,
                                   dtype='float32')
    jres, tres = both_pipelines(monkeypatch, config)
    assert tres['model'].cfg.parallel_residual
    assert tres['model'].cfg.num_key_value_heads == 1
    for k in PPLS:
        assert abs(tres[k] - jres[k]) / jres[k] < 1e-3, k
