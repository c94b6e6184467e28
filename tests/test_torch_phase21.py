"""``chip_smoke.py``'s phase 21 at a tiny size on the CPU (no kernel): the
AutoAWQ export against ``pack_model``'s packing and a plain forward over
the file's weights, the symmetric export against the fake-quant weights,
each writer's checkpoint against a CPU copy's, block offload against the
resident run, and the code eval against the CPU's completions; and the
phase's copies of the shipped backend configs' sections.  On the CPU no
kernel launches, so the launch predictions are read apart from the
records' ``ok``."""

import os

import pytest
import torch
import yaml

import chip_smoke

torch.set_num_threads(1)

CPU = torch.device('cpu')
ZERO = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
# widths the W4 g128 grid takes (K a multiple of 128)
LLAMA_TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, head_dim=64,
                  max_position_embeddings=256, dtype='bfloat16')
SIZES = dict(n_samples=2, seq_len=32)


def test_export_configs_copy_the_shipped_sections():
    """Each ``EXPORT_CONFIGS`` entry holds its config's weight spec (the
    AWQ-searched ones' under RTN) and save flags; GPTQ's its whole quant
    section."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, (rel, quant, save) in chip_smoke.EXPORT_CONFIGS.items():
        with open(os.path.join(root, rel)) as f:
            cfg = yaml.safe_load(f)
        assert quant['weight'] == cfg['quant']['weight'], name
        if quant['method'] != 'RTN':
            assert quant == cfg['quant'], name
        shipped = {k: v for k, v in cfg['save'].items() if k != 'save_path'}
        assert {k: v for k, v in save.items() if k != 'tp_size'} \
            == shipped, name


def test_chip_smoke_cpu_phase21_export_tiny():
    rec = chip_smoke.phase21_export(CPU, cfg_kw=LLAMA_TINY, **SIZES)
    assert rec['ok'] and rec['launches'] == ZERO
    assert rec['expected_launches'] == dict(ZERO, w4_dequant_matmul=14)
    mism = rec['codes_vs_b1']
    assert mism['linears'] == 14 and mism['codes_checked'] > 0
    assert rec['bytes_by_part']['qweight'] > 0 and rec['save_s'] > 0


def test_chip_smoke_cpu_phase21_symmetric_tiny():
    rec = chip_smoke.phase21_symmetric(CPU, cfg_kw=LLAMA_TINY, **SIZES)
    assert rec['ok'] and 0 < rec['worst_err_over_fp16_bound'] <= 1


def test_chip_smoke_cpu_phase21_writers_tiny():
    recs = list(chip_smoke.phase21_writers(CPU, cfg_kw=LLAMA_TINY, **SIZES))
    assert [r['name'] for r in recs] == list(chip_smoke.WRITERS)
    for r in recs:
        assert r['ok'] and r['vs_cpu']['tensors'] > 0, r['name']
    gptq = recs[chip_smoke.WRITERS.index('vllm_gptq_w4a16')]
    assert gptq['layers'] == 1 and gptq['depth_cut']


def test_chip_smoke_cpu_phase21_offload_tiny():
    arch = dict(LLAMA_TINY, num_key_value_heads=1)
    rec = chip_smoke.phase21_offload(
        CPU, cfg_kw=arch, layers=4, check_layers=2,
        eval_kw=dict(num_tokens=256, seq_len=32, bs=4), **SIZES)
    assert rec['ok'] and rec['ppl_rel_offload_vs_resident'] <= 1e-6
    assert rec['runs']['offload']['layers'] == 4
    assert rec['transfers']['block_bytes'] > 0


def test_chip_smoke_cpu_phase21_code_eval_tiny():
    rec = chip_smoke.phase21_code_eval(
        CPU, cfg_kw=dict(LLAMA_TINY, dtype='float32'), max_new_tokens=4)
    assert rec['ok'] and rec['completions_equal_cpu']
    assert rec['launches'] == ZERO and rec['xla_branch_calls'] == 0
    assert rec['expected_launches'] == dict(ZERO, flash_decode=2 * 3 * 2)


@pytest.mark.parametrize('name', ['autoawq_rtn_w4a16', 'vllm_gptq_w4a16'])
def test_export_config_is_a_pipeline_config(name):
    cfg = chip_smoke.export_config(LLAMA_TINY, name, 'out', **SIZES)
    assert cfg['save']['save_path'] == 'out' and 'eval' not in cfg
