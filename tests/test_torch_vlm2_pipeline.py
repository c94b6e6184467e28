"""Qwen2-VL, InternVL, LLaVA-OneVision and MiniCPM-V through both packages'
``run_pipeline`` on the same weights (``same_random_vlm2_weights``): the
shipped CI config of OneVision's video with PruneVid as it is, tiny shapes
of ``qwen2vl_awq_w4.yml``'s two ``quant`` sections (AWQ on the tower, then
AWQ with clipping on the LM) and ``internvl2_rtn_w4.yml``'s, and a
MiniCPM-V RTN language-only config, each with the native VQA eval.  The
results agree key for key.

The reference is held with each tower under its own modality's deploy
(``reference_tower_takes_its_own_qmap``): as shipped, Qwen2-VL's calibrated
tower reaches no eval and MiniCPM-V's tower takes the LM's QMap (ROADMAP
C), which the port does not do."""

import os

import pytest
import torch

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu_torch.main import run_pipeline
from torch_port_helpers import (VLM2_ARCHS, reference_tower_takes_its_own_qmap,
                                same_random_vlm2_weights)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP = 16      # the configs' group of 128, cut to the tiny widths


def _load(rel):
    from llmc_tpu_torch.utils import load_config
    return load_config(os.path.join(ROOT, rel))


def _quant(rel):
    """A shipped config's ``quant`` section, its group size cut."""
    q = _load(rel)['quant']
    for sec in q.values():
        if sec['weight'].get('group_size'):
            sec['weight']['group_size'] = GROUP
    return q


def _with_eval(cfg, data, positions=('pretrain', 'fake_quant')):
    cfg['calib'] = dict(data, n_samples=2, bs=1, seed=42)
    cfg['eval'] = dict(data, type='vqa', n_samples=2, bs=1, seed=0,
                       answer_tokens=2, eval_pos=list(positions))
    return cfg


def _qwen2vl():
    data = dict(name='synthetic_qwen2vl', seq_len=14, vocab_size=120,
                image_token=126, vision_start_token=125, grid_hw=[4, 4],
                patch_dim=3 * 2 * 4 * 4)
    return _with_eval(dict(base=dict(seed=42), model=dict(
        type='Qwen2vl', arch=VLM2_ARCHS['Qwen2vl']), quant=_quant(
            'configs/quantization/models/qwen2vl_awq_w4.yml')), data)


def _internvl():
    data = dict(name='synthetic_vlm', seq_len=12, vocab_size=120,
                image_token=126, image_seq_length=4, image_size=16)
    return _with_eval(dict(base=dict(seed=42), model=dict(
        type='InternVL2', arch=VLM2_ARCHS['InternVL2']), quant=_quant(
            'configs/quantization/models/internvl2_rtn_w4.yml')), data)


def _minicpmv():
    data = dict(name='synthetic_vlm', seq_len=10, vocab_size=68,
                image_token=70, image_seq_length=4, image_size=28)
    return _with_eval(dict(base=dict(seed=0), model=dict(
        type='MiniCPMV', arch=VLM2_ARCHS['MiniCPMV']), quant=dict(
            method='RTN', weight=dict(bit=4, symmetric=False,
                                      granularity='per_group',
                                      group_size=GROUP))), data)


CONFIGS = {
    'token_reduction_prunevid_onevision': lambda: _load(
        'configs/ci/token_reduction_prunevid_onevision.yml'),
    'qwen2vl_awq_w4': _qwen2vl,
    'internvl2_rtn_w4': _internvl,
    'minicpmv_rtn_language': _minicpmv,
}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_vlm2_pipeline_matches_reference(name, monkeypatch):
    same_random_vlm2_weights(monkeypatch)
    state = reference_tower_takes_its_own_qmap(monkeypatch)
    cfg = CONFIGS[name]()
    jres, tres = j_run_pipeline(cfg), run_pipeline(cfg, device='cpu')
    want = {k: v for k, v in jres.items() if k.startswith('vqa_')}
    got = {k: v for k, v in tres.items() if k.startswith('vqa_')}
    assert want and got == want
    assert got['vqa_pretrain_acc'] == 1.0   # answers by construction
    if 'sparse' in cfg:
        assert tres['model'].token_reduction == dict(
            cfg['sparse']['special'])
    # a vision section calibrated the tower, whose deploy reached the
    # reference's tower as it reaches the port's
    assert ('opt' in state) == ('vision' in cfg.get('quant', {}))
    assert tres['model'].modality == 'language'


def test_minicpmv_vision_modality_raises():
    cfg = _minicpmv()
    cfg['quant'] = dict(vision=dict(cfg['quant']))
    with pytest.raises(ValueError, match='language model only'):
        run_pipeline(cfg, device='cpu')
