"""The LLaVA tier and ViT through both packages' ``run_pipeline`` on the
same weights (``same_random_vlm_weights``, or one transformers-written
checkpoint): the shipped CI config of FastV with the native VQA eval, a
tiny ``vit_rtn_w8a8.yml`` shape with the ImageNet accuracy eval, tiny
``videollava_rtn_w4.yml`` and ``dycoke.yml`` shapes, and a two-modality
RTN config (the tower, then the LM).  The results agree key for key.

Where a QMap reaches the tower, the reference is held with its tower under
its own modality's deploy (``reference_tower_takes_its_own_qmap``): as
shipped, its LM QMap quantizes the tower too (ROADMAP C), which the port
does not."""

import os

import pytest
import torch

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu_torch.main import run_pipeline
from torch_port_helpers import (LLAVA_ARCH, VIDEOLLAVA_ARCH,
                                reference_tower_takes_its_own_qmap,
                                same_random_vlm_weights)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=16)
W8 = dict(bit=8, symmetric=True, granularity='per_channel')


def _load(rel):
    from llmc_tpu_torch.utils import load_config
    return load_config(os.path.join(ROOT, rel))


def _vlm_eval(name, cfg_arch, **kw):
    video = name == 'synthetic_videollava'
    span = (cfg_arch['image_size'] // cfg_arch['patch_size']) ** 2
    ev = dict(type='vqa', name=name, n_samples=2, seq_len=span * (
        cfg_arch.get('num_frames', 1) if video else 1) + 8,
        vocab_size=69, image_seq_length=span, image_size=cfg_arch[
            'image_size'], answer_tokens=2, bs=1, seed=0, **kw)
    if video:
        ev.update(video_token=cfg_arch['video_token_index'],
                  num_frames=cfg_arch['num_frames'])
    else:
        ev['image_token'] = cfg_arch['image_token_index']
    return ev


def _two_modality():
    arch = dict(LLAVA_ARCH)
    ev = _vlm_eval('synthetic_vlm', arch, eval_pos=['pretrain',
                                                    'fake_quant'])
    calib = {k: v for k, v in ev.items() if k not in ('type', 'eval_pos',
                                                      'answer_tokens')}
    return dict(base=dict(seed=7), model=dict(type='Llava', arch=arch),
                calib=calib, eval=ev,
                quant=dict(vision=dict(method='RTN', weight=W8),
                           language=dict(method='RTN', weight=W4)))


def _videollava(sparse):
    arch = dict(VIDEOLLAVA_ARCH)
    positions = ['pretrain', 'transformed' if sparse else 'fake_quant']
    ev = _vlm_eval('synthetic_videollava', arch, eval_pos=positions)
    cfg = dict(base=dict(seed=42), model=dict(type='VideoLlava', arch=arch),
               eval=ev)
    if sparse:       # configs/sparsification/token_reduction/dycoke.yml
        cfg['sparse'] = dict(method='TokenReduction', special=dict(
            method='DyCoke', merging_ratio=0.5))
    else:            # configs/quantization/models/videollava_rtn_w4.yml
        cfg['calib'] = {k: v for k, v in ev.items()
                        if k not in ('type', 'eval_pos', 'answer_tokens')}
        cfg['quant'] = dict(language=dict(method='RTN', weight=W4))
    return cfg


CONFIGS = {
    'token_reduction_fastv_vqa': lambda: _load(
        'configs/ci/token_reduction_fastv_vqa.yml'),
    'videollava_rtn_w4': lambda: _videollava(False),
    'dycoke': lambda: _videollava(True),
    'llava_vision_language_rtn': _two_modality,
}


def _numbers(res):
    return {k: v for k, v in res.items()
            if isinstance(v, (int, float)) and k not in ('wall_s',)}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_vlm_pipeline_matches_reference(name, monkeypatch):
    same_random_vlm_weights(monkeypatch)
    state = reference_tower_takes_its_own_qmap(monkeypatch)
    cfg = CONFIGS[name]()
    jres, tres = j_run_pipeline(cfg), run_pipeline(cfg, device='cpu')
    want, got = _numbers(jres), _numbers(tres)
    keys = {k for k in want if k.startswith('vqa_')}
    assert keys and keys == {k for k in got if k.startswith('vqa_')}
    for k in keys:
        assert got[k] == want[k], (k, got, want)
    assert got['vqa_pretrain_acc'] == 1.0   # answers by construction
    if 'sparse' in cfg:
        special = dict(cfg['sparse']['special'])
        assert tres['model'].token_reduction == special
    # the reference's tower took its own modality's deploy (or none)
    assert ('opt' in state) == (name == 'llava_vision_language_rtn')
    assert tres['model'].modality == 'language'


@pytest.fixture(scope='module')
def vit_dir(tmp_path_factory):
    tr = pytest.importorskip('transformers')
    cfg = tr.ViTConfig(image_size=32, patch_size=8, num_channels=3,
                       hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_labels=10)
    torch.manual_seed(0)
    model = tr.ViTForImageClassification(cfg).eval()
    d = tmp_path_factory.mktemp('tiny_vit')
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


def test_vit_rtn_w8a8_pipeline_matches_reference(vit_dir):
    """The vit_rtn_w8a8.yml shape (tests/test_eval_orchestration.py): RTN
    W8A8 with the quantized attention over the ``vision`` modality, the
    ImageNet accuracy on synthetic pixels labelled by the pretrain
    model."""
    cfg = dict(
        base=dict(seed=42),
        model=dict(type='Vit', path=vit_dir, torch_dtype='float32'),
        calib=dict(name='synthetic_img', n_samples=4, bs=1, seed=0,
                   image_size=32, preproc='img_general'),
        eval=dict(name='imagenet', n_samples=8, bs=4,
                  eval_pos=['pretrain', 'fake_quant']),
        quant=dict(vision=dict(
            method='RTN', weight=W8,
            act=dict(bit=8, symmetric=True, granularity='per_token',
                     quant_attn=True, quant_softmax=True,
                     quant_act_fn=True))))
    jres, tres = j_run_pipeline(cfg), run_pipeline(cfg, device='cpu')
    assert tres['acc_pretrain'] == jres['acc_pretrain'] == 1.0
    assert tres['acc_fake_quant'] == jres['acc_fake_quant']
    qmap = tres['opt'].deploy('fake_quant')
    for pseudo in ('attention.matmul_1', 'attention.softmax', 'act_fn'):
        assert qmap.get(pseudo).a_spec is not None


def test_vision_modality_of_other_models_raises():
    cfg = dict(model=dict(type='Llama', arch={}),
               quant=dict(vision=dict(method='RTN', weight=W8)))
    with pytest.raises(NotImplementedError, match='ROADMAP A13e'):
        run_pipeline(cfg, device='cpu')
