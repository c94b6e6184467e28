"""``chip_smoke.py``'s phase 22 at a tiny size on the CPU (every step
eager, no kernel): the packed LLaVA served through ``vlm_greedy_generate``
with VisionZip and its fake-quant and CPU checks, FastV, the two-modality
pipeline with the vqa eval, Video-LLaVA with DyCoke, and ViT W8A8 with the
accuracy eval.  On the CPU no kernel launches, so the launch predictions
are read apart from the records' ``ok``."""

import torch

import chip_smoke

torch.set_num_threads(1)

CPU = torch.device('cpu')
PEAKS = chip_smoke.PEAKS['H100 SXM']
ZERO = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
# widths the W4 g128 packing takes (K a multiple of 128); a 56-pixel image
# of 14-pixel patches is 16 image tokens
LLAVA_TINY = dict(
    text=dict(vocab_size=160, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=2, head_dim=64, dtype='bfloat16'),
    vision=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                num_attention_heads=2),
    image_size=56, patch_size=14, image_token_index=150)
SERVE = dict(batch=2, text_tokens=4, new_tokens=4, cpu_layers=1,
             cpu_new_tokens=3)


def test_chip_smoke_cpu_phase22_serve_tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, 'VISIONZIP', dict(
        method='VisionZip', dominant=6, contextual=3))
    rec, model = chip_smoke.phase22_serve(CPU, PEAKS, spec=LLAVA_TINY,
                                          serve=SERVE, group_size=128)
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    assert rec['image_tokens'] == 16 and rec['layers'] == 2
    assert rec['visionzip']['image_tokens_after'] == 9
    for attn, run in rec['runs'].items():
        kernel = 'batch_decode' if attn == 'batch' else 'flash_decode'
        for m in ('graph', 'eager'):
            assert run[m]['launches'] == ZERO
            assert run[m]['expected_launches'] == dict(
                ZERO, w4_dequant_matmul=9 * 4, **{kernel: 2 * 3})
    checks = chip_smoke.phase22_launch_checks(rec)
    assert len(checks) == 5 and all(c['xla_branch_calls'] == 0
                                    for c in checks)
    assert rec['weight_bound_ms'] > 0 and rec['tower_projector_ms'] > 0
    assert 'qweight' in model.params['blocks'][0]['mlp']['gate_up_proj']


def test_chip_smoke_cpu_phase22_fastv_tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, 'FASTV', dict(method='FastV',
                                                   prune_layer=2, keep=5))
    model = chip_smoke.llava_model(CPU, dict(LLAVA_TINY, text=dict(
        LLAVA_TINY['text'], num_hidden_layers=3)))
    rec = chip_smoke.phase22_fastv(CPU, model, prompt_tokens=4)
    assert rec['ok'] and rec['pruned_length'] == 1 + 5 + 4
    assert rec['vs_cpu']['rel_logit_err'] == 0.0


def test_chip_smoke_cpu_phase22_compress_tiny():
    rec = chip_smoke.phase22_compress(
        CPU, spec=dict(LLAVA_TINY, text=dict(LLAVA_TINY['text'],
                                              dtype='float32')),
        sizes=dict(samples=2, answer_tokens=3, calib_samples=1))
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    assert rec['results']['vqa_pretrain_acc'] == 1.0
    assert rec['launches'] == ZERO
    assert rec['expected_launches'] == dict(ZERO, flash_decode=2 * 2 * 2 * 2)


def test_chip_smoke_cpu_phase22_videollava_tiny():
    rec = chip_smoke.phase22_videollava(
        CPU, spec=LLAVA_TINY, layers=2,
        video=dict(image_size=28, num_frames=8, video_token_index=151),
        cpu=dict(layers=1, tower_layers=(2, 'tiny')), prompt_tokens=4)
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    # 8 frames of 4 tokens; DyCoke keeps 2 of 4 in the 5 pruned frames
    assert rec['video_tokens'] == 32 and rec['video_tokens_kept'] == 22


def test_chip_smoke_cpu_phase22_vit_tiny():
    arch = dict(image_size=32, patch_size=8, hidden_size=64,
                intermediate_size=128, num_hidden_layers=3,
                num_attention_heads=4, num_labels=10)
    rec = chip_smoke.phase22_vit(CPU, arch=arch, run=dict(
        images=8, calib_images=2, cpu_layers=2, cpu_images=4))
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    assert rec['acc_pretrain'] == 1.0 and rec['launches'] == ZERO
    assert rec['vs_cpu']['w8a8_predictions_equal']


def test_phase22_shapes_are_the_published_configs():
    """LLaVA-1.5-7B's tower (CLIP ViT-L/14-336: 576 patches), LM and
    vocab; the token-reduction configs as the repository ships them."""
    import os

    import yaml
    spec = chip_smoke.LLAVA15_7B
    assert spec['text']['vocab_size'] == 32064
    assert (spec['image_size'] // spec['patch_size']) ** 2 == 576
    assert spec['vision']['num_hidden_layers'] == 24
    assert chip_smoke.VIT_B16['hidden_size'] == 768
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, want in (('visionzip', chip_smoke.VISIONZIP),
                       ('fastv', chip_smoke.FASTV),
                       ('dycoke', chip_smoke.DYCOKE)):
        with open(os.path.join(root, 'configs/sparsification/'
                               f'token_reduction/{name}.yml')) as f:
            assert yaml.safe_load(f)['sparse']['special'] == want, name
