"""``chip_smoke.py``'s phase 23 at a tiny size on the CPU (every step
eager, no kernel): Qwen2-VL's packed eager forward with images and its
text served through the engine, its two-modality AWQ pipeline with the vqa
eval, InternVL (and InternViT-6B's qk-norm block), OneVision's anyres image
and video with PruneVid and DyCoke, and MiniCPM-V after RTN.  On the CPU no
kernel launches, so the launch predictions are read apart from the
records' ``ok``."""

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

CPU = torch.device('cpu')
PEAKS = chip_smoke.PEAKS['H100 SXM']
ZERO = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
# widths the W4 g128 packing takes (K a multiple of 128), head dim 64
LM = dict(vocab_size=160, hidden_size=128, intermediate_size=256,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
          head_dim=64, attention_bias=True, dtype='bfloat16')
TOWER = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=2)
QWEN2VL = dict(text=dict(LM, rope_theta=1e6, rope_scaling_type='mrope'),
               vision=TOWER, mrope_section=(8, 12, 12), patch_size=4,
               temporal_patch_size=2, spatial_merge_size=2,
               image_token_id=150, vision_start_token_id=148)
INTERNVL = dict(text=LM, vision=TOWER, image_size=16, patch_size=4,
                image_token_id=150, downsample_ratio=0.5)
ONEVISION = dict(text=LM, vision=TOWER, image_size=16, patch_size=4,
                 image_token_index=150, video_token_index=151,
                 vision_aspect_ratio='anyres_max_9',
                 image_grid_pinpoints=((16, 16), (16, 32), (32, 32)))
MINICPMV = dict(text=dict(LM, attention_bias=False), vision=TOWER,
                image_size=28, patch_size=14, num_queries=4,
                image_token_index=150)


def _launch_checks(rec, n):
    checks = chip_smoke.phase23_launch_checks(rec)
    assert len(checks) == n
    for c in checks:
        assert c['launches'] == ZERO and c['xla_branch_calls'] == 0
    return checks


def test_chip_smoke_cpu_phase23_qwen2vl_tiny():
    rec = chip_smoke.phase23_qwen2vl(
        CPU, PEAKS, spec=QWEN2VL, run=dict(
            batch=2, grid=(1, 4, 4), text_tokens=4, text_batch=2,
            text_prompt=8, new_tokens=4, cpu_layers=1, cpu_grid=(1, 4, 4)),
        timing_steps=2)
    assert rec['ok'], chip_smoke.phase23_failure(rec)
    assert rec['image_tokens'] == 4 and rec['rope_scaling_type'] == 'mrope'
    checks = _launch_checks(rec, 6)
    assert checks[-1]['expected_launches'] == dict(
        ZERO, w4_dequant_matmul=9)
    for attn, run in rec['text_runs'].items():
        kernel = 'batch_decode' if attn == 'batch' else 'flash_decode'
        assert run['eager']['expected_launches'][kernel] > 0
    assert rec['weight_bound_ms'] > 0 and rec['tower_merger_ms'] > 0


def test_chip_smoke_cpu_phase23_qwen2vl_compress_tiny():
    g32 = dict(symmetric=False, granularity='per_group', group_size=32)
    sizes = dict(chip_smoke.QWEN2VL_COMPRESS, layers=(2, 'tiny'), samples=2,
                 answer_tokens=2, calib_samples=1, grid=(4, 4), quant=dict(
                     vision=dict(method='Awq', weight=dict(g32, bit=8),
                                 special=dict(trans=True, weight_clip=False)),
                     language=dict(method='Awq', weight=dict(g32, bit=4),
                                   special=chip_smoke.AWQ_SPECIAL)))
    spec = dict(QWEN2VL, text=dict(QWEN2VL['text'], dtype='float32'))
    rec = chip_smoke.phase23_qwen2vl_compress(CPU, spec=spec, sizes=sizes)
    assert rec['ok'], chip_smoke.phase23_failure(rec)
    assert rec['results']['vqa_pretrain_acc'] == 1.0
    assert rec['deploy_bits'] == dict(vision=8, language=4)
    _launch_checks(rec, 1)


def test_chip_smoke_cpu_phase23_internvl_tiny():
    rec = chip_smoke.phase23_internvl(
        CPU, PEAKS, spec=INTERNVL, layers=2, batch=2, text_tokens=4,
        cpu_layers=1, vit6b=dict(hidden_size=48, intermediate_size=96,
                                 layers=2, heads=3, tokens=17))
    assert rec['ok'], chip_smoke.phase23_failure(rec)
    assert rec['image_tokens'] == 4 and rec['layer_scale']
    assert rec['internvit_6b']['rel_err'] == 0.0
    (check,) = _launch_checks(rec, 1)
    assert check['expected_launches'] == dict(ZERO, w4_dequant_matmul=9)


def test_chip_smoke_cpu_phase23_onevision_tiny(monkeypatch):
    rec = chip_smoke.phase23_onevision(
        CPU, PEAKS, spec=ONEVISION, layers=2, run=dict(
            image=(32, 32), frames=4, text_tokens=4, cpu_layers=1,
            cpu_frames=2))
    assert rec['ok'], chip_smoke.phase23_failure(rec)
    # the base crop and a 2 x 2 grid of 4 x 4 patches, a newline a row
    assert rec['crops'] == 5 and rec['image_tokens'] == 16 + 8 * 9
    assert rec['video_tokens'] == 4 * 4 + 1
    assert set(rec['video_tokens_kept']) == {'PruneVid', 'DyCoke'}
    _launch_checks(rec, 4)


def test_chip_smoke_cpu_phase23_minicpmv_tiny():
    rec = chip_smoke.phase23_minicpmv(CPU, PEAKS, spec=MINICPMV, layers=2,
                                      text_tokens=4, cpu_layers=1)
    assert rec['ok'], chip_smoke.phase23_failure(rec)
    assert rec['image_tokens'] == 4
    _launch_checks(rec, 1)


def test_phase23_shapes_are_the_published_configs():
    """The published widths each model's HF config gives: Qwen2-VL-7B's
    1024 patches of 1176 into 256 tokens, InternVL3-8B's 256 image tokens
    of 4096 into its projector, OneVision-7B's 729 patches and its 36
    pinpoints, MiniCPM-Llama3-V-2.5's 96 queries into 4096."""
    q = chip_smoke.QWEN2VL_7B
    assert q['text']['hidden_size'] == 3584 and q['text']['vocab_size'] \
        == 152064 and q['vision']['num_hidden_layers'] == 32
    assert 3 * q['temporal_patch_size'] * q['patch_size'] ** 2 == 1176
    assert sum(q['mrope_section']) == q['text']['head_dim'] // 2
    i = chip_smoke.INTERNVL3_8B
    assert (i['image_size'] // i['patch_size']) ** 2 // 4 == 256
    assert i['text']['vocab_size'] == 151674
    o = chip_smoke.ONEVISION_7B
    assert (o['image_size'] // o['patch_size']) ** 2 == 729
    assert len(o['image_grid_pinpoints']) == 36
    m = chip_smoke.MINICPMV_25
    assert m['num_queries'] == 96 and m['text']['hidden_size'] == 4096
    assert chip_smoke.PRUNEVID == {
        'method': 'PruneVid', 'taus': 0.5, 'cluster_ratios': 0.5,
        'temporal_segment_ratios': 0.34}
