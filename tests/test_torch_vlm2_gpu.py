"""Qwen2-VL, InternVL, LLaVA-OneVision and MiniCPM-V on the card (``gpu``
marker; each test skips without a card), at small widths: each packed LM
through B1 in the eager forward with an image (or a video), its logits
against the fake-quant model and the card against the CPU port, the
launches its path implies and no call of the XLA branch; Qwen2-VL's text
served through B1 and B2 / B5, its captured decode's tokens equal to the
eager decode's.  The phases are ``chip_smoke.py``'s phase 23 at these
widths."""

import pytest

import chip_smoke
from torch_port_helpers import cuda_device  # noqa: F401

PEAKS = chip_smoke.PEAKS['H100 SXM']
# widths every kernel takes (K a multiple of 128, head dim 64, GQA)
LM = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=64, attention_bias=True, dtype='bfloat16')
TOWER = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=2)


def _require(rec):
    assert rec['ok'], chip_smoke.phase23_failure(rec)
    for run in chip_smoke.phase23_launch_checks(rec):
        assert run['launches'] == run['expected_launches'], run['phase']
        assert run['xla_branch_calls'] == 0


@pytest.mark.gpu
def test_card_serves_a_packed_qwen2vl(cuda_device):  # noqa: F811
    spec = dict(text=dict(LM, rope_theta=1e6, rope_scaling_type='mrope'),
                vision=TOWER, mrope_section=(8, 12, 12), patch_size=14,
                temporal_patch_size=2, spatial_merge_size=2,
                image_token_id=500, vision_start_token_id=498)
    rec = chip_smoke.phase23_qwen2vl(
        cuda_device, PEAKS, spec=spec, run=dict(
            batch=2, grid=(1, 8, 8), text_tokens=8, text_batch=4,
            text_prompt=16, new_tokens=8, cpu_layers=2, cpu_grid=(1, 4, 4)),
        timing_steps=4)
    _require(rec)
    assert rec['image_tokens'] == 16


@pytest.mark.gpu
def test_card_internvl_onevision_minicpmv(cuda_device):  # noqa: F811
    rec = chip_smoke.phase23_internvl(
        cuda_device, PEAKS, spec=dict(text=LM, vision=TOWER, image_size=56,
                                      patch_size=14, image_token_id=500,
                                      downsample_ratio=0.5),
        layers=2, batch=2, text_tokens=8, cpu_layers=2,
        vit6b=dict(hidden_size=200, intermediate_size=400, layers=2,
                   heads=5, tokens=65))
    _require(rec)
    rec = chip_smoke.phase23_onevision(
        cuda_device, PEAKS, spec=dict(
            text=LM, vision=TOWER, image_size=56, patch_size=14,
            image_token_index=500, video_token_index=501,
            vision_aspect_ratio='anyres_max_9',
            image_grid_pinpoints=((56, 56), (56, 112), (112, 112))),
        layers=2, run=dict(image=(112, 112), frames=4, text_tokens=8,
                           cpu_layers=2, cpu_frames=2))
    _require(rec)
    rec = chip_smoke.phase23_minicpmv(
        cuda_device, PEAKS, spec=dict(
            text=dict(LM, attention_bias=False), vision=TOWER,
            image_size=56, patch_size=14, num_queries=8,
            image_token_index=500), layers=2, text_tokens=8, cpu_layers=2)
    _require(rec)
