"""The LLaVA tier on the card (``gpu`` marker; each test skips without a
card), at small widths: a packed LLaVA served by ``vlm_greedy_generate``
through B1 and B2 / B5, its captured decode's tokens equal to the eager
decode's and to the CPU port's, the launches its path implies and no
call of the XLA branch, VisionZip through the same cached path; FastV and
Video-LLaVA with DyCoke against the CPU port; ViT W8A8 against the CPU
port.  The phases are ``chip_smoke.py``'s phase 22 at these widths."""

import pytest

import chip_smoke
from torch_port_helpers import cuda_device  # noqa: F401

PEAKS = chip_smoke.PEAKS['H100 SXM']
# widths every kernel takes (K a multiple of 128, head dim 64)
LLAVA_CARD = dict(
    text=dict(vocab_size=512, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, head_dim=64, dtype='bfloat16'),
    vision=dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                num_attention_heads=2),
    image_size=112, patch_size=14, image_token_index=500)


@pytest.mark.gpu
def test_card_serves_a_packed_llava(cuda_device, monkeypatch):  # noqa: F811
    monkeypatch.setattr(chip_smoke, 'VISIONZIP', dict(
        method='VisionZip', dominant=12, contextual=4))
    rec, _ = chip_smoke.phase22_serve(
        cuda_device, PEAKS, spec=LLAVA_CARD, serve=dict(
            batch=4, text_tokens=8, new_tokens=8, cpu_layers=2,
            cpu_new_tokens=6))
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    for run in chip_smoke.phase22_launch_checks(rec):
        assert run['launches'] == run['expected_launches'], run['phase']
        assert run['xla_branch_calls'] == 0
    assert rec['visionzip']['image_tokens_after'] == 16


@pytest.mark.gpu
def test_card_fastv_and_dycoke_equal_the_cpu(cuda_device,  # noqa: F811
                                             monkeypatch):
    monkeypatch.setattr(chip_smoke, 'FASTV', dict(method='FastV',
                                                   prune_layer=2, keep=20))
    spec = dict(LLAVA_CARD, text=dict(LLAVA_CARD['text'],
                                      num_hidden_layers=3))
    rec = chip_smoke.phase22_fastv(cuda_device, chip_smoke.llava_model(
        cuda_device, spec), prompt_tokens=8)
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    rec = chip_smoke.phase22_videollava(
        cuda_device, spec=LLAVA_CARD, layers=2,
        video=dict(image_size=56, num_frames=8, video_token_index=501),
        cpu=dict(layers=2, tower_layers=(3, 'small')), prompt_tokens=8)
    assert rec['ok'], chip_smoke.phase22_failure(rec)


@pytest.mark.gpu
def test_card_vit_equals_the_cpu(cuda_device):  # noqa: F811
    arch = dict(image_size=64, patch_size=16, hidden_size=128,
                intermediate_size=256, num_hidden_layers=3,
                num_attention_heads=4, num_labels=50)
    rec = chip_smoke.phase22_vit(cuda_device, arch=arch, run=dict(
        images=16, calib_images=2, cpu_layers=2, cpu_images=8))
    assert rec['ok'], chip_smoke.phase22_failure(rec)
    assert rec['launches'] == rec['expected_launches']
