"""The straight-through and input-channel fake-quant paths, and one
gradient-trained block, on the card against the CPU (float32 both; the
card's float32 matmuls without TF32).  Every test needs a CUDA card and
skips without one; run them on the card with ``pytest -m gpu``."""

import numpy as np
import pytest
import torch

from llmc_tpu_torch.compression.quantization.ntweak import NormTweaking
from llmc_tpu_torch.compression.quantization.omniq import OmniQuant
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.quant import quantizer as TQ
from llmc_tpu_torch.quant.qspec import QuantSpec
from llmc_tpu_torch.utils import Cfg

W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=32,
          calib_algo='learnable')
CARD_F32 = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=2, head_dim=32, dtype='float32')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the card paths run only there '
                    '(pytest -m gpu on the card)')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('kw', [
    dict(bit=8, symmetric=True, granularity='per_channel'),
    dict(bit=4, symmetric=False, granularity='per_group', group_size=32)])
def test_dim_ic_fake_quant_card_equals_cpu(card, kw):
    """AdaDim's input-channel fake-quant on a CUDA tensor, bit for bit the
    CPU's (elementwise IEEE operations and exact reductions)."""
    w = torch.randn(256, 512, generator=torch.Generator().manual_seed(0))
    for folded in (False, True):
        want = TQ.fake_quant_weight(QuantSpec(**kw), w, dim_ic=True,
                                    folded=folded)
        got = TQ.fake_quant_weight(QuantSpec(**kw), w.to(card), dim_ic=True,
                                   folded=folded)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_ste_gradients_card_equal_cpu(card):
    """The straight-through gradients of the weight fake-quant in its clip
    factors and its weight, and of the activation fake-quant in its input,
    on CUDA tensors: within 1e-6 of the CPU's (the card sums the factors'
    gradients over a group in another order)."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn(64, 128, generator=g) * 0.1
    up = torch.rand(256, 1, generator=g) * 3 + 2
    low = torch.rand(256, 1, generator=g) * 3 + 2
    c = torch.randn(64, 128, generator=g)
    a = torch.randn(2, 7, 128, generator=g) * 2
    ca = torch.randn(2, 7, 128, generator=g)
    grads = []
    for dev in ('cpu', card):
        ts = [t.to(dev, copy=True).requires_grad_()
              for t in (w, up, low, a)]
        out = TQ.fake_quant_weight(QuantSpec(**W4), ts[0], ts[1], ts[2],
                                   round_fn=TQ.ste_round)
        outa = TQ.fake_quant_act(
            QuantSpec(bit=8, symmetric=False, granularity='per_token'),
            ts[3], round_fn=TQ.ste_round)
        ((out * c.to(dev)).sum() + (outa * ca.to(dev)).sum()).backward()
        grads.append([t.grad.cpu().numpy() for t in ts])
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_omniquant_block_card_equals_cpu(card):
    """One OmniQuant block (learnable clips, 3 AdamW steps) on the card and
    on the CPU from the same weights and calibration inputs: the block
    loss before and after within 1e-4 relative, the trained clip factors
    within 1e-5 where 99% of them are, all within 5e-4 (Adam's first steps
    move a factor whose gradient lies near its epsilon by an amount that
    the gradient's last bits steer; see test_torch_trained_methods.py)."""
    cfg = Cfg(dict(model=dict(type='Llama'), quant=dict(
        method='OmniQuant', weight=dict(W4, calib_algo='minmax'),
        special=dict(epochs=3, lwc=True, let=False))))
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (4, 32)))
    out = []
    for dev in ('cpu', card):
        m = LlamaAdapter.random(LlamaConfig(**CARD_F32), seed=0,
                                device='cpu')
        m.params = _to(m.params, dev)
        xs, kws = m.collect_first_block_input([{'input_ids': ids}])
        algo = OmniQuant(m, cfg['quant'], {'data': xs, 'kwargs': kws}, None,
                         cfg)
        algo.run_block_loop()
        lin = m.blocks[0]['mlp']['down_proj']
        out.append((algo.train_stats['block_loss'][0],
                    torch.cat([lin['clip_up'], lin['clip_low']]).cpu()))
    (cpu_loss, cpu_f), (card_loss, card_f) = out
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-4)
    d = (card_f - cpu_f).abs()
    assert float(d.max()) <= 5e-4
    assert float((d <= 1e-5).float().mean()) >= 0.99
    assert float((cpu_f - 4.0).abs().max()) >= 1e-2


@pytest.mark.gpu
def test_normtweaking_block_card_equals_cpu(card):
    """One NormTweaking block (3 AdamW steps at ``tweak_lr`` 1e-2, where
    the shipped 1e-5 moves no bf16 norm: these steps move norms of 1 by up
    to 3e-2, four bf16 steps) on the card and on the CPU from the same
    weights and calibration inputs: the block loss before and after within
    1e-4 relative, and lower after; the trained norms within 1e-5 where 99%
    of them are, all within 5e-4 (as OmniQuant's clips); every norm
    moved, the farthest by at least 2e-2."""
    cfg = Cfg(dict(model=dict(type='Llama'), quant=dict(
        method='NormTweaking', weight=dict(W4, calib_algo='minmax'),
        special=dict(epochs=3, tweak_lr=1e-2))))
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (4, 32)))
    out = []
    for dev in ('cpu', card):
        m = LlamaAdapter.random(LlamaConfig(**CARD_F32), seed=0,
                                device='cpu')
        m.params = _to(m.params, dev)
        xs, kws = m.collect_first_block_input([{'input_ids': ids}])
        algo = NormTweaking(m, cfg['quant'], {'data': xs, 'kwargs': kws},
                            None, cfg)
        algo.run_block_loop()
        out.append((algo.train_stats['block_loss'][0], torch.cat(
            [m.blocks[0][ln]['w'] for ln in algo.layout.layernorms]).cpu()))
    (cpu_loss, cpu_w), (card_loss, card_w) = out
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-4)
    d = (card_w - cpu_w).abs()
    assert float(d.max()) <= 5e-4
    assert float((d <= 1e-5).float().mean()) >= 0.99
    assert cpu_loss[1] < cpu_loss[0]
    assert bool(((cpu_w - 1.0).abs() > 0).all())
    assert float((cpu_w - 1.0).abs().max()) >= 2e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree
