"""The decode PPL's and the last methods' paths on the card against the CPU:
decode_nll and decode_logits at 2 layers of Llama-2-7B's width over the fp
and int8 caches (through the flash-decode kernel, once a layer a fed step)
and over the KIVI and Sink caches (the plain masked read, no kernel), the
logits of every step held to the CPU's and to the kernel's plain version,
each bound set below what a planted fault moves them; and one SpQR and one
DGQ block (float32 both, the card's matmuls without TF32).  Every test
needs a CUDA card and skips without one; run them on the card with
``pytest -m gpu``."""

import numpy as np
import pytest
import torch

from llmc_tpu_torch.compression.quantization.dgq import DGQ
from llmc_tpu_torch.compression.quantization.spqr import SpQR
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
from llmc_tpu_torch.ops.flash_decode import flash_decode_plain
from llmc_tpu_torch.serve import decode
from llmc_tpu_torch.serve.decode import decode_logits, decode_nll
from llmc_tpu_torch.serve.kvcache import KVCachePolicy
from llmc_tpu_torch.utils import Cfg
from torch_port_helpers import cuda_device, method_quant  # noqa: F401

LLAMA2_7B_2L = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=11008, num_hidden_layers=2,
                    num_attention_heads=32, num_key_value_heads=32,
                    head_dim=128, dtype='float32')
CARD_F32 = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=2, head_dim=64, dtype='float32')
POLICIES = {'fp': dict(method='fp'), 'naive': dict(method='naive', bit=8),
            'kivi': dict(method='kivi', bit=4, residual_length=16),
            'sink': dict(method='sink', num_sink_tokens=4, window_length=16)}
# planted faults, each read on the CPU against the fp cache's logits: what
# a cache read that goes wrong moves them by (a 4-bit cache; a window that
# drops all but the last 8 positions)
FAULTS = {'naive_4bit': dict(method='naive', bit=4),
          'window_8': dict(method='sink', num_sink_tokens=0,
                           window_length=8)}
# The random model's logits are near uniform, so the NLL hardly moves with
# what attention returns; the logits themselves do.  ``_rel``: the largest
# over the fed steps of a step's |got - want| / |want| (L2 over the
# vocabulary).
# The card's bf16 model (bf16 weights, activations and cache) against the
# CPU's float32 one, through 2 layers.  Measured on an H100: fp 8.8e-3,
# naive int8 1.4e-2, kivi 4-bit 3.2e-2 (codes near a rounding tie flip),
# sink 9.1e-3; the planted faults 0.168 (4-bit cache) and 1.31 (window).
TOL_LOGITS_BF16 = 5e-2
# The flash-decode kernel against its plain version in the same decode on
# the card (the same bf16 model and caches): f32 sums in another order,
# whose last bits flip a bf16 rounding of the attention output now and
# then.  Measured on an H100: fp 4.9e-3, naive int8 5.2e-3.
TOL_LOGITS_B2_PLAIN = 1e-2
IDS = np.random.RandomState(1).randint(0, 32000, (2, 48))


def _rel(got, want) -> float:
    d = torch.linalg.vector_norm((got - want).double(), dim=-1)
    return float((d / torch.linalg.vector_norm(want.double(), dim=-1)).max())


def _to(tree, dev, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        if dtype is not None and tree.is_floating_point():
            tree = tree.to(dtype)
        return tree.to(dev)
    return tree


@pytest.fixture(scope='module')
def models():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the decode kernels run only there '
                    '(pytest -m gpu on the card)')
    cpu = LlamaAdapter.random(LlamaConfig(**LLAMA2_7B_2L), seed=0,
                              device='cpu')
    card = LlamaAdapter(LlamaConfig(**dict(LLAMA2_7B_2L, dtype='bfloat16')),
                        _to(cpu.params, 'cuda', torch.bfloat16))
    return cpu, card


@pytest.fixture(scope='module')
def fault_reads(models):
    """What each planted fault moves the CPU's logits by (``_rel``
    against the fp cache's)."""
    cpu = models[0]
    fp = decode_logits(cpu, IDS, device='cpu')
    return {k: _rel(decode_logits(cpu, IDS, kv_policy=KVCachePolicy(**kw),
                                  device='cpu'), fp)
            for k, kw in FAULTS.items()}


@pytest.mark.gpu
@pytest.mark.parametrize('policy', list(POLICIES))
def test_decode_nll_card_equals_cpu(models, fault_reads, policy):
    """decode_nll and decode_logits over each cache at 2 layers of
    Llama-2-7B width: the card's bf16 logits of every fed step within
    ``TOL_LOGITS_BF16`` of the CPU's float32 ones, a bound that each
    planted fault exceeds at least twice over; the NLL within 1e-2
    relative; the flash-decode kernel launched once a layer a fed step
    over the fp and int8 caches, never over KIVI's and Sink's."""
    cpu, card = models
    pol = KVCachePolicy(**POLICIES[policy])
    want_nll, n = decode_nll(cpu, IDS, kv_policy=pol, device='cpu')
    want = decode_logits(cpu, IDS, kv_policy=pol, device='cpu')
    reset_launch_counts()
    got_nll, n2 = decode_nll(card, IDS, kv_policy=pol, device='cuda')
    counts = launch_counts()
    got = decode_logits(card, IDS, kv_policy=pol, device='cuda').cpu()
    rel = _rel(got, want)
    print(f'{policy}: card vs CPU {rel:.4g}; faults {fault_reads}')
    assert n == n2 == 2 * 47
    assert abs(float(got_nll) - float(want_nll)) <= 1e-2 * abs(
        float(want_nll))
    assert rel <= TOL_LOGITS_BF16
    assert min(fault_reads.values()) >= 2 * TOL_LOGITS_BF16
    b2 = 47 * 2 if policy in ('fp', 'naive') else 0
    assert counts['flash_decode'] == b2
    assert sum(counts.values()) == b2


@pytest.mark.gpu
@pytest.mark.parametrize('policy', ['fp', 'naive'])
def test_decode_flash_kernel_equals_plain_read_on_card(models, fault_reads,
                                                       policy, monkeypatch):
    """The same bf16 decode on the card through the flash-decode kernel
    and through its plain version (``ATTN_IMPL`` 'auto' pointed at it):
    the logits of every step within ``TOL_LOGITS_B2_PLAIN``, a bound that
    each planted fault exceeds at least twice over, and no launch in the
    plain run."""
    card = models[1]
    pol = KVCachePolicy(**POLICIES[policy])
    got = decode_logits(card, IDS, kv_policy=pol, device='cuda')
    monkeypatch.setitem(decode._DECODE_KERNELS, 'auto', flash_decode_plain)
    reset_launch_counts()
    want = decode_logits(card, IDS, kv_policy=pol, device='cuda')
    assert sum(launch_counts().values()) == 0
    rel = _rel(got, want)
    print(f'{policy}: flash-decode vs its plain version {rel:.4g}')
    assert rel <= TOL_LOGITS_B2_PLAIN
    assert min(fault_reads.values()) >= 2 * TOL_LOGITS_B2_PLAIN


def _block(cls, quant, dev):
    """One block of ``cls`` on ``dev`` (float32) from the same weights and
    calibration inputs."""
    cfg = Cfg(dict(model=dict(type='Llama'), quant=quant))
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (4, 64)))
    m = LlamaAdapter.random(LlamaConfig(**CARD_F32), seed=0, device='cpu')
    m.params = _to(m.params, dev)
    xs, kws = m.collect_first_block_input([{'input_ids': ids}])
    algo = cls(m, cfg['quant'], {'data': xs, 'kwargs': kws}, None, cfg)
    algo.run_block_loop()
    return algo, m


@pytest.mark.gpu
def test_spqr_block_card_equals_cpu(cuda_device):  # noqa: F811
    """One SpQR block as shipped (asymmetric W4 g128, the simplified
    pre-pass) on the card and on the CPU: the outlier marks equal in 99.99%
    of the weights, the double-quantized scales within 1e-5 relative where
    99% of them are, the baked weights within 1e-5 where 99.5% of them are
    and more than a step apart in at most 0.05% of them.  The f32 Cholesky
    factors differ in their last bits, which the compensation carries on:
    a code or a mark near its edge flips, and the later columns of its
    group follow it (on an H100: 99.86% within 1e-5, 0.01% a step apart,
    at most 6 marks of 131072 differ)."""
    out = []
    for dev in ('cpu', cuda_device):
        algo, m = _block(SpQR, dict(method_quant('spqr_w4'), weight=dict(
            bit=4, symmetric=False, granularity='per_group',
            group_size=128)), dev)
        algo.deploy('fake_quant')
        out.append([(lin['spqr_mask'].cpu(), lin['gptq_scales'].cpu(),
                     lin['w'].cpu()) for lin in (
            m.blocks[0]['self_attn']['q_proj'], m.blocks[0]['mlp']['up_proj'],
            m.blocks[0]['mlp']['down_proj'])])
    for (mc, sc, wc), (mg, sg, wg) in zip(*out):
        assert float((mc == mg).float().mean()) >= 0.9999
        assert 0 < float(mc.mean()) < 0.2
        rel = ((sg - sc).abs() / sc.abs().clamp(min=1e-9)).flatten()
        assert float((rel <= 1e-5).float().mean()) >= 0.99
        d = (wg - wc).abs()
        assert float((d <= 1e-5).float().mean()) >= 0.995
        assert float((d > 1.01 * sc.max()).float().mean()) <= 5e-4


@pytest.mark.gpu
def test_dgq_block_card_equals_cpu(cuda_device):  # noqa: F811
    """One DGQ block as shipped (int4 groups of 128 under per-token A8) on
    the card and on the CPU: the integer group scales and zero points equal
    in 99% of the (channel, group) pairs, the int8 super-scales within
    1e-5 relative where 99% of them are (the grid losses are f32 products
    summed in other orders: a near-tie may fall the other way)."""
    out = []
    for dev in ('cpu', cuda_device):
        algo, m = _block(DGQ, dict(method_quant('dgq_w4a8'), weight=dict(
            bit=4, symmetric=False, granularity='per_group',
            group_size=128)), dev)
        out.append([tuple(lin[k].cpu() for k in ('dgq_s4', 'dgq_z4',
                                                 'dgq_s8'))
                    for lin in (m.blocks[0]['self_attn']['q_proj'],
                                m.blocks[0]['mlp']['gate_proj'],
                                m.blocks[0]['mlp']['down_proj'])])
    for (s4c, z4c, s8c), (s4g, z4g, s8g) in zip(*out):
        assert float((s4c == s4g).float().mean()) >= 0.99
        assert float((z4c == z4g).float().mean()) >= 0.99
        rel = (s8g - s8c).abs() / s8c.abs()
        assert float((rel <= 1e-5).float().mean()) >= 0.99
