"""Port parity of the activation quantization (llmc_tpu_torch.quant and
models.base): every quantizer function the port added, bit-equal to the
JAX package's run under ``jax.jit`` where the reference only runs it
jitted (the scale as XLA folds ``amax / qmax``), or eagerly where it runs
eagerly; the packed int4 layout; the W48 pair with its budgets; the
masked (LLM.int8) quantizers; ``attn_act_fq``; and on the card a packed
linear with ``a_spec`` through the W4 and W8 kernels."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import base as JB
from llmc_tpu.models.adapter import QMap as JQMap
from llmc_tpu.quant import quantizer as JQ
from llmc_tpu.quant.qspec import QuantSpec as JSpec
from llmc_tpu_torch.models import base as TB
from llmc_tpu_torch.models.adapter import QMap
from llmc_tpu_torch.quant import quantizer as TQ
from llmc_tpu_torch.quant.qspec import QuantSpec
from torch_port_helpers import cuda_device, rel_err  # noqa: F401

TD = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
torch.set_num_threads(1)

ACT_SPECS = {
    'a8_sym_token': dict(bit=8, symmetric=True, granularity='per_token'),
    'a8_asym_token': dict(bit=8, symmetric=False, granularity='per_token'),
    'a8_sym_tensor': dict(bit=8, symmetric=True, granularity='per_tensor'),
    'a4_asym_g32': dict(bit=4, symmetric=False, granularity='per_group',
                        group_size=32),
    'a8_nozp_token': dict(bit=8, symmetric=False, granularity='per_token',
                          round_zp=False),
    'e4m3_token': dict(bit='e4m3', granularity='per_token'),
    'e4m3_elementwise': dict(bit='e4m3', granularity='per_token',
                             use_fp_scaled_cast=False),
}


def _a(seed=0, shape=(3, 7, 96), scale=3.0):
    """Activations with rows whose true division and f32-reciprocal
    multiply by qmax differ."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    x[..., 0] = 1 + 0.01 * np.arange(np.prod(shape[:-1])).reshape(shape[:-1])
    return x


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('name', sorted(ACT_SPECS))
def test_fake_quant_act_bit_equal_to_jitted_reference(name):
    """Bit for bit, except the per-element exponent scales of a float
    format without the scaled cast (log2 / exp2, whose last bits differ
    between XLA and torch): within 2e-6 relative there."""
    kw = ACT_SPECS[name]
    x = _a()
    want = jax.jit(lambda t: JQ.fake_quant_act(JSpec(**kw), t))(
        jnp.asarray(x))
    got = TQ.fake_quant_act(QuantSpec(**kw), torch.as_tensor(x))
    if name == 'e4m3_elementwise':
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    else:
        _eq(got.numpy(), want)


@pytest.mark.parametrize('sym', [True, False])
def test_static_fake_quants_bit_equal(sym):
    """fake_quant_act_static and fake_quant_weight_static with given
    qparams (per tensor and per channel)."""
    x = _a(1)
    spec = dict(bit=8, symmetric=sym, granularity='per_tensor')
    qp = JQ.static_qparams_from_batches(JSpec(**spec), [jnp.asarray(x)],
                                        'static_minmax')
    tqp = TQ.QParams(torch.as_tensor(np.array(qp.scales)),
                     torch.as_tensor(np.array(qp.zeros)))
    want = jax.jit(lambda t: JQ.fake_quant_act_static(JSpec(**spec), t, qp))(
        jnp.asarray(x))
    _eq(TQ.fake_quant_act_static(QuantSpec(**spec), torch.as_tensor(x),
                                 tqp).numpy(), want)
    w = _a(2, (48, 64))
    wspec = dict(bit=4, symmetric=sym, granularity='per_group',
                 group_size=32)
    t, jqp = JQ.tensor_qparams(JSpec(**wspec), jnp.asarray(w))
    want = JQ.fake_quant_weight_static(JSpec(**wspec), jnp.asarray(w), jqp)
    tq = TQ.QParams(torch.as_tensor(np.array(jqp.scales)),
                    torch.as_tensor(np.array(jqp.zeros)))
    _eq(TQ.fake_quant_weight_static(QuantSpec(**wspec), torch.as_tensor(w),
                                    tq).numpy(), want)


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('gran', ['per_channel', 'per_group'])
def test_mse_range_bit_equal_to_jitted_reference(sym, gran):
    w = _a(3, (32, 128), 1.0)
    kw = dict(bit=4, symmetric=sym, granularity=gran, group_size=32,
              calib_algo='mse')
    jt = JQ.reshape_tensor(JSpec(**kw), jnp.asarray(w))
    jmn, jmx = jax.jit(lambda t: JQ.mse_range(JSpec(**kw), t))(jt)
    tt = TQ.reshape_tensor(QuantSpec(**kw), torch.as_tensor(w))
    tmn, tmx = TQ.mse_range(QuantSpec(**kw), tt)
    _eq(tmn.numpy(), jmn)
    _eq(tmx.numpy(), jmx)


def test_hqq_qparams_match_jitted_reference():
    """hqq's scales bit for bit; its zeros (means refined in a loop, summed
    in another order) within 1e-5."""
    w = _a(4, (16, 128), 1.0)
    kw = dict(bit=4, symmetric=False, granularity='per_group', group_size=64,
              calib_algo='hqq', round_zp=False)
    jt = JQ.reshape_tensor(JSpec(**kw), jnp.asarray(w))
    jqp = jax.jit(lambda t: JQ.hqq_qparams(JSpec(**kw), t))(jt)
    tqp = TQ.hqq_qparams(QuantSpec(**kw),
                         TQ.reshape_tensor(QuantSpec(**kw),
                                           torch.as_tensor(w)))
    _eq(tqp.scales.numpy(), jqp.scales)
    np.testing.assert_allclose(tqp.zeros.numpy(), np.asarray(jqp.zeros),
                               atol=1e-5)


@pytest.mark.parametrize('signed', [True, False])
def test_pack_unpack_int4_bit_equal(signed):
    rng = np.random.RandomState(5)
    lo = -8 if signed else 0
    codes = rng.randint(lo, lo + 16, (6, 32)).astype(np.int8)
    jp = JQ.pack_int4(jnp.asarray(codes))
    tp = TQ.pack_int4(torch.as_tensor(codes))
    assert tp.dtype == torch.int8
    _eq(tp.numpy(), jp)
    _eq(TQ.unpack_int4(tp, signed).numpy(), JQ.unpack_int4(jp, signed))
    if signed:
        _eq(TQ.unpack_int4(tp).numpy(), codes)


W48_BUDGETS = {
    'none': (dict(symmetric=False, granularity='per_channel'),
             dict(granularity='per_group', group_size=32), None, None),
    'afp8': (dict(symmetric=True, granularity='per_channel',
                  int_range=(-120, 120)),
             dict(symmetric=False, granularity='per_group', group_size=32),
             None, (-128.0, 127.0, -128.0, 127.0)),
}


@pytest.mark.parametrize('name', sorted(W48_BUDGETS))
def test_w48_bit_equal_to_jitted_reference(name):
    b8, b4, c8, c4 = W48_BUDGETS[name]
    w = _a(6, (24, 128), 0.05)
    j8, j4 = JSpec(bit=8, **b8), JSpec(bit=4, **b4)
    want = jax.jit(lambda t: JQ.fake_quant_weight_w48(
        j8, j4, t, clamps8=c8, clamps4=c4))(jnp.asarray(w))
    got = TQ.fake_quant_weight_w48(QuantSpec(bit=8, **b8),
                                   QuantSpec(bit=4, **b4),
                                   torch.as_tensor(w), clamps8=c8,
                                   clamps4=c4)
    _eq(got.numpy(), want)


@pytest.mark.parametrize('sym', [True, False])
def test_masked_quantizers_bit_equal_to_jitted_reference(sym):
    x = _a(7)
    x[..., 5] = 20.0
    mask = np.abs(x).reshape(-1, 96).max(0) <= 6.0
    aspec = dict(bit=8, symmetric=sym, granularity='per_token')
    want = jax.jit(lambda t, m: JQ.fake_quant_act_masked(
        JSpec(**aspec), t, m))(jnp.asarray(x), jnp.asarray(mask))
    got = TQ.fake_quant_act_masked(QuantSpec(**aspec), torch.as_tensor(x),
                                   torch.as_tensor(mask))
    _eq(got.numpy(), want)
    w = _a(8, (40, 96), 0.1)
    wspec = dict(bit=8, symmetric=sym, granularity='per_channel')
    want = jax.jit(lambda t, m: JQ.fake_quant_weight_masked(
        JSpec(**wspec), t, m))(jnp.asarray(w), jnp.asarray(mask))
    got = TQ.fake_quant_weight_masked(QuantSpec(**wspec), torch.as_tensor(w),
                                      torch.as_tensor(mask))
    _eq(got.numpy(), want)


def test_ste_round_raises_with_its_roadmap_item():
    """Straight-through rounding raised (ROADMAP A10) until it was ported:
    now it rounds as jnp.round does and passes the gradient through."""
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.3],
                     requires_grad=True)
    y = TQ.ste_round(x)
    _eq(y.detach().numpy(), jnp.round(jnp.asarray(x.detach().numpy())))
    y.sum().backward()
    _eq(x.grad.numpy(), np.ones(7, np.float32))


@pytest.mark.parametrize('static', [False, True])
def test_linear_apply_with_act_quant_matches(static):
    """linear_apply with a dynamic or static a_spec and a w_spec: the
    reference's output within 1e-5 (its weight qdq runs jitted)."""
    rng = np.random.RandomState(9)
    w = rng.randn(48, 64).astype(np.float32) * 0.1
    x = _a(10, (2, 5, 64))
    aspec = dict(bit=8, symmetric=True,
                 granularity='per_tensor' if static else 'per_token')
    wspec = dict(bit=8, symmetric=True, granularity='per_channel')
    jp, tp = {'w': jnp.asarray(w), 'b': None}, {'w': torch.as_tensor(w),
                                               'b': None}
    if static:
        qp = JQ.static_qparams_from_batches(JSpec(**aspec), [jnp.asarray(x)],
                                            'static_minmax')
        jp.update(a_scales=qp.scales, a_zeros=qp.zeros)
        tp.update(a_scales=torch.as_tensor(np.array(qp.scales)),
                  a_zeros=torch.as_tensor(np.array(qp.zeros)))
    want = jax.jit(lambda p, t: JB.linear_apply(p, t, JB.LinearQcfg(
        w_spec=JSpec(**wspec), a_spec=JSpec(**aspec), a_static=static)))(
        jp, jnp.asarray(x))
    got = TB.linear_apply(tp, torch.as_tensor(x), TB.LinearQcfg(
        w_spec=QuantSpec(**wspec), a_spec=QuantSpec(**aspec),
        a_static=static))
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_attn_act_fq_bit_equal():
    """The quantized-attention pseudo-path policies fake-quantize as the
    reference's; paths without a policy pass through."""
    x = _a(11, (2, 4, 3, 16))
    spec = dict(bit=8, symmetric=True, granularity='per_token')
    jq = JQMap({'self_attn.matmul_1': JB.LinearQcfg(a_spec=JSpec(**spec))})
    tq = QMap({'self_attn.matmul_1': TB.LinearQcfg(a_spec=QuantSpec(**spec))})
    want = jax.jit(lambda t: JB.attn_act_fq(jq, 'self_attn.matmul_1', t))(
        jnp.asarray(x))
    got = TB.attn_act_fq(tq, 'self_attn.matmul_1', torch.as_tensor(x))
    _eq(got.numpy(), want)
    t = torch.as_tensor(x)
    assert TB.attn_act_fq(tq, 'self_attn.softmax', t) is t


@pytest.mark.gpu
@pytest.mark.parametrize('bits', [4, 8])
def test_packed_a_spec_linear_launches_the_kernel_on_card(cuda_device, bits):
    """A packed linear with a per-token a_spec on the card: W4 g128 through
    B1, W8 per channel through B4, each launched once, no XLA branch, the
    activation fake-quant on the card, within 1e-2 of the CPU's plain
    version (bf16 operands on the card)."""
    from llmc_tpu_torch.quant.quantizer import real_quant_weight
    rng = np.random.RandomState(bits)
    N, K = 256, 512
    w = torch.as_tensor(rng.randn(N, K).astype(np.float32) * 0.05)
    wspec = (QuantSpec(bit=4, symmetric=False, granularity='per_group',
                       group_size=128) if bits == 4 else
             QuantSpec(bit=8, symmetric=True, granularity='per_channel'))
    codes, scales, zeros = real_quant_weight(wspec, w)
    meta = TD.QMeta(bits=bits, group_size=128 if bits == 4 else K,
                    symmetric=wspec.symmetric, out_features=N, in_features=K)
    qw, s, z = TD.pack_weight(codes.to(torch.int8), scales, zeros, meta)
    p = {'qweight': qw, 'scales': s, 'b': None}
    if z is not None:
        p['zeros'] = z
    qc = TB.LinearQcfg(w_packed=True, qmeta=meta, a_spec=QuantSpec(
        bit=8, symmetric=True, granularity='per_token'))
    x = torch.as_tensor(_a(12, (3, 5, K), 1.0)).to(torch.bfloat16)
    pd = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
          for k, v in p.items()}
    name = 'w4_dequant_matmul' if bits == 4 else 'w8_dequant_matmul'
    before, xla = TD.LAUNCHES[name], TD.XLA_BRANCH['xla_branch_calls']
    got = TB.linear_apply(pd, x.to(cuda_device), qc)
    torch.cuda.synchronize()
    assert TD.LAUNCHES[name] == before + 1
    assert TD.XLA_BRANCH['xla_branch_calls'] == xla
    want = TB.linear_apply(p, x.float(), dataclasses.replace(qc))
    assert rel_err(got.float().cpu().numpy(), want.numpy()) < 1e-2
