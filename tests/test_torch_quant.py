"""Port parity of the integer quantizers (llmc_tpu_torch.quant): codes,
scales and zeros must be bit-equal to llmc_tpu at f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.quant import quantizer as JQ
from llmc_tpu.quant.qspec import QuantSpec as JSpec
from llmc_tpu.quant.qspec import spec_from_config as j_spec_from_config
from llmc_tpu_torch.quant import quantizer as TQ
from llmc_tpu_torch.quant.qspec import QuantSpec
from llmc_tpu_torch.quant.qspec import spec_from_config

torch.set_num_threads(1)

SPECS = {
    'w4_sym_g32': dict(bit=4, symmetric=True, granularity='per_group',
                       group_size=32),
    'w4_asym_g32': dict(bit=4, symmetric=False, granularity='per_group',
                        group_size=32),
    'w8_sym_channel': dict(bit=8, symmetric=True,
                           granularity='per_channel'),
    'w4_asym_tensor': dict(bit=4, symmetric=False,
                           granularity='per_tensor'),
    'w3_asym_g24_nozp': dict(bit=3, symmetric=False, granularity='per_group',
                             group_size=24, round_zp=False),
}


def _w(seed=0, shape=(48, 96)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# integer storage needs rounded zeros
REAL_SPECS = sorted(n for n, kw in SPECS.items() if kw.get('round_zp', True))


@pytest.mark.parametrize('name', REAL_SPECS)
def test_real_quant_weight_bit_equal(name):
    kw = SPECS[name]
    w = _w(1)
    jc, js, jz = JQ.real_quant_weight(JSpec(**kw), jnp.asarray(w))
    tc, ts, tz = TQ.real_quant_weight(QuantSpec(**kw), torch.as_tensor(w))
    assert str(tc.dtype).replace('torch.', '') == str(jc.dtype)
    _eq(tc.numpy(), jc)
    _eq(ts.numpy(), js)
    if jz is None:
        assert tz is None
    else:
        _eq(tz.numpy(), jz)


@pytest.mark.parametrize('name', sorted(SPECS))
def test_fake_quant_weight_bit_equal(name):
    kw = SPECS[name]
    w = _w(2, (40, 100))   # 100 % 32 != 0: exercises the group padding
    want = JQ.fake_quant_weight(JSpec(**kw), jnp.asarray(w))
    got = TQ.fake_quant_weight(QuantSpec(**kw), torch.as_tensor(w))
    _eq(got.numpy(), want)


def test_qparams_and_codes_bit_equal_per_group():
    spec_kw = SPECS['w4_asym_g32']
    w = _w(3)
    jt, jqp = JQ.tensor_qparams(JSpec(**spec_kw), jnp.asarray(w))
    tt, tqp = TQ.tensor_qparams(QuantSpec(**spec_kw), torch.as_tensor(w))
    _eq(tt.numpy(), jt)
    _eq(tqp.scales.numpy(), jqp.scales)
    _eq(tqp.zeros.numpy(), jqp.zeros)
    _eq(TQ.quant(QuantSpec(**spec_kw), tt, tqp).numpy(),
        JQ.quant(JSpec(**spec_kw), jt, jqp))


def test_round_half_to_even_matches():
    """Values on exact .5 ties round to even in both packages."""
    spec = dict(bit=8, symmetric=True, granularity='per_tensor')
    t = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]], np.float32)
    jqp = JQ.qparams_from_range(JSpec(**spec), JQ.minmax_range(
        JSpec(**spec), jnp.asarray(t)))
    tqp = TQ.qparams_from_range(QuantSpec(**spec), TQ.minmax_range(
        QuantSpec(**spec), torch.as_tensor(t)))
    _eq(TQ.quant(QuantSpec(**spec), torch.as_tensor(t), tqp).numpy(),
        JQ.quant(JSpec(**spec), jnp.asarray(t), jqp))


@pytest.mark.parametrize('algo', ['mse', 'hqq', 'learnable', 'clip'])
def test_unported_calibration_raises(algo):
    """The mse / hqq / learnable calibrations, which raised until they were
    ported, and AWQ's stored clip factors (``clip``) give the reference's
    codes, scales and zeros (hqq's float zeros within 1e-6: the means of
    its refinement sum in another order), symmetric and not."""
    if algo != 'clip':
        w = np.random.RandomState(0).randn(16, 128).astype(np.float32)
        for sym in (True, False):
            kw = dict(bit=4, symmetric=sym, granularity='per_group',
                      group_size=32, calib_algo=algo, round_zp=algo != 'hqq')
            jc, js, jz = JQ.real_quant_weight(JSpec(**kw), jnp.asarray(w))
            tc, ts, tz = TQ.real_quant_weight(QuantSpec(**kw),
                                              torch.as_tensor(w))
            _eq(tc.numpy(), jc)
            _eq(ts.numpy(), js)
            if jz is None:
                assert tz is None
            elif algo == 'hqq':
                np.testing.assert_allclose(tz.numpy(), jz, atol=1e-6)
            else:
                _eq(tz.numpy(), jz)
        return
    rng = np.random.RandomState(0)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    up = rng.uniform(0.5, 4.0, (8, 1)).astype(np.float32)
    low = rng.uniform(0.5, 4.0, (8, 1)).astype(np.float32)
    for sym in (True, False):
        kw = dict(bit=4, symmetric=sym, granularity='per_group',
                  group_size=32)
        want = JQ.real_quant_weight(JSpec(**kw), jnp.asarray(w),
                                    jnp.asarray(up), jnp.asarray(low))
        got = TQ.real_quant_weight(QuantSpec(**kw), torch.as_tensor(w),
                                   torch.as_tensor(up), torch.as_tensor(low))
        for g, j in zip(got, want):
            assert (g is None) == (j is None)
            if g is not None:
                _eq(g.numpy(), j)
        _eq(TQ.fake_quant_weight(QuantSpec(**kw), torch.as_tensor(w),
                                 torch.as_tensor(up),
                                 torch.as_tensor(low)).numpy(),
            JQ.fake_quant_weight(JSpec(**kw), jnp.asarray(w),
                                 jnp.asarray(up), jnp.asarray(low)))


def test_spec_from_config_matches():
    cfg = {'bit': 4, 'symmetric': False, 'granularity': 'per_group',
           'group_size': 64, 'calib_algo': 'minmax', 'int_range': [-7, 7]}
    assert dataclass_dict(spec_from_config(cfg)) == \
        dataclass_dict(j_spec_from_config(cfg))


def dataclass_dict(spec):
    import dataclasses
    return dataclasses.asdict(spec)
