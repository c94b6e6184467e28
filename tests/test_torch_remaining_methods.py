"""The pieces of QUIK, SpQR and DGQ against the JAX package's on the CPU at
float32, on the same numpy inputs from fixed seeds: QUIK's fp columns and
its masked linear, SpQR's layer (both outlier scorers), DGQ's grid
search and down_proj smoothing, and the grids packing reads from DGQ's
qparams and from QUIK's int columns.  The method objects are built on TINY with no calibration
inputs; the features are handed to them directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.compression.quantization.dgq import DGQ as JDGQ
from llmc_tpu.compression.quantization.quik import QUIK as JQUIK
from llmc_tpu.compression.quantization.spqr import SpQR as JSpQR
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models import base as JB
from llmc_tpu.utils.config import Cfg as JCfg
from llmc_tpu_torch.compression.quantization.dgq import DGQ
from llmc_tpu_torch.compression.quantization.quik import QUIK
from llmc_tpu_torch.compression.quantization.spqr import SpQR
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models import base as TB
from llmc_tpu_torch.quant.quantizer import quant_dequant, reshape_tensor
from llmc_tpu_torch.serve.packed import stored_grid
from llmc_tpu_torch.utils import Cfg
from torch_port_helpers import TINY, method_quant, port_params, rel_err

torch.set_num_threads(1)


def both(cls_j, cls_t, quant):
    """(JAX method object, port method object) on the same TINY model."""
    cfg = dict(model=dict(type='Llama'), quant=quant)
    jm = JAdapter.random(JConfig(**TINY), seed=3)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    empty = {'data': [], 'kwargs': []}
    return (cls_j(jm, JCfg(cfg)['quant'], empty, None, JCfg(cfg)),
            cls_t(tm, Cfg(cfg)['quant'], empty, None, Cfg(cfg)))


def _subset(layout, name):
    return next(s for s in layout.subsets if s.name == name)


@pytest.mark.parametrize('special', [dict(fp_features=8),
                                     dict(fp_features=2, fp_relative=True),
                                     dict(fp_features=8, fp_threshold=1e9)])
def test_quik_int_mask_and_masked_linear(special):
    """QUIK's int_mask of every subset equals the reference's (the fp
    columns by numpy's argsort, a relative count, a threshold no
    activation reaches), and the mixed-column linear under QUIK's policy
    gives the reference's output within 1e-5."""
    quant = dict(method_quant('quik_w4a8'), special=special)
    ja, ta = both(JQUIK, QUIK, quant)
    rng = np.random.RandomState(0)
    jblock, tblock = ja.model.blocks[0], ta.model.blocks[0]
    for subset in ta.layout.subsets:
        ic = TB.get_path(tblock, subset.layers[0])['w'].shape[1]
        x = (rng.randn(2, 12, ic) * rng.uniform(0.5, 4, ic)).astype(
            np.float32)
        jblock = ja.subset_transform(0, jblock, _subset(ja.layout,
                                                        subset.name),
                                     {subset.input_key: [jnp.asarray(x)]})
        tblock = ta.subset_transform(0, tblock, subset,
                                     {subset.input_key: [torch.as_tensor(x)]})
        for p in subset.layers:
            jlin, tlin = JB.get_path(jblock, p), TB.get_path(tblock, p)
            want = np.asarray(jlin['int_mask'])
            np.testing.assert_array_equal(tlin['int_mask'].numpy(), want)
            n_fp = int((~want).sum())
            assert n_fp == (0 if 'fp_threshold' in special else
                            2 * (ic // 64) if special.get('fp_relative')
                            else 8)
            y_j = JB.linear_apply(jlin, jnp.asarray(x),
                                  ja.fake_quant_qcfg(0, p))
            y_t = TB.linear_apply(tlin, torch.as_tensor(x),
                                  ta.fake_quant_qcfg(0, p))
            assert rel_err(y_t.numpy(), np.asarray(y_j)) <= 1e-5


def _hessian(ic, seed):
    x = np.random.RandomState(seed).randn(96, ic).astype(np.float32)
    x[:, ::7] *= 6.0    # a few hot channels
    return (x.T @ x * (2.0 / 96)).astype(np.float32)


@pytest.mark.parametrize('simplified', [True, False])
def test_spqr_layer_transform(simplified):
    """SpQR's layer (the simplified pre-pass, which the shipped config runs,
    and the exact leave-one-out scorer): the outlier mask equal to the
    reference's, the baked weight (its outliers added back) within 1e-5,
    the double-quantized scales and zeros within 1e-6 relative."""
    quant = method_quant('spqr_w4')
    quant['special'] = dict(simplified_outliers=simplified)
    ja, ta = both(JSpQR, SpQR, quant)
    rng = np.random.RandomState(1)
    w = (rng.randn(64, 128) * 0.05).astype(np.float32)
    w[rng.rand(64, 128) < 0.01] *= 12.0          # outlier weights
    H = _hessian(128, 2)
    jl = ja.layer_transform({'w': jnp.asarray(w), 'b': None},
                            jnp.asarray(H))
    tl = ta.layer_transform({'w': torch.as_tensor(w), 'b': None},
                            torch.as_tensor(H))
    mask = np.asarray(jl['spqr_mask'])
    np.testing.assert_array_equal(tl['spqr_mask'].numpy(), mask)
    assert 0 < mask.mean() < 0.2
    for k in ('gptq_scales', 'gptq_zeros'):
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-6, atol=1e-7)
    want = np.asarray(jax.jit(ja.static_w_qdq)(jl))
    got = ta.static_w_qdq(tl).numpy()
    assert rel_err(got, want) <= 1e-5
    # the outliers stay fp in the baked weight
    np.testing.assert_array_equal(got[mask > 0], tl['w'].numpy()[mask > 0])


def test_spqr_requires_per_group():
    quant = method_quant('spqr_w4')
    quant['weight'] = dict(bit=4, symmetric=False, granularity='per_channel')
    cfg = dict(model=dict(type='Llama'), quant=quant)
    tm = LlamaAdapter.random(LlamaConfig(**TINY), seed=0, device='cpu')
    with pytest.raises(ValueError, match='per_group'):
        SpQR(tm, Cfg(cfg)['quant'], {'data': [], 'kwargs': []}, None,
             Cfg(cfg))


def _dgq_case(seed, oc=48, ic=256):
    rng = np.random.RandomState(seed)
    w = (rng.randn(oc, ic) * 0.05).astype(np.float32)
    w[:, rng.rand(ic) < 0.05] *= 6.0
    x = (rng.randn(2, 24, ic) * rng.uniform(0.3, 3, ic)).astype(np.float32)
    return w, x


@pytest.mark.parametrize('seed', [0, 1])
def test_dgq_search_core(seed):
    """DGQ's grid search as shipped (int4 groups of 128 under a per-token
    A8 spec) on the same weight and features: ``s4_int`` and ``z4`` equal
    to the jitted reference's, ``s8`` within 1e-6 relative."""
    ja, ta = both(JDGQ, DGQ, method_quant('dgq_w4a8'))
    assert ta.gs == ja.gs == 128
    w, x = _dgq_case(seed)
    js4, jz4, js8 = ja._search_layer(jnp.asarray(w), jnp.asarray(x))
    ts4, tz4, ts8 = ta._search_core(torch.as_tensor(w), torch.as_tensor(x))
    np.testing.assert_array_equal(ts4.numpy(), np.asarray(js4))
    np.testing.assert_array_equal(tz4.numpy(), np.asarray(jz4))
    np.testing.assert_allclose(ts8.numpy(), np.asarray(js8), rtol=1e-6)
    assert (ts4.numpy() >= 1).all() and len(np.unique(ts4.numpy())) > 1


def test_dgq_smooth_down_and_stored_grid():
    """``_smooth_down`` moves the same channels by the same scales (the
    smoothed up_proj and down_proj equal the reference's bit for bit); the
    grid packing reads from DGQ's qparams (scale ``s4_int * s8``, zero
    ``z4``) holds DGQ's fake-quant weight bit for bit."""
    ja, ta = both(JDGQ, DGQ, method_quant('dgq_w4a8'))
    subset = _subset(ta.layout, 'down')
    ic = TB.get_path(ta.model.blocks[0], 'mlp.down_proj')['w'].shape[1]
    x = np.abs(np.random.RandomState(4).randn(2, 24, ic)).astype(np.float32)
    x[..., 3] *= 50.0
    jblock = ja._smooth_down(ja.model.blocks[0],
                             _subset(ja.layout, 'down'), [jnp.asarray(x)])
    tblock = ta._smooth_down(ta.model.blocks[0], subset,
                             [torch.as_tensor(x)])
    for p in ('mlp.up_proj', 'mlp.down_proj'):
        np.testing.assert_array_equal(TB.get_path(tblock, p)['w'].numpy(),
                                      np.asarray(JB.get_path(jblock, p)['w']))
    before = TB.get_path(ta.model.blocks[0], 'mlp.up_proj')['w']
    assert not torch.equal(TB.get_path(tblock, 'mlp.up_proj')['w'], before)

    w, x = _dgq_case(2)
    s4, z4, s8 = ta._search_core(torch.as_tensor(w), torch.as_tensor(x))
    lin = dict(w=torch.as_tensor(w), dgq_s4=s4, dgq_z4=z4, dgq_s8=s8)
    assert (torch.round(127.0 / s8) >= 15).all()
    # the config's weight spec at its shipped group of 128 (DGQ's grain)
    wspec = ta.wspec.replace(group_size=128)
    assert stored_grid(lin, ta.wspec) is None     # another grouping
    qp = stored_grid(lin, wspec)
    held = quant_dequant(wspec, reshape_tensor(wspec, lin['w']), qp)
    own = ta.static_w_qdq(lin)
    assert torch.equal(held.reshape(own.shape), own)
    np.testing.assert_array_equal(
        own.numpy(), np.asarray(jax.jit(ja.static_w_qdq)(
            {k: jnp.asarray(v.numpy()) for k, v in lin.items()})))


@pytest.mark.parametrize('symmetric', [False, True])
def test_quik_stored_grid(symmetric):
    """The grid packing reads for a QUIK linear (its per-channel qparams
    over the int columns, standing for every group of the channel) holds
    the reference's masked fake-quant weight bit for bit in the int
    columns; only the fp columns, which no grid holds, differ."""
    from llmc_tpu.quant.quantizer import fake_quant_weight_masked as jfq
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight_masked
    quant = method_quant('quik_w4a8')
    quant['weight'] = dict(quant['weight'], symmetric=symmetric)
    ja, ta = both(JQUIK, QUIK, quant)
    rng = np.random.RandomState(5)
    w = rng.randn(24, 64).astype(np.float32)
    mask = np.ones(64, bool)
    mask[rng.choice(64, 8, replace=False)] = False
    lin = dict(w=torch.as_tensor(w), int_mask=torch.as_tensor(mask))
    wspec = ta.wspec
    assert wspec.granularity == 'per_group' and wspec.group_size == 32
    qp = stored_grid(lin, wspec)
    held = quant_dequant(wspec, reshape_tensor(wspec, lin['w']),
                         qp).reshape(w.shape).numpy()
    own = fake_quant_weight_masked(wspec, lin['w'], lin['int_mask']).numpy()
    want = np.asarray(jax.jit(lambda a, m: jfq(ja.wspec, a, m))(
        jnp.asarray(w), jnp.asarray(mask)))
    np.testing.assert_array_equal(own, want)
    np.testing.assert_array_equal(held[:, mask], own[:, mask])
    assert (held[:, ~mask] != own[:, ~mask]).mean() > 0.9
