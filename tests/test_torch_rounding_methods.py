"""TesseraQ, HQQ and AdaDim of the port against the JAX package's, on the
CPU at float32 (the tests' TINY Llama, the same calibration batches), and
which values the five methods this slice ported read from the shipped
method configs.

- TesseraQ: the rounding variables after one and after three Adam steps
  at the first threshold, the hardened ones (+-100) at the same places,
  within 1e-5; the merged weights' codes and the stored scales and zeros
  equal.  Two reference faults the port keeps apart from (ROADMAP C): the
  reference trains block i on block i+1's inputs, and builds its jitted
  training step once, in the first block, where the step keeps that
  block's qparams, so every later block trains its rounding against the
  first block's scales and zeros.  The reference is run here trained on
  each block's own inputs with its step built afresh in each block, and a
  test pins what the second fault changes.
- HQQ: each linear's fake-quantized weight, block by block.
- AdaDim: the dimension each linear chose, on losses that no rounding
  can swap.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from llmc_tpu.compression.quantization.adadim import AdaDim as JAdaDim
from llmc_tpu.compression.quantization.hqq import HQQ as JHQQ
from llmc_tpu.compression.quantization.ntweak import \
    NormTweaking as JNormTweaking
from llmc_tpu.compression.quantization.omniq import OmniQuant as JOmniQuant
from llmc_tpu.compression.quantization.tesseraq import \
    TesseraQ as JTesseraQ
from llmc_tpu.data import CalibDataset as JCalibDataset
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.base import get_path as jget_path
from llmc_tpu.utils.config import Cfg as JCfg
from llmc_tpu_torch.compression.quantization.adadim import AdaDim
from llmc_tpu_torch.compression.quantization.hqq import HQQ
from llmc_tpu_torch.compression.quantization.ntweak import NormTweaking
from llmc_tpu_torch.compression.quantization.omniq import OmniQuant
from llmc_tpu_torch.compression.quantization.tesseraq import TesseraQ
from llmc_tpu_torch.data import CalibDataset
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models.base import get_path
from llmc_tpu_torch.utils import Cfg
from torch_port_helpers import (TINY, port_params,
                                reference_builds_its_step_per_block,
                                reference_trains_on_block_inputs, rel_err)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = os.path.join(ROOT, 'configs', 'quantization', 'methods')
W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=32)
CALIB = dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
             vocab_size=128)
CLASSES = {'TesseraQ': (JTesseraQ, TesseraQ), 'HQQ': (JHQQ, HQQ),
           'AdaDim': (JAdaDim, AdaDim), 'OmniQuant': (JOmniQuant, OmniQuant),
           'NormTweaking': (JNormTweaking, NormTweaking)}
# a rounding variable after 1 or 3 Adam steps of 1e-2, absolute
TOL_V = 1e-5


def both(method, weight=W4, special=None, seed=3):
    """(JAX algorithm, port algorithm) on the same model and calibration
    batches."""
    quant = dict(method=method, weight=dict(weight),
                 special=dict(special or {}))
    cfg = dict(base=dict(seed=7), model=dict(type='Llama'),
               calib=dict(CALIB), quant=quant)
    jm = JAdapter.random(JConfig(**TINY), seed=seed)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    jx, jkw = jm.collect_first_block_input(
        JCalibDataset(cfg['calib'], None).get_calib_dataset()[0])
    tx, tkw = tm.collect_first_block_input(
        CalibDataset(cfg['calib'], None).get_calib_dataset()[0])
    jcls, tcls = CLASSES[method]
    return (jcls(jm, JCfg(cfg)['quant'], {'data': jx, 'kwargs': jkw}, None,
                 JCfg(cfg)),
            tcls(tm, Cfg(cfg)['quant'], {'data': tx, 'kwargs': tkw}, None,
                 Cfg(cfg)))


# --------------------------------------------------------------------------
# TesseraQ
# --------------------------------------------------------------------------

def _fixed_reference(monkeypatch):
    """The reference's TesseraQ trained on each block's own inputs, with
    its step built afresh in each block (ROADMAP C)."""
    reference_trains_on_block_inputs(monkeypatch, JTesseraQ)
    reference_builds_its_step_per_block(monkeypatch, JTesseraQ)


def _rounding_at_hardening(monkeypatch, ja, ta):
    """Record the rounding variables each package holds when it hardens
    them: the reference's from the sigmoid of its eager hardening (three
    calls a linear, the traced calls inside its step left out), the port's
    from ``harden``.  Lists of {path: V} in (block, threshold) order."""
    jcalls, tlist = [], []
    sigmoid = jax.nn.sigmoid

    def rec_sigmoid(x):
        if not isinstance(x, jax.core.Tracer):
            jcalls.append(np.array(x))
        return sigmoid(x)
    monkeypatch.setattr(jax.nn, 'sigmoid', rec_sigmoid)
    inner = ta.harden

    def rec_harden(theta, t):
        tlist.append({p: v.detach().numpy().copy() for p, v in theta.items()})
        return inner(theta, t)
    ta.harden = rec_harden
    paths = ta.layout.linears

    def jlist():
        vs = jcalls[::3]
        return [dict(zip(paths, vs[i:i + len(paths)]))
                for i in range(0, len(vs), len(paths))]
    return jlist, tlist


@pytest.mark.parametrize('steps', [1, 3])
def test_tesseraq_rounding_matches_jax(monkeypatch, steps):
    """The rounding variables when the second threshold hardens them
    (after ``steps`` steps at the first), in both blocks: the hardened
    entries at the same places, every other within 1e-5 and moved; then
    the merged codes and the stored qparams equal."""
    _fixed_reference(monkeypatch)
    ja, ta = both('TesseraQ', special=dict(thresholds=[0.8, 0.5],
                                           iterations=steps, lr=1e-2))
    jlist, tlist = _rounding_at_hardening(monkeypatch, ja, ta)
    ja.run_block_loop()
    ta.run_block_loop()
    jv = jlist()
    assert len(jv) == len(tlist) == 4   # 2 blocks x 2 thresholds
    assert ta.train_stats['steps'] == 2 * 2 * steps
    for b in range(2):
        v0, got, want = tlist[2 * b], tlist[2 * b + 1], jv[2 * b + 1]
        for p in ta.layout.linears:
            hard = np.abs(want[p]) == 100.0
            np.testing.assert_array_equal(np.abs(got[p]) == 100.0, hard)
            assert 0.15 <= hard.mean() <= 0.25
            np.testing.assert_allclose(got[p][~hard], want[p][~hard],
                                       rtol=0, atol=TOL_V)
            moved = np.abs(got[p] - v0[p])[~hard]
            assert moved.max() >= 0.5 * 1e-2 * steps
    _assert_merged_equal(ja, ta)


def _codes(lin):
    s = np.asarray(lin['gptq_scales'], np.float32)
    z = np.asarray(lin['gptq_zeros'], np.float32)
    w = np.asarray(lin['w'], np.float32)
    oc = w.shape[0]
    q = np.round(w.reshape(oc, s.shape[1], -1) / s[..., None]) + z[..., None]
    return q, s, z


def _assert_merged_equal(ja, ta):
    for b in range(2):
        for p in ta.layout.linears:
            jq, js, jz = _codes(jget_path(ja.model.blocks[b], p))
            tl = get_path(ta.model.blocks[b], p)
            tq, ts, tz = _codes({k: v.numpy() for k, v in tl.items()
                                 if v is not None})
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(tz, jz)


def test_tesseraq_trains_each_block_with_its_own_qparams(monkeypatch):
    """The reference fault the port keeps apart from: with the step the
    reference caches, its second block learns another rounding (the step
    reads the first block's qparams) than with its step built afresh,
    which the port equals; the first blocks agree."""
    special = dict(thresholds=[0.8, 0.5], iterations=3, lr=1e-2)
    reference_trains_on_block_inputs(monkeypatch, JTesseraQ)
    stale, ta = both('TesseraQ', special=special)
    stale.run_block_loop()
    ta.run_block_loop()
    reference_builds_its_step_per_block(monkeypatch, JTesseraQ)
    fresh = both('TesseraQ', special=special)[0]
    fresh.run_block_loop()
    _assert_merged_equal(fresh, ta)
    p = 'mlp.down_proj'
    assert not np.array_equal(_codes(jget_path(stale.model.blocks[1], p))[0],
                              _codes(jget_path(fresh.model.blocks[1], p))[0])
    np.testing.assert_array_equal(
        _codes(jget_path(stale.model.blocks[0], p))[0],
        _codes(jget_path(fresh.model.blocks[0], p))[0])


# --------------------------------------------------------------------------
# HQQ and AdaDim
# --------------------------------------------------------------------------

@pytest.mark.parametrize('axis', [1, 0])
def test_hqq_weights_per_block(axis):
    """Each linear's HQQ weight (asymmetric g64 on 64-wide rows, the shipped
    config's, and along the input channels with ``axis: 0``) within 1e-6
    relative of the reference's, and no element a code apart: every
    difference under 1e-3 of its group's step (the solver's float zeros are
    means refined in a loop, which XLA and torch sum in another order, so
    most elements differ in their last bits); the bake puts it in place of
    the weight."""
    weight = dict(bit=4, symmetric=False, granularity='per_group',
                  group_size=64, calib_algo='hqq')
    ja, ta = both('HQQ', weight=weight, special=dict(axis=axis))
    ja.run_block_loop()
    ta.run_block_loop()
    for b in range(2):
        for p in ta.layout.linears:
            jw = np.asarray(jget_path(ja.model.blocks[b], p)['hqq_w'])
            tw = get_path(ta.model.blocks[b], p)['hqq_w'].numpy()
            assert rel_err(tw, jw) <= 1e-6
            w = np.asarray(jget_path(ja.model.blocks[b], p)['w'])
            w = (w.T if axis == 0 else w).reshape(-1, 64)
            step = (w.max(-1) - w.min(-1)) / 15
            d = np.abs(tw - jw)
            d = (d.T if axis == 0 else d).reshape(-1, 64)
            assert (d / step[:, None]).max() < 1e-3
    ja.deploy('fake_quant')
    ta.deploy('fake_quant')
    lin = get_path(ta.model.blocks[1], 'mlp.up_proj')
    assert 'hqq_w' not in lin
    assert rel_err(lin['w'].numpy(), jget_path(
        ja.model.blocks[1], 'mlp.up_proj')['w']) <= 1e-6


@pytest.mark.parametrize('weight', [
    dict(bit=8, symmetric=True, granularity='per_channel'),
    dict(bit=4, symmetric=True, granularity='per_channel')])
def test_adadim_choice_equals_jax(weight):
    """The dimension every linear chose (and its stored ``qdim``), on
    losses that differ by far more than their last bits; the baked
    weights equal."""
    ja, ta = both('AdaDim', weight=weight)
    losses = []
    inner = ta.dim_losses

    def rec(w, b, xs):
        out = inner(w, b, xs)
        losses.append(tuple(float(v) for v in out))
        return out
    ta.dim_losses = rec
    ja.run_block_loop()
    ta.run_block_loop()
    assert ta.dim_choice == ja.dim_choice and len(ta.dim_choice) == 14
    assert len(set(ta.dim_choice.values())) == 2   # both dims are chosen
    for l_oc, l_ic in losses:
        assert abs(l_oc - l_ic) > 1e-4 * max(l_oc, l_ic)
    for (b, p), choice in ta.dim_choice.items():
        assert int(get_path(ta.model.blocks[b], p)['qdim']) == \
            (0 if choice == 'ic' else 1)
    ja.deploy('fake_quant')
    ta.deploy('fake_quant')
    for b in range(2):
        for p in ta.layout.linears:
            np.testing.assert_array_equal(
                get_path(ta.model.blocks[b], p)['w'].numpy(),
                np.asarray(jget_path(ja.model.blocks[b], p)['w']))


# --------------------------------------------------------------------------
# What the methods read from the shipped configs
# --------------------------------------------------------------------------

# Three shipped configs set keys neither package reads (ROADMAP C, "Not
# faults"): omniquant_w4.yml's ``wlr`` (the clips' rate is ``lwc_lr``),
# tesseraq_w4.yml's ``epochs`` (the steps are ``iterations`` a threshold)
# and normtweaking_w4.yml's ``lr`` (the rate is ``tweak_lr``).
READ_FROM_CONFIG = {
    'hqq_w4': dict(axis=1, lp_norm=0.7, beta=10.0, kappa=1.01, iters=20),
    'adadim_w8': {},
    'omniquant_w4': dict(lwc=True, let=False, epochs=20, lwc_lr=1e-2,
                         let_lr=5e-3, wd=0.0, alpha=0.5),
    'tesseraq_w4': dict(lr=1e-3, iterations=100, batch_size=1,
                        thresholds=[0.8, 0.5, 0.2], load_transform=False),
    'normtweaking_w4': dict(epochs=10, lr=1e-5),
}

@pytest.mark.parametrize('name', sorted(READ_FROM_CONFIG))
def test_values_read_from_the_shipped_configs(name):
    with open(os.path.join(METHODS, f'{name}.yml')) as f:
        quant = yaml.safe_load(f)['quant']
    ja, ta = both(quant['method'], weight=dict(quant['weight'],
                                               group_size=32),
                  special=quant.get('special'))
    got = ta.hyperparams()
    assert got == READ_FROM_CONFIG[name]
    for k, v in got.items():
        if quant['method'] == 'HQQ' and k != 'axis':
            assert getattr(ja.wspec, f'hqq_{k}') == v
        else:
            assert getattr(ja, k) == v, k


def test_packing_holds_each_method_grid():
    """What packing holds (its codes dequantized), after each method's
    deploy: TesseraQ's and AdaDim's output-channel linears exactly their
    baked weights (from the qparams they stored); HQQ's its baked weights
    except where its float zero clips an element, which the rounded zero
    of the kernels' integer codes moves by at most half a step; AdaDim's
    input-channel linears are requantized per output channel."""
    from llmc_tpu_torch.quant.quantizer import (quant_dequant,
                                                reshape_tensor,
                                                restore_tensor)
    from llmc_tpu_torch.serve.packed import packed_grid
    cases = (('TesseraQ', W4, dict(thresholds=[0.5], iterations=2)),
             ('HQQ', dict(W4, calib_algo='hqq'), None),
             ('AdaDim', dict(bit=8, symmetric=True,
                             granularity='per_channel'), None))
    for method, weight, special in cases:
        _, ta = both(method, weight=weight, special=special)
        ta.run_block_loop()
        ta.deploy('fake_quant')
        spec, clipped = ta.wspec, 0
        for b in range(2):
            for p in ta.layout.linears:
                lin = get_path(ta.model.blocks[b], p)
                qp = packed_grid(lin, spec)
                t = reshape_tensor(spec, lin['w'])
                held = restore_tensor(spec, quant_dequant(spec, t, qp),
                                      lin['w'].shape)
                if method == 'AdaDim' and ta.dim_choice[(b, p)] == 'ic':
                    assert 'gptq_scales' not in lin
                    continue
                d = (held - lin['w']).abs()
                if method != 'HQQ':
                    assert float(d.max()) <= 1e-6 * float(
                        lin['w'].abs().max())
                    continue
                steps = reshape_tensor(spec, d) / qp.scales
                assert float(steps.max()) <= 0.5 + 1e-5
                clipped += int((steps > 1e-5).sum())
        if method == 'HQQ':
            assert 0 < clipped
    assert len(set(ta.dim_choice.values())) == 2


def test_pack_and_tree_helpers_take_qdim_and_hqq_w():
    """``pack_model`` and the numpy tree helpers take blocks that hold
    AdaDim's ``qdim`` and HQQ's ``hqq_w`` (before its bake), as the JAX
    package's do; the packed model serves the same function either way."""
    from llmc_tpu_torch.convert import params_from_numpy, params_to_numpy
    from llmc_tpu_torch.quant.qspec import QuantSpec
    from llmc_tpu_torch.serve import pack_model
    spec = QuantSpec(bit=4, symmetric=False, granularity='per_group',
                     group_size=32)
    for method, weight in (('AdaDim', dict(bit=8, symmetric=True,
                                           granularity='per_channel')),
                           ('HQQ', dict(W4, calib_algo='hqq'))):
        _, ta = both(method, weight=weight)
        ta.run_block_loop()
        key = 'qdim' if method == 'AdaDim' else 'hqq_w'
        blk = ta.model.blocks[0]
        assert key in get_path(blk, 'mlp.down_proj')
        back = params_from_numpy(params_to_numpy(blk), device='cpu')
        assert torch.equal(get_path(back, 'mlp.down_proj')[key],
                           get_path(blk, 'mlp.down_proj')[key])
        qmap = pack_model(ta.model, spec, fuse=True)
        assert 'qweight' in get_path(ta.model.blocks[1], 'mlp.down_proj')
        assert qmap.get('mlp.down_proj').w_packed


def test_tesseraq_refuses_load_transform_without_scale_path():
    """The reference raises for ``load_transform`` without ``scale_path``
    (a ``KeyError`` in its constructor); the port's pipeline refuses it
    before any heavy work."""
    from llmc_tpu_torch.main import run_pipeline
    quant = dict(method='TesseraQ', weight=W4,
                 special=dict(load_transform=True))
    with pytest.raises(ValueError, match='scale_path'):
        run_pipeline(dict(model=dict(type='Llama', path='/nonexistent'),
                          quant=quant), device='cpu')
    with pytest.raises(KeyError, match='scale_path'):
        both('TesseraQ', special=dict(load_transform=True))
