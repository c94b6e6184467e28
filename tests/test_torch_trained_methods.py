"""The gradient-trained methods of the port against the JAX package's, on
the CPU at float32: OmniQuant (learnable weight clips on the tests' GQA
TINY; learnable equivalent transforms with the q/k scale on an MHA
variant; both together) and NormTweaking, each after one and after three
optimizer steps a block from the same initial parameters, every trained
parameter within 1e-5 of the reference's.  Both packages walk the same two
blocks on the same calibration batches; a learning rate of 1e-2 moves every
parameter by about that much a step.  The reference is run trained on each
block's own inputs: as it stands it trains block i on block i+1's inputs
(ROADMAP C), which the last test pins.

Weight-only: with activation quantization a last-bit difference between
XLA's and torch's activations flips about one 8-bit code a block (on
TINY's LET case the norm's output differs by 5 ulp), which moves the loss
by about 1e-3 relative, and Adam's first step turns the gradients of the
clip factors nearest its epsilon (about 1e-8) into updates that differ by
up to 2.6e-3.  The straight-through gradient of the activation
fake-quant itself is held to 1e-6 in ``test_torch_ste.py``."""

import jax
import numpy as np
import pytest
import torch

from llmc_tpu.compression.quantization.ntweak import \
    NormTweaking as JNormTweaking
from llmc_tpu.compression.quantization.omniq import OmniQuant as JOmniQuant
from llmc_tpu.data import CalibDataset as JCalibDataset
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.base import get_path as jget_path
from llmc_tpu.utils.config import Cfg as JCfg
from llmc_tpu_torch.compression.quantization.ntweak import NormTweaking
from llmc_tpu_torch.compression.quantization.omniq import OmniQuant
from llmc_tpu_torch.data import CalibDataset
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models.base import get_path
from llmc_tpu_torch.utils import Cfg
from torch_port_helpers import (TINY, port_params,
                                reference_trains_on_block_inputs, rel_err)

torch.set_num_threads(1)

MHA = dict(TINY, num_key_value_heads=4)
W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=32)
CALIB = dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
             vocab_size=128)
# a trained parameter after 1 or 3 Adam steps, absolute: each step moves
# it by about the learning rate (1e-2) whatever the gradient's size, and
# the two packages' gradients differ in their last bits
TOL_THETA = 1e-5
TOL_THETA_NEAR_EPS = 5e-4
LR = 1e-2

CLASSES = {'OmniQuant': (JOmniQuant, OmniQuant),
           'NormTweaking': (JNormTweaking, NormTweaking)}


def both(method, special, arch=TINY, weight=W4, act=None, seed=3,
         run=True):
    """(JAX algorithm, port algorithm) on the same model and calibration
    batches, each after its block loop (``run``)."""
    quant = dict(method=method, weight=dict(weight), special=dict(special))
    if act:
        quant['act'] = dict(act)
    cfg = dict(base=dict(seed=7), model=dict(type='Llama'),
               calib=dict(CALIB), quant=quant)
    jm = JAdapter.random(JConfig(**arch), seed=seed)
    tm = LlamaAdapter(LlamaConfig(**arch), port_params(jm.params))
    jx, jkw = jm.collect_first_block_input(
        JCalibDataset(cfg['calib'], None).get_calib_dataset()[0])
    tx, tkw = tm.collect_first_block_input(
        CalibDataset(cfg['calib'], None).get_calib_dataset()[0])
    jcls, tcls = CLASSES[method]
    ja = jcls(jm, JCfg(cfg)['quant'], {'data': jx, 'kwargs': jkw}, None,
              JCfg(cfg))
    ta = tcls(tm, Cfg(cfg)['quant'], {'data': tx, 'kwargs': tkw}, None,
              Cfg(cfg))
    if run:
        ja.run_block_loop()
        ta.run_block_loop()
    return ja, ta


OMNI = {
    'lwc': (TINY, dict(lwc=True, let=False)),
    'let_qkt': (MHA, dict(lwc=False, let=True)),
    'lwc_let': (MHA, dict(lwc=True, let=True)),
}


def _final_thetas(algo, concrete):
    """Wrap ``algo``'s transform so that it records each block's trained
    parameters: the call that bakes them, the only one whose parameters
    are ``concrete`` (the reference traces the others inside its jitted
    step; the port's others carry gradients)."""
    name = 'apply_theta' if hasattr(algo, 'apply_theta') else '_apply_theta'
    inner, got = getattr(algo, name), []

    def rec(block, theta, truncate=True):
        leaves = [t for k in ('lwc', 'let') for d in theta[k].values()
                  for t in d.values() if t is not None]
        if all(concrete(t) for t in leaves):
            got.append({f'{k}.{n}.{kk}': np.array(t) for k in ('lwc', 'let')
                        for n, d in theta[k].items()
                        for kk, t in d.items() if t is not None})
        return inner(block, theta, truncate)
    setattr(algo, name, rec)
    return got


def _omni_thetas(monkeypatch, case, epochs):
    reference_trains_on_block_inputs(monkeypatch, JOmniQuant)
    arch, special = OMNI[case]
    ja, ta = both('OmniQuant', dict(special, epochs=epochs, lwc_lr=LR,
                                    let_lr=LR), arch=arch, run=False)
    jth = _final_thetas(ja, lambda t: not isinstance(t, jax.core.Tracer))
    tth = _final_thetas(ta, lambda t: not t.requires_grad)
    ja.run_block_loop()
    ta.run_block_loop()
    return ja, ta, jth, tth


class ThetaCheck:
    """Trained parameters against the reference's.

    Adam's update is ``lr * g / (|g| + eps)`` at its first step, so a
    parameter whose gradient lies near eps (1e-8) moves by less than the
    learning rate, by an amount that a last-bit difference of that
    gradient steers (an LET gradient is what the quantization leaves of
    terms that cancel; on block 0's small inputs a norm's gradient can be
    that small too).  Held to 1e-5: every parameter the reference moved by
    at least 0.9 lr a step (its gradient well above eps), and 95% of all
    (measured 98.4% to 100% on TINY); the rest within 5e-4 (measured up to
    2.5e-4)."""

    def __init__(self):
        self.close, self.n = 0, 0

    def add(self, got, want, start, lr, steps, what=''):
        got, want = np.asarray(got), np.asarray(want)
        d = np.abs(got - want)
        firm = np.abs(want - np.asarray(start)) >= 0.9 * lr * steps
        assert d[firm].max(initial=0.0) <= TOL_THETA, what
        assert d.max() <= TOL_THETA_NEAR_EPS, what
        assert np.abs(got - np.asarray(start)).max() >= 0.5 * lr * steps
        self.close += int((d <= TOL_THETA).sum())
        self.n += d.size

    def done(self):
        assert self.close >= 0.95 * self.n


@pytest.mark.parametrize('steps', [1, 3])
@pytest.mark.parametrize('case', sorted(OMNI))
def test_omniquant_theta_matches_jax(monkeypatch, case, steps):
    """After ``steps`` steps a block, every clip factor and smoothing scale
    (the q/k one with them) of both blocks (``ThetaCheck``), and the block
    they bake."""
    ja, ta, jth, tth = _omni_thetas(monkeypatch, case, steps)
    jth0 = _omni_thetas(monkeypatch, case, 0)[2]
    assert ta.train_stats['steps'] == 2 * steps
    assert len(jth) == len(tth) == len(jth0) == 2
    check = ThetaCheck()
    for jb, tb, j0 in zip(jth, tth, jth0):
        assert set(jb) == set(tb)
        assert ('let.qkt.scale' in tb) == OMNI[case][1]['let']
        for k in tb:
            check.add(tb[k], jb[k], j0[k], LR, steps, k)
    check.done()
    for b in range(2):
        for path in ta.layout.linears:
            jl = jget_path(ja.model.blocks[b], path)
            tl = get_path(ta.model.blocks[b], path)
            assert set(tl) == set(jl)
            assert rel_err(tl['w'].numpy(), jl['w']) <= TOL_THETA_NEAR_EPS


@pytest.mark.parametrize('steps', [1, 3])
def test_normtweaking_theta_matches_jax(monkeypatch, steps):
    """The norm weights after ``steps`` AdamW steps a block (the learning
    rate falling with depth, optax's weight decay 1e-4), against the
    reference's (``ThetaCheck``)."""
    reference_trains_on_block_inputs(monkeypatch, JNormTweaking)
    ja, ta = both('NormTweaking', dict(epochs=steps, tweak_lr=LR))
    check = ThetaCheck()
    for b in range(2):
        lr = LR * (1.0 - b / 4)
        for ln in ta.layout.layernorms:
            check.add(get_path(ta.model.blocks[b], ln)['w'].numpy(),
                      jget_path(ja.model.blocks[b], ln)['w'], 1.0, lr,
                      steps, f'{b}.{ln}')
    check.done()
    assert ta.train_stats['steps'] == 2 * steps
    assert set(ta.train_stats['block_loss']) == {0, 1}


def test_each_block_trains_on_its_own_inputs(monkeypatch):
    """The reference fault the port keeps apart from: as it stands, the
    reference trains block 0's norms on block 1's inputs (its outputs), and
    lands elsewhere than when it trains on block 0's inputs, which the port
    equals."""
    special = dict(epochs=3, tweak_lr=LR)
    as_is = both('NormTweaking', special)[0]
    reference_trains_on_block_inputs(monkeypatch, JNormTweaking)
    fixed, ta = both('NormTweaking', special)
    ln = 'post_attention_layernorm'
    got = get_path(ta.model.blocks[0], ln)['w'].numpy()
    want = np.asarray(jget_path(fixed.model.blocks[0], ln)['w'])
    assert (np.abs(got - want) <= TOL_THETA).mean() >= 0.95
    assert np.abs(got - np.asarray(
        jget_path(as_is.model.blocks[0], ln)['w'])).max() > 1e-3


@pytest.mark.parametrize('method', ['OmniQuant', 'TesseraQ', 'NormTweaking'])
def test_trained_method_without_a_card_raises(method):
    """``device=None`` is the card: without one a trained method's pipeline
    raises and never trains on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: device=None runs on it')
    from llmc_tpu_torch.main import run_pipeline
    cfg = dict(base=dict(seed=7), model=dict(type='Llama', arch=TINY),
               calib=dict(CALIB), quant=dict(method=method, weight=W4))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run_pipeline(cfg)
