"""The algorithms of the port against the JAX package's, end to end on the
CPU at float32: ``run_pipeline`` on the tests' TINY Llama (a checkpoint
written from a seed) for each method configuration the repository ships
under ``configs/quantization/methods`` (its ``quant`` section, with group
size 128 cut to 32 for TINY's widths), the three PPLs within 1e-3 of the
JAX package's; QuaRot with the reference's rotation handed in; the
gradient-trained methods against the reference trained on each block's own
inputs, TesseraQ's with its training step built afresh in each block
(ROADMAP C: two reference faults the port keeps apart from); GPTQ's
codes and scales block by block; the static activation qparams bit for
bit; and the fail-fast option check."""


import jax
import numpy as np
import pytest
import torch

from llmc_tpu.compression.quantization.ntweak import \
    NormTweaking as JNormTweaking
from llmc_tpu.compression.quantization.omniq import OmniQuant as JOmniQuant
from llmc_tpu.compression.quantization.tesseraq import \
    TesseraQ as JTesseraQ
from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.hf_loader import \
    save_llama_params_to_hf as j_save_params
from llmc_tpu.ops import hadamard as JH
from llmc_tpu_torch.compression.quantization.gptq import GPTQ
from llmc_tpu_torch.compression.quantization.quarot import Quarot
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models.base import get_path
from torch_port_helpers import (TINY, method_quant,
                                reference_builds_its_step_per_block,
                                reference_trains_on_block_inputs)

torch.set_num_threads(1)

HF = dict({k: v for k, v in TINY.items() if k != 'dtype'},
          torch_dtype='float32', rms_norm_eps=1e-5)
PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')
CONFIGS = ('smoothquant_w8a8', 'gptq_w4a16', 'gptq_static_groups',
           'gptq_owq', 'quarot_w4a8', 'osplus_w8a8', 'llmint8_w8a8',
           'rtn_w8a8', 'rtn_w_a_pertensor_static', 'w48_double',
           'w48_afp8', 'awq_w_a_chat_data', 'hqq_w4', 'adadim_w8',
           'omniquant_w4', 'tesseraq_w4', 'normtweaking_w4', 'quik_w4a8',
           'spqr_w4', 'dgq_w4a8')
# DGQ's int4 grain is its w_1 spec, which dgq_w4a8.yml leaves at the
# default group of 128: it runs on a checkpoint 128 wide (every linear's
# input a whole number of groups) as shipped
WIDE = dict(TINY, hidden_size=128, head_dim=32, intermediate_size=256)
ON_WIDE = ('dgq_w4a8',)


def pipeline_config(path, quant):
    return dict(
        base=dict(seed=7),
        model=dict(type='Llama', path=path, torch_dtype='float32'),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=1536, seq_len=48,
                  vocab_size=128, bs=2,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=quant)


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'tiny')
    j_save_params(JAdapter.random(JConfig(**TINY), seed=3).params, path, HF)
    return path


@pytest.fixture(scope='module')
def wide_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'wide')
    hf = dict({k: v for k, v in WIDE.items() if k != 'dtype'},
              torch_dtype='float32', rms_norm_eps=1e-5)
    j_save_params(JAdapter.random(JConfig(**WIDE), seed=3).params, path, hf)
    return path


def _reference_rotation(monkeypatch, seed=0):
    """Hand the port's QuaRot the JAX package's rotation."""
    def make_rotation(self, n):
        q = JH.get_rotation(n, jax.random.PRNGKey(seed), 'hadamard')
        return torch.as_tensor(np.array(q), device=self.model.device)
    monkeypatch.setattr(Quarot, 'make_rotation', make_rotation)


_RUNS = {}


def _runs(checkpoint, name, monkeypatch):
    if name not in _RUNS:
        quant = method_quant(name)
        if quant['method'] == 'Quarot':
            _reference_rotation(monkeypatch)
        trained = {'NormTweaking': JNormTweaking, 'OmniQuant': JOmniQuant,
                   'TesseraQ': JTesseraQ}.get(quant['method'])
        if trained is not None:
            reference_trains_on_block_inputs(monkeypatch, trained)
        if trained is JTesseraQ:
            reference_builds_its_step_per_block(monkeypatch, trained)
        jres = j_run_pipeline(pipeline_config(checkpoint, quant))
        tres = run_pipeline(pipeline_config(checkpoint, quant), device='cpu')
        _RUNS[name] = (jres, tres)
    return _RUNS[name]


@pytest.mark.parametrize('name', CONFIGS)
def test_method_ppls_match_jax(request, monkeypatch, name):
    """Each shipped configuration runs end to end in the port (each raised
    before), its three PPLs within 1e-3 of the JAX package's; an
    equivalence transform keeps the function ('transformed' within 2e-4
    of pretrain; QuaRot within 2e-2, its embeddings' mean removed, which
    no RMSNorm undoes; GPTQ's compensated weights, TesseraQ's merged
    rounding and NormTweaking's trained norms are no equivalence, nor
    are SpQR's, which are GPTQ's)."""
    checkpoint = request.getfixturevalue(
        'wide_checkpoint' if name in ON_WIDE else 'checkpoint')
    jres, tres = _runs(checkpoint, name, monkeypatch)
    for ppl in PPLS:
        assert np.isfinite(tres[ppl]), ppl
        assert abs(tres[ppl] - jres[ppl]) / jres[ppl] <= 1e-3, (
            ppl, tres[ppl], jres[ppl])
    if not name.startswith(('gptq', 'tesseraq', 'normtweaking', 'spqr')):
        tol = 2e-2 if name.startswith('quarot') else 2e-4
        assert abs(tres['ppl_transformed'] - tres['ppl_pretrain']) \
            <= tol * tres['ppl_pretrain']


def _codes(lin, spec):
    """The int codes of a GPTQ-baked linear, in the layout its qparams
    follow (permuted by the in-loop search, original for static groups),
    OWQ's fp tail left out; and its scales."""
    w = lin['w'].to(torch.float32) if isinstance(lin['w'], torch.Tensor) \
        else torch.as_tensor(np.array(lin['w'], np.float32))
    s = torch.as_tensor(np.asarray(lin['gptq_scales'], np.float32))
    z = lin.get('gptq_zeros')
    z = torch.as_tensor(np.asarray(z, np.float32)) if z is not None else 0.0
    if lin.get('gptq_perm_qp'):
        w = w[:, torch.as_tensor(np.asarray(lin['perm'])).long()]
    oc, C = w.shape
    q = torch.round(w.reshape(oc, -1, spec.group_size) / s[..., None]
                    + (z[..., None] if torch.is_tensor(z) else z))
    q = q.reshape(oc, C)
    n_out = int(lin.get('owq_n_out', 0))
    return (q[:, :C - n_out] if n_out else q), s


@pytest.mark.parametrize('name', ['gptq_w4a16', 'gptq_static_groups',
                                  'gptq_owq'])
def test_gptq_codes_and_scales_per_block(checkpoint, monkeypatch, name):
    """GPTQ block by block against the JAX package: the share of equal
    codes at least 0.99 and the scales within 1e-5 relative in every
    linear of every block (f32 Cholesky factors and the tail matmuls
    differ in their last bits between XLA and torch, and the error
    feedback carries that on)."""
    jres, tres = _runs(checkpoint, name, monkeypatch)
    jm, tm, spec = jres['model'], tres['model'], tres['opt'].wspec
    shares = []
    for b in range(tm.n_blocks):
        for path in tm.get_layout().linears:
            jq, js = _codes(get_path(jm.params['blocks'][b], path), spec)
            tq, ts = _codes(get_path(tm.params['blocks'][b], path), spec)
            assert tq.shape == jq.shape
            shares.append(float((tq == jq).float().mean()))
            np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=1e-5,
                                       atol=1e-7)
    assert min(shares) >= 0.99, shares


@pytest.mark.parametrize('algo', ['static_minmax', 'static_moving_minmax',
                                  'static_hist'])
@pytest.mark.parametrize('sym', [True, False])
def test_static_act_qparams_bit_equal(algo, sym):
    """The per-tensor static activation qparams of the three calibrations
    from the same batches, bit for bit (the reference computes them
    eagerly)."""
    from llmc_tpu.quant import quantizer as JQ
    from llmc_tpu.quant.qspec import QuantSpec as JSpec
    from llmc_tpu_torch.quant import quantizer as TQ
    from llmc_tpu_torch.quant.qspec import QuantSpec
    rng = np.random.RandomState(5)
    batches = [(rng.randn(2, 24, 64) * (1 + i)).astype(np.float32)
               for i in range(4)]
    kw = dict(bit=8, symmetric=sym, granularity='per_tensor')
    jq = JQ.static_qparams_from_batches(
        JSpec(**kw), [jax.numpy.asarray(b) for b in batches], algo)
    tq = TQ.static_qparams_from_batches(
        QuantSpec(**kw), [torch.as_tensor(b) for b in batches], algo)
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.zeros.numpy(), np.asarray(jq.zeros))


def test_static_act_qparams_of_the_pipeline(checkpoint, monkeypatch):
    """The pipeline's static qparams of every (block, capture key), from
    activations that differ in their last bits between XLA and torch:
    within 1e-6 relative."""
    jres, tres = _runs(checkpoint, 'rtn_w_a_pertensor_static', monkeypatch)
    jq, tq = jres['opt'].static_aqparams, tres['opt'].static_aqparams
    assert set(jq) == set(tq) and len(tq) == 2 * 4
    for key in jq:
        np.testing.assert_allclose(tq[key].scales.numpy(),
                                   np.asarray(jq[key].scales), rtol=1e-6)
        np.testing.assert_array_equal(tq[key].zeros.numpy(),
                                      np.asarray(jq[key].zeros))


def test_check_special_fails_before_any_work(checkpoint):
    """An invalid GPTQ option combination raises from the pipeline's
    fail-fast check (before the model is built), as in the reference."""
    quant = method_quant('gptq_owq')
    quant['special'] = dict(quant['special'], static_groups=True)
    with pytest.raises(ValueError, match='static_groups with owq'):
        run_pipeline(pipeline_config('/nonexistent/ckpt', quant),
                     device='cpu')
    with pytest.raises(ValueError, match='n_outs'):
        GPTQ.check_special({'owq': True})


def test_quarot_rotation_comes_from_a_generator():
    """Without a rotation handed in, QuaRot's comes from a torch.Generator
    seeded with special.seed: orthogonal, the same for the same seed."""
    from llmc_tpu_torch.ops.hadamard import get_rotation
    q1 = get_rotation(64, torch.Generator().manual_seed(0))
    q2 = get_rotation(64, torch.Generator().manual_seed(0))
    assert torch.equal(q1, q2)
    np.testing.assert_allclose((q1 @ q1.T).numpy(), np.eye(64), atol=1e-5)
