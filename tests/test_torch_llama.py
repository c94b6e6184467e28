"""Port parity of the Llama model (llmc_tpu_torch.models): f32 logits of
model_apply within 1e-5 relative of llmc_tpu on a tiny GQA Llama whose
weights are carried across by convert.params_from_numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models import base as JB
from llmc_tpu.models import llama as JL
from llmc_tpu_torch.convert import params_from_numpy
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models import base as TB
from llmc_tpu_torch.models import llama as TL
from torch_port_helpers import TINY, perturbed, port_params, rel_err

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def pair():
    jm = JAdapter.random(JConfig(**TINY), seed=0)
    return jm, LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))


def test_model_apply_logits_match(pair):
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 128, (2, 9))
    want = np.asarray(jm.forward_logits(jnp.asarray(ids)))
    got = tm.forward_logits(torch.as_tensor(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 9, 128)
    assert rel_err(got.numpy(), want) < 1e-5


def test_block_captures_match(pair):
    jm, tm = pair
    x = np.random.RandomState(1).randn(1, 5, 64).astype(np.float32)
    jc, js = JL.rope_cos_sin(jm.cfg, jnp.arange(5)[None])
    tc, ts = TL.rope_cos_sin(tm.cfg, torch.arange(5)[None])
    jy, jcaps, _ = JL.block_apply(jm.params['blocks'][1], jm.cfg,
                                  jnp.asarray(x), jc, js, capture=True)
    ty, tcaps = TL.block_apply(tm.params['blocks'][1], tm.cfg,
                               torch.as_tensor(x), tc, ts, capture=True)
    assert rel_err(ty.numpy(), jy) < 1e-5
    assert sorted(tcaps) == sorted(jcaps)
    for key in jcaps:
        assert rel_err(tcaps[key].numpy(), jcaps[key]) < 1e-5


@pytest.mark.parametrize('scaling', [None, 'linear', 'llama3'])
def test_rope_tables_match(scaling):
    kw = dict(head_dim=64, rope_theta=500000.0, rope_scaling_type=scaling,
              rope_scaling_factor=8.0, rope_original_max_pos=64)
    pos = np.array([[0, 1, 7, 300, 4095]])
    jc, js = JL.rope_cos_sin(JConfig(**kw), jnp.asarray(pos))
    tc, ts = TL.rope_cos_sin(LlamaConfig(**kw), torch.as_tensor(pos))
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), js, atol=2e-5)


@pytest.mark.parametrize('scaling', ['yarn', 'dynamic'])
def test_unknown_rope_scaling_raises(scaling):
    """A rope_scaling type the reference computes unscaled (it applies
    only linear and llama3) raises in the port instead."""
    cfg = LlamaConfig(head_dim=64, rope_scaling_type=scaling,
                      rope_scaling_factor=4.0)
    with pytest.raises(NotImplementedError, match=scaling):
        TL.rope_cos_sin(cfg, torch.as_tensor(np.array([[0, 1]])))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_norms_match(dtype):
    """rms_norm keeps the cast to x.dtype before the weight multiply."""
    x = np.random.RandomState(2).randn(3, 64).astype(np.float32) * 3
    w = np.random.RandomState(3).rand(64).astype(np.float32)
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.as_tensor(x).to(tdt)
    jr = JB.rms_norm(jx, jnp.asarray(w).astype(dtype), 1e-5)
    tr = TB.rms_norm(tx, torch.as_tensor(w).to(tdt), 1e-5)
    tol = 1e-6 if dtype == 'float32' else 1e-2
    assert rel_err(tr.float().numpy(), np.asarray(jr, np.float32)) < tol
    b = np.random.RandomState(4).randn(64).astype(np.float32)
    jn = JB.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    tn = TB.layer_norm(torch.as_tensor(x), torch.as_tensor(w),
                       torch.as_tensor(b), 1e-5)
    assert rel_err(tn.numpy(), jn) < 1e-5


def test_config_from_hf_and_layout_match():
    hf = {'vocab_size': 1000, 'hidden_size': 256, 'intermediate_size': 512,
          'num_hidden_layers': 3, 'num_attention_heads': 8,
          'num_key_value_heads': 2, 'torch_dtype': 'float16',
          'rope_scaling': {'rope_type': 'llama3', 'factor': 8.0}}
    jc, tc = JConfig.from_hf(hf), LlamaConfig.from_hf(hf)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert hash(tc) == hash(LlamaConfig.from_hf(hf))
    jl, tl = JL.llama_layout(jc), TL.llama_layout(tc)
    assert jl.linears == tl.linears and jl.capture_of == tl.capture_of
    assert [s.name for s in jl.subsets] == [s.name for s in tl.subsets]


@pytest.mark.parametrize('opt,owner', [
    (dict(layer_scale=True), 'VLM tier'),
    (dict(qk_norm_full=True), 'VLM tier'),
    (dict(learned_pos_offset=2), 'OPT'),
    (dict(learned_pos=True, learned_pos_offset=2), 'OPT')])
def test_unported_graph_options_raise(opt, owner):
    """The options that raised until their slice ported them run: the
    logits of ``model_apply`` within 1e-5 of the reference's on the same
    weights.  InternViT's layer scale and full-width qk-norm (the VLM
    tier) run in the eager graph, with the reference's random ``ls1`` /
    ``ls2`` and q / k norms moved off their init; OPT's offset positions
    also through a cached prefill plus two decode steps (each slot at its
    own position)."""
    cfg = LlamaConfig(**dict(TINY, **opt))
    from llmc_tpu.serve import decode as JD
    from llmc_tpu_torch.serve import decode as TD
    jm = JAdapter.random(JConfig(**dict(TINY, **opt)), seed=4)
    if owner != 'OPT':
        jm.params = jax.tree.map(jnp.asarray, perturbed(
            jax.tree.map(np.asarray, jm.params), np.random.RandomState(5)))
        blk = jm.params['blocks'][0]
        assert ('ls1' in blk) == cfg.layer_scale
        assert ('q_norm' in blk['self_attn']) == cfg.qk_norm_full
    tm = LlamaAdapter(cfg, port_params(jm.params))
    ids = np.random.RandomState(2).randint(0, 128, (2, 7))
    want = np.asarray(jm.forward_logits(jnp.asarray(ids)))
    assert rel_err(tm.forward_logits(torch.as_tensor(ids)).numpy(),
                   want) < 1e-5
    if owner != 'OPT':
        return
    jc = JD.init_cache(jm, 2, 9)
    tc = TD.init_cache(tm, 2, 9, device='cpu')
    jc['pos'] = jnp.asarray([0, 0], jnp.int32)
    tc['pos'] = torch.zeros(2, dtype=torch.int32)
    for s in (slice(0, 5), slice(5, 6), slice(6, 7)):
        jl, jc = JD.forward_cached(jm.params, jm.cfg, jnp.asarray(ids[:, s]),
                                   jc, JD.FP_POLICY)
        tl, tc = TD.forward_cached(tm.params, tm.cfg,
                                   torch.as_tensor(ids[:, s]), tc,
                                   TD.FP_POLICY)
        assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-5


def test_linear_qcfg_unported_fields_raise(pair):
    """No field is left unported: QUIK's mixed columns, the LLM.int8
    decomposition, the online rotation and straight-through rounding,
    which raised until they were ported, give the reference's output."""
    from llmc_tpu.models import base as JB
    from llmc_tpu.quant.qspec import QuantSpec as JSpec
    from llmc_tpu_torch.quant.qspec import QuantSpec
    jm, tm = pair
    mask = np.ones(64, bool)
    mask[[5, 17, 40]] = False           # QUIK's fp columns
    p = dict(tm.blocks[0]['self_attn']['q_proj'],
             int_mask=torch.as_tensor(mask))
    jp = dict(jm.blocks[0]['self_attn']['q_proj'],
              int_mask=jnp.asarray(mask))
    x = np.random.RandomState(2).randn(3, 64).astype(np.float32) * 2
    x[:, 5] = 9.0     # an outlier column past the threshold
    spec = dict(bit=8, symmetric=True, granularity='per_token')
    wspec = dict(bit=8, symmetric=True, granularity='per_channel')
    for kw, jkw in ((dict(a_outlier_threshold=6.0, a_spec=QuantSpec(**spec),
                          w_spec=QuantSpec(**wspec)),
                     dict(a_outlier_threshold=6.0, a_spec=JSpec(**spec),
                          w_spec=JSpec(**wspec))),
                    (dict(pre_had='full'), dict(pre_had='full')),
                    (dict(ste=True, a_spec=QuantSpec(**spec),
                          w_spec=QuantSpec(**wspec)),
                     dict(ste=True, a_spec=JSpec(**spec),
                          w_spec=JSpec(**wspec))),
                    (dict(mixed_cols=True, a_spec=QuantSpec(**spec),
                          w_spec=QuantSpec(**wspec)),
                     dict(mixed_cols=True, a_spec=JSpec(**spec),
                          w_spec=JSpec(**wspec)))):
        got = TB.linear_apply(p, torch.as_tensor(x), TB.LinearQcfg(**kw))
        want = JB.linear_apply(jp, jnp.asarray(x), JB.LinearQcfg(**jkw))
        assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_random_is_seeded_and_needs_card_without_device():
    cfg = LlamaConfig(**TINY)
    a = LlamaAdapter.random(cfg, seed=5, device='cpu')
    b = LlamaAdapter.random(cfg, seed=5, device='cpu')
    assert torch.equal(a.params['blocks'][1]['mlp']['down_proj']['w'],
                       b.params['blocks'][1]['mlp']['down_proj']['w'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            LlamaAdapter.random(cfg)
        with pytest.raises(RuntimeError, match='CUDA'):
            params_from_numpy({'w': np.zeros(3, np.float32)})


def test_converter_handles_bfloat16_and_packed_bytes():
    jm = JAdapter.random(JConfig(**dict(TINY, dtype='bfloat16')), seed=2)
    tp = port_params(jm.params)
    w = tp['blocks'][0]['self_attn']['k_proj']['w']
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        np.asarray(jm.params['blocks'][0]['self_attn']['k_proj']['w'])
        .view(np.int16))
    f32 = params_from_numpy({'w': np.asarray(
        jm.params['norm']['w'])}, 'cpu', dtype=torch.float32)
    assert f32['w'].dtype == torch.float32
