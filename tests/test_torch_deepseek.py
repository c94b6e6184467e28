"""DeepSeek-V2/V3 (MLA and a shared-and-routed MoE) of the port against the
JAX package's on the CPU at float32: the interleaved rope, ``mla_apply``
with ``q_lora_rank`` unset and set (its captures, and the quantized
attention's fake-quant points), ``moe_apply`` (renormalised and scaled
too), the dense and MoE blocks, ``forward_logits``, the layout and the
inspect functions; checkpoints written with transformers, plain and as an
FP8-block checkpoint stores them, loaded by both packages to the same
tree.  And the configs the reference loads without error but computes
wrongly (ROADMAP C): a yarn ``rope_scaling``, V3's sigmoid / noaux_tc /
group-limited routing and its ``e_score_correction_bias``; the port
raises on each, beside the value the JAX package silently computes.
Inputs are made with numpy from a seed; 1e-5 relative."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import deepseek as JDS
from llmc_tpu.models.adapter import DeepseekV2Adapter as JAdapter
from llmc_tpu.models.adapter import DeepseekV3Adapter as JAdapterV3
from llmc_tpu_torch.convert import params_to_numpy
from llmc_tpu_torch.models import deepseek as DS
from llmc_tpu_torch.models.adapter import (DeepseekV2Adapter,
                                           DeepseekV3Adapter, QMap)
from llmc_tpu_torch.models.base import LinearQcfg
from torch_port_helpers import DS_TINY, port_params, rel_err, to_np

TOL = 1e-5
# the tiny V2 of the JAX package's own tests, written by transformers
HF_TINY = dict({k: v for k, v in DS_TINY.items() if k != 'dtype'},
               routed_scaling_factor=1.0, norm_topk_prob=False,
               moe_layer_freq=1, num_key_value_heads=4)


def _models(seed=4, **over):
    kw = dict(DS_TINY, **over)
    jm = JAdapter.random(JDS.DeepseekConfig(**kw), seed=seed)
    return jm, DeepseekV2Adapter(DS.DeepseekConfig(**kw),
                                 port_params(jm.params))


def _x(shape=(2, 7, 64), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _kw(jm, S=7, B=2):
    jkw = jm.embed_and_rope(jnp.zeros((B, S), jnp.int32))[1]
    return jkw, {k: torch.as_tensor(np.array(v)) for k, v in jkw.items()}


def test_interleaved_rope_matches_jax():
    cfg = DS.DeepseekConfig(**DS_TINY)
    pos = np.arange(11)[None].repeat(2, 0) + np.array([[0], [5]])
    jc, js = JDS.rope_freqs(JDS.DeepseekConfig(**DS_TINY), jnp.asarray(pos))
    tc, ts = DS.rope_freqs(cfg, torch.as_tensor(pos))
    np.testing.assert_allclose(tc.numpy(), jc, rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), js, rtol=TOL, atol=1e-6)
    x = _x((2, 11, 4, 8))
    want = JDS.apply_rope_interleaved(jnp.asarray(x), jc, js)
    got = DS.apply_rope_interleaved(torch.as_tensor(x), tc, ts)
    assert rel_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize('quant_attn', [False, True])
@pytest.mark.parametrize('q_lora_rank', [None, 32])
def test_mla_apply_matches_jax(q_lora_rank, quant_attn):
    """The attention with the low-rank q or one ``q_proj``, its captures
    (``q_b_in``, ``kv_b_in``, ``o_in``), and under a quantized-attention
    QMap (8-bit per-token fake-quant at ``matmul_1`` / ``softmax`` /
    ``matmul_2``)."""
    from llmc_tpu.models.adapter import QMap as JQMap
    from llmc_tpu.models.base import LinearQcfg as JQcfg
    from llmc_tpu.quant.qspec import QuantSpec as JSpec
    from llmc_tpu_torch.quant.qspec import QuantSpec
    jm, tm = _models(q_lora_rank=q_lora_rank)
    jqm = tqm = None
    if quant_attn:
        spec = dict(bit=8, symmetric=True, granularity='per_token')
        paths = ('self_attn.matmul_1', 'self_attn.softmax',
                 'self_attn.matmul_2')
        jqm = JQMap({p: JQcfg(a_spec=JSpec(**spec)) for p in paths})
        tqm = QMap({p: LinearQcfg(a_spec=QuantSpec(**spec)) for p in paths})
    jkw, tkw = _kw(jm)
    x = _x()
    jy, jc = JDS.mla_apply(jm.params['blocks'][1]['self_attn'], jm.cfg,
                           jnp.asarray(x), jkw['cos'], jkw['sin'], None,
                           jqm, capture=True)
    ty, tc = DS.mla_apply(tm.params['blocks'][1]['self_attn'], tm.cfg,
                          torch.as_tensor(x), tkw['cos'], tkw['sin'], None,
                          tqm, capture=True)
    assert rel_err(ty.numpy(), jy) <= TOL
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert rel_err(tc[k].numpy(), jc[k]) <= TOL, k


@pytest.mark.parametrize('norm_topk,scale', [(False, 1.0), (True, 2.5)])
def test_moe_apply_matches_jax(norm_topk, scale):
    """Softmax routing, the top k, the optional renormalisation, the
    routed scaling factor and the shared experts, with the captures."""
    jm, tm = _models(norm_topk_prob=norm_topk, routed_scaling_factor=scale)
    x = _x()
    jy, jc = JDS.moe_apply(jm.params['blocks'][1]['mlp'], jm.cfg,
                           jnp.asarray(x), capture=True)
    ty, tc = DS.moe_apply(tm.params['blocks'][1]['mlp'], tm.cfg,
                          torch.as_tensor(x), capture=True)
    assert rel_err(ty.numpy(), jy) <= TOL
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert rel_err(tc[k].numpy(), jc[k]) <= TOL, k


@pytest.mark.parametrize('block', [0, 1], ids=['dense', 'moe'])
def test_block_apply_matches_jax(block):
    jm, tm = _models()
    jkw, tkw = _kw(jm)
    x = _x()
    jy, jc, _ = jm.block_fn()(jm.params['blocks'][block], jnp.asarray(x),
                              jkw, capture=True)
    ty, tc = tm.block_fn()(tm.params['blocks'][block], torch.as_tensor(x),
                           tkw, capture=True)
    assert rel_err(ty.numpy(), jy) <= TOL
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert rel_err(tc[k].numpy(), jc[k]) <= TOL, k


@pytest.mark.parametrize('q_lora_rank', [None, 32])
def test_forward_logits_layout_and_inspect_match_jax(q_lora_rank):
    jm, tm = _models(q_lora_rank=q_lora_rank)
    ids = np.random.RandomState(1).randint(0, 128, (2, 9))
    assert rel_err(tm.forward_logits(torch.as_tensor(ids)).numpy(),
                   jm.forward_logits(jnp.asarray(ids))) <= TOL
    jl, tl = jm.get_layout(), tm.get_layout()
    assert [vars(s) for s in tl.subsets] == [vars(s) for s in jl.subsets]
    assert (tl.linears, tl.capture_of, tl.layernorms) == (
        jl.linears, jl.capture_of, jl.layernorms)
    assert sorted(tm.inspect_fns()) == sorted(jm.inspect_fns())
    jfns, tfns = jm.inspect_fns(), tm.inspect_fns()
    jkw, tkw = _kw(jm)
    cfg = tm.cfg
    widths = {'kv_b_in': cfg.kv_lora_rank, 'q_b_in': 32,
              'shared_down_in': cfg.moe_intermediate_size,
              **{f'down_in_{e}': cfg.moe_intermediate_size
                 for e in range(cfg.n_routed_experts)}}
    for i, s in enumerate(jl.subsets):
        x = _x((2, 7, widths.get(s.input_key, 64)), seed=i)
        want = jfns[s.inspect](jm.params['blocks'][1], jnp.asarray(x), jkw)
        got = tfns[s.inspect](tm.params['blocks'][1], torch.as_tensor(x),
                              tkw)
        assert rel_err(got.numpy(), want) <= TOL, s.name


def test_masked_calibration_kwargs_match_jax():
    """``embed_and_rope_p`` under a left-padding mask: the positions count
    the valid tokens and the additive bias masks the padding."""
    jm, tm = _models()
    ids = np.random.RandomState(3).randint(0, 128, (2, 7))
    mask = np.ones((2, 7), np.int32)
    mask[1, :3] = 0
    jx, jkw = jm.embed_and_rope(jnp.asarray(ids), jnp.asarray(mask))
    tx, tkw = tm.embed_and_rope_p(tm.params, torch.as_tensor(ids),
                                  torch.as_tensor(mask))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for k in jkw:
        np.testing.assert_allclose(tkw[k].numpy(), np.asarray(jkw[k]),
                                   rtol=TOL, atol=1e-6)
    jy = jm.block_fn()(jm.params['blocks'][1], jx, jkw)[0]
    ty = tm.block_fn()(tm.params['blocks'][1], tx, tkw)[0]
    assert rel_err(ty.numpy(), jy) <= TOL


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """(plain dir, FP8-block dir) of the tiny V2, written with
    transformers as the JAX package's tests write it; the FP8 copy stores
    the block linears of whole 16 x 16 blocks as e4m3 codes with a
    ``weight_scale_inv`` a block."""
    import transformers as tr
    from safetensors import safe_open
    from safetensors.flax import save_file as save_flax
    from llmc_tpu.quant import fp8_block as JF
    root = tmp_path_factory.mktemp('ds')
    plain, fp8 = str(root / 'plain'), str(root / 'fp8')
    torch.manual_seed(0)
    model = tr.DeepseekV2ForCausalLM(tr.DeepseekV2Config(
        tie_word_embeddings=False, attention_bias=False, **HF_TINY))
    model.save_pretrained(plain, safe_serialization=True)
    flat = {}
    with safe_open(os.path.join(plain, 'model.safetensors'),
                   framework='flax') as f:
        for name in f.keys():
            flat[name] = f.get_tensor(name)
    for name in list(flat):
        # the linears whose shape is whole blocks (a real V3's all are:
        # 128 divides them), as both loaders infer the block size
        if name.endswith('proj.weight') and not any(
                d % 16 for d in flat[name].shape):
            codes, scale_inv = JF.weight_cast_to_fp8(flat[name], 16)
            flat[name] = codes
            flat[name + '_scale_inv'] = scale_inv
    os.makedirs(fp8)
    save_flax(flat, os.path.join(fp8, 'model.safetensors'))
    shutil.copy(os.path.join(plain, 'config.json'), fp8)
    return plain, fp8


@pytest.mark.parametrize('kind', ['plain', 'fp8_block'])
@pytest.mark.parametrize('stream', [False, True])
def test_checkpoint_loads_the_same_tree_and_logits(checkpoints, kind,
                                                   stream):
    path = checkpoints[kind == 'fp8_block']
    jm = JAdapter.from_pretrained(path, dtype=jnp.float32)
    tm = DeepseekV2Adapter.from_pretrained(path, dtype=torch.float32,
                                           stream=stream, device='cpu')
    assert tm.cfg == DS.DeepseekConfig(**vars(jm.cfg))
    jt, tt = to_np(jm.params), params_to_numpy(tm.params)
    assert jax.tree.structure(jt) == jax.tree.structure(tt)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
        np.testing.assert_array_equal(b, a)
    ids = np.random.RandomState(0).randint(0, 128, (1, 10))
    assert rel_err(tm.forward_logits(torch.as_tensor(ids)).numpy(),
                   jm.forward_logits(jnp.asarray(ids))) <= TOL


def test_v3_type_and_build_model(checkpoints):
    """``DeepseekV3`` is the V2 graph under its own name, as in the
    reference; ``build_model`` reaches both types."""
    from llmc_tpu_torch.models import build_model
    assert issubclass(DeepseekV3Adapter, DeepseekV2Adapter)
    assert issubclass(JAdapterV3, JAdapter)
    m = build_model({'model': {'type': 'DeepseekV3', 'path': checkpoints[0],
                               'torch_dtype': 'float8_e4m3fn'}},
                    device='cpu')
    assert type(m) is DeepseekV3Adapter
    assert m.params['embed_tokens']['w'].dtype == torch.bfloat16
    m = build_model({'model': {'type': 'DeepseekV2', 'seed': 2,
                               'arch': DS_TINY}}, device='cpu')
    assert m.forward_logits(torch.zeros((1, 3), dtype=torch.long)
                            ).shape == (1, 3, 128)


def _with_config(src, dst, **over):
    shutil.copytree(src, dst)
    with open(os.path.join(dst, 'config.json')) as f:
        hf = json.load(f)
    hf.update(over)
    with open(os.path.join(dst, 'config.json'), 'w') as f:
        json.dump(hf, f)
    return dst


YARN = {'type': 'yarn', 'factor': 40, 'original_max_position_embeddings':
        4096, 'beta_fast': 32, 'beta_slow': 1, 'mscale': 0.707,
        'mscale_all_dim': 0.707}
REFUSED = {
    'yarn_rope_scaling': dict(rope_scaling=YARN),
    'sigmoid_scoring': dict(scoring_func='sigmoid'),
    'noaux_tc_topk': dict(topk_method='noaux_tc'),
    'group_limited_topk': dict(topk_method='group_limited_greedy',
                               n_group=2, topk_group=1),
    'group_limit_alone': dict(n_group=4, topk_group=2),
}


@pytest.mark.parametrize('case', sorted(REFUSED))
def test_refuses_what_the_reference_computes_wrongly(checkpoints, tmp_path,
                                                     case):
    """The JAX package loads each config and computes the model as if the
    key were absent (unscaled rope, softmax-greedy top-k over every
    expert): its logits equal the plain checkpoint's.  The port raises."""
    path = _with_config(checkpoints[0], str(tmp_path / case),
                        **REFUSED[case])
    ids = jnp.asarray(np.random.RandomState(0).randint(0, 128, (1, 6)))
    plain = JAdapter.from_pretrained(checkpoints[0], dtype=jnp.float32)
    silent = JAdapter.from_pretrained(path, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(silent.forward_logits(ids)),
                                  np.asarray(plain.forward_logits(ids)))
    with pytest.raises(NotImplementedError):
        DeepseekV2Adapter.from_pretrained(path, device='cpu')


def test_plain_configs_still_load():
    """A greedy softmax config with no rope scaling loads, the way
    DeepSeek-V2-Lite's routing reads (``topk_method: greedy``, one
    group)."""
    DS.check_hf_config(dict(topk_method='greedy', scoring_func='softmax',
                            n_group=1, topk_group=1,
                            rope_scaling={'type': 'default'}))
    DS.check_hf_config({})


def test_refuses_a_score_correction_bias(checkpoints, tmp_path):
    """A V3 checkpoint's gate carries ``e_score_correction_bias``: the
    JAX package never reads it; the port raises."""
    from safetensors.torch import load_file, save_file
    dst = str(tmp_path / 'bias')
    shutil.copytree(checkpoints[0], dst)
    f = os.path.join(dst, 'model.safetensors')
    flat = load_file(f)
    flat['model.layers.1.mlp.gate.e_score_correction_bias'] = torch.ones(4)
    save_file(flat, f)
    jm = JAdapter.from_pretrained(dst, dtype=jnp.float32)
    assert 'e_score_correction_bias' not in jm.params['blocks'][1]['mlp'][
        'gate']
    with pytest.raises(NotImplementedError, match='e_score_correction'):
        DeepseekV2Adapter.from_pretrained(dst, device='cpu')
