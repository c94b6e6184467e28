"""OPT in the port (llmc_tpu_torch.models.opt, ``OptAdapter``) against
the JAX package's and against transformers on the CPU at float32: tiny
``OPTForCausalLM`` checkpoints written by transformers (the mainline
pre-LN shape, a projected embedding, and opt-350m's post-LN layout), the
native graph's logits and layout, the generalized view's logits and its
cached decode over fp and int8 caches, RTN and AWQ through both
``run_pipeline``s, and the packed model served by the engine."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import opt as JO
from llmc_tpu.models.adapter import OptAdapter as JOpt
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve import decode as JD
from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu.serve.packed import pack_model as j_pack_model
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models import opt as TO
from llmc_tpu_torch.models.adapter import OptAdapter
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve import (KVCachePolicy, Request, ServingEngine,
                                  pack_model)
from llmc_tpu_torch.serve import decode as TD
from torch_port_helpers import rel_err

torch.set_num_threads(1)

OPT_TINY = dict(vocab_size=256, hidden_size=64, ffn_dim=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64)
# (word_embed_proj_dim, do_layer_norm_before): opt-125m's shape, a
# projected embedding, opt-350m's LayerNorm after each sublayer
SHAPES = {'mainline': (64, True), 'projected': (32, True),
          'post_ln': (64, False)}
W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=32)
POLICIES = {'fp': dict(method='fp'), 'int8': dict(method='naive', bit=8)}


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """shape -> (path, the transformers model), each written with
    ``save_pretrained`` from random weights (biases and LayerNorms moved
    off their init, so that every one of them is read)."""
    from transformers import OPTConfig, OPTForCausalLM
    out = {}
    for name, (proj, pre) in SHAPES.items():
        torch.manual_seed(0)
        model = OPTForCausalLM(OPTConfig(word_embed_proj_dim=proj,
                                         do_layer_norm_before=pre,
                                         **OPT_TINY)).eval()
        with torch.no_grad():
            for n, p in model.named_parameters():
                if p.ndim == 1:
                    p.add_(0.1 * torch.randn_like(p))
        path = str(tmp_path_factory.mktemp(f'opt_{name}'))
        model.save_pretrained(path, safe_serialization=True)
        out[name] = (path, model)
    return out


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(4, 250, shape)


@pytest.mark.parametrize('shape', list(SHAPES))
def test_native_graph_matches_jax_and_hf(checkpoints, shape):
    """``model_apply`` of the native graph within 1e-5 relative of the
    reference's and of transformers', with the same layout."""
    path, hf = checkpoints[shape]
    jm = JOpt.from_pretrained(path)
    tm = OptAdapter.from_pretrained(path, device='cpu')
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    ids = _ids((2, 10))
    want = np.asarray(jm.forward_logits(jnp.asarray(ids)))
    got = tm.forward_logits(torch.as_tensor(ids)).numpy()
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).logits.numpy()
    assert rel_err(got, want) < 1e-5 and rel_err(got, ref) < 1e-5
    jl, tl = jm.get_layout(), tm.get_layout()
    assert (jl.linears, jl.layernorms, jl.capture_of) == \
        (tl.linears, tl.layernorms, tl.capture_of)
    assert [dataclasses.asdict(s) for s in jl.subsets] == \
        [dataclasses.asdict(s) for s in tl.subsets]
    # the block's captures under an attention mask
    mask = np.ones((2, 10), np.int64)
    mask[1, :3] = 0
    jx, jkw = jm.embed_and_rope(jnp.asarray(ids), jnp.asarray(mask))
    tx, tkw = tm.embed_and_rope_p(tm.params, torch.as_tensor(ids),
                                  torch.as_tensor(mask))
    jy, jcaps, _ = jm.block_fn()(jm.blocks[1], jx, jkw, capture=True)
    ty, tcaps = tm.block_fn()(tm.blocks[1], tx, tkw, capture=True)
    assert rel_err(ty.numpy(), jy) < 1e-5
    for k in jcaps:
        assert rel_err(tcaps[k].numpy(), jcaps[k]) < 1e-5


def test_generalized_view_refuses_what_the_reference_refuses(checkpoints):
    for shape in ('projected', 'post_ln'):
        tm = OptAdapter.from_pretrained(checkpoints[shape][0], device='cpu')
        with pytest.raises(NotImplementedError, match='generalized OPT'):
            tm.as_generalized()


@pytest.fixture(scope='module')
def generalized(checkpoints):
    path, _ = checkpoints['mainline']
    jm = JOpt.from_pretrained(path)
    tm = OptAdapter.from_pretrained(path, device='cpu')
    return jm, tm, jm.as_generalized(), tm.as_generalized()


@pytest.mark.parametrize('kv', list(POLICIES))
def test_generalized_cached_decode_matches_jax(generalized, kv):
    """The generalized view's logits within 1e-5 of the native graph's;
    a prefill and five decode steps through ``forward_cached`` within
    2e-4 of the reference's, over an fp and an int8 cache."""
    jm, tm, jg, tg = generalized
    ids = _ids((2, 11), seed=1)
    native = tm.forward_logits(torch.as_tensor(ids)).numpy()
    assert rel_err(tg.forward_logits(torch.as_tensor(ids)).numpy(),
                   native) < 1e-5
    jp, tp = JPolicy(**POLICIES[kv]), KVCachePolicy(**POLICIES[kv])
    jc = JD.init_cache(jg, 2, 11, jp)
    tc = TD.init_cache(tg, 2, 11, tp, device='cpu')
    for s in [slice(0, 6)] + [slice(t, t + 1) for t in range(6, 11)]:
        jl, jc = JD.forward_cached(jg.params, jg.cfg, jnp.asarray(ids[:, s]),
                                   jc, jp)
        tl, tc = TD.forward_cached(tg.params, tg.cfg,
                                   torch.as_tensor(ids[:, s]), tc, tp)
        assert rel_err(tl.numpy(), np.asarray(jl)) < 2e-4


def _opt_config(path, method, special=None, save_path=None):
    cfg = dict(
        base=dict(seed=1), model=dict(type='Opt', path=path),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=16,
                   seed=0, vocab_size=256),
        eval=dict(name='synthetic', num_tokens=1024, seq_len=32,
                  vocab_size=256, bs=2,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=dict(method=method, weight=dict(W4)))
    if special:
        cfg['quant']['special'] = special
    if save_path:
        cfg['save'] = dict(save_trans=True, save_path=save_path)
    return cfg


@pytest.mark.parametrize('method,special', [
    ('RTN', None),
    ('Awq', dict(trans=True, trans_version='v2', weight_clip=False)),
    ('Awq', dict(trans=True, weight_clip=True, clip_version='v1'))])
def test_pipeline_on_opt_matches_jax(checkpoints, tmp_path, method,
                                     special):
    """RTN and AWQ (the reference's ``test_opt_awq_pipeline`` and AWQ with
    its clip) through both pipelines: PPLs within 1e-3, the transformed
    PPL the pretrain one within 2e-3 (OPT's biases ride the scale
    transform).  The port's ``save_trans`` writes an OPT checkpoint that
    loads back to the transformed model's logits (the reference's save
    reads a Llama tree and fails on OPT)."""
    path, _ = checkpoints['mainline']
    jres = j_run_pipeline(_opt_config(path, method, special))
    out = str(tmp_path / 'saved')
    tres = run_pipeline(_opt_config(path, method, special, save_path=out),
                        device='cpu')
    for k in ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant'):
        assert abs(tres[k] - jres[k]) / jres[k] <= 1e-3, k
    assert tres['ppl_transformed'] == pytest.approx(tres['ppl_pretrain'],
                                                    rel=2e-3)
    back = OptAdapter.from_pretrained(out, device='cpu')
    ids = torch.as_tensor(_ids((1, 9)))
    np.testing.assert_array_equal(back.forward_logits(ids).numpy(),
                                  tres['model'].forward_logits(ids).numpy())


def test_packed_engine_tokens_match_jax(checkpoints):
    """The generalized view packed (W4 g32, fused q/k/v, head packed: the
    biased q/k/v fuse with their biases, the non-gated ReLU MLP keeps its
    up_proj) and served by the engine over an int8 cache: every request's
    greedy tokens equal the JAX engine's on the reference's packing of the
    same model."""
    path, _ = checkpoints['mainline']
    jg = JOpt.from_pretrained(path).as_generalized()
    tg = OptAdapter.from_pretrained(path, device='cpu').as_generalized()
    jq = j_pack_model(jg, JSpec(**W4), fuse=True, head=True)
    tq = pack_model(tg, QuantSpec(**W4), fuse=True, head=True)
    blk = tg.blocks[0]
    assert 'qkv_proj' in blk['self_attn'] and \
        blk['self_attn']['qkv_proj']['b'] is not None
    assert sorted(blk['mlp']) == ['down_proj', 'up_proj']
    rng = np.random.RandomState(3)
    prompts = [rng.randint(4, 250, (p,)) for p in (9, 4, 13)]
    kw = dict(max_batch=2, max_len=32, prefill_buckets=(16,))
    jr = [JRequest(uid=i, prompt_ids=p, max_new_tokens=6)
          for i, p in enumerate(prompts)]
    JEngine(jg, qmap=jq, kv_policy=JPolicy(method='naive', bit=8),
            **kw).run(jr)
    tr = [Request(uid=i, prompt_ids=p, max_new_tokens=6)
          for i, p in enumerate(prompts)]
    ServingEngine(tg, qmap=tq, kv_policy=KVCachePolicy(method='naive', bit=8),
                  device='cpu', **kw).run(tr)
    assert [r.output_ids for r in tr] == [list(r.output_ids) for r in jr]


def test_random_opt_tree_and_registry():
    """``model.type: Opt`` builds from an inline arch; the random tree has
    the reference's shapes (the position table 2 rows longer, a tied
    head)."""
    from llmc_tpu_torch.models import build_model
    m = build_model(dict(model=dict(type='Opt', arch=dict(OPT_TINY),
                                    seed=3)), device='cpu')
    assert isinstance(m, OptAdapter)
    jt = JO.init_params(JO.OptConfig(**OPT_TINY),
                        __import__('jax').random.PRNGKey(0))
    tt = TO.init_params(TO.OptConfig(**OPT_TINY),
                        torch.Generator().manual_seed(0), device='cpu')

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return None if t is None else tuple(t.shape)
    assert shapes(tt) == shapes(jt)
    assert tt['lm_head']['w'] is tt['embed_tokens']['w']


def test_params_from_numpy_carries_opt_trees():
    """``convert.params_from_numpy`` carries the JAX package's OPT trees,
    the native one (its ``None`` projections and tied head) and the
    generalized view, onto the port: the same logits within 1e-5."""
    import jax
    from llmc_tpu.models.adapter import OptAdapter as J
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    jm = J(JO.OptConfig(**OPT_TINY),
           JO.init_params(JO.OptConfig(**OPT_TINY), jax.random.PRNGKey(2)))
    tm = OptAdapter(TO.OptConfig(**OPT_TINY), params_from_numpy(
        jax.tree.map(np.asarray, jm.params), device='cpu'))
    assert tm.params['project_in'] is None
    ids = _ids((2, 7))
    want = np.asarray(jm.forward_logits(jnp.asarray(ids)))
    assert rel_err(tm.forward_logits(torch.as_tensor(ids)).numpy(),
                   want) < 1e-5
    jg = jm.as_generalized()
    tg = LlamaAdapter(LlamaConfig(**dataclasses.asdict(jg.cfg)),
                      params_from_numpy(jax.tree.map(np.asarray, jg.params),
                                        device='cpu'))
    assert rel_err(tg.forward_logits(torch.as_tensor(ids)).numpy(),
                   np.asarray(jg.forward_logits(jnp.asarray(ids)))) < 1e-5
