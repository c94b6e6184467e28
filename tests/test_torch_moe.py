"""The MoE families of the port (Mixtral, Qwen2-MoE) against the JAX
package's on the CPU at float32: ``moe_apply``, ``block_apply`` (with its
captures), ``forward_logits``, the layouts, the cached forward over the fp
and int8 caches (prefill then decode, the MoE branch of ``_finish_block``),
and checkpoints written with transformers loaded by both packages to the
same tree.  Also the router's tie rule (finding: ``torch.topk`` promises
no order among equal values, ``jax.lax.top_k`` puts the lower index
first), the MoE trees' round trip through ``convert.py``, and the
refusal of ``pack_model`` on an MoE model, beside the reference's serving
QMap that names no expert.  Inputs are made with numpy from a seed; 1e-5
relative unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import mixtral as JMX
from llmc_tpu.models import qwen2moe as JQM
from llmc_tpu.models.adapter import MixtralAdapter as JMixtral
from llmc_tpu.models.adapter import Qwen2MoeAdapter as JQwen2Moe
from llmc_tpu_torch.convert import params_from_numpy, params_to_numpy
from llmc_tpu_torch.models import adapter as A
from llmc_tpu_torch.models import base as B
from llmc_tpu_torch.models import mixtral as MX
from llmc_tpu_torch.models import qwen2moe as QM
from torch_port_helpers import DS_TINY, MX_TINY, port_params, rel_err, to_np

QM_TINY = dict(MX_TINY, shared_expert_intermediate_size=128)
FAMILIES = {
    'mixtral': (JMixtral, JMX.MixtralConfig, JMX, A.MixtralAdapter,
                MX.MixtralConfig, MX, 'block_sparse_moe', MX_TINY),
    'qwen2moe': (JQwen2Moe, JQM.Qwen2MoeConfig, JQM, A.Qwen2MoeAdapter,
                 QM.Qwen2MoeConfig, QM, 'mlp', QM_TINY),
}
TOL = 1e-5


def _models(name, seed=3, **over):
    jcls, jcfg, _, tcls, tcfg, _, _, tiny = FAMILIES[name]
    kw = dict(tiny, **over)
    jm = jcls.random(jcfg(**kw), seed=seed)
    return jm, tcls(tcfg(**kw), port_params(jm.params))


def _x(shape=(2, 7, 64), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('name,norm_topk', [('mixtral', False),
                                             ('qwen2moe', False),
                                             ('qwen2moe', True)])
def test_moe_apply_matches_jax(name, norm_topk):
    """The routed MLP and its per-expert captures (``down_in_{e}``, the
    shared expert's ``shared_down_in``); Qwen2-MoE with and without
    ``norm_topk_prob`` (Mixtral's top-k softmax has no such option)."""
    over = {'norm_topk_prob': norm_topk} if name == 'qwen2moe' else {}
    jm, tm = _models(name, **over)
    _, _, jmod, _, _, tmod, key, _ = FAMILIES[name]
    x = _x()
    jy, jc = jmod.moe_apply(jm.params['blocks'][0][key], jm.cfg,
                            jnp.asarray(x), capture=True)
    ty, tc = tmod.moe_apply(tm.params['blocks'][0][key], tm.cfg,
                            torch.as_tensor(x), capture=True)
    assert rel_err(ty.numpy(), jy) <= TOL
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert rel_err(tc[k].numpy(), jc[k]) <= TOL, k


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_block_apply_and_captures_match_jax(name):
    jm, tm = _models(name)
    x = _x()
    jkw = jm.embed_and_rope(jnp.zeros((2, 7), jnp.int32))[1]
    tkw = {k: torch.as_tensor(np.asarray(v)) for k, v in jkw.items()}
    jy, jc, _ = jm.block_fn()(jm.params['blocks'][1], jnp.asarray(x), jkw,
                              capture=True)
    ty, tc = tm.block_fn()(tm.params['blocks'][1], torch.as_tensor(x), tkw,
                           capture=True)
    assert rel_err(ty.numpy(), jy) <= TOL
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert rel_err(tc[k].numpy(), jc[k]) <= TOL, k


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_forward_logits_matches_jax(name):
    jm, tm = _models(name)
    ids = np.random.RandomState(1).randint(0, 128, (2, 9))
    want = np.asarray(jm.forward_logits(jnp.asarray(ids)))
    got = tm.forward_logits(torch.as_tensor(ids)).numpy()
    assert rel_err(got, want) <= TOL


def _layout_fields(layout):
    return ([vars(s) for s in layout.subsets], layout.linears,
            layout.layernorms, layout.capture_of)


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_layout_equals_jax(name):
    """Subset names, their fields, the linears and ``capture_of``; the
    inspect functions' names too."""
    jm, tm = _models(name)
    assert _layout_fields(tm.get_layout()) == _layout_fields(
        jm.get_layout())
    assert sorted(tm.inspect_fns()) == sorted(jm.inspect_fns())


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_inspect_fns_match_jax(name):
    """Every inspect function of the layout from its subset's input."""
    jm, tm = _models(name)
    jfns, tfns = jm.inspect_fns(), tm.inspect_fns()
    bj, bt = jm.params['blocks'][0], tm.params['blocks'][0]
    jkw = jm.embed_and_rope(jnp.zeros((2, 7), jnp.int32))[1]
    tkw = {k: torch.as_tensor(np.asarray(v)) for k, v in jkw.items()}
    widths = {f'down_in_{e}': tm.cfg.intermediate_size
              for e in range(tm.cfg.num_local_experts)}
    widths['shared_down_in'] = getattr(
        tm.cfg, 'shared_expert_intermediate_size', 0)
    for i, s in enumerate(jm.get_layout().subsets):
        x = _x((2, 7, widths.get(s.input_key, 64)), seed=i)
        want = jfns[s.inspect](bj, jnp.asarray(x), jkw)
        got = tfns[s.inspect](bt, torch.as_tensor(x), tkw)
        assert rel_err(got.numpy(), want) <= TOL, s.name


@pytest.mark.parametrize('kv', ['fp', 'int8'])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_forward_cached_prefill_then_decode_matches_jax(name, kv):
    """``forward_cached`` over the per-head cache: a 6-token prefill then
    three decode steps, the MoE MLP through ``_finish_block``'s branch."""
    from llmc_tpu.serve.decode import forward_cached as j_forward
    from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    from llmc_tpu_torch.serve.kvcache import KVCachePolicy
    jm, tm = _models(name)
    pol = dict(method='naive', bit=8) if kv == 'int8' else dict(method='fp')
    jp, tp = JPolicy(**pol), KVCachePolicy(**pol)
    ids = np.random.RandomState(2).randint(0, 128, (2, 9))
    cfg = jm.cfg
    jc = jp.init_cache(2, 16, cfg.num_key_value_heads, cfg.head_dim,
                       cfg.num_hidden_layers, dtype=jnp.float32)
    tc = init_cache(tm, 2, 16, tp, device='cpu')
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jl, jc = j_forward(jm.params, cfg, jnp.asarray(ids[:, lo:hi]), jc,
                           jp)
        tl, tc = forward_cached(tm.params, tm.cfg,
                                torch.as_tensor(ids[:, lo:hi]), tc, tp)
        assert rel_err(tl.numpy(), jl) <= TOL, (lo, hi)


def _hf_checkpoint(tmp_path_factory, name):
    import transformers as tr
    torch.manual_seed(0)
    if name == 'mixtral':
        cfg = tr.MixtralConfig(tie_word_embeddings=False, **{
            k: v for k, v in MX_TINY.items() if k != 'dtype'})
        model = tr.MixtralForCausalLM(cfg)
    else:
        cfg = tr.Qwen2MoeConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=96, shared_expert_intermediate_size=160,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
            norm_topk_prob=False, decoder_sparse_step=1,
            mlp_only_layers=[], tie_word_embeddings=False)
        model = tr.Qwen2MoeForCausalLM(cfg)
    path = str(tmp_path_factory.mktemp(name))
    model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """Tiny checkpoints written with transformers, as the JAX package's
    own tests write them."""
    return {n: _hf_checkpoint(tmp_path_factory, n) for n in FAMILIES}


@pytest.mark.parametrize('stream', [False, True])
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_checkpoint_loads_the_same_tree_and_logits(checkpoints, name,
                                                   stream):
    jcls, tcls = FAMILIES[name][0], FAMILIES[name][3]
    jm = jcls.from_pretrained(checkpoints[name], dtype=jnp.float32)
    tm = tcls.from_pretrained(checkpoints[name], dtype=torch.float32,
                              stream=stream, device='cpu')
    assert tm.cfg == type(tm.cfg)(**{
        k: getattr(jm.cfg, k) for k in tm.cfg.__dataclass_fields__})
    jt, tt = to_np(jm.params), params_to_numpy(tm.params)
    assert jax.tree.structure(jt) == jax.tree.structure(tt)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
        np.testing.assert_array_equal(b, a)
    ids = np.random.RandomState(0).randint(0, 128, (2, 10))
    assert rel_err(tm.forward_logits(torch.as_tensor(ids)).numpy(),
                   jm.forward_logits(jnp.asarray(ids))) <= TOL


def test_build_model_reaches_the_moe_types(checkpoints):
    """``model.type`` reaches each registered family, from a checkpoint
    (bf16 whatever ``torch_dtype`` says, as the reference's adapters load
    these families) and from ``model.arch``."""
    from llmc_tpu_torch.models import build_model
    for name, typ in (('mixtral', 'Mixtral'), ('qwen2moe', 'Qwen2Moe')):
        m = build_model({'model': {'type': typ, 'path': checkpoints[name],
                                   'torch_dtype': 'float32'}}, device='cpu')
        assert type(m) is FAMILIES[name][3]
        assert m.params['embed_tokens']['w'].dtype == torch.bfloat16
        m = build_model({'model': {'type': typ, 'seed': 1,
                                   'arch': FAMILIES[name][7]}},
                        device='cpu')
        assert m.forward_logits(torch.zeros((1, 3), dtype=torch.long)
                                ).shape == (1, 3, 128)
    for typ in ('DeepseekV2', 'DeepseekV3'):
        assert typ in A.MODEL_REGISTRY


def test_planted_router_tie_picks_the_lower_index():
    """Equal router values at the k-th place: ``base.top_k`` takes the
    lower expert index first, as ``jax.lax.top_k`` does, in bf16 and f32
    and at Mixtral's, Qwen1.5-MoE's and DeepSeek-V2-Lite's (E, k)."""
    rng = np.random.RandomState(0)
    for E, K in ((8, 2), (60, 4), (64, 6)):
        x = rng.randn(64, E).astype(np.float32)
        for r in range(64):   # a tie across the k-th place, spread out
            hi = np.sort(x[r])[::-1]
            a, b = rng.choice(E, 2, replace=False)
            x[r, a] = x[r, b] = hi[K - 1] + 1e-3 * (r % 3 == 0)
        for dt in (torch.float32, torch.bfloat16):
            t = torch.as_tensor(x).to(dt)
            jv, ji = jax.lax.top_k(jnp.asarray(t.float().numpy()), K)
            tv, ti = B.top_k(t, K)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.float().numpy(),
                                          np.asarray(jv))


def test_planted_router_tie_routes_as_jax():
    """Two experts with equal router rows tie on every token: Mixtral's
    ``moe_apply`` routes to the lower one, as the reference does."""
    jm, tm = _models('mixtral')
    gate = np.asarray(jm.params['blocks'][0]['block_sparse_moe']['gate']
                      ['w']).copy()
    gate[2] = gate[1]
    gate[3] = gate[1] + 1.0           # expert 3 first, then the 1/2 tie
    gate[0] = gate[1] - 1.0
    jp = dict(jm.params['blocks'][0]['block_sparse_moe'],
              gate={'w': jnp.asarray(gate), 'b': None})
    tp = dict(tm.params['blocks'][0]['block_sparse_moe'],
              gate={'w': torch.as_tensor(gate), 'b': None})
    x = np.abs(_x()) + 0.1
    jy, _ = JMX.moe_apply(jp, jm.cfg, jnp.asarray(x))
    ty, _ = MX.moe_apply(tp, tm.cfg, torch.as_tensor(x))
    assert rel_err(ty.numpy(), jy) <= TOL
    logits = B.linear_apply(tp['gate'], torch.as_tensor(x))
    assert torch.equal(B.top_k(logits, 2)[1][..., 1],
                       torch.full((2, 7), 1))


@pytest.mark.parametrize('name', ['mixtral', 'qwen2moe', 'deepseek'])
def test_moe_trees_round_trip_through_convert(name):
    """The expert lists (lists of dicts) carried to the port and back,
    bit for bit, in f32 and bf16."""
    if name == 'deepseek':
        from llmc_tpu.models.adapter import DeepseekV2Adapter
        from llmc_tpu.models.deepseek import DeepseekConfig
        tree = to_np(DeepseekV2Adapter.random(DeepseekConfig(**DS_TINY),
                                              seed=1).params)
    else:
        tree = to_np(_models(name)[0].params)
    for dt in (None, torch.bfloat16):
        back = params_to_numpy(params_from_numpy(tree, device='cpu',
                                                 dtype=dt))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            want = a if dt is None else torch.as_tensor(a).to(dt).float()
            np.testing.assert_array_equal(b, np.asarray(want))


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_pack_model_raises_on_moe(name):
    """The reference packs every linear of the layout, the experts too,
    but its serving QMap names the Llama-family linears only: a packed
    expert gets no qcfg and its forward looks for ``w``, which packing
    removed (the JAX engine raises ``KeyError: 'w'`` at admission).  The
    port refuses at ``pack_model`` (ROADMAP C)."""
    from llmc_tpu.quant.qspec import QuantSpec as JSpec
    from llmc_tpu.serve.packed import pack_block as j_pack_block
    from llmc_tpu.serve.packed import packed_qmap as j_packed_qmap
    from llmc_tpu_torch.quant.qspec import QuantSpec
    from llmc_tpu_torch.serve.packed import pack_model
    jm, tm = _models(name)
    spec = dict(bit=4, symmetric=True, granularity='per_group',
                group_size=16)
    expert = jm.get_layout().linears[4]
    jblk = j_pack_block(jm.params['blocks'][0], jm.cfg, JSpec(**spec),
                        jm.get_layout())
    lin = jblk
    for part in expert.split('.'):
        lin = lin[int(part)] if part.isdigit() else lin[part]
    assert 'qweight' in lin and 'w' not in lin
    assert j_packed_qmap(jm.cfg, JSpec(**spec)).get(expert) is None
    with pytest.raises(NotImplementedError, match='MoE'):
        pack_model(tm, QuantSpec(**spec))
