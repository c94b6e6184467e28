"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed, run through the JAX package on
the CPU and through ``llmc_tpu_torch`` with ``device='cpu'``, and compared
as numpy arrays.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

# the tiny GQA Llama of the JAX package's own tests
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, dtype='float32')
# the tiny Mixtral and DeepSeek-V2 of the JAX package's MoE engine tests
# (tests/test_engine_moe.py)
MX_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16,
               num_local_experts=4, num_experts_per_tok=2, dtype='float32')
DS_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=48, num_hidden_layers=3,
               num_attention_heads=4, q_lora_rank=32, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               n_routed_experts=4, n_shared_experts=1,
               num_experts_per_tok=2, first_k_dense_replace=1,
               dtype='float32')
WSPEC = dict(bit=4, symmetric=True, granularity='per_group', group_size=32)
METHODS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'quantization', 'methods')


def method_quant(name):
    """The ``quant`` section of a shipped method config, group size 128
    cut to 32 (TINY is 64 wide), and QUIK's ``fp_features`` 128 cut to 8
    (``min(128, in_features - 1)`` would keep all but one of TINY's
    columns fp), as the JAX package's own QUIK test cuts it."""
    with open(os.path.join(METHODS, f'{name}.yml')) as f:
        quant = yaml.safe_load(f)['quant']

    def cut(d):
        return {k: (32 if k == 'group_size' and v == 128 else
                    8 if k == 'fp_features' and v == 128 else
                    cut(v) if isinstance(v, dict) else v)
                for k, v in d.items()}
    return cut(quant)


# tests/test_decode_families.py's archs, and the Llama-family ones
ARCHS = {
    'llama': {},
    'gemma2': dict(act_fn='gelu_tanh', sandwich_norms=True,
                   embed_scale=True, tie_word_embeddings=True,
                   attn_logit_softcap=50.0, final_logit_softcap=30.0,
                   query_pre_attn_scalar=16.0, sliding_window=6),
    'glm': dict(rotary_pct=0.5, rope_interleaved=True, attention_bias=True),
    'falcon': dict(norm_type='ln', parallel_residual=True, shared_ln=True,
                   gated_mlp=False, act_fn='gelu', num_key_value_heads=1,
                   tie_word_embeddings=True),
    'bloom': dict(norm_type='ln', gated_mlp=False, act_fn='gelu_tanh',
                  rotary_pct=0.0, use_alibi=True, tie_word_embeddings=True),
    'falcon_alibi': dict(norm_type='ln', gated_mlp=False, act_fn='gelu',
                         rotary_pct=0.0, use_alibi=True, alibi_scaled=True),
    'stablelm': dict(norm_type='ln', rotary_pct=0.25, attention_bias=True),
    'starcoder': dict(norm_type='ln', gated_mlp=False, act_fn='gelu_tanh',
                      rotary_pct=0.0, learned_pos=True,
                      num_key_value_heads=1, tie_word_embeddings=True),
    'minicpm': dict(embed_multiplier=2.0, residual_multiplier=0.7,
                    logit_divisor=2.0),
    'qwen2': dict(attention_bias=True, rope_theta=1e6),
    'qwen3': dict(use_qk_norm=True),
    'phi3': dict(num_key_value_heads=4),
    'mistral': dict(rope_theta=1e6),
    'smollm': dict(tie_word_embeddings=True),
}
BASE = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=8, dtype='float32', max_position_embeddings=64)


def perturbed(tree, rng, key=''):
    """A numpy param tree with every bias drawn N(0, 0.1) and every norm
    weight (1-D ``w``) scaled by 1 + N(0, 0.2)."""
    if isinstance(tree, dict):
        return {k: perturbed(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturbed(v, rng) for v in tree]
    if tree is None:
        return None
    a = np.asarray(tree)
    if key == 'b':
        return (rng.randn(*a.shape) * 0.1).astype(a.dtype)
    if a.ndim == 1:
        return (a * (1 + 0.2 * rng.randn(*a.shape))).astype(a.dtype)
    return a


def family_pair(name, seed=0, **over):
    """(JAX adapter, port adapter, numpy params) of arch ``name`` on the
    same weights.  The reference's random tree has no q/k norms for
    ``use_qk_norm`` (ROADMAP C): they are added to both."""
    import jax.numpy as jnp
    from llmc_tpu.models import llama as JL
    arch = {**BASE, **ARCHS[name], **over}
    jcfg = JL.LlamaConfig(**arch)
    tree = jax.tree.map(np.asarray, JL.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    if jcfg.use_qk_norm:
        for blk in tree['blocks']:
            for n in ('q_norm', 'k_norm'):
                blk['self_attn'][n] = {'w': np.ones((jcfg.head_dim,),
                                                    np.float32)}
    tree = perturbed(tree, np.random.RandomState(seed + 1))
    from llmc_tpu.models import LlamaAdapter as JAdapter
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    jm = JAdapter(jcfg, jax.tree.map(
        lambda a: None if a is None else jnp.asarray(a), tree))
    tm = LlamaAdapter(LlamaConfig(**arch), params_from_numpy(tree,
                                                             device='cpu'))
    return jm, tm, tree


# the families' model types whose inline arch runs a graph of its own,
# for the pipeline tests; MiniCPM takes its multipliers from the arch
PIPELINE_FAMILIES = ('Bloom', 'Falcon', 'Gemma2', 'Glm', 'MiniCPM', 'Phi',
                     'Qwen2', 'Qwen3', 'StableLm', 'Starcoder')


def family_pipeline_config(model_type, method, special=None, weight=None,
                           eval_pos=('pretrain', 'transformed',
                                     'fake_quant')):
    """A tiny pipeline config of ``model_type`` with an inline arch
    (BASE's widths; MiniCPM's multipliers from ARCHS), synthetic data."""
    arch = dict(BASE)
    if model_type == 'MiniCPM':
        arch.update(ARCHS['minicpm'])
    quant = dict(method=method, weight=weight or dict(
        bit=4, symmetric=False, granularity='per_group', group_size=16))
    if special:
        quant['special'] = dict(special)
    return dict(
        base=dict(seed=7), model=dict(type=model_type, arch=arch, seed=0),
        calib=dict(name='synthetic', n_samples=2, bs=-1, seq_len=16, seed=0,
                   vocab_size=96, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=512, seq_len=32,
                  vocab_size=96, bs=2, eval_pos=list(eval_pos)),
        quant=quant)


def same_random_weights(monkeypatch):
    """Both packages' random models draw the JAX package's tree from the
    seed (``PRNGKey(seed)``), every bias and norm weight then moved off
    its init (``perturbed``), so that a model built from the same inline
    arch holds the same weights in both.  ``use_qk_norm`` gets its q/k
    norms in both: the reference's random tree lacks them (ROADMAP C)."""
    from llmc_tpu.models import llama as JL
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.models import llama as TL
    j_init = JL.init_params

    def tree(cfg, seed):
        t = jax.tree.map(np.asarray, j_init(cfg, jax.random.PRNGKey(seed)))
        if cfg.use_qk_norm:
            for blk in t['blocks']:
                for n in ('q_norm', 'k_norm'):
                    blk['self_attn'][n] = {'w': np.ones((cfg.head_dim,),
                                                        np.float32)}
        return perturbed(t, np.random.RandomState(seed + 1))

    def jax_init(cfg, key, dtype=None):
        import jax.numpy as jnp
        seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
        return jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                            tree(cfg, seed))

    def port_init(cfg, generator, dtype=None, device=None, blocks=None):
        jcfg = JL.LlamaConfig(**dataclasses.asdict(cfg))
        params = params_from_numpy(tree(jcfg, generator.initial_seed()),
                                   device=device)
        if blocks is not None:   # an offloaded model's host list
            for b in params['blocks']:
                blocks.append(b)
            params['blocks'] = blocks
        return params
    monkeypatch.setattr(JL, 'init_params', jax_init)
    monkeypatch.setattr(TL, 'init_params', port_init)


def to_np(tree):
    """A JAX param tree as numpy arrays (None leaves stay None)."""
    return jax.tree.map(np.asarray, tree)


def assert_trees_equal(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f'{path}[{i}]')
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def port_params(jax_params):
    from llmc_tpu_torch.convert import params_from_numpy
    return params_from_numpy(to_np(jax_params), device='cpu')


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip with a reason (decided inside the test,
    never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels run only '
                    'there (python3 chip_smoke.py, or pytest -m gpu on '
                    'the card)')
    return torch.device('cuda')


def reference_trains_on_block_inputs(monkeypatch, cls):
    """The JAX package's gradient-trained method ``cls`` trained on each
    block's own calibration inputs: its ``block_opt`` replaces
    ``self.inputs`` by the block's outputs before ``block_transform``
    trains on them (ROADMAP C)."""
    inner_opt, inner_transform = cls.block_opt, cls.block_transform

    def block_opt(self, idx):
        self._block_inputs = self.inputs
        return inner_opt(self, idx)

    def block_transform(self, idx, block, feats):
        outs, self.inputs = self.inputs, self._block_inputs
        try:
            return inner_transform(self, idx, block, feats)
        finally:
            self.inputs = outs
    monkeypatch.setattr(cls, 'block_opt', block_opt)
    monkeypatch.setattr(cls, 'block_transform', block_transform)


def reference_builds_its_step_per_block(monkeypatch, cls):
    """The JAX package's TesseraQ with its jitted training step built
    anew in each block: the cached step keeps the qparams of the block it
    was built in (ROADMAP C)."""
    inner = cls.block_transform

    def block_transform(self, idx, block, feats):
        self._jits.clear()
        return inner(self, idx, block, feats)
    monkeypatch.setattr(cls, 'block_transform', block_transform)


def reference_loads_qk_norm(monkeypatch):
    """The JAX package's Qwen3 loader with ``use_qk_norm`` on where the
    checkpoint's blocks hold q/k norms (ROADMAP C)."""
    import dataclasses

    import jax.numpy as jnp
    from llmc_tpu.models import adapter as JA
    inner = JA.Qwen3Adapter.from_pretrained.__func__

    def from_pretrained(cls, path, dtype=jnp.bfloat16):
        m = inner(cls, path, dtype=dtype)
        if 'q_norm' in m.params['blocks'][0]['self_attn']:
            m.cfg = dataclasses.replace(m.cfg, use_qk_norm=True)
        return m
    monkeypatch.setattr(JA.Qwen3Adapter, 'from_pretrained',
                        classmethod(from_pretrained))


def write_hf_moe_checkpoint(kind: str, path: str) -> str:
    """A tiny checkpoint written with transformers, as the JAX package's
    own tests write them: ``mixtral`` (MX_TINY) or ``deepseek`` (DS_TINY,
    a DeepSeek-V2 with a low-rank q, one dense first layer and a shared
    expert)."""
    import transformers as tr
    torch.manual_seed(0)
    if kind == 'mixtral':
        model = tr.MixtralForCausalLM(tr.MixtralConfig(
            tie_word_embeddings=False,
            **{k: v for k, v in MX_TINY.items() if k != 'dtype'}))
    else:
        model = tr.DeepseekV2ForCausalLM(tr.DeepseekV2Config(
            tie_word_embeddings=False, attention_bias=False,
            routed_scaling_factor=1.0, norm_topk_prob=False,
            moe_layer_freq=1, num_key_value_heads=4,
            **{k: v for k, v in DS_TINY.items() if k != 'dtype'}))
    model.save_pretrained(path, safe_serialization=True)
    return path


MOE_CONFIGS = os.path.dirname(METHODS)


def moe_config(rel: str, path: str, group_size: int = 16) -> dict:
    """A shipped MoE config (``rel`` under configs/quantization) as the
    tests run it: its ``model`` and ``quant`` sections on the tiny
    checkpoint at ``path`` (per-group 128 cut to ``group_size``: DS_TINY's
    experts are 48 wide), synthetic calibration and PPL data in place of
    its datasets.  Its ``save`` section is left out: the exports are held
    in ``test_torch_export*.py``."""
    with open(os.path.join(MOE_CONFIGS, rel)) as f:
        cfg = yaml.safe_load(f)

    def cut(d):
        return {k: (group_size if k == 'group_size' and v == 128 else
                    cut(v) if isinstance(v, dict) else v)
                for k, v in d.items()}
    return dict(
        base=dict(seed=7), model=dict(cfg['model'], path=path),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=768, seq_len=32,
                  vocab_size=128, bs=2,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=cut(cfg['quant']))


def load_moe_checkpoints_in_f32(monkeypatch):
    """Both packages' MoE adapters load a checkpoint in float32 (as
    shipped they load bf16 whatever ``torch_dtype`` says): at bf16 a router
    tie and GPTQ's error feedback carry last-bit differences between XLA
    and torch to 7.8e-4 of a PPL, at f32 to 5e-5."""
    import jax.numpy as jnp
    from llmc_tpu.models import adapter as JA
    from llmc_tpu_torch.models import adapter as TA
    for cls, f32 in ((JA.MixtralAdapter, jnp.float32),
                     (JA.DeepseekV2Adapter, jnp.float32),
                     (TA.MixtralAdapter, torch.float32),
                     (TA.DeepseekV2Adapter, torch.float32)):
        inner = cls.from_pretrained.__func__

        def load(c, path, dtype=f32, inner=inner, **kw):
            return inner(c, path, dtype, **kw)
        monkeypatch.setattr(cls, 'from_pretrained', classmethod(load))


# the tiny Llava of the JAX package's own VLM tests (tests/test_llava.py,
# test_token_reduction.py): a 56-pixel image of 14-pixel patches is 16
# placeholders; VideoLlava's adds a video token and 4 frames of 28 pixels
LLAVA_ARCH = dict(vocab_size=72, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=8, dtype='float32',
                  image_size=56, patch_size=14, image_token_index=70)
VIDEOLLAVA_ARCH = dict(LLAVA_ARCH, num_hidden_layers=2, image_size=28,
                       video_token_index=71, num_frames=4)
# the tiny ViT of tests/test_vit.py
VIT_ARCH = dict(image_size=32, patch_size=8, num_channels=3, hidden_size=64,
                intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_labels=10)


def vlm_pair(model_type='Llava', seed=0, **arch):
    """(JAX adapter, port adapter) of a tiny ``model_type`` (a Llava-tier
    name, or ``Vit``, whose arch is a ``VitConfig``'s fields) on the same
    weights: the JAX package's random tree, every bias and norm weight
    moved off its init (``perturbed``)."""
    import jax.numpy as jnp
    from llmc_tpu.utils.registry import MODEL_REGISTRY as JREG
    import llmc_tpu.models  # noqa: F401  (registers the adapters)
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.utils.registry import MODEL_REGISTRY as TREG
    import llmc_tpu_torch.models  # noqa: F401
    base = {'VideoLlava': VIDEOLLAVA_ARCH, 'Vit': VIT_ARCH}.get(model_type,
                                                              LLAVA_ARCH)
    m = dict(type=model_type, arch=dict(base, **arch), seed=seed)
    tm = TREG[model_type].from_config(dict(model=m), device='cpu')
    if model_type == 'Vit':
        from llmc_tpu.models import vit as JV
        from llmc_tpu.models.adapter import VitAdapter as JVit
        jcfg = JV.VitConfig(**dataclasses.asdict(tm.cfg))
        jm = JVit(jcfg, None)
        from llmc_tpu_torch.convert import params_to_numpy
        tree = perturbed(params_to_numpy(tm.params),
                         np.random.RandomState(seed + 1))
    else:
        jm = JREG[model_type].from_config(dict(model=dict(
            m, arch=dict(m['arch']))))
        tree = perturbed(to_np(jm.params), np.random.RandomState(seed + 1))
    jm.params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                             tree)
    tm.params = params_from_numpy(tree, device='cpu')
    return jm, tm


def jax_llava_cfg(cfg):
    """The JAX package's LlavaConfig of a port ``LlavaConfig``."""
    from llmc_tpu.models import llama as JL
    from llmc_tpu.models import llava as JLV
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw['text'] = JL.LlamaConfig(**dataclasses.asdict(cfg.text))
    kw['vision'] = JL.LlamaConfig(**dataclasses.asdict(cfg.vision))
    return JLV.LlavaConfig(**kw)


def same_random_vlm_weights(monkeypatch):
    """Both packages' random Llava-tier models draw the JAX package's tree
    from the seed, its biases and norm weights then perturbed, so that a
    model built from the same inline arch holds the same weights in both;
    a random ViT (an inline arch the JAX package does not take) draws the
    port's tree, perturbed, in both."""
    import jax.numpy as jnp
    from llmc_tpu.models import llava as JLV
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.models import llava as TLV
    j_init = JLV.init_params

    def tree(jcfg, seed):
        t = to_np(j_init(jcfg, jax.random.PRNGKey(seed)))
        return perturbed(t, np.random.RandomState(seed + 1))

    def jax_init(cfg, key):
        seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
        return jax.tree.map(lambda a: None if a is None else jnp.asarray(a),
                            tree(cfg, seed))

    def port_init(cfg, generator, dtype=None, device=None):
        return params_from_numpy(tree(jax_llava_cfg(cfg),
                                      generator.initial_seed()),
                                 device=device)
    monkeypatch.setattr(JLV, 'init_params', jax_init)
    monkeypatch.setattr(TLV, 'init_params', port_init)


def reference_tower_takes_its_own_qmap(monkeypatch):
    """The JAX package's VLM towers under their own modality's deploy: the
    fake-quant QMap of the algorithm that calibrated the ``vision``
    modality (none where no algorithm did).  The reference hands LLaVA's
    ``vision_features`` / ``video_features``, OneVision's video tower and
    MiniCPM-V's the LM's QMap, and Qwen2-VL's, InternVL's and OneVision's
    image towers none (ROADMAP C): each tower takes ``tower_qmap`` of the
    QMap its forward was given instead."""
    from llmc_tpu.compression.blockwise import BlockwiseOpt
    from llmc_tpu.models import internvl as JIV
    from llmc_tpu.models import llava as JLV
    from llmc_tpu.models import llava_onevision as JOV
    from llmc_tpu.models import minicpmv as JMV
    from llmc_tpu.models import qwen2vl as JQV
    state = {}
    inner_init = BlockwiseOpt.__init__

    def init(self, model, *a, **kw):
        inner_init(self, model, *a, **kw)
        if getattr(model, '_modality', None) == 'vision':
            state['opt'] = self

    def tower_qmap(qmap):
        if qmap is None or 'opt' not in state:
            return None
        if 'qmap' not in state:
            opt = state['opt']
            opt.model.set_modality('vision')
            try:
                state['qmap'] = opt.deploy('fake_quant')
            finally:
                opt.model.set_modality('language')
        return state['qmap']

    for name in ('vision_features', 'video_features'):
        inner = getattr(JLV, name)

        def confined(vp, cfg, px, qmap=None, reduction=None, inner=inner):
            return inner(vp, cfg, px, qmap=tower_qmap(qmap),
                         reduction=reduction)
        monkeypatch.setattr(JLV, name, confined)
    # the second slice's forwards: the QMap a forward was given, which its
    # tower then reads through tower_qmap
    given = {}

    def forward_of(mod, name):
        inner = getattr(mod, name)

        def outer(*a, qmap=None, **kw):
            given['qmap'] = qmap
            try:
                return inner(*a, qmap=qmap, **kw)
            finally:
                given.pop('qmap')
        monkeypatch.setattr(mod, name, outer)

    def tower_of(mod, name):
        inner = getattr(mod, name)

        def outer(*a, qmap=None, **kw):
            return inner(*a, qmap=tower_qmap(given.get('qmap')), **kw)
        monkeypatch.setattr(mod, name, outer)
    for mod, fwd, tower in ((JQV, 'qwen2vl_forward', 'vision_forward'),
                            (JIV, 'internvl_forward', 'image_features'),
                            (JOV, 'onevision_forward', 'vision_features'),
                            (JMV, 'minicpmv_forward', 'image_embeds')):
        forward_of(mod, fwd)
        tower_of(mod, tower)
    monkeypatch.setattr(BlockwiseOpt, '__init__', init)
    return state


# the tiny models of the JAX package's own tests of Qwen2-VL, InternVL,
# OneVision (tests/test_qwen2vl.py, test_internvl.py,
# test_llava_onevision.py: 16-pixel images of 4-pixel patches) and
# MiniCPM-V (tests/test_minicpmv.py)
VLM2_LM = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, dtype='float32')
VLM2_TOWER = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2)
VLM2_ARCHS = {
    'Qwen2vl': dict(VLM2_LM, patch_size=4, image_token_id=126,
                    vision_start_token_id=125, mrope_section=[2, 3, 3],
                    vision=VLM2_TOWER),
    'InternVL2': dict(VLM2_LM, image_size=16, patch_size=4,
                      image_token_id=126, vision=VLM2_TOWER),
    'LlavaOneVision': dict(VLM2_LM, image_size=16, patch_size=4,
                           image_token_index=126, video_token_index=127,
                           vision=VLM2_TOWER),
    'MiniCPMV': dict(VLM2_LM, vocab_size=72, hidden_size=32,
                     intermediate_size=64, head_dim=8, image_size=28,
                     patch_size=14, num_queries=4, image_token_index=70,
                     vision=dict(VLM2_TOWER, num_attention_heads=4)),
}


def _vlm2_tree(jm, seed):
    """The JAX model's params as numpy, perturbed; the resampler's head
    count stays a Python int."""
    tree = perturbed(to_np(jm.params), np.random.RandomState(seed + 1))
    if 'resampler' in tree:
        tree['resampler']['num_heads'] = int(tree['resampler']['num_heads'])
    return tree


def _jax_tree(tree):
    import jax.numpy as jnp
    return jax.tree.map(lambda a: a if a is None or isinstance(a, int)
                        else jnp.asarray(a), tree)


def vlm2_pair(model_type, seed=0, vision=None, **arch):
    """(JAX adapter, port adapter) of a tiny ``model_type`` of the second
    VLM slice on the same weights: the JAX package's random tree with
    every bias and norm weight moved off its init (``perturbed``)."""
    from llmc_tpu.utils.registry import MODEL_REGISTRY as JREG
    import llmc_tpu.models  # noqa: F401  (registers the adapters)
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.utils.registry import MODEL_REGISTRY as TREG
    import llmc_tpu_torch.models  # noqa: F401
    a = dict(VLM2_ARCHS[model_type], **arch)
    a['vision'] = dict(a['vision'], **(vision or {}))
    m = dict(type=model_type, arch=a, seed=seed)
    jm = JREG[model_type].from_config(dict(model=m))
    tm = TREG[model_type].from_config(dict(model=m), device='cpu')
    tree = _vlm2_tree(jm, seed)
    jm.params = _jax_tree(tree)
    tm.params = params_from_numpy(tree, device='cpu')
    return jm, tm


def same_random_vlm2_weights(monkeypatch):
    """Both packages' random Qwen2-VL, InternVL, OneVision and MiniCPM-V
    (an inline ``model.arch``) hold the JAX package's random tree of that
    arch and seed, perturbed (``vlm2_pair``'s weights)."""
    from llmc_tpu.utils.registry import MODEL_REGISTRY as JREG
    import llmc_tpu.models  # noqa: F401
    from llmc_tpu_torch.convert import params_from_numpy
    from llmc_tpu_torch.utils.registry import MODEL_REGISTRY as TREG
    import llmc_tpu_torch.models  # noqa: F401
    for name in VLM2_ARCHS:
        jcls, tcls = JREG[name], TREG[name]
        j_from, t_from = jcls.from_config.__func__, tcls.from_config.__func__

        def jf(cls, config, j_from=j_from):
            jm = j_from(cls, config)
            if not config['model'].get('path'):
                jm.params = _jax_tree(_vlm2_tree(
                    jm, int(config['model'].get('seed', 0))))
            return jm

        def tf(cls, config, device=None, j_from=j_from, t_from=t_from,
               jcls=jcls):
            tm = t_from(cls, config, device=device)
            if not config['model'].get('path'):
                tree = _vlm2_tree(j_from(jcls, config),
                                  int(config['model'].get('seed', 0)))
                tm.params = params_from_numpy(tree, device=tm.device)
            return tm
        monkeypatch.setattr(jcls, 'from_config', classmethod(jf))
        monkeypatch.setattr(tcls, 'from_config', classmethod(tf))
