"""The families' checkpoint loaders (llmc_tpu_torch.models.adapter): tiny
HF checkpoints written by the installed ``transformers`` (every 1-D
parameter, norm weights and biases, moved off its init so that it
counts), loaded by the port and by the JAX package, and both held against
HF's own logits on the CPU.  InternLM2, Qwen (v1) and MiniCPM, which
``transformers`` does not ship, are written by hand in their own names.

Qwen3 pins a reference fault (ROADMAP C): its loader leaves
``use_qk_norm`` off for a checkpoint, so the reference runs without the
q/k norms it loads; the port reads them, and the parity test puts them
back in the reference (``reference_loads_qk_norm``)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import adapter as JA
from llmc_tpu_torch.convert import params_to_numpy
from llmc_tpu_torch.models import adapter as TA
from llmc_tpu_torch.models import build_model
from torch_port_helpers import (assert_trees_equal, family_pair, rel_err,
                                reference_loads_qk_norm, to_np)

tr = pytest.importorskip('transformers')
torch.set_num_threads(1)

IDS = np.random.RandomState(0).randint(0, 256, (2, 12))


def _jitter(model, seed=0):
    """Move every 1-D parameter (norm weights and biases) off its init."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


def _checkpoint(model, path):
    model.eval()
    model.save_pretrained(path, safe_serialization=True)
    with torch.no_grad():
        return model(torch.as_tensor(IDS)).logits.float().numpy()


def _load_both(name, path):
    tm = TA.__dict__[f'{name}Adapter'].from_pretrained(
        path, dtype=torch.float32, device='cpu')
    jm = JA.__dict__[f'{name}Adapter'].from_pretrained(path,
                                                       dtype=jnp.float32)
    return tm, jm


def _logits(tm, jm):
    return (tm.forward_logits(torch.as_tensor(IDS)).numpy(),
            np.asarray(jm.forward_logits(jnp.asarray(IDS))))


HF_FAMILIES = {
    'Qwen2': lambda: tr.Qwen2ForCausalLM(tr.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False)),
    'Phi3': lambda: tr.Phi3ForCausalLM(tr.Phi3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
        tie_word_embeddings=False)),
    'Gemma2': lambda: tr.Gemma2ForCausalLM(tr.Gemma2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rms_norm_eps=1e-6, max_position_embeddings=128,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=16, sliding_window=8,
        hidden_activation='gelu_pytorch_tanh', tie_word_embeddings=True)),
    'StableLm': lambda: tr.StableLmForCausalLM(tr.StableLmConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        partial_rotary_factor=0.25, use_qkv_bias=True, layer_norm_eps=1e-5,
        tie_word_embeddings=False)),
    'Falcon': lambda: tr.FalconForCausalLM(tr.FalconConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True,
        new_decoder_architecture=False, parallel_attn=True, bias=False,
        alibi=False, tie_word_embeddings=True)),
    'Falcon_alibi': lambda: tr.FalconForCausalLM(tr.FalconConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=False,
        new_decoder_architecture=False, parallel_attn=False, bias=True,
        alibi=True, tie_word_embeddings=True)),
    'Falcon_grouped': lambda: tr.FalconForCausalLM(tr.FalconConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_kv_heads=2,
        new_decoder_architecture=True, parallel_attn=True, bias=False,
        alibi=False, tie_word_embeddings=True)),
    'Phi': lambda: tr.PhiForCausalLM(tr.PhiConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        partial_rotary_factor=0.5, layer_norm_eps=1e-5,
        tie_word_embeddings=False)),
    'Starcoder': lambda: tr.GPTBigCodeForCausalLM(tr.GPTBigCodeConfig(
        vocab_size=256, n_embd=64, n_inner=128, n_layer=2, n_head=4,
        n_positions=64, multi_query=True,
        activation_function='gelu_pytorch_tanh', tie_word_embeddings=True)),
    'Bloom': lambda: tr.BloomForCausalLM(tr.BloomConfig(
        vocab_size=256, hidden_size=64, n_layer=2, n_head=4,
        layer_norm_epsilon=1e-5, tie_word_embeddings=True)),
    'Glm': lambda: tr.GlmForCausalLM(tr.GlmConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, partial_rotary_factor=0.5, attention_bias=True,
        tie_word_embeddings=False, pad_token_id=0)),
}


@pytest.mark.parametrize('family', sorted(HF_FAMILIES))
def test_family_checkpoint_matches_hf_and_jax(family, tmp_path):
    """The port's logits within 1e-4 of HF's and 1e-5 of the JAX
    package's, its params equal to the reference's, on each family's
    checkpoint."""
    name = family.split('_')[0]
    torch.manual_seed(0)
    hf = _checkpoint(_jitter(HF_FAMILIES[family]()), str(tmp_path))
    tm, jm = _load_both(name, str(tmp_path))
    got, want = _logits(tm, jm)
    assert rel_err(got, hf) < 1e-4
    assert rel_err(got, want) < 1e-5
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    jp, tp = to_np(jm.params), params_to_numpy(tm.params)
    for path in ('embed_tokens', 'norm', 'embed_positions',
                 'embed_layernorm', 'lm_head'):
        assert (path in jp) == (path in tp), path
    np.testing.assert_array_equal(tp['blocks'][1]['self_attn']['q_proj']['w'],
                                  jp['blocks'][1]['self_attn']['q_proj']['w'])


def _qwen3_checkpoint(path):
    """A tiny Qwen3 checkpoint whose q/k norm weights are U(0.5, 2)."""
    torch.manual_seed(0)
    model = tr.Qwen3ForCausalLM(tr.Qwen3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, tie_word_embeddings=False))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(('q_norm.weight', 'k_norm.weight')):
                p.copy_(0.5 + 1.5 * torch.rand(p.shape, generator=gen))
    return _checkpoint(model, path)


def test_qwen3_checkpoint_runs_its_qk_norm(tmp_path):
    """The fault: the unmodified reference loads a Qwen3 checkpoint with
    ``use_qk_norm`` off, and its logits leave HF's by more than 10 % of
    their scale; the port's (``use_qk_norm`` on from the checkpoint) stay
    within 1e-4."""
    hf = _qwen3_checkpoint(str(tmp_path))
    tm, jm = _load_both('Qwen3', str(tmp_path))
    got, want = _logits(tm, jm)
    assert tm.cfg.use_qk_norm and not jm.cfg.use_qk_norm
    assert rel_err(got, hf) < 1e-4
    assert rel_err(want, hf) > 0.1


def test_qwen3_checkpoint_matches_fixed_reference(tmp_path, monkeypatch):
    """With the q/k norms put back in the reference, the port's logits
    are within 1e-5 of the JAX package's; ``model_type: qwen3`` alone
    turns the norms on too, through ``build_model``."""
    reference_loads_qk_norm(monkeypatch)
    hf = _qwen3_checkpoint(str(tmp_path))
    tm, jm = _load_both('Qwen3', str(tmp_path))
    got, want = _logits(tm, jm)
    assert rel_err(got, want) < 1e-5 and rel_err(want, hf) < 1e-4
    with open(tmp_path / 'config.json') as f:
        assert json.load(f)['model_type'] == 'qwen3'
    assert TA.Qwen3Adapter.config_from_hf(dict(
        vocab_size=8, hidden_size=8, intermediate_size=8,
        num_hidden_layers=1, num_attention_heads=1,
        model_type='qwen3')).use_qk_norm
    bm = build_model(dict(model=dict(type='Qwen3', path=str(tmp_path),
                                     torch_dtype='float32')), device='cpu')
    assert rel_err(bm.forward_logits(torch.as_tensor(IDS)).numpy(), hf) < 1e-4


# --------------------------------------------------------------------------
# the families transformers does not ship: written in their own names
# --------------------------------------------------------------------------

LLAMA_HF = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, rms_norm_eps=1e-5,
                torch_dtype='float32')


def _llama_tree(seed=0, heads=4, kv_heads=2, bias=False):
    """A random Llama-named numpy tree (HF names -> arrays) of LLAMA_HF's
    widths: the weights of the hand-written checkpoints."""
    rng = np.random.RandomState(seed)
    D, I, hd = 32, 64, 8
    flat = {'model.embed_tokens.weight': rng.randn(256, D) * 0.1,
            'model.norm.weight': 1 + 0.1 * rng.randn(D),
            'lm_head.weight': rng.randn(256, D) * 0.1}
    for i in range(2):
        b = f'model.layers.{i}'
        for n, shape in (('self_attn.q_proj', (heads * hd, D)),
                         ('self_attn.k_proj', (kv_heads * hd, D)),
                         ('self_attn.v_proj', (kv_heads * hd, D)),
                         ('self_attn.o_proj', (D, heads * hd)),
                         ('mlp.gate_proj', (I, D)), ('mlp.up_proj', (I, D)),
                         ('mlp.down_proj', (D, I))):
            flat[f'{b}.{n}.weight'] = rng.randn(*shape) / shape[1] ** 0.5
            if bias and n[-6:] in ('q_proj', 'k_proj', 'v_proj'):
                flat[f'{b}.{n}.bias'] = rng.randn(shape[0]) * 0.1
        for n in ('input_layernorm', 'post_attention_layernorm'):
            flat[f'{b}.{n}.weight'] = 1 + 0.1 * rng.randn(D)
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _write(path, flat, config):
    from safetensors.numpy import save_file
    save_file(flat, os.path.join(path, 'model.safetensors'))
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(config, f)


def _internlm2(flat):
    """InternLM2's names: a grouped fused wqkv [KVH, rep + 2, hd]."""
    out = {'model.tok_embeddings.weight': flat['model.embed_tokens.weight'],
           'model.norm.weight': flat['model.norm.weight'],
           'output.weight': flat['lm_head.weight']}
    for i in range(2):
        b = f'model.layers.{i}'
        q = flat[f'{b}.self_attn.q_proj.weight'].reshape(2, 2, 8, 32)
        k = flat[f'{b}.self_attn.k_proj.weight'].reshape(2, 1, 8, 32)
        v = flat[f'{b}.self_attn.v_proj.weight'].reshape(2, 1, 8, 32)
        out[f'{b}.attention.wqkv.weight'] = np.concatenate(
            [q, k, v], 1).reshape(-1, 32)
        for old, new in (('self_attn.o_proj', 'attention.wo'),
                         ('mlp.gate_proj', 'feed_forward.w1'),
                         ('mlp.up_proj', 'feed_forward.w3'),
                         ('mlp.down_proj', 'feed_forward.w2'),
                         ('input_layernorm', 'attention_norm'),
                         ('post_attention_layernorm', 'ffn_norm')):
            out[f'{b}.{new}.weight'] = flat[f'{b}.{old}.weight']
    return out


def _qwen_v1(flat):
    """Qwen (v1)'s names: a fused biased c_attn, w2 the gate, w1 the
    up projection."""
    out = {'transformer.wte.weight': flat['model.embed_tokens.weight'],
           'transformer.ln_f.weight': flat['model.norm.weight'],
           'lm_head.weight': flat['lm_head.weight']}
    for i in range(2):
        b, h = f'model.layers.{i}', f'transformer.h.{i}'
        for part in ('weight', 'bias'):
            out[f'{h}.attn.c_attn.{part}'] = np.concatenate(
                [flat[f'{b}.self_attn.{p}_proj.{part}'] for p in 'qkv'], 0)
        for old, new in (('self_attn.o_proj', 'attn.c_proj'),
                         ('mlp.gate_proj', 'mlp.w2'),
                         ('mlp.up_proj', 'mlp.w1'),
                         ('mlp.down_proj', 'mlp.c_proj'),
                         ('input_layernorm', 'ln_1'),
                         ('post_attention_layernorm', 'ln_2')):
            out[f'{h}.{new}.weight'] = flat[f'{b}.{old}.weight']
    return out


HAND_WRITTEN = {
    'InternLM2': (lambda: _llama_tree(1), _internlm2, LLAMA_HF),
    'Qwen': (lambda: _llama_tree(2, heads=4, kv_heads=4, bias=True),
             _qwen_v1, dict(vocab_size=256, hidden_size=32,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, layer_norm_epsilon=1e-6,
                            rotary_emb_base=10000.0, seq_length=64)),
    'MiniCPM': (lambda: _llama_tree(3), lambda flat: flat,
                dict(LLAMA_HF, scale_emb=12.0, scale_depth=1.4,
                     dim_model_base=16)),
}


@pytest.mark.parametrize('family', sorted(HAND_WRITTEN))
def test_hand_written_checkpoint_matches_jax(family, tmp_path):
    """InternLM2's and Qwen's renames and splits, MiniCPM's multipliers:
    the port's logits within 1e-5 of the JAX package's on the same
    checkpoint, and (InternLM2, Qwen) of the port's Llama on the tree in
    Llama's names."""
    tree, rename, config = HAND_WRITTEN[family]
    flat = tree()
    _write(str(tmp_path), rename(flat), config)
    tm, jm = _load_both(family, str(tmp_path))
    got, want = _logits(tm, jm)
    assert rel_err(got, want) < 1e-5
    if family != 'MiniCPM':
        os.makedirs(tmp_path / 'llama')
        _write(str(tmp_path / 'llama'), flat, LLAMA_HF if family !=
               'Qwen' else dict(LLAMA_HF, num_key_value_heads=4,
                                rms_norm_eps=1e-6))
        lm = TA.LlamaAdapter.from_pretrained(str(tmp_path / 'llama'),
                                             dtype=torch.float32,
                                             device='cpu')
        assert rel_err(got, lm.forward_logits(
            torch.as_tensor(IDS)).numpy()) < 1e-6
    else:
        assert tm.cfg.logit_divisor == 2.0 and tm.cfg.embed_multiplier == 12.0


def test_save_keeps_the_families_trees(tmp_path):
    """``save_llama_params_to_hf`` writes LayerNorm biases, learned
    positions and the embedding LayerNorm: a Bloom-like tree saved and
    loaded back through the Llama names is the same tree."""
    from llmc_tpu_torch.models.hf_loader import (llama_params_from_hf,
                                                 load_hf_tensors,
                                                 save_llama_params_to_hf)
    for name in ('bloom', 'starcoder', 'gemma2', 'qwen3'):
        _, tm, _ = family_pair(name)
        if name == 'bloom':
            tm.params['embed_layernorm'] = {'w': torch.ones(32),
                                            'b': torch.zeros(32)}
        out = str(tmp_path / name)
        save_llama_params_to_hf(tm.params, out)
        back = llama_params_from_hf(load_hf_tensors(out, dtype=None),
                                    tm.cfg.num_hidden_layers,
                                    tm.cfg.tie_word_embeddings)
        assert_trees_equal(params_to_numpy(back), params_to_numpy(tm.params))
