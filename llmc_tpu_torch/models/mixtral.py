"""Functional Mixtral sparse-MoE model (port of
``llmc_tpu/models/mixtral.py``).

The experts are kept as HF-named per-expert param dicts
(``block_sparse_moe.experts.{e}.w1/w2/w3``: gate, down, up), and the MoE
applies by dense dispatch, as in the reference: every expert runs on every
token and the router's top-k weights mask the combine, summed in f32 in
expert order.  The router picks its top k with the reference's tie rule
(``base.top_k``).  The calibration engine treats each expert linear like
any other (per-expert subsets, ``w1``/``w3`` with ``do_trans=False``: the
experts share the post-attention norm).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import llama as L
from .base import (BlockLayout, SubsetSpec, dense_route_weights,
                   linear_apply, rms_norm, top_k)
from .hf_loader import hf_attention, hf_linear

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MixtralConfig(L.LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def from_hf(cls, hf: dict) -> 'MixtralConfig':
        base = L.LlamaConfig.from_hf(hf)
        return cls(**{**base.__dict__,
                      'num_local_experts': hf.get('num_local_experts', 8),
                      'num_experts_per_tok': hf.get('num_experts_per_tok',
                                                    2)})


def swiglu_expert(ep: Dict, x: torch.Tensor, names, qc) -> tuple:
    """One gated expert, (y, down_in): ``names`` = (gate, up, down) keys
    of ``ep``; ``qc(name)`` its linear's qcfg."""
    g, u, d = names
    gx = linear_apply(ep[g], x, qc(g))
    ux = linear_apply(ep[u], x, qc(u))
    down_in = torch.nn.functional.silu(gx.to(F32)).to(x.dtype) * ux
    return linear_apply(ep[d], down_in, qc(d)), down_in


def _qc_of(qmap, prefix: str):
    def qc(name):
        return qmap.get(f'{prefix}.{name}') if qmap is not None else None
    return qc


def moe_apply(p: Dict, cfg: MixtralConfig, x: torch.Tensor, qmap=None,
              capture: bool = False):
    """Sparse-MoE MLP by dense dispatch: softmax over the top-k router
    logits.  Returns (out, captures: ``down_in_{e}``)."""
    E, K = cfg.num_local_experts, cfg.num_experts_per_tok
    logits = linear_apply(p['gate'], x).to(F32)             # [B,S,E]
    topv, topi = top_k(logits, K)
    weights = dense_route_weights(logits, topi, torch.softmax(topv, -1))
    caps = {}
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for e in range(E):
        y, down_in = swiglu_expert(
            p['experts'][e], x, ('w1', 'w3', 'w2'),
            _qc_of(qmap, f'block_sparse_moe.experts.{e}'))
        if capture:
            caps[f'down_in_{e}'] = down_in
        out = out + weights[..., e:e + 1] * y.to(F32)
    return out.to(x.dtype), caps


def block_apply(bp: Dict, cfg, x, cos, sin, attn_bias=None, qmap=None,
                capture: bool = False, moe=None):
    """One decoder block, Llama attention then the MoE (``moe``: the
    family's ``moe_apply`` and its param key, Mixtral's by default).
    Returns (y, captures)."""
    moe_fn, key = moe or (moe_apply, 'block_sparse_moe')
    caps = {}
    h = rms_norm(x, bp['input_layernorm']['w'], cfg.rms_norm_eps)
    if capture:
        caps['qkv_in'] = h
    attn_out, o_in = L.attention_apply(bp['self_attn'], cfg, h, cos, sin,
                                       attn_bias, qmap)
    if capture:
        caps['o_in'] = o_in
    x = x + attn_out
    h = rms_norm(x, bp['post_attention_layernorm']['w'], cfg.rms_norm_eps)
    if capture:
        caps['moe_in'] = h
    moe_out, moe_caps = moe_fn(bp[key], cfg, h, qmap, capture)
    caps.update(moe_caps)
    return x + moe_out, caps


def attention_subsets(cfg):
    """The attention subsets, linears and captures both MoE families share
    with Llama."""
    gqa = cfg.num_key_value_heads != cfg.num_attention_heads
    qkv = ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj')
    subsets = [
        SubsetSpec(name='qkv', layers=qkv, prev_op='input_layernorm',
                   prev_kind='ln', input_key='qkv_in', inspect='attn',
                   has_kwargs=True),
        SubsetSpec(name='o', layers=('self_attn.o_proj',),
                   prev_op='self_attn.v_proj', prev_kind='fc',
                   input_key='o_in', inspect='o_proj', is_gqa=gqa),
    ]
    linears = list(qkv) + ['self_attn.o_proj']
    capture_of = [(p, 'qkv_in') for p in qkv] + [('self_attn.o_proj',
                                                  'o_in')]
    return subsets, linears, capture_of


def expert_subsets(pre: str, names, up_name: str, down_name: str,
                   input_key: str, inspect: str):
    """The two subsets of one gated expert under ``pre``: gate+up fed by
    the post-attention norm (no transform: the norm is shared), down fed by
    its own ``input_key``.  Returns (subsets, linears, capture_of)."""
    g, u, d = (f'{pre}.{n}' for n in names)
    subsets = [
        SubsetSpec(name=up_name, layers=(g, u),
                   prev_op='post_attention_layernorm', prev_kind='ln',
                   input_key='moe_in', inspect=f'{inspect}_up', is_mlp=True,
                   do_trans=False),
        SubsetSpec(name=down_name, layers=(d,), prev_op=u, prev_kind='fc',
                   input_key=input_key, inspect=f'{inspect}_down',
                   is_mlp=True)]
    return subsets, [g, u, d], [(g, 'moe_in'), (u, 'moe_in'),
                                (d, input_key)]


def mixtral_layout(cfg: MixtralConfig) -> BlockLayout:
    subsets, linears, capture_of = attention_subsets(cfg)
    for e in range(cfg.num_local_experts):
        s, lin, cap = expert_subsets(
            f'block_sparse_moe.experts.{e}', ('w1', 'w3', 'w2'),
            f'expert{e}_w1w3', f'expert{e}_w2', f'down_in_{e}',
            f'expert{e}')
        subsets += s
        linears += lin
        capture_of += cap
    return BlockLayout(subsets=tuple(subsets), linears=tuple(linears),
                       layernorms=('input_layernorm',
                                   'post_attention_layernorm'),
                       capture_of=tuple(capture_of))


def attention_inspect_fns(cfg) -> Dict:
    def attn(bp, h, kw, qmap=None):
        out, _ = L.attention_apply(bp['self_attn'], cfg, h, kw['cos'],
                                   kw['sin'], kw.get('attn_bias'), qmap)
        return out

    def o_proj(bp, o_in, kw, qmap=None):
        return linear_apply(bp['self_attn']['o_proj'], o_in,
                            qmap.get('self_attn.o_proj')
                            if qmap is not None else None)
    return {'attn': attn, 'o_proj': o_proj}


def expert_inspect_fns(get, names) -> tuple:
    """(up, down) inspect functions of the expert ``get(bp)``: the
    unquantized gate*up product, and its down projection."""
    g, u, d = names

    def up(bp, h, kw, qmap=None):
        ep = get(bp)
        return (torch.nn.functional.silu(linear_apply(ep[g], h).to(F32))
                .to(h.dtype) * linear_apply(ep[u], h))

    def down(bp, din, kw, qmap=None):
        return linear_apply(get(bp)[d], din)
    return up, down


def make_inspect_fns(cfg: MixtralConfig) -> Dict:
    fns = attention_inspect_fns(cfg)
    for e in range(cfg.num_local_experts):
        fns[f'expert{e}_up'], fns[f'expert{e}_down'] = expert_inspect_fns(
            lambda bp, e=e: bp['block_sparse_moe']['experts'][e],
            ('w1', 'w3', 'w2'))
    return fns


def model_from_hf(flat, cfg, mlp_key: str, mlp_of) -> Dict:
    """The params tree of a Llama-attention MoE checkpoint; ``mlp_of(b)``
    builds block ``b``'s MoE under ``mlp_key``.  The head falls back on
    the embedding where the checkpoint has no ``lm_head``."""
    blocks = []
    for i in range(cfg.num_hidden_layers):
        b = f'model.layers.{i}'
        blocks.append({
            'input_layernorm': {'w': flat[f'{b}.input_layernorm.weight']},
            'self_attn': hf_attention(flat, b),
            'post_attention_layernorm': {
                'w': flat[f'{b}.post_attention_layernorm.weight']},
            mlp_key: mlp_of(b)})
    emb = flat['model.embed_tokens.weight']
    lm = flat.get('lm_head.weight')
    return {'embed_tokens': {'w': emb}, 'blocks': blocks,
            'norm': {'w': flat['model.norm.weight']},
            'lm_head': {'w': emb if lm is None else lm, 'b': None}}


def params_from_hf(flat, cfg: MixtralConfig) -> Dict:
    def moe(b):
        pre = f'{b}.block_sparse_moe'
        return {'gate': hf_linear(flat, f'{pre}.gate'),
                'experts': [{n: hf_linear(flat, f'{pre}.experts.{e}.{n}')
                             for n in ('w1', 'w2', 'w3')}
                            for e in range(cfg.num_local_experts)]}
    return model_from_hf(flat, cfg, 'block_sparse_moe', moe)


def model_init(ini: L.Init, cfg, mlp_key: str, mlp_of,
               attn_bias: bool = False) -> Dict:
    D = cfg.hidden_size
    blocks = [{'input_layernorm': ini.ones(D),
               'self_attn': L.attention_init(ini, cfg, attn_bias),
               'post_attention_layernorm': ini.ones(D),
               mlp_key: mlp_of()} for _ in range(cfg.num_hidden_layers)]
    return {'embed_tokens': ini.embed(cfg.vocab_size, D), 'blocks': blocks,
            'norm': ini.ones(D), 'lm_head': ini.lin(cfg.vocab_size, D)}


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` (on ``device``)."""
    ini = L.Init(generator, dtype or cfg.tdtype, device)
    D, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts

    def moe():
        return {'gate': ini.lin(E, D),
                'experts': [{'w1': ini.lin(I, D), 'w2': ini.lin(D, I),
                             'w3': ini.lin(I, D)} for _ in range(E)]}
    return model_init(ini, cfg, 'block_sparse_moe', moe)
