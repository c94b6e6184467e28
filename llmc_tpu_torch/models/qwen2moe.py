"""Qwen2-MoE / Qwen1.5-MoE (port of ``llmc_tpu/models/qwen2moe.py``): a
sparse MoE with a gated shared expert.

Differences from Mixtral (``models/mixtral.py``), as in the reference:
- routing: softmax over all the router logits first, then the top k
  (re-normalised under ``norm_topk_prob``);
- a shared expert runs on every token, gated by
  sigmoid(shared_expert_gate(x));
- HF names ``mlp.gate``, ``mlp.experts.{e}.gate_proj/up_proj/down_proj``,
  ``mlp.shared_expert.*``, ``mlp.shared_expert_gate``; the attention
  carries biases (``from_hf`` forces ``attention_bias``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import llama as L
from . import mixtral as MX
from .base import BlockLayout, dense_route_weights, linear_apply, top_k
from .hf_loader import hf_linear

F32 = torch.float32
_GUD = ('gate_proj', 'up_proj', 'down_proj')


@dataclasses.dataclass(frozen=True)
class Qwen2MoeConfig(L.LlamaConfig):
    num_local_experts: int = 4
    num_experts_per_tok: int = 2
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = False

    @classmethod
    def from_hf(cls, hf: dict) -> 'Qwen2MoeConfig':
        base = L.LlamaConfig.from_hf(dict(hf, attention_bias=True))
        return cls(**{
            **base.__dict__,
            'intermediate_size': hf.get('moe_intermediate_size',
                                        hf.get('intermediate_size')),
            'num_local_experts': hf.get('num_experts', 4),
            'num_experts_per_tok': hf.get('num_experts_per_tok', 2),
            'shared_expert_intermediate_size':
                hf.get('shared_expert_intermediate_size', 0),
            'norm_topk_prob': hf.get('norm_topk_prob', False)})


def moe_apply(p: Dict, cfg: Qwen2MoeConfig, x: torch.Tensor, qmap=None,
              capture: bool = False):
    """Dense-dispatch sparse MoE plus the gated shared expert.  Returns
    (out, captures: ``down_in_{e}``, ``shared_down_in``)."""
    E, K = cfg.num_local_experts, cfg.num_experts_per_tok
    logits = linear_apply(p['gate'], x).to(F32)             # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, K)
    if cfg.norm_topk_prob:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    weights = dense_route_weights(probs, topi, topw)
    caps = {}
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for e in range(E):
        y, down_in = MX.swiglu_expert(p['experts'][e], x, _GUD,
                                      MX._qc_of(qmap, f'mlp.experts.{e}'))
        if capture:
            caps[f'down_in_{e}'] = down_in
        out = out + weights[..., e:e + 1] * y.to(F32)
    sy, sdown_in = MX.swiglu_expert(p['shared_expert'], x, _GUD,
                                    MX._qc_of(qmap, 'mlp.shared_expert'))
    if capture:
        caps['shared_down_in'] = sdown_in
    gate = torch.sigmoid(linear_apply(p['shared_expert_gate'], x).to(F32))
    out = out + gate * sy.to(F32)
    return out.to(x.dtype), caps


def block_apply(bp: Dict, cfg: Qwen2MoeConfig, x, cos, sin, attn_bias=None,
                qmap=None, capture: bool = False):
    return MX.block_apply(bp, cfg, x, cos, sin, attn_bias, qmap, capture,
                          moe=(moe_apply, 'mlp'))


def qwen2moe_layout(cfg: Qwen2MoeConfig) -> BlockLayout:
    subsets, linears, capture_of = MX.attention_subsets(cfg)
    experts = [(f'mlp.experts.{e}', f'expert{e}_gate_up', f'expert{e}_down',
                f'down_in_{e}', f'expert{e}')
               for e in range(cfg.num_local_experts)]
    # the shared expert's subsets come after the routed ones (reference
    # qwen2moe.py:60-120)
    experts.append(('mlp.shared_expert', 'shared_gate_up', 'shared_down',
                    'shared_down_in', 'shared'))
    for pre, up_name, down_name, key, inspect in experts:
        s, lin, cap = MX.expert_subsets(pre, _GUD, up_name, down_name, key,
                                        inspect)
        subsets += s
        linears += lin
        capture_of += cap
    return BlockLayout(subsets=tuple(subsets), linears=tuple(linears),
                       layernorms=('input_layernorm',
                                   'post_attention_layernorm'),
                       capture_of=tuple(capture_of))


def make_inspect_fns(cfg: Qwen2MoeConfig) -> Dict:
    fns = MX.attention_inspect_fns(cfg)
    for e in range(cfg.num_local_experts):
        fns[f'expert{e}_up'], fns[f'expert{e}_down'] = \
            MX.expert_inspect_fns(lambda bp, e=e: bp['mlp']['experts'][e],
                                  _GUD)
    fns['shared_up'], fns['shared_down'] = MX.expert_inspect_fns(
        lambda bp: bp['mlp']['shared_expert'], _GUD)
    return fns


def params_from_hf(flat, cfg: Qwen2MoeConfig) -> Dict:
    def moe(b):
        pre = f'{b}.mlp'
        return {
            'gate': hf_linear(flat, f'{pre}.gate'),
            'experts': [{n: hf_linear(flat, f'{pre}.experts.{e}.{n}')
                         for n in _GUD}
                        for e in range(cfg.num_local_experts)],
            'shared_expert': {
                n: hf_linear(flat, f'{pre}.shared_expert.{n}')
                for n in _GUD},
            'shared_expert_gate': hf_linear(flat,
                                            f'{pre}.shared_expert_gate')}
    return MX.model_from_hf(flat, cfg, 'mlp', moe)


def init_params(cfg: Qwen2MoeConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` (on ``device``); the
    attention biases zero."""
    ini = L.Init(generator, dtype or cfg.tdtype, device)
    D, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    SI = cfg.shared_expert_intermediate_size or I

    def swiglu(inter):
        return {'gate_proj': ini.lin(inter, D), 'up_proj': ini.lin(inter, D),
                'down_proj': ini.lin(D, inter)}

    def moe():
        return {'gate': ini.lin(E, D),
                'experts': [swiglu(I) for _ in range(E)],
                'shared_expert': swiglu(SI),
                'shared_expert_gate': ini.lin(1, D)}
    return MX.model_init(ini, cfg, 'mlp', moe, attn_bias=True)
