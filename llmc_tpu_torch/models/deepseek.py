"""Functional DeepSeek-V2/V3: MLA attention plus a shared-and-routed MoE
(port of ``llmc_tpu/models/deepseek.py``).

MLA as in HF ``modeling_deepseek_v2``: a low-rank q (``q_a`` -> rmsnorm ->
``q_b``, or one ``q_proj`` where ``q_lora_rank`` is unset) and kv
(``kv_a`` -> the rope part split off -> rmsnorm -> ``kv_b``), the
interleaved (complex) rope on the rope dims only, softmax scale
(dn + dr)^-1/2.  The MoE dispatches densely (every expert on every token,
the combine masked by the router's top-k weights), as in the reference;
the first ``first_k_dense_replace`` layers hold a dense gated MLP.

The reference's ``DeepseekConfig.from_hf`` drops ``rope_scaling`` (yarn)
and V3's routing keys (``scoring_func: sigmoid``, ``topk_method:
noaux_tc`` or ``group_limited_greedy``, group-limited ``n_group`` /
``topk_group``, the gate's ``e_score_correction_bias``), and then computes
unscaled rope and softmax-greedy routing with no error.  The port raises
where a checkpoint names one of them (``check_hf_config``; ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import llama as L
from . import mixtral as MX
from .base import (BlockLayout, SubsetSpec, attn_act_fq, dense_route_weights,
                   linear_apply, rms_norm, top_k)
from .hf_loader import hf_linear

F32 = torch.float32
_GUD = ('gate_proj', 'up_proj', 'down_proj')


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 4
    num_attention_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: Optional[int] = None
    n_shared_experts: Optional[int] = None
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    first_k_dense_replace: int = 0
    moe_layer_freq: int = 1
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    dtype: str = 'float32'

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    # the per-head engine's fields
    @property
    def head_dim(self) -> int:
        return self.qk_head_dim

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def is_moe_layer(self, idx: int) -> bool:
        return (self.n_routed_experts is not None
                and idx >= self.first_k_dense_replace
                and idx % self.moe_layer_freq == 0)

    @classmethod
    def from_hf(cls, hf: dict) -> 'DeepseekConfig':
        check_hf_config(hf)
        keys = ['vocab_size', 'hidden_size', 'intermediate_size',
                'moe_intermediate_size', 'num_hidden_layers',
                'num_attention_heads', 'q_lora_rank', 'kv_lora_rank',
                'qk_nope_head_dim', 'qk_rope_head_dim', 'v_head_dim',
                'n_routed_experts', 'n_shared_experts',
                'num_experts_per_tok', 'routed_scaling_factor',
                'norm_topk_prob', 'first_k_dense_replace',
                'moe_layer_freq', 'rms_norm_eps', 'rope_theta',
                'tie_word_embeddings', 'attention_bias']
        kw = {k: hf[k] for k in keys if k in hf and hf[k] is not None}
        if 'q_lora_rank' in hf:
            kw['q_lora_rank'] = hf['q_lora_rank']
        return cls(**kw)


def check_hf_config(hf: dict) -> None:
    """Raise for what a checkpoint's config names that the reference's
    graph does not compute: a rope scaling, or a routing other than
    softmax-greedy top-k."""
    rs = hf.get('rope_scaling') or {}
    rs_type = rs.get('rope_type', rs.get('type'))
    if rs_type not in (None, 'default'):
        raise NotImplementedError(
            f'rope_scaling type {rs_type!r}: the reference computes '
            f'unscaled rope for DeepSeek (its from_hf drops the key); the '
            f'port refuses the checkpoint rather than compute it unscaled')
    scoring = hf.get('scoring_func')
    if scoring not in (None, 'softmax'):
        raise NotImplementedError(
            f'scoring_func={scoring!r}: the reference routes by softmax '
            f'scores only')
    method = hf.get('topk_method')
    if method not in (None, 'greedy'):
        raise NotImplementedError(
            f'topk_method={method!r}: the reference routes by greedy top-k '
            f'only')
    n_group, topk_group = hf.get('n_group'), hf.get('topk_group')
    if n_group and topk_group and topk_group < n_group:
        raise NotImplementedError(
            f'group-limited routing (topk_group={topk_group} of '
            f'n_group={n_group}): the reference routes over every expert')


# --------------------------------------------------------------------------
# Interleaved (complex) rope on the rope dims
# --------------------------------------------------------------------------

def rope_freqs(cfg: DeepseekConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., d_rope / 2] of the interleaved rope, f32."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=F32, device=positions.device) / d))
    f = positions.to(F32)[..., None] * inv
    return torch.cos(f), torch.sin(f)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """x [..., d]: the pairs (x0, x1), (x2, x3), ... rotated by e^{i theta}
    (HF deepseek ``apply_rotary_emb``, a complex multiply)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.to(F32).reshape(*lead, d // 2, 2)
    while cos.ndim < xf.ndim - 1:
        cos, sin = cos[..., None, :], sin[..., None, :]
    xr = xf[..., 0] * cos - xf[..., 1] * sin
    xi = xf[..., 0] * sin + xf[..., 1] * cos
    return torch.stack([xr, xi], dim=-1).reshape(*lead, d).to(x.dtype)


# --------------------------------------------------------------------------
# MLA attention
# --------------------------------------------------------------------------

def _qc(qmap, name):
    return qmap.get(name) if qmap is not None else None


def mla_project_q(p: Dict, cfg: DeepseekConfig, x, qmap=None, caps=None):
    """The queries [B, S, H, dn + dr], through ``q_proj`` or the low-rank
    pair (``caps`` gets ``q_b_in``)."""
    B, S, _ = x.shape
    if cfg.q_lora_rank is None:
        q = linear_apply(p['q_proj'], x, _qc(qmap, 'self_attn.q_proj'))
    else:
        q_a = linear_apply(p['q_a_proj'], x, _qc(qmap, 'self_attn.q_a_proj'))
        q_an = rms_norm(q_a, p['q_a_layernorm']['w'], cfg.rms_norm_eps)
        if caps is not None:
            caps['q_b_in'] = q_an
        q = linear_apply(p['q_b_proj'], q_an, _qc(qmap, 'self_attn.q_b_proj'))
    return q.reshape(B, S, cfg.num_attention_heads, cfg.qk_head_dim)


def mla_project_kv_a(p: Dict, cfg: DeepseekConfig, x, qmap=None):
    """(the normed latent [B, S, dc], the un-roped shared rope key
    [B, S, dr])."""
    ckv = linear_apply(p['kv_a_proj_with_mqa'], x,
                       _qc(qmap, 'self_attn.kv_a_proj_with_mqa'))
    dc = cfg.kv_lora_rank
    kv_an = rms_norm(ckv[..., :dc], p['kv_a_layernorm']['w'],
                     cfg.rms_norm_eps)
    return kv_an, ckv[..., dc:]


def mla_apply(p: Dict, cfg: DeepseekConfig, x, cos, sin, attn_bias,
              qmap=None, capture: bool = False):
    """Full causal MLA for one block.  Returns (out, captures: ``q_b_in``,
    ``kv_b_in``, ``o_in``)."""
    B, S, _ = x.shape
    H = cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    caps = {}
    q = mla_project_q(p, cfg, x, qmap, caps if capture else None)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv_an, k_pe = mla_project_kv_a(p, cfg, x, qmap)
    if capture:
        caps['kv_b_in'] = kv_an
    kv = linear_apply(p['kv_b_proj'], kv_an,
                      _qc(qmap, 'self_attn.kv_b_proj')).reshape(
                          B, S, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = apply_rope_interleaved(q_pe, cos, sin)               # [B,S,H,dr]
    k_pe = apply_rope_interleaved(k_pe.reshape(B, S, 1, dr), cos, sin)
    k_pe = k_pe.expand(B, S, H, dr)
    qh = torch.cat([q_nope, q_pe], dim=-1)
    kh = torch.cat([k_nope, k_pe], dim=-1)
    qh = attn_act_fq(qmap, 'self_attn.matmul_1', qh)
    kh = attn_act_fq(qmap, 'self_attn.matmul_1', kh)
    scale = (dn + dr) ** -0.5
    scores = torch.einsum('bqhd,bkhd->bhqk', qh.to(F32), kh.to(F32)) * scale
    scores = attn_act_fq(qmap, 'self_attn.softmax', scores)
    if attn_bias is not None:
        scores = scores + attn_bias.to(F32)
    else:
        qi = torch.arange(S, device=x.device)[:, None]
        ki = torch.arange(S, device=x.device)[None, :]
        scores = scores.masked_fill(~(qi >= ki), float('-inf'))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    probs = attn_act_fq(qmap, 'self_attn.matmul_2', probs)
    v = attn_act_fq(qmap, 'self_attn.matmul_2', v)
    ctx = torch.einsum('bhqk,bkhd->bqhd', probs.to(F32),
                       v.to(F32)).to(x.dtype)
    o_in = ctx.reshape(B, S, H * dv)
    if capture:
        caps['o_in'] = o_in
    return linear_apply(p['o_proj'], o_in, _qc(qmap, 'self_attn.o_proj')), caps


# --------------------------------------------------------------------------
# MoE / dense MLP
# --------------------------------------------------------------------------

def _swiglu(p: Dict, x, qmap, prefix: str):
    """A gated MLP under ``prefix``: (out, down_in)."""
    return MX.swiglu_expert(p, x, _GUD, MX._qc_of(qmap, prefix))


def moe_apply(p: Dict, cfg: DeepseekConfig, x, qmap=None,
              capture: bool = False):
    """Softmax routing, top k, the optional renormalisation, the routed
    scaling factor, and the shared experts.  Returns (out, captures:
    ``down_in_{e}``, ``shared_down_in``)."""
    caps = {}
    K = cfg.num_experts_per_tok
    logits = linear_apply(p['gate'], x).to(F32)
    scores = torch.softmax(logits, dim=-1)
    topv, topi = top_k(scores, K)
    if cfg.norm_topk_prob:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-20)
    topv = topv * cfg.routed_scaling_factor
    weights = dense_route_weights(scores, topi, topv)
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for e in range(cfg.n_routed_experts):
        y, din = _swiglu(p['experts'][e], x, qmap, f'mlp.experts.{e}')
        if capture:
            caps[f'down_in_{e}'] = din
        out = out + weights[..., e:e + 1] * y.to(F32)
    if cfg.n_shared_experts:
        y, din = _swiglu(p['shared_experts'], x, qmap, 'mlp.shared_experts')
        if capture:
            caps['shared_down_in'] = din
        out = out + y.to(F32)
    return out.to(x.dtype), caps


def mlp_apply(bp: Dict, cfg: DeepseekConfig, h, qmap=None,
              capture: bool = False):
    """The block's MLP: the MoE where the block has a router, else the
    dense gated MLP (captures ``down_in``)."""
    if 'gate' in bp['mlp']:
        return moe_apply(bp['mlp'], cfg, h, qmap, capture)
    out, din = _swiglu(bp['mlp'], h, qmap, 'mlp')
    return out, ({'down_in': din} if capture else {})


# --------------------------------------------------------------------------
# Block apply (a dense or MoE block, told apart by the router's key)
# --------------------------------------------------------------------------

def block_apply(bp: Dict, cfg: DeepseekConfig, x, cos, sin, attn_bias=None,
                qmap=None, capture: bool = False):
    """One decoder block.  Returns (y, captures)."""
    caps = {}
    h = rms_norm(x, bp['input_layernorm']['w'], cfg.rms_norm_eps)
    if capture:
        caps['q_in'] = h
    attn_out, acaps = mla_apply(bp['self_attn'], cfg, h, cos, sin,
                                attn_bias, qmap, capture)
    caps.update(acaps)
    x = x + attn_out
    h = rms_norm(x, bp['post_attention_layernorm']['w'], cfg.rms_norm_eps)
    if capture:
        caps['mlp_in'] = h
    mlp_out, mcaps = mlp_apply(bp, cfg, h, qmap, capture)
    caps.update(mcaps)
    return x + mlp_out, caps


def deepseek_layout(cfg: DeepseekConfig) -> BlockLayout:
    """The reference's subsets (deepseekv2.py:67-190) for the MoE block;
    a model with dense first layers lists their MLP linears too, and the
    block loop skips what a block lacks (``has_path``)."""
    q_layers = (('self_attn.q_proj',) if cfg.q_lora_rank is None
                else ('self_attn.q_a_proj',))
    qkv_a = q_layers + ('self_attn.kv_a_proj_with_mqa',)
    subsets = [
        SubsetSpec(name='qkv_a', layers=qkv_a, prev_op='input_layernorm',
                   prev_kind='ln', input_key='q_in', inspect='attn',
                   has_kwargs=True),
        SubsetSpec(name='o', layers=('self_attn.o_proj',), prev_op=None,
                   prev_kind=None, input_key='o_in', inspect='o_proj'),
        SubsetSpec(name='kv_b', layers=('self_attn.kv_b_proj',),
                   prev_op='self_attn.kv_a_layernorm', prev_kind='ln',
                   input_key='kv_b_in', inspect='kv_b', do_trans=False),
    ]
    linears = list(qkv_a) + ['self_attn.o_proj', 'self_attn.kv_b_proj']
    capture_of = [(p, 'q_in') for p in qkv_a] + [
        ('self_attn.o_proj', 'o_in'), ('self_attn.kv_b_proj', 'kv_b_in')]
    if cfg.q_lora_rank is not None:
        subsets.append(SubsetSpec(
            name='q_b', layers=('self_attn.q_b_proj',),
            prev_op='self_attn.q_a_layernorm', prev_kind='ln',
            input_key='q_b_in', inspect='q_b', do_trans=False))
        linears.append('self_attn.q_b_proj')
        capture_of.append(('self_attn.q_b_proj', 'q_b_in'))
    dense = [('mlp.gate_proj', 'mlp_in'), ('mlp.up_proj', 'mlp_in'),
             ('mlp.down_proj', 'down_in')]
    if cfg.n_routed_experts:
        gu = []
        for e in range(cfg.n_routed_experts):
            pre = f'mlp.experts.{e}'
            gu += [f'{pre}.gate_proj', f'{pre}.up_proj']
            subsets.append(SubsetSpec(
                name=f'expert{e}_down', layers=(f'{pre}.down_proj',),
                prev_op=f'{pre}.up_proj', prev_kind='fc',
                input_key=f'down_in_{e}', inspect=f'expert{e}_down',
                is_mlp=True))
            capture_of += [(f'{pre}.gate_proj', 'mlp_in'),
                           (f'{pre}.up_proj', 'mlp_in'),
                           (f'{pre}.down_proj', f'down_in_{e}')]
        gu += ['mlp.shared_experts.gate_proj', 'mlp.shared_experts.up_proj']
        capture_of += [('mlp.shared_experts.gate_proj', 'mlp_in'),
                       ('mlp.shared_experts.up_proj', 'mlp_in'),
                       ('mlp.shared_experts.down_proj', 'shared_down_in')]
        subsets.insert(3, SubsetSpec(
            name='moe_gu', layers=tuple(gu),
            prev_op='post_attention_layernorm', prev_kind='ln',
            input_key='mlp_in', inspect='mlp', is_mlp=True))
        subsets.append(SubsetSpec(
            name='shared_down', layers=('mlp.shared_experts.down_proj',),
            prev_op='mlp.shared_experts.up_proj', prev_kind='fc',
            input_key='shared_down_in', inspect='shared_down', is_mlp=True))
        linears += gu + [f'mlp.experts.{e}.down_proj'
                         for e in range(cfg.n_routed_experts)] + [
                             'mlp.shared_experts.down_proj']
        if cfg.first_k_dense_replace > 0:
            linears += [p for p, _ in dense]
            capture_of += dense
    else:
        subsets.append(SubsetSpec(
            name='gate_up', layers=('mlp.gate_proj', 'mlp.up_proj'),
            prev_op='post_attention_layernorm', prev_kind='ln',
            input_key='mlp_in', inspect='mlp', is_mlp=True))
        subsets.append(SubsetSpec(
            name='down', layers=('mlp.down_proj',), prev_op='mlp.up_proj',
            prev_kind='fc', input_key='down_in', inspect='down',
            is_mlp=True))
        linears += [p for p, _ in dense]
        capture_of += dense
    return BlockLayout(subsets=tuple(subsets), linears=tuple(linears),
                       layernorms=('input_layernorm',
                                   'post_attention_layernorm'),
                       capture_of=tuple(capture_of))


def make_inspect_fns(cfg: DeepseekConfig) -> Dict:
    def attn(bp, h, kw, qmap=None):
        return mla_apply(bp['self_attn'], cfg, h, kw['cos'], kw['sin'],
                         kw.get('attn_bias'), qmap)[0]

    def mlp(bp, h, kw, qmap=None):
        return mlp_apply(bp, cfg, h, qmap)[0]

    def lin(*path):
        def fn(bp, x, kw, qmap=None):
            p = bp
            for k in path:
                p = p[k]
            return linear_apply(p, x)
        return fn
    fns = {'attn': attn, 'mlp': mlp,
           'o_proj': lin('self_attn', 'o_proj'),
           'kv_b': lin('self_attn', 'kv_b_proj'),
           'q_b': lin('self_attn', 'q_b_proj'),
           'down': lin('mlp', 'down_proj'),
           'shared_down': lin('mlp', 'shared_experts', 'down_proj')}
    for e in range(cfg.n_routed_experts or 0):
        fns[f'expert{e}_down'] = lin('mlp', 'experts', e, 'down_proj')
    return fns


# --------------------------------------------------------------------------
# HF loading / random init
# --------------------------------------------------------------------------

def init_params(cfg: DeepseekConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` (on ``device``)."""
    ini = L.Init(generator, dtype or cfg.tdtype, device)
    D, H = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dc = cfg.kv_lora_rank

    def swiglu(inter):
        return {'gate_proj': ini.lin(inter, D), 'up_proj': ini.lin(inter, D),
                'down_proj': ini.lin(D, inter)}

    blocks = []
    for i in range(cfg.num_hidden_layers):
        attn = {'kv_a_proj_with_mqa': ini.lin(dc + dr, D),
                'kv_a_layernorm': ini.ones(dc),
                'kv_b_proj': ini.lin(H * (dn + dv), dc),
                'o_proj': ini.lin(D, H * dv)}
        if cfg.q_lora_rank is None:
            attn['q_proj'] = ini.lin(H * (dn + dr), D)
        else:
            attn['q_a_proj'] = ini.lin(cfg.q_lora_rank, D)
            attn['q_a_layernorm'] = ini.ones(cfg.q_lora_rank)
            attn['q_b_proj'] = ini.lin(H * (dn + dr), cfg.q_lora_rank)
        if cfg.is_moe_layer(i):
            mlp = {'gate': ini.lin(cfg.n_routed_experts, D),
                   'experts': [swiglu(cfg.moe_intermediate_size)
                               for _ in range(cfg.n_routed_experts)]}
            if cfg.n_shared_experts:
                mlp['shared_experts'] = swiglu(
                    cfg.moe_intermediate_size * cfg.n_shared_experts)
        else:
            mlp = swiglu(cfg.intermediate_size)
        blocks.append({'input_layernorm': ini.ones(D), 'self_attn': attn,
                       'post_attention_layernorm': ini.ones(D), 'mlp': mlp})
    return {'embed_tokens': ini.embed(cfg.vocab_size, D), 'blocks': blocks,
            'norm': ini.ones(D), 'lm_head': ini.lin(cfg.vocab_size, D)}


def params_from_hf(flat, cfg: DeepseekConfig) -> Dict:
    def lin(pre):
        return hf_linear(flat, pre)

    blocks = []
    for i in range(cfg.num_hidden_layers):
        b = f'model.layers.{i}'
        sa = f'{b}.self_attn'
        attn = {'kv_a_proj_with_mqa': lin(f'{sa}.kv_a_proj_with_mqa'),
                'kv_a_layernorm': {'w': flat[f'{sa}.kv_a_layernorm.weight']},
                'kv_b_proj': lin(f'{sa}.kv_b_proj'),
                'o_proj': lin(f'{sa}.o_proj')}
        if cfg.q_lora_rank is None:
            attn['q_proj'] = lin(f'{sa}.q_proj')
        else:
            attn['q_a_proj'] = lin(f'{sa}.q_a_proj')
            attn['q_a_layernorm'] = {'w': flat[f'{sa}.q_a_layernorm.weight']}
            attn['q_b_proj'] = lin(f'{sa}.q_b_proj')
        if cfg.is_moe_layer(i):
            if f'{b}.mlp.gate.e_score_correction_bias' in flat:
                raise NotImplementedError(
                    f'{b}.mlp.gate.e_score_correction_bias: the checkpoint '
                    f'routes with a score correction (V3 noaux_tc), which '
                    f'the reference does not compute')
            mlp = {'gate': {'w': flat[f'{b}.mlp.gate.weight'], 'b': None},
                   'experts': [{n: lin(f'{b}.mlp.experts.{e}.{n}')
                                for n in _GUD}
                               for e in range(cfg.n_routed_experts)]}
            if cfg.n_shared_experts:
                mlp['shared_experts'] = {
                    n: lin(f'{b}.mlp.shared_experts.{n}') for n in _GUD}
        else:
            mlp = {n: lin(f'{b}.mlp.{n}') for n in _GUD}
        blocks.append({
            'input_layernorm': {'w': flat[f'{b}.input_layernorm.weight']},
            'self_attn': attn,
            'post_attention_layernorm': {
                'w': flat[f'{b}.post_attention_layernorm.weight']},
            'mlp': mlp})
    emb = flat['model.embed_tokens.weight']
    lm = flat.get('lm_head.weight')
    return {'embed_tokens': {'w': emb}, 'blocks': blocks,
            'norm': {'w': flat['model.norm.weight']},
            'lm_head': {'w': emb if lm is None else lm, 'b': None}}
