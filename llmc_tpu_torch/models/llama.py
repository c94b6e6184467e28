"""Functional Llama model (port of ``llmc_tpu/models/llama.py``).

``LlamaConfig`` keeps every field of the reference (so ``from_hf`` and
hashing agree); the port runs the Llama graph — RMSNorm, full rotary
(with 'linear' / 'llama3' scaling), GQA, gated MLP — and raises
``NotImplementedError`` for the generalized-graph options it has not
ported (``check_ported``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .base import (BlockLayout, LinearQcfg, SubsetSpec, attn_act_fq,
                   linear_apply, matmul_f32_acc, rms_norm)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    dtype: str = 'bfloat16'
    use_qk_norm: bool = False
    act_fn: str = 'silu'
    sandwich_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: Optional[int] = None
    embed_scale: bool = False
    embed_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logit_divisor: Optional[float] = None
    norm_type: str = 'rms'
    rotary_pct: float = 1.0
    rope_interleaved: bool = False
    parallel_residual: bool = False
    shared_ln: bool = False
    layer_scale: bool = False
    qk_norm_full: bool = False
    gated_mlp: bool = True
    use_alibi: bool = False
    alibi_scaled: bool = False
    learned_pos: bool = False
    learned_pos_offset: int = 0
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def from_hf(cls, hf: dict) -> 'LlamaConfig':
        h = hf
        heads = h['num_attention_heads']
        rs = h.get('rope_scaling') or {}
        rs_type = rs.get('rope_type', rs.get('type'))
        if rs_type == 'default':
            rs_type = None
        return cls(
            rope_scaling_type=rs_type,
            rope_scaling_factor=float(rs.get('factor', 1.0)),
            rope_low_freq_factor=float(rs.get('low_freq_factor', 1.0)),
            rope_high_freq_factor=float(rs.get('high_freq_factor', 4.0)),
            rope_original_max_pos=int(rs.get(
                'original_max_position_embeddings', 8192)),
            vocab_size=h['vocab_size'],
            hidden_size=h['hidden_size'],
            intermediate_size=h['intermediate_size'],
            num_hidden_layers=h['num_hidden_layers'],
            num_attention_heads=heads,
            num_key_value_heads=h.get('num_key_value_heads', heads),
            head_dim=h.get('head_dim') or h['hidden_size'] // heads,
            rms_norm_eps=h.get('rms_norm_eps', 1e-5),
            rope_theta=h.get('rope_theta', 10000.0),
            max_position_embeddings=h.get('max_position_embeddings', 4096),
            tie_word_embeddings=h.get('tie_word_embeddings', False),
            attention_bias=h.get('attention_bias', False),
            mlp_bias=h.get('mlp_bias', False),
            dtype=_norm_dtype(h.get('torch_dtype', 'bfloat16')),
        )


def _norm_dtype(s) -> str:
    """torch_dtype config string -> dtype name; fp16 and 'auto' map to
    bf16, as in the reference."""
    s = str(s).replace('torch.', '')
    if s in ('float16', 'half', 'auto'):
        return 'bfloat16'
    return s


# graph options of LlamaConfig the port has not ported: name -> default
_GRAPH_DEFAULTS = {
    'use_qk_norm': False, 'sandwich_norms': False,
    'attn_logit_softcap': None, 'final_logit_softcap': None,
    'query_pre_attn_scalar': None, 'sliding_window': None,
    'embed_scale': False, 'embed_multiplier': None,
    'residual_multiplier': None, 'logit_divisor': None, 'norm_type': 'rms',
    'rotary_pct': 1.0, 'rope_interleaved': False,
    'parallel_residual': False, 'shared_ln': False, 'layer_scale': False,
    'qk_norm_full': False, 'gated_mlp': True, 'use_alibi': False,
    'alibi_scaled': False, 'learned_pos': False,
}


def check_ported(cfg: LlamaConfig) -> None:
    """Raise for a generalized-graph option the port does not run yet
    (the other model families, ROADMAP A13)."""
    for name, default in _GRAPH_DEFAULTS.items():
        v = getattr(cfg, name)
        if v != default:
            raise NotImplementedError(
                f'LlamaConfig.{name}={v!r} is not ported yet (ROADMAP A13: '
                f'the generalized block graph of the other families)')


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------

def rope_cos_sin(cfg: LlamaConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions, float32, [..., head_dim]."""
    rd = cfg.head_dim - cfg.head_dim % 2
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rd, 2, dtype=F32, device=dev) / rd))
    if cfg.rope_scaling_type == 'linear':
        inv_freq = inv_freq / cfg.rope_scaling_factor
    elif cfg.rope_scaling_type == 'llama3':
        factor = cfg.rope_scaling_factor
        lo_wl = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
        hi_wl = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
        wl = 2.0 * math.pi / inv_freq
        smooth = ((cfg.rope_original_max_pos / wl - cfg.rope_low_freq_factor)
                  / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor))
        blended = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(wl < hi_wl, inv_freq,
                               torch.where(wl > lo_wl, inv_freq / factor,
                                           blended))
    elif cfg.rope_scaling_type is not None:
        raise NotImplementedError(
            f'rope_scaling_type={cfg.rope_scaling_type!r} is not ported')
    freqs = positions.to(F32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF rotate-half rope.  q,k: [B,S,H,hd]; cos/sin: [B?,S,hd]."""
    def rot(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    while cos.ndim < q.ndim:
        cos, sin = cos[..., None, :], sin[..., None, :]
    qf, kf = q.to(F32), k.to(F32)
    q_out = (qf * cos + rot(qf) * sin).to(q.dtype)
    k_out = (kf * cos + rot(kf) * sin).to(k.dtype)
    return q_out, k_out


# --------------------------------------------------------------------------
# Attention / MLP
# --------------------------------------------------------------------------

def _qc(qmap, path: str) -> Optional[LinearQcfg]:
    if qmap is None:
        return None
    return qmap.get(path)


def attention_apply(p: Dict, cfg: LlamaConfig, x: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor,
                    attn_bias: Optional[torch.Tensor], qmap=None,
                    prefix: str = 'self_attn'):
    """Full causal attention for one block.  Returns (out, o_in)."""
    B, S, D = x.shape
    H, KVH, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = linear_apply(p['q_proj'], x, _qc(qmap, f'{prefix}.q_proj'))
    k = linear_apply(p['k_proj'], x, _qc(qmap, f'{prefix}.k_proj'))
    v = linear_apply(p['v_proj'], x, _qc(qmap, f'{prefix}.v_proj'))
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    q, k = apply_rope(q, k, cos, sin)
    if KVH != H:
        rep = H // KVH
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    q = attn_act_fq(qmap, f'{prefix}.matmul_1', q)
    k = attn_act_fq(qmap, f'{prefix}.matmul_1', k)
    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32), k.to(F32)) * scale
    scores = attn_act_fq(qmap, f'{prefix}.softmax', scores)
    Skv = k.shape[1]
    if attn_bias is not None:
        scores = scores + attn_bias.to(F32)
    else:
        q_pos = torch.arange(S, device=x.device)[:, None] + (Skv - S)
        k_pos = torch.arange(Skv, device=x.device)[None, :]
        scores = scores.masked_fill(~(q_pos >= k_pos), float('-inf'))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    probs = attn_act_fq(qmap, f'{prefix}.matmul_2', probs)
    v = attn_act_fq(qmap, f'{prefix}.matmul_2', v)
    ctx = torch.einsum('bhqk,bkhd->bqhd', probs.to(F32),
                       v.to(F32)).to(x.dtype)
    o_in = ctx.reshape(B, S, H * hd)
    out = linear_apply(p['o_proj'], o_in, _qc(qmap, f'{prefix}.o_proj'))
    return out, o_in


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == 'gelu_tanh':
        return torch.nn.functional.gelu(x, approximate='tanh')
    if act == 'gelu':
        return torch.nn.functional.gelu(x)
    if act == 'relu':
        return torch.relu(x)
    if act == 'quick_gelu':
        return x * torch.sigmoid(1.702 * x)
    return torch.nn.functional.silu(x)


def mlp_apply(p: Dict, x: torch.Tensor, qmap=None, prefix: str = 'mlp',
              act: str = 'silu'):
    """Gated MLP.  Returns (out, down_in)."""
    u = linear_apply(p['up_proj'], x, _qc(qmap, f'{prefix}.up_proj'))
    g = linear_apply(p['gate_proj'], x, _qc(qmap, f'{prefix}.gate_proj'))
    g = attn_act_fq(qmap, f'{prefix}.act_fn', g)
    down_in = _act(g.to(F32), act).to(x.dtype) * u
    out = linear_apply(p['down_proj'], down_in,
                       _qc(qmap, f'{prefix}.down_proj'))
    return out, down_in


# --------------------------------------------------------------------------
# Block / model apply
# --------------------------------------------------------------------------

def block_apply(bp: Dict, cfg: LlamaConfig, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, qmap=None,
                capture: bool = False):
    """One decoder block.  Returns (y, captures); captures is {} unless
    ``capture`` (keys qkv_in, o_in, mlp_in, down_in)."""
    caps = {}
    eps = cfg.rms_norm_eps
    h = rms_norm(x, bp['input_layernorm']['w'], eps)
    if capture:
        caps['qkv_in'] = h
    attn_out, o_in = attention_apply(bp['self_attn'], cfg, h, cos, sin,
                                     attn_bias, qmap)
    if capture:
        caps['o_in'] = o_in
    x = x + attn_out
    h = rms_norm(x, bp['post_attention_layernorm']['w'], eps)
    if capture:
        caps['mlp_in'] = h
    mlp_out, down_in = mlp_apply(bp['mlp'], h, qmap, act=cfg.act_fn)
    if capture:
        caps['down_in'] = down_in
    return x + mlp_out, caps


def embed_apply(params: Dict, cfg: LlamaConfig,
                input_ids: torch.Tensor) -> torch.Tensor:
    return params['embed_tokens']['w'][input_ids]


def head_apply(params: Dict, cfg: LlamaConfig, x: torch.Tensor,
               qmap=None) -> torch.Tensor:
    """Final norm + lm_head -> float32 logits.  A packed head goes through
    the weight-only dequant-matmul of its bits with an f32 output."""
    h = rms_norm(x, params['norm']['w'], cfg.rms_norm_eps)
    head = params.get('lm_head') if not cfg.tie_word_embeddings else None
    if head is not None and 'qweight' in head:
        from ..ops.dequant_matmul import dequant_matmul
        qc = qmap.get('lm_head') if qmap is not None else None
        if qc is None or qc.qmeta is None:
            raise ValueError('packed lm_head needs a qmap entry with QMeta')
        logits = dequant_matmul(h.to(cfg.tdtype), head['qweight'],
                                head['scales'], head.get('zeros'),
                                qc.qmeta, out_dtype=F32)
        if head.get('b') is not None:
            logits = logits + head['b'].to(F32)
        return logits
    w = (params['embed_tokens']['w'] if cfg.tie_word_embeddings
         else params['lm_head']['w'])
    logits = matmul_f32_acc(h, w)
    if not cfg.tie_word_embeddings and params['lm_head'].get('b') is not None:
        logits = logits + params['lm_head']['b'].to(F32)
    return logits


def model_apply(params: Dict, cfg: LlamaConfig, input_ids: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, qmap=None
                ) -> torch.Tensor:
    """Full forward to logits (no KV cache)."""
    check_ported(cfg)
    B, S = input_ids.shape
    x = embed_apply(params, cfg, input_ids)
    cos, sin = rope_cos_sin(cfg, torch.arange(S, device=x.device)[None, :])
    for bp in params['blocks']:
        x, _ = block_apply(bp, cfg, x, cos, sin, attn_bias, qmap)
    return head_apply(params, cfg, x)


# --------------------------------------------------------------------------
# Layout (the declarative get_subsets_in_block)
# --------------------------------------------------------------------------

def llama_layout(cfg: LlamaConfig) -> BlockLayout:
    gqa = cfg.num_key_value_heads != cfg.num_attention_heads
    mlp_layers = ('mlp.gate_proj', 'mlp.up_proj')
    subsets = (
        SubsetSpec(name='qkv', layers=('self_attn.q_proj', 'self_attn.k_proj',
                                       'self_attn.v_proj'),
                   prev_op='input_layernorm', prev_kind='ln',
                   input_key='qkv_in', inspect='attn', has_kwargs=True),
        SubsetSpec(name='o', layers=('self_attn.o_proj',),
                   prev_op='self_attn.v_proj', prev_kind='fc',
                   input_key='o_in', inspect='o_proj', is_gqa=gqa),
        SubsetSpec(name='gate_up', layers=mlp_layers,
                   prev_op='post_attention_layernorm', prev_kind='ln',
                   input_key='mlp_in', inspect='mlp', is_mlp=True),
        SubsetSpec(name='down', layers=('mlp.down_proj',),
                   prev_op='mlp.up_proj', prev_kind='fc',
                   input_key='down_in', inspect='down_proj', is_mlp=True),
    )
    linears = ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj',
               'self_attn.o_proj') + mlp_layers + ('mlp.down_proj',)
    capture_of = (
        ('self_attn.q_proj', 'qkv_in'), ('self_attn.k_proj', 'qkv_in'),
        ('self_attn.v_proj', 'qkv_in'), ('self_attn.o_proj', 'o_in'),
    ) + tuple((n, 'mlp_in') for n in mlp_layers) + (
        ('mlp.down_proj', 'down_in'),)
    return BlockLayout(subsets=subsets, linears=linears,
                       layernorms=('input_layernorm',
                                   'post_attention_layernorm'),
                       capture_of=capture_of)


# --------------------------------------------------------------------------
# Inspect functions: re-run a slice of the block from a subset's input
# --------------------------------------------------------------------------

def make_inspect_fns(cfg: LlamaConfig):
    """Named functions (bp, subset_input, kwargs) -> subset output."""

    def attn(bp, h, kw, qmap=None):
        out, _ = attention_apply(bp['self_attn'], cfg, h, kw.get('cos'),
                                 kw.get('sin'), kw.get('attn_bias'), qmap)
        return out

    def o_proj(bp, o_in, kw, qmap=None):
        return linear_apply(bp['self_attn']['o_proj'], o_in,
                            _qc(qmap, 'self_attn.o_proj'))

    def mlp(bp, h, kw, qmap=None):
        out, _ = mlp_apply(bp['mlp'], h, qmap, act=cfg.act_fn)
        return out

    def down_proj(bp, down_in, kw, qmap=None):
        return linear_apply(bp['mlp']['down_proj'], down_in,
                            _qc(qmap, 'mlp.down_proj'))

    return {'attn': attn, 'o_proj': o_proj, 'mlp': mlp,
            'down_proj': down_proj}


# --------------------------------------------------------------------------
# Parameter init (random, for tests and benches without checkpoints)
# --------------------------------------------------------------------------

class Init:
    """Random params drawn from a ``torch.Generator`` in the reference's
    scales: a linear N(0, 0.6 / sqrt(in)), the embedding N(0, 0.02), the
    norms ones, the biases zero."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device=None):
        self.gen = generator
        self.dtype = dtype
        self.device = (torch.device(device) if device is not None
                       else generator.device)

    def normal(self, shape, std):
        return (torch.randn(shape, generator=self.gen, dtype=F32,
                            device=self.device) * std).to(self.dtype)

    def lin(self, o: int, i: int, bias: bool = False) -> Dict:
        return {'w': self.normal((o, i), 0.6 / i ** 0.5),
                'b': (torch.zeros((o,), dtype=self.dtype, device=self.device)
                      if bias else None)}

    def ones(self, n: int) -> Dict:
        return {'w': torch.ones((n,), dtype=self.dtype, device=self.device)}

    def embed(self, vocab: int, d: int) -> Dict:
        return {'w': self.normal((vocab, d), 0.02)}


def attention_init(ini: Init, cfg, bias: bool = False,
                   o_bias: bool = False) -> Dict:
    """The q/k/v/o projections, drawn in that order."""
    D, H, KVH, hd = (cfg.hidden_size, cfg.num_attention_heads,
                     cfg.num_key_value_heads, cfg.head_dim)
    return {'q_proj': ini.lin(H * hd, D, bias),
            'k_proj': ini.lin(KVH * hd, D, bias),
            'v_proj': ini.lin(KVH * hd, D, bias),
            'o_proj': ini.lin(D, H * hd, o_bias)}


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None,
                device=None) -> Dict:
    """Random params drawn from ``generator`` (on ``device``; the
    generator must live on the same device)."""
    check_ported(cfg)
    ini = Init(generator, dtype or cfg.tdtype, device)
    D, I = cfg.hidden_size, cfg.intermediate_size
    blocks = []
    for _ in range(cfg.num_hidden_layers):
        blocks.append({
            'input_layernorm': ini.ones(D),
            'self_attn': attention_init(ini, cfg, cfg.attention_bias,
                                        cfg.attention_bias),
            'mlp': {'up_proj': ini.lin(I, D, cfg.mlp_bias),
                    'down_proj': ini.lin(D, I, cfg.mlp_bias),
                    'gate_proj': ini.lin(I, D, cfg.mlp_bias)},
            'post_attention_layernorm': ini.ones(D),
        })
    params = {'embed_tokens': ini.embed(cfg.vocab_size, D),
              'blocks': blocks, 'norm': ini.ones(D)}
    if not cfg.tie_word_embeddings:
        params['lm_head'] = ini.lin(cfg.vocab_size, D)
    return params
