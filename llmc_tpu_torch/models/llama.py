"""Functional Llama-family model on the generalized block graph (port of
``llmc_tpu/models/llama.py``).

``LlamaConfig`` keeps every field of the reference (so ``from_hf`` and
hashing agree).  The one block graph runs Llama, Mistral, Qwen2/3, Phi3
and SmolLM, and through its options Gemma2 (sandwich norms, softcaps, the
query scale, even-layer sliding window, sqrt(D) embedding scale),
MiniCPM (its three multipliers), StableLm / Phi / GLM (partial and
interleaved rope), Falcon / Phi (parallel residual, shared LayerNorm),
Starcoder and OPT (learned positions, OPT's at +2,
``learned_pos_offset``) and Bloom / Falcon-RW (ALiBi), with LayerNorm and
non-gated MLPs, and InternViT's ``layer_scale`` (per-channel ``ls1`` /
``ls2`` on each sublayer's output) and ``qk_norm_full`` (an RMS q / k norm
over the whole projection, before the head split).  Qwen2-VL's ``mrope``
rope-scaling type is plain rope on 1-D positions: its three streams carry
one position on text (the VL forward builds its own tables,
``models/qwen2vl.py::mrope_cos_sin``).  The eager graph also takes the
fused serving layout of ``serve/packed.py`` (``qkv_proj``,
``gate_up_proj``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from .base import (BlockLayout, LinearQcfg, SubsetSpec, attn_act_fq,
                   layer_norm, linear_apply, matmul_f32_acc, rms_norm)

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


def norm_apply(cfg: LlamaConfig, x: torch.Tensor, p: Dict) -> torch.Tensor:
    """The block's norm: RMSNorm, or LayerNorm (with its bias where the
    params hold one) under ``norm_type='ln'``."""
    if cfg.norm_type == 'ln':
        return layer_norm(x, p['w'], p.get('b'), cfg.rms_norm_eps)
    return rms_norm(x, p['w'], cfg.rms_norm_eps)


# --------------------------------------------------------------------------
# Rotary embeddings and ALiBi
# --------------------------------------------------------------------------

def _rotary_dim(cfg: LlamaConfig) -> int:
    rd = int(cfg.head_dim * cfg.rotary_pct)
    return rd - rd % 2


def rope_cos_sin(cfg: LlamaConfig, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions, float32, [..., rotary_dim]
    (= head_dim unless ``rotary_pct`` < 1; empty when it is 0)."""
    rd = _rotary_dim(cfg)
    dev = positions.device
    if rd == 0:
        z = torch.zeros(positions.shape + (0,), dtype=F32, device=dev)
        return z, z
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
    elif cfg.rope_scaling_type not in (None, 'mrope'):
        raise NotImplementedError(
            f'rope_scaling_type={cfg.rope_scaling_type!r} is not ported')
    freqs = positions.to(F32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, interleaved: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF rotate-half rope.  q,k: [B,S,H,hd]; cos/sin: [B?,S,rd].  Where
    rd < hd (partial rotary: StableLm, Phi, GLM) only the first rd
    channels rotate and the tail passes through; ``interleaved`` (GLM)
    rotates adjacent channel pairs instead of halves."""
    if interleaved:
        def rot(x):
            x1, x2 = x[..., 0::2], x[..., 1::2]
            return torch.stack([-x2, x1], dim=-1).reshape(x.shape)
    else:
        def rot(x):
            x1, x2 = torch.chunk(x, 2, dim=-1)
            return torch.cat([-x2, x1], dim=-1)

    while cos.ndim < q.ndim:
        cos, sin = cos[..., None, :], sin[..., None, :]
    rd, hd = cos.shape[-1], q.shape[-1]
    qf, kf = q[..., :rd].to(F32), k[..., :rd].to(F32)
    q_out = (qf * cos + rot(qf) * sin).to(q.dtype)
    k_out = (kf * cos + rot(kf) * sin).to(k.dtype)
    if rd < hd:
        q_out = torch.cat([q_out, q[..., rd:]], dim=-1)
        k_out = torch.cat([k_out, k[..., rd:]], dim=-1)
    return q_out, k_out


def rope_qk(cfg: LlamaConfig, q: torch.Tensor, k: torch.Tensor,
            cos: torch.Tensor, sin: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The config's rope on q and k (none where ``rotary_pct`` is 0).
    GLM's interleaved rope takes the first rd/2 frequencies, each on an
    adjacent channel pair."""
    if _rotary_dim(cfg) == 0:
        return q, k
    if cfg.rope_interleaved:
        rd = cos.shape[-1]
        cos = torch.repeat_interleave(cos[..., :rd // 2], 2, dim=-1)
        sin = torch.repeat_interleave(sin[..., :rd // 2], 2, dim=-1)
    return apply_rope(q, k, cos, sin, interleaved=cfg.rope_interleaved)


_SLOPES: Dict = {}


def _alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """Bloom-style ALiBi head slopes (geometric; a head count that is no
    power of two gets the interleaved extension), float32.  Kept per
    (heads, device): made once, outside any CUDA graph capture."""
    key = (n_heads, str(device))
    if key not in _SLOPES:
        p = 2 ** math.floor(math.log2(n_heads))
        base = [2.0 ** (-(2.0 ** -(math.log2(p) - 3)) * (i + 1))
                for i in range(p)]
        if p < n_heads:
            base += [2.0 ** (-(2.0 ** -(math.log2(2 * p) - 3)) * (i + 1))
                     for i in range(0, 2 * (n_heads - p), 2)]
        _SLOPES[key] = torch.tensor(base, dtype=F32, device=device)
    return _SLOPES[key]


def attn_scale(cfg: LlamaConfig) -> float:
    """The scores' scale: 1/sqrt(query_pre_attn_scalar) (Gemma2), else
    1/sqrt(head_dim)."""
    qs = cfg.query_pre_attn_scalar
    return 1.0 / ((qs if qs else cfg.head_dim) ** 0.5)


def alibi_bias(cfg: LlamaConfig, n_kv: int, device) -> torch.Tensor:
    """[H, 1, n_kv] per-head linear bias in key position (the row-constant
    query term cancels in the softmax, as in HF Bloom's alibi tensor);
    Falcon's ``alibi_scaled`` scales it by the scores' scale too."""
    slopes = _alibi_slopes(cfg.num_attention_heads, device) * (
        attn_scale(cfg) if cfg.alibi_scaled else 1.0)
    return slopes[:, None, None] * torch.arange(n_kv, dtype=F32,
                                                device=device)[None, None]


# --------------------------------------------------------------------------
# Attention / MLP
# --------------------------------------------------------------------------

def _qc(qmap, path: str) -> Optional[LinearQcfg]:
    if qmap is None:
        return None
    return qmap.get(path)


def qkv_project(p: Dict, cfg: LlamaConfig, x: torch.Tensor, qmap=None,
                prefix: str = 'self_attn'):
    """q [B,S,H,hd], k and v [B,S,KVH,hd] of one block, before rope: the
    three projections (or the fused serving layout's one ``qkv_proj``),
    InternViT's full-width q / k norm, then the per-head q / k norm."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if 'qkv_proj' in p:
        q, k, v = torch.split(
            linear_apply(p['qkv_proj'], x, _qc(qmap, f'{prefix}.qkv_proj')),
            [H * hd, KVH * hd, KVH * hd], dim=-1)
    else:
        q = linear_apply(p['q_proj'], x, _qc(qmap, f'{prefix}.q_proj'))
        k = linear_apply(p['k_proj'], x, _qc(qmap, f'{prefix}.k_proj'))
        v = linear_apply(p['v_proj'], x, _qc(qmap, f'{prefix}.v_proj'))
    if cfg.qk_norm_full:
        q = rms_norm(q, p['q_norm']['w'], cfg.rms_norm_eps)
        k = rms_norm(k, p['k_norm']['w'], cfg.rms_norm_eps)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, p['q_norm']['w'], cfg.rms_norm_eps)
        k = rms_norm(k, p['k_norm']['w'], cfg.rms_norm_eps)
    return q, k, v


def attention_apply(p: Dict, cfg: LlamaConfig, x: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor,
                    attn_bias: Optional[torch.Tensor], qmap=None,
                    prefix: str = 'self_attn', window: Optional[int] = None):
    """Full attention for one block.  Returns (out, o_in).  Scores get
    the config's query scale, logit softcap and ALiBi, then ``attn_bias``
    (additive, in place of the causal mask) or the causal mask, within
    ``window`` positions where one is given."""
    B, S, D = x.shape
    H, KVH, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = qkv_project(p, cfg, x, qmap, prefix)
    q, k = rope_qk(cfg, q, k, cos, sin)
    if KVH != H:
        rep = H // KVH
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    q = attn_act_fq(qmap, f'{prefix}.matmul_1', q)
    k = attn_act_fq(qmap, f'{prefix}.matmul_1', k)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32),
                          k.to(F32)) * attn_scale(cfg)
    scores = attn_act_fq(qmap, f'{prefix}.softmax', scores)
    cap = cfg.attn_logit_softcap
    if cap:
        scores = cap * torch.tanh(scores / cap)
    Skv = k.shape[1]
    if cfg.use_alibi:
        scores = scores + alibi_bias(cfg, Skv, x.device)
    if attn_bias is not None:
        scores = scores + attn_bias.to(F32)
    else:
        q_pos = torch.arange(S, device=x.device)[:, None] + (Skv - S)
        k_pos = torch.arange(Skv, device=x.device)[None, :]
        keep = q_pos >= k_pos
        if window is not None:
            keep = keep & (q_pos - k_pos < window)
        scores = scores.masked_fill(~keep, float('-inf'))
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
    """Gated MLP (SwiGLU / GeGLU-tanh), or up -> act -> down where the
    params hold no gate (Starcoder, Phi, Falcon, Bloom); a fused
    ``gate_up_proj`` holds the gate's rows, then the up's.  Returns (out,
    down_in)."""
    if 'gate_up_proj' in p:
        g, u = torch.chunk(linear_apply(p['gate_up_proj'], x, _qc(
            qmap, f'{prefix}.gate_up_proj')), 2, dim=-1)
    else:
        u = linear_apply(p['up_proj'], x, _qc(qmap, f'{prefix}.up_proj'))
        g = (linear_apply(p['gate_proj'], x, _qc(qmap, f'{prefix}.gate_proj'))
             if 'gate_proj' in p else None)
    if g is not None:
        g = attn_act_fq(qmap, f'{prefix}.act_fn', g)
        down_in = _act(g.to(F32), act).to(x.dtype) * u
    else:
        u = attn_act_fq(qmap, f'{prefix}.act_fn', u)
        down_in = _act(u.to(F32), act).to(x.dtype)
    out = linear_apply(p['down_proj'], down_in,
                       _qc(qmap, f'{prefix}.down_proj'))
    return out, down_in


# --------------------------------------------------------------------------
# Block / model apply
# --------------------------------------------------------------------------

def block_apply(bp: Dict, cfg: LlamaConfig, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, qmap=None,
                capture: bool = False, window: Optional[int] = None):
    """One decoder block.  Returns (y, captures); captures is {} unless
    ``capture`` (keys qkv_in, o_in, mlp_in, down_in).  ``parallel_residual``
    (Falcon, Phi): y = x + attn(h) + mlp(h'), h' the attention's norm
    under ``shared_ln``; ``sandwich_norms`` (Gemma2): each sublayer's
    output is normed before its residual add; ``residual_multiplier``
    (MiniCPM) scales both sublayers' outputs; ``layer_scale`` (InternViT)
    multiplies them by ``ls1`` / ``ls2`` first."""
    caps = {}
    rm = cfg.residual_multiplier or 1.0
    h = norm_apply(cfg, x, bp['input_layernorm'])
    if capture:
        caps['qkv_in'] = h
    attn_out, o_in = attention_apply(bp['self_attn'], cfg, h, cos, sin,
                                     attn_bias, qmap, window=window)
    if capture:
        caps['o_in'] = o_in
    if cfg.parallel_residual:
        h2 = h if cfg.shared_ln else norm_apply(
            cfg, x, bp['post_attention_layernorm'])
        if capture:
            caps['mlp_in'] = h2
        mlp_out, down_in = mlp_apply(bp['mlp'], h2, qmap, act=cfg.act_fn)
        if capture:
            caps['down_in'] = down_in
        return x + attn_out + mlp_out, caps
    if cfg.layer_scale:
        attn_out = attn_out * bp['ls1']
    if cfg.sandwich_norms:
        x = x + norm_apply(cfg, attn_out, bp['post_attention_layernorm'])
        h = norm_apply(cfg, x, bp['pre_feedforward_layernorm'])
    else:
        x = x + attn_out * rm
        h = norm_apply(cfg, x, bp['post_attention_layernorm'])
    if capture:
        caps['mlp_in'] = h
    mlp_out, down_in = mlp_apply(bp['mlp'], h, qmap, act=cfg.act_fn)
    if capture:
        caps['down_in'] = down_in
    if cfg.layer_scale:
        mlp_out = mlp_out * bp['ls2']
    if cfg.sandwich_norms:
        mlp_out = norm_apply(cfg, mlp_out, bp['post_feedforward_layernorm'])
    return x + mlp_out * rm, caps


def embed_apply(params: Dict, cfg: LlamaConfig, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding, scaled by sqrt(D) (Gemma) and by
    ``embed_multiplier`` (MiniCPM), plus learned absolute positions
    (Starcoder; OPT's at ``positions + learned_pos_offset``; ``positions``
    default 0..S-1, clamped to the table as a JAX gather clamps its
    indices), then Bloom's embedding LayerNorm."""
    e = params['embed_tokens']['w'][input_ids]
    if cfg.embed_scale:
        e = (e.to(F32) * cfg.hidden_size ** 0.5).to(e.dtype)
    if cfg.embed_multiplier:
        e = (e.to(F32) * cfg.embed_multiplier).to(e.dtype)
    if cfg.learned_pos:
        table = params['embed_positions']['w']
        if positions is None:
            positions = torch.arange(input_ids.shape[1],
                                     device=input_ids.device)[None, :]
        e = e + table[torch.clamp(positions + cfg.learned_pos_offset, 0,
                                  table.shape[0] - 1)]
    if 'embed_layernorm' in params:
        p = params['embed_layernorm']
        e = layer_norm(e, p['w'], p.get('b'), cfg.rms_norm_eps)
    return e


def head_apply(params: Dict, cfg: LlamaConfig, x: torch.Tensor,
               qmap=None) -> torch.Tensor:
    """Final norm + lm_head -> float32 logits, with MiniCPM's logit
    divisor and the final softcap (Gemma2).  A packed head goes through
    the weight-only dequant-matmul of its bits with an f32 output; a tied
    model's head is packed as a copy of the embedding
    (``serve.packed.pack_head``), which the token lookup keeps reading."""
    h = norm_apply(cfg, x, params['norm'])
    if cfg.logit_divisor:
        h = (h.to(F32) / cfg.logit_divisor).to(h.dtype)
    head = params.get('lm_head')
    if head is not None and 'qweight' in head:
        from ..ops.dequant_matmul import dequant_matmul
        qc = qmap.get('lm_head') if qmap is not None else None
        if qc is None or qc.qmeta is None:
            raise ValueError('packed lm_head needs a qmap entry with QMeta')
        logits = dequant_matmul(h.to(cfg.tdtype), head['qweight'],
                                head['scales'], head.get('zeros'),
                                qc.qmeta, out_dtype=F32)
    else:
        w = (params['embed_tokens']['w'] if cfg.tie_word_embeddings
             else head['w'])
        logits = matmul_f32_acc(h, w)
        if cfg.tie_word_embeddings:
            head = None
    if head is not None and head.get('b') is not None:
        logits = logits + head['b'].to(F32)
    cap = cfg.final_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


def layer_window(cfg: LlamaConfig, layer: int) -> Optional[int]:
    """The sliding window of block ``layer``: Gemma2's even layers (HF's
    convention), else none."""
    return (cfg.sliding_window if cfg.sliding_window and layer % 2 == 0
            else None)


def model_apply(params: Dict, cfg: LlamaConfig, input_ids: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, qmap=None
                ) -> torch.Tensor:
    """Full forward to logits (no KV cache)."""
    B, S = input_ids.shape
    x = embed_apply(params, cfg, input_ids)
    cos, sin = rope_cos_sin(cfg, torch.arange(S, device=x.device)[None, :])
    for i, bp in enumerate(params['blocks']):
        x, _ = block_apply(bp, cfg, x, cos, sin, attn_bias, qmap,
                           window=layer_window(cfg, i))
    return head_apply(params, cfg, x)


# --------------------------------------------------------------------------
# Layout (the declarative get_subsets_in_block)
# --------------------------------------------------------------------------

def llama_layout(cfg: LlamaConfig) -> BlockLayout:
    gqa = cfg.num_key_value_heads != cfg.num_attention_heads
    # Gemma2's gate/up read the pre-ffn norm (its post-attention norm is
    # an output norm, no scaling prev_op); a shared-LN parallel block's
    # MLP reads the attention's norm
    ffn_ln = ('pre_feedforward_layernorm' if cfg.sandwich_norms
              else 'input_layernorm'
              if cfg.parallel_residual and cfg.shared_ln
              else 'post_attention_layernorm')
    mlp_layers = (('mlp.gate_proj', 'mlp.up_proj') if cfg.gated_mlp
                  else ('mlp.up_proj',))
    subsets = (
        SubsetSpec(name='qkv', layers=('self_attn.q_proj', 'self_attn.k_proj',
                                       'self_attn.v_proj'),
                   prev_op='input_layernorm', prev_kind='ln',
                   input_key='qkv_in', inspect='attn', has_kwargs=True),
        SubsetSpec(name='o', layers=('self_attn.o_proj',),
                   prev_op='self_attn.v_proj', prev_kind='fc',
                   input_key='o_in', inspect='o_proj', is_gqa=gqa),
        SubsetSpec(name='gate_up', layers=mlp_layers,
                   prev_op=ffn_ln, prev_kind='ln',
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
    if cfg.parallel_residual and cfg.shared_ln:
        lns = ('input_layernorm',)
    else:
        lns = ('input_layernorm', 'post_attention_layernorm')
    if cfg.sandwich_norms:
        lns += ('pre_feedforward_layernorm', 'post_feedforward_layernorm')
    return BlockLayout(subsets=subsets, linears=linears, layernorms=lns,
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

    def norm(self, n: int, bias: bool = False) -> Dict:
        """A norm's ones, with a zero bias for a LayerNorm."""
        p = self.ones(n)
        if bias:
            p['b'] = torch.zeros((n,), dtype=self.dtype, device=self.device)
        return p

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
                device=None, blocks: Optional[List] = None) -> Dict:
    """Random params drawn from ``generator`` (on ``device``; the
    generator must live on the same device), in the reference's tree:
    LayerNorms with zero biases under ``norm_type='ln'``, no gate where
    ``gated_mlp`` is off, Gemma2's sandwich norms, the learned position
    table, and a zero ``o_proj`` bias wherever ``attention_bias`` is on (as
    the reference builds it; HF's Qwen2 has none).  ``use_qk_norm`` gets
    its q/k norms of ones [head_dim], which the reference's random tree
    lacks (ROADMAP C); ``layer_scale`` gets its ``ls1`` / ``ls2`` of 0.1 and
    ``qk_norm_full`` its q / k norms of ones over the whole projection, as
    the reference draws them.  ``blocks``: the list each block is appended
    to as it is drawn (an offloaded model's ``HostBlocks``), a new list by
    default."""
    ini = Init(generator, dtype or cfg.tdtype, device)
    D, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    ln = cfg.norm_type == 'ln'
    blocks = [] if blocks is None else blocks
    for _ in range(cfg.num_hidden_layers):
        mlp = {'up_proj': ini.lin(I, D, cfg.mlp_bias),
               'down_proj': ini.lin(D, I, cfg.mlp_bias)}
        if cfg.gated_mlp:
            mlp['gate_proj'] = ini.lin(I, D, cfg.mlp_bias)
        blk = {'input_layernorm': ini.norm(D, ln),
               'self_attn': attention_init(ini, cfg, cfg.attention_bias,
                                           cfg.attention_bias),
               'mlp': mlp}
        if not (cfg.parallel_residual and cfg.shared_ln):
            blk['post_attention_layernorm'] = ini.norm(D, ln)
        if cfg.sandwich_norms:
            blk['pre_feedforward_layernorm'] = ini.norm(D, ln)
            blk['post_feedforward_layernorm'] = ini.norm(D, ln)
        if cfg.use_qk_norm:
            blk['self_attn']['q_norm'] = ini.ones(hd)
            blk['self_attn']['k_norm'] = ini.ones(hd)
        if cfg.layer_scale:
            blk['ls1'] = ini.ones(D)['w'] * 0.1
            blk['ls2'] = ini.ones(D)['w'] * 0.1
        if cfg.qk_norm_full:
            blk['self_attn']['q_norm'] = ini.ones(cfg.num_attention_heads * hd)
            blk['self_attn']['k_norm'] = ini.ones(cfg.num_key_value_heads * hd)
        blocks.append(blk)
    params = {'embed_tokens': ini.embed(cfg.vocab_size, D),
              'blocks': blocks, 'norm': ini.norm(D, ln)}
    if cfg.learned_pos:
        params['embed_positions'] = ini.embed(cfg.max_position_embeddings, D)
    if not cfg.tie_word_embeddings:
        params['lm_head'] = ini.lin(cfg.vocab_size, D)
    return params
