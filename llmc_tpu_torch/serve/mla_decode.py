"""DeepSeek MLA cached decode with the absorbed latent cache (port of
``llmc_tpu/serve/mla_decode.py``).

The cache holds the normed latent ``c_kv`` [dc] and the shared roped key
``k_pe`` [dr] of each token, not H heads of K and V.  At decode the
up-projections are absorbed into the attention:

    k_nope[h] = W_uk[h] @ c_kv   =>  q_nope . k_nope = (q_nope W_uk) . c_kv
    v[h]      = W_uv[h] @ c_kv   =>  ctx . v         = (probs . c_kv) W_uv

so the scores and the context are taken against the latent directly.  A
quantized latent cache (``quant_bit``) stores integer codes in int8 and
one f32 scale a token (``_quant_latent``); the scale folds into the scores
after the dot and into the probabilities, as the per-head int8 read does.
``k_pe`` stays in the model's type.

The single-token step reads the cache by an online softmax over chunks
(``_mla_decode_attn_chunked``).  The reference loops over the chunks of
the valid prefix, a trip count that depends on the positions; here the
loop runs over every chunk of the buffer, so that a captured CUDA graph
(``serve/graphs.py``) can replay it.  A chunk past every slot's position
leaves the running max, sum and context as they were, bit for bit (its
scores are -inf: the correction is exp(0) = 1 and the probabilities 0),
so the fixed loop gives the valid-prefix loop's bits.  The read is torch
ops on both devices, as the reference's is XLA: no TPU kernel backs it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models import deepseek as DS
from ..models.base import linear_apply, matmul_f32_acc, rms_norm
from ..utils.device import check_on, resolve_device
from .decode import _chunk_for
from .kvcache import _per_slot, _upd

F32 = torch.float32


def init_mla_cache(cfg: DS.DeepseekConfig, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None,
                   quant_bit: Optional[int] = None, device=None) -> Dict:
    """The latent cache [L, B, max_len, ...] (``ckv`` in the model's type,
    or ``ckv_q`` int8 codes and ``ckv_s`` [L, B, max_len] f32 scales under
    ``quant_bit``), ``kpe``, and ``pos`` 0."""
    dev = resolve_device(device)
    dtype = dtype or cfg.tdtype
    shape = (cfg.num_hidden_layers, batch, max_len)
    cache = {'kpe': torch.zeros(shape + (cfg.qk_rope_head_dim,),
                                dtype=dtype, device=dev), 'pos': 0}
    if quant_bit:
        cache['ckv_q'] = torch.zeros(shape + (cfg.kv_lora_rank,),
                                     dtype=torch.int8, device=dev)
        cache['ckv_s'] = torch.zeros(shape, dtype=F32, device=dev)
    else:
        cache['ckv'] = torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dtype,
                                   device=dev)
    return cache


def _quant_latent(lat: torch.Tensor, bit: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric codes over the latent dim: [..., dc] -> (int8
    codes [..., dc], f32 scale [...]).  The reference quantizes inside its
    jitted steps, where XLA folds ``amax / qmax`` into a multiply by the
    f32 reciprocal of qmax: the scale is computed so; ``lat / s`` stays a
    true division."""
    qmax = 2 ** (bit - 1) - 1
    lf = lat.to(F32)
    amax = torch.clamp(lf.abs().amax(-1), min=1e-5)
    s = amax * (1.0 / qmax)
    q = torch.clamp(torch.round(lf / s[..., None]), -qmax - 1, qmax)
    return q.to(torch.int8), s


def _mla_decode_attn_chunked(q_lat: torch.Tensor, q_pe: torch.Tensor,
                             cache: Dict, layer: int, chunk: int,
                             n_chunks: Optional[int] = None) -> torch.Tensor:
    """The online-softmax read of the latent cache for ONE decode token.
    q_lat [B, H, dc], q_pe [B, H, dr], both f32 and already multiplied by
    the attention scale.  Returns ctx_lat [B, H, dc] f32.  ``n_chunks``:
    the chunks read from the start of the buffer, every chunk by default
    (the reference reads ceil((max(pos) + 1) / chunk); the chunks past it
    change nothing)."""
    B, H, dc = q_lat.shape
    quant = 'ckv_q' in cache
    cbuf = cache['ckv_q'] if quant else cache['ckv']
    kpe = cache['kpe']
    pos = cache['pos']
    pos = (pos.to(torch.long) if _per_slot(pos) else
           torch.full((B,), int(pos), dtype=torch.long, device=q_lat.device))
    if n_chunks is None:
        n_chunks = cbuf.shape[2] // chunk
    m = torch.full((B, H), float('-inf'), dtype=F32, device=q_lat.device)
    l = torch.zeros((B, H), dtype=F32, device=q_lat.device)
    acc = torch.zeros((B, H, dc), dtype=F32, device=q_lat.device)
    for it in range(n_chunks):
        off = it * chunk
        c_c = cbuf[layer, :, off:off + chunk].to(F32)           # [B,k,dc]
        kpe_c = kpe[layer, :, off:off + chunk].to(F32)          # [B,k,dr]
        s = torch.einsum('bhc,bkc->bhk', q_lat, c_c)
        if quant:
            s_c = cache['ckv_s'][layer, :, off:off + chunk]     # [B,k]
            s = s * s_c[:, None, :]
        s = s + torch.einsum('bhr,bkr->bhk', q_pe, kpe_c)
        idx = off + torch.arange(chunk, device=q_lat.device)
        s = s.masked_fill(~(idx[None, None, :] <= pos[:, None, None]),
                          float('-inf'))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        if quant:
            p = p * s_c[:, None, :]
        acc = acc * corr[..., None] + torch.einsum('bhk,bkc->bhc', p, c_c)
        m = m_new
    return acc / torch.clamp(l[..., None], min=1e-30)


def _mla_block_cached(bp: Dict, cfg: DS.DeepseekConfig, x, cos, sin,
                      cache: Dict, layer: int, qmap=None,
                      latent_bit: int = 8):
    """One block against the latent cache: its latent and rope key are
    written at ``cache['pos']`` (an int for lockstep slots, an int32 [B]
    tensor of per-slot positions), then attended through the absorbed
    ``W_uk`` / ``W_uv``.  Returns (y, cache), the buffers written in
    place."""
    B, S, _ = x.shape
    H = cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dc = cfg.kv_lora_rank
    p = bp['self_attn']
    h = rms_norm(x, bp['input_layernorm']['w'], cfg.rms_norm_eps)
    q = DS.mla_project_q(p, cfg, h, qmap)
    q_nope = q[..., :dn]
    q_pe = DS.apply_rope_interleaved(q[..., dn:], cos, sin)
    kv_an, k_pe = DS.mla_project_kv_a(p, cfg, h, qmap)
    k_pe = DS.apply_rope_interleaved(k_pe.reshape(B, S, 1, dr), cos,
                                     sin).reshape(B, S, dr)
    pos = cache['pos']
    quant = 'ckv_q' in cache
    if quant:
        codes, scale = _quant_latent(kv_an, bit=latent_bit)
        _upd(cache['ckv_q'], layer, pos, codes)
        _upd(cache['ckv_s'], layer, pos, scale)
    else:
        _upd(cache['ckv'], layer, pos, kv_an)
    _upd(cache['kpe'], layer, pos, k_pe)

    # the absorbed attention: W_uk / W_uv from kv_b_proj [H*(dn+dv), dc]
    # (a kv_b bias would break the absorption; DeepSeek has none)
    if p['kv_b_proj'].get('b') is not None:
        raise ValueError('the absorbed MLA decode needs a bias-free '
                         'kv_b_proj')
    wkv = p['kv_b_proj']['w'].reshape(H, dn + dv, dc)
    w_uk, w_uv = wkv[:, :dn, :].to(F32), wkv[:, dn:, :].to(F32)
    q_lat = torch.einsum('bshd,hdc->bshc', q_nope.to(F32), w_uk)
    scale = (dn + dr) ** -0.5
    kpe_full = cache['kpe'][layer]
    smax = kpe_full.shape[1]
    chunk = _chunk_for(smax)
    if S == 1 and chunk is not None:
        ctx_lat = _mla_decode_attn_chunked(
            q_lat[:, 0] * scale, q_pe[:, 0].to(F32) * scale, cache, layer,
            chunk)[:, None]                                     # [B,1,H,dc]
    else:
        if quant:
            ckv_full = (cache['ckv_q'][layer].to(F32)
                        * cache['ckv_s'][layer][..., None]).to(x.dtype)
        else:
            ckv_full = cache['ckv'][layer]
        ckv_f = ckv_full.to(F32)
        scores = (torch.einsum('bshc,bkc->bhsk', q_lat, ckv_f)
                  + torch.einsum('bshr,bkr->bhsk', q_pe.to(F32),
                                 kpe_full.to(F32))) * scale
        kv_idx = torch.arange(smax, device=x.device)
        s_idx = torch.arange(S, device=x.device)
        if _per_slot(pos):
            q_idx = pos.to(torch.long)[:, None, None] + s_idx[None, :, None]
            valid = (kv_idx[None, None, :] <= q_idx)[:, None]
        else:
            q_idx = int(pos) + s_idx[:, None]
            valid = (kv_idx[None, :] <= q_idx)[None, None]
        scores = scores.masked_fill(~valid, float('-inf'))
        probs = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum('bhsk,bkc->bshc', probs, ckv_f)  # [B,S,H,dc]
    ctx = torch.einsum('bshc,hdc->bshd', ctx_lat, w_uv).to(x.dtype)
    attn_out = linear_apply(p['o_proj'], ctx.reshape(B, S, H * dv),
                            qmap.get('self_attn.o_proj')
                            if qmap is not None else None)
    x = x + attn_out
    h = rms_norm(x, bp['post_attention_layernorm']['w'], cfg.rms_norm_eps)
    return x + DS.mlp_apply(bp, cfg, h, qmap)[0], cache


def mla_forward_cached(params: Dict, cfg: DS.DeepseekConfig, ids, cache: Dict,
                       qmap=None, latent_bit: int = 8,
                       last_only: bool = False):
    """Run ``ids`` [B, S] against the latent cache; returns (f32 logits,
    cache) with the buffers written in place and ``pos`` advanced by S.
    ``latent_bit``: the quantized latent's bits (the engine passes its KV
    policy's).  ``last_only`` projects just the final position through the
    lm_head."""
    S = ids.shape[1]
    x = params['embed_tokens']['w'][ids]
    pos0 = cache['pos']
    s_idx = torch.arange(S, device=ids.device)
    if _per_slot(pos0):
        positions = pos0.to(torch.long)[:, None] + s_idx[None, :]
    else:
        positions = int(pos0) + s_idx[None, :]
    cos, sin = DS.rope_freqs(cfg, positions)
    for layer, bp in enumerate(params['blocks']):
        x, cache = _mla_block_cached(bp, cfg, x, cos, sin, cache, layer, qmap,
                                     latent_bit=latent_bit)
    cache = dict(cache, pos=pos0 + S)
    if last_only:
        x = x[:, -1:]
    h = rms_norm(x, params['norm']['w'], cfg.rms_norm_eps)
    return matmul_f32_acc(h, params['lm_head']['w']), cache


@torch.no_grad()
def mla_greedy_generate(model, prompt_ids, max_new_tokens: int, qmap=None,
                        device=None) -> torch.Tensor:
    """Prefill and greedy decode of a DeepSeek adapter through an fp latent
    cache; returns [B, prompt + new] token ids."""
    dev = resolve_device(device)
    check_on(model.params, dev, 'the model')
    cfg = model.cfg
    ids = torch.as_tensor(prompt_ids, device=dev).to(torch.long)
    B, P = ids.shape
    cache = init_mla_cache(cfg, B, P + max_new_tokens, device=dev)
    logits, cache = mla_forward_cached(model.params, cfg, ids, cache, qmap)
    tok = logits[:, -1].argmax(-1)
    out = [ids, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        logits, cache = mla_forward_cached(model.params, cfg, tok[:, None],
                                           cache, qmap)
        tok = logits[:, -1].argmax(-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
