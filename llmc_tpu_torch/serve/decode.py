"""KV-cached prefill, greedy decode and the decode-time NLL (port of
``llmc_tpu/serve/decode.py``).

``forward_cached`` runs S tokens of every slot against the cache, one
Python loop over the layers.  Decode (S == 1) attention over the ``fp``
and symmetric ``naive`` caches goes through a hand-written kernel on the
card, chosen by ``ATTN_IMPL`` (read from ``LLMC_ATTN``, the reference's
switch):

- ``auto`` and ``flash``: ``ops.flash_decode.flash_decode_attention``;
- ``batch``: ``ops.batch_decode.batch_decode_attention``, the
  serving-batch kernel;
- ``chunked``: the reference's chunked read (``_decode_attn_chunked``, an
  online softmax over the chunks up to the largest position, in torch
  ops; the reference has no TPU kernel for it), on both devices;
- ``full``: the plain masked read over the whole cache (``_attend_cached``),
  on both devices.

A decode step takes a kernel or the chunked read only where the
reference's ``attn_ok`` lets it (decode.py:272-274,
``kernel_takes_attention``): one token on an ``fp`` or ``naive`` cache, in
a graph without ALiBi (Bloom, Falcon-RW), an attention softcap or a
sliding window (Gemma2).  Every other step reads the cache by the plain
masked read, which carries those options, on both devices: the ``kivi``
and ``sink`` caches too, KIVI's fp residual spliced in by ``policy.read``
and Sink's row-dependent mask applied there for every S.

The paged pool (``serve/paged_cache.py::PagedKVPolicy``) is a decode-step
cache, as in the reference (decode.py:259-266): a step writes its token
into the slot's page and reads the pool by ``decode_attn_paged``, the
reference's XLA loop in torch ops on both devices (no TPU kernel backs
it); prefill runs on a dense local cache (``ServingEngine``).

The asymmetric int8 cache (``k_z`` in the cache) has no kernel in the
reference either: its decode step takes the chunked read under
``chunked`` (which dequantizes its codes) and the plain masked read that
prefill uses otherwise, on both devices.  Prefill (S > 1)
keeps the reference's plain masked attention (decode.py:319-363): the
block writes its K/V first and then attends over what the policy reads
back, so with an int8 cache prefill sees the dequantized codes it just
wrote, as the reference does.  The reference's XLA scheduling machinery
(``_pick_attn``'s scan / unroll table, ``BATCH_MIN_B``,
``prefer_unroll``, scan stacking) has no counterpart here: it chose
between XLA programs, and the port has one eager loop.

``decode_nll`` feeds a sequence one token a step through
``forward_cached`` (the decode-PPL inner loop): the reference's one
``lax.scan`` is one eager loop here.  ``decode_logits`` keeps every step's
logits of the same loop, which the tests and the chip check hold against a
prefill's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import deepseek as DS
from ..models import llama as L
from ..models import mixtral as MX
from ..models import qwen2moe as QM
from ..models.base import linear_apply
from ..ops.batch_decode import batch_decode_attention
from ..ops.flash_decode import flash_decode_attention, online_softmax_step
from ..utils.device import check_on, resolve_device
from .kvcache import KVCachePolicy, _per_slot

F32 = torch.float32
FP_POLICY = KVCachePolicy(method='fp')
# auto | flash | batch | chunked | full (module-level, as in the reference)
ATTN_IMPL = os.environ.get('LLMC_ATTN', 'auto')
_DECODE_KERNELS = {'auto': flash_decode_attention,
                   'flash': flash_decode_attention,
                   'batch': batch_decode_attention}
_READS = ('chunked', 'full')
_CHUNK_OPTS = (512, 256, 128, 64, 32)


def _decode_kernel():
    """The decode-attention function ``ATTN_IMPL`` names."""
    if ATTN_IMPL in _DECODE_KERNELS:
        return _DECODE_KERNELS[ATTN_IMPL]
    raise ValueError(f'LLMC_ATTN={ATTN_IMPL!r}: want auto, flash, batch, '
                     f'chunked or full')


def _chunk_for(smax: int) -> Optional[int]:
    """The chunked read's chunk: the largest of ``_CHUNK_OPTS`` that
    divides the cache into at least two chunks (or the whole of a cache
    of at most 32), else None (the full read), as in the reference."""
    for c in _CHUNK_OPTS:
        if smax % c == 0 and (c < smax or smax <= 32):
            return c
    return None


def _decode_attn_chunked(q, cache, layer: int, policy: KVCachePolicy, cfg,
                         chunk: int, n_chunks: Optional[int] = None
                         ) -> torch.Tensor:
    """The reference's chunked read (decode.py:107-207) in torch ops: an
    online softmax over the cache's chunks up to the largest position, on
    the ``fp`` and ``naive`` caches.  q [B, 1, H, hd] f32, pre-scaled ->
    ctx [B, 1, H, hd] f32.  Symmetric int8 codes enter the dot as they are,
    their K scale folded into the scores and their V scale into the
    probabilities; asymmetric codes are dequantized first.  Query heads
    group by their kv head.  ``n_chunks``: the chunks read from the start
    of the buffer.  By default, eagerly, the loop stops at the chunk of
    the largest position; while a CUDA graph captures it (no host read of
    the positions there) it runs every chunk, whose masked tail adds
    exactly nothing, as the reference's unrolled loop does."""
    B, _, H, hd = q.shape
    KVH = cfg.num_key_value_heads
    G = H // KVH
    pos = cache['pos']
    pos = (pos.to(torch.long) if _per_slot(pos) else
           torch.full((B,), int(pos), dtype=torch.long, device=q.device))
    fp = policy.method == 'fp'
    kbuf, vbuf = (cache['k'], cache['v']) if fp else (cache['k_q'],
                                                      cache['v_q'])
    smax = kbuf.shape[2]
    if n_chunks is None:
        n_chunks = (smax // chunk if q.is_cuda
                    and torch.cuda.is_current_stream_capturing()
                    else -(-(int(pos.max()) + 1) // chunk))
    qg = q[:, 0].reshape(B, KVH, G, hd).to(F32)

    def read(buf, sname, zname, off):
        c = buf[layer, :, off:off + chunk]               # [B, C, KVH, hd]
        if fp:
            return c, None
        s = cache[sname][layer, :, off:off + chunk]      # [B, C, KVH]
        if zname not in cache:
            return c, s
        z = cache[zname][layer, :, off:off + chunk]
        return (c.to(F32) - z[..., None]) * s[..., None], None

    carry = (torch.full((B, KVH, G), float('-inf'), dtype=F32,
                        device=q.device),
             torch.zeros((B, KVH, G), dtype=F32, device=q.device),
             torch.zeros((B, KVH, G, hd), dtype=F32, device=q.device))
    for it in range(n_chunks):
        off = it * chunk
        k_c, k_sc = read(kbuf, 'k_s', 'k_z', off)
        v_c, v_sc = read(vbuf, 'v_s', 'v_z', off)
        carry = online_softmax_step(
            qg, k_c, v_c, k_sc, v_sc,
            off + torch.arange(chunk, device=q.device), pos, carry)
    _, l, acc = carry
    ctx = acc / torch.clamp(l[..., None], min=1e-30)
    return ctx.reshape(B, 1, H, hd)


def _attend_cached(q, cache, layer: int, policy: KVCachePolicy, cfg,
                   x_dtype) -> torch.Tensor:
    """Plain masked attention over the whole cache buffer (prefill, the
    ``full`` read, and every decode step no kernel takes): the config's
    query scale, attention softcap and ALiBi, the causal mask from each
    slot's position, Gemma2's window on even layers and Sink's
    row-dependent window.  q [B, S, H, hd] -> ctx [B, S, H, hd] in
    ``x_dtype``."""
    B, S, H, hd = q.shape
    KVH = cfg.num_key_value_heads
    k_full, v_full = policy.read(cache, layer, x_dtype)
    if KVH != H:
        k_full = torch.repeat_interleave(k_full, H // KVH, dim=2)
        v_full = torch.repeat_interleave(v_full, H // KVH, dim=2)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32),
                          k_full.to(F32)) * L.attn_scale(cfg)
    cap = cfg.attn_logit_softcap
    if cap:
        scores = cap * torch.tanh(scores / cap)
    smax = k_full.shape[1]
    if cfg.use_alibi:
        scores = scores + L.alibi_bias(cfg, smax, q.device)
    kv_idx = torch.arange(smax, device=q.device)
    pos = cache['pos']
    s_idx = torch.arange(S, device=q.device)
    if _per_slot(pos):
        q_idx = pos.to(torch.long)[:, None, None] + s_idx[None, :, None]
    else:
        q_idx = int(pos) + s_idx[:, None]
    valid = kv_idx <= q_idx                     # [B, S, Smax] or [S, Smax]
    window = L.layer_window(cfg, layer)
    if window is not None:
        valid = valid & (q_idx - kv_idx < window)
    # sink: each query row sees the sinks and its own recent window
    sink = policy.attention_mask_offset(q_idx + 1, smax)
    if sink is not None:
        valid = valid & sink
    valid = valid[:, None] if _per_slot(pos) else valid[None, None]
    scores = scores.masked_fill(~valid, float('-inf'))
    probs = torch.softmax(scores, dim=-1).to(x_dtype)
    return torch.einsum('bhqk,bkhd->bqhd', probs.to(F32),
                        v_full.to(F32)).to(x_dtype)


def kernel_takes_attention(cfg, S: int, policy) -> bool:
    """Whether a decode step's attention may take a kernel or the chunked
    read (the reference's ``attn_ok``, decode.py:272-274): one token on an
    ``fp`` or ``naive`` cache, and no ALiBi, softcap or sliding window in
    the graph."""
    return (S == 1 and policy.method in ('fp', 'naive')
            and not cfg.use_alibi and not cfg.attn_logit_softcap
            and not cfg.sliding_window)


def _block_cached(bp, cfg, x, cos, sin, cache, layer: int,
                  policy: KVCachePolicy, qmap=None):
    """One decoder block with cache write and read, on the generalized
    graph (the reference's decode.py:210-366): the config's norms, q/k
    norm, partial / interleaved rope, and the attention read
    ``ATTN_IMPL`` and ``kernel_takes_attention`` pick."""
    B, S, _ = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    # an unknown LLMC_ATTN raises on every path
    attend = None if ATTN_IMPL in _READS else _decode_kernel()
    h = L.norm_apply(cfg, x, bp['input_layernorm'])
    p = bp['self_attn']

    def qc(path):
        return qmap.get(path) if qmap is not None else None
    q, k, v = L.qkv_project(p, cfg, h, qmap)
    q, k = L.rope_qk(cfg, q, k, cos, sin)
    paged = policy.method == 'paged'
    if paged and S != 1:
        raise ValueError('the paged pool is a decode-step cache: prefill '
                         'runs on a dense local cache (ServingEngine)')
    cache = policy.update(cache, layer, k, v)
    scale = L.attn_scale(cfg)
    ok = kernel_takes_attention(cfg, S, policy)
    chunk = ok and _chunk_for(cache['k' if policy.method == 'fp'
                                    else 'k_q'].shape[2])
    if paged:
        if cfg.use_alibi or cfg.attn_logit_softcap or cfg.sliding_window:
            raise NotImplementedError(
                'the paged pool\'s read has no ALiBi, softcap or sliding '
                'window: the reference\'s drops them silently (ROADMAP C)')
        from .paged_cache import decode_attn_paged
        ctx = decode_attn_paged(q.to(F32) * scale, cache, layer, policy,
                                cfg).to(x.dtype)
    elif ok and ATTN_IMPL == 'chunked' and chunk:
        ctx = _decode_attn_chunked(q.to(F32) * scale, cache, layer, policy,
                                   cfg, chunk).to(x.dtype)
    elif ok and attend is not None and 'k_z' not in cache:
        fp = policy.method == 'fp'
        pos = cache['pos']
        pos_b = (pos.to(torch.int32) if _per_slot(pos) else
                 torch.full((B,), int(pos), dtype=torch.int32,
                            device=x.device))
        ctx = attend(
            q[:, 0].to(F32) * scale,
            cache['k'] if fp else cache['k_q'],
            cache['v'] if fp else cache['v_q'],
            None if fp else cache['k_s'], None if fp else cache['v_s'],
            pos_b, layer).reshape(B, 1, H, hd).to(x.dtype)
    else:
        ctx = _attend_cached(q, cache, layer, policy, cfg, x.dtype)
    attn_out = linear_apply(p['o_proj'], ctx.reshape(B, S, H * hd),
                            qc('self_attn.o_proj'))
    return _finish_block(bp, cfg, x, h, attn_out, qc, qmap), cache


def moe_of(bp):
    """(the family's ``moe_apply``, its params) where the block's MLP is
    an MoE (the reference's cached-decode branch, decode.py:385-395),
    else None: Mixtral's ``block_sparse_moe``, Qwen2-MoE's experts with a
    shared expert, DeepSeek's with shared experts."""
    if 'block_sparse_moe' in bp:
        return MX.moe_apply, bp['block_sparse_moe']
    mp = bp['mlp']
    if 'experts' not in mp:
        return None
    return (QM if 'shared_expert' in mp else DS).moe_apply, mp


def _finish_block(bp, cfg, x, h, attn_out, qc, qmap):
    """Post-attention residual + MLP tail of the decoder block (the
    reference's decode.py:369-420): the parallel residual off ``h`` (or
    the post-attention norm), Gemma2's sandwich norms, MiniCPM's residual
    multiplier.  An MoE block's routed MLP is a [B, S, D] -> [B, S, D]
    operator like the dense one (dense dispatch, as in the reference)."""
    rm = cfg.residual_multiplier or 1.0

    def mlp(h_in):
        moe = moe_of(bp)
        if moe is not None:
            return moe[0](moe[1], cfg, h_in, qmap)[0]
        return L.mlp_apply(bp['mlp'], h_in, qmap, act=cfg.act_fn)[0]

    if cfg.parallel_residual:
        h2 = h if cfg.shared_ln else L.norm_apply(
            cfg, x, bp['post_attention_layernorm'])
        return x + attn_out + mlp(h2)
    if cfg.sandwich_norms:
        x = x + L.norm_apply(cfg, attn_out, bp['post_attention_layernorm'])
        h = L.norm_apply(cfg, x, bp['pre_feedforward_layernorm'])
    else:
        x = x + attn_out * rm
        h = L.norm_apply(cfg, x, bp['post_attention_layernorm'])
    mlp_out = mlp(h)
    if cfg.sandwich_norms:
        mlp_out = L.norm_apply(cfg, mlp_out, bp['post_feedforward_layernorm'])
    return x + mlp_out * rm


def forward_cached(params, cfg, ids, cache: Dict, policy: KVCachePolicy,
                   qmap=None, last_only: bool = False, input_embeds=None):
    """Run ``ids`` [B, S] against the cache; returns (logits, cache) with
    the cache's buffers written in place and ``pos`` advanced by S.
    ``last_only`` projects just the final position through the lm_head.
    ``input_embeds`` [B, S, D] takes the token embedding's place (``ids``
    may be None): the VLM prefill's merged multimodal embeddings."""
    ref = ids if input_embeds is None else input_embeds
    S = ref.shape[1]
    pos0 = cache['pos']
    s_idx = torch.arange(S, device=ref.device)
    if _per_slot(pos0):
        positions = pos0.to(torch.long)[:, None] + s_idx[None, :]
    else:
        positions = int(pos0) + s_idx[None, :]
    x = (input_embeds if input_embeds is not None
         else L.embed_apply(params, cfg, ids, positions=positions))
    cos, sin = L.rope_cos_sin(cfg, positions)
    for layer, bp in enumerate(params['blocks']):
        x, cache = _block_cached(bp, cfg, x, cos, sin, cache, layer, policy,
                                 qmap)
    cache = dict(cache, pos=pos0 + S)
    if last_only:
        x = x[:, -1:]
    return L.head_apply(params, cfg, x, qmap=qmap), cache


def init_cache(model, batch: int, max_len: int,
               policy: KVCachePolicy = FP_POLICY, device=None) -> Dict:
    cfg = model.cfg
    return policy.init_cache(batch, max_len, cfg.num_key_value_heads,
                             cfg.head_dim, cfg.num_hidden_layers,
                             dtype=cfg.tdtype, device=device)


def _ids_on(ids, dev) -> torch.Tensor:
    """Token ids (a tensor or an array) as int64 on ``dev``."""
    t = ids if isinstance(ids, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(ids))
    return t.to(device=dev, dtype=torch.long)


def _decode_steps(model, ids: torch.Tensor, qmap, policy: KVCachePolicy,
                  fed: int, dev):
    """Feed ``ids[:, t]`` for t < ``fed``, one token a step through a
    cache ``ids.shape[1]`` long; yields each step's logits [B, V]."""
    cache = init_cache(model, ids.shape[0], ids.shape[1], policy, device=dev)
    for t in range(fed):
        logits, cache = forward_cached(model.params, model.cfg,
                                       ids[:, t:t + 1], cache, policy, qmap)
        yield logits[:, -1]


@torch.no_grad()
def decode_nll(model, ids, qmap=None,
               kv_policy: Optional[KVCachePolicy] = None,
               n_valid: Optional[int] = None, labels=None, score_mask=None,
               device=None) -> Tuple[torch.Tensor, int]:
    """Token-by-token NLL through the KV cache (the decode-PPL inner
    loop), the cache ``ids.shape[1]`` long: (the summed f32 NLL, the count
    of scored tokens).

    By default feeding ``ids[:, j]`` is scored against ``ids[:, j + 1]``
    for j < ``n_valid`` - 1 (the last fed token predicts nothing).
    ``labels`` / ``score_mask`` generalize that: the step that feeds
    ``ids[:, j]`` is scored against ``labels[:, j]`` iff
    ``score_mask[j]``, and every token is fed (the raw-text protocol,
    whose cache persists across texts)."""
    dev = resolve_device(device)
    check_on(model.params, dev, 'the model')
    ids = _ids_on(ids, dev)
    B, S = ids.shape
    if labels is None:
        labels = torch.cat([ids[:, 1:], ids[:, -1:]], dim=1)
        nv = S if n_valid is None else int(n_valid)
        mask = np.arange(S) < nv - 1
        fed = S - 1
    else:
        if score_mask is None:
            raise ValueError('decode_nll: labels need a score_mask')
        labels = _ids_on(labels, dev)
        mask = np.asarray(score_mask, bool)
        fed = S
    nll = torch.zeros((), dtype=F32, device=dev)
    for t, logits in enumerate(_decode_steps(model, ids, qmap,
                                             kv_policy or FP_POLICY, fed,
                                             dev)):
        if mask[t]:
            lp = torch.log_softmax(logits.to(F32), dim=-1)
            nll = nll - torch.gather(lp, -1, labels[:, t:t + 1]).sum()
    return nll, int(mask.sum()) * B


@torch.no_grad()
def decode_logits(model, ids, qmap=None,
                  kv_policy: Optional[KVCachePolicy] = None,
                  device=None) -> torch.Tensor:
    """The f32 logits [B, S, V] of ``ids`` [B, S] fed one token a step
    through the KV cache: row t is what the step that feeds ``ids[:, t]``
    predicts, the decode counterpart of one prefill's logits."""
    dev = resolve_device(device)
    check_on(model.params, dev, 'the model')
    ids = _ids_on(ids, dev)
    return torch.stack([row.to(F32) for row in _decode_steps(
        model, ids, qmap, kv_policy or FP_POLICY, ids.shape[1], dev)], 1)


@torch.no_grad()
def greedy_generate(model, prompt_ids: torch.Tensor, max_new_tokens: int,
                    qmap=None, kv_policy: Optional[KVCachePolicy] = None,
                    device=None) -> torch.Tensor:
    """Prefill + greedy decode; returns [B, prompt + new] token ids."""
    dev = resolve_device(device)
    check_on(model.params, dev, 'the model')
    policy = kv_policy or FP_POLICY
    cfg = model.cfg
    ids = torch.as_tensor(prompt_ids, device=dev).to(torch.long)
    B, P = ids.shape
    cache = init_cache(model, B, P + max_new_tokens, policy, device=dev)
    logits, cache = forward_cached(model.params, cfg, ids, cache, policy,
                                   qmap)
    tok = logits[:, -1].argmax(-1)
    out = [ids, tok[:, None]]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_cached(model.params, cfg, tok[:, None],
                                       cache, policy, qmap)
        tok = logits[:, -1].argmax(-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


@torch.no_grad()
def vlm_greedy_generate(model, input_ids, max_new_tokens: int, qmap=None,
                        kv_policy: Optional[KVCachePolicy] = None,
                        token_reduction: Optional[dict] = None,
                        timings: Optional[dict] = None,
                        graph: Optional[bool] = None, device=None,
                        **img_kwargs) -> torch.Tensor:
    """KV-cached greedy generation of a VLM: one multimodal prefill (the
    tower, the projector and the merged embeddings, a tower-side reduction
    applied; ``model.prefill_embeds``) through ``forward_cached``, then
    one token a step through the LM's cache.  An LM-side reduction raises
    ``NotImplementedError``: it prunes inside the eager forward.  Returns
    [B, S' + new] ids, S' the prompt after any reduction; ``timings``
    gets ``embeds_s`` (the tower, the projector and the merge),
    ``prefill_s`` (the LM's prefill), ``decode_first_s`` (the first decode
    step: on the card its eager run and its capture) and ``decode_s`` (every
    decode step), each ended by a device synchronise.

    The decode steps read the slots' positions from a tensor, so one step
    serves every position: on a CUDA device (or where ``graph``) the step
    is one captured CUDA graph (``serve/graphs.py::CapturedStep``; its
    first call runs eagerly, the others replay), on the CPU it runs
    eagerly; the tokens are the same either way."""
    import time
    from .graphs import CapturedStep
    dev = resolve_device(device)
    check_on(model.params, dev, 'the model')
    policy = kv_policy or FP_POLICY
    t_e = time.perf_counter()
    embeds, ids = model.prefill_embeds(
        _ids_on(input_ids, dev), qmap=qmap, token_reduction=token_reduction,
        **img_kwargs)
    _sync(dev)
    cfg, params = model.lm_cfg, model.params
    B, P = ids.shape
    cache = policy.init_cache(B, P + max_new_tokens, cfg.num_key_value_heads,
                              cfg.head_dim, cfg.num_hidden_layers,
                              dtype=cfg.tdtype, device=dev)
    t0 = time.perf_counter()
    logits, cache = forward_cached(params, cfg, None, cache, policy, qmap,
                                   last_only=True, input_embeds=embeds)
    tok = logits[:, -1].argmax(-1)
    _sync(dev)
    t1 = time.perf_counter()
    out = [ids, tok[:, None]]
    if max_new_tokens > 1:
        # per-slot positions (the KIVI ring takes lockstep ones only)
        if policy.method != 'kivi':
            cache['pos'] = torch.full((B,), P, dtype=torch.int32, device=dev)
        cur = tok.clone()

        def step():
            lg, nxt_cache = forward_cached(params, cfg, cur[:, None], cache,
                                           policy, qmap)
            nxt = lg[:, -1].argmax(-1)
            if _per_slot(cache['pos']):
                cache['pos'].copy_(nxt_cache['pos'])
            else:
                cache['pos'] = nxt_cache['pos']
            cur.copy_(nxt)
            return nxt
        graphed = dev.type == 'cuda' if graph is None else graph
        run = CapturedStep(step, dev) if graphed else step
        for i in range(max_new_tokens - 1):
            out.append(run().clone()[:, None])
            if i == 0:
                _sync(dev)
                t2 = time.perf_counter()
        _sync(dev)
    if timings is not None:
        t3 = time.perf_counter()
        timings.update(embeds_s=t0 - t_e, prefill_s=t1 - t0,
                       decode_first_s=(t2 - t1) if max_new_tokens > 1
                       else 0.0, decode_s=t3 - t1)
    return torch.cat(out, dim=1)
