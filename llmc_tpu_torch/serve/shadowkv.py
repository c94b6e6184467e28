"""ShadowKV: long-context KV sparsification by SVD key landmarks (port of
``llmc_tpu/serve/shadowkv.py``, a measurement of accuracy only, as
upstream's).

- Prefill keeps a rank-r SVD of the unroped K of each layer, the mean of
  each chunk of roped K (its landmark), the values, and exact outlier
  chunks: those whose landmark represents their keys worst (the smallest
  minimum cosine similarity between the landmark and the chunk's keys,
  upstream's heuristic).  The local chunks (the most recent) are always
  attended and are never outliers.
- Each decode step scores the landmarks against the query, retrieves the
  top ``sparse_budget // chunk_size`` chunks of the rest, rebuilds their K
  from the SVD and ropes it at the retrieved positions, gathers their V,
  and attends over them, the outlier and local chunks, and a dense buffer
  of the generated tokens.

Batch 1 only, as in the reference.  Torch ops on both devices: no TPU
kernel backs it (the reference runs it as XLA in a jit).  On the card one
decode step, over static buffers (the fed token, its label, the position
and the generated row as device tensors), replays as one captured CUDA
graph (``serve/graphs.py::CapturedStep``), the counterpart of the
reference's jitted step; on the CPU it runs eagerly.  The top-k picks the
lower index among equal scores, as ``jax.lax.top_k`` does.

Departure: the reference writes the k-th generated token at row k of a
``max_gen``-row buffer, and JAX drops a write past the end without a word,
so a decode longer than ``max_gen`` is scored wrongly; the port raises
``ValueError`` instead (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import llama as L
from ..models.base import linear_apply, rms_norm, top_k
from ..utils.device import check_on

F32 = torch.float32


def _rot_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


@dataclasses.dataclass(frozen=True)
class ShadowKVPolicy:
    sparse_budget: int = 1024
    chunk_size: int = 8
    rank: int = 160
    outlier_chunk: int = 48
    local_chunk: int = 4
    max_gen: int = 256

    def _local(self, n_chunks: int) -> int:
        """The local (most recent) chunks: at most all but one."""
        return max(min(self.local_chunk, n_chunks - 1), 0)

    def init_from_prefill(self, cfg, k_unroped: List[torch.Tensor],
                          k_roped: List[torch.Tensor],
                          v: List[torch.Tensor]) -> Dict:
        """The sparse state from each layer's prefill K (before and after
        rope) and V, [1, S, KVH, hd] each; S is a multiple of
        ``chunk_size``."""
        ku, kr, vv = (torch.stack(t) for t in (k_unroped, k_roped, v))
        Lc, B, S, KVH, hd = ku.shape
        cs = self.chunk_size
        n_chunks = S // cs
        # rank-r SVD of each layer's unroped K, [1, S, KVH * hd]
        u, s, vt = torch.linalg.svd(ku.reshape(Lc, B, S, KVH * hd).to(F32),
                                    full_matrices=False)
        r = min(self.rank, u.shape[-1])
        U = u[..., :r]                                   # [L, 1, S, r]
        SV = (s[..., :r, None] * vt[..., :r, :]).reshape(
            Lc, B, r, KVH, hd).permute(0, 1, 3, 2, 4)     # [L, 1, KVH, r, hd]
        kc = kr.reshape(Lc, B, n_chunks, cs, KVH, hd)
        landmarks = kc.mean(dim=3).permute(0, 1, 3, 2, 4)  # [L,1,KVH,C,hd]
        # outliers: the chunks whose landmark is farthest (by the minimum
        # cosine similarity) from one of its keys
        kf = kc.to(F32)
        lmk = kc.mean(dim=3, keepdim=True).to(F32)
        num = torch.sum(kf * lmk, dim=-1)
        den = (torch.linalg.vector_norm(kf, dim=-1)
               * torch.linalg.vector_norm(lmk, dim=-1) + 1e-8)
        cos_min = (num / den).amin(dim=3).permute(0, 1, 3, 2)  # [L,B,KVH,C]
        loc = self._local(n_chunks)
        if loc:     # the local chunks are attended apart: never outliers
            cos_min[..., n_chunks - loc:] = float('inf')
        n_out = min(self.outlier_chunk, n_chunks - loc)
        out_idx = top_k(-cos_min, n_out)[1]             # [L, 1, KVH, n_out]
        dev = ku.device
        gen = torch.zeros((Lc, B, self.max_gen, KVH, hd), dtype=cfg.tdtype,
                          device=dev)
        # the next position and generated row, on the device: a captured
        # step advances them in place
        return {'U': U.to(cfg.tdtype), 'SV': SV.to(cfg.tdtype),
                'landmarks': landmarks, 'v_full': vv, 'out_idx': out_idx,
                'k_gen': gen, 'v_gen': gen.clone(),
                'pos': torch.full((1,), S, dtype=torch.long, device=dev),
                'gen': torch.zeros((1,), dtype=torch.long, device=dev)}

    def retrieve(self, cfg, state: Dict, layer: int, q: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q [1, 1, H, hd] -> (k_sel, v_sel, positions) [1, KVH, n, hd]
        (positions [1, KVH, n]): the retrieved, outlier and local chunks'
        tokens, in that order."""
        B = 1
        KVH, hd, H = (cfg.num_key_value_heads, cfg.head_dim,
                      cfg.num_attention_heads)
        cs = self.chunk_size
        dev = q.device
        lm = state['landmarks'][layer]                   # [1, KVH, C, hd]
        n_chunks = lm.shape[2]
        qv = q.reshape(B, 1, KVH, H // KVH, hd).permute(0, 2, 3, 1, 4)
        attn = torch.einsum('bkgqd,bkcd->bkgqc', qv.to(F32),
                            lm.to(F32)) / (128.0 ** 0.5)
        attn = torch.softmax(attn, dim=-1).sum(dim=3).amax(dim=2)  # [1,KVH,C]
        # the outlier and local chunks are attended exactly: none is
        # retrieved a second time
        out_idx = state['out_idx'][layer]                 # [1, KVH, n_out]
        excl = torch.zeros(attn.shape, dtype=torch.bool, device=dev)
        excl.scatter_(-1, out_idx, True)
        loc = self._local(n_chunks)
        local_ids = n_chunks - 1 - torch.arange(loc, device=dev)
        excl.index_fill_(-1, local_ids, True)
        attn = attn.masked_fill(excl, float('-inf'))
        n_sel = min(self.sparse_budget // cs,
                    n_chunks - out_idx.shape[-1] - loc)
        local = local_ids[None, None, :].expand(B, KVH, loc)
        parts = [out_idx, local]
        if n_sel > 0:
            parts.insert(0, top_k(attn, n_sel)[1])
        chunks = torch.cat(parts, dim=-1)
        pos = (chunks[..., None] * cs + torch.arange(cs, device=dev)
               ).reshape(B, KVH, -1)                       # [1, KVH, n]
        # K rebuilt from the SVD at those positions, roped there
        U = state['U'][layer].to(F32)                      # [1, S, r]
        U_sel = torch.gather(U[:, None].expand(B, KVH, -1, -1), 2,
                             pos[..., None].expand(-1, -1, -1, U.shape[-1]))
        k_sel = torch.einsum('bknr,bkrd->bknd', U_sel,
                             state['SV'][layer].to(F32))
        cos, sin = L.rope_cos_sin(cfg, pos.reshape(B, -1))
        cos, sin = (t.reshape(B, KVH, -1, hd) for t in (cos, sin))
        k_sel = k_sel * cos + _rot_half(k_sel) * sin
        v_full = state['v_full'][layer].permute(0, 2, 1, 3)  # [1,KVH,S,hd]
        v_sel = torch.gather(v_full, 2, pos[..., None].expand(-1, -1, -1, hd))
        return k_sel.to(v_sel.dtype), v_sel, pos


def _decode_block(bp, cfg, x, cos, sin, state: Dict, layer: int,
                  policy: ShadowKVPolicy, valid_gen: torch.Tensor
                  ) -> torch.Tensor:
    """One Llama block of a decode step over the retrieved tokens and the
    generated ones (written at row ``state['gen']`` first; ``valid_gen``
    [max_gen] marks the rows written so far)."""
    B = 1
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    h = rms_norm(x, bp['input_layernorm']['w'], cfg.rms_norm_eps)
    p = bp['self_attn']
    q = linear_apply(p['q_proj'], h).reshape(B, 1, H, hd)
    k = linear_apply(p['k_proj'], h).reshape(B, 1, KVH, hd)
    v = linear_apply(p['v_proj'], h).reshape(B, 1, KVH, hd)
    q, k = L.apply_rope(q, k, cos, sin)
    state['k_gen'][layer].index_copy_(1, state['gen'],
                                      k.to(state['k_gen'].dtype))
    state['v_gen'][layer].index_copy_(1, state['gen'],
                                      v.to(state['v_gen'].dtype))
    k_sel, v_sel, _ = policy.retrieve(cfg, state, layer, q)
    k_all = torch.cat([k_sel, state['k_gen'][layer].permute(0, 2, 1, 3)], 2)
    v_all = torch.cat([v_sel, state['v_gen'][layer].permute(0, 2, 1, 3)], 2)
    qh = q.reshape(B, 1, KVH, H // KVH, hd)
    scores = torch.einsum('bqkgd,bknd->bkgqn', qh.to(F32),
                          k_all.to(F32)) / (hd ** 0.5)
    scores[..., k_sel.shape[2]:] = scores[..., k_sel.shape[2]:].masked_fill(
        ~valid_gen, float('-inf'))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum('bkgqn,bknd->bqkgd', probs, v_all.to(F32))
    x = x + linear_apply(p['o_proj'], ctx.reshape(B, 1, H * hd).to(x.dtype))
    h2 = rms_norm(x, bp['post_attention_layernorm']['w'], cfg.rms_norm_eps)
    return x + L.mlp_apply(bp['mlp'], h2)[0]


@torch.no_grad()
def shadowkv_decode_nll(model, ids, policy: ShadowKVPolicy
                        ) -> Tuple[float, int]:
    """Decode PPL under ShadowKV retrieval: (PPL, scored tokens).  The
    first half of ``ids`` [1, S] (chunk-aligned) is prefilled into the
    sparse state; each later token is decoded over the retrieved and the
    generated tokens and scored against the next.  On the model's device.
    Raises ``ValueError`` where the decode is longer than ``max_gen``,
    which the reference scores wrongly (it drops the writes past the
    buffer)."""
    cfg, params = model.cfg, model.params
    dev = model.device
    check_on(params, dev, 'the model')
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
    B, S = ids.shape
    if B != 1:
        raise ValueError('ShadowKV supports batch_size=1 (upstream '
                         'kvsparse.py:72)')
    cs = policy.chunk_size
    S_pre = (S // 2 // cs) * cs  # half prefill, half decode, chunk-aligned
    n_dec = S - 1 - S_pre
    if n_dec > policy.max_gen:
        raise ValueError(
            f'ShadowKV decodes {n_dec} tokens after a {S_pre}-token '
            f'prefill, past its max_gen={policy.max_gen} buffer: the '
            f'reference drops those writes silently (ROADMAP C); raise '
            f'max_gen')
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    # prefill: whole blocks, keeping each layer's K before and after rope
    x, kw = model.embed_and_rope_p(params, ids[:, :S_pre])
    bfn = model.block_fn()
    ku_l, kr_l, v_l = [], [], []
    for bp in params['blocks']:
        h = rms_norm(x, bp['input_layernorm']['w'], cfg.rms_norm_eps)
        k = linear_apply(bp['self_attn']['k_proj'], h).reshape(B, -1, KVH,
                                                               hd)
        v = linear_apply(bp['self_attn']['v_proj'], h).reshape(B, -1, KVH,
                                                               hd)
        ku_l.append(k)
        kr_l.append(L.apply_rope(k, k, kw['cos'], kw['sin'])[0])
        v_l.append(v)
        x, _ = bfn(bp, x, kw)
    state = policy.init_from_prefill(cfg, ku_l, kr_l, v_l)
    head = model.head_fn()
    logits = head(params, x)[:, -1]

    # one decode step over static buffers: feed ``tok``, score the next
    # token ``label``, summing the NLL on the device in float64 (as the
    # reference sums its floats on the host)
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    label = torch.zeros((1,), dtype=torch.long, device=dev)
    total = -torch.log_softmax(logits.to(F32), dim=-1)[0, ids[0, S_pre]].to(
        torch.float64)
    gen_rows = torch.arange(policy.max_gen, device=dev)

    def step():
        x = L.embed_apply(params, cfg, tok)
        cos, sin = L.rope_cos_sin(cfg, state['pos'].view(1, 1))
        valid_gen = gen_rows <= state['gen']
        for layer, bp in enumerate(params['blocks']):
            x = _decode_block(bp, cfg, x, cos, sin, state, layer, policy,
                              valid_gen)
        state['pos'] += 1
        state['gen'] += 1
        lp = torch.log_softmax(head(params, x)[:, -1].to(F32), dim=-1)
        total.sub_(lp[0, label].to(torch.float64).sum())

    if dev.type == 'cuda':
        from .graphs import CapturedStep
        step = CapturedStep(step, dev)
    for t in range(S_pre, S - 1):
        tok.copy_(ids[:, t:t + 1])
        label.copy_(ids[0, t + 1:t + 2])
        step()
    count = S - S_pre
    return float(np.exp(float(total) / count)), count
