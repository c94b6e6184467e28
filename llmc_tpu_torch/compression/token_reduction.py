"""Token reduction (VLM visual-token pruning and merging) operators (port of
``llmc_tpu/compression/token_reduction.py``).

Every operator behind the 13 method names, over token states, wired into
the Llava-family forwards (``models/llava.py``).  Selections are top-k
with the lower index first among equal values (``models/base.py::top_k``,
as ``jax.lax.top_k``), so indices agree with the reference's.  The
data-dependent-size methods (MustDrop's merge count, PruneVid, FastVID,
HoliTom) read their sizes on the host, as the reference's hooks do;
HoliTom's clustering is numpy on the host.  The ``TokenReduction``
algorithm makes the reference's config shape work end to end:

    sparse:
      method: TokenReduction
      special: {method: FastV, prune_layer: 2, keep: 8}

It installs the reduction on the model (``model.token_reduction``) and has
no block loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..models.base import top_k
from ..utils.registry import ALGO_REGISTRY, TOKEN_REDUCTION_REGISTRY
from .blockwise import BlockwiseOpt

F32 = torch.float32


def _unit(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def _unit_plus(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, C] at rows idx [B, K] -> [B, K, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _set_true(shape, idx: torch.Tensor, device) -> torch.Tensor:
    """A [B, N] bool mask True at idx [B, K]."""
    return torch.zeros(shape, dtype=torch.bool, device=device).scatter(
        1, idx, True)


def fastv_prune(hidden: torch.Tensor, attn_probs: torch.Tensor,
                vision_range: Tuple[int, int], keep: int):
    """FastV: after the pruning layer keep the ``keep`` vision tokens that
    receive the most attention (mean over heads and queries).  hidden
    [B, S, D], attn_probs [B, H, S, S] -> (pruned hidden, kept indices)."""
    v0, v1 = vision_range
    B, S, _ = hidden.shape
    score = attn_probs.to(F32).mean(dim=1).mean(dim=1)        # [B, S]
    keep_idx = torch.sort(top_k(score[:, v0:v1], keep)[1] + v0, dim=-1).values
    dev = hidden.device
    all_idx = torch.cat([torch.arange(v0, device=dev).expand(B, v0), keep_idx,
                         torch.arange(v1, S, device=dev).expand(B, S - v1)],
                        dim=1)
    return _rows(hidden, all_idx), all_idx


def tome_merge(tokens: torch.Tensor, r: int) -> torch.Tensor:
    """ToMe bipartite soft matching: the ``r`` even tokens most similar to
    an odd token merge into their best odd match (mean).  [B, S, D] ->
    [B, S - r, D]."""
    B, S, D = tokens.shape
    a, b = tokens[:, 0::2], tokens[:, 1::2]
    A, Bn = a.shape[1], b.shape[1]
    sim = torch.einsum('bad,bcd->bac', _unit(a), _unit(b))
    best_sim = torch.amax(sim, dim=-1)
    best_dst = torch.argmax(sim, dim=-1)
    merged = _set_true((B, A), top_k(best_sim, r)[1], tokens.device)
    dst = torch.where(merged, best_dst, torch.full_like(best_dst, Bn))
    ones = merged.to(F32)
    # one row past the end takes (and drops) the unmerged tokens
    b_sum = torch.cat([b.to(F32), b.new_zeros((B, 1, D), dtype=F32)], 1)
    b_sum = b_sum.scatter_add(1, dst[..., None].expand(-1, -1, D),
                              a.to(F32) * ones[..., None])[:, :Bn]
    b_cnt = ones.new_zeros((B, Bn + 1)).scatter_add(1, dst, ones)[:, :Bn]
    b_new = b_sum / (1.0 + b_cnt)[..., None]
    rank = torch.arange(A, device=tokens.device)[None] + merged * (10 * S)
    keep_idx = torch.sort(top_k(-rank, A - r)[1], dim=-1).values
    return torch.cat([_rows(a, keep_idx).to(tokens.dtype),
                      b_new.to(tokens.dtype)], dim=1)


def divprune_select(tokens: torch.Tensor, keep: int) -> torch.Tensor:
    """DivPrune: greedy max-min diversity selection of ``keep`` tokens
    (farthest-point sampling on cosine distance), sorted indices."""
    B, S, _ = tokens.shape
    tn = _unit(tokens.to(F32))
    out = []
    for tb in tn:
        chosen = torch.zeros((keep,), dtype=torch.long, device=tokens.device)
        mind = torch.full((S,), float('inf'), dtype=F32,
                          device=tokens.device)
        for i in range(keep):
            nxt = torch.argmax(mind)
            chosen[i] = nxt
            mind = torch.minimum(mind, 1.0 - tb @ tb[nxt])
            mind[nxt] = float('-inf')
        out.append(torch.sort(chosen).values)
    return torch.stack(out)


def fastervlm_select(cls_attn: torch.Tensor, keep: int) -> torch.Tensor:
    """FasterVLM: the ``keep`` patches the tower's CLS attends to most
    (mean over heads), in their original order.  cls_attn [B, H, N]."""
    return torch.sort(top_k(cls_attn.to(F32).mean(dim=1), keep)[1],
                      dim=-1).values


def visionzip_reduce(hidden: torch.Tensor, attn: torch.Tensor,
                     metric: torch.Tensor, dominant: int, contextual: int
                     ) -> torch.Tensor:
    """VisionZip at the tower's select layer: CLS and the ``dominant``
    patches CLS attends to most, in original order, then ``contextual``
    merged tokens (each remaining token added, by key-metric similarity,
    to its nearest strided target).  hidden [B, 1+N, D] (CLS first), attn
    [B, H, S, S], metric [B, S, hd] -> [B, 1 + dominant + contextual, D]."""
    B, S, D = hidden.shape
    dev = hidden.device
    cls_attn = attn.to(F32)[:, :, 0, 1:].sum(dim=1)          # [B, N]
    top = top_k(cls_attn, dominant)[1] + 1
    keep_mask = _set_true((B, S), torch.cat(
        [torch.zeros((B, 1), dtype=top.dtype, device=dev), top], 1), dev)
    ar = torch.arange(S, device=dev)[None].expand(B, S)
    big = torch.full_like(ar, S + 1)
    dom_idx = torch.sort(torch.where(keep_mask, ar, big), -1).values[
        :, :dominant + 1]
    dom = _rows(hidden, dom_idx)
    nfilt = S - (dominant + 1)
    filt_idx = torch.sort(torch.where(keep_mask, big, ar), -1).values[
        :, :nfilt]
    h_f = _rows(hidden, filt_idx)
    m_f = _unit(_rows(metric.to(F32), filt_idx))
    step = max(1, nfilt // contextual)
    tgt = torch.arange(0, nfilt, step, device=dev)[:contextual]
    is_tgt = torch.zeros((nfilt,), dtype=torch.bool, device=dev)
    is_tgt[tgt] = True
    rest_idx = torch.nonzero(~is_tgt)[:, 0]
    m_rest, h_rest = m_f[:, rest_idx], h_f[:, rest_idx]
    sim = torch.einsum('brd,btd->brt', m_rest, m_f[:, tgt])
    onehot = torch.nn.functional.one_hot(torch.argmax(sim, dim=-1),
                                         tgt.shape[0]).to(F32)
    counts = torch.clamp(onehot.sum(dim=1), min=1.0)[..., None]
    agg = torch.einsum('brt,brd->btd', onehot, h_rest.to(F32)) / counts
    ctx = h_f[:, tgt].to(F32) + agg
    return torch.cat([dom, ctx.to(hidden.dtype)], dim=1)


def _pairwise(xf: torch.Tensor) -> torch.Tensor:
    """Euclidean distances over the last axis / sqrt(C): [..., N, N]."""
    C = xf.shape[-1]
    return torch.linalg.norm(xf[..., :, None, :] - xf[..., None, :, :],
                             dim=-1) / (C ** 0.5)


def _density_sep(d: torch.Tensor, k: int) -> torch.Tensor:
    """DPC's density * separation score of every point, from the
    distances d [..., N, N] and the density's ``k`` nearest."""
    N = d.shape[-1]
    dk = -top_k(-d, k)[0]
    density = torch.exp(-(dk ** 2).mean(dim=-1)) \
        + torch.arange(N, device=d.device) * 1e-6           # tie-break
    higher = density[..., None, :] > density[..., :, None]
    dmax = torch.amax(d.reshape(d.shape[:-2] + (-1,)), dim=-1)[..., None,
                                                               None]
    sep = torch.amin(torch.where(higher, d, dmax), dim=-1)
    return sep * density


def dpc_cluster_merge(x: torch.Tensor, cluster_num: int) -> torch.Tensor:
    """Density-peaks clustering merge (SparseVLM's cluster_and_merge):
    ``cluster_num`` centers by density * separation, every token to its
    nearest center, each cluster averaged.  x [B, N, C] -> [B, K, C]."""
    B, N, _ = x.shape
    xf = x.to(F32)
    d = _pairwise(xf)
    centers = top_k(_density_sep(d, min(cluster_num, N)), cluster_num)[1]
    d_toc = torch.gather(d, 1, centers[..., None].expand(-1, -1, N))
    idx = torch.argmin(d_toc, dim=1)                          # [B, N]
    idx = idx.scatter(1, centers, torch.arange(
        cluster_num, device=x.device).expand(B, -1))
    onehot = torch.nn.functional.one_hot(idx, cluster_num).to(F32)
    w = torch.clamp(onehot.sum(dim=1), min=1e-6)[..., None]
    return (torch.einsum('bnk,bnc->bkc', onehot, xf) / w).to(x.dtype)


# SparseVLM's per-stage keep schedule
SPARSEVLM_SCHEDULE = {192: (300, 200, 110), 128: (303, 110, 36),
                      64: (66, 30, 17)}


def sparsevlm_rate(probs: torch.Tensor, v0: int, v_num: int, t0: int
                   ) -> torch.Tensor:
    """SparseVLM's text-to-vision relation: the mean over heads and over
    the text queries (from ``t0`` on) of the attention each vision token
    receives.  probs [B, H, S, S] -> [B, v_num]."""
    p = probs.to(F32).mean(dim=1)
    return p[:, t0:, v0:v0 + v_num].mean(dim=1)


def pyramiddrop_rate(q: torch.Tensor, k: torch.Tensor, query_pos: int,
                     v0: int, v_num: int) -> torch.Tensor:
    """PyramidDrop: the causal softmax attention of the query at
    ``query_pos`` (the last image token), mean over heads, over the vision
    span.  q / k [B, S, H, hd] post-rope -> [B, v_num]."""
    S, hd = q.shape[1], q.shape[3]
    logits = torch.einsum('bhd,bshd->bhs', q.to(F32)[:, query_pos],
                          k.to(F32)) / (hd ** 0.5)
    mask = torch.arange(S, device=q.device)[None, None, :] <= query_pos
    p = torch.softmax(logits.masked_fill(~mask, float('-inf')),
                      dim=-1).mean(dim=1)
    return p[:, v0:v0 + v_num]


def dycoke_ttm(feats: torch.Tensor, n_per_frame: int, merging_ratio: float
               ) -> torch.Tensor:
    """DyCoke temporal token merging (batch 1, static output length).
    feats [F*N, C].  Each odd frame keeps the ``(1 - merging_ratio) * N``
    tokens least cosine-similar to the frame before it; every frame i+2
    for i in 0, 4, 8, ... (up to F-4) is pruned against frame i."""
    FN, C = feats.shape
    F_ = FN // n_per_frame
    keep = int((1.0 - merging_ratio) * n_per_frame)
    frames = feats.reshape(F_, n_per_frame, C)

    def prune_against(tgt, ref):
        af, bf = tgt.to(F32), ref.to(F32)
        sim = (af * bf).sum(-1) / (torch.linalg.norm(af, dim=-1)
                                   * torch.linalg.norm(bf, dim=-1) + 1e-8)
        return tgt[top_k(-sim, keep)[1]]

    kept = {}
    for i in range(0, F_ - 1, 2):
        kept[i] = frames[i]
        kept[i + 1] = prune_against(frames[i + 1], frames[i])
    if F_ % 2:
        kept[F_ - 1] = frames[F_ - 1]
    for i in range(0, F_ - 4, 4):
        kept[i + 2] = prune_against(frames[i + 2], frames[i])
    return torch.cat([kept[i] for i in range(F_)], dim=0)


def dart_keep_indices(hidden: torch.Tensor, keys: torch.Tensor, v0: int,
                      v_num: int, pivot_image_token: int,
                      pivot_text_token: int, reduction_ratio: float,
                      max_num_trunction: int = 0) -> torch.Tensor:
    """DART duplication-aware retention, batch 1.  hidden [S, D] (the final
    norm at the pruning block), keys [S, H*hd] post-rope.  The pivots are
    the top-L1 keys (image and text); each retains its ``topk`` least
    similar still-valid image tokens.  Returns the sorted absolute indices
    of the retained image tokens (a static count)."""
    P = pivot_image_token + pivot_text_token
    budget = (max_num_trunction if max_num_trunction
              else int(v_num * (1.0 - reduction_ratio)))
    topk = max(budget // P, 1)
    kf = keys.to(F32)
    dev = hidden.device
    img_piv = top_k(torch.abs(kf[v0:v0 + v_num]).sum(-1),
                    pivot_image_token)[1]
    txt_piv = top_k(torch.abs(kf[v0 + v_num:]).sum(-1),
                    pivot_text_token)[1] + v0 + v_num
    hn = _unit_plus(hidden.to(F32))
    img_tokens = hn[v0:v0 + v_num]
    valid = torch.ones((v_num,), dtype=torch.bool, device=dev)
    valid[img_piv] = False
    keep = ~valid
    pivots_abs = torch.cat([img_piv + v0, txt_piv])
    for p in range(P):
        sim = img_tokens @ hn[pivots_abs[p]]
        idx = top_k(torch.where(valid, -sim, torch.full_like(
            sim, float('-inf'))), topk)[1]
        keep[idx] = True
        valid[idx] = False
    total = pivot_image_token + P * topk
    rel = torch.sort(torch.where(keep, torch.arange(v_num, device=dev),
                                 torch.full((v_num,), v_num, device=dev))
                     ).values[:total]
    return rel + v0


def mustdrop_spatial_merge(x: torch.Tensor, threshold: float,
                           window: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """MustDrop's spatial stage (before vision block 1): the windows whose
    mean pairwise cosine similarity clears ``threshold`` collapse to their
    mean; the others keep their tokens, in original order.  x [B, 1+N, C]
    with CLS.  The merge count is read on the host (eager)."""
    B = x.shape[0]
    cls_tok, feat = x[:, :1], x[:, 1:]
    N, C = feat.shape[1], feat.shape[2]
    g = int(N ** 0.5)
    wh, ww = window
    nw = (g // wh) * (g // ww)
    k = wh * ww
    grid = feat.reshape(B, g // wh, wh, g // ww, ww, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, nw, k, C)
    nf = _unit_plus(grid.to(F32))
    sims = torch.einsum('bwic,bwjc->bwij', nf, nf)
    off = torch.eye(k, device=x.device)[None, None]
    sim_map = (sims * (1 - off)).sum((-1, -2)) / (k * (k - 1))    # [B, nw]
    r = int((sim_map >= threshold).sum(dim=1).min())
    if r == 0:
        return x
    top = top_k(sim_map, r)[1]                                    # [B, r]
    merged = torch.gather(grid, 1, top[..., None, None].expand(
        -1, -1, k, C)).mean(dim=2)
    idx_grid = torch.as_tensor(np.arange(N).reshape(
        g // wh, wh, g // ww, ww).transpose(0, 2, 1, 3).reshape(nw, k),
        device=x.device)
    keep_mask = ~_set_true((B, nw), top, x.device)
    wins = torch.arange(nw, device=x.device)[None].expand(B, nw)
    unm_win = torch.sort(torch.where(keep_mask, wins,
                                     torch.full_like(wins, nw)),
                         dim=1).values[:, :nw - r]
    unm_tok = torch.sort(idx_grid[unm_win].reshape(B, -1), dim=1).values
    return torch.cat([cls_tok, merged.to(x.dtype), _rows(feat, unm_tok)],
                     dim=1)


def dpc_assign(x: torch.Tensor, cluster_num: int, k: int = 5
               ) -> torch.Tensor:
    """DPC-KNN cluster assignment (PruneVid's cluster_dpc_knn): x [N, C] ->
    assignments [N] in [0, cluster_num), every center its own."""
    d = _pairwise(x.to(F32))
    centers = top_k(_density_sep(d, min(k, x.shape[0])), cluster_num)[1]
    idx = torch.argmin(d[:, centers], dim=1)
    idx[centers] = torch.arange(cluster_num, device=x.device)
    return idx


def prunevid_merge(frames: torch.Tensor, taus: float, cluster_ratio: float,
                   temporal_ratio: float, k: int = 7, min_spatial: int = 14
                   ) -> torch.Tensor:
    """PruneVid, batch 1, eager.  frames [F, L, C].  A temporal DPC-KNN on
    the frame means gives contiguous segments; in each, the tokens whose
    mean cross-frame cosine similarity exceeds ``taus`` are static (their
    window mean, DPC-merged), the others dynamic (DPC-merged per frame);
    the output is [static | dynamic] per segment."""
    F_, L, C = frames.shape
    n_seg = max(int(F_ * temporal_ratio), 1)
    assign = dpc_assign(frames.mean(dim=1), n_seg, k=min(k, F_)).cpu(
        ).numpy()
    windows, start = [], 0
    for t in range(1, F_ + 1):
        if t == F_ or assign[t] != assign[t - 1]:
            windows.append((start, t - start))
            start = t

    def spatial(t):
        if t.shape[0] <= min_spatial:
            return t
        return dpc_cluster_merge(t[None], max(int(t.shape[0] * cluster_ratio),
                                              1))[0]
    pieces = []
    for s0, w in windows:
        cur = frames[s0:s0 + w]
        if w > 1:
            nf = _unit_plus(cur.to(F32))
            sim = torch.einsum('wlc,tlc->wtl', nf, nf)
            sim = (sim.sum(dim=(0, 1)) - w) / (w * (w - 1))
        else:
            sim = torch.full((L,), 2.0, dtype=F32, device=frames.device)
        static = (sim > taus).cpu().numpy()
        stat_idx = torch.as_tensor(np.nonzero(static)[0], device=cur.device)
        dyn_idx = torch.as_tensor(np.nonzero(~static)[0], device=cur.device)
        if stat_idx.numel():
            pieces.append(spatial(cur[:, stat_idx].mean(dim=0)))
        if dyn_idx.numel():
            pieces.append(torch.cat([spatial(cur[i, dyn_idx])
                                     for i in range(w)], dim=0))
    return torch.cat(pieces, dim=0)


def fastvid_prune(frames: torch.Tensor, frame_attn: torch.Tensor,
                  frame_global: torch.Tensor, *, DySeg_c: int = 4,
                  DySeg_tau: float = 0.9, retention_ratio: float = 0.25,
                  STPrune_d: float = 0.5, DTM_p: int = 4,
                  DTM_alpha: float = 0.3) -> torch.Tensor:
    """FastVID, batch 1, eager.  frames [F, N, C], frame_attn [F, N] (each
    token's saliency), frame_global [F, C].  DySeg cuts between adjacent
    frames at the DySeg_c-1 lowest similarities and any below DySeg_tau;
    each frame keeps ``retain = N * retention_ratio`` tokens: its
    ``retain * (1 - d)`` most salient, plus density-peak context anchors on
    every DTM_p-th frame from each segment's end, each DTM-merged with the
    segment's tokens assigned to it (alpha-clamped weights), in original
    order."""
    F_, N, C = frames.shape
    dev = frames.device
    ff = frames.to(F32).cpu().numpy()
    gn = _unit_plus(frame_global.to(F32)).cpu().numpy()
    sim_adj = (gn[:-1] * gn[1:]).sum(-1) if F_ > 1 else np.zeros((0,))
    cuts = set(np.argsort(sim_adj)[:max(DySeg_c - 1, 0)]
               .tolist())
    cuts |= set(np.nonzero(sim_adj < DySeg_tau)[0].tolist())
    segments, s0 = [], 0
    for c in sorted(cuts) + [F_ - 1]:
        segments.append((s0, c - s0 + 1))
        s0 = c + 1
    segments = [(a, w) for a, w in segments if w > 0]
    retain = max(int(N * retention_ratio), 1)
    salient = max(retain - int(retain * STPrune_d), 1)
    context = retain - salient
    sal_idx = top_k(frame_attn.to(F32), salient)[1].cpu().numpy()
    mask = np.ones((F_, N), bool)
    np.put_along_axis(mask, sal_idx, False, axis=1)
    filt_idx = np.nonzero(mask)[1].reshape(F_, N - salient)
    tf = np.take_along_axis(ff, filt_idx[..., None], axis=1)
    score = _density_sep(_pairwise(torch.from_numpy(tf)),
                         min(4, N - salient)).numpy()
    tn = tf / (np.linalg.norm(tf, axis=-1, keepdims=True) + 1e-8)
    out = []
    for a, w in segments:
        # anchor frames: every DTM_p-th counted from the segment's end
        anchors = [a + i for i in range(w) if (w - 1 - i) % DTM_p == 0]
        cur_ctx = (context * w) // len(anchors) if anchors else 0
        for fi in range(a, a + w):
            toks = [ff[fi][sal_idx[fi]]]
            positions = [sal_idx[fi]]
            if fi in anchors and cur_ctx > 0:
                top = np.argsort(-score[fi])[:cur_ctx]
                seg_tf = tf[a:a + w].reshape(-1, C)
                assign = np.argmax(tn[a:a + w].reshape(-1, C)
                                   @ tn[fi][top].T, axis=1)
                ctx_toks = []
                for j in range(cur_ctx):
                    grp = seg_tf[assign == j]
                    wgt = max(1.0 / (len(grp) + 1), DTM_alpha)
                    base = tf[fi][top[j]]
                    agg = grp.mean(0) if len(grp) else base
                    ctx_toks.append(wgt * base + (1 - wgt) * agg)
                toks.append(np.stack(ctx_toks))
                positions.append(filt_idx[fi][top])
            # original token order within the frame
            order = np.argsort(np.concatenate(positions))
            out.append(np.concatenate(toks, axis=0)[order])
    return torch.as_tensor(np.concatenate(out, axis=0).astype(np.float32),
                           device=dev).to(frames.dtype)[None]


def _holitom_dpc(feat: np.ndarray, cluster_num: int, k: int):
    """DPC-KNN centers and the distance matrix (HoliTom's
    cluster_dpc_knn), numpy.  SparseVLM's, PruneVid's and this variant
    stay apart, as the reference's method files keep them."""
    n, C = feat.shape
    d = np.linalg.norm(feat[:, None] - feat[None, :], axis=-1) / (C ** 0.5)
    dk = np.sort(d, axis=-1)[:, :min(k, n)]
    density = np.exp(-(dk ** 2).mean(-1)) + np.arange(n) * 1e-6
    higher = density[None, :] > density[:, None]
    sep = np.where(higher, d, d.max()).min(-1)
    targets = np.sort(np.argsort(-(sep * density))[:cluster_num])
    return targets, d


def _holitom_cluster_merge(feat: np.ndarray, targets: np.ndarray,
                           dist: np.ndarray, beta: float) -> np.ndarray:
    """The beta-weighted merge of the non-targets into their nearest
    target."""
    non = np.setdiff1d(np.arange(feat.shape[0]), targets)
    if non.size:
        assign = np.argmin(dist[np.ix_(non, targets)], axis=1)
    out = []
    for i, t in enumerate(targets):
        grp = feat[non[assign == i]] if non.size else np.empty((0,))
        out.append(beta * feat[t] + (1 - beta) * grp.mean(0) if len(grp)
                   else feat[t])
    return np.stack(out)


def holitom_merge(frames: torch.Tensor, frame_attn: torch.Tensor, *,
                  tau: float = 0.8, max_window_size: int = 4,
                  retain_ratio: float = 0.25, D: float = 0.5,
                  beta: float = 0.5, K: int = 7) -> torch.Tensor:
    """HoliTom, batch 1, eager, numpy on the host.  A DP over frame
    windows maximizes the pruned static tokens; per window the tokens whose
    frame-to-frame similarity stays above ``tau`` become one static set
    (the window mean, density-merged), and the dynamic rest merges per
    frame by attention-weighted dominant / contextual selection, in
    original order."""
    F_, N, C = frames.shape
    fnp = frames.to(F32).cpu().numpy()
    anp = frame_attn.to(F32).cpu().numpy()
    nf = fnp / (np.linalg.norm(fnp, axis=-1, keepdims=True) + 1e-8)
    fsim = (nf[1:] * nf[:-1]).sum(-1)                   # [F-1, N]
    pruned = np.zeros((F_, F_))
    for s in range(F_):
        for e in range(s + 1, F_):
            pruned[s, e] = np.all(fsim[s:e] > tau, axis=0).sum() * (e - s)
    dp, prev = np.zeros(F_), np.zeros(F_, int)
    for i in range(F_):
        best, bj = (dp[i - 1] if i > 0 else 0.0), i
        for w in range(2, min(i + 1, max_window_size) + 1):
            j = i - w
            val = (dp[j] if j >= 0 else 0.0) + pruned[j + 1, i]
            if val > best:
                best, bj = val, j + 1
        dp[i], prev[i] = best, bj
    windows, i = [], F_ - 1
    while i >= 0:
        windows.append((prev[i], i))
        i = prev[i] - 1
    windows = windows[::-1]

    def merge_attn_density(feat, attn, pos):
        n = feat.shape[0]
        keep = int(np.ceil(n * retain_ratio))
        dom = round(keep * (1 - D))
        ctx = keep - dom
        parts, ppos = [], []
        mask = np.ones(n, bool)
        if dom > 0:
            di = np.sort(np.argsort(-attn)[:dom])
            mask[di] = False
            parts.append(feat[di])
            ppos.append(pos[di])
        if ctx > 0 and mask.sum() > 0:
            ff = feat[mask]
            t, dist = _holitom_dpc(ff, min(ctx, ff.shape[0]),
                                   min(K, max(ctx, 1)))
            parts.append(_holitom_cluster_merge(ff, t, dist, beta))
            ppos.append(pos[mask][t])
        if not parts:
            return feat[:0]
        order = np.argsort(np.concatenate(ppos))
        return np.concatenate(parts, axis=0)[order]

    out = []
    for s, e in windows:
        static = (np.all(fsim[s:e] > tau, axis=0) if e > s
                  else np.zeros(N, bool))
        if static.any():
            sf = fnp[s:e + 1, static].mean(0)
            keep = round(sf.shape[0] * retain_ratio)
            if keep > 0:
                t, dist = _holitom_dpc(sf, keep, min(K, keep))
                out.append(_holitom_cluster_merge(sf, t, dist, beta))
        dyn_pos = np.nonzero(~static)[0]
        for fi in range(s, e + 1):
            out.append(merge_attn_density(fnp[fi, ~static],
                                          anp[fi, ~static], dyn_pos))
    return torch.as_tensor(np.concatenate(out, axis=0).astype(np.float32),
                           device=frames.device).to(frames.dtype)[None]


@dataclasses.dataclass
class TokenReductionBase:
    """What a ``TOKEN_REDUCTION_REGISTRY`` entry builds: the method's
    config; the VLM forwards apply its operator."""

    config: dict
    method: str = 'FastV'


TOKEN_REDUCTION_METHODS = ('FastV', 'ToMe', 'DivPrune', 'FasterVLM',
                           'SparseVLM', 'VisionZip', 'PyramidDrop', 'DART',
                           'DyCoke', 'MustDrop', 'PruneVid', 'FastVID',
                           'HoliTom')
for _name in TOKEN_REDUCTION_METHODS:
    TOKEN_REDUCTION_REGISTRY.register(
        (lambda n: lambda cfg, *a, **kw: TokenReductionBase(cfg, n))(_name),
        name=_name)


@ALGO_REGISTRY.register(name='TokenReduction')
class TokenReduction(BlockwiseOpt):
    """The reference's ``sparse: {method: TokenReduction, special:
    {method: ...}}``: installs the reduction config on the model, which the
    VLM adapters read as their default ``token_reduction``.  No block loop,
    no calibration data."""

    needs_calib = False

    def __init__(self, model, sparsity_config, inputs, padding_mask, config):
        super().__init__(model, sparsity_config, inputs, padding_mask, config)
        special = dict(sparsity_config.get('special', {}) or {})
        self.check_special(special)
        self.reduction = TOKEN_REDUCTION_REGISTRY[special['method']](special)
        model.token_reduction = special

    @staticmethod
    def check_special(special):
        name = (special or {}).get('method')
        if name not in TOKEN_REDUCTION_REGISTRY:
            raise KeyError(
                f'token_reduction special.method {name!r} unknown; '
                f'available: {sorted(TOKEN_REDUCTION_REGISTRY.keys())}')

    def run_block_loop(self):
        pass

    def deploy(self, quant_format: str):
        return None
