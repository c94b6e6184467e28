"""Llava-style VLM: CLIP vision tower -> MLP projector -> Llama LM (port of
``llmc_tpu/models/llava.py``).

The tower runs on the generalized block graph (``models/llama.py``) set up
as a CLIP encoder block: LayerNorm, biased attention, no rope, no causal
mask, a non-gated quick-GELU MLP.  The tower, the projector and their
attention are plain torch matmuls on both devices (the reference computes
them outside any Pallas kernel); only the LM's linears and its decode
attention reach the port's kernels, through a packed serving QMap.

A deploy's QMap keys its linears by path alone, and the tower's block
linears carry the LM's path names (``self_attn.q_proj`` ... ``mlp.down_proj``),
so the reference's LM QMap also quantizes the tower, and a packed LM's QMap
sends the tower's unpacked linears to the packed path (ROADMAP C).  Here
the tower takes only what ``vision_qmap`` finds: the ``vision`` QMap a
``ModalQMap`` carries beside the LM's, or none.

Token reduction (``compression/token_reduction.py``) is wired in as in the
reference: tower-side methods (FasterVLM, VisionZip, MustDrop) shrink the
image span before the LM and compose with the cached prefill; LM-side
methods (FastV, DART, SparseVLM, PyramidDrop) prune inside the eager LM
forward; the video methods (DyCoke, PruneVid, FastVID, HoliTom) act on
Video-LLaVA's frame features.  The reference wires no forward for ToMe and
DivPrune (its forward runs them unreduced); here they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import llama as L
from .base import layer_norm, linear_apply, rms_norm, top_k

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    text: L.LlamaConfig
    vision: L.LlamaConfig            # CLIP encoder block config
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    image_token_index: int = 32000
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = 'default'  # drop CLS
    projector_act: str = 'gelu'
    # Video-LLaVA: F frames of tower features spliced at video_token_index
    video_token_index: Optional[int] = None
    num_frames: int = 8

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def image_seq_length(self) -> int:
        n = self.num_patches
        return n if self.vision_feature_select_strategy == 'default' \
            else n + 1

    @staticmethod
    def clip_block_cfg(hidden: int, intermediate: int, layers: int,
                       heads: int, eps: float = 1e-5) -> L.LlamaConfig:
        """A CLIP vision encoder block on the generalized decoder graph."""
        return L.LlamaConfig(
            vocab_size=1, hidden_size=hidden,
            intermediate_size=intermediate, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=heads,
            head_dim=hidden // heads, rms_norm_eps=eps, norm_type='ln',
            rotary_pct=0.0, gated_mlp=False, act_fn='quick_gelu',
            attention_bias=True, mlp_bias=True, dtype='float32')


# tower-side reductions act before the LM and compose with the cached
# prefill; the LM-side ones prune inside the LM forward and stay eager
TOWER_SIDE_METHODS = ('FasterVLM', 'VisionZip', 'MustDrop')
VIDEO_METHODS = ('DyCoke', 'PruneVid', 'FastVID', 'HoliTom')
UNWIRED_METHODS = ('ToMe', 'DivPrune')


def vision_qmap(qmap):
    """The tower's policy in a deploy: the ``vision`` QMap a ``ModalQMap``
    carries, else None.  An LM QMap never reaches the tower."""
    return getattr(qmap, 'vision', None)


def _no_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((1, 1, 1, 1), dtype=F32, device=x.device)


def _first(ids_row: torch.Tensor, token: int) -> int:
    """The first position of ``token`` in a row of ids (0 where there is
    none, as the reference's argmax gives)."""
    hit = torch.nonzero(ids_row == token)
    return int(hit[0, 0]) if hit.shape[0] else 0


def _select_upto(cfg: LlavaConfig) -> int:
    nl = cfg.vision.num_hidden_layers
    fl = cfg.vision_feature_layer
    return fl % nl + 1 if fl < 0 else fl


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, ...] at rows idx [B, K] -> [B, K, ...]."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.ndim - 2))
                        .expand(shape))


# --------------------------------------------------------------------------
# Vision tower
# --------------------------------------------------------------------------

def clip_embed(vp: Dict, cfg: LlavaConfig, pixels: torch.Tensor
               ) -> torch.Tensor:
    """pixels [B, C, H, W] -> [B, 1+N, D]: the patch conv as unfold +
    matmul, the class embedding, learned positions, pre-LayerNorm."""
    B = pixels.shape[0]
    p = cfg.patch_size
    kern = vp['patch_proj']['w']                 # [D, C, p, p]
    D = kern.shape[0]
    g = cfg.image_size // p
    x = pixels.reshape(B, cfg.num_channels, g, p, g, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, -1, cfg.num_channels * p * p)
    toks = torch.einsum('bnc,dc->bnd', x.to(F32), kern.reshape(D, -1).to(F32))
    if vp['patch_proj'].get('b') is not None:
        toks = toks + vp['patch_proj']['b'].to(F32)
    cls = vp['class_emb'].to(F32)[None, None].expand(B, 1, D)
    toks = torch.cat([cls, toks], dim=1) + vp['pos_embed'].to(F32)
    toks = toks.to(kern.dtype)
    pre = vp['pre_ln']
    return layer_norm(toks, pre['w'], pre.get('b'), cfg.vision.rms_norm_eps)


def _vision_block(bp: Dict, vc: L.LlamaConfig, x: torch.Tensor, qmap=None):
    return L.block_apply(bp, vc, x, None, None, attn_bias=_no_mask(x),
                         qmap=qmap)[0]


def _vision_block_with_probs(bp: Dict, vc: L.LlamaConfig, x: torch.Tensor,
                             qmap=None):
    """One CLIP block returning (y, attention probs [B, H, S, S], the keys'
    mean over heads [B, S, hd]): the probe of the tower-side methods."""
    B, S, _ = x.shape
    H, hd = vc.num_attention_heads, vc.head_dim

    def qc(path):
        return qmap.get(path) if qmap is not None else None
    h = layer_norm(x, bp['input_layernorm']['w'],
                   bp['input_layernorm'].get('b'), vc.rms_norm_eps)
    ap = bp['self_attn']
    q = linear_apply(ap['q_proj'], h, qc('self_attn.q_proj')).reshape(
        B, S, H, hd)
    k = linear_apply(ap['k_proj'], h, qc('self_attn.k_proj')).reshape(
        B, S, H, hd)
    v = linear_apply(ap['v_proj'], h, qc('self_attn.v_proj')).reshape(
        B, S, H, hd)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32), k.to(F32)) \
        / (hd ** 0.5)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum('bhqk,bkhd->bqhd', probs.to(x.dtype).to(F32),
                       v.to(F32)).to(x.dtype)
    x = x + linear_apply(ap['o_proj'], ctx.reshape(B, S, H * hd),
                         qc('self_attn.o_proj'))
    h2 = layer_norm(x, bp['post_attention_layernorm']['w'],
                    bp['post_attention_layernorm'].get('b'), vc.rms_norm_eps)
    mlp_out, _ = L.mlp_apply(bp['mlp'], h2, qmap, act=vc.act_fn)
    return x + mlp_out, probs, k.to(F32).mean(dim=2)


def vision_features(vp: Dict, cfg: LlavaConfig, pixels: torch.Tensor,
                    qmap=None, reduction: Optional[dict] = None
                    ) -> torch.Tensor:
    """The tower's selected hidden state (``vision_feature_layer``; -2 is
    the penultimate block's output), CLS dropped under 'default'.
    ``qmap`` is the tower's own policy.  ``reduction``: the tower-side
    methods, FasterVLM ({'keep': K}, or ``reduction_ratio`` of the
    patches dropped), VisionZip ({'dominant', 'contextual'}) and MustDrop
    ({'spatial_threshold', 'window_size'})."""
    x = clip_embed(vp, cfg, pixels)
    vc = cfg.vision
    upto = _select_upto(cfg)
    method = (reduction or {}).get('method')
    drop_cls = cfg.vision_feature_select_strategy == 'default'
    if method == 'MustDrop':
        # the spatial-merge stage hooked before vision block 1
        from ..compression.token_reduction import mustdrop_spatial_merge
        x = _vision_block(vp['blocks'][0], vc, x, qmap)
        x = mustdrop_spatial_merge(
            x, float(reduction.get('spatial_threshold', 0.9)),
            tuple(reduction.get('window_size', (2, 2))))
        for bp in vp['blocks'][1:upto]:
            x = _vision_block(bp, vc, x, qmap)
        return x[:, 1:] if drop_cls else x
    if method in ('FasterVLM', 'VisionZip'):
        from ..compression.token_reduction import (fastervlm_select,
                                                   visionzip_reduce)
        for bp in vp['blocks'][:upto - 1]:
            x = _vision_block(bp, vc, x, qmap)
        x, probs, keys = _vision_block_with_probs(vp['blocks'][upto - 1], vc,
                                                  x, qmap)
        if method == 'FasterVLM':
            if drop_cls:
                x = x[:, 1:]
            idx = fastervlm_select(probs[:, :, 0, 1:],
                                   fastervlm_keep(reduction, cfg.num_patches))
            return _gather_rows(x, idx)
        x = visionzip_reduce(x, probs, keys, int(reduction['dominant']),
                             int(reduction['contextual']))
        return x[:, 1:] if drop_cls else x
    for bp in vp['blocks'][:upto]:
        x = _vision_block(bp, vc, x, qmap)
    return x[:, 1:] if drop_cls else x


def fastervlm_keep(reduction: dict, n_patches: int) -> int:
    """FasterVLM's kept patches: ``keep``, or the patches that
    ``reduction_ratio`` leaves (the shipped config's key, which the
    reference's wiring does not read)."""
    if 'keep' in reduction:
        return int(reduction['keep'])
    return max(1, int(round(n_patches * (1.0 - float(
        reduction['reduction_ratio'])))))


def video_features(vp: Dict, cfg: LlavaConfig, pixels_videos: torch.Tensor,
                   qmap=None, reduction: Optional[dict] = None
                   ) -> torch.Tensor:
    """Per-frame tower features of a clip: [B, F, C, H, W] -> [B, F*N, D],
    frames in temporal order.  The video methods (batch 1) reduce them:
    DyCoke (``merging_ratio``), PruneVid, FastVID and HoliTom (the latter
    two from one tower pass whose select layer also gives each frame's
    CLS->patch attention and its CLS state)."""
    B, F_, C, H, W = pixels_videos.shape
    method = (reduction or {}).get('method')
    flat = pixels_videos.reshape(B * F_, C, H, W)
    if method in ('FastVID', 'HoliTom'):
        vc = cfg.vision
        upto = _select_upto(cfg)
        x = clip_embed(vp, cfg, flat)
        for bp in vp['blocks'][:upto - 1]:
            x = _vision_block(bp, vc, x, qmap)
        x, probs, _ = _vision_block_with_probs(vp['blocks'][upto - 1], vc, x,
                                               qmap)
        frame_attn = probs[:, :, 0, 1:].mean(dim=1)          # [F, N]
        frame_global = x[:, 0]                               # [F, C_v]
        feats = x[:, 1:] if cfg.vision_feature_select_strategy == 'default' \
            else x
    else:
        feats = vision_features(vp, cfg, flat, qmap=qmap)
    N = feats.shape[1]
    feats = feats.reshape(B, F_ * N, -1)
    if method in VIDEO_METHODS and B != 1:
        raise ValueError(f'{method} wiring supports batch 1 (the reference '
                         f'too)')
    if method == 'DyCoke':
        from ..compression.token_reduction import dycoke_ttm
        return dycoke_ttm(feats[0], N, float(reduction.get(
            'merging_ratio', 0.3)))[None]
    if method == 'PruneVid':
        from ..compression.token_reduction import prunevid_merge
        return prunevid_merge(
            feats[0].reshape(F_, N, -1), float(reduction.get('taus', 0.8)),
            float(reduction.get('cluster_ratios', 0.5)),
            float(reduction.get('temporal_segment_ratios', 0.25)))[None]
    if method == 'FastVID':
        from ..compression.token_reduction import fastvid_prune
        kw = {k[8:]: reduction[k] for k in
              ('fastvid_DySeg_c', 'fastvid_DySeg_tau',
               'fastvid_retention_ratio', 'fastvid_STPrune_d',
               'fastvid_DTM_p', 'fastvid_DTM_alpha') if k in reduction}
        return fastvid_prune(feats[0].reshape(F_, N, -1), frame_attn,
                             frame_global, **kw)
    if method == 'HoliTom':
        from ..compression.token_reduction import holitom_merge
        kw = {k[8:]: reduction[k] for k in
              ('holitom_tau', 'holitom_max_window_size',
               'holitom_retain_ratio', 'holitom_D', 'holitom_beta',
               'holitom_K') if k in reduction}
        if 'retain_ratio' in kw:
            kw['retain_ratio'] = float(kw['retain_ratio'])
        return holitom_merge(feats[0].reshape(F_, N, -1), frame_attn, **kw)
    return feats


def project_features(pp: Dict, cfg: LlavaConfig, feats: torch.Tensor
                     ) -> torch.Tensor:
    h = linear_apply(pp['linear_1'], feats)
    h = L._act(h.to(F32), cfg.projector_act).to(feats.dtype)
    return linear_apply(pp['linear_2'], h)


def merge_embeddings(text_embeds: torch.Tensor, image_feats: torch.Tensor,
                     input_ids: torch.Tensor, image_token: int
                     ) -> torch.Tensor:
    """Scatter the projected features into the placeholder positions: the
    k-th placeholder of a row takes ``image_feats[b, k]`` (HF
    LlavaForConditionalGeneration's expansion order)."""
    is_img = input_ids == image_token                        # [B, S]
    k = torch.clamp(torch.cumsum(is_img.to(torch.long), dim=1) - 1, 0,
                    image_feats.shape[1] - 1)
    gathered = _gather_rows(image_feats, k).to(text_embeds.dtype)
    return torch.where(is_img[..., None], gathered, text_embeds)


# --------------------------------------------------------------------------
# LM-side probes of the token-reduction methods
# --------------------------------------------------------------------------

def _qk_postrope(bp: Dict, cfg: L.LlamaConfig, x: torch.Tensor, cos, sin):
    """Post-rope q / k of one LM block (kv heads repeated), unquantized."""
    B, S, _ = x.shape
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    h = L.norm_apply(cfg, x, bp['input_layernorm'])
    ap = bp['self_attn']
    q = linear_apply(ap['q_proj'], h).reshape(B, S, H, hd)
    k = linear_apply(ap['k_proj'], h).reshape(B, S, KVH, hd)
    q, k = L.rope_qk(cfg, q, k, cos, sin)
    if KVH != H:
        k = torch.repeat_interleave(k, H // KVH, dim=2)
    return q, k


def _attn_probs(bp: Dict, cfg: L.LlamaConfig, x: torch.Tensor, cos, sin
                ) -> torch.Tensor:
    """Block ``bp``'s causal softmax attention map on its input (prefill):
    the probe FastV and SparseVLM rank visual tokens with."""
    S = x.shape[1]
    q, k = _qk_postrope(bp, cfg, x, cos, sin)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32), k.to(F32)) \
        / (cfg.head_dim ** 0.5)
    causal = torch.arange(S, device=x.device)[:, None] \
        >= torch.arange(S, device=x.device)[None, :]
    return torch.softmax(scores.masked_fill(~causal, float('-inf')), dim=-1)


# --------------------------------------------------------------------------
# Forwards
# --------------------------------------------------------------------------

def _blocks(params, tc, x, cos, sin, qmap, blocks=None):
    for bp in (params['blocks'] if blocks is None else blocks):
        x, _ = L.block_apply(bp, tc, x, cos, sin, qmap=qmap)
    return x


def _rope(tc, positions: torch.Tensor):
    return L.rope_cos_sin(tc, positions[None, :])


def llava_embed(params: Dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                pixel_values: Optional[torch.Tensor], qmap=None
                ) -> torch.Tensor:
    embeds = L.embed_apply(params, cfg.text, input_ids)
    if pixel_values is not None:
        feats = vision_features(params['vision'], cfg, pixel_values,
                                qmap=vision_qmap(qmap))
        feats = project_features(params['projector'], cfg, feats)
        embeds = merge_embeddings(embeds, feats, input_ids,
                                  cfg.image_token_index)
    return embeds


def _shrunk_span(params, cfg: LlavaConfig, input_ids, pixel_values, qmap,
                 reduction):
    """A tower-side method's merged embeddings and ids: the image span
    shrinks to the reduced features' count (the reference rewrites
    ``input_ids`` so)."""
    feats = vision_features(params['vision'], cfg, pixel_values,
                            qmap=vision_qmap(qmap), reduction=reduction)
    feats = project_features(params['projector'], cfg, feats)
    new_n = feats.shape[1]
    v0 = _first(input_ids[0], cfg.image_token_index)
    v1 = v0 + cfg.image_seq_length
    input_ids = torch.cat([input_ids[:, :v0 + new_n], input_ids[:, v1:]],
                          dim=1)
    embeds = L.embed_apply(params, cfg.text, input_ids)
    return (merge_embeddings(embeds, feats, input_ids,
                             cfg.image_token_index), input_ids)


def reduction_method(token_reduction: Optional[dict]) -> Optional[str]:
    """The method a reduction config names; a config without one is FastV
    (the reference's default)."""
    if not token_reduction:
        return None
    return token_reduction.get('method', 'FastV')


def llava_prefill_embeds(params: Dict, cfg: LlavaConfig,
                         input_ids: torch.Tensor,
                         pixel_values: Optional[torch.Tensor], qmap=None,
                         token_reduction: Optional[dict] = None):
    """The merged embeddings of the cached prefill: (embeds [B, S', D],
    ids [B, S']) with any tower-side reduction applied.  An LM-side method
    raises ``NotImplementedError``: it prunes inside the LM forward."""
    method = reduction_method(token_reduction)
    if pixel_values is None or method is None:
        return (llava_embed(params, cfg, input_ids, pixel_values, qmap=qmap),
                input_ids)
    if method not in TOWER_SIDE_METHODS:
        raise NotImplementedError(
            f'{method!r} prunes inside the LM forward; the cached prefill '
            f'takes the tower-side methods {TOWER_SIDE_METHODS}')
    return _shrunk_span(params, cfg, input_ids, pixel_values, qmap,
                        token_reduction)


def llava_forward(params: Dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                  pixel_values: Optional[torch.Tensor] = None, qmap=None,
                  token_reduction: Optional[dict] = None) -> torch.Tensor:
    """The merged-modal forward to f32 logits (the head takes no QMap, as
    in the reference).  ``token_reduction``: FastV ({'prune_layer',
    'keep'}; the default method), FasterVLM, VisionZip, MustDrop (tower
    side), DART, SparseVLM and PyramidDrop (LM side, batch 1)."""
    tc = cfg.text
    B, S = input_ids.shape
    method = reduction_method(token_reduction)
    blocks = params['blocks']
    dev = input_ids.device
    if pixel_values is not None and method in UNWIRED_METHODS:
        raise NotImplementedError(
            f'{method!r} has no wiring in the Llava forward: the reference '
            f'runs it unreduced (ROADMAP C)')
    if pixel_values is not None and method in VIDEO_METHODS:
        raise NotImplementedError(
            f'{method!r} reduces video frames: it runs through '
            f'videollava_forward with pixel_values_videos')

    if method in TOWER_SIDE_METHODS and pixel_values is not None:
        x, input_ids = _shrunk_span(params, cfg, input_ids, pixel_values,
                                    qmap, token_reduction)
        cos, sin = _rope(tc, torch.arange(input_ids.shape[1], device=dev))
        return L.head_apply(params, tc, _blocks(params, tc, x, cos, sin,
                                                qmap))

    x = llava_embed(params, cfg, input_ids, pixel_values, qmap=qmap)
    cos, sin = _rope(tc, torch.arange(S, device=dev))
    if pixel_values is None or method is None:
        return L.head_apply(params, tc, _blocks(params, tc, x, cos, sin,
                                                qmap))
    v0 = _first(input_ids[0], cfg.image_token_index)
    v_num = cfg.image_seq_length

    if method == 'FastV':
        from ..compression.token_reduction import fastv_prune
        pl = int(token_reduction['prune_layer'])
        x = _blocks(params, tc, x, cos, sin, qmap, blocks[:pl])
        probs = _attn_probs(blocks[pl], tc, x, cos, sin)
        x, kept = fastv_prune(x, probs, (v0, v0 + v_num),
                              int(token_reduction['keep']))
        cos = _gather_rows(cos.expand(B, -1, -1), kept)
        sin = _gather_rows(sin.expand(B, -1, -1), kept)
        return L.head_apply(params, tc, _blocks(params, tc, x, cos, sin,
                                                qmap, blocks[pl:]))

    if B != 1:
        raise ValueError(f'{method} wiring supports batch 1 (the reference '
                         f'too)')
    if method == 'DART':
        from ..compression.token_reduction import dart_keep_indices
        pl = int(token_reduction.get('pruning_loc', 2))
        x = _blocks(params, tc, x, cos, sin, qmap, blocks[:pl - 1])
        # the key states of block pl-1, and the final norm of its output
        _, keys = _qk_postrope(blocks[pl - 1], tc, x, cos, sin)
        x = _blocks(params, tc, x, cos, sin, qmap, blocks[pl - 1:pl])
        hidden = rms_norm(x, params['norm']['w'], tc.rms_norm_eps)[0]
        retained = dart_keep_indices(
            hidden, keys[0].reshape(S, -1), v0, v_num,
            int(token_reduction.get('pivot_image_token', 4)),
            int(token_reduction.get('pivot_text_token', 4)),
            float(token_reduction.get('reduction_ratio', 0.778)),
            int(token_reduction.get('max_num_trunction', 0)))
        keep = torch.sort(torch.cat([
            torch.arange(v0, device=dev), retained,
            torch.arange(v0 + v_num, S, device=dev)])).values
        x = x[:, keep]
        # the kept positions keep their original rope phases
        cos, sin = cos[:, keep], sin[:, keep]
        return L.head_apply(params, tc, _blocks(params, tc, x, cos, sin,
                                                qmap, blocks[pl:]))

    if method == 'SparseVLM':
        from ..compression.token_reduction import (SPARSEVLM_SCHEDULE,
                                                   dpc_cluster_merge,
                                                   sparsevlm_rate)
        locs = list(token_reduction.get('pruning_loc', (2, 6, 15)))
        sched = SPARSEVLM_SCHEDULE[int(token_reduction.get(
            'retained_tokens', 192))]
        stage = 0
        for li, bp in enumerate(blocks):
            if stage < len(locs) and li == locs[stage] and v_num > 1:
                probs = _attn_probs(bp, tc, x, cos, sin)
                rel = sparsevlm_rate(probs, v0, v_num, v0 + v_num)[0]
                keep_k = min(int(sched[min(stage, len(sched) - 1)]),
                             v_num - 1)
                keep_idx = torch.sort(top_k(rel, keep_k)[1]).values
                vis = x[0, v0:v0 + v_num]
                kept_vis = vis[keep_idx]
                # recycle the top 30% of the pruned by relation, DPC-merged
                pr = v_num - keep_k
                prune_rank = torch.sort(top_k(-rel, pr)[1]).values
                m1 = int(pr * 0.3) + 1
                m_idx = top_k(rel[prune_rank], m1)[1]
                m_tokens = vis[prune_rank][m_idx][None]
                cn = m1 // 10 + 1
                merged = dpc_cluster_merge(m_tokens, cn)[0]
                x = torch.cat([x[0, :v0], kept_vis, merged,
                               x[0, v0 + v_num:]], dim=0)[None]
                v_num = keep_k + cn
                # consecutive re-positioning
                cos, sin = _rope(tc, torch.arange(x.shape[1], device=dev))
                stage += 1
            x, _ = L.block_apply(bp, tc, x, cos, sin, qmap=qmap)
        return L.head_apply(params, tc, x)

    if method == 'PyramidDrop':
        from ..compression.token_reduction import pyramiddrop_rate
        locs = list(token_reduction.get('layer_list', (8, 16, 24)))
        ratios = list(token_reduction.get('image_token_ratio_list',
                                          (0.5, 0.25, 0.125)))
        n0 = v_num
        pos = torch.arange(S, device=dev)
        stage = 0
        for li, bp in enumerate(blocks):
            if stage < len(locs) and li == locs[stage] and v_num > 1:
                q, k = _qk_postrope(bp, tc, x, cos, sin)
                rel = pyramiddrop_rate(q, k, v0 + v_num - 1, v0, v_num)[0]
                keep_k = max(1, int(n0 * ratios[stage]))
                keep_idx = torch.sort(top_k(rel, keep_k)[1]).values
                x = torch.cat([x[0, :v0], x[0, v0:v0 + v_num][keep_idx],
                               x[0, v0 + v_num:]], dim=0)[None]
                pos = torch.cat([pos[:v0], pos[v0:v0 + v_num][keep_idx],
                                 pos[v0 + v_num:]])
                v_num = keep_k
                cos, sin = _rope(tc, pos)
                stage += 1
            x, _ = L.block_apply(bp, tc, x, cos, sin, qmap=qmap)
        return L.head_apply(params, tc, x)
    raise NotImplementedError(f'token-reduction method {method!r} is not '
                              f'wired into the Llava forward')


def videollava_forward(params: Dict, cfg: LlavaConfig,
                       input_ids: torch.Tensor,
                       pixel_values: Optional[torch.Tensor] = None,
                       pixel_values_videos: Optional[torch.Tensor] = None,
                       qmap=None, token_reduction: Optional[dict] = None
                       ) -> torch.Tensor:
    """The forward with image and / or video inputs.  A video method
    (DyCoke, PruneVid, FastVID, HoliTom) shrinks the video span and
    rewrites the ids; another method on video inputs raises (a no-op would
    report an unreduced run as reduced); without video it is the Llava
    forward."""
    method = (token_reduction or {}).get('method')
    tc = cfg.text
    if pixel_values_videos is None:
        return llava_forward(params, cfg, input_ids, pixel_values, qmap=qmap,
                             token_reduction=token_reduction)
    if method is not None and method not in VIDEO_METHODS:
        raise NotImplementedError(
            f'token-reduction method {method!r} is not wired for video '
            f'inputs (supported: {", ".join(VIDEO_METHODS)})')
    tq = vision_qmap(qmap)
    feats = video_features(params['vision'], cfg, pixel_values_videos,
                           qmap=tq, reduction=token_reduction)
    feats = project_features(params['projector'], cfg, feats)
    vt = cfg.video_token_index
    full_len = cfg.num_frames * cfg.image_seq_length
    new_n = feats.shape[1]
    if new_n != full_len:          # the method shrank the span
        v0 = _first(input_ids[0], vt)
        input_ids = torch.cat([input_ids[:, :v0 + new_n],
                               input_ids[:, v0 + full_len:]], dim=1)
    x = merge_embeddings(L.embed_apply(params, tc, input_ids), feats,
                         input_ids, vt)
    if pixel_values is not None:
        ifeats = project_features(params['projector'], cfg, vision_features(
            params['vision'], cfg, pixel_values, qmap=tq))
        x = merge_embeddings(x, ifeats, input_ids, cfg.image_token_index)
    cos, sin = _rope(tc, torch.arange(input_ids.shape[1],
                                      device=input_ids.device))
    return L.head_apply(params, tc, _blocks(params, tc, x, cos, sin, qmap))


# --------------------------------------------------------------------------
# Random init and the HF checkpoint mapping
# --------------------------------------------------------------------------

def init_params(cfg: LlavaConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` in the reference's tree and
    scales: the LM's, then the tower's blocks, its patch conv, class
    embedding and positions, and the projector."""
    ini = L.Init(generator, dtype or cfg.text.tdtype, device)
    params = L.init_params(cfg.text, generator, dtype=dtype, device=device)
    vc = cfg.vision
    vis = L.init_params(vc, generator, dtype=dtype or vc.tdtype,
                        device=device)
    vini = L.Init(generator, dtype or vc.tdtype, device)
    D = vc.hidden_size
    params['vision'] = {
        'patch_proj': {'w': vini.normal(
            (D, cfg.num_channels, cfg.patch_size, cfg.patch_size), 0.02),
            'b': None},
        'class_emb': vini.normal((D,), 0.02),
        'pos_embed': vini.normal((1 + cfg.num_patches, D), 0.02),
        'pre_ln': vini.norm(D, bias=True),
        'post_ln': vini.norm(D, bias=True),
        'blocks': vis['blocks'],
    }
    td = cfg.text.hidden_size
    params['projector'] = {
        'linear_1': {'w': ini.normal((td, D), 0.6 / D ** 0.5),
                     'b': ini.norm(td, bias=True)['b']},
        'linear_2': {'w': ini.normal((td, td), 0.6 / td ** 0.5),
                     'b': ini.norm(td, bias=True)['b']},
    }
    return params


def params_from_hf(flat, cfg: LlavaConfig) -> Dict:
    """LlavaForConditionalGeneration tensors (the pre- and post-4.52
    transformers key layouts) onto the params tree."""
    from .hf_loader import hf_linear, hf_norm, llama_params_from_hf
    norm = {}
    for name in flat.keys():
        n = name
        # post-4.52 layout: model.language_model..., model.vision_tower...
        if n.startswith('model.language_model.'):
            n = 'model.' + n[len('model.language_model.'):]
        elif n.startswith('language_model.'):
            n = n[len('language_model.'):]
        if n.startswith(('model.vision_tower.',
                         'model.multi_modal_projector.')):
            n = n[len('model.'):]
        norm[n] = flat[name]
    text = {k: v for k, v in norm.items()
            if not k.startswith(('vision_tower.', 'multi_modal_projector.'))}
    params = llama_params_from_hf(text, cfg.text.num_hidden_layers,
                                  cfg.text.tie_word_embeddings)
    vt = 'vision_tower.vision_model'

    blocks = []
    for i in range(cfg.vision.num_hidden_layers):
        b = f'{vt}.encoder.layers.{i}'
        blocks.append({
            'input_layernorm': hf_norm(norm, f'{b}.layer_norm1'),
            'self_attn': {
                'q_proj': hf_linear(norm, f'{b}.self_attn.q_proj'),
                'k_proj': hf_linear(norm, f'{b}.self_attn.k_proj'),
                'v_proj': hf_linear(norm, f'{b}.self_attn.v_proj'),
                'o_proj': hf_linear(norm, f'{b}.self_attn.out_proj')},
            'post_attention_layernorm': hf_norm(
                norm, f'{b}.layer_norm2'),
            'mlp': {'up_proj': hf_linear(norm, f'{b}.mlp.fc1'),
                    'down_proj': hf_linear(norm, f'{b}.mlp.fc2')},
        })
    params['vision'] = {
        'patch_proj': hf_linear(norm, f'{vt}.embeddings.patch_embedding'),
        'class_emb': norm[f'{vt}.embeddings.class_embedding'],
        'pos_embed': norm[f'{vt}.embeddings.position_embedding.weight'],
        'pre_ln': hf_norm(norm, f'{vt}.pre_layrnorm'),   # HF's spelling
        'post_ln': hf_norm(norm, f'{vt}.post_layernorm'),
        'blocks': blocks,
    }
    params['projector'] = {
        'linear_1': hf_linear(norm, 'multi_modal_projector.linear_1'),
        'linear_2': hf_linear(norm, 'multi_modal_projector.linear_2'),
    }
    return params
