"""LLaVA-OneVision: a SigLIP tower, anyres packing and a Qwen2 LM (port of
``llmc_tpu/models/llava_onevision.py``).

The SigLIP tower is the generalized block graph (``models/llama.py``) set
up as a pre-LN ViT: LayerNorm, biased attention, a non-gated gelu-tanh MLP,
no CLS token, learned positions.  Anyres packing runs on host-static grid
shapes: the image sizes and pinpoints are data-prep values, so
``select_best_resolution`` and ``anyres_grid_shape`` stay on the host, as
in the reference; only their outputs reach the device.  The video branch
pools each frame's features 2x bilinearly, appends one ``image_newline``,
and takes DyCoke or PruneVid (``compression/token_reduction.py``) on the
pooled frames.  ``resize_linear`` is the reference's ``jax.image.resize``
(bilinear, with or without its antialiasing) as two matrix products.

The tower, the projector and their attention are plain torch matmuls on
both devices (the reference computes them outside any Pallas kernel); only
the LM's linears and head reach the port's kernels, through a packed
serving QMap.  The tower reads only a ``ModalQMap``'s ``vision`` QMap
(``llava.vision_qmap``): the reference hands its image tower none and its
video tower the LM's QMap (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import llama as L
from .base import linear_apply
from .llava import _first, merge_embeddings, vision_qmap

F32 = torch.float32
VIDEO_METHODS = ('DyCoke', 'PruneVid')


@dataclasses.dataclass(frozen=True)
class LlavaOnevisionConfig:
    text: L.LlamaConfig
    vision: L.LlamaConfig          # SigLIP encoder block config
    image_size: int = 384
    patch_size: int = 14
    num_channels: int = 3
    image_token_index: int = 151646
    video_token_index: int = 151647
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = 'full'
    vision_aspect_ratio: str = 'anyres_max_9'
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = ((384, 384),)
    projector_act: str = 'gelu'

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @staticmethod
    def siglip_block_cfg(hidden: int, intermediate: int, layers: int,
                         heads: int, eps: float = 1e-6) -> L.LlamaConfig:
        return L.LlamaConfig(
            vocab_size=1, hidden_size=hidden,
            intermediate_size=intermediate, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=heads,
            head_dim=hidden // heads, rms_norm_eps=eps, norm_type='ln',
            rotary_pct=0.0, gated_mlp=False, act_fn='gelu_tanh',
            attention_bias=True, mlp_bias=True, dtype='float32')


# --------------------------------------------------------------------------
# Anyres helpers (host-static)
# --------------------------------------------------------------------------

def select_best_resolution(orig: Tuple[int, int],
                           pinpoints: Sequence[Tuple[int, int]]
                           ) -> Tuple[int, int]:
    """The pinpoint (h, w) that keeps the most of the image's resolution,
    then wastes the least."""
    oh, ow = orig
    best, best_fit = None, None
    for h, w in pinpoints:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        fit = (eff, -(h * w - eff))
        if best_fit is None or fit > best_fit:
            best, best_fit = (h, w), fit
    return best


def anyres_grid_shape(image_size: Tuple[int, int],
                      pinpoints: Sequence[Tuple[int, int]],
                      patch_dim: int) -> Tuple[int, int]:
    h, w = select_best_resolution(image_size, pinpoints)
    return h // patch_dim, w // patch_dim


def num_patches_for(image_size: Tuple[int, int],
                    pinpoints: Sequence[Tuple[int, int]],
                    patch_dim: int) -> int:
    """The crops an image of ``image_size`` takes: the anyres grid and the
    base image."""
    nh, nw = anyres_grid_shape(image_size, pinpoints, patch_dim)
    return nh * nw + 1


def _resize_weights(m: int, n: int, antialias: bool, device) -> torch.Tensor:
    """The [m, n] weights of a linear (triangle-kernel) resize of one axis
    from m to n samples, half-pixel centres; ``antialias`` widens the
    kernel by the downscale (``jax.image.scale_and_translate``'s)."""
    inv = 1.0 / (n / m)
    ks = max(inv, 1.0) if antialias else 1.0
    sample = (torch.arange(n, dtype=F32, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(m, dtype=F32,
                                                 device=device)[:, None]) / ks
    w = torch.clamp(1.0 - x, min=0.0)
    tot = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, shape: Sequence[int],
                  antialias: bool = True) -> torch.Tensor:
    """``x`` resized to ``shape`` by separable linear interpolation, each
    axis whose size changes in turn (``jax.image.resize(method='bilinear')``;
    the weights are made in float32 and cast to ``x``'s type)."""
    for d, n in enumerate(shape):
        m = x.shape[d]
        if m == n:
            continue
        w = _resize_weights(m, n, antialias, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w,
                                          dims=1), -1, d)
    return x


# --------------------------------------------------------------------------
# SigLIP tower
# --------------------------------------------------------------------------

def siglip_embed(vp: Dict, cfg, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, C, H, W] -> [N, P, D]: the patch conv as unfold + matmul
    and learned positions (no CLS token).  ``cfg`` needs ``image_size``,
    ``patch_size`` and ``num_channels``."""
    N = pixels.shape[0]
    p = cfg.patch_size
    kern = vp['patch_proj']['w']                       # [D, C, p, p]
    D = kern.shape[0]
    g = cfg.image_size // p
    x = pixels.reshape(N, cfg.num_channels, g, p, g, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(N, -1, cfg.num_channels * p * p)
    toks = torch.einsum('bnc,dc->bnd', x.to(F32), kern.reshape(D, -1).to(F32))
    if vp['patch_proj'].get('b') is not None:
        toks = toks + vp['patch_proj']['b'].to(F32)
    return (toks + vp['pos_embed'].to(F32)).to(kern.dtype)


def vision_features(vp: Dict, cfg: LlavaOnevisionConfig,
                    pixels: torch.Tensor, qmap=None) -> torch.Tensor:
    """The tower's selected hidden state (HF selects from the hidden
    states, which never hold the post-LayerNorm).  ``qmap`` is the tower's
    own policy."""
    x = siglip_embed(vp, cfg, pixels)
    vc = cfg.vision
    nl = vc.num_hidden_layers
    fl = cfg.vision_feature_layer
    upto = fl % nl + 1 if fl < 0 else fl
    no_mask = torch.zeros((1, 1, 1, 1), dtype=F32, device=x.device)
    for bp in vp['blocks'][:upto]:
        x, _ = L.block_apply(bp, vc, x, None, None, attn_bias=no_mask,
                             qmap=qmap)
    if cfg.vision_feature_select_strategy == 'default':
        x = x[:, 1:]
    return x


def project_features(pp: Dict, cfg: LlavaOnevisionConfig,
                     feats: torch.Tensor) -> torch.Tensor:
    h = linear_apply(pp['linear_1'], feats)
    h = L._act(h.to(F32), cfg.projector_act).to(feats.dtype)
    return linear_apply(pp['linear_2'], h)


def pack_image_features(feats: torch.Tensor, cfg: LlavaOnevisionConfig,
                        image_size: Tuple[int, int],
                        image_newline: torch.Tensor) -> torch.Tensor:
    """feats [num_patches, P, D] of one image -> [total_len, D]: the base
    image's tokens, then the anyres grid unpadded to the image's aspect,
    shrunk (antialiased) where it holds more than ``anyres_max_N`` crops'
    worth, each row closed by ``image_newline``."""
    n = feats.shape[0]
    side = cfg.patches_per_side
    if n == 1:
        return torch.cat([feats[0], image_newline[None].to(feats.dtype)], 0)
    base, rest = feats[0], feats[1:]
    nh, nw = anyres_grid_shape(image_size, cfg.image_grid_pinpoints,
                               cfg.image_size)
    D = feats.shape[-1]
    f = rest.reshape(nh, nw, side, side, D)
    f = f.permute(4, 0, 2, 1, 3).reshape(D, nh * side, nw * side)
    oh, ow = image_size
    ch, cw = f.shape[1], f.shape[2]
    if ow / oh > cw / ch:
        new_h = int(round(oh * (cw / ow), 7))
        pad = (ch - new_h) // 2
        f = f[:, pad:ch - pad]
    else:
        new_w = int(round(ow * (ch / oh), 7))
        pad = (cw - new_w) // 2
        f = f[:, :, pad:cw - pad]
    maxp = int(cfg.vision_aspect_ratio.replace('anyres_max_', '') or 9)
    ch, cw = f.shape[1], f.shape[2]
    r = math.sqrt(ch * cw / (maxp * side ** 2))
    if r > 1.1:
        f = resize_linear(f, (D, int(ch // r), int(cw // r)))
    nl = image_newline[:, None, None].to(f.dtype).expand(D, f.shape[1], 1)
    f = torch.cat([f, nl], dim=-1).reshape(D, -1).T
    return torch.cat([base, f.to(base.dtype)], dim=0)


def image_features(params: Dict, cfg: LlavaOnevisionConfig,
                   pixels: torch.Tensor, image_size: Tuple[int, int],
                   qmap=None) -> torch.Tensor:
    """pixels [num_patches, C, H, W] of one image -> its packed tokens;
    ``qmap`` is the tower's own policy."""
    f = vision_features(params['vision'], cfg, pixels, qmap=qmap)
    f = project_features(params['projector'], cfg, f)
    return pack_image_features(f, cfg, image_size, params['image_newline'])


def video_features(params: Dict, cfg: LlavaOnevisionConfig,
                   pixel_values_videos: torch.Tensor, qmap=None,
                   reduction: Optional[dict] = None) -> torch.Tensor:
    """[B, F, C, H, W] -> [B, span, lm_hidden]: per-frame tower features,
    the projector, a 2x bilinear pool per frame (ceil(side / 2), half-pixel
    centres, no antialiasing: torch's ``interpolate``), the frames side by
    side and one ``image_newline``.  ``reduction`` (batch 1): DyCoke
    (``merging_ratio``) or PruneVid on the pooled frames, as the reference
    wires them; another method raises."""
    B, F_, C, H, W = pixel_values_videos.shape
    method = (reduction or {}).get('method')
    if method is not None and method not in VIDEO_METHODS:
        raise NotImplementedError(
            f'token-reduction {method!r} is not wired for OneVision video '
            f'(supported: {", ".join(VIDEO_METHODS)})')
    if method is not None and B != 1:
        raise ValueError(f'{method} wiring supports batch 1 (the reference '
                         f'too)')
    f = vision_features(params['vision'], cfg, pixel_values_videos.reshape(
        B * F_, C, H, W), qmap=qmap)
    f = project_features(params['projector'], cfg, f)
    side = cfg.patches_per_side
    D = f.shape[-1]
    half = math.ceil(side / 2)
    g = resize_linear(f.reshape(B * F_, side, side, D).to(F32),
                      (B * F_, half, half, D), antialias=False).to(f.dtype)
    n2 = half * half
    feats = g.reshape(B, F_ * n2, D)
    if method == 'DyCoke':
        from ..compression.token_reduction import dycoke_ttm
        feats = dycoke_ttm(feats[0], n2, float(reduction.get(
            'merging_ratio', 0.3)))[None]
    elif method == 'PruneVid':
        from ..compression.token_reduction import prunevid_merge
        feats = prunevid_merge(
            feats[0].reshape(F_, n2, -1), float(reduction.get('taus', 0.8)),
            float(reduction.get('cluster_ratios', 0.5)),
            float(reduction.get('temporal_segment_ratios', 0.25)))[None]
    nl = params['image_newline'][None, None].to(feats.dtype).expand(B, 1, D)
    return torch.cat([feats, nl], dim=1)


# --------------------------------------------------------------------------
# Full forward (one image per sample, and / or one video per sample)
# --------------------------------------------------------------------------

def lm_inputs(params: Dict, cfg: LlavaOnevisionConfig,
              input_ids: torch.Tensor,
              pixel_values: Optional[torch.Tensor] = None,
              image_sizes: Optional[Sequence[Tuple[int, int]]] = None,
              pixel_values_videos: Optional[torch.Tensor] = None, qmap=None,
              token_reduction: Optional[dict] = None):
    """Block 0's input and the ids it stands for: (x, ids).  A reduced
    video span rewrites the ids to the kept count, as the reference does.
    The towers take only the deploy's ``vision`` QMap."""
    tc = cfg.text
    tq = vision_qmap(qmap)
    if pixel_values_videos is not None:
        vfeats = video_features(params, cfg, pixel_values_videos, qmap=tq,
                                reduction=token_reduction)
        vt = cfg.video_token_index
        if token_reduction:
            full = int((input_ids[0] == vt).sum())
            new_n = vfeats.shape[1]
            if new_n != full:
                v0 = _first(input_ids[0], vt)
                input_ids = torch.cat([input_ids[:, :v0 + new_n],
                                       input_ids[:, v0 + full:]], dim=1)
        x = merge_embeddings(L.embed_apply(params, tc, input_ids), vfeats,
                             input_ids, vt)
    else:
        x = L.embed_apply(params, tc, input_ids)
    if pixel_values is not None:
        feats = torch.stack([
            image_features(params, cfg, pixel_values[b],
                           tuple(int(v) for v in image_sizes[b]), qmap=tq)
            for b in range(input_ids.shape[0])])
        x = merge_embeddings(x, feats, input_ids, cfg.image_token_index)
    return x, input_ids


def onevision_forward(params: Dict, cfg: LlavaOnevisionConfig,
                      input_ids: torch.Tensor,
                      pixel_values: Optional[torch.Tensor] = None,
                      image_sizes: Optional[Sequence[Tuple[int, int]]]
                      = None,
                      pixel_values_videos: Optional[torch.Tensor] = None,
                      qmap=None, token_reduction: Optional[dict] = None
                      ) -> torch.Tensor:
    """The merged-modal forward to f32 logits; a packed head takes the
    QMap's ``lm_head`` entry."""
    tc = cfg.text
    x, input_ids = lm_inputs(params, cfg, input_ids, pixel_values,
                             image_sizes, pixel_values_videos, qmap,
                             token_reduction)
    cos, sin = L.rope_cos_sin(tc, torch.arange(
        input_ids.shape[1], device=input_ids.device)[None, :])
    for bp in params['blocks']:
        x, _ = L.block_apply(bp, tc, x, cos, sin, qmap=qmap)
    return L.head_apply(params, tc, x, qmap=qmap)


# --------------------------------------------------------------------------
# Random init and the HF checkpoint mapping
# --------------------------------------------------------------------------

def init_params(cfg: LlavaOnevisionConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` in the reference's tree and
    scales: the LM's, the tower's blocks, patch conv, positions and
    post-LayerNorm, the projector and ``image_newline``."""
    params = L.init_params(cfg.text, generator, dtype=dtype, device=device)
    vc = cfg.vision
    vis = L.init_params(vc, generator, dtype=dtype or vc.tdtype,
                        device=device)
    vini = L.Init(generator, dtype or vc.tdtype, device)
    ini = L.Init(generator, dtype or cfg.text.tdtype, device)
    D = vc.hidden_size
    td = cfg.text.hidden_size
    params['vision'] = {
        'patch_proj': {'w': vini.normal(
            (D, cfg.num_channels, cfg.patch_size, cfg.patch_size), 0.02),
            'b': vini.norm(D, bias=True)['b']},
        'pos_embed': vini.normal((cfg.num_patches, D), 0.02),
        'post_ln': vini.norm(D, bias=True),
        'blocks': vis['blocks'],
    }
    params['projector'] = {
        'linear_1': {'w': ini.normal((td, D), 0.6 / D ** 0.5),
                     'b': ini.norm(td, bias=True)['b']},
        'linear_2': {'w': ini.normal((td, td), 0.6 / td ** 0.5),
                     'b': ini.norm(td, bias=True)['b']},
    }
    params['image_newline'] = ini.normal((td,), 0.02)
    return params


def siglip_params_from_hf(norm, prefix: str, layers: int) -> Dict:
    """A SigLIP vision tower's tensors under ``prefix`` (HF's names) onto
    the tower's tree: its blocks, patch conv, positions and
    post-LayerNorm."""
    from .hf_loader import hf_linear, hf_norm
    blocks = []
    for i in range(layers):
        b = f'{prefix}.encoder.layers.{i}'
        blocks.append({
            'input_layernorm': hf_norm(norm, f'{b}.layer_norm1'),
            'self_attn': {
                'q_proj': hf_linear(norm, f'{b}.self_attn.q_proj'),
                'k_proj': hf_linear(norm, f'{b}.self_attn.k_proj'),
                'v_proj': hf_linear(norm, f'{b}.self_attn.v_proj'),
                'o_proj': hf_linear(norm, f'{b}.self_attn.out_proj')},
            'post_attention_layernorm': hf_norm(norm, f'{b}.layer_norm2'),
            'mlp': {'up_proj': hf_linear(norm, f'{b}.mlp.fc1'),
                    'down_proj': hf_linear(norm, f'{b}.mlp.fc2')},
        })
    return {'patch_proj': hf_linear(norm, f'{prefix}.embeddings'
                                          f'.patch_embedding'),
            'pos_embed': norm[f'{prefix}.embeddings.position_embedding'
                              f'.weight'],
            'post_ln': hf_norm(norm, f'{prefix}.post_layernorm'),
            'blocks': blocks}


def params_from_hf(flat, cfg: LlavaOnevisionConfig) -> Dict:
    """LlavaOnevisionForConditionalGeneration tensors (the pre- and
    post-4.52 transformers key layouts) onto the params tree."""
    from .hf_loader import hf_linear, llama_params_from_hf
    norm = {}
    for name in flat.keys():
        n = name
        if n.startswith('language_model.model.'):
            n = 'model.' + n[len('language_model.model.'):]
        elif n.startswith('language_model.'):
            n = n[len('language_model.'):]
        if n.startswith('model.language_model.'):
            n = 'model.' + n[len('model.language_model.'):]
        if n.startswith(('model.vision_tower.', 'model.multi_modal_projector.',
                         'model.image_newline')):
            n = n[len('model.'):]
        norm[n] = flat[name]
    text = {k: v for k, v in norm.items()
            if not k.startswith(('vision_tower.', 'multi_modal_projector.',
                                 'image_newline'))}
    params = llama_params_from_hf(text, cfg.text.num_hidden_layers,
                                  cfg.text.tie_word_embeddings)
    params['vision'] = siglip_params_from_hf(
        norm, 'vision_tower.vision_model', cfg.vision.num_hidden_layers)
    params['projector'] = {
        'linear_1': hf_linear(norm, 'multi_modal_projector.linear_1'),
        'linear_2': hf_linear(norm, 'multi_modal_projector.linear_2'),
    }
    params['image_newline'] = norm['image_newline']
    return params
