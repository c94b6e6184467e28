"""MiniCPM-V: a SigLIP tower, a perceiver resampler and the MiniCPM / Llama
LM (port of ``llmc_tpu/models/minicpmv.py``).

As in the reference, only the language model compresses; the vision side
(the tower and the resampler) feeds the multimodal forward.  The tower is
OneVision's SigLIP (``llava_onevision.siglip_embed`` and its block config)
with its post-LayerNorm; the resampler is one cross-attention read-out:
``num_queries`` learned queries over the kv-projected tower features, a 2-D
sincos position embedding on the keys (HF MiniCPM-V's ``Resampler``, a
``torch.nn.MultiheadAttention`` whose fused in-projection splits into q / k
/ v), then a LayerNorm and a projection.  The image tokens splice into the
placeholder span as they come out, unscaled.

The tower and the resampler are plain torch matmuls on both devices (the
reference computes them outside any Pallas kernel); only the LM's linears
and head reach the port's kernels.  The tower reads only a ``ModalQMap``'s
``vision`` QMap (``llava.vision_qmap``), which a language-only deploy never
carries: the reference hands it the LM's QMap, and a packed one sends the
tower's unpacked linears to the packed path (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from . import llama as L
from .base import layer_norm, linear_apply
from .llava import vision_qmap
from .llava_onevision import siglip_embed

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MiniCPMVConfig:
    text: L.LlamaConfig
    vision: L.LlamaConfig              # SigLIP block config
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    num_queries: int = 64
    image_token_index: int = 128244    # <unk> placeholder span
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = 'full'

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size


def pos_2d_sincos(dim: int, grid: int) -> np.ndarray:
    """The 2-D sincos position embedding [grid*grid, dim] (the resampler's
    ``get_2d_sincos_pos_embed``): rows row-major, half the channels for
    the row, half for the column, each half sin then cos."""
    half = dim // 2

    def axis(pos):
        omega = 1.0 / (10000 ** (np.arange(half // 2) / (half / 2.)))
        out = np.einsum('p,f->pf', pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    return np.concatenate([axis(np.repeat(g, grid)), axis(np.tile(g, grid))],
                          axis=1).astype(np.float32)


def resample(rp: Dict, cfg: MiniCPMVConfig, feats: torch.Tensor
             ) -> torch.Tensor:
    """feats [B, P, kv_dim] -> [B, num_queries, lm_dim]."""
    D = rp['query'].shape[1]
    B, P, _ = feats.shape
    dev = feats.device
    kv = linear_apply(rp['kv_proj'], feats)              # [B, P, D]
    kv = layer_norm(kv, rp['ln_kv']['w'], rp['ln_kv'].get('b'), 1e-6)
    q = layer_norm(rp['query'][None], rp['ln_q']['w'], rp['ln_q'].get('b'),
                   1e-6)                                 # [1, Q, D]
    grid = int(math.sqrt(P))
    pos = torch.as_tensor(pos_2d_sincos(D, grid), device=dev)[:P]
    k = kv + pos[None]
    wq, wk, wv = torch.chunk(rp['in_proj']['w'], 3, dim=0)
    b = rp['in_proj'].get('b')
    bq, bk, bv = torch.chunk(b, 3) if b is not None else (None,) * 3
    H = int(rp['num_heads'])
    hd = D // H

    def proj(x, w, bias):
        y = torch.einsum('bsd,od->bso', x.to(F32), w.to(F32))
        return y if bias is None else y + bias.to(F32)
    Q = q.shape[1]
    qq = proj(q.expand(B, Q, D), wq, bq).reshape(B, Q, H, hd)
    kk = proj(k, wk, bk).reshape(B, P, H, hd)
    vv = proj(kv, wv, bv).reshape(B, P, H, hd)
    scores = torch.einsum('bqhd,bkhd->bhqk', qq, kk) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum('bhqk,bkhd->bqhd', probs, vv).reshape(B, Q, D)
    out = linear_apply(rp['out_proj'], ctx.to(feats.dtype))
    out = layer_norm(out, rp['ln_post']['w'], rp['ln_post'].get('b'), 1e-6)
    return torch.einsum('bqd,de->bqe', out.to(F32),
                        rp['proj'].to(F32)).to(feats.dtype)


def image_embeds(params: Dict, cfg: MiniCPMVConfig, pixels: torch.Tensor,
                 qmap=None) -> torch.Tensor:
    """pixels [B, C, H, W] -> resampled [B, num_queries, lm_dim]; ``qmap``
    is the tower's own policy."""
    vp = params['vision']
    x = siglip_embed(vp, cfg, pixels)
    no_mask = torch.zeros((1, 1, 1, 1), dtype=F32, device=x.device)
    for bp in vp['blocks']:
        x, _ = L.block_apply(bp, cfg.vision, x, None, None,
                             attn_bias=no_mask, qmap=qmap)
    pl = vp.get('post_ln')
    if pl is not None:
        x = layer_norm(x, pl['w'], pl.get('b'), cfg.vision.rms_norm_eps)
    return resample(params['resampler'], cfg, x)


def lm_embeds(params: Dict, cfg: MiniCPMVConfig, input_ids: torch.Tensor,
              pixel_values: Optional[torch.Tensor] = None, qmap=None
              ) -> torch.Tensor:
    """Block 0's input: the (scaled) token embeddings, the k-th image
    placeholder of a row taking the row's k-th resampled token.  The tower
    takes only the deploy's ``vision`` QMap."""
    x = L.embed_apply(params, cfg.text, input_ids)
    if pixel_values is None:
        return x
    feats = image_embeds(params, cfg, pixel_values, qmap=vision_qmap(qmap))
    is_img = input_ids == cfg.image_token_index
    k = torch.clamp(torch.cumsum(is_img.to(torch.long), dim=1) - 1, 0,
                    feats.shape[1] - 1)
    g = torch.gather(feats, 1, k[..., None].expand(k.shape + feats.shape[2:]))
    return torch.where(is_img[..., None], g.to(x.dtype), x)


def minicpmv_forward(params: Dict, cfg: MiniCPMVConfig,
                     input_ids: torch.Tensor,
                     pixel_values: Optional[torch.Tensor] = None,
                     qmap=None) -> torch.Tensor:
    """The merged-modal forward to f32 logits; a packed head takes the
    QMap's ``lm_head`` entry."""
    tc = cfg.text
    x = lm_embeds(params, cfg, input_ids, pixel_values, qmap)
    cos, sin = L.rope_cos_sin(tc, torch.arange(
        input_ids.shape[1], device=input_ids.device)[None, :])
    for bp in params['blocks']:
        x, _ = L.block_apply(bp, tc, x, cos, sin, qmap=qmap)
    return L.head_apply(params, tc, x, qmap=qmap)


# --------------------------------------------------------------------------
# Random init and the HF checkpoint mapping
# --------------------------------------------------------------------------

def init_params(cfg: MiniCPMVConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator``: the LM's, then the vision
    side in the reference's tree and scales (float32, as the reference
    draws it: linears N(0, 1/in), the patch conv N(0, 0.1), positions and
    queries N(0, 0.02))."""
    params = L.init_params(cfg.text, generator, dtype=dtype, device=device)
    ini = L.Init(generator, F32, device)
    vc = cfg.vision
    D, FF = vc.hidden_size, vc.intermediate_size
    DL = cfg.text.hidden_size

    def lin(i, o, bias=True):
        return {'w': ini.normal((o, i), 1.0 / math.sqrt(i)),
                'b': ini.norm(o, bias=True)['b'] if bias else None}

    blocks = [{'input_layernorm': ini.norm(D, bias=True),
               'post_attention_layernorm': ini.norm(D, bias=True),
               'self_attn': {n: lin(D, D) for n in ('q_proj', 'k_proj',
                                                    'v_proj', 'o_proj')},
               'mlp': {'up_proj': lin(D, FF), 'down_proj': lin(FF, D)}}
              for _ in range(vc.num_hidden_layers)]
    params['vision'] = {
        'patch_proj': {'w': ini.normal((D, cfg.num_channels, cfg.patch_size,
                                        cfg.patch_size), 0.1),
                       'b': ini.norm(D, bias=True)['b']},
        'pos_embed': ini.normal((cfg.patches_per_side ** 2, D), 0.02),
        'blocks': blocks, 'post_ln': ini.norm(D, bias=True)}
    params['resampler'] = {
        'query': ini.normal((cfg.num_queries, DL), 0.02),
        'kv_proj': lin(D, DL, bias=False),
        'ln_kv': ini.norm(DL, bias=True), 'ln_q': ini.norm(DL, bias=True),
        'ln_post': ini.norm(DL, bias=True),
        'in_proj': {'w': ini.normal((3 * DL, DL), 1.0 / math.sqrt(DL)),
                    'b': ini.norm(3 * DL, bias=True)['b']},
        'out_proj': lin(DL, DL),
        'proj': ini.normal((DL, DL), 1.0 / math.sqrt(DL)),
        'num_heads': cfg.text.num_attention_heads}
    return params


def vision_params_from_hf(flat, cfg: MiniCPMVConfig,
                          dtype: torch.dtype = F32) -> Dict:
    """The vision side's tensors (HF's ``vpm.*`` SigLIP and ``resampler.*``)
    in ``dtype``: {'vision': ..., 'resampler': ...}.  The resampler has a
    head of 128 channels."""
    from .hf_loader import hf_linear
    from .llava_onevision import siglip_params_from_hf

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dtype) if isinstance(tree, torch.Tensor) else tree

    kv = hf_linear(flat, 'resampler.kv_proj')
    resampler = {
        'query': flat['resampler.query'],
        'kv_proj': {'w': kv['w'], 'b': None},
        'ln_kv': hf_linear(flat, 'resampler.ln_kv'),
        'ln_q': hf_linear(flat, 'resampler.ln_q'),
        'ln_post': hf_linear(flat, 'resampler.ln_post'),
        'in_proj': {'w': flat['resampler.attn.in_proj_weight'],
                    'b': flat.get('resampler.attn.in_proj_bias')},
        'out_proj': hf_linear(flat, 'resampler.attn.out_proj'),
        'proj': flat['resampler.proj'],
        'num_heads': cfg.text.hidden_size // 128}
    return cast({'vision': siglip_params_from_hf(
        flat, 'vpm', cfg.vision.num_hidden_layers), 'resampler': resampler})
