"""Qwen2-VL: a ViT with 2-D rope and a patch merger, and the Qwen2 LM with
M-RoPE (port of ``llmc_tpu/models/qwen2vl.py``).

The tower runs on the generalized block graph (``models/llama.py``) set up
as a pre-LN ViT block: LayerNorm, biased attention, a non-gated quick-GELU
MLP, no causal mask, and the 2-D rotary tables of each patch passed in as
the block's cos / sin.  HF's fused ``attn.qkv`` splits into q / k / v at
load.  Pixels come in the HF processor's layout: flattened patches
[n, C*T*p*p] in spatial-merge-window order with a static (t, h, w) grid,
so the merger is a reshape.  M-RoPE is rotate-half rope whose cos / sin
take each channel from one of the three (t, h, w) position streams; on
text all three carry one position, so the LM's cached decode runs plain
rope (``LlamaConfig.rope_scaling_type='mrope'``).  ``rope_index`` (the 3-D
positions of a prompt with images) runs on the host, as in the reference.

The tower, the merger and their attention are plain torch matmuls on both
devices (the reference computes them outside any Pallas kernel); only the
LM's linears and head reach the port's kernels, through a packed serving
QMap.  The tower reads only a ``ModalQMap``'s ``vision`` QMap
(``llava.vision_qmap``): the reference hands it none, so its calibrated
tower reaches no eval (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import llama as L
from .base import layer_norm, linear_apply
from .llava import vision_qmap

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    text: L.LlamaConfig
    vision: L.LlamaConfig               # ViT block config (embed dim etc.)
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    spatial_merge_size: int = 2
    patch_size: int = 14
    temporal_patch_size: int = 2
    num_channels: int = 3
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652

    @property
    def patch_dim(self) -> int:
        return (self.num_channels * self.temporal_patch_size
                * self.patch_size ** 2)

    @staticmethod
    def vit_block_cfg(embed_dim: int, mlp_hidden: int, depth: int,
                      heads: int, act: str = 'quick_gelu',
                      eps: float = 1e-6) -> L.LlamaConfig:
        return L.LlamaConfig(
            vocab_size=1, hidden_size=embed_dim,
            intermediate_size=mlp_hidden, num_hidden_layers=depth,
            num_attention_heads=heads, num_key_value_heads=heads,
            head_dim=embed_dim // heads, rms_norm_eps=eps,
            norm_type='ln', rotary_pct=1.0, gated_mlp=False, act_fn=act,
            attention_bias=True, mlp_bias=True, dtype='float32')


# --------------------------------------------------------------------------
# Vision tower
# --------------------------------------------------------------------------

def vision_rot_cos_sin(grid_thw: Tuple[int, int, int], head_dim: int,
                       merge: int, theta: float = 10000.0, device=None):
    """The 2-D rotary cos / sin [seq, head_dim] of each patch token in
    spatial-merge-window order (HF's ``rot_pos_emb``): the first half of
    the channels turn with the row, the second with the column.  Made on
    the host in float64, as the reference makes them, then float32."""
    t, h, w = (int(v) for v in grid_thw)
    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))

    def win(m):
        m = m.reshape(h // merge, merge, w // merge, merge)
        return m.transpose(0, 2, 1, 3).reshape(-1)

    hp, wp = np.tile(win(hpos), t), np.tile(win(wpos), t)
    dim = head_dim // 2
    inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    freqs = np.concatenate([hp[:, None] * inv[None, :],
                            wp[:, None] * inv[None, :]], axis=1)
    emb = np.concatenate([freqs, freqs], axis=1)
    return (torch.as_tensor(np.cos(emb), dtype=F32, device=device),
            torch.as_tensor(np.sin(emb), dtype=F32, device=device))


def patch_embed(vp: Dict, cfg: Qwen2VLConfig, patches: torch.Tensor
                ) -> torch.Tensor:
    """Processor-layout patches [n, C*T*p*p] -> tokens [1, n, D]: the 3-D
    patch conv as one matmul (no bias)."""
    return linear_apply(vp['patch_proj'],
                        patches.to(cfg.vision.tdtype))[None]


def vision_forward(vp: Dict, cfg: Qwen2VLConfig, patches: torch.Tensor,
                   grid_thw: Tuple[int, int, int], qmap=None
                   ) -> torch.Tensor:
    """patches [n, C*T*p*p] -> merged image embeddings [n / merge^2,
    lm_hidden]: the tower, then the PatchMerger (LayerNorm, merge^2 window
    tokens side by side, MLP).  ``qmap`` is the tower's own policy."""
    vc = cfg.vision
    x = patch_embed(vp, cfg, patches)
    cos, sin = vision_rot_cos_sin(grid_thw, vc.head_dim,
                                  cfg.spatial_merge_size, device=x.device)
    no_mask = torch.zeros((1, 1, 1, 1), dtype=F32, device=x.device)
    for bp in vp['blocks']:
        x, _ = L.block_apply(bp, vc, x, cos[None], sin[None],
                             attn_bias=no_mask, qmap=qmap)
    m = vp['merger']
    h = layer_norm(x[0], m['ln_q']['w'], m['ln_q'].get('b'), vc.rms_norm_eps)
    h = h.reshape(-1, vc.hidden_size * cfg.spatial_merge_size ** 2)
    h = linear_apply(m['mlp_0'], h, L._qc(qmap, 'merger.mlp_0'))
    h = torch.nn.functional.gelu(h.to(F32)).to(h.dtype)
    return linear_apply(m['mlp_2'], h, L._qc(qmap, 'merger.mlp_2'))


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

def mrope_channels(head_dim: int, sections: Tuple[int, ...]) -> np.ndarray:
    """The stream (0 t, 1 h, 2 w) each rope channel reads: section i of
    ``sections`` twice over takes stream i % 3."""
    sel = np.zeros((head_dim,), np.int64)
    off = 0
    for i, s in enumerate(list(sections) * 2):
        sel[off:off + s] = i % 3
        off += s
    return sel


def mrope_cos_sin(tcfg: L.LlamaConfig, pos3: torch.Tensor,
                  sections: Tuple[int, ...]):
    """pos3 [3, B, S] (the t / h / w position streams) -> cos / sin
    [B, S, head_dim], float32 (HF's ``apply_multimodal_rotary_pos_emb``)."""
    hd = tcfg.head_dim
    dev = pos3.device
    inv = 1.0 / tcfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=F32, device=dev) / hd)
    freqs = pos3.to(F32)[..., None] * inv               # [3, B, S, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)             # [3, B, S, hd]
    sel = torch.as_tensor(mrope_channels(hd, sections), device=dev)
    eff = torch.gather(emb.permute(1, 2, 3, 0), -1,
                       sel[None, None, :, None].expand(
                           emb.shape[1:] + (1,)))[..., 0]
    return torch.cos(eff), torch.sin(eff)


def rope_index(input_ids: np.ndarray, image_grids: List[Tuple[int, int, int]],
               cfg: Qwen2VLConfig, merge: Optional[int] = None
               ) -> np.ndarray:
    """The 3-D position ids [3, B, S] of a prompt with images, on the host
    (HF's ``get_rope_index``; images only, no padding): an image span's
    positions count its merged (t, h, w) grid from the position before
    it, and the text after it resumes one past the span's largest."""
    merge = merge or cfg.spatial_merge_size
    ids = np.asarray(input_ids)
    B, S = ids.shape
    out = np.zeros((3, B, S), np.int32)
    img_idx = 0
    for b in range(B):
        row = ids[b]
        pos, s = 0, 0
        while s < S:
            if row[s] == cfg.image_token_id:
                t, h, w = (int(v) for v in image_grids[img_idx])
                img_idx += 1
                lh, lw = h // merge, w // merge
                n = t * lh * lw
                out[0, b, s:s + n] = pos + np.repeat(np.arange(t), lh * lw)
                out[1, b, s:s + n] = pos + np.tile(
                    np.repeat(np.arange(lh), lw), t)
                out[2, b, s:s + n] = pos + np.tile(np.arange(lw), t * lh)
                pos += max(t, lh, lw)
                s += n
            else:
                out[:, b, s] = pos
                pos += 1
                s += 1
    return out


def text_pos3(input_ids: torch.Tensor) -> torch.Tensor:
    """The three streams of a text-only prompt: each the positions 0..S-1."""
    B, S = input_ids.shape
    p = torch.arange(S, device=input_ids.device)
    return p[None, None, :].expand(3, B, S)


# --------------------------------------------------------------------------
# Full forward
# --------------------------------------------------------------------------

def merge_image_embeds(text_embeds: torch.Tensor, image_feats: torch.Tensor,
                       input_ids: torch.Tensor, image_token: int
                       ) -> torch.Tensor:
    """The k-th image placeholder of the batch row takes ``image_feats[k]``
    (one shared [N, D] feature list, clamped as a JAX gather clamps)."""
    is_img = input_ids == image_token
    k = torch.clamp(torch.cumsum(is_img.to(torch.long), dim=1) - 1, 0,
                    image_feats.shape[0] - 1)
    return torch.where(is_img[..., None],
                       image_feats[k].to(text_embeds.dtype), text_embeds)


def lm_inputs(params: Dict, cfg: Qwen2VLConfig, input_ids: torch.Tensor,
              pixel_patches: Optional[torch.Tensor] = None,
              grid_thw: Optional[Tuple[int, int, int]] = None, qmap=None):
    """Block 0's input and its M-RoPE tables: (x, cos, sin).  ``qmap`` is
    the deploy; the tower takes only its ``vision`` QMap."""
    tc = cfg.text
    x = L.embed_apply(params, tc, input_ids)
    if pixel_patches is not None:
        feats = vision_forward(params['vision'], cfg, pixel_patches,
                               grid_thw, qmap=vision_qmap(qmap))
        x = merge_image_embeds(x, feats, input_ids, cfg.image_token_id)
        pos3 = torch.as_tensor(rope_index(input_ids.cpu().numpy(),
                                          [grid_thw], cfg),
                               device=input_ids.device)
    else:
        pos3 = text_pos3(input_ids)
    cos, sin = mrope_cos_sin(tc, pos3, cfg.mrope_section)
    return x, cos, sin


def qwen2vl_forward(params: Dict, cfg: Qwen2VLConfig, input_ids: torch.Tensor,
                    pixel_patches: Optional[torch.Tensor] = None,
                    grid_thw: Optional[Tuple[int, int, int]] = None,
                    qmap=None) -> torch.Tensor:
    """The merged-modal forward to f32 logits; a packed head takes the
    QMap's ``lm_head`` entry."""
    tc = cfg.text
    x, cos, sin = lm_inputs(params, cfg, input_ids, pixel_patches, grid_thw,
                            qmap)
    for bp in params['blocks']:
        x, _ = L.block_apply(bp, tc, x, cos, sin, qmap=qmap)
    return L.head_apply(params, tc, x, qmap=qmap)


# --------------------------------------------------------------------------
# Random init and the HF checkpoint mapping
# --------------------------------------------------------------------------

def init_params(cfg: Qwen2VLConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` in the reference's tree and
    scales: the LM's, the tower's blocks, its patch projection and the
    merger."""
    params = L.init_params(cfg.text, generator, dtype=dtype, device=device)
    vc = cfg.vision
    vis = L.init_params(vc, generator, dtype=dtype or vc.tdtype,
                        device=device)
    ini = L.Init(generator, dtype or vc.tdtype, device)
    D = vc.hidden_size
    mh = D * cfg.spatial_merge_size ** 2
    td = cfg.text.hidden_size
    params['vision'] = {
        'patch_proj': {'w': ini.normal((D, cfg.patch_dim), 0.02), 'b': None},
        'blocks': vis['blocks'],
        'merger': {
            'ln_q': ini.norm(D, bias=True),
            'mlp_0': {'w': ini.normal((mh, mh), 0.6 / mh ** 0.5),
                      'b': ini.norm(mh, bias=True)['b']},
            'mlp_2': {'w': ini.normal((td, mh), 0.6 / mh ** 0.5),
                      'b': ini.norm(td, bias=True)['b']},
        },
    }
    return params


def params_from_hf(flat, cfg: Qwen2VLConfig) -> Dict:
    """Qwen2VLForConditionalGeneration tensors (the post-4.52
    ``model.language_model.`` / ``model.visual.`` layout and the older
    ``model.`` / ``visual.`` one) onto the params tree; the tower's fused
    ``attn.qkv`` splits into q / k / v."""
    from .hf_loader import hf_linear, hf_norm, llama_params_from_hf
    norm = {}
    for name in flat.keys():
        n = name
        if n.startswith('model.language_model.'):
            n = 'model.' + n[len('model.language_model.'):]
        if n.startswith('model.visual.'):
            n = n[len('model.'):]
        norm[n] = flat[name]
    text = {k: v for k, v in norm.items() if not k.startswith('visual.')}
    params = llama_params_from_hf(text, cfg.text.num_hidden_layers,
                                  cfg.text.tie_word_embeddings)
    D = cfg.vision.hidden_size
    blocks = []
    for i in range(cfg.vision.num_hidden_layers):
        b = f'visual.blocks.{i}'
        qkv = hf_linear(norm, f'{b}.attn.qkv')
        ws = torch.chunk(qkv['w'], 3, dim=0)
        bs = (torch.chunk(qkv['b'], 3) if qkv['b'] is not None
              else (None,) * 3)
        blocks.append({
            'input_layernorm': hf_norm(norm, f'{b}.norm1'),
            'self_attn': {
                **{n: {'w': w.contiguous(),
                       'b': None if bb is None else bb.contiguous()}
                   for n, w, bb in zip(('q_proj', 'k_proj', 'v_proj'), ws,
                                       bs)},
                'o_proj': hf_linear(norm, f'{b}.attn.proj')},
            'post_attention_layernorm': hf_norm(norm, f'{b}.norm2'),
            'mlp': {'up_proj': hf_linear(norm, f'{b}.mlp.fc1'),
                    'down_proj': hf_linear(norm, f'{b}.mlp.fc2')},
        })
    params['vision'] = {
        'patch_proj': {'w': norm['visual.patch_embed.proj.weight']
                       .reshape(D, -1), 'b': None},
        'blocks': blocks,
        'merger': {'ln_q': hf_norm(norm, 'visual.merger.ln_q'),
                   'mlp_0': hf_linear(norm, 'visual.merger.mlp.0'),
                   'mlp_2': hf_linear(norm, 'visual.merger.mlp.2')},
    }
    return params
