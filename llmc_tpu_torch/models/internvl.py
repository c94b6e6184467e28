"""InternVL 2 / 2.5 / 3 in the HF-native layout: the InternViT tower, a
pixel shuffle, an MLP projector and a Qwen2 / Llama LM (port of
``llmc_tpu/models/internvl.py``).

The tower runs on the generalized block graph (``models/llama.py``) with
InternViT's two options: ``layer_scale`` (the per-channel lambda_1 /
lambda_2 on each sublayer's output) and ``qk_norm_full`` (InternViT-6B's
RMS q / k norm over the whole embed dim, before the head split).  The
tower, the projector and their attention are plain torch matmuls on both
devices (the reference computes them outside any Pallas kernel); only the
LM's linears and head reach the port's kernels, through a packed serving
QMap.  The tower reads only a ``ModalQMap``'s ``vision`` QMap
(``llava.vision_qmap``): the reference's forward hands it none, so its
calibrated tower reaches no eval (ROADMAP C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import llama as L
from .base import layer_norm, linear_apply
from .llava import merge_embeddings, vision_qmap

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    text: L.LlamaConfig
    vision: L.LlamaConfig
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    image_token_id: int = 151667
    downsample_ratio: float = 0.5
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = 'default'   # drop CLS
    projector_act: str = 'gelu'
    use_abs_pos: bool = True
    final_layernorm: bool = True      # not use_mean_pooling

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def image_seq_length(self) -> int:
        r = self.downsample_ratio
        return int(self.num_patches * r * r)

    @staticmethod
    def vit_block_cfg(hidden: int, intermediate: int, layers: int,
                      heads: int, act: str = 'gelu',
                      norm_type: str = 'ln', qk_norm: bool = False,
                      attention_bias: bool = True,
                      eps: float = 1e-6) -> L.LlamaConfig:
        return L.LlamaConfig(
            vocab_size=1, hidden_size=hidden,
            intermediate_size=intermediate, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=heads,
            head_dim=hidden // heads, rms_norm_eps=eps,
            norm_type=norm_type, rotary_pct=0.0, gated_mlp=False,
            act_fn=act, attention_bias=attention_bias, mlp_bias=True,
            layer_scale=True, qk_norm_full=qk_norm, dtype='float32')


# --------------------------------------------------------------------------
# Vision tower
# --------------------------------------------------------------------------

def vit_embed(vp: Dict, cfg: InternVLConfig, pixels: torch.Tensor
              ) -> torch.Tensor:
    """pixels [B, C, H, W] -> [B, 1+N, D]: the patch conv as unfold +
    matmul, the CLS token, absolute positions."""
    B = pixels.shape[0]
    p = cfg.patch_size
    kern = vp['patch_proj']['w']                       # [D, C, p, p]
    D = kern.shape[0]
    g = cfg.image_size // p
    x = pixels.reshape(B, cfg.num_channels, g, p, g, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, -1, cfg.num_channels * p * p)
    toks = torch.einsum('bnc,dc->bnd', x.to(F32), kern.reshape(D, -1).to(F32))
    if vp['patch_proj'].get('b') is not None:
        toks = toks + vp['patch_proj']['b'].to(F32)
    cls = vp['class_emb'].to(F32)[None, None].expand(B, 1, D)
    toks = torch.cat([cls, toks], dim=1)
    if cfg.use_abs_pos:
        toks = toks + vp['pos_embed'].to(F32)
    return toks.to(kern.dtype)


def vision_features(vp: Dict, cfg: InternVLConfig, pixels: torch.Tensor,
                    qmap=None) -> torch.Tensor:
    """The tower's selected hidden state, the final LayerNorm at layer -1,
    CLS dropped under 'default'.  ``qmap`` is the tower's own policy."""
    x = vit_embed(vp, cfg, pixels)
    vc = cfg.vision
    nl = vc.num_hidden_layers
    fl = cfg.vision_feature_layer
    upto = fl % nl + 1 if fl < 0 else fl
    no_mask = torch.zeros((1, 1, 1, 1), dtype=F32, device=x.device)
    for bp in vp['blocks'][:upto]:
        x, _ = L.block_apply(bp, vc, x, None, None, attn_bias=no_mask,
                             qmap=qmap)
    if fl == -1 and cfg.final_layernorm and 'post_ln' in vp:
        x = layer_norm(x, vp['post_ln']['w'], vp['post_ln'].get('b'),
                       vc.rms_norm_eps)
    if cfg.vision_feature_select_strategy == 'default':
        x = x[:, 1:]
    return x


def pixel_shuffle(feats: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """[B, N, C] (N square) -> [B, N*scale^2, C/scale^2], HF's view /
    permute sequence."""
    B, N, C = feats.shape
    fs = int(round(N ** 0.5))
    h2 = int(fs * scale)
    x = feats.reshape(B, fs, h2, int(C / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(B, h2, int(fs * scale), int(C / scale ** 2))
    x = x.permute(0, 2, 1, 3)
    return x.reshape(B, -1, x.shape[-1])


def project_features(pp: Dict, cfg: InternVLConfig, feats: torch.Tensor
                     ) -> torch.Tensor:
    h = layer_norm(feats, pp['layer_norm']['w'], pp['layer_norm'].get('b'),
                   1e-5)
    h = linear_apply(pp['linear_1'], h)
    h = L._act(h.to(F32), cfg.projector_act).to(feats.dtype)
    return linear_apply(pp['linear_2'], h)


def image_features(params: Dict, cfg: InternVLConfig, pixels: torch.Tensor,
                   qmap=None) -> torch.Tensor:
    """pixels [B, C, H, W] -> projected image tokens [B, N', lm_hidden];
    ``qmap`` is the tower's own policy."""
    f = vision_features(params['vision'], cfg, pixels, qmap=qmap)
    f = pixel_shuffle(f, cfg.downsample_ratio)
    return project_features(params['projector'], cfg, f)


# --------------------------------------------------------------------------
# Full forward
# --------------------------------------------------------------------------

def lm_embeds(params: Dict, cfg: InternVLConfig, input_ids: torch.Tensor,
              pixel_values: Optional[torch.Tensor] = None, qmap=None
              ) -> torch.Tensor:
    """Block 0's input: the token embeddings with the image tokens merged
    in; the tower takes only the deploy's ``vision`` QMap."""
    x = L.embed_apply(params, cfg.text, input_ids)
    if pixel_values is not None:
        feats = image_features(params, cfg, pixel_values,
                               qmap=vision_qmap(qmap))
        x = merge_embeddings(x, feats, input_ids, cfg.image_token_id)
    return x


def internvl_forward(params: Dict, cfg: InternVLConfig,
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

def init_params(cfg: InternVLConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params drawn from ``generator`` in the reference's tree and
    scales: the LM's, the tower's blocks (layer scale 0.1), its patch conv,
    CLS token, positions and final LayerNorm, and the projector."""
    params = L.init_params(cfg.text, generator, dtype=dtype, device=device)
    vc = cfg.vision
    vis = L.init_params(vc, generator, dtype=dtype or vc.tdtype,
                        device=device)
    vini = L.Init(generator, dtype or vc.tdtype, device)
    ini = L.Init(generator, dtype or cfg.text.tdtype, device)
    D = vc.hidden_size
    params['vision'] = {
        'patch_proj': {'w': vini.normal(
            (D, cfg.num_channels, cfg.patch_size, cfg.patch_size), 0.02),
            'b': vini.norm(D, bias=True)['b']},
        'class_emb': vini.normal((D,), 0.02),
        'pos_embed': vini.normal((1 + cfg.num_patches, D), 0.02),
        'post_ln': vini.norm(D, bias=True),
        'blocks': vis['blocks'],
    }
    td = cfg.text.hidden_size
    pd = int(D / cfg.downsample_ratio ** 2)
    params['projector'] = {
        'layer_norm': ini.norm(pd, bias=True),
        'linear_1': {'w': ini.normal((td, pd), 0.6 / pd ** 0.5),
                     'b': ini.norm(td, bias=True)['b']},
        'linear_2': {'w': ini.normal((td, td), 0.6 / td ** 0.5),
                     'b': ini.norm(td, bias=True)['b']},
    }
    return params


def params_from_hf(flat, cfg: InternVLConfig) -> Dict:
    """InternVLForConditionalGeneration tensors (the serialized
    ``language_model.model.`` layout and the in-memory
    ``model.language_model.`` one) onto the params tree."""
    from .hf_loader import hf_linear, hf_norm, llama_params_from_hf
    norm = {}
    for name in flat.keys():
        n = name
        if n.startswith('language_model.model.'):
            n = 'model.' + n[len('language_model.model.'):]
        elif n.startswith('language_model.'):
            n = n[len('language_model.'):]
        if n.startswith('model.language_model.'):
            n = 'model.' + n[len('model.language_model.'):]
        if n.startswith(('model.vision_tower.',
                         'model.multi_modal_projector.')):
            n = n[len('model.'):]
        norm[n] = flat[name]
    text = {k: v for k, v in norm.items()
            if not k.startswith(('vision_tower.', 'multi_modal_projector.'))}
    params = llama_params_from_hf(text, cfg.text.num_hidden_layers,
                                  cfg.text.tie_word_embeddings)
    vt = 'vision_tower'
    blocks = []
    for i in range(cfg.vision.num_hidden_layers):
        b = f'{vt}.encoder.layer.{i}'
        a = f'{b}.attention'
        blk = {
            'input_layernorm': hf_norm(norm, f'{b}.layernorm_before'),
            'self_attn': {'q_proj': hf_linear(norm, f'{a}.q_proj'),
                          'k_proj': hf_linear(norm, f'{a}.k_proj'),
                          'v_proj': hf_linear(norm, f'{a}.v_proj'),
                          'o_proj': hf_linear(norm, f'{a}.projection_layer')},
            'post_attention_layernorm': hf_norm(norm, f'{b}.layernorm_after'),
            'mlp': {'up_proj': hf_linear(norm, f'{b}.mlp.fc1'),
                    'down_proj': hf_linear(norm, f'{b}.mlp.fc2')},
            'ls1': norm[f'{b}.lambda_1'],
            'ls2': norm[f'{b}.lambda_2'],
        }
        if cfg.vision.qk_norm_full:
            for n in ('q_norm', 'k_norm'):
                blk['self_attn'][n] = {'w': norm[f'{a}.{n}.weight']}
        blocks.append(blk)
    e = f'{vt}.embeddings'
    vis = {'patch_proj': hf_linear(norm, f'{e}.patch_embeddings.projection'),
           'class_emb': norm[f'{e}.cls_token'].reshape(-1),
           'blocks': blocks}
    if f'{e}.position_embeddings' in norm:
        vis['pos_embed'] = norm[f'{e}.position_embeddings'][0]
    if f'{vt}.layernorm.weight' in norm:
        vis['post_ln'] = hf_norm(norm, f'{vt}.layernorm')
    params['vision'] = vis
    params['projector'] = {
        'layer_norm': hf_norm(norm, 'multi_modal_projector.layer_norm'),
        'linear_1': hf_linear(norm, 'multi_modal_projector.linear_1'),
        'linear_2': hf_linear(norm, 'multi_modal_projector.linear_2'),
    }
    return params
