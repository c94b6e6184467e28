"""Functional ViT, the ImageNet classifier (port of ``llmc_tpu/models/vit.py``):
HF ViTForImageClassification's layout (the patch conv, pre / post
LayerNorms, separate query / key / value, a GELU MLP, the classifier head).
Its matmuls are plain torch ops on both devices, as the reference's run
outside any Pallas kernel.

The subsets are the reference's ViT entries: qkv (after
``layernorm_before``), the attention output (after the value), the
intermediate (after ``layernorm_after``) and the output (after the
intermediate).  The quantized attention's pseudo-paths
(``attention.matmul_1`` / ``matmul_2`` / ``softmax``, ``act_fn``) reach
its internals through ``attn_act_fq``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .base import (BlockLayout, SubsetSpec, attn_act_fq, layer_norm,
                   linear_apply)
from .llama import Init

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class VitConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    layer_norm_eps: float = 1e-12
    num_labels: int = 1000
    dtype: str = 'float32'

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf(cls, hf: dict) -> 'VitConfig':
        return cls(image_size=hf.get('image_size', 224),
                   patch_size=hf.get('patch_size', 16),
                   num_channels=hf.get('num_channels', 3),
                   hidden_size=hf['hidden_size'],
                   intermediate_size=hf['intermediate_size'],
                   num_hidden_layers=hf['num_hidden_layers'],
                   num_attention_heads=hf['num_attention_heads'],
                   layer_norm_eps=hf.get('layer_norm_eps', 1e-12),
                   num_labels=len(hf.get('id2label', {})) or 1000)


def _qc(qmap, path: str):
    return qmap.get(path) if qmap is not None else None


def patch_embed(params: Dict, cfg: VitConfig, pixels: torch.Tensor
                ) -> torch.Tensor:
    """pixels [B, C, H, W] -> tokens [B, 1+N, D]: the patch conv as unfold
    + matmul, the CLS token and the learned positions."""
    B = pixels.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    kern = params['patch_proj']['w']             # [D, C, p, p]
    D = kern.shape[0]
    x = pixels.reshape(B, cfg.num_channels, g, p, g, p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, -1, cfg.num_channels * p * p)
    toks = torch.einsum('bnc,dc->bnd', x.to(F32), kern.reshape(D, -1).to(F32))
    if params['patch_proj'].get('b') is not None:
        toks = toks + params['patch_proj']['b'].to(F32)
    cls = params['cls_token'].to(F32).reshape(1, 1, D).expand(B, 1, D)
    toks = torch.cat([cls, toks], dim=1)
    return (toks + params['pos_embed'].to(F32)).to(cfg.tdtype)


def attention_apply(p: Dict, cfg: VitConfig, h: torch.Tensor, qmap=None):
    """Self-attention with the quantized attention's fake-quants: q and k
    at ``attention.matmul_1``, the scores at ``attention.softmax``, the
    probabilities and v at ``attention.matmul_2``.  Returns (out, o_in)."""
    B, S, D = h.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    q = linear_apply(p['query'], h, _qc(qmap, 'attention.query')).reshape(
        B, S, H, hd)
    k = linear_apply(p['key'], h, _qc(qmap, 'attention.key')).reshape(
        B, S, H, hd)
    v = linear_apply(p['value'], h, _qc(qmap, 'attention.value')).reshape(
        B, S, H, hd)
    q = attn_act_fq(qmap, 'attention.matmul_1', q)
    k = attn_act_fq(qmap, 'attention.matmul_1', k)
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32), k.to(F32)) \
        / (hd ** 0.5)
    scores = attn_act_fq(qmap, 'attention.softmax', scores)
    probs = torch.softmax(scores, dim=-1).to(h.dtype)
    probs = attn_act_fq(qmap, 'attention.matmul_2', probs)
    v = attn_act_fq(qmap, 'attention.matmul_2', v)
    ctx = torch.einsum('bhqk,bkhd->bqhd', probs.to(F32),
                       v.to(F32)).to(h.dtype)
    o_in = ctx.reshape(B, S, D)
    return linear_apply(p['out'], o_in, _qc(qmap, 'attention.out')), o_in


def block_apply(bp: Dict, cfg: VitConfig, x: torch.Tensor, qmap=None,
                capture: bool = False):
    """One pre-LN encoder block.  Returns (y, captures): qkv_in, o_in,
    fc1_in, fc2_in where ``capture``."""
    caps = {}
    eps = cfg.layer_norm_eps
    h = layer_norm(x, bp['layernorm_before']['w'],
                   bp['layernorm_before'].get('b'), eps)
    if capture:
        caps['qkv_in'] = h
    attn_out, o_in = attention_apply(bp['attention'], cfg, h, qmap)
    if capture:
        caps['o_in'] = o_in
    x = x + attn_out
    h = layer_norm(x, bp['layernorm_after']['w'],
                   bp['layernorm_after'].get('b'), eps)
    if capture:
        caps['fc1_in'] = h
    f1 = linear_apply(bp['intermediate'], h, _qc(qmap, 'intermediate'))
    f1 = attn_act_fq(qmap, 'act_fn', f1)
    f1 = torch.nn.functional.gelu(f1.to(F32)).to(x.dtype)
    if capture:
        caps['fc2_in'] = f1
    return x + linear_apply(bp['output'], f1, _qc(qmap, 'output')), caps


def vit_layout(cfg: VitConfig) -> BlockLayout:
    subsets = (
        SubsetSpec(name='qkv', layers=('attention.query', 'attention.key',
                                       'attention.value'),
                   prev_op='layernorm_before', prev_kind='ln',
                   input_key='qkv_in', inspect='attn', has_kwargs=True),
        SubsetSpec(name='out', layers=('attention.out',),
                   prev_op='attention.value', prev_kind='fc',
                   input_key='o_in', inspect='out'),
        SubsetSpec(name='fc1', layers=('intermediate',),
                   prev_op='layernorm_after', prev_kind='ln',
                   input_key='fc1_in', inspect='fc1', is_mlp=True),
        SubsetSpec(name='fc2', layers=('output',),
                   prev_op='intermediate', prev_kind='fc',
                   input_key='fc2_in', inspect='fc2', is_mlp=True),
    )
    linears = ('attention.query', 'attention.key', 'attention.value',
               'attention.out', 'intermediate', 'output')
    capture_of = (('attention.query', 'qkv_in'), ('attention.key', 'qkv_in'),
                  ('attention.value', 'qkv_in'), ('attention.out', 'o_in'),
                  ('intermediate', 'fc1_in'), ('output', 'fc2_in'))
    return BlockLayout(subsets=subsets, linears=linears,
                       layernorms=('layernorm_before', 'layernorm_after'),
                       capture_of=capture_of)


def make_inspect_fns(cfg: VitConfig):
    """(bp, subset input, kwargs) -> subset output; the linear subsets run
    unquantized, as in the reference."""
    def attn(bp, h, kw, qmap=None):
        return attention_apply(bp['attention'], cfg, h, qmap)[0]

    def out(bp, o_in, kw, qmap=None):
        return linear_apply(bp['attention']['out'], o_in)

    def fc1(bp, h, kw, qmap=None):
        return linear_apply(bp['intermediate'], h)

    def fc2(bp, h, kw, qmap=None):
        return linear_apply(bp['output'], h)
    return {'attn': attn, 'out': out, 'fc1': fc1, 'fc2': fc2}


def classify(params: Dict, cfg: VitConfig, pixels: torch.Tensor,
             qmap=None) -> torch.Tensor:
    """Pixels -> f32 class logits [B, num_labels] (the classifier reads the
    final LayerNorm of the CLS token; it takes no QMap)."""
    x = patch_embed(params, cfg, pixels)
    for bp in params['blocks']:
        x, _ = block_apply(bp, cfg, x, qmap=qmap)
    x = layer_norm(x, params['layernorm']['w'], params['layernorm'].get('b'),
                   cfg.layer_norm_eps)
    return linear_apply(params['classifier'], x[:, 0]).to(F32)


def init_params(cfg: VitConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None, device=None) -> Dict:
    """Random params from ``generator`` (the reference builds a ViT from a
    checkpoint only): linears N(0, 0.6 / sqrt(in)) with zero biases, the
    patch conv, CLS token and positions N(0, 0.02), LayerNorms of ones with
    zero biases."""
    ini = Init(generator, dtype or cfg.tdtype, device)
    D, I, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    blocks = [{'layernorm_before': ini.norm(D, bias=True),
               'attention': {n: ini.lin(D, D, bias=True)
                             for n in ('query', 'key', 'value', 'out')},
               'layernorm_after': ini.norm(D, bias=True),
               'intermediate': ini.lin(I, D, bias=True),
               'output': ini.lin(D, I, bias=True)}
              for _ in range(cfg.num_hidden_layers)]
    return {'patch_proj': {'w': ini.normal((D, cfg.num_channels, p, p),
                                           0.02),
                           'b': ini.norm(D, bias=True)['b']},
            'cls_token': ini.normal((D,), 0.02),
            'pos_embed': ini.normal((1 + cfg.num_patches, D), 0.02),
            'blocks': blocks,
            'layernorm': ini.norm(D, bias=True),
            'classifier': ini.lin(cfg.num_labels, D, bias=True)}


def params_from_hf(flat, cfg: VitConfig) -> Dict:
    from .hf_loader import hf_linear

    def lin(pre):
        return hf_linear(flat, pre)

    blocks = []
    for i in range(cfg.num_hidden_layers):
        b = f'vit.encoder.layer.{i}'
        blocks.append({
            'layernorm_before': lin(f'{b}.layernorm_before'),
            'attention': {
                'query': lin(f'{b}.attention.attention.query'),
                'key': lin(f'{b}.attention.attention.key'),
                'value': lin(f'{b}.attention.attention.value'),
                'out': lin(f'{b}.attention.output.dense')},
            'layernorm_after': lin(f'{b}.layernorm_after'),
            'intermediate': lin(f'{b}.intermediate.dense'),
            'output': lin(f'{b}.output.dense'),
        })
    return {
        'patch_proj': lin('vit.embeddings.patch_embeddings.projection'),
        'cls_token': flat['vit.embeddings.cls_token'][0],
        'pos_embed': flat['vit.embeddings.position_embeddings'][0],
        'blocks': blocks,
        'layernorm': lin('vit.layernorm'),
        'classifier': lin('classifier'),
    }
