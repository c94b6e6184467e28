"""Packed-weight model construction (port of ``llmc_tpu/serve/packed.py``).

The packed param tree is the serving artifact consumed by the
dequant-matmul kernels: W4A16, W4A8 (``a_int8``: per-token int8
activations on the block linears, the head stays weight-only), W8A16
(``QuantSpec(bit=8)``) and the per-channel int8 companion copy
(``w8_prefill``: ``qweight8`` / ``scales8`` beside every block linear,
read through ``prefill_qmap_from``'s QMap).  Activation fake-quant
(``a_spec``) is not ported yet (ROADMAP A10) and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models.adapter import QMap
from ..models.base import LinearQcfg, get_path, set_path
from ..ops.dequant_matmul import (QMeta, _quant_act_token, dequant_weight,
                                  pack_scales_t, pack_weight)
from ..quant.qspec import QuantSpec
from ..quant.quantizer import real_quant_weight
from ..utils.device import resolve_device

F32 = torch.float32


def _no_a_spec(a_spec) -> None:
    if a_spec is not None:
        raise NotImplementedError(
            'activation fake-quant (a_spec) is not ported yet (ROADMAP A10)')


def _linear_dims(cfg):
    """path -> (out_features, in_features) for Llama-family blocks."""
    D = cfg.hidden_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    I = cfg.intermediate_size
    return {
        'self_attn.q_proj': (H * hd, D),
        'self_attn.k_proj': (KVH * hd, D),
        'self_attn.v_proj': (KVH * hd, D),
        'self_attn.o_proj': (D, H * hd),
        'mlp.gate_proj': (I, D),
        'mlp.up_proj': (I, D),
        'mlp.down_proj': (D, I),
    }


def _meta(wspec: QuantSpec, out_f: int, in_f: int, pre_t: bool) -> QMeta:
    gs = wspec.group_size if wspec.granularity == 'per_group' else 0
    return QMeta(bits=int(wspec.bit), group_size=gs or in_f,
                 symmetric=wspec.symmetric, out_features=out_f,
                 in_features=in_f, pre_t=pre_t)


def packed_qmap(cfg, wspec: QuantSpec, a_spec: Optional[QuantSpec] = None,
                fuse: bool = False, pre_t: bool = False, head: bool = False,
                a_int8: bool = False) -> QMap:
    """QMap whose entries carry per-layer QMeta for the kernel path;
    ``fuse`` adds the qkv_proj / gate_up_proj entries, ``head`` the packed
    lm_head.  ``a_int8`` (W4A8) applies to the block linears; the head
    stays weight-only, its logits feed sampling."""
    _no_a_spec(a_spec)
    pre_t = pre_t and int(wspec.bit) == 4
    dims = dict(_linear_dims(cfg))
    if fuse:
        D = cfg.hidden_size
        H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        dims['self_attn.qkv_proj'] = ((H + 2 * KVH) * hd, D)
        dims['mlp.gate_up_proj'] = (2 * cfg.intermediate_size, D)
    if head and not cfg.tie_word_embeddings:
        dims['lm_head'] = (cfg.vocab_size, cfg.hidden_size)
    return QMap({path: LinearQcfg(w_packed=True,
                                  qmeta=_meta(wspec, o, i, pre_t),
                                  a_int8=a_int8 and path != 'lm_head')
                 for path, (o, i) in dims.items()})


def prefill_qmap_from(qmap: QMap) -> QMap:
    """The w8-companion QMap of a serving QMap: every packed block linear
    is rerouted through ('qweight8', 'scales8') with the per-channel W8A8
    dot; the lm_head keeps its packed weight-only entry.  Every other
    field of an entry is kept."""
    entries = {}
    for path, qc in qmap._d.items():
        if qc is None or not qc.w_packed or path == 'lm_head':
            entries[path] = qc
            continue
        m = qc.qmeta
        entries[path] = dataclasses.replace(
            qc, a_int8=True, w8_alt=True,
            qmeta=QMeta(bits=8, group_size=m.in_features, symmetric=True,
                        out_features=m.out_features,
                        in_features=m.in_features))
    return QMap(entries, default=qmap._default)


def w8_companion(w: torch.Tensor):
    """(codes int8 [N, K], scales [N]) per-channel symmetric int8 of a
    weight: the companion copy, by the activation quantizer's recipe
    (per 'row' symmetric, / 127) so that all int8 paths share one.  The
    reference packs eagerly, where ``max(ax, 1e-8) / 127.0`` is a true
    division: so is this one (``folded=False``)."""
    q, s8 = _quant_act_token(w, folded=False)
    return q, s8[:, 0]


def _pack_linear(lin: Dict, wspec: QuantSpec, pre_t: bool,
                 up=None, low=None, w8_prefill: bool = False) -> Dict:
    w = lin['w']
    codes, scales, zeros = real_quant_weight(wspec, w.to(F32),
                                             up_factor=up, low_factor=low)
    meta = _meta(wspec, w.shape[0], w.shape[1], False)
    qw, s, z = pack_weight(codes.to(torch.int8), scales, zeros, meta)
    if pre_t:
        st, zst = pack_scales_t(s, z, meta)
        new = {'qweight': qw, 'scales': st, 'zeros': zst, 'b': lin.get('b')}
    else:
        new = {'qweight': qw, 'scales': s, 'b': lin.get('b')}
        if z is not None:
            new['zeros'] = z
    if w8_prefill:
        # the companion quantizes the dequantized weight (what w4 serves),
        # from the un-transposed scales and zeros whatever pre_t says
        new['qweight8'], new['scales8'] = w8_companion(
            dequant_weight(qw, s, z, meta))
    return new


def pack_block(block: Dict, cfg, wspec: QuantSpec, layout,
               fuse: bool = False, pre_t: bool = False,
               w8_prefill: bool = False) -> Dict:
    """Replace each linear's fp weight with packed codes + scales;
    ``w8_prefill`` stores the per-channel int8 companion beside them."""
    pre_t = pre_t and int(wspec.bit) == 4
    for path in layout.linears:
        lin = get_path(block, path)
        block = set_path(block, path, _pack_linear(
            lin, wspec, pre_t, lin.get('clip_up'), lin.get('clip_low'),
            w8_prefill=w8_prefill))
    if fuse:
        block = fuse_packed_block(block)
    return block


def _concat_packed(lins):
    out = {'qweight': torch.cat([l['qweight'] for l in lins], 0)}
    if 'qweight8' in lins[0]:
        out['qweight8'] = torch.cat([l['qweight8'] for l in lins], 0)
        out['scales8'] = torch.cat([l['scales8'] for l in lins], 0)
    # pre_t scales [ng, N] concat on N (axis 1); legacy [N, ng] on 0
    sa = 1 if lins[0]['scales'].shape[1] == lins[0]['qweight'].shape[0] \
        else 0
    out['scales'] = torch.cat([l['scales'] for l in lins], sa).contiguous()
    if 'zeros' in lins[0]:
        out['zeros'] = torch.cat([l['zeros'] for l in lins],
                                 sa).contiguous()
    bs = [l.get('b') for l in lins]
    out['b'] = (torch.cat(bs, 0) if all(b is not None for b in bs)
                else None)
    return out


def fuse_packed_block(block: Dict) -> Dict:
    """Merge packed q/k/v and gate/up into single serving linears."""
    a = block.get('self_attn', {})
    if all(k in a for k in ('q_proj', 'k_proj', 'v_proj')):
        a = dict(a)
        a['qkv_proj'] = _concat_packed([a.pop('q_proj'), a.pop('k_proj'),
                                        a.pop('v_proj')])
        block = dict(block, self_attn=a)
    m = block.get('mlp', {})
    if 'gate_proj' in m and 'up_proj' in m:
        m = dict(m)
        m['gate_up_proj'] = _concat_packed([m.pop('gate_proj'),
                                            m.pop('up_proj')])
        block = dict(block, mlp=m)
    return block


def pack_head(params: Dict, cfg, wspec: QuantSpec,
              pre_t: bool = True) -> Dict:
    """Real-quantize + pack the lm_head weight (weight-only)."""
    if cfg.tie_word_embeddings or params.get('lm_head') is None:
        return params
    lin = params['lm_head']
    if 'qweight' in lin or lin.get('w') is None:
        return params
    pre_t = pre_t and int(wspec.bit) == 4
    return dict(params, lm_head=_pack_linear(lin, wspec, pre_t))


def pack_model(model, wspec: QuantSpec, a_spec: Optional[QuantSpec] = None,
               fuse: bool = False, pre_t: bool = True, head: bool = False,
               a_int8: bool = False, w8_prefill: bool = False) -> QMap:
    """In place: pack every block's linears; returns the serving QMap.
    ``a_int8`` serves W4A8; ``w8_prefill`` also stores each block linear's
    per-channel int8 companion (twice the weight bytes)."""
    _no_a_spec(a_spec)
    layout = model.get_layout()
    for i in range(model.n_blocks):
        model.set_block(i, pack_block(model.blocks[i], model.cfg, wspec,
                                      layout, fuse=fuse, pre_t=pre_t,
                                      w8_prefill=w8_prefill))
    if head:
        model.params = pack_head(model.params, model.cfg, wspec,
                                 pre_t=pre_t)
    return packed_qmap(model.cfg, wspec, fuse=fuse, pre_t=pre_t,
                       head=head and not model.cfg.tie_word_embeddings,
                       a_int8=a_int8)


def random_packed_llama(cfg, wspec: QuantSpec, seed: int = 0,
                        fuse: bool = False, pre_t: bool = True,
                        head: bool = True, a_int8: bool = False,
                        device=None):
    """A Llama adapter whose linears are random packed codes (uint8
    nibble bytes for 4 bits, signed int8 codes with legacy ``[N, ng]``
    scales for 8), drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``None``: the CUDA device) — for serving and benches
    without fp weights.  Scales follow the reference's: 0.008, and
    for symmetric pre_t storage zs = 0.008 * 8."""
    from ..models.adapter import LlamaAdapter
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = cfg.hidden_size
    dt = cfg.tdtype
    gs = wspec.group_size if wspec.granularity == 'per_group' else None
    pre_t = pre_t and int(wspec.bit) == 4

    def packed_lin(out_f, in_f):
        if int(wspec.bit) == 4:
            qw = torch.randint(0, 256, (out_f, in_f // 2), generator=gen,
                               device=dev, dtype=torch.uint8)
        else:
            qw = torch.randint(-128, 128, (out_f, in_f), generator=gen,
                               device=dev, dtype=torch.int8)
        ng = in_f // (gs or in_f)
        if pre_t:
            zs = 0.0 if wspec.symmetric is False else 0.008 * 8.0
            return {'qweight': qw,
                    'scales': torch.full((ng, out_f), 0.008, dtype=F32,
                                         device=dev),
                    'zeros': torch.full((ng, out_f), zs, dtype=F32,
                                        device=dev),
                    'b': None}
        return {'qweight': qw,
                'scales': torch.full((out_f, ng), 0.008, dtype=F32,
                                     device=dev), 'b': None}

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=F32, device=dev)
                * 0.02).to(dt)

    blocks = []
    for _ in range(cfg.num_hidden_layers):
        blk = {'input_layernorm': {'w': torch.ones((D,), dtype=dt,
                                                   device=dev)},
               'post_attention_layernorm': {'w': torch.ones(
                   (D,), dtype=dt, device=dev)},
               'self_attn': {}, 'mlp': {}}
        for path, (out_f, in_f) in _linear_dims(cfg).items():
            comp, lname = path.split('.')
            blk[comp][lname] = packed_lin(out_f, in_f)
        if fuse:
            blk = fuse_packed_block(blk)
        blocks.append(blk)
    if head and not cfg.tie_word_embeddings:
        lm_head = packed_lin(cfg.vocab_size, D)
    else:
        lm_head = {'w': normal((cfg.vocab_size, D)), 'b': None}
    params = {'embed_tokens': {'w': normal((cfg.vocab_size, D))},
              'blocks': blocks,
              'norm': {'w': torch.ones((D,), dtype=dt, device=dev)},
              'lm_head': lm_head}
    return LlamaAdapter(cfg, params), packed_qmap(
        cfg, wspec, fuse=fuse, pre_t=pre_t,
        head=head and not cfg.tie_word_embeddings, a_int8=a_int8)
