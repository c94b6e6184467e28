"""Packed-weight model construction (port of ``llmc_tpu/serve/packed.py``).

The packed param tree is the serving artifact consumed by the
dequant-matmul kernels: W4A16, W4A8 (``a_int8``: per-token int8
activations on the block linears, the head stays weight-only), W8A16
(``QuantSpec(bit=8)``) and the per-channel int8 companion copy
(``w8_prefill``: ``qweight8`` / ``scales8`` beside every block linear,
read through ``prefill_qmap_from``'s QMap).  ``a_spec`` puts a dynamic
activation fake-quant before every packed linear (the head too, as in the
reference): a W8 per-channel SmoothQuant model then serves through the W8
kernel and a W4 one through the W4 kernel, each on fake-quantized
activations.
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
from ..quant.quantizer import (QParams, masked_qparams, real_quant_weight,
                               reshape_tensor, stored_qparams, tensor_qparams)
from ..utils.device import resolve_device

F32 = torch.float32


def _linear_dims(cfg):
    """path -> (out_features, in_features) for Llama-family blocks (no
    gate where the MLP is not gated)."""
    D = cfg.hidden_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    I = cfg.intermediate_size
    dims = {
        'self_attn.q_proj': (H * hd, D),
        'self_attn.k_proj': (KVH * hd, D),
        'self_attn.v_proj': (KVH * hd, D),
        'self_attn.o_proj': (D, H * hd),
        'mlp.gate_proj': (I, D),
        'mlp.up_proj': (I, D),
        'mlp.down_proj': (D, I),
    }
    if not getattr(cfg, 'gated_mlp', True):
        del dims['mlp.gate_proj']
    return dims


def _meta(wspec: QuantSpec, out_f: int, in_f: int, pre_t: bool) -> QMeta:
    gs = wspec.group_size if wspec.granularity == 'per_group' else 0
    return QMeta(bits=int(wspec.bit), group_size=gs or in_f,
                 symmetric=wspec.symmetric, out_features=out_f,
                 in_features=in_f, pre_t=pre_t)


def packed_qmap(cfg, wspec: QuantSpec, a_spec: Optional[QuantSpec] = None,
                fuse: bool = False, pre_t: bool = False, head: bool = False,
                a_int8: bool = False) -> QMap:
    """QMap whose entries carry per-layer QMeta for the kernel path;
    ``fuse`` adds the qkv_proj / gate_up_proj entries (no gate_up for a
    non-gated MLP), ``head`` the packed lm_head (a tied model's too,
    ``pack_head``).  ``a_int8`` (W4A8) applies to the block linears; the head
    stays weight-only, its logits feed sampling.  ``a_spec`` fake-quantizes
    every entry's input."""
    pre_t = pre_t and int(wspec.bit) == 4
    dims = dict(_linear_dims(cfg))
    if fuse:
        D = cfg.hidden_size
        H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        dims['self_attn.qkv_proj'] = ((H + 2 * KVH) * hd, D)
        if 'mlp.gate_proj' in dims:
            dims['mlp.gate_up_proj'] = (2 * cfg.intermediate_size, D)
    if head:
        dims['lm_head'] = (cfg.vocab_size, cfg.hidden_size)
    return QMap({path: LinearQcfg(w_packed=True,
                                  qmeta=_meta(wspec, o, i, pre_t),
                                  a_spec=a_spec,
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


def stored_grid(lin: Dict, wspec: QuantSpec) -> Optional[QParams]:
    """The qparams a linear's method fixed at compress time (GPTQ, SpQR,
    TesseraQ, HQQ, AdaDim's output-channel choices as they stored them;
    DGQ's dual grain: scale ``dgq_s4 * dgq_s8``, zero ``dgq_z4``; QUIK's
    per-channel qparams over its int columns, ``int_mask``), as
    ``reshape_tensor`` groups the weight, where they group its columns in
    their own order as ``wspec`` does (``wspec`` then has the method's
    bits); else None.  GPTQ's act-order qparams (``perm``) group permuted
    columns, which the kernels cannot read.  DGQ's grid is the asymmetric
    4-bit one, its codes clipped to [0, 15] wherever
    ``round(127 / s8) >= 15``.  QUIK's channel qparams stand for each
    group of the channel; its fp columns are on no grid."""
    if wspec.is_float:
        return None
    t = reshape_tensor(wspec, lin['w'])
    if 'dgq_s4' in lin:
        if wspec.symmetric or int(wspec.bit) != 4:
            return None
        s = lin['dgq_s4'].to(F32) * lin['dgq_s8'].to(F32).reshape(-1, 1)
        qp = QParams(s.reshape(-1, 1), lin['dgq_z4'].to(F32).reshape(-1, 1))
    elif 'int_mask' in lin:
        qp = masked_qparams(wspec, lin['w'], lin['int_mask'][None, :])
        ng = t.shape[0] // qp.scales.shape[0]
        qp = QParams(*(v if v.ndim == 0 else v.repeat_interleave(ng, 0)
                       for v in qp))
    elif 'gptq_scales' not in lin or 'perm' in lin:
        return None
    else:
        qp = stored_qparams(lin)
    if qp.scales.numel() != t.numel() // t.shape[-1]:
        return None  # packed at another grouping than the method's
    return qp


def packed_grid(lin: Dict, wspec: QuantSpec) -> QParams:
    """The qparams packing quantizes a linear's weight with: its
    ``stored_grid``, else ``wspec``'s calibration of the weight (with its
    clip factors).  The kernels' codes are integers, so under ``round_zp``
    a float zero (HQQ's) is rounded: that moves only an element that the
    float zero's grid clips, by at most half a step."""
    qp = stored_grid(lin, wspec)
    if qp is None:
        qp = tensor_qparams(wspec, lin['w'], lin.get('clip_up'),
                            lin.get('clip_low'))[1]
    if wspec.round_zp:
        qp = QParams(qp.scales, torch.round(qp.zeros))
    return qp


def _pack_linear(lin: Dict, wspec: QuantSpec, pre_t: bool,
                 w8_prefill: bool = False) -> Dict:
    w = lin['w']
    codes, scales, zeros = real_quant_weight(wspec, w.to(F32),
                                             qp=packed_grid(lin, wspec))
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
            lin, wspec, pre_t, w8_prefill=w8_prefill))
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
    """Real-quantize + pack the lm_head weight (weight-only).  A tied
    model's head (Gemma2's 256000 rows, Bloom's 250880) is packed as a
    copy of the embedding, which the token lookup keeps reading in its
    own type; the reference leaves a tied head unpacked."""
    lin = params.get('lm_head')
    if cfg.tie_word_embeddings:
        lin = {'w': params['embed_tokens']['w'], 'b': None}
    if lin is None or 'qweight' in lin or lin.get('w') is None:
        return params
    pre_t = pre_t and int(wspec.bit) == 4
    return dict(params, lm_head=_pack_linear(lin, wspec, pre_t))


def pack_model(model, wspec: QuantSpec, a_spec: Optional[QuantSpec] = None,
               fuse: bool = False, pre_t: bool = True, head: bool = False,
               a_int8: bool = False, w8_prefill: bool = False) -> QMap:
    """In place: pack every block's linears; returns the serving QMap.
    ``a_int8`` serves W4A8; ``w8_prefill`` also stores each block linear's
    per-channel int8 companion (twice the weight bytes); ``a_spec`` the
    per-token activation fake-quant of every packed linear.

    An MoE or MLA model raises: the reference packs its every linear, the
    experts too, but its serving QMap (``packed_qmap``) names the
    Llama-family linears only, so a packed expert has no qcfg and its
    forward looks for the unpacked weight (a ``KeyError: 'w'`` at the
    engine's first admission); packed MoE serving is a feature the
    reference lacks (ROADMAP C).

    A VLM (LLaVA, Qwen2-VL, InternVL, OneVision, MiniCPM-V) packs its LM's
    blocks and head, whatever modality the engine last saw: its tower,
    projector, merger or resampler stay as they are, and the serving QMap
    reaches the LM only (``models/llava.py::vision_qmap``), where the
    reference's reaches LLaVA's, OneVision's video and MiniCPM-V's
    unpacked tower linears too and cannot serve (ROADMAP C)."""
    if hasattr(model, 'set_modality'):
        model.set_modality('language')
    unserved = [p for p in model.get_layout().linears
                if p not in _linear_dims(model.cfg)]
    if unserved:
        raise NotImplementedError(
            f'pack_model on {type(model).__name__}: the serving QMap names '
            f'the Llama-family linears only, and the reference cannot serve '
            f'its packed MoE / MLA linears ({unserved[:3]}...); serve the '
            f'model unpacked')
    layout = model.get_layout()
    for i in range(model.n_blocks):
        model.set_block(i, pack_block(model.blocks[i], model.cfg, wspec,
                                      layout, fuse=fuse, pre_t=pre_t,
                                      w8_prefill=w8_prefill))
    if head:
        model.params = pack_head(model.params, model.cfg, wspec,
                                 pre_t=pre_t)
    return packed_qmap(model.cfg, wspec, a_spec, fuse=fuse, pre_t=pre_t,
                       head=head, a_int8=a_int8)


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
    # a tied head packed too, as ``pack_head`` packs it
    lm_head = (packed_lin(cfg.vocab_size, D) if head
               else {'w': normal((cfg.vocab_size, D)), 'b': None})
    params = {'embed_tokens': {'w': normal((cfg.vocab_size, D))},
              'blocks': blocks,
              'norm': {'w': torch.ones((D,), dtype=dt, device=dev)},
              'lm_head': lm_head}
    return LlamaAdapter(cfg, params), packed_qmap(
        cfg, wspec, fuse=fuse, pre_t=pre_t, head=head, a_int8=a_int8)
