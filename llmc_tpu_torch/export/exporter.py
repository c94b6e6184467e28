"""The backend export (port of ``llmc_tpu/export/exporter.py``): real-quantize
every linear and write a backend checkpoint (``save_vllm``, ``save_sgl``,
``save_lightllm``, ``save_autoawq``, ``save_mlcllm``).

Each block is quantized and packed on the model's device, block by block
(an offloaded model's block is uploaded for it), and only the packed
tensors are copied to the host.  The checkpoint holds every tensor the
reference writes, under the same name, dtype and shape, and the same
``config.json``.  Where the reference is at fault the port departs from it
(ROADMAP C, "Reference faults the port keeps apart from"):

- a symmetric model's signed codes are offset by 2^(bits-1) for the
  AWQ-GEMM backends, and that offset is written as their zero point, as
  the compressed-tensors writer offsets them (the reference hands the
  packer negative codes with zero points of 0: the checkpoint dequantizes
  to other weights);
- a float weight format raises ``NotImplementedError`` (the reference
  raises ``ValueError`` on ``int('e4m3')`` after all its work);
- a parameter of the model that no written tensor holds (Gemma2's
  sandwich norms, a LayerNorm bias, Qwen3's q/k norms, OPT's tree) raises
  ``ValueError`` naming it (the reference writes the checkpoint without
  it).  The MoE and MLA families' routers and latent norms are written
  under their HF names (``mlp.gate.weight``,
  ``self_attn.kv_a_layernorm.weight``, ...), which the reference leaves
  out.

``safetensors`` is imported inside the functions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import torch

from ..models.base import get_path, has_path
from ..quant.qspec import QuantSpec
from ..quant.quantizer import real_quant_weight
from .formats import (awq_quant_config, export_awq_gemm_linear,
                      export_vllm_linear, stamp_config, vllm_quant_config)

F32 = torch.float32
CT_BACKENDS = ('vllm', 'sgl', 'lightllm')
AWQ_BACKENDS = ('autoawq', 'mlcllm')
# the norms whose weight every block writes, and the MoE / MLA families'
# routers and latent norms, each under its path with w -> weight, b -> bias
BLOCK_NORMS = ('input_layernorm', 'post_attention_layernorm')
BLOCK_EXTRAS = ('self_attn.q_a_layernorm', 'self_attn.kv_a_layernorm',
                'mlp.gate', 'block_sparse_moe.gate', 'mlp.shared_expert_gate')
_SUFFIX = {'w': 'weight', 'b': 'bias'}


def leaf_paths(tree, prefix: str = ''):
    """(dotted path, tensor) of every tensor leaf of a nested dict / list
    tree (None leaves skipped)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is not None:
            yield prefix, tree
        return
    for k, v in items:
        yield from leaf_paths(v, f'{prefix}.{k}' if prefix else str(k))


def check_nothing_dropped(tree, written: Iterable[str],
                          linears: Iterable[str], what: str) -> None:
    """Raise ``ValueError`` naming every tensor leaf of ``tree`` that is not
    written (``written``: leaf paths).  The leaves of a linear in
    ``linears`` other than its weight ``w`` and bias ``b`` are its qparams
    (clip factors, stored grids), which no checkpoint holds."""
    written = set(written)
    linears = tuple(f'{c}.' for c in linears)

    def qparam(p):
        return p.startswith(linears) and p.rsplit('.', 1)[1] not in ('w', 'b')
    dropped = [p for p, _ in leaf_paths(tree)
               if p not in written and not qparam(p)]
    if dropped:
        raise ValueError(
            f'{what} holds {dropped} that the checkpoint would not hold; the '
            f'writer writes the Llama and MoE / MLA names only (the '
            f'reference drops them silently: ROADMAP C)')


def check_weight_format(wspec: QuantSpec) -> None:
    if wspec.is_float:
        raise NotImplementedError(
            f'a backend export of float weights ({wspec.bit}) is not written '
            f'by the reference (it fails on int({wspec.bit!r}): ROADMAP C)')


def _real_quant(wspec: QuantSpec, lin: Dict):
    return real_quant_weight(wspec, lin['w'].to(F32),
                             up_factor=lin.get('clip_up'),
                             low_factor=lin.get('clip_low'))


def _stored_quant(wspec: QuantSpec, lin: Dict):
    """Codes from the calibration loop's stored static qparams (GPTQ /
    SpQR): the export reproduces the error-compensated quantization, not a
    fresh minmax one.  Returns (codes, scales [oc, ng], zeros | None,
    g_idx | None); with act-order qparams that follow the permuted columns,
    the codes come back in the ORIGINAL column order beside each column's
    group index (``weight_g_idx``)."""
    if int(lin.get('owq_n_out', 0)):
        raise ValueError(
            'OWQ keeps FP outlier columns; real-quant formats cannot '
            'represent them — use save_fake / save_trans instead')
    if lin.get('spqr_mask') is not None:
        raise ValueError(
            'SpQR FP outlier entries cannot be represented in dense '
            'real-quant formats — use save_fake / save_trans instead')
    w = lin['w'].to(F32)
    oc, C = w.shape
    scales = lin['gptq_scales'].to(F32).reshape(oc, -1)
    gs = C // scales.shape[1]
    z = lin.get('gptq_zeros')
    z = z.to(F32).reshape(oc, -1) if z is not None else None
    perm = lin['perm'] if lin.get('gptq_perm_qp') else None
    wq_in = w[:, perm] if perm is not None else w
    s_rep = torch.repeat_interleave(scales.clamp(min=1e-9), gs, dim=1)
    z_rep = torch.repeat_interleave(z, gs, dim=1) if z is not None else 0.0
    q = torch.clamp(torch.round(wq_in / s_rep) + z_rep, wspec.qmin,
                    wspec.qmax)
    g_idx = None
    if perm is not None:
        inv = torch.argsort(perm)
        q = q[:, inv]
        g_idx = (inv // gs).to(torch.int32)
    codes = q.to(torch.int8 if wspec.qmin != 0 else torch.uint8)
    return codes, scales, z, g_idx


def _awq_codes(codes, scales, zeros, bits: int):
    """Unsigned codes and zero points for the AWQ-GEMM layout: signed
    (symmetric) codes offset by 2^(bits-1), which becomes the zero point."""
    if codes.dtype == torch.int8:
        off = 2 ** (bits - 1)
        return codes.to(torch.int32) + off, torch.full_like(scales, off)
    return codes, zeros


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to('cpu').contiguous()


def synthetic_hf_config(model) -> Dict:
    """The minimal HF config a random model (no ``hf_config``) is written
    with, as the reference builds it."""
    c = model.cfg
    return {
        'model_type': 'llama',
        'vocab_size': c.vocab_size,
        'hidden_size': c.hidden_size,
        'intermediate_size': getattr(c, 'intermediate_size', 0),
        'num_hidden_layers': model.n_blocks,
        'num_attention_heads': c.num_attention_heads,
        'num_key_value_heads': c.num_key_value_heads,
        'torch_dtype': 'bfloat16',
    }


def export_real_quant(model, wspec: QuantSpec, quant_cfg: Dict,
                      save_path: str, backend: str = 'vllm',
                      static_input_scales: Optional[Dict] = None) -> Dict:
    """Write packed weights and the config for an external engine; returns
    the written tensors ({name: host tensor}).

    backend: vllm | sgl | lightllm (compressed-tensors) or autoawq |
    mlcllm (AWQ GEMM)."""
    from safetensors.torch import save_file
    if backend not in CT_BACKENDS + AWQ_BACKENDS:
        raise ValueError(f'unknown backend {backend!r}')
    check_weight_format(wspec)
    params = model.params
    top = {k: v for k, v in params.items() if k != 'blocks'}
    check_nothing_dropped(top, ('embed_tokens.w', 'norm.w', 'lm_head.w'),
                          (), 'the model')
    os.makedirs(save_path, exist_ok=True)
    layout = model.get_layout()
    flat: Dict[str, torch.Tensor] = {}

    def put(name, t):
        if t is not None:
            flat[name] = _host(t)

    put('model.embed_tokens.weight', params['embed_tokens']['w'])
    put('model.norm.weight', params['norm']['w'])
    if 'lm_head' in params:
        put('lm_head.weight', params['lm_head']['w'])

    ct = backend in CT_BACKENDS
    need_pack = bool(quant_cfg['weight'].get('need_pack', False))
    bits = int(wspec.bit)
    for i in range(model.n_blocks):
        blk = model.blocks[i]
        b = f'model.layers.{i}'
        linears = [p for p in layout.linears if has_path(blk, p)]
        extras = [f'{p}.w' for p in BLOCK_NORMS if has_path(blk, p)] + [
            f'{p}.{k}' for p in BLOCK_EXTRAS if has_path(blk, p)
            for k, _ in leaf_paths(get_path(blk, p))]
        check_nothing_dropped(
            blk, extras + [f'{p}.{k}' for p in linears for k in 'wb'],
            linears, f'block {i}')
        for p in extras:
            leaf = p.rsplit('.', 1)
            put(f'{b}.{leaf[0]}.{_SUFFIX.get(leaf[1], leaf[1])}',
                get_path(blk, p))
        for path in linears:
            lin = get_path(blk, path)
            g_idx = None
            if 'gptq_scales' in lin:
                codes, scales, zeros, g_idx = _stored_quant(wspec, lin)
            else:
                codes, scales, zeros = _real_quant(wspec, lin)
            prefix = f'{b}.{path}'
            if g_idx is not None and not ct:
                raise ValueError(
                    'GPTQ actorder (weight_g_idx) is only representable '
                    'in the compressed-tensors backends (vllm/sgl/'
                    'lightllm)')
            if ct:
                tensors = export_vllm_linear(codes, scales, zeros, bits,
                                             need_pack)
                if g_idx is not None:
                    tensors['weight_g_idx'] = g_idx
            else:
                codes, zeros = _awq_codes(codes, scales, zeros, bits)
                if zeros is None:   # the AWQ format needs zero points
                    zeros = torch.zeros_like(scales)
                tensors = export_awq_gemm_linear(codes, scales, zeros, bits,
                                                 wspec.group_size)
            for suffix, t in tensors.items():
                put(f'{prefix}.{suffix}', t)
            put(f'{prefix}.bias', lin.get('b'))
            if static_input_scales and prefix in static_input_scales:
                put(f'{prefix}.input_scale',
                    torch.as_tensor(static_input_scales[prefix], dtype=F32))
        del blk
    save_file(flat, os.path.join(save_path, 'model.safetensors'))
    hf_cfg = model.hf_config if model.hf_config is not None \
        else synthetic_hf_config(model)
    with open(os.path.join(save_path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f, indent=4)
    if ct:
        stamp_config(save_path, 'compression_config',
                     vllm_quant_config(quant_cfg))
    else:
        stamp_config(save_path, 'quantization_config',
                     awq_quant_config(quant_cfg))
    return flat
