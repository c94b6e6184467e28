"""TRT-LLM checkpoint export (port of ``llmc_tpu/export/trtllm.py``): the
checkpoint layout ``trtllm-build`` starts from (``config.json`` and
``rank{r}.safetensors`` with ``transformer.layers.N.*`` names, sharded for
tensor and pipeline parallelism, weight-only int4 / int8 codes with
per-channel scales) written without the ``tensorrt_llm`` package.

The shards are slices on the host side of the writer, not
``torch.distributed``: rank r = pp * tp_size + tp gets its tp slice of
each of its pp stage's layers.  Each slice is quantized (per-channel
symmetric, the port's ``real_quant_weight``) on the model's device and
packed there; TRT-LLM's own interleaving for its mixed GEMMs belongs to
the consumer's build step, as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from ..quant.qspec import QuantSpec
from ..quant.quantizer import real_quant_weight
from .exporter import check_nothing_dropped

F32 = torch.float32
_LINEARS = ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj',
            'self_attn.o_proj', 'mlp.gate_proj', 'mlp.up_proj',
            'mlp.down_proj')


def _t16(t: torch.Tensor, dtype: str = 'float16') -> torch.Tensor:
    return t.detach().to(getattr(torch, dtype)).to('cpu').contiguous()


def _pack_int4_inout(q: torch.Tensor) -> torch.Tensor:
    """[out, in] signed int4 codes -> int8-packed [in, out/2] (TRT-LLM's
    weight-only layout: transposed, two output channels a byte, the even
    channel in the low nibble)."""
    t = q.t().to(torch.int32)                 # [in, out]
    lo = t[:, 0::2] & 0xF
    hi = t[:, 1::2] & 0xF
    return ((lo | (hi << 4)) & 0xFF).to(torch.uint8).view(torch.int8)


def _weight_only(w: torch.Tensor, bits: int):
    """Per-channel symmetric weight-only quantization (W4A16 / W8A16):
    (packed int8 tensor, per_channel_scale [out] fp16) on the host."""
    spec = QuantSpec(bit=bits, symmetric=True, granularity='per_channel')
    codes, scales, _ = real_quant_weight(spec, w.to(F32))
    codes = codes.to(torch.int8)              # [out, in]
    packed = _pack_int4_inout(codes) if bits == 4 else codes.t()
    return (packed.to('cpu').contiguous(),
            scales.reshape(-1).to(torch.float16).to('cpu').contiguous())


def export_trtllm(model, out_dir: str, tp_size: int = 1, pp_size: int = 1,
                  dtype: str = 'float16',
                  quant_algo: Optional[str] = 'W4A16') -> None:
    """Write a TRT-LLM LLaMA-family checkpoint: config.json and
    rank{r}.safetensors for r in range(tp_size * pp_size)."""
    from safetensors.torch import save_file
    cfg = model.cfg
    params = model.params
    check_nothing_dropped(
        {k: v for k, v in params.items() if k != 'blocks'},
        ('embed_tokens.w', 'norm.w', 'lm_head.w'), (), 'the model')
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    nl = cfg.num_hidden_layers
    assert nl % pp_size == 0, (nl, pp_size)
    assert H % tp_size == 0 and KVH % tp_size == 0, (H, KVH, tp_size)
    bits = {'W4A16': 4, 'W8A16': 8, None: 0}[quant_algo]
    os.makedirs(out_dir, exist_ok=True)

    config = {
        'architecture': 'LlamaForCausalLM',
        'dtype': dtype,
        'num_hidden_layers': nl,
        'num_attention_heads': H,
        'num_key_value_heads': KVH,
        'head_size': hd,
        'hidden_size': cfg.hidden_size,
        'intermediate_size': cfg.intermediate_size,
        'vocab_size': cfg.vocab_size,
        'position_embedding_type': 'rope_gpt_neox',
        'max_position_embeddings': cfg.max_position_embeddings,
        'rotary_base': cfg.rope_theta,
        'norm_epsilon': cfg.rms_norm_eps,
        'hidden_act': 'silu',
        'mapping': {'world_size': tp_size * pp_size,
                    'tp_size': tp_size, 'pp_size': pp_size},
        'quantization': {'quant_algo': quant_algo,
                         'exclude_modules': ['lm_head']},
    }
    with open(os.path.join(out_dir, 'config.json'), 'w') as f:
        json.dump(config, f, indent=2)

    def put_linear(sd, name, w_full):
        if bits:
            sd[f'{name}.weight'], sd[f'{name}.per_channel_scale'] = \
                _weight_only(w_full, bits)
        else:
            sd[f'{name}.weight'] = _t16(w_full, dtype)

    lpp = nl // pp_size
    for pp in range(pp_size):
        for tp in range(tp_size):
            rank = pp * tp_size + tp
            sd: Dict[str, torch.Tensor] = {}
            if pp == 0:
                sd['transformer.vocab_embedding.weight'] = _t16(
                    params['embed_tokens']['w'], dtype)
            if pp == pp_size - 1:
                sd['transformer.ln_f.weight'] = _t16(params['norm']['w'],
                                                     dtype)
                lm = (params['embed_tokens']['w'] if cfg.tie_word_embeddings
                      else params['lm_head']['w'])
                vshard = lm.shape[0] // tp_size
                sd['lm_head.weight'] = _t16(
                    lm[tp * vshard:(tp + 1) * vshard], dtype)
            for li in range(pp * lpp, (pp + 1) * lpp):
                bp = params['blocks'][li]
                check_nothing_dropped(
                    bp, ('input_layernorm.w', 'post_attention_layernorm.w')
                    + tuple(f'{p}.w' for p in _LINEARS), _LINEARS,
                    f'block {li}')
                pre = f'transformer.layers.{li}'
                sd[f'{pre}.input_layernorm.weight'] = _t16(
                    bp['input_layernorm']['w'], dtype)
                sd[f'{pre}.post_layernorm.weight'] = _t16(
                    bp['post_attention_layernorm']['w'], dtype)
                a = bp['self_attn']
                # the fused qkv, column-sharded: per rank
                # [(H + 2 KVH) / tp * hd, D]
                qh, kvh = H // tp_size, KVH // tp_size
                q = a['q_proj']['w'].reshape(H, hd, -1)
                k = a['k_proj']['w'].reshape(KVH, hd, -1)
                v = a['v_proj']['w'].reshape(KVH, hd, -1)
                qkv = torch.cat([
                    q[tp * qh:(tp + 1) * qh].reshape(qh * hd, -1),
                    k[tp * kvh:(tp + 1) * kvh].reshape(kvh * hd, -1),
                    v[tp * kvh:(tp + 1) * kvh].reshape(kvh * hd, -1)], 0)
                put_linear(sd, f'{pre}.attention.qkv', qkv)
                o = a['o_proj']['w']                      # [D, H*hd]
                osh = o.shape[1] // tp_size
                put_linear(sd, f'{pre}.attention.dense',
                           o[:, tp * osh:(tp + 1) * osh])  # row-sharded
                m = bp['mlp']
                ish = m['gate_proj']['w'].shape[0] // tp_size
                # TRT-LLM's GatedMLP: fc <- gate_proj, gate <- up_proj
                put_linear(sd, f'{pre}.mlp.fc',
                           m['gate_proj']['w'][tp * ish:(tp + 1) * ish])
                put_linear(sd, f'{pre}.mlp.gate',
                           m['up_proj']['w'][tp * ish:(tp + 1) * ish])
                d = m['down_proj']['w']
                dsh = d.shape[1] // tp_size
                put_linear(sd, f'{pre}.mlp.proj',
                           d[:, tp * dsh:(tp + 1) * dsh])
                del bp
            save_file(sd, os.path.join(out_dir, f'rank{rank}.safetensors'))
