"""Backend checkpoint formats (port of ``llmc_tpu/export/formats.py``).

- vLLM / SGLang / LightLLM compressed-tensors: the int32 shift-pack of
  unsigned codes (signed ones offset by 2^(bits-1)) and the config stamp.
- AutoAWQ / MLC-LLM GEMM: the order map [0, 2, 4, 6, 1, 3, 5, 7],
  ``qweight`` [in, out/pf], ``qzeros`` [in/gs, out/pf], ``scales``
  [in/gs, out] fp16.

The packing runs on the codes' device (``llmc_tpu_torch.native``).  Every
integer cast that may leave its type's range goes through ``int32`` and
wraps modulo 2^8, as numpy's ``astype(np.int8)`` does; a float cast
straight to int8 is undefined in torch and differs between the CPU and the
card.  The fp16 scales round to nearest even on both sides.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from .. import native
from ..native import AWQ_ORDER  # noqa: F401  (the reference's name)

F16 = torch.float16


def _int8(t: torch.Tensor) -> torch.Tensor:
    """``astype(np.int8)``: an integer (or in-range float) tensor wrapped
    modulo 2^8."""
    return (t.to(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def pack_int32_rows(codes_u: torch.Tensor, bits: int) -> torch.Tensor:
    """compressed-tensors pack: unsigned codes [oc, ic] -> int32
    [oc, ceil(ic/pf)], pf = 32 // bits."""
    return native.pack_int32_rows(codes_u, bits)


def export_vllm_linear(codes: torch.Tensor, scales: torch.Tensor,
                       zeros: Optional[torch.Tensor], bits: int,
                       need_pack: bool) -> Dict[str, torch.Tensor]:
    """{suffix: tensor} of one linear."""
    out = {}
    if need_pack:
        # signed (symmetric) codes get the unsigned offset; asymmetric
        # codes are already unsigned
        c = codes.to(torch.int32)
        if codes.dtype == torch.int8:
            c = c + 2 ** bits // 2
        out['weight_packed'] = pack_int32_rows(c, bits)
    else:
        out['weight'] = _int8(codes)
    out['weight_scale'] = scales.to(F16)
    if zeros is not None:
        out['weight_zero_point'] = _int8(zeros)
    return out


def export_awq_gemm_linear(codes_u: torch.Tensor, scales: torch.Tensor,
                           zeros: torch.Tensor, bits: int, group_size: int
                           ) -> Dict[str, torch.Tensor]:
    """AWQ GEMM layout.  codes_u: unsigned codes [oc, ic]; scales / zeros:
    [oc, ic/gs]."""
    return {
        'qweight': native.pack_awq_order(codes_u.t(), bits),
        'qzeros': native.pack_awq_order(zeros.t(), bits),
        'scales': scales.t().contiguous().to(F16),
    }


def vllm_quant_config(quant_cfg: Dict, ignore=None) -> Dict:
    """The compressed-tensors config stamp."""
    w = quant_cfg['weight']
    a = quant_cfg.get('act')
    need_pack = w.get('need_pack', False)
    quant_type = 'float' if w.get('quant_type') == 'float-quant' else 'int'
    fmt = ('pack-quantized' if need_pack else
           'float-quantized' if quant_type == 'float' else 'int-quantized')
    group_size = w.get('group_size') \
        if w.get('granularity') == 'per_group' else None
    dynamic = not (a or {}).get('static', False)
    return {
        'config_groups': {
            'group_0': {
                'targets': ['Linear'],
                'input_activations': {
                    'dynamic': dynamic,
                    'group_size': None,
                    'num_bits': a['bit'],
                    'observer': 'minmax',
                    'observer_kwargs': {},
                    'strategy': 'token'
                    if a.get('granularity') == 'per_token' else 'tensor',
                    'symmetric': a.get('symmetric', True),
                    'type': quant_type,
                } if a else None,
                'weights': {
                    'dynamic': False,
                    'group_size': group_size,
                    'num_bits': 8 if quant_type == 'float' else w['bit'],
                    'observer': 'minmax',
                    'observer_kwargs': {},
                    'strategy': 'group' if group_size else 'channel',
                    'symmetric': w.get('symmetric', True),
                    'type': quant_type,
                },
            }
        },
        'format': fmt,
        'ignore': ignore or ['lm_head'],
        'quant_method': 'compressed-tensors',
    }


def awq_quant_config(quant_cfg: Dict) -> Dict:
    w = quant_cfg['weight']
    return {
        'quant_method': 'awq',
        'zero_point': not w.get('symmetric', False),
        'group_size': w.get('group_size', 128),
        'bits': w['bit'],
        'version': 'gemm',
    }


def stamp_config(save_path: str, key: str, quant_config: Dict) -> None:
    path = os.path.join(save_path, 'config.json')
    with open(path) as f:
        cfg = json.load(f)
    cfg[key] = quant_config
    with open(path, 'w') as f:
        json.dump(cfg, f, indent=4)
