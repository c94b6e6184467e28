"""Backend checkpoint exports (port of ``llmc_tpu/export``): the
compressed-tensors and AWQ-GEMM writers (``exporter``, ``formats``) and
TRT-LLM's (``trtllm``); ``export_backends`` runs every one a config's
``save`` section asks for, as ``run_pipeline`` does."""

import os
from typing import Dict, List

from .exporter import export_real_quant
from .formats import (awq_quant_config, export_awq_gemm_linear,
                      export_vllm_linear, pack_int32_rows, stamp_config,
                      vllm_quant_config)
from .trtllm import export_trtllm

# save flag -> the compressed-tensors or AWQ-GEMM backend it writes for
BACKENDS = {'save_vllm': 'vllm', 'save_sgl': 'sgl',
            'save_lightllm': 'lightllm', 'save_autoawq': 'autoawq',
            'save_mlcllm': 'mlcllm'}


def export_backends(model, opt, save: Dict) -> List[str]:
    """Write every backend checkpoint ``save`` asks for (the algorithm
    ``opt``'s weight spec and quant section; TRT-LLM's weight-only bits
    from it, 4 without one); returns the directories written."""
    outs = []
    for flag, backend in BACKENDS.items():
        if save.get(flag) and opt is not None:
            out = save.get('save_path', './save_' + backend)
            export_real_quant(model, opt.wspec, dict(opt.quant_config), out,
                              backend=backend)
            outs.append(out)
    if save.get('save_trtllm'):
        out = save.get('save_path', './save_trtllm')
        bits = opt.wspec.bit if opt is not None else 4
        export_trtllm(model, out, tp_size=int(save.get('tp_size', 1)),
                      pp_size=int(save.get('pp_size', 1)),
                      quant_algo={4: 'W4A16', 8: 'W8A16'}.get(bits))
        outs.append(out)
    return outs


def read_checkpoint(path: str, device='cpu') -> Dict:
    """A written checkpoint read back: {file: {name: tensor on
    ``device``}} for its safetensors files, {file: dict} for its JSON
    ones."""
    import json

    from safetensors.torch import load_file
    out = {}
    for fn in sorted(os.listdir(path)):
        full = os.path.join(path, fn)
        if fn.endswith('.safetensors'):
            out[fn] = load_file(full, device=str(device))
        elif fn.endswith('.json'):
            with open(full) as f:
                out[fn] = json.load(f)
    return out


__all__ = ['BACKENDS', 'export_backends', 'export_real_quant',
           'export_trtllm', 'read_checkpoint', 'awq_quant_config',
           'export_awq_gemm_linear', 'export_vllm_linear',
           'pack_int32_rows', 'stamp_config', 'vllm_quant_config']
