"""SmoothQuant (port of
``llmc_tpu/compression/quantization/smoothquant.py``): for each subset fed
by a norm, s = act_max^alpha / w_max^(1 - alpha) per input channel, the
norm divided by s and the subset's columns multiplied by it."""

from __future__ import annotations

import torch

from ...models.base import get_path, set_path
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization, channel_absmax
from ..transforms import scale_ln_fcs

F32 = torch.float32


@ALGO_REGISTRY.register(name='SmoothQuant')
class SmoothQuant(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.alpha = self.special.get('alpha', 0.5)

    def subset_transform(self, idx, block, subset, feats):
        if subset.prev_kind != 'ln' or not subset.do_trans:
            return block
        act_max = channel_absmax(feats[subset.input_key])
        fcs = [get_path(block, p) for p in subset.layers]
        w_max = None
        for fc in fcs:
            m = torch.amax(torch.abs(fc['w'].to(F32)), dim=0)
            w_max = m if w_max is None else torch.maximum(w_max, m)
        scales = (torch.clamp(act_max, min=1e-5) ** self.alpha
                  / torch.clamp(w_max, min=1e-5) ** (1 - self.alpha))
        scales = torch.clamp(scales, min=1e-5)
        ln = get_path(block, subset.prev_op)
        new_ln, new_fcs = scale_ln_fcs(ln, fcs, scales)
        block = set_path(block, subset.prev_op, new_ln)
        for p, fc in zip(subset.layers, new_fcs):
            block = set_path(block, p, fc)
        self.update_input_feat(feats, subset, scales)
        if self.save_scale:
            for p in subset.layers:
                self.act_scales[f'model.layers.{idx}.{p}'] = scales
        return block
