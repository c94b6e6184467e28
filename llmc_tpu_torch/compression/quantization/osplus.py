"""Outlier Suppression+ (port of
``llmc_tpu/compression/quantization/osplus.py``): a channel shift (models
with biases only; Llama has none) and a scale search over a symmetric
clip range st in [1, absmax] of the subset's input.  The channel scale is
max(cmx / st, cmn / -st, 1); the loss is the MSE of the quantized subset's
output against the fp one on the first calibration batch, as in the
reference.  Only subsets fed by a norm are transformed."""

from __future__ import annotations

import numpy as np
import torch

from ...models.base import get_path, set_path
from ...quant.quantizer import fake_quant_act, fake_quant_weight
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization
from ..transforms import scale_ln_fcs, shift_ln_fcs

F32 = torch.float32


@ALGO_REGISTRY.register(name='OsPlus')
class OsPlus(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.has_bias = bool(getattr(model.cfg, 'attention_bias', False))

    def subset_transform(self, idx, block, subset, feats):
        if subset.prev_kind != 'ln' or not subset.do_trans:
            return block
        x = feats[subset.input_key][0]
        kw = self.kwargs_list[0] if self.kwargs_list else {}
        inspect = self.inspect_fns[subset.inspect]

        xf = x.to(F32)
        red = tuple(range(xf.ndim - 1))
        if self.has_bias:
            shift = (torch.amax(xf, dim=red) + torch.amin(xf, dim=red)) / 2
            x_shift = xf - shift
        else:
            shift = None
            x_shift = xf
        cmx = torch.amax(x_shift, dim=red)
        cmn = torch.amin(x_shift, dim=red)
        amx = float(torch.clamp(torch.max(x_shift), min=0.0))
        amn = float(torch.clamp(torch.min(x_shift), max=0.0))
        num = 100 if not np.isfinite(amx) else max(100, int(amx / 0.5))
        num = int(self.special.get('os_grid', num))  # a test-speed override
        hi = max(-amn, amx)
        step = (hi - 1.0) / num

        def scales_for(st: float):
            st_t = torch.full_like(cmx, np.float32(st))
            one = torch.ones_like(cmx)
            mx_s = torch.where(cmx > st_t, cmx / st_t, one)
            mn_s = torch.where(cmn < -st_t, cmn / -st_t, one)
            return torch.maximum(mx_s, mn_s)

        def loss_for(st: float, org_out):
            s = scales_for(st)
            bp = block
            for p in subset.layers:
                lin = get_path(bp, p)
                w = lin['w'].to(F32)
                if self.has_bias and lin.get('b') is not None:
                    bp = set_path(bp, p + '.b',
                                  lin['b'].to(F32) + shift @ w.T)
                wq = fake_quant_weight(self.wspec,
                                       (w * s[None, :]).to(lin['w'].dtype),
                                       folded=True)
                bp = set_path(bp, p + '.w', wq)
            xq = x_shift / s[None, :]
            if self.aspec is not None:
                xq = fake_quant_act(self.aspec, xq.to(x.dtype))
            out = inspect(bp, xq.to(x.dtype), kw)
            return torch.mean(torch.sum(
                (org_out.to(F32) - out.to(F32)) ** 2, dim=-1))

        org_out = inspect(block, x, kw)
        best_loss, best_st = None, hi
        st = hi
        while st >= 1.0 and step > 0:
            cur = float(loss_for(st, org_out))
            if best_loss is None or cur < best_loss:
                best_loss, best_st = cur, st
            st -= step
        best_scale = scales_for(best_st)

        ln = get_path(block, subset.prev_op)
        fcs = [get_path(block, p) for p in subset.layers]
        if shift is not None:
            ln, fcs = shift_ln_fcs(ln, fcs, shift, self.has_bias)
        ln, fcs = scale_ln_fcs(ln, fcs, best_scale)
        block = set_path(block, subset.prev_op, ln)
        for p, fc in zip(subset.layers, fcs):
            block = set_path(block, p, fc)
        if self.act_static:
            self.update_input_feat(feats, subset, best_scale)
        return block
