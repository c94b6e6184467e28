"""AWQ: activation-aware scale search per subset (port of
``llmc_tpu/compression/quantization/awq.py``).

A 20-point grid over the ratio r; scales s = a^r (v2) or a^r / w^(1-r)
(v1), normalised by sqrt(max * min); the MSE of the subset's output
against the unquantized one picks the winner, which ``scale_ln_fcs`` /
``scale_fc_fc`` apply.  The reference jits the loss of one ratio; here it
is a plain function under ``torch.no_grad()`` with the same arithmetic in
the same order.
"""

from __future__ import annotations

from typing import List

import torch

from ...models.base import get_path, matmul_f32_acc, set_path
from ...quant.quantizer import fake_quant_act, reshape_tensor
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization
from ..transforms import repeat_gqa_scales, scale_fc_fc, scale_ln_fcs

F32 = torch.float32


@ALGO_REGISTRY.register(name='Awq')
class Awq(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        special = self.special
        self.trans = special.get('trans', True)
        self.trans_version = special.get('trans_version', 'v2')
        self.n_grid = special.get('n_grid', 20)

    # ------------------------------------------------------------------
    def get_weight_scale(self, weights: List[torch.Tensor]) -> torch.Tensor:
        """Mean over layers of the per-element |w| / group max, then mean
        over output channels."""
        total = None
        for w in weights:
            wf = w.to(F32)
            a = torch.abs(reshape_tensor(self.wspec, wf))
            ls = (a / torch.amax(a, dim=-1, keepdim=True)).reshape(wf.shape)
            m = ls.mean(dim=0)
            total = m if total is None else total + m
        return total / len(weights)

    @staticmethod
    def get_act_scale(x: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(x.to(F32)).reshape(-1, x.shape[-1]),
                          dim=0)

    def _scales_from_ratio(self, a_scale, w_scale, ratio):
        if self.trans_version == 'v1' and w_scale is not None:
            s = torch.clamp(a_scale ** ratio / w_scale ** (1 - ratio),
                            min=1e-4)
        else:
            s = torch.clamp(a_scale ** ratio, min=1e-4)
        return s / torch.sqrt(torch.max(s) * torch.min(s))

    # ------------------------------------------------------------------
    def search_scale_subset(self, idx, block, subset, feats):
        """The grid search of one subset.  Returns (best scales, is_gqa)."""
        layers = [get_path(block, p) for p in subset.layers]
        inputs = feats[subset.input_key]
        kwargs_list = self._kwargs_iter()
        inspect = self.inspect_fns[subset.inspect]
        is_gqa = subset.is_gqa and self.has_gqa and self.do_gqa_trans
        cfgm = self.model.cfg

        if is_gqa:
            # the act scale is measured on v_proj's output and the weight
            # scale on v_proj; x is the previous subset's input
            prev = get_path(block, subset.prev_op)
            w_scale = self.get_weight_scale([prev['w']])
            gqa_rep = (cfgm.num_key_value_heads,
                       cfgm.num_attention_heads // cfgm.num_key_value_heads)
            inputs = feats['qkv_in']
        else:
            w_scale = self.get_weight_scale([lin['w'] for lin in layers])
            gqa_rep = None

        def loss_for_ratio(bp, ratio, x, kw, org_out, a_scale):
            scales = self._scales_from_ratio(
                a_scale, None if is_gqa else w_scale, ratio)
            s_col = repeat_gqa_scales(scales, *gqa_rep) if is_gqa else scales
            for p in subset.layers:
                lin = get_path(bp, p)
                w = lin['w']
                wq = self.w_qdq((w.to(F32) * s_col[None, :]).to(w.dtype))
                bp = set_path(bp, p, dict(lin, w=wq))
            x_t = x / s_col.reshape((1,) * (x.ndim - 1) + (-1,))
            if not self.w_only:
                x_t = fake_quant_act(self.aspec, x_t)
            out = inspect(bp, x_t, kw)
            return torch.mean((out.to(F32) - org_out.to(F32)) ** 2), scales

        def vout(x):
            prev = get_path(block, subset.prev_op)
            y = matmul_f32_acc(x, prev['w'])
            if prev.get('b') is not None:
                y = y + prev['b']
            return y.to(x.dtype)

        n_samples = sum(x.shape[0] for x in inputs)
        org_outs, a_scales = [], []
        for i, x in enumerate(inputs):
            kw = kwargs_list[i] if i < len(kwargs_list) else {}
            org_outs.append(inspect(block, x, kw))
            a_scales.append(self.get_act_scale(vout(x) if is_gqa else x))
        best_err, best_scales = float('inf'), None
        for n in range(self.n_grid):
            ratio = torch.tensor(n / self.n_grid, dtype=F32,
                                 device=w_scale.device)
            tot, sc = 0.0, 0.0
            for i, x in enumerate(inputs):
                kw = kwargs_list[i] if i < len(kwargs_list) else {}
                loss, s = loss_for_ratio(block, ratio, x, kw, org_outs[i],
                                         a_scales[i])
                wgt = x.shape[0] / n_samples
                tot = tot + wgt * loss
                sc = sc + wgt * s
            if float(tot) < best_err:
                best_err, best_scales = float(tot), sc
        return best_scales, is_gqa

    # ------------------------------------------------------------------
    def subset_transform(self, idx, block, subset, feats):
        if not self.trans or not subset.do_trans:
            return block
        if subset.prev_op is None:
            return block
        if subset.is_gqa and self.has_gqa and not self.do_gqa_trans:
            return block  # v_proj's rows cannot take o_proj's scales
        scales, is_gqa = self.search_scale_subset(idx, block, subset, feats)
        block = self.apply_scale_to_block(block, subset, scales, is_gqa)
        self.update_input_feat(feats, subset, scales, is_gqa)
        if self.save_scale:
            for p in subset.layers:
                self.act_scales[f'model.layers.{idx}.{p}'] = scales
        return block

    def apply_scale_to_block(self, block, subset, scales, is_gqa=False):
        """A norm before the subset takes ``scale_ln_fcs``, a linear
        ``scale_fc_fc``."""
        cfgm = self.model.cfg
        if subset.prev_kind == 'ln':
            ln = get_path(block, subset.prev_op)
            fcs = [get_path(block, p) for p in subset.layers]
            new_ln, new_fcs = scale_ln_fcs(ln, fcs, scales)
            block = set_path(block, subset.prev_op, new_ln)
            for p, fc in zip(subset.layers, new_fcs):
                block = set_path(block, p, fc)
        else:
            fc1 = get_path(block, subset.prev_op)
            fc2 = get_path(block, subset.layers[0])
            rep = (cfgm.num_key_value_heads,
                   cfgm.num_attention_heads // cfgm.num_key_value_heads) \
                if is_gqa else None
            new1, new2 = scale_fc_fc(fc1, fc2, scales, gqa_repeat=rep)
            block = set_path(block, subset.prev_op, new1)
            block = set_path(block, subset.layers[0], new2)
        return block
