"""AWQ weight-clip grid search (port of
``llmc_tpu/compression/quantization/auto_clip.py``).

Works on the block's param tree and the captured subset inputs; v1 clamps
the weights in place, v2 stores logit-space clip factors in the layer's
params (``clip_up`` / ``clip_low``) that ``fake_quant_weight`` reads
through ``learnable_range``.  Under activation quantization the sampled
inputs are fake-quantized, as the reference does, over the [1, T, ng, gs]
view the search holds (per token, each group of columns apart).

The reference writes the group dot products as ``sum(xs * wg, -1)`` over a
broadcast [oc, T, ng, gs] product, which XLA fuses; here the same sums are
a batched matmul over the groups, which never holds that product (at
11008 x 4096 and 512 tokens it would be 92 GB).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...models.base import get_path, has_path, set_path
from ...quant.qspec import QuantSpec
from ...quant.quantizer import (fake_quant_act, fake_quant_weight,
                                learnable_range, minmax_range,
                                qparams_from_range, quant_dequant,
                                reshape_tensor)

F32 = torch.float32


def _logit(x):
    return torch.log(x / (1 - x))


class AutoClipper:
    def __init__(self, w_only: bool, wspec: QuantSpec,
                 aspec: Optional[QuantSpec], clip_version: str,
                 clip_sym: bool, save_clip: bool, padding_mask=None):
        self.w_only = w_only
        self.wspec = wspec
        self.aspec = aspec
        self.clip_version = clip_version
        self.clip_sym = clip_sym
        self.save_clip = save_clip
        self.padding_mask = padding_mask
        self.weight_clips: Dict = {}

    # ------------------------------------------------------------------
    def run(self, block, block_idx: int, layout, feats,
            n_sample_token: Optional[int] = None, n_grid: int = 20):
        """Clip every linear of the block except the q/k projections."""
        for path in layout.linears:
            leaf = path.split('.')[-1]
            if any(t in leaf for t in ('q_', 'k_', 'query', 'key', 'Wqkv')):
                continue
            if not has_path(block, path):
                continue
            lin = get_path(block, path)
            inputs = feats[layout.capture_key(path)]
            x = torch.cat([i.reshape(-1, i.shape[-1]) for i in inputs], dim=0)
            if self.padding_mask is not None:
                m = np.concatenate([np.asarray(pm).reshape(-1)
                                    for pm in self.padding_mask])
                if m.shape[0] == x.shape[0]:
                    keep = torch.from_numpy(np.where(m > 0)[0]).to(x.device)
                    x = x[keep]
            best_max, best_min = self.auto_clip_layer(
                lin['w'], x, n_sample_token=n_sample_token, n_grid=n_grid)
            block = self.apply_clip(block, block_idx, path, lin,
                                    best_min, best_max)
        return block

    # ------------------------------------------------------------------
    def auto_clip_layer(self, w, x, n_grid=20, max_shrink=0.5,
                        n_sample_token=512):
        """Grid-search the best (min, max) clip per (out channel, group).
        Returns (best_max, best_min), each [oc, ng]."""
        oc, ic = w.shape
        gs = self.wspec.group_size \
            if self.wspec.granularity == 'per_group' else ic
        ng = ic // gs
        wg = w.to(F32).reshape(oc, 1, ng, gs)
        if n_sample_token is None:
            n_sample_token = min(x.shape[0], 512)
        step = max(1, x.shape[0] // n_sample_token)
        xs = x[::step].to(F32).reshape(1, -1, ng, gs)
        return self._search(wg, xs, n_grid, max_shrink)

    @staticmethod
    def _group_dots(xs, wg):
        """sum(xs * wg, -1) as [oc, T, ng], one matmul per group."""
        xg = xs[0].permute(1, 0, 2)          # [ng, T, gs]
        wt = wg[:, 0].permute(1, 2, 0)       # [ng, gs, oc]
        return torch.bmm(xg, wt).permute(2, 1, 0)

    def _search(self, wg, xs, n_grid=20, max_shrink=0.5):
        if self.clip_sym:
            org_max = torch.amax(torch.abs(wg), dim=-1, keepdim=True)
        else:
            org_max = torch.amax(wg, dim=-1, keepdim=True)
        org_min = torch.amin(wg, dim=-1, keepdim=True)
        org_out = self._group_dots(xs, wg)
        best_err = torch.full_like(org_max, 1e9)
        best_max, best_min = org_max, org_min
        for i_s in range(int(max_shrink * n_grid)):
            frac = 1.0 - torch.tensor(i_s, dtype=F32, device=wg.device) \
                / n_grid
            max_val = org_max * frac
            min_val = -max_val if self.clip_sym else org_min * frac
            qw = self._fake_quant_w(wg, min_val, max_val, org_min, org_max)
            qx = xs if self.w_only else fake_quant_act(self.aspec, xs)
            cur = self._group_dots(qx, qw)
            err = torch.mean((cur - org_out) ** 2, dim=1)[:, None, :, None]
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_max = torch.where(take, max_val, best_max)
            best_min = torch.where(take, min_val, best_min)
        return best_max[:, 0, :, 0], best_min[:, 0, :, 0]

    def _fake_quant_w(self, wg, min_val, max_val, org_min, org_max):
        oc, _, ng, gs = wg.shape
        spec = self.wspec.replace(granularity='per_group', group_size=gs)
        if self.clip_version == 'v1':
            cur = torch.clamp(wg, min_val, max_val)
            return fake_quant_weight(spec, cur.reshape(oc * ng, gs)
                                     ).reshape(wg.shape)
        # v2: the learnable-range static quantizer
        flat = wg.reshape(oc * ng, gs)
        up = _logit(max_val / org_max).reshape(oc * ng, 1)
        low = None
        if not self.clip_sym:
            low = _logit(min_val / org_min).reshape(oc * ng, 1)
        rng = learnable_range(spec, flat, up_factor=up, low_factor=low)
        qp = qparams_from_range(spec, rng)
        return quant_dequant(spec, flat, qp).reshape(wg.shape)

    # ------------------------------------------------------------------
    def apply_clip(self, block, block_idx, path, lin, min_val, max_val):
        oc = lin['w'].shape[0]
        if self.clip_version == 'v1':
            w = lin['w'].to(F32)
            ng = max_val.shape[1]
            wg = w.reshape(oc, ng, -1)
            mx = max_val[:, :, None]
            mn = -mx if self.clip_sym else min_val[:, :, None]
            w2 = torch.clamp(wg, mn, mx).reshape(w.shape).to(lin['w'].dtype)
            return set_path(block, path, dict(lin, w=w2))
        # v2: logit factors shaped like reshape_tensor's range output
        spec = self.wspec
        org_min, org_max = minmax_range(spec, reshape_tensor(
            spec, lin['w'].to(F32)))
        if self.clip_sym:
            abs_max = torch.clamp(torch.maximum(torch.abs(org_max),
                                                torch.abs(org_min)), min=1e-5)
            up = _logit(max_val.reshape(abs_max.shape) / abs_max)
            low = None
        else:
            up = _logit(max_val.reshape(org_max.shape) / org_max)
            low = _logit(min_val.reshape(org_min.shape) / org_min)
        newlin = dict(lin, clip_up=up)
        if low is not None:
            newlin['clip_low'] = low
        if self.save_clip:
            self.weight_clips.setdefault(block_idx, {})
            n = f'{path}.weight_quantizer.'
            self.weight_clips[block_idx][n + 'upbound_factor'] = up
            self.weight_clips[block_idx][n + 'lowbound_factor'] = low
        return set_path(block, path, newlin)
