"""DGQ (port of ``llmc_tpu/compression/quantization/dgq.py``): dual-grain
quantization, int4 group scales that are integer multiples of a
per-channel int8 scale (W4A8 with int8 kernels).

- A subset fed by a norm is smoothed first by SmoothQuant's square-root
  ratio ``sqrt(act_max) / sqrt(w_max)``.
- Llama's ``down_proj``: the up_proj output channels hotter than the
  99.5th percentile (numpy's sort of the host copy) are divided down into
  ``down_proj``.  The cached ``down_proj`` input features are not
  rescaled, as in the reference (and upstream): the search below runs on
  the features from before this smoothing.
- ``_search_core``: a 20-point clamp grid per (channel, group) for the
  asymmetric int4 qparams ``s4`` / ``z4``, then an 80-point grid per
  channel for the int8 super-scale ``s8``; the group scales become
  ``s4_int = max(round(s4 / s8), 1)``.  A grid point is taken where its
  loss is strictly lower, as in the reference.
- ``static_w_qdq``: scale ``s4_int * s8``, zero ``z4``, the codes clipped
  to the int8 budget's bounds; baked into the params at
  ``deploy('fake_quant')``.

The reference's search runs jitted: its divisions by constants are
folded, and so are they here.  The losses are f32 products on either
device (no TF32); the group losses are taken a few groups at a time, so
that no more than one chunk of outputs lives beside the fp outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.base import get_path, set_path
from ...quant.qspec import spec_from_config
from ...quant.quantizer import clip, div_const, fake_quant_act
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BakedAtDeploy, channel_absmax
from ..transforms import scale_fc_fc, scale_ln_fcs

F32 = torch.float32
# f32 elements of one chunk of grouped outputs [groups, L, oc] (1 GiB)
CHUNK_ELEMENTS = 2 ** 28


def grid_ratio(i: int, n: int, span: float) -> float:
    """``1.02 - (i + 1) / n * span`` in f32, as the jitted reference
    computes it (the division by ``n`` a reciprocal multiply)."""
    f = np.float32
    return float(f(1.02) - f(i + 1) * (f(1) / f(n)) * f(span))


def _int8_budget(s8: torch.Tensor) -> torch.Tensor:
    """``round(127 / s8)``, a true division (``127.0 / t`` in torch is a
    reciprocal multiply)."""
    return torch.round(torch.full_like(s8, 127.0) / s8)


@ALGO_REGISTRY.register(name='DGQ')
class DGQ(BakedAtDeploy):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        w1 = dict(self.quant_config['weight'].get(
            'w_1', {'bit': 4, 'symmetric': False, 'granularity': 'per_group',
                    'group_size': 128}))
        self.w4spec = spec_from_config(w1)
        self.gs = self.w4spec.group_size

    # ------------------------------------------------------------------
    def subset_transform(self, idx, block, subset, feats):
        xs = feats[subset.input_key]
        if subset.prev_kind == 'ln':
            a_max, w_max = channel_absmax(xs), None
            for p in subset.layers:
                m = torch.amax(torch.abs(get_path(block, p)['w'].to(F32)),
                               dim=0)
                w_max = m if w_max is None else torch.maximum(w_max, m)
            s = torch.clamp(torch.sqrt(torch.clamp(a_max, min=1e-5))
                            / torch.sqrt(torch.clamp(w_max, min=1e-5)),
                            min=1e-5)
            ln, fcs = scale_ln_fcs(get_path(block, subset.prev_op),
                                   [get_path(block, p)
                                    for p in subset.layers], s)
            block = set_path(block, subset.prev_op, ln)
            for p, fc in zip(subset.layers, fcs):
                block = set_path(block, p, fc)
            self.update_input_feat(feats, subset, s)
            xs = feats[subset.input_key]
        if 'mlp.down_proj' in subset.layers:
            block = self._smooth_down(block, subset, xs)
        for p in subset.layers:
            lin = get_path(block, p)
            s4, z4, s8 = self._search_core(lin['w'], xs[0])
            block = set_path(block, p, dict(lin, dgq_s4=s4, dgq_z4=z4,
                                            dgq_s8=s8))
        return block

    def _smooth_down(self, block, subset, xs):
        """Divide the hottest 0.5% of up_proj's output channels down into
        down_proj (the features in ``xs`` stay as they are)."""
        act = channel_absmax(xs)
        scales = act.cpu().numpy()
        basl = int(len(scales) * 0.005 + 1.5)
        baseline = np.sort(scales)[-basl]
        if baseline < 1e-4:
            return block
        s = scales / baseline
        s[scales <= baseline] = 1.0
        upp, downp = scale_fc_fc(get_path(block, subset.prev_op),
                                 get_path(block, subset.layers[0]),
                                 torch.from_numpy(s).to(act.device))
        block = set_path(block, subset.prev_op, upp)
        return set_path(block, subset.layers[0], downp)

    # ------------------------------------------------------------------
    @staticmethod
    def _q4(wc: torch.Tensor):
        """Asymmetric int4 of each group (last axis): (qdq, s, z)."""
        mn = torch.amin(wc, -1, keepdim=True)
        mx = torch.amax(wc, -1, keepdim=True)
        s = div_const(torch.clamp(mx - mn, min=1e-5), 15.0, True)
        z = torch.clamp(-torch.round(mn / s), 0, 15)
        q = torch.clamp(torch.round(wc / s) + z, 0, 15)
        return (q - z) * s, s, z

    def _group_loss(self, xq: torch.Tensor, wq: torch.Tensor,
                    org: torch.Tensor) -> torch.Tensor:
        """mean over tokens of (org - xq_g @ wq_g^T)^2 per (channel,
        group): xq [ng, L, gs], wq [ng, oc, gs], org [ng, L, oc] ->
        [oc, ng]."""
        ng, L, oc = org.shape
        step = max(1, CHUNK_ELEMENTS // (L * oc))
        out = []
        for g0 in range(0, ng, step):
            y = torch.bmm(xq[g0:g0 + step], wq[g0:g0 + step].transpose(1, 2))
            d = org[g0:g0 + step] - y
            del y
            out.append(div_const((d * d).sum(1), L, True))
            del d
        return torch.cat(out, 0).T

    def _search_core(self, w: torch.Tensor, x0: torch.Tensor):
        """(s4_int [oc, ng], z4 [oc, ng], s8 [oc]) of one linear."""
        gs = self.gs
        wf = w.to(F32)
        oc, ic = wf.shape
        ng = ic // gs
        x = x0.reshape(-1, ic).to(F32)
        L = x.shape[0]
        wg = wf.reshape(oc, ng, gs)
        xg = x.reshape(L, ng, gs)
        xgt = xg.transpose(0, 1)                       # [ng, L, gs]
        wgt = wg.transpose(0, 1)                       # [ng, oc, gs]
        org_g = torch.bmm(xgt, wgt.transpose(1, 2))    # [ng, L, oc]
        aspec = self.aspec
        xq = (fake_quant_act(aspec, xg) if aspec is not None else xg
              ).transpose(0, 1)
        w_max = torch.amax(wg, -1, keepdim=True)
        w_min = torch.amin(wg, -1, keepdim=True)
        best = torch.full((oc, ng), float('inf'), dtype=F32, device=w.device)
        s4 = torch.ones((oc, ng, 1), dtype=F32, device=w.device)
        z4 = torch.zeros((oc, ng, 1), dtype=F32, device=w.device)
        for i in range(20):
            ratio = grid_ratio(i, 20, 0.22)
            wq, s, z = self._q4(clip(wg, w_min * ratio, w_max * ratio))
            loss = self._group_loss(xq, wq.transpose(0, 1), org_g)
            take = loss < best
            best = torch.where(take, loss, best)
            s4 = torch.where(take[..., None], s, s4)
            z4 = torch.where(take[..., None], z, z4)
            del wq, loss
        del org_g
        s4, z4 = s4[..., 0], z4[..., 0]

        org = x @ wf.T
        xq_full = fake_quant_act(aspec, x) if aspec is not None else x
        a_max = torch.amax(torch.abs(wf), -1, keepdim=True)
        best8 = torch.full((oc,), float('inf'), dtype=F32, device=w.device)
        s8 = torch.ones((oc, 1), dtype=F32, device=w.device)
        for i in range(80):
            ratio = grid_ratio(i, 80, 0.82)
            wc = clip(wf, -a_max * ratio, a_max * ratio)
            amax = torch.clamp(torch.amax(torch.abs(wc), -1, keepdim=True),
                               min=1e-5)
            s8c = div_const(amax, 127.0, True)
            sq = torch.clamp(torch.round(s4 / s8c), min=1.0) * s8c
            wdq = self._dual_qdq(wg, sq, z4, s8c).reshape(oc, ic)
            d = org - xq_full @ wdq.T
            loss = div_const((d * d).sum(0), L, True)
            take = loss < best8
            best8 = torch.where(take, loss, best8)
            s8 = torch.where(take[:, None], s8c, s8)
        s4_int = torch.clamp(torch.round(s4 / s8), min=1.0)
        return s4_int, z4, s8[:, 0]

    @staticmethod
    def _dual_qdq(wg, sq, z4, s8):
        """The weight [oc, ng, gs] on the grid of scale ``sq`` (an integer
        multiple of ``s8``) and zero ``z4``, its codes within the int8
        budget's bounds."""
        int_max = _int8_budget(s8)
        upper = torch.clamp(z4 + int_max, max=15.0)[..., None]
        lower = torch.clamp(z4 - int_max, min=0.0)[..., None]
        q = clip(torch.round(wg / sq[..., None]) + z4[..., None], lower,
                 upper)
        return (q - z4[..., None]) * sq[..., None]

    # ------------------------------------------------------------------
    def static_w_qdq(self, lin) -> torch.Tensor:
        w = lin['w'].to(F32)
        oc, ic = w.shape
        s8 = lin['dgq_s8'].reshape(-1, 1)
        out = self._dual_qdq(w.reshape(oc, -1, self.gs), lin['dgq_s4'] * s8,
                             lin['dgq_z4'], s8)
        return out.reshape(oc, ic).to(lin['w'].dtype)

    def bake_fake_quant_weights(self):
        with torch.no_grad():
            for b in range(self.model.n_blocks):
                blk = self.model.blocks[b]
                for path in self.layout.linears:
                    lin = get_path(blk, path)
                    if 'dgq_s4' in lin:
                        blk = set_path(blk, path,
                                       dict(lin, w=self.static_w_qdq(lin)))
                self.model.set_block(b, blk)
