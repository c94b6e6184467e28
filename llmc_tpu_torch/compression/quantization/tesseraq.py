"""TesseraQ (port of ``llmc_tpu/compression/quantization/tesseraq.py``):
progressive adaptive rounding.  Each linear gets a rounding variable
``V = logit(frac(w / s))`` over the minmax qparams of the block (after the
optional clip and loaded AWQ scales), so that the soft weight
``clip(floor(w / s) + sigmoid(V) + z)`` starts at ``w``.  For each
threshold t the most confident ``1 - t`` of V (by ``|sigmoid(V) - 0.5|``
against its ``np.quantile``) is hardened to +-100, Adam starts afresh and
takes ``iterations`` steps on the MSE of the block's output against the
fp block's, each on a batch drawn by ``np.random.RandomState(idx)``.  The
merge ``w += 0.5 * s * ((V > 0) - (frac > 0.5))`` makes plain rounding
with the stored qparams (``gptq_scales`` / ``gptq_zeros``, as GPTQ stores
them) reproduce the learned rounding; ``deploy('fake_quant')`` bakes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.adapter import QMap
from ...models.base import LinearQcfg, get_path, set_path
from ...quant.quantizer import (clip, minmax_range, qparams_from_range,
                                reshape_tensor, restore_tensor)
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import (BakedAtDeploy, BlockTraining,
                         load_search_artifact)
from ..transforms import scale_fc_fc, scale_ln_fcs

F32 = torch.float32


def _logit(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-6, 1 - 1e-6)
    return torch.log(x / (1 - x))


@ALGO_REGISTRY.register(name='TesseraQ')
class TesseraQ(BlockTraining, BakedAtDeploy):
    HYPERPARAMS = ('lr', 'iterations', 'batch_size', 'thresholds',
                   'load_transform')

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        self.check_special(sp)
        self.lr = float(sp.get('lr', 1e-3))
        self.iterations = int(sp.get('iterations', 100))
        self.batch_size = int(sp.get('batch_size', 1))
        self.thresholds = list(sp.get('thresholds',
                                      [0.8, 0.6, 0.4, 0.2, 0.1]))
        self.load_transform = sp.get('load_transform', False)
        self.loaded_scales = load_search_artifact(
            sp['scale_path'], 'scales.pkl') if self.load_transform else None

    @classmethod
    def check_special(cls, sp):
        """Option validation without a model (the pipeline's fail-fast
        check)."""
        if sp.get('load_transform') and not sp.get('scale_path'):
            raise ValueError('TesseraQ: special.load_transform requires '
                             'special.scale_path')

    # ------------------------------------------------------------------
    def collect_qparams(self, block):
        """path -> (scales, zeros broadcast to the scales' shape)."""
        qps = {}
        for path in self.layout.linears:
            t = reshape_tensor(self.wspec, get_path(block, path)['w'].to(F32))
            qp = qparams_from_range(self.wspec, minmax_range(self.wspec, t))
            qps[path] = (qp.scales,
                         torch.broadcast_to(qp.zeros, qp.scales.shape))
        return qps

    def soft_block(self, block, theta, qps):
        """The block with the weights that V rounds."""
        spec = self.wspec
        for path in self.layout.linears:
            lin = get_path(block, path)
            s, z = qps[path]
            w = lin['w'].to(F32)
            t = reshape_tensor(spec, w)
            q = clip(torch.floor(t / s) + torch.sigmoid(theta[path]) + z,
                     spec.qmin, spec.qmax)
            wq = restore_tensor(spec, (q - z) * s, w.shape)
            block = set_path(block, path, dict(lin, w=wq.to(lin['w'].dtype)))
        return block

    def harden(self, theta, t: float):
        """The most confident ``1 - t`` of each V set to +-100."""
        for path, v in theta.items():
            sig = torch.sigmoid(v)
            qv = float(np.quantile(torch.abs(sig - 0.5).cpu().numpy(), t))
            hi = float(np.float32(qv + 0.5))
            lo = float(np.float32(0.5 - qv))
            theta[path] = torch.where(
                sig > hi, torch.full_like(v, 100.0),
                torch.where(sig < lo, torch.full_like(v, -100.0), v))

    # ------------------------------------------------------------------
    def block_transform(self, idx, block, feats):
        if self.loaded_scales is not None:
            block = self.apply_loaded_scales(idx, block)
        if self.weight_clip:
            block = self.auto_clipper.run(
                block, idx, self.layout, feats,
                n_sample_token=self.config.get_nested('calib.seq_len')
                if hasattr(self.config, 'get_nested') else None)
        qps = self.collect_qparams(block)
        theta = {}
        for path in self.layout.linears:
            t = reshape_tensor(self.wspec, get_path(block, path)['w'].to(F32))
            frac = t / qps[path][0]
            theta[path] = _logit(frac - torch.floor(frac))

        qmap = QMap({p: LinearQcfg(a_spec=self.aspec, ste=True)
                     for p in self.layout.linears})
        kwargs_list = self._kwargs_iter()
        fp_outs = self.fp_targets(
            block, changed=self.loaded_scales is not None or self.weight_clip)

        def loss_fn(x, kw, target):
            y = self.block_fn(self.soft_block(block, theta, qps), x, kw,
                              qmap=qmap)[0]
            return self.mse(y, target)

        def hard_loss(v_of):
            return self.mean_loss(self.soft_block(
                block, {p: torch.where(v_of(p), 100.0, -100.0)
                        for p in theta}, qps), qmap, fp_outs)

        # the loss of nearest rounding, with the same qparams
        rec = self.records_loss(idx)
        before = hard_loss(lambda p: torch.sigmoid(theta[p]) > 0.5) \
            if rec else None
        rng = np.random.RandomState(idx)
        n_batches = len(self.block_inputs)
        for t in self.thresholds:
            self.harden(theta, t)
            for v in theta.values():
                v.requires_grad_()
            opt = torch.optim.Adam(list(theta.values()), lr=self.lr)
            for _ in range(self.iterations):
                i = int(rng.randint(n_batches))
                if not self.train_step(opt, loss_fn, self.block_inputs[i],
                                       kwargs_list[i], fp_outs[i]):
                    break
            theta = {p: v.detach() for p, v in theta.items()}
        if rec:
            self.train_stats['block_loss'][idx] = (
                before, hard_loss(lambda p: theta[p] > 0))

        # merge: plain rounding with the stored qparams reproduces V's
        for path in self.layout.linears:
            lin = get_path(block, path)
            s, z = qps[path]
            w = lin['w'].to(F32)
            t = reshape_tensor(self.wspec, w)
            frac = t / s - torch.floor(t / s)
            delta = ((theta[path] > 0).to(F32)
                     - (frac > 0.5).to(F32)) * 0.5 * s
            w2 = restore_tensor(self.wspec, t + delta, w.shape)
            newlin = dict(lin, w=w2.to(lin['w'].dtype),
                          gptq_scales=s.reshape(w.shape[0], -1))
            if not (self.wspec.symmetric and self.wspec.round_zp):
                newlin['gptq_zeros'] = z.reshape(w.shape[0], -1)
            block = set_path(block, path, newlin)
        return block

    def apply_loaded_scales(self, idx, block):
        """The AWQ scales of a two-stage pipeline, applied as AWQ applies
        them."""
        for ss in self.layout.subsets:
            s = self.loaded_scales.get(f'model.layers.{idx}.{ss.layers[0]}')
            if s is None:
                continue
            s = torch.as_tensor(s, dtype=F32, device=self.model.device)
            if ss.prev_kind == 'ln':
                ln, fcs = scale_ln_fcs(
                    get_path(block, ss.prev_op),
                    [get_path(block, p) for p in ss.layers], s)
                block = set_path(block, ss.prev_op, ln)
                for p, fc in zip(ss.layers, fcs):
                    block = set_path(block, p, fc)
            else:
                fc1 = get_path(block, ss.prev_op)
                fc2 = get_path(block, ss.layers[0])
                if fc1['w'].shape[0] != fc2['w'].shape[1]:
                    continue
                fc1, fc2 = scale_fc_fc(fc1, fc2, s)
                block = set_path(block, ss.prev_op, fc1)
                block = set_path(block, ss.layers[0], fc2)
        return block

    def subset_transform(self, idx, block, subset, feats):
        return block
