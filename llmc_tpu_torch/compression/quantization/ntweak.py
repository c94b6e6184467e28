"""NormTweaking (port of ``llmc_tpu/compression/quantization/ntweak.py``):
per block, AdamW trains the norm weights (in f32, cast to the block's
type in the forward) on the MSE of the fake-quantized block's output
against the fp block's, with straight-through rounding and a learning
rate that falls with depth, ``tweak_lr * (1 - idx / (2 * n_blocks))``.

The reference's optimizer is ``optax.adamw`` with optax's defaults
(``weight_decay=1e-4``, where ``torch.optim.AdamW`` defaults to 1e-2).
optax adds ``wd * p`` to the Adam update before scaling by the learning
rate; torch decays ``p`` by ``lr * wd`` first: the same step, to rounding,
since the moments do not depend on ``p``.
"""

from __future__ import annotations

import torch

from ...models.adapter import QMap
from ...models.base import LinearQcfg, get_path, set_path
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BlockTraining

F32 = torch.float32
OPTAX_ADAMW_WEIGHT_DECAY = 1e-4


@ALGO_REGISTRY.register(name='NormTweaking')
class NormTweaking(BlockTraining):
    HYPERPARAMS = ('epochs', 'lr')

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        self.epochs = int(sp.get('epochs', 3))
        self.lr = float(sp.get('tweak_lr', 1e-5))
        self.train_stats['norms_moved'] = 0

    def with_norms(self, block, theta):
        for ln, w in theta.items():
            lnp = get_path(block, ln)
            block = set_path(block, ln, dict(lnp, w=w.to(lnp['w'].dtype)))
        return block

    def block_transform(self, idx, block, feats):
        qmap = QMap({p: LinearQcfg(w_spec=self.wspec, a_spec=self.aspec,
                                   ste=True)
                     for p in self.layout.linears})
        kwargs_list = self._kwargs_iter()
        fp_outs = self.fp_targets(block)
        theta = {ln: get_path(block, ln)['w'].to(F32).clone()
                 .requires_grad_()
                 for ln in self.layout.layernorms}
        lr = self.lr * (1.0 - idx / (2 * self.model.n_blocks))
        opt = torch.optim.AdamW(list(theta.values()), lr=lr,
                                weight_decay=OPTAX_ADAMW_WEIGHT_DECAY)

        def loss_fn(x, kw, target):
            y = self.block_fn(self.with_norms(block, theta), x, kw,
                              qmap=qmap)[0]
            return self.mse(y, target)

        rec = self.records_loss(idx)
        before = self.mean_loss(block, qmap, fp_outs) if rec else None
        for _ in range(self.epochs):
            for i, x in enumerate(self.block_inputs):
                if not self.train_step(opt, loss_fn, x, kwargs_list[i],
                                       fp_outs[i]):
                    break
        old = block
        block = self.with_norms(block, {k: v.detach()
                                        for k, v in theta.items()})
        # the norm elements training moved in the block's type (at the
        # shipped rate, 1e-5 a step, a bf16 norm near 1 moves none)
        self.train_stats['norms_moved'] += sum(
            int((get_path(block, ln)['w'] != get_path(old, ln)['w']).sum())
            for ln in theta)
        if rec:
            self.train_stats['block_loss'][idx] = (
                before, self.mean_loss(block, qmap, fp_outs))
        return block
