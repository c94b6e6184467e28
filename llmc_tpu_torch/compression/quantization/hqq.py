"""HQQ (port of ``llmc_tpu/compression/quantization/hqq.py``):
half-quadratic proximal optimization of the zero points, per layer and
data-free.  Each linear's fake-quantized weight is stored beside it as
``hqq_w``; ``deploy('fake_quant')`` bakes it in.  Along the output
channels (``axis: 1``) the solver's scales and float zeros are stored
too, as ``gptq_scales`` / ``gptq_zeros``, for packing.  The solver is the
quantizer's ``hqq_qparams``, which the reference runs jitted (its
divisions folded).
"""

from __future__ import annotations

import torch

from ...models.base import get_path, set_path
from ...quant.quantizer import (hqq_qparams, quant_dequant, reshape_tensor,
                                restore_tensor)
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BakedAtDeploy

F32 = torch.float32


@ALGO_REGISTRY.register(name='HQQ')
class HQQ(BakedAtDeploy):
    HYPERPARAMS = ('axis',)

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        self.wspec = self.wspec.replace(
            calib_algo='hqq',
            hqq_lp_norm=sp.get('lp_norm', self.wspec.hqq_lp_norm),
            hqq_beta=sp.get('beta', self.wspec.hqq_beta),
            hqq_kappa=sp.get('kappa', self.wspec.hqq_kappa),
            hqq_iters=sp.get('iters', self.wspec.hqq_iters))
        self.axis = sp.get('axis', 1)  # 0: quantize along the input channels

    def hyperparams(self):
        s = self.wspec
        return dict(super().hyperparams(), lp_norm=s.hqq_lp_norm,
                    beta=s.hqq_beta, kappa=s.hqq_kappa, iters=s.hqq_iters)

    def qdq_layer(self, w: torch.Tensor):
        """(the fake-quantized weight, the solver's (scales, zeros) as
        [out, groups], or None along the input channels)."""
        t = w.to(F32)
        if self.axis == 0:
            t = t.T
        tr = reshape_tensor(self.wspec, t)
        qp = hqq_qparams(self.wspec, tr)
        out = restore_tensor(self.wspec, quant_dequant(self.wspec, tr, qp),
                             t.shape)
        if self.axis == 0:
            return out.T.to(w.dtype), None
        rows = w.shape[0]
        return out.to(w.dtype), (qp.scales.reshape(rows, -1),
                                 qp.zeros.reshape(rows, -1))

    def block_opt(self, idx: int):
        # data-free: no capture pass
        block = self.model.blocks[idx]
        for path in self.layout.linears:
            lin = get_path(block, path)
            wq, qp = self.qdq_layer(lin['w'])
            new = dict(lin, hqq_w=wq)
            if qp is not None:
                # the solver's qparams, which packing reads
                new['gptq_scales'], new['gptq_zeros'] = qp
            block = set_path(block, path, new)
        self.model.set_block(idx, block)
        if self.inputs:
            self.inputs = self.block_forward(block)

    def bake_fake_quant_weights(self):
        for b in range(self.model.n_blocks):
            blk = self.model.blocks[b]
            for path in self.layout.linears:
                lin = get_path(blk, path)
                if 'hqq_w' in lin:
                    new = dict(lin, w=lin['hqq_w'])
                    del new['hqq_w']
                    blk = set_path(blk, path, new)
            self.model.set_block(b, blk)
