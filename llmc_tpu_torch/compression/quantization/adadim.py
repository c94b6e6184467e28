"""AdaDim (port of ``llmc_tpu/compression/quantization/adadim.py``): per
linear, the quantization dimension (output or input channels) whose
fake-quantized weight gives the smaller output MSE on the calibration
inputs.  The choice is stored in the layer as ``qdim`` (1: output
channels, 0: input channels), with the output-channel qparams where it
chose those (``gptq_scales`` / ``gptq_zeros``, for packing: B1 and B4 read
no input-channel scales), and baked at ``deploy('fake_quant')``.  The
reference computes both losses and the bake jitted (``folded``).
"""

from __future__ import annotations

import torch

from ...models.base import get_path, linear_apply, set_path
from ...quant.quantizer import fake_quant_weight, tensor_qparams
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BakedAtDeploy

F32 = torch.float32


@ALGO_REGISTRY.register(name='AdaDim')
class AdaDim(BakedAtDeploy):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.dim_choice = {}  # (block, path) -> 'oc' | 'ic'

    def dim_losses(self, w, b, xs):
        """(oc loss, ic loss): the token-weighted output MSE of each
        fake-quantized weight against the fp one."""
        n_tok = sum(x.numel() // x.shape[-1] for x in xs)
        out = []
        for dim_ic in (False, True):
            qw = fake_quant_weight(self.wspec, w, dim_ic=dim_ic, folded=True)
            tot = 0.0
            for x in xs:
                y0 = linear_apply({'w': w, 'b': b}, x)
                y1 = linear_apply({'w': qw, 'b': b}, x)
                tot = tot + torch.mean((y0.to(F32) - y1.to(F32)) ** 2) \
                    * ((x.numel() // x.shape[-1]) / n_tok)
            out.append(tot)
        return tuple(out)

    def subset_transform(self, idx, block, subset, feats):
        inputs = feats[subset.input_key]
        for path in subset.layers:
            lin = get_path(block, path)
            l_oc, l_ic = self.dim_losses(lin['w'], lin.get('b'), inputs)
            choice = 'ic' if float(l_ic) < float(l_oc) else 'oc'
            self.dim_choice[(idx, path)] = choice
            new = dict(lin, qdim=torch.tensor(
                0 if choice == 'ic' else 1, dtype=torch.int32,
                device=lin['w'].device))
            if choice == 'oc':
                # the output-channel qparams, which packing reads
                qp = tensor_qparams(self.wspec, lin['w'], folded=True)[1]
                rows = lin['w'].shape[0]
                new['gptq_scales'] = qp.scales.reshape(rows, -1)
                if not (self.wspec.symmetric and self.wspec.round_zp):
                    new['gptq_zeros'] = torch.broadcast_to(
                        qp.zeros, qp.scales.shape).reshape(rows, -1)
            block = set_path(block, path, new)
        return block

    def bake_fake_quant_weights(self):
        for b in range(self.model.n_blocks):
            blk = self.model.blocks[b]
            for path in self.layout.linears:
                if self.layer_is_ignored(b, path):
                    continue
                lin = get_path(blk, path)
                ic = self.dim_choice.get((b, path), 'oc') == 'ic'
                w = fake_quant_weight(self.wspec, lin['w'], dim_ic=ic,
                                      folded=True)
                blk = set_path(blk, path, dict(lin, w=w))
            self.model.set_block(b, blk)
