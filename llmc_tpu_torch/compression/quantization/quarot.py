"""QuaRot (port of ``llmc_tpu/compression/quantization/quarot.py``): one
orthogonal (random Hadamard) rotation Q of the residual stream, folded into
the weights, and with ``special.online_rotate`` a Hadamard online before
o_proj (across heads) and down_proj (full), whose other factor is folded
into v_proj's rows and the two projections' columns.

The embeddings are untied and their mean removed, the norms made
weightless by folding them into the next linears (so ||xQ|| = ||x||
keeps every RMSNorm's function), and Q applied on both sides of every
linear that reads or writes the residual stream: 'transformed' PPL equals
pretrain up to the rounding of the weights' dtype.  Q comes from a
``torch.Generator`` seeded with ``special.seed`` on the model's device
(``make_rotation``, which a caller may override to hand in another Q).
"""

from __future__ import annotations

import dataclasses

import torch

from ...models.base import get_path, has_path, set_path
from ...ops.hadamard import apply_exact_had_to_linear, get_rotation
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization
from ..transforms import (fuse_ln_fcs, remove_mean_from_embed,
                          rotate_embedding, rotate_post_layer,
                          rotate_pre_layer)


@ALGO_REGISTRY.register(name='Quarot')
class Quarot(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.rotate_mode = self.special.get('rotate_mode', 'hadamard')
        self.preprocess()

    def make_rotation(self, n: int) -> torch.Tensor:
        """The [n, n] rotation of the residual stream."""
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(
            int(self.special.get('seed', 0)))
        return get_rotation(n, gen, self.rotate_mode, device=dev)

    # ------------------------------------------------------------------
    def preprocess(self):
        params = self.model.params
        cfg = self.model.cfg
        if 'lm_head' not in params or cfg.tie_word_embeddings:
            params['lm_head'] = {'w': params['embed_tokens']['w'], 'b': None}
            self.model.cfg = dataclasses.replace(cfg,
                                                 tie_word_embeddings=False)
            cfg = self.model.cfg
        params['embed_tokens'] = remove_mean_from_embed(
            params['embed_tokens'])
        self.Q = self.make_rotation(cfg.hidden_size)
        params['embed_tokens'] = rotate_embedding(params['embed_tokens'],
                                                  self.Q)
        # fuse the final norm into the head, weightless; rotate the head
        norm, heads = fuse_ln_fcs(params['norm'], [params['lm_head']])
        params['norm'] = norm
        params['lm_head'] = rotate_pre_layer(heads[0], self.Q)
        self.model.params = params

    # ------------------------------------------------------------------
    def block_opt(self, idx: int):
        block = self.block_rotate(self.model.blocks[idx])
        self.model.set_block(idx, block)
        if self.inputs:
            # data-free: forward once for a chained algorithm
            self.inputs = self.block_forward(block)

    def block_rotate(self, block):
        for subset in self.layout.subsets:
            if not subset.do_trans:
                continue
            layers = list(subset.layers)
            missing = [p for p in layers if not has_path(block, p)]
            if missing:
                # the reference's rotation looks the path up and raises
                # KeyError (DeepSeek's dense first block has no experts)
                raise NotImplementedError(
                    f'QuaRot rotates every linear of subset '
                    f'{subset.name!r}, and this block has no {missing[0]}: '
                    f'a model with dense and MoE blocks is not rotated, as '
                    f'in the reference')
            if subset.prev_kind == 'ln':
                ln = get_path(block, subset.prev_op)
                fcs = [get_path(block, p) for p in layers]
                ln, fcs = fuse_ln_fcs(ln, fcs)
                block = set_path(block, subset.prev_op, ln)
                for p, fc in zip(layers, fcs):
                    block = set_path(block, p, rotate_pre_layer(fc, self.Q))
            else:
                # the output-side projections write the residual stream
                for p in layers:
                    fc = rotate_post_layer(get_path(block, p), self.Q)
                    if self.online_rotate and subset.is_mlp:
                        fc = dict(fc, w=apply_exact_had_to_linear(
                            fc['w'], had_dim=-1, output=False))
                    block = set_path(block, p, fc)
                if self.online_rotate and not subset.is_mlp:
                    # a per-head Hadamard on v_proj's output, a full one on
                    # o_proj's input
                    prev = get_path(block, subset.prev_op)
                    prev = dict(prev, w=apply_exact_had_to_linear(
                        prev['w'], had_dim=self.model.cfg.head_dim,
                        output=True))
                    block = set_path(block, subset.prev_op, prev)
                    fc = get_path(block, layers[0])
                    fc = dict(fc, w=apply_exact_had_to_linear(
                        fc['w'], had_dim=-1, output=False))
                    block = set_path(block, layers[0], fc)
        return block
