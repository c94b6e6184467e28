"""Sparsification: Dense (no-op), Magnitude, Wanda, ShortGPT (port of
``llmc_tpu/compression/sparsification.py``).

The block loop captures each block's subset inputs over the calibration
batches, masks the linears' weights in place of the reference's jitted
functions, and hands the block's outputs to the next block.  ShortGPT
scores each block's Block Influence and removes the least influential
blocks at ``deploy``, which ``run_pipeline`` calls before the transformed
eval, as the reference does; it updates ``hf_config['num_hidden_layers']``
so that ``save_trans`` writes the shortened checkpoint.

As in the reference, a sparsifier has no KV-cache policy: a
``sparse.kvcache`` section (``configs/sparsification/kvsparse/``) is read
by no eval (ROADMAP C), and ``run_pipeline`` warns that it is not applied.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.base import get_path, set_path
from ..utils.registry import ALGO_REGISTRY
from .blockwise import BlockwiseOpt

F32 = torch.float32


class BaseBlockwiseSparsification(BlockwiseOpt):
    def __init__(self, model, sparsity_config, inputs, padding_mask,
                 config):
        super().__init__(model, sparsity_config, inputs, padding_mask,
                         config)
        self.sparsity_config = sparsity_config
        self.layout = model.get_layout()
        self.block_fn = model.block_fn()
        w = sparsity_config.get('weight', sparsity_config)
        self.sparsity = float(w.get('sparsity', 0.5))
        # the reference key is sparse.weight.n_prune_layers; the shipped
        # shortgpt.yml sets sparse.special.n_prune_layers
        self.n_prune_layers = w.get(
            'n_prune_layers',
            (sparsity_config.get('special', {}) or {}).get('n_prune_layers'))

    def block_opt(self, idx: int):
        block = self.model.blocks[idx]
        outs, feats = self.block_forward_capture(block)
        for subset in self.layout.subsets:
            block = self.subset_transform(idx, block, subset, feats)
        self.model.set_block(idx, block)
        self.inputs = outs

    def subset_transform(self, idx, block, subset, feats):
        return block

    def deploy(self, quant_format: str) -> None:
        """The masked weights are in the params: no QMap."""
        return None


@ALGO_REGISTRY.register(name='Dense')
class Dense(BaseBlockwiseSparsification):
    needs_calib = False  # the no-op baseline reads no calibration data


def _masked(w: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    return torch.where(drop, torch.zeros((), dtype=F32, device=w.device),
                       w.to(F32)).to(w.dtype)


@ALGO_REGISTRY.register(name='Magnitude')
class Magnitude(BaseBlockwiseSparsification):
    """Per layer, every weight whose magnitude is at most the value at
    index k (k = sparsity · size) of the sorted magnitudes is zeroed: the
    reference's ``sort(|w|)[k]``.  The CPU selects it (``kthvalue``, one
    pass); the card sorts, as its ``kthvalue`` runs a slice on one thread
    block (12 s for a 7B block's linears)."""

    def prune(self, w: torch.Tensor) -> torch.Tensor:
        a = torch.abs(w.to(F32)).reshape(-1)
        k = int(w.numel() * self.sparsity)
        thresh = (torch.sort(a).values[k] if a.is_cuda
                  else torch.kthvalue(a, k + 1).values)
        return _masked(w, a.reshape(w.shape) <= thresh)

    def subset_transform(self, idx, block, subset, feats):
        for path in subset.layers:
            lin = get_path(block, path)
            block = set_path(block, path, dict(lin, w=self.prune(lin['w'])))
        return block


@ALGO_REGISTRY.register(name='Wanda')
class Wanda(BaseBlockwiseSparsification):
    """Per row, the k smallest of |W|·sqrt(Σ‖x‖²/n) are zeroed (k =
    sparsity · in_features; ranked by a stable sort), the sum taken over
    every calibration batch."""

    @staticmethod
    def scaler_row(xs: List[torch.Tensor]) -> torch.Tensor:
        """Σ‖x‖² of each input channel over every batch, over the sample
        count."""
        total, nsamples = None, 0
        for x in xs:
            x2 = x.reshape(-1, x.shape[-1]).to(F32)
            s = torch.sum(x2 * x2, dim=0)
            total = s if total is None else total + s
            nsamples += x.shape[0] if x.ndim == 3 else 1
        return total / max(nsamples, 1)

    def prune(self, w: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
        metric = torch.abs(w.to(F32)) * torch.sqrt(sr)[None, :]
        k = int(w.shape[1] * self.sparsity)
        order = torch.argsort(metric, dim=-1, stable=True)
        drop = torch.zeros(metric.shape, dtype=torch.bool, device=w.device)
        drop.scatter_(-1, order[:, :k], True)
        return _masked(w, drop)

    def subset_transform(self, idx, block, subset, feats):
        sr = self.scaler_row(feats[subset.input_key])
        for path in subset.layers:
            lin = get_path(block, path)
            block = set_path(block, path, dict(lin, w=self.prune(lin['w'],
                                                                 sr)))
        return block


@ALGO_REGISTRY.register(name='ShortGPT')
class ShortGPT(BaseBlockwiseSparsification):
    """Block Influence layer pruning: a block's importance is Σ(1 − cos)
    between its input and output rows over every calibration sample (NaN
    counted as 0.5); ``deploy`` removes the ``n_prune_layers`` least
    important."""

    def __init__(self, model, sparsity_config, inputs, padding_mask,
                 config):
        super().__init__(model, sparsity_config, inputs, padding_mask,
                         config)
        self.importances = np.zeros(model.n_blocks)
        self.removed: Optional[List[int]] = None   # set by the first deploy

    @staticmethod
    def block_influence(xin: torch.Tensor, xout: torch.Tensor) -> float:
        d = xin.shape[-1]
        a = xin.reshape(-1, d).to(F32)
        b = xout.reshape(-1, d).to(F32)
        sim = torch.sum(a * b, dim=-1) / (torch.linalg.vector_norm(a, dim=-1)
                                          * torch.linalg.vector_norm(b,
                                                                     dim=-1))
        return float(torch.sum(1 - torch.nan_to_num(sim, nan=0.5)))

    def block_opt(self, idx: int):
        outs, _ = self.block_forward_capture(self.model.blocks[idx])
        self.importances[idx] = sum(
            self.block_influence(xin, xout)
            for xin, xout in zip(self.inputs, outs))
        self.inputs = outs

    def remove_layers(self, layers_to_remove: Optional[List[int]] = None
                      ) -> List[int]:
        if not layers_to_remove and self.n_prune_layers:
            layers_to_remove = np.argsort(
                self.importances)[:self.n_prune_layers].tolist()
        for i in sorted(layers_to_remove or [], reverse=True):
            del self.model.params['blocks'][i]
        return layers_to_remove or []

    def deploy(self, quant_format: str) -> None:
        """Remove the blocks, once (``removed``); no QMap."""
        if self.removed is None:
            self.removed = self.remove_layers()
            if self.model.hf_config is not None:
                self.model.hf_config['num_hidden_layers'] = \
                    self.model.n_blocks
        return None
