"""SpQR (port of ``llmc_tpu/compression/quantization/spqr.py``): GPTQ's
compensation with fp outliers and double-quantized group qparams.

- The outlier threshold is ``relative_threshold`` times the mean of
  ``var(W, 0) / diag(Hinv)^2``, the variance unbiased (ddof 1) as the
  upstream method's ``torch.Tensor.var`` takes it.
- Each group's qparams come from the group with its likely outliers
  replaced by the group mean, and are themselves fake-quantized by the
  ``scale`` and ``zero`` specs (8-bit per tensor by default).  The likely
  outliers are none (``simplified_outliers``, the default) or those of the
  exact leave-one-out scorer (``_loo_scores``).
- In the column loop an element whose squared error over the factor's
  diagonal exceeds the threshold is marked an outlier and kept fp; the
  compensation then carries its (zero) error.  The marks are stored as
  ``spqr_mask`` beside GPTQ's qparams, and ``static_w_qdq`` adds the
  outliers back at deploy.

The column loop is GPTQ's (``GPTQ._layer_core``): SpQR overrides its three
hooks, the threshold (``_outlier_threshold``), a group's qparams
(``_group_qparams``) and a column's error and marks (``_column_err``).
The reference's loop runs jitted: its divisions by constants are folded
(``folded=True`` here).  As GPTQ's, the column loop is a Python loop of
torch ops on the weight's device.
"""

from __future__ import annotations

import torch

from ...quant.qspec import spec_from_config
from ...quant.quantizer import (div_const, fake_quant_weight,
                                minmax_range, qparams_from_range)
from ...utils.registry import ALGO_REGISTRY
from .gptq import GPTQ

F32 = torch.float32


@ALGO_REGISTRY.register(name='SpQR')
class SpQR(GPTQ):
    HYPERPARAMS = ('relative_threshold', 'simplified_outliers')

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        rt = sp.get('relative_threshold', 0.2)
        self.relative_threshold = float('inf') if rt == 'inf' else float(rt)
        self.simplified_outliers = sp.get('simplified_outliers', True)
        per_tensor8 = {'bit': 8, 'symmetric': False,
                       'granularity': 'per_tensor'}
        self.scale_spec = spec_from_config(dict(sp.get('scale', per_tensor8)))
        self.zero_spec = spec_from_config(dict(sp.get('zero', per_tensor8)))
        if self.wspec.granularity != 'per_group':
            raise ValueError('SpQR: the weight must be quantized per_group '
                             f'(got {self.wspec.granularity!r})')
        self.blocksize = self.wspec.group_size
        self.static_groups = False

    def _group_qparams_dq(self, G: torch.Tensor, mask: torch.Tensor):
        """(scales, zeros) [oc, 1] of a group, its masked elements replaced
        by the group mean, each fake-quantized by its own spec."""
        keep = 1.0 - mask
        denom = torch.clamp(keep.sum(-1, keepdim=True), min=1.0)
        mean = (G * keep).sum(-1, keepdim=True) / denom
        newG = G * keep + mean * mask
        spec = self.wspec.replace(granularity='per_channel')
        qp = qparams_from_range(spec, minmax_range(spec, newG), folded=True)
        s = fake_quant_weight(self.scale_spec, qp.scales, folded=True)
        if spec.symmetric:
            return s, torch.zeros_like(s)
        z = torch.broadcast_to(qp.zeros.to(F32), qp.scales.shape)
        return s, fake_quant_weight(self.zero_spec, z, folded=True)

    def _loo_scores(self, G: torch.Tensor, hd: torch.Tensor) -> torch.Tensor:
        """The exact leave-one-out scorer: for each column j of the group,
        how much the rows' rounding error (over the factor's diagonal)
        falls when j leaves the quantization range.  [oc, gs]."""
        oc, gs = G.shape
        spec = self.wspec.replace(granularity='per_channel', round_zp=False)

        def qdq_rows(X):
            qp = qparams_from_range(spec, minmax_range(spec, X), folded=True)
            z = qp.zeros.to(F32)
            s = torch.clamp(qp.scales, min=1e-9)
            q = torch.clamp(torch.round(X / s + z), spec.qmin, spec.qmax)
            return (q - z) * qp.scales

        ar = torch.arange(gs, device=G.device)
        # row j: the gs - 1 column indices without j
        idx = ar[1:][None, :] - (ar[:, None] >= ar[1:][None, :]).to(ar.dtype)
        loo = G[:, idx]                                    # [oc, gs, gs-1]
        dq = qdq_rows(loo.reshape(oc * gs, gs - 1)).reshape(loo.shape)
        loo_hd = torch.clamp(hd[idx], min=1e-9)            # [gs, gs-1]
        loo_err = (((dq - loo) / loo_hd[None]) ** 2).sum(-1)
        base = (((qdq_rows(G) - G) / torch.clamp(hd, min=1e-9)[None]) ** 2
                ).sum(-1, keepdim=True)
        return base - loo_err

    def _outlier_threshold(self, W, Hinv):
        # the unbiased variance over the output channels, as jnp.var
        # computes it jitted (ddof=1; the upstream method's Tensor.var)
        oc, C = W.shape
        centered = W - div_const(W.sum(0), oc, True)
        var = div_const((centered * centered).sum(0), oc - 1, True)
        return self.relative_threshold * div_const(
            (var / torch.clamp(torch.diagonal(Hinv) ** 2, min=1e-12)).sum(),
            C, True)

    def _group_qparams(self, Wb, Hb, valid, thr):
        if self.relative_threshold != float('inf') \
                and not self.simplified_outliers:
            # likely outliers leave the group's qparam range
            M0 = (self._loo_scores(Wb, torch.diagonal(Hb)) > thr).to(F32)
        else:
            M0 = torch.zeros_like(Wb)
        return self._group_qparams_dq(Wb, M0)

    def _column_err(self, w, qdq, d, thr):
        # an element whose error is above the threshold stays fp: its
        # error, which the compensation carries, is then zero
        m = (((w - qdq) / d) ** 2 > thr).to(F32)
        return (w - (qdq * (1 - m) + w * m)) / d, m

    def static_w_qdq(self, lin, n_out=None) -> torch.Tensor:
        """GPTQ's static qdq, the outliers added back in fp."""
        base = super().static_w_qdq(lin, n_out)
        mask = lin.get('spqr_mask')
        if mask is None:
            return base
        return (base.to(F32) * (1 - mask) + lin['w'].to(F32) * mask
                ).to(lin['w'].dtype)
