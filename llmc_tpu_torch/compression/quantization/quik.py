"""QUIK (port of ``llmc_tpu/compression/quantization/quik.py``): mixed int
and fp columns chosen by activation magnitude.

Per linear, the input channels are ranked by their calibration absmax;
the top ``fp_features`` (times ``in_features // hidden_size`` with
``fp_relative``) stay fp in both the weight and the activation, unless the
layer's largest activation is at most ``fp_threshold``.  The choice is a
boolean column mask, ``int_mask`` (True: quantized), which ``linear_apply``
reads under ``LinearQcfg.mixed_cols``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.base import LinearQcfg, get_path, set_path
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization, channel_absmax


@ALGO_REGISTRY.register(name='QUIK')
class QUIK(BaseBlockwiseQuantization):
    HYPERPARAMS = ('fp_relative', 'fp_features', 'fp_threshold')

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        self.fp_relative = sp.get('fp_relative', False)
        self.fp_features = int(sp.get('fp_features', 128))
        self.fp_threshold = float(sp.get('fp_threshold', 0.0))

    def outlier_num(self, ic: int, act_max: float) -> int:
        """How many of a linear's ``ic`` input channels stay fp."""
        n = (ic // self.model.cfg.hidden_size) * self.fp_features \
            if self.fp_relative else self.fp_features
        n = min(n, ic - 1)
        if n > 0 and act_max <= self.fp_threshold:
            n = 0
        return n

    def subset_transform(self, idx, block, subset, feats):
        # the fp columns by numpy's argsort of the host copy, as the
        # reference picks them (torch.argsort orders ties otherwise)
        scales = channel_absmax(feats[subset.input_key]).cpu().numpy()
        for path in subset.layers:
            lin = get_path(block, path)
            ic = lin['w'].shape[1]
            n = self.outlier_num(ic, float(scales.max()))
            mask = np.ones(ic, bool)
            if n > 0:
                mask[np.argsort(scales)[-n:]] = False
            block = set_path(block, path, dict(
                lin, int_mask=torch.from_numpy(mask).to(lin['w'].device)))
        return block

    def fake_quant_qcfg(self, block_idx, path):
        if self.layer_is_ignored(block_idx, path):
            return None
        return LinearQcfg(w_spec=self.wspec, a_spec=self.aspec,
                          mixed_cols=True)
