"""LLM.int8 (port of ``llmc_tpu/compression/quantization/llmint8.py``): no
calibration transform; at run time the activation columns whose absmax
exceeds ``threshold`` stay fp while the rest are quantized, a mask select
through ``LinearQcfg.a_outlier_threshold``."""

from __future__ import annotations

from ...models.base import LinearQcfg
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization


@ALGO_REGISTRY.register(name='LlmInt8')
class LlmInt8(BaseBlockwiseQuantization):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.threshold = float(self.special.get('threshold', 6.0))

    def block_opt(self, idx: int):
        if self.inputs:
            self.inputs = self.block_forward(self.model.blocks[idx])

    def fake_quant_qcfg(self, block_idx, path):
        if self.layer_is_ignored(block_idx, path):
            return None
        return LinearQcfg(w_spec=self.wspec, a_spec=self.aspec,
                          a_outlier_threshold=self.threshold)
