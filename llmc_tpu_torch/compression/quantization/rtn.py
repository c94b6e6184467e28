"""RTN (round to nearest): no transform, only fake/real quant at deploy
(port of ``llmc_tpu/compression/quantization/rtn.py``)."""

from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BaseBlockwiseQuantization


@ALGO_REGISTRY.register(name='RTN')
class RTN(BaseBlockwiseQuantization):
    def subset_transform(self, idx, block, subset, feats):
        return block
