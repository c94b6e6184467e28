from .fp8_block import (act_quant_per_group, fp8_block_matmul,
                        weight_cast_to_bf16, weight_cast_to_fp8)
from .fp_formats import float_cast, float_cast_format
from .qspec import FLOAT_FORMATS, QuantSpec, spec_from_config

__all__ = ['QuantSpec', 'spec_from_config', 'FLOAT_FORMATS', 'float_cast',
           'float_cast_format', 'act_quant_per_group', 'fp8_block_matmul',
           'weight_cast_to_bf16', 'weight_cast_to_fp8']
