"""Kernels and their plain versions.  Importing this package builds
nothing: each kernel is compiled at its first launch (``_build.py``)."""

from .batch_decode import LAUNCHES as _BD_LAUNCHES
from .batch_decode import batch_decode_attention
from .dequant_matmul import LAUNCHES as _DM_LAUNCHES
from .dequant_matmul import XLA_BRANCH as _XLA_BRANCH
from .dequant_matmul import (QMeta, dequant_matmul, dequant_weight,
                             pack_scales_t, pack_weight, unpack_weight)
from .flash_decode import LAUNCHES as _FD_LAUNCHES
from .flash_decode import flash_decode_attention
from .fp8_gemm import LAUNCHES as _FP8_LAUNCHES
from .probe_gemm import LAUNCHES as _PROBE_LAUNCHES

_COUNTERS = (_DM_LAUNCHES, _FD_LAUNCHES, _BD_LAUNCHES, _FP8_LAUNCHES,
             _PROBE_LAUNCHES)


def launch_counts() -> dict:
    """Launches of every kernel since the last ``reset_launch_counts``."""
    return {k: v for d in _COUNTERS for k, v in d.items()}


def xla_branch_calls() -> int:
    """Calls on the card since the last ``reset_launch_counts`` that ran
    the reference's XLA branch in torch ops (a weight no kernel takes)."""
    return _XLA_BRANCH['xla_branch_calls']


def reset_launch_counts() -> None:
    for d in _COUNTERS + (_XLA_BRANCH,):
        for k in d:
            d[k] = 0


__all__ = ['QMeta', 'dequant_matmul', 'dequant_weight', 'pack_scales_t',
           'pack_weight', 'unpack_weight', 'flash_decode_attention',
           'batch_decode_attention', 'launch_counts', 'reset_launch_counts',
           'xla_branch_calls']
