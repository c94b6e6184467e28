"""Low-precision float casts (port of ``llmc_tpu/quant/fp_formats.py``):
e2m1 / e3m2 / e4m3 / e5m2 / e4m7, round to nearest even, saturating.

Plain torch ops on both devices (the reference has no kernel here).  The
operations follow the reference one for one, so the results are bit-equal
at f32: ``frexp`` for the exponent, an exact power-of-two step, ``x /
step`` (never ``x * (1 / step)``), ``round`` (half to even), ``clip``.
"""

from __future__ import annotations

import torch

from .qspec import FLOAT_FORMATS

F32 = torch.float32


def _pow2(exp: torch.Tensor) -> torch.Tensor:
    """2 ** exp as f32, exact, from the exponent field (exp in the normal
    range -126 .. 127)."""
    return ((exp.to(torch.int32) + 127) << 23).view(F32)


def float_cast(x: torch.Tensor, e_bits: int, m_bits: int,
               max_val: float) -> torch.Tensor:
    """Round ``x`` to the nearest value of a 1-sign / e_bits / m_bits float
    format, saturating at +-max_val.  Subnormals: exponents below the
    minimum normal exponent take the fixed subnormal step."""
    xf = x.to(F32)
    bias = 2 ** (e_bits - 1) - 1
    min_normal_exp = 1 - bias

    ax = torch.abs(xf)
    # ax = mant * 2^e with mant in [0.5, 1): floor(log2(ax)) == e - 1
    _, exp = torch.frexp(torch.where(ax == 0, torch.ones_like(ax), ax))
    exp = torch.clamp(exp - 1, min=min_normal_exp)
    step = _pow2(exp - m_bits)
    q = torch.round(xf / step) * step
    q = torch.clamp(q, -max_val, max_val)
    return torch.where(ax == 0, torch.zeros_like(q), q).to(x.dtype)


def float_cast_format(x: torch.Tensor, fmt: str) -> torch.Tensor:
    e, m, mx = FLOAT_FORMATS[fmt]
    return float_cast(x, e, m, mx)
