"""Weight quantizers (port of ``llmc_tpu/quant/quantizer.py:41-349``).

Pure functions of ``(spec, tensor)``.  The operations run in float32 in
the JAX order, so that codes, scales and zeros are bit-equal to the
reference at f32: ``t / s`` (never ``t * (1 / s)``), the 1e-5 range clamp,
the 1e-9 scale clamp and the ``round_zp`` branch.  ``torch.round`` and
``jnp.round`` both round half to even.

Ported: the minmax range, the sigmoid-bounded range of AWQ's stored clip
factors (``up_factor`` / ``low_factor``), and the float formats of
``FLOAT_FORMATS`` (scaled cast and per-element exponent scales).  Not
ported yet (ROADMAP A2): the ``mse``, ``hqq`` and ``learnable``
calibrations; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .fp_formats import float_cast
from .qspec import QuantSpec

F32 = torch.float32


class QParams(NamedTuple):
    scales: torch.Tensor
    zeros: torch.Tensor  # 0-d zero tensor for symmetric


# --------------------------------------------------------------------------
# Granularity reshape (quant.py:612-658)
# --------------------------------------------------------------------------

def reshape_tensor(spec: QuantSpec, t: torch.Tensor) -> torch.Tensor:
    """Reshape so that the quantization group is the last axis (or, for
    per_block, axes (1, 3))."""
    if spec.granularity == 'per_group':
        d = t.shape[-1]
        if d >= spec.group_size:
            if d % spec.group_size:
                pad = spec.group_size - d % spec.group_size
                t = torch.cat([t, t.new_zeros(t.shape[:-1] + (pad,))],
                              dim=-1)
            return t.reshape(-1, spec.group_size)
        return t
    if spec.granularity == 'per_head':
        return t.reshape(spec.head_num, -1)
    if spec.granularity == 'per_block':
        m, n = t.shape
        bs = spec.block_size
        mp, np_ = -(-m // bs) * bs, -(-n // bs) * bs
        t = torch.nn.functional.pad(t, (0, np_ - n, 0, mp - m))
        return t.reshape(mp // bs, bs, np_ // bs, bs)
    return t


def restore_tensor(spec: QuantSpec, t: torch.Tensor, shape) -> torch.Tensor:
    if tuple(t.shape) == tuple(shape):
        return t
    if spec.granularity == 'per_block':
        bs = spec.block_size
        mb, _, nb, _ = t.shape
        t = t.reshape(mb * bs, nb * bs)
        return t[:shape[0], :shape[1]]
    flat = t.reshape(*shape[:-1], -1)
    return flat[..., :shape[-1]]


# --------------------------------------------------------------------------
# Range estimation
# --------------------------------------------------------------------------

def minmax_range(spec: QuantSpec, t: torch.Tensor):
    t = t.to(F32)
    if spec.granularity == 'per_tensor':
        return torch.min(t), torch.max(t)
    if spec.granularity == 'per_block':
        a = torch.abs(t)
        return (torch.amin(a, dim=(1, 3), keepdim=True),
                torch.amax(a, dim=(1, 3), keepdim=True))
    return (torch.amin(t, dim=-1, keepdim=True),
            torch.amax(t, dim=-1, keepdim=True))


def learnable_range(spec: QuantSpec, t: torch.Tensor, up_factor=None,
                    low_factor=None):
    """Sigmoid-bounded shrink of the minmax range (quant.py:205-222): the
    range of AWQ's clip-v2 factors stored per layer."""
    mn, mx = minmax_range(spec, t)
    if spec.symmetric:
        if up_factor is not None:
            amax = torch.clamp(torch.maximum(torch.abs(mx), torch.abs(mn)),
                               min=1e-5)
            amax = torch.sigmoid(up_factor.to(F32)) * amax
            return -amax, amax
    else:
        if up_factor is not None and low_factor is not None:
            mn = torch.sigmoid(low_factor.to(F32)) * mn
            mx = torch.sigmoid(up_factor.to(F32)) * mx
    return mn, mx


def qparams_from_range(spec: QuantSpec, rng) -> QParams:
    mn, mx = rng
    mn, mx = mn.to(F32), mx.to(F32)
    qmin, qmax = spec.qmin, spec.qmax
    if spec.symmetric or spec.is_float:
        amax = torch.clamp(torch.maximum(torch.abs(mx), torch.abs(mn)),
                           min=1e-5)
        scales = amax / qmax
        zeros = torch.zeros((), dtype=F32, device=mn.device)
    else:
        scales = torch.clamp(mx - mn, min=1e-5) / (qmax - qmin)
        if spec.round_zp:
            zeros = torch.clamp(qmin - torch.round(mn / scales), qmin, qmax)
        else:
            zeros = qmin - mn / scales
    return QParams(scales, zeros)


def tensor_qparams(spec: QuantSpec, t: torch.Tensor, up_factor=None,
                   low_factor=None) -> Tuple[torch.Tensor, QParams]:
    """Reshape + calibrate (minmax, or the stored clip factors' range);
    returns (reshaped tensor, qparams)."""
    if spec.calib_algo != 'minmax':
        raise NotImplementedError(
            f'calib_algo={spec.calib_algo!r} is not ported yet (ROADMAP A2)')
    t = reshape_tensor(spec, t.to(F32))
    if up_factor is not None:
        rng = learnable_range(spec, t, up_factor, low_factor)
    else:
        rng = minmax_range(spec, t)
    return t, qparams_from_range(spec, rng)


# --------------------------------------------------------------------------
# Quant / dequant
# --------------------------------------------------------------------------

def quant(spec: QuantSpec, t: torch.Tensor, qp: QParams) -> torch.Tensor:
    t = t.to(F32)
    if spec.is_float:
        scales = torch.where(qp.scales == 0, torch.ones_like(qp.scales),
                             qp.scales)
        scaled = t / scales + qp.zeros
        if spec.use_fp_scaled_cast:
            return float_cast(scaled, spec.e_bits, spec.m_bits, spec.fp_max)
        return torch.round(scaled)
    if spec.round_zp:
        return torch.clamp(torch.round(t / qp.scales) + qp.zeros,
                           spec.qmin, spec.qmax)
    return torch.clamp(
        torch.round(t / torch.clamp(qp.scales, min=1e-9) + qp.zeros),
        spec.qmin, spec.qmax)


def dequant(spec: QuantSpec, q: torch.Tensor, qp: QParams) -> torch.Tensor:
    return (q - qp.zeros) * qp.scales


def quant_dequant(spec: QuantSpec, t: torch.Tensor,
                  qp: QParams) -> torch.Tensor:
    return dequant(spec, quant(spec, t, qp), qp)


def _float_elementwise_qdq(spec: QuantSpec, t: torch.Tensor) -> torch.Tensor:
    """Per-element exponent-scale float fake-quant, the reference's
    non-qtorch path (quant.py:1005-1027)."""
    t = t.to(F32)
    mn, mx = minmax_range(spec, t)
    maxval = torch.clamp(torch.maximum(mx, -mn), min=1e-12)
    e, m = spec.e_bits, spec.m_bits
    bias = 2.0 ** e - torch.log2(maxval) + math.log2(2 - 2.0 ** (-m)) - 1
    xc = torch.clamp(t, -maxval, maxval)
    log_scales = torch.clamp(
        torch.floor(torch.log2(torch.abs(xc) + 1e-38) + bias), min=1.0)
    scales = torch.exp2(log_scales - m - bias)
    return torch.round(xc / scales) * scales


def fake_quant_weight(spec, w: torch.Tensor, up_factor=None,
                      low_factor=None) -> torch.Tensor:
    """Dynamic weight fake-quant (quant.py:831-867)."""
    if spec is None:
        return w
    if spec.is_float and not spec.use_fp_scaled_cast:
        out = _float_elementwise_qdq(spec, reshape_tensor(spec, w))
    else:
        t, qp = tensor_qparams(spec, w, up_factor, low_factor)
        out = quant_dequant(spec, t, qp)
    return restore_tensor(spec, out, w.shape).to(w.dtype)


def real_quant_weight(spec: QuantSpec, w: torch.Tensor, up_factor=None,
                      low_factor=None):
    """Quantize to integer (or fp8) codes plus (scales, zeros) laid out
    per output channel (quant.py:916-960)."""
    shape = w.shape
    t, qp = tensor_qparams(spec, w, up_factor, low_factor)
    q = quant(spec, t, qp)
    q = restore_tensor(spec, q, shape)
    if spec.is_float:
        if spec.bit not in ('e4m3', 'e5m2'):
            raise ValueError(f'no storage type for float format {spec.bit!r}')
        codes = q.to(torch.float8_e4m3fn if spec.bit == 'e4m3'
                     else torch.float8_e5m2)
        zeros = None
    else:
        codes = q.to(torch.int8 if spec.qmin != 0 else torch.uint8)
        zeros = None if spec.symmetric else qp.zeros
    if spec.granularity == 'per_tensor':
        qshape = (1,)
    elif spec.granularity == 'per_block':
        qshape = (qp.scales.shape[0], qp.scales.shape[2])
    else:
        qshape = (shape[0], -1)
    scales = qp.scales.reshape(qshape)
    if zeros is not None:
        zeros = zeros.reshape(qshape).to(
            torch.int8 if spec.round_zp else F32)
    return codes, scales, zeros
