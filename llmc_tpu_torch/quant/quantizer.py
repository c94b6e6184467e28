"""Quantizers (port of ``llmc_tpu/quant/quantizer.py``).

Pure functions of ``(spec, tensor)``.  The operations run in float32 in
the JAX order, so that codes, scales and zeros are bit-equal to the
reference at f32: ``t / s`` (never ``t * (1 / s)``), the 1e-5 range clamp,
the 1e-9 scale clamp and the ``round_zp`` branch.  ``torch.round`` and
``jnp.round`` both round half to even.

One order differs by where the reference runs a function.  Under
``jax.jit`` XLA turns a division by a constant (``amax / qmax``,
``i / mse_grid``, a mean's ``/ n``) into a multiply by its f32
reciprocal; run eagerly it stays a true division.  ``folded=True``
computes those as the jitted reference does: the default of the
functions the reference only runs jitted (the activation quantizers, the
masked and W48 quantizers, the mse and hqq calibrations); the weight
quantizers and the static activation ranges keep the eager division.
A true division here is a tensor by a tensor, which is the same on the
CPU and on the card (a tensor by a Python scalar is a reciprocal
multiply on the card).

The functions are differentiable where the reference's are: ``ste_round``
(the rounding of the gradient-trained algorithms, passed as ``round_fn``)
rounds forward and passes the gradient straight through, and every clip
on a gradient's way is ``clip`` (maximum, then minimum), which gives an
element lying on a bound half the gradient, as ``jnp.clip`` does;
``torch.clamp`` would give it all.  Under straight-through rounding every
code that rounds to ``qmin`` or ``qmax`` lies on a bound.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
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
            amax = clip(torch.maximum(torch.abs(mx), torch.abs(mn)), 1e-5)
            amax = torch.sigmoid(up_factor.to(F32)) * amax
            return -amax, amax
    else:
        if up_factor is not None and low_factor is not None:
            mn = torch.sigmoid(low_factor.to(F32)) * mn
            mx = torch.sigmoid(up_factor.to(F32)) * mx
    return mn, mx


def div_const(x: torch.Tensor, c: float, folded: bool) -> torch.Tensor:
    """x / c for a constant c: the f32 reciprocal multiply of a jitted
    reference (``folded``), else a true division."""
    if folded:
        return x * float(np.float32(1.0) / np.float32(c))
    return x / torch.full_like(x, c)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: the maximum with ``lo``, then the minimum with
    ``hi``, which split the gradient of a tie in half (``torch.clamp``
    passes all of it).  A bound is a tensor or a number, which is filled
    in on ``x``'s device (no host copy: the decode step is captured as a
    CUDA graph)."""
    if lo is not None:
        x = torch.maximum(x, lo if isinstance(lo, torch.Tensor)
                          else x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, hi if isinstance(hi, torch.Tensor)
                          else x.new_full((), hi))
    return x


def qparams_from_range(spec: QuantSpec, rng, folded: bool = False) -> QParams:
    mn, mx = rng
    mn, mx = mn.to(F32), mx.to(F32)
    qmin, qmax = spec.qmin, spec.qmax
    if spec.symmetric or spec.is_float:
        amax = clip(torch.maximum(torch.abs(mx), torch.abs(mn)), 1e-5)
        scales = div_const(amax, qmax, folded)
        zeros = torch.zeros((), dtype=F32, device=mn.device)
    else:
        scales = div_const(clip(mx - mn, 1e-5), qmax - qmin, folded)
        if spec.round_zp:
            zeros = torch.clamp(qmin - torch.round(mn / scales), qmin, qmax)
        else:
            zeros = qmin - mn / scales
    return QParams(scales, zeros)


def mse_range(spec: QuantSpec, t: torch.Tensor):
    """Grid-shrink MSE range search (quant.py:146-204): shrink the minmax
    range by p = 1 - i / grid and keep, per row, the range minimizing
    sum(|qdq(x) - x| ** norm).  The reference's grid is a ``fori_loop``,
    compiled even when called eagerly: its divisions are folded and p is
    one rounding of 1 - i * (1 / grid)."""
    t = t.to(F32)
    mn0, mx0 = minmax_range(spec, t)
    reduce_axes = tuple(range(1, t.ndim)) if t.ndim > 1 else (0,)
    per_tensor = spec.granularity == 'per_tensor'
    best = torch.full(() if per_tensor else (t.shape[0],), float('inf'),
                      dtype=F32, device=t.device)
    bmn, bmx = mn0, mx0
    inv_grid = np.float32(1.0) / np.float32(spec.mse_grid)
    for i in range(int(spec.maxshrink * spec.mse_grid)):
        # XLA contracts 1 - i * (1 / grid) into one fused multiply-add
        p = float(np.float32(1.0 - float(i) * float(inv_grid)))
        mn, mx = p * mn0, p * mx0
        q = quant_dequant(spec, t, qparams_from_range(spec, (mn, mx), True))
        d = torch.abs(q - t) ** spec.mse_norm
        e = d.sum() if per_tensor else d.sum(dim=reduce_axes)
        take = e < best
        best = torch.where(take, e, best)
        tk = take if per_tensor else take.reshape(
            take.shape + (1,) * (mn0.ndim - take.ndim))
        bmn, bmx = torch.where(tk, mn, bmn), torch.where(tk, mx, bmx)
    return bmn, bmx


def hqq_qparams(spec: QuantSpec, t: torch.Tensor,
                folded: bool = True) -> QParams:
    """Half-quadratic proximal solver for (scale, zero) (quant.py:588-610):
    minmax scales, then zeros refined while the mean error falls.  The
    reference's refinement is a ``while_loop``, compiled even when called
    eagerly: its means are folded; ``folded`` is the minmax scales'."""
    t = t.to(F32)
    qp = qparams_from_range(spec, minmax_range(spec, t), folded)
    s_inv = 1.0 / qp.scales
    zeros = torch.broadcast_to(qp.zeros.to(F32), qp.scales.shape).clone()
    lp, kappa = spec.hqq_lp_norm, spec.hqq_kappa
    beta = torch.tensor(spec.hqq_beta, dtype=F32, device=t.device)
    best = torch.tensor(1e4, dtype=F32, device=t.device)
    n_last, n_all = t.shape[-1], t.numel()

    def shrink(x, beta):
        if lp == 1:
            return torch.sign(x) * torch.relu(torch.abs(x) - 1.0 / beta)
        return torch.sign(x) * torch.relu(
            torch.abs(x) - (1.0 / beta) * torch.abs(x) ** (lp - 1))

    for _ in range(spec.hqq_iters):
        w_q = torch.clamp(torch.round(t * s_inv + zeros), spec.qmin,
                          spec.qmax)
        w_r = (w_q - zeros) / s_inv
        w_e = shrink(t - w_r, beta)
        zeros = div_const((w_q - (t - w_e) * s_inv).sum(-1, keepdim=True),
                          n_last, True)
        err = div_const(torch.abs(t - w_r).sum(), n_all, True)
        stop = bool(err >= best)
        best = torch.minimum(best, err)
        beta = beta * kappa
        if stop:
            break
    return QParams(qp.scales, zeros)


def tensor_qparams(spec: QuantSpec, t: torch.Tensor, up_factor=None,
                   low_factor=None, folded: bool = False
                   ) -> Tuple[torch.Tensor, QParams]:
    """Reshape + calibrate (minmax, mse, hqq, or the learnable / stored
    clip factors' range); returns (reshaped tensor, qparams)."""
    t = reshape_tensor(spec, t.to(F32))
    if spec.calib_algo == 'hqq':
        return t, hqq_qparams(spec, t, folded)
    if spec.calib_algo == 'mse':
        rng = mse_range(spec, t)
    elif spec.calib_algo == 'learnable' or up_factor is not None:
        rng = learnable_range(spec, t, up_factor, low_factor)
    else:
        rng = minmax_range(spec, t)
    return t, qparams_from_range(spec, rng, folded)


# --------------------------------------------------------------------------
# Quant / dequant
# --------------------------------------------------------------------------

def stored_qparams(lin) -> QParams:
    """The qparams a method fixed at compress time and stored beside a
    linear's weight (``gptq_scales`` and, unless symmetric with rounded
    zeros, ``gptq_zeros``, each [out, groups] over the weight's own column
    order), laid out as ``reshape_tensor`` groups the weight."""
    s = lin['gptq_scales'].to(F32)
    z = lin.get('gptq_zeros')
    z = torch.zeros((), dtype=F32, device=s.device) if z is None \
        else z.to(F32).reshape(-1, 1)
    return QParams(s.reshape(-1, 1), z)


def quant(spec: QuantSpec, t: torch.Tensor, qp: QParams,
          round_fn=torch.round) -> torch.Tensor:
    t = t.to(F32)
    if spec.is_float:
        scales = torch.where(qp.scales == 0, torch.ones_like(qp.scales),
                             qp.scales)
        scaled = t / scales + qp.zeros
        if spec.use_fp_scaled_cast:
            return float_cast(scaled, spec.e_bits, spec.m_bits, spec.fp_max)
        return round_fn(scaled)
    if spec.round_zp:
        return clip(round_fn(t / qp.scales) + qp.zeros, spec.qmin, spec.qmax)
    return clip(round_fn(t / clip(qp.scales, 1e-9) + qp.zeros),
                spec.qmin, spec.qmax)


def dequant(spec: QuantSpec, q: torch.Tensor, qp: QParams) -> torch.Tensor:
    return (q - qp.zeros) * qp.scales


def quant_dequant(spec: QuantSpec, t: torch.Tensor, qp: QParams,
                  round_fn=torch.round) -> torch.Tensor:
    return dequant(spec, quant(spec, t, qp, round_fn), qp)


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
                      low_factor=None, folded: bool = False,
                      dim_ic: bool = False,
                      round_fn=torch.round) -> torch.Tensor:
    """Dynamic weight fake-quant (quant.py:831-867).  ``dim_ic``
    quantizes along the input channels (AdaDim)."""
    if spec is None:
        return w
    qw = w.T if dim_ic else w
    if spec.is_float and not spec.use_fp_scaled_cast:
        out = _float_elementwise_qdq(spec, reshape_tensor(spec, qw))
    else:
        t, qp = tensor_qparams(spec, qw, up_factor, low_factor, folded)
        out = quant_dequant(spec, t, qp, round_fn)
    out = restore_tensor(spec, out, qw.shape)
    return (out.T if dim_ic else out).to(w.dtype)


def fake_quant_weight_static(spec: QuantSpec, w: torch.Tensor, qp: QParams,
                             round_fn=torch.round) -> torch.Tensor:
    """Weight fake-quant with given qparams."""
    t = reshape_tensor(spec, w)
    out = quant_dequant(spec, t, qp, round_fn)
    return restore_tensor(spec, out, w.shape).to(w.dtype)


def fake_quant_act(spec: Optional[QuantSpec], a: torch.Tensor,
                   folded: bool = True, round_fn=torch.round) -> torch.Tensor:
    """Dynamic activation fake-quant (quant.py:744-782); the jitted
    reference's order by default."""
    if spec is None:
        return a
    if spec.is_float and not spec.use_fp_scaled_cast:
        out = _float_elementwise_qdq(spec, reshape_tensor(spec, a))
    else:
        t, qp = tensor_qparams(spec, a, folded=folded)
        out = quant_dequant(spec, t, qp, round_fn)
    return restore_tensor(spec, out, a.shape).to(a.dtype)


def fake_quant_act_static(spec: QuantSpec, a: torch.Tensor,
                          qp: QParams) -> torch.Tensor:
    """Activation fake-quant with calibrated (static) qparams."""
    t = reshape_tensor(spec, a)
    out = quant_dequant(spec, t, qp)
    return restore_tensor(spec, out, a.shape).to(a.dtype)


def real_quant_weight(spec: QuantSpec, w: torch.Tensor, up_factor=None,
                      low_factor=None, qp: Optional[QParams] = None):
    """Quantize to integer (or fp8) codes plus (scales, zeros) laid out
    per output channel (quant.py:916-960); ``qp``: given qparams (as
    ``reshape_tensor`` groups ``w``) instead of the calibration's."""
    shape = w.shape
    if qp is None:
        t, qp = tensor_qparams(spec, w, up_factor, low_factor)
    else:
        t = reshape_tensor(spec, w.to(F32))
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


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (in int8, range [-8, 7] or [0, 15]) two a byte along
    the last axis: the low nibble is the even index.  Returns int8."""
    assert codes.shape[-1] % 2 == 0
    u = codes.to(torch.uint8) & 0xF
    lo, hi = u[..., 0::2], u[..., 1::2]
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor, signed: bool = True) -> torch.Tensor:
    u = packed.contiguous().view(torch.uint8) if packed.dtype == torch.int8 \
        else packed.to(torch.uint8)
    lo, hi = u & 0xF, u >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    out = out.to(torch.int8)
    if signed:
        out = torch.where(out >= 8, out - 16, out)
    return out


# --------------------------------------------------------------------------
# Weight48 double quantization (quant.py:1232-1369)
# --------------------------------------------------------------------------

def _w48_qparams(spec: QuantSpec, t: torch.Tensor, clamps=None,
                 folded: bool = True) -> QParams:
    """Weight48 qparams: the minmax range, an always-rounded zero point,
    then the scales and zeros clamped to the ``scales_bit`` /
    ``zeros_bit`` budgets; the zero point is clamped to the zeros bounds
    only, which default to (qmin, qmax)."""
    mn, mx = minmax_range(spec, t)
    if spec.symmetric:
        amax = torch.clamp(torch.maximum(torch.abs(mx), torch.abs(mn)),
                           min=1e-5)
        scales = div_const(amax, spec.qmax, folded)
        zeros = torch.zeros((), dtype=F32, device=t.device)
    else:
        scales = div_const(torch.clamp(mx - mn, min=1e-5),
                           spec.qmax - spec.qmin, folded)
        zeros = spec.qmin - torch.round(mn / scales)
    smin, smax, zmin, zmax = clamps or (None, None, None, None)
    if smin is not None:
        scales = torch.clamp(scales, smin, smax)
    if not spec.symmetric:
        zeros = torch.clamp(zeros, spec.qmin if zmin is None else zmin,
                            spec.qmax if zmax is None else zmax)
    return QParams(scales, zeros)


def fake_quant_weight_w48(spec8: QuantSpec, spec4: QuantSpec,
                          w: torch.Tensor, clamps8=None, clamps4=None,
                          folded: bool = True) -> torch.Tensor:
    """Quantize to 8 bits, quantize the 8-bit codes to 4 bits, and
    reconstruct (``bit: 48``).  ``clamps*`` are (scale_min, scale_max,
    zero_min, zero_max) from the budgets (None keeps a default)."""
    t8 = reshape_tensor(spec8, w.to(F32))
    qp8 = _w48_qparams(spec8, t8, clamps8, folded)
    q8r = restore_tensor(spec8, quant(spec8, t8, qp8), w.shape)
    t4 = reshape_tensor(spec4, q8r)
    qp4 = _w48_qparams(spec4, t4, clamps4, folded)
    if folded:
        # XLA contracts the 4-bit dequant's multiply and the 8-bit zero's
        # subtraction into one fused multiply-add: exact in float64 here
        # (small integers times f32 scales), then one rounding
        v = (quant(spec4, t4, qp4) - qp4.zeros).to(torch.float64) \
            * qp4.scales.to(torch.float64)
        v8 = reshape_tensor(spec8, restore_tensor(spec4, v, w.shape))
        out = (v8 - qp8.zeros.to(torch.float64)).to(F32) * qp8.scales
    else:
        q4r = restore_tensor(spec4, quant_dequant(spec4, t4, qp4), w.shape)
        out = dequant(spec8, reshape_tensor(spec8, q4r), qp8)
    return restore_tensor(spec8, out, w.shape).to(w.dtype)


# --------------------------------------------------------------------------
# Mixed int / fp columns (LLM.int8 and QUIK style)
# --------------------------------------------------------------------------

_BIG = 3.4e38


def masked_qparams(spec: QuantSpec, x: torch.Tensor, sel: torch.Tensor,
                   folded: bool = True) -> QParams:
    """Per-row qparams of ``x`` [..., C] from the columns where ``sel``
    (broadcast against ``x``) holds alone."""
    xf = x.to(F32)
    if spec.symmetric:
        amax = torch.clamp(torch.amax(torch.abs(torch.where(
            sel, xf, torch.zeros_like(xf))), dim=-1, keepdim=True), min=1e-5)
        return QParams(div_const(amax, spec.qmax, folded),
                       torch.zeros((), dtype=F32, device=x.device))
    mn = torch.amin(torch.where(sel, xf, torch.full_like(xf, _BIG)),
                    dim=-1, keepdim=True)
    mx = torch.amax(torch.where(sel, xf, torch.full_like(xf, -_BIG)),
                    dim=-1, keepdim=True)
    return qparams_from_range(spec, (mn, mx), folded)


def fake_quant_weight_masked(spec: QuantSpec, w: torch.Tensor,
                             int_mask: torch.Tensor,
                             folded: bool = True) -> torch.Tensor:
    """Quantize only the columns where ``int_mask`` holds, with per-channel
    qparams from those columns alone; the others stay as they are."""
    wf = w.to(F32)
    sel = int_mask[None, :]
    q = quant_dequant(spec, wf, masked_qparams(spec, wf, sel, folded))
    return torch.where(sel, q, wf).to(w.dtype)


def fake_quant_act_masked(spec: QuantSpec, a: torch.Tensor,
                          int_mask: torch.Tensor,
                          folded: bool = True) -> torch.Tensor:
    """Per-token activation fake-quant over the ``int_mask`` columns only;
    the others stay as they are."""
    af = a.to(F32)
    sel = int_mask.reshape((1,) * (a.ndim - 1) + (-1,))
    q = quant_dequant(spec, af, masked_qparams(spec, af, sel, folded))
    return torch.where(sel, q, af).to(a.dtype)


# --------------------------------------------------------------------------
# Static activation calibration (quant.py:403-543), per tensor
# --------------------------------------------------------------------------

def static_minmax_range(batches):
    """The global min / max over every calibration batch."""
    mn = min(float(torch.min(b)) for b in batches)
    mx = max(float(torch.max(b)) for b in batches)
    dev = batches[0].device
    return (torch.tensor(mn, dtype=F32, device=dev),
            torch.tensor(mx, dtype=F32, device=dev))


def static_moving_minmax_range(batches, alpha: float = 0.01):
    """An EMA of the per-batch min / max, in Python floats as the
    reference's."""
    mn = mx = None
    for b in batches:
        bmn, bmx = float(torch.min(b)), float(torch.max(b))
        if mn is None:
            mn, mx = bmn, bmx
        else:
            mn = mn + alpha * (bmn - mn)
            mx = mx + alpha * (bmx - mx)
    dev = batches[0].device
    return (torch.tensor(mn, dtype=F32, device=dev),
            torch.tensor(mx, dtype=F32, device=dev))


def static_hist_range(spec: QuantSpec, batches, bins: int = 2048):
    """Histogram-threshold search: a global histogram, then [min, max]
    shrunk greedily while the L2 quantization error estimated from it
    falls.  Host-side numpy, as in the reference (calibration only)."""
    arrs = [b.detach().to(F32).cpu().numpy().ravel() for b in batches]
    gmin = min(a.min() for a in arrs)
    gmax = max(a.max() for a in arrs)
    gmax = max(gmax, gmin + 1e-8)
    hist = np.zeros(bins, np.float64)
    for a in arrs:
        h, _ = np.histogram(a, bins=bins, range=(gmin, gmax))
        hist += h
    bin_width = (gmax - gmin) / bins
    dst_nbins = int(2 ** (spec.bit if not spec.is_float else 8))

    def quant_error(start_bin, end_bin):
        dst_bin_width = bin_width * (end_bin - start_bin + 1) / dst_nbins
        if dst_bin_width == 0:
            return float('inf')
        centers = gmin + (np.arange(bins) + 0.5) * bin_width
        lo = gmin + start_bin * bin_width
        hi = gmin + (end_bin + 1) * bin_width
        q = np.round((np.clip(centers, lo, hi) - lo) / dst_bin_width - 0.5)
        deq = lo + (q + 0.5) * dst_bin_width
        return float((hist * (centers - deq) ** 2).sum())

    total = hist.sum()
    csum = np.cumsum(hist)
    alpha, beta = 0.0, 1.0
    stepsize = 1e-5
    start_bin, end_bin = 0, bins - 1
    norm_min = float('inf')
    while alpha < beta:
        next_alpha, next_beta = alpha + stepsize, beta - stepsize
        left, right = start_bin, end_bin
        while left < end_bin and csum[left] < next_alpha * total:
            left += 1
        while right > start_bin and csum[right] > next_beta * total:
            right -= 1
        next_start, next_end = start_bin, end_bin
        if (left - start_bin) > (end_bin - right):
            next_start = left
            alpha = next_alpha
        else:
            next_end = right
            beta = next_beta
        if next_start == start_bin and next_end == end_bin:
            continue
        norm = quant_error(next_start, next_end)
        if norm > norm_min:
            break
        norm_min = norm
        start_bin, end_bin = next_start, next_end
    dev = batches[0].device
    return (torch.tensor(gmin + bin_width * start_bin, dtype=F32, device=dev),
            torch.tensor(gmin + bin_width * (end_bin + 1), dtype=F32,
                         device=dev))


def static_qparams_from_batches(spec: QuantSpec, batches, algo: str
                                ) -> QParams:
    """Static activation calibration, per tensor (the reference asserts
    the same): ``static_hist``, ``static_moving_minmax`` or the minmax."""
    if algo == 'static_hist':
        rng = static_hist_range(spec, batches)
    elif algo == 'static_moving_minmax':
        rng = static_moving_minmax_range(batches)
    else:
        rng = static_minmax_range(batches)
    return qparams_from_range(spec, rng)


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through rounding of the gradient-trained algorithms:
    ``torch.round`` (half to even) forward, the identity backward."""
    return _SteRound.apply(x)
