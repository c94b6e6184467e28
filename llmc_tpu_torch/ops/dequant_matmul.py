"""Dequant-matmul over packed weights (port of
``llmc_tpu/ops/dequant_matmul.py``): W4A16, W4A8, W8A16 and the
per-channel W8A8 dot.

Host side: ``QMeta``, group-pair ``pack_weight``, ``pack_scales_t``,
``unpack_weight``, ``dequant_weight``, the per-token int8 activation
quantizer ``_quant_act_token`` and the plain matmuls, which mirror the
reference's XLA paths (``_dequant_matmul_xla``, ``_dequant_matmul_xla_a8``,
``_dequant_matmul_a8_staged``) including the ``pre_t`` un-fold
``z_eff = zs / clip(s, 1e-9)``.

Kernels, one wrapper each, every GEMM the Hopper port of a TPU kernel:

- ``w4_dequant_matmul``   -> ``csrc/dequant_matmul_w4.cu``   (``_kernel_w4``)
- ``w4a8_dequant_matmul`` -> ``csrc/dequant_matmul_w4a8.cu`` (``_kernel_w4a8``)
- ``w8_dequant_matmul``   -> ``csrc/dequant_matmul_w8.cu``   (``_kernel_w8``)
- ``quant_act_token``     -> ``csrc/quant_act_token.cu``: W4A8's activation
  quantizer (XLA ops in the reference, no TPU kernel), with the int32 piece
  sums the W4A8 kernel's zero term reads

``dequant_matmul`` keeps the reference's dispatch.  A CPU tensor takes the
plain version.  On a CUDA tensor one rule decides, by the weight's
metadata alone (``kernel_takes``): the port runs its hand kernel for every
weight that a TPU kernel of the reference takes, and more; a weight that
no TPU kernel of the reference takes (the reference's ``pallas_ok`` fails,
``llmc_tpu/ops/dequant_matmul.py:514-517``) and no kernel of the port
takes runs the plain version, the counterpart of the reference's XLA
branch, in torch ops on the card, and adds one to
``XLA_BRANCH['xla_branch_calls']``.  Nothing is chosen by a failed build
or launch: a kernel that the rule picks launches or raises.  Two branches
are plain torch on both devices because the reference runs them in XLA
and has no Pallas kernel for them: the per-channel W8A8 dot
(``_int8_dot``: ``torch._int_mm`` on the card, an exact int32 matmul on
the CPU) and the per-group W8A8 emulation.

A packed byte is **unsigned** here, as ``pack_weight`` emits it and as the
reference's XLA path reads it (``& 0xFF``).  The reference's
``random_packed_llama`` stores packed bytes as int8, which its TPU kernel sign-extends
(``dequant_matmul.py:216``), so its kernel and XLA paths disagree on such
bytes; the port's converter reinterprets int8 nibble bytes as uint8.  A
bits=8 ``qweight`` (and ``qweight8``) is a **signed** int8 code and keeps
its sign.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import torch

from ..utils.device import sm_count
from . import _build

F32 = torch.float32

# Launches of the CUDA kernel (the plain version never counts).
LAUNCHES = {'w4_dequant_matmul': 0, 'w4a8_dequant_matmul': 0,
            'w8_dequant_matmul': 0, 'quant_act_token': 0}
# Calls on a CUDA tensor that ran the reference's XLA branch in torch ops,
# for a weight that no kernel takes (here and in ``quant/fp8_block.py``);
# ``ops.reset_launch_counts`` resets it with the launch counters.
XLA_BRANCH = {'xla_branch_calls': 0}


@dataclasses.dataclass(frozen=True)
class QMeta:
    """Static metadata for a packed weight."""

    bits: int = 4
    group_size: int = 128
    symmetric: bool = False
    out_features: int = 0
    in_features: int = 0
    # pre_t: scales/zeros stored pre-transposed [ng, N], zero term folded
    # (zs = s * z_eff)
    pre_t: bool = False


# --------------------------------------------------------------------------
# Packing (group-pair)
# --------------------------------------------------------------------------

def pack_weight(codes: torch.Tensor, scales: torch.Tensor,
                zeros: Optional[torch.Tensor], meta: QMeta
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """codes: integer codes [N, K] (int4 range for bits=4).  Returns
    (packed [N, K/2] uint8 | [N, K] int8, scales f32 [N, K/gs],
    zeros f32 [N, K/gs] | None)."""
    N, K = codes.shape
    gs = meta.group_size if meta.group_size > 0 else K
    if meta.bits == 4:
        if not ((K // gs) % 2 == 0 or K == gs):
            raise ValueError(
                f'group-pair packing needs an even group count ({K}/{gs})')
        c = codes.to(torch.int32)
        if meta.symmetric:
            c = c + 8  # excess-8: store unsigned, correct on output
        u = (c & 0xF).to(torch.uint8)
        if K == gs:  # single group: pair = halves of the group
            lo, hi = u[:, :K // 2], u[:, K // 2:]
        else:
            u = u.reshape(N, K // (2 * gs), 2, gs)
            lo = u[:, :, 0, :].reshape(N, K // 2)
            hi = u[:, :, 1, :].reshape(N, K // 2)
        packed = (lo | (hi << 4)).to(torch.uint8)
    else:
        packed = codes.to(torch.int8)
    s = scales.reshape(N, -1).to(F32)
    z = zeros.reshape(N, -1).to(F32) if zeros is not None else None
    return packed, s, z


def pack_scales_t(scales: torch.Tensor, zeros: Optional[torch.Tensor],
                  meta: QMeta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-transpose + fold for ``pre_t``: returns (s_t [ng, N],
    zs_t [ng, N]) with zs = s * z_eff, z_eff including the excess-8
    offset of symmetric storage."""
    N = scales.shape[0]
    s = scales.reshape(N, -1).to(F32)
    z = (zeros.reshape(N, -1).to(F32) if zeros is not None
         else torch.zeros_like(s))
    z_eff = z + 8.0 if meta.symmetric else z
    return s.T.contiguous(), (s * z_eff).T.contiguous()


def unpack_weight(packed: torch.Tensor, meta: QMeta) -> torch.Tensor:
    """Inverse of pack_weight -> integer codes [N, K] as float32.  Bytes
    are read unsigned whatever their storage type."""
    if meta.bits != 4:
        return packed.to(F32)
    N, half = packed.shape
    K = half * 2
    gs = meta.group_size if meta.group_size > 0 else K
    u = packed.to(torch.int32) & 0xFF
    lo = u & 0xF
    hi = u >> 4
    if meta.symmetric:
        lo = lo - 8
        hi = hi - 8
    if K == gs:
        codes = torch.cat([lo, hi], dim=-1)
    else:
        lo = lo.reshape(N, K // (2 * gs), 1, gs)
        hi = hi.reshape(N, K // (2 * gs), 1, gs)
        codes = torch.cat([lo, hi], dim=2).reshape(N, K)
    return codes.to(F32)


unpack_weight_xla = unpack_weight  # the reference's name


def dequant_weight(packed, scales, zeros, meta: QMeta) -> torch.Tensor:
    codes = unpack_weight(packed, meta)  # [N, K]
    N, K = codes.shape
    gs = meta.group_size if meta.group_size > 0 else K
    c = codes.reshape(N, K // gs, gs)
    if zeros is not None:
        c = c - zeros.reshape(N, -1, 1)
    return (c * scales.reshape(N, -1, 1)).reshape(N, K)


dequant_weight_xla = dequant_weight  # the reference's name


# --------------------------------------------------------------------------
# Plain version (the reference's XLA path)
# --------------------------------------------------------------------------

def _unfold_pre_t(scales, zeros, meta: QMeta):
    """[ng, N] folded (s, zs) -> legacy [N, ng] (s, z) for the plain path
    (dequant_matmul.py:554-559)."""
    s = scales.T
    z_eff = zeros.T / torch.clamp(s, min=1e-9)
    z = z_eff - 8.0 if meta.symmetric else z_eff
    return s, z, dataclasses.replace(meta, pre_t=False)


def dequant_matmul_plain(x, packed, scales, zeros, meta: QMeta,
                         out_dtype=None, w_bf16: bool = False
                         ) -> torch.Tensor:
    """x [M, K] -> [M, N]: dequantize in f32, one f32 matmul.  With
    ``w_bf16`` the dequantized weight and x are rounded to bf16 first, as
    the W8 kernel does (the function ``_kernel_w8`` computes)."""
    if meta.pre_t:
        scales, zeros, meta = _unfold_pre_t(scales, zeros, meta)
    w = dequant_weight(packed, scales, zeros, meta)
    xf = x.to(F32)
    if w_bf16:
        w = w.to(torch.bfloat16).to(F32)
        xf = x.to(torch.bfloat16).to(F32)
    y = torch.matmul(xf, w.T)
    return y.to(out_dtype or x.dtype)


def _quant_act_token(x: torch.Tensor, folded: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8 (the W4A8 runtime's activation
    quantizer, and per-'row' the w8 companion's).  Returns (xq int8,
    sx [M, 1] f32).

    The reference runs its serving steps under ``jax.jit``, where XLA
    folds ``max(ax, 1e-8) / 127.0`` into a multiply by the f32
    reciprocal of 127: ``folded`` computes the scale so on either device
    (``tensor / scalar`` is a true division on the CPU and a reciprocal
    multiply on the card, so neither spelling of the division is right on
    both).  ``folded=False`` is the true division of the reference run
    eagerly, as its packer runs ``w8_companion``.  ``x / sx`` stays a true
    division in both."""
    xf = x.to(F32)
    ax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    sx = ax * (1.0 / 127.0) if folded else \
        ax / torch.full_like(ax, 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def quant_act_token_plain(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The quantizer kernel's function: ``_quant_act_token``'s (xq, sx)
    and the exact int32 sums of xq over each 64-column piece, [K/64, Mp]
    with Mp = M rounded up to a multiple of 4 (zeros past M)."""
    xq, sx = _quant_act_token(x)
    M, K = xq.shape
    sums = torch.zeros((K // WG_UNIT, -(-M // 4) * 4), dtype=torch.int32,
                       device=x.device)
    sums[:, :M] = xq.to(torch.int32).reshape(M, K // WG_UNIT, WG_UNIT
                                             ).sum(-1).T
    return xq, sx, sums


def quant_act_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(xq int8 [M, K], sx f32 [M, 1], sums int32 [K/64, Mp]) of x [M, K]
    (bf16 or f32, K a multiple of 64): ``csrc/quant_act_token.cu`` in one
    launch for a CUDA tensor, ``quant_act_token_plain`` for a CPU one."""
    M, K = x.shape
    if not x.is_cuda:
        return quant_act_token_plain(x)
    if x.dtype not in (torch.bfloat16, F32):
        raise ValueError(f'quant_act_token takes bf16 or f32 x, got '
                         f'{x.dtype}')
    if K % WG_UNIT or M < 1:
        raise ValueError(f'quant_act_token needs M >= 1 and K a multiple of '
                         f'{WG_UNIT} (M={M}, K={K})')
    _check_operands(x, {'x': (x, x.dtype, (M, K))}, None)
    Mp = -(-M // 4) * 4
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=F32, device=x.device)
    sums = torch.empty((K // WG_UNIT, Mp), dtype=torch.int32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().llmc_quant_act_token(
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), sums.data_ptr(), M, K,
        Mp, int(x.dtype == F32), stream)
    _build.check(err, 'quant_act_token')
    LAUNCHES['quant_act_token'] += 1
    return xq, sx, sums


def dequant_matmul_plain_a8(x, packed, scales, zeros, meta: QMeta,
                            out_dtype=None) -> torch.Tensor:
    """The W4A8 / W8A8 emulation (the reference's
    ``_dequant_matmul_xla_a8``): per-token int8 codes of x against the
    dequantized weight in one f32 matmul, then the per-token scale."""
    if meta.pre_t:
        scales, zeros, meta = _unfold_pre_t(scales, zeros, meta)
    xq, sx = _quant_act_token(x)
    w = dequant_weight(packed, scales, zeros, meta)
    y = torch.matmul(xq.to(F32), w.T) * sx
    return y.to(out_dtype or x.dtype)


def _int8_dot(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 times w8 [N, K] int8, transposed -> [M, N] int32,
    exact.  The reference leaves this dot to XLA, outside any Pallas
    kernel, so on the card it is ``torch._int_mm``, which refuses 16 rows
    or fewer: the rows are padded to a multiple of 8, at least 32, and
    the result sliced; it also takes K and N in multiples of 8 only, so
    both are zero-padded to them (exact: a zero code adds nothing) and the
    columns sliced.  On the CPU it is an int32 matmul."""
    if not xq.is_cuda:
        return torch.matmul(xq.to(torch.int32), w8.to(torch.int32).T)
    M, K = xq.shape
    N = w8.shape[0]
    Mp = max(32, -(-M // 8) * 8)
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        xq = torch.nn.functional.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w8 = torch.nn.functional.pad(w8, (0, Kp - K, 0, Np - N))
    return torch._int_mm(xq.contiguous(), w8.T)[:M, :N]


def w8a8_channel_matmul(x, w8, scales8, out_dtype=None) -> torch.Tensor:
    """The per-channel W8A8 dot (dequant_matmul.py:523-535): per-token
    int8 x against int8 codes [N, K] with one f32 scale per output
    channel.  The int32 result is cast and scaled in f32."""
    xq, sx = _quant_act_token(x)
    y = _int8_dot(xq, w8).to(F32) * (sx * scales8.reshape(-1)[None, :].to(F32))
    return y.to(out_dtype or x.dtype)


# Row count from which the W4A8 path re-quantizes the w4 weight to
# per-channel int8 once per call and runs one full-K int8 dot.  Off by
# default, as in the reference, and on an H100 it should stay off:
# ``chip_smoke.py`` times it beside the W4A8 kernel at 4096 rows
# (``staged_ms`` against ``path_ms``), where it is slower at every linear
# of Llama-2-7B.
A8_STAGE_MIN_M = int(os.environ.get('LLMC_A8_STAGE_MIN_M', str(2 ** 62)))


def _dequant_matmul_a8_staged(x, packed, scales, zeros, meta: QMeta,
                              out_dtype=None) -> torch.Tensor:
    """W4A8 prefill staging: w4 -> per-channel int8 weight, then one
    int8 dot.  Plain torch on both devices (XLA in the reference)."""
    if meta.pre_t:
        scales, zeros, meta = _unfold_pre_t(scales, zeros, meta)
    w8, s8 = _quant_act_token(dequant_weight(packed, scales, zeros, meta))
    return w8a8_channel_matmul(x, w8, s8[:, 0], out_dtype)


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

def _half_group(meta: QMeta) -> Tuple[int, bool]:
    """(gsl, single): the K span of one nibble half and whether the
    weight has a single scale group (K == gs)."""
    K = meta.in_features
    gs = meta.group_size if meta.group_size > 0 else K
    single = gs == K
    return (K // 2 if single else gs), single


def _check_kernel_meta(meta: QMeta, M: int, K: int, span: int = 64,
                       item: str = 'B1') -> Tuple[int, bool]:
    """Raise on a weight the kernel does not take; returns (gsl, single).
    ``span``: the columns of a half group the kernel reads at a time (64
    for the W4A16 and W4A8 kernels, 128 for B1's old design), ROADMAP
    ``item`` naming it."""
    N = meta.out_features
    gsl, single = _half_group(meta)
    if meta.bits != 4 or K != meta.in_features:
        raise ValueError(f'kernel takes bits=4 with K={meta.in_features}; '
                         f'got bits={meta.bits}, K={K}')
    if not single and (K // gsl) % 2:
        raise ValueError(f'odd group count {K // gsl}: the group-pair '
                         f'layout needs an even count')
    if gsl % span:
        raise NotImplementedError(
            f'the kernel reads {span}-column pieces of each half group; a '
            f'span of {gsl} is not ported yet (ROADMAP {item})')
    if N < 1 or M < 1:
        raise ValueError(f'kernel needs M, N >= 1 (N={N}, M={M})')
    return gsl, single


# CTAs the card keeps resident per SM for each row tile of the mma.sync
# probes (shared memory and registers): below one full wave of tiles the
# K loop is split across CTAs
_RESIDENT = {16: 2, 32: 1, 64: 1}


def _even_splits(units: int, splits: int) -> int:
    """The fewest splits that deal ``units`` K steps out as evenly as
    ``splits`` do (every split gets at least one)."""
    if splits <= 1:
        return 1
    per = -(-units // splits)
    return -(-units // per)


def _tiling(M: int, N: int, units: int, sms: int,
            bm: Optional[int] = None) -> Tuple[int, int]:
    """(row tile BM, K splits) of the mma.sync kernels (the probes) when
    the K loop has ``units`` steps that can be dealt out to CTAs; ``bm``
    fixes the row tile (else it follows M)."""
    bm = bm or next(b for b in (16, 32, 64) if M <= b or b == 64)
    tiles = -(-N // 128) * -(-M // bm)
    want = sms * _RESIDENT[bm]
    splits = 1 if tiles >= want else min(units, -(-want // tiles))
    return bm, _even_splits(units, splits)


def kernel_tiling(M: int, N: int, K: int, gsl: int,
                  sms: int) -> Tuple[int, int]:
    """(row tile BM, K splits) for a W4 mma.sync kernel (B1's old design,
    a probe) on a card of ``sms`` SMs: the K loop is dealt out in group
    pairs."""
    return _tiling(M, N, (K // 2) // gsl, sms)


# The wgmma kernels (W4A16, W4A8, W8A16, FP8-block): a CTA covers WG_ROWS
# weight rows by a token tile from TOKEN_TILES (wgmma's N), and its K loop
# walks units of WG_UNIT weight bytes a row (64 columns of each half group
# for W4 and W4A8, 64 columns for W8; 128 columns, one scale block, for
# FP8-block).
WG_ROWS = 128
WG_UNIT = 64
TOKEN_TILES = (8, 16, 32, 64, 128)
# a split's cost in waves: above the decode tiles, and at them
SPLIT_COST = (0.05, 0.02)


def w4_steps(K: int, gsl: int) -> int:
    """K steps of the W4A16 kernel: two 64-column pieces of each half group
    a step where a half group holds two (one epilogue a step), else one."""
    units = (K // 2) // WG_UNIT
    return units // 2 if gsl % (2 * WG_UNIT) == 0 else units


@functools.lru_cache(maxsize=4096)
def wgmma_tiling(M: int, N: int, units: int,
                 sms: int) -> Tuple[int, int]:
    """(token tile T, K splits) of the wgmma kernels on a card of ``sms``
    SMs (one CTA fills an SM).  T is the smallest tile that holds the M
    tokens, else 128, repeated.  The K loop of ``units`` steps is split
    over CTAs, below four waves of tiles, to the count with the fewest
    waves of CTAs per split (a tail wave costs as much as a full one), each
    split beyond the first counted as SPLIT_COST[T <= 16] of a wave (its
    f32 partials: a few rows at decode tiles, the whole output above
    them)."""
    T = next(t for t in TOKEN_TILES if M <= t or t == TOKEN_TILES[-1])
    tiles = -(-N // WG_ROWS) * -(-M // T)
    if tiles >= 4 * sms:      # a tail of at most a quarter: no split
        return T, 1
    cost = SPLIT_COST[T <= 16]
    splits = min(range(1, min(units, 16) + 1),
                 key=lambda n: (-(-tiles * n // sms) / n + cost * (n - 1), n))
    return T, _even_splits(units, splits)


def _check_operands(x, want, out_dtype) -> None:
    """Each kernel operand: dtype, shape, device, contiguity, alignment;
    and ``out_dtype`` bf16 or f32 (None: the caller's own check)."""
    dev = x.device
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or t.shape != shape:
            raise ValueError(f'{name}: want {dt} {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name}: must be contiguous on {dev}')
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: must be 16-byte aligned')
    if out_dtype is not None and out_dtype not in (torch.bfloat16, F32):
        raise ValueError(f'out_dtype must be bf16 or f32, got {out_dtype}')


def _out_and_partial(M, N, splits, out_dtype, device):
    out = torch.empty((M, N), dtype=out_dtype, device=device)
    partial = (torch.empty((splits, M, N), dtype=F32, device=device)
               if splits > 1 else out)
    return out, partial


def w4_dequant_matmul(x: torch.Tensor, packed: torch.Tensor,
                      s_t: torch.Tensor, zs_t: torch.Tensor, meta: QMeta,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the Hopper kernel: x [M, K] bf16, packed [N, K/2] uint8,
    s_t / zs_t [ng, N] f32 (pre_t layout) -> [M, N] ``out_dtype`` (bf16,
    or f32 for the head).  Checks what the kernel takes and raises on
    anything else."""
    M, K = x.shape
    N = meta.out_features
    if not x.is_cuda:
        raise ValueError('w4_dequant_matmul launches a CUDA kernel; '
                         'x is on the CPU')
    gsl, single = _check_kernel_meta(meta, M, K)
    ng = 1 if single else K // gsl
    _check_operands(x, {'x': (x, torch.bfloat16, (M, K)),
                        'packed': (packed, torch.uint8, (N, K // 2)),
                        's': (s_t, F32, (ng, N)),
                        'zs': (zs_t, F32, (ng, N))}, out_dtype)
    tt, splits = wgmma_tiling(M, N, w4_steps(K, gsl),
                              sm_count(x.device.index))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    # one f32 scratch: x's row sums over each 64-column piece (the zero
    # term; rows padded to a multiple of 4 for the kernel's TMA), then the
    # split-K partials
    n_sums = (K // WG_UNIT) * (-(-M // 4) * 4)
    scratch = torch.empty(n_sums + (splits * M * N if splits > 1 else 0),
                          dtype=F32, device=x.device)
    sums = scratch.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().llmc_w4_dequant_matmul(
        x.data_ptr(), packed.data_ptr(), s_t.data_ptr(), zs_t.data_ptr(),
        sums, out.data_ptr(), sums + 4 * n_sums, M, N, K, gsl, int(single),
        int(out_dtype == F32), tt, splits, stream)
    _build.check(err, 'w4_dequant_matmul')
    LAUNCHES['w4_dequant_matmul'] += 1
    return out


def w4a8_dequant_matmul(xq: torch.Tensor, sx: torch.Tensor,
                        sums: torch.Tensor, packed: torch.Tensor,
                        s_t: torch.Tensor, zs_t: torch.Tensor, meta: QMeta,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the W4A8 Hopper kernel on ``quant_act_token``'s outputs: xq
    [M, K] int8 per-token codes, sx [M, 1] f32 and sums [K/64, Mp] int32
    (made before the launch, as the reference quantizes before its
    kernel), packed [N, K/2] uint8, s_t / zs_t [ng, N] f32 -> [M, N]
    ``out_dtype``.  The kernel also applies the zero / excess-8
    correction and the per-token scale."""
    M, K = xq.shape
    N = meta.out_features
    if not xq.is_cuda:
        raise ValueError('w4a8_dequant_matmul launches a CUDA kernel; '
                         'xq is on the CPU')
    gsl, single = _check_kernel_meta(meta, M, K, span=WG_UNIT, item='B3')
    ng = 1 if single else K // gsl
    _check_operands(xq, {'xq': (xq, torch.int8, (M, K)),
                         'sx': (sx, F32, (M, 1)),
                         'sums': (sums, torch.int32,
                                  (K // WG_UNIT, -(-M // 4) * 4)),
                         'packed': (packed, torch.uint8, (N, K // 2)),
                         's': (s_t, F32, (ng, N)),
                         'zs': (zs_t, F32, (ng, N))}, out_dtype)
    tt, splits = wgmma_tiling(M, N, w4_steps(K, gsl),
                              sm_count(xq.device.index))
    out, partial = _out_and_partial(M, N, splits, out_dtype, xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = _build.lib().llmc_w4a8_dequant_matmul(
        xq.data_ptr(), packed.data_ptr(), s_t.data_ptr(), zs_t.data_ptr(),
        sums.data_ptr(), sx.data_ptr(), out.data_ptr(), partial.data_ptr(),
        M, N, K, gsl, int(single), int(out_dtype == F32), tt, splits,
        stream)
    _build.check(err, 'w4a8_dequant_matmul')
    LAUNCHES['w4a8_dequant_matmul'] += 1
    return out


W8_GROUP = 32   # the W8 kernel's scale groups: a multiple of this


def _w4_takes(meta: QMeta) -> bool:
    """B1 and B3 take a group-pair weight whose half groups (or single
    group's halves) are whole 64-column pieces."""
    K = meta.in_features
    gs = meta.group_size if meta.group_size > 0 else K
    gsl, single = _half_group(meta)
    return (K % gs == 0 and (single or (K // gs) % 2 == 0)
            and gsl % WG_UNIT == 0)


def _w8_takes(meta: QMeta) -> bool:
    """B4 takes scale groups of a multiple of 32 columns that divide K, K a
    multiple of its 64-column unit."""
    K = meta.in_features
    gs = meta.group_size if meta.group_size > 0 else K
    return gs % W8_GROUP == 0 and K % gs == 0 and K % WG_UNIT == 0


def kernel_takes(meta: QMeta, a_int8: bool = False) -> bool:
    """The dispatch rule on a CUDA tensor, by the weight's metadata alone:
    whether a hand kernel of the port takes the weight (bits=4: B1, or B3
    with ``a_int8``; bits=8 weight-only: B4).  It takes every weight that
    the reference's ``pallas_ok`` takes (half groups of a multiple of 128
    columns, W8 groups of a multiple of 128), and more; what it refuses
    runs the reference's XLA branch in torch ops.  bits=8 with ``a_int8``
    has no kernel in either package.  The kernels take any N (an odd one
    too: TMA zero-fills the weight rows past N, and the epilogue and the
    split-K sum store element by element where N is no multiple of 4)."""
    if meta.bits == 4:
        return _w4_takes(meta)
    return meta.bits == 8 and not a_int8 and _w8_takes(meta)


def _check_w8_meta(meta: QMeta, M: int, K: int) -> int:
    """Raise on a weight the W8 kernel does not take; returns gs."""
    N = meta.out_features
    gs = meta.group_size if meta.group_size > 0 else K
    if meta.bits != 8 or K != meta.in_features:
        raise ValueError(f'kernel takes bits=8 with K={meta.in_features}; '
                         f'got bits={meta.bits}, K={K}')
    if not _w8_takes(meta):
        raise NotImplementedError(
            f'the W8 kernel takes scale groups of a multiple of {W8_GROUP} '
            f'columns that divide K, K a multiple of {WG_UNIT}; group size '
            f'{gs} at K={K} is not ported (ROADMAP B4)')
    if N < 1 or M < 1:
        raise ValueError(f'kernel needs M, N >= 1 (N={N}, M={M})')
    return gs


def w8_dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                      s: torch.Tensor, z: Optional[torch.Tensor],
                      meta: QMeta, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the W8A16 Hopper kernel: x [M, K] bf16, codes [N, K] int8,
    s / z [N, ng] f32 as ``pack_weight`` stores them (``z`` None: no zero
    point) -> [M, N] ``out_dtype``.  Each weight is dequantized
    ``(code - z) * s`` in f32 and rounded to bf16 before the dot, as
    ``_kernel_w8`` does."""
    M, K = x.shape
    N = meta.out_features
    if not x.is_cuda:
        raise ValueError('w8_dequant_matmul launches a CUDA kernel; '
                         'x is on the CPU')
    gs = _check_w8_meta(meta, M, K)
    ng = K // gs
    want = {'x': (x, torch.bfloat16, (M, K)),
            'codes': (codes, torch.int8, (N, K)), 's': (s, F32, (N, ng))}
    if z is not None:
        want['z'] = (z, F32, (N, ng))
    _check_operands(x, want, out_dtype)
    tt, splits = wgmma_tiling(M, N, K // WG_UNIT, sm_count(x.device.index))
    out, partial = _out_and_partial(M, N, splits, out_dtype, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().llmc_w8_dequant_matmul(
        x.data_ptr(), codes.data_ptr(), s.data_ptr(),
        (z if z is not None else s).data_ptr(), out.data_ptr(),
        partial.data_ptr(), M, N, K, gs, int(z is not None),
        int(out_dtype == F32), tt, splits, stream)
    _build.check(err, 'w8_dequant_matmul')
    LAUNCHES['w8_dequant_matmul'] += 1
    return out


def _kernel_operands(scales, zeros, meta: QMeta):
    """[ng, N] (s, zs) for the W4 kernels from either layout (the
    reference wrapper's transpose/fold, :408-415)."""
    if meta.pre_t:
        return scales, zeros
    z = zeros if zeros is not None else torch.zeros_like(scales)
    z_eff = z + 8.0 if meta.symmetric else z
    return scales.T.contiguous(), (scales * z_eff).T.contiguous()


def _dequant_matmul_cuda(x2, packed, scales, zeros, meta: QMeta, out_dtype,
                         a_int8: bool) -> torch.Tensor:
    """On the card: the kernel of (bits, a_int8) for a weight that
    ``kernel_takes``, else the reference's XLA branch in torch ops
    (counted in ``XLA_BRANCH``)."""
    if meta.bits not in (4, 8):
        raise NotImplementedError(f'bits={meta.bits}: no kernel for the '
                                  f'card (only 4 and 8 are served)')
    if not kernel_takes(meta, a_int8):
        XLA_BRANCH['xla_branch_calls'] += 1
        plain = dequant_matmul_plain_a8 if a_int8 else dequant_matmul_plain
        return plain(x2, packed, scales, zeros, meta, out_dtype=out_dtype)
    if meta.bits == 4:
        s_t, zs_t = _kernel_operands(scales, zeros, meta)
        if a_int8:
            if x2.dtype not in (torch.bfloat16, F32):
                x2 = x2.to(F32)
            xq, sx, sums = quant_act_token(x2.contiguous())
            return w4a8_dequant_matmul(xq, sx, sums, packed, s_t, zs_t, meta,
                                       out_dtype)
        return w4_dequant_matmul(x2.to(torch.bfloat16).contiguous(), packed,
                                 s_t, zs_t, meta, out_dtype)
    if meta.pre_t:
        raise ValueError('bits=8 weights have no pre_t layout')
    # the kernel reads the stored [N, ng] layout: no torch op here
    N = meta.out_features
    return w8_dequant_matmul(
        x2.to(torch.bfloat16).contiguous(), packed, scales.reshape(N, -1),
        zeros.reshape(N, -1) if zeros is not None else None, meta,
        out_dtype)


def dequant_matmul(x, packed, scales, zeros, meta: QMeta, out_dtype=None,
                   a_int8: bool = False):
    """y = x @ dequant(packed).T for x [*, K], with the reference's
    dispatch.  ``a_int8`` (bits 4 and 8): per-token dynamic int8
    activations.

    - bits=8, ``a_int8``, one group per channel: the W8A8 dot, on both
      devices (symmetric weights only: anything else raises).
    - bits=8, ``a_int8``, per group: the plain emulation on both devices
      (the reference has no kernel for it either).
    - bits=4, ``a_int8``, at least ``A8_STAGE_MIN_M`` rows: the staged
      per-channel dot, plain torch.
    - else a CUDA tensor launches the kernel of (bits, a_int8) for a weight
      that ``kernel_takes`` and runs the plain version (the reference's
      XLA branch) on the card for any other; a CPU tensor takes the plain
      version."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {x2.device}')
    a_int8 = a_int8 and meta.bits in (4, 8)
    od = out_dtype or x.dtype
    if a_int8 and meta.bits == 8:
        if meta.group_size >= meta.in_features:
            if zeros is not None and not meta.symmetric:
                raise ValueError('the per-channel a8 dot requires symmetric '
                                 'weights')
            y = w8a8_channel_matmul(x2, packed, scales, od)
        else:
            y = dequant_matmul_plain_a8(x2, packed, scales, zeros, meta, od)
    elif a_int8 and x2.shape[0] >= A8_STAGE_MIN_M:
        y = _dequant_matmul_a8_staged(x2, packed, scales, zeros, meta, od)
    elif x2.is_cuda:
        y = _dequant_matmul_cuda(x2, packed, scales, zeros, meta, od, a_int8)
    else:
        plain = dequant_matmul_plain_a8 if a_int8 else dequant_matmul_plain
        y = plain(x2, packed, scales, zeros, meta, out_dtype=od)
    return y.reshape(*lead, -1)
