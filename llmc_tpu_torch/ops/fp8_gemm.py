"""The blockwise-scaled FP8 GEMM (port of ``llmc_tpu/ops/fp8_gemm.py``).

``fp8_block_matmul_cuda`` launches ``csrc/fp8_block_gemm.cu``, the Hopper
port of the TPU kernel ``_kernel_fp8`` (the codes multiplied as f16 on the
tensor cores: exact, where the e4m3 ones keep too few bits of a sum);
``fp8_block_matmul_plain`` is the same function in plain torch (the
reference's XLA branch, ``quant/fp8_block.py:92-103``), used by the tests
and for CPU tensors.
The dispatch between them is ``quant/fp8_block.py::fp8_block_matmul``:
on a CUDA tensor the kernel takes every block size that
``kernel_takes_block`` allows, a superset of what the reference's Pallas
kernel lowers on a TPU (a multiple of 128 columns, or the whole K), and
the plain version runs the rest in torch ops on the card.
"""

from __future__ import annotations

import torch

from ..utils.device import sm_count
from . import _build
from .dequant_matmul import _check_operands, _out_and_partial, wgmma_tiling

F32 = torch.float32
E4M3 = torch.float8_e4m3fn
UNIT = 64     # the kernel's K unit: 64 columns

# Launches of the CUDA kernel (the plain version never counts).
LAUNCHES = {'fp8_block_gemm': 0}


def fp8_block_matmul_plain(x_codes, x_scales, w_codes, w_scale_inv,
                           block_size: int = 128,
                           out_dtype: torch.dtype = torch.bfloat16,
                           acc_dtype: torch.dtype = F32) -> torch.Tensor:
    """Per K block: the codes' product summed in f32 (the codes are exact
    in f32, as they are in the reference's bf16), times the two scales,
    added to an f32 running sum.  The reference's einsum keeps all
    [M, N, K/bs] block sums at once; the loop is the same arithmetic
    without that array.  ``acc_dtype=torch.float64`` gives the oracle the
    kernel is held against."""
    M, K = x_codes.shape
    N = w_codes.shape[0]
    kb = K // block_size
    xg = x_codes.to(acc_dtype).reshape(M, kb, block_size)
    wg = w_codes.to(acc_dtype).reshape(N, kb, block_size)
    ws = torch.repeat_interleave(w_scale_inv.to(acc_dtype), block_size,
                                 dim=0)[:N]                      # [N, kb]
    xs = x_scales.to(acc_dtype)
    y = torch.zeros((M, N), dtype=acc_dtype, device=x_codes.device)
    for k in range(kb):
        part = torch.matmul(xg[:, k], wg[:, k].T)
        y += part * xs[:, k, None] * ws[None, :, k]
    return y.to(out_dtype)


def kernel_takes_block(K: int, block_size: int) -> bool:
    """Whether the kernel takes a scale block of ``block_size`` columns at
    this K: a multiple of 64 that divides K, or the whole K (any K: the
    columns past K are zero in both operands).  Every block that Mosaic
    lowers for the reference (a multiple of 128, or K) is one."""
    return K % block_size == 0 and (block_size % UNIT == 0
                                    or block_size == K)


def _check_fp8_meta(M: int, N: int, K: int, block_size: int) -> int:
    """Raise on a shape the kernel does not take; returns K / block."""
    if M < 1 or N < 1 or K < 1 or K % block_size:
        raise ValueError(f'the FP8 kernel needs M, N >= 1 and K a multiple '
                         f'of the block size (M={M}, N={N}, K={K}, block '
                         f'{block_size})')
    if not kernel_takes_block(K, block_size):
        raise NotImplementedError(
            f'the FP8 kernel takes scale blocks of a multiple of {UNIT} '
            f'columns or the whole K; block size {block_size} at K={K} runs '
            f'the XLA-branch counterpart (ROADMAP B6)')
    return K // block_size


def _check_weight_rows(w_codes: torch.Tensor) -> int:
    """The weight codes' row stride in bytes: rows of unit column stride,
    each at least K apart.  Where the stride and the address are multiples
    of 16 (a contiguous [N, K] tensor with 16 | K, or the view
    ``weight_cast_to_fp8`` returns for any other K, its rows padded with
    zero codes) the kernel reads the weight by TMA; else (a checkpoint's
    codes at such a K, or a padded cast moved by ``.to``) by its own
    loads, slower."""
    ld = w_codes.stride(0)
    if w_codes.stride(1) != 1 or ld < w_codes.shape[1]:
        raise ValueError(f'w_codes: want rows of unit column stride; got '
                         f'strides {w_codes.stride()} at '
                         f'K={w_codes.shape[1]}')
    return ld


def fp8_block_matmul_cuda(x_codes, x_scales, w_codes, w_scale_inv,
                          block_size: int = 128,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Launch the Hopper kernel: x_codes [M, K] e4m3, x_scales [M, K/bs]
    f32, w_codes [N, K] e4m3, w_scale_inv [ceil(N/bs), K/bs] f32, all as
    stored, bs = ``block_size`` -> [M, N] ``out_dtype`` (bf16 or f32).
    Checks what the kernel takes and raises on anything else."""
    if not x_codes.is_cuda:
        raise ValueError('fp8_block_matmul_cuda launches a CUDA kernel; '
                         'x_codes is on the CPU')
    M, K = x_codes.shape
    N = w_codes.shape[0]
    kb = _check_fp8_meta(M, N, K, block_size)
    if w_codes.dtype != E4M3 or tuple(w_codes.shape) != (N, K) \
            or w_codes.device != x_codes.device:
        raise ValueError(f'w_codes: want {E4M3} ({N}, {K}) on '
                         f'{x_codes.device}, got {w_codes.dtype} '
                         f'{tuple(w_codes.shape)} on {w_codes.device}')
    ldw = _check_weight_rows(w_codes)
    # x_codes' rows are converted, not read by TMA: any K
    _check_operands(x_codes, {'x_codes': (x_codes, E4M3, (M, K)),
                              'x_scales': (x_scales, F32, (M, kb)),
                              'w_scale_inv': (w_scale_inv, F32,
                                              (-(-N // block_size), kb))},
                    out_dtype)
    tt, splits = wgmma_tiling(M, N, kb, sm_count(x_codes.device.index))
    out, partial = _out_and_partial(M, N, splits, out_dtype, x_codes.device)
    # x's codes as f16, which the kernel's tensor cores multiply in, in
    # rows of 16-byte multiples
    ldx = -(-K // 8) * 8
    x16 = torch.empty((M, ldx), dtype=torch.float16, device=x_codes.device)
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    err = _build.lib().llmc_fp8_block_gemm(
        x_codes.data_ptr(), x_scales.data_ptr(), w_codes.data_ptr(),
        w_scale_inv.data_ptr(), x16.data_ptr(), out.data_ptr(),
        partial.data_ptr(), M, N, K, block_size, ldw, ldx,
        int(out_dtype == F32), tt, splits, stream)
    _build.check(err, 'fp8_block_gemm')
    LAUNCHES['fp8_block_gemm'] += 1
    return out
