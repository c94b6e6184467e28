"""The blockwise-scaled FP8 GEMM (port of ``llmc_tpu/ops/fp8_gemm.py``).

``fp8_block_matmul_cuda`` launches ``csrc/fp8_block_gemm.cu``, the Hopper
port of the TPU kernel ``_kernel_fp8``; ``fp8_block_matmul_plain`` is the
same function in plain torch (the reference's XLA branch,
``quant/fp8_block.py:92-103``), used by the tests and for CPU tensors.
The dispatch between them is ``quant/fp8_block.py::fp8_block_matmul``.
"""

from __future__ import annotations

import torch

from ..utils.device import sm_count
from . import _build
from .dequant_matmul import _check_operands, _out_and_partial, _tiling

F32 = torch.float32
E4M3 = torch.float8_e4m3fn
BLOCK = 128   # the scale block the kernel is written for

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


def fp8_block_matmul_cuda(x_codes, x_scales, w_codes, w_scale_inv,
                          block_size: int = 128,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Launch the Hopper kernel: x_codes [M, K] e4m3, x_scales [M, K/128]
    f32, w_codes [N, K] e4m3, w_scale_inv [N/128, K/128] f32, all as
    stored -> [M, N] ``out_dtype`` (bf16 or f32).  Checks what the kernel
    takes and raises on anything else."""
    if not x_codes.is_cuda:
        raise ValueError('fp8_block_matmul_cuda launches a CUDA kernel; '
                         'x_codes is on the CPU')
    M, K = x_codes.shape
    N = w_codes.shape[0]
    if block_size != BLOCK:
        raise NotImplementedError(
            f'the FP8 kernel is written for scale blocks of {BLOCK}; block '
            f'size {block_size} is not ported (ROADMAP B6)')
    if K % BLOCK or N % BLOCK or M < 1:
        raise ValueError(f'the FP8 kernel needs M >= 1 and N, K in multiples '
                         f'of {BLOCK} (M={M}, N={N}, K={K})')
    kb = K // BLOCK
    _check_operands(x_codes, {'x_codes': (x_codes, E4M3, (M, K)),
                              'x_scales': (x_scales, F32, (M, kb)),
                              'w_codes': (w_codes, E4M3, (N, K)),
                              'w_scale_inv': (w_scale_inv, F32,
                                              (N // BLOCK, kb))}, out_dtype)
    bm, splits = _tiling(M, N, kb, sm_count(x_codes.device.index))
    out, partial = _out_and_partial(M, N, splits, out_dtype, x_codes.device)
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    err = _build.lib().llmc_fp8_block_gemm(
        x_codes.data_ptr(), x_scales.data_ptr(), w_codes.data_ptr(),
        w_scale_inv.data_ptr(), out.data_ptr(), partial.data_ptr(), M, N, K,
        int(out_dtype == F32), bm, splits, stream)
    _build.check(err, 'fp8_block_gemm')
    LAUNCHES['fp8_block_gemm'] += 1
    return out
