"""Per-128-block FP8 weight cast, per-group activation quantizer and the
blockwise-scaled FP8 GEMM's dispatch (port of
``llmc_tpu/quant/fp8_block.py``): the ingestion path of FP8-block
checkpoints (e4m3 codes plus one inverse scale per 128 x 128 block).

The casts and the activation quantizer are torch ops on both devices, as
they are XLA ops in the reference.  Codes are computed with the ported
``float_cast`` and only then stored as ``torch.float8_e4m3fn``, so that
saturation and ties are the reference's and not the cast's.

``fp8_block_matmul`` decides by the tensor's device and, on the card, by
the block size alone (``ops/fp8_gemm.py::kernel_takes_block``): the port's
rule of ``ops/dequant_matmul.py``.  A CUDA tensor launches the Hopper
kernel for every block the reference's Pallas kernel takes, and more; any
other block size runs the plain version, the reference's XLA branch, in
torch ops on the card (counted in ``xla_branch_calls``).  A CPU tensor
takes the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.dequant_matmul import XLA_BRANCH
from ..ops.fp8_gemm import (fp8_block_matmul_cuda, fp8_block_matmul_plain,
                            kernel_takes_block)
from .fp_formats import float_cast

F32 = torch.float32
E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0


def _block_view(w: torch.Tensor, bs: int):
    m, n = w.shape
    mp, np_ = -(-m // bs) * bs, -(-n // bs) * bs
    wp = torch.nn.functional.pad(w, (0, np_ - n, 0, mp - m))
    return wp.reshape(mp // bs, bs, np_ // bs, bs), (m, n)


def weight_cast_to_fp8(w: torch.Tensor, block_size: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16/f32 weight -> (e4m3 codes, scale_inv [ceil(m/bs), ceil(n/bs)])."""
    wb, (m, n) = _block_view(w.to(F32), block_size)
    amax = torch.clamp(torch.amax(torch.abs(wb), dim=(1, 3), keepdim=True),
                       min=1e-12)
    # one division, as in the reference: torch evaluates ``448.0 / amax`` as
    # ``amax.reciprocal() * 448.0``, two roundings
    scale = torch.full_like(amax, E4M3_MAX) / amax
    codes = float_cast(wb * scale, 4, 3, E4M3_MAX)
    codes = codes.reshape(wb.shape[0] * block_size, -1)[:m, :n].to(E4M3)
    if n % 16:
        # rows of 16-byte multiples, as the card's kernel reads them by TMA:
        # the codes are a view of zero-padded rows (ops/fp8_gemm.py)
        rows = torch.zeros((m, -(-n // 16) * 16), dtype=E4M3,
                           device=codes.device)
        rows[:, :n] = codes
        codes = rows[:, :n]
    return codes, (1.0 / scale)[:, 0, :, 0]


def weight_cast_to_bf16(codes: torch.Tensor, scale_inv: torch.Tensor,
                        block_size: int = 128,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(e4m3 codes, scale_inv) -> dense weight."""
    m, n = codes.shape
    cb, _ = _block_view(codes.to(F32), block_size)
    s = scale_inv[:, None, :, None].to(F32)
    w = (cb * s).reshape(cb.shape[0] * block_size, -1)[:m, :n]
    return w.to(dtype)


def act_quant_per_group(x: torch.Tensor, group: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-128-group activation -> (e4m3 codes, f32 scales [..., n/group]).
    The scale is ``amax`` times the f32 reciprocal of 448, as ``jax.jit``
    of the reference computes ``amax / 448.0`` (XLA folds a division by a
    constant into that multiply); ``xg / scale`` stays a true division."""
    lead = x.shape[:-1]
    n = x.shape[-1]
    xg = x.to(F32).reshape(-1, n // group, group)
    amax = torch.clamp(torch.amax(torch.abs(xg), dim=-1, keepdim=True),
                       min=1e-12)
    scale = amax * (1.0 / E4M3_MAX)
    codes = float_cast(xg / scale, 4, 3, E4M3_MAX)
    return (codes.reshape(*lead, n).to(E4M3),
            scale.reshape(*lead, n // group))


def fp8_block_matmul(x_codes, x_scales, w_codes, w_scale_inv,
                     block_size: int = 128,
                     out_dtype: torch.dtype = torch.bfloat16,
                     force_plain: bool = False) -> torch.Tensor:
    """y = (x_codes . x_scales) @ (w_codes . w_scale_inv)^T with exact
    e4m3 products, an f32 sum per K block, both scales applied to the
    block's sum, and an f32 running sum.  x: [M, K] codes + [M, K/bs]
    scales; w: [N, K] codes + [ceil(N/bs), K/bs] scale_inv.

    A CUDA tensor launches the Hopper kernel where it takes the block
    size (any N), else runs the plain version on the card and counts the
    call in ``xla_branch_calls``; a CPU tensor takes the plain version.
    ``force_plain`` (the reference's ``force_xla``) takes the plain version
    on either device."""
    if x_codes.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {x_codes.device}')
    if force_plain or not x_codes.is_cuda:
        return fp8_block_matmul_plain(x_codes, x_scales, w_codes,
                                      w_scale_inv, block_size, out_dtype)
    if not kernel_takes_block(x_codes.shape[1], block_size):
        XLA_BRANCH['xla_branch_calls'] += 1
        return fp8_block_matmul_plain(x_codes, x_scales, w_codes,
                                      w_scale_inv, block_size, out_dtype)
    return fp8_block_matmul_cuda(x_codes, x_scales, w_codes, w_scale_inv,
                                 block_size, out_dtype)
