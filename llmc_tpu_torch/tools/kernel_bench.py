"""Isolate the W4A16 kernel's cost components on the card (port of
``tools/kernel_bench.py``).

    python -m llmc_tpu_torch.tools.kernel_bench

One linear at the gate_up shape: M=64, K=4096, N=22016, group size 128,
operands from ``np.random.RandomState(0)`` as the JAX tool draws them.
Variants, each the skeleton of B1's mma.sync design (``csrc/probe_gemm.cu``)
with one part changed:

  w4_current   B1 in that design (``csrc/dequant_matmul_w4_mma.cu``; B1
               itself now runs on wgmma, ``csrc/dequant_matmul_w4.cu``)
  bf16_pallas  weights already bf16 (``bf16_chunked``): against
               w4_current the nibble decode, the zero term and the scale
               epilogue (at M=4096; at M <= 128 the bf16 weight's 4x bytes
               bound it instead); against bf16_xla the skeleton itself
  bf16_xla     ``torch.matmul`` on the bf16 weight
  i8_cast      int8 weights cast to bf16 in the kernel: the sub-word
               widen alone, and against the W8 kernel (B4) the cost of
               its per-group dequantization
  i32_window   eight nibbles a 32-bit word, 128 columns apart: one load
               feeds eight k steps (no scale; a speed probe)
  w4_fullq     the packed bytes read as group halves, each scale folded
               into the bf16 weight, one f32 sum
  w4_xc        byte-dot: x . w = xe . b + xc . (b >> 4) with the byte b
               exact in bf16, the scale on each group's f32 partial (xe,
               xc: the halves of x stand in for the even / combined
               activations, as in the JAX tool)

The JAX tool timed w4_fullq and w4_xc at two k-step widths (``_g4``,
``_g8``), a TPU tiling argument that changes no function: this tool prints
one line for each.  Every line holds ``ms`` (CUDA events, the weight
rotated past the L2), ``bound_ms`` / ``bound_by`` (data-sheet peaks),
``plain_ms`` and the error against the plain version, and ``library_ms``
where one PyTorch call computes the same function.  The last line is the
JAX tool's: variant -> ms, and the ``*_gbs`` weight rates.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import probe_gemm as P
from ..utils.device import peaks_for, resolve_device
from . import _measure as U

M_DEFAULT, K_DEFAULT, N_DEFAULT = 64, 4096, 22016
VARIANTS = ('w4_current', 'bf16_pallas', 'bf16_xla', 'i8_cast',
            'i32_window', 'w4_fullq', 'w4_xc')


def run(device=None, M: Union[int, Sequence[int]] = M_DEFAULT,
        K: int = K_DEFAULT, N: int = N_DEFAULT, seed: int = 0) -> list:
    """The records of every variant at each M (an int or a sequence).
    ``device`` None is the card (or a raise without one); on the CPU the
    plain versions run and nothing is timed."""
    dev = resolve_device(device)
    Ms = (M,) if isinstance(M, int) else tuple(M)
    peaks = peaks_for(torch.cuda.get_device_name(dev)
                      if dev.type == 'cuda' else '')[1]
    rng = np.random.RandomState(seed)
    xs = {m: U.as_tensor(rng.randn(m, K), U.BF16, dev) for m in Ms}
    codes = U.as_tensor(rng.randint(-8, 8, size=(N, K)), torch.int8, dev)
    scales = U.as_tensor(rng.rand(N, K // U.GS) * 0.01 + 0.005, U.F32, dev)
    packed, _, s_t, zs_t, meta_t = U.w4_operands(codes, scales)
    wb = U.as_tensor(rng.randn(N, K), U.BF16, dev)
    w32 = U.as_tensor(rng.randint(0, 2 ** 31, size=(N, K // 8)), torch.int32,
                      dev)
    w_i8 = codes.to(U.BF16)
    w_fullq = P.w4_fullq_weight(packed, s_t)
    ng = K // U.GS
    recs = []
    for m, x in xs.items():
        xe, xc = x[:, :K // 2].contiguous(), x[:, K // 2:].contiguous()
        ops = 2 * m * N * K
        io = 2 * m * K + 2 * m * N          # x in, bf16 out

        def lib(w, x=x):
            return lambda: (lambda: torch.matmul(x, w.T))
        variants = {
            'w4_current': dict(U.w4_current(x, packed, s_t, zs_t, meta_t),
                               nbytes=io + N * K // 2 + 8 * ng * N),
            'bf16_pallas': dict(
                kernel='bf16_chunked', weights=(wb,),
                call=lambda w, x=x: P.bf16_chunked(x, w),
                plain=lambda x=x: P.bf16_chunked_plain(x, wb),
                library=lib(wb), nbytes=io + 2 * N * K),
            'bf16_xla': dict(call=lambda w, x=x: torch.matmul(x, w.T),
                             weights=(wb,), nbytes=io + 2 * N * K),
            'i8_cast': dict(
                kernel='i8_cast', weights=(codes,),
                call=lambda w, x=x: P.i8_cast(x, w),
                plain=lambda x=x: P.i8_cast_plain(x, codes),
                library=lib(w_i8), nbytes=io + N * K),
            'i32_window': dict(
                kernel='i32_window', weights=(w32,),
                call=lambda w, x=x: P.i32_window(x, w),
                plain=lambda x=x: P.i32_window_plain(x, w32),
                nbytes=io + N * K // 2),
            'w4_fullq': dict(
                kernel='w4_fullq', weights=(packed, s_t),
                call=lambda p, s, x=x: P.w4_fullq(x, p, s),
                plain=lambda x=x: P.w4_fullq_plain(x, packed, s_t),
                library=lib(w_fullq), nbytes=io + N * K // 2 + 4 * ng * N),
            'w4_xc': dict(
                kernel='w4_xc', weights=(packed, s_t),
                call=lambda p, s, xe=xe, xc=xc: P.w4_xc(xe, xc, p, s),
                plain=lambda xe=xe, xc=xc: P.w4_xc_plain(xe, xc, packed,
                                                         s_t),
                nbytes=io + N * K // 2 + 4 * ng * N),
        }
        for name in VARIANTS:
            recs.append(U.measure(name, m, dev, peaks, ops=ops,
                                  **variants[name]))
    U.check(recs)
    return recs


def summary(records, N: int = N_DEFAULT, K: int = K_DEFAULT) -> list:
    """The JAX tool's line for each M: variant -> ms and the weight
    rates in GB/s (None where nothing was timed)."""
    out = []
    for m in dict.fromkeys(r['M'] for r in records):
        ms = {r['name']: r['ms'] for r in records if r['M'] == m}

        def gbs(nbytes, t):
            return None if t is None else nbytes / (t / 1e3) / 1e9
        bytes_w4 = N * K / 2
        out.append(dict(M=m, **ms, xc_gbs=gbs(bytes_w4, ms['w4_xc']),
                        w4_gbs=gbs(bytes_w4, ms['w4_current']),
                        i32_gbs=gbs(bytes_w4, ms['i32_window']),
                        fullq_gbs=gbs(bytes_w4, ms['w4_fullq']),
                        bf16_gbs=gbs(N * K * 2, ms['bf16_xla'])))
    return out


def main() -> None:
    recs = run()
    U.print_records(recs, summary(recs))


if __name__ == '__main__':
    main()
