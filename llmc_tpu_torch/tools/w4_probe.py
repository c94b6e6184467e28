"""W4A16 kernel variant probe on the card (port of ``tools/w4_probe.py``).

    python -m llmc_tpu_torch.tools.w4_probe

The hypotheses of the JAX tool, restated for Hopper.  Each probe is the
skeleton of B1's mma.sync design (``csrc/probe_gemm.cu``: 64 x 128 tiles, eight
warps along N, a cp.async ring, ``mma.sync``) with one part changed, so a
pair of lines isolates one part of that design of B1
(``csrc/dequant_matmul_w4_mma.cu``, ``w4_current``):

  H1  the nibble decode, zero term and scale epilogue
      -> w4_current against bf16_pallas_chunked (at M=4096; at M <= 128
         the bf16 weight's 4x bytes bound the bf16 probe instead)
  H2  the skeleton: a fresh f32 partial per 128-column chunk, and the
      tile / warp layout / ring against the library's GEMM
      -> bf16_pallas_chunked against bf16_pallas_bigdot, and
         bf16_pallas_bigdot against bf16_xla (``torch.matmul``)
  H3  rows per tile: the probes' tile holds 64 rows, so at M=64 half of
      what M=128 computes rides on the same weight stream
      -> every variant at M=64 and M=128
  H4  the int8 tensor-core path (no bf16 decode, twice the bf16 rate)
      -> i8xi8_int32dot against i8_cast_bigdot (same int8 weight bytes)
  H5  decode to a scaled bf16 weight, then one f32 sum (no zero-term
      mma, no scale on the partial)
      -> w4_blockdecode_bigdot against w4_current

and the 4-bit two's-complement codes read natively (``i4_native_bigdot``,
the port's own 4-bit layout ``pack_i4_native``) against ``torch.matmul`` on
their bf16 cast (``i4_native_xla``, the cast inside the timed call).

Operands from ``np.random.RandomState(0)`` as the JAX tool draws them:
K=4096, N=22016, group size 128, M in (64, 128).  ``i8xi8_int32dot``
times the int32 kernel on codes ``round(16 x)`` clipped to +-127, made
before it (``quant_x16``); its ``/ 16 -> bf16`` (``from_x16``) also stays
outside, as in the JAX tool.  One JSON line a variant (``ms``,
``bound_ms``, ``bound_by``, ``plain_ms``, the error against the plain
version, ``library_ms`` where one PyTorch call computes the same
function), then the JAX tool's lines: ``m{M}_<variant>`` -> ms.  A kernel
that disagrees with its plain version raises after the records are made.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import probe_gemm as P
from ..ops.dequant_matmul import _int8_dot
from ..utils.device import peaks_for, resolve_device
from . import _measure as U

M_DEFAULT, K_DEFAULT, N_DEFAULT = (64, 128), 4096, 22016
VARIANTS = ('w4_current', 'bf16_xla', 'bf16_pallas_chunked',
            'bf16_pallas_bigdot', 'i8_cast_bigdot', 'i8xi8_int32dot',
            'w4_blockdecode_bigdot', 'i4_native_bigdot', 'i4_native_xla')


def quant_x16(x: torch.Tensor) -> torch.Tensor:
    """The JAX tool's activation codes for the int8 dot:
    ``clip(round(16 x), -127, 127)`` as int8."""
    return torch.clamp(torch.round(x.to(U.F32) * 16.0), -127,
                       127).to(torch.int8)


def from_x16(y: torch.Tensor) -> torch.Tensor:
    """The int32 dot back to bf16: ``bf16(f32(y) / 16)``."""
    return (y.to(U.F32) * (1 / 16.0)).to(U.BF16)


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
    codes = U.as_tensor(rng.randint(-8, 8, size=(N, K)), torch.int8, dev)
    scales = U.as_tensor(rng.rand(N, K // U.GS) * 0.01 + 0.005, U.F32, dev)
    packed, s, s_t, zs_t, meta_t = U.w4_operands(codes, scales)
    wb = U.as_tensor(rng.randn(N, K), U.BF16, dev)
    p_i4 = P.pack_i4_native(codes)
    w_i8 = codes.to(U.BF16)
    w_block = P.w4_blockdecode_weight(packed, s)
    ng = K // U.GS
    recs = []
    for m in Ms:
        x = U.as_tensor(rng.randn(m, K), U.BF16, dev)
        xq = quant_x16(x)
        ops = 2 * m * N * K
        io = 2 * m * K + 2 * m * N          # x in, bf16 out

        def lib(w, x=x):
            return lambda: (lambda: torch.matmul(x, w.T))

        def int_mm(xq=xq):
            # torch._int_mm, rows padded as it needs (_int8_dot)
            return lambda: _int8_dot(xq, codes)
        variants = {
            'w4_current': dict(U.w4_current(x, packed, s_t, zs_t, meta_t),
                               nbytes=io + N * K // 2 + 8 * ng * N),
            'bf16_xla': dict(call=lambda w, x=x: torch.matmul(x, w.T),
                             weights=(wb,), nbytes=io + 2 * N * K),
            'bf16_pallas_chunked': dict(
                kernel='bf16_chunked', weights=(wb,),
                call=lambda w, x=x: P.bf16_chunked(x, w),
                plain=lambda x=x: P.bf16_chunked_plain(x, wb),
                library=lib(wb), nbytes=io + 2 * N * K),
            'bf16_pallas_bigdot': dict(
                kernel='bf16_bigdot', weights=(wb,),
                call=lambda w, x=x: P.bf16_bigdot(x, w),
                plain=lambda x=x: P.bf16_bigdot_plain(x, wb),
                library=lib(wb), nbytes=io + 2 * N * K),
            'i8_cast_bigdot': dict(
                kernel='i8_cast', weights=(codes,),
                call=lambda w, x=x: P.i8_cast(x, w),
                plain=lambda x=x: P.i8_cast_plain(x, codes),
                library=lib(w_i8), nbytes=io + N * K),
            'i8xi8_int32dot': dict(
                kernel='i8xi8_int32', weights=(codes,), peak='int8',
                call=lambda w, xq=xq: P.i8xi8_int32(xq, w),
                plain=lambda xq=xq: P.i8xi8_int32_plain(xq, codes),
                library=int_mm, nbytes=m * K + N * K + 4 * m * N),
            'w4_blockdecode_bigdot': dict(
                kernel='w4_blockdecode', weights=(packed, s),
                call=lambda p, sc, x=x: P.w4_blockdecode(x, p, sc),
                plain=lambda x=x: P.w4_blockdecode_plain(x, packed, s),
                library=lib(w_block), nbytes=io + N * K // 2 + 4 * ng * N),
            'i4_native_bigdot': dict(
                kernel='i4_native', weights=(p_i4,),
                call=lambda p, x=x: P.i4_native(x, p),
                plain=lambda x=x: P.i4_native_plain(x, p_i4),
                library=lib(w_i8), nbytes=io + N * K // 2),
            'i4_native_xla': dict(
                call=lambda w, x=x: torch.matmul(x, w.to(U.BF16).T),
                weights=(codes,), nbytes=io + N * K),
        }
        for name in VARIANTS:
            recs.append(U.measure(f'm{m}_{name}', m, dev, peaks, ops=ops,
                                  **variants[name]))
    U.check(recs)
    return recs


def summary(records) -> list:
    """The JAX tool's lines: ``m{M}_<variant>`` -> ms (None where nothing
    was timed)."""
    return [{r['name']: r['ms']} for r in records]


def main() -> None:
    recs = run()
    U.print_records(recs, summary(recs))


if __name__ == '__main__':
    main()
