"""The packers and bf16 conversions of the export path (port of
``llmc_tpu/native``): torch functions that run on the input's device,
bit-equal to the reference's C++ (``llmc_tpu/native/packing.cpp``) and,
for codes in range, to its numpy twins.

The reference packs on the host with many threads.  Here the codes are
already on the card, so they are packed there and only the packed words
cross to the host: 2-8x fewer bytes than the codes.  The codes are read
as uint8 (no wider copy of the matrix), and each 32-bit word is built in
``int32`` from one strided field slice at a time: torch shifts a signed
integer as its unsigned twin, so the bits come out as the reference's
``uint32`` word ``view(np.int32)``.
"""

from __future__ import annotations

import torch

AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# the C++'s order maps by pack factor (8 at 4 bits, 4 at 8 bits)
AWQ_ORDERS = {8: AWQ_ORDER, 4: (0, 2, 1, 3)}
_I32 = torch.int32
_I64 = torch.int64


def _u8(codes: torch.Tensor) -> torch.Tensor:
    """Codes as the C++ reads them (``np.ascontiguousarray(codes,
    np.uint8)``: modulo 256), as uint8."""
    if codes.is_floating_point():
        codes = codes.to(_I32)      # truncates, as numpy's cast does
    return codes.to(torch.uint8)    # integer casts wrap modulo 256


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 of the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(_I32)


def _or_fields(fields: torch.Tensor, bits: int, order=None) -> torch.Tensor:
    """[..., pf] uint8 fields -> int32 words: field ``order[i]`` (``i``
    by default) shifted by ``bits * i``, OR-ed, the word kept to 32 bits
    (a field wider than ``bits`` spills into the next, as in the C++)."""
    pf = fields.shape[-1]
    order = order or range(pf)
    w = fields[..., order[0]].to(_I32,
                                 memory_format=torch.contiguous_format)
    for i in range(1, pf):
        w |= fields[..., order[i]].to(_I32) << (bits * i)
    return w


def pack_int4_colsplit(codes: torch.Tensor, gs: int) -> torch.Tensor:
    """uint8 codes [N, K] -> int8 packed [N, K/2] (group-colsplit: byte c of
    a pair of adjacent gs-column groups holds column c of the first group
    in its low nibble and of the second in its high one; a single-group
    row pairs its two halves)."""
    N, K = codes.shape
    span = K if K == gs else 2 * gs
    u = _u8(codes).reshape(N, K // span, span)
    lo, hi = u[..., :span // 2] & 0xF, u[..., span // 2:] & 0xF
    return (lo | (hi << 4)).view(torch.int8).reshape(N, K // 2)


def unpack_int4_colsplit(packed: torch.Tensor, gs: int) -> torch.Tensor:
    """Inverse of ``pack_int4_colsplit``: int8 [N, K/2] -> uint8 [N, K]."""
    N, half = packed.shape
    K = half * 2
    span = K if K == gs else 2 * gs
    u = _u8(packed).reshape(N, K // span, span // 2)
    return torch.cat([u & 0xF, u >> 4], dim=-1).reshape(N, K).to(
        torch.uint8)


def pack_int32_rows(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned codes [N, K] -> int32 [N, ceil(K/pf)], pf = 32 // bits:
    column k at bit ``bits * (k % pf)`` of word ``k // pf`` (the
    compressed-tensors shift-pack); K is padded with zeros."""
    N, K = codes.shape
    pf = 32 // bits
    u = _u8(codes)
    pad = (-K) % pf
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    return _or_fields(u.reshape(N, -1, pf), bits)


def pack_awq_order(m: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned codes [R, C] -> int32 [R, C/pf]: each word packs pf
    consecutive columns reordered by ``AWQ_ORDERS[pf]`` (the AWQ GEMM
    layout), each code kept to its low ``bits``; 4 and 8 bits only (the
    C++ has no order map for other pack factors)."""
    R, C = m.shape
    pf = 32 // bits
    if pf not in AWQ_ORDERS:
        raise ValueError(f'the AWQ GEMM layout packs 4 or 8 bits, not {bits}')
    g = (_u8(m) & ((1 << bits) - 1)).reshape(R, C // pf, pf)
    return _or_fields(g, bits, AWQ_ORDERS[pf])


def unpack_awq_order(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of ``pack_awq_order``: int32 [R, C/pf] -> codes [R, C]
    (int32), on the words' device (the reference has no unpacker: its
    readers are the engines)."""
    pf = 32 // bits
    order = AWQ_ORDERS[pf]
    w = words.to(_I32)
    out = torch.empty(w.shape[0], w.shape[1] * pf, dtype=_I32,
                      device=w.device)
    for i in range(pf):
        # the sign bits an arithmetic shift brings in are masked off
        out[:, order[i]::pf] = (w >> (bits * i)) & ((1 << bits) - 1)
    return out


def bf16_to_f32(a: torch.Tensor) -> torch.Tensor:
    """bf16 values (a ``torch.bfloat16`` tensor, or their bits in a 16-bit
    integer tensor) -> float32."""
    if a.dtype == torch.bfloat16:
        return a.to(torch.float32)
    bits = (a.to(_I64) & 0xFFFF) << 16
    return _as_int32(bits).view(torch.float32)


def f32_to_bf16_bits(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the bf16 bit pattern, rounded to nearest even as the
    reference rounds (NaN payloads too), as int16 (the two's complement
    of the reference's uint16)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32).to(_I64) \
        & 0xFFFFFFFF
    lsb = (bits >> 16) & 1
    r = ((bits + 0x7FFF + lsb) & 0xFFFFFFFF) >> 16
    return torch.where(r >= 2 ** 15, r - 2 ** 16, r).to(torch.int16)
