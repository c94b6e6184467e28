"""The w4 design probes (port of the Pallas kernels local to
``tools/kernel_bench.py`` and ``tools/w4_probe.py``): nine variants of the
W4A16 dequant-matmul, each one part changed, timed beside the shipping
kernel by ``llmc_tpu_torch.tools.kernel_bench`` and ``.w4_probe``.

One wrapper per TPU probe function, each launching its kernel of
``csrc/probe_gemm.cu`` on a CUDA tensor (or raising), and taking its plain
version on a CPU tensor or with ``force_plain``:

- ``bf16_chunked``: ``x . w^T``, w bf16, a fresh f32 partial per
  128-column chunk (``tools/kernel_bench.py:113``, and
  ``tools/w4_probe.py:120``)
- ``bf16_bigdot``: ``x . w^T``, one f32 sum (``tools/w4_probe.py:149``)
- ``i8_cast``: ``x . bf16(codes)^T``, codes int8
  (``tools/kernel_bench.py:151``, and ``tools/w4_probe.py:179``)
- ``i8xi8_int32``: ``xq . codes^T`` in int32, int32 out
  (``tools/w4_probe.py:210``)
- ``w4_blockdecode``: group-pair bytes, ``W = bf16(u * bf16(s[n, g]))``,
  u the stored nibble (``tools/w4_probe.py:257``)
- ``w4_fullq``: the same bytes as group halves, ``W = bf16(u *
  bf16(s_t[g, n]))`` (``tools/kernel_bench.py:236``)
- ``i32_window``: 8 nibbles an int32 word, 128 columns apart in a
  1024-column window; no scale (``tools/kernel_bench.py:191``)
- ``w4_xc``: ``sum_g s_t[g] (xe_g . b_g^T + xc_g . (b_g >> 4)^T)`` over
  64-byte groups (``tools/kernel_bench.py:297``)
- ``i4_native``: ``x . bf16(codes)^T``, 4-bit codes
  (``tools/w4_probe.py:295``)

Every output but ``i8xi8_int32``'s is bf16 from f32 sums.

The probes' numerics are their functions' and are kept as they are:
``w4_blockdecode`` applies no excess-8 correction, ``w4_fullq`` reads
group-pair bytes as group halves, ``i32_window`` applies no scale.  The
TPU tiling arguments of the tools (``tn``, ``span``, the ``_g4`` / ``_g8``
k-step widths) change no function, so each row has one kernel.

Beside them, ``w4_mma_sync``: B1's function on B1's layout in B1's design
before its wgmma redesign (``csrc/dequant_matmul_w4_mma.cu``), which the
tools time as ``w4_current`` so that one run reads the old design beside
the new one.

``i4_native``'s operand: torch has no int4 tensor a kernel can read, so
the 4-bit codes travel in the port's own layout, ``pack_i4_native`` (two's
complement, column 2c in the low nibble of byte c), with its inverse.
"""

from __future__ import annotations

import torch

from ..utils.device import sm_count
from . import _build
from .dequant_matmul import (QMeta, _check_kernel_meta, _check_operands,
                             _out_and_partial, _tiling, dequant_matmul_plain,
                             kernel_tiling, unpack_weight)

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32

# bf16 outputs against their plain versions: every product is exact in f32
# (bf16 values, or a bf16 weight product rounded the same way on both
# sides), so what is left is the f32 summation order and one bf16 rounding
# of each output: max |err| <= TOL_BF16 * max |plain|.  kI8xI8's int32
# output is exact.
TOL_BF16 = 1e-2

# kernel ids of csrc/probe_gemm.cu (enum Kind), in the order of the rows
# of PERF.md's kernel table (7 to 15)
KINDS = {'bf16_chunked': 0, 'bf16_bigdot': 1, 'i8_cast': 2,
         'i8xi8_int32': 3, 'w4_blockdecode': 4, 'w4_fullq': 5,
         'i32_window': 6, 'w4_xc': 7, 'i4_native': 8}

# Launches of the CUDA kernels (the plain versions never count).
LAUNCHES = dict.fromkeys(list(KINDS) + ['w4_mma_sync'], 0)

PROBE_BM = 64      # the kernels' one row tile
CHUNK = 128        # K columns a kernel chunk covers (a group pair: 256)


# --------------------------------------------------------------------------
# The 4-bit layout of ``i4_native``
# --------------------------------------------------------------------------

def pack_i4_native(codes: torch.Tensor) -> torch.Tensor:
    """Integer codes [N, K] in -8..7 -> [N, K/2] uint8: two's complement,
    column 2c in the low nibble of byte c, 2c + 1 in the high one."""
    N, K = codes.shape
    if K % 2:
        raise ValueError(f'K must be even, got {K}')
    c = codes.to(I32)
    if bool(((c < -8) | (c > 7)).any()):
        raise ValueError('4-bit codes must lie in -8..7')
    u = c & 0xF
    return (u[:, 0::2] | (u[:, 1::2] << 4)).to(torch.uint8)


def unpack_i4_native(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_i4_native``: [N, K/2] uint8 -> int8 codes [N, K]."""
    b = packed.to(I32) & 0xFF
    nib = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(b.shape[0], -1)
    return torch.where(nib >= 8, nib - 16, nib).to(torch.int8)


# --------------------------------------------------------------------------
# Plain versions (any device; f32 sums)
# --------------------------------------------------------------------------

def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, k] . w [N, k]^T in f32 from bf16-exact operands."""
    return torch.matmul(x.to(F32), w.to(F32).T)


def _scaled_bf16(u: torch.Tensor, s_cols: torch.Tensor) -> torch.Tensor:
    """bf16(u * bf16(s)) for integer u and f32 scales, one per column of u:
    the product of a nibble and a bf16 is exact in f32, so this is one
    rounding, as the TPU kernels' bf16 multiply."""
    return (u.to(F32) * s_cols.to(BF16).to(F32)).to(BF16)


def bf16_chunked_plain(x, w, chunk: int = CHUNK) -> torch.Tensor:
    acc = torch.zeros((x.shape[0], w.shape[0]), dtype=F32, device=x.device)
    for c in range(0, x.shape[1], chunk):
        acc += _dot(x[:, c:c + chunk], w[:, c:c + chunk])
    return acc.to(BF16)


def bf16_bigdot_plain(x, w) -> torch.Tensor:
    return _dot(x, w).to(BF16)


def i8_cast_plain(x, codes) -> torch.Tensor:
    return _dot(x, codes.to(BF16)).to(BF16)


def i8xi8_int32_plain(xq, codes) -> torch.Tensor:
    """Exact: float64 holds every partial sum of int8 products of any K
    below 2^38, and the card has no integer matmul in torch."""
    return torch.matmul(xq.to(torch.float64),
                        codes.to(torch.float64).T).to(I32)


def w4_blockdecode_weight(packed, s) -> torch.Tensor:
    """The bf16 weight ``w4_blockdecode`` multiplies: group-pair nibbles
    u (0..15, no excess-8 correction) times the bf16 scale s [N, ng]."""
    N, half = packed.shape
    K = 2 * half
    gs = K // s.shape[1]
    u = unpack_weight(packed, QMeta(bits=4, group_size=gs, out_features=N,
                                    in_features=K))
    return _scaled_bf16(u, torch.repeat_interleave(s, gs, dim=1))


def w4_blockdecode_plain(x, packed, s) -> torch.Tensor:
    return _dot(x, w4_blockdecode_weight(packed, s)).to(BF16)


def w4_fullq_weight(packed, s_t) -> torch.Tensor:
    """The bf16 weight ``w4_fullq`` multiplies: within group g (gs = K /
    ng columns) column c < gs/2 is the low nibble of byte g*gs/2 + c and
    column gs/2 + c its high nibble, the group-pair layout of half the
    group size, times the bf16 scale s_t [ng, N]."""
    N, half = packed.shape
    K = 2 * half
    gs = K // s_t.shape[0]
    u = unpack_weight(packed, QMeta(bits=4, group_size=gs // 2,
                                    out_features=N, in_features=K))
    return _scaled_bf16(u, torch.repeat_interleave(s_t.T, gs, dim=1))


def w4_fullq_plain(x, packed, s_t) -> torch.Tensor:
    return _dot(x, w4_fullq_weight(packed, s_t)).to(BF16)


def i32_window_weight(words) -> torch.Tensor:
    """words int32 [N, K/8] -> the nibbles [N, K] as int32: in window t of
    1024 columns, column t*1024 + j*128 + c is nibble j of word
    [n, t*128 + c]."""
    N, k8 = words.shape
    nib = torch.stack([(words >> (4 * j)) & 0xF for j in range(8)], dim=1)
    # [N, 8, t*128 + c] -> [N, t, j, c]
    nib = nib.reshape(N, 8, k8 // 128, 128).permute(0, 2, 1, 3)
    return nib.reshape(N, 8 * k8)


def i32_window_plain(x, words) -> torch.Tensor:
    return _dot(x, i32_window_weight(words)).to(BF16)


def w4_xc_plain(xe, xc, packed, s_t, group: int = 64) -> torch.Tensor:
    b = packed.to(I32) & 0xFF
    hi = b >> 4
    acc = torch.zeros((xe.shape[0], b.shape[0]), dtype=F32, device=xe.device)
    for g in range(b.shape[1] // group):
        c = slice(g * group, (g + 1) * group)
        acc += (_dot(xe[:, c], b[:, c]) + _dot(xc[:, c], hi[:, c])) * \
            s_t[g].to(F32)[None, :]
    return acc.to(BF16)


def i4_native_plain(x, packed) -> torch.Tensor:
    return _dot(x, unpack_i4_native(packed).to(BF16)).to(BF16)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _launch(name, x, w, *, N, K, want, x2=None, s=None, units,
            out_dtype=BF16) -> torch.Tensor:
    """Check what the kernel takes (raise on anything else), launch it."""
    M = x.shape[0]
    if not x.is_cuda:
        raise ValueError(f'{name} launches a CUDA kernel; x is on '
                         f'{x.device}')
    if N % 2 or M < 1:
        raise ValueError(f'{name} needs an even N and M >= 1 '
                         f'(N={N}, M={M})')
    _check_operands(x, want, None)
    _, splits = _tiling(M, N, units, sm_count(x.device.index), bm=PROBE_BM)
    acc_dtype = I32 if out_dtype == I32 else F32
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=acc_dtype, device=x.device)
               if splits > 1 else out)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().llmc_probe_gemm(
        KINDS[name], x.data_ptr(), None if x2 is None else x2.data_ptr(),
        w.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
        partial.data_ptr(), M, N, K, splits, stream)
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def _need(name, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f'{name}: {what}')


def _plain_route(t: torch.Tensor, force_plain: bool) -> bool:
    """The plain version for a CPU tensor or on request; the kernel for a
    CUDA tensor; a raise for any other device."""
    if force_plain or t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'unsupported device {t.device}')
    return False


def _dense(name, x, w, wdtype, plain, force_plain):
    """The three probes of x [M, K] bf16 against a dense [N, K] weight."""
    if _plain_route(x, force_plain):
        return plain(x, w)
    M, K = x.shape
    N = w.shape[0]
    _need(name, K % CHUNK == 0, f'K={K} must be a multiple of {CHUNK}')
    return _launch(name, x, w, N=N, K=K, units=K // CHUNK,
                   want={'x': (x, BF16, (M, K)), 'w': (w, wdtype, (N, K))})


def bf16_chunked(x, w, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, w [N, K] bf16 -> [M, N] bf16, a fresh f32 partial
    per 128-column chunk."""
    return _dense('bf16_chunked', x, w, BF16, bf16_chunked_plain,
                  force_plain)


def bf16_bigdot(x, w, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, w [N, K] bf16 -> [M, N] bf16, one f32 sum."""
    return _dense('bf16_bigdot', x, w, BF16, bf16_bigdot_plain, force_plain)


def i8_cast(x, codes, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, codes [N, K] int8 -> x . bf16(codes)^T, bf16."""
    return _dense('i8_cast', x, codes, torch.int8, i8_cast_plain,
                  force_plain)


def i8xi8_int32(xq, codes, force_plain: bool = False) -> torch.Tensor:
    """xq [M, K] int8, codes [N, K] int8 -> [M, N] int32, exact."""
    if _plain_route(xq, force_plain):
        return i8xi8_int32_plain(xq, codes)
    M, K = xq.shape
    N = codes.shape[0]
    _need('i8xi8_int32', K % CHUNK == 0,
          f'K={K} must be a multiple of {CHUNK}')
    return _launch('i8xi8_int32', xq, codes, N=N, K=K, units=K // CHUNK,
                   want={'xq': (xq, torch.int8, (M, K)),
                         'codes': (codes, torch.int8, (N, K))},
                   out_dtype=I32)


def w4_blockdecode(x, packed, s, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, group-pair packed [N, K/2] uint8 (``pack_weight``),
    s [N, K/128] f32 -> [M, N] bf16 with W = bf16(u * bf16(s)), u the
    stored nibble."""
    if _plain_route(x, force_plain):
        return w4_blockdecode_plain(x, packed, s)
    M, K = x.shape
    N = packed.shape[0]
    _need('w4_blockdecode', K % (2 * CHUNK) == 0,
          f'K={K} must be a multiple of {2 * CHUNK} (group pairs of 128)')
    return _launch('w4_blockdecode', x, packed, s=s, N=N, K=K,
                   units=K // (2 * CHUNK),
                   want={'x': (x, BF16, (M, K)),
                         'packed': (packed, torch.uint8, (N, K // 2)),
                         's': (s, F32, (N, K // CHUNK))})


def w4_fullq(x, packed, s_t, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, packed [N, K/2] uint8 read as group halves, s_t
    [K/128, N] f32 -> [M, N] bf16 with W = bf16(u * bf16(s_t))."""
    if _plain_route(x, force_plain):
        return w4_fullq_plain(x, packed, s_t)
    M, K = x.shape
    N = packed.shape[0]
    _need('w4_fullq', K % CHUNK == 0, f'K={K} must be a multiple of {CHUNK}')
    return _launch('w4_fullq', x, packed, s=s_t, N=N, K=K,
                   units=K // CHUNK,
                   want={'x': (x, BF16, (M, K)),
                         'packed': (packed, torch.uint8, (N, K // 2)),
                         's_t': (s_t, F32, (K // CHUNK, N))})


def i32_window(x, words, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, words [N, K/8] int32 (8 nibbles a word over
    1024-column windows) -> [M, N] bf16; no scale."""
    if _plain_route(x, force_plain):
        return i32_window_plain(x, words)
    M, K = x.shape
    N = words.shape[0]
    _need('i32_window', K % 1024 == 0,
          f'K={K} must be a multiple of 1024 (the window)')
    return _launch('i32_window', x, words, N=N, K=K, units=K // CHUNK,
                   want={'x': (x, BF16, (M, K)),
                         'words': (words, I32, (N, K // 8))})


def w4_xc(xe, xc, packed, s_t, force_plain: bool = False) -> torch.Tensor:
    """xe, xc [M, K/2] bf16, packed [N, K/2] uint8, s_t [K/128, N] f32 ->
    sum_g s_t[g] (xe_g . b_g^T + xc_g . (b_g >> 4)^T) over 64-byte groups,
    bf16."""
    if _plain_route(xe, force_plain):
        return w4_xc_plain(xe, xc, packed, s_t)
    M, half = xe.shape
    N = packed.shape[0]
    _need('w4_xc', half % 64 == 0,
          f'K/2={half} must be a multiple of 64 (the byte group)')
    return _launch('w4_xc', xe, packed, x2=xc, s=s_t, N=N, K=2 * half,
                   units=half // 64,
                   want={'xe': (xe, BF16, (M, half)),
                         'xc': (xc, BF16, (M, half)),
                         'packed': (packed, torch.uint8, (N, half)),
                         's_t': (s_t, F32, (half // 64, N))})


def i4_native(x, packed, force_plain: bool = False) -> torch.Tensor:
    """x [M, K] bf16, 4-bit codes [N, K/2] uint8 (``pack_i4_native``) ->
    x . bf16(codes)^T, bf16."""
    if _plain_route(x, force_plain):
        return i4_native_plain(x, packed)
    M, K = x.shape
    N = packed.shape[0]
    _need('i4_native', K % CHUNK == 0, f'K={K} must be a multiple of {CHUNK}')
    return _launch('i4_native', x, packed, N=N, K=K, units=K // CHUNK,
                   want={'x': (x, BF16, (M, K)),
                         'packed': (packed, torch.uint8, (N, K // 2))})


def w4_mma_sync(x, packed, s_t, zs_t, meta: QMeta, out_dtype=BF16,
                force_plain: bool = False) -> torch.Tensor:
    """B1's old design: x [M, K] bf16, packed [N, K/2] uint8, s_t / zs_t
    [ng, N] f32 (pre_t) -> [M, N] ``out_dtype`` (bf16 or f32).  Its plain
    version is B1's (``dequant_matmul_plain``)."""
    if _plain_route(x, force_plain):
        return dequant_matmul_plain(x, packed, s_t, zs_t, meta,
                                    out_dtype=F32).to(out_dtype)
    M, K = x.shape
    N = meta.out_features
    gsl, single = _check_kernel_meta(meta, M, K, span=CHUNK,
                                     item='B1, old design')
    ng = 1 if single else K // gsl
    _check_operands(x, {'x': (x, BF16, (M, K)),
                        'packed': (packed, torch.uint8, (N, K // 2)),
                        's': (s_t, F32, (ng, N)),
                        'zs': (zs_t, F32, (ng, N))}, out_dtype)
    bm, splits = kernel_tiling(M, N, K, gsl, sm_count(x.device.index))
    out, partial = _out_and_partial(M, N, splits, out_dtype, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().llmc_w4_mma_sync(
        x.data_ptr(), packed.data_ptr(), s_t.data_ptr(), zs_t.data_ptr(),
        out.data_ptr(), partial.data_ptr(), M, N, K, gsl, int(single),
        int(out_dtype == F32), bm, splits, stream)
    _build.check(err, 'w4_mma_sync')
    LAUNCHES['w4_mma_sync'] += 1
    return out


# name -> (wrapper, plain version)
PROBES = {'bf16_chunked': (bf16_chunked, bf16_chunked_plain),
          'bf16_bigdot': (bf16_bigdot, bf16_bigdot_plain),
          'i8_cast': (i8_cast, i8_cast_plain),
          'i8xi8_int32': (i8xi8_int32, i8xi8_int32_plain),
          'w4_blockdecode': (w4_blockdecode, w4_blockdecode_plain),
          'w4_fullq': (w4_fullq, w4_fullq_plain),
          'i32_window': (i32_window, i32_window_plain),
          'w4_xc': (w4_xc, w4_xc_plain),
          'i4_native': (i4_native, i4_native_plain)}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, that over max |want|), in float64."""
    err = (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()
    return err, err / max(want.to(torch.float64).abs().max().item(), 1e-30)


def within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """The kernel's output against its plain version: int32 equal, bf16
    within ``TOL_BF16`` of the largest output."""
    if want.dtype == I32:
        return bool(torch.equal(got, want))
    return bool(torch.isfinite(got).all()) and \
        rel_err(got, want)[1] <= TOL_BF16
