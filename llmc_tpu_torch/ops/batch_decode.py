"""Serving-batch decode attention over the KV cache (port of
``llmc_tpu/ops/batch_decode.py``).

The same function as ``ops/flash_decode.py``, shaped for the serving
batch: many slots, one token each.  The slots are taken in blocks of
``b_blk``, and a block reads the cache in chunks up to its last valid one,
``blk_last = max(pos in block) // chunk``.  ``batch_decode_attention``
keeps the reference's signature.  A CUDA tensor launches
``csrc/batch_decode.cu`` (the Hopper port of the TPU kernel ``_kernel``),
which finds ``blk_last`` itself, so no position is read by the host; a CPU
tensor takes the plain version, blocked the same way.

``alias_cache`` existed in the reference to thread the cache buffers
through the kernel as donated aliases, which kept XLA's per-layer cache
updates in place.  Torch updates the cache in place anyway, so here the
pass-through is a no-op: with ``alias_cache=True`` the very tensors that
were given come back beside ``ctx``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.device import sm_count
from . import _build
from .flash_decode import online_softmax_step

F32 = torch.float32

# Launches of the CUDA kernel (the plain version never counts).
LAUNCHES = {'batch_decode': 0}

MAX_WARPS = 16      # the kernel's most warps per CTA (b_blk * wps)
KERNEL_CHUNK = 64   # the default chunk: the grain of a block's early stop


def _pick_blocks(b: int, smax: int, kvh: int, hd: int, itemsize: int,
                 sms: int = 132) -> Tuple[int, int]:
    """(b_blk, chunk) for the card.  The TPU's choice fitted a working set
    into VMEM; here a block is one CTA of one warp per slot (or a few),
    which holds nothing but registers, so the block is the largest
    divisor of ``b`` up to 8 that still leaves two CTAs for every SM —
    a small batch gets blocks of one slot — and the chunk is 64 rows."""
    del hd, itemsize   # the kernel's footprint does not depend on them
    b_blk = next((d for d in (8, 4, 2) if b % d == 0
                  and (b // d) * kvh >= 2 * sms), 1)
    return b_blk, min(KERNEL_CHUNK, smax)


def _warps_per_slot(b: int, kvh: int, b_blk: int, sms: int = 132) -> int:
    """Warps that share one (slot, kv head) when the batch alone would
    leave the card's SMs short of warps."""
    wps = 1
    while (wps < 4 and b * kvh * wps < 16 * sms
           and b_blk * wps * 2 <= MAX_WARPS):
        wps *= 2
    return wps


def batch_decode_plain(q, kbuf, vbuf, ks, vs, pos, layer: int,
                       b_blk: Optional[int] = None,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """The plain version: blocks of ``b_blk`` slots, each read in chunks
    up to its own last valid chunk."""
    B, H, hd = q.shape
    _, _, smax, kvh, _ = kbuf.shape
    g = H // kvh
    if b_blk is None or chunk is None:
        bb, cc = _pick_blocks(B, smax, kvh, hd, kbuf.element_size())
        b_blk, chunk = b_blk or bb, chunk or cc
    if B % b_blk:
        raise ValueError(f'B={B} is not a multiple of b_blk={b_blk}')
    pos = pos.to(torch.int64)
    outs = []
    for b0 in range(0, B, b_blk):
        sl = slice(b0, b0 + b_blk)
        pb = pos[sl]
        qg = q[sl].reshape(b_blk, kvh, g, hd).to(F32)
        m = torch.full((b_blk, kvh, g), float('-inf'), dtype=F32,
                       device=q.device)
        l = torch.zeros((b_blk, kvh, g), dtype=F32, device=q.device)
        acc = torch.zeros((b_blk, kvh, g, hd), dtype=F32, device=q.device)
        blk_last = min(int(pb.max()), smax - 1) // chunk
        for ic in range(blk_last + 1):
            off = ic * chunk
            end = min(off + chunk, smax)
            idx = torch.arange(off, end, device=q.device)
            k_sc = ks[layer, sl, off:end] if ks is not None else None
            v_sc = vs[layer, sl, off:end] if vs is not None else None
            m, l, acc = online_softmax_step(
                qg, kbuf[layer, sl, off:end], vbuf[layer, sl, off:end],
                k_sc, v_sc, idx, pb, (m, l, acc))
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)
                     ).reshape(b_blk, H, hd))
    return torch.cat(outs, dim=0)


def batch_decode_cuda(q, kbuf, vbuf, ks, vs, pos, layer: int,
                      b_blk: Optional[int] = None,
                      chunk: Optional[int] = None,
                      wps: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel.  q [B, H, hd] f32; kbuf/vbuf
    [L, B, Smax, KVH, hd] int8 (with ks/vs [L, B, Smax, KVH] f32) or bf16
    (ks/vs None); pos [B] int32 on the card; layer an int.  ``wps`` warps
    share one slot (default: from the batch and the card's SM count)."""
    B, H, hd = q.shape
    L, Bk, smax, kvh, hdk = kbuf.shape
    quant = ks is not None
    if not q.is_cuda:
        raise ValueError('batch_decode_cuda launches a CUDA kernel; q is '
                         'on the CPU')
    sms = sm_count(q.device.index)
    if b_blk is None or chunk is None:
        bb, cc = _pick_blocks(B, smax, kvh, hd, kbuf.element_size(), sms)
        b_blk, chunk = b_blk or bb, chunk or cc
    if wps is None:
        wps = _warps_per_slot(B, kvh, b_blk, sms)
    if (Bk, hdk) != (B, hd) or H % kvh or hd not in (16, 32, 64, 128):
        raise ValueError(f'kernel takes a head dim of 16, 32, 64 or 128 and '
                         f'H a multiple of KVH; got q {tuple(q.shape)}, '
                         f'cache {tuple(kbuf.shape)}')
    if B % b_blk or b_blk < 1 or wps < 1 or b_blk * wps > MAX_WARPS \
            or chunk < 1:
        raise ValueError(f'kernel takes B a multiple of b_blk, b_blk * wps '
                         f'<= {MAX_WARPS} and chunk >= 1; got B={B}, '
                         f'b_blk={b_blk}, wps={wps}, chunk={chunk}')
    if not 0 <= int(layer) < L:
        raise ValueError(f'layer {layer} out of range [0, {L})')
    want_kv = torch.int8 if quant else torch.bfloat16
    checks = [('q', q, F32, (B, H, hd)), ('pos', pos, torch.int32, (B,)),
              ('kbuf', kbuf, want_kv, tuple(kbuf.shape)),
              ('vbuf', vbuf, want_kv, tuple(kbuf.shape))]
    if quant:
        checks += [('ks', ks, F32, (L, B, smax, kvh)),
                   ('vs', vs, F32, (L, B, smax, kvh))]
    elif vs is not None:
        raise ValueError('ks and vs must both be given or both be None')
    for name, t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f'{name}: want {dt} {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f'{name}: must be contiguous on {q.device}')
        if name in ('q', 'kbuf', 'vbuf') and t.data_ptr() % 16:
            raise ValueError(f'{name}: must be 16-byte aligned')
    out = torch.empty((B, H, hd), dtype=F32, device=q.device)
    dummy = kbuf  # never read when the cache is bf16
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().llmc_batch_decode(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
        (ks if quant else dummy).data_ptr(),
        (vs if quant else dummy).data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, H, kvh, hd, smax, int(layer),
        0 if quant else 1, b_blk, wps, chunk, stream)
    _build.check(err, 'batch_decode')
    LAUNCHES['batch_decode'] += 1
    return out


def batch_decode_attention(q, kbuf, vbuf, ks, vs, pos, layer,
                           b_blk: Optional[int] = None,
                           chunk: Optional[int] = None,
                           alias_cache: bool = False):
    """q [B, H, hd] f32, PRE-scaled by the attention scale; kbuf / vbuf
    [L, B, Smax, KVH, hd] (int8 codes or fp values); ks / vs
    [L, B, Smax, KVH] f32 per-token-head scales, or None (fp); pos [B]
    int32 — positions idx <= pos[b] are attended; layer an int.  Returns
    ctx [B, H, hd] f32 or, with ``alias_cache``,
    (ctx, kbuf, vbuf[, ks, vs]) with the tensors that were given (see the
    module docstring).  CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    if q.is_cuda:
        ctx = batch_decode_cuda(q, kbuf, vbuf, ks, vs, pos.to(torch.int32),
                                int(layer), b_blk, chunk)
    elif q.device.type == 'cpu':
        ctx = batch_decode_plain(q, kbuf, vbuf, ks, vs, pos, int(layer),
                                 b_blk, chunk)
    else:
        raise ValueError(f'unsupported device {q.device}')
    if not alias_cache:
        return ctx
    return (ctx, kbuf, vbuf) + ((ks, vs) if ks is not None else ())
