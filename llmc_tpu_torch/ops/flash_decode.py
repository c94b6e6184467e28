"""Flash-decode attention over the KV cache (port of
``llmc_tpu/ops/flash_decode.py``).

``flash_decode_attention`` keeps the reference's signature.  A CUDA tensor
launches ``csrc/flash_decode.cu`` (the Hopper port of the TPU kernel
``_kernel``); a CPU tensor takes the plain version, the chunked
online-softmax read of ``serve/decode.py::online_softmax_step`` /
``_decode_attn_chunked`` (decode.py:107-207): the K scale multiplies the
scores after the dot and the V scale folds into the probabilities.

The kernel cuts each (slot, kv head) into ``split_plan``'s splits of whole
64-position chunks and combines the splits' (m, l, acc) in split order;
``flash_decode_split_plain`` is that arithmetic in plain torch, which the
tests hold against the one-pass plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..utils.device import sm_count
from . import _build

F32 = torch.float32

# Launches of the CUDA kernel (the plain version never counts).
LAUNCHES = {'flash_decode': 0}

KERNEL_CHUNK = 64   # positions a chunk of the kernel (a TMA box's rows)
# CTAs an SM holds with a full ring, int8 and bf16 caches
# (csrc/flash_decode.cu, Ring)
RESIDENT = {True: 4, False: 2}
# per device: one int32 arrival counter a (slot, kv head), zero between
# launches (each launch's last split resets its own)
_ARRIVALS: Dict[torch.device, torch.Tensor] = {}


def split_plan(B: int, kvh: int, smax: int, sms: int,
               quant: bool = True) -> Tuple[int, int]:
    """(splits S, chunks a split) of the kernel's grid (S, KVH, B).  Each
    (slot, kv head) is cut into S splits of whole chunks so that the grid
    holds about twice the CTAs the card keeps resident, and never into
    more splits than chunks; where the slots and kv heads alone fill that,
    S is 1.  Decided from shapes and the SM count only: the host never
    reads ``pos``."""
    nch = -(-smax // KERNEL_CHUNK)
    target = 2 * sms * RESIDENT[quant]
    pairs = B * kvh
    if pairs >= target:
        return 1, nch
    cps = -(-nch // min(nch, -(-target // pairs)))
    return -(-nch // cps), cps


def active_splits(pos: torch.Tensor, splits: int, cps: int) -> torch.Tensor:
    """Splits of each slot that hold a valid position; the kernel's later
    splits exit at once."""
    return torch.clamp(pos.to(torch.int64) // (cps * KERNEL_CHUNK) + 1,
                       max=splits)


def online_softmax_step(qg, k_c, v_c, k_sc, v_sc, idx, pos, carry):
    """One online-softmax step over a KV chunk.  qg [B, KVH, G, hd] f32
    pre-scaled; k_c / v_c [B, C, KVH, hd] values or int codes (with
    per-(token, head) scales k_sc / v_sc [B, C, KVH]); idx [C] absolute
    positions, masked against per-slot ``pos`` [B]."""
    m, l, acc = carry
    s = torch.einsum('bkgd,bskd->bkgs', qg, k_c.to(F32))   # [B,KVH,G,C]
    if k_sc is not None:
        s = s * k_sc.permute(0, 2, 1)[:, :, None, :]
    s = torch.where(idx[None, None, None, :] <= pos[:, None, None, None],
                    s, torch.full_like(s, float('-inf')))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    if v_sc is not None:
        p = p * v_sc.permute(0, 2, 1)[:, :, None, :]
    acc = acc * corr[..., None] + torch.einsum('bkgs,bskd->bkgd', p,
                                               v_c.to(F32))
    return m_new, l, acc


def flash_decode_plain(q, kbuf, vbuf, ks, vs, pos, layer: int,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """The plain version: chunks up to max(pos) // chunk only."""
    B, H, hd = q.shape
    _, _, smax, kvh, _ = kbuf.shape
    g = H // kvh
    chunk = min(chunk or KERNEL_CHUNK, smax)
    qg = q.reshape(B, kvh, g, hd).to(F32)
    m = torch.full((B, kvh, g), float('-inf'), dtype=F32, device=q.device)
    l = torch.zeros((B, kvh, g), dtype=F32, device=q.device)
    acc = torch.zeros((B, kvh, g, hd), dtype=F32, device=q.device)
    n_chunks = int(pos.max()) // chunk + 1
    for ic in range(n_chunks):
        off = ic * chunk
        end = min(off + chunk, smax)
        idx = torch.arange(off, end, device=q.device)
        k_c, v_c = kbuf[layer, :, off:end], vbuf[layer, :, off:end]
        k_sc = ks[layer, :, off:end] if ks is not None else None
        v_sc = vs[layer, :, off:end] if vs is not None else None
        m, l, acc = online_softmax_step(qg, k_c, v_c, k_sc, v_sc, idx, pos,
                                        (m, l, acc))
    ctx = acc / torch.clamp(l[..., None], min=1e-30)
    return ctx.reshape(B, H, hd)


def combine_splits(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The splits' online-softmax states, m / l [S, ...] and acc
    [S, ..., hd], merged in split order into ctx [..., hd], as the
    kernel's last CTA merges them.  A split without a valid position
    (m = -inf) adds nothing."""
    M = m.amax(0)
    L = torch.zeros_like(l[0])
    A = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        e = torch.where(m[s] == float('-inf'), torch.zeros_like(M),
                        torch.exp(m[s] - M))
        L = L + l[s] * e
        A = A + acc[s] * e[..., None]
    return A / torch.clamp(L[..., None], min=1e-30)


def flash_decode_split_plain(q, kbuf, vbuf, ks, vs, pos, layer: int,
                             splits: int, cps: int) -> torch.Tensor:
    """The kernel's split arithmetic in plain torch: split s reads chunks
    s * cps .. (s + 1) * cps - 1 with its own online softmax, and
    ``combine_splits`` merges them.  Equal to ``flash_decode_plain`` up to
    the f32 rounding of the order."""
    B, H, hd = q.shape
    _, _, smax, kvh, _ = kbuf.shape
    if splits * cps * KERNEL_CHUNK < smax:
        raise ValueError(f'{splits} splits of {cps} chunks do not cover '
                         f'{smax} positions')
    g = H // kvh
    qg = q.reshape(B, kvh, g, hd).to(F32)
    states = []
    for s in range(splits):
        m = torch.full((B, kvh, g), float('-inf'), dtype=F32, device=q.device)
        l = torch.zeros((B, kvh, g), dtype=F32, device=q.device)
        acc = torch.zeros((B, kvh, g, hd), dtype=F32, device=q.device)
        for ic in range(s * cps, (s + 1) * cps):
            off = ic * KERNEL_CHUNK
            end = min(off + KERNEL_CHUNK, smax)
            if off >= end:
                break
            idx = torch.arange(off, end, device=q.device)
            m, l, acc = online_softmax_step(
                qg, kbuf[layer, :, off:end], vbuf[layer, :, off:end],
                ks[layer, :, off:end] if ks is not None else None,
                vs[layer, :, off:end] if vs is not None else None, idx, pos,
                (m, l, acc))
        # a chunk with no valid position leaves m at -inf and l at 0 (the
        # step's exp(-inf - -inf) is NaN there: take the empty state back)
        empty = m == float('-inf')
        l = torch.where(empty, torch.zeros_like(l), l)
        acc = torch.where(empty[..., None], torch.zeros_like(acc), acc)
        states.append((m, l, acc))
    m, l, acc = (torch.stack(t) for t in zip(*states))
    return combine_splits(m, l, acc).reshape(B, H, hd)


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    buf = _ARRIVALS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[device] = buf
    return buf


def flash_decode_cuda(q, kbuf, vbuf, ks, vs, pos, layer: int
                      ) -> torch.Tensor:
    """Launch the Hopper kernel.  q [B, H, hd] f32; kbuf/vbuf
    [L, B, Smax, KVH, hd] int8 (with ks/vs [L, B, Smax, KVH] f32) or
    bf16 (ks/vs None); pos [B] int32 on the card; layer an int.  One
    launch, split over the cache as ``split_plan`` says."""
    B, H, hd = q.shape
    L, Bk, smax, kvh, hdk = kbuf.shape
    quant = ks is not None
    if not q.is_cuda:
        raise ValueError('flash_decode_cuda launches a CUDA kernel; q is '
                         'on the CPU')
    if (Bk, hdk) != (B, hd) or H % kvh or H // kvh > 8 or hd > 128 \
            or hd % 16:
        raise ValueError(f'kernel takes hd <= 128 (multiple of 16) and at '
                         f'most 8 query heads per kv head; got q '
                         f'{tuple(q.shape)}, cache {tuple(kbuf.shape)}')
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
    splits, cps = split_plan(B, kvh, smax, sm_count(q.device.index), quant)
    out = torch.empty((B, H, hd), dtype=F32, device=q.device)
    work = (torch.empty((B, kvh, splits, H // kvh, hd + 2), dtype=F32,
                        device=q.device) if splits > 1 else out)
    arrivals = _arrivals(q.device, B * kvh) if splits > 1 else out
    dummy = kbuf  # never read when the cache is bf16
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().llmc_flash_decode(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
        (ks if quant else dummy).data_ptr(),
        (vs if quant else dummy).data_ptr(), pos.data_ptr(),
        out.data_ptr(), work.data_ptr(), arrivals.data_ptr(), B, H, kvh, hd,
        smax, L, int(layer), 0 if quant else 1, splits, cps, stream)
    _build.check(err, 'flash_decode')
    LAUNCHES['flash_decode'] += 1
    return out


def flash_decode_attention(q, kbuf, vbuf, ks, vs, pos, layer,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """q [B, H, hd] f32, PRE-scaled by the attention scale; kbuf / vbuf
    [L, B, Smax, KVH, hd] (int8 codes or fp values); ks / vs
    [L, B, Smax, KVH] f32 per-token-head scales, or None (fp); pos [B]
    int32 — positions idx <= pos[b] are attended; layer an int.  Returns
    ctx [B, H, hd] f32.  CUDA tensors launch the kernel, CPU tensors take
    the plain version.  ``chunk`` is the reference's read size, which does
    not change the function: the plain version reads in it, the kernel in
    its own chunks of ``KERNEL_CHUNK``."""
    if q.is_cuda:
        return flash_decode_cuda(q, kbuf, vbuf, ks, vs, pos.to(torch.int32),
                                 int(layer))
    if q.device.type != 'cpu':
        raise ValueError(f'unsupported device {q.device}')
    return flash_decode_plain(q, kbuf, vbuf, ks, vs, pos, int(layer), chunk)
