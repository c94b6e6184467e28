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

KERNEL_CHUNK = 64   # positions a chunk (a TMA box's rows)
# the cache kinds the kernels take, by (value dtype, scales given): int8
# codes with f32 scales, or bf16 or f32 values; the C functions' kv_kind
KINDS = {(torch.int8, True): 'int8', (torch.bfloat16, False): 'bf16',
         (torch.float32, False): 'f32'}
KIND_ID = {'int8': 0, 'bf16': 1, 'f32': 2}
# CTAs an SM holds with a full ring at hd = 128, by cache kind
# (csrc/flash_decode.cu, Ring)
RESIDENT = {'int8': 4, 'bf16': 2, 'f32': 1}
HEAD_GROUP = 8      # query heads a CTA of this kernel: more, a grid dim
# per device: the split workspace (f32) and one int32 arrival counter a
# (slot, kv head, head group), shared by this kernel and batch_decode.cu.
# They only grow, so their addresses stay put once the largest shape has
# run (a captured CUDA graph keeps them); the counters are zero between
# launches (each launch's last split resets its own).
_SCRATCH: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def cache_kind(kbuf: torch.Tensor, ks) -> str:
    """'int8', 'bf16' or 'f32': the kernels' cache kind, or a raise."""
    kind = KINDS.get((kbuf.dtype, ks is not None))
    if kind is None:
        raise ValueError(f'the decode kernels take an int8 cache with f32 '
                         f'scales, or a bf16 or f32 cache without; got '
                         f'{kbuf.dtype} with scales {ks is not None}')
    return kind


def split_plan(B: int, kvh: int, smax: int, sms: int, kind: str = 'int8',
               groups: int = 1) -> Tuple[int, int]:
    """(splits S, chunks a split) of the kernel's grid (S x head groups,
    KVH, B).  Each (slot, kv head, head group) is cut into S splits of
    whole chunks so that the grid holds about twice the CTAs the card
    keeps resident (``RESIDENT``), and never into more splits than chunks;
    where the slots, kv heads and head groups alone fill that, S is 1.
    Decided from shapes and the SM count only: the host never reads
    ``pos``."""
    nch = -(-smax // KERNEL_CHUNK)
    target = 2 * sms * RESIDENT[kind]
    ctas = B * kvh * groups
    if ctas >= target:
        return 1, nch
    cps = -(-nch // min(nch, -(-target // ctas)))
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


def decode_scratch(device: torch.device, n_work: int, n_arrivals: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(workspace of at least ``n_work`` f32, ``n_arrivals`` zero int32
    counters) on ``device``: one pair per device, grown, never shrunk."""
    bufs = _SCRATCH.setdefault(device, {})
    work, arrivals = bufs.get('work'), bufs.get('arrivals')
    if work is None or work.numel() < n_work:
        work = bufs['work'] = torch.empty(max(n_work, 1 << 16), dtype=F32,
                                          device=device)
    if arrivals is None or arrivals.numel() < n_arrivals:
        arrivals = bufs['arrivals'] = torch.zeros(
            max(n_arrivals, 1024), dtype=torch.int32, device=device)
    return work, arrivals


def check_cache_operands(q, kbuf, vbuf, ks, vs, pos, layer: int) -> str:
    """The decode kernels' operand checks (both take the same); returns
    the cache kind."""
    B, H, hd = q.shape
    L, Bk, smax, kvh, hdk = kbuf.shape
    if (Bk, hdk) != (B, hd) or H % kvh or hd > 128 or hd % 16:
        raise ValueError(f'the kernel takes a head dim of at most 128, a '
                         f'multiple of 16, and H a multiple of KVH; got q '
                         f'{tuple(q.shape)}, cache {tuple(kbuf.shape)}')
    if not 0 <= int(layer) < L:
        raise ValueError(f'layer {layer} out of range [0, {L})')
    if (ks is None) != (vs is None):
        raise ValueError('ks and vs must both be given or both be None')
    kind = cache_kind(kbuf, ks)
    checks = [('q', q, F32, (B, H, hd)), ('pos', pos, torch.int32, (B,)),
              ('kbuf', kbuf, kbuf.dtype, tuple(kbuf.shape)),
              ('vbuf', vbuf, kbuf.dtype, tuple(kbuf.shape))]
    if ks is not None:
        checks += [('ks', ks, F32, (L, B, smax, kvh)),
                   ('vs', vs, F32, (L, B, smax, kvh))]
    for name, t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f'{name}: want {dt} {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f'{name}: must be contiguous on {q.device}')
        if name in ('q', 'kbuf', 'vbuf') and t.data_ptr() % 16:
            raise ValueError(f'{name}: must be 16-byte aligned')
    return kind


def flash_decode_cuda(q, kbuf, vbuf, ks, vs, pos, layer: int
                      ) -> torch.Tensor:
    """Launch the Hopper kernel.  q [B, H, hd] f32; kbuf/vbuf
    [L, B, Smax, KVH, hd] int8 (with ks/vs [L, B, Smax, KVH] f32), or bf16
    or f32 (ks/vs None); pos [B] int32 on the card; layer an int.  One
    launch, split over the cache as ``split_plan`` says."""
    if not q.is_cuda:
        raise ValueError('flash_decode_cuda launches a CUDA kernel; q is '
                         'on the CPU')
    kind = check_cache_operands(q, kbuf, vbuf, ks, vs, pos, layer)
    B, H, hd = q.shape
    L, _, smax, kvh, _ = kbuf.shape
    groups = -(-(H // kvh) // HEAD_GROUP)
    splits, cps = split_plan(B, kvh, smax, sm_count(q.device.index), kind,
                             groups)
    out = torch.empty((B, H, hd), dtype=F32, device=q.device)
    work, arrivals = (decode_scratch(q.device, B * H * splits * (hd + 2),
                                     B * kvh * groups)
                      if splits > 1 else (out, out))
    dummy = kbuf  # never read without scales
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().llmc_flash_decode(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
        (ks if ks is not None else dummy).data_ptr(),
        (vs if vs is not None else dummy).data_ptr(), pos.data_ptr(),
        out.data_ptr(), work.data_ptr(), arrivals.data_ptr(), B, H, kvh, hd,
        smax, L, int(layer), KIND_ID[kind], splits, cps, stream)
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
