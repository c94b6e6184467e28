"""Serving-batch decode attention over the KV cache (port of
``llmc_tpu/ops/batch_decode.py``).

The same function as ``ops/flash_decode.py``, shaped for the serving
batch: many slots, one token each.  The slots are taken in blocks of
``b_blk``, and a block reads the cache in chunks up to its last valid one,
``blk_last = max(pos in block) // chunk``.  ``batch_decode_attention``
keeps the reference's signature.  A CUDA tensor launches
``csrc/batch_decode.cu`` (the Hopper port of the TPU kernel ``_kernel``):
a warp a slot (a CTA a block of slots), each with its own TMA ring, up to
the slot's own last chunk, reads K and V once for every query head of a
kv head, and at a small batch splits each slot's cache over warps
(``batch_plan``, from shapes and the kernel's occupancy on the card: the
host never reads a position).  A CPU tensor takes the plain version,
blocked the same way; ``batch_decode_split_plain`` is the kernel's split
arithmetic in plain torch.

``alias_cache`` existed in the reference to thread the cache buffers
through the kernel as donated aliases, which kept XLA's per-layer cache
updates in place.  Torch updates the cache in place anyway, so here the
pass-through is a no-op: with ``alias_cache=True`` the very tensors that
were given come back beside ``ctx``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.device import sm_count
from . import _build
from .flash_decode import (KERNEL_CHUNK, KIND_ID, KINDS,
                           check_cache_operands, combine_splits,
                           decode_scratch, kernel_hd, online_softmax_step)

F32 = torch.float32

# Launches of the CUDA kernel (the plain version never counts).
LAUNCHES = {'batch_decode': 0}

HEAD_GROUP = 8      # query heads a tensor-core warp: more, a grid dim
BLOCKS = (8, 4, 2)  # the slots a CTA the card's pick tries, largest first
WARP_CHUNK = 16     # positions a warp's TMA box
RING_STAGES = 2     # stages of a warp's ring
SMEM = 227 * 1024   # shared memory a CTA may take
SM_SMEM = 228 * 1024  # and an SM holds
# a cache's kind by its dtype (int8 codes come with scales)
_DTYPE_KIND = {dt: kind for (dt, _), kind in KINDS.items()}
_KIND_ITEMSIZE = {'int8': 1, 'bf16': 2, 'f16': 2, 'f32': 4}


def warp_ring_bytes(hd: int, itemsize: int) -> int:
    """Shared memory of one warp's ring (csrc/batch_decode.cu): rows of the
    laid-out head dim, ``kernel_hd(hd)``."""
    return RING_STAGES * 2 * WARP_CHUNK * kernel_hd(hd) * itemsize


def _cta_smem(b_blk: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory of a CTA of ``b_blk`` warps."""
    return 128 + b_blk * (warp_ring_bytes(hd, itemsize) + 8 * RING_STAGES)


def smem_warps(b_blk: int, hd: int, itemsize: int) -> int:
    """Warps in CTAs of ``b_blk`` that an SM's 228 KB of shared memory
    holds (1 KB of it kept back a CTA), by shared memory alone."""
    smem = _cta_smem(b_blk, hd, itemsize)
    return 0 if smem > SMEM else (SM_SMEM // (smem + 1024)) * b_blk


def _pick_blocks(b: int, smax: int, hd: int, itemsize: int,
                 warps: Optional[Callable[[int], int]] = None
                 ) -> Tuple[int, int]:
    """(b_blk, chunk).  The TPU's choice fitted a working set into VMEM.
    Here a block of slots is one CTA of one warp a slot, each with its own
    ring, so the block only packs the warps: of the sizes in ``BLOCKS`` and
    1 that divide ``b``, the one whose CTAs let an SM keep the most warps
    resident, ``warps(b_blk)`` (on the card the kernel's occupancy,
    ``resident_warps``, which registers can cap alike for every size),
    then the most by shared memory alone (``smem_warps``: the smaller CTAs
    where the rings leave room), then the larger.  The chunk is the plain
    version's read size (64 rows; the kernel reads in boxes of
    ``WARP_CHUNK``)."""
    def key(d):
        by_smem = smem_warps(d, hd, itemsize)
        return (warps(d) if warps else by_smem, by_smem, d)
    b_blk = max((d for d in BLOCKS + (1,) if b % d == 0), key=key)
    return b_blk, min(KERNEL_CHUNK, smax)


_RESIDENT: Dict[tuple, int] = {}


def resident_warps(device: torch.device, kind: str, G: int, b_blk: int,
                   hd: int) -> int:
    """Warps of the kernel launched for ``G`` query heads a kv head (one
    head on the CUDA cores, more on the tensor cores: their registers
    differ) that one SM keeps resident in CTAs of ``b_blk``, by
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (registers, shared
    memory and launch bounds together); 0 where the CTA's rings do not fit.
    Asked once a (library, device, kind, kernel, b_blk, hd)."""
    lib = _build.lib()
    key = (id(lib), device.index, kind, min(G, 2), b_blk, hd)
    if key not in _RESIDENT:
        warps = ctypes.c_int(0)
        if _cta_smem(b_blk, hd, _KIND_ITEMSIZE[kind]) <= SMEM:
            with torch.cuda.device(device):
                _build.check(lib.llmc_batch_decode_occupancy(
                    KIND_ID[kind], G, hd, b_blk, ctypes.byref(warps)),
                    'batch_decode occupancy')
        _RESIDENT[key] = warps.value
    return _RESIDENT[key]


def batch_plan(B: int, kvh: int, G: int, smax: int, sms: int,
               warps_per_sm: int) -> Tuple[int, int]:
    """(splits S, chunks a split at most) of the kernel's grid (S x head
    groups, KVH, B / b_blk): its warps, one a (slot, kv head, head group,
    split), up to one wave of the card's resident warps (``warps_per_sm``
    on each of ``sms`` SMs, the occupancy of the kernel launched) where the
    slots, kv heads and head groups alone fall short, and never more (a
    part of a second wave costs a whole one).  Split s takes every S-th
    chunk of ``WARP_CHUNK`` positions from chunk s, so that a short prefix
    still spreads over the splits; never more splits than chunks.  Decided
    from shapes and the card alone: the host never reads ``pos``."""
    nch = -(-smax // WARP_CHUNK)
    items = B * kvh * head_groups(G)
    splits = max(1, min(nch, sms * warps_per_sm // items))
    return splits, -(-nch // splits)


_PLANS: Dict[tuple, Tuple[int, int]] = {}


def kernel_plan(q: torch.Tensor, kbuf: torch.Tensor,
                b_blk: Optional[int] = None) -> Tuple[int, int]:
    """(b_blk, splits) of the kernel's launch for q [B, H, hd] and the
    cache kbuf [L, B, Smax, KVH, hd] on their card: ``_pick_blocks`` by the
    kernel's occupancy unless ``b_blk`` is given, then ``batch_plan``;
    worked out once a (library, device, shapes, cache kind, b_blk), as a
    serving run launches the same shapes at every layer and step."""
    key = (id(_build.lib()), q.device.index, q.shape, kbuf.shape,
           kbuf.dtype, b_blk)
    plan = _PLANS.get(key)
    if plan is None:
        B, H, hd = q.shape
        _, _, smax, kvh, _ = kbuf.shape
        kind = _DTYPE_KIND[kbuf.dtype]

        def warps(d):
            return resident_warps(q.device, kind, H // kvh, d, hd)
        bb = b_blk or _pick_blocks(B, smax, hd, kbuf.element_size(),
                                   warps)[0]
        plan = _PLANS[key] = (bb, batch_plan(
            B, kvh, H // kvh, smax, sm_count(q.device.index), warps(bb))[0])
    return plan


def head_groups(G: int) -> int:
    """Warps a (slot, kv head, split): one for a single head (the CUDA
    cores), else one for each ``HEAD_GROUP`` query heads (the tensor
    cores)."""
    return -(-G // HEAD_GROUP)


def batch_decode_plain(q, kbuf, vbuf, ks, vs, pos, layer: int,
                       b_blk: Optional[int] = None,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """The plain version: blocks of ``b_blk`` slots, each read in chunks
    up to its own last valid chunk."""
    B, H, hd = q.shape
    _, _, smax, kvh, _ = kbuf.shape
    g = H // kvh
    if b_blk is None or chunk is None:
        bb, cc = _pick_blocks(B, smax, hd, kbuf.element_size())
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


def batch_decode_split_plain(q, kbuf, vbuf, ks, vs, pos, layer: int,
                             splits: int) -> torch.Tensor:
    """The kernel's split arithmetic in plain torch: split s of a slot
    reads chunks s, s + S, s + 2S, ... of ``WARP_CHUNK`` positions with its
    own online softmax, and ``combine_splits`` merges the splits in split
    order.  Equal to ``batch_decode_plain`` up to the f32 rounding of the
    order."""
    B, H, hd = q.shape
    _, _, smax, kvh, _ = kbuf.shape
    g = H // kvh
    qg = q.reshape(B, kvh, g, hd).to(F32)
    pos = pos.to(torch.int64)
    states = []
    for s in range(splits):
        m = torch.full((B, kvh, g), float('-inf'), dtype=F32, device=q.device)
        l = torch.zeros((B, kvh, g), dtype=F32, device=q.device)
        acc = torch.zeros((B, kvh, g, hd), dtype=F32, device=q.device)
        for off in range(s * WARP_CHUNK, smax, splits * WARP_CHUNK):
            end = min(off + WARP_CHUNK, smax)
            idx = torch.arange(off, end, device=q.device)
            m, l, acc = online_softmax_step(
                qg, kbuf[layer, :, off:end], vbuf[layer, :, off:end],
                ks[layer, :, off:end] if ks is not None else None,
                vs[layer, :, off:end] if vs is not None else None, idx, pos,
                (m, l, acc))
        # a split with no valid position keeps the empty state (the step's
        # exp(-inf - -inf) is NaN there)
        empty = m == float('-inf')
        l = torch.where(empty, torch.zeros_like(l), l)
        acc = torch.where(empty[..., None], torch.zeros_like(acc), acc)
        states.append((m, l, acc))
    m, l, acc = (torch.stack(t) for t in zip(*states))
    return combine_splits(m, l, acc).reshape(B, H, hd)


def batch_decode_cuda(q, kbuf, vbuf, ks, vs, pos, layer: int,
                      b_blk: Optional[int] = None,
                      chunk: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel.  q [B, H, hd] f32; kbuf/vbuf
    [L, B, Smax, KVH, hd] int8 (with ks/vs [L, B, Smax, KVH] f32), or bf16,
    fp16 or f32 (ks/vs None); pos [B] int32 on the card; layer an int.  A CTA
    takes ``b_blk`` slots (default: ``kernel_plan``'s pick on this card);
    ``chunk`` is the plain version's read size, which does not change the
    function: the kernel reads in its own chunks of ``KERNEL_CHUNK``."""
    if not q.is_cuda:
        raise ValueError('batch_decode_cuda launches a CUDA kernel; q is '
                         'on the CPU')
    kind = check_cache_operands(q, kbuf, vbuf, ks, vs, pos, layer)
    B, H, hd = q.shape
    L, _, smax, kvh, _ = kbuf.shape
    bad = b_blk is not None and not 1 <= b_blk <= BLOCKS[0]
    if not bad:
        b_blk, splits = kernel_plan(q, kbuf, b_blk)
    if (bad or B % b_blk or B // b_blk > 65535
            or _cta_smem(b_blk, hd, kbuf.element_size()) > SMEM
            or (chunk or 1) < 1):
        raise ValueError(f'kernel takes B a multiple of b_blk <= '
                         f'{BLOCKS[0]}, at most 65535 blocks, the block\'s '
                         f'rings in {SMEM} bytes, and chunk >= 1; got B={B}, '
                         f'b_blk={b_blk}, chunk={chunk}, hd={hd}, '
                         f'{kbuf.dtype} cache')
    groups = head_groups(H // kvh)
    out = torch.empty((B, H, hd), dtype=F32, device=q.device)
    work, arrivals = (decode_scratch(q.device, B * H * splits * (hd + 2),
                                     B * kvh * groups)
                      if splits > 1 else (out, out))
    dummy = kbuf  # never read without scales
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().llmc_batch_decode(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
        (ks if ks is not None else dummy).data_ptr(),
        (vs if vs is not None else dummy).data_ptr(), pos.data_ptr(),
        out.data_ptr(), work.data_ptr(), arrivals.data_ptr(), B, H, kvh, hd,
        smax, L, int(layer), KIND_ID[kind], b_blk, splits, stream)
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
