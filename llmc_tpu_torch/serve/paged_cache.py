"""Paged KV cache for the serving engine (port of
``llmc_tpu/serve/paged_cache.py``).

K/V live in a shared page pool and each slot owns a list of pages:

    pool_k / pool_v : [L, n_pages, page_size, KVH, hd]
    table           : [B, max_pages] int32 (pool page of each slot page;
                      -1 = unallocated)
    pos             : [B] int32 per-slot positions

The last page is never allocated: it takes the writes of slots whose
table entry is -1 (a retired slot still flows through the batched decode
step).  The host-side ``PageAllocator`` rewrites rows of ``table`` in
place between steps.

The reference has no Pallas kernel here: its paged read is an XLA
online-softmax loop over the slot's pages, and the port's is the same loop
in torch ops on both devices (``ops/flash_decode.py::online_softmax_step``,
the reference's ``decode.py:107``).  The reference reads the loop's trip
count, ``ceil((max(pos) + 1) / page_size)``, on the device; here the
engine hands it over from its host mirror of the positions as
``cache['read_pages']`` (a Python int), so a decode step makes no host
read of ``pos``; without it (a direct call on the CPU) the read takes it
from ``pos``, as ``flash_decode_plain`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from ..ops.flash_decode import online_softmax_step
from ..utils.device import resolve_device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PagedKVPolicy:
    """Paged KV cache (duck-types ``KVCachePolicy``).

    bit=0: a pool in the model's dtype.  bit=2..8: symmetric per-(token,
    head) codes in int8 storage, in -qmax-1..qmax, with f32 scales (the
    dense ``naive`` policy's widths); the read multiplies the K scale into
    the scores and the V scale into the probabilities."""

    method: str = 'paged'
    page_size: int = 16
    n_pages: int = 256
    max_pages: int = 64          # per-slot page-table length
    bit: int = 0                 # 0 = fp, 2..8 = symmetric codes

    def __post_init__(self):
        if self.bit != 0 and not 2 <= self.bit <= 8:
            raise ValueError(f'the paged pool holds fp values (bit=0) or '
                             f'2- to 8-bit codes; got bit={self.bit}')

    def init_cache(self, batch: int, max_len: int, kv_heads: int,
                   head_dim: int, n_blocks: int, dtype=torch.bfloat16,
                   device=None) -> Dict:
        if max_len > self.max_pages * self.page_size:
            raise ValueError(f'max_len {max_len} exceeds {self.max_pages} '
                             f'pages of {self.page_size}')
        dev = resolve_device(device)
        pshape = (n_blocks, self.n_pages, self.page_size, kv_heads,
                  head_dim)
        cache = {
            'table': torch.full((batch, self.max_pages), -1,
                                dtype=torch.int32, device=dev),
            'pos': torch.zeros((batch,), dtype=torch.int32, device=dev),
        }
        if self.bit:
            cache['pool_k'] = torch.zeros(pshape, dtype=torch.int8,
                                          device=dev)
            cache['pool_v'] = torch.zeros(pshape, dtype=torch.int8,
                                          device=dev)
            cache['pool_k_s'] = torch.zeros(pshape[:-1], dtype=F32,
                                            device=dev)
            cache['pool_v_s'] = torch.zeros(pshape[:-1], dtype=F32,
                                            device=dev)
        else:
            cache['pool_k'] = torch.zeros(pshape, dtype=dtype, device=dev)
            cache['pool_v'] = torch.zeros(pshape, dtype=dtype, device=dev)
        return cache

    def _quant(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Symmetric per-(token, head) codes over head_dim; the scale is the
        jitted reference's multiply by the f32 reciprocal of qmax (as
        ``KVCachePolicy._quant``)."""
        qmax = 2 ** (self.bit - 1) - 1
        tf = t.to(F32)
        amax = torch.clamp(tf.abs().amax(-1, keepdim=True), min=1e-5)
        s = amax * (1.0 / qmax)
        q = torch.clamp(torch.round(tf / s), -qmax - 1, qmax).to(torch.int8)
        return q, s[..., 0]

    def update(self, cache: Dict, layer: int, k_new: torch.Tensor,
               v_new: torch.Tensor) -> Dict:
        """Write S new tokens of each slot at its ``cache['pos']``, in
        place; a table entry of -1 sends the write to the scratch page
        (the last one, never allocated)."""
        B, S = k_new.shape[0], k_new.shape[1]
        ps = self.page_size
        dev = k_new.device
        pos = cache['pos']
        pos = (pos.to(torch.long) if isinstance(pos, torch.Tensor)
               else torch.tensor(int(pos), device=dev)).expand(B)
        p = pos[:, None] + torch.arange(S, device=dev)[None, :]    # [B, S]
        page = torch.gather(cache['table'], 1, p // ps).to(torch.long)
        page = torch.where(page < 0, torch.full_like(page, self.n_pages - 1),
                           page)
        off = p % ps
        if self.bit:
            kq, ks = self._quant(k_new)
            vq, vs = self._quant(v_new)
            writes = (('pool_k', kq), ('pool_v', vq), ('pool_k_s', ks),
                      ('pool_v_s', vs))
        else:
            writes = (('pool_k', k_new), ('pool_v', v_new))
        for name, new in writes:
            buf = cache[name][layer]
            buf.index_put_((page, off), new.to(buf.dtype))
        return cache


def decode_attn_paged(q: torch.Tensor, cache: Dict, layer: int,
                      policy: PagedKVPolicy, cfg) -> torch.Tensor:
    """q [B, 1, H, hd] f32 PRE-scaled -> ctx [B, 1, H, hd] f32: the online
    softmax over the slot's pages, ``cache['read_pages']`` of them (all
    slots alike) or, without it, ``ceil((max(pos) + 1) / page_size)``."""
    B, _, H, hd = q.shape
    kvh = cfg.num_key_value_heads
    ps = policy.page_size
    pos = cache['pos']
    pos = (pos if isinstance(pos, torch.Tensor)
           else torch.tensor(int(pos), device=q.device)).expand(B)
    n_read = cache.get('read_pages')
    if n_read is None:
        n_read = (int(pos.max()) + ps) // ps
    qg = q[:, 0].reshape(B, kvh, H // kvh, hd).to(F32)
    table = cache['table']
    quant = bool(policy.bit)
    m = torch.full((B, kvh, H // kvh), float('-inf'), dtype=F32,
                   device=q.device)
    l = torch.zeros((B, kvh, H // kvh), dtype=F32, device=q.device)
    acc = torch.zeros((B, kvh, H // kvh, hd), dtype=F32, device=q.device)
    lane = torch.arange(ps, device=q.device)
    for c in range(min(int(n_read), table.shape[1])):
        page = torch.clamp(table[:, c], 0, policy.n_pages - 1).to(torch.long)
        k_c = cache['pool_k'][layer][page]             # [B, ps, KVH, hd]
        v_c = cache['pool_v'][layer][page]
        k_sc = cache['pool_k_s'][layer][page] if quant else None
        v_sc = cache['pool_v_s'][layer][page] if quant else None
        m, l, acc = online_softmax_step(qg, k_c, v_c, k_sc, v_sc,
                                        c * ps + lane, pos, (m, l, acc))
    ctx = acc / torch.clamp(l[..., None], min=1e-30)
    return ctx.reshape(B, 1, H, hd)


class PageAllocator:
    """Host-side free list over the pool: pages are taken at admission
    (``ceil(n_tokens / page_size)``) and given back at retirement; each
    rewrites the slot's row of the device ``table`` in place."""

    def __init__(self, policy: PagedKVPolicy):
        self.policy = policy
        # the last page is the scratch target of retired slots' writes
        self.free: List[int] = list(range(policy.n_pages - 2, -1, -1))
        self.owned: Dict[int, List[int]] = {}

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.policy.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return len(self.free) >= self.pages_needed(n_tokens)

    def allocate(self, slot: int, n_tokens: int, table: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[int]]:
        n = self.pages_needed(n_tokens)
        if len(self.free) < n:
            raise RuntimeError(f'page pool exhausted: {n} pages wanted, '
                               f'{len(self.free)} free')
        if n > self.policy.max_pages:
            # checked before any page leaves the free list
            raise ValueError(f'{n_tokens} tokens need {n} pages, more than '
                             f'the {self.policy.max_pages} of a table row')
        pages = [self.free.pop() for _ in range(n)]
        self.owned[slot] = pages
        row = torch.full((self.policy.max_pages,), -1, dtype=torch.int32)
        row[:n] = torch.tensor(pages, dtype=torch.int32)
        table[slot] = row.to(table.device)
        return table, pages

    def release(self, slot: int, table: torch.Tensor) -> torch.Tensor:
        self.free.extend(self.owned.pop(slot, []))
        table[slot] = -1
        return table
