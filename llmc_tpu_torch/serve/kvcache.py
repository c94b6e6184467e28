"""KV-cache policies (port of ``llmc_tpu/serve/kvcache.py``).

- ``fp``: the values as the model computes them.
- ``naive``: int8 codes with per-(token, head) scales, symmetric or
  asymmetric, at 2 to 8 bits.
- ``kivi``: ``naive`` codes for every token, and beside them an fp ring of
  the most recent ``residual_length`` tokens (``k_r`` / ``v_r``), which
  ``read`` splices over their codes: with per-token qparams that is the
  upstream method's quantize-at-eviction.
- ``sink``: the fp cache; the attention keeps the first
  ``num_sink_tokens`` positions and the last ``window_length`` before each
  query (``attention_mask_offset``), each slot at its own position in the
  serving engine.

``KV_REGISTRY['ShadowKV']`` builds ``serve/shadowkv.py::ShadowKVPolicy``
as the reference does, whose ``shadowkv_decode_nll`` scores a sequence
under retrieval.  The paged pool is a policy of its own,
``serve.paged_cache.PagedKVPolicy``, as in the reference, whose
``KVCachePolicy`` has no paged method.

The cache is a dict of preallocated tensors ``[L, B, Smax, KVH, hd]``
(scales squeezed ``[L, B, Smax, KVH]``) plus ``pos``: a Python int for
lockstep batches, or an int32 ``[B]`` tensor of per-slot positions
(serving engine).  Unlike the reference's immutable arrays, ``update``
writes the new tokens **in place** (slice assignment / ``index_put_``)
and returns the same dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..utils.device import resolve_device
from ..utils.registry import KV_REGISTRY

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class KVCachePolicy:
    """Static description of KV-cache handling."""

    method: str = 'fp'        # fp | naive | kivi | sink
    bit: int = 8
    symmetric: bool = True
    residual_length: int = 128
    num_sink_tokens: int = 4
    window_length: int = 256

    def __post_init__(self):
        if self.method == 'paged':
            raise NotImplementedError(
                'the paged KV pool is serve.paged_cache.PagedKVPolicy, not '
                'a KVCachePolicy method (as in the reference)')
        if self.method not in ('fp', 'naive', 'kivi', 'sink'):
            raise ValueError(f'unknown KV policy {self.method!r}: want fp, '
                             f'naive, kivi or sink')
        if self.method in ('naive', 'kivi') and not 2 <= self.bit <= 8:
            raise ValueError(f'naive KV codes are stored in int8; '
                             f'bit={self.bit} does not fit')

    def init_cache(self, batch: int, max_len: int, kv_heads: int,
                   head_dim: int, n_blocks: int, dtype=torch.bfloat16,
                   device=None) -> Dict:
        dev = resolve_device(device)
        shape = (n_blocks, batch, max_len, kv_heads, head_dim)
        if self.method in ('fp', 'sink'):
            return {'k': torch.zeros(shape, dtype=dtype, device=dev),
                    'v': torch.zeros(shape, dtype=dtype, device=dev),
                    'pos': 0}
        cache = {
            'k_q': torch.zeros(shape, dtype=torch.int8, device=dev),
            'v_q': torch.zeros(shape, dtype=torch.int8, device=dev),
            'k_s': torch.zeros(shape[:-1], dtype=F32, device=dev),
            'v_s': torch.zeros(shape[:-1], dtype=F32, device=dev),
            'pos': 0,
        }
        if not self.symmetric:
            cache['k_z'] = torch.zeros(shape[:-1], dtype=F32, device=dev)
            cache['v_z'] = torch.zeros(shape[:-1], dtype=F32, device=dev)
        if self.method == 'kivi':
            rshape = (n_blocks, batch, self.residual_length, kv_heads,
                      head_dim)
            cache['k_r'] = torch.zeros(rshape, dtype=dtype, device=dev)
            cache['v_r'] = torch.zeros(rshape, dtype=dtype, device=dev)
            # the tokens present after this step's write ('pos' advances
            # once a step, after every layer ran)
            cache['kivi_total'] = 0
        return cache

    # -- quant helpers (per token+head over head_dim) -------------------
    def _quant(self, t: torch.Tensor):
        """Per-(token, head) codes over head_dim.  The reference quantizes
        inside its jitted steps, where XLA folds ``amax / qmax`` into a
        multiply by the f32 reciprocal of qmax: the scale is computed so
        on both devices.  ``tf / s`` and ``mn / s`` stay true divisions."""
        qmax = 2 ** (self.bit - 1) - 1
        qmin = -(2 ** (self.bit - 1))
        tf = t.to(F32)
        if self.symmetric:
            amax = torch.clamp(tf.abs().amax(-1, keepdim=True), min=1e-5)
            s = amax * (1.0 / qmax)
            q = torch.clamp(torch.round(tf / s), qmin, qmax).to(torch.int8)
            return q, s, None
        mn = tf.amin(-1, keepdim=True)
        mx = tf.amax(-1, keepdim=True)
        s = torch.clamp(mx - mn, min=1e-5) * (1.0 / (2 ** self.bit - 1))
        z = torch.clamp(-torch.round(mn / s) + qmin, qmin, qmax)
        q = torch.clamp(torch.round(tf / s) + z, qmin, qmax).to(torch.int8)
        return q, s, z

    def _dequant(self, q, s, z, dtype):
        out = q.to(F32)
        if z is not None:
            out = out - z
        return (out * s).to(dtype)

    # -- update/read ----------------------------------------------------
    def update(self, cache: Dict, layer: int, k_new: torch.Tensor,
               v_new: torch.Tensor) -> Dict:
        """Write new tokens at cache['pos'] for this layer, in place."""
        pos = cache['pos']
        if self.method in ('fp', 'sink'):
            _upd(cache['k'], layer, pos, k_new)
            _upd(cache['v'], layer, pos, v_new)
            return cache
        kq, ks, kz = self._quant(k_new)
        vq, vs, vz = self._quant(v_new)
        _upd(cache['k_q'], layer, pos, kq)
        _upd(cache['v_q'], layer, pos, vq)
        _upd(cache['k_s'], layer, pos, ks[..., 0])
        _upd(cache['v_s'], layer, pos, vs[..., 0])
        if kz is not None:
            _upd(cache['k_z'], layer, pos, kz[..., 0])
            _upd(cache['v_z'], layer, pos, vz[..., 0])
        if self.method == 'kivi':
            if _per_slot(pos):
                raise NotImplementedError(
                    'the kivi cache keeps one residual ring for the batch: '
                    'lockstep positions only (the serving engine does not '
                    'take it, nor does the reference\'s)')
            _roll_in(cache['k_r'], layer, k_new)
            _roll_in(cache['v_r'], layer, v_new)
            cache['kivi_total'] = int(pos) + k_new.shape[1]
        return cache

    def read(self, cache: Dict, layer: int, dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.method in ('fp', 'sink'):
            return cache['k'][layer], cache['v'][layer]
        k = self._dequant(cache['k_q'][layer], cache['k_s'][layer][..., None],
                          cache['k_z'][layer][..., None]
                          if 'k_z' in cache else None, dtype)
        v = self._dequant(cache['v_q'][layer], cache['v_s'][layer][..., None],
                          cache['v_z'][layer][..., None]
                          if 'v_z' in cache else None, dtype)
        if self.method == 'kivi':
            # the most recent residual_length tokens (this step's
            # included) read their fp values
            total, R = cache['kivi_total'], self.residual_length
            _splice_residual(k, cache['k_r'][layer], total, R)
            _splice_residual(v, cache['v_r'][layer], total, R)
        return k, v

    def attention_mask_offset(self, pos, max_len: int):
        """sink: the kv positions a query at ``pos - 1`` attends (the sinks
        and the window before it), broadcast over ``pos``'s shape plus a
        trailing [max_len]; None for the other policies."""
        if self.method != 'sink':
            return None
        idx = torch.arange(max_len, device=pos.device if isinstance(
            pos, torch.Tensor) else None)
        return (idx < self.num_sink_tokens) | (idx >= pos
                                              - self.window_length)


def _per_slot(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def _roll_in(buf: torch.Tensor, layer: int, new: torch.Tensor) -> None:
    """Shift the ring [L, B, R, ...] of ``layer`` left by the new
    tokens and append them (the last R of them), in place."""
    R = buf.shape[2]
    new = new[:, -R:].to(buf.dtype)
    s = new.shape[1]
    buf[layer] = torch.cat([buf[layer, :, s:], new], dim=1)


def _splice_residual(kdq: torch.Tensor, kres: torch.Tensor, total: int,
                     R: int) -> None:
    """Overwrite positions [total - R, total) of kdq [B, S, KH, hd] with
    the ring kres [B, R, KH, hd], in place: slot j holds absolute
    position total - R + j, ``total`` the tokens after this step's write."""
    lo, hi = max(total - R, 0), min(total, kdq.shape[1])
    if hi > lo:
        off = total - R
        kdq[:, lo:hi] = kres[:, lo - off:hi - off].to(kdq.dtype)


def _upd(buf: torch.Tensor, layer: int, pos, new: torch.Tensor) -> None:
    """buf [L,B,S,...] <- new [B,s,...] at [layer, :, pos:pos+s], in
    place.  ``pos`` is an int (lockstep) or an int32 [B] tensor of
    per-slot positions (each slot written at its own offset)."""
    if _per_slot(pos):
        B, s = new.shape[0], new.shape[1]
        idx = pos.to(torch.long)[:, None] + torch.arange(
            s, device=buf.device)[None, :]                  # [B, s]
        rows = torch.arange(B, device=buf.device)[:, None]
        buf[layer].index_put_((rows, idx), new.to(buf.dtype))
        return
    p = int(pos)
    buf[layer, :, p:p + new.shape[1]] = new.to(buf.dtype)


@KV_REGISTRY.register(name='Naive')
def _naive(quant_type, kvcfg, n_blocks, **kw):
    return KVCachePolicy(method='naive', bit=int(kvcfg.get('bit', 8)),
                         symmetric=bool(kvcfg.get('symmetric', True)))


@KV_REGISTRY.register(name='Kivi')
def _kivi(quant_type, kvcfg, n_blocks, **kw):
    return KVCachePolicy(method='kivi', bit=int(kvcfg.get('bit', 8)),
                         symmetric=bool(kvcfg.get('symmetric', True)),
                         residual_length=int(kw.get('residual_length', 128)))


@KV_REGISTRY.register(name='SinkKV')
def _sink(quant_type, kvcfg, n_blocks, **kw):
    return KVCachePolicy(method='sink',
                         num_sink_tokens=int(kw.get('num_sink_tokens', 4)),
                         window_length=int(kw.get('window_length', 256)))


@KV_REGISTRY.register(name='ShadowKV')
def _shadowkv(quant_type, kvcfg, n_blocks, **kw):
    from .shadowkv import ShadowKVPolicy
    return ShadowKVPolicy(
        sparse_budget=int(kw.get('sparse_budget', 1024)),
        chunk_size=int(kw.get('chunk_size', 8)),
        rank=int(kw.get('rank', 160)),
        outlier_chunk=int(kw.get('outlier_chunk', 48)))
