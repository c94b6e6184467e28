"""Continuous-batching serving engine (port of
``llmc_tpu/serve/engine.py``).

Fixed ``max_batch`` decode slots with per-slot positions; one
``forward_cached`` over all slots per decode step.  Admission, as in the
reference:

- monolithic and bucketed: queued requests with the same prompt bucket
  prefill together in groups of 1, 2 or 4 on a local cache, whose every
  field is then spliced into the slots;
- chunked (``prefill_chunk``): a request claims a free slot, then its
  prompt advances ``prefill_chunk`` tokens at a time through a local
  cache, at most ``prefill_chunks_per_step`` chunks an engine step, so
  that active slots stall one chunk's prefill instead of a whole prompt's;
  the finished local cache is spliced into the slot;
- into the paged pool (``kv_policy=PagedKVPolicy(...)``,
  ``serve/paged_cache.py``): the allocator's pages are taken at admission
  (a request waits while the pool cannot hold it) and given back at
  retirement; prefill, monolithic or chunked (in whole pages), runs on a
  dense fp local cache whose rows are then scattered, quantized for an
  int8 pool, into the slot's pages.

Greedy, temperature and top-p sampling; ``decode_steps_per_sync`` windows
of K steps per host sync; retirement on EOS or ``max_new_tokens``.

The compiled steps: where the reference ``jax.jit``s its decode step and
the K-step ``lax.scan`` (engine.py:254-256), the port, on a CUDA device
with a dense ``fp`` or ``naive`` cache, runs each as one captured CUDA
graph (``serve/graphs.py``) that replays the hand kernels (the ``sink``
cache's step too, which reads by the plain masked read); its inputs and
outputs are the engine's static buffers (the cache, ``pos``,
``last_tok``, the active mask, the slots' nonces and start positions),
which admission, splice and retirement write in place.  The window's graph
is K steps, its tokens bit-identical to K single steps.  The paged step
(its read length changes every step), prefill and the chunk step run
eagerly, as does every step on the CPU.  ``EagerServingEngine`` runs
the eager decode step (``_decode_window``) on the card too: the
comparison that the graphs are held to.

Sampling cannot reproduce JAX's PRNG bits.  It keeps the reference's
property instead: a slot's draw depends only on (seed, admission nonce,
generated-token index), through a counter-based hash computed on the
device, so outputs do not change with co-scheduling or window size.

``prefill_w8`` sends every prefill forward through the per-channel int8
companion copy of the block linears (``pack_model(w8_prefill=True)``,
``packed.prefill_qmap_from``); ``decode_w8`` sends the decode steps
there too.  The engine checks at construction that the companion is
packed in.  Where the reference ignores either flag silently when
``qmap`` is None, the port raises ``ValueError``.

A DeepSeek-family model (its config carries ``kv_lora_rank``) serves
through the absorbed latent cache (``serve/mla_decode.py``): the fp latent
under the ``fp`` policy, int8 codes with a per-token scale at the policy's
bit under ``naive``; every program then rides ``mla_forward_cached``, and
the decode steps are captured as the per-head ones are.  The reference
takes no other policy there, nor does the port (the paged pool included).

The ``sink`` policy (SinkKV) serves on its dense fp cache: every slot
masks the sinks and its own recent window at its own position, through
the plain masked read (``serve/decode.py::_attend_cached``; no decode
kernel takes it, as the reference's ``attn_ok`` takes none), captured
like the fp step.  Not ported yet, and raising: ``mesh`` (ROADMAP A14);
the kivi policy, whose one residual ring cannot hold per-slot positions,
is refused as the reference refuses it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.base import get_path, has_path
from ..utils.device import check_on, resolve_device
from .decode import forward_cached
from .graphs import CapturedStep
from .kvcache import KVCachePolicy
from .mla_decode import init_mla_cache, mla_forward_cached
from .packed import prefill_qmap_from
from .paged_cache import PageAllocator

F32 = torch.float32
FP = KVCachePolicy(method='fp')
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: np.ndarray
    max_new_tokens: int = 64
    eos_id: Optional[int] = None
    # filled by the engine
    output_ids: Optional[List[int]] = None
    done: bool = False


def _top_p_filter(logits, temperature: float, top_p: float):
    l = logits.to(F32) / temperature
    if top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx)
        l = l.masked_fill(l < cutoff, float('-inf'))
    return l


def sample_logits(logits, generator: Optional[torch.Generator],
                  temperature: float, top_p: float):
    """[B, V] logits -> [B] token ids.  temperature == 0 -> greedy."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_top_p_filter(logits, temperature, top_p), -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix on int64 tensors (products stay < 2**63)."""
    x = x & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def sample_logits_per_slot(logits, seed: int, nonce, n_gen,
                           temperature: float, top_p: float):
    """Per-slot deterministic sampling: slot b's draw uses Gumbel noise
    hashed from (seed, nonce[b], n_gen[b], vocab index) alone — not from
    the other slots or the decode window."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = _top_p_filter(logits, temperature, top_p)
    V = l.shape[-1]
    key = _hash32(_hash32(torch.full_like(nonce, seed, dtype=torch.int64))
                  ^ nonce.to(torch.int64))
    key = _hash32(key ^ n_gen.to(torch.int64))                    # [B]
    cols = _hash32(torch.arange(V, device=l.device, dtype=torch.int64))
    bits = _hash32(key[:, None] ^ cols[None, :])                   # [B, V]
    u = (bits.to(torch.float64) + 0.5) / 2.0 ** 32
    gumbel = (-torch.log(-torch.log(u))).to(F32)
    return torch.argmax(gumbel + l, dim=-1).to(torch.int32)


class ServingEngine(torch.nn.Module):
    """An ``nn.Module`` because it owns state: the KV cache and slots."""

    def __init__(self, model, qmap=None, max_batch: int = 8,
                 max_len: int = 1024, kv_policy: KVCachePolicy = FP,
                 temperature: float = 0.0, top_p: float = 1.0, mesh=None,
                 seed: int = 0, prefill_buckets=(32, 64, 128, 256, 512),
                 prefill_chunk: Optional[int] = None,
                 prefill_chunks_per_step: int = 1,
                 decode_steps_per_sync: int = 1, prefill_w8: bool = False,
                 decode_w8: bool = False, device=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError('ServingEngine(mesh=...) is not '
                                      'ported yet (ROADMAP A14 parallel)')
        # DeepSeek-family configs carry kv_lora_rank: they serve through
        # the absorbed latent cache (serve/mla_decode.py) under the same
        # scheduler, as in the reference
        self.mla = getattr(model.cfg, 'kv_lora_rank', None) is not None
        if self.mla and kv_policy.method not in ('fp', 'naive'):
            raise ValueError(
                f'MLA serving takes the fp or the quantized (naive) latent '
                f'cache, as in the reference; not {kv_policy.method!r}')
        if self.mla and (prefill_w8 or decode_w8):
            raise ValueError('prefill_w8 / decode_w8 on an MLA model: the '
                             'reference ignores them there, and the port '
                             'packs no MLA model (ROADMAP C)')
        if kv_policy.method not in ('fp', 'naive', 'paged', 'sink'):
            raise ValueError(
                f'the engine serves the fp, naive, paged and sink KV '
                f'policies, as the reference does; not '
                f'{kv_policy.method!r}')
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f'prefill_chunk must be >= 1, got '
                             f'{prefill_chunk}')
        self.device = resolve_device(device)
        check_on(model.params, self.device, 'the model')
        self.model = model
        self.cfg = model.cfg
        self.qmap = qmap
        self.qmap_prefill = qmap
        if prefill_w8 or decode_w8:
            qmap_w8 = self._w8_qmap(model, qmap,
                                    'prefill_w8' if prefill_w8
                                    else 'decode_w8')
            self.qmap_prefill = qmap_w8
            if decode_w8:   # decode rides the companion too: W8A8 serving
                self.qmap = qmap_w8
        self.policy = kv_policy
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks_per_step = max(1, int(prefill_chunks_per_step))
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.B = max_batch
        self.S = max_len
        self.buckets = sorted({b for b in prefill_buckets if b < max_len}
                              | {max_len})
        self.paged = kv_policy.method == 'paged'
        self.allocator = None
        if self.paged:
            off = [b for b in self.buckets if b % kv_policy.page_size]
            if off:
                raise ValueError(f'prefill buckets (max_len included) must '
                                 f'be multiples of page_size='
                                 f'{kv_policy.page_size}; got {off}')
            self.allocator = PageAllocator(kv_policy)
        self.cache = self._local_cache(self.B, self.S, kv_policy)
        self.cache['pos'] = torch.zeros((self.B,), dtype=torch.int32,
                                        device=self.device)
        self.active = np.zeros((self.B,), bool)
        # the device copy of ``active``, rewritten before each decode step
        self._act = torch.zeros((self.B,), dtype=torch.bool,
                                device=self.device)
        self.last_tok = torch.zeros((self.B,), dtype=torch.int32,
                                    device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: deque = deque()
        self.pending: deque = deque()      # chunked admissions in flight
        self.steps_per_sync = max(1, int(decode_steps_per_sync))
        # host mirror of per-slot positions (window headroom and the paged
        # read's length without a device read)
        self._host_pos = np.zeros((self.B,), np.int64)
        self.slot_nonce = torch.zeros((self.B,), dtype=torch.int32,
                                      device=self.device)
        self._start_pos = torch.zeros((self.B,), dtype=torch.int32,
                                      device=self.device)
        self._admit_seq = 0
        # the captured decode steps, by window length, in one memory pool
        self._graphs: Dict[int, CapturedStep] = {}
        self._graph_pool = None
        # forwards run, for checking kernel launch counts; admissions that
        # found the page pool too small and left the request waiting
        self.stats = {'prefill_forwards': 0, 'decode_steps': 0,
                      'pool_waits': 0}

    @staticmethod
    def _w8_qmap(model, qmap, which: str):
        """The companion QMap, after checking at construction (not at the
        first admission) that every packed block linear, and each fused
        one, has its w8 companion."""
        if qmap is None:
            raise ValueError(f'{which}=True needs the serving qmap of a '
                             f'model packed with its w8 companion')
        blk0 = model.blocks[0]
        paths = [p for p in model.get_layout().linears
                 if has_path(blk0, p) and 'qweight' in get_path(blk0, p)]
        paths += [p for p in ('self_attn.qkv_proj', 'mlp.gate_up_proj')
                  if has_path(blk0, p)]
        for p in paths:
            if 'qweight8' not in get_path(blk0, p):
                raise ValueError(
                    f'{which}=True but linear {p!r} has no w8 companion: '
                    f'pack with pack_model(..., w8_prefill=True)')
        return prefill_qmap_from(qmap)

    @property
    def graphed(self) -> bool:
        """Whether the decode steps replay captured CUDA graphs: on a CUDA
        device with a dense (fp, naive or sink) cache."""
        return self.device.type == 'cuda' and not self.paged

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------
    def _decode_step(self, toks, active):
        """One decode step over every slot: writes the cache and ``pos``
        in place (inactive slots neither advance nor keep their token) and
        returns the sampled tokens."""
        pos = self.cache['pos']
        n_gen = pos - self._start_pos + 1
        logits, out = self._forward(toks[:, None].to(torch.long), self.cache,
                                    self.policy, self.qmap)
        nxt = sample_logits_per_slot(logits[:, -1], self.seed,
                                     self.slot_nonce, n_gen,
                                     self.temperature, self.top_p)
        pos.copy_(torch.where(active, out['pos'], pos))
        return nxt

    def _decode_window(self, K: int) -> torch.Tensor:
        """K decode steps in a row, the reference's ``_decode_multi`` (K=1:
        its ``_decode_step``); ``last_tok`` advances in place.  Returns the
        [B, K] tokens."""
        act = self._act
        toks, outs = self.last_tok, []
        for _ in range(K):
            nxt = self._decode_step(toks, act)
            toks = torch.where(act, nxt, toks)
            outs.append(nxt)
        self.last_tok.copy_(toks)
        return torch.stack(outs, dim=1)

    def _decode(self, K: int) -> torch.Tensor:
        """The K-step window on the device: the captured graph of its
        length where the engine is ``graphed`` (captured at its first use),
        else ``_decode_window`` itself."""
        self._act.copy_(torch.from_numpy(self.active))
        self.stats['decode_steps'] += K
        if self.paged:
            # pages up to the largest position the window reaches
            self.cache['read_pages'] = (int(self._host_pos.max()) + K - 1
                                        ) // self.policy.page_size + 1
        if not self.graphed:
            return self._decode_window(K)
        step = self._graphs.get(K)
        if step is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            step = self._graphs[K] = CapturedStep(
                lambda: self._decode_window(K), self.device,
                pool=self._graph_pool)
        return step()

    def _forward(self, ids, cache, policy, qmap):
        """The one forward every program rides: ``forward_cached`` over the
        per-head cache, ``mla_forward_cached`` over the latent cache."""
        if self.mla:
            return mla_forward_cached(self.model.params, self.cfg, ids, cache,
                                      qmap, latent_bit=int(self.policy.bit))
        return forward_cached(self.model.params, self.cfg, ids, cache, policy,
                              qmap)

    def _local_forward(self, ids, local, policy):
        """A prefill (or prompt chunk) forward on a local cache."""
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        logits, local = self._forward(ids_t, local, policy,
                                      self.qmap_prefill)
        self.stats['prefill_forwards'] += 1
        return logits, local

    def _local_cache(self, batch: int, slen: int, policy):
        """A cache of ``batch`` rows of ``slen`` tokens under ``policy``;
        the latent cache on an MLA model (the int8 latent under ``naive``,
        at the policy's bit)."""
        cfg = self.cfg
        if self.mla:
            return init_mla_cache(
                cfg, batch, slen, dtype=cfg.tdtype,
                quant_bit=policy.bit if policy.method == 'naive' else None,
                device=self.device)
        return policy.init_cache(batch, slen, cfg.num_key_value_heads,
                                 cfg.head_dim, cfg.num_hidden_layers,
                                 dtype=cfg.tdtype, device=self.device)

    def _prefill(self, ids: np.ndarray, slots: List[int],
                 p_lasts: List[int], slen: int) -> torch.Tensor:
        """G same-bucket prompts through one forward on a local cache;
        every cache field is spliced into the G slots.  Returns the G
        greedy first tokens."""
        G = len(slots)
        logits, local = self._local_forward(
            ids, self._local_cache(G, slen, self.policy), self.policy)
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for k, v in local.items():
            if k == 'pos':
                continue
            self.cache[k][:, sl, :slen] = v.to(self.cache[k].dtype)
        rows = torch.arange(G, device=self.device)
        pl = torch.as_tensor(p_lasts, dtype=torch.long, device=self.device)
        return sample_logits(logits[rows, pl], None, 0.0, 1.0)

    def _splice(self, local, slot: int) -> None:
        """Every local-cache field into the slot's row of the cache."""
        for k, v in local.items():
            if k == 'pos':
                continue
            self.cache[k][:, slot, :v.shape[2]] = v[:, 0].to(
                self.cache[k].dtype)

    def _scatter_pages(self, local, slot: int, slen: int) -> None:
        """A dense fp local cache's K/V rows into the slot's pool pages
        (quantized for an int8 pool); the allocator wrote the slot's
        table row at admission."""
        ps = self.policy.page_size
        n_loc = slen // ps
        pages = self.cache['table'][slot, :n_loc].to(torch.long)
        Lc = self.cfg.num_hidden_layers

        def rows(buf):
            return buf[:, 0].reshape(Lc, n_loc, ps, *buf.shape[3:])
        if self.policy.bit:
            kq, ks = self.policy._quant(local['k'])
            vq, vs = self.policy._quant(local['v'])
            writes = (('pool_k', kq), ('pool_v', vq), ('pool_k_s', ks),
                      ('pool_v_s', vs))
        else:
            writes = (('pool_k', local['k']), ('pool_v', local['v']))
        for name, new in writes:
            buf = self.cache[name]
            buf[:, pages] = rows(new).to(buf.dtype)

    def _prefill_paged(self, ids: np.ndarray, slot: int, p_last: int,
                       slen: int) -> int:
        """One prompt on a dense fp local cache, scattered into the slot's
        pages; returns the greedy first token."""
        logits, local = self._local_forward(
            ids, self._local_cache(1, slen, FP), FP)
        self._scatter_pages(local, slot, slen)
        return int(torch.argmax(logits[0, p_last]))

    # ------------------------------------------------------------------
    # host scheduler
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        P = len(req.prompt_ids)
        if P > self.buckets[-1]:
            raise ValueError(
                f'prompt length {P} exceeds the engine max prefill length '
                f'{self.buckets[-1]} (max_len={self.S})')
        if P >= self.S:
            raise ValueError(f'prompt length {P} leaves no room to '
                             f'generate within max_len={self.S}')
        req.output_ids = []
        self.queue.append(req)

    def _bucket(self, P: int) -> int:
        return next((s for s in self.buckets if s >= P), self.buckets[-1])

    def _retire(self, b, req):
        req.done = True
        self.active[b] = False
        self.slot_req[b] = None
        self.cache['pos'][b] = 0
        self._host_pos[b] = 0
        if self.allocator is not None:
            self.allocator.release(b, self.cache['table'])

    def _finish_admit(self, b, req, P, nxt: int):
        self.cache['pos'][b] = P
        self._host_pos[b] = P
        self._admit_seq += 1
        self.slot_nonce[b] = self._admit_seq
        self._start_pos[b] = P
        self.last_tok[b] = nxt
        self.active[b] = True
        self.slot_req[b] = req
        req.output_ids.append(int(nxt))
        if (len(req.output_ids) >= req.max_new_tokens
                or (req.eos_id is not None and int(nxt) == req.eos_id)):
            self._retire(b, req)

    def _admit_chunked(self):
        """Each queued request claims a free slot; its prompt then
        advances ``prefill_chunk`` tokens at a time (whole pages under a
        paged pool) through a local cache, at most
        ``prefill_chunks_per_step`` chunks an engine step."""
        for b in range(self.B):
            if self.active[b] or self.slot_req[b] is not None \
                    or not self.queue:
                continue
            req = self.queue[0]
            P = len(req.prompt_ids)
            bucket = self._bucket(P)
            ce = min(self.prefill_chunk, bucket)
            if self.paged:
                ps = self.policy.page_size
                ce = max(ps, ce // ps * ps)
            n_run = -(-P // ce)
            if n_run * ce > self.S:    # odd bucket/chunk ratio: one shot
                ce, n_run = bucket, 1
            if self.paged:
                # capped at max_len: a slot retires at max_len - 1
                need = min(max(n_run * ce, P + req.max_new_tokens), self.S)
                if not self.allocator.can_admit(need):
                    self.stats['pool_waits'] += 1
                    break              # pool exhausted: the request waits
                self.allocator.allocate(b, need, self.cache['table'])
            self.queue.popleft()
            ids = np.zeros((1, n_run * ce), np.int64)
            ids[0, :P] = np.asarray(req.prompt_ids)
            # the paged engine chunks through a dense fp local cache,
            # scattered into the slot's pages at completion
            policy = FP if self.paged else self.policy
            # p_rel: the prompt's last token, in the final chunk
            p_rel = min(max(P - 1 - (n_run - 1) * ce, 0), ce - 1)
            self.pending.append(dict(
                req=req, slot=b, ids=ids, P=P, ce=ce, n_run=n_run,
                local=self._local_cache(1, n_run * ce, policy),
                policy=policy, i=0, p_rel=p_rel))
            self.slot_req[b] = req          # reserved; active stays False
        budget = self.prefill_chunks_per_step
        while budget > 0 and self.pending:
            st = self.pending[0]
            off = st['i'] * st['ce']
            logits, st['local'] = self._local_forward(
                st['ids'][:, off:off + st['ce']], st['local'], st['policy'])
            st['i'] += 1
            budget -= 1
            if st['i'] == st['n_run']:
                self.pending.popleft()
                if self.paged:
                    self._scatter_pages(st['local'], st['slot'],
                                        st['n_run'] * st['ce'])
                else:
                    self._splice(st['local'], st['slot'])
                nxt = int(torch.argmax(logits[0, st['p_rel']]))
                self._finish_admit(st['slot'], st['req'], st['P'], nxt)

    def _admit(self):
        if self.prefill_chunk is not None:
            return self._admit_chunked()
        pend = []
        for b in range(self.B):
            if self.active[b] or not self.queue:
                continue
            req = self.queue[0]
            P = len(req.prompt_ids)
            bucket = self._bucket(P)
            if self.paged:
                # the page budget covers the bucket's scatter + generation,
                # capped at max_len: a slot retires at max_len - 1
                need = min(max(bucket, P + req.max_new_tokens), self.S)
                if not self.allocator.can_admit(need):
                    self.stats['pool_waits'] += 1
                    break              # pool exhausted: the request waits
            self.queue.popleft()
            ids = np.zeros((bucket,), np.int64)
            ids[:P] = np.asarray(req.prompt_ids)
            if self.paged:
                self.allocator.allocate(b, need, self.cache['table'])
                self._finish_admit(b, req, P, self._prefill_paged(
                    ids[None], b, P - 1, bucket))
            else:
                pend.append((b, req, P, bucket, ids))
        by_bucket: Dict[int, list] = {}
        for item in pend:
            by_bucket.setdefault(item[3], []).append(item)
        for bucket, group in by_bucket.items():
            i = 0
            while i < len(group):
                g = 1
                while g * 2 <= len(group) - i and g * 2 <= 4:
                    g *= 2
                sub = group[i:i + g]
                i += g
                nxt = self._prefill(np.stack([s[4] for s in sub]),
                                    [s[0] for s in sub],
                                    [s[2] - 1 for s in sub], bucket)
                nxt_np = nxt.cpu().numpy()
                for j, (b, req, P, _, _) in enumerate(sub):
                    self._finish_admit(b, req, P, int(nxt_np[j]))

    @torch.no_grad()
    def step(self):
        """Admission, then one decode step over all slots, or a K-step
        window when every active slot has K steps of max_len headroom;
        tokens past EOS / ``max_new_tokens`` in a window are decoded and
        discarded."""
        self._admit()
        if not self.active.any():
            return False
        K = self.steps_per_sync
        if not (K > 1 and np.all(self._host_pos[self.active] + K
                                 <= self.S - 1)):
            K = 1
        out_np = self._decode(K).cpu().numpy()              # [B, K]
        self._host_pos[self.active] += K
        for b in range(self.B):
            if not self.active[b]:
                continue
            req = self.slot_req[b]
            done = False
            for t in out_np[b]:
                req.output_ids.append(int(t))
                if (req.eos_id is not None and int(t) == req.eos_id) \
                        or len(req.output_ids) >= req.max_new_tokens:
                    done = True
                    break
            if done or int(self._host_pos[b]) >= self.S - 1:
                self._retire(b, req)
        return True

    def run(self, requests: List[Request],
            max_steps: int = 10000) -> List[Request]:
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.queue or self.pending or self.active.any()) \
                and steps < max_steps:
            self.step()
            steps += 1
        return requests


class EagerServingEngine(ServingEngine):
    """The engine with every decode step run eagerly (``_decode_window``),
    on the card too: the comparison that the captured steps are held to
    (tests, ``chip_smoke.py``)."""
    graphed = False
