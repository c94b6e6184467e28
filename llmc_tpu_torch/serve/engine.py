"""Continuous-batching serving engine (port of
``llmc_tpu/serve/engine.py``).

Fixed ``max_batch`` decode slots with per-slot positions; one
``forward_cached`` over all slots per decode step.  Admission is
monolithic and bucketed: queued requests with the same prompt bucket
prefill together in groups of 1, 2 or 4 on a local cache, whose every
field is then spliced into the slots.  Greedy, temperature and top-p
sampling; ``decode_steps_per_sync`` windows of K steps per host sync;
retirement on EOS or ``max_new_tokens``.

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

Not ported yet, and raising: ``mesh`` (ROADMAP A14), ``prefill_chunk``
(A7), and KV policies other than fp / naive (A11).
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
from .kvcache import KVCachePolicy
from .packed import prefill_qmap_from

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
        for name, v, item in (('mesh', mesh, 'A14 parallel'),
                              ('prefill_chunk', prefill_chunk, 'A7')):
            if v is not None:
                raise NotImplementedError(
                    f'ServingEngine({name}=...) is not ported yet '
                    f'(ROADMAP {item})')
        if prefill_chunks_per_step != 1:
            raise NotImplementedError(
                'prefill_chunks_per_step needs prefill_chunk (ROADMAP A7)')
        if getattr(model.cfg, 'kv_lora_rank', None) is not None:
            raise NotImplementedError('MLA serving is not ported (A11)')
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
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.B = max_batch
        self.S = max_len
        self.buckets = sorted({b for b in prefill_buckets if b < max_len}
                              | {max_len})
        cfg = self.cfg
        self.cache = kv_policy.init_cache(
            self.B, self.S, cfg.num_key_value_heads, cfg.head_dim,
            cfg.num_hidden_layers, dtype=cfg.tdtype, device=self.device)
        self.cache['pos'] = torch.zeros((self.B,), dtype=torch.int32,
                                        device=self.device)
        self.active = np.zeros((self.B,), bool)
        self.last_tok = torch.zeros((self.B,), dtype=torch.int32,
                                    device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: deque = deque()
        self.steps_per_sync = max(1, int(decode_steps_per_sync))
        # host mirror of per-slot positions (window headroom without a
        # device read)
        self._host_pos = np.zeros((self.B,), np.int64)
        self.slot_nonce = torch.zeros((self.B,), dtype=torch.int32,
                                      device=self.device)
        self._start_pos = torch.zeros((self.B,), dtype=torch.int32,
                                      device=self.device)
        self._admit_seq = 0
        # forwards run, for checking kernel launch counts
        self.stats = {'prefill_forwards': 0, 'decode_steps': 0}

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

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------
    def _decode_step(self, toks, active):
        pos_before = self.cache['pos']
        n_gen = pos_before - self._start_pos + 1
        logits, cache = forward_cached(self.model.params, self.cfg,
                                       toks[:, None].to(torch.long),
                                       self.cache, self.policy, self.qmap)
        self.stats['decode_steps'] += 1
        nxt = sample_logits_per_slot(logits[:, -1], self.seed,
                                     self.slot_nonce, n_gen,
                                     self.temperature, self.top_p)
        # inactive slots neither advance nor keep the sampled token
        cache['pos'] = torch.where(active, cache['pos'], pos_before)
        self.cache = cache
        return nxt

    def _prefill(self, ids: np.ndarray, slots: List[int],
                 p_lasts: List[int], slen: int) -> torch.Tensor:
        """G same-bucket prompts through one forward on a local cache;
        every cache field is spliced into the G slots.  Returns the G
        greedy first tokens."""
        cfg = self.cfg
        G = len(slots)
        local = self.policy.init_cache(
            G, slen, cfg.num_key_value_heads, cfg.head_dim,
            cfg.num_hidden_layers, dtype=cfg.tdtype, device=self.device)
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        logits, local = forward_cached(self.model.params, cfg, ids_t, local,
                                       self.policy, self.qmap_prefill)
        self.stats['prefill_forwards'] += 1
        sl = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for k, v in local.items():
            if k == 'pos':
                continue
            self.cache[k][:, sl, :slen] = v.to(self.cache[k].dtype)
        rows = torch.arange(G, device=self.device)
        pl = torch.as_tensor(p_lasts, dtype=torch.long, device=self.device)
        return sample_logits(logits[rows, pl], None, 0.0, 1.0)

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

    def _retire(self, b, req):
        req.done = True
        self.active[b] = False
        self.slot_req[b] = None
        self.cache['pos'][b] = 0
        self._host_pos[b] = 0

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

    def _admit(self):
        pend = []
        for b in range(self.B):
            if self.active[b] or not self.queue:
                continue
            req = self.queue.popleft()
            P = len(req.prompt_ids)
            bucket = next((s for s in self.buckets if s >= P),
                          self.buckets[-1])
            ids = np.zeros((bucket,), np.int64)
            ids[:P] = np.asarray(req.prompt_ids)
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
        """One decode step over all slots (or a K-step window when every
        active slot has K steps of max_len headroom)."""
        self._admit()
        if not self.active.any():
            return False
        K = self.steps_per_sync
        if K > 1 and np.all(self._host_pos[self.active] + K <= self.S - 1):
            return self._step_window(K)
        act = torch.as_tensor(self.active, device=self.device)
        nxt = self._decode_step(self.last_tok, act)
        self.last_tok = torch.where(act, nxt, self.last_tok)
        nxt_np = nxt.cpu().numpy()
        pos_np = self.cache['pos'].cpu().numpy()
        self._host_pos[:] = pos_np
        for b in range(self.B):
            if not self.active[b]:
                continue
            req = self.slot_req[b]
            req.output_ids.append(int(nxt_np[b]))
            hit_eos = (req.eos_id is not None
                       and req.output_ids[-1] == req.eos_id)
            if len(req.output_ids) >= req.max_new_tokens or hit_eos \
                    or int(pos_np[b]) >= self.S - 1:
                self._retire(b, req)
        return True

    def _step_window(self, K: int):
        """K decode steps with one host sync; tokens past EOS /
        max_new_tokens are decoded and discarded."""
        act = torch.as_tensor(self.active, device=self.device)
        toks, outs = self.last_tok, []
        for _ in range(K):
            nxt = self._decode_step(toks, act)
            toks = torch.where(act, nxt, toks)
            outs.append(nxt)
        self.last_tok = toks
        out_np = torch.stack(outs, dim=1).cpu().numpy()       # [B, K]
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

    def run(self, requests: List[Request], max_steps: int = 10000
            ) -> List[Request]:
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.queue or self.active.any()) and steps < max_steps:
            self.step()
            steps += 1
        return requests
