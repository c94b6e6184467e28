"""Latency statistics: TTFT and decode tokens/s (port of
``llmc_tpu/eval/latency.py``).

A warm-up prefill and G-step greedy decode, then ``iters`` timed runs of
each on random ids (``np.random.RandomState(0)``, as in the reference),
each ended by a device synchronise where the reference blocks until its
result is ready.  Prefill runs eagerly.  On a CUDA device the G-step decode
runs as one captured CUDA graph (``serve/graphs.py::CapturedStep``), the
counterpart of the reference's jitted ``lax.scan``: its first call (the
warm-up) runs eagerly and captures, each timed run replays it.  The
tokens of the warm-up's decode and of the last timed one
(``first_tokens``, ``tokens``: [B, G + 1] each, with the prefill's) and
the forwards run (``stats``) are kept for checking; the times are
records, not a parity target.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch


class LatencyEval:
    def __init__(self, prompt_len: int = 128, gen_len: int = 64,
                 batch: int = 1, iters: int = 5):
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.batch = batch
        self.iters = iters
        self.tokens: Optional[torch.Tensor] = None
        self.first_tokens: Optional[torch.Tensor] = None
        self.stats: Dict[str, int] = {}

    @staticmethod
    def _sync(dev: torch.device) -> None:
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def eval(self, model, qmap=None, kv_policy=None) -> Dict[str, float]:
        from ..serve.decode import forward_cached, init_cache
        from ..serve.graphs import CapturedStep
        from ..serve.kvcache import KVCachePolicy
        policy = kv_policy or KVCachePolicy(method='fp')
        cfg, params, dev = model.cfg, model.params, model.device
        B, P, G = self.batch, self.prompt_len, self.gen_len
        # one cache, rewritten by every run: a prefill writes positions
        # 0..P-1 and its decode P..P+G-1, before any read of them
        cache = init_cache(model, B, P + G, policy, device=dev)
        tok = torch.zeros((B,), dtype=torch.long, device=dev)
        ids = torch.as_tensor(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (B, P)), dtype=torch.long, device=dev)
        self.stats = {'prefill_forwards': 0, 'decode_steps': 0}

        def prefill():
            logits, _ = forward_cached(params, cfg, ids, dict(cache, pos=0),
                                       policy, qmap)
            tok.copy_(torch.argmax(logits[:, -1], -1))
            self.stats['prefill_forwards'] += 1

        def decode():
            c, t, outs = dict(cache, pos=P), tok, []
            for _ in range(G):
                logits, c = forward_cached(params, cfg, t[:, None], c,
                                           policy, qmap)
                t = torch.argmax(logits[:, -1], -1)
                outs.append(t)
            return torch.stack(outs, dim=1)

        run_decode = (CapturedStep(decode, dev) if dev.type == 'cuda'
                      else decode)
        # warm-up (on the card: the decode's eager run and its capture)
        prefill()
        first = tok.clone()
        self.first_tokens = torch.cat([first[:, None], run_decode()],
                                      dim=1).cpu()
        self.stats['decode_steps'] += G
        ttfts, dps, gen = [], [], None
        for _ in range(self.iters):
            t0 = time.perf_counter()
            prefill()
            self._sync(dev)
            ttfts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            gen = run_decode()
            self._sync(dev)
            dps.append(B * G / (time.perf_counter() - t0))
            self.stats['decode_steps'] += G
        self.tokens = (self.first_tokens if gen is None else
                       torch.cat([first[:, None], gen], dim=1).cpu())
        if not ttfts:
            return {}
        return {
            'ttft_p50_ms': float(np.percentile(ttfts, 50) * 1e3),
            'ttft_p99_ms': float(np.percentile(ttfts, 99) * 1e3),
            'decode_tokens_per_s': float(np.median(dps)),
            'prefill_tokens_per_s': float(B * P / np.percentile(ttfts, 50)),
        }
