"""VQA evaluation of a VLM (port of ``llmc_tpu/eval/vqa.py``).

``VQAEval`` greedy-generates an answer to each (image, question) sample
and scores an exact match (or a substring match).  Under ``use_cache``
'auto' a sample runs through the KV-cached ``vlm_greedy_generate`` (on the
card: the packed LM's kernels and a captured decode step) where the model
has ``prefill_embeds`` and its reduction is tower-side; an LM-side
reduction, or image inputs ``prefill_embeds`` does not take (Video-LLaVA's
clips), fall back to the eager re-forward of the growing sequence.  The
prefill and decode seconds are kept, as the reference's statistics hooks
keep them.  ``LmmsEvalAdapter`` is the optional lmms-eval integration: it
raises ``ImportError`` without the ``lmms_eval`` package.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


class VQAEval:
    """Native VQA scoring over explicit samples: {'input_ids': [S] ints
    (the prompt with its image placeholders), the model's image kwargs
    ('pixel_values', 'pixel_values_videos'), 'answer_ids': [A] ints}.  A
    sample scores 1 when its first len(answer_ids) greedy tokens equal the
    answer (or hold it, with ``substring``)."""

    def __init__(self, samples: Sequence[Dict], max_new_tokens: int = 8,
                 substring: bool = False, use_cache='auto'):
        self.samples = list(samples)
        self.max_new_tokens = max_new_tokens
        self.substring = substring
        self.use_cache = use_cache
        self.statistics: Dict = {}

    @torch.no_grad()
    def _gen_eager(self, model, qmap, ids, img, n_max, answer):
        dev = model.device
        toks, cur = [], ids
        t0 = time.perf_counter()
        prefill_s = 0.0
        for step in range(n_max):
            logits = model.forward_logits(cur, qmap=qmap, **img)
            nxt = int(torch.argmax(logits[0, -1]))
            if step == 0:
                prefill_s = time.perf_counter() - t0
                t0 = time.perf_counter()
            toks.append(nxt)
            cur = torch.cat([cur, torch.tensor([[nxt]], dtype=cur.dtype,
                                               device=cur.device)], dim=1)
            if len(toks) >= len(answer) and not self.substring:
                break
        _sync(dev)
        return toks, prefill_s, time.perf_counter() - t0

    def eval(self, model, qmap=None) -> Dict:
        from ..serve.decode import vlm_greedy_generate
        dev = model.device
        correct, prefill_s, decode_s, n_decode = 0, 0.0, 0.0, 0
        cached_ok = (self.use_cache in ('auto', True)
                     and hasattr(model, 'prefill_embeds'))
        for s in self.samples:
            ids = torch.as_tensor(np.asarray(s['input_ids'], np.int64)[None],
                                  device=dev)
            img = {k: (torch.as_tensor(v, device=dev)
                       if isinstance(v, np.ndarray) else v)
                   for k, v in s.items() if k not in ('input_ids',
                                                      'answer_ids')}
            answer = [int(a) for a in np.asarray(s['answer_ids'])]
            n_new = (self.max_new_tokens if self.substring
                     else min(len(answer), self.max_new_tokens))
            toks = None
            if cached_ok:
                try:
                    t = {}
                    out = vlm_greedy_generate(model, ids, n_new, qmap=qmap,
                                              timings=t, device=dev, **img)
                    toks = out[0, -n_new:].tolist()
                    prefill_s += t['prefill_s']
                    decode_s += t['decode_s']
                except (NotImplementedError, TypeError):
                    # an LM-side reduction, or inputs the cached prefill
                    # does not take: eager from here on
                    cached_ok = False
            if toks is None:
                toks, pt, dt = self._gen_eager(model, qmap, ids, img,
                                               self.max_new_tokens, answer)
                prefill_s += pt
                decode_s += dt
            n_decode += max(len(toks) - 1, 0)
            correct += int(_contains(toks, answer) if self.substring
                           else toks[:len(answer)] == answer)
        n = max(len(self.samples), 1)
        self.statistics = {'prefill_time_s': prefill_s,
                           'decode_time_s': decode_s,
                           'decode_tokens': n_decode,
                           'prefill_p50_ms': prefill_s / n * 1e3}
        return {'accuracy': correct / n, 'n': n, **self.statistics}


def _contains(seq: List[int], sub: List[int]) -> bool:
    if not sub:
        return True
    return any(seq[i:i + len(sub)] == sub
               for i in range(len(seq) - len(sub) + 1))


class LmmsEvalAdapter:
    """The optional lmms-eval integration: constructing it without the
    ``lmms_eval`` package raises ``ImportError``."""

    def __init__(self, model, qmap=None, batch_size: int = 1):
        import lmms_eval  # noqa: F401  (the optional dependency's gate)
        self._model = model
        self._qmap = qmap
        self.batch_size = batch_size

    def evaluate(self, tasks: List[str], limit: Optional[int] = None):
        from lmms_eval.evaluator import simple_evaluate
        return simple_evaluate(model=self._wrap(), tasks=tasks, limit=limit,
                               batch_size=self.batch_size)

    def _wrap(self):
        from lmms_eval.api.model import lmms

        from ..serve.decode import greedy_generate
        outer = self

        class _Wrapped(lmms):
            def generate_until(self, requests):
                outs = []
                tok = outer._model.tokenizer
                for r in requests:
                    ids = torch.as_tensor([tok(r.args[0])['input_ids']])
                    out = greedy_generate(outer._model, ids, 32,
                                          qmap=outer._qmap,
                                          device=outer._model.device)
                    outs.append(tok.decode(out[0, ids.shape[1]:].tolist()))
                return outs

            def loglikelihood(self, requests):
                raise NotImplementedError

            def loglikelihood_rolling(self, requests):
                raise NotImplementedError
        return _Wrapped()
