"""Generation-based evaluators and the lm-evaluation-harness adapter (port
of ``llmc_tpu/eval/harness.py``): ``CustomGenerate``, ``LMEvalAdapter``
and ``run_lm_eval``.  ``lm_eval`` is optional: it is imported where the
adapter is built, which raises ``ImportError`` without it."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class CustomGenerate:
    """Free-form greedy generation dumps (upstream
    eval_custom_generate.py): each prompt, tokenized (or, with no
    tokenizer, its first 32 UTF-8 bytes as ids), greedily continued by
    ``max_new_tokens``; the outputs are the decoded new text, or the new
    ids without a tokenizer."""

    def __init__(self, prompts: List[str], max_new_tokens: int = 64):
        self.prompts = prompts
        self.max_new_tokens = max_new_tokens

    def eval(self, model, qmap=None) -> List:
        from ..serve.decode import greedy_generate
        tok = model.tokenizer
        outs = []
        for prompt in self.prompts:
            if tok is not None:
                ids = np.asarray(tok(prompt)['input_ids'], np.int64)[None, :]
            else:
                ids = np.frombuffer(prompt.encode()[:32],
                                    np.uint8).astype(np.int64)[None, :]
            out = greedy_generate(model, ids, self.max_new_tokens, qmap=qmap,
                                  device=model.device)
            new = out[0, ids.shape[1]:].cpu().numpy()
            outs.append(tok.decode(new) if tok is not None else new.tolist())
        return outs


class LMEvalAdapter:
    """The model behind lm-evaluation-harness's LM API (the reference
    implements it natively; the upstream tool runs the harness in a
    process of its own).  Constructing it without the optional ``lm_eval``
    package raises ``ImportError``."""

    def __init__(self, model, qmap=None, batch_size: int = 1,
                 max_length: int = 2048):
        import lm_eval  # noqa: F401  (the optional package's gate)
        from lm_eval.api.model import LM
        self._model = model
        self._qmap = qmap
        outer = self

        class _Wrapped(LM):
            def loglikelihood(self, requests):
                return [outer._loglikelihood(r.args[0], r.args[1])
                        for r in requests]

            def loglikelihood_rolling(self, requests):
                return [outer._rolling_ll(r.args[0]) for r in requests]

            def generate_until(self, requests):
                return [outer._generate(r.args[0], r.args[1])
                        for r in requests]

        self.lm = _Wrapped()

    def _encode(self, text):
        return np.asarray(self._model.tokenizer(text)['input_ids'], np.int64)

    def _logprobs(self, ids: np.ndarray) -> np.ndarray:
        """[S, vocab] float32 log-softmax of one sequence's logits."""
        model = self._model
        with torch.no_grad():
            logits = model.forward_logits(
                torch.as_tensor(ids[None, :], device=model.device),
                qmap=self._qmap)
            lp = torch.log_softmax(logits[0].to(torch.float32), dim=-1)
        return lp.cpu().numpy()

    def _loglikelihood(self, context: str, continuation: str):
        ctx = self._encode(context)
        cont = self._encode(continuation)
        ids = np.concatenate([ctx, cont])
        lp = self._logprobs(ids)
        tgt = ids[len(ctx):]
        pos = np.arange(len(ctx) - 1, len(ids) - 1)
        token_lp = lp[pos, tgt]
        greedy = lp[pos].argmax(-1)
        return float(token_lp.sum()), bool((greedy == tgt).all())

    def _rolling_ll(self, text: str):
        ids = self._encode(text)
        lp = self._logprobs(ids)
        return float(lp[np.arange(len(ids) - 1), ids[1:]].sum())

    def _generate(self, context: str, gen_kwargs: Dict):
        from ..serve.decode import greedy_generate
        model = self._model
        ids = self._encode(context)[None, :]
        out = greedy_generate(model, ids,
                              int(gen_kwargs.get('max_gen_toks', 128)),
                              qmap=self._qmap, device=model.device)
        text = model.tokenizer.decode(out[0, ids.shape[1]:].cpu().numpy())
        for stop in gen_kwargs.get('until', []):
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
        return text


def run_lm_eval(model, tasks: List[str], qmap=None, **kw) -> Dict:
    """lm-evaluation-harness's ``simple_evaluate`` over the model."""
    import lm_eval
    adapter = LMEvalAdapter(model, qmap=qmap)
    return lm_eval.simple_evaluate(model=adapter.lm, tasks=tasks, **kw)
