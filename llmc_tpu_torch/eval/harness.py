"""Generation-based evaluators (port of ``llmc_tpu/eval/harness.py``'s
``CustomGenerate``).  The lm-eval adapter of the reference waits on the
optional ``lm_eval`` package (ROADMAP A13)."""

from __future__ import annotations

from typing import List

import numpy as np


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
