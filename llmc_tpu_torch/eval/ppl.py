"""Perplexity evaluation (port of ``llmc_tpu/eval/ppl.py``).

The model is (params, qmap), so re-deploying between eval positions is
passing another qmap.  Ported: the sequence-chunked ``PerplexityEval``.
The decode PPL and the token-consistency eval wait for ``decode_nll``
(ROADMAP A5).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def nll_sum(model, ids: torch.Tensor, qmap=None):
    """(summed next-token NLL, token count) of one [B, S] batch of ids."""
    head, bfn = model.head_fn(), model.block_fn()
    x, kw = model.embed_and_rope_p(model.params, ids)
    for bp in model.params['blocks']:
        x, _ = bfn(bp, x, kw, qmap=qmap)
    logits = head(model.params, x)
    lp = torch.log_softmax(logits[:, :-1].to(F32), dim=-1)
    tgt = ids[:, 1:].to(torch.int64)
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return torch.sum(nll), nll.numel()


class PerplexityEval:
    """Sequence-chunked PPL over a flat array of token ids."""

    def __init__(self, test_ids: np.ndarray, seq_len: int = 2048,
                 bs: int = 1):
        ids = np.asarray(test_ids).reshape(-1)
        n = ids.shape[0] // seq_len
        self.chunks = ids[:n * seq_len].reshape(n, seq_len)
        self.bs = bs
        self.seq_len = seq_len

    def eval(self, model, qmap=None) -> float:
        dev = model.device
        total, count = 0.0, 0
        with torch.no_grad():
            for i in range(0, len(self.chunks), self.bs):
                batch = torch.from_numpy(
                    np.ascontiguousarray(self.chunks[i:i + self.bs])).to(dev)
                nll, n = nll_sum(model, batch, qmap)
                total += float(nll)
                count += n
        return float(np.exp(total / count))
