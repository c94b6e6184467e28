"""Perplexity and token-consistency evaluation (port of
``llmc_tpu/eval/ppl.py``).

The model is (params, qmap), so re-deploying between eval positions is
passing another qmap.  ``PerplexityEval``: the sequence-chunked PPL.
``TokenConsistencyEval``: the share of argmax tokens two deploys agree
on.  ``DecodePerplexityEval``: the PPL of token-by-token decoding through
the (quantized) KV cache (``serve.decode.decode_nll``), over ``seq_len``
chunks of ids or over raw texts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

F32 = torch.float32


def forward_logits(model, ids: torch.Tensor, qmap=None) -> torch.Tensor:
    """The logits of one [B, S] batch of ids under ``qmap``."""
    head, bfn = model.head_fn(), model.block_fn()
    x, kw = model.embed_and_rope_p(model.params, ids)
    for bp in model.params['blocks']:
        x, _ = bfn(bp, x, kw, qmap=qmap)
    return head(model.params, x)


def nll_sum(model, ids: torch.Tensor, qmap=None):
    """(summed next-token NLL, token count) of one [B, S] batch of ids."""
    logits = forward_logits(model, ids, qmap)
    lp = torch.log_softmax(logits[:, :-1].to(F32), dim=-1)
    tgt = ids[:, 1:].to(torch.int64)
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return torch.sum(nll), nll.numel()


def _chunks(test_ids, seq_len: int, limit: Optional[int] = None):
    """The whole ``seq_len`` chunks of a flat id array (at most
    ``limit``), [n, seq_len]."""
    ids = np.asarray(test_ids).reshape(-1)
    n = ids.shape[0] // seq_len
    if limit is not None:
        n = min(n, limit)
    return ids[:n * seq_len].reshape(n, seq_len)


def _batches(chunks, bs: int, dev):
    for i in range(0, len(chunks), bs):
        yield torch.from_numpy(np.ascontiguousarray(chunks[i:i + bs])).to(dev)


class PerplexityEval:
    """Sequence-chunked PPL over a flat array of token ids."""

    def __init__(self, test_ids: np.ndarray, seq_len: int = 2048,
                 bs: int = 1):
        self.chunks = _chunks(test_ids, seq_len)
        self.bs = bs
        self.seq_len = seq_len

    def eval(self, model, qmap=None) -> float:
        total, count = 0.0, 0
        with torch.no_grad():
            for batch in _batches(self.chunks, self.bs, model.device):
                nll, n = nll_sum(model, batch, qmap)
                total += float(nll)
                count += n
        return float(np.exp(total / count))


class TokenConsistencyEval:
    """The share of positions where two deploys (``qmap_a``, ``qmap_b``)
    predict the same argmax token."""

    def __init__(self, test_ids: np.ndarray, seq_len: int = 2048,
                 bs: int = 1):
        self.chunks = _chunks(test_ids, seq_len)
        self.bs = bs

    def eval(self, model, qmap_a=None, qmap_b=None) -> float:
        agree = total = 0
        with torch.no_grad():
            for batch in _batches(self.chunks, self.bs, model.device):
                ta = forward_logits(model, batch, qmap_a).argmax(-1)
                tb = forward_logits(model, batch, qmap_b).argmax(-1)
                agree += int((ta == tb).sum())
                total += ta.numel()
        return agree / total


class DecodePerplexityEval:
    """Token-by-token decode PPL through the (quantized) KV cache.

    Two protocols.  Ids: the first ``num_samples`` whole ``seq_len``
    chunks, each decoded with a cache of its own.  Raw texts (``texts`` and
    ``tokenizer``, the reference's): the first ``num_samples`` texts, each
    tokenized whole; as upstream resets its cache outside the text loop,
    the cache persists across texts, and each text's last token is a label
    but never an input.  The PPL is exp of the mean NLL over every scored
    token.  The reference pads the text stream to a multiple of 64 tokens
    to bound its recompiles; the eager loop here has none to bound and
    feeds the stream as it is (the padded steps come after every scored
    one: they would only lengthen the cache)."""

    def __init__(self, test_ids: Optional[np.ndarray] = None,
                 seq_len: int = 2048, num_samples: int = 4,
                 texts=None, tokenizer=None):
        if texts is not None:
            self.texts = list(texts)[:num_samples]
            self.tokenizer = tokenizer
            self.chunks = None
        else:
            self.chunks = _chunks(test_ids, seq_len, num_samples)

    def eval(self, model, qmap=None, kv_policy=None) -> float:
        from ..serve.decode import decode_nll
        dev = model.device
        if self.chunks is not None:
            total, count = 0.0, 0
            for chunk in self.chunks:
                nll, n = decode_nll(model, chunk[None, :], qmap=qmap,
                                    kv_policy=kv_policy, device=dev)
                total += float(nll)
                count += n
            return float(np.exp(total / count))
        fed, lab = [], []
        for text in self.texts:
            ids = np.asarray(self.tokenizer(text)['input_ids'],
                             np.int64).reshape(-1)
            if ids.size < 2:
                continue   # upstream's token loop is empty too
            fed.append(ids[:-1])
            lab.append(ids[1:])
        if not fed:
            return float('nan')
        F, Lb = np.concatenate(fed), np.concatenate(lab)
        nll, n = decode_nll(model, F[None, :], qmap=qmap,
                            kv_policy=kv_policy, labels=Lb[None, :],
                            score_mask=np.ones(F.size, bool), device=dev)
        return float(np.exp(float(nll) / max(n, 1)))
