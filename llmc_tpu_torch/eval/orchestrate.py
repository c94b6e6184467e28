"""Config-driven eval orchestration (port of
``llmc_tpu/eval/orchestrate.py``): the config's ``eval`` section is a list
of entries, each with its own ``type`` and ``eval_pos``; every entry whose
positions include the current one runs, under the QMap of that position.

Ported: entries of type ``ppl`` on ``synthetic`` ids, a raw text file or a
dataset on disk, with ``eval_token_consist`` (the argmax agreement of the
fake-quant deploy with the params under no QMap, at ``fake_quant``); and
entries of type ``decode_ppl``, which run at every configured position
(the calibrated KV-cache quantizer only at ``fake_quant``; an entry with no
positions runs at ``fake_quant``); entries of type ``latency``
(``eval/latency.py``: TTFT and decode tokens/s, under the calibrated KV
policy at ``fake_quant``) and ``custom_gen`` (``eval/harness.py``: greedy
continuations of the entry's ``prompts`` or the lines of its ``path``)
and ``code`` (``eval/code.py``: HumanEval completions of a problems file).
A ``ppl`` entry with ``inference_per_block`` runs block-outer
(``OffloadPPL``: each block uploaded once, the way a model larger than the
card is evaluated).  The VLM, audio and video types (acc, vqa, img_txt,
video_gen) raise ``NotImplementedError`` (ROADMAP A13e).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .ppl import DecodePerplexityEval, PerplexityEval, TokenConsistencyEval

_UNPORTED_TYPES = {
    'acc': 'ROADMAP A13e', 'vqa': 'ROADMAP A13e', 'img_txt': 'ROADMAP A13e',
    'video_gen': 'ROADMAP A13e',
}


def get_eval_list(config) -> List[Dict]:
    """The config's ``eval`` section as a list of entries."""
    ev = config.get('eval')
    if not ev:
        return []
    return [dict(e) for e in (ev if isinstance(ev, list) else [ev])]


def load_eval_ids(ev: Dict, tokenizer) -> Optional[np.ndarray]:
    """Token ids of a text eval entry (synthetic / a raw file / a dataset
    on disk)."""
    name = ev.get('name', 'synthetic')
    if name == 'synthetic':
        rng = np.random.RandomState(ev.get('seed', 0))
        n = ev.get('num_tokens', 16384)
        vocab = ev.get('vocab_size', 32000)
        return rng.randint(0, vocab, size=(n,)).astype(np.int32)
    path = ev.get('path')
    if path and os.path.isfile(path):
        with open(path) as f:
            text = f.read()
        return np.asarray(tokenizer(text)['input_ids'], np.int32)
    import datasets
    ds = datasets.load_from_disk(path)
    text = '\n\n'.join(ds['text'])
    return np.asarray(tokenizer(text)['input_ids'], np.int32)


def load_eval_texts(ev: Dict):
    """The raw texts of the per-text decode-PPL protocol (a raw file's
    lines, or a dataset's ``text`` column); None for synthetic data,
    which has no texts."""
    if ev.get('name', 'synthetic') == 'synthetic':
        return None
    path = ev.get('path')
    if path and os.path.isfile(path):
        with open(path) as f:
            return f.read().splitlines(keepends=True)
    import datasets
    return datasets.load_from_disk(path)['text']


class OffloadPPL:
    """The PPL of ``inference_per_block``: block-outer through
    ``utils/offload.py::streaming_ppl``, so each block of an offloaded model
    is uploaded once for every chunk."""

    def __init__(self, test_ids: np.ndarray, seq_len: int = 2048,
                 bs: int = 8):
        ids = np.asarray(test_ids).reshape(-1)
        n = ids.shape[0] // seq_len
        self.chunks = ids[:n * seq_len].reshape(n, seq_len)
        self.bs = bs

    def eval(self, model, qmap=None) -> float:
        from ..utils.offload import streaming_ppl
        return streaming_ppl(model, self.chunks, qmap=qmap, bs=self.bs)


class _Entry:
    def __init__(self, ev: Dict, key: str):
        self.ev = ev
        self.key = key                    # result-key base
        self.positions = list(ev.get('eval_pos', []))
        self.evaluator = None             # built at first use


class EvalOrchestrator:
    """One evaluator per eval entry; ``run(position, ...)`` runs every
    entry whose ``eval_pos`` holds the position.  Result keys are
    ``ppl_{pos}``; a second entry of one type is told apart by its
    ``name`` or index."""

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.entries: List[_Entry] = []
        seen: Dict[str, int] = {}
        for i, ev in enumerate(get_eval_list(config)):
            etype = self._etype(ev, config)
            n = seen.get(etype, 0)
            seen[etype] = n + 1
            key = etype if n == 0 else f"{etype}_{ev.get('name', i)}"
            self.entries.append(_Entry(dict(ev, _etype=etype), key))

    @staticmethod
    def _etype(ev: Dict, config) -> str:
        t = ev.get('type')
        if t in _UNPORTED_TYPES:
            raise NotImplementedError(
                f'eval type {t!r} is not ported yet ({_UNPORTED_TYPES[t]})')
        if t not in (None, 'ppl', 'decode_ppl', 'latency', 'custom_gen',
                     'code'):
            raise ValueError(f'unknown eval type {t!r}')
        if ev.get('name') == 'imagenet':
            raise NotImplementedError(
                'the ImageNet accuracy eval is not ported yet (ROADMAP A13e)')
        return t or 'ppl'

    def positions(self) -> List[str]:
        return sorted({p for e in self.entries for p in e.positions})

    @staticmethod
    def _active(e: _Entry, position: str) -> bool:
        # a decode_ppl entry with no positions runs at fake_quant
        return position in e.positions or (
            e.ev['_etype'] == 'decode_ppl' and not e.positions
            and position == 'fake_quant')

    def wants(self, position: str) -> bool:
        return any(self._active(e, position) for e in self.entries)

    def run(self, position: str, model, qmap=None, kv_policy=None) -> Dict:
        """Run every eval entry active at ``position``.  ``qmap=None`` is
        the pretrain / transformed deploy; a QMap is the fake-quant one.
        ``kv_policy``, the calibrated KV-cache quantizer, applies to the
        decode PPL at ``fake_quant`` alone (``fake_quant_wo_kv`` isolates
        it: the same QMap over an fp cache)."""
        results: Dict = {}
        for e in self.entries:
            if not self._active(e, position):
                continue
            etype = e.ev['_etype']
            if etype == 'decode_ppl':
                kv = kv_policy if position == 'fake_quant' else None
                results[f'{e.key}_{position}'] = self._decode_ppl(
                    e, model, qmap, kv)
                continue
            if etype == 'latency':
                results[f'{e.key}_{position}'] = self._latency(
                    e, model, qmap, kv_policy)
                continue
            if etype == 'custom_gen':
                results[f'{e.key}_{position}'] = self._custom_gen(
                    e, model, qmap)
                continue
            if etype == 'code':
                results[f'{e.key}_{position}'] = self._code(e, model, qmap)
                continue
            results[f'{e.key}_{position}'] = self._ppl(e, model, qmap)
            if position == 'fake_quant' and qmap is not None \
                    and e.ev.get('eval_token_consist'):
                results['token_consistency'] = TokenConsistencyEval(
                    load_eval_ids(e.ev, model.tokenizer),
                    seq_len=e.ev.get('seq_len', 2048),
                    bs=e.ev.get('bs', 1)).eval(model, None, qmap)
        return results

    def _decode_ppl(self, e, model, qmap, kv_policy):
        if e.evaluator is None:
            ev = e.ev
            texts = load_eval_texts(ev)
            if texts is not None and model.tokenizer is not None:
                e.evaluator = DecodePerplexityEval(
                    texts=texts, tokenizer=model.tokenizer,
                    num_samples=ev.get('num_samples', 4))
            else:
                e.evaluator = DecodePerplexityEval(
                    load_eval_ids(ev, model.tokenizer),
                    seq_len=ev.get('seq_len', 2048),
                    num_samples=ev.get('num_samples', 4))
        return e.evaluator.eval(model, qmap=qmap, kv_policy=kv_policy)

    def _latency(self, e, model, qmap, kv_policy):
        if e.evaluator is None:
            from .latency import LatencyEval
            ev = e.ev
            e.evaluator = LatencyEval(
                prompt_len=int(ev.get('prompt_len', 128)),
                gen_len=int(ev.get('gen_len', 64)),
                batch=int(ev.get('bs', 1)), iters=int(ev.get('iters', 5)))
        return e.evaluator.eval(model, qmap=qmap, kv_policy=kv_policy)

    def _custom_gen(self, e, model, qmap):
        if e.evaluator is None:
            from .harness import CustomGenerate
            ev = e.ev
            prompts = ev.get('prompts')
            if prompts is None and ev.get('path') \
                    and os.path.isfile(ev['path']):
                with open(ev['path']) as f:
                    prompts = [ln.rstrip('\n') for ln in f if ln.strip()]
            e.evaluator = CustomGenerate(
                prompts or ['Hello'],
                max_new_tokens=int(ev.get('max_new_tokens', 64)))
        return e.evaluator.eval(model, qmap=qmap)

    def _code(self, e, model, qmap):
        if e.evaluator is None:
            from .code import HumanEval
            ev = e.ev
            e.evaluator = HumanEval(
                problem_file=ev.get('path') or ev.get('problem_file'),
                max_new_tokens=int(ev.get('max_new_tokens', 256)),
                n_samples_per_task=int(ev.get('n_samples_per_task', 1)),
                res_path=ev.get('res_path', './humaneval_out'))
        return e.evaluator.eval(model, qmap=qmap)

    def _ppl(self, e, model, qmap):
        if e.evaluator is None:
            ev = e.ev
            ids = load_eval_ids(ev, model.tokenizer)
            if ev.get('inference_per_block'):
                e.evaluator = OffloadPPL(ids, seq_len=ev.get('seq_len', 2048),
                                         bs=ev.get('bs', 8))
            else:
                e.evaluator = PerplexityEval(
                    ids, seq_len=ev.get('seq_len', 2048), bs=ev.get('bs', 1))
        return e.evaluator.eval(model, qmap=qmap)
