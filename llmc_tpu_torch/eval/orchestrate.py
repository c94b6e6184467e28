"""Config-driven eval orchestration (port of
``llmc_tpu/eval/orchestrate.py``): the config's ``eval`` section is a list
of entries, each with its own ``type`` and ``eval_pos``; every entry whose
positions include the current one runs, under the QMap of that position.

Ported: entries of type ``ppl`` on ``synthetic`` ids, a raw text file or a
dataset on disk.  The other types (decode_ppl, acc, code, custom_gen,
latency, vqa, video_gen), ``inference_per_block`` and
``eval_token_consist`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .ppl import PerplexityEval

_UNPORTED_TYPES = {
    'decode_ppl': 'ROADMAP A5 (decode_nll)', 'latency': 'ROADMAP A13',
    'acc': 'ROADMAP A13', 'code': 'ROADMAP A13', 'custom_gen': 'ROADMAP A13',
    'vqa': 'ROADMAP A13', 'img_txt': 'ROADMAP A13',
    'video_gen': 'ROADMAP A13',
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
        if t not in (None, 'ppl'):
            raise ValueError(f'unknown eval type {t!r}')
        if ev.get('name') == 'imagenet':
            raise NotImplementedError(
                'the ImageNet accuracy eval is not ported yet (ROADMAP A13)')
        for opt, item in (('inference_per_block', 'ROADMAP A13'),
                          ('eval_token_consist', 'ROADMAP A5')):
            if ev.get(opt):
                raise NotImplementedError(
                    f'eval option {opt} is not ported yet ({item})')
        return 'ppl'

    def positions(self) -> List[str]:
        return sorted({p for e in self.entries for p in e.positions})

    def wants(self, position: str) -> bool:
        return any(position in e.positions for e in self.entries)

    def run(self, position: str, model, qmap=None) -> Dict:
        """Run every eval entry active at ``position``.  ``qmap=None`` is
        the pretrain / transformed deploy; a QMap is the fake-quant one."""
        results: Dict = {}
        for e in self.entries:
            if position in e.positions:
                results[f'{e.key}_{position}'] = self._ppl(e, model, qmap)
        return results

    def _ppl(self, e, model, qmap):
        if e.evaluator is None:
            ev = e.ev
            e.evaluator = PerplexityEval(
                load_eval_ids(ev, model.tokenizer),
                seq_len=ev.get('seq_len', 2048), bs=ev.get('bs', 1))
        return e.evaluator.eval(model, qmap=qmap)
