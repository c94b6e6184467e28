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
card is evaluated).  The ImageNet accuracy (``type: acc``, ``name:
imagenet``, or any entry on a ``Vit``: ``acc_{pos}``) reads an .npz /
.npy pair from ``path``, or else scores synthetic pixels against the
pretrain model's own predictions; ``vqa`` / ``img_txt`` entries
(``eval/vqa.py``: ``vqa_{pos}_acc``) answer samples from a calibration
source whose answers are the pretrain model's greedy continuations.  Both
build their labels before calibration changes the weights (``prebuild``).
``video_gen`` raises ``NotImplementedError`` (ROADMAP A13e).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .ppl import DecodePerplexityEval, PerplexityEval, TokenConsistencyEval

_UNPORTED_TYPES = {'video_gen': 'ROADMAP A13e'}


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
        if t in _UNPORTED_TYPES or config['model']['type'] in ('WanT2V',
                                                               'WanI2V'):
            raise NotImplementedError(
                f'eval type {t or "video_gen"!r} is not ported yet '
                f'({_UNPORTED_TYPES["video_gen"]})')
        if t in ('img_txt', 'vqa'):
            return 'vqa'
        if t in ('decode_ppl', 'latency', 'custom_gen', 'code', 'acc'):
            return t
        if t not in (None, 'ppl'):
            raise ValueError(f'unknown eval type {t!r}')
        # ImageNet accuracy keys off the ViT model type, as in the
        # reference (the only eval its Vit configs use)
        if ev.get('name') == 'imagenet' or config['model']['type'] == 'Vit':
            return 'acc'
        return 'ppl'

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

    def prebuild(self, model) -> None:
        """Build the evaluators whose labels are the pretrain model's (the
        VQA answers, the synthetic accuracy labels): before calibration
        changes the weights, whether or not 'pretrain' is a position."""
        for e in self.entries:
            if e.evaluator is None and e.ev['_etype'] == 'vqa':
                self._vqa_build(e, model)
            if e.evaluator is None and e.ev['_etype'] == 'acc':
                self._acc_build(e, model)

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
            if etype == 'acc':
                key = ('acc' if e.key == 'acc' else e.key) + f'_{position}'
                results[key] = self._acc(e, model, qmap)
                continue
            if etype == 'vqa':
                results[f'vqa_{position}_acc'] = self._vqa(e, model, qmap)
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

    def _acc_build(self, e, model):
        """ImageNet pixels and labels from ``path`` (one .npz with
        ``pixels`` / ``labels``, or a directory of pixels.npy and
        labels.npy); without them ``n_samples`` synthetic images
        (``RandomState(seed)``) labelled by the pretrain model's own
        predictions, so ``acc_pretrain`` is 1.0 and later positions measure
        the predictions' consistency under compression."""
        from ..models.adapter import AccuracyEval, VitAdapter
        if not isinstance(model, VitAdapter):
            raise ValueError(f'the acc eval classifies images: it needs a '
                             f'Vit model, not {type(model).__name__}')
        ev = e.ev
        path = ev.get('path')
        bs = int(ev.get('bs', 16))
        if path and os.path.isfile(path):
            d = np.load(path)
            pixels, labels = d['pixels'], d['labels']
        elif path and os.path.isdir(path):
            pixels = np.load(os.path.join(path, 'pixels.npy'))
            labels = np.load(os.path.join(path, 'labels.npy'))
        else:
            cfg = model.cfg
            rng = np.random.RandomState(ev.get('seed', 0))
            pixels = rng.randn(int(ev.get('n_samples', 16)), cfg.num_channels,
                               cfg.image_size, cfg.image_size).astype(
                np.float32)
            labels = AccuracyEval(pixels, np.zeros(len(pixels)),
                                  bs).predictions(model)
        e.evaluator = AccuracyEval(pixels, labels, bs=bs)

    def _acc(self, e, model, qmap):
        if e.evaluator is None:
            self._acc_build(e, model)
        return e.evaluator.eval(model, qmap=qmap)

    def _vqa_build(self, e, model):
        """The entry's samples from its calibration source (``name``,
        ``synthetic_vlm`` by default), each answered by the pretrain model
        (``answer_tokens`` greedy tokens)."""
        from ..data import CalibDataset
        from .vqa import VQAEval
        ev = e.ev
        batches, _ = CalibDataset(dict(ev, name=ev.get('name',
                                                       'synthetic_vlm')),
                                  model.tokenizer).get_calib_dataset()
        ans_len = int(ev.get('answer_tokens', 4))
        e.evaluator = VQAEval(vqa_samples(model, batches, ans_len),
                              max_new_tokens=ans_len)

    def _vqa(self, e, model, qmap):
        if e.evaluator is None:
            self._vqa_build(e, model)
        return e.evaluator.eval(model, qmap=qmap)['accuracy']


@torch.no_grad()
def vqa_samples(model, batches, ans_len: int) -> List[Dict]:
    """Native VQA samples: each batch's first row becomes (prompt, image
    inputs, answer), the answer the model's eager greedy continuation of
    ``ans_len`` tokens (lmms-eval's generate-and-match, with no network)."""
    dev = model.device
    samples = []
    for b in batches:
        bs = int(np.asarray(b['input_ids']).shape[0])
        img = {k: (v[:1] if bs > 1 and isinstance(v, np.ndarray)
                   and v.ndim > 1 and v.shape[0] == bs else v)
               for k, v in b.items() if k not in ('input_ids',
                                                  'attention_mask')}
        prompt = np.asarray(b['input_ids'], np.int64)[:1]
        cur = torch.as_tensor(prompt, device=dev)
        timg = {k: (torch.as_tensor(v, device=dev)
                    if isinstance(v, np.ndarray) else v)
                for k, v in img.items()}
        ans = []
        for _ in range(ans_len):
            nxt = int(torch.argmax(model.forward_logits(cur, **timg)[0, -1]))
            ans.append(nxt)
            cur = torch.cat([cur, torch.tensor([[nxt]], dtype=cur.dtype,
                                               device=dev)], dim=1)
        samples.append(dict({'input_ids': prompt[0].astype(np.int32),
                             'answer_ids': ans}, **img))
    return samples
