"""Calibration dataset assembly (port of ``llmc_tpu/data/dataset.py``):
source selection (``synthetic``, a dataset on disk, ``custom_txt``),
preprocessor dispatch, batching (bs = -1 | 1 | n), rank striding and
padding masks.

Samples are numpy int32, as in the reference, and the ``synthetic`` ids
come from ``np.random.RandomState(seed + rank)``: both packages calibrate
on the same tokens.  The LLaVA tier's synthetic sources draw theirs the
same way, one batch a sample: ``synthetic_vlm`` (ids with one image
placeholder span, and ``pixel_values``), ``synthetic_img`` (pixels alone,
ViT) and ``synthetic_videollava`` (ids with a video span, and F-frame
``pixel_values_videos``).  The other multimodal, audio and video sources
raise (ROADMAP A13e).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.registry import PREPROC_REGISTRY
from . import preproc as _preproc  # noqa: F401  (registers preprocs)

TEXT_KEY = {'pileval': 'text', 'c4': 'text', 'wikitext2': 'text',
            'ptb': 'sentence'}


# the synthetic multimodal sources of the LLaVA tier
SYNTHETIC_VLM = ('synthetic_vlm', 'synthetic_img', 'synthetic_videollava')


class CalibDataset:
    def __init__(self, calib_cfg: Dict, tokenizer=None):
        self.cfg = calib_cfg
        self.tokenizer = tokenizer
        self.name = calib_cfg['name']
        self.path = calib_cfg.get('path')
        self.n_samples = calib_cfg.get('n_samples')
        self.bs = calib_cfg.get('bs', 1)
        self.seq_len = calib_cfg.get('seq_len')
        self.preproc = calib_cfg.get('preproc', 'txt_general_preproc')
        self.padding = calib_cfg.get('padding', False)
        self.seed = calib_cfg.get('seed', 42)
        self.key = TEXT_KEY.get(self.name, 'text')
        self.calib_dataset = self._build(calib_cfg.get('download', False))

    # --- sources --------------------------------------------------------
    def _build(self, download: bool):
        if self.name in ('synthetic',) + SYNTHETIC_VLM:
            return None  # generated directly in get_calib_dataset
        if self.name.startswith('synthetic') or self.name in ('t2v', 'i2v'):
            raise NotImplementedError(
                f'calib source {self.name!r} (multimodal / audio / video) '
                f'is not ported yet (ROADMAP A13e)')
        if self.name == 'custom_txt':
            return self._load_custom_txt(self.path)
        if download:
            raise NotImplementedError(
                'calib.download fetches from a hub; the port reads datasets '
                'from disk only (calib.path)')
        import datasets
        return datasets.load_from_disk(self.path)

    @staticmethod
    def _load_custom_txt(path: str) -> List[str]:
        if os.path.isdir(path):
            lines = []
            for f in sorted(os.listdir(path)):
                fp = os.path.join(path, f)
                if f.endswith('.jsonl'):
                    with open(fp) as fh:
                        lines += [json.loads(ln).get('text', '')
                                  for ln in fh if ln.strip()]
                elif f.endswith('.txt'):
                    with open(fp) as fh:
                        lines += [ln.strip() for ln in fh if ln.strip()]
            return lines
        with open(path) as fh:
            return [ln.strip() for ln in fh if ln.strip()]

    # --- assembly -------------------------------------------------------
    def get_calib_dataset(self, rank: int = 0, world_size: int = 1
                          ) -> Tuple[List[Dict], Optional[List]]:
        """Returns (batches, padding_masks).  Each batch:
        {'input_ids': np.int32 [bs, seq], 'attention_mask': optional}."""
        random.seed(self.seed)
        if self.name in SYNTHETIC_VLM:
            return self._synthetic_vlm(np.random.RandomState(
                self.seed + rank)), None
        if self.name == 'synthetic':
            rng = np.random.RandomState(self.seed + rank)
            vocab = int(self.cfg.get('vocab_size', 32000))
            samples = [rng.randint(0, vocab, size=(1, self.seq_len))
                       .astype(np.int32) for _ in range(self.n_samples)]
        else:
            data = self.calib_dataset
            if world_size > 1 and not hasattr(data, 'shard'):
                data = list(data)[rank::world_size]
            elif world_size > 1:
                data = data.shard(num_shards=world_size, index=rank)
            fn = PREPROC_REGISTRY[self.preproc]
            kw = dict(calib_dataset=data, tokenizer=self.tokenizer,
                      n_samples=self.n_samples, seq_len=self.seq_len)
            if self.preproc == 'txt_general_preproc':
                kw['key'] = self.key
            samples = fn(**kw)
        batches = self._batch(samples)
        masks = [b.get('attention_mask') for b in batches] \
            if self.padding else None
        return batches, masks

    def _synthetic_vlm(self, rng) -> List[Dict]:
        """One batch a sample, drawn in the reference's order."""
        c = self.cfg
        size = int(c.get('image_size', 32 if self.name == 'synthetic_img'
                         else 28))
        chans = int(c.get('num_channels', 3))
        if self.name == 'synthetic_img':
            return [{'pixel_values': rng.randn(1, chans, size, size).astype(
                np.float32)} for _ in range(self.n_samples)]
        video = self.name == 'synthetic_videollava'
        vocab = int(c.get('vocab_size', 64 if video else 32000))
        tok = int(c.get('video_token' if video else 'image_token', vocab))
        per = int(c.get('image_seq_length', 4))
        frames = int(c.get('num_frames', 4))
        span = frames * per if video else per
        out = []
        for _ in range(self.n_samples):
            ids = rng.randint(0, vocab, size=(1, self.seq_len))
            ids[0, 1:1 + span] = tok
            shape = (1, frames, chans, size, size) if video else (
                1, chans, size, size)
            px = rng.randn(*shape).astype(np.float32)
            out.append({'input_ids': ids.astype(np.int32),
                        'pixel_values_videos' if video else 'pixel_values':
                        px})
        return out

    def _batch(self, samples: List[np.ndarray]) -> List[Dict]:
        if self.bs == -1:
            groups = [samples]
        elif self.bs == 1:
            return [{'input_ids': s} for s in samples]
        else:
            groups = [samples[i:i + self.bs]
                      for i in range(0, len(samples), self.bs)]
        out = []
        for grp in groups:
            if self.padding:
                ids, mask = _pad_cat(grp)
                out.append({'input_ids': ids, 'attention_mask': mask})
            else:
                out.append({'input_ids': np.concatenate(grp, axis=0)})
        return out


def _pad_cat(samples: List[np.ndarray], pad_id: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad to the longest sample (the HF convention for causal LM
    calibration)."""
    maxlen = max(s.shape[1] for s in samples)
    ids = np.full((len(samples), maxlen), pad_id, np.int32)
    mask = np.zeros((len(samples), maxlen), np.int32)
    for i, s in enumerate(samples):
        n = s.shape[1]
        ids[i, maxlen - n:] = s[0]
        mask[i, maxlen - n:] = 1
    return ids, mask
