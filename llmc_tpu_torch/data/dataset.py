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
``pixel_values_videos``); those of the second VLM slice ``synthetic_qwen2vl``
(a vision start, the merged image span, processor-layout
``pixel_patches`` and ``grid_thw``), ``synthetic_onevision`` (anyres crop
stacks with ``image_sizes``) and ``synthetic_onevision_video`` (the pooled
video span and its frames).  The other multimodal, audio and video sources
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


# the synthetic multimodal sources of the ported VLMs
SYNTHETIC_VLM = ('synthetic_vlm', 'synthetic_img', 'synthetic_videollava',
                 'synthetic_qwen2vl', 'synthetic_onevision',
                 'synthetic_onevision_video')


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
        if self.name == 'synthetic_qwen2vl':
            return self._synthetic_qwen2vl(rng)
        if self.name.startswith('synthetic_onevision'):
            return self._synthetic_onevision(rng)
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

    def _synthetic_qwen2vl(self, rng) -> List[Dict]:
        """Qwen2-VL's processor layout: ids with ``vision_start`` and the
        merged image span, flattened patches [h*w, patch_dim], the grid."""
        c = self.cfg
        vocab = int(c.get('vocab_size', 32000))
        img_tok = int(c.get('image_token', vocab))
        vstart = int(c.get('vision_start_token', vocab + 1))
        h, w = c.get('grid_hw', (4, 4))
        merge = int(c.get('spatial_merge_size', 2))
        pdim = int(c.get('patch_dim', 3 * 2 * 14 * 14))
        out = []
        for _ in range(self.n_samples):
            ids = rng.randint(0, vocab, size=(1, self.seq_len))
            ids[0, 1] = vstart
            ids[0, 2:2 + h * w // (merge * merge)] = img_tok
            out.append({'input_ids': ids.astype(np.int32),
                        'pixel_patches': rng.randn(h * w, pdim).astype(
                            np.float32),
                        'grid_thw': (1, h, w)})
        return out

    def _synthetic_onevision(self, rng) -> List[Dict]:
        """OneVision's anyres images (ids with the image span from position
        2, [1, crops, C, H, W] and ``image_sizes``) or videos (ids with the
        pooled span F*ceil(side/2)^2 + 1 from position 1, [1, F, C, H, W])."""
        c = self.cfg
        video = self.name == 'synthetic_onevision_video'
        vocab = int(c.get('vocab_size', 32000))
        tok = int(c.get('video_token' if video else 'image_token', vocab))
        size = int(c.get('image_size', 16))
        chans = int(c.get('num_channels', 3))
        if video:
            half = -(-(size // int(c.get('patch_size', 4))) // 2)
            frames = int(c.get('num_frames', 3))
            start, span = 1, frames * half * half + 1
            shape = (1, frames, chans, size, size)
        else:
            start, span = 2, int(c.get('image_seq_length', 4))
            shape = (1, int(c.get('num_crops', 2)), chans, size, size)
        out = []
        for _ in range(self.n_samples):
            ids = rng.randint(0, vocab, size=(1, self.seq_len))
            ids[0, start:start + span] = tok
            px = rng.randn(*shape).astype(np.float32)
            b = {'input_ids': ids.astype(np.int32)}
            if video:
                b['pixel_values_videos'] = px
            else:
                b.update(pixel_values=px, image_sizes=[(size, size)])
            out.append(b)
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
