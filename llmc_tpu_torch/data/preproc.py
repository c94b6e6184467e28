"""Calibration text preprocessors (port of ``llmc_tpu/data/preproc.py``).

Each preprocessor maps (text records, tokenizer, n_samples, seq_len) to a
list of int32 numpy arrays of shape [1, seq].  They stay numpy and draw
from python's ``random`` exactly as the reference does, so both packages
calibrate on the same tokens.  ``img_general`` turns image records into
``pixel_values`` batches (ViT and the VLMs' image calibration).
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from ..utils.registry import PREPROC_REGISTRY


def _ids(tokenizer, text: str) -> np.ndarray:
    out = tokenizer(text)['input_ids']
    return np.asarray(out, dtype=np.int32)[None, :]


def _random_slices(ids: np.ndarray, n_samples: int, seq_len: int
                   ) -> List[np.ndarray]:
    total = ids.shape[1]
    samples = []
    for _ in range(n_samples):
        i = random.randint(0, total - seq_len - 1)
        samples.append(ids[:, i:i + seq_len])
    return samples


def _texts(calib_dataset, key: str) -> List[str]:
    """Accept HF datasets, list-of-dicts, or list-of-str."""
    if hasattr(calib_dataset, 'column_names'):
        return list(calib_dataset[key])
    if calib_dataset and isinstance(calib_dataset[0], dict):
        return [d[key] for d in calib_dataset]
    return list(calib_dataset)


@PREPROC_REGISTRY.register
def wikitext2_gptq(calib_dataset, tokenizer, n_samples, seq_len):
    ids = _ids(tokenizer, '\n\n'.join(_texts(calib_dataset, 'text')))
    return _random_slices(ids, n_samples, seq_len)


@PREPROC_REGISTRY.register
def ptb_gptq(calib_dataset, tokenizer, n_samples, seq_len):
    ids = _ids(tokenizer, ' '.join(_texts(calib_dataset, 'sentence')))
    return _random_slices(ids, n_samples, seq_len)


@PREPROC_REGISTRY.register
def c4_gptq(calib_dataset, tokenizer, n_samples, seq_len):
    texts = _texts(calib_dataset, 'text')
    samples = []
    for _ in range(n_samples):
        while True:
            i = random.randint(0, len(texts) - 1)
            ids = _ids(tokenizer, texts[i])
            if ids.shape[1] >= seq_len:
                break
        i = random.randint(0, ids.shape[1] - seq_len - 1)
        samples.append(ids[:, i:i + seq_len])
    return samples


@PREPROC_REGISTRY.register
def pileval_awq(calib_dataset, tokenizer, n_samples, seq_len):
    texts = _shuffled(calib_dataset, 'text')
    chunks, n_run = [], 0
    for line in texts:
        enc = tokenizer(line.strip())['input_ids']
        if len(enc) > seq_len or len(enc) == 0:
            continue
        chunks.append(np.asarray(enc, np.int32))
        n_run += 1
        if n_run == n_samples:
            break
    cat = np.concatenate(chunks)[None, :]
    n_split = cat.shape[1] // seq_len
    return [cat[:, i * seq_len:(i + 1) * seq_len] for i in range(n_split)]


@PREPROC_REGISTRY.register
def pileval_smooth(calib_dataset, tokenizer, n_samples, seq_len):
    texts = _shuffled(calib_dataset, 'text')
    samples = []
    for line in texts[:n_samples]:
        enc = tokenizer(line)['input_ids'][:seq_len]
        samples.append(np.asarray(enc, np.int32)[None, :])
    return samples


@PREPROC_REGISTRY.register
def pileval_omni(calib_dataset, tokenizer, n_samples, seq_len):
    texts = _texts(calib_dataset, 'text')[:1000]
    ids = _ids(tokenizer, '\n\n'.join(texts))
    return _random_slices(ids, n_samples, seq_len)


@PREPROC_REGISTRY.register
def random_truncate_txt(calib_dataset, tokenizer, n_samples, seq_len):
    texts = list(calib_dataset)
    random.shuffle(texts)
    ids = _ids(tokenizer, '\n\n'.join(texts))
    return _random_slices(ids, n_samples, seq_len)


@PREPROC_REGISTRY.register
def ultrachat_general(calib_dataset, tokenizer, n_samples, seq_len):
    ds = calib_dataset.shuffle(seed=42).select(range(n_samples)) \
        if hasattr(calib_dataset, 'shuffle') else calib_dataset[:n_samples]
    samples = []
    for ex in ds:
        text = tokenizer.apply_chat_template(ex['messages'], tokenize=False)
        enc = tokenizer(text, add_special_tokens=False)['input_ids'][:seq_len]
        samples.append(np.asarray(enc, np.int32)[None, :])
    return samples


@PREPROC_REGISTRY.register
def txt_general_preproc(calib_dataset, tokenizer, n_samples, seq_len, key):
    texts = _shuffled(calib_dataset, key)
    samples = []
    for line in texts:
        enc = tokenizer(line)['input_ids'][:seq_len]
        if len(enc) < seq_len:
            continue
        samples.append(np.asarray(enc, np.int32)[None, :])
        if len(samples) == n_samples:
            break
    return samples


@PREPROC_REGISTRY.register
def original_txt(calib_dataset, tokenizer, n_samples, seq_len):
    """One sample per input line, untruncated (reference 'original_txt')."""
    samples = []
    for line in list(calib_dataset)[:n_samples]:
        samples.append(_ids(tokenizer, line))
    return samples


def _shuffled(calib_dataset, key):
    if hasattr(calib_dataset, 'shuffle'):
        ds = calib_dataset.shuffle(seed=42)
        return [d[key] for d in ds]
    texts = _texts(calib_dataset, key)
    rng = random.Random(42)
    texts = list(texts)
    rng.shuffle(texts)
    return texts


@PREPROC_REGISTRY.register
def img_general(calib_dataset, tokenizer, n_samples, seq_len=None,
                batch_process=None):
    """Image calibration samples: shuffle (python's ``random``), take
    ``n_samples``, and run the model's ``batch_process`` on them; without
    one, each item (an array, or a record's ``image``) is a
    {'pixel_values': [1, C, H, W] float32} batch."""
    items = list(calib_dataset)
    random.shuffle(items)
    items = items[:n_samples]
    if batch_process is not None:
        return batch_process(items)
    out = []
    for it in items:
        px = np.asarray(it['image'] if isinstance(it, dict) else it,
                        np.float32)
        out.append({'pixel_values': px[None] if px.ndim == 3 else px})
    return out
