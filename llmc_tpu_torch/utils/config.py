"""YAML config loading and validation (port of
``llmc_tpu/utils/config.py``): a small attribute dict plus explicit
validation.  ``yaml`` is imported only by ``load_config``.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np
import torch


class Cfg(dict):
    """Attribute-accessible nested dict."""

    def __init__(self, d: Dict = None, **kw):
        super().__init__()
        d = dict(d or {}, **kw)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def get_nested(self, path: str, default=None):
        cur = self
        for part in path.split('.'):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def load_config(path: str) -> Cfg:
    import yaml
    with open(path) as f:
        return Cfg(yaml.safe_load(f))


def check_config(config: Cfg) -> None:
    """Weight granularity constraints and eval positions."""
    if 'model' not in config:
        raise ValueError('config must have a model section')
    for modality_cfg in iter_compress_sections(config):
        w = modality_cfg.get('weight')
        if w:
            gran = w.get('granularity', 'per_channel')
            if gran == 'per_group' and int(w.get('group_size', 128)) <= 0:
                raise ValueError('per_group requires positive group_size')
            if gran == 'per_head' and int(w.get('head_num', 0)) <= 0:
                raise ValueError('per_head requires head_num')
    if 'eval' in config and config.eval:
        ev = config.eval
        evs = ev if isinstance(ev, list) else [ev]
        for e in evs:
            for pos in e.get('eval_pos', []):
                if pos not in ('pretrain', 'transformed', 'fake_quant',
                               'fake_quant_wo_kv'):
                    raise ValueError(f'unknown eval_pos {pos!r}')


def iter_compress_sections(config: Cfg) -> List[Cfg]:
    """All quant/sparse sections, flattening per-modality nesting."""
    out = []
    for key in ('quant', 'sparse'):
        if key not in config:
            continue
        sec = config[key]
        sub = [m for m in ('language', 'vision', 'video_gen') if m in sec]
        if sub:
            out.extend(sec[m] for m in sub)
        else:
            out.append(sec)
    return out


def get_modality(config: Cfg) -> List[Tuple[str, Cfg]]:
    """(modality, sub-config) pairs run in turn; default ('language',
    config.quant)."""
    for key in ('quant', 'sparse'):
        if key not in config:
            continue
        sec = config[key]
        sub = [m for m in ('vision', 'language', 'video_gen') if m in sec]
        if sub:
            return [(m, sec[m]) for m in sub]
        return [('language', sec)]
    return []


def seed_all(seed: int, device='cpu') -> torch.Generator:
    """Seed python's and numpy's global generators (the text preprocessors
    draw from them, as in the reference) and return an explicit
    ``torch.Generator`` on ``device`` for the port's own random draws."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(int(seed))
