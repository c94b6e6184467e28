"""Blockwise optimization engine (port of
``llmc_tpu/compression/blockwise.py``).

``BlockwiseOpt`` walks the blocks; ``BaseBlockwiseQuantization`` holds
what every quantization algorithm shares: config parsing, the per-block
capture + transform step, ``deploy`` and weight baking.  Forward hooks are
``block_apply(capture=True)`` returning the subset inputs, module
replacement is a ``QMap`` (a static per-linear policy) plus param
transforms on one tree.  The reference's ``jax.jit`` caches have no
counterpart: the block functions are plain functions under
``torch.no_grad()``.

Ported: weight-only configs.  Activation quantization (dynamic and
static), the double W4/W8 quantization (``bit: 48``), KV-cache
quantization configs and online rotation raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import torch

from ..convert import params_to_numpy
from ..models.adapter import BaseAdapter, QMap
from ..models.base import LinearQcfg, get_path, has_path, set_path
from ..quant.qspec import spec_from_config
from ..quant.quantizer import fake_quant_weight


class BlockwiseOpt:
    """The abstract block loop."""

    def __init__(self, model: BaseAdapter, compress_config, inputs,
                 padding_mask, config):
        self.model = model
        self.compress_config = compress_config
        self.config = config
        self.inputs = list(inputs['data']) if isinstance(inputs, dict) \
            else (list(inputs[0]) if isinstance(inputs, tuple) else
                  list(inputs) if inputs else [])
        self.kwargs_list = (inputs.get('kwargs')
                            if isinstance(inputs, dict) else None) or []
        self.padding_mask = padding_mask
        self.n_samples = sum(int(x.shape[0]) for x in self.inputs)
        self.block_idx = -1

    def run_block_loop(self):
        with torch.no_grad():
            for i in range(self.model.n_blocks):
                self.block_idx = i
                self.block_opt(i)
        self.save_search_artifacts()

    def save_search_artifacts(self):
        """scales.pkl / clips.pkl: the artifacts of a two-stage pipeline,
        as trees of numpy arrays."""
        if getattr(self, 'save_scale', False) and self.act_scales:
            os.makedirs(self.scale_path, exist_ok=True)
            with open(os.path.join(self.scale_path, 'scales.pkl'), 'wb') as f:
                pickle.dump(params_to_numpy(self.act_scales), f)
        clips = getattr(self, 'auto_clipper', None)
        if getattr(self, 'save_clip', False) and clips is not None \
                and clips.weight_clips:
            os.makedirs(self.clip_path, exist_ok=True)
            with open(os.path.join(self.clip_path, 'clips.pkl'), 'wb') as f:
                pickle.dump(params_to_numpy(clips.weight_clips), f)

    def block_opt(self, idx: int):
        raise NotImplementedError


class BaseBlockwiseQuantization(BlockwiseOpt):
    """Shared machinery of every quantization algorithm."""

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.quant_config = quant_config
        self.layout = model.get_layout()
        self.block_fn = model.block_fn()
        self.inspect_fns = model.inspect_fns()
        self.set_quant_config()

    # ------------------------------------------------------------------
    # config parsing
    # ------------------------------------------------------------------
    def set_quant_config(self):
        qc = self.quant_config
        cfg = self.config
        self.mixed_precision = 'ignored_layers' in cfg
        il = cfg.get('ignored_layers', {}) or {}
        self.ignored_block_ids = _expand_ranges(il.get('block_ids', []))
        self.ignored_layer_names = list(il.get('layer_names', []))
        self.ignored_special_names = list(il.get('speical_names',
                                                 il.get('special_names', [])))
        self.quant_out = qc.get('quant_out', False)

        wcfg = dict(qc.get('weight', {}))
        if wcfg.get('bit') == 48:
            raise NotImplementedError(
                'weight.bit=48 (double W4/W8 quantization) is not ported '
                'yet (ROADMAP A10)')
        self.wspec = spec_from_config(wcfg) if wcfg else None
        if qc.get('act'):
            raise NotImplementedError(
                'quant.act (activation quantization, dynamic or static) is '
                'not ported yet (ROADMAP A10)')
        self.w_only = True
        self.aspec = None
        if 'kvcache' in qc:
            raise NotImplementedError(
                'quant.kvcache (a calibrated KV-cache quantizer in the '
                'evals) is not ported yet (ROADMAP A11)')
        self.kv_module = None

        special = qc.get('special', {}) or {}
        self.special = special
        if special.get('online_rotate', False):
            raise NotImplementedError(
                'special.online_rotate (QuaRot online rotation) is not '
                'ported yet (ROADMAP A10)')
        self.true_sequential = special.get('true_sequential', False)
        self.weight_clip = special.get('weight_clip', False)
        self.save_clip = special.get('save_clip', False)
        self.clip_path = special.get('clip_path')
        self.clip_version = special.get('clip_version', 'v1')
        if self.weight_clip or special.get('search_clip_init', False):
            from .quantization.auto_clip import AutoClipper
            self.auto_clipper = AutoClipper(
                w_only=self.w_only, wspec=self.wspec, aspec=self.aspec,
                clip_version=self.clip_version,
                clip_sym=special.get('clip_sym',
                                     self.wspec.symmetric
                                     if self.wspec else True),
                save_clip=self.save_clip, padding_mask=self.padding_mask)
        self.save_scale = special.get('save_scale', False)
        self.scale_path = special.get('scale_path')
        self.act_scales = {}
        self.do_gqa_trans = special.get('do_gqa_trans', False)
        self.has_gqa = (getattr(self.model.cfg, 'num_key_value_heads', 1)
                        != getattr(self.model.cfg, 'num_attention_heads', 1))

    # ------------------------------------------------------------------
    # fake-quant weight helpers
    # ------------------------------------------------------------------
    def w_qdq(self, w, up_factor=None, low_factor=None):
        return fake_quant_weight(self.wspec, w, up_factor=up_factor,
                                 low_factor=low_factor)

    def layer_is_ignored(self, block_idx: int, path: str) -> bool:
        if not self.mixed_precision:
            return False
        if block_idx in self.ignored_block_ids and \
                path in self.ignored_layer_names:
            return True
        full = f'model.layers.{block_idx}.{path}'
        return full in self.ignored_special_names

    def qcfg_for(self, block_idx: int, path: str) -> Optional[LinearQcfg]:
        """The fake-quant policy of one linear: the single source for
        every qmap build."""
        if self.layer_is_ignored(block_idx, path):
            return None
        return LinearQcfg(w_spec=self.wspec, a_spec=self.aspec,
                          a_static=False)

    def fake_quant_qmap(self, block_idx: int) -> QMap:
        return QMap({p: self.qcfg_for(block_idx, p)
                     for p in self.layout.linears})

    # ------------------------------------------------------------------
    # block forward / capture
    # ------------------------------------------------------------------
    def block_forward(self, block, inputs=None, qmap=None) -> List:
        inputs = self.inputs if inputs is None else inputs
        return [self.block_fn(block, x, kw, qmap=qmap)[0]
                for x, kw in zip(inputs, self._kwargs_iter())]

    def block_forward_capture(self, block, qmap=None):
        outs, feats = [], {}
        for x, kw in zip(self.inputs, self._kwargs_iter()):
            y, caps = self.block_fn(block, x, kw, qmap=qmap, capture=True)
            outs.append(y)
            for k, v in caps.items():
                feats.setdefault(k, []).append(v)
        return outs, feats

    def _kwargs_iter(self):
        if not self.kwargs_list:
            return [{}] * len(self.inputs)
        if len(self.kwargs_list) == 1:
            return self.kwargs_list * len(self.inputs)
        return self.kwargs_list

    # ------------------------------------------------------------------
    # the per-block step
    # ------------------------------------------------------------------
    def block_opt(self, idx: int):
        block = self.model.blocks[idx]
        outs, feats = self.block_forward_capture(block)
        if not self.quant_out:
            self.inputs = outs
        block = self.block_transform(idx, block, feats)
        if self.quant_out:
            self.inputs = self.block_forward(
                block, qmap=self.fake_quant_qmap(idx))
        self.model.set_block(idx, block)

    def block_transform(self, idx: int, block, feats):
        for i, subset in enumerate(self.layout.subsets):
            if not has_path(block, subset.layers[0]):
                continue  # a mixed-arch block lacks this subset
            block = self.subset_transform(idx, block, subset, feats)
            if self.true_sequential and i != len(self.layout.subsets) - 1:
                # recompute activations with this subset fake-quantized
                qmap = QMap({p: self.qcfg_for(idx, p)
                             for s in self.layout.subsets[:i + 1]
                             for p in s.layers})
                _, feats2 = self.block_forward_capture(block, qmap=qmap)
                feats.update(feats2)
        if self.weight_clip:
            block = self.auto_clipper.run(
                block, idx, self.layout, feats,
                n_sample_token=self.config.get_nested('calib.seq_len')
                if hasattr(self.config, 'get_nested') else None)
        return block

    def subset_transform(self, idx, block, subset, feats):
        """Algorithm-specific; default no-op (RTN)."""
        return block

    def update_input_feat(self, feats, subset, scales, is_gqa=False):
        """Divide the cached activations by the applied scales."""
        s = scales
        if is_gqa:
            from .transforms import repeat_gqa_scales
            cfgm = self.model.cfg
            s = repeat_gqa_scales(
                scales, cfgm.num_key_value_heads,
                cfgm.num_attention_heads // cfgm.num_key_value_heads)
        key = subset.input_key
        feats[key] = [x / s.reshape((1,) * (x.ndim - 1) + (-1,))
                      for x in feats[key]]

    # ------------------------------------------------------------------
    # deploy / save
    # ------------------------------------------------------------------
    def deploy(self, quant_format: str) -> QMap:
        """Build the QMap of an eval/serve stage."""
        if quant_format in ('origin_float', 'transformed'):
            qmap = QMap({})
        elif quant_format == 'fake_quant':
            per_block = [{p: self.qcfg_for(b, p)
                          for p in self.layout.linears}
                         for b in range(self.model.n_blocks)]
            if all(pb == per_block[0] for pb in per_block[1:]):
                entries = dict(per_block[0])
            else:
                # Block-dependent policies (ignored_layers.block_ids)
                # cannot live in ONE flat QMap: bake the weight qdq into
                # the params by each block's own decision; weight-only, so
                # nothing is left for the runtime.
                if not getattr(self, '_baked', False):
                    self.bake_fake_quant_weights()
                    self._baked = True   # save_fake must not re-bake
                entries = {p: None for p in self.layout.linears}
            qmap = QMap(entries)
        else:
            raise ValueError(f'unknown quant_format {quant_format!r}')
        self.model.qmap = qmap
        return qmap

    def bake_fake_quant_weights(self):
        """Quantize-dequantize the weights once and store them back into
        the params."""
        with torch.no_grad():
            for b in range(self.model.n_blocks):
                blk = self.model.blocks[b]
                for path in self.layout.linears:
                    if self.layer_is_ignored(b, path) \
                            or not has_path(blk, path):
                        continue
                    lin = get_path(blk, path)
                    wq = self.w_qdq(lin['w'], lin.get('clip_up'),
                                    lin.get('clip_low'))
                    blk = set_path(blk, path, dict(lin, w=wq))
                self.model.set_block(b, blk)


def _expand_ranges(items):
    out = []
    for it in items:
        s = str(it)
        if '-' in s and s.replace('-', '').isdigit():
            a, b = s.split('-')
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(it))
    return out
