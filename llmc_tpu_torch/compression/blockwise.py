"""Blockwise optimization engine (port of
``llmc_tpu/compression/blockwise.py``).

``BlockwiseOpt`` walks the blocks; ``BaseBlockwiseQuantization`` holds
what every quantization algorithm shares: config parsing, the per-block
capture + transform step, static activation calibration, ``deploy`` and
weight baking.  Forward hooks are ``block_apply(capture=True)`` returning
the subset inputs, module replacement is a ``QMap`` (a static per-linear
policy) plus param transforms on one tree.  The reference's ``jax.jit``
caches have no counterpart: the block functions are plain functions under
``torch.no_grad()``.  ``BlockTraining`` holds what the gradient-trained
methods share: their optimizer steps run under ``torch.enable_grad()``
inside the loop's ``no_grad``.

Ported: weight and activation quantization (dynamic, and static per
tensor), the double W4/W8 quantization (``bit: 48``) with its budgets,
the quantized-attention and act-fn pseudo-paths, the QuaRot online
rotation (``special.online_rotate``) that any method honours, and the
KV-cache quantizer of the evals (``quant.kvcache``: Naive, Kivi or SinkKV
from ``KV_REGISTRY``, as ``kv_module``).

On an offloaded model (``utils/offload.py``) ``model.blocks[i]`` uploads
block i and ``set_block`` takes it back to host memory, so every
algorithm's block step, the static act install and the weight bake hold
one block on the device at a time, with no code of their own for it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Dict, List, Optional

import torch

from ..convert import params_to_numpy
from ..models.adapter import BaseAdapter, QMap
from ..models.base import LinearQcfg, get_path, has_path, set_path
from ..quant.qspec import spec_from_config
from ..quant.quantizer import (fake_quant_act, fake_quant_weight,
                               fake_quant_weight_static,
                               fake_quant_weight_w48,
                               static_qparams_from_batches, stored_qparams)

F32 = torch.float32


class BlockwiseOpt:
    """The abstract block loop, and what ``run_pipeline`` asks of every
    algorithm: ``deploy`` (the QMap of an eval stage; None where the
    params are all that was deployed), ``kv_module`` (the evals' KV-cache
    policy) and ``bake_fake_quant_weights``."""

    kv_module = None

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

    def deploy(self, quant_format: str):
        raise NotImplementedError

    def bake_fake_quant_weights(self):
        """Nothing to bake: the params already hold what was deployed."""

    def block_forward_capture(self, block, qmap=None):
        """(outputs, {capture key: [one tensor a batch]}) of ``block``
        (the subclass's ``block_fn``) over the current inputs."""
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


def load_search_artifact(path: Optional[str], name: str):
    """A ``scales.pkl`` / ``clips.pkl`` tree of numpy arrays, as
    ``save_search_artifacts`` writes it; None without a path."""
    if not path:
        return None
    with open(os.path.join(path, name), 'rb') as f:
        return pickle.load(f)


class BaseBlockwiseQuantization(BlockwiseOpt):
    """Shared machinery of every quantization algorithm."""

    # the attributes a method reads from ``quant.special`` (``hyperparams``)
    HYPERPARAMS = ()

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.quant_config = quant_config
        self.layout = model.get_layout()
        self.block_fn = model.block_fn()
        self.inspect_fns = model.inspect_fns()
        self.set_quant_config()

    def hyperparams(self) -> Dict:
        """The values the method took from its config or its defaults."""
        return {k: getattr(self, k) for k in self.HYPERPARAMS}

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
        self.w48 = (wcfg.get('bit') == 48)
        self.w48_clamps = (None, None)
        if self.w48:
            # bit8 / bit4 sub-dicts with optional int_range and the
            # scales_bit / zeros_bit budgets; the legacy 'w4' key kept
            b8 = dict(wcfg.get('bit8', {}))
            b8.setdefault('symmetric', wcfg.get('symmetric', True))
            b8.setdefault('granularity', wcfg.get('granularity',
                                                  'per_channel'))
            b4 = dict(wcfg.get('bit4', wcfg.get(
                'w4', {'granularity': 'per_group',
                       'group_size': wcfg.get('group_size', 128)})))
            self.wspec = spec_from_config(dict(b8, bit=8))
            self.wspec4 = spec_from_config(dict(b4, bit=4))
            self.w48_clamps = (_w48_budget_clamps(b4),
                               _w48_budget_clamps(b8))
        else:
            self.wspec = spec_from_config(wcfg) if wcfg else None
            self.wspec4 = None

        acfg = qc.get('act')
        if acfg:
            self.w_only = False
            self.aspec = spec_from_config(dict(acfg))
            self.act_static = acfg.get('static', False)
            if self.act_static and self.aspec.granularity != 'per_tensor':
                raise ValueError('only per_tensor static act quant supported')
            self.quant_attn = acfg.get('quant_attn', False)
            self.quant_softmax = acfg.get('quant_softmax', False)
            self.quant_act_fn = acfg.get('quant_act_fn', False)
        else:
            self.w_only = True
            self.aspec = None
            self.act_static = False
            self.quant_attn = False
            self.quant_softmax = False
            self.quant_act_fn = False
        # the KV-cache quantizer of the fake-quant evals (a decode PPL
        # reads it); the static act flag rides along, as in the reference
        self.kv_module = None
        if 'kvcache' in qc:
            from ..serve.kvcache import KV_REGISTRY
            kvcfg = dict(qc['kvcache'])
            kvcfg['static'] = self.act_static
            self.kv_module = KV_REGISTRY[kvcfg['method']](
                kvcfg.get('quant_type', 'int-quant'), kvcfg,
                self.model.n_blocks, **kvcfg.get('special', {}))

        special = qc.get('special', {}) or {}
        self.special = special
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
        self.online_rotate = special.get('online_rotate', False)
        self.do_gqa_trans = special.get('do_gqa_trans', False)
        self.has_gqa = (getattr(self.model.cfg, 'num_key_value_heads', 1)
                        != getattr(self.model.cfg, 'num_attention_heads', 1))
        # static act qparams per (block, capture key), filled in calibration
        self.static_aqparams: Dict = {}

    # ------------------------------------------------------------------
    # fake-quant helpers
    # ------------------------------------------------------------------
    def w_qdq(self, w, up_factor=None, low_factor=None):
        if self.w48:
            c4, c8 = self.w48_clamps
            return fake_quant_weight_w48(self.wspec, self.wspec4, w,
                                         clamps8=c8, clamps4=c4)
        return fake_quant_weight(self.wspec, w, up_factor=up_factor,
                                 low_factor=low_factor)

    def a_qdq(self, a):
        return fake_quant_act(self.aspec, a)

    def layer_is_ignored(self, block_idx: int, path: str) -> bool:
        if not self.mixed_precision:
            return False
        if block_idx in self.ignored_block_ids and \
                path in self.ignored_layer_names:
            return True
        full = f'model.layers.{block_idx}.{path}'
        return full in self.ignored_special_names

    def fake_quant_qcfg(self, block_idx: int, path: str
                        ) -> Optional[LinearQcfg]:
        """The fake-quant policy of one linear (an algorithm may override
        it)."""
        if self.layer_is_ignored(block_idx, path):
            return None
        if self.w48:
            # the double quantization is no runtime w_spec: deploy() bakes
            # it into the params
            return LinearQcfg(a_spec=self.aspec, a_static=self.act_static)
        return LinearQcfg(w_spec=self.wspec, a_spec=self.aspec,
                          a_static=self.act_static)

    def _pre_had_for(self, path: str):
        """(mode, dim) of the QuaRot online rotation ``path`` needs, or
        None; any method honours ``special.online_rotate`` (GPTQ on a
        rotated checkpoint)."""
        if not self.online_rotate:
            return None
        if path.endswith('down_proj'):
            return ('full', 0)
        if path.endswith('o_proj'):
            return ('head', self.model.cfg.head_dim)
        return None

    def with_rotation(self, qc: Optional[LinearQcfg], path: str
                      ) -> Optional[LinearQcfg]:
        """``qc`` with the online rotation ``path`` needs, if any."""
        ph = self._pre_had_for(path)
        if qc is None or ph is None or qc.pre_had is not None:
            return qc
        return dataclasses.replace(qc, pre_had=ph[0], pre_had_dim=ph[1])

    def qcfg_for(self, block_idx: int, path: str) -> Optional[LinearQcfg]:
        """``fake_quant_qcfg`` with the online rotation: the single source
        for every qmap build."""
        return self.with_rotation(self.fake_quant_qcfg(block_idx, path), path)

    def transform_qmap(self) -> Optional[QMap]:
        """The QMap of the fp / 'transformed' evals: the online rotation
        alone, no quantization; None when nothing needs it."""
        entries = {}
        for p in self.layout.linears:
            ph = self._pre_had_for(p)
            if ph is not None:
                entries[p] = LinearQcfg(pre_had=ph[0], pre_had_dim=ph[1])
        return QMap(entries) if entries else None

    def install_static_act_qparams(self):
        """Write the calibrated static act qparams into each linear's
        params (``a_scales`` / ``a_zeros``), which ``linear_apply`` reads
        under ``a_static``."""
        if not self.static_aqparams:
            return
        for b in range(self.model.n_blocks):
            blk = self.model.blocks[b]
            for path in self.layout.linears:
                if not has_path(blk, path):
                    continue
                qp = self.static_aqparams.get(
                    (b, self.layout.capture_key(path)))
                if qp is None:
                    continue
                lin = dict(get_path(blk, path), a_scales=qp.scales.to(F32),
                           a_zeros=qp.zeros.to(F32))
                blk = set_path(blk, path, lin)
            self.model.set_block(b, blk)

    def act_pseudo_entries(self) -> Dict:
        """Quantized-attention and act-fn policies: the pseudo-paths the
        graphs query, '<pfx>.matmul_1' (q and k), '<pfx>.matmul_2' (probs
        and v), '<pfx>.softmax' (its input) and '<mlp>.act_fn'."""
        e = {}
        if not (self.quant_attn or self.quant_act_fn) or self.aspec is None:
            return e
        qc = LinearQcfg(a_spec=self.aspec)
        pfx = self.layout.linears[0].split('.')[0] \
            if '.' in self.layout.linears[0] else 'attention'
        if self.quant_attn:
            e[f'{pfx}.matmul_1'] = qc
            e[f'{pfx}.matmul_2'] = qc
            if self.quant_softmax:
                e[f'{pfx}.softmax'] = qc
        if self.quant_act_fn:
            has_mlp = any(p.startswith('mlp.') for p in self.layout.linears)
            e['mlp.act_fn' if has_mlp else 'act_fn'] = qc
        return e

    def fake_quant_qmap(self, block_idx: int) -> QMap:
        entries = {p: self.qcfg_for(block_idx, p)
                   for p in self.layout.linears}
        entries.update(self.act_pseudo_entries())
        return QMap(entries)

    # ------------------------------------------------------------------
    # block forward / capture
    # ------------------------------------------------------------------
    def block_forward(self, block, inputs=None, qmap=None) -> List:
        inputs = self.inputs if inputs is None else inputs
        return [self.block_fn(block, x, kw, qmap=qmap)[0]
                for x, kw in zip(inputs, self._kwargs_iter())]

    # ------------------------------------------------------------------
    # the per-block step
    # ------------------------------------------------------------------
    def block_opt(self, idx: int):
        block = self.model.blocks[idx]
        outs, feats = self.block_forward_capture(
            block, qmap=self.transform_qmap())
        if not self.quant_out:
            self.inputs = outs
        block = self.block_transform(idx, block, feats)
        if self.quant_out:
            self.inputs = self.block_forward(
                block, qmap=self.fake_quant_qmap(idx))
        self.model.set_block(idx, block)

    def block_transform(self, idx: int, block, feats):
        if self.act_static:
            self.register_static_act_qparams(idx, feats)
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

    def register_static_act_qparams(self, idx, feats):
        """Per-tensor static act qparams of each capture key, from the
        calibration batches."""
        algo = self.quant_config['act'].get('calib_algo', 'static_minmax')
        for key, batches in feats.items():
            self.static_aqparams[(idx, key)] = static_qparams_from_batches(
                self.aspec, batches, algo)

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
            qmap = self.transform_qmap() or QMap({})
        elif quant_format == 'fake_quant':
            if self.act_static:
                self.install_static_act_qparams()
            if self.w48 and not getattr(self, '_baked', False):
                self.bake_fake_quant_weights()
                self._baked = True
            per_block = [{p: self.qcfg_for(b, p)
                          for p in self.layout.linears}
                         for b in range(self.model.n_blocks)]
            if all(pb == per_block[0] for pb in per_block[1:]):
                entries = dict(per_block[0])
            else:
                # Block-dependent policies (ignored_layers.block_ids)
                # cannot live in ONE flat QMap: bake the weight qdq into
                # the params by each block's own decision, and keep only
                # the (uniform) activation policy at runtime.
                if not getattr(self, '_baked', False):
                    self.bake_fake_quant_weights()
                    self._baked = True   # save_fake must not re-bake
                entries = {}
                for p in self.layout.linears:
                    qcs = [pb[p] for pb in per_block]
                    live = [q for q in qcs if q is not None]
                    a_specs = {(q.a_spec, q.a_static) for q in live}
                    if not live or a_specs == {(None, False)}:
                        entries[p] = None    # the weight is baked
                    elif len(a_specs) == 1 and len(live) == len(qcs):
                        a_spec, a_static = next(iter(a_specs))
                        entries[p] = LinearQcfg(a_spec=a_spec,
                                                a_static=a_static)
                    else:
                        raise NotImplementedError(
                            'per-block ignored_layers combined with '
                            'activation quantization cannot be expressed '
                            'in the fake-quant eval path')
            entries.update(self.act_pseudo_entries())
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


class BakedAtDeploy(BaseBlockwiseQuantization):
    """A method that fixes each linear's quantized weight at compress time
    (GPTQ, TesseraQ, HQQ, AdaDim) and bakes it into the params at
    ``deploy('fake_quant')``, once: the runtime then quantizes only the
    activations.  By default the bake is the static qdq with the qparams
    the method stored beside the weight (``stored_qparams``)."""

    def static_w_qdq(self, lin: Dict) -> torch.Tensor:
        return fake_quant_weight_static(self.wspec, lin['w'].to(F32),
                                        stored_qparams(lin)
                                        ).to(lin['w'].dtype)

    def bake_fake_quant_weights(self):
        with torch.no_grad():
            for b in range(self.model.n_blocks):
                blk = self.model.blocks[b]
                for path in self.layout.linears:
                    if self.layer_is_ignored(b, path):
                        continue
                    lin = get_path(blk, path)
                    if 'gptq_scales' in lin:
                        blk = set_path(blk, path,
                                       dict(lin, w=self.static_w_qdq(lin)))
                self.model.set_block(b, blk)

    def fake_quant_qcfg(self, block_idx, path):
        if self.layer_is_ignored(block_idx, path):
            return None
        if getattr(self, '_baked', False):
            return LinearQcfg(a_spec=self.aspec)
        return LinearQcfg(w_spec=self.wspec, a_spec=self.aspec)

    def deploy(self, quant_format):
        if quant_format == 'fake_quant':
            if not getattr(self, '_baked', False):
                self.bake_fake_quant_weights()
            self._baked = True
        return super().deploy(quant_format)


class BlockTraining(BaseBlockwiseQuantization):
    """What the gradient-trained methods (OmniQuant, TesseraQ,
    NormTweaking) share: the block's own calibration inputs
    (``block_inputs``) and its fp outputs on them as targets, one optimizer
    step on the f32 MSE of the block's output against them, and a record
    of the training (``train_stats``: steps, their seconds, and the loss
    before and after training at the first, the middle and the last block,
    ``records_loss``).

    The reference trains on ``self.inputs``, which its ``block_opt`` has
    already replaced by the block's outputs: block i learns on block i+1's
    inputs (ROADMAP C).  The port trains each block on its own."""

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        self.block_inputs = self.inputs
        self.captured_outs = None
        self.train_stats = {'steps': 0, 'train_s': 0.0, 'block_loss': {}}

    def block_opt(self, idx: int):
        self.block_inputs = self.inputs
        super().block_opt(idx)

    def block_forward_capture(self, block, qmap=None):
        outs, feats = super().block_forward_capture(block, qmap)
        # the fp block's outputs on its own inputs, unless a rotation ran
        self.captured_outs = outs if qmap is None else None
        return outs, feats

    def fp_targets(self, block, changed: bool = False) -> List:
        """The fp outputs of ``block`` on its own inputs: the capture
        pass's, unless the method ``changed`` the block since (TesseraQ's
        clip) or the capture ran an online rotation, as the reference's
        targets never do."""
        if self.captured_outs is not None and not changed:
            return self.captured_outs
        return self.block_forward(block, inputs=self.block_inputs)

    def records_loss(self, idx: int) -> bool:
        """Whether block ``idx``'s loss before and after training is
        recorded (two more forwards over the calibration set): the first,
        the middle and the last block."""
        n = self.model.n_blocks
        return idx in (0, n // 2, n - 1)

    @staticmethod
    def mse(y: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.mean((y.to(F32) - target.to(F32)) ** 2)

    def mean_loss(self, block, qmap, targets) -> float:
        """The MSE of ``block`` under ``qmap`` over every calibration
        batch (no gradient)."""
        outs = self.block_forward(block, inputs=self.block_inputs, qmap=qmap)
        return sum(float(self.mse(y, t)) for y, t in zip(outs, targets)) \
            / len(targets)

    def train_step(self, opt, loss_fn, *args) -> bool:
        """One step of ``opt`` on ``loss_fn(*args)``; returns whether the
        loss was finite (the reference reads it after the update and stops
        the epoch's loop at a non-finite one)."""
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(*args)
            loss.backward()
        opt.step()
        finite = bool(torch.isfinite(loss))
        self.train_stats['steps'] += 1
        self.train_stats['train_s'] += time.perf_counter() - t0
        return finite


def channel_absmax(batches) -> torch.Tensor:
    """The largest |x| of each input channel (the last axis) over every
    batch of captured activations, in f32."""
    out = None
    for x in batches:
        m = torch.amax(torch.abs(x.to(F32)).reshape(-1, x.shape[-1]), dim=0)
        out = m if out is None else torch.maximum(out, m)
    return out


def _w48_budget_clamps(cfg: dict):
    """(scale_min, scale_max, zero_min, zero_max) from a Weight48
    sub-spec's scales_bit / zeros_bit budgets; None keeps a default.  As
    in the reference, the zeros' bounds come from scales_bit too."""
    if 'scales_bit' not in cfg and 'zeros_bit' not in cfg:
        return None
    smin = smax = zmin = zmax = None
    if 'scales_bit' in cfg:
        sb = int(cfg['scales_bit'])
        if cfg.get('scales_symmetric', True):
            smin, smax = float(-(2 ** (sb - 1))), float(2 ** (sb - 1) - 1)
        else:
            smin, smax = 0.0, float(2 ** sb - 1)
    if 'zeros_bit' in cfg:
        sb = int(cfg.get('scales_bit', cfg['zeros_bit']))
        if cfg.get('zeros_symmetric', True):
            zmin, zmax = float(-(2 ** (sb - 1))), float(2 ** (sb - 1) - 1)
        else:
            zmin, zmax = 0.0, float(2 ** sb - 1)
    return (smin, smax, zmin, zmax)


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
