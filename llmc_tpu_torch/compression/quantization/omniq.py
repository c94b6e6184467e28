"""OmniQuant (port of ``llmc_tpu/compression/quantization/omniq.py``):
per block, gradient training of the learnable weight clips (LWC: an
``up`` and a ``low`` factor per group or channel, 4.0 at first, that
shrink the minmax range through a sigmoid) and the learnable equivalent
transforms (LET: a smoothing scale per subset, from
``a_max ** alpha / w_max ** (1 - alpha)``, and a q/k scale where q and k
have one shape).  One AdamW with a group each for the clips and the
transforms (``lwc_lr``, ``let_lr``, ``weight_decay=wd``) trains them on the
MSE of the fake-quantized block's output against the fp block's, under
straight-through rounding; the trained transforms and clips are then
baked into the block.  ``search_scale_init`` / ``search_clip_init`` start
from a two-stage pipeline's ``scales.pkl`` / ``clips.pkl``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ...models.adapter import QMap
from ...models.base import LinearQcfg, get_path, set_path
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BlockTraining, load_search_artifact
from ..transforms import scale_fc_fc, scale_ln_fcs

F32 = torch.float32


def _trunc(s: torch.Tensor) -> torch.Tensor:
    """A scale nearer 0 than 1e-2 moved out to +-1e-2 (0 to +1e-2)."""
    return torch.where(torch.abs(s) < 1e-2,
                       1e-2 * torch.sign(s) + (s == 0).to(s.dtype) * 1e-2,
                       s)


@ALGO_REGISTRY.register(name='OmniQuant')
class OmniQuant(BlockTraining):
    HYPERPARAMS = ('lwc', 'let', 'epochs', 'lwc_lr', 'let_lr', 'wd', 'alpha')

    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        self.lwc = sp.get('lwc', True)
        self.let = sp.get('let', False)
        self.epochs = int(sp.get('epochs', 20))
        self.lwc_lr = float(sp.get('lwc_lr', 1e-2))
        self.let_lr = float(sp.get('let_lr', 5e-3))
        self.wd = float(sp.get('wd', 0.0))
        self.alpha = float(sp.get('alpha', 0.5))
        self.loaded_scales = load_search_artifact(
            sp.get('scale_path'), 'scales.pkl') \
            if sp.get('search_scale_init') else None
        self.loaded_clips = load_search_artifact(
            sp.get('clip_path'), 'clips.pkl') \
            if sp.get('search_clip_init') else None

    # ------------------------------------------------------------------
    def init_theta(self, idx: int, block, feats) -> Dict:
        theta = {'lwc': {}, 'let': {}}
        spec = self.wspec
        dev = self.model.device

        def loaded(a, shape):
            return torch.as_tensor(a, dtype=F32, device=dev).reshape(shape)

        if self.lwc:
            clips = (self.loaded_clips or {}).get(idx, {})
            for path in self.layout.linears:
                oc, ic = get_path(block, path)['w'].shape
                dim = oc * (-(-ic // spec.group_size)) \
                    if spec.granularity == 'per_group' else oc
                up = torch.full((dim, 1), 4.0, dtype=F32, device=dev)
                low = None if spec.symmetric else \
                    torch.full((dim, 1), 4.0, dtype=F32, device=dev)
                kup = f'{path}.weight_quantizer.upbound_factor'
                if clips.get(kup) is not None:
                    up = loaded(clips[kup], (dim, 1))
                klo = f'{path}.weight_quantizer.lowbound_factor'
                if clips.get(klo) is not None:
                    low = loaded(clips[klo], (dim, 1))
                theta['lwc'][path] = {'up': up, 'low': low}
        if self.let:
            for ss in self.layout.subsets:
                if not ss.do_trans:
                    continue
                if ss.prev_kind == 'fc' and \
                        get_path(block, ss.prev_op)['w'].shape[0] != \
                        get_path(block, ss.layers[0])['w'].shape[1]:
                    continue  # GQA o_proj: no LET
                a_max = None
                for x in feats[ss.input_key]:
                    m = torch.amax(torch.abs(x.to(F32)).reshape(
                        -1, x.shape[-1]), dim=0)
                    a_max = m if a_max is None else torch.maximum(a_max, m)
                w_max = None
                for p in ss.layers:
                    m = torch.amax(torch.abs(get_path(block, p)['w']
                                             .to(F32)), dim=0)
                    w_max = m if w_max is None else torch.maximum(w_max, m)
                s0 = (torch.clamp(a_max, min=1e-5) ** self.alpha
                      / torch.clamp(w_max, min=1e-5) ** (1 - self.alpha))
                s0 = torch.clamp(s0, min=1e-2)
                got = (self.loaded_scales or {}).get(
                    f'model.layers.{idx}.{ss.layers[0]}')
                if got is not None:
                    s0 = loaded(got, (-1,))
                theta['let'][ss.name] = {'scale': s0}
            # q rows / s, k rows * s: exact on q k^T, where q and k have
            # one shape (no GQA)
            qw = get_path(block, 'self_attn.q_proj')['w']
            if qw.shape == get_path(block, 'self_attn.k_proj')['w'].shape:
                theta['let']['qkt'] = {'scale': torch.ones(
                    (qw.shape[0],), dtype=F32, device=dev)}
        return theta

    # ------------------------------------------------------------------
    def apply_theta(self, block, theta, truncate: bool = True):
        """The block transformed by the LET scales, its linears holding
        the LWC factors (``clip_up`` / ``clip_low``)."""
        def scale(t):
            return _trunc(t['scale']) if truncate else t['scale']

        qkt = theta['let'].get('qkt')
        if qkt is not None:
            s = scale(qkt)
            q = dict(get_path(block, 'self_attn.q_proj'))
            k = dict(get_path(block, 'self_attn.k_proj'))
            q['w'] = q['w'] / s[:, None].to(q['w'].dtype)
            if q.get('b') is not None:
                q['b'] = q['b'] / s.to(q['b'].dtype)
            k['w'] = k['w'] * s[:, None].to(k['w'].dtype)
            if k.get('b') is not None:
                k['b'] = k['b'] * s.to(k['b'].dtype)
            block = set_path(block, 'self_attn.q_proj', q)
            block = set_path(block, 'self_attn.k_proj', k)
        for ss in self.layout.subsets:
            let = theta['let'].get(ss.name)
            if let is None:
                continue
            s = scale(let)
            if ss.prev_kind == 'ln':
                ln, fcs = scale_ln_fcs(
                    get_path(block, ss.prev_op),
                    [get_path(block, p) for p in ss.layers], s)
                block = set_path(block, ss.prev_op, ln)
                for p, fc in zip(ss.layers, fcs):
                    block = set_path(block, p, fc)
            else:
                fc1, fc2 = scale_fc_fc(get_path(block, ss.prev_op),
                                       get_path(block, ss.layers[0]), s)
                block = set_path(block, ss.prev_op, fc1)
                block = set_path(block, ss.layers[0], fc2)
        for path, clip in theta['lwc'].items():
            lin = dict(get_path(block, path), clip_up=clip['up'])
            if clip['low'] is not None:
                lin['clip_low'] = clip['low']
            block = set_path(block, path, lin)
        return block

    def train_qmap(self) -> QMap:
        wspec = self.wspec.replace(calib_algo='learnable')
        return QMap({p: LinearQcfg(w_spec=wspec, a_spec=self.aspec,
                                   ste=True)
                     for p in self.layout.linears})

    # ------------------------------------------------------------------
    def block_transform(self, idx, block, feats):
        theta = self.init_theta(idx, block, feats)
        if not theta['lwc'] and not theta['let']:
            return block
        leaves = {k: [t for d in theta[k].values() for t in d.values()
                      if t is not None] for k in ('lwc', 'let')}
        for t in leaves['lwc'] + leaves['let']:
            t.requires_grad_()
        qmap = self.train_qmap()
        kwargs_list = self._kwargs_iter()
        fp_outs = self.fp_targets(block)
        lrs = {'lwc': self.lwc_lr, 'let': self.let_lr}
        opt = torch.optim.AdamW(
            [{'params': leaves[k], 'lr': lrs[k]} for k in ('lwc', 'let')
             if leaves[k]], weight_decay=self.wd)

        def loss_fn(x, kw, target):
            y = self.block_fn(self.apply_theta(block, theta), x, kw,
                              qmap=qmap)[0]
            return self.mse(y, target)

        rec = self.records_loss(idx)
        before = self.mean_loss(self.apply_theta(block, theta), qmap,
                                fp_outs) if rec else None
        for _ in range(self.epochs):
            for i, x in enumerate(self.block_inputs):
                if not self.train_step(opt, loss_fn, x, kwargs_list[i],
                                       fp_outs[i]):
                    break
        for t in leaves['lwc'] + leaves['let']:
            t.requires_grad_(False)
        block = self.apply_theta(block, theta)
        if rec:
            self.train_stats['block_loss'][idx] = (
                before, self.mean_loss(block, qmap, fp_outs))
        return block

    def subset_transform(self, idx, block, subset, feats):
        return block  # the training runs in block_transform
