"""Model abstraction layer (port of ``llmc_tpu/models/base.py``).

Params are nested dicts of tensors under the reference's HF-style paths;
``linear_apply`` applies one linear with its static ``LinearQcfg``
policy, in the reference's order: the QuaRot online rotation
(``pre_had``), the LLM.int8 outlier decomposition
(``a_outlier_threshold``), the activation fake-quant (``a_spec``, dynamic
or from the layer's calibrated ``a_scales`` / ``a_zeros`` with
``a_static``), then the packed weight (W4A16, W4A8 through ``a_int8``,
W8A16, the w8 companion through ``w8_alt``) or the fp weight with its
fake-quant (an unbaked ``w_spec``, with the layer's stored clip factors).
``ste`` rounds both fake-quants straight through (the training forwards
of OmniQuant, TesseraQ and NormTweaking).  ``mixed_cols`` (QUIK) keeps
the columns its linear's ``int_mask`` leaves out in floating point, in the
activation and the weight alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..quant.qspec import QuantSpec
from ..quant.quantizer import (QParams, fake_quant_act, fake_quant_act_static,
                               fake_quant_act_masked, fake_quant_weight,
                               fake_quant_weight_masked, ste_round)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LinearQcfg:
    """Static per-linear quantization behaviour (all reference fields)."""

    w_spec: Optional[QuantSpec] = None
    a_spec: Optional[QuantSpec] = None
    a_static: bool = False
    w_baked: bool = False
    w_packed: bool = False  # params hold packed codes; use kernel path
    qmeta: object = None    # ops.dequant_matmul.QMeta when w_packed
    a_int8: bool = False    # W4A8 serving
    w8_alt: bool = False    # read the w8 companion ('qweight8'/'scales8')
    a_outlier_threshold: Optional[float] = None
    pre_had: Optional[str] = None
    pre_had_dim: int = 0
    ste: bool = False
    mixed_cols: bool = False  # QUIK: params hold 'int_mask' [in_features]


def _fp_dot(p: Dict, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = matmul_f32_acc(x, w).to(x.dtype)
    if p.get('b') is not None:
        y = y + p['b']
    return y


def linear_apply(p: Dict, x: torch.Tensor,
                 qcfg: Optional[LinearQcfg] = None) -> torch.Tensor:
    """y = x @ W^T + b, HF (out_features, in_features) weight layout."""
    if qcfg is not None and qcfg.pre_had is not None:
        from ..ops.hadamard import pre_had_apply
        x = pre_had_apply(x, qcfg.pre_had, qcfg.pre_had_dim)
    round_fn = ste_round if qcfg is not None and qcfg.ste else torch.round
    int_mask = None
    if qcfg is not None and qcfg.mixed_cols:
        # QUIK: the columns the calibration chose stay fp
        int_mask = p['int_mask']
    elif qcfg is not None and qcfg.a_outlier_threshold is not None:
        # LLM.int8: the columns whose activation absmax exceeds the
        # threshold stay fp
        red = tuple(range(x.ndim - 1))
        col_max = torch.amax(torch.abs(x.to(F32)), dim=red)
        int_mask = col_max <= qcfg.a_outlier_threshold
    if int_mask is not None:
        # both activation and weight, the int qparams from the other
        # columns alone
        if qcfg.a_spec is not None:
            x = fake_quant_act_masked(qcfg.a_spec, x, int_mask)
        w = p['w']
        if qcfg.w_spec is not None and not qcfg.w_baked:
            w = fake_quant_weight_masked(qcfg.w_spec, w, int_mask)
        return _fp_dot(p, x, w)
    if qcfg is not None and qcfg.a_spec is not None:
        if qcfg.a_static:
            x = fake_quant_act_static(qcfg.a_spec, x,
                                      QParams(p['a_scales'], p['a_zeros']))
        else:
            x = fake_quant_act(qcfg.a_spec, x, round_fn=round_fn)
    if qcfg is not None and qcfg.w_packed:
        from ..ops.dequant_matmul import dequant_matmul
        if qcfg.w8_alt:   # the per-channel int8 companion copy
            y = dequant_matmul(x, p['qweight8'], p['scales8'], None,
                               qcfg.qmeta, a_int8=qcfg.a_int8)
        else:
            y = dequant_matmul(x, p['qweight'], p['scales'], p.get('zeros'),
                               qcfg.qmeta, a_int8=qcfg.a_int8)
    else:
        w = p['w']
        if qcfg is not None and qcfg.w_spec is not None and not qcfg.w_baked:
            w = fake_quant_weight(qcfg.w_spec, w, up_factor=p.get('clip_up'),
                                  low_factor=p.get('clip_low'),
                                  round_fn=round_fn)
        y = matmul_f32_acc(x, w).to(x.dtype)
    if p.get('b') is not None:
        y = y + p['b']
    return y


def matmul_f32_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T with f32 accumulation and an f32 result (the reference's
    ``preferred_element_type=F32``)."""
    return torch.matmul(x.to(F32), w.to(F32).T)


def attn_act_fq(qmap, path: str, t: torch.Tensor) -> torch.Tensor:
    """Fake-quantize an attention-internal tensor where the QMap holds a
    policy for its pseudo-path ('self_attn.matmul_1' and the like): the
    reference's quantized matmul, softmax and act-fn wrappers."""
    qc = qmap.get(path) if qmap is not None else None
    if qc is None or qc.a_spec is None:
        return t
    return fake_quant_act(qc.a_spec, t)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of the last axis,
    the lower index first among equal values, as ``jax.lax.top_k`` picks
    them (``torch.topk`` promises no order among ties, which a bf16
    router's logits often hold): the first ``k`` of a stable descending
    sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dense_route_weights(like: torch.Tensor, topi: torch.Tensor,
                        topw: torch.Tensor) -> torch.Tensor:
    """The dense [..., E] combine weights of a dense-dispatch MoE: ``topw``
    at the routed experts ``topi``, 0 elsewhere."""
    return torch.zeros_like(like).scatter(-1, topi, topw)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    # cast the normalised value to x.dtype BEFORE the weight multiply,
    # as the reference does (base.py:167-171)
    return (out.to(x.dtype) * w).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * w.to(F32)
    if b is not None:
        out = out + b.to(F32)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Subset descriptors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubsetSpec:
    """Which linears are transformed together, what feeds them."""

    name: str
    layers: Tuple[str, ...]
    prev_op: Optional[str]
    prev_kind: Optional[str]
    input_key: str
    inspect: str
    has_kwargs: bool = False
    is_mlp: bool = False
    do_trans: bool = True
    is_gqa: bool = False


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Static layout of one decoder block: subsets plus the ln/linear map."""

    subsets: Tuple[SubsetSpec, ...]
    linears: Tuple[str, ...]
    layernorms: Tuple[str, ...]
    capture_of: Tuple[Tuple[str, str], ...]

    def capture_key(self, layer: str) -> str:
        return dict(self.capture_of)[layer]


# --------------------------------------------------------------------------
# Param-tree path helpers
# --------------------------------------------------------------------------

def get_path(tree, path: str):
    cur = tree
    for part in path.split('.'):
        cur = cur[int(part)] if part.isdigit() else cur[part]
    return cur


def has_path(tree, path: str) -> bool:
    cur = tree
    for part in path.split('.'):
        if isinstance(cur, (list, tuple)):
            i = int(part) if part.isdigit() else -1
            if not (0 <= i < len(cur)):
                return False
            cur = cur[i]
        elif isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return False
    return True


def set_path(tree, path: str, value):
    """Replace the subtree at ``path``; returns a new tree sharing
    everything else."""
    parts = path.split('.')

    def rec(node, i):
        if i == len(parts):
            return value
        key = parts[i]
        if isinstance(node, (list, tuple)):
            idx = int(key)
            items = list(node)
            items[idx] = rec(items[idx], i + 1)
            return type(node)(items)
        new = dict(node)
        new[key] = rec(new[key], i + 1)
        return new

    return rec(tree, 0)
