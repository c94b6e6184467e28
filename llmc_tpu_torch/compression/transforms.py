"""Equivalent-transform primitives on param trees (port of
``llmc_tpu/compression/transforms.py``).

A linear is ``{'w': [out, in], 'b': [out] | None}`` and a norm is
``{'w': [d], 'b': optional}``; every function returns new dicts.  The
scaling math runs in float32; rotations, LN fusion and mean removal run in
float64 (torch has real f64 on the CPU and on the card, so they stay on
the tensor's device).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

F32 = torch.float32
F64 = torch.float64


def _cast_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x.to(ref.dtype)


def repeat_gqa_scales(scales: torch.Tensor, num_kv_heads: int,
                      num_groups: int) -> torch.Tensor:
    """kv-dim scales -> q-dim scales by a per-head repeat."""
    s = scales.reshape(num_kv_heads, -1)
    return torch.repeat_interleave(s, num_groups, dim=0).reshape(-1)


def scale_fc_fc(fc1: Dict, fc2: Dict, scales: torch.Tensor,
                gqa_repeat: Optional[Tuple[int, int]] = None
                ) -> Tuple[Dict, Dict]:
    """fc1 rows /= s; fc2 cols *= s.  ``gqa_repeat=(num_kv_heads,
    num_groups)`` handles fc1.out != fc2.in (v_proj -> o_proj under GQA)."""
    s = scales.to(F32).reshape(-1)
    w1 = fc1['w'].to(F32) / s[:, None]
    out1 = dict(fc1, w=_cast_like(w1, fc1['w']))
    if fc1.get('b') is not None:
        out1['b'] = _cast_like(fc1['b'].to(F32) / s, fc1['b'])
    s2 = s
    if gqa_repeat is not None and fc1['w'].shape[0] != fc2['w'].shape[1]:
        s2 = repeat_gqa_scales(s, *gqa_repeat)
    w2 = fc2['w'].to(F32) * s2[None, :]
    return out1, dict(fc2, w=_cast_like(w2, fc2['w']))


def scale_ln_fcs(ln: Dict, fcs: List[Dict], scales: torch.Tensor
                 ) -> Tuple[Dict, List[Dict]]:
    """ln params /= s; every fc's columns *= s."""
    s = scales.to(F32).reshape(-1)
    new_ln = dict(ln, w=_cast_like(ln['w'].to(F32) / s, ln['w']))
    if ln.get('b') is not None:
        new_ln['b'] = _cast_like(ln['b'].to(F32) / s, ln['b'])
    new_fcs = []
    for fc in fcs:
        w = fc['w'].to(F32) * s[None, :]
        new_fcs.append(dict(fc, w=_cast_like(w, fc['w'])))
    return new_ln, new_fcs


def shift_fc_fc(fc1: Dict, fc2: Dict, shifts: torch.Tensor
                ) -> Tuple[Dict, Dict]:
    """fc1 bias -= shift; fc2 bias += W2 @ shift."""
    sh = shifts.to(F32)
    out1 = dict(fc1)
    if fc1.get('b') is not None:
        out1['b'] = _cast_like(fc1['b'].to(F32) - sh, fc1['b'])
    comp = torch.mv(fc2['w'].to(F32), sh)
    b2 = fc2['b'].to(F32) + comp if fc2.get('b') is not None else comp
    return out1, dict(fc2, b=_cast_like(b2, fc2['w']))


def shift_ln_fcs(ln: Dict, fcs: List[Dict], shifts: torch.Tensor,
                 ln_has_bias: bool) -> Tuple[Dict, List[Dict]]:
    """ln bias -= shift; each fc bias += W @ shift."""
    sh = shifts.to(F32)
    new_ln = dict(ln)
    if ln_has_bias and ln.get('b') is not None:
        new_ln['b'] = _cast_like(ln['b'].to(F32) - sh, ln['b'])
    new_fcs = []
    for fc in fcs:
        comp = torch.mv(fc['w'].to(F32), sh)
        b = fc['b'].to(F32) + comp if fc.get('b') is not None else comp
        new_fcs.append(dict(fc, b=_cast_like(b, fc['w'])))
    return new_ln, new_fcs


def fuse_ln_fcs(ln: Dict, fcs: List[Dict]) -> Tuple[Dict, List[Dict]]:
    """Fold the LN weight (and bias) into the following fcs, in float64;
    the LN becomes weightless."""
    lw = ln['w'].to(F64)
    lb = ln.get('b')
    new_fcs = []
    for fc in fcs:
        w = fc['w'].to(F64)
        new_fc = dict(fc, w=_cast_like(w * lw[None, :], fc['w']))
        if lb is not None:
            b0 = fc['b'].to(F64) if fc.get('b') is not None else 0.0
            new_fc['b'] = _cast_like(b0 + torch.mv(w, lb.to(F64)), fc['w'])
        new_fcs.append(new_fc)
    new_ln = dict(ln, w=torch.ones_like(ln['w']))
    if lb is not None:
        new_ln['b'] = torch.zeros_like(ln['b'])
    return new_ln, new_fcs


def rotate_pre_layer(fc: Dict, Q: torch.Tensor) -> Dict:
    """W <- W @ Q (input-side rotation, float64)."""
    w = fc['w'].to(F64) @ Q.to(F64)
    return dict(fc, w=_cast_like(w, fc['w']))


def rotate_post_layer(fc: Dict, Q: torch.Tensor) -> Dict:
    """W <- Q^T @ W, b <- Q^T b (output-side rotation, float64)."""
    qt = Q.to(F64).T
    out = dict(fc, w=_cast_like(qt @ fc['w'].to(F64), fc['w']))
    if fc.get('b') is not None:
        out['b'] = _cast_like(torch.mv(qt, fc['b'].to(F64)), fc['b'])
    return out


def rotate_embedding(embed: Dict, Q: torch.Tensor) -> Dict:
    """E <- E @ Q (float64)."""
    w = embed['w'].to(F64) @ Q.to(F64)
    return dict(embed, w=_cast_like(w, embed['w']))


def remove_mean_from_embed(embed: Dict) -> Dict:
    w = embed['w'].to(F64)
    return dict(embed, w=_cast_like(w - w.mean(dim=-1, keepdim=True),
                                    embed['w']))


def bake_mean_into_fc(fc: Dict) -> Dict:
    """Subtract the per-column mean of W (and the mean of b); pairs with
    ``remove_mean_from_embed`` for rotation-based methods."""
    w = fc['w'].to(F64)
    out = dict(fc, w=_cast_like(w - w.mean(dim=0, keepdim=True), fc['w']))
    if fc.get('b') is not None:
        b = fc['b'].to(F64)
        out['b'] = _cast_like(b - b.mean(), fc['b'])
    return out
