"""Carry weights from numpy trees (for example the JAX package's params,
``jax.tree.map(np.asarray, model.params)``) onto the port's params.

Packed 4-bit ``qweight`` bytes become ``torch.uint8`` by reinterpretation
of the bytes (``.view(np.uint8)``), never by a value cast: a packed nibble
byte is unsigned in the port.  A bits=8 ``qweight`` and the companion
``qweight8`` are signed int8 codes and keep their sign.  bfloat16 arrays
from ``ml_dtypes``, which ``torch.from_numpy`` refuses, go through int16
and are viewed back as ``torch.bfloat16``; ``ml_dtypes`` float8 arrays
(the codes of an FP8-block checkpoint) go through uint8 the same way.
``params_to_numpy`` is the way back, for comparisons.  Both map every
leaf of any tree, so the generalized graph's extra trees (the norms'
biases, q/k norms, Gemma2's sandwich norms, learned positions, Bloom's
embedding LayerNorm) carry over as the Llama ones do, and so do OPT's
native tree (its absent projections stay ``None``) and its generalized
view, and the VLM trees (the towers' ``patch_proj``, ``merger``, ``ls1`` /
``ls2`` and full-width ``q_norm``, the projectors, ``image_newline``, the
resampler), whose Python scalars (the resampler's ``num_heads``) stay as
they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .utils.device import resolve_device


# ml_dtypes float8 names -> the torch type with the same bits
_FLOAT8 = {'float8_e4m3fn': torch.float8_e4m3fn,
           'float8_e5m2': torch.float8_e5m2}


def tensor_from_numpy(a, device: torch.device, dtype=None,
                      packed: bool = False) -> torch.Tensor:
    a = np.array(a)   # a writable copy: torch does not alias the source
    if packed and a.dtype == np.int8:
        a = a.view(np.uint8)
    if a.dtype.name == 'bfloat16':   # ml_dtypes, detected by name
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name in _FLOAT8:
        t = torch.from_numpy(a.view(np.uint8)).view(_FLOAT8[a.dtype.name])
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None,
                      qmap=None, bits: Optional[int] = None):
    """Map a nested dict/list tree of numpy arrays onto tensors on
    ``device`` (``None``: the CUDA device).  ``dtype`` casts the floating
    leaves; integer leaves keep their type.

    An int8 ``qweight`` is reinterpreted as unsigned nibble bytes only
    when its weight has 4 bits; with 8 bits it is a signed code and keeps
    its sign, as ``qweight8`` always does.  The shapes cannot tell the two
    apart, so the bits come from ``qmap`` (the serving QMap: the entry of
    the linear's path, ``lm_head`` or a block path such as
    ``self_attn.qkv_proj``), else from ``bits`` for every linear.  An int8
    ``qweight`` with neither raises."""
    dev = resolve_device(device)

    def nibble_bytes(path):
        qc = qmap.get(path) if qmap is not None else None
        if qc is not None and getattr(qc, 'qmeta', None) is not None:
            return int(qc.qmeta.bits) == 4
        if bits is None:
            raise ValueError(
                f'{path}.qweight is int8: 4-bit nibble bytes or signed '
                f'8-bit codes?  Pass qmap= or bits=')
        return int(bits) == 4

    def rec(node, path=()):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, ()) for v in node]   # a block: paths restart
        if isinstance(node, (int, float)):
            return node
        packed = (path[-1:] == ('qweight',) and np.asarray(node).dtype == np.int8
                  and nibble_bytes('.'.join(path[:-1])))
        return tensor_from_numpy(node, dev, dtype, packed=packed)
    return rec(tree)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host.  bfloat16 becomes float32
    (every bf16 value is one); float8 codes become ``ml_dtypes`` arrays
    of the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    for name, tt in _FLOAT8.items():
        if t.dtype == tt:
            import ml_dtypes
            return t.view(torch.uint8).numpy().view(getattr(ml_dtypes, name))
    return t.numpy()


def params_to_numpy(tree):
    """A params tree (nested dicts / lists of tensors) as numpy arrays;
    ``None`` leaves stay."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree)
    return tree
