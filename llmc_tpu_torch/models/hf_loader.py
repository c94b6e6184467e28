"""HuggingFace checkpoint ingestion (port of
``llmc_tpu/models/hf_loader.py``): safetensors -> the params tree, and
back.

FP8-block checkpoints (an e4m3 ``weight`` beside a ``weight_scale_inv``
with one f32 inverse scale per block) are dequantized on load by
``quant.fp8_block.weight_cast_to_bf16``; the block size follows from the
two shapes.  ``safetensors`` is imported inside the functions, so the
package imports without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from ..quant.fp8_block import weight_cast_to_bf16

F32 = torch.float32


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, 'config.json')) as f:
        return json.load(f)


def _iter_safetensor_files(path: str):
    idx = os.path.join(path, 'model.safetensors.index.json')
    if os.path.exists(idx):
        with open(idx) as f:
            index = json.load(f)
        for fname in sorted(set(index['weight_map'].values())):
            yield os.path.join(path, fname)
    else:
        single = os.path.join(path, 'model.safetensors')
        if not os.path.exists(single):
            raise FileNotFoundError(f'no safetensors found under {path}')
        yield single


def _ingest_fp8(w: torch.Tensor, scale_inv: torch.Tensor) -> torch.Tensor:
    """(e4m3 codes, weight_scale_inv) -> f32 weight; the block size is
    what the two shapes imply."""
    bs = -(-w.shape[0] // scale_inv.shape[0])
    return weight_cast_to_bf16(w, scale_inv, block_size=bs, dtype=F32)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is not None and t.dtype in (torch.float16, torch.float32,
                                         torch.bfloat16, torch.float64):
        return t.to(dtype)
    return t


class LazyHFTensors:
    """Lazy {hf_name: tensor} view over a (sharded) safetensors
    checkpoint: one tensor is read per access, straight from its shard, so
    peak host memory while a params tree is assembled is the tree plus one
    tensor.  Stands in for the flat dict ``llama_params_from_hf`` takes
    (``[]``, ``.get``, ``in``, ``.keys``).  FP8-block pairs are dequantized
    on access.  Tensors come back on the CPU."""

    def __init__(self, path: str, dtype=torch.bfloat16):
        self.path = path
        self.dtype = dtype
        self._name_to_file: Dict[str, str] = {}
        idx = os.path.join(path, 'model.safetensors.index.json')
        if os.path.exists(idx):
            with open(idx) as f:
                index = json.load(f)
            self._name_to_file = dict(index['weight_map'])
            self.total_size = int(
                index.get('metadata', {}).get('total_size', 0))
        else:
            single = os.path.join(path, 'model.safetensors')
            if not os.path.exists(single):
                raise FileNotFoundError(
                    f'no safetensors found under {path}')
            from safetensors import safe_open
            with safe_open(single, framework='pt') as f:
                for name in f.keys():
                    self._name_to_file[name] = 'model.safetensors'
            self.total_size = os.path.getsize(single)

    def keys(self):
        return self._name_to_file.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._name_to_file

    def _raw(self, name: str) -> torch.Tensor:
        from safetensors import safe_open
        fpath = os.path.join(self.path, self._name_to_file[name])
        with safe_open(fpath, framework='pt') as f:
            return f.get_tensor(name)

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._name_to_file:
            raise KeyError(name)
        if name.endswith('weight_scale_inv'):
            raise KeyError(f'{name}: consumed by its weight pair')
        t = self._raw(name)
        sn = name + '_scale_inv'
        if name.endswith('weight') and sn in self._name_to_file:
            t = _ingest_fp8(t, self._raw(sn))
        return _cast(t, self.dtype)

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default


def load_hf_tensors(path: str, dtype=torch.bfloat16,
                    device='cpu') -> Dict[str, torch.Tensor]:
    """Flat {hf_name: tensor} on ``device``; floating tensors are cast to
    ``dtype``, FP8-block weights dequantized with their
    ``weight_scale_inv``."""
    from safetensors import safe_open
    out = {}
    for fpath in _iter_safetensor_files(path):
        with safe_open(fpath, framework='pt') as f:
            for name in f.keys():
                out[name] = f.get_tensor(name).to(device)
    for sn in [n for n in out if n.endswith('weight_scale_inv')]:
        wn = sn.replace('_scale_inv', '')
        out[wn] = _ingest_fp8(out[wn], out.pop(sn))
    return {name: _cast(t, dtype) for name, t in out.items()}


def hf_linear(flat, prefix: str) -> Dict:
    """An HF linear's weight and bias (None where it has none)."""
    return {'w': flat[f'{prefix}.weight'], 'b': flat.get(f'{prefix}.bias')}


def hf_norm(flat, prefix: str) -> Dict:
    """An HF norm's weight, with its bias where it has one (a
    LayerNorm's)."""
    p = {'w': flat[f'{prefix}.weight']}
    if flat.get(f'{prefix}.bias') is not None:
        p['b'] = flat[f'{prefix}.bias']
    return p


def hf_attention(flat, b: str) -> Dict:
    """The q/k/v/o projections of HF block ``b`` (Llama's names)."""
    return {n: hf_linear(flat, f'{b}.self_attn.{n}')
            for n in ('q_proj', 'k_proj', 'v_proj', 'o_proj')}


def llama_params_from_hf(flat, num_layers: int, tie_embeddings: bool) -> Dict:
    """Map HF Llama names (the canonical namespace every family's adapter
    renames its checkpoint into) onto the params tree: the norms' biases
    (LayerNorm families), the gate where the MLP has one, the
    post-attention norm where the block has one, Gemma2's sandwich norms,
    Qwen3's q/k norms, learned position embeddings (Starcoder) and Bloom's
    embedding LayerNorm."""
    def lin(prefix: str) -> Dict:
        return hf_linear(flat, prefix)

    def ln(prefix: str) -> Dict:
        p = {'w': flat[f'{prefix}.weight']}
        b = flat.get(f'{prefix}.bias')
        if b is not None:
            p['b'] = b
        return p

    blocks = []
    for i in range(num_layers):
        b = f'model.layers.{i}'
        blk = {'input_layernorm': ln(f'{b}.input_layernorm'),
               'self_attn': hf_attention(flat, b),
               'mlp': {'up_proj': lin(f'{b}.mlp.up_proj'),
                       'down_proj': lin(f'{b}.mlp.down_proj')}}
        if f'{b}.mlp.gate_proj.weight' in flat:
            blk['mlp']['gate_proj'] = lin(f'{b}.mlp.gate_proj')
        for norm in ('post_attention_layernorm', 'pre_feedforward_layernorm',
                     'post_feedforward_layernorm'):
            if f'{b}.{norm}.weight' in flat:
                blk[norm] = ln(f'{b}.{norm}')
        if f'{b}.self_attn.q_norm.weight' in flat:
            for norm in ('q_norm', 'k_norm'):
                blk['self_attn'][norm] = {
                    'w': flat[f'{b}.self_attn.{norm}.weight']}
        blocks.append(blk)
    params = {
        'embed_tokens': {'w': flat['model.embed_tokens.weight']},
        'blocks': blocks,
        'norm': ln('model.norm'),
    }
    if 'model.embed_positions.weight' in flat:
        params['embed_positions'] = {'w': flat['model.embed_positions.weight']}
    if 'model.embed_layernorm.weight' in flat:
        params['embed_layernorm'] = ln('model.embed_layernorm')
    if not tie_embeddings:
        lm = flat.get('lm_head.weight')
        if lm is None:  # some checkpoints tie without the flag
            params['lm_head'] = {'w': flat['model.embed_tokens.weight'],
                                 'b': None}
        else:
            params['lm_head'] = {'w': lm, 'b': flat.get('lm_head.bias')}
    return params


def save_llama_params_to_hf(params: Dict, path: str,
                            hf_config: Optional[dict] = None) -> None:
    """Write params back out as an HF-style safetensors checkpoint in the
    canonical namespace (the ``save_trans`` / ``save_fake`` output), with
    every norm's bias, the sandwich and q/k norms, the learned positions
    and the embedding LayerNorm where the tree holds them; the block
    entries it lacks (a gate, a post-attention norm) are left out.  Each
    tensor is copied to the host as it is gathered, so an offloaded model's
    blocks (uploaded one at a time as they are read) never sit on the
    device together."""
    flat = {}

    def put(name, t):
        if t is not None:
            flat[name] = t.detach().to('cpu')

    def put_tree(prefix, p):
        put(f'{prefix}.weight', p['w'])
        put(f'{prefix}.bias', p.get('b'))

    put_tree('model.embed_tokens', params['embed_tokens'])
    put_tree('model.norm', params['norm'])
    for name in ('embed_positions', 'embed_layernorm'):
        if name in params:
            put_tree(f'model.{name}', params[name])
    if 'lm_head' in params:
        put_tree('lm_head', params['lm_head'])
    for i, blk in enumerate(params['blocks']):
        b = f'model.layers.{i}'
        for norm in ('input_layernorm', 'post_attention_layernorm',
                     'pre_feedforward_layernorm',
                     'post_feedforward_layernorm'):
            if norm in blk:
                put_tree(f'{b}.{norm}', blk[norm])
        for part, names in (('self_attn', ('q_proj', 'k_proj', 'v_proj',
                                           'o_proj', 'q_norm', 'k_norm')),
                            ('mlp', ('gate_proj', 'up_proj', 'down_proj'))):
            for name in names:
                if name in blk[part]:
                    put_tree(f'{b}.{part}.{name}', blk[part][name])
    save_flat_to_hf(flat, path, hf_config)


def save_flat_to_hf(flat: Dict, path: str,
                    hf_config: Optional[dict] = None) -> None:
    """Write flat named tensors as ``model.safetensors`` (host copies)
    beside ``config.json`` from ``hf_config``."""
    from safetensors.torch import save_file
    os.makedirs(path, exist_ok=True)
    save_file({n: t.detach().to('cpu').contiguous()
               for n, t in flat.items()},
              os.path.join(path, 'model.safetensors'))
    if hf_config is not None:
        with open(os.path.join(path, 'config.json'), 'w') as f:
            json.dump(hf_config, f, indent=2)
