"""Model adapters (port of ``llmc_tpu/models/adapter.py:54-286`` and
``build_model``): the protocol the compression engine and the evals
consume.

``QMap`` maps linear paths to their static ``LinearQcfg``.  The adapter
is an ``nn.Module`` because it owns the params: a nested dict of tensors
under the reference's HF-style paths (not registered ``nn.Parameter``s,
so the converter stays a tree map).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..utils.device import resolve_device, tree_device
from ..utils.registry import MODEL_REGISTRY
from . import deepseek as DS
from . import llama as L
from . import mixtral as MX
from . import qwen2moe as QM
from .base import BlockLayout, LinearQcfg, matmul_f32_acc, rms_norm


class QMap:
    """Hashable linear-path -> LinearQcfg policy."""

    def __init__(self, mapping: Dict[str, LinearQcfg] = None,
                 default: Optional[LinearQcfg] = None):
        self._items = tuple(sorted((mapping or {}).items()))
        self._default = default
        self._d = dict(self._items)

    def get(self, path: str) -> Optional[LinearQcfg]:
        return self._d.get(path, self._default)

    def with_(self, path: str, qcfg: LinearQcfg) -> 'QMap':
        d = dict(self._d)
        d[path] = qcfg
        return QMap(d, self._default)

    def __hash__(self):
        return hash((self._items, self._default))

    def __eq__(self, other):
        return (isinstance(other, QMap) and self._items == other._items
                and self._default == other._default)

    def __repr__(self):
        return f'QMap(default={self._default}, n={len(self._items)})'


class BaseAdapter(torch.nn.Module):
    """Common protocol of the port's adapters."""

    name = 'base'

    def __init__(self, cfg, params, tokenizer=None, hf_config=None):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.hf_config = hf_config

    @property
    def blocks(self) -> List[Dict]:
        return self.params['blocks']

    @property
    def n_blocks(self) -> int:
        return len(self.params['blocks'])

    def get_layout(self) -> BlockLayout:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return tree_device(self.params)

    def block_fn(self) -> Callable:
        """(block_params, x, kwargs, qmap, capture) -> (y, captures)."""
        raise NotImplementedError

    def inspect_fns(self) -> Dict[str, Callable]:
        raise NotImplementedError

    def embed_and_rope_p(self, params, input_ids, attention_mask=None):
        """(params, ids[, mask]) -> (x, kwargs) for block 0."""
        raise NotImplementedError

    def head_fn(self) -> Callable:
        raise NotImplementedError

    def forward_logits(self, input_ids, qmap=None):
        raise NotImplementedError

    def forward(self, input_ids, qmap=None):
        return self.forward_logits(input_ids, qmap=qmap)

    def collect_first_block_input(self, calib_batches: List[Dict]
                                  ) -> Tuple[List, List]:
        """Run the embedding (and the rope tables) over the calibration
        batches.  Returns (inputs, kwargs_list): inputs[i] is block 0's
        input, kwargs_list[i] that batch's block kwargs.  A batch's numpy
        ids go to the params' device."""
        dev = self.device
        xs, kws = [], []
        with torch.no_grad():
            for batch in calib_batches:
                ids = torch.as_tensor(batch['input_ids']).to(dev)
                mask = batch.get('attention_mask')
                if mask is not None:
                    mask = torch.as_tensor(mask).to(dev)
                x, kw = self.embed_and_rope_p(self.params, ids, mask)
                xs.append(x)
                kws.append(kw)
        return xs, kws

    def set_block(self, idx: int, new_block: Dict) -> None:
        self.params['blocks'][idx] = new_block


@MODEL_REGISTRY.register(name='Llama')
class LlamaAdapter(BaseAdapter):
    """Llama / Llama-2 / Llama-3 and GQA variants sharing the graph."""

    name = 'Llama'
    config_cls = L.LlamaConfig

    def __init__(self, cfg: L.LlamaConfig, params, tokenizer=None,
                 hf_config=None):
        L.check_ported(cfg)
        super().__init__(cfg, params, tokenizer, hf_config)
        self._layout = L.llama_layout(cfg)

    @classmethod
    def random(cls, cfg: L.LlamaConfig, seed: int = 0, device=None):
        """Random params from a ``torch.Generator`` seeded with ``seed``
        on ``device`` (``None``: the CUDA device)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, L.init_params(cfg, gen, device=dev))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16,
                        stream: Optional[bool] = None, offload: bool = False,
                        device=None):
        """Load an HF checkpoint directory onto ``device`` (``None``: the
        CUDA device).  ``stream`` reads the tensors one at a time from the
        (possibly sharded) safetensors files (default: on for a sharded
        checkpoint).  FP8-block weights are dequantized on load."""
        from .hf_loader import llama_params_from_hf, load_hf_config
        if offload:
            raise NotImplementedError(
                'offload=True (block params kept on the host) is not ported '
                'yet (ROADMAP A13)')
        hf = load_hf_config(path)
        cfg = cls.config_cls.from_hf(hf)
        params = _load_params(
            path, dtype, stream, device,
            lambda flat: llama_params_from_hf(flat, cfg.num_hidden_layers,
                                              cfg.tie_word_embeddings))
        return cls(cfg, params, _load_tokenizer(path), hf)

    @classmethod
    def from_config(cls, config, device=None):
        """Build from a framework config dict: ``model.path`` (an HF
        checkpoint directory) or ``model.arch`` (an inline architecture,
        random weights from ``model.seed``)."""
        m = config['model']
        if m.get('path'):
            return cls.from_pretrained(
                m['path'], dtype=_config_dtype(m.get('torch_dtype',
                                                     'bfloat16')),
                device=device)
        if 'arch' not in m:
            raise ValueError(
                'model.path is missing/empty; set model.path to a checkpoint '
                'or pass model.arch explicitly for a synthetic model')
        return cls.random(cls.config_cls(**dict(m['arch'])),
                          seed=int(m.get('seed', 0)), device=device)

    def get_layout(self) -> BlockLayout:
        return self._layout

    def block_fn(self):
        cfg = self.cfg

        def fn(bp, x, kw, qmap=None, capture=False):
            return L.block_apply(bp, cfg, x, kw['cos'], kw['sin'],
                                 kw.get('attn_bias'), qmap=qmap,
                                 capture=capture)
        return fn

    def inspect_fns(self):
        return L.make_inspect_fns(self.cfg)

    def embed_and_rope_p(self, params, input_ids, attention_mask=None):
        cfg = self.cfg
        x = L.embed_apply(params, cfg, input_ids)
        S = input_ids.shape[1]
        dev = input_ids.device
        if attention_mask is not None:
            # HF convention under (left) padding: positions count the
            # valid tokens only (cumsum(mask) - 1, clamped at 0)
            positions = torch.clamp(
                torch.cumsum(attention_mask, dim=-1) - 1, min=0)
        else:
            positions = torch.arange(S, device=dev)[None, :]
        cos, sin = self.rope_tables(positions)
        kw = {'cos': cos, 'sin': sin}
        if attention_mask is not None:
            # additive [B,1,S,S] bias: the padding mask plus the causal
            # mask, with a finite value so that an all-masked pad row
            # softmaxes to finite garbage, not NaN
            neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            bias = torch.where(attention_mask[:, None, None, :] > 0, zero,
                               neg)
            q_pos = torch.arange(S, device=dev)[:, None]
            k_pos = torch.arange(S, device=dev)[None, :]
            causal = torch.where(q_pos >= k_pos, zero, neg)
            kw['attn_bias'] = bias + causal[None, None]
        return x, kw

    def rope_tables(self, positions):
        """The block kwargs' cos / sin tables at ``positions``."""
        return L.rope_cos_sin(self.cfg, positions)

    def head_fn(self):
        cfg = self.cfg

        def fn(params, x):
            return L.head_apply(params, cfg, x)
        return fn

    def forward_logits(self, input_ids, qmap=None):
        return L.model_apply(self.params, self.cfg, input_ids, qmap=qmap)


class _MoEFamilyAdapter(LlamaAdapter):
    """What the MoE families' adapters share: the family module's graph,
    inspect functions, HF mapping and random init (``family``), its config
    (``config_cls``) and layout (``layout_of``).  A checkpoint loads in bf16
    whatever its ``torch_dtype``, as the reference's adapters load these
    families."""

    family = None

    def __init__(self, cfg, params, tokenizer=None, hf_config=None):
        BaseAdapter.__init__(self, cfg, params, tokenizer, hf_config)
        self._layout = self.layout_of(cfg)

    @classmethod
    def random(cls, cfg, seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, cls.family.init_params(cfg, gen, device=dev))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16,
                        stream: Optional[bool] = None, device=None):
        """Load an HF checkpoint directory onto ``device`` (``None``: the
        CUDA device); ``stream`` as in ``LlamaAdapter.from_pretrained``,
        FP8-block weights dequantized on load."""
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        cfg = cls.config_cls.from_hf(hf)
        params = _load_params(path, dtype, stream, device,
                              lambda flat: cls.family.params_from_hf(flat,
                                                                     cfg))
        return cls(cfg, params, _load_tokenizer(path), hf)

    @classmethod
    def from_config(cls, config, device=None):
        m = config['model']
        if m.get('path'):
            return cls.from_pretrained(m['path'], device=device)
        if 'arch' not in m:
            raise ValueError(
                'model.path is missing/empty; set model.path to a checkpoint '
                'or pass model.arch explicitly for a synthetic model')
        return cls.random(cls.config_cls(**dict(m['arch'])),
                          seed=int(m.get('seed', 0)), device=device)

    def block_fn(self):
        cfg, fam = self.cfg, self.family

        def fn(bp, x, kw, qmap=None, capture=False):
            return fam.block_apply(bp, cfg, x, kw['cos'], kw['sin'],
                                   kw.get('attn_bias'), qmap=qmap,
                                   capture=capture)
        return fn

    def inspect_fns(self):
        return self.family.make_inspect_fns(self.cfg)

    def forward_logits(self, input_ids, qmap=None):
        x, kw = self.embed_and_rope_p(self.params, input_ids)
        bfn = self.block_fn()
        for bp in self.blocks:
            x, _ = bfn(bp, x, kw, qmap=qmap)
        return self.head_fn()(self.params, x)


@MODEL_REGISTRY.register(name='Mixtral')
class MixtralAdapter(_MoEFamilyAdapter):
    """Mixtral sparse MoE (per-expert quantization subsets)."""

    name = 'Mixtral'
    config_cls = MX.MixtralConfig
    family = MX
    layout_of = staticmethod(MX.mixtral_layout)


@MODEL_REGISTRY.register(name='Qwen2Moe')
class Qwen2MoeAdapter(_MoEFamilyAdapter):
    """Qwen2-MoE / Qwen1.5-MoE: softmax-then-top-k routing and a gated
    shared expert, per-expert and shared-expert subsets."""

    name = 'Qwen2Moe'
    config_cls = QM.Qwen2MoeConfig
    family = QM
    layout_of = staticmethod(QM.qwen2moe_layout)


@MODEL_REGISTRY.register(name='DeepseekV2')
class DeepseekV2Adapter(_MoEFamilyAdapter):
    """DeepSeek-V2/V3: MLA and a shared-and-routed MoE.  Its rope is the
    interleaved one on the rope dims; the engine serves it through the
    absorbed latent cache (``serve/mla_decode.py``)."""

    name = 'DeepseekV2'
    config_cls = DS.DeepseekConfig
    family = DS
    layout_of = staticmethod(DS.deepseek_layout)

    def rope_tables(self, positions):
        return DS.rope_freqs(self.cfg, positions)

    def head_fn(self):
        cfg = self.cfg

        def fn(params, x):
            h = rms_norm(x, params['norm']['w'], cfg.rms_norm_eps)
            return matmul_f32_acc(h, params['lm_head']['w'])
        return fn


@MODEL_REGISTRY.register(name='DeepseekV3')
class DeepseekV3Adapter(DeepseekV2Adapter):
    name = 'DeepseekV3'


def _load_params(path: str, dtype, stream: Optional[bool], device, build):
    """``build(flat)`` over a checkpoint's tensors, on ``device`` (``None``:
    the CUDA device).  ``stream`` reads them one at a time from the
    (possibly sharded) safetensors files (default: on for a sharded
    checkpoint)."""
    from .hf_loader import LazyHFTensors, load_hf_tensors
    dev = resolve_device(device)
    if stream is None:
        stream = os.path.exists(
            os.path.join(path, 'model.safetensors.index.json'))
    if not stream:
        return build(load_hf_tensors(path, dtype=dtype, device=dev))
    return _tree_to(build(LazyHFTensors(path, dtype=dtype)), dev)


def _config_dtype(s) -> torch.dtype:
    """An HF-config dtype string ('torch.float16', 'auto', ...) as a torch
    dtype; 'auto' is float32 and fp16 maps to bf16, as in the reference."""
    s = str(s).replace('torch.', '')
    if s == 'auto':
        s = 'float32'
    if s in ('float16', 'half'):
        s = 'bfloat16'
    return getattr(torch, s)


def _load_tokenizer(path: str):
    """The checkpoint's tokenizer, or None where ``transformers`` is not
    installed or the directory holds no tokenizer files (the text
    calibration sources then have nothing to tokenize with and raise)."""
    # a model saved alone names its tokenizer class in config.json without
    # the vocab files, and the tokenizer's constructor then raises
    if not any(os.path.exists(os.path.join(path, f))
               for f in _TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    try:
        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except (OSError, ValueError):
        return None


_TOKENIZER_FILES = ('tokenizer.json', 'tokenizer_config.json',
                    'tokenizer.model', 'vocab.json')


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree if tree is None else tree.to(device)


def build_model(config, device=None) -> BaseAdapter:
    """The adapter ``config.model.type`` names, on ``device`` (``None``:
    the CUDA device)."""
    m = config['model']
    if m.get('offload'):
        raise NotImplementedError(
            'model.offload (block params kept on the host) is not ported '
            'yet (ROADMAP A13)')
    return MODEL_REGISTRY[m['type']].from_config(config, device=device)
