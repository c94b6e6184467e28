"""Model adapters (port of ``llmc_tpu/models/adapter.py``: the protocol,
the Llama-family and generalized-graph families, the MoE / MLA families,
OPT, the LLaVA tier (Llava, LlavaHf, VideoLlava), Qwen2-VL, InternVL,
LLaVA-OneVision, MiniCPM-V, ViT with its accuracy eval, and
``build_model``): the protocol the compression engine and the
evals consume.

``QMap`` maps linear paths to their static ``LinearQcfg``; ``ModalQMap``
carries a VLM tower's own QMap beside the LM's.  The adapter
is an ``nn.Module`` because it owns the params: a nested dict of tensors
under the reference's HF-style paths (not registered ``nn.Parameter``s,
so the converter stays a tree map).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, tree_device
from ..utils.offload import (HostBlocks, offload_model_blocks,
                             tree_to_device)
from ..utils.registry import MODEL_REGISTRY
from . import deepseek as DS
from . import llama as L
from . import mixtral as MX
from . import opt as O
from . import qwen2moe as QM
from . import internvl as IV
from . import llava as LV
from . import llava_onevision as OV
from . import minicpmv as MV
from . import qwen2vl as QV
from . import vit as V
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


class ModalQMap(QMap):
    """A VLM's deploy: the LM's policy (what ``get`` answers) and the
    tower's own QMap (``vision``, or None), which only the tower reads.
    The tower's block linears carry the LM's path names, so a flat QMap
    cannot keep the two apart (ROADMAP C)."""

    def __init__(self, language: Optional[QMap] = None,
                 vision: Optional[QMap] = None):
        lang = language if language is not None else QMap({})
        super().__init__(dict(lang._d), lang._default)
        self.vision = vision

    def __hash__(self):
        return hash((self._items, self._default, self.vision))

    def __eq__(self, other):
        return (isinstance(other, ModalQMap) and super().__eq__(other)
                and self.vision == other.vision)

    def __repr__(self):
        return (f'ModalQMap(language={QMap.__repr__(self)}, '
                f'vision={self.vision!r})')


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

    def save_to_hf(self, path: str) -> None:
        """Write the params (and ``hf_config``) as an HF checkpoint in the
        Llama names, the ``save_trans`` / ``save_fake`` output."""
        from .hf_loader import save_llama_params_to_hf
        save_llama_params_to_hf(self.params, path, self.hf_config)


@MODEL_REGISTRY.register(name='Llama')
class LlamaAdapter(BaseAdapter):
    """Llama / Llama-2 / Llama-3 and GQA variants sharing the graph; the
    other families' adapters below subclass it with their config, their
    checkpoint's renaming and their ``arch_defaults``."""

    name = 'Llama'
    config_cls = L.LlamaConfig

    def __init__(self, cfg: L.LlamaConfig, params, tokenizer=None,
                 hf_config=None):
        super().__init__(cfg, params, tokenizer, hf_config)
        self._layout = L.llama_layout(cfg)

    @classmethod
    def random(cls, cfg: L.LlamaConfig, seed: int = 0, device=None,
               offload: bool = False):
        """Random params from a ``torch.Generator`` seeded with ``seed``
        on ``device`` (``None``: the CUDA device).  ``offload`` moves each
        block to host memory as soon as it is drawn (the same weights: the
        generator draws in the same order), so the device never holds more
        than one block."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if not offload:
            return cls(cfg, L.init_params(cfg, gen, device=dev))
        m = cls(cfg, L.init_params(cfg, gen, device=dev,
                                   blocks=HostBlocks([], dev)))
        m.offloaded = True
        return m

    # a family's defaults under an inline ``model.arch`` (the reference's
    # ``setdefault``s in its ``from_config``)
    arch_defaults: Dict = {}

    @classmethod
    def config_from_hf(cls, hf: dict):
        """The family's config from its checkpoint's ``config.json``."""
        return cls.config_cls.from_hf(hf)

    @classmethod
    def rename_flat(cls, flat, cfg, hf: dict):
        """The checkpoint's tensors in the canonical Llama namespace
        (``model.layers.i.{self_attn,mlp,*norm}``), fused projections
        split; Llama's own names pass as they are."""
        return flat

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16,
                        stream: Optional[bool] = None, offload: bool = False,
                        device=None):
        """Load an HF checkpoint directory onto ``device`` (``None``: the
        CUDA device).  ``stream`` reads the tensors one at a time from the
        (possibly sharded) safetensors files (default: on for a sharded
        checkpoint; a family that renames its tensors reads them all).
        FP8-block weights are dequantized on load.  ``offload`` reads the
        blocks' tensors one at a time straight to host memory, where they
        stay (pinned for a CUDA device, ``utils/offload.py``): a checkpoint
        larger than the card never lands on it whole; the embedding, final
        norm and head go to ``device``."""
        from .hf_loader import llama_params_from_hf, load_hf_config
        hf = load_hf_config(path)
        cfg = cls.config_from_hf(hf)

        def build(flat):
            return llama_params_from_hf(cls.rename_flat(flat, cfg, hf),
                                        cfg.num_hidden_layers,
                                        cfg.tie_word_embeddings)
        if not offload:
            params = _load_params(path, dtype, stream, device, build)
            return cls(cfg, params, _load_tokenizer(path), hf)
        dev = resolve_device(device)
        params = _load_params(path, dtype, True, 'cpu', build)
        blocks, host = params.pop('blocks'), HostBlocks([], dev)
        for i in range(len(blocks)):   # pin one block, release its copy
            host.append(blocks[i])
            blocks[i] = None
        params = dict(tree_to_device(params, dev), blocks=host)
        m = cls(cfg, params, _load_tokenizer(path), hf)
        m.offloaded = True
        return m

    @classmethod
    def from_config(cls, config, device=None):
        """Build from a framework config dict: ``model.path`` (an HF
        checkpoint directory) or ``model.arch`` (an inline architecture
        over the family's ``arch_defaults``, random weights from
        ``model.seed``)."""
        m = config['model']
        offload = bool(m.get('offload'))
        if m.get('path'):
            return cls.from_pretrained(
                m['path'], dtype=_config_dtype(m.get('torch_dtype',
                                                     'bfloat16')),
                offload=offload, device=device)
        if 'arch' not in m:
            raise ValueError(
                'model.path is missing/empty; set model.path to a checkpoint '
                'or pass model.arch explicitly for a synthetic model')
        arch = dict(cls.arch_defaults, **dict(m['arch']))
        return cls.random(cls.config_cls(**arch), seed=int(m.get('seed', 0)),
                          device=device, offload=offload)

    def get_layout(self) -> BlockLayout:
        return self._layout

    def block_fn(self):
        cfg = self.cfg

        # no sliding window here, as in the reference's block function:
        # only model_apply windows Gemma2's even layers
        def fn(bp, x, kw, qmap=None, capture=False):
            return L.block_apply(bp, cfg, x, kw['cos'], kw['sin'],
                                 kw.get('attn_bias'), qmap=qmap,
                                 capture=capture)
        return fn

    def inspect_fns(self):
        return L.make_inspect_fns(self.cfg)

    def embed_and_rope_p(self, params, input_ids, attention_mask=None):
        x = self.embed(params, input_ids)
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
            kw['attn_bias'] = _causal_pad_bias(attention_mask, S, dev)
        return x, kw

    def embed(self, params, input_ids):
        """Block 0's input: the config's token (and position) embedding."""
        return L.embed_apply(params, self.cfg, input_ids)

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

    def embed(self, params, input_ids):
        return params['embed_tokens']['w'][input_ids]

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


def _causal_pad_bias(attention_mask, S: int, dev):
    """The additive [B, 1, S, S] bias of a padding mask plus the causal
    mask, finite so that an all-masked pad row softmaxes to finite
    garbage, not NaN."""
    neg = torch.tensor(-1e9, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(attention_mask[:, None, None, :] > 0, zero, neg)
    causal = torch.where(torch.arange(S, device=dev)[:, None]
                         >= torch.arange(S, device=dev)[None, :], zero, neg)
    return bias + causal[None, None]


@MODEL_REGISTRY.register(name='Opt')
class OptAdapter(BaseAdapter):
    """OPT (facebook/opt-*) on its native graph (``models/opt.py``), which
    calibration and the PPL evals run; ``as_generalized`` views it through
    the Llama graph for the cached decode, packing and the engine.  A
    checkpoint loads in float32 by default, as in the reference."""

    name = 'Opt'

    def __init__(self, cfg: O.OptConfig, params, tokenizer=None,
                 hf_config=None):
        super().__init__(cfg, params, tokenizer, hf_config)
        self._layout = O.opt_layout(cfg)

    @classmethod
    def random(cls, cfg: O.OptConfig, seed: int = 0, device=None):
        """Random params from a ``torch.Generator`` seeded with ``seed``
        on ``device`` (``None``: the CUDA device)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, O.init_params(cfg, gen, device=dev))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32,
                        stream: Optional[bool] = None, device=None):
        """Load an HF checkpoint directory onto ``device`` (``None``: the
        CUDA device)."""
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        cfg = O.OptConfig.from_hf(hf)
        params = _load_params(path, dtype, stream, device,
                              lambda flat: O.params_from_hf(flat, cfg))
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
        return cls.random(O.OptConfig(**dict(m['arch'])),
                          seed=int(m.get('seed', 0)), device=device)

    def get_layout(self) -> BlockLayout:
        return self._layout

    def block_fn(self):
        cfg = self.cfg

        def fn(bp, x, kw, qmap=None, capture=False):
            return O.block_apply(bp, cfg, x, kw.get('attn_bias'), qmap=qmap,
                                 capture=capture)
        return fn

    def inspect_fns(self):
        return O.make_inspect_fns(self.cfg)

    def embed_and_rope_p(self, params, input_ids, attention_mask=None):
        x = O.embed_apply(params, self.cfg, input_ids)
        kw = {}
        if attention_mask is not None:
            kw['attn_bias'] = _causal_pad_bias(
                attention_mask, input_ids.shape[1], input_ids.device)
        return x, kw

    def head_fn(self):
        cfg = self.cfg

        def fn(params, x):
            return O.head_apply(params, cfg, x)
        return fn

    def forward_logits(self, input_ids, qmap=None):
        return O.model_apply(self.params, self.cfg, input_ids, qmap=qmap)

    def as_generalized(self) -> LlamaAdapter:
        """The same model (its tensors shared) through the generalized
        Llama graph, which the cached decode, ``pack_model`` and the
        serving engine run."""
        lcfg, gp = O.to_generalized(self.cfg, self.params)
        return LlamaAdapter(lcfg, gp, self.tokenizer, self.hf_config)

    def has_bias(self) -> bool:
        return True

    def save_to_hf(self, path: str) -> None:
        """Write the params (and ``hf_config``) as an HF OPT checkpoint,
        the ``save_trans`` / ``save_fake`` output."""
        from .hf_loader import save_flat_to_hf
        save_flat_to_hf(O.params_to_hf(self.params), path, self.hf_config)


# --------------------------------------------------------------------------
# The Llama-family adapters and the generalized-graph families (reference
# adapter.py:679-1230, 1880-1925).  Each renames its checkpoint into the
# canonical namespace (``rename_flat``), splitting fused projections, and
# rides the Llama loader and graph.
# --------------------------------------------------------------------------

@MODEL_REGISTRY.register(name='Mistral')
class MistralAdapter(LlamaAdapter):
    name = 'Mistral'


@MODEL_REGISTRY.register(name='SmolLM')
class SmolLMAdapter(LlamaAdapter):
    name = 'SmolLM'


@MODEL_REGISTRY.register(name='Qwen2')
class Qwen2Adapter(LlamaAdapter):
    """Qwen2 / Qwen2.5: the Llama block with q/k/v biases.  An inline arch
    takes ``attention_bias``, whose random tree (as the reference's) also
    has a zero ``o_proj`` bias."""

    name = 'Qwen2'
    arch_defaults = dict(attention_bias=True)


@MODEL_REGISTRY.register(name='Qwen3')
class Qwen3Adapter(LlamaAdapter):
    """Qwen3: the Llama block with per-head q/k RMSNorm (``use_qk_norm``).
    A checkpoint whose ``model_type`` is qwen3, or whose blocks hold
    q/k-norm weights, runs them; the reference leaves ``use_qk_norm`` off
    for a checkpoint and loads the weights unused (ROADMAP C)."""

    name = 'Qwen3'
    arch_defaults = dict(use_qk_norm=True)

    @classmethod
    def config_from_hf(cls, hf: dict):
        cfg = super().config_from_hf(hf)
        if hf.get('model_type') == 'qwen3':
            cfg = dataclasses.replace(cfg, use_qk_norm=True)
        return cfg

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, stream=None,
                        offload: bool = False, device=None):
        m = super().from_pretrained(path, dtype, stream, offload, device)
        if 'q_norm' in m.blocks[0]['self_attn'] and not m.cfg.use_qk_norm:
            m.cfg = dataclasses.replace(m.cfg, use_qk_norm=True)
        return m


@MODEL_REGISTRY.register(name='Phi3')
class Phi3Adapter(LlamaAdapter):
    """Phi-3: the Llama graph with fused ``qkv_proj`` / ``gate_up_proj``
    checkpoints, split at load (q/k/v and gate/up share their input, so
    the per-subset transforms stay valid)."""

    name = 'Phi3'

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = {n: flat[n] for n in flat.keys()}
        H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        inter = cfg.intermediate_size
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            qkv = out.pop(f'{b}.self_attn.qkv_proj.weight')
            out[f'{b}.self_attn.q_proj.weight'] = qkv[:H * hd]
            out[f'{b}.self_attn.k_proj.weight'] = qkv[H * hd:(H + KVH) * hd]
            out[f'{b}.self_attn.v_proj.weight'] = qkv[(H + KVH) * hd:]
            gu = out.pop(f'{b}.mlp.gate_up_proj.weight')
            out[f'{b}.mlp.gate_proj.weight'] = gu[:inter]
            out[f'{b}.mlp.up_proj.weight'] = gu[inter:]
        return out


@MODEL_REGISTRY.register(name='Gemma2')
class Gemma2Adapter(LlamaAdapter):
    """Gemma2: sandwich norms, GeGLU-tanh, attention and final logit
    softcaps, the query scale, sqrt(D)-scaled tied embeddings, a sliding
    window on even layers.  HF's norms apply x * (1 + w): the +1 is folded
    in at load, so the norms and ``scale_ln_fcs`` apply unchanged; the
    head dim comes from ``config.json`` (256 where it names none)."""

    name = 'Gemma2'
    arch_defaults = dict(
        act_fn='gelu_tanh', sandwich_norms=True, embed_scale=True,
        tie_word_embeddings=True, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, query_pre_attn_scalar=256.0,
        rope_theta=10000.0, rms_norm_eps=1e-6)

    @classmethod
    def config_from_hf(cls, hf):
        return dataclasses.replace(
            L.LlamaConfig.from_hf(hf),
            act_fn='gelu_tanh', sandwich_norms=True, embed_scale=True,
            tie_word_embeddings=True,
            attn_logit_softcap=hf.get('attn_logit_softcapping', 50.0),
            final_logit_softcap=hf.get('final_logit_softcapping', 30.0),
            query_pre_attn_scalar=hf.get('query_pre_attn_scalar', 256.0),
            sliding_window=hf.get('sliding_window'),
            head_dim=hf.get('head_dim', 256))

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        return {n: (flat[n] + 1.0 if 'norm' in n and n.endswith('.weight')
                    else flat[n]) for n in flat.keys()}


def _renamed(flat, pairs) -> Dict:
    """Every tensor of ``flat`` under its name with each (old, new)
    substring of ``pairs`` replaced, in order."""
    out = {}
    for name in flat.keys():
        n = name
        for old, new in pairs:
            n = n.replace(old, new)
        out[n] = flat[name]
    return out


def _put_qkv(out, b: str, part: str, q, k, v) -> None:
    for proj, t in (('q_proj', q), ('k_proj', k), ('v_proj', v)):
        out[f'{b}.self_attn.{proj}.{part}'] = t


@MODEL_REGISTRY.register(name='StableLm')
class StableLmAdapter(LlamaAdapter):
    """StableLM(-2): Llama's names with LayerNorm (biased), partial rotary
    and biased q/k/v."""

    name = 'StableLm'
    arch_defaults = dict(norm_type='ln', rotary_pct=0.25)

    @classmethod
    def config_from_hf(cls, hf):
        return dataclasses.replace(
            L.LlamaConfig.from_hf(hf), norm_type='ln',
            rms_norm_eps=hf.get('layer_norm_eps', 1e-5),
            rotary_pct=hf.get('partial_rotary_factor', 0.25))


_BLOOM_FALCON_NAMES = (
    ('transformer.word_embeddings_layernorm', 'model.embed_layernorm'),
    ('transformer.word_embeddings', 'model.embed_tokens'),
    ('transformer.ln_f', 'model.norm'),
    ('transformer.h.', 'model.layers.'),
    ('.self_attention.dense', '.self_attn.o_proj'),
    ('.mlp.dense_h_to_4h', '.mlp.up_proj'),
    ('.mlp.dense_4h_to_h', '.mlp.down_proj'))


@MODEL_REGISTRY.register(name='Falcon')
class FalconAdapter(LlamaAdapter):
    """Falcon: a fused ``query_key_value`` (MQA, grouped or per-head
    layouts), the parallel attention + MLP residual, LayerNorm, a
    non-gated GELU MLP, and ALiBi in place of rope (Falcon-RW, with the
    scores' scale on the bias)."""

    name = 'Falcon'
    arch_defaults = dict(norm_type='ln', parallel_residual=True,
                         shared_ln=True, gated_mlp=False, act_fn='gelu',
                         num_key_value_heads=1, tie_word_embeddings=True)

    @classmethod
    def config_from_hf(cls, hf):
        H, D = hf['num_attention_heads'], hf['hidden_size']
        new_arch = hf.get('new_decoder_architecture', False)
        parallel = hf.get('parallel_attn', True)
        alibi = hf.get('alibi', False)
        kvh = ((hf.get('num_kv_heads') or H) if new_arch
               else 1 if hf.get('multi_query', True) else H)
        return L.LlamaConfig(
            vocab_size=hf['vocab_size'], hidden_size=D,
            intermediate_size=hf.get('ffn_hidden_size', 4 * D),
            num_hidden_layers=hf['num_hidden_layers'],
            num_attention_heads=H, num_key_value_heads=kvh, head_dim=D // H,
            rms_norm_eps=hf.get('layer_norm_epsilon', 1e-5),
            rope_theta=hf.get('rope_theta', 10000.0),
            max_position_embeddings=hf.get('max_position_embeddings', 2048),
            tie_word_embeddings=hf.get('tie_word_embeddings', True),
            norm_type='ln', parallel_residual=parallel,
            shared_ln=parallel and not new_arch, gated_mlp=False,
            act_fn='gelu', use_alibi=alibi, alibi_scaled=True,
            rotary_pct=0.0 if alibi else 1.0)

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = _renamed(flat, _BLOOM_FALCON_NAMES + (
            ('.ln_attn', '.input_layernorm'),       # the 40B two-norm layout
            ('.ln_mlp', '.post_attention_layernorm')))
        H, KVH, hd, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim, cfg.hidden_size)
        new_arch = hf.get('new_decoder_architecture', False)
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            for part in ('weight', 'bias'):
                qkv = out.pop(f'{b}.self_attention.query_key_value.{part}',
                              None)
                if qkv is None:
                    continue
                tail = (D,) if part == 'weight' else ()
                if new_arch:             # [KVH, H/KVH + 2, hd] row groups
                    g = qkv.reshape((KVH, H // KVH + 2, hd) + tail)
                    q = g[:, :-2].reshape((H * hd,) + tail)
                    k = g[:, -2].reshape((KVH * hd,) + tail)
                    v = g[:, -1].reshape((KVH * hd,) + tail)
                elif hf.get('multi_query', True):   # [H*hd | hd | hd]
                    q, k, v = (qkv[:H * hd], qkv[H * hd:H * hd + hd],
                               qkv[H * hd + hd:])
                else:                    # per-head interleaved [H, 3, hd]
                    g = qkv.reshape((H, 3, hd) + tail)
                    q, k, v = (g[:, j].reshape((H * hd,) + tail)
                               for j in range(3))
                _put_qkv(out, b, part, q, k, v)
        return out


@MODEL_REGISTRY.register(name='Phi')
class PhiAdapter(LlamaAdapter):
    """Phi-1.5 / 2: parallel attention + MLP off one LayerNorm, partial
    rotary, a non-gated gelu_new MLP (fc1 / fc2) and a biased head."""

    name = 'Phi'
    arch_defaults = dict(norm_type='ln', parallel_residual=True,
                         shared_ln=True, gated_mlp=False, act_fn='gelu_tanh',
                         rotary_pct=0.5)

    @classmethod
    def config_from_hf(cls, hf):
        return dataclasses.replace(
            L.LlamaConfig.from_hf(hf), norm_type='ln',
            parallel_residual=True, shared_ln=True, gated_mlp=False,
            act_fn='gelu_tanh', rms_norm_eps=hf.get('layer_norm_eps', 1e-5),
            rotary_pct=hf.get('partial_rotary_factor', 0.5))

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        return _renamed(flat, (('.self_attn.dense', '.self_attn.o_proj'),
                               ('.mlp.fc1', '.mlp.up_proj'),
                               ('.mlp.fc2', '.mlp.down_proj'),
                               ('model.final_layernorm', 'model.norm')))


@MODEL_REGISTRY.register(name='Starcoder')
class StarcoderAdapter(LlamaAdapter):
    """Starcoder (gpt_bigcode): MQA with a fused ``c_attn``, learned
    absolute positions (no rope), LayerNorm, a non-gated gelu-tanh MLP and
    a tied head."""

    name = 'Starcoder'
    arch_defaults = dict(norm_type='ln', gated_mlp=False, act_fn='gelu_tanh',
                         rotary_pct=0.0, learned_pos=True,
                         num_key_value_heads=1, tie_word_embeddings=True)

    @classmethod
    def config_from_hf(cls, hf):
        H = hf.get('n_head', hf.get('num_attention_heads'))
        D = hf.get('n_embd', hf.get('hidden_size'))
        return L.LlamaConfig(
            vocab_size=hf['vocab_size'], hidden_size=D,
            intermediate_size=hf.get('n_inner') or 4 * D,
            num_hidden_layers=hf.get('n_layer', hf.get('num_hidden_layers')),
            num_attention_heads=H,
            num_key_value_heads=1 if hf.get('multi_query', True) else H,
            head_dim=D // H, rms_norm_eps=hf.get('layer_norm_epsilon', 1e-5),
            max_position_embeddings=hf.get('n_positions', 8192),
            tie_word_embeddings=True, norm_type='ln', gated_mlp=False,
            act_fn='gelu_tanh', rotary_pct=0.0, learned_pos=True)

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = _renamed(flat, (
            ('transformer.wte', 'model.embed_tokens'),
            ('transformer.wpe', 'model.embed_positions'),
            ('transformer.ln_f', 'model.norm'),
            ('transformer.h.', 'model.layers.'),
            ('.ln_1', '.input_layernorm'),
            ('.ln_2', '.post_attention_layernorm'),
            ('.attn.c_proj', '.self_attn.o_proj'),
            ('.mlp.c_fc', '.mlp.up_proj'),
            ('.mlp.c_proj', '.mlp.down_proj')))
        qd, kd = (cfg.num_attention_heads * cfg.head_dim,
                  cfg.num_key_value_heads * cfg.head_dim)
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            for part in ('weight', 'bias'):
                qkv = out.pop(f'{b}.attn.c_attn.{part}', None)
                if qkv is not None:
                    _put_qkv(out, b, part, qkv[:qd], qkv[qd:qd + kd],
                             qkv[qd + kd:])
        return out


@MODEL_REGISTRY.register(name='Bloom')
class BloomAdapter(LlamaAdapter):
    """Bloom: ALiBi (no rope), LayerNorm with an embedding LayerNorm, a
    per-head interleaved fused q/k/v, a non-gated gelu-tanh MLP and a tied
    head."""

    name = 'Bloom'
    arch_defaults = dict(norm_type='ln', gated_mlp=False, act_fn='gelu_tanh',
                         rotary_pct=0.0, use_alibi=True,
                         tie_word_embeddings=True)

    @classmethod
    def config_from_hf(cls, hf):
        H = hf.get('n_head', hf.get('num_attention_heads'))
        D = hf['hidden_size']
        return L.LlamaConfig(
            vocab_size=hf['vocab_size'], hidden_size=D,
            intermediate_size=4 * D,
            num_hidden_layers=hf.get('n_layer', hf.get('num_hidden_layers')),
            num_attention_heads=H, num_key_value_heads=H, head_dim=D // H,
            rms_norm_eps=hf.get('layer_norm_epsilon', 1e-5),
            tie_word_embeddings=True, norm_type='ln', gated_mlp=False,
            act_fn='gelu_tanh', rotary_pct=0.0, use_alibi=True)

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = _renamed(flat, _BLOOM_FALCON_NAMES)
        H, hd = cfg.num_attention_heads, cfg.head_dim
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            for part in ('weight', 'bias'):
                qkv = out.pop(f'{b}.self_attention.query_key_value.{part}',
                              None)
                if qkv is None:
                    continue
                tail = qkv.shape[1:]
                g = qkv.reshape((H, 3, hd) + tuple(tail))
                _put_qkv(out, b, part, *(g[:, j].reshape((H * hd,) + tail)
                                         for j in range(3)))
        return out


@MODEL_REGISTRY.register(name='InternLM2')
class InternLM2Adapter(LlamaAdapter):
    """InternLM2: the Llama graph under other names, with a grouped fused
    ``wqkv`` ([KVH, rep + 2, hd] row groups)."""

    name = 'InternLM2'

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = _renamed(flat, (
            ('model.tok_embeddings', 'model.embed_tokens'),
            ('.attention.wo', '.self_attn.o_proj'),
            ('.feed_forward.w1', '.mlp.gate_proj'),
            ('.feed_forward.w3', '.mlp.up_proj'),
            ('.feed_forward.w2', '.mlp.down_proj'),
            ('.attention_norm', '.input_layernorm'),
            ('.ffn_norm', '.post_attention_layernorm')))
        if 'output.weight' in out:
            out['lm_head.weight'] = out.pop('output.weight')
        H, KVH, hd, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim, cfg.hidden_size)
        rep = H // KVH
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            g = out.pop(f'{b}.attention.wqkv.weight').reshape(
                KVH, rep + 2, hd, D)
            _put_qkv(out, b, 'weight', g[:, :rep].reshape(H * hd, D),
                     g[:, rep].reshape(KVH * hd, D),
                     g[:, rep + 1].reshape(KVH * hd, D))
        return out


@MODEL_REGISTRY.register(name='Glm')
@MODEL_REGISTRY.register(name='ChatGLM')
class GlmAdapter(LlamaAdapter):
    """GLM-4 / ChatGLM: the Llama graph with interleaved partial rotary
    (adjacent pairs share a frequency), biased q/k/v and a fused
    ``gate_up_proj`` split at load."""

    name = 'Glm'
    arch_defaults = dict(rotary_pct=0.5, rope_interleaved=True,
                         attention_bias=True)

    @classmethod
    def config_from_hf(cls, hf):
        return dataclasses.replace(
            L.LlamaConfig.from_hf(hf),
            rotary_pct=hf.get('partial_rotary_factor', 0.5),
            rope_interleaved=True)

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = {n: flat[n] for n in flat.keys()}
        inter = cfg.intermediate_size
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            for part in ('weight', 'bias'):
                gu = out.pop(f'{b}.mlp.gate_up_proj.{part}', None)
                if gu is not None:
                    out[f'{b}.mlp.gate_proj.{part}'] = gu[:inter]
                    out[f'{b}.mlp.up_proj.{part}'] = gu[inter:]
        return out


@MODEL_REGISTRY.register(name='MiniCPM')
class MiniCPMAdapter(LlamaAdapter):
    """MiniCPM: the Llama graph with depth and width scaling (``scale_emb``,
    ``scale_depth`` / sqrt(L) on the residuals, hidden / dim_model_base as
    the logit divisor)."""

    name = 'MiniCPM'

    @classmethod
    def config_from_hf(cls, hf):
        return dataclasses.replace(
            L.LlamaConfig.from_hf(hf),
            embed_multiplier=hf.get('scale_emb', 1.0),
            residual_multiplier=(hf.get('scale_depth', 1.0)
                                 / hf['num_hidden_layers'] ** 0.5),
            logit_divisor=(hf['hidden_size']
                           / hf.get('dim_model_base', hf['hidden_size'])))


@MODEL_REGISTRY.register(name='Qwen')
class QwenAdapter(LlamaAdapter):
    """Qwen (v1, QWenLMHeadModel): the Llama graph under ``transformer.h``
    names, with a fused biased ``c_attn`` split into q/k/v at load and the
    swapped-gate MLP ``c_proj(w1(x) * silu(w2(x)))`` (w2 is the gate).
    HF's ``intermediate_size`` counts w1 and w2: the MLP is half of it."""

    name = 'Qwen'

    @classmethod
    def config_from_hf(cls, hf):
        heads = hf['num_attention_heads']
        return L.LlamaConfig(
            vocab_size=hf['vocab_size'], hidden_size=hf['hidden_size'],
            intermediate_size=hf['intermediate_size'] // 2,
            num_hidden_layers=hf['num_hidden_layers'],
            num_attention_heads=heads, num_key_value_heads=heads,
            head_dim=hf['hidden_size'] // heads,
            rms_norm_eps=hf.get('layer_norm_epsilon', 1e-6),
            rope_theta=hf.get('rotary_emb_base', 10000.0),
            max_position_embeddings=hf.get('seq_length', 8192),
            attention_bias=True)

    @classmethod
    def rename_flat(cls, flat, cfg, hf):
        out = _renamed(flat, (
            ('transformer.wte', 'model.embed_tokens'),
            ('transformer.h.', 'model.layers.'),
            ('.ln_1', '.input_layernorm'),
            ('.ln_2', '.post_attention_layernorm'),
            ('.attn.c_proj', '.self_attn.o_proj'),
            ('.mlp.w2', '.mlp.gate_proj'),
            ('.mlp.w1', '.mlp.up_proj'),
            ('.mlp.c_proj', '.mlp.down_proj'),
            ('transformer.ln_f', 'model.norm')))
        for i in range(cfg.num_hidden_layers):
            b = f'model.layers.{i}'
            for part in ('weight', 'bias'):
                ca = out.pop(f'{b}.attn.c_attn.{part}', None)
                if ca is not None:
                    _put_qkv(out, b, part, *torch.chunk(ca, 3, dim=0))
        return out


# --------------------------------------------------------------------------
# ViT and the LLaVA tier (reference adapter.py:288-365, 1233-1390,
# 1935-2040)
# --------------------------------------------------------------------------

def _on(x, dev, dtype=None):
    """A batch's array (numpy or tensor) as a tensor on ``dev``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.to(device=dev, dtype=dtype)


def _arch(m) -> dict:
    if 'arch' not in m:
        raise ValueError(
            'model.path is missing/empty; set model.path to a checkpoint '
            'or pass model.arch explicitly for a synthetic model')
    return dict(m['arch'])


@MODEL_REGISTRY.register(name='Vit')
class VitAdapter(BaseAdapter):
    """ViT ImageNet classifier; calibration batches carry
    ``pixel_values``.  Besides the reference's checkpoint, an inline
    ``model.arch`` builds a random ViT (``VitConfig``'s fields)."""

    name = 'Vit'

    def __init__(self, cfg: V.VitConfig, params, tokenizer=None,
                 hf_config=None):
        super().__init__(cfg, params, tokenizer, hf_config)
        self._layout = V.vit_layout(cfg)

    @classmethod
    def random(cls, cfg: V.VitConfig, seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, V.init_params(cfg, gen, device=dev))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.float32, device=None):
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        cfg = dataclasses.replace(V.VitConfig.from_hf(hf),
                                  dtype=str(dtype).replace('torch.', ''))
        params = _load_params(path, dtype, False, device,
                              lambda flat: V.params_from_hf(flat, cfg))
        return cls(cfg, params, None, hf)

    @classmethod
    def from_config(cls, config, device=None):
        m = config['model']
        if m.get('path'):
            return cls.from_pretrained(
                m['path'], dtype=_config_dtype(m.get('torch_dtype',
                                                     'float32')),
                device=device)
        return cls.random(V.VitConfig(**_arch(m)), seed=int(m.get('seed', 0)),
                          device=device)

    def get_layout(self) -> BlockLayout:
        return self._layout

    def block_fn(self):
        cfg = self.cfg

        def fn(bp, x, kw, qmap=None, capture=False):
            return V.block_apply(bp, cfg, x, qmap=qmap, capture=capture)
        return fn

    def inspect_fns(self):
        return V.make_inspect_fns(self.cfg)

    def embed_and_rope_p(self, params, pixel_values, attention_mask=None):
        return V.patch_embed(params, self.cfg, pixel_values), {}

    def collect_first_block_input(self, calib_batches):
        dev = self.device
        xs, kws = [], []
        with torch.no_grad():
            for batch in calib_batches:
                px = batch.get('pixel_values', batch.get('input_ids'))
                x, kw = self.embed_and_rope_p(self.params, _on(px, dev))
                xs.append(x)
                kws.append(kw)
        return xs, kws

    def classify(self, pixels, qmap=None):
        return V.classify(self.params, self.cfg, _on(pixels, self.device),
                          qmap=qmap)

    def forward_logits(self, pixels, qmap=None):
        return self.classify(pixels, qmap=qmap)


class AccuracyEval:
    """ImageNet top-1 over (pixels, labels) arrays, ``bs`` images a
    forward."""

    def __init__(self, pixels, labels, bs: int = 16):
        self.pixels = pixels
        self.labels = np.asarray(labels)
        self.bs = bs

    @torch.no_grad()
    def predictions(self, model: VitAdapter, qmap=None) -> np.ndarray:
        return np.concatenate([
            torch.argmax(model.classify(self.pixels[i:i + self.bs],
                                        qmap=qmap), -1).cpu().numpy()
            for i in range(0, len(self.labels), self.bs)])

    def eval(self, model: VitAdapter, qmap=None) -> float:
        return float((self.predictions(model, qmap) == self.labels).sum()
                     / len(self.labels))


def _tower_cfg(make, varch: dict, **kw) -> L.LlamaConfig:
    """The tower's block config ``make`` builds from an inline
    ``model.arch.vision`` (the reference's defaults: 32 wide, 64 in the
    MLP, 2 layers of 2 heads; float32 unless it names a ``dtype``)."""
    cfg = make(varch.get('hidden_size', 32),
               varch.get('intermediate_size', 64),
               varch.get('num_hidden_layers', 2),
               varch.get('num_attention_heads', 2), **kw)
    return dataclasses.replace(cfg, dtype=varch.get('dtype', cfg.dtype))


class _VisionLanguageAdapter(LlamaAdapter):
    """What the two-modality VLM adapters share: ``set_modality`` switches
    the block stack the compression engine sees ('vision': the tower's
    blocks, which take the batch kwargs' rope tables where the tower has
    any; 'language': the LM's); ``cfg`` is the LM's config, ``vl_cfg``
    the whole.  ``family`` is the model's module (its ``init_params``);
    the towers take only a ``ModalQMap``'s ``vision`` QMap."""

    family = None

    def __init__(self, cfg, params, tokenizer=None, hf_config=None):
        super().__init__(cfg.text, params, tokenizer, hf_config)
        self.vl_cfg = cfg
        self._modality = 'language'
        self._vlayout = L.llama_layout(cfg.vision)

    @classmethod
    def random(cls, cfg, seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, cls.family.init_params(cfg, gen, device=dev))

    # --- modality dispatch ---------------------------------------------
    def set_modality(self, modality: str) -> None:
        if modality not in ('language', 'vision'):
            raise ValueError(f'modality {modality!r}: want language or '
                             f'vision')
        self._modality = modality

    @property
    def modality(self) -> str:
        return self._modality

    @property
    def blocks(self):
        if self._modality == 'vision':
            return self.params['vision']['blocks']
        return self.params['blocks']

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def set_block(self, idx: int, new_block) -> None:
        self.blocks[idx] = new_block

    def get_layout(self) -> BlockLayout:
        return self._vlayout if self._modality == 'vision' else self._layout

    def block_fn(self):
        if self._modality == 'language':
            return super().block_fn()
        vc = self.vl_cfg.vision

        def fn(bp, x, kw, qmap=None, capture=False):
            return L.block_apply(bp, vc, x, kw.get('cos'), kw.get('sin'),
                                 attn_bias=kw.get('attn_bias'), qmap=qmap,
                                 capture=capture)
        return fn

    def inspect_fns(self):
        return L.make_inspect_fns(self.vl_cfg.vision
                                  if self._modality == 'vision' else self.cfg)

    def _pixels(self, px):
        return None if px is None else _on(px, self.device)

    def _ids(self, ids):
        return _on(ids, self.device, torch.long)

    def _reduction(self, token_reduction, *pixels):
        # the one the TokenReduction algorithm installed, where a call
        # with pixels names none
        if token_reduction is None and any(p is not None for p in pixels):
            return getattr(self, 'token_reduction', None)
        return token_reduction

    def _rope_kw(self, ids):
        cos, sin = L.rope_cos_sin(self.cfg, torch.arange(
            ids.shape[1], device=ids.device)[None, :])
        return {'cos': cos, 'sin': sin}

    def _tower_kw(self, x):
        return {'attn_bias': torch.zeros((1, 1, 1, 1), dtype=torch.float32,
                                         device=x.device)}

    def collect_first_block_input(self, calib_batches):
        """Block 0's input of the modality's stack over the batches, no
        QMap on the tower (``_first_input``)."""
        xs, kws = [], []
        with torch.no_grad():
            for batch in calib_batches:
                x, kw = self._first_input(batch)
                xs.append(x)
                kws.append(kw)
        return xs, kws

    # the inline arch keys that belong to the whole config, not the LM
    _VL_KEYS: Tuple[str, ...] = ()

    @classmethod
    def _tower_cfg(cls, varch: dict) -> L.LlamaConfig:
        raise NotImplementedError

    @classmethod
    def _from_arch(cls, m, device):
        arch = dict(cls.arch_defaults, **_arch(m))
        vcfg = cls._tower_cfg(arch.pop('vision', {}))
        extra = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in ((k, arch.pop(k)) for k in cls._VL_KEYS
                              if k in arch)}
        cfg = cls.vl_config_cls(text=L.LlamaConfig(**arch), vision=vcfg,
                                **extra)
        return cls.random(cfg, seed=int(m.get('seed', 0)), device=device)

    @classmethod
    def from_config(cls, config, device=None):
        """``model.path`` (an HF checkpoint directory) or ``model.arch``
        (the LM's fields, the config's own keys and a ``vision`` section;
        random weights from ``model.seed``)."""
        m = config['model']
        if m.get('path'):
            return cls.from_pretrained(
                m['path'], dtype=_config_dtype(m.get('torch_dtype',
                                                     'bfloat16')),
                device=device)
        return cls._from_arch(m, device)


@MODEL_REGISTRY.register(name='Llava')
class LlavaAdapter(_VisionLanguageAdapter):
    """Llava: CLIP tower + MLP projector + Llama LM (``llava_cfg`` is
    ``vl_cfg``).  Calibration batches may carry ``pixel_values`` beside
    ``input_ids``."""

    name = 'Llava'
    family = LV
    vl_config_cls = LV.LlavaConfig
    _VL_KEYS = ('image_size', 'patch_size', 'image_token_index')

    @property
    def llava_cfg(self) -> LV.LlavaConfig:
        return self.vl_cfg

    @llava_cfg.setter
    def llava_cfg(self, cfg: LV.LlavaConfig) -> None:
        self.vl_cfg = cfg

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device=None):
        """An HF LlavaForConditionalGeneration checkpoint onto ``device``
        (``None``: the CUDA device)."""
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        v = hf['vision_config']
        cfg = LV.LlavaConfig(
            text=L.LlamaConfig.from_hf(hf['text_config']),
            vision=LV.LlavaConfig.clip_block_cfg(
                v['hidden_size'], v['intermediate_size'],
                v['num_hidden_layers'], v['num_attention_heads'],
                v.get('layer_norm_eps', 1e-5)),
            image_size=v.get('image_size', 336),
            patch_size=v.get('patch_size', 14),
            image_token_index=hf.get('image_token_index', 32000),
            vision_feature_layer=hf.get('vision_feature_layer', -2),
            vision_feature_select_strategy=hf.get(
                'vision_feature_select_strategy', 'default'))
        params = _load_params(path, dtype, False, device,
                              lambda flat: LV.params_from_hf(flat, cfg))
        return cls(cfg, params, _load_tokenizer(path), hf)

    @classmethod
    def _tower_cfg(cls, varch):
        return _tower_cfg(LV.LlavaConfig.clip_block_cfg, varch)

    # --- embeddings / forward -------------------------------------------
    def embed_and_rope_p(self, params, input_ids, attention_mask=None,
                         pixel_values=None):
        cfg = self.llava_cfg
        if self._modality == 'vision':
            x = LV.clip_embed(params['vision'], cfg, pixel_values
                              if pixel_values is not None else input_ids)
            return x, self._tower_kw(x)
        return (LV.llava_embed(params, cfg, input_ids, pixel_values),
                self._rope_kw(input_ids))

    def _first_input(self, batch):
        ids = batch.get('input_ids')
        return self.embed_and_rope_p(
            self.params, None if ids is None else _on(ids, self.device,
                                                      torch.long),
            None, self._pixels(batch.get('pixel_values')))

    def forward_logits(self, input_ids, qmap=None, pixel_values=None,
                       token_reduction=None):
        return LV.llava_forward(
            self.params, self.llava_cfg, _on(input_ids, self.device,
                                             torch.long),
            self._pixels(pixel_values), qmap=qmap,
            token_reduction=self._reduction(token_reduction, pixel_values))

    # --- KV-cached serving (serve/decode.py::vlm_greedy_generate) -------
    @property
    def lm_cfg(self) -> L.LlamaConfig:
        return self.llava_cfg.text

    def prefill_embeds(self, input_ids, qmap=None, pixel_values=None,
                       token_reduction=None):
        return LV.llava_prefill_embeds(
            self.params, self.llava_cfg, _on(input_ids, self.device,
                                             torch.long),
            self._pixels(pixel_values), qmap=qmap,
            token_reduction=self._reduction(token_reduction, pixel_values))


@MODEL_REGISTRY.register(name='LlavaHf')
class LlavaHfAdapter(LlavaAdapter):
    """The reference's HF-transformers Llava wrapper: the same graph and
    checkpoint layout under its registry name."""

    name = 'LlavaHf'


@MODEL_REGISTRY.register(name='VideoLLaVA')
@MODEL_REGISTRY.register(name='VideoLlava')
class VideoLlavaAdapter(LlavaAdapter):
    """Video-LLaVA: the Llava graph whose one CLIP tower also encodes F
    frames of a clip, spliced at ``video_token_index``.  Calibration
    batches may carry ``pixel_values_videos`` [B, F, C, H, W]; the video
    methods (DyCoke, PruneVid, FastVID, HoliTom) reduce them."""

    name = 'VideoLlava'
    _VL_KEYS = LlavaAdapter._VL_KEYS + ('video_token_index', 'num_frames')

    @classmethod
    def from_config(cls, config, device=None):
        m = config['model']
        if m.get('path'):
            self = super().from_config(config, device=device)
            hf = self.hf_config
            self.llava_cfg = dataclasses.replace(
                self.llava_cfg,
                video_token_index=hf.get('video_token_index', 32001),
                num_frames=hf.get('num_frames', 8))
            return self
        arch = _arch(m)
        arch.setdefault('video_token_index', 32001)
        return super().from_config(dict(config, model=dict(m, arch=arch)),
                                   device=device)

    def _first_input(self, batch):
        vids = self._pixels(batch.get('pixel_values_videos'))
        imgs = self._pixels(batch.get('pixel_values'))
        if self._modality == 'vision':
            # a clip's frames go through the tower as images
            return self.embed_and_rope_p(
                self.params, None, pixel_values=(
                    vids.flatten(0, 1) if vids is not None else imgs))
        ids = _on(batch['input_ids'], self.device, torch.long)
        return self._lm_embeds(ids, imgs, vids), self._rope_kw(ids)

    def _lm_embeds(self, ids, imgs, vids):
        cfg, p = self.llava_cfg, self.params
        x = L.embed_apply(p, cfg.text, ids)
        for px, feats_of, tok in (
                (vids, LV.video_features, cfg.video_token_index),
                (imgs, LV.vision_features, cfg.image_token_index)):
            if px is not None:
                feats = LV.project_features(p['projector'], cfg,
                                            feats_of(p['vision'], cfg, px))
                x = LV.merge_embeddings(x, feats, ids, tok)
        return x

    def forward_logits(self, input_ids, qmap=None, pixel_values=None,
                       pixel_values_videos=None, token_reduction=None):
        return LV.videollava_forward(
            self.params, self.llava_cfg, _on(input_ids, self.device,
                                             torch.long),
            self._pixels(pixel_values), self._pixels(pixel_values_videos),
            qmap=qmap, token_reduction=self._reduction(
                token_reduction, pixel_values, pixel_values_videos))


# --------------------------------------------------------------------------
# Qwen2-VL, InternVL, LLaVA-OneVision and MiniCPM-V (reference
# adapter.py:1392-1880, 2198-2305)
# --------------------------------------------------------------------------

@MODEL_REGISTRY.register(name='Qwen2vl')
class Qwen2VLAdapter(_VisionLanguageAdapter):
    """Qwen2-VL: the 2-D-rope ViT with its patch merger and the Qwen2 LM
    with M-RoPE.  Calibration batches may carry ``pixel_patches`` (the HF
    processor's layout [n, C*T*p*p]) and ``grid_thw``.  The LM's config
    keeps a checkpoint's ``mrope`` rope-scaling type, plain rope on text:
    the cached decode serves text prompts; a prompt with an image takes the
    eager forward (the reference's cached VLM prefill is LLaVA's only)."""

    name = 'Qwen2vl'
    family = QV
    vl_config_cls = QV.Qwen2VLConfig
    arch_defaults = {'attention_bias': True}
    _VL_KEYS = ('patch_size', 'temporal_patch_size', 'image_token_id',
                'vision_start_token_id', 'mrope_section')

    @classmethod
    def _tower_cfg(cls, varch):
        return _tower_cfg(QV.Qwen2VLConfig.vit_block_cfg, varch)

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device=None):
        """An HF Qwen2VLForConditionalGeneration checkpoint onto
        ``device`` (``None``: the CUDA device)."""
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        tc_hf = hf.get('text_config', hf)
        v = hf['vision_config']
        embed = v.get('embed_dim', v.get('hidden_size', 1280))
        rs = tc_hf.get('rope_scaling') or {}
        cfg = QV.Qwen2VLConfig(
            text=L.LlamaConfig.from_hf(dict(tc_hf, attention_bias=True)),
            vision=QV.Qwen2VLConfig.vit_block_cfg(
                embed, int(embed * v.get('mlp_ratio', 4)),
                v.get('depth', 32), v.get('num_heads', 16),
                v.get('hidden_act', 'quick_gelu')),
            mrope_section=tuple(rs.get('mrope_section', (16, 24, 24))),
            spatial_merge_size=v.get('spatial_merge_size', 2),
            patch_size=v.get('patch_size', 14),
            temporal_patch_size=v.get('temporal_patch_size', 2),
            num_channels=v.get('in_channels', 3),
            image_token_id=hf.get('image_token_id', 151655),
            video_token_id=hf.get('video_token_id', 151656),
            vision_start_token_id=hf.get('vision_start_token_id', 151652))
        params = _load_params(path, dtype, False, device,
                              lambda flat: QV.params_from_hf(flat, cfg))
        return cls(cfg, params, _load_tokenizer(path), hf)

    def _first_input(self, batch):
        cfg = self.vl_cfg
        patches = self._pixels(batch.get('pixel_patches'))
        grid = batch.get('grid_thw')
        if self._modality == 'vision':
            x = QV.patch_embed(self.params['vision'], cfg, patches)
            cos, sin = QV.vision_rot_cos_sin(
                grid, cfg.vision.head_dim, cfg.spatial_merge_size,
                device=x.device)
            return x, dict(self._tower_kw(x), cos=cos[None], sin=sin[None])
        x, cos, sin = QV.lm_inputs(self.params, cfg,
                                   self._ids(batch['input_ids']), patches,
                                   grid)
        return x, {'cos': cos, 'sin': sin}

    def forward_logits(self, input_ids, qmap=None, pixel_patches=None,
                       grid_thw=None):
        return QV.qwen2vl_forward(
            self.params, self.vl_cfg, self._ids(input_ids),
            self._pixels(pixel_patches),
            None if grid_thw is None else tuple(int(g) for g in grid_thw),
            qmap=qmap)


@MODEL_REGISTRY.register(name='InternVL2')
class InternVLAdapter(_VisionLanguageAdapter):
    """InternVL 2 / 2.5 / 3: InternViT (layer scale, optional full-width
    qk-norm), a pixel shuffle, the MLP projector and a Qwen2 / Llama LM.
    Calibration batches may carry ``pixel_values`` [B, C, H, W]."""

    name = 'InternVL2'
    family = IV
    vl_config_cls = IV.InternVLConfig
    _VL_KEYS = ('image_size', 'patch_size', 'image_token_id',
                'downsample_ratio')

    @classmethod
    def _tower_cfg(cls, varch):
        return _tower_cfg(IV.InternVLConfig.vit_block_cfg, varch,
                          qk_norm=varch.get('use_qk_norm', False))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device=None):
        """An HF InternVLForConditionalGeneration checkpoint onto
        ``device`` (``None``: the CUDA device)."""
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        v = hf['vision_config']

        def scalar(x, default):
            x = x if x is not None else default
            return x[0] if isinstance(x, (list, tuple)) else x

        cfg = IV.InternVLConfig(
            text=L.LlamaConfig.from_hf(hf['text_config']),
            vision=IV.InternVLConfig.vit_block_cfg(
                v['hidden_size'], v['intermediate_size'],
                v['num_hidden_layers'], v['num_attention_heads'],
                v.get('hidden_act', 'gelu'),
                'ln' if v.get('norm_type', 'layer_norm') == 'layer_norm'
                else 'rms', v.get('use_qk_norm', False),
                v.get('attention_bias', True), v.get('layer_norm_eps', 1e-6)),
            image_size=scalar(v.get('image_size'), 448),
            patch_size=scalar(v.get('patch_size'), 14),
            image_token_id=hf.get('image_token_id', 151667),
            downsample_ratio=hf.get('downsample_ratio', 0.5),
            vision_feature_layer=hf.get('vision_feature_layer', -1),
            vision_feature_select_strategy=hf.get(
                'vision_feature_select_strategy', 'default'),
            use_abs_pos=v.get('use_absolute_position_embeddings', True),
            final_layernorm=not v.get('use_mean_pooling', False))
        params = _load_params(path, dtype, False, device,
                              lambda flat: IV.params_from_hf(flat, cfg))
        return cls(cfg, params, _load_tokenizer(path), hf)

    def _first_input(self, batch):
        px = self._pixels(batch.get('pixel_values'))
        if self._modality == 'vision':
            x = IV.vit_embed(self.params['vision'], self.vl_cfg, px)
            return x, self._tower_kw(x)
        ids = self._ids(batch['input_ids'])
        return (IV.lm_embeds(self.params, self.vl_cfg, ids, px),
                self._rope_kw(ids))

    def forward_logits(self, input_ids, qmap=None, pixel_values=None):
        return IV.internvl_forward(self.params, self.vl_cfg,
                                   self._ids(input_ids),
                                   self._pixels(pixel_values), qmap=qmap)


@MODEL_REGISTRY.register(name='LlavaOneVision')
class LlavaOneVisionAdapter(_VisionLanguageAdapter):
    """LLaVA-OneVision: the SigLIP tower, anyres packing and a Qwen2 LM.
    Calibration batches may carry ``pixel_values`` [B, crops, C, H, W] with
    ``image_sizes``; the forward also takes ``pixel_values_videos`` [B, F,
    C, H, W], which DyCoke or PruneVid (a ``token_reduction``, or the one
    the TokenReduction algorithm installed) reduce."""

    name = 'LlavaOneVision'
    family = OV
    vl_config_cls = OV.LlavaOnevisionConfig
    _VL_KEYS = ('image_size', 'patch_size', 'image_token_index',
                'video_token_index')

    @classmethod
    def _tower_cfg(cls, varch):
        return _tower_cfg(OV.LlavaOnevisionConfig.siglip_block_cfg, varch)

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device=None):
        """An HF LlavaOnevisionForConditionalGeneration checkpoint onto
        ``device`` (``None``: the CUDA device)."""
        from .hf_loader import load_hf_config
        hf = load_hf_config(path)
        v = hf['vision_config']
        cfg = OV.LlavaOnevisionConfig(
            text=L.LlamaConfig.from_hf(hf['text_config']),
            vision=OV.LlavaOnevisionConfig.siglip_block_cfg(
                v['hidden_size'], v['intermediate_size'],
                v['num_hidden_layers'], v['num_attention_heads'],
                v.get('layer_norm_eps', 1e-6)),
            image_size=v.get('image_size', 384),
            patch_size=v.get('patch_size', 14),
            image_token_index=hf.get('image_token_index', 151646),
            video_token_index=hf.get('video_token_index', 151647),
            vision_feature_layer=hf.get('vision_feature_layer', -1),
            vision_feature_select_strategy=hf.get(
                'vision_feature_select_strategy', 'full'),
            vision_aspect_ratio=hf.get('vision_aspect_ratio',
                                       'anyres_max_9'),
            image_grid_pinpoints=tuple(
                tuple(p) for p in hf.get('image_grid_pinpoints',
                                         [[384, 384]])))
        params = _load_params(path, dtype, False, device,
                              lambda flat: OV.params_from_hf(flat, cfg))
        return cls(cfg, params, _load_tokenizer(path), hf)

    def _first_input(self, batch):
        cfg = self.vl_cfg
        px = self._pixels(batch.get('pixel_values'))
        if self._modality == 'vision':
            x = OV.siglip_embed(self.params['vision'], cfg,
                                px.flatten(0, 1) if px.ndim == 5 else px)
            return x, self._tower_kw(x)
        ids = self._ids(batch['input_ids'])
        sizes = batch.get('image_sizes', [(cfg.image_size, cfg.image_size)]
                          * ids.shape[0])
        x, _ = OV.lm_inputs(self.params, cfg, ids, px, sizes)
        return x, self._rope_kw(ids)

    def forward_logits(self, input_ids, qmap=None, pixel_values=None,
                       image_sizes=None, pixel_values_videos=None,
                       token_reduction=None):
        return OV.onevision_forward(
            self.params, self.vl_cfg, self._ids(input_ids),
            self._pixels(pixel_values), image_sizes,
            self._pixels(pixel_values_videos), qmap=qmap,
            token_reduction=self._reduction(token_reduction,
                                            pixel_values_videos))


@MODEL_REGISTRY.register(name='MiniCPMV')
class MiniCPMVAdapter(_VisionLanguageAdapter):
    """MiniCPM-V: the SigLIP tower, the perceiver resampler and the LM.  As
    in the reference, only the language model compresses: ``set_modality``
    refuses 'vision'.  Calibration batches may carry ``pixel_values``."""

    name = 'MiniCPMV'
    family = MV
    vl_config_cls = MV.MiniCPMVConfig
    _VL_KEYS = ('image_size', 'patch_size', 'num_queries',
                'image_token_index')

    @classmethod
    def _tower_cfg(cls, varch):
        return _tower_cfg(OV.LlavaOnevisionConfig.siglip_block_cfg, varch)

    def set_modality(self, modality: str) -> None:
        if modality != 'language':
            raise ValueError('MiniCPMV compresses the language model only '
                             '(the reference\'s find_blocks asserts it)')
        self._modality = modality

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device=None):
        """An HF MiniCPM-V checkpoint (``llm.*``, ``vpm.*``, ``resampler.*``)
        onto ``device`` (``None``: the CUDA device)."""
        from .hf_loader import llama_params_from_hf, load_hf_config
        hf = load_hf_config(path)
        tcfg = L.LlamaConfig.from_hf(hf)
        v = hf.get('vision_config', {})
        cfg = MV.MiniCPMVConfig(
            text=tcfg, vision=OV.LlavaOnevisionConfig.siglip_block_cfg(
                v.get('hidden_size', 1152), v.get('intermediate_size', 4304),
                v.get('num_hidden_layers', 27),
                v.get('num_attention_heads', 16)),
            image_size=v.get('image_size', 448),
            patch_size=v.get('patch_size', 14),
            num_queries=hf.get('query_num', 64))

        def build(flat):
            params = llama_params_from_hf(
                {k[len('llm.'):]: t for k, t in flat.items()
                 if k.startswith('llm.')}, tcfg.num_hidden_layers,
                tcfg.tie_word_embeddings)
            params.update(MV.vision_params_from_hf(flat, cfg, dtype))
            return params
        params = _load_params(path, dtype, False, device, build)
        return cls(cfg, params, _load_tokenizer(path), hf)

    def _first_input(self, batch):
        ids = self._ids(batch['input_ids'])
        return (MV.lm_embeds(self.params, self.vl_cfg, ids,
                             self._pixels(batch.get('pixel_values'))),
                self._rope_kw(ids))

    def forward_logits(self, input_ids, qmap=None, pixel_values=None):
        return MV.minicpmv_forward(self.params, self.vl_cfg,
                                   self._ids(input_ids),
                                   self._pixels(pixel_values), qmap=qmap)


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
    return tree_to_device(build(LazyHFTensors(path, dtype=dtype)), dev)


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


def build_model(config, device=None) -> BaseAdapter:
    """The adapter ``config.model.type`` names, on ``device`` (``None``:
    the CUDA device).  ``model.offload`` keeps the blocks in host memory
    (``utils/offload.py``; ``offload_model_blocks`` leaves a model whose
    blocks are there already as it is).  The Llama graph's loaders put
    each block there as it is read or drawn, so its model may be larger
    than the card; the other families build on the card and move their
    blocks after the build (ROADMAP A, item 8)."""
    m = config['model']
    model = MODEL_REGISTRY[m['type']].from_config(config, device=device)
    if m.get('offload'):
        offload_model_blocks(model)
    return model
