"""Functional OPT model, facebook/opt-* (port of ``llmc_tpu/models/opt.py``).

LayerNorm (before each sublayer from opt-125m up; after it where
``do_layer_norm_before`` is off, as in opt-350m), biased linears, learned
positions at an offset of 2, a ReLU MLP, and an embedding projected in
and out where ``word_embed_proj_dim`` differs from the hidden size.  The
native graph here is what calibration and the PPL evals run;
``to_generalized`` maps the mainline shape (LayerNorm before, no
projection) onto the Llama graph (``models/llama.py``: ``norm_type='ln'``,
no rope, a non-gated ReLU MLP, learned positions at +2), which the cached
decode and the serving engine run.

Subsets as in the reference: qkv (after ``self_attn_layer_norm``), out
(after ``v_proj``), fc1 (after ``final_layer_norm``) and fc2 (after fc1,
no scale transform across the ReLU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .base import BlockLayout, SubsetSpec, layer_norm, linear_apply, \
    matmul_f32_acc
from .llama import Init

F32 = torch.float32
# HF's OPTLearnedPositionalEmbedding reads its table at position + 2
POS_OFFSET = 2


@dataclasses.dataclass(frozen=True)
class OptConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    do_layer_norm_before: bool = True
    word_embed_proj_dim: int = 0  # 0: the hidden size (no projection)
    dtype: str = 'float32'

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def from_hf(cls, hf: dict) -> 'OptConfig':
        proj = hf.get('word_embed_proj_dim', hf['hidden_size'])
        return cls(
            vocab_size=hf['vocab_size'], hidden_size=hf['hidden_size'],
            ffn_dim=hf['ffn_dim'],
            num_hidden_layers=hf['num_hidden_layers'],
            num_attention_heads=hf['num_attention_heads'],
            max_position_embeddings=hf['max_position_embeddings'],
            do_layer_norm_before=hf.get('do_layer_norm_before', True),
            word_embed_proj_dim=0 if proj == hf['hidden_size'] else proj,
            dtype='float32')


def _qc(qmap, path: str):
    return qmap.get(path) if qmap is not None else None


def _ln(p: Dict, x: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    return layer_norm(x, p['w'], p.get('b'), cfg.layer_norm_eps)


def attention_apply(p: Dict, cfg: OptConfig, x: torch.Tensor,
                    attn_bias: Optional[torch.Tensor], qmap=None):
    """Full causal attention (or ``attn_bias`` in place of the causal
    mask).  Returns (out, o_in)."""
    B, S, D = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    q = linear_apply(p['q_proj'], x, _qc(qmap, 'self_attn.q_proj'))
    k = linear_apply(p['k_proj'], x, _qc(qmap, 'self_attn.k_proj'))
    v = linear_apply(p['v_proj'], x, _qc(qmap, 'self_attn.v_proj'))
    q, k, v = (t.reshape(B, S, H, hd) for t in (q, k, v))
    scores = torch.einsum('bqhd,bkhd->bhqk', q.to(F32),
                          k.to(F32)) / (hd ** 0.5)
    if attn_bias is not None:
        scores = scores + attn_bias.to(F32)
    else:
        keep = (torch.arange(S, device=x.device)[:, None]
                >= torch.arange(S, device=x.device)[None, :])
        scores = scores.masked_fill(~keep, float('-inf'))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum('bhqk,bkhd->bqhd', probs.to(F32),
                       v.to(F32)).to(x.dtype)
    o_in = ctx.reshape(B, S, D)
    out = linear_apply(p['out_proj'], o_in, _qc(qmap, 'self_attn.out_proj'))
    return out, o_in


def block_apply(bp: Dict, cfg: OptConfig, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, qmap=None,
                capture: bool = False):
    """One decoder block.  Returns (y, captures); captures is {} unless
    ``capture`` (keys qkv_in, o_in, fc1_in, fc2_in)."""
    caps = {}
    pre = cfg.do_layer_norm_before
    h = _ln(bp['self_attn_layer_norm'], x, cfg) if pre else x
    if capture:
        caps['qkv_in'] = h
    attn_out, o_in = attention_apply(bp['self_attn'], cfg, h, attn_bias,
                                     qmap)
    if capture:
        caps['o_in'] = o_in
    x = x + attn_out
    if not pre:
        x = _ln(bp['self_attn_layer_norm'], x, cfg)
    h = _ln(bp['final_layer_norm'], x, cfg) if pre else x
    if capture:
        caps['fc1_in'] = h
    f1 = linear_apply(bp['fc1'], h, _qc(qmap, 'fc1'))
    f1 = torch.relu(f1.to(F32)).to(x.dtype)
    if capture:
        caps['fc2_in'] = f1
    x = x + linear_apply(bp['fc2'], f1, _qc(qmap, 'fc2'))
    if not pre:
        x = _ln(bp['final_layer_norm'], x, cfg)
    return x, caps


def opt_layout(cfg: OptConfig) -> BlockLayout:
    subsets = (
        SubsetSpec(name='qkv',
                   layers=('self_attn.q_proj', 'self_attn.k_proj',
                           'self_attn.v_proj'),
                   prev_op='self_attn_layer_norm', prev_kind='ln',
                   input_key='qkv_in', inspect='attn', has_kwargs=True),
        SubsetSpec(name='out', layers=('self_attn.out_proj',),
                   prev_op='self_attn.v_proj', prev_kind='fc',
                   input_key='o_in', inspect='out_proj'),
        SubsetSpec(name='fc1', layers=('fc1',),
                   prev_op='final_layer_norm', prev_kind='ln',
                   input_key='fc1_in', inspect='fc1', is_mlp=True),
        # no fc1 -> fc2 scale transform: a ReLU sits between them
        SubsetSpec(name='fc2', layers=('fc2',), prev_op='fc1',
                   prev_kind='fc', input_key='fc2_in', inspect='fc2',
                   is_mlp=True, do_trans=False),
    )
    linears = ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj',
               'self_attn.out_proj', 'fc1', 'fc2')
    capture_of = (('self_attn.q_proj', 'qkv_in'),
                  ('self_attn.k_proj', 'qkv_in'),
                  ('self_attn.v_proj', 'qkv_in'),
                  ('self_attn.out_proj', 'o_in'),
                  ('fc1', 'fc1_in'), ('fc2', 'fc2_in'))
    return BlockLayout(subsets=subsets, linears=linears,
                       layernorms=('self_attn_layer_norm',
                                   'final_layer_norm'),
                       capture_of=capture_of)


def make_inspect_fns(cfg: OptConfig):
    """Named functions (bp, subset_input, kwargs) -> subset output."""

    def attn(bp, h, kw, qmap=None):
        return attention_apply(bp['self_attn'], cfg, h, kw.get('attn_bias'),
                               qmap)[0]

    def lin(path, key):
        def fn(bp, x, kw, qmap=None):
            p = bp['self_attn'][key] if path.startswith('self_attn') \
                else bp[key]
            return linear_apply(p, x, _qc(qmap, path))
        return fn

    return {'attn': attn, 'out_proj': lin('self_attn.out_proj', 'out_proj'),
            'fc1': lin('fc1', 'fc1'), 'fc2': lin('fc2', 'fc2')}


def embed_apply(params: Dict, cfg: OptConfig,
                input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding (projected in where the params hold
    ``project_in``) plus the learned positions of 0..S-1 at +2, clamped
    to the table as a JAX gather clamps its indices."""
    x = params['embed_tokens']['w'][input_ids]
    if params.get('project_in') is not None:
        x = linear_apply(params['project_in'], x)
    table = params['embed_positions']['w']
    pos = torch.clamp(torch.arange(input_ids.shape[1],
                                   device=input_ids.device) + POS_OFFSET,
                      max=table.shape[0] - 1)
    return x + table[pos][None]


def head_apply(params: Dict, cfg: OptConfig, x: torch.Tensor
               ) -> torch.Tensor:
    """The final LayerNorm (where the params hold one), ``project_out``,
    then the head -> float32 logits."""
    if params.get('final_layer_norm') is not None:
        x = _ln(params['final_layer_norm'], x, cfg)
    if params.get('project_out') is not None:
        x = linear_apply(params['project_out'], x)
    return matmul_f32_acc(x, params['lm_head']['w'])


def model_apply(params: Dict, cfg: OptConfig, input_ids: torch.Tensor,
                qmap=None) -> torch.Tensor:
    """Full forward to logits (no KV cache)."""
    x = embed_apply(params, cfg, input_ids)
    for bp in params['blocks']:
        x, _ = block_apply(bp, cfg, x, qmap=qmap)
    return head_apply(params, cfg, x)


def params_from_hf(flat, cfg: OptConfig) -> Dict:
    """The params tree from an HF checkpoint's flat tensors; the head is
    the embedding where the checkpoint has no ``lm_head`` (tied)."""
    pre = 'model.decoder'

    def lin(prefix):
        return {'w': flat[f'{prefix}.weight'],
                'b': flat.get(f'{prefix}.bias')}

    def opt(prefix):
        return lin(prefix) if f'{prefix}.weight' in flat else None

    blocks = []
    for i in range(cfg.num_hidden_layers):
        b = f'{pre}.layers.{i}'
        blocks.append({
            'self_attn_layer_norm': lin(f'{b}.self_attn_layer_norm'),
            'self_attn': {n: lin(f'{b}.self_attn.{n}')
                          for n in ('q_proj', 'k_proj', 'v_proj',
                                    'out_proj')},
            'final_layer_norm': lin(f'{b}.final_layer_norm'),
            'fc1': lin(f'{b}.fc1'),
            'fc2': lin(f'{b}.fc2'),
        })
    embed = flat[f'{pre}.embed_tokens.weight']
    return {
        'embed_tokens': {'w': embed},
        'embed_positions': {'w': flat[f'{pre}.embed_positions.weight']},
        'blocks': blocks,
        'final_layer_norm': opt(f'{pre}.final_layer_norm'),
        'project_in': opt(f'{pre}.project_in'),
        'project_out': opt(f'{pre}.project_out'),
        'lm_head': {'w': flat.get('lm_head.weight', embed), 'b': None},
    }


def params_to_hf(params: Dict) -> Dict[str, torch.Tensor]:
    """The flat HF tensors of a params tree, ``params_from_hf``'s way
    back (the head left out: OPT ties it to the embedding), as host copies
    taken one block at a time (an offloaded model's blocks never sit on
    the device together)."""
    pre = 'model.decoder'
    flat = {}

    def put(prefix, p):
        if p is None:
            return
        flat[f'{prefix}.weight'] = p['w'].detach().to('cpu')
        if p.get('b') is not None:
            flat[f'{prefix}.bias'] = p['b'].detach().to('cpu')

    put(f'{pre}.embed_tokens', params['embed_tokens'])
    put(f'{pre}.embed_positions', params['embed_positions'])
    for name in ('final_layer_norm', 'project_in', 'project_out'):
        put(f'{pre}.{name}', params.get(name))
    for i, bp in enumerate(params['blocks']):
        b = f'{pre}.layers.{i}'
        for name in ('self_attn_layer_norm', 'final_layer_norm', 'fc1',
                     'fc2'):
            put(f'{b}.{name}', bp[name])
        for name, p in bp['self_attn'].items():
            put(f'{b}.self_attn.{name}', p)
    return flat


def init_params(cfg: OptConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params drawn from ``generator`` in the reference's scales
    (a linear N(0, 0.6 / sqrt(in)) with a zero bias, the embeddings
    N(0, 0.02), LayerNorms of ones and zeros), the head tied to the token
    embedding."""
    ini = Init(generator, cfg.tdtype, device)
    D, F = cfg.hidden_size, cfg.ffn_dim
    blocks = [{
        'self_attn_layer_norm': ini.norm(D, True),
        'self_attn': {n: ini.lin(D, D, True)
                      for n in ('q_proj', 'k_proj', 'v_proj', 'out_proj')},
        'final_layer_norm': ini.norm(D, True),
        'fc1': ini.lin(F, D, True), 'fc2': ini.lin(D, F, True),
    } for _ in range(cfg.num_hidden_layers)]
    embed = ini.embed(cfg.vocab_size, D)
    return {
        'embed_tokens': embed,
        'embed_positions': ini.embed(cfg.max_position_embeddings
                                     + POS_OFFSET, D),
        'blocks': blocks,
        'final_layer_norm': ini.norm(D, True),
        'project_in': None, 'project_out': None,
        'lm_head': {'w': embed['w'], 'b': None},
    }


def to_generalized(cfg: OptConfig, params: Dict):
    """(LlamaConfig, params) of the same model on the Llama graph:
    LayerNorm, no rope, a non-gated ReLU MLP and learned positions at +2,
    for the cached decode and the serving engine.  The tensors are
    shared.  Only the mainline shape maps (LayerNorm before each
    sublayer, no embedding projection), as in the reference: opt-350m's
    layout keeps the native graph."""
    from . import llama as L
    if not cfg.do_layer_norm_before or cfg.word_embed_proj_dim:
        raise NotImplementedError(
            'generalized OPT decode requires do_layer_norm_before=True '
            'and no word_embed projection')
    lcfg = L.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.ffn_dim,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_attention_heads,
        head_dim=cfg.head_dim, rms_norm_eps=cfg.layer_norm_eps,
        max_position_embeddings=cfg.max_position_embeddings,
        dtype=cfg.dtype, norm_type='ln', rotary_pct=0.0, act_fn='relu',
        learned_pos=True, learned_pos_offset=POS_OFFSET, gated_mlp=False)
    blocks = [{
        'input_layernorm': bp['self_attn_layer_norm'],
        'self_attn': {'q_proj': bp['self_attn']['q_proj'],
                      'k_proj': bp['self_attn']['k_proj'],
                      'v_proj': bp['self_attn']['v_proj'],
                      'o_proj': bp['self_attn']['out_proj']},
        'post_attention_layernorm': bp['final_layer_norm'],
        'mlp': {'up_proj': bp['fc1'], 'down_proj': bp['fc2']},
    } for bp in params['blocks']]
    fl = params.get('final_layer_norm')
    if fl is None:  # no head LayerNorm: an identity one
        w = params['embed_tokens']['w']
        fl = {'w': torch.ones((cfg.hidden_size,), dtype=w.dtype,
                              device=w.device),
              'b': torch.zeros((cfg.hidden_size,), dtype=w.dtype,
                               device=w.device)}
    return lcfg, {'embed_tokens': params['embed_tokens'],
                  'embed_positions': params['embed_positions'],
                  'blocks': blocks, 'norm': fl,
                  'lm_head': params['lm_head']}
