"""Port parity of the W4A8 / W8 serving modes (llmc_tpu_torch.serve):
the w8 companion packing, the a_int8 and w8_alt wiring of linear_apply,
LLMC_ATTN, the engine's prefill_w8 / decode_w8 modes, the asymmetric int8
KV decode and the signed-code conversion, held against llmc_tpu on the
CPU."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.base import linear_apply as j_linear_apply
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve import packed as JP
from llmc_tpu.serve.decode import forward_cached as j_forward_cached
from llmc_tpu.serve.decode import init_cache as j_init_cache
from llmc_tpu.serve.engine import Request as JRequest
from llmc_tpu.serve.engine import ServingEngine as JEngine
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu_torch.convert import params_from_numpy
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models.base import linear_apply
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve import (KVCachePolicy, Request, ServingEngine,
                                  pack_model, random_packed_llama)
from llmc_tpu_torch.serve import decode as TDec
from llmc_tpu_torch.serve import packed as TP
from llmc_tpu_torch.serve.decode import forward_cached, init_cache
from torch_port_helpers import TINY, WSPEC, port_params, rel_err, to_np

JD = importlib.import_module('llmc_tpu.ops.dequant_matmul')
TD = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
torch.set_num_threads(1)

W8SPEC = dict(bit=8, symmetric=True, granularity='per_group', group_size=32)
INT8 = dict(method='naive', bit=8)
FUSED = ('self_attn.qkv_proj', 'self_attn.o_proj', 'mlp.gate_up_proj',
         'mlp.down_proj')


def _pair(wspec=WSPEC, seed=0, **pack_kw):
    """A JAX model packed by JAX's pack_model and the port's copy of the
    same tree, with the serving QMap of each package."""
    jm = JAdapter.random(JConfig(**TINY), seed=seed)
    jq = JP.pack_model(jm, JSpec(**wspec), fuse=True, head=True, **pack_kw)
    cfg = LlamaConfig(**TINY)
    tq = TP.packed_qmap(cfg, QuantSpec(**wspec), fuse=True, pre_t=True,
                        head=True, a_int8=pack_kw.get('a_int8', False))
    tm = LlamaAdapter(cfg, params_from_numpy(to_np(jm.params), device='cpu',
                                             qmap=tq))
    return jm, jq, tm, tq


@pytest.fixture(scope='module')
def companion_pair():
    return _pair(w8_prefill=True)


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

def test_w8_companion_bit_equal():
    w = np.random.RandomState(0).randn(24, 64).astype(np.float32)
    jq8, js8 = JP.w8_companion(jnp.asarray(w))
    tq8, ts8 = TP.w8_companion(torch.as_tensor(w))
    assert tq8.dtype == torch.int8 and ts8.shape == (24,)
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts8.numpy(), np.asarray(js8))


@pytest.mark.parametrize('pre_t', [True, False])
def test_pack_model_w8_prefill_bit_equal_to_jax(pre_t):
    """pack_model(w8_prefill=True) stores the same companion codes and
    scales as JAX beside every block linear, fused ones included, and
    none on the head."""
    jm = JAdapter.random(JConfig(**TINY), seed=2)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    jq = JP.pack_model(jm, JSpec(**WSPEC), fuse=True, head=True,
                       pre_t=pre_t, w8_prefill=True)
    tq = pack_model(tm, QuantSpec(**WSPEC), fuse=True, head=True,
                    pre_t=pre_t, w8_prefill=True)
    jp = to_np(jm.params)
    for path in FUSED:
        a, b = path.split('.')
        for i in range(TINY['num_hidden_layers']):
            lin = tm.blocks[i][a][b]
            assert lin['qweight8'].dtype == torch.int8
            for k in ('qweight', 'scales', 'zeros', 'qweight8', 'scales8'):
                if k in lin:
                    np.testing.assert_array_equal(
                        lin[k].numpy(), jp['blocks'][i][a][b][k])
        assert tq.get(path).qmeta.__dict__ == jq.get(path).qmeta.__dict__
    assert 'qweight8' not in tm.params['lm_head']


def test_prefill_qmap_from_equals_jax():
    cfg = LlamaConfig(**TINY)
    tq = TP.packed_qmap(cfg, QuantSpec(**WSPEC), fuse=True, pre_t=True,
                        head=True, a_int8=True)
    jq = JP.packed_qmap(JConfig(**TINY), JSpec(**WSPEC), fuse=True,
                        pre_t=True, head=True, a_int8=True)
    assert not tq.get('lm_head').a_int8 and tq.get('mlp.down_proj').a_int8
    t8, j8 = TP.prefill_qmap_from(tq), JP.prefill_qmap_from(jq)
    for path in FUSED + ('self_attn.q_proj', 'lm_head'):
        t, j = t8.get(path), j8.get(path)
        assert (t.a_int8, t.w8_alt, t.w_packed) == (j.a_int8, j.w8_alt,
                                                    j.w_packed)
        assert t.qmeta.__dict__ == j.qmeta.__dict__
    assert t8.get('lm_head') == tq.get('lm_head')
    m = t8.get('mlp.down_proj').qmeta
    assert (m.bits, m.group_size, m.symmetric) == (8, m.in_features, True)
    # a_spec (which raised until activation quantization was ported) goes
    # on every entry, the head's too, and prefill_qmap_from keeps it
    aq = TP.packed_qmap(cfg, QuantSpec(**WSPEC), a_spec=QuantSpec(bit=8),
                        fuse=True, head=True)
    ja = JP.packed_qmap(JConfig(**TINY), JSpec(**WSPEC), a_spec=JSpec(bit=8),
                        fuse=True, head=True)
    for path in FUSED + ('lm_head',):
        assert aq.get(path).a_spec == QuantSpec(bit=8)
        assert ja.get(path).a_spec == JSpec(bit=8)
        assert TP.prefill_qmap_from(aq).get(path).a_spec == QuantSpec(bit=8)


@pytest.mark.parametrize('mode', ['a_int8', 'w8_alt', 'plain'])
def test_linear_apply_wiring(companion_pair, mode):
    """linear_apply honours a_int8 and w8_alt as the reference does:
    w8_alt reads ('qweight8', 'scales8') with no zeros."""
    jm, jq, tm, tq = companion_pair
    path = 'mlp.down_proj'
    jl = jm.blocks[0]['mlp']['down_proj']
    tl = tm.blocks[0]['mlp']['down_proj']
    x = np.random.RandomState(1).randn(3, 5, 128).astype(np.float32)
    if mode == 'w8_alt':
        jc = JP.prefill_qmap_from(jq).get(path)
        tc = TP.prefill_qmap_from(tq).get(path)
        assert tc.w8_alt and tc.a_int8
    else:
        a8 = mode == 'a_int8'
        jc = dataclasses.replace(jq.get(path), a_int8=a8)
        tc = dataclasses.replace(tq.get(path), a_int8=a8)
    want = j_linear_apply(jl, jnp.asarray(x), jc)
    got = linear_apply(tl, torch.as_tensor(x), tc)
    assert rel_err(got.numpy(), want) < 1e-5
    base = linear_apply(tl, torch.as_tensor(x), tq.get(path))
    differs = rel_err(got.numpy(), base.numpy()) > 1e-4
    assert differs == (mode != 'plain')       # the flags change the math


def test_random_packed_llama_a_int8_and_bits8():
    cfg = dataclasses.replace(LlamaConfig(**TINY), dtype='bfloat16')
    m, q = random_packed_llama(cfg, QuantSpec(**WSPEC), seed=1, fuse=True,
                               a_int8=True, device='cpu')
    assert q.get('self_attn.qkv_proj').a_int8 and not q.get('lm_head').a_int8
    m8, q8 = random_packed_llama(cfg, QuantSpec(**W8SPEC), seed=1, fuse=True,
                                 device='cpu')
    qkv = m8.blocks[0]['self_attn']['qkv_proj']
    assert qkv['qweight'].dtype == torch.int8
    assert qkv['qweight'].shape == (128, 64) and qkv['qweight'].min() < 0
    assert qkv['scales'].shape == (128, 2) and 'zeros' not in qkv
    meta = q8.get('self_attn.qkv_proj').qmeta
    assert (meta.bits, meta.pre_t, meta.group_size) == (8, False, 32)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 128, (1, 4)))
    fp = KVCachePolicy(method='fp')
    for model, qmap in ((m, q), (m8, q8)):
        cache = init_cache(model, 1, 4, fp, device='cpu')
        logits, _ = forward_cached(model.params, cfg, ids, cache, fp, qmap)
        assert logits.shape == (1, 4, 128) and torch.isfinite(logits).all()


# --------------------------------------------------------------------------
# fault: the converter took every int8 qweight for unsigned nibble bytes
# --------------------------------------------------------------------------

def test_converter_keeps_signed_codes():
    """A bits=8 tree and a tree with the w8 companion, carried across
    from the JAX package, keep their negative codes."""
    jm = JAdapter.random(JConfig(**TINY), seed=3)
    jq = JP.pack_model(jm, JSpec(**W8SPEC), fuse=True, head=True)
    tree = to_np(jm.params)
    tq = TP.packed_qmap(LlamaConfig(**TINY), QuantSpec(**W8SPEC), fuse=True,
                        head=True)
    for kw in (dict(qmap=tq), dict(bits=8)):
        tp = params_from_numpy(tree, device='cpu', **kw)
        for lin, ref in ((tp['blocks'][0]['mlp']['down_proj'],
                          tree['blocks'][0]['mlp']['down_proj']),
                         (tp['lm_head'], tree['lm_head'])):
            assert lin['qweight'].dtype == torch.int8
            assert ref['qweight'].min() < 0
            np.testing.assert_array_equal(lin['qweight'].numpy(),
                                          ref['qweight'])
    with pytest.raises(ValueError, match='qmap= or bits='):
        params_from_numpy(tree, device='cpu')
    # nibble bytes stored as int8 are still reinterpreted under bits=4,
    # and a companion beside them keeps its sign
    nib = {'lm_head': {'qweight': np.array([[-1, 5]], np.int8),
                       'qweight8': np.array([[-7, 7]], np.int8)}}
    t4 = params_from_numpy(nib, device='cpu', bits=4)['lm_head']
    assert t4['qweight'].dtype == torch.uint8
    assert t4['qweight'].tolist() == [[255, 5]]
    assert t4['qweight8'].dtype == torch.int8
    assert t4['qweight8'].tolist() == [[-7, 7]]


def test_bits8_model_from_jax_gives_jax_logits():
    """QuantSpec(bit=8) packed by the JAX package and carried across:
    prefill and decode logits within 1e-5."""
    jm, jq, tm, tq = _pair(W8SPEC, seed=4)
    jp, tp = JPolicy(**INT8), KVCachePolicy(**INT8)
    ids = np.random.RandomState(0).randint(0, 128, (2, 6))
    jc = j_init_cache(jm, 2, 8, jp)
    tc = init_cache(tm, 2, 8, tp, device='cpu')
    jl, jc = j_forward_cached(jm.params, jm.cfg, jnp.asarray(ids), jc, jp, jq)
    tl, tc = forward_cached(tm.params, tm.cfg, torch.as_tensor(ids), tc, tp,
                            tq)
    assert rel_err(tl.numpy(), jl) < 1e-5
    tok = np.asarray(jl[:, -1].argmax(-1))
    jl, _ = j_forward_cached(jm.params, jm.cfg, jnp.asarray(tok)[:, None],
                             jc, jp, jq)
    tl, _ = forward_cached(tm.params, tm.cfg, torch.as_tensor(tok)[:, None],
                           tc, tp, tq)
    assert rel_err(tl.numpy(), jl) < 1e-5


# --------------------------------------------------------------------------
# fault: asymmetric int8 KV decode raised
# --------------------------------------------------------------------------

@pytest.mark.parametrize('per_slot', [False, True])
@pytest.mark.parametrize('attn', ['auto', 'batch'])
def test_asymmetric_int8_kv_decode_matches_jax(per_slot, attn, monkeypatch):
    """The reference serves the asymmetric int8 cache through its XLA
    reads (no Pallas kernel takes k_z); the port's decode step takes its
    plain masked read, whatever ATTN_IMPL says: f32 logits within 1e-5,
    lockstep and per-slot positions."""
    monkeypatch.setattr(TDec, 'ATTN_IMPL', attn)
    jm, jq, tm, tq = _pair(seed=5)
    kw = dict(method='naive', bit=8, symmetric=False)
    jp, tp = JPolicy(**kw), KVCachePolicy(**kw)
    ids = np.random.RandomState(1).randint(0, 128, (2, 6))
    jc = j_init_cache(jm, 2, 10, jp)
    tc = init_cache(tm, 2, 10, tp, device='cpu')
    assert 'k_z' in tc
    jl, jc = j_forward_cached(jm.params, jm.cfg, jnp.asarray(ids), jc, jp, jq)
    tl, tc = forward_cached(tm.params, tm.cfg, torch.as_tensor(ids), tc, tp,
                            tq)
    if per_slot:      # slot 1 steps back two positions
        jc = dict(jc, pos=jnp.asarray([6, 4], jnp.int32))
        tc = dict(tc, pos=torch.tensor([6, 4], dtype=torch.int32))
    tok = np.asarray(jl[:, -1].argmax(-1))
    for _ in range(2):
        jl, jc = j_forward_cached(jm.params, jm.cfg,
                                  jnp.asarray(tok)[:, None], jc, jp, jq)
        tl, tc = forward_cached(tm.params, tm.cfg,
                                torch.as_tensor(tok)[:, None], tc, tp, tq)
        assert rel_err(tl.numpy(), jl) < 1e-5
        tok = np.asarray(jl[:, -1].argmax(-1))


# --------------------------------------------------------------------------
# LLMC_ATTN
# --------------------------------------------------------------------------

@pytest.mark.parametrize('kv', ['fp', 'int8'])
def test_attn_impl_batch_equals_flash(kv, monkeypatch):
    """ATTN_IMPL='batch' gives the decode logits of 'flash' (the same
    function, blocked differently), lockstep and per-slot."""
    _, _, tm, tq = _pair(seed=6)
    tp = KVCachePolicy(**(INT8 if kv == 'int8' else dict(method='fp')))
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 128, (4, 7)))
    outs = {}
    for impl in ('flash', 'batch'):
        monkeypatch.setattr(TDec, 'ATTN_IMPL', impl)
        tc = init_cache(tm, 4, 12, tp, device='cpu')
        logits, tc = forward_cached(tm.params, tm.cfg, ids, tc, tp, tq)
        tc = dict(tc, pos=torch.tensor([7, 3, 5, 7], dtype=torch.int32))
        rows = []
        tok = logits[:, -1].argmax(-1)
        for _ in range(3):
            logits, tc = forward_cached(tm.params, tm.cfg, tok[:, None], tc,
                                        tp, tq)
            rows.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)
        outs[impl] = torch.stack(rows).numpy()
    assert rel_err(outs['batch'], outs['flash']) < 1e-5


@pytest.mark.parametrize('impl', ['chunked', 'full', 'nonsense'])
def test_attn_impl_unported_reads_raise(impl, monkeypatch):
    """The chunked and full reads, which raised until they were ported,
    give the decode logits of 'flash' (within 1e-5) on a packed model;
    an unknown name raises."""
    _, _, tm, tq = _pair(seed=6)
    tp = KVCachePolicy(method='fp')
    ids = torch.zeros((1, 1), dtype=torch.long)
    outs = {}
    for name in (impl, 'flash'):
        monkeypatch.setattr(TDec, 'ATTN_IMPL', name)
        tc = init_cache(tm, 1, 64, tp, device='cpu')
        tc = dict(tc, pos=torch.tensor([37], dtype=torch.int32))
        if name == 'nonsense':
            with pytest.raises(ValueError, match='LLMC_ATTN'):
                forward_cached(tm.params, tm.cfg, ids, tc, tp, tq)
            continue
        outs[name] = forward_cached(tm.params, tm.cfg, ids, tc, tp,
                                    tq)[0].numpy()
    if impl != 'nonsense':
        assert rel_err(outs[impl], outs['flash']) < 1e-5
    assert TDec._decode_kernel.__module__ == TDec.__name__


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

ENGINE_PROMPT_LENS = (5, 9, 12, 6, 14)


def _prompts(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)) for n in ENGINE_PROMPT_LENS]


@pytest.mark.parametrize('mode', ['a_int8', 'prefill_w8', 'decode_w8'])
def test_engine_w8_modes_tokens_equal_jax(mode):
    """ServingEngine with W4A8 activations, and with the w8 companion on
    prefill or on every forward, gives the JAX engine's tokens request
    for request, on fixed data (an int8 code on a rounding tie can flip
    between the two frameworks; see the engine test of the W4A16 path)."""
    a8 = mode == 'a_int8'
    jm, jq, tm, tq = _pair(seed=0, a_int8=a8, w8_prefill=not a8)
    kw = {} if a8 else {mode: True}
    prompts = _prompts()
    je = JEngine(jm, qmap=jq, max_batch=3, max_len=48, prefill_buckets=(8, 16),
                 kv_policy=JPolicy(**INT8), **kw)
    want = je.run([JRequest(uid=i, prompt_ids=p, max_new_tokens=5 + i)
                   for i, p in enumerate(prompts)])
    te = ServingEngine(tm, qmap=tq, max_batch=3, max_len=48,
                       prefill_buckets=(8, 16), kv_policy=KVCachePolicy(**INT8),
                       device='cpu', **kw)
    got = te.run([Request(uid=i, prompt_ids=p, max_new_tokens=5 + i)
                  for i, p in enumerate(prompts)])
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert all(r.done for r in got)
    if not a8:
        w8 = te.qmap_prefill.get('mlp.down_proj')
        assert w8.w8_alt and w8.qmeta.bits == 8
        assert te.qmap.get('mlp.down_proj').w8_alt == (mode == 'decode_w8')
        assert not te.qmap_prefill.get('lm_head').w8_alt


@pytest.mark.parametrize('flag', ['prefill_w8', 'decode_w8'])
def test_engine_w8_without_companion_raises(flag):
    """Either flag on a model packed without the companion fails at
    construction, naming the linear."""
    _, _, tm, tq = _pair(seed=0)
    with pytest.raises(ValueError, match='w8 companion'):
        ServingEngine(tm, qmap=tq, max_batch=2, max_len=48, device='cpu',
                      **{flag: True})
