"""Port parity of the Llama-family adapters' graphs and the generalized
block graph (llmc_tpu_torch.models.llama, serve.decode): every arch of the
JAX package's tests/test_decode_families.py, and Qwen2, Qwen3, Phi3,
Mistral and SmolLM, on the same numpy weights (biases and norms drawn
away from their zero / one init, so that they count), held against
llmc_tpu on the CPU: model_apply, the layout, prefill plus five decode
steps on fp and int8 caches (the engine's greedy tokens:
tests/test_torch_family_engine.py).  Then the chunked and full decode
reads (``LLMC_ATTN``) against the reference's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.serve import decode as JDec
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu_torch.models import LlamaConfig
from llmc_tpu_torch.serve import KVCachePolicy
from llmc_tpu_torch.serve import decode as TDec
from torch_port_helpers import ARCHS, BASE, family_pair, rel_err

torch.set_num_threads(1)

POLICIES = {'fp': dict(method='fp'), 'int8': dict(method='naive', bit=8)}
IDS = np.random.RandomState(0).randint(0, 96, (2, 10))


_PAIRS = {}


@pytest.fixture(scope='module')
def pairs():
    """One model pair per arch, shared by the module's tests."""
    def get(name):
        if name not in _PAIRS:
            _PAIRS[name] = family_pair(name)
        return _PAIRS[name]
    yield get
    _PAIRS.clear()


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_model_apply_matches_jax(pairs, name):
    jm, tm, _ = pairs(name)
    want = np.asarray(jm.forward_logits(jnp.asarray(IDS)))
    got = tm.forward_logits(torch.as_tensor(IDS)).numpy()
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_layout_matches_jax(pairs, name):
    jm, tm, _ = pairs(name)
    jl, tl = jm.get_layout(), tm.get_layout()
    assert jl.linears == tl.linears and jl.capture_of == tl.capture_of
    assert jl.layernorms == tl.layernorms
    assert [(s.name, s.layers, s.prev_op, s.prev_kind, s.is_gqa)
            for s in jl.subsets] == [(s.name, s.layers, s.prev_op,
                                      s.prev_kind, s.is_gqa)
                                     for s in tl.subsets]
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(tm.cfg)


@pytest.mark.parametrize('kv', sorted(POLICIES))
@pytest.mark.parametrize('name', sorted(ARCHS))
def test_forward_cached_prefill_and_decode_match_jax(pairs, name, kv):
    """A prefill of 5 tokens and five decode steps (the window, softcap
    and ALiBi masks of the plain read; B2's plain version where the
    reference's attn_ok lets a kernel take the step): every step's
    logits within 2e-4 of the JAX package's (its own test's tolerance),
    and the last within 2e-4 of model_apply's."""
    jm, tm, _ = pairs(name)
    jp, tp = JPolicy(**POLICIES[kv]), KVCachePolicy(**POLICIES[kv])
    jc = JDec.init_cache(jm, 2, 10, jp)
    tc = TDec.init_cache(tm, 2, 10, tp, device='cpu')
    for lo, hi in [(0, 5)] + [(t, t + 1) for t in range(5, 10)]:
        jl, jc = JDec.forward_cached(jm.params, jm.cfg,
                                     jnp.asarray(IDS[:, lo:hi]), jc, jp)
        tl, tc = TDec.forward_cached(tm.params, tm.cfg,
                                     torch.as_tensor(IDS[:, lo:hi]), tc, tp)
        assert rel_err(tl.numpy(), jl) < 2e-4, (lo, hi)
    full = tm.forward_logits(torch.as_tensor(IDS)).numpy()
    if kv == 'fp':
        np.testing.assert_allclose(tl[:, -1].numpy(), full[:, -1],
                                   rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# the chunked and full decode reads
# --------------------------------------------------------------------------

def _random_cache(policy, rng, shape=(2, 3, 64, 2, 8)):
    """A cache of ``policy`` (fp, symmetric or asymmetric int8) filled by
    the policy's own write of random K / V, both packages' copies."""
    L, B, S, KVH, hd = shape
    k = rng.randn(B, S, KVH, hd).astype(np.float32)
    v = rng.randn(B, S, KVH, hd).astype(np.float32)
    jc = JPolicy(**policy).init_cache(B, S, KVH, hd, L, dtype=jnp.float32)
    tc = KVCachePolicy(**policy).init_cache(B, S, KVH, hd, L,
                                            dtype=torch.float32, device='cpu')
    for layer in range(L):
        jc = JPolicy(**policy).update(jc, layer, jnp.asarray(k),
                                      jnp.asarray(v))
        tc = KVCachePolicy(**policy).update(tc, layer, torch.as_tensor(k),
                                            torch.as_tensor(v))
    return jc, tc


@pytest.mark.parametrize('policy', [dict(method='fp'),
                                    dict(method='naive', bit=8),
                                    dict(method='naive', bit=8,
                                         symmetric=False)],
                         ids=['fp', 'int8', 'int8_asym'])
def test_chunked_read_matches_reference(policy):
    """``_decode_attn_chunked`` against the reference's over the same
    cache, per-slot positions on and off the chunk boundaries, GQA (2
    query heads a kv head): within 1e-5."""
    rng = np.random.RandomState(4)
    jc, tc = _random_cache(policy, rng)
    q = (rng.randn(3, 1, 4, 8) / 8 ** 0.5).astype(np.float32)
    cfg = LlamaConfig(**dict(BASE, num_attention_heads=4,
                             num_key_value_heads=2))
    pos = np.array([0, 31, 40], np.int32)
    jc, tc = dict(jc, pos=jnp.asarray(pos)), dict(tc, pos=torch.as_tensor(pos))
    for layer in (0, 1):
        want = JDec._decode_attn_chunked(jnp.asarray(q), jc, layer,
                                         JPolicy(**policy), cfg, 32)
        got = TDec._decode_attn_chunked(torch.as_tensor(q), tc, layer,
                                        KVCachePolicy(**policy), cfg, 32)
        assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('policy', [dict(method='fp'),
                                    dict(method='naive', bit=8),
                                    dict(method='naive', bit=8,
                                         symmetric=False)],
                         ids=['fp', 'int8', 'int8_asym'])
def test_chunked_read_every_chunk_equals_prefix(policy):
    """The loop a CUDA graph captures (every chunk of the buffer) gives
    the same bits as the eager loop up to the largest position's chunk:
    the masked tail's chunks add exactly nothing, with per-slot positions
    in the first, second and third of four chunks."""
    rng = np.random.RandomState(5)
    _, tc = _random_cache(policy, rng, shape=(2, 3, 128, 2, 8))
    q = torch.as_tensor((rng.randn(3, 1, 4, 8) / 8 ** 0.5).astype(
        np.float32))
    cfg = LlamaConfig(**dict(BASE, num_attention_heads=4,
                             num_key_value_heads=2))
    tp = KVCachePolicy(**policy)
    for pos in ([0, 31, 40], [3, 17, 95], [32, 32, 32]):
        c = dict(tc, pos=torch.as_tensor(np.array(pos, np.int32)))
        for layer in (0, 1):
            prefix = TDec._decode_attn_chunked(q, c, layer, tp, cfg, 32)
            every = TDec._decode_attn_chunked(q, c, layer, tp, cfg, 32,
                                              n_chunks=128 // 32)
            assert torch.equal(every, prefix), (pos, layer)


@pytest.mark.parametrize('kv', sorted(POLICIES))
@pytest.mark.parametrize('impl', ['chunked', 'full'])
def test_attn_reads_match_reference(pairs, monkeypatch, impl, kv):
    """``LLMC_ATTN`` = chunked / full on both packages: a prefill and
    decode steps whose logits stay within 1e-5 of the reference's, and
    within 1e-5 of the port's default (B2's plain version on the CPU)."""
    jm, tm, _ = pairs('llama')
    ids = torch.as_tensor(IDS)
    outs = {}
    for attn in (impl, 'auto'):
        monkeypatch.setattr(TDec, 'ATTN_IMPL', attn)
        monkeypatch.setattr(JDec, 'ATTN_IMPL', attn)
        jp, tp = JPolicy(**POLICIES[kv]), KVCachePolicy(**POLICIES[kv])
        jc = JDec.init_cache(jm, 2, 64, jp)
        tc = TDec.init_cache(tm, 2, 64, tp, device='cpu')
        rows = []
        for lo, hi in [(0, 5)] + [(t, t + 1) for t in range(5, 10)]:
            jl, jc = JDec.forward_cached(jm.params, jm.cfg,
                                         jnp.asarray(IDS[:, lo:hi]), jc, jp)
            tl, tc = TDec.forward_cached(tm.params, tm.cfg, ids[:, lo:hi],
                                         tc, tp)
            assert rel_err(tl.numpy(), jl) < 1e-5, (attn, lo)
            rows.append(tl[:, -1].numpy())
        outs[attn] = np.stack(rows)
    assert rel_err(outs[impl], outs['auto']) < 1e-5


def test_no_kernel_where_attn_ok_is_false():
    """The reference's attn_ok: a decode step on a graph with ALiBi, a
    softcap or a sliding window, or over more than one token, takes the
    plain read (no kernel); the others may take one."""
    fp = KVCachePolicy(method='fp')
    for name, takes in (('llama', True), ('qwen3', True), ('glm', True),
                        ('gemma2', False), ('bloom', False),
                        ('falcon_alibi', False), ('falcon', True)):
        cfg = LlamaConfig(**dict(BASE, **ARCHS[name]))
        assert TDec.kernel_takes_attention(cfg, 1, fp) is takes, name
        assert not TDec.kernel_takes_attention(cfg, 2, fp)
    assert not TDec.kernel_takes_attention(
        LlamaConfig(**BASE), 1, KVCachePolicy(method='sink'))


@pytest.mark.parametrize('name', ['gemma2', 'bloom', 'falcon_alibi',
                                  'llama'])
def test_paged_read_refuses_what_it_would_drop(name):
    """The paged pool's read has no ALiBi, softcap or window: the
    reference's decodes another function with no error (ROADMAP C); the
    port raises for those graphs and decodes the others."""
    from llmc_tpu_torch.serve.paged_cache import PagedKVPolicy
    _, tm, _ = family_pair(name)
    policy = PagedKVPolicy(page_size=8, n_pages=4, max_pages=2, bit=0)
    cache = policy.init_cache(1, 16, tm.cfg.num_key_value_heads,
                              tm.cfg.head_dim, tm.cfg.num_hidden_layers,
                              dtype=torch.float32, device='cpu')
    cache['table'][0] = torch.tensor([0, 1], dtype=torch.int32)
    ids = torch.zeros((1, 1), dtype=torch.long)
    if name == 'llama':
        logits, _ = TDec.forward_cached(tm.params, tm.cfg, ids, cache, policy)
        assert torch.isfinite(logits).all()
    else:
        with pytest.raises(NotImplementedError, match='ROADMAP C'):
            TDec.forward_cached(tm.params, tm.cfg, ids, cache, policy)
