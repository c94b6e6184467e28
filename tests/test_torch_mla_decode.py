"""The absorbed-latent MLA cache of the port (serve/mla_decode.py) and the
engine's MLA branches against the JAX package's on the CPU at float32:
``_quant_latent`` bit for bit against the jitted reference (8 and 4
bits); the chunked online-softmax read against the reference's; the
fixed trip count (every chunk of the buffer, which a captured CUDA graph
can replay) bit for bit against the valid-prefix loop; the cached forward
prefill then decode, lockstep and per slot, through the chunked and the
full reads; greedy generation; and the serving engine's tokens against
the JAX engine's on the fp and int8 latent caches, with chunked admission
and the 4-bit latent, and its refusals.  Inputs are made with numpy from a
seed; 1e-5 relative unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import deepseek as JDS
from llmc_tpu.models.adapter import DeepseekV2Adapter as JAdapter
from llmc_tpu.serve import mla_decode as JMD
from llmc_tpu_torch.models import deepseek as DS
from llmc_tpu_torch.models.adapter import DeepseekV2Adapter
from llmc_tpu_torch.serve import mla_decode as MD
from torch_port_helpers import DS_TINY, port_params, rel_err

TOL = 1e-5


@pytest.fixture(scope='module')
def models():
    jm = JAdapter.random(JDS.DeepseekConfig(**DS_TINY), seed=4)
    return jm, DeepseekV2Adapter(DS.DeepseekConfig(**DS_TINY),
                                 port_params(jm.params))


@pytest.mark.parametrize('bit', [8, 4])
def test_quant_latent_bit_equal_to_jitted_reference(bit):
    """Codes and scales bit for bit against the reference as it runs (in
    its jitted steps, where XLA folds ``amax / qmax`` into a multiply by
    the reciprocal), on latents of widely spread magnitudes, all-zero
    tokens included."""
    rng = np.random.RandomState(bit)
    lat = (rng.randn(3, 33, 512) * np.exp(rng.randn(3, 33, 1) * 3)
           ).astype(np.float32)
    lat[0, :4] = 0.0
    jq, js = jax.jit(lambda x: JMD._quant_latent(x, bit))(jnp.asarray(lat))
    tq, ts = MD._quant_latent(torch.as_tensor(lat), bit)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and np.abs(tq.numpy()).max() <= 2 ** (
        bit - 1)


def _latent_caches(quant, B=3, smax=128, seed=0):
    """A layer-1 latent cache of random contents in both packages, with
    per-slot positions."""
    cfg = DS.DeepseekConfig(**DS_TINY)
    rng = np.random.RandomState(seed)
    L, dc, dr = cfg.num_hidden_layers, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    c = {'kpe': rng.randn(L, B, smax, dr).astype(np.float32)}
    if quant:
        c['ckv_q'] = rng.randint(-127, 128, (L, B, smax, dc)).astype(np.int8)
        c['ckv_s'] = (rng.rand(L, B, smax) * 0.02).astype(np.float32)
    else:
        c['ckv'] = rng.randn(L, B, smax, dc).astype(np.float32)
    pos = np.array([5, 40, 17][:B], np.int32)
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    jc['pos'] = jnp.asarray(pos)
    tc = {k: torch.as_tensor(v) for k, v in c.items()}
    tc['pos'] = torch.as_tensor(pos)
    q_lat = (rng.randn(B, 4, dc) * 0.1).astype(np.float32)
    q_pe = (rng.randn(B, 4, dr) * 0.1).astype(np.float32)
    return jc, tc, q_lat, q_pe


@pytest.mark.parametrize('quant', [False, True], ids=['fp', 'int8'])
def test_chunked_read_matches_jax(quant):
    jc, tc, q_lat, q_pe = _latent_caches(quant)
    want = JMD._mla_decode_attn_chunked(jnp.asarray(q_lat),
                                        jnp.asarray(q_pe), jc, 1, 16)
    got = MD._mla_decode_attn_chunked(torch.as_tensor(q_lat),
                                      torch.as_tensor(q_pe), tc, 1, 16)
    assert rel_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize('quant', [False, True], ids=['fp', 'int8'])
@pytest.mark.parametrize('chunk', [8, 16, 32])
def test_fixed_trip_count_bit_equal_to_valid_prefix(quant, chunk):
    """Every chunk of the buffer (the captured step's loop) against the
    reference's ceil((max(pos) + 1) / chunk) chunks: the chunks past every
    slot's position change no bit of the result, even over stale cache
    contents."""
    _, tc, q_lat, q_pe = _latent_caches(quant, seed=chunk)
    q_lat, q_pe = torch.as_tensor(q_lat), torch.as_tensor(q_pe)
    n_valid = -(-(int(tc['pos'].max()) + 1) // chunk)
    assert n_valid < tc['kpe'].shape[2] // chunk
    fixed = MD._mla_decode_attn_chunked(q_lat, q_pe, tc, 1, chunk)
    prefix = MD._mla_decode_attn_chunked(q_lat, q_pe, tc, 1, chunk,
                                         n_chunks=n_valid)
    assert torch.equal(fixed, prefix)


@pytest.mark.parametrize('smax', [64, 48], ids=['chunked', 'full'])
@pytest.mark.parametrize('kv', ['fp', 'int8', 'int4'])
def test_forward_cached_prefill_then_decode_matches_jax(models, kv, smax):
    """A 6-token prefill then four decode steps, lockstep; at max_len 64
    the decode step takes the chunked read (chunk 32), at 48 no chunk
    divides and it takes the full read."""
    jm, tm = models
    bit = {'fp': None, 'int8': 8, 'int4': 4}[kv]
    ids = np.random.RandomState(2).randint(0, 128, (2, 10))
    jc = JMD.init_mla_cache(jm.cfg, 2, smax, dtype=jnp.float32,
                            quant_bit=bit)
    tc = MD.init_mla_cache(tm.cfg, 2, smax, quant_bit=bit, device='cpu')
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 10)):
        jl, jc = JMD.mla_forward_cached(jm.params, jm.cfg,
                                        jnp.asarray(ids[:, lo:hi]), jc,
                                        latent_bit=bit or 8)
        tl, tc = MD.mla_forward_cached(tm.params, tm.cfg,
                                       torch.as_tensor(ids[:, lo:hi]), tc,
                                       latent_bit=bit or 8)
        assert rel_err(tl.numpy(), jl) <= TOL, (lo, hi)
    assert tc['pos'] == 10
    for k in jc:
        if k != 'pos' and k != 'ckv_q':
            assert rel_err(tc[k].numpy(), jc[k]) <= TOL, k


def test_per_slot_decode_matches_jax(models):
    """The engine's form: per-slot positions, each slot written and read
    at its own offset, through the int8 latent."""
    jm, tm = models
    rng = np.random.RandomState(7)
    jc = JMD.init_mla_cache(jm.cfg, 3, 64, dtype=jnp.float32, quant_bit=8)
    tc = MD.init_mla_cache(tm.cfg, 3, 64, quant_bit=8, device='cpu')
    pos = np.array([3, 11, 29], np.int32)
    jc['pos'], tc['pos'] = jnp.asarray(pos), torch.as_tensor(pos)
    for step in range(3):
        tok = rng.randint(0, 128, (3, 1))
        jl, jc = JMD.mla_forward_cached(jm.params, jm.cfg, jnp.asarray(tok),
                                        jc)
        tl, tc = MD.mla_forward_cached(tm.params, tm.cfg,
                                       torch.as_tensor(tok), tc)
        assert rel_err(tl.numpy(), jl) <= TOL, step
    np.testing.assert_array_equal(tc['pos'].numpy(), pos + 3)


def test_greedy_generate_matches_jax(models):
    jm, tm = models
    ids = np.random.RandomState(2).randint(0, 128, (2, 5))
    want = np.asarray(JMD.mla_greedy_generate(jm, jnp.asarray(ids), 6))
    got = MD.mla_greedy_generate(tm, ids, 6, device='cpu').numpy()
    np.testing.assert_array_equal(got, want)


def _requests(cls, n=3, seed=5, max_new=5):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt_ids=rng.randint(0, 128, (4 + i,)),
                max_new_tokens=max_new) for i in range(n)]


_JAX_ENGINE = {}


def _jax_tokens(jm, kv, chunk, max_len):
    """The JAX engine's tokens, run once per configuration."""
    from llmc_tpu.serve.engine import Request as JRequest
    from llmc_tpu.serve.engine import ServingEngine as JEngine
    from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
    key = (tuple(sorted(kv.items())), chunk, max_len)
    if key not in _JAX_ENGINE:
        eng = JEngine(jm, max_batch=2, max_len=max_len, prefill_buckets=(16,),
                      kv_policy=JPolicy(**kv), prefill_chunk=chunk)
        reqs = _requests(JRequest)
        eng.run(reqs)
        _JAX_ENGINE[key] = [list(r.output_ids) for r in reqs]
    return _JAX_ENGINE[key]


KVS = {'fp': dict(method='fp'), 'int8': dict(method='naive', bit=8),
       'int4': dict(method='naive', bit=4)}


@pytest.mark.parametrize('kv,chunk', [('fp', None), ('int8', None),
                                      ('fp', 4), ('int8', 4),
                                      ('int4', None)])
def test_engine_tokens_equal_jax_engine(models, kv, chunk):
    """The engine over the latent cache (monolithic and chunked admission,
    the chunk step's local latent cache spliced into the slot) gives the
    JAX engine's greedy tokens; the 4-bit latent's codes stay in 4 bits."""
    from llmc_tpu_torch.serve import KVCachePolicy, Request, ServingEngine
    jm, tm = models
    eng = ServingEngine(tm, max_batch=2, max_len=64, prefill_buckets=(16,),
                        kv_policy=KVCachePolicy(**KVS[kv]),
                        prefill_chunk=chunk, device='cpu')
    assert eng.mla and ('ckv_q' in eng.cache) == (kv != 'fp')
    reqs = _requests(Request)
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert [list(r.output_ids) for r in reqs] == _jax_tokens(
        jm, KVS[kv], chunk, 64)
    if kv == 'int4':
        codes = eng.cache['ckv_q']
        assert 0 < int(codes.abs().max()) <= 8


def test_engine_window_equals_single_steps(models):
    """K-step windows over the int8 latent give the single steps'
    tokens."""
    from llmc_tpu_torch.serve import KVCachePolicy, Request, ServingEngine
    _, tm = models
    out = []
    for K in (1, 4):
        eng = ServingEngine(tm, max_batch=2, max_len=64,
                            prefill_buckets=(16,),
                            kv_policy=KVCachePolicy(**KVS['int8']),
                            decode_steps_per_sync=K, device='cpu')
        reqs = _requests(Request)
        eng.run(reqs)
        out.append([r.output_ids for r in reqs])
    assert out[0] == out[1]


def test_engine_refuses_what_the_reference_refuses(models):
    """The reference serves MLA over the fp and naive latent caches only
    (an assert at construction): the paged pool, KIVI and Sink raise, as
    do the w8 companion flags, which the reference ignores there."""
    from llmc_tpu_torch.serve import KVCachePolicy, ServingEngine
    from llmc_tpu_torch.serve.paged_cache import PagedKVPolicy
    _, tm = models
    for pol in (PagedKVPolicy(page_size=16, n_pages=8, max_pages=4),
                KVCachePolicy(method='sink'), KVCachePolicy(method='kivi')):
        with pytest.raises(ValueError, match='latent'):
            ServingEngine(tm, max_len=64, kv_policy=pol, device='cpu')
    for flag in ('prefill_w8', 'decode_w8'):
        with pytest.raises(ValueError, match='MLA'):
            ServingEngine(tm, max_len=64, device='cpu', **{flag: True})
