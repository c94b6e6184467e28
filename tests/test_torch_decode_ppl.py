"""Port parity of the decode-time evaluation (llmc_tpu_torch.serve.decode::
decode_nll, eval.ppl's DecodePerplexityEval and TokenConsistencyEval) and
of the KV-cache policies it scores (Naive, KIVI, SinkKV), held against
llmc_tpu on the CPU at float32 on fixed data.

The reference quantizes its cache inside jitted steps (the scale's
division by a constant folded into a reciprocal multiply), so its
policy's ``update`` is held here under ``jax.jit``; its decode reads the
fp and naive caches by the chunked XLA read on the CPU and the port by
the kernels' plain versions, which differ in the order of their sums
only."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.eval.ppl import DecodePerplexityEval as JDecodePPL
from llmc_tpu.eval.ppl import TokenConsistencyEval as JConsist
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.adapter import QMap as JQMap
from llmc_tpu.models.base import LinearQcfg as JQcfg
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve.decode import decode_nll as j_decode_nll
from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu_torch.eval.ppl import DecodePerplexityEval, TokenConsistencyEval
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models.adapter import QMap
from llmc_tpu_torch.models.base import LinearQcfg
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve.decode import decode_nll
from llmc_tpu_torch.serve.kvcache import KV_REGISTRY, KVCachePolicy
from torch_port_helpers import TINY, port_params

torch.set_num_threads(1)

# the policies decode_nll scores: 4-bit KIVI with a residual ring shorter
# than the sequence, and a sink window shorter than it
POLICIES = {'fp': dict(method='fp'),
            'naive': dict(method='naive', bit=8),
            'kivi': dict(method='kivi', bit=4, residual_length=8),
            'sink': dict(method='sink', num_sink_tokens=2, window_length=6)}
LINEARS = ('self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj',
           'self_attn.o_proj', 'mlp.gate_proj', 'mlp.up_proj',
           'mlp.down_proj')
W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=32)
# NLLs of the same model from the two packages: f32 sums in other orders
# over 2 layers and a few dozen steps
TOL_NLL = 1e-5


@pytest.fixture(scope='module')
def pair():
    jm = JAdapter.random(JConfig(**TINY), seed=4)
    return jm, LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))


@pytest.fixture(scope='module')
def ids():
    return np.random.RandomState(5).randint(0, TINY['vocab_size'],
                                            (2, 24)).astype(np.int32)


def _qmaps():
    return (JQMap({p: JQcfg(w_spec=JSpec(**W4)) for p in LINEARS}),
            QMap({p: LinearQcfg(w_spec=QuantSpec(**W4)) for p in LINEARS}))


@pytest.mark.parametrize('bit,R', [(4, 4), (8, 3)])
def test_kivi_update_read_and_splice_alignment(bit, R):
    """Step by step, what the KIVI cache reads back equals the jitted
    reference's bit for bit; positions [total - R, total) read exactly
    their fp values (this step's token included) and older ones their
    per-token codes."""
    B, KH, hd, T = 2, 2, 8, 10
    kw = dict(method='kivi', bit=bit, residual_length=R)
    jp, tp = JPolicy(**kw), KVCachePolicy(**kw)
    jc = jp.init_cache(B, T, KH, hd, 1, dtype=jnp.float32)
    tc = tp.init_cache(B, T, KH, hd, 1, dtype=torch.float32, device='cpu')
    rng = np.random.RandomState(3)
    ks = rng.randn(T, B, 1, KH, hd).astype(np.float32)
    vs = (rng.randn(T, B, 1, KH, hd) * 2).astype(np.float32)
    j_update = jax.jit(jp.update, static_argnums=1)
    for t in range(T):
        jc = j_update(jc, 0, jnp.asarray(ks[t]), jnp.asarray(vs[t]))
        tp.update(tc, 0, torch.as_tensor(ks[t]), torch.as_tensor(vs[t]))
        jk, jv = jp.read(jc, 0, jnp.float32)
        tk, tv = tp.read(tc, 0, torch.float32)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        total = t + 1
        assert tc['kivi_total'] == int(jc['kivi_total']) == total
        for a in range(total):
            want = ks[a, :, 0]
            if a < total - R:       # evicted: its per-token codes
                q, s, _ = tp._quant(torch.as_tensor(want))
                want = tp._dequant(q, s, None, torch.float32).numpy()
            np.testing.assert_array_equal(tk[:, a].numpy(), want,
                                          err_msg=f't={t} pos={a}')
        jc = dict(jc, pos=jc['pos'] + 1)
        tc['pos'] += 1


def test_kivi_write_longer_than_its_ring():
    """A write of more tokens than KIVI's ring holds (a prefill) keeps the
    last ``residual_length`` of them in the ring: what the cache reads back
    equals the read after the same tokens written one at a time.  The
    reference's ring raises on such a write (``dynamic_update_slice`` of
    an update larger than the ring; ROADMAP C)."""
    B, KH, hd, T, R = 2, 2, 8, 10, 4
    pol = KVCachePolicy(method='kivi', bit=4, residual_length=R)
    rng = np.random.RandomState(8)
    k = torch.as_tensor(rng.randn(B, 6, KH, hd).astype(np.float32))
    v = torch.as_tensor(rng.randn(B, 6, KH, hd).astype(np.float32))
    whole = pol.init_cache(B, T, KH, hd, 1, dtype=torch.float32,
                           device='cpu')
    pol.update(whole, 0, k, v)
    steps = pol.init_cache(B, T, KH, hd, 1, dtype=torch.float32,
                           device='cpu')
    for t in range(6):
        pol.update(steps, 0, k[:, t:t + 1], v[:, t:t + 1])
        steps['pos'] += 1
    for a, b in zip(pol.read(whole, 0, torch.float32),
                    pol.read(steps, 0, torch.float32)):
        assert torch.equal(a, b)
    assert torch.equal(whole['k_r'][0], k[:, -R:])
    jp = JPolicy(method='kivi', bit=4, residual_length=R)
    with pytest.raises(TypeError, match='dynamic_update_slice'):
        jp.update(jp.init_cache(B, T, KH, hd, 1, dtype=jnp.float32), 0,
                  jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))


def test_sink_mask_equals_reference():
    """The sink policy's row-dependent mask over a [S, 1] column of query
    positions (as the masked read passes it) equals the reference's."""
    kw = dict(method='sink', num_sink_tokens=3, window_length=5)
    q_idx = np.arange(4, 20)[:, None]
    want = JPolicy(**kw).attention_mask_offset(jnp.asarray(q_idx + 1), 24)
    got = KVCachePolicy(**kw).attention_mask_offset(
        torch.as_tensor(q_idx + 1), 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert KVCachePolicy(method='fp').attention_mask_offset(1, 4) is None


def test_registry_builds_the_reference_policies():
    """Naive, Kivi, SinkKV and ShadowKV read the same keys as the
    reference's registry entries (ShadowKV raised until it was ported)."""
    for name, cfg, special in (('Naive', dict(bit=4, symmetric=False), {}),
                               ('Kivi', dict(bit=4), dict(
                                   residual_length=16)),
                               ('SinkKV', {}, dict(num_sink_tokens=2,
                                                   window_length=7))):
        from llmc_tpu.utils.registry import KV_REGISTRY as JREG
        want = JREG[name]('int-quant', cfg, 2, **special)
        got = KV_REGISTRY[name]('int-quant', cfg, 2, **special)
        assert {f: getattr(got, f) for f in ('method', 'bit', 'symmetric',
                                             'residual_length',
                                             'num_sink_tokens',
                                             'window_length')} == \
            {f: getattr(want, f) for f in ('method', 'bit', 'symmetric',
                                           'residual_length',
                                           'num_sink_tokens',
                                           'window_length')}
    from llmc_tpu.utils.registry import KV_REGISTRY as JREG
    for special in ({}, dict(sparse_budget=64, chunk_size=4, rank=16,
                             outlier_chunk=3, local_chunk=9, max_gen=7)):
        want = JREG['ShadowKV']('int-quant', {}, 2, **special)
        got = KV_REGISTRY['ShadowKV']('int-quant', {}, 2, **special)
        assert type(got).__name__ == 'ShadowKVPolicy'
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize('policy', list(POLICIES))
@pytest.mark.parametrize('quantized', [False, True])
def test_decode_nll_matches_jax(pair, ids, policy, quantized):
    """decode_nll over each cache, with fp weights and under a W4
    fake-quant QMap: the summed NLL within 1e-5 relative of the JAX
    package's, the same count."""
    jm, tm = pair
    jq, tq = _qmaps() if quantized else (None, None)
    want, wn = j_decode_nll(jm, jnp.asarray(ids), qmap=jq,
                            kv_policy=JPolicy(**POLICIES[policy]))
    got, n = decode_nll(tm, ids, qmap=tq,
                        kv_policy=KVCachePolicy(**POLICIES[policy]),
                        device='cpu')
    assert n == wn == 2 * 23
    assert abs(float(got) - float(want)) <= TOL_NLL * abs(float(want))


def test_decode_nll_scored_steps_and_fp_residual(pair, ids):
    """``n_valid`` scores only the first n_valid - 1 steps, and labels with
    a score mask feed every token; a 4-bit cache moves the NLL, and a KIVI
    ring as long as the sequence reads only fp values: fp's NLL (fp's read
    the flash kernel's plain version, KIVI's the masked read)."""
    jm, tm = pair
    for kw in (dict(n_valid=10),
               dict(labels=np.roll(ids, -1, 1),
                    score_mask=np.arange(24) % 3 > 0)):
        jkw = {k: jnp.asarray(v) if k == 'labels' else v
               for k, v in kw.items()}
        want, wn = j_decode_nll(jm, jnp.asarray(ids), **jkw)
        got, n = decode_nll(tm, ids, device='cpu', **kw)
        assert n == wn
        assert abs(float(got) - float(want)) <= TOL_NLL * abs(float(want))
    fp = float(decode_nll(tm, ids, device='cpu')[0])
    q4 = float(decode_nll(tm, ids, device='cpu', kv_policy=KVCachePolicy(
        method='naive', bit=4))[0])
    kivi = float(decode_nll(tm, ids, device='cpu', kv_policy=KVCachePolicy(
        method='kivi', bit=4, residual_length=24))[0])
    assert abs(q4 - fp) > 10 * TOL_NLL * fp
    assert abs(kivi - fp) <= TOL_NLL * fp


class ToyTokenizer:
    """Characters to ids modulo the vocabulary, one per character."""

    def __call__(self, text):
        return {'input_ids': [ord(c) % TINY['vocab_size'] for c in text]}


TEXTS = ['the quick brown fox\n', 'a\n', '', 'jumps over the lazy dog\n',
         'pack my box with five dozen liquor jugs\n']


@pytest.mark.parametrize('policy', ['fp', 'naive', 'kivi'])
def test_decode_perplexity_eval_both_protocols(pair, policy):
    """DecodePerplexityEval over seq_len chunks of ids and over raw texts
    (the cache persisting across texts, each text's last token a label
    only, a one-token text and an empty one scoring nothing): the PPL
    within 1e-5 relative of the JAX package's."""
    jm, tm = pair
    flat = np.random.RandomState(6).randint(0, TINY['vocab_size'],
                                            200).astype(np.int32)
    jp, tp = JPolicy(**POLICIES[policy]), KVCachePolicy(**POLICIES[policy])
    jq, tq = _qmaps()
    for jev, tev in ((JDecodePPL(flat, seq_len=20, num_samples=3),
                      DecodePerplexityEval(flat, seq_len=20, num_samples=3)),
                     (JDecodePPL(texts=TEXTS, tokenizer=ToyTokenizer(),
                                 num_samples=4),
                      DecodePerplexityEval(texts=TEXTS,
                                           tokenizer=ToyTokenizer(),
                                           num_samples=4))):
        want = jev.eval(jm, qmap=jq, kv_policy=jp)
        got = tev.eval(tm, qmap=tq, kv_policy=tp)
        assert abs(got - want) <= TOL_NLL * want, (got, want)


def test_token_consistency_eval_matches_jax(pair):
    """The argmax agreement of the fp model with its W4 fake-quant deploy
    equals the JAX package's (it is a count: equal unless an argmax is a
    near-tie, which these weights have none of), and is 1 against
    itself."""
    jm, tm = pair
    flat = np.random.RandomState(7).randint(0, TINY['vocab_size'],
                                            400).astype(np.int32)
    jq, tq = _qmaps()
    want = JConsist(flat, seq_len=48, bs=2).eval(jm, None, jq)
    got = TokenConsistencyEval(flat, seq_len=48, bs=2).eval(tm, None, tq)
    assert got == want and 0.5 < got < 1.0
    assert TokenConsistencyEval(flat, seq_len=48).eval(tm, tq, tq) == 1.0
