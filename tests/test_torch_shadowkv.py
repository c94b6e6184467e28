"""ShadowKV in the port (llmc_tpu_torch.serve.shadowkv) against the JAX
package's on the CPU at float32: ``shadowkv_decode_nll`` on the tiny
Llama at the policy of the reference's own test and at one where the
retrieval really selects, the prefill state and the retrieved positions
on fixed data, and the port's refusal of a decode longer than
``max_gen``, which the reference scores wrongly (ROADMAP C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.serve import shadowkv as JS
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.serve import shadowkv as TS
from torch_port_helpers import TINY, port_params

torch.set_num_threads(1)

# tests/test_pipeline.py's policy: every chunk attended at full rank
TRACKING = dict(sparse_budget=32, chunk_size=4, rank=32, outlier_chunk=2,
                local_chunk=2, max_gen=40)
# 16 prefill chunks: 3 outliers, 2 local, the top 4 of the other 11
SELECTING = dict(sparse_budget=16, chunk_size=4, rank=8, outlier_chunk=3,
                 local_chunk=2, max_gen=64)


@pytest.fixture(scope='module')
def pair():
    jm = JAdapter.random(JConfig(**TINY), seed=6)
    return jm, LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))


def _ids(n):
    return np.random.RandomState(4).randint(0, 128, (1, n))


@pytest.fixture(scope='module')
def tracking(pair):
    jm, _ = pair
    return JS.shadowkv_decode_nll(jm, jnp.asarray(_ids(64)),
                                  JS.ShadowKVPolicy(**TRACKING))


@pytest.mark.parametrize('policy,n', [(TRACKING, 64), (SELECTING, 128)])
def test_decode_nll_matches_jax(pair, tracking, policy, n):
    """The PPL within 1e-4 relative of the reference's, the same count."""
    jm, tm = pair
    want = tracking if policy is TRACKING else JS.shadowkv_decode_nll(
        jm, jnp.asarray(_ids(n)), JS.ShadowKVPolicy(**policy))
    got = TS.shadowkv_decode_nll(tm, _ids(n), TS.ShadowKVPolicy(**policy))
    assert got[1] == want[1] == n - n // 2
    assert abs(got[0] - want[0]) / want[0] < 1e-4


def test_state_and_retrieval_match_on_fixed_data():
    """The prefill state (rank-r SVD, landmarks, outlier chunks by the
    minimum cosine similarity) and the retrieved positions equal the
    reference's: coherent chunks with one rogue key in chunk 3 make it the
    outlier, and no outlier or local chunk is retrieved again."""
    cfg_j, cfg_t = JConfig(**TINY), LlamaConfig(**TINY)
    rng = np.random.RandomState(0)
    Lc, S, KVH, hd = TINY['num_hidden_layers'], 48, 2, 16
    k = (np.repeat(np.repeat(rng.randn(1, 1, 1, hd), S, 1), KVH, 2)
         + 0.01 * rng.randn(1, S, KVH, hd)).astype(np.float32)
    k[0, 13] = -k[0, 13]
    v = rng.randn(1, S, KVH, hd).astype(np.float32)
    q = rng.randn(1, 1, TINY['num_attention_heads'], hd).astype(np.float32)
    kw = dict(sparse_budget=8, chunk_size=4, rank=16, outlier_chunk=2,
              local_chunk=2, max_gen=4)
    jp, tp = JS.ShadowKVPolicy(**kw), TS.ShadowKVPolicy(**kw)
    js = jp.init_from_prefill(cfg_j, [jnp.asarray(k)] * Lc,
                              [jnp.asarray(k)] * Lc, [jnp.asarray(v)] * Lc)
    ts = tp.init_from_prefill(cfg_t, [torch.as_tensor(k)] * Lc,
                              [torch.as_tensor(k)] * Lc,
                              [torch.as_tensor(v)] * Lc)
    np.testing.assert_array_equal(ts['out_idx'].numpy(),
                                  np.asarray(js['out_idx']))
    assert (ts['out_idx'].numpy()[..., 0] == 3).all()
    np.testing.assert_allclose(ts['landmarks'].numpy(),
                               np.asarray(js['landmarks']), atol=1e-6)
    # U and SV carry the SVD's signs; their product does not
    np.testing.assert_allclose(
        torch.einsum('lbsr,lbkrd->lbksd', ts['U'], ts['SV']).numpy(),
        np.einsum('lbsr,lbkrd->lbksd', np.asarray(js['U']),
                  np.asarray(js['SV'])), atol=1e-5)
    for layer in range(Lc):
        jk, jv, jpos = jp.retrieve(cfg_j, js, layer, jnp.asarray(q))
        tk, tv, tpos = tp.retrieve(cfg_t, ts, layer, torch.as_tensor(q))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    chunks = tpos.numpy()[0, :, ::4] // 4             # [KVH, n_chunks]
    assert all(len(set(row)) == len(row) for row in chunks)


def test_decode_past_max_gen_raises(pair, tracking):
    """The reference writes the k-th generated token at row k of its
    ``max_gen`` rows and JAX drops the writes past the end: 31 decode
    steps over 16 rows score another PPL without a word.  The port raises
    (ROADMAP C); at 31 rows it scores what the reference does at 40."""
    jm, tm = pair
    short = dict(TRACKING, max_gen=16)
    dropped = JS.shadowkv_decode_nll(jm, jnp.asarray(_ids(64)),
                                     JS.ShadowKVPolicy(**short))
    assert np.isfinite(dropped[0]) and dropped[0] != tracking[0]
    with pytest.raises(ValueError, match='max_gen=16'):
        TS.shadowkv_decode_nll(tm, _ids(64), TS.ShadowKVPolicy(**short))
    exact = TS.shadowkv_decode_nll(tm, _ids(64), TS.ShadowKVPolicy(
        **dict(TRACKING, max_gen=31)))
    assert abs(exact[0] - tracking[0]) / tracking[0] < 1e-4


def test_batch_of_two_raises(pair):
    _, tm = pair
    with pytest.raises(ValueError, match='batch_size=1'):
        TS.shadowkv_decode_nll(tm, np.zeros((2, 16), np.int64),
                               TS.ShadowKVPolicy(**TRACKING))
