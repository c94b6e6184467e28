"""Port parity of the paged KV pool (llmc_tpu_torch.serve.paged_cache):
the pool's layout, its int8 quantizer bit-equal to the jitted reference's,
``update`` exact against the reference (codes, scales, values, the
scratch page a retired slot writes to), the paged read within 1e-5 at f32,
and the host allocator's free list and table rows."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.serve import paged_cache as JPC
from llmc_tpu_torch.serve import paged_cache as TPC
from torch_port_helpers import rel_err

torch.set_num_threads(1)

L, B, KVH, HD = 2, 3, 2, 16
PS, NP, MP = 4, 12, 4
CFG = types.SimpleNamespace(num_key_value_heads=KVH)
# slot 0 owns pages 3, 0, 7; slot 1 pages 5, 1; slot 2 is retired (-1)
TABLE = np.array([[3, 0, 7, -1], [5, 1, -1, -1], [-1, -1, -1, -1]],
                 np.int32)


def _policy(mod, bit):
    return mod.PagedKVPolicy(page_size=PS, n_pages=NP, max_pages=MP, bit=bit)


def _caches(bit, seed=0):
    """The same pool in both packages: random contents, ``TABLE``."""
    jc = _policy(JPC, bit).init_cache(B, MP * PS, KVH, HD, L,
                                      dtype=jnp.float32)
    tc = _policy(TPC, bit).init_cache(B, MP * PS, KVH, HD, L,
                                      dtype=torch.float32, device='cpu')
    rng = np.random.RandomState(seed)
    for k in ('pool_k', 'pool_v', 'pool_k_s', 'pool_v_s'):
        if k not in jc:
            continue
        shape = jc[k].shape
        if jc[k].dtype == jnp.int8:
            a = rng.randint(-127, 128, shape).astype(np.int8)
        elif k.endswith('_s'):
            a = rng.uniform(.01, .03, shape).astype(np.float32)
        else:
            a = rng.randn(*shape).astype(np.float32)
        jc[k] = jnp.asarray(a)
        tc[k] = torch.as_tensor(a.copy())
    jc['table'] = jnp.asarray(TABLE)
    tc['table'] = torch.as_tensor(TABLE.copy())
    return jc, tc


@pytest.mark.parametrize('bit', [0, 8])
def test_init_cache_layout_matches_reference(bit):
    jc = _policy(JPC, bit).init_cache(B, 16, KVH, HD, L, dtype=jnp.float32)
    tc = _policy(TPC, bit).init_cache(B, 16, KVH, HD, L,
                                      dtype=torch.float32, device='cpu')
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert str(tc[k].dtype).split('.')[-1] == str(jc[k].dtype), k
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    with pytest.raises(ValueError, match='exceeds'):
        _policy(TPC, bit).init_cache(B, MP * PS + 1, KVH, HD, L,
                                     device='cpu')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_quant_bit_equal_to_jitted_reference(seed):
    """The pool's int8 quantizer on 4096 x 128 values of scale 3: codes and
    scales bit-equal to ``jax.jit`` of the reference's ``_quant`` (whose
    scale XLA folds into a multiply by the f32 reciprocal of 127)."""
    x = (np.random.RandomState(seed).randn(4096, 128) * 3).astype(np.float32)
    jq, js = jax.jit(_policy(JPC, 8)._quant)(jnp.asarray(x))
    tq, ts = _policy(TPC, 8)._quant(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('bit', [0, 8])
@pytest.mark.parametrize('S, pos', [(1, [9, 2, 0]), (1, [3, 4, 0]),
                                    (3, [3, 3, 0])])
def test_update_exact_against_reference(bit, S, pos):
    """S new tokens a slot at its own position (S > 1 across a page
    boundary): every pool field equal to the jitted reference's, codes and
    scales bit for bit; the retired slot (table row -1) writes the last,
    scratch page, and no live page changes but where a slot wrote."""
    jc, tc = _caches(bit, seed=3)
    k, v = (np.random.RandomState(4 + i).randn(B, S, KVH, HD).astype(
        np.float32) * 2 for i in range(2))
    jc['pos'] = jnp.asarray(np.array(pos, np.int32))
    tc['pos'] = torch.as_tensor(np.array(pos, np.int32))
    before = {n: t.clone() for n, t in tc.items()}
    jc = jax.jit(_policy(JPC, bit).update, static_argnums=1)(
        jc, 1, jnp.asarray(k), jnp.asarray(v))
    out = _policy(TPC, bit).update(tc, 1, torch.as_tensor(k),
                                   torch.as_tensor(v))
    assert out is tc
    for n in ('pool_k', 'pool_v', 'pool_k_s', 'pool_v_s'):
        if n in jc:
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
    scratch = tc['pool_k'][1, NP - 1, pos[2] % PS]
    assert not torch.equal(scratch, before['pool_k'][1, NP - 1,
                                                     pos[2] % PS])
    untouched = [p for p in range(NP - 1) if p not in (3, 0, 7, 5, 1)]
    assert torch.equal(tc['pool_k'][:, untouched],
                       before['pool_k'][:, untouched])
    assert torch.equal(tc['pool_k'][0], before['pool_k'][0])


@pytest.mark.parametrize('bit', [0, 8])
@pytest.mark.parametrize('read_pages', [None, 4])
def test_decode_attn_paged_matches_reference(bit, read_pages):
    """The paged read against the reference's, f32, within 1e-5: slots at
    positions inside a page, at a page's last row and on a third page
    (GQA, 2 query heads a kv head); with the page count from ``pos`` or
    handed over as ``read_pages`` (the engine's, which may read pages past
    every position: they are masked)."""
    jc, tc = _caches(bit, seed=5)
    pos = np.array([9, 3, 0], np.int32)
    jc['pos'] = jnp.asarray(pos)
    tc['pos'] = torch.as_tensor(pos)
    if read_pages is not None:
        tc['read_pages'] = read_pages
    q = (np.random.RandomState(6).randn(B, 1, 2 * KVH, HD) / 4).astype(
        np.float32)
    want = JPC.decode_attn_paged(jnp.asarray(q), jc, 1, _policy(JPC, bit),
                                 CFG)
    got = TPC.decode_attn_paged(torch.as_tensor(q), tc, 1, _policy(TPC, bit),
                                CFG)
    assert got.shape == (B, 1, 2 * KVH, HD)
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_allocator_matches_reference():
    """The free list keeps the last page as scratch, hands pages out in
    the reference's order and writes the same table rows; release gives
    them back and clears the row."""
    jp, tp = _policy(JPC, 0), _policy(TPC, 0)
    ja, ta = JPC.PageAllocator(jp), TPC.PageAllocator(tp)
    jt = jnp.full((B, MP), -1, jnp.int32)
    tt = torch.full((B, MP), -1, dtype=torch.int32)
    assert ta.free == ja.free and NP - 1 not in ta.free
    for slot, n in ((0, 9), (2, 4), (1, 13)):
        assert ta.can_admit(n) == ja.can_admit(n)
        jt, jpages = ja.allocate(slot, n, jt)
        tt2, tpages = ta.allocate(slot, n, tt)
        assert tt2 is tt and tpages == jpages
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jt = ja.release(2, jt)
    assert ta.release(2, tt) is tt
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ta.free == ja.free
    assert not ta.can_admit(PS * (len(ta.free) + 1))
    with pytest.raises(RuntimeError, match='exhausted'):
        ta.allocate(2, PS * (len(ta.free) + 1), tt)
