"""Port parity of the KV-cache policies (llmc_tpu_torch.serve.kvcache):
int8 codes and scales bit-equal to llmc_tpu, in-place updates at scalar
and per-slot positions, and what the policy reads back.

The reference quantizes the cache inside its jitted steps, where XLA
folds the scale's division by a constant into a multiply by the f32
reciprocal; the reference's policy is held here under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.serve.kvcache import KVCachePolicy as JPolicy
from llmc_tpu_torch.serve.kvcache import KVCachePolicy
from llmc_tpu_torch.serve.paged_cache import PagedKVPolicy
from torch_port_helpers import cuda_device  # noqa: F401

torch.set_num_threads(1)

POLICIES = {'fp': dict(method='fp'),
            'naive_sym': dict(method='naive', bit=8),
            'naive_asym': dict(method='naive', bit=8, symmetric=False),
            'naive4_sym': dict(method='naive', bit=4)}


def _kv(seed, shape=(2, 3, 2, 16)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32) * 3)


@pytest.mark.parametrize('name', ['naive_sym', 'naive_asym', 'naive4_sym'])
def test_quant_codes_bit_equal(name):
    k, _ = _kv(0)
    jq, js, jz = jax.jit(JPolicy(**POLICIES[name])._quant)(jnp.asarray(k))
    tq, ts, tz = KVCachePolicy(**POLICIES[name])._quant(torch.as_tensor(k))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if jz is not None:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize('symmetric, seed', [(True, 0), (False, 1)])
def test_quant_scale_bit_equal_to_jitted_reference(symmetric, seed):
    """On 4096 x 128 values of scale 3 the scale is the jitted reference's
    bit for bit, a multiply by the f32 reciprocal of qmax (or of 2^bit - 1)
    where a true division differs in 175 rows (symmetric, seed 0) and 3169
    (asymmetric, seed 1); codes and zero points follow."""
    x = (np.random.RandomState(seed).randn(4096, 128) * 3).astype(np.float32)
    jp = JPolicy(method='naive', bit=8, symmetric=symmetric)
    jq, js, jz = jax.jit(jp._quant)(jnp.asarray(x))
    tq, ts, tz = KVCachePolicy(method='naive', bit=8,
                               symmetric=symmetric)._quant(torch.as_tensor(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if not symmetric:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # the eager reference divides: the case tells the two apart
    _, es, _ = jp._quant(jnp.asarray(x))
    assert int((np.asarray(es) != np.asarray(js)).sum()) > 100


@pytest.mark.parametrize('name', sorted(POLICIES))
def test_update_read_scalar_pos(name):
    """Two writes at scalar positions 0 and 3, then read: every cache
    field and the read-back K/V equal the reference's."""
    jp, tp = JPolicy(**POLICIES[name]), KVCachePolicy(**POLICIES[name])
    jc = jp.init_cache(2, 8, 2, 16, 3, dtype=jnp.float32)
    tc = tp.init_cache(2, 8, 2, 16, 3, dtype=torch.float32, device='cpu')
    for pos, seed in ((0, 1), (3, 2)):
        k, v = _kv(seed)
        jc = dict(jc, pos=jnp.asarray(pos, jnp.int32))
        tc['pos'] = pos
        jc = jax.jit(jp.update, static_argnums=1)(jc, 1, jnp.asarray(k),
                                                  jnp.asarray(v))
        out = tp.update(tc, 1, torch.as_tensor(k), torch.as_tensor(v))
        assert out is tc                              # updated in place
    for key in tc:
        if key != 'pos':
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]))
    for a, b in zip(tp.read(tc, 1, torch.float32),
                    jp.read(jc, 1, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_update_per_slot_positions():
    """A [B] position vector writes each slot at its own offset."""
    jp, tp = JPolicy(**POLICIES['naive_sym']), \
        KVCachePolicy(**POLICIES['naive_sym'])
    jc = jp.init_cache(3, 8, 2, 16, 2, dtype=jnp.float32)
    tc = tp.init_cache(3, 8, 2, 16, 2, dtype=torch.float32, device='cpu')
    pos = np.array([0, 5, 7], np.int32)
    k, v = _kv(3, (3, 1, 2, 16))
    jc = jax.jit(jp.update, static_argnums=1)(
        dict(jc, pos=jnp.asarray(pos)), 0, jnp.asarray(k), jnp.asarray(v))
    tc['pos'] = torch.as_tensor(pos)
    tp.update(tc, 0, torch.as_tensor(k), torch.as_tensor(v))
    for key in ('k_q', 'v_q', 'k_s', 'v_s'):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert tc['k_s'].shape == (2, 3, 8, 2)     # scales stay squeezed


@pytest.mark.parametrize('method', ['kivi', 'sink', 'paged'])
def test_unported_policies_raise(method):
    """The paged pool is a policy of its own, PagedKVPolicy, as in the
    reference.  kivi and sink, which raised until they were ported, build
    the reference's cache (the same buffers, shapes and types); kivi's
    int8 codes refuse more than 8 bits."""
    if method == 'paged':
        with pytest.raises(NotImplementedError, match='PagedKVPolicy'):
            KVCachePolicy(method=method)
        return
    jc = JPolicy(method=method).init_cache(2, 8, 2, 16, 3,
                                           dtype=jnp.float32)
    tc = KVCachePolicy(method=method).init_cache(2, 8, 2, 16, 3,
                                                 dtype=torch.float32,
                                                 device='cpu')
    assert set(tc) == set(jc)
    for key, v in tc.items():
        if isinstance(v, torch.Tensor):
            assert tuple(v.shape) == jc[key].shape, key
            assert str(v.dtype).split('.')[-1] == str(jc[key].dtype), key
    if method == 'kivi':
        with pytest.raises(ValueError, match='int8'):
            KVCachePolicy(method=method, bit=16)


def test_init_cache_device_none_needs_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: device=None is valid here')
    with pytest.raises(RuntimeError, match='CUDA'):
        KVCachePolicy().init_cache(1, 4, 1, 16, 1)


@pytest.mark.gpu
@pytest.mark.parametrize('policy', ['naive_sym', 'naive_asym', 'paged'])
def test_quant_scale_card_equals_cpu_on_card(cuda_device, policy):
    """The folded scale is the same multiply on both devices: the card's
    codes, scales and zero points equal the CPU's, bit for bit, on the
    4096 x 128 cases."""
    x = (np.random.RandomState(1).randn(4096, 128) * 3).astype(np.float32)
    pol = (PagedKVPolicy(bit=8) if policy == 'paged'
           else KVCachePolicy(**POLICIES[policy]))
    cpu = pol._quant(torch.as_tensor(x))
    card = pol._quant(torch.as_tensor(x).to(cuda_device))
    for a, b in zip(cpu, card):
        if a is not None:
            assert torch.equal(a, b.cpu())
