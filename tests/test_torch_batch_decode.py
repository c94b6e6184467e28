"""Port parity of the serving-batch decode attention
(llmc_tpu_torch.ops.batch_decode): the plain version against the
reference's Pallas kernel in interpret mode on the reference's own cases
(int8 and fp caches, GQA, positions skewed inside a block of slots, a
single block and chunk), and the Hopper kernel against the plain version
on the card."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, rel_err  # noqa: F401

JB = importlib.import_module('llmc_tpu.ops.batch_decode')
TB = importlib.import_module('llmc_tpu_torch.ops.batch_decode')
TF = importlib.import_module('llmc_tpu_torch.ops.flash_decode')
torch.set_num_threads(1)

L, B, S, KVH, HD = 3, 8, 64, 4, 32
# chunk interior, chunk boundaries, the full cache, and skew inside a
# block of 4 slots (the reference test's list)
POS = np.array([5, 15, 40, S - 1, 0, 31, 32, 17], np.int32)


def _cache(quantized, seed=0, shape=(L, B, S, KVH, HD)):
    rng = np.random.default_rng(seed)
    if quantized:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(.01, .03, shape[:-1]).astype(np.float32),
                rng.uniform(.01, .03, shape[:-1]).astype(np.float32))
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32), None, None)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize('g', [1, 2])
@pytest.mark.parametrize('quantized', [True, False])
def test_plain_matches_pallas_interpret(g, quantized):
    """Plain version vs the reference's Pallas kernel (interpret mode),
    blocks of 4 slots and chunks of 16: f32 throughout, 2e-5."""
    k, v, ks, vs = _cache(quantized)
    q = np.random.default_rng(1).normal(size=(B, KVH * g, HD)).astype(
        np.float32)
    want = JB.batch_decode_attention(
        _j(q), _j(k), _j(v), _j(ks), _j(vs), _j(POS),
        jnp.asarray(1, jnp.int32), b_blk=4, chunk=16, interpret=True)
    got = TB.batch_decode_attention(_t(q), _t(k), _t(v), _t(ks), _t(vs),
                                    _t(POS), 1, b_blk=4, chunk=16)
    assert got.shape == (B, KVH * g, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the blocks and chunks the port picks itself give the same function
    auto = TB.batch_decode_attention(_t(q), _t(k), _t(v), _t(ks), _t(vs),
                                     _t(POS), 1)
    np.testing.assert_allclose(auto.numpy(), got.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_plain_single_chunk_single_block():
    """One block and one chunk: init and emit in the same step."""
    shape = (2, 4, 32, 2, 16)
    k, v, _, _ = _cache(False, seed=1, shape=shape)
    q = np.random.default_rng(2).normal(size=(4, 2, 16)).astype(np.float32)
    pos = np.array([3, 9, 31, 0], np.int32)
    want = JB.batch_decode_attention(
        _j(q), _j(k), _j(v), None, None, _j(pos), jnp.asarray(0, jnp.int32),
        b_blk=4, chunk=32, interpret=True)
    got = TB.batch_decode_attention(_t(q), _t(k), _t(v), None, None,
                                    _t(pos), 0, b_blk=4, chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize('quantized', [True, False])
def test_alias_cache_returns_the_given_tensors(quantized):
    """With alias_cache the reference returns the cache buffers beside
    ctx; the port returns the very tensors it was given."""
    k, v, ks, vs = _cache(quantized, seed=3)
    q = np.random.default_rng(4).normal(size=(B, KVH, HD)).astype(np.float32)
    targs = [_t(a) for a in (k, v, ks, vs)]
    res = TB.batch_decode_attention(_t(q), *targs, _t(POS), 2, b_blk=4,
                                    chunk=16, alias_cache=True)
    want = JB.batch_decode_attention(
        _j(q), _j(k), _j(v), _j(ks), _j(vs), _j(POS),
        jnp.asarray(2, jnp.int32), b_blk=4, chunk=16, interpret=True,
        alias_cache=True)
    assert len(res) == len(want) == (5 if quantized else 3)
    np.testing.assert_allclose(res[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=2e-5)
    for given, back in zip([a for a in targs if a is not None], res[1:]):
        assert back is given


def test_plain_equals_flash_plain_and_skips_past_block_last():
    """Same function as flash-decode; and a block never reads past its
    own last valid chunk: garbage (NaN) there does not reach the output."""
    k, v, ks, vs = _cache(False, seed=5)
    q = np.random.default_rng(6).normal(size=(B, KVH * 2, HD)).astype(
        np.float32)
    pos = np.array([3, 9, 15, 0, 40, 63, 2, 33], np.int32)
    k, v = k.copy(), v.copy()
    k[1, :4, 16:] = np.nan      # block 0 (b_blk 4) ends in chunk 0
    v[1, :4, 16:] = np.nan
    got = TB.batch_decode_plain(_t(q), _t(k), _t(v), None, None, _t(pos), 1,
                                b_blk=4, chunk=16)
    assert torch.isfinite(got).all()
    want = TF.flash_decode_plain(_t(q)[4:], _t(k)[:, 4:], _t(v)[:, 4:], None,
                                 None, _t(pos)[4:], 1, chunk=16)
    assert rel_err(got[4:].numpy(), want.numpy()) < 2e-5


def test_pick_blocks_and_warps_for_the_card():
    """A full serving batch takes blocks of 8 slots and one warp a slot;
    a small batch takes blocks of one slot and several warps a slot."""
    assert TB._pick_blocks(128, 96, 32, 128, 1) == (8, 64)
    assert TB._warps_per_slot(128, 32, 8) == 1
    bb, cc = TB._pick_blocks(8, 1024, 32, 128, 1)
    assert (bb, cc) == (1, 64) and TB._warps_per_slot(8, 32, bb) == 4
    bb, cc = TB._pick_blocks(3, 48, 2, 16, 4)
    assert 3 % bb == 0 and cc == 48
    for b, kvh in ((128, 32), (8, 32), (16, 8), (256, 8)):
        bb, _ = TB._pick_blocks(b, 256, kvh, 128, 1)
        assert bb * TB._warps_per_slot(b, kvh, bb) <= TB.MAX_WARPS


def test_cpu_tensors_take_plain_version_without_launch():
    k, v, ks, vs = _cache(True)
    q = torch.randn(B, KVH, HD)
    before = TB.LAUNCHES['batch_decode']
    TB.batch_decode_attention(q, _t(k), _t(v), _t(ks), _t(vs), _t(POS), 0)
    assert TB.LAUNCHES['batch_decode'] == before
    with pytest.raises(ValueError, match='CUDA'):
        TB.batch_decode_cuda(q, _t(k), _t(v), _t(ks), _t(vs), _t(POS), 0)
    with pytest.raises(ValueError, match='multiple of b_blk'):
        TB.batch_decode_plain(q, _t(k), _t(v), _t(ks), _t(vs), _t(POS), 0,
                              b_blk=3)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('quantized', [True, False])
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('blocks', [(None, None, None), (4, 16, 1),
                                    (2, 16, 4), (1, 64, 2)])
def test_kernel_matches_plain_on_card(cuda_device, quantized, g, hd, blocks):
    """The Hopper kernel vs the plain version on the card (f32 both): 2e-4
    of the output scale (exp and summation order), for the blocks the
    port picks and for forced (b_blk, chunk, warps per slot)."""
    dev = cuda_device
    b_blk, chunk, wps = blocks
    k, v, ks, vs = _cache(quantized, seed=5, shape=(L, B, S, KVH, hd))
    args = [_t(a) for a in (k, v, ks, vs)]
    if not quantized:
        args[:2] = [a.to(torch.bfloat16) for a in args[:2]]
    args = [None if a is None else a.to(dev) for a in args]
    q = torch.randn(B, KVH * g, hd).to(dev)
    pos = _t(POS).to(dev)
    before = TB.LAUNCHES['batch_decode']
    got = TB.batch_decode_cuda(q, *args, pos, 2, b_blk, chunk, wps)
    want = TB.batch_decode_plain(q, *args, pos, 2, b_blk, chunk)
    torch.cuda.synchronize()
    assert TB.LAUNCHES['batch_decode'] == before + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4


@pytest.mark.gpu
def test_kernel_skips_past_block_last_and_refuses_on_card(cuda_device):
    """On the card too a block stops at its last valid chunk (NaN beyond
    it never reaches the output), and the wrapper refuses what the kernel
    does not take."""
    dev = cuda_device
    k, v, ks, vs = _cache(True, seed=7)
    k, v, ks, vs = (_t(a).to(dev) for a in (k, v, ks, vs))
    q = torch.randn(B, KVH * 2, HD, device=dev)
    pos = torch.tensor([3, 9, 15, 0, 40, 63, 2, 33], dtype=torch.int32,
                       device=dev)
    ks[1, :4, 16:] = float('nan')
    vs[1, :4, 16:] = float('nan')
    got = TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1, 4, 16)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    before = TB.LAUNCHES['batch_decode']
    with pytest.raises(ValueError, match='pos'):
        TB.batch_decode_cuda(q, k, v, ks, vs, pos.long(), 1)
    with pytest.raises(ValueError, match='contiguous'):
        TB.batch_decode_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                             k, v, ks, vs, pos, 1)
    with pytest.raises(ValueError, match='b_blk'):
        TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1, 8, 16, 4)
    with pytest.raises(ValueError, match='head dim'):
        TB.batch_decode_cuda(q[..., :24].contiguous(),
                             k[..., :24].contiguous(),
                             v[..., :24].contiguous(), ks, vs, pos, 1)
    with pytest.raises(ValueError, match='both'):
        TB.batch_decode_cuda(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                             None, vs, pos, 1)
    assert TB.LAUNCHES['batch_decode'] == before
