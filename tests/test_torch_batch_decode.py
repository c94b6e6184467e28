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
    """A block of slots is one CTA of one warp a slot, each warp with its
    own ring: the pick packs the warps so that an SM holds the most (by
    default by shared memory: rings of 8, 16 and 32 KB for int8, bf16 and
    f32 at hd=128; on the card by the kernel's occupancy, which registers
    can cut); the warps an SM keeps, not the blocks, decide the split: a
    full serving batch is not split, a small one is."""
    assert TB._pick_blocks(128, 96, 128, 1) == (2, 64)
    assert TB._pick_blocks(128, 96, 128, 2) == (1, 64)
    assert TB._pick_blocks(128, 96, 128, 4) == (2, 64)
    assert TB.smem_warps(8, 128, 1) == 24 and TB.smem_warps(2, 128, 2) == 12
    # a kernel of about 200 registers: 10 warps an SM in CTAs of 1 or 2, 8
    # in CTAs of 4 or 8; where registers cap every size alike, shared
    # memory decides (26 warps in CTAs of 2 at int8, 13 in CTAs of 1 at
    # bf16)
    regs = {1: 10, 2: 10, 4: 8, 8: 8}
    assert TB._pick_blocks(128, 96, 128, 1, regs.get)[0] == 2
    assert TB._pick_blocks(128, 96, 128, 1, lambda d: 8)[0] == 2
    assert TB._pick_blocks(128, 96, 128, 2, lambda d: 8)[0] == 1
    assert TB._pick_blocks(8, 4096, 128, 1, {1: 6, 2: 8, 4: 8, 8: 8}.get
                           )[0] == 2
    assert TB.batch_plan(128, 32, 1, 96, 132, 16) == (1, 6)
    bb, cc = TB._pick_blocks(8, 1024, 128, 1)
    assert (bb, cc) == (2, 64)
    assert TB.batch_plan(8, 32, 1, 1024, 132, 16) == (8, 8)
    assert TB.batch_plan(1, 32, 1, 4096, 132, 16) == (66, 4)
    # Llama-3-8B's widths at B=8: 10 resident warps an SM give 20 splits
    # (1280 warps), where 16 would have asked for 33 (2112 warps, 1.6
    # waves of such a kernel)
    assert TB.batch_plan(8, 8, 4, 4096, 132, 10) == (20, 13)
    bb, cc = TB._pick_blocks(3, 48, 16, 4)
    assert 3 % bb == 0 and cc == 48
    for b in (128, 8, 16, 256, 1):
        for isz in (1, 2, 4):
            bb, _ = TB._pick_blocks(b, 256, 128, isz)
            assert b % bb == 0 and bb in TB.BLOCKS + (1,)
            assert TB._cta_smem(bb, 128, isz) <= TB.SMEM


@pytest.mark.parametrize('sms', [114, 132])
@pytest.mark.parametrize('B', [1, 8, 128])
@pytest.mark.parametrize('kvh, g', [(32, 1), (8, 4), (8, 16)])
@pytest.mark.parametrize('warps_per_sm', [6, 10, 16])
def test_plan_fills_the_card(sms, B, kvh, g, warps_per_sm):
    """The kernel's warps at B = 1, 8 and 128 over Llama-2-7B's 4096
    positions, on an H100 of 114 (PCIe) and 132 (SXM) SMs, for kernels
    that keep 6, 10 or 16 warps an SM: as many splits as keep the warps
    within one wave, or one split a chunk where the cache has too few
    chunks for that; never more splits than chunks (a split takes every
    S-th chunk, so each holds one)."""
    smax = 4096
    splits, cps = TB.batch_plan(B, kvh, g, smax, sms, warps_per_sm)
    nch = smax // TB.WARP_CHUNK
    items = B * kvh * TB.head_groups(g)
    assert 1 <= splits <= nch and cps == -(-nch // splits)
    wave = sms * warps_per_sm
    assert items * splits <= max(wave, items)
    assert items * splits > wave - items or splits == nch
    if items >= wave:
        assert splits == 1


@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32'])
@pytest.mark.parametrize('splits', [1, 2, 3, 5, 16])
def test_split_plain_equals_one_pass(cache, splits):
    """The kernel's arithmetic in its plain twin (split s of a slot takes
    its chunks s, s + S, ... of 16 positions with its own online softmax,
    the splits merged in split order) against the one-pass plain version,
    f32, to 1e-6 relative; positions in the first chunk, at chunk
    boundaries and at the end, so that some splits hold no position of a
    slot."""
    smax = 256
    k, v, ks, vs = _cache_kind(cache, seed=8, shape=(2, B, smax, 2, HD))
    q = torch.as_tensor(np.random.default_rng(9).normal(
        size=(B, 2 * 4, HD)).astype(np.float32))
    pos = torch.tensor([0, 15, 16, 130, smax - 1, 5, 47, 200],
                       dtype=torch.int32)
    want = TB.batch_decode_plain(q, k, v, ks, vs, pos, 1)
    got = TB.batch_decode_split_plain(q, k, v, ks, vs, pos, 1, splits)
    assert rel_err(got.numpy(), want.numpy()) < 1e-6


def _cache_kind(kind, seed=0, shape=(L, B, S, KVH, HD)):
    """The port's cache tensors of one kind: int8 codes with f32 scales,
    or bf16 or f32 values (bf16 made from f32 normals)."""
    k, v, ks, vs = _cache(kind == 'int8', seed, shape)
    k, v, ks, vs = _t(k), _t(v), _t(ks), _t(vs)
    if kind == 'bf16':
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return k, v, ks, vs


def _jax_cache(k, v, ks, vs):
    """The same cache for the reference (bf16 exactly as bf16)."""
    def j(a):
        if a is None:
            return None
        if a.dtype == torch.bfloat16:
            return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(a.numpy())
    return j(k), j(v), j(ks), j(vs)


@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32'])
@pytest.mark.parametrize('g', [1, 2, 4, 16])
def test_plain_matches_pallas_interpret_every_cache_and_group(cache, g):
    """The plain version against the reference's Pallas kernel (interpret
    mode, blocks of 4 slots, chunks of 16) at 1, 2, 4 and 16 query heads a
    kv head, on int8, bf16 and f32 caches: f32 arithmetic on the same
    values on both sides, so exp and summation order only, 2e-5 relative
    (about 1e-5 at f32)."""
    k, v, ks, vs = _cache_kind(cache, seed=10)
    q = np.random.default_rng(11).normal(size=(B, KVH * g, HD)).astype(
        np.float32)
    want = JB.batch_decode_attention(
        jnp.asarray(q), *_jax_cache(k, v, ks, vs), _j(POS),
        jnp.asarray(1, jnp.int32), b_blk=4, chunk=16, interpret=True)
    got = TB.batch_decode_attention(_t(q), k, v, ks, vs, _t(POS), 1,
                                    b_blk=4, chunk=16)
    assert got.shape == (B, KVH * g, HD)
    assert rel_err(got.numpy(), np.asarray(want)) < 2e-5


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
@pytest.mark.parametrize('blocks', [(None, None), (4, 16), (2, 16), (1, 64)])
def test_kernel_matches_plain_on_card(cuda_device, quantized, g, hd, blocks):
    """The Hopper kernel vs the plain version on the card (f32 both): 2e-4
    of the output scale (exp and summation order), for the blocks the
    port picks and for forced (b_blk, chunk)."""
    dev = cuda_device
    b_blk, chunk = blocks
    k, v, ks, vs = _cache(quantized, seed=5, shape=(L, B, S, KVH, hd))
    args = [_t(a) for a in (k, v, ks, vs)]
    if not quantized:
        args[:2] = [a.to(torch.bfloat16) for a in args[:2]]
    args = [None if a is None else a.to(dev) for a in args]
    q = torch.randn(B, KVH * g, hd).to(dev)
    pos = _t(POS).to(dev)
    before = TB.LAUNCHES['batch_decode']
    got = TB.batch_decode_cuda(q, *args, pos, 2, b_blk, chunk)
    want = TB.batch_decode_plain(q, *args, pos, 2, b_blk, chunk)
    torch.cuda.synchronize()
    assert TB.LAUNCHES['batch_decode'] == before + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32'])
@pytest.mark.parametrize('g', [1, 4, 16])
@pytest.mark.parametrize('blocks', [(None, None), (4, 16), (2, 16), (1, 64)])
def test_kernel_every_cache_and_group_twice_on_card(cuda_device, cache, g,
                                                    blocks):
    """int8, bf16 and f32 caches at 1, 4 and 16 query heads a kv head
    (16: four head groups of four), the picked and forced blocks: within
    2e-4 of the plain version, and a second launch gives the same bits."""
    dev = cuda_device
    b_blk, chunk = blocks
    k, v, ks, vs = (None if a is None else a.to(dev)
                    for a in _cache_kind(cache, seed=12))
    q = torch.randn(B, KVH * g, HD).to(dev)
    pos = _t(POS).to(dev)
    got = TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1, b_blk, chunk)
    again = TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1, b_blk, chunk)
    want = TB.batch_decode_plain(q, k, v, ks, vs, pos, 1, b_blk, chunk)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32'])
@pytest.mark.parametrize('B, smax, kvh, H', [(1, 4096, 32, 32),
                                             (8, 4096, 32, 32),
                                             (8, 4096, 8, 32),
                                             (8, 1024, 32, 32),
                                             (128, 96, 32, 32)])
def test_kernel_matches_plain_at_the_long_cache_on_card(cuda_device, cache,
                                                        B, smax, kvh, H):
    """chip_smoke's attention rows (Llama-2-7B's and Llama-3-8B's widths,
    up to the full context; the split plan at small batch) against the
    plain version (f32 both, 2e-4 of the output scale): positions inside
    the first chunk, at the last position of the splits' first chunks and
    the next one's first, random, and at the end of the cache; twice, to
    the same bits."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (2, B, smax, kvh, 128)
    if cache == 'int8':
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
    else:
        dt = torch.bfloat16 if cache == 'bf16' else torch.float32
        k = torch.randn(shape, generator=gen, device=dev).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        ks = vs = None
    q = torch.randn((B, H, 128), generator=gen, device=dev) / 128 ** 0.5
    _, splits = TB.kernel_plan(q, k)
    edge = splits * TB.WARP_CHUNK   # one chunk of every split, then wrap
    for p in ([0] * B, [min(edge - 1, smax - 1)] * B,
              [min(edge, smax - 1)] * B, [smax - 1] * B,
              np.random.RandomState(B).randint(0, smax, B).tolist()):
        pos = torch.tensor(p, dtype=torch.int32, device=dev)
        got = TB.batch_decode_attention(q, k, v, ks, vs, pos, 1)
        again = TB.batch_decode_attention(q, k, v, ks, vs, pos, 1)
        want = TB.batch_decode_plain(q, k, v, ks, vs, pos, 1)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4, p[:4]


@pytest.mark.gpu
@pytest.mark.parametrize('H', [32, 8])
def test_kernel_keeps_the_small_products_of_a_quantized_cache_on_card(
        cuda_device, H):
    """An int8 cache made by the port's own KV quantizer from keys of std 1
    and values of std 0.05 (V scales about 1e-3), q of scores that spread
    over a few units, over 4000 of 4096 positions at Llama-3-8B's 8 kv
    heads (G = 4, the tensor cores; and G = 1): most p times its V scale
    lies far below f16's normal range, which the tensor cores' f16 halves
    must not drop.  Within 2e-5 of the plain version (f32 rounding), twice
    to the same bits."""
    import chip_smoke
    dev = cuda_device
    q, k, v, ks, vs = chip_smoke.flash_inputs(dev, 8, 4096, 8, H, 128,
                                              cache='int8_kv')
    assert float(vs[1].median()) < 2e-3
    for p in ([4095] * 8, [3999] * 8,
              np.random.RandomState(3).randint(0, 4096, 8).tolist()):
        pos = torch.tensor(p, dtype=torch.int32, device=dev)
        got = TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1)
        again = TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1)
        want = TB.batch_decode_plain(q, k, v, ks, vs, pos, 1)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-5, p[:2]


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
        TB.batch_decode_cuda(q, k, v, ks, vs, pos, 1, 3, 16)
    with pytest.raises(ValueError, match='head dim'):
        TB.batch_decode_cuda(q[..., :24].contiguous(),
                             k[..., :24].contiguous(),
                             v[..., :24].contiguous(), ks, vs, pos, 1)
    with pytest.raises(ValueError, match='both'):
        TB.batch_decode_cuda(q, k.to(torch.bfloat16), v.to(torch.bfloat16),
                             None, vs, pos, 1)
    with pytest.raises(ValueError, match='float16'):
        TB.batch_decode_cuda(q, k.to(torch.float16), v.to(torch.float16),
                             None, None, pos, 1)
    assert TB.LAUNCHES['batch_decode'] == before
