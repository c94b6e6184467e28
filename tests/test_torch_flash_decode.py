"""Port parity of flash-decode attention (llmc_tpu_torch.ops.flash_decode):
the plain version against the reference's Pallas kernel in interpret
mode and its XLA chunked reader, int8 and fp caches, GQA, per-slot
positions at chunk boundaries; the Hopper kernel against the plain
version on the card."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.serve import decode as JDec
from torch_port_helpers import cuda_device, rel_err  # noqa: F401

JF = importlib.import_module('llmc_tpu.ops.flash_decode')
TF = importlib.import_module('llmc_tpu_torch.ops.flash_decode')
torch.set_num_threads(1)

L, B, S, KVH, HD = 3, 4, 64, 4, 32
# positions: chunk interior, chunk boundaries (15/16 at chunk 16), mid,
# and the last slot of the cache
POS = np.array([5, 15, 16, S - 1], np.int32)


def _cache(quantized, seed=0, kvh=KVH, hd=HD):
    rng = np.random.default_rng(seed)
    shape = (L, B, S, kvh, hd)
    if quantized:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(.01, .03, shape[:-1]).astype(np.float32),
                rng.uniform(.01, .03, shape[:-1]).astype(np.float32))
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32), None, None)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize('g', [1, 2])
@pytest.mark.parametrize('quantized', [True, False])
@pytest.mark.parametrize('chunk', [16, None])
def test_plain_matches_pallas_interpret(g, quantized, chunk):
    """Plain version vs the reference's Pallas kernel (interpret, chunk
    16): f32 throughout, 2e-5 relative (exp and summation order)."""
    k, v, ks, vs = _cache(quantized)
    q = np.random.default_rng(1).normal(size=(B, KVH * g, HD)).astype(
        np.float32)
    want = JF.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), jnp.asarray(POS),
        jnp.asarray(1, jnp.int32), chunk=16, interpret=True)
    got = TF.flash_decode_attention(_t(q), _t(k), _t(v), _t(ks), _t(vs),
                                    _t(POS), 1, chunk=chunk)
    assert got.shape == (B, KVH * g, HD)
    assert rel_err(got.numpy(), want) < 2e-5


def test_plain_matches_xla_chunked_reader():
    """The reference's XLA chunked reader (decode.py:139-207) over the
    same int8 cache and per-slot positions."""
    k, v, ks, vs = _cache(True, seed=3)
    g = 2
    cfg = JConfig(num_attention_heads=KVH * g, num_key_value_heads=KVH,
                  head_dim=HD)
    q = np.random.default_rng(4).normal(size=(B, 1, KVH * g, HD)).astype(
        np.float32)
    cache = {'k_q': jnp.asarray(k), 'v_q': jnp.asarray(v),
             'k_s': jnp.asarray(ks), 'v_s': jnp.asarray(vs),
             'pos': jnp.asarray(POS)}
    policy = JDec.KVCachePolicy(method='naive', bit=8)
    want = JDec._decode_attn_chunked(jnp.asarray(q), cache, 2, policy, cfg,
                                     32)
    got = TF.flash_decode_attention(_t(q[:, 0]), _t(k), _t(v), _t(ks),
                                    _t(vs), _t(POS), 2)
    assert rel_err(got.numpy(), np.asarray(want)[:, 0]) < 2e-5


FLOAT_KINDS = {'bf16': torch.bfloat16, 'f16': torch.float16,
               'f32': torch.float32}


def _cache_kind(kind, seed, kvh=KVH):
    k, v, ks, vs = _cache(kind == 'int8', seed, kvh)
    k, v, ks, vs = _t(k), _t(v), _t(ks), _t(vs)
    if kind in FLOAT_KINDS:
        k, v = k.to(FLOAT_KINDS[kind]), v.to(FLOAT_KINDS[kind])
    return k, v, ks, vs


def _jax(a):
    if a is None:
        return None
    if a.dtype == torch.bfloat16:
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(a.numpy())


@pytest.mark.parametrize('cache, g', [('f32', 1), ('f32', 4), ('f32', 16),
                                      ('int8', 16), ('bf16', 16),
                                      ('f16', 1), ('f16', 4), ('f16', 16)])
def test_plain_matches_pallas_at_f32_caches_and_16_heads(cache, g):
    """An f32 or fp16 cache (which the reference's kernel casts in its
    body) and 16 query heads a kv head (Llama-3.1-405B's 128 over 8): the
    plain version against the reference's Pallas kernel in interpret mode,
    f32 arithmetic on the same values, 2e-5 relative."""
    k, v, ks, vs = _cache_kind(cache, seed=13)
    q = np.random.default_rng(14).normal(size=(B, KVH * g, HD)).astype(
        np.float32)
    want = JF.flash_decode_attention(
        jnp.asarray(q), _jax(k), _jax(v), _jax(ks), _jax(vs),
        jnp.asarray(POS), jnp.asarray(1, jnp.int32), chunk=16,
        interpret=True)
    got = TF.flash_decode_attention(_t(q), k, v, ks, vs, _t(POS), 1)
    assert got.shape == (B, KVH * g, HD)
    assert rel_err(got.numpy(), want) < 2e-5


def test_cpu_tensors_take_plain_version_without_launch():
    k, v, ks, vs = _cache(True)
    q = torch.randn(B, KVH, HD)
    before = TF.LAUNCHES['flash_decode']
    TF.flash_decode_attention(q, _t(k), _t(v), _t(ks), _t(vs), _t(POS), 0)
    assert TF.LAUNCHES['flash_decode'] == before
    with pytest.raises(ValueError, match='CUDA'):
        TF.flash_decode_cuda(q, _t(k), _t(v), _t(ks), _t(vs), _t(POS), 0)


@pytest.mark.gpu
@pytest.mark.parametrize('quantized', [True, False])
@pytest.mark.parametrize('g', [1, 3, 4, 8])
@pytest.mark.parametrize('hd', [64, 128])
def test_kernel_matches_plain_on_card(cuda_device, quantized, g, hd):
    """The Hopper kernel vs the plain version on the card (f32 both): 2e-4
    of the output scale (exp and summation order)."""
    dev = cuda_device
    k, v, ks, vs = _cache(quantized, seed=5, hd=hd)
    if not quantized:
        k = torch.as_tensor(k).to(torch.bfloat16)
        v = torch.as_tensor(v).to(torch.bfloat16)
    args = [_t(a) if not isinstance(a, torch.Tensor) else a
            for a in (k, v, ks, vs)]
    args = [None if a is None else a.to(dev) for a in args]
    q = torch.randn(B, KVH * g, hd).to(dev)
    pos = _t(POS).to(dev)
    before = TF.LAUNCHES['flash_decode']
    got = TF.flash_decode_attention(q, *args, pos, 2)
    want = TF.flash_decode_plain(q, *args, pos, 2)
    torch.cuda.synchronize()
    assert TF.LAUNCHES['flash_decode'] == before + 1
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4


@pytest.mark.parametrize('B, kvh, smax, quant, want', [
    (128, 32, 96, True, (1, 2)), (8, 32, 1024, True, (4, 4)),
    (1, 32, 4096, True, (32, 2)), (8, 32, 4096, True, (5, 13)),
    (8, 8, 4096, True, (16, 4)), (128, 32, 96, False, (1, 2)),
    (8, 32, 1024, False, (3, 6)), (1, 32, 4096, False, (16, 4)),
    (8, 32, 4096, False, (3, 22)), (8, 8, 4096, False, (8, 8))])
def test_split_plan_fills_the_card_twice(B, kvh, smax, quant, want):
    """The kernel's (splits, chunks a split) on 132 SMs at the bench shape,
    the long caches of ``chip_smoke`` and Llama-3-8B's 8 kv heads: one
    split where the slots and kv heads fill twice the resident CTAs (the
    bench shape: no combine), else about that many CTAs, every split
    holding a chunk and the splits covering the cache."""
    kind = 'int8' if quant else 'bf16'
    splits, cps = TF.split_plan(B, kvh, smax, 132, kind)
    assert (splits, cps) == want
    nch = -(-smax // TF.KERNEL_CHUNK)
    assert (splits - 1) * cps < nch <= splits * cps
    if splits > 1:
        assert B * kvh * splits >= 2 * 132 * TF.RESIDENT[kind] * 0.7


@pytest.mark.parametrize('B, kvh, groups, kind, want', [
    (1, 32, 1, 'f32', (8, 8)), (8, 8, 2, 'bf16', (5, 13)),
    (8, 8, 2, 'int8', (8, 8)), (128, 8, 2, 'f32', (1, 64))])
def test_split_plan_counts_head_groups_and_f32(B, kvh, groups, kind, want):
    """An f32 cache keeps one CTA an SM (a ring of three 64-row chunks of
    f32 K and V), and each group of eight query heads is a CTA of its own:
    both enter the CTAs the plan fills (Llama-3.1-405B: 128 query heads
    over 8 kv heads, two groups)."""
    assert TF.split_plan(B, kvh, 4096, 132, kind, groups) == want


def test_splits_past_pos_exit():
    """A split holds a valid position only up to the one that holds pos:
    the later ones exit at once (the kernel's ``c0 > pos / 64``), and the
    plain twin's states for them are empty."""
    pos = torch.tensor([0, 63, 64, 127, 128, 4095], dtype=torch.int32)
    assert TF.active_splits(pos, 32, 2).tolist() == [1, 1, 1, 1, 2, 32]
    assert TF.active_splits(pos, 5, 13).tolist() == [1, 1, 1, 1, 1, 5]


@pytest.mark.parametrize('splits, cps', [(2, 2), (4, 1), (3, 2), (1, 4)])
@pytest.mark.parametrize('quantized', [True, False])
@pytest.mark.parametrize('g', [1, 4])
def test_split_combine_equals_one_pass(splits, cps, quantized, g):
    """The kernel's arithmetic in its plain twin: each split's own online
    softmax, the splits merged in split order, against the one-pass plain
    version, f32, to 1e-6 relative; positions inside the first split, at
    chunk and split boundaries and at the end of the cache."""
    smax = 256
    rng = np.random.default_rng(7)
    shape = (2, 5, smax, 2, HD)
    if quantized:
        k = torch.as_tensor(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.as_tensor(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.as_tensor(rng.uniform(.01, .03, shape[:-1]).astype(
            np.float32))
        vs = torch.as_tensor(rng.uniform(.01, .03, shape[:-1]).astype(
            np.float32))
    else:
        k = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        v = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        ks = vs = None
    q = torch.as_tensor(rng.normal(size=(5, 2 * g, HD)).astype(np.float32))
    pos = torch.tensor([0, 63, 64, 130, smax - 1], dtype=torch.int32)
    want = TF.flash_decode_plain(q, k, v, ks, vs, pos, 1)
    got = TF.flash_decode_split_plain(q, k, v, ks, vs, pos, 1, splits, cps)
    assert rel_err(got.numpy(), want.numpy()) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize('quantized', [True, False])
@pytest.mark.parametrize('B, smax, kvh, H', [(1, 4096, 32, 32),
                                             (8, 4096, 32, 32),
                                             (8, 4096, 8, 32),
                                             (8, 1024, 32, 32),
                                             (128, 96, 32, 32)])
def test_kernel_matches_plain_at_the_long_cache_on_card(cuda_device,
                                                        quantized, B, smax,
                                                        kvh, H):
    """The split kernel at Llama-2-7B's and Llama-3-8B's attention widths
    and full context against the plain version (f32 both, 2e-4 of the
    output scale): positions inside the first split, at a split's last
    position and the next one's first, random, and at the end of the
    cache; twice, to the same bits (the splits merge in a fixed order)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(11)
    shape = (2, B, smax, kvh, 128)
    if quantized:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
    q = torch.randn((B, H, 128), generator=gen, device=dev) / 128 ** 0.5
    splits, cps = TF.split_plan(B, kvh, smax,
                                torch.cuda.get_device_properties(
                                    dev).multi_processor_count,
                                'int8' if quantized else 'bf16')
    edge = cps * TF.KERNEL_CHUNK
    for p in ([0] * B, [min(edge - 1, smax - 1)] * B,
              [min(edge, smax - 1)] * B, [smax - 1] * B,
              np.random.RandomState(B).randint(0, smax, B).tolist()):
        pos = torch.tensor(p, dtype=torch.int32, device=dev)
        before = TF.LAUNCHES['flash_decode']
        got = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
        again = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
        want = TF.flash_decode_plain(q, k, v, ks, vs, pos, 1)
        torch.cuda.synchronize()
        assert TF.LAUNCHES['flash_decode'] == before + 2
        assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
        assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4, p[:4]


@pytest.mark.gpu
@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32', 'f16'])
@pytest.mark.parametrize('g', [1, 4, 12, 16])
@pytest.mark.parametrize('B, smax', [(4, 64), (8, 1024), (1, 4096)])
def test_kernel_f32_caches_and_many_heads_on_card(cuda_device, cache, g, B,
                                                  smax):
    """f32 and fp16 caches and up to 16 query heads a kv head (12 and 16:
    head groups of eight, the second one short at 12) against the plain
    version on the card, 2e-4; split and unsplit plans; a rerun gives the
    same bits."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(17)
    kvh = 4
    shape = (2, B, smax, kvh, 128)
    if cache == 'int8':
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
    else:
        dt = FLOAT_KINDS[cache]
        k = torch.randn(shape, generator=gen, device=dev).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        ks = vs = None
    q = torch.randn((B, kvh * g, 128), generator=gen, device=dev) / 128 ** .5
    pos = torch.tensor(np.random.RandomState(g).randint(0, smax, B),
                       dtype=torch.int32, device=dev)
    before = TF.LAUNCHES['flash_decode']
    got = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
    again = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
    want = TF.flash_decode_plain(q, k, v, ks, vs, pos, 1)
    torch.cuda.synchronize()
    assert TF.LAUNCHES['flash_decode'] == before + 2
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4


def _hd_cache(kind, hd, kvh, B_, smax, gen, dev):
    """A random cache of one kind at head dim ``hd`` on ``dev``."""
    shape = (2, B_, smax, kvh, hd)
    if kind == 'int8':
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * .02 + .01
        return k, v, ks, vs
    dt = FLOAT_KINDS[kind]
    return (torch.randn(shape, generator=gen, device=dev).to(dt),
            torch.randn(shape, generator=gen, device=dev).to(dt), None, None)


@pytest.mark.parametrize('hd', [72, 256])
@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32', 'f16'])
@pytest.mark.parametrize('g', [1, 4])
def test_plain_matches_pallas_at_head_dims_72_and_256(hd, cache, g):
    """Head dims 72 (no multiple of 16) and 256 (above 128), which the
    card refused before: the plain version against the reference's Pallas
    kernel in interpret mode, which takes any head dim, 2e-5."""
    gen = torch.Generator().manual_seed(hd + g)
    k, v, ks, vs = _hd_cache(cache, hd, 2, 4, 64, gen, 'cpu')
    q = torch.randn((4, 2 * g, hd), generator=gen) / hd ** .5
    pos = torch.tensor([5, 15, 16, 63], dtype=torch.int32)
    want = JF.flash_decode_attention(
        jnp.asarray(q.numpy()), _jax(k), _jax(v), _jax(ks), _jax(vs),
        jnp.asarray(pos.numpy()), jnp.asarray(1, jnp.int32), chunk=16,
        interpret=True)
    got = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
    assert got.shape == (4, 2 * g, hd)
    assert rel_err(got.numpy(), want) < 2e-5


def test_head_dim_rule():
    """The laid-out row and what the kernels take: up to 256 channels in
    rows of 4-byte words."""
    assert [TF.kernel_hd(h) for h in (8, 16, 64, 72, 96, 128, 200, 256)] \
        == [16, 16, 64, 128, 128, 128, 256, 256]
    assert TF.kernel_takes_hd(72) and TF.kernel_takes_hd(256)
    assert not TF.kernel_takes_hd(18) and not TF.kernel_takes_hd(264)


@pytest.mark.gpu
@pytest.mark.parametrize('hd', [72, 256])
@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32', 'f16'])
@pytest.mark.parametrize('g', [1, 4, 12])
@pytest.mark.parametrize('B, smax', [(4, 64), (8, 1024), (1, 4096)])
def test_kernel_at_head_dims_72_and_256_on_card(cuda_device, hd, cache, g,
                                                 B, smax):
    """B2 at head dims 72 and 256 on every cache kind, one to twelve query
    heads a kv head, split and unsplit plans: within 2e-4 of the plain
    version on the card, a rerun the same bits, one launch a call."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(hd + 7 * g + B)
    k, v, ks, vs = _hd_cache(cache, hd, 2, B, smax, gen, dev)
    q = torch.randn((B, 2 * g, hd), generator=gen, device=dev) / hd ** .5
    pos = torch.tensor(np.random.RandomState(g).randint(0, smax, B),
                       dtype=torch.int32, device=dev)
    before = TF.LAUNCHES['flash_decode']
    got = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
    again = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
    want = TF.flash_decode_plain(q, k, v, ks, vs, pos, 1)
    torch.cuda.synchronize()
    assert TF.LAUNCHES['flash_decode'] == before + 2
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize('kvh', [1, 3])
@pytest.mark.parametrize('cache', ['int8', 'bf16', 'f32', 'f16'])
def test_kernel_head_dim_72_at_odd_kv_heads_on_card(cuda_device, kvh, cache):
    """Head dim 72 over one or three kv heads, where a cache row (72 bytes
    of int8 a head) is no multiple of 16 bytes: the rows copied in the
    kernel, within 2e-4 of the plain version."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(kvh)
    k, v, ks, vs = _hd_cache(cache, 72, kvh, 4, 256, gen, dev)
    q = torch.randn((4, 2 * kvh, 72), generator=gen, device=dev) / 72 ** .5
    pos = torch.tensor([0, 63, 64, 255], dtype=torch.int32, device=dev)
    got = TF.flash_decode_attention(q, k, v, ks, vs, pos, 1)
    want = TF.flash_decode_plain(q, k, v, ks, vs, pos, 1)
    torch.cuda.synchronize()
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2e-4
