"""FP8-block path of the PyTorch port against the JAX package on the CPU:
the float casts, the per-block weight cast and its inverse, the per-group
activation quantizer, and the blockwise-scaled GEMM's plain version
against the reference's XLA branch and its Pallas kernel in interpret
mode.  The Hopper kernel itself is held against the plain version and a
float64 oracle on the card (``gpu`` marker)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llmc_tpu.ops.fp8_gemm import fp8_block_matmul_pallas
from llmc_tpu.quant import fp8_block as JF
from llmc_tpu.quant import fp_formats as JFMT
from llmc_tpu.quant.qspec import QuantSpec as JQuantSpec
from llmc_tpu.quant.quantizer import fake_quant_weight as j_fake_quant
from llmc_tpu_torch.convert import tensor_from_numpy, tensor_to_numpy
from llmc_tpu_torch.ops import fp8_gemm as G
from llmc_tpu_torch.quant import (FLOAT_FORMATS, QuantSpec,
                                  act_quant_per_group, float_cast,
                                  fp8_block_matmul, weight_cast_to_bf16,
                                  weight_cast_to_fp8)
from llmc_tpu_torch.quant.quantizer import fake_quant_weight
from torch_port_helpers import cuda_device, rel_err  # noqa: F401

F32 = torch.float32


def t(a):
    return tensor_from_numpy(a, 'cpu')


def bits(a):
    """An array's bytes, for bit-equality of float8 / float32 values."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _format_grid(e_bits, m_bits, max_val):
    """Every representable value of the format, the midpoints between
    neighbours (the ties), values just off the ties, the subnormal range,
    +-max and beyond, and 0."""
    bias = 2 ** (e_bits - 1) - 1
    vals = [0.0]
    for e in range(0, 2 ** e_bits):
        for m in range(2 ** m_bits):
            v = (m / 2 ** m_bits) * 2.0 ** (1 - bias) if e == 0 else \
                (1 + m / 2 ** m_bits) * 2.0 ** (e - bias)
            if v <= max_val:
                vals.append(v)
    vals = np.unique(np.asarray(vals, np.float64))
    mids = (vals[1:] + vals[:-1]) / 2
    pts = np.concatenate([vals, mids, mids * (1 + 1e-6), mids * (1 - 1e-6),
                          [max_val * 1.01, max_val * 4, 1e-12,
                           vals[1] / 2, vals[1] / 4]])
    pts = np.concatenate([pts, -pts]).astype(np.float32)
    rnd = np.random.RandomState(0).standard_normal(4096).astype(np.float32)
    return np.concatenate([pts, rnd * max_val / 3,
                           rnd * vals[1] * 4]).astype(np.float32)


@pytest.mark.parametrize('fmt', ['e4m3', 'e5m2', 'e2m1', 'e3m2'])
def test_float_cast_bit_equal(fmt):
    e, m, mx = FLOAT_FORMATS[fmt]
    x = _format_grid(e, m, mx)
    want = np.asarray(JFMT.float_cast(jnp.asarray(x), e, m, mx))
    got = float_cast(t(x), e, m, mx).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert np.abs(got).max() == mx and (got[x == 0] == 0).all()


def test_float_cast_agrees_with_the_e4m3_storage_cast_in_range():
    """Inside +-448 the ported cast and ``.to(float8_e4m3fn)`` give the
    same codes, so storing the cast's result loses nothing."""
    x = _format_grid(4, 3, 448.0)
    x = x[np.abs(x) <= 448.0]
    got = float_cast(t(x), 4, 3, 448.0)
    np.testing.assert_array_equal(
        got.to(torch.float8_e4m3fn).to(F32).numpy(), got.numpy())


@pytest.mark.parametrize('shape,bs', [((256, 384), 128), ((64, 96), 32),
                                      ((70, 100), 32)])
def test_weight_cast_to_fp8_and_back_bit_equal(shape, bs):
    w = (np.random.RandomState(1).standard_normal(shape) * 0.05
         ).astype(np.float32)
    jc, js = JF.weight_cast_to_fp8(jnp.asarray(w), bs)
    tc, ts = weight_cast_to_fp8(t(w), bs)
    assert tc.dtype == torch.float8_e4m3fn and ts.dtype == F32
    assert tuple(ts.shape) == (-(-shape[0] // bs), -(-shape[1] // bs))
    np.testing.assert_array_equal(bits(tensor_to_numpy(tc)),
                                  bits(np.asarray(jc)))
    np.testing.assert_array_equal(bits(ts.numpy()), bits(np.asarray(js)))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jw = np.asarray(JF.weight_cast_to_bf16(jc, js, bs, jdt), np.float32)
        tw = weight_cast_to_bf16(tc, ts, bs, tdt).to(F32).numpy()
        np.testing.assert_array_equal(bits(tw), bits(jw))


def test_e4m3_codes_cross_the_converter_unchanged():
    a = np.random.RandomState(2).uniform(-448, 448, (16, 8)).astype(
        ml_dtypes.float8_e4m3fn)
    back = tensor_to_numpy(t(a))
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(bits(back), bits(a))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'randn64x1024'])
def test_act_quant_per_group_bit_equal(dtype):
    """Codes and scales equal the reference's under ``jax.jit``, where XLA
    folds ``amax / 448.0`` into a multiply by the f32 reciprocal of 448
    (the 64 x 1024 case: 248 of its 512 scales differ from a true
    division)."""
    x = (np.random.RandomState(3).standard_normal((3, 5, 256)) * 2
         ).astype(np.float32)
    x[0, 0, :128] = 0.0                      # an all-zero group
    if dtype == 'randn64x1024':
        x = (np.random.RandomState(1).randn(64, 1024) * 3).astype(np.float32)
        dtype = 'float32'
    jx = jnp.asarray(x).astype(dtype)
    tx = t(x).to(getattr(torch, dtype))
    jc, js = jax.jit(JF.act_quant_per_group, static_argnums=1)(jx, 128)
    tc, ts = act_quant_per_group(tx, 128)
    assert tuple(tc.shape) == x.shape
    assert tuple(ts.shape) == x.shape[:-1] + (x.shape[-1] // 128,)
    np.testing.assert_array_equal(bits(tensor_to_numpy(tc)),
                                  bits(np.asarray(jc)))
    np.testing.assert_array_equal(bits(ts.numpy()), bits(np.asarray(js)))


def _gemm_case(M, N, K, bs, seed=4):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((M, K)) * 1.5).astype(np.float32)
    w = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    jxc, jxs = JF.act_quant_per_group(jnp.asarray(x), bs)
    jwc, jws = JF.weight_cast_to_fp8(jnp.asarray(w), bs)
    j = (jxc, jxs, jwc, jws)
    return j, tuple(t(np.asarray(a)) for a in j)


@pytest.mark.parametrize('M,N,K,bs', [(5, 128, 256, 128), (33, 256, 384, 128),
                                      (7, 96, 128, 32)])
def test_fp8_block_matmul_plain_matches_xla_branch(M, N, K, bs):
    j, p = _gemm_case(M, N, K, bs)
    want = np.asarray(JF.fp8_block_matmul(*j, block_size=bs,
                                          out_dtype=jnp.float32,
                                          force_xla=True))
    got = fp8_block_matmul(*p, block_size=bs, out_dtype=F32).numpy()
    assert rel_err(got, want) <= 1e-5
    forced = fp8_block_matmul(*p, block_size=bs, out_dtype=F32,
                              force_plain=True).numpy()
    np.testing.assert_array_equal(forced, got)


@pytest.mark.parametrize('M', [1, 16, 37])
def test_fp8_block_matmul_plain_matches_pallas_interpret(M):
    j, p = _gemm_case(M, 256, 384, 128, seed=5)
    want = np.asarray(fp8_block_matmul_pallas(
        *j, block_size=128, tm=16, tn=128, out_dtype=jnp.float32,
        interpret=True))
    got = fp8_block_matmul(*p, out_dtype=F32).numpy()
    assert rel_err(got, want) <= 1e-5
    want16 = np.asarray(fp8_block_matmul_pallas(
        *j, block_size=128, tm=16, tn=128, out_dtype=jnp.bfloat16,
        interpret=True), np.float32)
    got16 = fp8_block_matmul(*p, out_dtype=torch.bfloat16).to(F32).numpy()
    # one bf16 ulp: 2^-8 of the value's own magnitude (2^-7 of a value
    # just above a power of two)
    assert (np.abs(got16 - want16)
            <= 2.0 ** -7 * np.abs(want16) + 1e-30).all()


@pytest.mark.parametrize('bs', [64, 256])
@pytest.mark.parametrize('M', [3, 16])
def test_fp8_plain_matches_xla_and_pallas_at_block_sizes(bs, M):
    """Block sizes 64 and 256, which the card's kernel now takes: the plain
    version against the reference's XLA branch and its Pallas kernel in
    interpret mode (which takes any block size), at f32, to 1e-5."""
    j, p = _gemm_case(M, 256, 512, bs, seed=12)
    assert tuple(p[3].shape) == (256 // bs, 512 // bs)
    got = fp8_block_matmul(*p, block_size=bs, out_dtype=F32).numpy()
    xla = np.asarray(JF.fp8_block_matmul(*j, block_size=bs,
                                         out_dtype=jnp.float32,
                                         force_xla=True))
    pallas = np.asarray(fp8_block_matmul_pallas(
        *j, block_size=bs, tm=16, tn=128, out_dtype=jnp.float32,
        interpret=True))
    assert rel_err(got, xla) <= 1e-5 and rel_err(got, pallas) <= 1e-5
    assert G.kernel_takes_block(512, bs)


@pytest.mark.parametrize('M', [1, 5])
def test_fp8_whole_k_block_off_16_bytes_matches_xla(M):
    """A scale block of the whole K = 1000 (no multiple of 16), which
    Mosaic lowers for the reference and the card's kernel now takes: the
    port's weight cast bit-equal to the reference's, its codes a view of
    rows padded to 1008 bytes with zero codes (what the kernel's TMA
    reads), and the plain version against the XLA branch, f32, 1e-5."""
    rng = np.random.RandomState(14)
    x = (rng.standard_normal((M, 1000)) * 1.5).astype(np.float32)
    w = (rng.standard_normal((96, 1000)) * 0.05).astype(np.float32)
    jxc, jxs = JF.act_quant_per_group(jnp.asarray(x), 1000)
    jwc, jws = JF.weight_cast_to_fp8(jnp.asarray(w), 1000)
    wc, ws = weight_cast_to_fp8(t(w), 1000)
    assert wc.shape == (96, 1000) and wc.stride() == (1008, 1)
    np.testing.assert_array_equal(bits(tensor_to_numpy(wc)),
                                  bits(np.asarray(jwc)))
    np.testing.assert_array_equal(bits(ws.numpy()), bits(np.asarray(jws)))
    pad = torch.as_strided(wc, (96, 8), (1008, 1), 1000)
    assert not pad.to(F32).any()
    assert G.kernel_takes_block(1000, 1000)
    want = np.asarray(JF.fp8_block_matmul(jxc, jxs, jwc, jws,
                                          block_size=1000,
                                          out_dtype=jnp.float32,
                                          force_xla=True))
    xc, xs = act_quant_per_group(t(x), 1000)
    got = fp8_block_matmul(xc, xs, wc, ws, block_size=1000, out_dtype=F32)
    assert got.shape == (M, 96) and rel_err(got.numpy(), want) <= 1e-5


def test_float64_oracle_is_the_plain_version_in_float64():
    _, p = _gemm_case(9, 128, 256, 128, seed=6)
    oracle = G.fp8_block_matmul_plain(*p, out_dtype=torch.float64,
                                      acc_dtype=torch.float64)
    xc, xs, wc, ws = (a.to(torch.float64) for a in p)
    dense = (xc.reshape(9, 2, 128) * xs[:, :, None]).reshape(9, 256) @ \
        (wc.reshape(128, 2, 128) * ws[0][None, :, None]).reshape(128, 256).T
    assert rel_err(oracle.numpy(), dense.numpy()) <= 1e-12
    got = G.fp8_block_matmul_plain(*p, out_dtype=F32)
    assert rel_err(got.numpy(), oracle.numpy()) <= 1e-6


@pytest.mark.parametrize('M,N,K', [(5, 200, 256), (3, 201, 384),
                                   (9, 1000, 128)])
def test_fp8_plain_matches_xla_branch_at_ragged_n(M, N, K):
    """N off the 128-row scale block, which the reference serves through
    its XLA branch and the card's kernel takes: the plain version against
    that branch, at f32, to 1e-5; and the kernel's shape rule accepts it,
    at block size 128 and, since the kernel takes every multiple of 64
    that divides K, at 64 too.  A block of 32 columns is still refused by
    the kernel's wrapper (the dispatch sends it to the XLA branch)."""
    j, p = _gemm_case(M, N, K, 128, seed=9)
    assert tuple(p[3].shape) == (-(-N // 128), K // 128)
    want = np.asarray(JF.fp8_block_matmul(*j, block_size=128,
                                          out_dtype=jnp.float32,
                                          force_xla=True))
    got = fp8_block_matmul(*p, out_dtype=F32).numpy()
    assert got.shape == (M, N) and rel_err(got, want) <= 1e-5
    assert G._check_fp8_meta(M, N, K, 128) == K // 128
    assert G._check_fp8_meta(M, N, K, 64) == K // 64
    with pytest.raises(NotImplementedError, match='ROADMAP B6'):
        G._check_fp8_meta(M, N, K, 32)
    with pytest.raises(ValueError, match='multiple'):
        G._check_fp8_meta(M, N, K + 64, 128)


def test_cuda_wrapper_refuses_a_cpu_tensor_and_dispatch_checks_device():
    _, p = _gemm_case(4, 128, 128, 128)
    with pytest.raises(ValueError, match='CUDA kernel'):
        G.fp8_block_matmul_cuda(*p)
    with pytest.raises(ValueError, match='unsupported device'):
        fp8_block_matmul(*(a.to('meta') for a in p))
    assert G.LAUNCHES['fp8_block_gemm'] == 0 or torch.cuda.is_available()


@pytest.mark.parametrize('fmt,gran', [('e4m3', 'per_channel'),
                                      ('e5m2', 'per_group'),
                                      ('e4m3', 'per_tensor')])
@pytest.mark.parametrize('scaled_cast', [True, False])
def test_float_fake_quant_weight_matches_reference(fmt, gran, scaled_cast):
    w = (np.random.RandomState(7).standard_normal((48, 64)) * 0.1
         ).astype(np.float32)
    kw = dict(bit=fmt, symmetric=True, granularity=gran, group_size=32,
              use_fp_scaled_cast=scaled_cast)
    want = np.asarray(j_fake_quant(JQuantSpec(**kw), jnp.asarray(w)))
    got = fake_quant_weight(QuantSpec(**kw), t(w)).numpy()
    assert rel_err(got, want) <= 1e-6


# --------------------------------------------------------------------------
# the kernel, on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('M', [1, 16, 77, 128, 600])
@pytest.mark.parametrize('N,K', [(128, 128), (512, 1024), (4096, 4096)])
def test_kernel_matches_plain_and_oracle_on_card(cuda_device, N, K, M):
    _, p = _gemm_case(M, N, K, 128, seed=8)
    p = tuple(a.to(cuda_device).contiguous() for a in p)
    oracle = G.fp8_block_matmul_plain(*p, out_dtype=torch.float64,
                                      acc_dtype=torch.float64).cpu().numpy()
    plain = G.fp8_block_matmul_plain(*p, out_dtype=F32).cpu().numpy()
    before = G.LAUNCHES['fp8_block_gemm']
    got = G.fp8_block_matmul_cuda(*p, out_dtype=F32)
    got16 = G.fp8_block_matmul_cuda(*p)
    assert G.LAUNCHES['fp8_block_gemm'] == before + 2
    assert got.shape == (M, N) and got16.dtype == torch.bfloat16
    assert rel_err(got.cpu().numpy(), oracle) <= 1e-5
    assert rel_err(got.cpu().numpy(), plain) <= 1e-5
    assert rel_err(got16.float().cpu().numpy(), plain) <= 1e-2


@pytest.mark.gpu
def test_kernel_route_raises_on_what_it_does_not_take(cuda_device):
    """The kernel's wrapper raises on block size 32, which the dispatch
    sends to the XLA branch on the card (no launch, one count, the plain
    version's result); a bf16 x raises; N=100, which raised before the
    kernel took ragged N, launches and matches the float64 oracle."""
    from llmc_tpu_torch.ops import reset_launch_counts, xla_branch_calls
    _, p = _gemm_case(4, 96, 128, 32)
    p = tuple(a.to(cuda_device) for a in p)
    with pytest.raises(NotImplementedError, match='ROADMAP B6'):
        G.fp8_block_matmul_cuda(*p, block_size=32)
    reset_launch_counts()
    got = fp8_block_matmul(*p, block_size=32, out_dtype=F32)
    want = G.fp8_block_matmul_plain(*p, block_size=32, out_dtype=F32)
    assert xla_branch_calls() == 1 and G.LAUNCHES['fp8_block_gemm'] == 0
    assert torch.equal(got, want)
    _, p = _gemm_case(4, 128, 256, 128)
    xc, xs, wc, ws = (a.to(cuda_device) for a in p)
    with pytest.raises((ValueError, TypeError)):
        fp8_block_matmul(xc.to(torch.bfloat16), xs, wc, ws)
    before = G.LAUNCHES['fp8_block_gemm']
    got = fp8_block_matmul(xc, xs, wc[:100], ws, out_dtype=F32)
    oracle = G.fp8_block_matmul_plain(xc, xs, wc[:100], ws,
                                      out_dtype=torch.float64,
                                      acc_dtype=torch.float64)
    assert G.LAUNCHES['fp8_block_gemm'] == before + 1
    assert got.shape == (4, 100)
    assert rel_err(got.cpu().numpy(), oracle.cpu().numpy()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize('M', [1, 8, 37, 128, 300])
@pytest.mark.parametrize('N,K', [(200, 256), (201, 384), (1000, 1024)])
def test_kernel_matches_oracle_at_ragged_n_on_card(cuda_device, N, K, M):
    """N off the 128-row block and the tile (odd too): f32 output within
    1e-5 of the float64 oracle, bf16 within 1e-2 of the plain version."""
    _, p = _gemm_case(M, N, K, 128, seed=10)
    p = tuple(a.to(cuda_device).contiguous() for a in p)
    oracle = G.fp8_block_matmul_plain(*p, out_dtype=torch.float64,
                                      acc_dtype=torch.float64).cpu().numpy()
    plain = G.fp8_block_matmul_plain(*p, out_dtype=F32).cpu().numpy()
    got = G.fp8_block_matmul_cuda(*p, out_dtype=F32)
    got16 = G.fp8_block_matmul_cuda(*p)
    assert got.shape == (M, N)
    assert rel_err(got.cpu().numpy(), oracle) <= 1e-5
    assert rel_err(got16.float().cpu().numpy(), plain) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize('M', [1, 37, 128, 300])
@pytest.mark.parametrize('N,K,bs', [(256, 512, 64), (200, 1024, 64),
                                    (512, 1024, 256), (201, 768, 256),
                                    (256, 384, 384), (130, 192, 192),
                                    (256, 96, 96)])
def test_kernel_matches_oracle_at_other_block_sizes_on_card(cuda_device, N,
                                                            K, bs, M):
    """Block sizes 64 (two rows of ws under a CTA's 128 weight rows), 256
    (a block over two K steps), the whole K (384; 192, one unit a step; 96,
    a last unit that TMA fills past K), at ragged N too: f32 output within
    1e-5 of the float64 oracle, bf16 within 1e-2 of the plain version,
    one launch each."""
    _, p = _gemm_case(M, N, K, bs, seed=13)
    p = tuple(a.to(cuda_device).contiguous() for a in p)
    oracle = G.fp8_block_matmul_plain(*p, block_size=bs,
                                      out_dtype=torch.float64,
                                      acc_dtype=torch.float64).cpu().numpy()
    plain = G.fp8_block_matmul_plain(*p, block_size=bs,
                                      out_dtype=F32).cpu().numpy()
    before = G.LAUNCHES['fp8_block_gemm']
    got = fp8_block_matmul(*p, block_size=bs, out_dtype=F32)
    got16 = fp8_block_matmul(*p, block_size=bs)
    assert G.LAUNCHES['fp8_block_gemm'] == before + 2
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert rel_err(got.cpu().numpy(), oracle) <= 1e-5
    assert rel_err(got16.float().cpu().numpy(), plain) <= 1e-2


@pytest.mark.gpu
def test_kernel_keeps_every_bit_of_a_block_sum_on_card(cuda_device):
    """chip_smoke's adder probe (products spanning 20 bits in every k32
    step) within 1e-5 of the float64 oracle: the kernel sums a block in
    f32, not in the fp8 tensor cores' shorter adder."""
    import chip_smoke
    assert chip_smoke.fp8_adder_probe(cuda_device) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize('M', [1, 77, 128])
@pytest.mark.parametrize('N', [96, 4096])
@pytest.mark.parametrize('K', [1000, 1001])
def test_kernel_takes_whole_k_off_16_bytes_on_card(cuda_device, M, N, K):
    """Block = K = 1000 and 1001 (rows of no whole 16 bytes, read in 8- or
    1-byte pieces without TMA): the weight cast on the card (rows padded to
    16 bytes once, when it is packed, read by TMA), the same codes in
    contiguous rows, and a cast made on the CPU and moved by ``.to`` (which
    drops the padding) each launch the kernel (no XLA-branch call), f32
    within 1e-5 of the float64 oracle."""
    from llmc_tpu_torch.ops import reset_launch_counts, xla_branch_calls
    dev = cuda_device
    gen = torch.Generator().manual_seed(15)
    w = torch.randn((N, K), generator=gen) * 0.05
    x = (torch.randn((M, K), generator=gen) * 1.5).to(dev)
    wc, ws = weight_cast_to_fp8(w.to(dev), K)
    wc_cpu, ws_cpu = weight_cast_to_fp8(w, K)
    moved = wc_cpu.to(dev)
    assert moved.is_contiguous()
    xc, xs = act_quant_per_group(x, K)
    oracle = G.fp8_block_matmul_plain(xc, xs, wc, ws, K,
                                      out_dtype=torch.float64,
                                      acc_dtype=torch.float64)
    for codes, scales in ((wc, ws), (wc.contiguous(), ws),
                          (moved, ws_cpu.to(dev))):
        reset_launch_counts()
        got = fp8_block_matmul(xc, xs, codes, scales, block_size=K,
                               out_dtype=F32)
        torch.cuda.synchronize()
        assert G.LAUNCHES['fp8_block_gemm'] == 1 and xla_branch_calls() == 0
        assert got.shape == (M, N)
        assert rel_err(got.cpu().numpy(), oracle.cpu().numpy()) <= 1e-5
