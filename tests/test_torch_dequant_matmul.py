"""Port parity of the W4 dequant-matmul (llmc_tpu_torch.ops.dequant_matmul):
packing bit-equal to llmc_tpu, the plain matmul against the reference's
XLA path (about 1e-5 relative at f32) and its Pallas kernel in interpret
mode, and the kernel against the plain version on the card."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu_torch.convert import tensor_from_numpy
from torch_port_helpers import cuda_device, rel_err  # noqa: F401

# the packages re-export the function dequant_matmul under the module's
# name, so the modules are looked up by their full name
JD = importlib.import_module('llmc_tpu.ops.dequant_matmul')
TD = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
torch.set_num_threads(1)
CPU = torch.device('cpu')


def _case(sym, N=64, K=256, gs=64, seed=0):
    """Codes in range, per-group scales and zeros, packed by JAX."""
    rng = np.random.RandomState(seed)
    lo = -8 if sym else 0
    codes = rng.randint(lo, lo + 16, (N, K)).astype(np.int8)
    scales = ((0.01 + rng.rand(N, K // gs)) * 0.02).astype(np.float32)
    zeros = None if sym else rng.randint(0, 16, (N, K // gs)).astype(
        np.float32)
    meta = JD.QMeta(bits=4, group_size=gs, symmetric=sym, out_features=N,
                    in_features=K)
    tmeta = TD.QMeta(**dataclasses.asdict(meta))
    return codes, scales, zeros, meta, tmeta


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('gs', [64, 256])          # ng = 4, and ng = 1
def test_pack_weight_bit_equal(sym, gs):
    codes, scales, zeros, meta, tmeta = _case(sym, gs=gs)
    jp, js, jz = JD.pack_weight(jnp.asarray(codes), jnp.asarray(scales),
                                None if zeros is None else jnp.asarray(zeros),
                                meta)
    tp, ts, tz = TD.pack_weight(_t(codes), _t(scales), _t(zeros), tmeta)
    assert tp.dtype == torch.uint8 and str(jp.dtype) == 'uint8'
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if zeros is not None:
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(
        TD.unpack_weight(tp, tmeta).numpy(),
        np.asarray(JD.unpack_weight_xla(jp, meta)))
    st, zst = TD.pack_scales_t(ts, tz, tmeta)
    jst, jzst = JD.pack_scales_t(js, jz, meta)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(zst.numpy(), np.asarray(jzst))


@pytest.mark.parametrize('sym', [True, False])
def test_dequant_weight_bit_equal(sym):
    codes, scales, zeros, meta, tmeta = _case(sym)
    jp, js, jz = JD.pack_weight(jnp.asarray(codes), jnp.asarray(scales),
                                None if zeros is None else jnp.asarray(zeros),
                                meta)
    tp, ts, tz = TD.pack_weight(_t(codes), _t(scales), _t(zeros), tmeta)
    np.testing.assert_array_equal(
        TD.dequant_weight(tp, ts, tz, tmeta).numpy(),
        np.asarray(JD.dequant_weight_xla(jp, js, jz, meta)))


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('pre_t', [True, False])
@pytest.mark.parametrize('gs', [64, 256])
@pytest.mark.parametrize('out', ['same', 'f32'])
def test_plain_matmul_matches_xla(sym, pre_t, gs, out):
    """Plain matmul vs the reference's XLA path, f32 inputs: about 1e-5
    relative (only the f32 summation order differs)."""
    codes, scales, zeros, meta, tmeta = _case(sym, gs=gs)
    jp, js, jz = JD.pack_weight(jnp.asarray(codes), jnp.asarray(scales),
                                None if zeros is None else jnp.asarray(zeros),
                                meta)
    if pre_t:
        js, jz = JD.pack_scales_t(js, jz, meta)
        meta = dataclasses.replace(meta, pre_t=True)
    tmeta = TD.QMeta(**dataclasses.asdict(meta))
    x = np.random.RandomState(1).randn(3, 5, 256).astype(np.float32)
    od = jnp.float32 if out == 'f32' else None
    want = JD.dequant_matmul(jnp.asarray(x), jp, js, jz, meta,
                             force_xla=True, out_dtype=od)
    got = TD.dequant_matmul(_t(x), _t(jp), _t(js), _t(jz), tmeta,
                            out_dtype=torch.float32 if out == 'f32'
                            else None)
    assert got.shape == (3, 5, 64) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('gs', [128, 64])
def test_plain_matches_pallas_kernel_interpret(sym, gs):
    """The reference's Pallas kernel (interpret mode) casts x to bf16;
    held to the plain version on the same bf16-rounded x, to 1e-5, at
    half groups of 128 and of 64 columns (both served by the kernel)."""
    codes, scales, zeros, meta, tmeta = _case(sym, N=128, K=256, gs=gs)
    jp, js, jz = JD.pack_weight(jnp.asarray(codes), jnp.asarray(scales),
                                None if zeros is None else jnp.asarray(zeros),
                                meta)
    x = np.random.RandomState(2).randn(8, 256).astype(np.float32) * 0.1
    xb = torch.as_tensor(x).to(torch.bfloat16)
    want = JD.dequant_matmul_pallas(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), jp, js, jz, meta, tm=16, tn=128, interpret=True,
        out_dtype=jnp.float32)
    got = TD.dequant_matmul(xb.float(), _t(jp), _t(js), _t(jz), tmeta,
                            out_dtype=torch.float32)
    assert rel_err(got.numpy(), want) < 1e-5


def test_int8_stored_bytes_reinterpreted_as_uint8():
    """The reference's random_packed_llama stores packed bytes as int8.  Its
    XLA path masks them (reads 0..15 nibbles); its Pallas kernel
    sign-extends them (dequant_matmul.py:216) and departs.  The port's
    converter reinterprets int8 bytes as uint8, so the port matches the
    XLA path — and the reference kernel does not."""
    rng = np.random.RandomState(4)
    N, K, gs = 128, 256, 128
    meta = JD.QMeta(bits=4, group_size=gs, symmetric=True, out_features=N,
                    in_features=K, pre_t=True)
    q8 = rng.randint(-128, 128, (N, K // 2)).astype(np.int8)
    s = np.full((K // gs, N), 0.008, np.float32)
    zs = np.full((K // gs, N), 0.064, np.float32)
    x = rng.randn(4, K).astype(np.float32)
    xla = np.asarray(JD.dequant_matmul(jnp.asarray(x), jnp.asarray(q8),
                                       jnp.asarray(s), jnp.asarray(zs), meta,
                                       force_xla=True))
    packed = tensor_from_numpy(q8, CPU, packed=True)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), q8.view(np.uint8))
    got = TD.dequant_matmul(_t(x), packed, _t(s), _t(zs),
                            TD.QMeta(**dataclasses.asdict(meta)))
    assert rel_err(got.numpy(), xla) < 1e-5
    kern = np.asarray(JD.dequant_matmul_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q8),
        jnp.asarray(s), jnp.asarray(zs), meta, tm=16, tn=128,
        interpret=True, out_dtype=jnp.float32))
    assert rel_err(kern, xla) > 0.1      # the reference fault, pinned


def test_odd_group_count_and_bits8_raise():
    codes, scales, zeros, meta, tmeta = _case(True, K=192, gs=64)
    with pytest.raises(ValueError, match='even group count'):
        TD.pack_weight(_t(codes), _t(scales), None, tmeta)
    # bits=8 is served: signed int8 codes, here three groups of 64
    m8 = dataclasses.replace(tmeta, bits=8)
    x = torch.randn(2, 192)
    got = TD.dequant_matmul(x, _t(codes), _t(scales), None, m8)
    want = x @ (_t(codes).float().reshape(64, 3, 64)
                * _t(scales)[:, :, None]).reshape(64, 192).T
    assert rel_err(got.numpy(), want.numpy()) < 1e-5


def test_cpu_tensor_takes_plain_version_without_launch():
    codes, scales, zeros, meta, tmeta = _case(True)
    tp, ts, _ = TD.pack_weight(_t(codes), _t(scales), None, tmeta)
    before = TD.LAUNCHES['w4_dequant_matmul']
    TD.dequant_matmul(torch.randn(2, 256), tp, ts, None, tmeta)
    assert TD.LAUNCHES['w4_dequant_matmul'] == before
    with pytest.raises(ValueError, match='CUDA'):
        st, zst = TD.pack_scales_t(ts, None, tmeta)
        TD.w4_dequant_matmul(torch.zeros(2, 256, dtype=torch.bfloat16), tp,
                             st, zst, tmeta, torch.bfloat16)


@pytest.mark.parametrize('gs, K, ok', [(128, 512, True), (256, 256, True),
                                       (64, 256, True), (128, 128, True),
                                       (192, 192, False)])
def test_kernel_takes_only_128_column_half_groups(gs, K, ok):
    """The W4A16 kernel reads each half group in 64-column pieces: group
    size 64 and a single group of 128 columns are taken; a half group of
    96 columns (one group of 192) raises."""
    meta = TD.QMeta(bits=4, group_size=gs, symmetric=True, out_features=64,
                    in_features=K)
    if ok:
        gsl, single = TD._check_kernel_meta(meta, 8, K)
        assert gsl % 64 == 0 and single == (gs == K)
    else:
        with pytest.raises(NotImplementedError, match='B1'):
            TD._check_kernel_meta(meta, 8, K)


@pytest.mark.parametrize('gs, K, ok', [(128, 512, True), (256, 256, True),
                                       (64, 256, True), (128, 128, True),
                                       (192, 192, False), (96, 384, False),
                                       (32, 256, False)])
def test_w4_half_groups_off_64_columns_go_to_the_xla_branch(gs, K, ok):
    """The W4A16 and W4A8 kernels on the wgmma skeleton read each half
    group in 64-column pieces (the wrapper's rule, span 64): group size 64
    and a single group of 128 columns are taken; a half group of 96 or 32
    columns is refused by the wrappers, and ``kernel_takes`` sends it to
    the reference's XLA branch on the card, as the reference's own rule
    does (its Pallas kernels want half groups of 128)."""
    meta = TD.QMeta(bits=4, group_size=gs, symmetric=True, out_features=64,
                    in_features=K)
    assert TD.kernel_takes(meta) == ok and TD.kernel_takes(meta, True) == ok
    if ok:
        gsl, single = TD._check_kernel_meta(meta, 8, K, span=TD.WG_UNIT,
                                            item='B3')
        assert gsl % 64 == 0 and single == (gs == K)
    else:
        with pytest.raises(NotImplementedError, match='B3'):
            TD._check_kernel_meta(meta, 8, K, span=TD.WG_UNIT, item='B3')


@pytest.mark.parametrize('sms', [114, 132])
def test_kernel_tiling_splits_k_below_one_wave(sms):
    """Decode-sized grids split K until they fill the card's SMs; a
    prefill-sized grid does not split."""
    bm, splits = TD.kernel_tiling(1, 4096, 4096, 128, sms)
    assert bm == 16 and splits == 8    # 32 tiles x 8 splits >= 2 CTAs an SM
    assert TD.kernel_tiling(4096, 22016, 4096, 128, sms) == (64, 1)


@pytest.mark.parametrize('M, tile', [(1, 8), (8, 8), (9, 16), (16, 16),
                                     (37, 64), (64, 64), (77, 128),
                                     (128, 128), (300, 128), (4096, 128)])
def test_wgmma_tiling_token_tile_follows_m(M, tile):
    """The wgmma kernels' token tile (wgmma's N) is the smallest that holds
    M, else 128; a prefill-sized grid does not split K."""
    assert TD.wgmma_tiling(M, 22016, TD.w4_steps(4096, 128), 132)[0] == tile
    assert TD.wgmma_tiling(4096, 4096, 32, 132) == (128, 1)


@pytest.mark.parametrize('sms', [114, 132])
@pytest.mark.parametrize('N, K', [(4096, 4096), (12288, 4096),
                                  (22016, 4096), (4096, 11008)])
def test_wgmma_tiling_splits_k_at_decode(sms, N, K):
    """At decode tiles the K loop (of the W4 kernel's steps) is split so that
    the CTAs fill their last wave of SMs (a tail wave costs a full one):
    at least 80% of every wave busy, better than without a split where
    that falls short, and every split with a share of the units."""
    units = TD.w4_steps(K, 128)
    tile, splits = TD.wgmma_tiling(1, N, units, sms)
    tiles = -(-N // TD.WG_ROWS)

    def fill(n):
        return tiles * n / (-(-tiles * n // sms) * sms)
    assert tile == 8 and 1 <= splits <= units
    assert fill(splits) >= max(0.8, fill(1))
    per = -(-units // splits)
    assert -(-units // per) == splits     # no split left empty


@pytest.mark.parametrize('sms', [114, 132])
@pytest.mark.parametrize('N', [4096, 22016])
def test_wgmma_tiling_fills_the_waves_above_decode_tiles(sms, N):
    """At the B=128 step's tile the same rule holds, with a dearer split
    (its partials are the whole output): o_proj's 32 tiles and gate_up's
    172 fill at least 80% of every wave, better than without a split."""
    tile, splits = TD.wgmma_tiling(128, N, 32, sms)
    tiles = -(-N // TD.WG_ROWS)

    def fill(n):
        return tiles * n / (-(-tiles * n // sms) * sms)
    assert tile == 128 and 1 < splits <= 32
    assert fill(splits) >= max(0.8, fill(1))


@pytest.mark.gpu
@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('M', [1, 8, 37, 128, 300])
@pytest.mark.parametrize('shape', [(256, 512, 128), (128, 256, 256),
                                   (256, 512, 64), (128, 128, 128),
                                   (200, 256, 128), (202, 256, 64)])
@pytest.mark.parametrize('out', [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_card(cuda_device, sym, M, shape, out):
    """The Hopper kernel vs the plain version on the same bf16 x: bf16
    output within one bf16 rounding (1e-2 of the output scale), f32
    output within f32 summation order (1e-4).  Shapes (N, K, gs): half
    groups of 128 and 64 columns, one group of K=128, and N off the
    128-row weight tile (even, and not a multiple of 4)."""
    N, K, gs = shape
    codes, scales, zeros, meta, tmeta = _case(sym, N=N, K=K, gs=gs)
    tp, ts, tz = TD.pack_weight(_t(codes), _t(scales), _t(zeros), tmeta)
    st, zst = TD.pack_scales_t(ts, tz, tmeta)
    tmeta = dataclasses.replace(tmeta, pre_t=True)
    dev = cuda_device
    x = torch.randn(M, K).to(torch.bfloat16).to(dev)
    args = (tp.to(dev), st.to(dev), zst.to(dev))
    before = TD.LAUNCHES['w4_dequant_matmul']
    got = TD.dequant_matmul(x, *args, tmeta, out_dtype=out)
    want = TD.dequant_matmul_plain(x, *args, tmeta, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert TD.LAUNCHES['w4_dequant_matmul'] == before + 1
    tol = 1e-2 if out == torch.bfloat16 else 1e-4
    assert rel_err(got.float().cpu().numpy(), want.cpu().numpy()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize('M', [1, 77])
def test_old_design_matches_plain_on_card(cuda_device, M):
    """B1's mma.sync design, kept as the ``w4_current`` probe, against the
    same plain version (bf16 out, 1e-2) and counted on its own."""
    P = importlib.import_module('llmc_tpu_torch.ops.probe_gemm')
    codes, scales, zeros, meta, tmeta = _case(False, N=256, K=512, gs=128)
    tp, ts, tz = TD.pack_weight(_t(codes), _t(scales), _t(zeros), tmeta)
    st, zst = TD.pack_scales_t(ts, tz, tmeta)
    tmeta = dataclasses.replace(tmeta, pre_t=True)
    dev = cuda_device
    x = torch.randn(M, 512).to(torch.bfloat16).to(dev)
    args = (tp.to(dev), st.to(dev), zst.to(dev))
    before = dict(TD.LAUNCHES), P.LAUNCHES['w4_mma_sync']
    got = P.w4_mma_sync(x, *args, tmeta)
    want = TD.dequant_matmul_plain(x, *args, tmeta, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (dict(TD.LAUNCHES), P.LAUNCHES['w4_mma_sync']) == \
        (before[0], before[1] + 1)
    assert rel_err(got.float().cpu().numpy(), want.cpu().numpy()) < 1e-2


def test_old_design_takes_plain_version_on_cpu():
    """On a CPU tensor the old design's wrapper is B1's plain version."""
    P = importlib.import_module('llmc_tpu_torch.ops.probe_gemm')
    codes, scales, zeros, meta, tmeta = _case(True, N=128, K=256, gs=128)
    tp, ts, tz = TD.pack_weight(_t(codes), _t(scales), _t(zeros), tmeta)
    st, zst = TD.pack_scales_t(ts, tz, tmeta)
    tmeta = dataclasses.replace(tmeta, pre_t=True)
    x = torch.randn(3, 256).to(torch.bfloat16)
    before = P.LAUNCHES['w4_mma_sync']
    got = P.w4_mma_sync(x, tp, st, zst, tmeta)
    want = TD.dequant_matmul_plain(x, tp, st, zst, tmeta,
                                   out_dtype=torch.float32)
    assert got.dtype == torch.bfloat16 and P.LAUNCHES['w4_mma_sync'] == before
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())
