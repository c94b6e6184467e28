"""Port parity of the W4A8, W8A16 and W8A8 dequant-matmuls
(llmc_tpu_torch.ops.dequant_matmul): the activation quantizer bit-equal
to llmc_tpu, the plain versions against the reference's XLA paths and its
Pallas kernels in interpret mode, and the two Hopper kernels against their
plain versions on the card."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, rel_err  # noqa: F401

JD = importlib.import_module('llmc_tpu.ops.dequant_matmul')
TD = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _case4(sym, pre_t, N=128, K=256, gs=128, seed=0):
    """A packed 4-bit weight (by JAX's pack_weight) in either layout."""
    rng = np.random.RandomState(seed)
    lo = -8 if sym else 0
    codes = rng.randint(lo, lo + 16, (N, K)).astype(np.int8)
    scales = ((0.01 + rng.rand(N, K // gs)) * 0.02).astype(np.float32)
    zeros = None if sym else rng.randint(0, 16, (N, K // gs)).astype(
        np.float32)
    meta = JD.QMeta(bits=4, group_size=gs, symmetric=sym, out_features=N,
                    in_features=K)
    jp, js, jz = JD.pack_weight(_j(codes), _j(scales), _j(zeros), meta)
    if pre_t:
        js, jz = JD.pack_scales_t(js, jz, meta)
        meta = dataclasses.replace(meta, pre_t=True)
    return jp, js, jz, meta, TD.QMeta(**dataclasses.asdict(meta))


def _case8(sym, N=64, K=256, gs=128, seed=0):
    """Signed int8 codes with per-group scales (and zeros)."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(-128, 128, (N, K)).astype(np.int8)
    scales = ((0.01 + rng.rand(N, K // gs)) * 0.02).astype(np.float32)
    zeros = None if sym else rng.randint(-20, 20, (N, K // gs)).astype(
        np.float32)
    meta = JD.QMeta(bits=8, group_size=gs, symmetric=sym, out_features=N,
                    in_features=K)
    return codes, scales, zeros, meta, TD.QMeta(**dataclasses.asdict(meta))


def _act_rows(case):
    """Activations of the quantizer tests.  'rows256': 256 rows whose
    first element is 1 + 0.01 m, on which the true division by 127 and the
    multiply by its f32 reciprocal differ in 11 scales."""
    rng = np.random.RandomState(3)
    x = rng.randn(9, 64).astype(np.float32) * 3
    if case == 'zero_row':
        x[2] = 0
    if case == 'ties':       # x / sx lands on .5 exactly
        x = np.tile(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 63.5, 0],
                             np.float32), (4, 2))
    if case == 'rows256':
        x = (np.random.RandomState(0).rand(256, 64) * 2 - 1).astype(
            np.float32)
        x[:, 0] = 1 + 0.01 * np.arange(256)
    return x


@pytest.mark.parametrize('case', ['normal', 'zero_row', 'ties', 'bf16',
                                  'rows256'])
def test_quant_act_token_bit_equal(case):
    """Codes and scales of the per-token int8 quantizer equal the
    reference's bit for bit as its serving steps run it, under
    ``jax.jit``: f32 abs-max, max(ax, 1e-8) times the f32 reciprocal of
    127 (XLA folds the division by a constant), a true division by that
    scale, round half to even."""
    x = _act_rows(case)
    jx, tx = _j(x), _t(x)
    if case == 'bf16':
        tx = tx.to(torch.bfloat16)
        jx = _j(tx.float().numpy()).astype(jnp.bfloat16)
    jq, js = jax.jit(JD._quant_act_token)(jx)
    tq, ts = TD._quant_act_token(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_act_token_folded_scale_is_not_the_eager_one():
    """On the 256-row case the jitted reference's scale differs from the
    eager reference's (a true division) in 11 rows; ``folded=False``
    gives the eager one bit for bit, as the w8 companion's packing, which
    the reference runs eagerly, needs."""
    x = _act_rows('rows256')
    _, jit_s = jax.jit(JD._quant_act_token)(_j(x))
    eq, es = JD._quant_act_token(_j(x))
    _, ts = TD._quant_act_token(_t(x))
    assert int((ts.numpy() != np.asarray(es)).sum()) == 11
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jit_s))
    tq, ts_eager = TD._quant_act_token(_t(x), folded=False)
    np.testing.assert_array_equal(ts_eager.numpy(), np.asarray(es))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(eq))


@pytest.mark.parametrize('M', [1, 6, 8])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quant_act_token_plain_gives_the_kernel_outputs(M, dtype):
    """The quantizer kernel's plain version: xq and sx bit-equal to the
    jitted reference, the int32 sums of xq over each 64-column piece exact
    in [K/64, Mp] (Mp = M rounded up to a multiple of 4, zeros past M)."""
    x = (np.random.RandomState(M).randn(M, 256) * 2).astype(np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = jax.jit(JD._quant_act_token)(_j(tx.float().numpy()).astype(
        getattr(jnp, dtype)))
    before = dict(TD.LAUNCHES)
    xq, sx, sums = TD.quant_act_token(tx)
    assert TD.LAUNCHES == before            # a CPU tensor: no launch
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(js))
    Mp = -(-M // 4) * 4
    assert sums.dtype == torch.int32 and tuple(sums.shape) == (4, Mp)
    want = np.asarray(jq).astype(np.int64).reshape(M, 4, 64).sum(-1).T
    np.testing.assert_array_equal(sums[:, :M].numpy(), want)
    assert not sums[:, M:].any()


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('pre_t', [True, False])
def test_a8_plain_matches_xla_and_pallas_interpret(sym, pre_t):
    """dequant_matmul(a_int8=True) on the CPU against the reference's
    XLA emulation and against its W4A8 Pallas kernel in interpret mode:
    the int products are exact, only f32 summation order differs."""
    jp, js, jz, meta, tmeta = _case4(sym, pre_t)
    x = np.random.RandomState(1).randn(2, 5, 256).astype(np.float32)
    got = TD.dequant_matmul(_t(x), _t(jp), _t(js), _t(jz), tmeta,
                            a_int8=True)
    assert got.shape == (2, 5, 128) and got.dtype == torch.float32
    want = JD.dequant_matmul(_j(x), jp, js, jz, meta, force_xla=True,
                             a_int8=True)
    assert rel_err(got.numpy(), want) < 1e-5
    kern = JD.dequant_matmul_pallas(_j(x.reshape(10, 256)), jp, js, jz,
                                    meta, tm=16, tn=128, interpret=True,
                                    a_int8=True)
    np.testing.assert_allclose(got.numpy().reshape(10, 128),
                               np.asarray(kern), rtol=1e-5, atol=1e-5)
    xla = JD._dequant_matmul_xla_a8
    if not pre_t:
        want2 = xla(_j(x.reshape(10, 256)), jp, js, jz, meta)
        assert rel_err(got.numpy().reshape(10, 128), want2) < 1e-5


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('pre_t', [True, False])
def test_a8_plain_matches_xla_at_group_size_64(sym, pre_t):
    """W4A8 at group size 64, which the reference serves through XLA (its
    Pallas rule wants a minor dim of 128) and the card's kernel now takes:
    the plain version on the CPU against the reference's XLA emulation."""
    jp, js, jz, meta, tmeta = _case4(sym, pre_t, N=192, K=512, gs=64)
    x = np.random.RandomState(11).randn(7, 512).astype(np.float32)
    got = TD.dequant_matmul(_t(x), _t(jp), _t(js), _t(jz), tmeta,
                            a_int8=True)
    want = JD.dequant_matmul(_j(x), jp, js, jz, meta, force_xla=True,
                             a_int8=True)
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('gs', [64, 32])
@pytest.mark.parametrize('sym', [True, False])
def test_bits8_plain_matches_xla_at_small_groups(gs, sym):
    """W8 at group sizes 64 and 32 (the reference's XLA path; the card's
    kernel takes them now): f32 to 1e-5, and with the weight rounded to
    bf16 as the kernel does, within the bf16 rounding of each weight."""
    codes, scales, zeros, meta, tmeta = _case8(sym, N=96, K=256, gs=gs)
    x = np.random.RandomState(12).randn(5, 256).astype(np.float32)
    want = JD.dequant_matmul(_j(x), _j(codes), _j(scales), _j(zeros), meta,
                             force_xla=True, out_dtype=jnp.float32)
    args = (_t(codes), _t(scales), _t(zeros), tmeta)
    got = TD.dequant_matmul(_t(x), *args, out_dtype=torch.float32)
    assert rel_err(got.numpy(), want) < 1e-5
    b16 = TD.dequant_matmul_plain(_t(x), *args, out_dtype=torch.float32,
                                  w_bf16=True)
    assert rel_err(b16.numpy(), want) < 1e-2


@pytest.mark.parametrize('M, tile', [(1, 8), (37, 64), (128, 128),
                                     (4096, 128)])
@pytest.mark.parametrize('N, K', [(12288, 4096), (4096, 11008),
                                  (22016, 4096)])
def test_wgmma_tiling_of_b3_and_b6(M, tile, N, K):
    """B3 walks B1's K steps (two 64-column units of each half group a
    step at group size 128, one at 64) and B6 one 128-column scale block a
    step: the token tile follows M, splits deal the steps out evenly and
    only below four waves of tiles."""
    for steps in (TD.w4_steps(K, 128), TD.w4_steps(K, 64), K // 128):
        tt, splits = TD.wgmma_tiling(M, N, steps, 132)
        assert tt == tile and 1 <= splits <= min(steps, 16)
        per = -(-steps // splits)
        assert -(-steps // per) == splits
        if -(-N // 128) * -(-M // tt) >= 4 * 132:
            assert splits == 1
    assert TD.w4_steps(4096, 64) == 2 * TD.w4_steps(4096, 128) == 32


@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('out', ['same', 'f32'])
def test_bits8_plain_matches_xla(sym, out):
    """bits=8 per group, f32: the reference's XLA path to 1e-5."""
    codes, scales, zeros, meta, tmeta = _case8(sym)
    x = np.random.RandomState(2).randn(3, 4, 256).astype(np.float32)
    want = JD.dequant_matmul(_j(x), _j(codes), _j(scales), _j(zeros), meta,
                             force_xla=True,
                             out_dtype=jnp.float32 if out == 'f32' else None)
    got = TD.dequant_matmul(_t(x), _t(codes), _t(scales), _t(zeros), tmeta,
                            out_dtype=torch.float32 if out == 'f32'
                            else None)
    assert got.shape == (3, 4, 64)
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('sym', [True, False])
def test_bits8_bf16_weight_plain_matches_pallas_interpret(sym):
    """The W8 kernel's function rounds each dequantized weight to bf16.
    The plain version with ``w_bf16`` does the same, so against the
    reference's kernel (interpret mode, f32 output) only the f32
    summation order differs: 1e-5.  Without the rounding the two differ
    by one bf16 rounding of each weight, 2^-9 relative each, which over
    K = 256 random terms stays under 2e-3 of the output scale."""
    codes, scales, zeros, meta, tmeta = _case8(sym, N=128)
    x = (np.random.RandomState(5).randn(8, 256) * 0.1).astype(np.float32)
    xb = _t(x).to(torch.bfloat16)
    want = JD.dequant_matmul_pallas(
        _j(xb.float().numpy()).astype(jnp.bfloat16), _j(codes), _j(scales),
        _j(zeros), meta, tm=16, tn=128, interpret=True,
        out_dtype=jnp.float32)
    args = (_t(codes), _t(scales), _t(zeros), tmeta)
    got = TD.dequant_matmul_plain(xb, *args, out_dtype=torch.float32,
                                  w_bf16=True)
    assert rel_err(got.numpy(), want) < 1e-5
    f32 = TD.dequant_matmul_plain(xb, *args, out_dtype=torch.float32)
    assert 0 < rel_err(f32.numpy(), want) < 2e-3


@pytest.mark.parametrize('M', [1, 16, 17, 40])
def test_w8a8_channel_dot(M):
    """The per-channel W8A8 dot: the int32 part is exact (rows of 16 and
    fewer included), and the scaled result is within 1e-5 of the
    reference, which on the CPU emulates it with an f32 dot."""
    rng = np.random.RandomState(M)
    N, K = 48, 256
    w8 = rng.randint(-127, 128, (N, K)).astype(np.int8)
    s8 = ((0.5 + rng.rand(N)) * 0.01).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    xq, _ = TD._quant_act_token(_t(x))
    np.testing.assert_array_equal(
        TD._int8_dot(xq, _t(w8)).numpy(),
        xq.numpy().astype(np.int64) @ w8.T.astype(np.int64))
    meta = JD.QMeta(bits=8, group_size=K, symmetric=True, out_features=N,
                    in_features=K)
    tmeta = TD.QMeta(**dataclasses.asdict(meta))
    got = TD.dequant_matmul(_t(x), _t(w8), _t(s8), None, tmeta, a_int8=True)
    want = JD.dequant_matmul(_j(x), _j(w8), _j(s8), None, meta, a_int8=True)
    assert rel_err(got.numpy(), want) < 1e-5
    asym = dataclasses.replace(tmeta, symmetric=False)
    with pytest.raises(ValueError, match='symmetric'):
        TD.dequant_matmul(_t(x), _t(w8), _t(s8), torch.zeros(N, 1), asym,
                          a_int8=True)


def test_bits8_per_group_a8_takes_the_emulation():
    """bits=8 + a_int8 + per group has no kernel in the reference: both
    packages run the f32 emulation."""
    codes, scales, zeros, meta, tmeta = _case8(False)
    x = np.random.RandomState(7).randn(6, 256).astype(np.float32)
    want = JD.dequant_matmul(_j(x), _j(codes), _j(scales), _j(zeros), meta,
                             a_int8=True)
    got = TD.dequant_matmul(_t(x), _t(codes), _t(scales), _t(zeros), tmeta,
                            a_int8=True)
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('pre_t', [True, False])
def test_staged_a8_matches_jax(pre_t, monkeypatch):
    """The staged W4A8 path (w4 -> per-channel int8, one int8 dot), and
    its dispatch once A8_STAGE_MIN_M is reached."""
    jp, js, jz, meta, tmeta = _case4(False, False)
    x = np.random.RandomState(8).randn(12, 256).astype(np.float32)
    ts, tz = _t(js), _t(jz)
    if pre_t:   # the reference's dispatch un-folds [ng, N] (s, zs) first
        jst, jzst = JD.pack_scales_t(js, jz, meta)
        js, jz = jst.T, jzst.T / jnp.clip(jst.T, 1e-9, None)
        ts, tz = TD.pack_scales_t(ts, tz, tmeta)
        tmeta = dataclasses.replace(tmeta, pre_t=True)
    # the reference stages inside its jitted serving step
    want = jax.jit(lambda *a: JD._dequant_matmul_a8_staged(*a, meta))(
        _j(x), jp, js, jz)
    got = TD._dequant_matmul_a8_staged(_t(x), _t(jp), ts, tz, tmeta)
    assert rel_err(got.numpy(), want) < 1e-5
    assert TD.A8_STAGE_MIN_M == 2 ** 62            # off by default
    monkeypatch.setattr(TD, 'A8_STAGE_MIN_M', 8)
    via = TD.dequant_matmul(_t(x), _t(jp), ts, tz, tmeta, a_int8=True)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_cpu_tensors_take_plain_versions_without_launch():
    jp, js, jz, meta, tmeta = _case4(True, True)
    codes, scales, zeros, _, tmeta8 = _case8(True)
    before = dict(TD.LAUNCHES)
    x = torch.randn(2, 256)
    TD.dequant_matmul(x, _t(jp), _t(js), _t(jz), tmeta, a_int8=True)
    TD.dequant_matmul(x, _t(codes), _t(scales), None, tmeta8)
    xq, sx, sums = TD.quant_act_token(x)
    assert TD.LAUNCHES == before
    with pytest.raises(ValueError, match='CUDA'):
        TD.w4a8_dequant_matmul(xq, sx, sums, _t(jp), _t(js), _t(jz), tmeta,
                               torch.float32)
    with pytest.raises(ValueError, match='CUDA'):
        TD.w8_dequant_matmul(x.to(torch.bfloat16), _t(codes), _t(scales),
                             None, tmeta8, torch.bfloat16)


@pytest.mark.parametrize('gs, K, ok', [(128, 512, True), (256, 256, True),
                                       (64, 256, True), (96, 192, True),
                                       (32, 128, True), (48, 192, False),
                                       (96, 256, False), (32, 96, False)])
def test_w8_groups_off_the_kernel_go_to_the_xla_branch(gs, K, ok):
    """The W8 kernel takes every scale group of a multiple of 32 columns
    that divides K (K a multiple of its 64-column unit), where the
    reference's Pallas rule takes multiples of 128 and sends the rest to
    XLA: its wrapper raises on a group of 48 columns, one that does not
    divide K, and K=96, and ``kernel_takes`` sends those to the XLA branch
    on the card."""
    meta = TD.QMeta(bits=8, group_size=gs, symmetric=True, out_features=64,
                    in_features=K)
    assert TD.kernel_takes(meta) == ok and not TD.kernel_takes(meta, True)
    if ok:
        assert TD._check_w8_meta(meta, 4, K) == gs
    else:
        with pytest.raises(NotImplementedError, match='B4'):
            TD._check_w8_meta(meta, 4, K)
    with pytest.raises(ValueError, match='bits=8'):
        TD._check_w8_meta(dataclasses.replace(meta, bits=4), 4, K)


def test_w8_tiling_deals_out_chunks():
    """Decode-sized W8 grids split K in 128-column chunks until they fill
    the card; every split gets at least one chunk."""
    bm, splits = TD._tiling(1, 4096, 4096 // 128, 132)
    assert bm == 16 and 1 < splits <= 32 and 32 % splits == 0
    assert TD._tiling(4096, 22016, 32, 132) == (64, 1)
    bm, splits = TD._tiling(8, 4096, 86, 132)      # down_proj: 11008 / 128
    assert -(-86 // -(-86 // splits)) == splits


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _oracle_a8(xq, sx, packed, s_t, zs_t, tmeta):
    """Integer oracle in float64: sx * sum_g s_g * sum_k xq * (u - z_eff)."""
    s, z, m = TD._unfold_pre_t(s_t.double(), zs_t.double(), tmeta)
    w = TD.dequant_weight(packed, s, z, m)      # float64 by promotion
    return (xq.double() @ w.double().T) * sx.double()


@pytest.mark.gpu
@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('M', [1, 8, 37, 128, 300])
@pytest.mark.parametrize('shape', [(256, 512, 128), (128, 256, 256),
                                   (256, 512, 64), (128, 128, 128),
                                   (200, 256, 128), (202, 256, 64)])
@pytest.mark.parametrize('out', [torch.bfloat16, torch.float32])
def test_w4a8_kernel_matches_plain_and_oracle_on_card(cuda_device, sym, M,
                                                      shape, out):
    """The W4A8 path (the quantizer kernel, then the GEMM) against the
    plain version within 1e-4 (f32 out; 1e-2 at bf16, one output
    rounding), and at f32 against the float64 integer oracle within 1e-6
    (the int32 sums are exact; only the order of the f32 group terms
    differs).  Shapes (N, K, gs): half groups of 128 and 64 columns, one
    group of K=128, and N off the 128-row weight tile."""
    N, K, gs = shape
    jp, js, jz, meta, tmeta = _case4(sym, True, N=N, K=K, gs=gs)
    dev = cuda_device
    x = torch.randn(M, K).to(torch.bfloat16).to(dev)
    args = (_t(jp).to(dev), _t(js).to(dev), _t(jz).to(dev))
    before = dict(TD.LAUNCHES)
    got = TD.dequant_matmul(x, *args, tmeta, out_dtype=out, a_int8=True)
    want = TD.dequant_matmul_plain_a8(x, *args, tmeta,
                                      out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert TD.LAUNCHES == dict(
        before, w4a8_dequant_matmul=before['w4a8_dequant_matmul'] + 1,
        quant_act_token=before['quant_act_token'] + 1)
    assert got.dtype == out
    tol = 1e-2 if out == torch.bfloat16 else 1e-4
    assert rel_err(got.float().cpu().numpy(), want.cpu().numpy()) < tol
    if out == torch.float32:
        xq, sx = TD._quant_act_token(x)
        oracle = _oracle_a8(xq, sx, *args, tmeta)
        assert rel_err(got.cpu().numpy(), oracle.cpu().numpy()) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize('sym', [True, False])
@pytest.mark.parametrize('M', [1, 8, 37, 128, 300])
@pytest.mark.parametrize('shape', [(256, 512, 128), (128, 256, 256),
                                   (200, 256, 128), (202, 384, 128),
                                   (256, 512, 64), (200, 256, 32),
                                   (202, 384, 96)])
@pytest.mark.parametrize('out', [torch.bfloat16, torch.float32])
def test_w8_kernel_matches_bf16_weight_plain_on_card(cuda_device, sym, M,
                                                     shape, out):
    """The W8 kernel against the plain version that rounds the weight to
    bf16 the same way: 1e-4 at f32 output (summation order), 1e-2 at bf16
    (one output rounding).  Shapes (N, K, gs) include N off the 128-row
    weight tile (even, and not a multiple of 4), and groups of 64, 32 and
    96 columns (the last two put two groups in a 64-column unit)."""
    N, K, gs = shape
    codes, scales, zeros, meta, tmeta = _case8(sym, N=N, K=K, gs=gs)
    dev = cuda_device
    x = torch.randn(M, K).to(torch.bfloat16).to(dev)
    args = (_t(codes).to(dev), _t(scales).to(dev),
            None if zeros is None else _t(zeros).to(dev))
    before = TD.LAUNCHES['w8_dequant_matmul']
    got = TD.dequant_matmul(x, *args, tmeta, out_dtype=out)
    want = TD.dequant_matmul_plain(x, *args, tmeta, out_dtype=torch.float32,
                                   w_bf16=True)
    torch.cuda.synchronize()
    assert TD.LAUNCHES['w8_dequant_matmul'] == before + 1
    assert got.dtype == out
    tol = 1e-2 if out == torch.bfloat16 else 1e-4
    assert rel_err(got.float().cpu().numpy(), want.cpu().numpy()) < tol


@pytest.mark.gpu
def test_card_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """Wrong dtype, non-contiguous operands and a group of 48 columns
    raise at the kernels' wrappers instead of launching or falling back
    (``dequant_matmul`` sends the group of 48 to the XLA branch, by the
    weight's metadata); W4A8 at group size 64 and W8 at 64, which raised
    before the kernels took them, launch and match their plain versions;
    the per-channel W8A8 dot runs at 16 rows and fewer."""
    dev = cuda_device
    jp, js, jz, meta, tmeta = _case4(True, True, N=128, K=256, gs=128)
    packed, s_t, zs_t = _t(jp).to(dev), _t(js).to(dev), _t(jz).to(dev)
    x = torch.randn(4, 256, device=dev)
    xq, sx, sums = TD.quant_act_token(x)
    before = dict(TD.LAUNCHES)
    with pytest.raises(ValueError, match='xq'):
        TD.w4a8_dequant_matmul(xq.to(torch.int16), sx, sums, packed, s_t,
                               zs_t, tmeta, torch.float32)
    with pytest.raises(ValueError, match='contiguous'):
        TD.w4a8_dequant_matmul(xq, sx, sums, packed, s_t.T.contiguous().T,
                               zs_t, tmeta, torch.float32)
    codes, scales, zeros, _, tmeta8 = _case8(True, N=128, K=256, gs=128)
    c8, s8 = _t(codes).to(dev), _t(scales).to(dev)
    with pytest.raises(ValueError, match='x:'):
        TD.w8_dequant_matmul(x, c8, s8, None, tmeta8, torch.bfloat16)
    with pytest.raises(ValueError, match='contiguous'):
        TD.w8_dequant_matmul(x.to(torch.bfloat16), c8.T.contiguous().T,
                             s8, None, tmeta8, torch.bfloat16)
    with pytest.raises(ValueError, match='^s:'):    # the [ng, N] layout
        TD.w8_dequant_matmul(x.to(torch.bfloat16), c8, s8.T.contiguous(),
                             None, tmeta8, torch.bfloat16)
    m8_48 = dataclasses.replace(tmeta8, group_size=48, in_features=192)
    with pytest.raises(NotImplementedError, match='B4'):
        TD.w8_dequant_matmul(x[:, :192].to(torch.bfloat16),
                             c8[:, :192].contiguous(),
                             torch.ones(128, 4, device=dev), None, m8_48,
                             torch.bfloat16)
    m2 = dataclasses.replace(tmeta8, bits=2)
    with pytest.raises(NotImplementedError, match='bits=2'):
        TD.dequant_matmul(x, c8, s8, None, m2)
    assert TD.LAUNCHES == before
    # the cases the card refused before: W4A8 and W8 at group size 64
    jp, js, jz, _, m64 = _case4(False, True, N=128, K=256, gs=64)
    a64 = (_t(jp).to(dev), _t(js).to(dev), _t(jz).to(dev))
    got = TD.dequant_matmul(x, *a64, m64, a_int8=True)
    want = TD.dequant_matmul_plain_a8(x, *a64, m64)
    codes, scales, _, _, m8_64 = _case8(True, N=128, K=256, gs=64)
    w64 = (_t(codes).to(dev), _t(scales).to(dev), None)
    got8 = TD.dequant_matmul(x, *w64, m8_64, out_dtype=torch.float32)
    want8 = TD.dequant_matmul_plain(x, *w64, m8_64, out_dtype=torch.float32,
                                    w_bf16=True)
    torch.cuda.synchronize()
    assert rel_err(got.cpu().numpy(), want.cpu().numpy()) < 1e-4
    assert rel_err(got8.cpu().numpy(), want8.cpu().numpy()) < 1e-4
    assert TD.LAUNCHES['w4a8_dequant_matmul'] == \
        before['w4a8_dequant_matmul'] + 1
    assert TD.LAUNCHES['w8_dequant_matmul'] == before['w8_dequant_matmul'] + 1
    # the W8A8 dot pads 4 rows up for torch._int_mm and stays exact
    w8 = torch.randint(-127, 128, (64, 256), dtype=torch.int8, device=dev)
    got = TD._int8_dot(xq, w8)
    want = xq.cpu().to(torch.int32) @ w8.cpu().to(torch.int32).T
    assert got.shape == (4, 64) and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize('M', [1, 5, 77, 300])
@pytest.mark.parametrize('K', [256, 4096, 11008, 53248])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_quant_act_token_kernel_bit_equal_on_card(cuda_device, M, K, dtype):
    """The quantizer kernel's xq and sx equal ``_quant_act_token``'s on the
    same x on the card bit for bit, its piece sums are exact (zeros past
    M), it counts one launch, at K up to Llama-3-405B's down projection
    (53248: a row too wide to hold in registers, read twice); and the
    plain version's sx and xq on the card equal its own on the CPU (the
    folded scale is the same multiply on both devices)."""
    x = torch.as_tensor(np.random.RandomState(M + K).rand(M, K) * 2 - 1,
                        dtype=torch.float32)
    x[:, 0] = 1 + 0.01 * torch.arange(M)
    x = x.to(dtype)
    xd = x.to(cuda_device)
    before = TD.LAUNCHES['quant_act_token']
    xq, sx, sums = TD.quant_act_token(xd)
    pq, psx = TD._quant_act_token(xd)
    cq, csx = TD._quant_act_token(x)
    torch.cuda.synchronize()
    assert TD.LAUNCHES['quant_act_token'] == before + 1
    assert torch.equal(xq, pq) and torch.equal(sx, psx)
    assert torch.equal(psx.cpu(), csx) and torch.equal(pq.cpu(), cq)
    want = cq.to(torch.int32).reshape(M, K // 64, 64).sum(-1).T
    assert torch.equal(sums[:, :M].cpu(), want)
    assert not sums[:, M:].any()
