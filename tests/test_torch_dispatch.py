"""The card's dispatch rule (``llmc_tpu_torch.ops.dequant_matmul.kernel_takes``
and ``ops/fp8_gemm.py::kernel_takes_block``): on a CUDA tensor the port
runs its hand kernel for every weight that a TPU kernel of the reference
takes, and more, and the reference's XLA branch in torch ops, counted in
``xla_branch_calls``, for a weight that no TPU kernel of the reference
takes.  The rule against the reference's own, written out; the cases that
go to the XLA branch against the JAX package on the CPU; and on the card
(``gpu`` marker) those cases equal to their plain versions with no kernel
launched."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu_torch.ops import (launch_counts, reset_launch_counts,
                                xla_branch_calls)
from llmc_tpu_torch.ops import fp8_gemm as G
from llmc_tpu_torch.quant import fp8_block_matmul
from torch_port_helpers import cuda_device, rel_err  # noqa: F401

JD = importlib.import_module('llmc_tpu.ops.dequant_matmul')
TD = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
torch.set_num_threads(1)

GROUPS = [16, 32, 48, 64, 96, 128, 256, 'K']
KS = [96, 128, 192, 256, 384, 512, 768, 1024, 4096, 11008]


def reference_pallas_ok(meta) -> bool:
    """The reference's rule for its W4 / W8 Pallas kernels, written out
    from ``llmc_tpu/ops/dequant_matmul.py:511-517``: the packed tile's
    minor dim (the group for paired groups, K/2 for a single group; the
    group for W8) a multiple of 128."""
    gs = meta.group_size if meta.group_size > 0 else meta.in_features
    ng = max(meta.in_features // gs, 1)
    minor = gs if ng > 1 else meta.in_features // 2
    if meta.bits == 4:
        return (ng % 2 == 0 or ng == 1) and minor % 128 == 0
    return gs % 128 == 0


def reference_runs_a_kernel(meta, a_int8) -> bool:
    """``use_pallas`` of the reference's dispatch (``:521-522``) on a TPU:
    bits=8 with per-token int8 activations has no Pallas kernel."""
    return (meta.bits in (4, 8) and reference_pallas_ok(meta)
            and not (a_int8 and meta.bits == 8))


def _valid(bits, gs, K) -> bool:
    """A weight that can be stored: groups that divide K, and for W4 an
    even group count or one group (the group-pair layout)."""
    return K % gs == 0 and (bits == 8 or (K // gs) % 2 == 0 or gs == K)


@pytest.mark.parametrize('a_int8', [False, True])
@pytest.mark.parametrize('bits', [4, 8])
@pytest.mark.parametrize('gs', GROUPS)
def test_the_card_runs_a_kernel_wherever_the_reference_does(gs, bits,
                                                            a_int8):
    """No weight that a TPU kernel of the reference takes goes to torch
    ops on the card: ``kernel_takes(meta) or not reference_pallas_ok``."""
    seen = 0
    for K in KS:
        g = K if gs == 'K' else gs
        if not _valid(bits, g, K):
            continue
        meta = TD.QMeta(bits=bits, group_size=g, symmetric=True,
                        out_features=256, in_features=K)
        assert TD.kernel_takes(meta, a_int8) or \
            not reference_runs_a_kernel(meta, a_int8), (bits, g, K, a_int8)
        seen += 1
    assert seen


@pytest.mark.parametrize('bits, gs, K, takes', [
    (4, 32, 256, False), (4, 64, 256, True), (4, 128, 4096, True),
    (4, 96, 384, False), (8, 16, 256, False), (8, 32, 256, True),
    (8, 64, 96, False), (8, 96, 288, False), (8, 128, 11008, True)])
def test_kernel_takes_the_named_weights(bits, gs, K, takes):
    """The cases ROADMAP C names: W4 at group size 32 and W8 at 16 or at a
    K that is no multiple of 64 go to the XLA branch; what the kernels
    serve stays with them."""
    meta = TD.QMeta(bits=bits, group_size=gs, symmetric=True,
                    out_features=128, in_features=K)
    assert TD.kernel_takes(meta) == takes


@pytest.mark.parametrize('bs', [32, 64, 128, 256, 'K'])
def test_fp8_kernel_takes_every_block_mosaic_lowers(bs):
    """The reference sends every ``K % bs == 0`` (with ``N % 128 == 0``)
    to its Pallas kernel (``llmc_tpu/quant/fp8_block.py:85``), whose
    ``(tm, bs)`` block (``llmc_tpu/ops/fp8_gemm.py:77``) Mosaic lowers for
    bs a multiple of 128 or the whole K.  The port's kernel takes each of
    those, and a multiple of 64 besides."""
    for K in (96, 128, 192, 256, 384, 512, 1024, 4096):
        b = K if bs == 'K' else bs
        if K % b:
            continue
        mosaic = b % 128 == 0 or b == K
        assert G.kernel_takes_block(K, b) or not mosaic, (K, b)
        assert G.kernel_takes_block(K, b) == (b % 64 == 0 or b == K)


def _w4(gs, sym=True, N=128, K=256, seed=0):
    """A packed W4 weight (JAX's pack_weight, pre_t layout): the JAX
    arguments and the port's."""
    rng = np.random.RandomState(seed)
    lo = -8 if sym else 0
    codes = rng.randint(lo, lo + 16, (N, K)).astype(np.int8)
    scales = ((0.01 + rng.rand(N, K // gs)) * 0.02).astype(np.float32)
    zeros = None if sym else rng.randint(0, 16, (N, K // gs)).astype(
        np.float32)
    meta = JD.QMeta(bits=4, group_size=gs, symmetric=sym, out_features=N,
                    in_features=K)
    jp, js, jz = JD.pack_weight(jnp.asarray(codes), jnp.asarray(scales),
                                None if zeros is None else jnp.asarray(zeros),
                                meta)
    js, jz = JD.pack_scales_t(js, jz, meta)
    meta = dataclasses.replace(meta, pre_t=True)
    port = tuple(torch.as_tensor(np.array(a)) for a in (jp, js, jz))
    return (jp, js, jz, meta), port + (
        TD.QMeta(**dataclasses.asdict(meta)),)


def _w8(gs, sym=True, N=96, K=256, seed=0):
    rng = np.random.RandomState(seed)
    codes = rng.randint(-128, 128, (N, K)).astype(np.int8)
    scales = ((0.01 + rng.rand(N, K // gs)) * 0.02).astype(np.float32)
    zeros = None if sym else rng.randint(-20, 20, (N, K // gs)).astype(
        np.float32)
    meta = JD.QMeta(bits=8, group_size=gs, symmetric=sym, out_features=N,
                    in_features=K)
    j = tuple(None if a is None else jnp.asarray(a)
              for a in (codes, scales, zeros))
    port = tuple(None if a is None else torch.as_tensor(a)
                 for a in (codes, scales, zeros))
    return j + (meta,), port + (TD.QMeta(**dataclasses.asdict(meta)),)


@pytest.mark.parametrize('a_int8', [False, True])
@pytest.mark.parametrize('sym', [True, False])
def test_w4_group_size_32_matches_jax(sym, a_int8):
    """W4 at group size 32 (half groups of 32 columns: the XLA branch in
    both packages), W4A16 and W4A8: the port's ``dequant_matmul`` on the
    CPU against the JAX package's on JAX-CPU, f32, to 1e-5 (only the f32
    summation order differs)."""
    j, p = _w4(32, sym)
    x = np.random.RandomState(1).randn(6, 256).astype(np.float32)
    assert not TD.kernel_takes(p[-1], a_int8)
    want = JD.dequant_matmul(jnp.asarray(x), *j, a_int8=a_int8)
    got = TD.dequant_matmul(torch.as_tensor(x), *p, a_int8=a_int8)
    assert got.shape == (6, 128) and rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize('N, K, gs', [(96, 256, 16), (64, 96, 32),
                                      (64, 96, 16)])
@pytest.mark.parametrize('sym', [True, False])
def test_w8_small_groups_and_k_off_64_match_jax(sym, N, K, gs):
    """W8 at group size 16, and at K=96 (no multiple of the kernel's
    64-column unit): the XLA branch in both packages, f32 to 1e-5."""
    j, p = _w8(gs, sym, N=N, K=K)
    x = np.random.RandomState(2).randn(5, K).astype(np.float32)
    assert not TD.kernel_takes(p[-1])
    want = JD.dequant_matmul(jnp.asarray(x), *j, out_dtype=jnp.float32)
    got = TD.dequant_matmul(torch.as_tensor(x), *p, out_dtype=torch.float32)
    assert got.shape == (5, N) and rel_err(got.numpy(), want) < 1e-5


def _odd_n(kind, N=201, K=256):
    j, p = (_w8(128, N=N, K=K) if kind == 'w8' else _w4(128, N=N, K=K))
    return j, p, kind == 'w4a8'


@pytest.mark.parametrize('kind', ['w4', 'w4a8', 'w8'])
def test_odd_n_plain_matches_the_reference(kind):
    """N = 201, which the reference's Pallas tiling takes as one tile
    (``llmc_tpu/ops/dequant_matmul.py:384-386``) and the card's kernels now
    take too: the port's ``dequant_matmul`` on the CPU against the JAX
    package's XLA branch (f32, 1e-5) and its Pallas kernel in interpret
    mode (1e-5, on the bf16 x it casts to; W8 with the weight rounded to
    bf16 as its kernel does)."""
    j, p, a8 = _odd_n(kind)
    assert TD.kernel_takes(p[-1], a8)
    x = (np.random.RandomState(21).randn(5, 256) * 0.1).astype(np.float32)
    want = JD.dequant_matmul(jnp.asarray(x), *j, a_int8=a8, force_xla=True,
                             out_dtype=jnp.float32)
    got = TD.dequant_matmul(torch.as_tensor(x), *p, a_int8=a8,
                            out_dtype=torch.float32)
    assert got.shape == (5, 201) and rel_err(got.numpy(), want) < 1e-5
    xb = torch.as_tensor(x).to(torch.bfloat16)
    jx = (jnp.asarray(x) if a8 else
          jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    kern = JD.dequant_matmul_pallas(jx, *j, tm=16, interpret=True,
                                    a_int8=a8, out_dtype=jnp.float32)
    if kind == 'w8':
        plain = TD.dequant_matmul_plain(xb, *p, out_dtype=torch.float32,
                                        w_bf16=True)
    elif a8:
        plain = got
    else:
        plain = TD.dequant_matmul(xb.float(), *p, out_dtype=torch.float32)
    assert rel_err(plain.numpy(), np.asarray(kern)) < 1e-5


def test_cpu_calls_leave_the_xla_branch_counter_at_zero():
    """On the CPU every call takes the plain version by the tensor's
    device; the counter counts only the card's calls that the rule sends
    to the XLA branch, and no kernel launches."""
    reset_launch_counts()
    _, p = _w4(32)
    x = torch.randn(3, 256)
    TD.dequant_matmul(x, *p)
    TD.dequant_matmul(x, *p, a_int8=True)
    _, p8 = _w8(16)
    TD.dequant_matmul(x, *p8)
    codes = torch.zeros((96, 128), dtype=torch.float8_e4m3fn)
    fp8_block_matmul(codes[:4], torch.ones(4, 4), codes, torch.ones(3, 4),
                     block_size=32)
    assert xla_branch_calls() == 0
    assert not any(launch_counts().values())


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('case', ['w4a16_gs32', 'w4a8_gs32', 'w8_gs16',
                                  'w8_k96'])
def test_xla_branch_cases_on_card(cuda_device, case):
    """W4 at group size 32 (W4A16, W4A8) and W8 at 16 or K=96 no longer
    raise on the card: finite results equal to their plain versions on the
    same tensors, one count of ``xla_branch_calls`` each and no GEMM
    kernel launched."""
    dev = cuda_device
    if case.startswith('w4'):
        _, p = _w4(32)
        K = 256
    else:
        _, p = _w8(16 if case == 'w8_gs16' else 32,
                   K=256 if case == 'w8_gs16' else 96)
        K = p[-1].in_features
    p = tuple(a if not isinstance(a, torch.Tensor) else a.to(dev) for a in p)
    a_int8 = case == 'w4a8_gs32'
    x = torch.randn(7, K, device=dev).to(torch.bfloat16)
    reset_launch_counts()
    got = TD.dequant_matmul(x, *p, a_int8=a_int8)
    plain = TD.dequant_matmul_plain_a8 if a_int8 else TD.dequant_matmul_plain
    want = plain(x, *p)
    torch.cuda.synchronize()
    assert xla_branch_calls() == 1
    assert not any(launch_counts().values())
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['w4', 'w4a8', 'w8'])
@pytest.mark.parametrize('N', [201, 4095])
@pytest.mark.parametrize('M', [1, 77, 300])
def test_odd_n_launches_the_kernels_on_card(cuda_device, kind, N, M):
    """An odd N, which the card refused before: B1, B3 and B4 launch (no
    XLA-branch call) and match their plain versions, 1e-4 at f32 output
    and 1e-2 at bf16 (one output rounding); K = 1024 splits the K loop at
    small M, so the split-K sum runs at the odd N too."""
    dev = cuda_device
    j, p, a8 = _odd_n(kind, N=N, K=1024)
    p = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in p)
    x = torch.randn(M, 1024, device=dev).to(torch.bfloat16)
    plain = TD.dequant_matmul_plain_a8 if a8 else TD.dequant_matmul_plain
    kw = {'w_bf16': True} if kind == 'w8' else {}
    want = plain(x, *p, out_dtype=torch.float32, **kw)
    name = {'w4': 'w4_dequant_matmul', 'w4a8': 'w4a8_dequant_matmul',
            'w8': 'w8_dequant_matmul'}[kind]
    for out, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        reset_launch_counts()
        got = TD.dequant_matmul(x, *p, out_dtype=out, a_int8=a8)
        torch.cuda.synchronize()
        assert launch_counts()[name] == 1 and xla_branch_calls() == 0
        assert got.shape == (M, N) and got.dtype == out
        assert rel_err(got.float().cpu().numpy(),
                       want.cpu().numpy()) < tol
