"""Drive the PyTorch / H100 port (``llmc_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line, all of them on every run:

1. ``device``     the card's name, count, SM count, and nvidia-smi's name
                  and power limit (also printed raw on a line of its own).
2. ``build``      nvcc build of ``llmc_tpu_torch/csrc`` (seconds,
                  registers and spills per kernel); it fails on a spill in
                  the wgmma kernels (B1, B3, B4, B6).
3. ``kernel_checks``  each of the seven kernels of the main paths against
                  its plain PyTorch version on the card at the main paths'
                  shapes and M = 1, 64, 77, 128, 4096 (the W4A8 kernel also
                  against a float64 integer oracle, the FP8-block kernel
                  against a float64 oracle, also on a block built to
                  expose a short adder, and at an N off the 128-row
                  block; the W4A8 activation quantizer bit for bit), with
                  times (CUDA events) beside the bound and a library
                  yardstick that the port never calls for that function.
                  ``kernel_ms`` is the kernel's wrapper on
                  prepared operands, ``path_ms`` the ``dequant_matmul``
                  call one linear of the main path makes (for W4A8 with
                  the activation quantizer's launch); every GEMM with its
                  host microseconds a launch and, up to M=128, its device
                  time through a CUDA graph.  B1 and B3 also at half
                  groups of 64 columns, B4 at groups of 64 and 32; B1
                  timed beside its old mma.sync design on the same
                  operands.  B1, B3 and B4 also at an odd N (4095).
                  Also the staged W4A8 prefill beside the kernel at
                  M=4096, and a sweep of the serving-batch kernel's slots
                  a CTA through CUDA graphs.  Both decode-attention
                  kernels (split over the cache at small batch) at
                  ``FLASH_SHAPES``: the bench's decode shape, B=8 at
                  Smax=1024, and Llama-2-7B's full context of 4096 at
                  B = 1 and 8 and Llama-3-8B's 8 kv heads at B = 8, int8
                  and bf16 caches, each launch repeated to the same bits,
                  a reading under 0.06 ms also through a CUDA graph; and
                  each on an f32 cache and at 16 query heads a kv head
                  (Llama-3.1-405B).  The FP8-block kernel also at block
                  sizes 64, 256 and the whole K, also at K = 1000 (rows
                  no whole 16 bytes).
4. ``probes``     the w4 design probes (``ops/probe_gemm.py``, nine kernels
                  of ``csrc/probe_gemm.cu`` and B1's old design
                  ``w4_current``) through their entry points
                  ``llmc_tpu_torch.tools.kernel_bench.run`` and
                  ``.w4_probe.run`` at the JAX tools' gate_up shape (K=4096,
                  N=22016) and M = 64, 77, 128 and 4096: every kernel held
                  against its plain version (bf16 within 1e-2 of the
                  largest output, the int8 dot's int32 equal), timed beside
                  its bound, the plain version and the library call, and
                  its launches equal to the calls the tools made.
5. ``parity``     2 layers at Llama-2-7B width: the card (bf16, kernels)
                  against the CPU (f32, plain versions) on the same
                  random packed weights, once per serving configuration:
                  W4A16 + flash, W4A8 + batch attention, W8A16 + flash;
                  each with a control run of the card through the plain
                  linears.  ``--parity-seeds 0 1 2`` repeats it on more
                  random models; nothing else takes an option.
6. ``serve``      ``ServingEngine`` on Llama-2-7B (32 layers) with random
                  packed W4 g128 weights and an int8 KV cache; the kernel
                  launch counters must equal what the path implies.
7. ``throughput`` the reference bench's shape: B=128, prefill 32, 64
                  greedy decode steps after one warm-up prefill and step
                  (a record, not a claim).
8. ``profile``    torch.profiler over 8 decode steps at that shape: device
                  time by kernel, attention's share and the device's idle
                  share; for W4A16 also at B=8 after a prefill of 1024
                  tokens (``LONG_PROFILE``), where a step is mostly
                  attention.
9. ``serve_w4a8`` + its ``throughput`` and ``profile``: the same engine
                  and bench shape with per-token int8 activations (every
                  block linear through the quantizer and the W4A8 kernel,
                  the head weight-only) and the serving-batch attention
                  kernel (``ATTN_IMPL='batch'``).
10. ``serve_w8`` + its ``throughput`` and ``profile``: the same on W8A16
                  per-group 128 weights (every linear through the W8
                  kernel).
11. ``serve_w8_companion``  8 layers at 7B width, a random fp model packed
                  with ``pack_model(w8_prefill=True)``: the engine once
                  with ``prefill_w8`` and once with ``decode_w8``.
12. ``fp8_linear`` one Llama-2-7B block's seven linears stored as an
                  FP8-block checkpoint stores them (e4m3 codes and one
                  inverse scale per 128 x 128 block), applied to 128 rows:
                  ``act_quant_per_group`` -> ``fp8_block_matmul``, seven
                  launches of the FP8-block kernel.
13. ``compress``  ``run_pipeline`` at Llama-2-7B width and depth (bf16,
                  random weights from a seed, synthetic calibration and
                  PPL data, W4 symmetric per-group 128): once RTN, once
                  AWQ (scale search + clip v1) on weights that came
                  through the FP8-block ingest and whose norms give the
                  activations outlier channels.  PPLs finite,
                  ``ppl_transformed`` near ``ppl_pretrain``, the searched
                  blocks' fake-quant output error at most RTN's on the
                  calibration inputs, seconds per pipeline phase.  The
                  calibration set is cut to 8 x 512 tokens; one more AWQ
                  run of a single block reads the seconds at 128 x 512,
                  the size of ``configs/quantization/methods/
                  awq_w_only.yml``.  The pipeline launches no kernel.
14. ``compress_serve``  what AWQ made, packed (``pack_model``, fused,
                  packed head) and served by ``ServingEngine`` with an
                  int8 KV cache; its logits on one prompt against the
                  same model under the fake-quant ``QMap``.

Every phase that drives the model or the probe tools on the card sets the
kernels' launch counters to 0 just before its run, reads them just after,
and fails unless they equal what its path implies and no call ran the
reference's XLA branch in torch ops (``xla_branch_calls`` 0: every weight
of every path goes to a kernel).  The flash-decode kernel combines its
splits inside its one launch: no combine launch to count.  Then the
``wgmma_kernels`` line (B1's, B3's, B4's and B6's registers, spills, host
microseconds a launch and graph times, B1's old design), the
``{"kernels": [...]}`` line (seventeen kernels: each of the main paths'
launches from the serve phase of its own path, the FP8-block kernel's from
``fp8_linear``, each probe's from the ``probes`` phase), the
nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero.
There is no CPU mode: without a CUDA card the script exits 2.  The phase
functions take a device and sizes, so the tests run the phases that
need no kernel at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import itertools
import json
import sys
import time

import numpy as np
import torch

from llmc_tpu_torch.utils.device import (PEAKS,  # noqa: F401 (re-exported)
                                         nvidia_smi_line, peaks_for)
from llmc_tpu_torch.utils.profiler import cuda_ms

F32 = torch.float32
BF16 = torch.bfloat16

# Llama-2-7B (the reference bench's configuration)
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, head_dim=128, dtype='bfloat16')

# Tolerances, with their reasons.
# w4 kernel vs plain (same bf16 x and packed weights, f32 plain math):
#   bf16 output — one bf16 rounding of each output (2^-8 relative) plus
#   f32 summation order: max |err| <= 1e-2 * max |ref|;
#   f32 output (head) — f32 summation order over K and the cancellation
#   between y+ and the excess-8 correction: max |err| <= 1e-4 * max |ref|.
TOL_W4_BF16 = 1e-2
TOL_W4_F32 = 1e-4
# W4A8 kernel vs plain on the same int8 codes: as the w4 kernel.  Against
# the float64 integer oracle at f32 output the int32 sums are exact and
# only the order of the <= 86 f32 group terms differs.
TOL_A8_ORACLE = 1e-6
# W8 kernel vs the plain version that rounds the weight to bf16 the same
# way: as the w4 kernel.
# flash and batch kernels vs plain (all f32): exp and summation order only.
TOL_FLASH = 2e-4
# on a cache made by the port's KV quantizer: f32 rounding, which f16
# halves that let p times its V scale fall below f16's normal range miss
# (by about 1e-4 on ATTN_KVQ's row)
TOL_ATTN_KVQ = 2e-5
# FP8-block kernel at f32 output vs the float64 oracle on the same codes
# and scales (and vs the plain f32 version): every e4m3 product is exact
# in f32, so what is left is the order of the f32 sums inside a 128-wide
# block and over at most 86 scaled block terms.  At bf16 output one more
# bf16 rounding: TOL_W4_BF16.
TOL_FP8_ORACLE = 1e-5
# One FP8-block linear (bf16 activations through act_quant_per_group and
# the kernel) vs x @ weight_cast_to_bf16(codes, scale_inv)^T in f32: the
# activation's e4m3 rounding, at most 2^-4 relative an element with random
# sign, leaves about 2.5% of an output's RMS, 4 to 5 sigma of it over all
# outputs against a largest output of as many sigma: 5e-2 of the largest
# output (the reference's own test allows 0.1).
TOL_FP8_LINEAR = 5e-2
# ``compress``: the transformed model's PPL against the pretrained one's.
# RTN transforms nothing (equal).  AWQ's scale transform is an equivalence
# up to the working type's rounding of the rescaled weights, and clip v1
# clamps group outliers in place, which a 4-bit grid search found cheaper
# than keeping them; both move the PPL of a model with random weights
# (close to the vocabulary size whatever the weights) by far less than
# 2e-2 relative.
TOL_PPL_TRANSFORMED = 2e-2
# ``compress`` with a search (AWQ scales, clip v1): the PPLs of random
# weights cannot tell a right search from a wrong one, so the searched
# blocks are held against RTN where it shows.  On a block's own calibration
# inputs, the squared error of its fake-quantized output against the
# unquantized block's is at most RTN's: both grids hold the point that
# changes nothing (ratio 0, no shrink), so every subset's own objective can
# only fall, and clipping a 4-bit group of Gaussian weights takes 10 to 20%
# off it.  A search that picks wrong scales, applies them on one side only
# or shrinks too far raises the error above RTN's.
TOL_SEARCH_VS_RTN = 1.0
# ``compress_serve``: logits of the packed model through the kernels
# against the same model under the fake-quant QMap, both on the card in
# bf16, relative to the largest logit.  The two differ by the bf16
# rounding of the fake-quantized weight (the kernel multiplies the exact
# codes and applies the f32 scales afterwards), the order of the f32 sums
# and the bf16 roundings they flip, through every layer of the run.
# Measured on an H100 at 32 layers of Llama-2-7B width: 1.9e-2.
TOL_COMPRESS_SERVE = 3e-2
# card (bf16 activations, int8 KV) vs CPU (f32) over 2 layers at 7B width,
# relative to the largest logit: bf16 rounding at every cast and int8 KV
# codes that flip between the two.  Measured on an H100 with seeds 0-2
# (phase_parity(seed=...)): W4A16 4.2e-3, 1.3e-3, 3.7e-3.  W4A8 quantizes
# every block linear's input per token to int8 in both runs, from a bf16 row
# on the card and an f32 row on the CPU, so a code near a rounding tie
# differs by one step: 1.4e-2, 1.3e-3, 1.2e-3, inside the W4A16 tolerance.
# The random W8 model's codes are centred (the W4 model's excess-8 nibbles
# have mean -0.5, which puts a common component into every logit and
# flatters a ratio to the largest one), and its logits are 2.5x smaller:
# 5.0e-2, 6.0e-2, 4.8e-2, and as much (4.6e-2 to 4.9e-2) when the card runs
# the plain f32-weight linears on the same bf16 activations, so the error
# is the working type's on that model and not the kernel's or its bf16
# weight rounding; its tolerance is 1e-1.  What the kernels add is held by
# two more limits.  The run with kernels may err at most PARITY_VS_CONTROL
# times what the card's control run with plain linears errs (readings:
# 1.00 to 1.26 times).  And it is compared directly with the control that
# computes the kernels' own function on the card (the plain linears; for
# W8 with the weight rounded to bf16), which takes the CPU's f32 working
# type out of the comparison: what is left is the order of the f32 sums,
# the bf16 roundings and int8 codes (KV, W4A8 activations) that it flips,
# and what two layers make of them.  Measured over seeds 0-2
# (``--parity-seeds 0 1 2``): W4A16 7.9e-4 to 1.3e-3, W4A8 5.1e-4 to
# 1.2e-3, W8A16 1.2e-2 to 1.4e-2 (that model turns any rounding into more
# than the W4 models do, as its error against the CPU shows);
# TOL_VS_CONTROL is a little over twice the worst reading.
TOL_PARITY = {'w4a16': 5e-2, 'w4a8': 5e-2, 'w8a16': 1e-1}
PARITY_VS_CONTROL = 1.3
TOL_VS_CONTROL = {'w4a16': 3e-3, 'w4a8': 3e-3, 'w8a16': 3e-2}
MIN_GREEDY_AGREE = 0.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def tree_to(tree, device, float_dtype=None):
    if isinstance(tree, dict):
        return {k: tree_to(v, device, float_dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, float_dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        if float_dtype is not None and tree.dtype in (BF16, torch.float16):
            tree = tree.to(float_dtype)
        return tree.to(device)
    return tree


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def _w4_case(N, K, M, sym, gen, dev, gs=128):
    from llmc_tpu_torch.ops.dequant_matmul import QMeta
    ng = K // gs
    meta = QMeta(bits=4, group_size=gs, symmetric=sym, out_features=N,
                 in_features=K, pre_t=True)
    packed = torch.randint(0, 256, (N, K // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    s = torch.rand((ng, N), generator=gen, device=dev) * 0.01 + 0.002
    z = (torch.full_like(s, 8.0) if sym else
         torch.randint(0, 16, (ng, N), generator=gen, device=dev).to(F32))
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    return x, packed, s.contiguous(), (s * z).contiguous(), meta


def _w8_case(N, K, M, sym, gen, dev, gs=128):
    """Signed int8 codes, legacy [N, ng] scales (and zeros when asym)."""
    from llmc_tpu_torch.ops.dequant_matmul import QMeta
    ng = K // gs
    meta = QMeta(bits=8, group_size=gs, symmetric=sym, out_features=N,
                 in_features=K)
    codes = torch.randint(-128, 128, (N, K), generator=gen, device=dev,
                          dtype=torch.int8)
    s = torch.rand((N, ng), generator=gen, device=dev) * 0.001 + 0.0002
    z = None if sym else torch.randint(-16, 16, (N, ng), generator=gen,
                                       device=dev).to(F32)
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    return x, codes, s.contiguous(), z, meta


def gemm_bound(kind, M, N, K, out_bytes, peaks, gs=128, has_z=True):
    """Least time of one dequant-matmul: every input read once (x, the
    weight, the f32 scale and zero term per group and column, the
    per-token scale of W4A8), the output written once, against 2*M*N*K
    operations at the peak of the type the tensor cores multiply in.  The
    W4 kernels always read s and zs; the W8 kernel reads zeros only when
    the weight has them (``has_z``)."""
    ng = K // gs
    x_b, w_b, peak = {'w4': (2 * M * K, N * K // 2, peaks.bf16),
                      'w4a8': (M * K + 4 * M, N * K // 2, peaks.int8),
                      'w8': (2 * M * K, N * K, peaks.bf16)}[kind]
    n_scale = 2 if has_z or kind != 'w8' else 1
    nbytes = x_b + w_b + n_scale * ng * N * 4 + M * N * out_bytes
    t_b, t_o = nbytes / peaks.bw * 1e3, 2 * M * N * K / peak * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _gemm_ops(kind):
    """(case, kernel, plain, library, tiling, path) of one dequant-matmul
    kernel.  ``kernel(case, weight, out_dtype)`` calls the kernel's wrapper
    on ``weight`` in place of the case's own (same shape), ``plain(case)``
    is its plain version in f32, ``library(case)`` returns the yardstick
    call, and ``path(case, weight, out_dtype)`` is what one linear of the
    main path calls: ``dequant_matmul``, with whatever it runs before the
    launch (for W4A8 the activation quantizer)."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    from llmc_tpu_torch.utils.device import sm_count

    def sms(case):
        return sm_count(case[0].device.index)

    def path(case, weight, out_dtype):
        x, _, s, z, meta = case
        return D.dequant_matmul(x, weight, s, z, meta, out_dtype,
                                a_int8=kind == 'w4a8')

    if kind == 'w8':
        def kernel(case, weight, out_dtype):
            x, _, s, z, meta = case
            return D.w8_dequant_matmul(x, weight, s, z, meta, out_dtype)

        def plain(case):
            x, codes, s, z, meta = case
            return D.dequant_matmul_plain(x, codes, s, z, meta,
                                          out_dtype=F32, w_bf16=True)

        def library(case):
            x, codes, s, z, meta = case
            w = D.dequant_weight(codes, s, z, meta).to(BF16)
            return lambda: torch.matmul(x, w.T)

        def tiling(case):
            x, _, _, _, meta = case
            tt, splits = D.wgmma_tiling(x.shape[0], meta.out_features,
                                        x.shape[1] // D.WG_UNIT, sms(case))
            return dict(tok_tile=tt, splits=splits)
        return _w8_case, kernel, plain, library, tiling, path

    def tiling(case):       # w4 and w4a8: the same K steps
        x, _, _, _, meta = case
        tt, splits = D.wgmma_tiling(x.shape[0], meta.out_features,
                                    D.w4_steps(x.shape[1],
                                               D._half_group(meta)[0]),
                                    sms(case))
        return dict(tok_tile=tt, splits=splits)

    def dense_weight(case):
        _, packed, s, zs, meta = case
        return D.dequant_weight(packed, *D._unfold_pre_t(s, zs, meta))

    if kind == 'w4':
        def kernel(case, weight, out_dtype):
            x, _, s, zs, meta = case
            return D.w4_dequant_matmul(x, weight, s, zs, meta, out_dtype)

        def plain(case):
            x, packed, s, zs, meta = case
            return D.dequant_matmul_plain(x, packed, s, zs, meta,
                                          out_dtype=F32)

        def library(case):
            x, w = case[0], dense_weight(case).to(BF16)
            return lambda: torch.matmul(x, w.T)
        return _w4_case, kernel, plain, library, tiling, path

    memo = {}

    def kernel(case, weight, out_dtype):       # w4a8
        """The wrapper on the quantizer kernel's outputs, made once per
        case: the quantizer is no part of the GEMM (``path`` times the two
        together).  Its launch is no launch of the main path either."""
        x, _, s, zs, meta = case
        if memo.get('x') is not x:
            memo.update(x=x, codes=D.quant_act_token(x))
        xq, sx, sums = memo['codes']
        return D.w4a8_dequant_matmul(xq, sx, sums, weight, s, zs, meta,
                                     out_dtype)

    def plain(case):
        x, packed, s, zs, meta = case
        return D.dequant_matmul_plain_a8(x, packed, s, zs, meta,
                                         out_dtype=F32)

    def library(case):
        x, packed, _, _, meta = case
        xq, _ = D._quant_act_token(x)
        rows = max(32, -(-xq.shape[0] // 8) * 8)    # _int_mm needs > 16
        xq = torch.nn.functional.pad(xq, (0, 0, 0, rows - xq.shape[0]))
        w8 = D.unpack_weight(packed, meta).to(torch.int8)
        return lambda: torch._int_mm(xq, w8.T)
    return _w4_case, kernel, plain, library, tiling, path


def a8_oracle(case):
    """The integer oracle of W4A8 in float64 from the same int8 codes:
    sx * sum_g s_g * sum_k xq * (u - z_eff)."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    x, packed, s, zs, meta = case
    xq, sx = D._quant_act_token(x)
    w = D.dequant_weight(packed, *D._unfold_pre_t(s.double(), zs.double(),
                                                  meta))
    return (xq.double() @ w.double().T) * sx.double()


def quant_bound(M, K, x_bytes, peaks):
    """Least time of the activation quantizer: x read once; xq, sx and the
    int32 piece sums (rows padded to a multiple of 4) written once; about
    four operations an element (abs and max, divide, round and clamp) at
    the f32 rate."""
    nbytes = M * K * (x_bytes + 1) + 4 * M + 4 * (K // 64) * (-(-M // 4) * 4)
    t_b, t_o = nbytes / peaks.bw * 1e3, 4 * M * K / peaks.f32 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def check_quant_act_token(dev, peaks, Ks=(4096, 11008),
                          ms_list=(1, 77, 128, 4096), timed=(1, 128, 4096),
                          wide=((53248, 1), (53248, 77))):
    """The quantizer kernel (``quant_act_token``) against its plain
    version ``_quant_act_token`` on the same x on the card: xq and sx bit
    for bit and the int32 piece sums exact (zeros past M); the plain
    version on the card also bit-equal to itself on the CPU.  bf16 x at
    the block linears' K (f32 x too at one shape); row m's first element
    is 1 + 0.01 m, which puts some rows' scale where a true division by
    127 and the folded multiply differ.  ``wide``: (K, M) of rows too wide
    for the kernel to hold in registers (Llama-3-405B's down projection),
    which it reads twice.  Timed at K=4096, bf16."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for K, M in [*itertools.product(Ks, ms_list), *wide]:
        for dt in (BF16, F32) if (K, M) == (4096, 77) else (BF16,):
            x = torch.rand((M, K), generator=gen, device=dev) * 2 - 1
            x[:, 0] = 1 + 0.01 * torch.arange(M, device=dev)
            x = x.to(dt)
            xq, sx, sums = D.quant_act_token(x)
            pq, psx = D._quant_act_token(x)
            cq, csx = D._quant_act_token(x.cpu())
            torch.cuda.synchronize()
            want = pq.to(torch.int32).reshape(M, K // 64, 64).sum(-1).T
            checks = dict(
                xq=torch.equal(xq, pq), sx=torch.equal(sx, psx),
                sums=torch.equal(sums[:, :M], want)
                and bool((sums[:, M:] == 0).all()),
                card_vs_cpu=torch.equal(pq.cpu(), cq)
                and torch.equal(psx.cpu(), csx))
            require(all(checks.values()), f'quant_act_token M={M} K={K} '
                    f'{dt}: not bit-equal: {checks}')
            row = dict(M=M, K=K, x=str(dt).replace('torch.', ''),
                       bit_equal=checks, max_abs_err=max(
                           (xq.float() - pq.float()).abs().max().item(),
                           (sx - psx).abs().max().item()))
            if M in timed and K == 4096 and dt == BF16:
                def kern():
                    return D.quant_act_token(x)
                row.update(kernel_ms=cuda_ms(kern, 50),
                           plain_ms=cuda_ms(lambda: D._quant_act_token(x),
                                            10),
                           host_us=host_us(kern), library_ms=None)
                if M <= 128:
                    row['device_ms'] = graph_ms(kern)
                row['bound_ms'], row['bound_by'] = quant_bound(M, K, 2,
                                                               peaks)
            rows.append(row)
            del x, xq, sx, sums, pq, psx
    return rows


def _rel(got, want):
    err = (got.to(want.dtype) - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def check_gemm(kind, dev, peaks, shapes, ms_list, timed_ms=(1, 128, 4096),
               gs=128):
    """One dequant-matmul kernel ('w4', 'w4a8' or 'w8') at every main-path
    (N, K), each M, sym and asym, group size ``gs``; the symmetric case
    timed at each M of ``timed_ms``.  The tolerance is TOL_W4_F32 at f32
    output and TOL_W4_BF16 at bf16; W4A8 is also run at f32 output against
    the float64 oracle."""
    make, kernel, plain, library, tiling, path = _gemm_ops(kind)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, worst_abs, worst_rel, worst_oracle = [], 0.0, 0.0, 0.0
    for (N, K, is_head) in shapes:
        out_dtype = F32 if is_head else BF16
        tol = TOL_W4_F32 if is_head else TOL_W4_BF16
        for M in ms_list:
            for sym in (True, False):
                case = make(N, K, M, sym, gen, dev, gs)
                got = kernel(case, case[1], out_dtype)
                want = plain(case)
                torch.cuda.synchronize()
                err, rel = _rel(got, want)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                                rel)
                what = f'{kind} N={N} K={K} M={M} sym={sym} gs={gs}'
                require(bool(torch.isfinite(got).all()) and rel <= tol,
                        f'{what}: rel err {rel:.3g} > {tol}')
                row = dict(N=N, K=K, M=M, sym=sym, gs=gs, **tiling(case),
                           out=str(out_dtype).replace('torch.', ''),
                           max_abs_err=err, max_rel_err=rel)
                if kind == 'w4a8':
                    got32 = got if is_head else kernel(case, case[1], F32)
                    _, rel_p = _rel(got32, want)
                    _, rel_o = _rel(got32, a8_oracle(case))
                    require(rel_p <= TOL_W4_F32 and rel_o <= TOL_A8_ORACLE,
                            f'{what}: f32 output rel err {rel_p:.3g} vs '
                            f'plain, {rel_o:.3g} vs the integer oracle')
                    worst_oracle = max(worst_oracle, rel_o)
                    row.update(f32_rel_err_plain=rel_p,
                               f32_rel_err_oracle=rel_o)
                    del got32
                if M in timed_ms and sym:
                    row.update(_time_gemm(kind, case, out_dtype, peaks,
                                          kernel, plain, library, path, gen))
                    if kind == 'w4a8' and M >= 4096:
                        row.update(_time_staged(case, out_dtype, want))
                rows.append(row)
                del case, got, want
    return rows, worst_abs, worst_rel, worst_oracle


def _time_staged(case, out_dtype, want):
    """The staged W4A8 prefill (``A8_STAGE_MIN_M``, off by default: the
    weight re-quantized to per-channel int8 on every call, then one
    library int8 dot) beside the kernel at the same prefill shape.  It
    computes another function than the kernel, so its error against the
    plain W4A8 version is recorded, not held to a tolerance."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    x, packed, s, zs, meta = case

    def staged():
        return D._dequant_matmul_a8_staged(x, packed, s, zs, meta, out_dtype)
    _, rel = _rel(staged(), want)
    return dict(staged_ms=cuda_ms(staged, 5, 1), staged_rel_err=rel)


def host_us(fn, n=50):
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    device is synchronised before and after, not in between)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def graph_ms(fn, n=20):
    """Device milliseconds a call of ``fn`` takes with the host out of the
    way: ``n`` calls captured in one CUDA graph, replayed and timed with
    CUDA events (``kernel_ms`` times calls as the host enqueues them, which
    at a few microseconds of device work a call reads the host)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    ms = cuda_ms(g.replay, 5, 1) / n
    del g
    return ms


def _old_w4(case, weight, out_dtype):
    """B1's design before its wgmma redesign (the ``w4_current`` probe) on
    the same operands."""
    from llmc_tpu_torch.ops.probe_gemm import w4_mma_sync
    x, _, s, zs, meta = case
    return w4_mma_sync(x, weight, s, zs, meta, out_dtype)


def _time_gemm(kind, case, out_dtype, peaks, kernel, plain, library, path,
               gen):
    x, weight, meta = case[0], case[1], case[4]
    M, K = x.shape
    N = meta.out_features
    # rotate over copies of the weight so that the 50 MB L2 does not
    # hold it between calls (the main path reads each weight once a step)
    n_copy = max(1, min(8, -(-160_000_000 // weight.numel())))
    lo, hi = (0, 256) if weight.dtype == torch.uint8 else (-128, 128)
    copies = [weight] + [torch.randint(lo, hi, weight.shape, generator=gen,
                                       device=weight.device,
                                       dtype=weight.dtype)
                         for _ in range(n_copy - 1)]
    def rotating(fn):
        it = [0]

        def call():
            it[0] += 1
            return fn(case, copies[it[0] % n_copy], out_dtype)
        return call
    iters = 10 if M >= 4096 else 50
    kernel_ms = cuda_ms(rotating(kernel), iters)
    path_ms = cuda_ms(rotating(path), iters)
    old = {}
    old['host_us'] = host_us(rotating(kernel))
    if M <= 128:
        old['device_ms'] = graph_ms(rotating(kernel))
        if kind == 'w4a8':   # the quantizer and the GEMM, one chain
            old['path_device_ms'] = graph_ms(rotating(path))
    if kind == 'w4':
        old.update(old_design_ms=cuda_ms(rotating(_old_w4), iters),
                   old_design_host_us=host_us(rotating(_old_w4)))
        if M <= 128:
            old['old_design_device_ms'] = graph_ms(rotating(_old_w4))
    plain_ms = cuda_ms(lambda: plain(case), 3, 1)
    lib = library(case)
    library_ms = cuda_ms(lib, iters)
    del lib, copies
    bound_ms, bound_by = gemm_bound(kind, M, N, K,
                                    4 if out_dtype == F32 else 2, peaks,
                                    has_z=kind != 'w8' or case[3] is not None)
    return dict(kernel_ms=kernel_ms, path_ms=path_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, **old)


def flash_inputs(dev, B=128, smax=96, kvh=32, H=32, hd=128, L=2, quant=True,
                 seed=2, cache=None):
    """q and a random cache: ``cache`` 'int8' (random codes and scales),
    'int8_kv' (the port's KV quantizer on keys of std 1 and values of std
    0.05, V scales about 1e-3, with q of scores that spread over a few
    units: most p times its V scale lies far below f16's normal range),
    'bf16' or 'f32' values; None takes ``quant`` (int8, else bf16)."""
    cache = cache or ('int8' if quant else 'bf16')
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (L, B, smax, kvh, hd)
    q = torch.randn((B, H, hd), generator=gen, device=dev) / hd ** 0.5
    if cache == 'f32':
        kb = torch.randn(shape, generator=gen, device=dev)
        vb = torch.randn(shape, generator=gen, device=dev)
        ks = vs = None
    elif cache == 'int8':
        kb = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vb = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01
    elif cache == 'int8_kv':
        from llmc_tpu_torch.serve import KVCachePolicy
        quant8 = KVCachePolicy(method='naive', bit=8)._quant
        kb, ks, _ = quant8(torch.randn(shape, generator=gen, device=dev))
        vb, vs, _ = quant8(torch.randn(shape, generator=gen, device=dev)
                           * 0.05)
        ks, vs = ks[..., 0], vs[..., 0]
        q = q * 2
    else:
        kb = torch.randn(shape, generator=gen, device=dev).to(BF16)
        vb = torch.randn(shape, generator=gen, device=dev).to(BF16)
        ks = vs = None
    return q, kb, vb, ks, vs


def flash_bound(pos, kvh, hd, H, quant, peaks, esize=None):
    """Least time of one decode attention: the valid rows of K and V of
    this run's positions (``esize`` bytes an element: 1 with its 4-byte
    scale where ``quant``, else 2 unless given), q, the output and pos."""
    valid = int((pos.to(torch.int64) + 1).sum())
    esize = esize or (1 if quant else 2)
    per_row = hd * esize + (4 if quant else 0)
    B = pos.numel()
    nbytes = 2 * valid * kvh * per_row + 2 * B * H * hd * 4 + B * 4
    flops = 4 * valid * (H // kvh) * kvh * hd
    t_b, t_o = nbytes / peaks.bw * 1e3, flops / peaks.f32 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _attn_positions(B, smax, chunk, dev):
    """Named position vectors: random with the chunk boundaries; one slot
    at Smax - 1 and the rest near 0, with every block of 8 slots holding
    such a slot and with only the first block holding one."""
    rng = np.random.RandomState(3)
    special = [0, chunk - 1, chunk, chunk + 1, smax - 1, 31, 32, 1]
    rnd = rng.randint(0, smax, B)
    rnd[:len(special)] = [min(p, smax - 1) for p in special][:B]
    every = rng.randint(0, 3, B)
    every[::8] = smax - 1
    first = rng.randint(0, 3, B)
    first[min(3, B - 1)] = smax - 1
    return {name: torch.as_tensor(v, dtype=torch.int32, device=dev)
            for name, v in (('random', rnd), ('skew_every_block', every),
                            ('skew_one_block', first))}


# check_attention's rows: (B, Smax, KVH, H, valid positions timed).  The
# bench's decode shape (64 valid: the ``kernels`` line's row), a small
# batch with a long cache, and Llama-2-7B's full context of 4096 at B = 1
# and 8 (32 kv heads) and Llama-3-8B's attention widths (8 kv heads for 32
# query heads) at B = 8.
FLASH_SHAPES = ((128, 96, 32, 32, (64,)), (8, 1024, 32, 32, (64, 1000)),
                (1, 4096, 32, 32, (4000,)), (8, 4096, 32, 32, (4000,)),
                (8, 4096, 8, 32, (4000,)))
BATCH_SHAPES = FLASH_SHAPES
# one more case each for both kernels: a float32 model's f32 cache at
# B=8 over 1000 of 1024 positions, and Llama-3.1-405B's attention widths
# (128 query heads over 8 kv heads: 16 a kv head) at the same row
ATTN_F32 = ((8, 1024, 32, 32, (1000,)),)
ATTN_G16 = ((8, 1024, 8, 128, (1000,)),)
# and an int8 cache made by the port's KV quantizer at Llama-3-8B's row
# (``flash_inputs``' 'int8_kv': V scales and p as a model gives them)
ATTN_KVQ = ((8, 4096, 8, 32, (4000,)),)
GRAPH_BELOW_MS = 0.06   # a reading under this also gets its graph time


def check_attention(name, dev, peaks, shapes=FLASH_SHAPES, hd=128,
                    caches=('int8', 'bf16'), tol=TOL_FLASH):
    """A decode-attention kernel ('flash_decode' or 'batch_decode') against
    its plain version (within ``tol``) at each of ``shapes`` and
    ``caches``, over ``_attn_positions``, each launched twice to the same
    bits; timed at each shape's valid positions a slot (the first row,
    which the ``kernels`` line reads, at the bench's mid-run state) beside
    the bound, the plain version and SDPA, and through a CUDA graph where the reading
    is under ``GRAPH_BELOW_MS`` (the host's enqueue rate)."""
    if name == 'flash_decode':
        from llmc_tpu_torch.ops.flash_decode import (
            KERNEL_CHUNK as chunk, flash_decode_cuda as kernel,
            flash_decode_plain as plain)
    else:
        from llmc_tpu_torch.ops.batch_decode import (
            KERNEL_CHUNK as chunk, batch_decode_cuda as kernel,
            batch_decode_plain as plain)
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    for (B, smax, kvh, H, timed), cache in itertools.product(shapes, caches):
        quant = cache.startswith('int8')
        q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd,
                                         cache=cache)
        errs = {}
        for pname, pos in _attn_positions(B, smax, chunk, dev).items():
            got = kernel(q, kb, vb, ks, vs, pos, 1)
            again = kernel(q, kb, vb, ks, vs, pos, 1)
            want = plain(q, kb, vb, ks, vs, pos, 1)
            torch.cuda.synchronize()
            err, rel = _rel(got, want)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                            rel)
            what = (f'{name} B={B} Smax={smax} KVH={kvh} H={H} {cache} '
                    f'{pname}')
            require(bool(torch.isfinite(got).all()) and rel <= tol,
                    f'{what}: rel err {rel:.3g} > {tol}')
            require(torch.equal(got, again),
                    f'{what}: a second launch gave other bits')
            errs[pname] = rel
            del got, again, want
        for valid in timed:
            pos_t = torch.full((B,), valid - 1, dtype=torch.int32,
                               device=dev)
            it = [0]

            def kern():
                it[0] += 1   # alternate layers: at B=128 each is beyond L2
                return kernel(q, kb, vb, ks, vs, pos_t, it[0] % 2)
            kernel_ms = cuda_ms(kern, 200, 5)
            plain_ms = cuda_ms(
                lambda: plain(q, kb, vb, ks, vs, pos_t, 1), 5, 1)
            library_ms = _time_sdpa(q, kb, vb, ks, vs, pos_t, 1)
            bound_ms, bound_by = flash_bound(pos_t, kvh, hd, H, quant,
                                             peaks, kb.element_size())
            row = dict(B=B, smax=smax, kvh=kvh, H=H, hd=hd, cache=cache,
                       max_rel_err=max(errs.values()),
                       rel_err_by_positions=errs,
                       timed_valid_positions=valid,
                       kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, x_bound=kernel_ms / bound_ms,
                       x_library=kernel_ms / library_ms)
            if kernel_ms < GRAPH_BELOW_MS:
                row['graph_ms'] = graph_ms(kern)
            rows.append(row)
        del q, kb, vb, ks, vs
        torch.cuda.empty_cache()
    return rows, worst_abs, worst_rel


def sweep_batch_blocks(dev, shapes=((128, 96, 32, 64), (8, 1024, 32, 64),
                                    (8, 1024, 32, 1000), (8, 4096, 8, 4000)),
                       H=32, hd=128):
    """The serving-batch kernel over its launch argument, slots a CTA
    (``b_blk``: how its warps are packed; the split plan follows the
    kernel's occupancy in CTAs of that size), on an int8 cache at each
    (B, Smax, kv heads, valid positions a slot: one query head a kv head
    on the CUDA cores, and Llama-3-8B's four on the tensor cores), timed
    through a CUDA graph (the device's time, not the host's enqueue rate):
    one row a block size, ``picked`` on the one ``kernel_plan`` chooses."""
    from llmc_tpu_torch.ops import batch_decode as BD
    rows = []
    for B, smax, kvh, valid in shapes:
        q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd)
        pos = torch.full((B,), valid - 1, dtype=torch.int32, device=dev)
        picked = BD.kernel_plan(q, kb)[0]
        for b_blk in (1,) + tuple(reversed(BD.BLOCKS)):
            if B % b_blk:
                continue
            it = [0]

            def kern():
                it[0] += 1
                return BD.batch_decode_cuda(q, kb, vb, ks, vs, pos,
                                            it[0] % 2, b_blk)
            rows.append(dict(B=B, smax=smax, kvh=kvh, valid=valid,
                             b_blk=b_blk,
                             splits=BD.kernel_plan(q, kb, b_blk)[1],
                             picked=b_blk == picked,
                             graph_ms=graph_ms(kern)))
        del q, kb, vb, ks, vs
    return rows


def _time_sdpa(q, kb, vb, ks, vs, pos, layer):
    """Yardstick: scaled_dot_product_attention on dequantized bf16 K/V
    (the port never calls it)."""
    B, H, hd = q.shape
    k = kb[layer].to(F32)
    v = vb[layer].to(F32)
    if ks is not None:
        k = k * ks[layer][..., None]
        v = v * vs[layer][..., None]
    kvh = k.shape[2]
    k = k.to(BF16).permute(0, 2, 1, 3).repeat_interleave(H // kvh, 1)
    v = v.to(BF16).permute(0, 2, 1, 3).repeat_interleave(H // kvh, 1)
    qq = q.to(BF16)[:, :, None, :]
    smax = k.shape[2]
    mask = (torch.arange(smax, device=q.device)[None, :]
            <= pos[:, None].to(torch.int64))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: sdpa(qq, k, v, attn_mask=mask, scale=1.0), 200, 5)


# --------------------------------------------------------------------------
# the FP8-block GEMM
# --------------------------------------------------------------------------

FP8_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (22016, 4096)]
# an N that is no multiple of the 128-row scale block (nor of the tile)
FP8_RAGGED = [(4000, 4096)]


def fp8_bound(M, N, K, out_bytes, peaks, bs=128):
    """Least time of one FP8-block GEMM: codes, both scale arrays and the
    output moved once, against 2*M*N*K operations at the FP8 rate."""
    kb = K // bs
    nbytes = (M * K + N * K + 4 * M * kb + 4 * -(-N // bs) * kb
              + out_bytes * M * N)
    t_b, t_o = nbytes / peaks.bw * 1e3, 2 * M * N * K / peaks.fp8 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _fp8_case(N, K, M, gen, dev, bs=128):
    """(x bf16, its codes and scales, the weight's codes and scale_inv):
    random activations and weights through the port's own quantizers, in
    blocks of ``bs``."""
    from llmc_tpu_torch.quant import act_quant_per_group, weight_cast_to_fp8
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    xc, xs = act_quant_per_group(x, bs)
    wc, ws = weight_cast_to_fp8(w, bs)
    return x, xc, xs.contiguous(), wc, ws.contiguous()


def _fp8_library(case):
    """The yardstick call and its name: ``torch._scaled_mm`` with 1x128 /
    128x128 block scales where this build of torch takes them (and gives
    the plain version's result), else a bf16 ``torch.matmul`` on the weight
    from ``weight_cast_to_bf16``, which is what the loader's route costs."""
    from llmc_tpu_torch.ops.fp8_gemm import fp8_block_matmul_plain
    from llmc_tpu_torch.quant import weight_cast_to_bf16
    x, xc, xs, wc, ws = case
    want = fp8_block_matmul_plain(xc, xs, wc, ws, out_dtype=F32)
    for sa, sb in ((xs.t().contiguous().t(), ws.t()),
                   (xs, ws.t().contiguous()),
                   (xs.t().contiguous().t(), ws.t().contiguous())):
        def scaled(sa=sa, sb=sb):
            return torch._scaled_mm(xc, wc.t(), scale_a=sa, scale_b=sb,
                                    out_dtype=BF16)
        try:
            got = scaled()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError, NotImplementedError):
            continue
        if _rel(got, want)[1] <= TOL_W4_BF16:
            return scaled, 'torch._scaled_mm, 1x128 and 128x128 block scales'
    w = weight_cast_to_bf16(wc, ws)
    return (lambda: torch.matmul(x, w.T)), \
        'torch.matmul, bf16 weight from weight_cast_to_bf16'


def check_fp8(dev, peaks, shapes=FP8_SHAPES, ms_list=(1, 64, 77, 128, 4096),
              timed=(1, 64, 128, 4096), bs=128, contiguous_w=False):
    """The FP8-block kernel at every (N, K) and M, f32 and bf16 output, in
    scale blocks of ``bs`` (the whole K where ``bs`` is 'K'), against its
    plain version and the float64 oracle; with ``contiguous_w`` on the
    weight codes in contiguous rows (not padded to 16 bytes as the cast
    packs them: where K is no multiple of 16 the kernel reads them without
    TMA).  Times by CUDA events at the
    ``timed`` Ms (block size 128), with the host's microseconds a launch
    and, up to M=128, the device time through a CUDA graph."""
    from llmc_tpu_torch.ops import fp8_gemm as G
    from llmc_tpu_torch.ops.dequant_matmul import wgmma_tiling
    from llmc_tpu_torch.quant import act_quant_per_group, fp8_block_matmul
    from llmc_tpu_torch.utils.device import sm_count
    gen = torch.Generator(device=dev).manual_seed(4)
    rows, worst_abs, worst_rel, worst_oracle = [], 0.0, 0.0, 0.0
    for (N, K), M in itertools.product(shapes, ms_list):
        b = K if bs == 'K' else bs
        case = _fp8_case(N, K, M, gen, dev, b)
        if contiguous_w:
            case = case[:3] + (case[3].contiguous(),) + case[4:]
        x, xc, xs, wc, ws = case
        plain = G.fp8_block_matmul_plain(xc, xs, wc, ws, b, out_dtype=F32)
        oracle = G.fp8_block_matmul_plain(xc, xs, wc, ws, b,
                                          out_dtype=torch.float64,
                                          acc_dtype=torch.float64)
        got32 = G.fp8_block_matmul_cuda(xc, xs, wc, ws, b, out_dtype=F32)
        got16 = G.fp8_block_matmul_cuda(xc, xs, wc, ws, b, out_dtype=BF16)
        torch.cuda.synchronize()
        err, rel_p = _rel(got32, plain)
        _, rel_o = _rel(got32, oracle)
        err16, rel16 = _rel(got16, plain)
        what = f'fp8_block_gemm N={N} K={K} M={M} block {b}'
        finite = bool(torch.isfinite(got32).all()
                      and torch.isfinite(got16).all())
        require(finite and rel_o <= TOL_FP8_ORACLE
                and rel_p <= TOL_FP8_ORACLE and rel16 <= TOL_W4_BF16,
                f'{what}: rel err {rel_o:.3g} vs the float64 oracle, '
                f'{rel_p:.3g} vs plain (limit {TOL_FP8_ORACLE}), bf16 output '
                f'{rel16:.3g} (limit {TOL_W4_BF16})')
        worst_abs, worst_rel = max(worst_abs, err16), max(worst_rel, rel16)
        worst_oracle = max(worst_oracle, rel_o)
        tt, splits = wgmma_tiling(M, N, K // b, sm_count(dev.index or 0))
        row = dict(N=N, K=K, M=M, block=b, tok_tile=tt, splits=splits,
                   f32_rel_err_oracle=rel_o, f32_rel_err_plain=rel_p,
                   max_abs_err=err16, max_rel_err=rel16)
        del plain, oracle, got32, got16
        if M in timed and b == 128:
            n_copy = max(1, min(8, -(-160_000_000 // wc.numel())))
            copies = [wc] + [wc.clone() for _ in range(n_copy - 1)]
            it = [0]

            def rotating(fn):
                def call():
                    it[0] += 1
                    return fn(copies[it[0] % n_copy])
                return call
            iters = 10 if M >= 4096 else 50
            kern = rotating(lambda w: G.fp8_block_matmul_cuda(xc, xs, w, ws))
            row['kernel_ms'] = cuda_ms(kern, iters)
            row['host_us'] = host_us(kern)
            if M <= 128:
                row['device_ms'] = graph_ms(kern)
            row['path_ms'] = cuda_ms(rotating(
                lambda w: fp8_block_matmul(*act_quant_per_group(x), w, ws)),
                iters)
            row['plain_ms'] = cuda_ms(
                lambda: G.fp8_block_matmul_plain(xc, xs, wc, ws), 2, 1)
            lib, row['library'] = _fp8_library(case)
            row['library_ms'] = cuda_ms(lib, iters)
            row['bound_ms'], row['bound_by'] = fp8_bound(M, N, K, 2, peaks)
            del lib, copies, kern
        rows.append(row)
        del case, x, xc, xs, wc, ws
    return rows, worst_abs, worst_rel, worst_oracle


def fp8_adder_probe(dev, M=16, N=128, K=1024):
    """What the kernel keeps when a block's products differ widely in
    size: in every 32-wide k step one product of 448 * 448 (about
    2^17.6) beside 31 products of 2^-6 * 16 = 2^-2, which float32 adds
    exactly (the sum of a block needs 21 bits).  An adder that aligns to
    the step's largest product and keeps fewer bits loses the small ones:
    124 * 2^-2 in 4 * 448^2 of a block, 3.9e-5 of the output.  Returns the
    kernel's error against the float64 oracle, relative to the largest
    output."""
    from llmc_tpu_torch.ops import fp8_gemm as G
    x = torch.full((M, K), 2.0 ** -6, device=dev)
    w = torch.full((N, K), 16.0, device=dev)
    x[:, ::32] = 448.0
    w[:, ::32] = 448.0
    # rows and columns differ, so that no two outputs are the same sum
    x[:, 1::32] *= torch.arange(1, M + 1, device=dev)[:, None].float()
    w[:, 2::32] /= 2.0 ** torch.arange(N, device=dev)[:, None].remainder(4)
    xc, wc = x.to(torch.float8_e4m3fn), w.to(torch.float8_e4m3fn)
    xs = torch.ones((M, K // 128), device=dev)
    ws = torch.ones((N // 128, K // 128), device=dev)
    oracle = G.fp8_block_matmul_plain(xc, xs, wc, ws,
                                      out_dtype=torch.float64,
                                      acc_dtype=torch.float64)
    return _rel(G.fp8_block_matmul_cuda(xc, xs, wc, ws, out_dtype=F32),
                oracle)[1]


# --------------------------------------------------------------------------
# model phases (device and sizes are arguments, so the CPU tests run them)
# --------------------------------------------------------------------------

# The w4 design probes (rows 7 to 15 of PERF.md's kernel table), each with
# the TPU kernel it replaces: the tool's pallas_call and its kernel function
PROBE_KERNELS = {
    'bf16_chunked': ('tools/kernel_bench.py:113',
                     'tools/kernel_bench.py::_bf16_kernel'),
    'bf16_bigdot': ('tools/w4_probe.py:149', 'tools/w4_probe.py::_bf16_big'),
    'i8_cast': ('tools/kernel_bench.py:151',
                'tools/kernel_bench.py::_i8_kernel'),
    'i8xi8_int32': ('tools/w4_probe.py:210', 'tools/w4_probe.py::_i8i8'),
    'w4_blockdecode': ('tools/w4_probe.py:257',
                       'tools/w4_probe.py::_w4_block'),
    'w4_fullq': ('tools/kernel_bench.py:236',
                 'tools/kernel_bench.py::_fullq_kernel'),
    'i32_window': ('tools/kernel_bench.py:191',
                   'tools/kernel_bench.py::_i32_kernel'),
    'w4_xc': ('tools/kernel_bench.py:297',
              'tools/kernel_bench.py::_xc_kernel'),
    'i4_native': ('tools/w4_probe.py:295', 'tools/w4_probe.py::_i4_big'),
    # B1's design before its wgmma redesign, the tools' ``w4_current``
    'w4_mma_sync': ('llmc_tpu/ops/dequant_matmul.py:426',
                    'llmc_tpu/ops/dequant_matmul.py::_kernel_w4'),
}
# the CUDA source of each probe
PROBE_SOURCES = dict(dict.fromkeys(PROBE_KERNELS, 'probe_gemm.cu'),
                     w4_mma_sync='dequant_matmul_w4_mma.cu')
# every kernel of the port: the probes, then the main paths' seven (the
# W4A8 path's activation quantizer replaces no TPU kernel)
KERNEL_NAMES = tuple(PROBE_KERNELS) + (
    'w4_dequant_matmul', 'w4a8_dequant_matmul', 'quant_act_token',
    'w8_dequant_matmul', 'flash_decode', 'batch_decode', 'fp8_block_gemm')
# A serving configuration: weight bits, per-token int8 activations on the
# block linears, and the decode-attention kernel (``ATTN_IMPL``).
Mode = collections.namedtuple('Mode', 'bits a_int8 attn')
MODES = {'w4a16': Mode(4, False, 'flash'), 'w4a8': Mode(4, True, 'batch'),
         'w8a16': Mode(8, False, 'flash')}


def _wspec(bits=4, group_size=128):
    from llmc_tpu_torch.quant import QuantSpec
    return QuantSpec(bit=bits, symmetric=True, granularity='per_group',
                     group_size=group_size)


def make_model(mode, cfg_kw, dev, seed=0, group_size=128):
    """Random packed Llama of a serving mode, and its QMap."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.serve.packed import random_packed_llama
    m = MODES[mode]
    return random_packed_llama(LlamaConfig(**cfg_kw),
                               _wspec(m.bits, group_size), seed=seed,
                               fuse=True, pre_t=True, head=True,
                               a_int8=m.a_int8, device=dev)


@contextlib.contextmanager
def attn_impl(name):
    """Run a block under ``serve.decode.ATTN_IMPL = name``."""
    from llmc_tpu_torch.serve import decode
    old, decode.ATTN_IMPL = decode.ATTN_IMPL, name
    try:
        yield
    finally:
        decode.ATTN_IMPL = old


def expected_launches(layers, forwards, decode_steps, mode='w4a16',
                      block_forwards=None):
    """Launches a path implies.  Per forward: 4 block linears a layer
    (fused qkv, o, fused gate_up, down) through the mode's kernel (for
    W4A8 each after one launch of the activation quantizer) and the
    packed head through the weight-only kernel of its bits; per decode
    step, one decode-attention a layer.  ``block_forwards``: the forwards
    whose block linears launch a kernel at all (the w8 companion's dot is
    no kernel of the port), default every forward."""
    m = MODES[mode]
    n = dict.fromkeys(KERNEL_NAMES, 0)
    weight_only = 'w8_dequant_matmul' if m.bits == 8 else 'w4_dequant_matmul'
    block = 'w4a8_dequant_matmul' if m.a_int8 else weight_only
    n[block] += 4 * layers * (forwards if block_forwards is None
                              else block_forwards)
    if m.a_int8:
        n['quant_act_token'] = n[block]
    n[weight_only] += forwards
    n['batch_decode' if m.attn == 'batch' else 'flash_decode'] = \
        layers * decode_steps
    return n


def _scale_weights(tree, factor) -> None:
    """Multiply every packed linear's scales by ``factor``, in place."""
    if isinstance(tree, dict):
        if 'qweight' in tree:
            tree['scales'] = tree['scales'] * factor
            return
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            _scale_weights(v, factor)


@contextlib.contextmanager
def plain_linears(w_bf16=False):
    """Send the card's dequant-matmuls through their plain versions (the
    parity phase's control run: same bf16 activations, no kernel).
    ``w_bf16`` rounds a W8 weight to bf16 as the W8 kernel does."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')

    def plain(x2, packed, scales, zeros, meta, out_dtype, a_int8):
        if a_int8:
            return D.dequant_matmul_plain_a8(x2, packed, scales, zeros, meta,
                                             out_dtype=out_dtype)
        return D.dequant_matmul_plain(x2, packed, scales, zeros, meta,
                                      out_dtype=out_dtype,
                                      w_bf16=w_bf16 and meta.bits == 8)
    old, D._dequant_matmul_cuda = D._dequant_matmul_cuda, plain
    try:
        yield
    finally:
        D._dequant_matmul_cuda = old


def phase_parity(dev, ref_dev, cfg_kw, prompt_len=32, steps=8, seed=0,
                 mode='w4a16', group_size=128):
    """The same random packed weights on ``dev`` (bf16) and ``ref_dev``
    (f32).  The reference is teacher-forced on ``dev``'s greedy tokens,
    so every step's logits compare like with like."""
    from llmc_tpu_torch.models import LlamaAdapter
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    src, qmap = make_model(mode, cfg_kw, 'cpu', seed, group_size)
    cfg = src.cfg
    if MODES[mode].bits == 8:
        # the random model gives 8-bit codes (+-128) the scale of the 4-bit
        # ones (+-8); a sixteenth of it gives the W8 parity model the W4
        # model's weight magnitude, so that the attention softmax is not
        # saturated to one-hot rows whose argmax a rounding can flip
        _scale_weights(src.params, 1 / 16)
    cfg32 = dataclasses.replace(cfg, dtype='float32')
    m_dev = LlamaAdapter(cfg, tree_to(src.params, dev))
    m_ref = LlamaAdapter(cfg32, tree_to(src.params, ref_dev, F32))
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, prompt_len)))

    def run(model, device, feed=None):
        cache = init_cache(model, 1, prompt_len + steps, policy,
                           device=device)
        logits, cache = forward_cached(model.params, model.cfg,
                                       ids.to(device), cache, policy, qmap)
        rows = [logits[:, -1].float().cpu()]
        tok = rows[-1].argmax(-1)
        toks = [int(tok)]
        for i in range(steps):
            t = tok if feed is None else torch.tensor([feed[i]])
            logits, cache = forward_cached(model.params, model.cfg,
                                           t[:, None].to(device), cache,
                                           policy, qmap)
            rows.append(logits[:, -1].float().cpu())
            tok = rows[-1].argmax(-1)
            toks.append(int(tok))
        return torch.cat(rows), toks

    with torch.no_grad(), attn_impl(MODES[mode].attn):
        reset_launch_counts()
        got, toks = run(m_dev, dev)
        counts, xla = read_counts()
        want, ref_toks = run(m_ref, ref_dev, feed=toks)
        # control runs on ``dev``: the same bf16 activations through the
        # plain linears, to tell the kernels' share of the error from the
        # working type's
        controls, same_fn = {}, None
        if dev.type == 'cuda':
            for name, w_bf16 in (('plain_linears', False),
                                 ('plain_linears_bf16_weight', True)):
                if w_bf16 and MODES[mode].bits != 8:
                    continue
                with plain_linears(w_bf16):
                    ctl, _ = run(m_dev, dev, feed=toks)
                controls[name] = _rel(ctl, want)[1]
                # the last control computes the kernels' own function (the
                # W8 kernel rounds its weight to bf16): the kernel run is
                # held against it directly
                same_fn = _rel(got, ctl)[1]
    err, rel = _rel(got, want)
    agree = float(np.mean([a == b for a, b in zip(toks, ref_toks)]))
    tol = TOL_PARITY[mode]
    return dict(phase='parity', mode=mode, seed=seed,
                layers=cfg.num_hidden_layers,
                width=cfg.hidden_size, prompt=prompt_len, steps=steps,
                max_abs_logit_err=err, rel_logit_err=rel,
                rel_logit_err_of_controls=controls,
                rel_logit_err_vs_same_function_control=same_fn,
                greedy_agreement=agree, tolerance=tol,
                tolerance_vs_same_function_control=TOL_VS_CONTROL[mode],
                min_greedy_agreement=MIN_GREEDY_AGREE,
                ok=bool(rel <= tol and agree >= MIN_GREEDY_AGREE
                        and all(rel <= PARITY_VS_CONTROL * c
                                for c in controls.values())
                        and (same_fn is None
                             or same_fn <= TOL_VS_CONTROL[mode])),
                launches=counts, xla_branch_calls=xla, expected_launches=expected_launches(
                    cfg.num_hidden_layers, 1 + steps, steps, mode))


def serve_requests(n, vocab, max_prompt=200, seed=0):
    from llmc_tpu_torch.serve import Request
    rng = np.random.RandomState(seed)
    lens = np.linspace(10, max_prompt, n).astype(int)
    rng.shuffle(lens)
    return [Request(uid=i, prompt_ids=rng.randint(0, vocab, (int(p),)),
                    max_new_tokens=int(16 + (i * 7) % 17))
            for i, p in enumerate(lens)]


def phase_serve(dev, model, qmap, n_requests=10, max_batch=8, max_len=256,
                buckets=(32, 64, 128, 256), max_prompt=200, mode='w4a16',
                w8_flag=None):
    """ServingEngine over mixed requests; returns the phase record with
    the launch counts the path implies.  ``w8_flag`` ('prefill_w8' or
    'decode_w8') sends those forwards through the model's w8 companion,
    whose block linears launch no kernel of the port."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy, ServingEngine
    cfg = model.cfg
    with attn_impl(MODES[mode].attn):
        eng = ServingEngine(model, qmap=qmap, max_batch=max_batch,
                            max_len=max_len, prefill_buckets=buckets,
                            kv_policy=KVCachePolicy(method='naive', bit=8),
                            device=dev, **({w8_flag: True} if w8_flag else {}))
        reqs = serve_requests(n_requests, cfg.vocab_size, max_prompt)
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.run(reqs)
        if dev.type == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, xla = read_counts()
    L = cfg.num_hidden_layers
    prefills, steps = eng.stats['prefill_forwards'], eng.stats['decode_steps']
    block_forwards = {None: None, 'prefill_w8': steps, 'decode_w8': 0}[w8_flag]
    expect = expected_launches(L, prefills + steps, steps, mode,
                               block_forwards)
    done = all(r.done and len(r.output_ids) == r.max_new_tokens
               and all(0 <= t < cfg.vocab_size for t in r.output_ids)
               for r in reqs)
    name = 'serve' if mode == 'w4a16' else f'serve_{mode.replace("a16", "")}'
    if w8_flag:
        name = f'serve_w8_companion.{w8_flag}'
    return dict(phase=name, mode=mode, layers=L, requests=len(reqs),
                prompt_lens=[len(r.prompt_ids) for r in reqs],
                tokens=sum(len(r.output_ids) for r in reqs),
                wall_s=wall, **eng.stats, launches=counts, xla_branch_calls=xla,
                expected_launches=expect, all_done=done)


def companion_model(dev, cfg_kw, seed=0, group_size=128):
    """A random fp Llama packed W4 with the per-channel int8 companion
    beside every block linear (``pack_model(w8_prefill=True)`` builds it
    from the dequantized weight), and its serving QMap."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.serve import pack_model
    model = LlamaAdapter.random(LlamaConfig(**cfg_kw), seed=seed, device=dev)
    qmap = pack_model(model, _wspec(4, group_size), fuse=True, head=True,
                      w8_prefill=True)
    return model, qmap


def phase_throughput(dev, model, qmap, B=128, prefill=32, steps=64, seed=0,
                     mode='w4a16'):
    """The reference bench's shape on the port: prefill, then greedy
    decode steps, timed with host clocks around synchronised work.  One
    prefill and one step on a throwaway cache first take the first-use
    costs (allocator growth, library handles) out of TTFT."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    cfg = model.cfg
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, prefill)), device=dev)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize()

    with torch.no_grad(), attn_impl(MODES[mode].attn):
        cache = init_cache(model, B, prefill + 1, policy, device=dev)
        logits, cache = forward_cached(model.params, cfg, ids, cache,
                                       policy, qmap, last_only=True)
        forward_cached(model.params, cfg, logits[:, -1].argmax(-1)[:, None],
                       cache, policy, qmap)
        del cache, logits
        cache = init_cache(model, B, prefill + steps, policy, device=dev)
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = forward_cached(model.params, cfg, ids, cache,
                                       policy, qmap, last_only=True)
        tok = logits[:, -1].argmax(-1)
        sync()
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = forward_cached(model.params, cfg, tok[:, None],
                                           cache, policy, qmap)
            tok = logits[:, -1].argmax(-1)
        sync()
        dec = time.perf_counter() - t0
        counts, xla = read_counts()
    return dict(phase='throughput', mode=mode, B=B, prefill=prefill,
                steps=steps, tokens_per_s=B * steps / dec,
                ttft_ms=ttft * 1e3, step_ms=dec / steps * 1e3,
                launches=counts, xla_branch_calls=xla, expected_launches=expected_launches(
                    cfg.num_hidden_layers, 1 + steps, steps, mode))


def phase_profile(dev, model, qmap, B=128, prefill=32, steps=8, top=12,
                  mode='w4a16'):
    """torch.profiler over ``steps`` decode steps after a prefill of
    ``prefill`` tokens a slot (the bench's shape by default): device time
    by kernel, the decode attention's share of it, and the device's busy
    share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    cfg = model.cfg
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.randint(0, cfg.vocab_size, (B, prefill), device=dev)
    with torch.no_grad(), attn_impl(MODES[mode].attn):
        cache = init_cache(model, B, prefill + steps + 1, policy, device=dev)
        reset_launch_counts()
        logits, cache = forward_cached(model.params, cfg, ids, cache, policy,
                                       qmap, last_only=True)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = forward_cached(model.params, cfg,
                                               tok[:, None], cache, policy,
                                               qmap)
                tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts, xla = read_counts()
    # device-side events only: a host op (aten::mean) also reports the
    # device time of the kernel it launched, which would count it twice
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0))
        if dt > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3          # ms
    attn = sum(r[0] for r in rows
               if 'flash_decode' in r[1] or 'batch_decode' in r[1]) / 1e3
    return dict(phase='profile', mode=mode, B=B, prefill=prefill,
                steps=steps, wall_ms=wall * 1e3, device_busy_ms=busy,
                device_busy_ms_per_step=busy / steps,
                attention_ms_per_step=attn / steps,
                attention_share=attn / busy if busy else 0.0,
                device_idle_share=max(0.0, 1 - busy / (wall * 1e3)),
                per_step_ms=wall * 1e3 / steps,
                top=[dict(kernel=k[:80], ms=dt / 1e3, calls=c)
                     for dt, k, c in rows[:top]],
                launches=counts, xla_branch_calls=xla, expected_launches=expected_launches(
                    cfg.num_hidden_layers, 1 + steps, steps, mode))


def step_bound(model, B, prefill, steps, peaks, mode='w4a16'):
    """Least time of one decode step: the packed weights' bytes (codes,
    scales, zeros) + the average valid int8 KV prefix, against the
    linears' operations at the peak of the type they multiply in (int8
    for the block linears of W4A8, bf16 otherwise and for the head)."""
    cfg = model.cfg

    def walk(t):
        """(bytes, weights) of every packed linear under ``t``."""
        if isinstance(t, dict):
            if 'qweight' in t:
                nbytes = sum(t[k].numel() * t[k].element_size()
                             for k in ('qweight', 'scales', 'zeros')
                             if t.get(k) is not None)
                per_byte = 2 if t['qweight'].dtype == torch.uint8 else 1
                return nbytes, t['qweight'].numel() * per_byte
            t = list(t.values())
        if isinstance(t, list):
            parts = [walk(v) for v in t]
            return sum(p[0] for p in parts), sum(p[1] for p in parts)
        return 0, 0
    blk_bytes, blk_params = walk(model.params['blocks'])
    head_bytes, head_params = walk(model.params.get('lm_head'))
    L, KVH, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim)
    valid = prefill + steps / 2
    kv = 2 * L * B * valid * KVH * (hd + 4)
    wbytes = blk_bytes + head_bytes
    t_b = (wbytes + kv) / peaks.bw * 1e3
    blk_peak = peaks.int8 if MODES[mode].a_int8 else peaks.bf16
    t_o = 2 * B * (blk_params / blk_peak + head_params / peaks.bf16) * 1e3
    return dict(step_bound_ms=max(t_b, t_o),
                step_bound_by='bytes' if t_b >= t_o else 'operations',
                weight_bytes=wbytes, kv_bytes_avg=kv,
                linear_params=blk_params + head_params)


# --------------------------------------------------------------------------
# the FP8-block linear and the compression pipeline
# --------------------------------------------------------------------------

def phase_fp8_linear(dev, cfg_kw, M=128, seed=0, block_size=128):
    """One block's seven linears as an FP8-block checkpoint stores them:
    random weights -> ``weight_cast_to_fp8``; M rows of bf16 activations
    -> ``act_quant_per_group`` -> ``fp8_block_matmul``.  Each output is
    held against x @ weight_cast_to_bf16(codes, scale_inv)^T in f32 and
    against the plain version on the same codes."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.models.base import get_path
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.quant import (act_quant_per_group, fp8_block_matmul,
                                      weight_cast_to_bf16, weight_cast_to_fp8)
    model = LlamaAdapter.random(
        LlamaConfig(**dict(cfg_kw, num_hidden_layers=1)), seed=seed,
        device=dev)
    paths = model.get_layout().linears
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        stored = {p: weight_cast_to_fp8(get_path(model.blocks[0], p)['w'],
                                        block_size) for p in paths}
        xs_in = {p: torch.randn((M, stored[p][0].shape[1]), generator=gen,
                                device=dev).to(BF16) for p in paths}
        reset_launch_counts()
        outs = {}
        for p in paths:
            codes, scale_inv = stored[p]
            xc, xs = act_quant_per_group(xs_in[p], block_size)
            outs[p] = fp8_block_matmul(xc, xs, codes, scale_inv, block_size)
        counts, xla = read_counts()
        rows = []
        for p in paths:
            codes, scale_inv = stored[p]
            xc, xs = act_quant_per_group(xs_in[p], block_size)
            plain = fp8_block_matmul(xc, xs, codes, scale_inv, block_size,
                                     out_dtype=F32, force_plain=True)
            dense = xs_in[p].to(F32) @ weight_cast_to_bf16(
                codes, scale_inv, block_size).to(F32).T
            rows.append(dict(
                path=p, N=codes.shape[0], K=codes.shape[1],
                finite=bool(torch.isfinite(outs[p]).all()),
                rel_err_vs_plain=_rel(outs[p], plain)[1],
                rel_err_vs_dense_bf16_weight=_rel(outs[p], dense)[1]))
    expect = dict.fromkeys(KERNEL_NAMES, 0)
    expect['fp8_block_gemm'] = len(paths) if dev.type == 'cuda' else 0
    return dict(phase='fp8_linear', width=model.cfg.hidden_size, layers=1,
                M=M, block_size=block_size, linears=rows,
                tolerance_vs_plain=TOL_W4_BF16,
                tolerance_vs_dense=TOL_FP8_LINEAR,
                ok=all(r['finite'] and r['rel_err_vs_plain'] <= TOL_W4_BF16
                       and r['rel_err_vs_dense_bf16_weight'] <= TOL_FP8_LINEAR
                       for r in rows),
                launches=counts, xla_branch_calls=xla, expected_launches=expect)


def _fp8_ingest_model_type():
    """Register (once) the model type of the ``compress`` phase's AWQ run:
    a random Llama whose block linears went through the FP8-block ingest
    in memory: ``weight_cast_to_fp8`` (what such a checkpoint stores) and
    the loader's own ``_ingest_fp8`` (``weight_cast_to_bf16`` with the
    block size taken from the two shapes).  Its norm weights are
    log-normal (sigma ``NORM_SIGMA``, scaled to a mean square of 1, which
    keeps a block's share of the residual stream what it is with norm
    weights of one) instead of ones, so that the inputs
    of the linears have outlier channels as a trained model's do: with
    uniform channels every AWQ ratio gives nearly the same scales, and
    ``search_vs_rtn`` could not tell the best ratio from the worst."""
    from llmc_tpu_torch.models import LlamaAdapter
    from llmc_tpu_torch.models.base import get_path, set_path
    from llmc_tpu_torch.models.hf_loader import _ingest_fp8
    from llmc_tpu_torch.quant import weight_cast_to_fp8
    from llmc_tpu_torch.utils import MODEL_REGISTRY
    name = 'LlamaFp8BlockIngest'
    if name in MODEL_REGISTRY:
        return name

    @MODEL_REGISTRY.register(name=name)
    class LlamaFp8BlockIngest(LlamaAdapter):
        @classmethod
        def from_config(cls, config, device=None):
            model = super().from_config(config, device=device)
            bs = int(config['model'].get('fp8_block_size', 128))
            dev = model.device
            gen = torch.Generator(device=dev).manual_seed(
                int(config['model'].get('seed', 0)) + 1)
            with torch.no_grad():
                for i, blk in enumerate(model.blocks):
                    for p in model.get_layout().linears:
                        lin = get_path(blk, p)
                        codes, scale_inv = weight_cast_to_fp8(lin['w'], bs)
                        w = _ingest_fp8(codes, scale_inv).to(lin['w'].dtype)
                        blk = set_path(blk, p, dict(lin, w=w))
                    for p in ('input_layernorm', 'post_attention_layernorm'):
                        ln = get_path(blk, p)
                        spread = torch.exp(NORM_SIGMA * torch.randn(
                            ln['w'].shape, generator=gen, device=dev))
                        spread = spread / spread.square().mean().sqrt()
                        blk = set_path(blk, p, dict(
                            ln, w=(ln['w'].float() * spread).to(ln['w'].dtype)))
                    model.set_block(i, blk)
            return model
    return name


def compress_config(cfg_kw, method, special=None, fp8_ingest=False,
                    group_size=128, n_samples=8, seq_len=512,
                    eval_tokens=4096, eval_bs=4, seed=0):
    """The pipeline config of the ``compress`` phase: a random model from
    ``model.arch``, synthetic calibration and PPL data, W4 symmetric
    per-group weights."""
    quant = dict(method=method, weight=dict(
        bit=4, symmetric=True, granularity='per_group',
        group_size=group_size))
    if special:
        quant['special'] = dict(special)
    vocab = cfg_kw['vocab_size']
    return dict(
        base=dict(seed=seed),
        model=dict(type=_fp8_ingest_model_type() if fp8_ingest else 'Llama',
                   arch=dict(cfg_kw), seed=seed),
        calib=dict(name='synthetic', n_samples=n_samples, bs=-1,
                   seq_len=seq_len, seed=seed, vocab_size=vocab),
        eval=dict(name='synthetic', num_tokens=eval_tokens, seq_len=seq_len,
                  vocab_size=vocab, bs=eval_bs,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=quant)


NORM_SIGMA = 1.0
# The calibration set of the repository's AWQ config: 128 samples of 512
# tokens.  The 32-layer runs take 8 samples to stay inside the script's
# time limit.
AWQ_SOURCE = 'configs/quantization/methods/awq_w_only.yml'
AWQ_SOURCE_SAMPLES = 128
AWQ_SPECIAL = dict(trans=True, weight_clip=True, clip_version='v1')


def search_vs_rtn(dev, config, res, blocks):
    """What the search bought, measured outside the algorithm.  The model
    of ``config`` is built again from its seed (the weights before the
    search), the calibration batches walk through its unquantized blocks
    as they did in the block loop, and at each of ``blocks`` the squared
    error of the fake-quantized output against the unquantized block's is
    taken twice on those inputs: with the original weights (RTN) and with
    the weights the search left in ``res['model']``."""
    from llmc_tpu_torch.data import CalibDataset
    from llmc_tpu_torch.models import build_model
    model, opt = res['model'], res['opt']
    orig = build_model(config, device=dev)
    batches, _ = CalibDataset(config['calib'],
                              orig.tokenizer).get_calib_dataset()
    xs, kws = orig.collect_first_block_input(batches)
    block_fn = orig.block_fn()
    rows = []
    with torch.no_grad():
        for i in range(max(blocks) + 1):
            outs = [block_fn(orig.blocks[i], x, kw)[0]
                    for x, kw in zip(xs, kws)]
            if i in blocks:
                qmap = opt.fake_quant_qmap(i)
                n = sum(y.numel() for y in outs)
                mse = {name: sum(float(
                    ((block_fn(blk, x, kw, qmap=qmap)[0].float()
                      - y.float()) ** 2).sum())
                    for x, kw, y in zip(xs, kws, outs)) / n
                    for name, blk in (('rtn', orig.blocks[i]),
                                      ('searched', model.blocks[i]))}
                rows.append(dict(block=i, mse_rtn=mse['rtn'],
                                 mse_searched=mse['searched'],
                                 searched_over_rtn=mse['searched']
                                 / mse['rtn']))
            xs = outs
    return rows


def phase_compress(dev, cfg_kw, method, special=None, fp8_ingest=False,
                   **sizes):
    """``run_pipeline`` (build, pretrain eval, calibration data, block
    loop, transformed eval, fake-quant eval) on ``dev``; after a method
    that searches, ``search_vs_rtn`` at the first, the middle and the last
    block.  Returns the phase record and the pipeline's result (the
    compressed model and its algorithm object)."""
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    config = compress_config(cfg_kw, method, special, fp8_ingest, **sizes)
    reset_launch_counts()
    res = run_pipeline(config, device=dev)
    counts, xla = read_counts()
    ppl = {k: res[k] for k in ('ppl_pretrain', 'ppl_transformed',
                               'ppl_fake_quant')}
    drift = abs(ppl['ppl_transformed'] - ppl['ppl_pretrain']) \
        / ppl['ppl_pretrain']
    times = res['phase_times']
    calib = times[f'calib_{method}']
    L = cfg_kw['num_hidden_layers']
    searched = search_vs_rtn(dev, config, res, sorted({0, L // 2, L - 1})) \
        if special else []
    rec = dict(phase='compress', method=method, special=special or {},
               fp8_block_ingest=fp8_ingest, layers=L,
               width=cfg_kw['hidden_size'], dtype=cfg_kw['dtype'],
               calib=config['calib'], eval=config['eval'],
               weight=config['quant']['weight'], **ppl,
               ppl_transformed_rel_drift=drift,
               tolerance_ppl_transformed=TOL_PPL_TRANSFORMED,
               block_output_mse=searched,
               tolerance_searched_over_rtn=TOL_SEARCH_VS_RTN,
               phase_times_s=times, block_loop_s_per_block=calib / L,
               wall_s=res['wall_s'], launches=counts, xla_branch_calls=xla,
               ok=bool(all(np.isfinite(v) for v in ppl.values())
                       and drift <= TOL_PPL_TRANSFORMED
                       and all(r['searched_over_rtn'] <= TOL_SEARCH_VS_RTN
                               for r in searched)))
    return rec, res


def phase_compress_serve(dev, res, prompt_len=32, seed=0, **serve_kw):
    """Serve what the pipeline compressed: ``pack_model`` (fused, packed
    head) on the result's model -> ``ServingEngine`` with an int8 KV
    cache.  Before the engine runs, the packed model's logits on one
    prompt are held against the same model under the fake-quant ``QMap``
    (the head's weight fake-quantized in place first, since the packed
    head is quantized too)."""
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight
    from llmc_tpu_torch.serve import pack_model
    from llmc_tpu_torch.serve.decode import (FP_POLICY, forward_cached,
                                             init_cache)
    model, opt = res['model'], res['opt']
    cfg = model.cfg
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, prompt_len)), device=dev)

    def prefill_logits(qmap):
        # the serving forward, for both: it takes the fused layout too
        cache = init_cache(model, 1, prompt_len, device=dev)
        return forward_cached(model.params, cfg, ids, cache, FP_POLICY,
                              qmap)[0].float()

    with torch.no_grad():
        head = model.params['lm_head']
        model.params['lm_head'] = dict(
            head, w=fake_quant_weight(opt.wspec, head['w']))
        want = prefill_logits(opt.deploy('fake_quant'))
        qmap = pack_model(model, opt.wspec, fuse=True, head=True)
        got = prefill_logits(qmap)
    err, rel = _rel(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    rec = phase_serve(dev, model, qmap, **serve_kw)
    rec.update(phase='compress_serve', method=type(opt).__name__,
               prompt=prompt_len, max_abs_logit_err_vs_fake_quant=err,
               rel_logit_err_vs_fake_quant=rel,
               argmax_agreement_vs_fake_quant=agree,
               tolerance_vs_fake_quant=TOL_COMPRESS_SERVE,
               ok=bool(torch.isfinite(got).all()
                       and rel <= TOL_COMPRESS_SERVE))
    return rec


# --------------------------------------------------------------------------

MAIN_SHAPES = [(12288, 4096, False), (4096, 4096, False),
               (22016, 4096, False), (4096, 11008, False),
               (32000, 4096, True)]


PROBE_MS = (64, 77, 128, 4096)


def phase_probes(dev, Ms=PROBE_MS, K=4096, N=22016):
    """The w4 design probes through the tools' entry points at every M.
    Each tool holds each kernel against its plain version (bf16 within
    ``probe_gemm.TOL_BF16`` of the largest output, the int8 dot's int32
    equal) and raises when one is off; the launches must equal the calls
    the tools made."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.tools import kernel_bench, w4_probe
    t0 = time.perf_counter()
    reset_launch_counts()
    kb = kernel_bench.run(dev, M=Ms, K=K, N=N)
    wp = w4_probe.run(dev, M=Ms, K=K, N=N)
    counts, xla = read_counts()
    wall = time.perf_counter() - t0
    expect = dict.fromkeys(KERNEL_NAMES, 0)
    for r in kb + wp:
        if r['kernel']:
            expect[r['kernel']] += r['calls']
    return dict(phase='probes', K=K, N=N, Ms=list(Ms), wall_s=wall,
                kernel_bench=kb, w4_probe=wp, launches=counts, xla_branch_calls=xla,
                expected_launches=expect)


def probe_kernel_record(name, rec, launches, M=128):
    """The ``kernels`` line's entry of a probe: its worst errors over every
    M, its times at gate_up and M (w4_probe's line where both tools have
    one)."""
    rows = [r for r in rec['w4_probe'] + rec['kernel_bench']
            if r['kernel'] == name]
    row = next(r for r in rows if r['M'] == M)
    replaces, replaces_fn = PROBE_KERNELS[name]
    return dict(name=name, route='cuda',
                source=f'llmc_tpu_torch/csrc/{PROBE_SOURCES[name]}',
                replaces=replaces, replaces_fn=replaces_fn,
                launches=launches[name],
                max_abs_err=max(r['max_abs_err'] for r in rows),
                max_rel_err=max(r['max_rel_err'] for r in rows),
                ms=row['ms'], plain_ms=row['plain_ms'],
                bound_ms=row['bound_ms'], bound_by=row['bound_by'],
                library_ms=row['library_ms'],
                at=f'{row["name"]} N={rec["N"]} K={rec["K"]} M={M}')


def read_counts():
    """(kernel launches, calls that ran the reference's XLA branch on the
    card) since the last ``reset_launch_counts``."""
    from llmc_tpu_torch.ops import launch_counts, xla_branch_calls
    return launch_counts(), xla_branch_calls()


def require_launches(rec) -> None:
    require(rec['launches'] == rec['expected_launches'],
            f'{rec["phase"]}: launches {rec["launches"]} != expected '
            f'{rec["expected_launches"]}')
    require(rec['xla_branch_calls'] == 0,
            f'{rec["phase"]}: {rec["xla_branch_calls"]} calls ran the XLA '
            f'branch in torch ops: a weight of the path no kernel takes')


def require_served(rec) -> None:
    require(rec['all_done'], f'{rec["phase"]}: a request did not finish '
            f'with max_new_tokens valid token ids')
    require(rec['requests'] >= 8, f'{rec["phase"]}: fewer than 8 requests')
    require_launches(rec)


# instantiations: 5 token tiles x 2 outputs x (B1, B3) 1 or 2 pieces a
# step, (B4) with or without zeros x one or two groups a unit, (B6) 1 or 2
# units a step
WGMMA_KERNELS = {'w4_dequant_matmul': 20, 'w4a8_dequant_matmul': 20,
                 'w8_dequant_matmul': 40, 'fp8_block_gemm': 20}


def wgmma_build(build_info):
    """Registers and spill bytes of every instantiation of the wgmma
    kernels (B1, B3, B4, B6), from ptxas; fails on a spill or a missing
    kernel."""
    out = {}
    for name, want in WGMMA_KERNELS.items():
        insts = {k: v for k, v in build_info.get('kernels', {}).items()
                 if f'{name}_kernel' in k}
        require(len(insts) == want, f'{name}: {len(insts)} instantiations '
                f'in the ptxas report, want {want}')
        spills = {k: v for k, v in insts.items()
                  if v.get('spill_stores', 0) or v.get('spill_loads', 0)}
        require(not spills, f'{name} spills: {spills}')
        out[name] = insts
    return out


def _at(row):
    return f'N={row["N"]} K={row["K"]} M={row["M"]}'


def wgmma_summary(build, gemm, fp8_rows, probes):
    """The B1, B3, B4 and B6 entries that go before the ``kernels`` line:
    each kernel's registers and spills, its host microseconds a launch at
    every timed shape and its device time through a CUDA graph up to M=128
    (B1 beside its old design, B3 also with its quantizer), and B1's old
    design from the probes phase (``w4_current``, gate_up, M = 64, 128,
    4096)."""
    rec = {}
    for kind, name in (('w4', 'w4_dequant_matmul'),
                       ('w4a8', 'w4a8_dequant_matmul'),
                       ('w8', 'w8_dequant_matmul'),
                       ('fp8', 'fp8_block_gemm')):
        rows = [r for r in (fp8_rows if kind == 'fp8' else gemm[kind][0])
                if 'kernel_ms' in r]
        rec[name] = dict(
            registers=sorted({v['registers'] for v in build[name].values()}),
            spill_bytes=sum(v.get('spill_stores', 0) + v.get('spill_loads', 0)
                            for v in build[name].values()),
            host_us={_at(r): r['host_us'] for r in rows},
            device_ms={_at(r): r['device_ms'] for r in rows
                       if 'device_ms' in r})
    rows = [r for r in gemm['w4a8'][0] if 'kernel_ms' in r]
    rec['w4a8_dequant_matmul'].update(
        path_ms={_at(r): r['path_ms'] for r in rows},
        path_device_ms={_at(r): r['path_device_ms'] for r in rows
                        if 'path_device_ms' in r})
    rows = [r for r in gemm['w4'][0] if 'kernel_ms' in r]
    rec['w4_dequant_matmul'].update(
        old_design_host_us={_at(r): r['old_design_host_us'] for r in rows},
        old_design_device_ms={_at(r): r['old_design_device_ms'] for r in rows
                              if 'old_design_device_ms' in r},
        old_design_ms=old_design_ms(probes))
    return rec


def old_design_ms(probes):
    """``w4_current`` (B1's mma.sync design) from the probes phase at
    gate_up, M -> ms (``w4_probe``'s line)."""
    return {r['M']: r['ms'] for r in probes['w4_probe']
            if r['kernel'] == 'w4_mma_sync' and r['M'] in (64, 128, 4096)}


# the long-context profile row of W4A16 + flash: a small batch deep into a
# long cache, where a decode step is mostly attention
LONG_PROFILE = dict(B=8, prefill=1024, steps=8)


def drive_mode(mode, dev, peaks, card):
    """The model phases of one serving mode at Llama-2-7B width and depth:
    serve, throughput, profile (for W4A16 also at ``LONG_PROFILE``).
    Returns the serve phase's launches."""
    model, qmap = make_model(mode, LLAMA2_7B, dev)
    rec = phase_serve(dev, model, qmap, mode=mode)
    emit(rec)
    require_served(rec)
    launches = rec['launches']
    rec = phase_throughput(dev, model, qmap, mode=mode)
    rec.update(step_bound(model, 128, 32, 64, peaks, mode), **card)
    emit(rec)
    require_launches(rec)
    rec = phase_profile(dev, model, qmap, mode=mode)
    emit(rec)
    require_launches(rec)
    if mode == 'w4a16':
        rec = phase_profile(dev, model, qmap, mode=mode, **LONG_PROFILE)
        rec.update(step_bound(model, LONG_PROFILE['B'],
                              LONG_PROFILE['prefill'], LONG_PROFILE['steps'],
                              peaks, mode), **card)
        emit(rec)
        require_launches(rec)
    del model
    torch.cuda.empty_cache()
    return launches


def kernel_record(name, source, replaces, replaces_fn, launches, errs, row,
                  at):
    worst_abs, worst_rel = errs
    return dict(name=name, route='cuda',
                source=f'llmc_tpu_torch/csrc/{source}', replaces=replaces,
                replaces_fn=replaces_fn, launches=launches[name],
                max_abs_err=worst_abs, max_rel_err=worst_rel,
                ms=row['kernel_ms'], path_ms=row.get('path_ms'),
                plain_ms=row['plain_ms'],
                bound_ms=row['bound_ms'], bound_by=row['bound_by'],
                library_ms=row['library_ms'], at=at)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parity-seeds', type=int, nargs='+', default=[0],
                    help='seeds of the parity phase\'s random models '
                         '(default: 0; more seeds show how its errors '
                         'spread)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on the '
              'card', file=sys.stderr)
        return 2
    from llmc_tpu_torch.ops import _build
    from llmc_tpu_torch.utils.device import sm_count
    t_start = time.perf_counter()
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    card = dict(card=kind, nvidia_smi=smi)
    peak_name, peaks = peaks_for(kind)
    emit(dict(phase='device', kind=kind, count=count, nvidia_smi=smi,
              sms=sm_count(0),
              peaks=dict(table=peak_name, bytes_per_s=peaks.bw,
                         bf16_flops=peaks.bf16, f32_flops=peaks.f32,
                         int8_ops=peaks.int8, fp8_flops=peaks.fp8)))
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.lib()
    emit(dict(phase='build', wall_s=time.perf_counter() - t0,
              **_build.BUILD_INFO))
    wg_build = wgmma_build(_build.BUILD_INFO)

    # the GEMMs also at M=64 (timed: the probes' M) and M=77 (rows off
    # every token tile); B1 and B3 at group size 64 (half groups of 64
    # columns, and a single group of K=128); B4 at group sizes 64 and 32
    # (a 64-column unit in two groups)
    gemm = {kind_: check_gemm(kind_, dev, peaks, MAIN_SHAPES,
                              (1, 64, 77, 128, 4096), (1, 64, 128, 4096))
            for kind_ in ('w4', 'w4a8', 'w8')}
    gs64 = {kind_: [check_gemm(kind_, dev, peaks, shapes, (1, 77, 128),
                               timed_ms=(), gs=gs)
                    for shapes, gs in (([(22016, 4096, False),
                                         (32000, 4096, True),
                                         (4096, 128, False)], 64),
                                       ([(4096, 128, False)], 128))]
            for kind_ in ('w4', 'w4a8')}
    w8_small = [check_gemm('w8', dev, peaks, [(22016, 4096, False),
                                              (4096, 11008, False),
                                              (32000, 4096, True)],
                           (1, 77, 128), timed_ms=(), gs=gs)
                for gs in (64, 32)]
    quant = check_quant_act_token(dev, peaks)
    attn = {'flash_decode': check_attention('flash_decode', dev, peaks),
            'batch_decode': check_attention('batch_decode', dev, peaks,
                                            BATCH_SHAPES)}
    # both kernels on a float32 model's cache, at 16 query heads a kv head
    # and on a cache made by the port's KV quantizer
    attn_more = {name: [check_attention(name, dev, peaks, ATTN_F32,
                                        caches=('f32',)),
                        check_attention(name, dev, peaks, ATTN_G16,
                                        caches=('int8',)),
                        check_attention(name, dev, peaks, ATTN_KVQ,
                                        caches=('int8_kv',),
                                        tol=TOL_ATTN_KVQ)]
                 for name in attn}
    # an odd N: every GEMM kernel at N = 4095 (no multiple of 2 or of the
    # 128-row tile)
    odd_n = {kind_: check_gemm(kind_, dev, peaks, [(4095, 4096, False)],
                               (1, 77, 128), timed_ms=())
             for kind_ in ('w4', 'w4a8', 'w8')}
    fp8 = check_fp8(dev, peaks)
    fp8_ragged = check_fp8(dev, peaks, FP8_RAGGED, (1, 77, 128), timed=())
    # block sizes other than 128: 64 (two rows of ws under a CTA), 256 (a
    # block over two K steps), the whole K
    fp8_blocks = [check_fp8(dev, peaks, FP8_SHAPES[:1] + FP8_RAGGED,
                            (1, 77, 128), timed=(), bs=bs)
                  for bs in (64, 256, 'K')]
    # the whole-K block at a K whose rows are no whole 16 bytes (the codes'
    # rows padded when the weight is cast)
    fp8_blocks.append(check_fp8(dev, peaks, [(4096, 1000)], (1, 77, 128),
                                timed=(), bs='K'))
    # and those codes in contiguous 1000-byte rows (a checkpoint's, or a
    # padded cast moved by .to()), which TMA cannot read
    fp8_blocks.append(check_fp8(dev, peaks, [(4096, 1000)], (1, 77, 128),
                                timed=(), bs='K', contiguous_w=True))
    fp8_adder = fp8_adder_probe(dev)
    require(fp8_adder <= TOL_FP8_ORACLE,
            f'fp8_block_gemm on a block whose products span 20 bits: '
            f'{fp8_adder:.3g} against the float64 oracle '
            f'(limit {TOL_FP8_ORACLE})')
    emit(dict(phase='kernel_checks', sms=sm_count(0), **card,
              w4_dequant_matmul=gemm['w4'][0],
              w4_dequant_matmul_half_group_64=gs64['w4'][0][0]
              + gs64['w4'][1][0],
              w4a8_dequant_matmul=gemm['w4a8'][0],
              w4a8_dequant_matmul_half_group_64=gs64['w4a8'][0][0]
              + gs64['w4a8'][1][0],
              w4a8_worst_rel_err_vs_integer_oracle=max(
                  gemm['w4a8'][3], gs64['w4a8'][0][3], gs64['w4a8'][1][3]),
              quant_act_token=quant,
              w8_dequant_matmul=gemm['w8'][0],
              w8_dequant_matmul_gs64_gs32=w8_small[0][0] + w8_small[1][0],
              w4_w4a8_w8_odd_n={k: v[0] for k, v in odd_n.items()},
              flash_decode=attn['flash_decode'][0],
              batch_decode=attn['batch_decode'][0],
              flash_decode_f32_g16_kvq=[
                  r for rec in attn_more['flash_decode'] for r in rec[0]],
              batch_decode_f32_g16_kvq=[
                  r for rec in attn_more['batch_decode'] for r in rec[0]],
              batch_decode_sweep=sweep_batch_blocks(dev),
              fp8_block_gemm=fp8[0],
              fp8_block_gemm_ragged_n=fp8_ragged[0],
              fp8_block_gemm_block_sizes=[r for rec in fp8_blocks
                                          for r in rec[0]],
              fp8_worst_rel_err_vs_float64_oracle=max(
                  [fp8[3], fp8_ragged[3]] + [r[3] for r in fp8_blocks]),
              fp8_adder_probe_rel_err_vs_float64_oracle=fp8_adder))

    probes = phase_probes(dev)
    probes.update(card)
    emit(probes)
    require_launches(probes)

    failed = []
    for mode, seed in itertools.product(MODES, args.parity_seeds):
        rec = phase_parity(dev, torch.device('cpu'),
                           dict(LLAMA2_7B, num_hidden_layers=2), seed=seed,
                           mode=mode)
        emit(rec)
        require_launches(rec)
        failed += [] if rec['ok'] else [(mode, seed)]
    require(not failed, f'parity failed for (mode, seed) in {failed}')

    launches = dict.fromkeys(KERNEL_NAMES, 0)
    launches.update({k: probes['launches'][k] for k in PROBE_KERNELS})
    for mode in MODES:
        got = drive_mode(mode, dev, peaks, card)
        # a kernel's launches are read from the serve run of its own path
        # (the head of the W4A8 model also runs the w4 kernel: keep the
        # W4A16 path's count for it)
        launches.update({k: v for k, v in got.items()
                         if v and not launches[k]})

    model, qmap = companion_model(dev, dict(LLAMA2_7B, num_hidden_layers=8))
    for flag in ('prefill_w8', 'decode_w8'):
        rec = phase_serve(dev, model, qmap, n_requests=8, w8_flag=flag)
        emit(rec)
        require_served(rec)
    del model
    torch.cuda.empty_cache()

    rec = phase_fp8_linear(dev, LLAMA2_7B)
    rec.update(card)
    emit(rec)
    require(rec['ok'], 'fp8_linear: an FP8-block linear is off its plain '
            'version or its dense bf16 weight')
    require_launches(rec)
    launches['fp8_block_gemm'] = rec['launches']['fp8_block_gemm']

    # the compression pipeline: RTN, then AWQ (scale search + clip v1) on
    # weights that came through the FP8-block ingest; what AWQ made is
    # packed and served
    for method, special, ingest in (('RTN', None, False),
                                    ('Awq', AWQ_SPECIAL, True)):
        rec, res = phase_compress(dev, LLAMA2_7B, method, special, ingest)
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'compress {method}: a PPL is not finite, '
                f'ppl_transformed left ppl_pretrain by '
                f'{rec["ppl_transformed_rel_drift"]:.3g} '
                f'(limit {TOL_PPL_TRANSFORMED}), or a searched block errs '
                f'more than RTN: {rec["block_output_mse"]}')
        if method == 'RTN':
            del res
            torch.cuda.empty_cache()
    rec = phase_compress_serve(dev, res)
    rec.update(card)
    emit(rec)
    require(rec['ok'], f'compress_serve: packed logits are '
            f'{rec["rel_logit_err_vs_fake_quant"]:.3g} off the fake-quant '
            f'model\'s (limit {TOL_COMPRESS_SERVE})')
    require_served(rec)
    del res
    torch.cuda.empty_cache()

    # one block at the calibration size AWQ's own config asks for
    rec, res = phase_compress(dev, dict(LLAMA2_7B, num_hidden_layers=1),
                              'Awq', AWQ_SPECIAL, True,
                              n_samples=AWQ_SOURCE_SAMPLES)
    rec.update(card, calib_size_of=AWQ_SOURCE)
    emit(rec)
    require(rec['ok'], f'compress Awq at {AWQ_SOURCE_SAMPLES} samples: '
            f'{rec["block_output_mse"]}')
    del res
    torch.cuda.empty_cache()

    require(min(launches.values()) > 0,
            f'a kernel of the main paths was never launched: {launches}')

    def gemm_row(kind_):
        return next(r for r in gemm[kind_][0]
                    if (r['N'], r['M']) == (22016, 128) and r['sym'])
    at_gemm = 'gate_up N=22016 K=4096 M=128 bf16'
    emit(dict(phase='wgmma_kernels', **card,
              **wgmma_summary(wg_build, gemm, fp8[0], probes)))

    def errs(*recs):
        return [max(e) for e in zip(*(r[1:3] for r in recs))]
    quant_row = next(r for r in quant
                     if (r['M'], r['K'], r['x']) == (128, 4096, 'bfloat16'))
    at_attn = 'B=128 Smax=96 KVH=32 hd=128 int8, 64 valid'
    dm = 'llmc_tpu/ops/dequant_matmul.py'
    emit({'kernels': [
        dict(kernel_record('w4_dequant_matmul', 'dequant_matmul_w4.cu',
                           f'{dm}:189', f'{dm}::_kernel_w4', launches,
                           errs(gemm['w4'], *gs64['w4'], odd_n['w4']),
                           gemm_row('w4'),
                           at_gemm),
             old_design_ms=old_design_ms(probes)),
        kernel_record('w4a8_dequant_matmul', 'dequant_matmul_w4a8.cu',
                      f'{dm}:236', f'{dm}::_kernel_w4a8', launches,
                      errs(gemm['w4a8'], *gs64['w4a8'], odd_n['w4a8']),
                      gemm_row('w4a8'),
                      at_gemm),
        dict(kernel_record('quant_act_token', 'quant_act_token.cu',
                           f'{dm}:143', f'{dm}::_quant_act_token', launches,
                           (max(r['max_abs_err'] for r in quant), 0.0),
                           quant_row, 'M=128 K=4096 bf16'),
             replaces_note='no TPU kernel: XLA ops before the W4A8 '
                           'kernel in the reference'),
        kernel_record('w8_dequant_matmul', 'dequant_matmul_w8.cu',
                      f'{dm}:274', f'{dm}::_kernel_w8', launches,
                      errs(gemm['w8'], *w8_small, odd_n['w8']),
                      gemm_row('w8'), at_gemm),
        kernel_record('flash_decode', 'flash_decode.cu',
                      'llmc_tpu/ops/flash_decode.py:59',
                      'llmc_tpu/ops/flash_decode.py::_kernel', launches,
                      errs(attn['flash_decode'],
                           *attn_more['flash_decode']),
                      attn['flash_decode'][0][0],
                      at_attn),
        kernel_record('batch_decode', 'batch_decode.cu',
                      'llmc_tpu/ops/batch_decode.py:88',
                      'llmc_tpu/ops/batch_decode.py::_kernel', launches,
                      errs(attn['batch_decode'],
                           *attn_more['batch_decode']),
                      attn['batch_decode'][0][0],
                      at_attn),
        kernel_record('fp8_block_gemm', 'fp8_block_gemm.cu',
                      'llmc_tpu/ops/fp8_gemm.py:28',
                      'llmc_tpu/ops/fp8_gemm.py::_kernel_fp8', launches,
                      errs(fp8, fp8_ragged, *fp8_blocks), next(
                          r for r in fp8[0] if (r['N'], r['M'])
                          == (22016, 128)),
                      'N=22016 K=4096 M=128 e4m3, block 128, bf16 out'),
    ] + [probe_kernel_record(name, probes, launches)
         for name in PROBE_KERNELS]})
    emit(dict(phase='done', wall_s=time.perf_counter() - t_start, **card))
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
