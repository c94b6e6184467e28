"""Drive the PyTorch / H100 port (``llmc_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line, all of them on every run:

1. ``device``     the card's name, count, SM count, and nvidia-smi's name
                  and power limit (also printed raw on a line of its own).
2. ``build``      nvcc build of ``llmc_tpu_torch/csrc`` (seconds,
                  registers and spills per kernel).
3. ``kernel_checks``  each of the six hand-written kernels against its
                  plain PyTorch version on the card at the main paths'
                  shapes (the W4A8 kernel also against a float64 integer
                  oracle, the FP8-block kernel against a float64 oracle,
                  also on a block built to expose a short adder), with
                  times (CUDA events) beside the bound and a library
                  yardstick that the port never calls for that function.
                  ``kernel_ms`` is the kernel's wrapper on
                  prepared operands, ``path_ms`` the ``dequant_matmul``
                  call one linear of the main path makes (for W4A8 with
                  the activation quantizer).  Also the staged W4A8 prefill
                  beside the kernel at M=4096, and a sweep of the
                  serving-batch kernel's two launch arguments.
4. ``parity``     2 layers at Llama-2-7B width: the card (bf16, kernels)
                  against the CPU (f32, plain versions) on the same
                  random packed weights, once per serving configuration:
                  W4A16 + flash, W4A8 + batch attention, W8A16 + flash;
                  each with a control run of the card through the plain
                  linears.  ``--parity-seeds 0 1 2`` repeats it on more
                  random models; nothing else takes an option.
5. ``serve``      ``ServingEngine`` on Llama-2-7B (32 layers) with random
                  packed W4 g128 weights and an int8 KV cache; the kernel
                  launch counters must equal what the path implies.
6. ``throughput`` the reference bench's shape: B=128, prefill 32, 64
                  greedy decode steps after one warm-up prefill and step
                  (a record, not a claim).
7. ``profile``    torch.profiler over 8 decode steps at that shape: device
                  time by kernel and the device's idle share.
8. ``serve_w4a8`` + its ``throughput`` and ``profile``: the same engine
                  and bench shape with per-token int8 activations (every
                  block linear through the W4A8 kernel, the head
                  weight-only) and the serving-batch attention kernel
                  (``ATTN_IMPL='batch'``).
9. ``serve_w8`` + its ``throughput`` and ``profile``: the same on W8A16
                  per-group 128 weights (every linear through the W8
                  kernel).
10. ``serve_w8_companion``  8 layers at 7B width, a random fp model packed
                  with ``pack_model(w8_prefill=True)``: the engine once
                  with ``prefill_w8`` and once with ``decode_w8``.
11. ``fp8_linear`` one Llama-2-7B block's seven linears stored as an
                  FP8-block checkpoint stores them (e4m3 codes and one
                  inverse scale per 128 x 128 block), applied to 128 rows:
                  ``act_quant_per_group`` -> ``fp8_block_matmul``, seven
                  launches of the FP8-block kernel.
12. ``compress``  ``run_pipeline`` at Llama-2-7B width and depth (bf16,
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
13. ``compress_serve``  what AWQ made, packed (``pack_model``, fused,
                  packed head) and served by ``ServingEngine`` with an
                  int8 KV cache; its logits on one prompt against the
                  same model under the fake-quant ``QMap``.

Every phase that drives the model on the card sets the kernels' launch
counters to 0 just before its run, reads them just after, and fails
unless they equal what its path implies.  Then the ``{"kernels": [...]}``
line (each kernel's launches from the serve phase of its own path), the
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
import subprocess
import sys
import time

import numpy as np
import torch

F32 = torch.float32
BF16 = torch.bfloat16

# Llama-2-7B (the reference bench's configuration)
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, head_dim=128, dtype='bfloat16')

# Data-sheet peaks (dense): memory bytes/s, bf16 tensor-core flop/s,
# f32 CUDA-core flop/s, int8 tensor-core op/s, fp8 tensor-core flop/s.
# H100 SXM at 700 W unless the name says otherwise.
Peaks = collections.namedtuple('Peaks', 'bw bf16 f32 int8 fp8')
PEAKS = {
    'H100 SXM': Peaks(3.35e12, 989e12, 67e12, 1979e12, 1979e12),
    'H100 PCIe': Peaks(2.0e12, 756e12, 51e12, 1513e12, 1513e12),
    'H100 NVL': Peaks(3.9e12, 835e12, 60e12, 1671e12, 1671e12),
}

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


def nvidia_smi_line() -> str:
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ''


def peaks_for(name: str):
    for key in ('H100 PCIe', 'H100 NVL'):
        if key.split()[1] in name and 'H100' in name:
            return key, PEAKS[key]
    return 'H100 SXM', PEAKS['H100 SXM']


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


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
            return D._tiling(x.shape[0], meta.out_features,
                             x.shape[1] // D.W8_CHUNK, sms(case))
        return _w8_case, kernel, plain, library, tiling, path

    def tiling(case):
        x, _, _, _, meta = case
        return D.kernel_tiling(x.shape[0], meta.out_features, x.shape[1],
                               D._half_group(meta)[0], sms(case))

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
        """The wrapper on int8 codes made once per case: the quantizer is
        no part of the kernel (``path`` times the two together)."""
        x, _, s, zs, meta = case
        if memo.get('x') is not x:
            memo.update(x=x, codes=D._quant_act_token(x))
        xq, sx = memo['codes']
        return D.w4a8_dequant_matmul(xq, sx, weight, s, zs, meta, out_dtype)

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


def _rel(got, want):
    err = (got.to(want.dtype) - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def check_gemm(kind, dev, peaks, shapes, ms_list, time_it=True):
    """One dequant-matmul kernel ('w4', 'w4a8' or 'w8') at every main-path
    (N, K), each M, sym and asym.  The tolerance is TOL_W4_F32 at f32
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
                case = make(N, K, M, sym, gen, dev)
                got = kernel(case, case[1], out_dtype)
                want = plain(case)
                torch.cuda.synchronize()
                err, rel = _rel(got, want)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                                rel)
                what = f'{kind} N={N} K={K} M={M} sym={sym}'
                require(bool(torch.isfinite(got).all()) and rel <= tol,
                        f'{what}: rel err {rel:.3g} > {tol}')
                bm, splits = tiling(case)
                row = dict(N=N, K=K, M=M, sym=sym, bm=bm, splits=splits,
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
                if time_it and sym:
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
    plain_ms = cuda_ms(lambda: plain(case), 3, 1)
    lib = library(case)
    library_ms = cuda_ms(lib, iters)
    del lib, copies
    bound_ms, bound_by = gemm_bound(kind, M, N, K,
                                    4 if out_dtype == F32 else 2, peaks,
                                    has_z=kind != 'w8' or case[3] is not None)
    return dict(kernel_ms=kernel_ms, path_ms=path_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flash_inputs(dev, B=128, smax=96, kvh=32, H=32, hd=128, L=2, quant=True,
                 seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (L, B, smax, kvh, hd)
    q = torch.randn((B, H, hd), generator=gen, device=dev) / hd ** 0.5
    if quant:
        kb = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vb = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01
    else:
        kb = torch.randn(shape, generator=gen, device=dev).to(BF16)
        vb = torch.randn(shape, generator=gen, device=dev).to(BF16)
        ks = vs = None
    return q, kb, vb, ks, vs


def flash_bound(pos, kvh, hd, H, quant, peaks):
    """Least time of one decode attention: the valid rows of K and V of
    this run's positions, q, the output and pos."""
    valid = int((pos.to(torch.int64) + 1).sum())
    per_row = hd * (1 if quant else 2) + (4 if quant else 0)
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
    rnd[:len(special)] = [min(p, smax - 1) for p in special]
    every = rng.randint(0, 3, B)
    every[::8] = smax - 1
    first = rng.randint(0, 3, B)
    first[3] = smax - 1
    return {name: torch.as_tensor(v, dtype=torch.int32, device=dev)
            for name, v in (('random', rnd), ('skew_every_block', every),
                            ('skew_one_block', first))}


def check_attention(name, dev, peaks, shapes=((128, 96), (8, 1024)), kvh=32,
                    H=32, hd=128):
    """A decode-attention kernel ('flash_decode' or 'batch_decode') against
    its plain version at the bench's decode shape and at a small batch
    with a long cache, int8 and bf16 caches, over ``_attn_positions``;
    timed at the bench's mid-run state, 64 valid positions a slot (the
    first row, which the ``kernels`` line reads), and the long cache also
    at 1000."""
    if name == 'flash_decode':
        from llmc_tpu_torch.ops.flash_decode import (
            KERNEL_CHUNK as chunk, flash_decode_cuda as kernel,
            flash_decode_plain as plain)
    else:
        from llmc_tpu_torch.ops.batch_decode import (
            KERNEL_CHUNK as chunk, batch_decode_cuda as kernel,
            batch_decode_plain as plain)
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    for B, smax in shapes:
        for quant in (True, False):
            q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd,
                                             quant=quant)
            errs = {}
            for pname, pos in _attn_positions(B, smax, chunk, dev).items():
                got = kernel(q, kb, vb, ks, vs, pos, 1)
                want = plain(q, kb, vb, ks, vs, pos, 1)
                torch.cuda.synchronize()
                err, rel = _rel(got, want)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                                rel)
                require(bool(torch.isfinite(got).all()) and rel <= TOL_FLASH,
                        f'{name} B={B} Smax={smax} quant={quant} {pname}: '
                        f'rel err {rel:.3g} > {TOL_FLASH}')
                errs[pname] = rel
            # the long cache is also timed nearly full, where the kernels
            # are bound by the rows they read and not by their launch
            for valid in (64, smax - 24) if smax > 128 else (64,):
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
                                                 peaks)
                rows.append(dict(B=B, smax=smax, kvh=kvh, H=H, hd=hd,
                                 cache='int8' if quant else 'bf16',
                                 max_rel_err=max(errs.values()),
                                 rel_err_by_positions=errs,
                                 timed_valid_positions=valid,
                                 kernel_ms=kernel_ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms,
                                 bound_by=bound_by))
            del q, kb, vb, ks, vs
    return rows, worst_abs, worst_rel


def sweep_batch_blocks(dev, shapes=((128, 96, 64), (8, 1024, 64),
                                    (8, 1024, 1000)), kvh=32, H=32, hd=128):
    """The serving-batch kernel over its two launch arguments, slots a
    CTA (``b_blk``) and warps a slot (``wps``), on an int8 cache at each
    (B, Smax, valid positions a slot): one row a pair, ``picked`` on the
    pair that ``_pick_blocks`` and ``_warps_per_slot`` choose."""
    from llmc_tpu_torch.ops import batch_decode as BD
    from llmc_tpu_torch.utils.device import sm_count
    sms = sm_count(dev.index or 0)
    rows = []
    for B, smax, valid in shapes:
        q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd)
        pos = torch.full((B,), valid - 1, dtype=torch.int32, device=dev)
        bb, chunk = BD._pick_blocks(B, smax, kvh, hd, 1, sms)
        picked = (bb, BD._warps_per_slot(B, kvh, bb, sms))
        for b_blk, wps in itertools.product((1, 2, 4, 8, 16), (1, 2, 4)):
            if B % b_blk or b_blk * wps > BD.MAX_WARPS:
                continue
            it = [0]

            def kern():
                it[0] += 1
                return BD.batch_decode_cuda(q, kb, vb, ks, vs, pos,
                                            it[0] % 2, b_blk, chunk, wps)
            rows.append(dict(B=B, smax=smax, valid=valid, b_blk=b_blk,
                             wps=wps, picked=(b_blk, wps) == picked,
                             kernel_ms=cuda_ms(kern, 200, 5)))
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


def fp8_bound(M, N, K, out_bytes, peaks, bs=128):
    """Least time of one FP8-block GEMM: codes, both scale arrays and the
    output moved once, against 2*M*N*K operations at the FP8 rate."""
    kb = K // bs
    nbytes = (M * K + N * K + 4 * M * kb + 4 * -(-N // bs) * kb
              + out_bytes * M * N)
    t_b, t_o = nbytes / peaks.bw * 1e3, 2 * M * N * K / peaks.fp8 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _fp8_case(N, K, M, gen, dev):
    """(x bf16, its codes and scales, the weight's codes and scale_inv):
    random activations and weights through the port's own quantizers."""
    from llmc_tpu_torch.quant import act_quant_per_group, weight_cast_to_fp8
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    xc, xs = act_quant_per_group(x)
    wc, ws = weight_cast_to_fp8(w)
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


def check_fp8(dev, peaks, shapes=FP8_SHAPES, ms_list=(1, 77, 128, 4096),
              timed=(1, 128, 4096)):
    """The FP8-block kernel at every (N, K) and M, f32 and bf16 output,
    against its plain version and the float64 oracle.  Times by CUDA
    events at the ``timed`` Ms."""
    from llmc_tpu_torch.ops import fp8_gemm as G
    from llmc_tpu_torch.ops.dequant_matmul import _tiling
    from llmc_tpu_torch.quant import act_quant_per_group, fp8_block_matmul
    from llmc_tpu_torch.utils.device import sm_count
    gen = torch.Generator(device=dev).manual_seed(4)
    rows, worst_abs, worst_rel, worst_oracle = [], 0.0, 0.0, 0.0
    for (N, K), M in itertools.product(shapes, ms_list):
        case = _fp8_case(N, K, M, gen, dev)
        x, xc, xs, wc, ws = case
        plain = G.fp8_block_matmul_plain(xc, xs, wc, ws, out_dtype=F32)
        oracle = G.fp8_block_matmul_plain(xc, xs, wc, ws,
                                          out_dtype=torch.float64,
                                          acc_dtype=torch.float64)
        got32 = G.fp8_block_matmul_cuda(xc, xs, wc, ws, out_dtype=F32)
        got16 = G.fp8_block_matmul_cuda(xc, xs, wc, ws, out_dtype=BF16)
        torch.cuda.synchronize()
        err, rel_p = _rel(got32, plain)
        _, rel_o = _rel(got32, oracle)
        err16, rel16 = _rel(got16, plain)
        what = f'fp8_block_gemm N={N} K={K} M={M}'
        finite = bool(torch.isfinite(got32).all()
                      and torch.isfinite(got16).all())
        require(finite and rel_o <= TOL_FP8_ORACLE
                and rel_p <= TOL_FP8_ORACLE and rel16 <= TOL_W4_BF16,
                f'{what}: rel err {rel_o:.3g} vs the float64 oracle, '
                f'{rel_p:.3g} vs plain (limit {TOL_FP8_ORACLE}), bf16 output '
                f'{rel16:.3g} (limit {TOL_W4_BF16})')
        worst_abs, worst_rel = max(worst_abs, err16), max(worst_rel, rel16)
        worst_oracle = max(worst_oracle, rel_o)
        bm, splits = _tiling(M, N, K // 128, sm_count(dev.index or 0))
        row = dict(N=N, K=K, M=M, bm=bm, splits=splits,
                   f32_rel_err_oracle=rel_o, f32_rel_err_plain=rel_p,
                   max_abs_err=err16, max_rel_err=rel16)
        del plain, oracle, got32, got16
        if M in timed:
            n_copy = max(1, min(8, -(-160_000_000 // wc.numel())))
            copies = [wc] + [wc.clone() for _ in range(n_copy - 1)]
            it = [0]

            def rotating(fn):
                def call():
                    it[0] += 1
                    return fn(copies[it[0] % n_copy])
                return call
            iters = 10 if M >= 4096 else 50
            row['kernel_ms'] = cuda_ms(rotating(
                lambda w: G.fp8_block_matmul_cuda(xc, xs, w, ws)), iters)
            row['path_ms'] = cuda_ms(rotating(
                lambda w: fp8_block_matmul(*act_quant_per_group(x), w, ws)),
                iters)
            row['plain_ms'] = cuda_ms(
                lambda: G.fp8_block_matmul_plain(xc, xs, wc, ws), 2, 1)
            lib, row['library'] = _fp8_library(case)
            row['library_ms'] = cuda_ms(lib, iters)
            row['bound_ms'], row['bound_by'] = fp8_bound(M, N, K, 2, peaks)
            del lib, copies
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

KERNEL_NAMES = ('w4_dequant_matmul', 'w4a8_dequant_matmul',
                'w8_dequant_matmul', 'flash_decode', 'batch_decode',
                'fp8_block_gemm')
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
    (fused qkv, o, fused gate_up, down) through the mode's kernel and the
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
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
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
        counts = launch_counts()
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
                launches=counts, expected_launches=expected_launches(
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
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
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
        counts = launch_counts()
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
                wall_s=wall, **eng.stats, launches=counts,
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
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
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
        counts = launch_counts()
    return dict(phase='throughput', mode=mode, B=B, prefill=prefill,
                steps=steps, tokens_per_s=B * steps / dec,
                ttft_ms=ttft * 1e3, step_ms=dec / steps * 1e3,
                launches=counts, expected_launches=expected_launches(
                    cfg.num_hidden_layers, 1 + steps, steps, mode))


def phase_profile(dev, model, qmap, B=128, prefill=32, steps=8, top=12,
                  mode='w4a16'):
    """torch.profiler over ``steps`` decode steps at the bench's shape:
    device time by kernel, and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
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
        counts = launch_counts()
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
    return dict(phase='profile', mode=mode, B=B, steps=steps,
                wall_ms=wall * 1e3, device_busy_ms=busy,
                device_busy_ms_per_step=busy / steps,
                device_idle_share=max(0.0, 1 - busy / (wall * 1e3)),
                per_step_ms=wall * 1e3 / steps,
                top=[dict(kernel=k[:80], ms=dt / 1e3, calls=c)
                     for dt, k, c in rows[:top]],
                launches=counts, expected_launches=expected_launches(
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
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
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
        counts = launch_counts()
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
                launches=counts, expected_launches=expect)


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
    from llmc_tpu_torch.ops import launch_counts, reset_launch_counts
    config = compress_config(cfg_kw, method, special, fp8_ingest, **sizes)
    reset_launch_counts()
    res = run_pipeline(config, device=dev)
    counts = launch_counts()
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
               wall_s=res['wall_s'], launches=counts,
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


def require_launches(rec) -> None:
    require(rec['launches'] == rec['expected_launches'],
            f'{rec["phase"]}: launches {rec["launches"]} != expected '
            f'{rec["expected_launches"]}')


def require_served(rec) -> None:
    require(rec['all_done'], f'{rec["phase"]}: a request did not finish '
            f'with max_new_tokens valid token ids')
    require(rec['requests'] >= 8, f'{rec["phase"]}: fewer than 8 requests')
    require_launches(rec)


def drive_mode(mode, dev, peaks, card):
    """The model phases of one serving mode at Llama-2-7B width and depth:
    serve, throughput, profile.  Returns the serve phase's launches."""
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

    gemm = {kind_: check_gemm(kind_, dev, peaks, MAIN_SHAPES, (1, 128, 4096))
            for kind_ in ('w4', 'w4a8', 'w8')}
    attn = {name: check_attention(name, dev, peaks)
            for name in ('flash_decode', 'batch_decode')}
    fp8 = check_fp8(dev, peaks)
    fp8_adder = fp8_adder_probe(dev)
    require(fp8_adder <= TOL_FP8_ORACLE,
            f'fp8_block_gemm on a block whose products span 20 bits: '
            f'{fp8_adder:.3g} against the float64 oracle '
            f'(limit {TOL_FP8_ORACLE})')
    emit(dict(phase='kernel_checks', sms=sm_count(0), **card,
              w4_dequant_matmul=gemm['w4'][0],
              w4a8_dequant_matmul=gemm['w4a8'][0],
              w4a8_worst_rel_err_vs_integer_oracle=gemm['w4a8'][3],
              w8_dequant_matmul=gemm['w8'][0],
              flash_decode=attn['flash_decode'][0],
              batch_decode=attn['batch_decode'][0],
              batch_decode_sweep=sweep_batch_blocks(dev),
              fp8_block_gemm=fp8[0],
              fp8_worst_rel_err_vs_float64_oracle=fp8[3],
              fp8_adder_probe_rel_err_vs_float64_oracle=fp8_adder))

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
    at_attn = 'B=128 Smax=96 KVH=32 hd=128 int8, 64 valid'
    dm = 'llmc_tpu/ops/dequant_matmul.py'
    emit({'kernels': [
        kernel_record('w4_dequant_matmul', 'dequant_matmul_w4.cu',
                      f'{dm}:189', f'{dm}::_kernel_w4', launches,
                      gemm['w4'][1:3], gemm_row('w4'), at_gemm),
        kernel_record('w4a8_dequant_matmul', 'dequant_matmul_w4a8.cu',
                      f'{dm}:236', f'{dm}::_kernel_w4a8', launches,
                      gemm['w4a8'][1:3], gemm_row('w4a8'), at_gemm),
        kernel_record('w8_dequant_matmul', 'dequant_matmul_w8.cu',
                      f'{dm}:274', f'{dm}::_kernel_w8', launches,
                      gemm['w8'][1:3], gemm_row('w8'), at_gemm),
        kernel_record('flash_decode', 'flash_decode.cu',
                      'llmc_tpu/ops/flash_decode.py:59',
                      'llmc_tpu/ops/flash_decode.py::_kernel', launches,
                      attn['flash_decode'][1:3], attn['flash_decode'][0][0],
                      at_attn),
        kernel_record('batch_decode', 'batch_decode.cu',
                      'llmc_tpu/ops/batch_decode.py:88',
                      'llmc_tpu/ops/batch_decode.py::_kernel', launches,
                      attn['batch_decode'][1:3], attn['batch_decode'][0][0],
                      at_attn),
        kernel_record('fp8_block_gemm', 'fp8_block_gemm.cu',
                      'llmc_tpu/ops/fp8_gemm.py:28',
                      'llmc_tpu/ops/fp8_gemm.py::_kernel_fp8', launches,
                      fp8[1:3], next(r for r in fp8[0] if (r['N'], r['M'])
                                     == (22016, 128)),
                      'N=22016 K=4096 M=128 e4m3, block 128, bf16 out'),
    ]})
    emit(dict(phase='done', wall_s=time.perf_counter() - t_start, **card))
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
