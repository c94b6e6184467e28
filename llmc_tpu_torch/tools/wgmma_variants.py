"""Attribute the time of the wgmma kernels (B1, B3, B4, B6) to their parts
on the card.

    python -m llmc_tpu_torch.tools.wgmma_variants \
        [--kernels KERNEL ...] [--M M ...]

Builds, beside the shipping library, copies of each kernel's source with
one part cut:

  no_decode     the weight's decode into wgmma's A fragments (a constant
                fragment, or for B3 the packed word unshifted; the
                shared-memory reads stay): the kernel without its CUDA-core
                decode
  no_wgmma      the wgmma (each fragment folded into the accumulator by one
                add): the kernel without the tensor cores
  no_epilogue   (B3) the scaling of each step's fresh int32 partial and
                its zero term into the f32 accumulator
  no_promotion  (B6) the f32 promotion of each scale block's fresh partial

and, for B4, two_group_lookup: the instantiation for group sizes that are
no multiple of 64 (the scales of each 32-column half looked up) run at
group size 128, where one lookup a 64-column unit serves; its result is
right, and its time is what serving every group size with it would cost.

The results of a cut kernel are wrong; only its time is read.  Each is timed
through the shipping wrapper on the gate_up linear (N=22016, K=4096, group
size 128, symmetric) at each M, the weight rotated past the L2, in turns
with the kernel as built (built, variant, variant, built).  One JSON line a
kernel, variant and M, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from typing import Dict, Sequence

import torch

from ..ops import _build
from ..utils.device import nvidia_smi_line
from ..utils.profiler import cuda_ms

D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
G = importlib.import_module('llmc_tpu_torch.ops.fp8_gemm')

W4, W8 = 'dequant_matmul_w4.cu', 'dequant_matmul_w8.cu'
W4A8, FP8 = 'dequant_matmul_w4a8.cu', 'fp8_block_gemm.cu'
# kernel -> (source, variant -> [(text, replacement)])
VARIANTS = {
    'w4_dequant_matmul': (W4, {
        'no_decode': [
            ('a[4 * q + ks][rh] = nib_pair(v, 0x4140);',
             'a[4 * q + ks][rh] = 0x3F803F80u + (v & 1);'),
            ('a[4 * q + ks][2 + rh] = nib_pair(v, 0x4342);',
             'a[4 * q + ks][2 + rh] = 0x3F803F80u;')],
        'no_wgmma': [
            ('wgmma_rs<TN>(part, a[4 * q + ks], d + 2 * ks, q + ks > 0);',
             'part[ks] += __uint_as_float((a[4 * q + ks][0] ^ '
             'a[4 * q + ks][3]) & 0x3FFFFFFF) + (float)(d & 1);')]}),
    'w8_dequant_matmul': (W8, {
        'no_decode': [
            ('dequant2<HAS_Z>(w2, 0x7540, 0x7541, c[rh], c[2 + rh]);',
             '0x3F803F80u + (w2 & 1);'),
            ('dequant2<HAS_Z>(w2, 0x7542, 0x7543, c[rh], c[2 + rh]);',
             '0x3F803F80u;')],
        'no_wgmma': [
            ('wgmma_rs<T>(acc, a[ks], d + 2 * ks, 1);',
             'acc[ks] += __uint_as_float((a[ks][0] ^ a[ks][3]) & '
             '0x3FFFFFFF) + (float)(d & 1);')],
        'two_group_lookup': [
            ('const bool g2 = gs % UNIT != 0;', 'const bool g2 = true;')]}),
    'w4a8_dequant_matmul': (W4A8, {
        'no_decode': [
            ('(frag_word(w, r0 + 8 * rh, 2 * ks, t) >> (4 * h)) &\n'
             '                  0x0F0F0F0Fu;',
             'frag_word(w, r0 + 8 * rh, 2 * ks, t);'),
            ('(frag_word(w, r0 + 8 * rh, 2 * ks + 1, t) >> (4 * h)) &\n'
             '                  0x0F0F0F0Fu;',
             'frag_word(w, r0 + 8 * rh, 2 * ks + 1, t);')],
        'no_wgmma': [
            ('wgmma_s8_rs<TN>(part, a[2 * q + ks], d + 2 * ks, q + ks > 0);',
             'part[ks] += (int)(a[2 * q + ks][0] ^ a[2 * q + ks][3]) + '
             '(int)(d & 1);')],
        'no_epilogue': [
            (''.join(f'\n            acc[c + {e}] += s{e >> 1} * '
                     f'static_cast<float>(part[4 * j + {e}]) - x{e & 1} * '
                     f'z{e >> 1};' for e in range(4)), '')]}),
    'fp8_block_gemm': (FP8, {
        'no_promotion': [
            ('\n          acc[c + 0] = fmaf(part[4 * j + 0], w0, acc[c + 0]);'
             '\n          acc[c + 1] = fmaf(part[4 * j + 1], w1, acc[c + 1]);'
             '\n          acc[c + 2] = fmaf(part[4 * j + 2], w2, acc[c + 2]);'
             '\n          acc[c + 3] = fmaf(part[4 * j + 3], w3, acc[c + 3]);',
             '')]}),
}
ROTATE_BYTES = 160_000_000


def variant_source(kernel: str, variant: str) -> str:
    """The text of ``kernel``'s source with ``variant``'s cut (raises when
    an anchor is missing, so a variant cannot silently cut nothing)."""
    source, variants = VARIANTS[kernel]
    text = (_build.CSRC / source).read_text()
    for old, new in variants[variant]:
        if text.count(old) != 1:
            raise ValueError(f'{kernel}/{variant}: anchor not found once: '
                             f'{old!r}')
        text = text.replace(old, new)
    return text


def build_source(kernel: str, variant: str, source: str,
                 text: str) -> ctypes.CDLL:
    """Compile ``text`` as ``source`` (beside the shipping headers) into its
    own library under ``build/`` and bind ``llmc_<kernel>`` (and its
    ``llmc_<kernel>_*`` helpers)."""
    d = _build.BUILD / 'variants' / f'{kernel}_{variant}'
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / source).write_text(text)
    for h in _build.CSRC.glob('*.cuh'):
        shutil.copy(h, d)
    so = d / 'lib.so'
    out = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS,
                          '-shared', '-I', str(d),
                          str(d / source), '-o', str(so)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f'nvcc failed for {kernel}/{variant}:\n'
                           f'{out.stdout[-3000:]}{out.stderr[-3000:]}')
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if name == f'llmc_{kernel}' or name.startswith(f'llmc_{kernel}_'):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_variant(kernel: str, variant: str) -> ctypes.CDLL:
    """Compile one cut source into its own library (under ``build/``)."""
    return build_source(kernel, variant, VARIANTS[kernel][0],
                        variant_source(kernel, variant))


def _operands(kernel: str, M: int, N: int, K: int, gen, dev):
    """x and the weights (as the wrapper takes them) of one linear: for
    B3, x is the quantizer kernel's (xq, sx, sums); for B6 the e4m3 codes
    and scales of x and the weight."""
    ng = K // 128
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    s = torch.rand((ng, N), generator=gen, device=dev) * 0.01 + 0.002
    if kernel == 'fp8_block_gemm':
        from ..quant import act_quant_per_group, weight_cast_to_fp8
        xc, xs = act_quant_per_group(x)
        wc, ws = weight_cast_to_fp8(
            torch.randn((N, K), generator=gen, device=dev) * 0.02)
        return (xc, xs.contiguous()), wc, (ws.contiguous(),), None
    if kernel in ('w4_dequant_matmul', 'w4a8_dequant_matmul'):
        meta = D.QMeta(bits=4, group_size=128, symmetric=True,
                       out_features=N, in_features=K, pre_t=True)
        packed = torch.randint(0, 256, (N, K // 2), generator=gen,
                               device=dev, dtype=torch.uint8)
        if kernel == 'w4a8_dequant_matmul':
            x = D.quant_act_token(x)
        return x, packed, (s, s * 8.0), meta
    meta = D.QMeta(bits=8, group_size=128, symmetric=True, out_features=N,
                   in_features=K)
    codes = torch.randint(-128, 128, (N, K), generator=gen, device=dev,
                          dtype=torch.int8)
    return x, codes, (s.T.contiguous() * 0.1, None), meta


def _call(kernel, x, weight, scales, meta, out_dtype=torch.bfloat16):
    """One call of the shipping wrapper."""
    if kernel == 'fp8_block_gemm':
        return G.fp8_block_matmul_cuda(*x, weight, *scales,
                                       out_dtype=out_dtype)
    wrapper = getattr(D, kernel)
    xs = x if isinstance(x, tuple) else (x,)
    return wrapper(*xs, weight, *scales, meta, out_dtype)


def _timer(kernel, x, weight, scales, meta, gen):
    """A call of the shipping wrapper that rotates over weight copies."""
    n = max(1, min(8, -(-ROTATE_BYTES // weight.numel())))
    if weight.dtype == torch.float8_e4m3fn:
        copies = [weight] + [weight.clone() for _ in range(n - 1)]
    else:
        lo, hi = (0, 256) if weight.dtype == torch.uint8 else (-128, 128)
        copies = [weight] + [torch.randint(lo, hi, weight.shape,
                                           generator=gen,
                                           device=weight.device,
                                           dtype=weight.dtype)
                             for _ in range(n - 1)]
    it = [0]

    def call():
        it[0] += 1
        return _call(kernel, x, copies[it[0] % n], scales, meta)
    return call


def run(Ms: Sequence[int] = (1, 128, 4096), N: int = 22016, K: int = 4096,
        seed: int = 0, kernels: Sequence[str] = tuple(VARIANTS)) -> list:
    """The records of each of ``kernels``, every variant and M (needs the
    card)."""
    if not torch.cuda.is_available():
        raise RuntimeError('wgmma_variants: no CUDA device')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    built = _build.lib()
    libs: Dict = {(k, v): build_variant(k, v)
                  for k in kernels for v in VARIANTS[k][1]}
    recs = []
    try:
        for kernel in kernels:
            for M in Ms:
                x, weight, scales, meta = _operands(kernel, M, N, K, gen,
                                                    dev)
                call = _timer(kernel, x, weight, scales, meta, gen)
                iters = 10 if M >= 1024 else 50
                for variant in VARIANTS[kernel][1]:
                    ms = {'built': [], variant: []}
                    for who in ('built', variant, variant, 'built'):
                        _build._LIB = (built if who == 'built'
                                       else libs[(kernel, variant)])
                        ms[who].append(cuda_ms(call, iters))
                    recs.append(dict(kernel=kernel, variant=variant, M=M,
                                     N=N, K=K, ms=ms))
                del x, weight, call
    finally:
        _build._LIB = built
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--kernels', nargs='+', choices=list(VARIANTS),
                    default=list(VARIANTS))
    ap.add_argument('--M', nargs='+', type=int, default=[1, 128, 4096])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('wgmma_variants: no CUDA device', file=sys.stderr)
        return 2
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': nvidia_smi_line()}), flush=True)
    for r in run(Ms=args.M, kernels=args.kernels):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
