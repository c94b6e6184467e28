"""Attribute the time of the wgmma kernels (B1, B4) to their parts on the
card.

    python -m llmc_tpu_torch.tools.wgmma_variants

Builds, beside the shipping library, copies of ``csrc/dequant_matmul_w4.cu``
and ``csrc/dequant_matmul_w8.cu`` with one part cut:

  no_decode  the weight's decode into wgmma's A fragments (a constant
             fragment; the shared-memory reads stay): the kernel without
             its CUDA-core decode
  no_wgmma   the wgmma (each fragment folded into the accumulator by one
             add): the kernel without the tensor cores

The results of a cut kernel are wrong; only its time is read.  Each is
timed through the shipping wrapper on the gate_up linear (N=22016, K=4096,
group size 128, symmetric) at each M, the weight rotated past the L2, in
turns with the kernel as built (built, cut, cut, built).  One JSON line a
kernel, variant and M, the card's name and power limit first.
"""

from __future__ import annotations

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

W4, W8 = 'dequant_matmul_w4.cu', 'dequant_matmul_w8.cu'
# kernel -> variant -> (source, [(text, replacement)])
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
            ('dequant2<HAS_Z>(w2, 0x7540, 0x7541, sc[rh], sc[2 + rh]);',
             '0x3F803F80u + (w2 & 1);'),
            ('dequant2<HAS_Z>(w2, 0x7542, 0x7543, sc[rh], sc[2 + rh]);',
             '0x3F803F80u;')],
        'no_wgmma': [
            ('wgmma_rs<T>(acc, a[ks], d + 2 * ks, 1);',
             'acc[ks] += __uint_as_float((a[ks][0] ^ a[ks][3]) & '
             '0x3FFFFFFF) + (float)(d & 1);')]}),
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


def build_variant(kernel: str, variant: str) -> ctypes.CDLL:
    """Compile one cut source into its own library (under ``build/``)."""
    source, _ = VARIANTS[kernel]
    d = _build.BUILD / 'variants' / f'{kernel}_{variant}'
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / source).write_text(variant_source(kernel, variant))
    for h in _build.CSRC.glob('*.cuh'):
        shutil.copy(h, d)
    so = d / 'lib.so'
    out = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS,
                          '-shared', '-I', str(d), str(d / source), '-o',
                          str(so)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f'nvcc failed for {kernel}/{variant}:\n'
                           f'{out.stdout[-3000:]}{out.stderr[-3000:]}')
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f'llmc_{kernel}')
    fn.argtypes = _build.SIGNATURES[f'llmc_{kernel}']
    fn.restype = ctypes.c_int
    return lib


def _operands(kernel: str, M: int, N: int, K: int, gen, dev):
    """x and the weights (as the wrapper takes them) of one linear."""
    ng = K // 128
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    s = torch.rand((ng, N), generator=gen, device=dev) * 0.01 + 0.002
    if kernel == 'w4_dequant_matmul':
        meta = D.QMeta(bits=4, group_size=128, symmetric=True,
                       out_features=N, in_features=K, pre_t=True)
        packed = torch.randint(0, 256, (N, K // 2), generator=gen,
                               device=dev, dtype=torch.uint8)
        return x, packed, (s, s * 8.0), meta
    meta = D.QMeta(bits=8, group_size=128, symmetric=True, out_features=N,
                   in_features=K)
    codes = torch.randint(-128, 128, (N, K), generator=gen, device=dev,
                          dtype=torch.int8)
    return x, codes, (s.T.contiguous() * 0.1, None), meta


def _timer(kernel, x, weight, scales, meta, gen):
    """A call of the shipping wrapper that rotates over weight copies."""
    n = max(1, min(8, -(-ROTATE_BYTES // weight.numel())))
    lo, hi = (0, 256) if weight.dtype == torch.uint8 else (-128, 128)
    copies = [weight] + [torch.randint(lo, hi, weight.shape, generator=gen,
                                       device=weight.device,
                                       dtype=weight.dtype)
                         for _ in range(n - 1)]
    wrapper = getattr(D, kernel)
    it = [0]

    def call():
        it[0] += 1
        return wrapper(x, copies[it[0] % n], *scales, meta, torch.bfloat16)
    return call


def run(Ms: Sequence[int] = (128, 4096), N: int = 22016, K: int = 4096,
        seed: int = 0) -> list:
    """The records of every kernel, variant and M (needs the card)."""
    if not torch.cuda.is_available():
        raise RuntimeError('wgmma_variants: no CUDA device')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    built = _build.lib()
    libs: Dict = {(k, v): build_variant(k, v)
                  for k in VARIANTS for v in VARIANTS[k][1]}
    recs = []
    try:
        for kernel in VARIANTS:
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
                    recs.append(dict(kernel=kernel, variant=variant, M=M, N=N,
                                     K=K, ms=ms))
                del x, weight, call
    finally:
        _build._LIB = built
    return recs


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print('wgmma_variants: no CUDA device', file=sys.stderr)
        return 2
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': nvidia_smi_line()}), flush=True)
    for r in run():
        print(json.dumps(r), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
