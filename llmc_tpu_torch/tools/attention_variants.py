"""Time the serving-batch attention kernel B5 (``csrc/batch_decode.cu``)
as built against copies of its source with one design choice changed, on
the card.

    python -m llmc_tpu_torch.tools.attention_variants [--variants ...]
        [--caches int8 int8_kv bf16 f32]

As built, each lane of a warp loads one of the chunk's 16 K and 16 V
scales (4 bytes a position, 4 KVH bytes apart) into a register a chunk
ahead, and a row's lanes take it by a shuffle.  The variant
``scales_by_copy`` has the 32 lanes copy them by cp.async into a buffer
beside the warp's ring as the chunk's TMA boxes are issued, arriving on
the chunk's barrier, and reads them from shared memory.
``mma_one_head`` runs one query head a kv head on the tensor-core kernel
of GQA instead of the CUDA-core one.  ``f16_unscaled`` feeds q and
p v_scale of an int8 cache to that kernel's f16 products as they are,
without the powers of two that keep them in f16's normal range (on
``--caches int8_kv``, ``chip_smoke.flash_inputs``' cache made by the
port's KV quantizer, its error shows).  ``ring_3`` keeps three chunks in a
warp's ring instead of two, and ``contiguous_splits`` gives split s of a
slot a run of whole chunks instead of its chunks s, s + S, ....  Each
computes the same function; its error against the plain version is
recorded (a variant more than 2e-4 off is not timed), and both are timed
through the shipping wrapper (its split plan follows each library's own occupancy) at the rows
of ``chip_smoke.FLASH_SHAPES`` on int8 caches, or those of ``--caches``
(CUDA events over 200 launches, and through a CUDA graph), in turns:
built, variant, variant, built.  One JSON line a row, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

from ..ops import _build
from ..utils.device import nvidia_smi_line
from ..utils.profiler import cuda_ms
from .wgmma_variants import build_source

SOURCE = 'batch_decode.cu'
_COPY = '''  // the chunk's scales by cp.async into a buffer beside the rings
  __device__ float* sbuf() const {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
    const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
    return reinterpret_cast<float*>(
               smem + nw * (warp_bytes<KIND>(hd) + ST * 8)) +
           warp * ST * 32;
  }
  __device__ void copy(const float* ks, const float* vs, int KVH, int k) {
    if (KIND != 0) return;
    const int j = min(first(k) + (lane & 15), p);
    cp_async4(sbuf() + (k % ST) * 32 + lane,
              (lane < 16 ? ks : vs) + ((size_t)row0 + j) * KVH + kv);
    cp_async_arrive(&full[k % ST]);
  }
  __device__ float sread(int k, int i) const {
    return sbuf()[(k % ST) * 32 + i];
  }
  // int8: lane l < 16 holds the K scale of row l of chunk k, lane 16 + l'''
# variant -> [(text, replacement, occurrences)]
VARIANTS = {
    # the chunk's scales copied into shared memory by the 32 lanes'
    # cp.async, arriving on the chunk's barrier, instead of one register
    # load a lane and shuffles
    'scales_by_copy': [
        ('for (int i = 0; i < ST; ++i) wg::mbar_init(&full[i], 1);',
         'for (int i = 0; i < ST; ++i)\n'
         '        wg::mbar_init(&full[i], KIND == 0 ? 33 : 1);', 1),
        ('  // int8: lane l < 16 holds the K scale of row l of chunk k, '
         'lane 16 + l', _COPY, 1),
        ('  float scur = w.scale(ks, vs, KVH, 0);\n',
         '  __syncwarp();\n'
         '  for (int k = 0; k < ST && k < w.nch; ++k) w.copy(ks, vs, KVH, k);\n',
         2),
        ('    const float snext = w.scale(ks, vs, KVH, i + 1);\n', '', 2),
        ('__shfl_sync(0xffffffffu, scur, j)', 'w.sread(i, j)', 1),
        ('__shfl_sync(0xffffffffu, scur, 16 + j)', 'w.sread(i, 16 + j)', 1),
        ('__shfl_sync(0xffffffffu, scur, key)', 'w.sread(i, key)', 1),
        ('__shfl_sync(0xffffffffu, scur, 16 + key)', 'w.sread(i, 16 + key)',
         1),
        ('    scur = snext;\n',
         '    if (i + ST < w.nch) w.copy(ks, vs, KVH, i + ST);\n', 2),
        ('*smem = 128 + b_blk * (warp_bytes<KIND>(hd) + ST * 8);',
         '*smem =\n'
         '      128 + b_blk * (warp_bytes<KIND>(hd) + ST * 8 + ST * 128);',
         1)],
    # one query head a kv head on the tensor cores too (as GQA), instead
    # of the CUDA-core kernel
    'mma_one_head': [
        ('*kern = G == 1 ? batch_decode_kernel<KIND> : '
         'batch_decode_mma_kernel<KIND>;',
         '*kern = batch_decode_mma_kernel<KIND>;', 1)],
    # the int8 GQA products without the powers of two that keep q and
    # p v_scale in f16's normal range (the arithmetic is otherwise the
    # same: the scales are 2^0)
    'f16_unscaled': [
        ('const int qe = qm > 0.f ? f16_range(qm * LOG2E) : 0;',
         'const int qe = 0;', 1),
        ('  int pe = KIND == 0 ? 126 : 0;\n', '  int pe = 0;\n', 1),
        ('const int pe_new = pm > 0.f ? min(pe, f16_range(pm)) : pe;',
         'const int pe_new = pe;', 1)],
    # a deeper ring a warp: three chunks of 16 positions
    'ring_3': [('constexpr int ST = 2;', 'constexpr int ST = 3;', 1)],
    # split s takes a run of whole chunks instead of every S-th one
    'contiguous_splits': [
        ('    if (split > last) return false;\n'
         '    nch = (last - split) / S + 1;  // chunks split, split + S, ...\n'
         '    active = min(S, last + 1);     // splits with a row\n',
         '    cps = ((Smax + CH - 1) / CH + S - 1) / S;\n'
         '    if (split * cps > last) return false;\n'
         '    nch = min(cps, last + 1 - split * cps);\n'
         '    active = min(S, last / cps + 1);\n', 1),
        ('  __device__ int first(int k) const { return (split + k * S) * CH; }',
         '  __device__ int first(int k) const {\n'
         '    return (split * cps + k) * CH;\n'
         '  }', 1),
        ('  int b, kv, G, ngrp, grp, hb, GC, S, split, p, nch, active, row0, '
         'hd, lane;',
         '  int b, kv, G, ngrp, grp, hb, GC, S, split, p, nch, active, row0, '
         'hd, lane,\n      cps;', 1)],
}


def variant_source(variant: str) -> str:
    """batch_decode.cu with ``variant``'s cuts (raises when an anchor is
    not found the expected number of times)."""
    text = (_build.CSRC / SOURCE).read_text()
    for old, new, count in VARIANTS[variant]:
        if text.count(old) != count:
            raise ValueError(f'{variant}: anchor not found {count} times: '
                             f'{old!r}')
        text = text.replace(old, new)
    return text


def run(variants=tuple(VARIANTS), caches=('int8',), seed: int = 2):
    """Yields one record a row of chip_smoke's attention shapes, a cache of
    ``caches`` and a variant of ``variants``: both kernels' errors against
    the plain version and, where the variant's is within 2e-4, both timed
    in turns with the kernel as built (needs the card)."""
    import chip_smoke as C
    from ..ops.batch_decode import batch_decode_cuda, batch_decode_plain
    if not torch.cuda.is_available():
        raise RuntimeError('attention_variants: no CUDA device')
    dev = torch.device('cuda')
    built = _build.lib()
    libs = {'built': built}
    libs.update({v: build_source('batch_decode', v, SOURCE,
                                 variant_source(v)) for v in variants})
    try:
        for (B, smax, kvh, H, valids), cache in itertools.product(
                C.FLASH_SHAPES, caches):
            q, kb, vb, ks, vs = C.flash_inputs(dev, B, smax, kvh, H, 128,
                                               seed=seed, cache=cache)
            for valid in valids:
                pos = torch.full((B,), valid - 1, dtype=torch.int32,
                                 device=dev)
                it = [0]

                def kern():
                    it[0] += 1
                    return batch_decode_cuda(q, kb, vb, ks, vs, pos,
                                             it[0] % 2)
                want = batch_decode_plain(q, kb, vb, ks, vs, pos, 1)
                for variant in variants:
                    rec = dict(B=B, smax=smax, kvh=kvh, H=H, valid=valid,
                               cache=cache, variant=variant,
                               rel_err={},
                               kernel_ms={'built': [], variant: []},
                               graph_ms={'built': [], variant: []})
                    for who in ('built', variant):
                        _build._LIB = libs[who]
                        got = batch_decode_cuda(q, kb, vb, ks, vs, pos, 1)
                        rec['rel_err'][who] = C._rel(got, want)[1]
                    if rec['rel_err']['built'] > C.TOL_FLASH:
                        raise RuntimeError(f'built kernel at {rec}: rel '
                                           f'err over {C.TOL_FLASH}')
                    # a variant off the plain version is not timed
                    rec['timed'] = rec['rel_err'][variant] <= C.TOL_FLASH
                    for who in (('built', variant, variant, 'built')
                                if rec['timed'] else ()):
                        _build._LIB = libs[who]
                        rec['kernel_ms'][who].append(cuda_ms(kern, 200, 5))
                        rec['graph_ms'][who].append(C.graph_ms(kern))
                    yield rec
            del q, kb, vb, ks, vs
    finally:
        _build._LIB = built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variants', nargs='+', choices=list(VARIANTS),
                    default=list(VARIANTS))
    ap.add_argument('--caches', nargs='+',
                    choices=('int8', 'int8_kv', 'bf16', 'f32'),
                    default=['int8'])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('attention_variants: no CUDA device', file=sys.stderr)
        return 2
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': nvidia_smi_line()}), flush=True)
    for r in run(args.variants, args.caches):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
