"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source exposes a plain C interface.  At first use
each source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one shared
library under ``llmc_tpu_torch/build/`` (git-ignored), which ``ctypes``
loads.  The library's name carries a hash of the sources, so an edited
source is rebuilt.  A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD = PKG / 'build'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as void*, every int as int
SIGNATURES = {
    # x, packed, s, zs, sums, out, partial, M, N, K, gsl, single, out_f32,
    # tok_tile, splits, stream
    'llmc_w4_dequant_matmul': [_VP] * 7 + [_I] * 8 + [_VP],
    # x, packed, s, zs, out, partial, M, N, K, gsl, single, out_f32, bm,
    # splits, stream (B1's mma.sync design, a probe)
    'llmc_w4_mma_sync': [_VP] * 6 + [_I] * 8 + [_VP],
    # q, kbuf, vbuf, ks, vs, pos, out, work, arrivals, B, H, KVH, hd, Smax,
    # L, layer, kv_kind, splits, cps, stream
    'llmc_flash_decode': [_VP] * 9 + [_I] * 10 + [_VP],
    # xq, packed, s, zs, sums, sx, out, partial, M, N, K, gsl, single,
    # out_f32, tok_tile, splits, stream
    'llmc_w4a8_dequant_matmul': [_VP] * 8 + [_I] * 8 + [_VP],
    # x, xq, sx, sums, M, K, Mp, x_f32, stream
    'llmc_quant_act_token': [_VP] * 4 + [_I] * 4 + [_VP],
    # x, codes, s, z, out, partial, M, N, K, gs, has_z, out_f32, tok_tile,
    # splits, stream
    'llmc_w8_dequant_matmul': [_VP] * 6 + [_I] * 8 + [_VP],
    # q, kbuf, vbuf, ks, vs, pos, out, work, arrivals, B, H, KVH, hd, Smax,
    # L, layer, kv_kind, b_blk, splits, stream
    'llmc_batch_decode': [_VP] * 9 + [_I] * 10 + [_VP],
    # kv_kind, G, hd, b_blk, warps (out)
    'llmc_batch_decode_occupancy': [_I] * 4 + [ctypes.POINTER(_I)],
    # x, xs, w, ws, x16, out, partial, M, N, K, block, ldw, ldx, out_f32,
    # tok_tile, splits, stream
    'llmc_fp8_block_gemm': [_VP] * 7 + [_I] * 9 + [_VP],
    # kind, x, x2, w, s, out, partial, M, N, K, splits, stream
    'llmc_probe_gemm': [_I] + [_VP] * 6 + [_I] * 4 + [_VP],
}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'llmc_tpu_torch cannot be built on this machine')
    return path


def _sources():
    return sorted(CSRC.glob('*.cu'))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob('*.cuh')):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(' '.join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _parse_ptxas(text: str) -> Dict[str, Dict]:
    """Registers and spill bytes per kernel from ``-Xptxas -v``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            out[cur]['spill_stores'] = int(m.group(1))
            out[cur]['spill_loads'] = int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out[cur]['registers'] = int(m.group(1))
            m2 = re.search(r'(\d+) bytes smem', line)
            out[cur]['smem_bytes'] = int(m2.group(1)) if m2 else 0
    return out


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = _sources()
    lib = BUILD / f'libllmc_kernels_{_digest(srcs)}.so'
    if lib.exists():
        BUILD_INFO.setdefault('cached', True)
        return lib
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for s in srcs:
        obj = BUILD / f'{s.stem}.{os.getpid()}.o'
        cmd = [nvcc, *ARCH, *FLAGS, '-I', str(CSRC), '-c', str(s),
               '-o', str(obj)]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for s, obj, p in procs:
        text = p.communicate()[0]
        logs.append(text)
        objs.append(obj)
        if p.returncode != 0:
            failed.append(f'{s.name}:\n{text[-4000:]}')
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    link = subprocess.run([nvcc, *ARCH, '-shared', '-o', str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError('nvcc link failed:\n' + link.stderr[-4000:])
    os.replace(tmp, lib)
    text = '\n'.join(logs)
    BUILD_INFO.update(cached=False, seconds=time.perf_counter() - t0,
                      kernels=_parse_ptxas(text),
                      warnings=[ln for ln in text.splitlines()
                                if 'warning' in ln.lower()],
                      sources=[s.name for s in srcs])
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        cdll = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = cdll
    return _LIB


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {err}')
