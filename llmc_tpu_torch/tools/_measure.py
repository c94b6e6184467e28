"""What the two probe tools share: the operands of the JAX tools, and one
record a variant with its time on the card beside its bound."""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.dequant_matmul import (QMeta, _unfold_pre_t, dequant_matmul_plain,
                                  dequant_weight, pack_scales_t, pack_weight)
from ..ops.probe_gemm import rel_err, w4_mma_sync, within
from ..utils.device import nvidia_smi_line, peaks_for
from ..utils.profiler import cuda_ms

BF16 = torch.bfloat16
F32 = torch.float32
GS = 128   # the tools' group size, the one the kernels are written for

# Weight bytes a timed variant rotates over: the card's L2 holds 50 MB, and
# the main path reads each weight once a step, so a timing loop reads
# copies of the weight in turn (at most 8) until they pass 160 MB
ROTATE_BYTES = 160_000_000


def as_tensor(a: np.ndarray, dtype, dev) -> torch.Tensor:
    """A numpy array on ``dev`` as ``dtype`` (floats through f32)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(F32)
    return t.to(dev).to(dtype)


def w4_operands(codes: torch.Tensor, scales: torch.Tensor):
    """The tools' W4 weight from int8 codes [N, K] in -8..7 and scales
    [N, K/128]: (packed [N, K/2] uint8 group pairs, s [N, ng], the
    W4 kernels' s_t / zs_t [ng, N] and their QMeta)."""
    N, K = codes.shape
    meta = QMeta(bits=4, group_size=GS, symmetric=True, out_features=N,
                 in_features=K)
    packed, s, _ = pack_weight(codes, scales, None, meta)
    s_t, zs_t = pack_scales_t(s, None, meta)
    return packed, s, s_t, zs_t, dataclasses.replace(meta, pre_t=True)


def w4_current(x, packed, s_t, zs_t, meta_t):
    """B1's variant: the W4A16 kernel in the design the tools measured
    (``probe_gemm.w4_mma_sync``, B1 before its wgmma redesign: the kernel
    on the card), plain version, library call."""
    def library():
        w = dequant_weight(packed, *_unfold_pre_t(s_t, zs_t, meta_t)).to(BF16)
        return lambda: torch.matmul(x, w.T)
    return dict(
        kernel='w4_mma_sync',
        call=lambda p, s, z: w4_mma_sync(x, p, s, z, meta_t),
        weights=(packed, s_t, zs_t),
        plain=lambda: dequant_matmul_plain(x, packed, s_t, zs_t, meta_t,
                                           out_dtype=F32),
        library=library)


def bound(nbytes: float, ops: float, peak: str, peaks) -> tuple:
    """Least time on the card, ms: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the ``peak`` rate, and which one."""
    t_b = nbytes / peaks.bw * 1e3
    t_o = ops / getattr(peaks, peak) * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _copies(weights: Sequence[torch.Tensor]) -> list:
    size = sum(t.numel() * t.element_size() for t in weights)
    n = max(1, min(8, -(-ROTATE_BYTES // size)))
    return [tuple(weights)] + [tuple(t.clone() for t in weights)
                               for _ in range(n - 1)]


def measure(name: str, M: int, dev: torch.device, peaks, *,
            call: Callable, weights: Sequence[torch.Tensor], nbytes: float,
            ops: float, peak: str = 'bf16', kernel: Optional[str] = None,
            plain: Optional[Callable] = None,
            library: Optional[Callable] = None) -> dict:
    """One variant: ``call(*weights)`` is what is timed, ``plain()`` its
    plain version on the same inputs, ``library()`` builds the one PyTorch
    call that computes the same function.  On the card: ``ms`` (CUDA
    events, weights rotated past the L2), ``plain_ms`` and
    ``library_ms``; on the CPU they are None (not measured).  ``calls``
    counts the launches of ``kernel`` (none on the CPU)."""
    out = call(*weights)
    on_card = dev.type == 'cuda'
    rec = dict(name=name, kernel=kernel, M=M,
               calls=int(bool(kernel) and on_card))
    rec['bound_ms'], rec['bound_by'] = bound(nbytes, ops, peak, peaks)
    if plain is not None:
        want = plain()
        rec['max_abs_err'], rec['max_rel_err'] = rel_err(out, want)
        rec['ok'] = within(out, want)
        del want
    del out
    rec.update(ms=None, plain_ms=None, library_ms=None)
    if on_card:
        iters, warmup = (10 if M >= 1024 else 50), 2
        it = itertools.cycle(_copies(weights))
        rec['ms'] = cuda_ms(lambda: call(*next(it)), iters, warmup)
        rec['calls'] += (iters + warmup) if kernel else 0
        if plain is not None:
            rec['plain_ms'] = cuda_ms(plain, 2, 1)
        if library is not None:
            rec['library_ms'] = cuda_ms(library(), iters, warmup)
    return rec


def check(records) -> None:
    """Raise when a kernel disagreed with its plain version."""
    bad = [(r['name'], r['M'], r['max_rel_err']) for r in records
           if r.get('ok') is False]
    if bad:
        raise RuntimeError(f'kernels off their plain versions: {bad}')


def print_records(records, summaries) -> None:
    """The card's name and power limit, a line a record, then the JAX
    tool's line (variant -> ms) for each M."""
    name = torch.cuda.get_device_name(0)
    print(json.dumps({'device': name, 'peaks': peaks_for(name)[0],
                      'nvidia_smi': nvidia_smi_line()}), flush=True)
    for r in records:
        print(json.dumps(r), flush=True)
    for s in summaries:
        print(json.dumps(s), flush=True)
