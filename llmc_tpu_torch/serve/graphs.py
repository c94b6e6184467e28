"""Captured CUDA graphs of the serving steps: the port's counterpart of the
reference's ``jax.jit`` of a decode step and of its K-step ``lax.scan``
(``llmc_tpu/serve/engine.py:254-256``, ``bench.py:238-267``).

``CapturedStep(fn, device)`` is a callable that stands for ``fn``, a step
over static buffers (tensors that it reads and writes in place, never
rebinds).  Its first call runs ``fn`` eagerly on a side stream, which
builds the kernels and fills their plan caches, and returns that run's
result: the step's real work.  Then it captures ``fn`` into one CUDA graph
(capture records kernels and runs none).  Every later call replays the
graph and returns the tensors the captured ``fn`` returned, rewritten by
the replay.  A graph that fails to capture raises; nothing falls back to
the eager step.

The kernels' launch counters (``ops.launch_counts``) are Python
increments at each wrapper's launch: the eager first run and the capture
each add one pass of ``fn``'s launches, and a replay, which runs no
Python, adds nothing.  The kernels a replay runs are counted on the
device, by the profiler (``chip_smoke.profiled_kernel_calls``).

The decode kernels' split workspace and arrival counters
(``ops/flash_decode.py::decode_scratch``) are per-device buffers that
grow: a larger shape run later frees the buffer that the graph's kernels
point at.  The step holds the buffers that were current at its capture,
so their addresses stay valid.  The GEMMs' per-call scratch and tensor
maps are captured from the graph's own memory pool and kernel parameters,
and stay put with it.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from ..ops import flash_decode


class CapturedStep:
    """``fn`` as one CUDA graph on ``device`` (see the module docstring).
    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
    steps that never run at the same time.  ``first_s``, ``gc_s`` and
    ``capture_s``: the seconds of the first call's eager run, of the
    garbage collection before the capture and of the capture, each
    synchronised; ``replays``: the calls since."""

    def __init__(self, fn: Callable, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type != 'cuda':
            raise ValueError(f'a CUDA graph needs a CUDA device, not '
                             f'{self.device}')
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.held: Dict[str, torch.Tensor] = {}
        self.first_s = self.gc_s = self.capture_s = 0.0
        self.replays = 0

    def __call__(self):
        if self.graph is None:
            return self._warm_and_capture()
        self.graph.replay()
        self.replays += 1
        return self.out

    def _warm_and_capture(self):
        if self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self.fn()
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.first_s = t1 - t0
        graph = torch.cuda.CUDAGraph()
        # a dead Python cycle that holds another CUDA graph must not be
        # collected during the capture: destroying a graph is not allowed
        # while a stream captures, and it would invalidate this capture
        gc.collect()
        t2 = time.perf_counter()
        self.gc_s = t2 - t1
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.out = self.fn()
        finally:
            if was_enabled:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t2
        self.held = dict(flash_decode._SCRATCH.get(self.device, {}))
        self.graph = graph
        self.fn = None      # a replay needs only the graph (and no cycle)
        return first
