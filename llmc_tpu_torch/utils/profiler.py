"""Per-phase wall timers and profiler traces (port of
``llmc_tpu/utils/profiler.py``).

A phase's time is a host clock around work that ends in
``torch.cuda.synchronize()`` when a card is in use: PyTorch returns before
the device finishes, so without the synchronise a phase would be charged
to whichever later phase first waits for the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ['phase                          total_s   calls']
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f'{name:<30} {tot:8.2f}  {self.counts[name]:6d}')
        return '\n'.join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` trace (host and device) around a region, written
    as a chrome trace under ``logdir``; a no-op when ``logdir`` is None."""
    if not logdir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
