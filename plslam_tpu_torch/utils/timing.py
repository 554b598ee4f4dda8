"""Per-stage wall-clock timing and the profiler switch (port of
``plslam_tpu/utils/timing.py``).

Device work is asynchronous: ``StageTimer.stop(stage, *block_on)`` waits
for the device (``torch.cuda.synchronize()``) when one of ``block_on`` is a
CUDA tensor, before it reads the clock. ``maybe_profile(dir)`` records a
``torch.profiler`` trace of the CPU and the CUDA device and writes it to
``dir`` as a Chrome trace (open it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0: Dict[str, float] = {}

    def start(self, stage: str) -> None:
        if self.enabled:
            self._t0[stage] = time.perf_counter()

    def stop(self, stage: str, *block_on) -> float:
        if not self.enabled:
            return 0.0
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in block_on):
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0[stage]
        self.totals[stage] += dt
        self.counts[stage] += 1
        return dt

    def summary(self) -> Dict[str, float]:
        """Mean milliseconds per stage."""
        return {k: 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}ms" for k, v in self.summary().items())


@contextlib.contextmanager
def maybe_profile(trace_dir):
    """A torch.profiler trace (CPU and, where there is one, the CUDA
    device) written to ``trace_dir``/trace.json; a no-op without a
    directory."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
