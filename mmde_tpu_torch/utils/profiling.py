"""Profiling and tracing hooks.

Counterpart of mmde_tpu/utils/profiling.py on torch.profiler:

  * `trace(logdir)`: context manager that profiles the enclosed region (CPU
    and, where there is a card, CUDA activity) and writes a Chrome trace
    (`trace.json` in `logdir`, for chrome://tracing or Perfetto); the
    profile object it yields has `key_averages()` for sums by kernel
    (tools/profile_step.py groups them);
  * `annotate(name)`: a named host span (`torch.profiler.record_function`),
    visible in the trace;
  * `StepMetrics`: step-time percentiles and images per second.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed region and export its Chrome trace to
    logdir/trace.json (None: export nothing). Where there is a CUDA
    device its activity is recorded too, and the region is synchronised
    with the card before the profile closes."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named host span, visible in profiler timelines."""
    return torch.profiler.record_function(name)


class StepMetrics:
    """Step-time statistics: mean / percentiles + images per second."""

    def __init__(self):
        self.durations: List[float] = []
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.durations.append(now - self._last)
        self._last = now

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "p99_s": float(np.percentile(d, 99)),
            "images_per_sec": float(items_per_step / d.mean()),
        }
