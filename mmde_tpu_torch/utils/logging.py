"""Meters, metric tables, text logs and scalar logs.

Counterpart of mmde_tpu/utils/logging.py: `AverageMeter`, `display_result`,
`log_args_to_txt`, `check_and_make_dirs`, `ProgressBar`, `ScalarWriter` and
`StepTimer`, plain Python as there. `ScalarWriter` writes TensorBoard events
through tensorboardX where that package imports, else one JSON object a
line to `scalars.jsonl` in the log directory.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class AverageMeter:
    """Running mean of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def display_result(result: Dict[str, float]) -> str:
    """The metric table, one `name: value` line a metric."""
    lines = ["\n=========================================="]
    for key, val in result.items():
        lines.append(f"{key:>18s}: {val:.6f}")
    lines.append("==========================================\n")
    return "\n".join(lines)


def log_args_to_txt(log_txt: str, args) -> None:
    """Append the full config to logs.txt."""
    with open(log_txt, "a") as f:
        f.write(repr(args) + "\n\n")


def check_and_make_dirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)


class ProgressBar:
    """ASCII progress bar with an estimate of the time left."""

    def __init__(self, total: int, width: int = 40):
        self.total = total
        self.width = width
        self.start = time.time()

    def update(self, current: int, msg: str = ""):
        frac = (current + 1) / self.total
        filled = int(self.width * frac)
        elapsed = time.time() - self.start
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        bar = "=" * filled + ">" + "." * (self.width - filled - 1)
        sys.stdout.write(f"\r[{bar}] {current + 1}/{self.total} "
                         f"eta {eta:5.0f}s {msg}")
        if current + 1 == self.total:
            sys.stdout.write("\n")
        sys.stdout.flush()


class ScalarWriter:
    """TensorBoard scalar writer (tensorboardX) with a JSONL fallback when
    that package does not import."""

    def __init__(self, log_dir: str):
        check_and_make_dirs(log_dir)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter    # type: ignore
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self._tb = SummaryWriter(logdir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


class StepTimer:
    """Items per second over the last `window` intervals between ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    def rate(self, items_per_step: int) -> float:
        if not self._times:
            return 0.0
        return items_per_step / (sum(self._times) / len(self._times))
