"""What the card tools (probe_layouts, bench_attention_variants, roofline)
and chip_smoke.py share: the card's nvidia-smi line, CUDA-event timing, and
the least time a function's bytes and operations take at an H100 SXM's
published rates.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

# published H100 SXM rates at 700 W (NVIDIA's data sheet): DRAM bytes/s,
# dense flop/s by operand type; MUFU results/s (exp2, rsqrt): 16 per clock
# per SM (CUDA C++ Programming Guide, throughput table, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
FP32_OPS_PER_S = PEAK_FLOPS["float32"] / 2     # one add (or mul) a lane
MUFU_OPS_PER_S = 16 * 132 * 1.98e9


def nvidia_smi_line() -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of one call of `fn`, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound(nbytes: float, op_seconds: float = 0.0, **extra) -> dict:
    """{"bound_ms", "bound_by", ...}: the larger of the bytes' time at the
    DRAM rate and `op_seconds`, the operations' time at their peak."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = op_seconds * 1e3
    return dict(extra, bytes=nbytes, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")
