#!/usr/bin/env python
"""Trace the flagship train step on the card and print its device time by
kernel group.

    python -m mmde_tpu_torch.tools.profile_step [--batch 4] [--steps 3] \\
        [--logdir DIR] [--device cuda]

Counterpart of the JAX package's tools/profile_step.py (whose groups are
XLA's op categories): the flagship (swin_base_v2 + decoder_v2, bfloat16,
480 x 640, nothing rematerialised: `train_steps.flagship_config`) trained
on one synthetic batch, two warm
steps, then `--steps` steps under torch.profiler (`utils.profiling.trace`,
whose Chrome trace lands in --logdir). Prints one JSON line: device ms a
step by kernel group (`group`: this repo's attention kernels forward /
backward / dbias, cuDNN convolutions, cuBLAS products, the optimizer's
foreach kernels, ...), the largest kernels, launches. `device_time` and
`profile_call` are what `chip_smoke.py`'s profile phases use, so the card
runs and this tool share one grouping. Raises without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import torch


def group(name: str) -> str:
    """The kernel group of a device kernel's name."""
    n = name.lower()
    if ("window_attention_fwd" in n or "fwd_tc_kernel" in n
            or "fwd_tc_w_kernel" in n):
        # K1 (FMA or tensor-core body), K6', K8', K5
        return "window_attention_fwd (this repo's kernel)"
    if "bwd_dbias" in n:
        # K3 (MMDE_ATTN_GRID=split; either body)
        return "window_attention_dbias (this repo's kernel)"
    if "bwd_dq_" in n or "bwd_dkv_" in n or "bwd_resident" in n:
        # K2 / K7' / K9' / K5's passes, K4 (any body)
        return "window_attention_bwd (this repo's kernel)"
    if "multi_tensor_apply" in n:
        return "optimizer (foreach AdamW, grad zeroing)"
    if ("fprop" in n or "implicit_gemm" in n or "conv" in n
            or "cudnn" in n or "dgrad" in n or "wgrad" in n):
        return "convolutions (cuDNN)"
    if ("gemm" in n or "cutlass" in n or "cublas" in n or "nvjet" in n
            or "xmma" in n):
        return "matrix products (cuBLAS)"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if "upsample" in n:
        return "bilinear upsample"
    if "copy_kernel" in n or "memcpy" in n or "memset" in n:
        return "copies and casts"
    return "elementwise, other"


def device_time(prof, calls: int = 1) -> dict:
    """Device time of a finished torch.profiler profile: every kernel's row
    (name, launches, device us), the total ms, launches, ms by `group` and
    the twelve largest rows; `calls` divides the totals (ms a call).
    Raises when the profile recorded no device time."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        # device-side rows only: an operator's row repeats its kernels' time,
        # and so does the optimizer's step annotation ("Optimizer.step#...")
        if (us > 0 and e.device_type == DeviceType.CUDA
                and not e.key.startswith("Optimizer.")):
            rows.append({"name": e.key[:120], "calls": e.count,
                         "device_us": us})
    rows.sort(key=lambda r: -r["device_us"])
    total = sum(r["device_us"] for r in rows)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    groups: dict = {}
    for r in rows:
        g = group(r["name"])
        groups[g] = groups.get(g, 0.0) + r["device_us"]
    return {"rows": rows, "device_ms_total": total / 1e3 / calls,
            "launches": sum(r["calls"] for r in rows) / calls,
            "device_ms_by_group": {k: v / 1e3 / calls for k, v in sorted(
                groups.items(), key=lambda kv: -kv[1])},
            "top": rows[:12]}


def profile_call(fn: Callable[[], object], logdir: Optional[str] = None,
                 calls: int = 1) -> dict:
    """`device_time` of running `fn` (`calls` times a run, for the
    division), synchronised with the card; the Chrome trace goes to
    `logdir` when one is given."""
    from mmde_tpu_torch.utils.profiling import trace
    with trace(logdir) as prof:
        fn()
    return device_time(prof, calls)


def main(argv=None) -> dict:
    from mmde_tpu_torch.models.two_frame import require_device
    from mmde_tpu_torch.tools import train_steps as ts

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4, help="frame pairs")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--logdir", default=None,
                    help="where the Chrome trace goes (default: not kept)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device, what="profile_step")
    if device.type != "cuda":
        raise RuntimeError("profile_step: device time needs a CUDA device")

    cfg = ts.flagship_config(batch_size=args.batch)
    state, step = ts.build_trainer(cfg, device=device, seed=0)
    batch = ts.synthetic_batch(args.batch, 480, 640, seed=31, device=device)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    def run():
        nonlocal state
        for _ in range(args.steps):
            state, _ = step(state, batch)

    t0 = time.perf_counter()
    rep = profile_call(run, args.logdir, calls=args.steps)
    rep["profiled_ms_host_a_step"] = (time.perf_counter() - t0) * 1e3 / \
        args.steps
    out = {k: v for k, v in rep.items() if k != "rows"}
    out.update(batch=args.batch, steps=args.steps,
               device=torch.cuda.get_device_name(device))
    if args.logdir:
        out["trace"] = os.path.join(args.logdir, "trace.json")
    print(json.dumps(out), flush=True)
    return rep


if __name__ == "__main__":
    main()
