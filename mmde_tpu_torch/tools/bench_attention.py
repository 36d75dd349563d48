#!/usr/bin/env python
"""Time the window-attention kernels at the flagship's stage shapes.

    python3 mmde_tpu_torch/tools/bench_attention.py [--tree DIR] [--reps 20]

Imports `mmde_tpu_torch` from DIR (default: the checkout holding this file),
so one copy of the script times two trees in turns on one card (unpack the
other tree with `git archive` into a gitignored directory and pass it as
--tree). Per stage of swin_base_v2 + decoder_v2 at 480x640, bfloat16, masked
where the stage shifts: the packed forward as served (1 frame pair), the
forward with its log-sum-exp and the backward as trained (2 pairs); and,
where the tree has the head-split kernels, swin_large_v2's stage 1 the same
way. Each time is the CUDA-event time of `--reps` back-to-back launches
divided by their number (after a warm-up), so host overhead between
launches hides behind the queue. Prints one JSON line per case, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _time(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _inputs(B_, N, C, nH, nW, gen):
    import torch
    dev, bf = "cuda", torch.bfloat16
    qkv = torch.randn((B_, N, 3 * C), device=dev, generator=gen).to(bf)
    ls = torch.randn((nH, 1, 1), device=dev, generator=gen) * 0.5 + 2.0
    bias = 16.0 * torch.sigmoid(torch.randn((nH, N, N), device=dev,
                                            generator=gen))
    mask = None
    if nW:
        m = torch.rand((nW, N, N), device=dev, generator=gen) < 0.3
        mask = torch.where(m, -100.0, 0.0)
    g = torch.randn((B_, N, C), device=dev, generator=gen).to(bf)
    return qkv, ls, bias, mask, g


def bench_packed(shape, pairs, reps, gen) -> dict:
    import torch
    from mmde_tpu_torch.ops import window_attention_packed as wap
    B_, N, C, nH, nW = shape
    B_ *= pairs
    qkv, ls, bias, mask, g = _inputs(B_, N, C, nH, nW, gen)
    bias = bias.to(torch.bfloat16)              # as bf16 models stream it
    mask = None if mask is None else mask.to(torch.bfloat16)
    rec = {"kernel": "packed", "B_": B_, "N": N, "C": C, "nH": nH, "nW": nW}
    if pairs == 1:
        rec["fwd_ms"] = _time(lambda: wap._launch_forward(
            qkv, ls, bias, mask, nH, True, False), reps)
        return rec
    rec["fwd_lse_ms"] = _time(lambda: wap._launch_forward(
        qkv, ls, bias, mask, nH, True, True), reps)
    lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True)[1]
    rec["bwd_ms"] = _time(lambda: wap._launch_backward(
        qkv, ls, bias, mask, lse, g, nH, "window_resident", True), reps)
    rec["bwd_no_dbias_ms"] = _time(lambda: wap._launch_backward(
        qkv, ls, bias, mask, lse, g, nH, "window_resident", False), reps)
    return rec


def bench_headsplit(shape, pairs, reps, gen) -> dict:
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    B_, N, C, nH, nW = shape
    B_ *= pairs
    qkv, ls, bias, mask, g = _inputs(B_, N, C, nH, nW, gen)
    q, k, v = qkv.reshape(B_, N, 3, nH, C // nH).permute(2, 0, 3, 1,
                                                          4).unbind(0)
    g = g.reshape(B_, N, nH, C // nH).permute(0, 2, 1, 3)
    rec = {"kernel": "headsplit", "B_": B_, "N": N, "C": C, "nH": nH,
           "nW": nW}
    if pairs == 1:
        rec["fwd_ms"] = _time(lambda: ths._launch_forward(
            q, k, v, ls, bias, mask, False), reps)
        return rec
    rec["fwd_lse_ms"] = _time(lambda: ths._launch_forward(
        q, k, v, ls, bias, mask, True), reps)
    lse = ths._launch_forward(q, k, v, ls, bias, mask, True)[1]
    rec["bwd_ms"] = _time(lambda: ths._launch_backward(
        q, k, v, ls, bias, mask, lse, g, True), reps)
    rec["bwd_no_dbias_ms"] = _time(lambda: ths._launch_backward(
        q, k, v, ls, bias, mask, lse, g, False), reps)
    return rec


# (B_ per frame pair, N, C, nH, nW) of each stage at 480x640
BASE_STAGES = ((48, 900, 128, 4, 24), (12, 900, 256, 8, 6),
               (4, 900, 512, 16, 0), (4, 225, 1024, 32, 0))
LARGE_STAGE1 = (48, 900, 192, 6, 24)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)),
                   help="checkout whose mmde_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 1
    import mmde_tpu_torch
    from mmde_tpu_torch.ops import window_attention_packed as wap
    tree = os.path.dirname(os.path.dirname(mmde_tpu_torch.__file__))
    wap.build_kernels()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    for pairs in (1, 2):
        for shape in BASE_STAGES:
            rec = bench_packed(shape, pairs, args.reps, gen)
            print(json.dumps({"tree": tree, **rec}), flush=True)
        try:
            import mmde_tpu_torch.ops.window_attention_headsplit  # noqa
        except ImportError:
            continue
        rec = bench_headsplit(LARGE_STAGE1, pairs, args.reps, gen)
        print(json.dumps({"tree": tree, **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
