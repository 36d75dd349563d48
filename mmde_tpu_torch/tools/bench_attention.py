#!/usr/bin/env python
"""Time the window-attention kernels at the flagship's stage shapes.

    python3 mmde_tpu_torch/tools/bench_attention.py [--tree DIR] [--reps 20] \
        [--grid bias_resident] [--windows-per-cell auto|N] \
        [--dtype bfloat16|float32] [--only packed|headsplit|slab]

Imports `mmde_tpu_torch` from DIR (default: the checkout holding this file),
so one copy of the script times two trees in turns on one card (unpack the
other tree with `git archive` into a gitignored directory and pass it as
--tree). Per stage of swin_base_v2 + decoder_v2 at 480x640, bfloat16 (or
`--dtype float32`: fp32 operands, bias and mask), masked where the stage
shifts: the packed forward as served (1 frame pair), the
forward with its log-sum-exp and the backward as trained (2 pairs); where
the tree has the head-split kernels, swin_large_v2's stage 1 the same way
(the body the tree gives the type and, where the tree has both, the FMA
body beside it);
and, where it has the slab kernels, the flagship's four stage maps through
them (float32 bias and mask, as the slab path streams them; where the tree
has the private `_fma`, the FMA body beside the body the tree gives the
type: for fp32 maps the same-card A/B of the tensor-core K8' / K9' against
the FMA ones). `--only` times one layout's kernels alone. `--grid
bias_resident` adds the single-pass backward K4 (after the forward without
log-sum-exp it follows) beside K2 at each train shape; `--windows-per-cell`
adds the packed kernels at the W the JAX rule gives for that setting (K5
where W > 1) beside W = 1 - both only where the tree has them. Each time is
the CUDA-event time of `--reps` back-to-back launches divided by their
number (after a warm-up), so host overhead between launches hides behind
the queue. Prints one JSON line per case, one line
with each compiled kernel's registers and spills as ptxas reports them,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def ptxas_summary(log: str) -> list:
    """One line per kernel of an `nvcc -Xptxas -v` log: its demangled name
    (template arguments kept, parameters dropped), registers, spills and
    shared memory."""
    names, stats, cur, spill = [], [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and cur:
            names.append(cur)
            stats.append(line.split(":", 1)[1].strip()
                         + (f"; {spill}" if spill else ""))
            cur = None
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout
        if len(out.splitlines()) == len(names):
            names = out.splitlines()
    short = [re.sub(r"\(anonymous namespace\)::|void ", "", n) for n in names]
    short = [n[:n.rfind(">(") + 1] if ">(" in n else n for n in short]
    return [f"{n}: {st}" for n, st in zip(short, stats)]


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


def _inputs(B_, N, C, nH, nW, gen, dtype="bfloat16"):
    import torch
    dev, bf = "cuda", getattr(torch, dtype)
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


def bench_packed(shape, pairs, reps, gen, grid="window_resident",
                 wpc="1", dtype="bfloat16") -> dict:
    import torch
    from mmde_tpu_torch.ops import window_attention_packed as wap
    B_, N, C, nH, nW = shape
    B_ *= pairs
    qkv, ls, bias, mask, g = _inputs(B_, N, C, nH, nW, gen, dtype)
    bias = bias.to(qkv.dtype)                   # as the models stream it
    mask = None if mask is None else mask.to(qkv.dtype)
    rec = {"kernel": "packed", "B_": B_, "N": N, "C": C, "nH": nH, "nW": nW}
    # W of the forward and the backward under --windows-per-cell (K5 where
    # W > 1), where the tree has K5
    w_f = w_b = 1
    if hasattr(wap, "windows_per_block"):
        w_f, w_b = (wap.windows_per_block(B_, N, C, nH, nW, bwd, wpc)
                    for bwd in (False, True))
    if pairs == 1:
        rec["fwd_ms"] = _time(lambda: wap._launch_forward(
            qkv, ls, bias, mask, nH, True, False), reps)
        if w_f > 1:
            rec[f"fwd_w{w_f}_ms"] = _time(lambda: wap._launch_forward(
                qkv, ls, bias, mask, nH, True, False, w=w_f), reps)
        return rec
    rec["fwd_lse_ms"] = _time(lambda: wap._launch_forward(
        qkv, ls, bias, mask, nH, True, True), reps)
    lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True)[1]
    rec["bwd_ms"] = _time(lambda: wap._launch_backward(
        qkv, ls, bias, mask, lse, g, nH, "window_resident", True), reps)
    rec["bwd_no_dbias_ms"] = _time(lambda: wap._launch_backward(
        qkv, ls, bias, mask, lse, g, nH, "window_resident", False), reps)
    if w_f > 1:
        rec[f"fwd_lse_w{w_f}_ms"] = _time(lambda: wap._launch_forward(
            qkv, ls, bias, mask, nH, True, True, w=w_f), reps)
    if w_b > 1:
        rec[f"bwd_w{w_b}_ms"] = _time(lambda: wap._launch_backward(
            qkv, ls, bias, mask, lse, g, nH, "window_resident", True,
            w=w_b), reps)
    if grid == "bias_resident" and hasattr(wap, "_launch_backward_resident"):
        rec["fwd_no_lse_ms"] = _time(lambda: wap._launch_forward(
            qkv, ls, bias, mask, nH, True, False), reps)
        rec["bwd_resident_ms"] = _time(
            lambda: wap._launch_backward_resident(qkv, ls, bias, mask, g, nH),
            reps)
    return rec


def bench_headsplit(shape, pairs, reps, gen, dtype="bfloat16") -> dict:
    """The head-split kernels (float32 bias and mask, as the stage streams
    them); where the tree has both bodies for bf16 (the private `_fma`),
    also the FMA body beside the tensor-core one (the `*_fma_ms` keys)."""
    import inspect
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    B_, N, C, nH, nW = shape
    B_ *= pairs
    qkv, ls, bias, mask, g = _inputs(B_, N, C, nH, nW, gen, dtype)
    q, k, v = qkv.reshape(B_, N, 3, nH, C // nH).permute(2, 0, 3, 1,
                                                          4).unbind(0)
    g = g.reshape(B_, N, nH, C // nH).permute(0, 2, 1, 3)
    rec = {"kernel": "headsplit", "B_": B_, "N": N, "C": C, "nH": nH,
           "nW": nW}
    bodies = {"": {}}
    if "_fma" in inspect.signature(ths._launch_forward).parameters:
        bodies["_fma"] = {"_fma": True}
    for sfx, kw in bodies.items():
        if pairs == 1:
            rec[f"fwd{sfx}_ms"] = _time(lambda: ths._launch_forward(
                q, k, v, ls, bias, mask, False, **kw), reps)
            continue
        rec[f"fwd_lse{sfx}_ms"] = _time(lambda: ths._launch_forward(
            q, k, v, ls, bias, mask, True, **kw), reps)
        lse = ths._launch_forward(q, k, v, ls, bias, mask, True, **kw)[1]
        rec[f"bwd{sfx}_ms"] = _time(lambda: ths._launch_backward(
            q, k, v, ls, bias, mask, lse, g, True, **kw), reps)
        rec[f"bwd_no_dbias{sfx}_ms"] = _time(lambda: ths._launch_backward(
            q, k, v, ls, bias, mask, lse, g, False, **kw), reps)
    return rec


def bench_slab(stage, pairs, reps, gen, dtype="bfloat16") -> dict:
    """The slab kernels on the map (float32 bias and mask, as the slab path
    streams them); where the tree has the private `_fma`, also the FMA body
    (`*_fma_ms`) beside the body the tree gives `dtype` (the tensor cores
    for either type since fp32 maps left the FMA body)."""
    import inspect
    from mmde_tpu_torch.ops import window_attention_slab as was
    Hp, Wp, C, nH, ws, masked = stage
    B, N = 2 * pairs, ws * ws
    nW = (Hp // ws) * (Wp // ws)
    qkv, ls, bias, mask, g = _inputs(B * nW, N, C, nH, nW if masked else 0,
                                     gen, dtype)
    qkv, g = qkv.reshape(B, Hp, Wp, 3 * C), g.reshape(B, Hp, Wp, C)
    rec = {"kernel": "slab", "map": [B, Hp, Wp], "B_": B * nW, "N": N,
           "C": C, "nH": nH, "nW": nW if masked else 0}
    bodies = {"": {}}
    if "_fma" in inspect.signature(was._launch_forward).parameters:
        bodies["_fma"] = {"_fma": True}
    for sfx, kw in bodies.items():
        if pairs == 1:
            rec[f"fwd{sfx}_ms"] = _time(lambda: was._launch_forward(
                qkv, ls, bias, mask, nH, ws, False, **kw), reps)
            continue
        rec[f"fwd_lse{sfx}_ms"] = _time(lambda: was._launch_forward(
            qkv, ls, bias, mask, nH, ws, True, **kw), reps)
        lse = was._launch_forward(qkv, ls, bias, mask, nH, ws, True, **kw)[1]
        rec[f"bwd{sfx}_ms"] = _time(lambda: was._launch_backward(
            qkv, ls, bias, mask, lse, g, nH, ws, True, **kw), reps)
        rec[f"bwd_no_dbias{sfx}_ms"] = _time(lambda: was._launch_backward(
            qkv, ls, bias, mask, lse, g, nH, ws, False, **kw), reps)
    return rec


# (B_ per frame pair, N, C, nH, nW) of each stage at 480x640
BASE_STAGES = ((48, 900, 128, 4, 24), (12, 900, 256, 8, 6),
               (4, 900, 512, 16, 0), (4, 225, 1024, 32, 0))
LARGE_STAGE1 = (48, 900, 192, 6, 24)
# (Hp, Wp, C, nH, ws, masked) of each stage's padded map at 480x640
BASE_SLAB_STAGES = ((120, 180, 128, 4, 30, True), (60, 90, 256, 8, 30, True),
                    (30, 60, 512, 16, 30, False),
                    (15, 30, 1024, 32, 15, False))


def _has(module: str) -> bool:
    import importlib.util
    return importlib.util.find_spec(module) is not None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)),
                   help="checkout whose mmde_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--grid", default="window_resident",
                   choices=("window_resident", "bias_resident"),
                   help="bias_resident: also time K4 at the train shapes")
    p.add_argument("--windows-per-cell", default="1",
                   help='"auto" or an int: also time the packed kernels at '
                        "the W the JAX rule gives for it (K5 where W > 1)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="the operands' type (float32: fp32 bias and mask)")
    p.add_argument("--only", default=None,
                   choices=("packed", "headsplit", "slab"),
                   help="time this layout's kernels only")
    args = p.parse_args(argv)
    if args.windows_per_cell != "auto":
        int(args.windows_per_cell)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 1
    import mmde_tpu_torch
    from mmde_tpu_torch.ops import window_attention_packed as wap
    tree = os.path.dirname(os.path.dirname(mmde_tpu_torch.__file__))
    builds = wap.build_kernels()
    print(json.dumps({"tree": tree, "ptxas": [
        ln for b in builds.values() for ln in ptxas_summary(b["log"])]}),
        flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    def wanted(layout):
        return args.only in (None, layout) and _has(
            f"mmde_tpu_torch.ops.window_attention_{layout}")

    for pairs in (1, 2):
        for shape in BASE_STAGES if wanted("packed") else ():
            rec = bench_packed(shape, pairs, args.reps, gen, args.grid,
                               args.windows_per_cell, args.dtype)
            print(json.dumps({"tree": tree, "dtype": args.dtype, **rec}),
                  flush=True)
        if wanted("headsplit"):
            rec = bench_headsplit(LARGE_STAGE1, pairs, args.reps, gen,
                                  args.dtype)
            print(json.dumps({"tree": tree, "dtype": args.dtype, **rec}),
                  flush=True)
    if wanted("slab"):
        # after the others, so that their inputs do not depend on the tree
        for pairs in (1, 2):
            for stage in BASE_SLAB_STAGES:
                rec = bench_slab(stage, pairs, args.reps, gen, args.dtype)
                print(json.dumps({"tree": tree, "dtype": args.dtype,
                                  **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
