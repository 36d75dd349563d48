#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mmde_tpu_torch).

    python3 chip_smoke.py                 # everything, one card
    python3 chip_smoke.py --only kernels  # build + compare the kernels only
    python3 chip_smoke.py --profile p.json  # also: device time by kernel
                                            # of a request and a train step,
                                            # flagship (p.json) and
                                            # swin_large (p_large.json)

What it does, each phase printing one JSON object on a line of its own:

  env           card name and power limit (nvidia-smi), torch / CUDA / nvcc
                versions, seconds spent building the kernels from csrc/.
  kernel_cases  the window-attention kernel against its plain PyTorch
                version at the four flagship stage shapes, float32 and
                bfloat16, with and without mask: max abs / rel-L2 error,
                kernel ms and plain ms (CUDA events, warm, median), and
                the roofline bound with its bytes and flops.
  kernel_cases_backward
                the backward kernel (both ways it can sum dbias) at the
                same stage shapes for 2 and 1 frame pairs, float32 and
                bfloat16, one head at the ln(100) clamp and one hot head:
                dqkv, dbias, dlogit_scale against the plain backward and
                against float64 autograd of the plain forward; ms, plain
                ms, bound. Each case also holds the output of the forward
                that recorded the graph (the forward kernel's training entry
                point, which writes the log-sum-exp as well) against the
                plain forward, and times it. Both phases also cover the
                packed stages 2-4 of swin_large_v2.
  kernel_cases_headsplit
                the head-split forward (K6') and backward (K7') against
                their plain versions, the backward also against float64
                autograd, at every head-split stage shape of the real swin
                variants at 480x640 (swin_tiny 1-2, swin_large 1, swin_huge
                1-2) and at swin_large's train shape, float32 and bfloat16,
                masked and unmasked, one clamped and one hot head; q, k, v
                are the model's strided views of one qkv tensor. ms, plain
                ms, bound of the serving forward, the forward with
                statistics and the backward.
  serve         the flagship model (swin_base_v2 + decoder_v2, bfloat16,
                two 480x640 frames) built at full width from a seed,
                answering requests through mmde_tpu_torch.tools.infer.predict
                with the kernel launch counters read around them.
  train         the flagship trainer (mmde_tpu_torch.tools.train_steps):
                steps of make_train_step at 2 frame pairs, bfloat16, train
                mode, with the launch counters of every kernel read around
                every step; per-step loss and ms, images/s, peak memory;
                then a short deterministic run whose loss must fall.
  serve_large, train_large
                the same for swin_large_v2 + decoder_v2 (the flagship's
                windows, depths and decoder): stage 1 (C 192, 6 heads) runs
                the head-split kernels, stages 2-4 the packed ones.
  parity        the whole model, attn_impl "cuda" against "torch", same
                weights and frames, float32 and bfloat16.
  train_parity  one deterministic float32 train step, kernel path against
                plain path: loss and gradients of a named set of parameters.
  parity_large  both, float32, for swin_large_v2 (gradients of stage-1
                parameters, which only the head-split backward reaches).
  kernels       per kernel and shape of each served path (forward) and
                each trained path (forward with statistics, backward):
                launches on that path, error, ms, plain ms, bound.

then the `nvidia-smi --query-gpu=name,power.limit` line and a last line
{"ok": true, "device": {...}}. Any failing phase raises: the script exits
non-zero and prints no last line. It needs a CUDA card and imports nothing of
JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks used for the roofline bound
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # fp32 FMA outside the tensor cores
              "bfloat16": 989e12}    # dense bf16 tensor-core rate

KERNEL_SOURCE = "mmde_tpu_torch/csrc/window_attention_fwd.cu"
KERNEL_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:283 "
                   "(_fwd_body; pallas_call :454)")
KERNEL_BWD_SOURCE = "mmde_tpu_torch/csrc/window_attention_bwd.cu"
KERNEL_BWD_REPLACES = ("mmde_tpu/ops/window_attention_packed.py:473 "
                       "(_bwd_body; pallas_call :1103)")
# the head-split entry points live in the same two sources
KERNEL_HS_REPLACES = ("mmde_tpu/ops/window_attention_pallas.py:62 "
                      "(_kernel; pallas_call :132)")
KERNEL_HS_BWD_REPLACES = ("mmde_tpu/ops/window_attention_pallas.py:146 "
                          "(_bwd_kernel; pallas_call :310)")

# kernel-vs-plain tolerances on the card
TOL_FP32_MAX_ABS = 5e-5     # fp32 sums in another order + expf vs exp
TOL_BF16_REL_L2 = 4e-3      # both round one fp32 result to bf16 (2^-9 ulp)

# backward kernel vs the plain backward AND vs float64 autograd of the plain
# forward, rel-L2 per output (max abs is printed beside it).
# fp32: the kernel, the plain backward and float64 differ by the order of
# fp32 sums (and expf vs exp), and the kernel rebuilds p from the saved
# log-sum-exp: for a head at scale 100 that number is ~1e2, and half an fp32
# ulp of it (4e-6) is a relative error of every p of its row (measured:
# dqkv 8e-6 where the plain backward has 3e-6). dlogit_scale is a sum of
# B_*N*N signed terms that cancel, so its rounding shows at up to 5e-5 of
# its value.
# bf16: dqkv and dbias leave in bf16 (one rounding, 2^-9 relative, rel-L2
# ~1.1e-3 against float64 on its own) after fp32 accumulation with __expf;
# dlogit_scale is fp32 but built from bf16-rounded g, q, k, v.
TOL_BWD = {
    "float32": {"dqkv": 2e-5, "dbias": 2e-5, "dlogit_scale": 2e-4},
    "bfloat16": {"dqkv": 4e-3, "dbias": 4e-3, "dlogit_scale": 1e-2},
}

# whole-model tolerances, kernel path vs plain path (see phase_parity)
TOL_MODEL = {
    # fp32: the two paths differ only in the order of the attention sums;
    # 24 blocks amplify ~1e-6 per block
    # (measured: depth 4e-6, pose 7e-7)
    "float32": {"depth": 2e-4, "pose": 2e-5},
    # bf16: the plain path rounds the probabilities to bf16 before the
    # second product, the kernel keeps them in fp32; the difference is one
    # bf16 rounding per block carried through 24 blocks and the decoder
    # (measured at depth std 1.1: depth max 0.16, pose 0.006)
    "bfloat16": {"depth": 0.5, "depth_mean": 0.05, "pose": 0.03},
}


def emit(tag: str, obj: dict) -> None:
    print(json.dumps({tag: obj}), flush=True)


def stage_shapes(backbone: str = "swin_base_v2", h: int = 480, w: int = 640,
                 batch: int = 1):
    """(B_, N, C, nH, nW, blocks, layout) the attention kernels see per stage
    for `batch` frame pairs at h x w, re-derived from the flagship config
    with `backbone`'s widths; layout = the kernel the stage takes
    ("packed" / "headsplit", as the model chooses)."""
    from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS
    from mmde_tpu_torch.ops.window_attention_packed import packed_layout_ok
    embed, heads = SWIN_VARIANTS[backbone.split("_")[1]]
    windows, shift = (30, 30, 30, 15), (True, True, False, False)
    depths = (2, 2, 18, 2)
    out = []
    mh, mw = h // 4, w // 4
    for i in range(4):
        ws = windows[i]
        hp, wp = -(-mh // ws) * ws, -(-mw // ws) * ws
        nw = (hp // ws) * (wp // ws)
        C = embed * 2 ** i
        out.append({"model": backbone, "stage": i + 1, "map": [mh, mw],
                    "padded": [hp, wp], "B_": 2 * batch * nw, "N": ws * ws,
                    "C": C, "nH": heads[i],
                    "nW": nw if (shift[i] and depths[i] > 1) else 0,
                    "blocks": depths[i],
                    "layout": ("packed" if packed_layout_ok(
                        ws * ws, heads[i], C // heads[i], C)
                        else "headsplit")})
        mh, mw = (mh + 1) // 2, (mw + 1) // 2
    return out


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median over `reps` launches of the CUDA-event time of one call."""
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


def kernel_bound(B_, N, C, nH, nW, dtype: torch.dtype, bias_dtype,
                 stats: bool = False) -> dict:
    """Roofline bound of the forward; `stats` adds the log-sum-exp output the
    training entry point writes."""
    esz = torch.empty((), dtype=dtype).element_size()
    bsz = torch.empty((), dtype=bias_dtype).element_size()
    nbytes = (B_ * N * 3 * C * esz          # qkv read once
              + B_ * N * C * esz            # out written once
              + nH * N * N * bsz            # bias read once
              + nW * N * N * bsz            # mask read once
              + nH * 4                      # logit_scale
              + (B_ * nH * N * 4 if stats else 0))  # log-sum-exp written once
    flops = 4 * B_ * nH * N * N * (C // nH)     # two products, 2 flops/MAC
    exps = B_ * nH * N * N
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return {"bytes": nbytes, "flops": flops, "exps": exps,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def make_kernel_inputs(shape: dict, dtype, with_mask: bool, gen,
                       sigmoid_bias: bool = True):
    dev = "cuda"
    B_, N, C, nH = shape["B_"], shape["N"], shape["C"], shape["nH"]
    nW = max(shape["nW"], 2 if B_ % 2 == 0 else 1) if with_mask else 0
    qkv = torch.randn((B_, N, 3 * C), device=dev, generator=gen).to(dtype)
    ls = (torch.randn((nH, 1, 1), device=dev, generator=gen) * 0.5 + 2.0)
    ls[0] = 5.0                                    # above the ln(100) clamp
    raw = torch.randn((nH, N, N), device=dev, generator=gen)
    bias = (16.0 * torch.sigmoid(raw)) if sigmoid_bias else raw * 2.0
    bias = bias.to(dtype)                 # bf16 models stream bias in bf16
    mask = None
    if with_mask:
        m = torch.rand((nW, N, N), device=dev, generator=gen) < 0.3
        eye = torch.eye(N, device=dev, dtype=torch.bool)
        mask = torch.where(m & ~eye, -100.0, 0.0).to(dtype).contiguous()
    return qkv, ls, bias, mask


def compare_kernel(shape, dtype, with_mask, gen, *, maxfree=True,
                   timed=True) -> dict:
    from mmde_tpu_torch.ops import window_attention_packed as wap
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, with_mask, gen,
                                             sigmoid_bias=maxfree)
    nH = shape["nH"]
    with torch.no_grad():
        got = wap.cosine_window_attention_packed(qkv, ls, bias, mask,
                                                 num_heads=nH,
                                                 maxfree=maxfree)
        torch.cuda.synchronize()
        want = wap.cosine_window_attention_packed_plain(qkv, ls, bias, mask,
                                                        num_heads=nH)
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"kernel output not finite at {shape} {dtype}")
        max_abs = float((g - w).abs().max())
        rel_l2 = float((g - w).norm() / w.norm())
        rec = {"model": shape["model"], "stage": shape["stage"],
               "B_": shape["B_"], "N": shape["N"], "C": shape["C"], "nH": nH,
               "nW": mask.shape[0] if mask is not None else 0,
               "dtype": str(dtype).replace("torch.", ""),
               "softmax": "maxfree" if maxfree else "rowmax",
               "max_abs_err": max_abs, "rel_l2_err": rel_l2}
        if dtype == torch.float32:
            ok = max_abs <= TOL_FP32_MAX_ABS
            rec["tolerance"] = {"max_abs": TOL_FP32_MAX_ABS}
        else:
            ok = rel_l2 <= TOL_BF16_REL_L2
            rec["tolerance"] = {"rel_l2": TOL_BF16_REL_L2}
        if not ok:
            raise RuntimeError(f"kernel disagrees with its plain version: "
                               f"{json.dumps(rec)}")
        if timed:
            rec["ms"] = time_ms(lambda: wap.cosine_window_attention_packed(
                qkv, ls, bias, mask, num_heads=nH, maxfree=maxfree))
            rec["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH), reps=5, warm=1)
            rec.update(kernel_bound(shape["B_"], shape["N"], shape["C"], nH,
                                    rec["nW"], dtype, bias.dtype))
            rec["library_ms"] = None    # no single PyTorch call computes this
    return rec


def backward_bound(B_, N, C, nH, nW, dtype: torch.dtype, bias_dtype) -> dict:
    """Roofline bound of the backward as a function: every input read once,
    every output written once in the type it leaves in (dbias in the bias's
    type). What the design moves besides is not in the bound: the fp32
    (nH, N, N) buffer dbias is summed in before its cast, and the scratch the
    dq pass hands to the dk/dv pass (delta, 4 bytes per row, and the
    per-block partial sums of dlogit_scale)."""
    esz = torch.empty((), dtype=dtype).element_size()
    bsz = torch.empty((), dtype=bias_dtype).element_size()
    nbytes = (B_ * N * 3 * C * esz          # qkv read once
              + B_ * N * C * esz            # g read once
              + B_ * N * 3 * C * esz        # dqkv written once
              + nH * N * N * bsz            # bias read once
              + nW * N * N * bsz            # mask read once
              + B_ * nH * N * 4             # saved log-sum-exp read once
              + nH * N * N * bsz            # dbias written once
              + 2 * nH * 4)                 # logit_scale, dlogit_scale
    # five N x N x Dh products: q^k^T, g v^T, p^T g, ds k^, ds^T q^
    flops = 10 * B_ * nH * N * N * (C // nH)
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_forward(got: torch.Tensor, want: torch.Tensor, dtype,
                  where: dict) -> dict:
    """The forward kernel's output against the plain forward's, at the
    tolerances of compare_kernel; raises when they disagree."""
    g, w = got.float(), want.float()
    rec = {"max_abs_err": float((g - w).abs().max()),
           "rel_l2_err": float((g - w).norm() / w.norm())}
    if dtype == torch.float32:
        ok = rec["max_abs_err"] <= TOL_FP32_MAX_ABS
        rec["tolerance"] = {"max_abs": TOL_FP32_MAX_ABS}
    else:
        ok = rec["rel_l2_err"] <= TOL_BF16_REL_L2
        rec["tolerance"] = {"rel_l2": TOL_BF16_REL_L2}
    if not (ok and bool(torch.isfinite(g).all())):
        raise RuntimeError(f"forward kernel (training entry point) disagrees "
                           f"with its plain version: {json.dumps(rec)} at "
                           f"{json.dumps(where)}")
    return rec


def _errs(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, w = got.double(), want.double()
    return {"max_abs": float((g - w).abs().max()),
            "rel_l2": float((g - w).norm() / w.norm().clamp_min(1e-300))}


def compare_backward(shape, dtype, gen, *, timed=True) -> dict:
    """K2 (both dbias grid modes) against the plain backward and against
    float64 autograd of the plain forward, at one stage shape; and the
    output of the forward that recorded the graph (K1 through its training
    entry point, which also writes the log-sum-exp) against the plain
    forward, under rec["forward"]. Head 0 sits
    above the ln(100) clamp (its dlogit_scale must be exactly 0), head 1 is
    hot (scale e^4 = 54.6 > 30: the forward's row-maximum softmax form)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    with_mask = shape["nW"] > 0
    qkv, ls, bias, mask = make_kernel_inputs(shape, dtype, with_mask, gen)
    ls[1] = 4.0
    nH = shape["nH"]
    g = torch.randn((shape["B_"], shape["N"], shape["C"]), device="cuda",
                    generator=gen).to(dtype)
    name = str(dtype).replace("torch.", "")
    rec = {"model": shape["model"], "stage": shape["stage"],
           "B_": shape["B_"], "N": shape["N"], "C": shape["C"], "nH": nH,
           "nW": mask.shape[0] if mask is not None else 0, "dtype": name,
           "tolerance_rel_l2": TOL_BWD[name]}

    def kernel_grads(grid_mode):
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
        out = wap.cosine_window_attention_packed(
            leaves[0], leaves[1], leaves[2], mask, num_heads=nH,
            grid_mode=grid_mode)
        out.backward(g)
        torch.cuda.synchronize()
        return [t.grad for t in leaves], out.detach()

    with torch.no_grad():
        plain = wap.cosine_window_attention_packed_backward_plain(
            qkv, ls, bias, mask, g, num_heads=nH)
        want_out = wap.cosine_window_attention_packed_plain(
            qkv, ls, bias, mask, num_heads=nH)
    # independent ground truth: autograd through the plain forward, float64
    leaves64 = [t.detach().double().requires_grad_() for t in (qkv, ls, bias)]
    out64 = wap.cosine_window_attention_packed_plain(
        leaves64[0], leaves64[1], leaves64[2],
        None if mask is None else mask.double(), num_heads=nH,
        compute_dtype=torch.float64)
    truth = torch.autograd.grad(out64, leaves64, g.double())
    del out64, leaves64
    # the plain backward itself must agree with autograd, or it is no oracle
    names = ("dqkv", "dlogit_scale", "dbias")
    rec["plain_vs_float64"] = {n: _errs(p, t)
                               for n, p, t in zip(names, plain, truth)}
    for grid_mode in wap.GRID_MODES:
        got, out = kernel_grads(grid_mode)
        if grid_mode == wap.DEFAULT_GRID_MODE:
            rec["forward"] = check_forward(out, want_out, dtype, rec)
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise RuntimeError(f"backward kernel output not finite at "
                               f"{shape} {dtype} {grid_mode}")
        if float(got[1].flatten()[0]) != 0.0:
            raise RuntimeError(f"dlogit_scale of the clamped head is "
                               f"{float(got[1].flatten()[0])}, not 0")
        vs = {"vs_plain": {n: _errs(k, p)
                           for n, k, p in zip(names, got, plain)},
              "vs_float64": {n: _errs(k, t)
                             for n, k, t in zip(names, got, truth)}}
        rec[grid_mode] = vs
        for which, d in vs.items():
            for n, e in d.items():
                if not e["rel_l2"] <= TOL_BWD[name][n]:
                    raise RuntimeError(
                        f"backward kernel disagrees ({grid_mode}, {which}, "
                        f"{n}): {json.dumps(rec)}")
    dflt = rec[wap.DEFAULT_GRID_MODE]["vs_float64"]
    rec["max_abs_err"] = dflt["dqkv"]["max_abs"]
    rec["rel_l2_err"] = dflt["dqkv"]["rel_l2"]
    del truth, want_out
    if timed:
        leaves = [t.detach().clone().requires_grad_() for t in (qkv, ls, bias)]
        # the forward as training launches it (graph recorded, stats written)
        fwd = rec["forward"]
        fwd["ms"] = time_ms(lambda: wap.cosine_window_attention_packed(
            leaves[0], leaves[1], leaves[2], mask, num_heads=nH))
        with torch.no_grad():
            fwd["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_plain(
                    qkv, ls, bias, mask, num_heads=nH), reps=5, warm=1)
        fwd.update(kernel_bound(shape["B_"], shape["N"], shape["C"], nH,
                                rec["nW"], dtype, bias.dtype, stats=True))
        fwd["library_ms"] = None    # no single PyTorch call computes this
        # time the backward launch alone: forward once, backward repeatedly
        for grid_mode in wap.GRID_MODES:
            out = wap.cosine_window_attention_packed(
                leaves[0], leaves[1], leaves[2], mask, num_heads=nH,
                grid_mode=grid_mode)
            ms = time_ms(lambda: torch.autograd.grad(
                out, leaves, g, retain_graph=True), reps=8, warm=2)
            rec["ms" if grid_mode == wap.DEFAULT_GRID_MODE
                else f"ms_{grid_mode}"] = ms
        qleaf = qkv.detach().clone().requires_grad_()   # frozen RPE: no dbias
        out = wap.cosine_window_attention_packed(qleaf, ls, bias, mask,
                                                 num_heads=nH)
        rec["ms_no_dbias"] = time_ms(lambda: torch.autograd.grad(
            out, qleaf, g, retain_graph=True), reps=8, warm=2)
        with torch.no_grad():
            rec["plain_ms"] = time_ms(
                lambda: wap.cosine_window_attention_packed_backward_plain(
                    qkv, ls, bias, mask, g, num_heads=nH), reps=3, warm=1)
        rec.update(backward_bound(shape["B_"], shape["N"], shape["C"], nH,
                                  rec["nW"], dtype, bias.dtype))
        rec["library_ms"] = None    # no single PyTorch call computes this
    torch.cuda.empty_cache()
    return rec


def phase_env() -> dict:
    from mmde_tpu_torch.ops import cuda_build
    from mmde_tpu_torch.ops import window_attention_packed as wap
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.time()
    recs = wap.build_kernels()          # one nvcc per source, side by side
    env = {"nvidia_smi": smi, "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": cuda_build.nvcc_version(),
           "build_seconds": round(time.time() - t0, 3),
           "nvcc_seconds": {n: round(r["seconds"], 3)
                            for n, r in recs.items()},
           "libraries": [os.path.relpath(r["path"]) for r in recs.values()],
           # registers / spills / shared memory per kernel, as ptxas says
           "ptxas": [ln.strip() for r in recs.values()
                     for ln in r["log"].splitlines()
                     if "registers" in ln or "spill" in ln],
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit("env", env)
    return env


def packed_stages(backbone: str, batch: int = 1) -> list:
    return [s for s in stage_shapes(backbone, batch=batch)
            if s["layout"] == "packed"]


def phase_kernels(timed: bool = True) -> list:
    """K1 at the flagship's four stage shapes and swin_large's packed
    stages 2-4 (1 frame pair, as served)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    cases = []
    shapes = stage_shapes()
    for shape in shapes + packed_stages("swin_large_v2"):
        for dtype in (torch.float32, torch.bfloat16):
            for with_mask in (False, True):
                cases.append(compare_kernel(shape, dtype, with_mask, gen,
                                            timed=timed))
    # the row-maximum form (bias not bounded by 16*sigmoid), ragged N = 225
    # and N = 900, both types
    for shape in (shapes[3], shapes[2]):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(compare_kernel(shape, dtype, True, gen,
                                        maxfree=False, timed=timed))
    emit("kernel_cases", {"cases": cases,
                          "timing": "CUDA events, 3 warm + 20 launches, "
                                    "median; inputs stay in L2 between "
                                    "launches"})
    return cases


def phase_kernels_backward(timed: bool = True) -> list:
    """K2 at the four flagship stage shapes, at 2 frame pairs (what the
    train phase runs) and at 1, and at swin_large's packed stages 2-4 at 2
    pairs; float32 and bfloat16, masked where the stage shifts."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    cases = []
    for batch, shapes in (
            (2, stage_shapes(batch=2) + packed_stages("swin_large_v2", 2)),
            (1, stage_shapes(batch=1))):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                case = compare_backward(shape, dtype, gen, timed=timed)
                case["frame_pairs"] = batch
                cases.append(case)
    emit("kernel_cases_backward", {
        "cases": cases,
        "timing": "CUDA events around the backward launch (dq pass, dk/dv "
                  "pass, dbias) of an autograd graph built once; 2 warm + 8 "
                  "launches, median"})
    return cases


def headsplit_shapes() -> list:
    """Every head-split stage shape of the real swin variants at 480x640 and
    1 frame pair (swin_tiny 1-2, swin_large 1, swin_huge 1-2), and
    swin_large's stage 1 at 2 pairs, the train shape."""
    out = [dict(s, frame_pairs=1) for b in ("swin_tiny_v2", "swin_large_v2",
                                            "swin_huge_v2")
           for s in stage_shapes(b) if s["layout"] == "headsplit"]
    out += [dict(s, frame_pairs=2)
            for s in stage_shapes("swin_large_v2", batch=2)
            if s["layout"] == "headsplit"]
    return out


def make_headsplit_inputs(shape: dict, dtype, with_mask: bool, gen):
    """q, k, v as the model hands them over: strided views of one
    (B_, N, 3C) qkv tensor; g likewise a view of a (B_, N, C) gradient.
    Bias and mask float32 (head-split stages keep them so). Head 0 above
    the ln(100) clamp, head 1 hot (scale e^4 = 54.6)."""
    dev = "cuda"
    B_, N, C, nH = shape["B_"], shape["N"], shape["C"], shape["nH"]
    qkv = torch.randn((B_, N, 3 * C), device=dev, generator=gen).to(dtype)
    ls = torch.randn((nH, 1, 1), device=dev, generator=gen) * 0.5 + 2.0
    ls[0], ls[1] = 5.0, 4.0
    bias = 16.0 * torch.sigmoid(torch.randn((nH, N, N), device=dev,
                                            generator=gen))
    mask = None
    if with_mask:
        m = torch.rand((shape["nW"], N, N), device=dev, generator=gen) < 0.3
        eye = torch.eye(N, device=dev, dtype=torch.bool)
        mask = torch.where(m & ~eye, -100.0, 0.0).contiguous()
    g = torch.randn((B_, N, C), device=dev, generator=gen).to(dtype)
    g = g.reshape(B_, N, nH, C // nH).permute(0, 2, 1, 3)
    return qkv, ls, bias, mask, g


def _views(qkv, nH):
    B_, N, C3 = qkv.shape
    return qkv.reshape(B_, N, 3, nH, C3 // 3 // nH).permute(2, 0, 3, 1,
                                                            4).unbind(0)


def compare_headsplit(shape: dict, dtype, with_mask: bool, gen,
                      timed: bool = True) -> dict:
    """K6' (serving entry, and the training entry that also writes the
    log-sum-exp) against the plain forward; K7' against the plain backward
    and against float64 autograd of the plain forward, at K1 / K2's
    tolerances. Gradients are taken through the model's views, into one
    (B_, N, 3C) dqkv."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    qkv, ls, bias, mask, g = make_headsplit_inputs(shape, dtype, with_mask,
                                                   gen)
    nH = shape["nH"]
    q, k, v = _views(qkv, nH)
    if not all(ths.rows_layout_ok(t) for t in (q, k, v, g)):
        raise RuntimeError(f"the model's views need a copy at {shape}")
    name = str(dtype).replace("torch.", "")
    rec = {"model": shape["model"], "stage": shape["stage"],
           "frame_pairs": shape["frame_pairs"], "B_": shape["B_"],
           "N": shape["N"], "C": shape["C"], "nH": nH,
           "nW": mask.shape[0] if mask is not None else 0, "dtype": name,
           "tolerance_rel_l2": TOL_BWD[name]}
    with torch.no_grad():
        want = ths.cosine_window_attention_headsplit_plain(q, k, v, ls, bias,
                                                           mask)
        got = ths.cosine_window_attention_headsplit(q, k, v, ls, bias, mask)
        torch.cuda.synchronize()
        rec["forward"] = check_forward(got, want, dtype, rec)

    leaves = [qkv.detach().clone().requires_grad_(), ls.clone()
              .requires_grad_(), bias.clone().requires_grad_()]
    out = ths.cosine_window_attention_headsplit(*_views(leaves[0], nH),
                                                leaves[1], leaves[2], mask)
    rec["forward_stats"] = check_forward(out.detach(), want, dtype, rec)
    out.backward(g)
    torch.cuda.synchronize()
    got = [t.grad for t in leaves]
    del out, want
    with torch.no_grad():
        dq, dk, dv, dls, dbias = \
            ths.cosine_window_attention_headsplit_backward_plain(
                q, k, v, ls, bias, mask, g)
        plain = [torch.stack([dq, dk, dv], 2).permute(0, 3, 2, 1, 4)
                 .reshape(qkv.shape), dls, dbias]
        del dq, dk, dv
    leaves64 = [t.detach().double().requires_grad_() for t in (qkv, ls,
                                                               bias)]
    out64 = ths.cosine_window_attention_headsplit_plain(
        *_views(leaves64[0], nH), leaves64[1], leaves64[2],
        None if mask is None else mask.double(), compute_dtype=torch.float64)
    truth = torch.autograd.grad(out64, leaves64, g.double())
    del out64, leaves64
    names = ("dqkv", "dlogit_scale", "dbias")
    rec["plain_vs_float64"] = {n: _errs(p, t)
                               for n, p, t in zip(names, plain, truth)}
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise RuntimeError(f"head-split backward not finite at {rec}")
    if float(got[1].flatten()[0]) != 0.0:
        raise RuntimeError(f"dlogit_scale of the clamped head is "
                           f"{float(got[1].flatten()[0])}, not 0")
    rec["vs_plain"] = {n: _errs(a, b) for n, a, b in zip(names, got, plain)}
    rec["vs_float64"] = {n: _errs(a, b) for n, a, b in zip(names, got, truth)}
    for which in ("vs_plain", "vs_float64"):
        for n, e in rec[which].items():
            if not e["rel_l2"] <= TOL_BWD[name][n]:
                raise RuntimeError(f"head-split backward disagrees ({which}, "
                                   f"{n}): {json.dumps(rec)}")
    rec["max_abs_err"] = rec["vs_float64"]["dqkv"]["max_abs"]
    rec["rel_l2_err"] = rec["vs_float64"]["dqkv"]["rel_l2"]
    del got, plain, truth, leaves
    if timed:
        nW = rec["nW"]
        fwd, fst = rec["forward"], rec["forward_stats"]
        with torch.no_grad():
            fwd["ms"] = time_ms(lambda: ths.cosine_window_attention_headsplit(
                q, k, v, ls, bias, mask))
            fwd["plain_ms"] = time_ms(
                lambda: ths.cosine_window_attention_headsplit_plain(
                    q, k, v, ls, bias, mask), reps=5, warm=1)
            fst["ms"] = time_ms(lambda: ths._launch_forward(
                q, k, v, ls, bias, mask, want_stats=True))
            fst["plain_ms"] = fwd["plain_ms"]
            lse = ths._launch_forward(q, k, v, ls, bias, mask,
                                      want_stats=True)[1]
            # the backward entry alone (its three passes, the dbias buffer
            # and the dlogit_scale sum), on the forward's saved statistics
            rec["ms"] = time_ms(lambda: ths._launch_backward(
                q, k, v, ls, bias, mask, lse, g, want_dbias=True),
                reps=8, warm=2)
            rec["ms_no_dbias"] = time_ms(lambda: ths._launch_backward(
                q, k, v, ls, bias, mask, lse, g, want_dbias=False),
                reps=8, warm=2)
            rec["plain_ms"] = time_ms(
                lambda: ths.cosine_window_attention_headsplit_backward_plain(
                    q, k, v, ls, bias, mask, g), reps=3, warm=1)
        for r, stats in ((fwd, False), (fst, True)):
            r.update(kernel_bound(shape["B_"], shape["N"], shape["C"], nH, nW,
                                  dtype, torch.float32, stats=stats))
            r["library_ms"] = None  # no single PyTorch call computes this
        rec.update(backward_bound(shape["B_"], shape["N"], shape["C"], nH,
                                  nW, dtype, torch.float32))
        rec["library_ms"] = None
    torch.cuda.empty_cache()
    return rec


def phase_kernels_headsplit(timed: bool = True) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    cases = []
    for shape in headsplit_shapes():
        for dtype in (torch.float32, torch.bfloat16):
            for with_mask in (False, True):     # every such stage shifts
                cases.append(compare_headsplit(shape, dtype, with_mask, gen,
                                               timed=timed))
    emit("kernel_cases_headsplit", {
        "cases": cases,
        "timing": "CUDA events, median: serving forward 3 warm + 20, "
                  "forward with statistics the same, backward entry 2 warm "
                  "+ 8; inputs stay in L2 between launches"})
    return cases


def randomize_weights(model, seed: int) -> None:
    """Fill the model from a seeded generator at scales that keep
    activations O(1) through the network: the package's own init (conv std
    0.001, identity BatchNorm) yields a near-constant depth map of
    max_depth/2, on which any comparison passes vacuously."""
    import torch.nn as nn
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(shape, std=1.0, mean=0.0):
        return torch.randn(tuple(shape), device=dev, generator=gen) * std + mean

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                gain = math.sqrt(2.0) if isinstance(m, nn.Conv2d) else 1.0
                m.weight.copy_(randn(m.weight.shape, gain / math.sqrt(fan_in)))
                if m.bias is not None:
                    m.bias.copy_(randn(m.bias.shape, 0.1))
            elif isinstance(m, nn.ConvTranspose2d):
                # each output pixel of a stride-2 deconv sums in_ch * (k/2)^2
                fan_in = m.weight.shape[0] * max(
                    (m.weight.shape[2] // 2) ** 2, 1)
                m.weight.copy_(randn(m.weight.shape,
                                     math.sqrt(2.0 / fan_in)))
            elif isinstance(m, nn.LayerNorm):
                m.weight.copy_(randn(m.weight.shape, 0.1, 1.0))
                m.bias.copy_(randn(m.bias.shape, 0.1))
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(randn(m.weight.shape, 0.1, 1.0))
                m.bias.copy_(randn(m.bias.shape, 0.1))
                m.running_mean.copy_(randn(m.running_mean.shape, 0.1))
                m.running_var.copy_(torch.rand(
                    tuple(m.running_var.shape), device=dev,
                    generator=gen) + 0.5)
        for name, p in model.named_parameters():
            if name.endswith(("q_bias", "v_bias")):
                p.copy_(randn(p.shape, 0.1))
            elif name.endswith("logit_scale"):
                p.copy_(randn(p.shape, 0.5, 2.0))


def make_frames(seed: int, batch: int = 1, h: int = 480, w: int = 640):
    rng = np.random.default_rng(seed)
    # smooth structure + noise, so windows differ from one another
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for k in range(2):
        base = (127 + 80 * np.sin(xx / (17.0 + 3 * k) + yy / 29.0)
                )[None, :, :, None]
        noise = rng.integers(-40, 40, size=(batch, h, w, 3))
        frames.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    return frames


def flagship_cfg(dtype: str = "bfloat16", attn_impl: str = "cuda",
                 depths=(2, 2, 18, 2), backbone: str = "swin_base_v2"):
    from mmde_tpu_torch.config import ModelConfig, SwinConfig
    swin = SwinConfig(depths=tuple(depths), window_size=(30, 30, 30, 15),
                      pretrain_window_size=(12, 12, 12, 6),
                      use_shift=(True, True, False, False),
                      drop_path_rate=0.3)
    return ModelConfig(backbone=backbone, decoder="decoder_v2",
                       model_scale=32, max_depth=10.0, swin=swin,
                       dtype=dtype, attn_impl=attn_impl)


EXPECT_SHAPES = {"pred_d1": (1, 480, 640, 1), "pred_d2": (1, 480, 640, 1),
                 "pred_r12": (1, 9), "pred_r21": (1, 9),
                 "pred_t12": (1, 3), "pred_t21": (1, 3)}


def check_outputs(out: dict, what: str) -> dict:
    info = {}
    for k, shp in EXPECT_SHAPES.items():
        a = out[k]
        if tuple(a.shape) != shp:
            raise RuntimeError(f"{what}: {k} has shape {a.shape}, not {shp}")
        if not np.isfinite(a).all():
            raise RuntimeError(f"{what}: {k} is not finite")
        info[k] = list(a.shape)
    d = out["pred_d1"]
    if not (d.min() >= 0.0 and d.max() <= 10.0):
        raise RuntimeError(f"{what}: depth outside [0, max_depth]")
    return info


def _reset_launch_counts():
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    from mmde_tpu_torch.ops import window_attention_packed as wap
    for m in (wap, ths):
        m.LAUNCHES = m.LAUNCHES_BWD = 0
        m.LAUNCHES_BY_SHAPE.clear()
        m.LAUNCHES_BWD_BY_SHAPE.clear()


def _launches(backward: bool = False) -> dict:
    """{layout: {(B_, N, C, nH): launches}} since the last reset."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    from mmde_tpu_torch.ops import window_attention_packed as wap
    attr = "LAUNCHES_BWD_BY_SHAPE" if backward else "LAUNCHES_BY_SHAPE"
    return {"packed": dict(getattr(wap, attr)),
            "headsplit": dict(getattr(ths, attr))}


def _total(by_layout: dict) -> int:
    return sum(n for d in by_layout.values() for n in d.values())


def expected_launches(backbone: str, batch: int, times: int) -> dict:
    """{layout: {(B_, N, C, nH): launches}} of `times` forwards (or
    backwards): one per block of each stage, in the stage's layout."""
    want = {"packed": {}, "headsplit": {}}
    for sh in stage_shapes(backbone, batch=batch):
        key = (sh["B_"], sh["N"], sh["C"], sh["nH"])
        want[sh["layout"]][key] = sh["blocks"] * times
    return want


def _per_forward(want: dict, times: int) -> dict:
    return {layout: sum(d.values()) // times for layout, d in want.items()}


def phase_serve(backbone: str = "swin_base_v2", requests: int = 3,
                flip: bool = True, tag: str = "serve") -> dict:
    """`backbone` + decoder_v2 (bfloat16, the flagship's windows and
    depths) built at full width from a seed, answering `requests` requests
    of two 480x640 frames through tools.infer.predict, with every kernel's
    launch counter read around them; with `flip`, also a flip-averaged
    request."""
    from mmde_tpu_torch.tools import infer
    t0 = time.time()
    model = infer.build(flagship_cfg("bfloat16", "cuda", backbone=backbone),
                        device="cuda", seed=0)
    randomize_weights(model, seed=7)
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    f1, f2 = make_frames(seed=11)
    infer.predict(model, f1, f2)                          # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launch_counts()
    ms, dev_ms, shapes = [], [], None
    for i in range(requests):
        g1, g2 = make_frames(seed=100 + i)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.time()
        e0.record()
        out = infer.predict(model, g1, g2)
        e1.record()
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
        shapes = check_outputs(out, f"{tag} request {i}")
    by_layout = _launches()
    want = expected_launches(backbone, 1, requests)
    if by_layout != want:
        raise RuntimeError(f"{tag}: kernel launches by layout and shape "
                           f"{by_layout} for {requests} forwards, expected "
                           f"{want}")
    per_forward = _per_forward(want, requests)
    depth_std = float(out["pred_d1"].std())
    if depth_std <= 0.1:
        raise RuntimeError(f"{tag}: depth map is near-constant (std "
                           f"{depth_std})")
    rec = {"model": f"{backbone} + decoder_v2, bfloat16, depths 2/2/18/2",
           "params": n_params, "build_seconds": round(build_s, 2),
           "input": "2 x uint8 (1, 480, 640, 3)", "request_ms": ms,
           "request_ms_cuda_events": dev_ms, "outputs": shapes,
           "finite": True, "depth_std": depth_std,
           "launches_per_forward": per_forward,
           "launches_by_shape": {lay: {str(k): v for k, v in d.items()}
                                 for lay, d in by_layout.items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if flip:
        infer.predict(model, f1, f2, flip_tta=True)       # warm-up
        torch.cuda.synchronize()
        before = _total(_launches())
        t = time.time()
        out_flip = infer.predict(model, f1, f2, flip_tta=True)
        torch.cuda.synchronize()
        rec["flip_request_ms"] = (time.time() - t) * 1e3
        check_outputs(out_flip, f"{tag} flip request")
        n_flip = _total(_launches()) - before
        if n_flip != 2 * sum(per_forward.values()):
            raise RuntimeError(f"{tag}: {n_flip} launches for a "
                               f"flip-averaged request, expected "
                               f"{2 * sum(per_forward.values())}")
        rec["launches_flip_request"] = n_flip
    emit(tag, rec)
    rec["backbone"] = backbone
    rec["_by_shape"] = by_layout
    del model
    torch.cuda.empty_cache()
    return rec


def _profile(fn) -> dict:
    """Device time of one call of `fn` by kernel, from torch.profiler,
    grouped coarsely."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        # device-side rows only: an operator's row repeats its kernels' time
        if us > 0 and e.device_type == DeviceType.CUDA:
            rows.append({"name": e.key[:120], "calls": e.count,
                         "device_us": us})
    rows.sort(key=lambda r: -r["device_us"])
    total = sum(r["device_us"] for r in rows)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")

    def group(name: str) -> str:
        n = name.lower()
        if "window_attention_fwd" in n:     # K1 and K6' share the kernel
            return "window_attention_fwd (this repo's kernel)"
        if "bwd_dq_kernel" in n or "bwd_dkv_kernel" in n \
                or "bwd_dbias_kernel" in n:
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
    groups = {}
    for r in rows:
        g = group(r["name"])
        groups[g] = groups.get(g, 0.0) + r["device_us"]
    return {"rows": rows, "device_ms_total": total / 1e3,
            "launches": sum(r["calls"] for r in rows),
            "device_ms_by_group": {k: v / 1e3 for k, v in sorted(
                groups.items(), key=lambda kv: -kv[1])},
            "top": rows[:12]}


def phase_profile(path: str, backbone: str = "swin_base_v2",
                  tag: str = "profile") -> dict:
    """Optional (--profile PATH): device time by kernel group of one served
    request and of one train step (2 frame pairs) of `backbone`. Every row
    goes to PATH (the served request's at top level, the train step's under
    "train_step")."""
    from mmde_tpu_torch.tools import infer
    from mmde_tpu_torch.tools import train_steps as ts
    model = infer.build(flagship_cfg("bfloat16", "cuda", backbone=backbone),
                        device="cuda", seed=0)
    randomize_weights(model, seed=7)
    f1, f2 = make_frames(seed=11)
    for _ in range(2):
        infer.predict(model, f1, f2)
    torch.cuda.synchronize()
    serve = _profile(lambda: infer.predict(model, f1, f2))
    del model
    torch.cuda.empty_cache()

    state, step = ts.build_trainer(
        ts.flagship_config(batch_size=2, backbone=backbone), device="cuda",
        seed=0)
    randomize_weights(state.model, seed=7)
    batch = ts.synthetic_batch(2, 480, 640, seed=31, device="cuda")
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.time()
    train = _profile(lambda: step(state, batch))
    train["profiled_step_ms_host"] = (time.time() - t0) * 1e3
    del state, step
    torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({**serve, "train_step": train}, f, indent=1)
    rec = {k: v for k, v in serve.items() if k != "rows"}
    rec["train_step"] = {k: v for k, v in train.items() if k != "rows"}
    emit(tag, rec)
    return rec


def phase_parity(backbone: str = "swin_base_v2",
                 dtypes=("float32", "bfloat16"), tag: str = "parity") -> dict:
    """Kernel path vs plain path through the whole model. fp32
    convolutions go through cuDNN in TF32 by default; for this phase TF32 is
    switched off so that both paths are true fp32 outside the attention."""
    from mmde_tpu_torch.tools import infer
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    f1, f2 = make_frames(seed=21)
    res = {"cudnn_allow_tf32": False}
    try:
        for dtype in dtypes:
            outs = {}
            for impl in ("cuda", "torch"):
                model = infer.build(flagship_cfg(dtype, impl,
                                                 backbone=backbone),
                                    device="cuda", seed=0)
                randomize_weights(model, seed=7)
                outs[impl] = infer.predict(model, f1, f2)
                check_outputs(outs[impl], f"parity {dtype} {impl}")
                del model
                torch.cuda.empty_cache()
            std = float(outs["torch"]["pred_d1"].std())
            if std <= 0.1:
                raise RuntimeError(f"parity {dtype}: depth map is "
                                   f"near-constant (std {std})")
            diffs = {k: float(np.abs(outs["cuda"][k].astype(np.float64)
                                     - outs["torch"][k]).max())
                     for k in EXPECT_SHAPES}
            tol = TOL_MODEL[dtype]
            for k, v in diffs.items():
                lim = tol["depth"] if k.startswith("pred_d") else tol["pose"]
                if not v <= lim:
                    raise RuntimeError(f"parity {dtype}: {k} differs by {v} "
                                       f"> {lim}")
            mean_d = float(np.abs(outs["cuda"]["pred_d1"]
                                  - outs["torch"]["pred_d1"]).mean())
            if not mean_d <= tol.get("depth_mean", tol["depth"]):
                raise RuntimeError(f"parity {dtype}: pred_d1 differs by "
                                   f"{mean_d} on average")
            res[dtype] = {"max_abs_diff": diffs, "mean_abs_diff_d1": mean_d,
                          "depth_std": std, "tolerance": tol}
    finally:
        torch.backends.cudnn.allow_tf32 = old
    if tag:
        emit(tag, res)
    return res


# train_parity: one fp32 step, kernel path vs plain path. The two differ by
# the order of fp32 sums inside the attention (forward ~1e-6 per block,
# backward ~1e-5, see TOL_BWD). The forward difference reaches the outputs
# at ~5e-6 relative, and the gradients amplify it: the decoder conv, whose
# gradient passes through no attention backward at all, already differs by
# 1e-4; qkv / RPE weights by 5e-4..9e-4; logit_scale gradients (cancelling
# sums) by 6e-4..2.3e-3 (measured, H100).
TOL_TRAIN_PARITY = {"loss_rel": 1e-4, "grad_rel_l2": 5e-3}
PARITY_PARAMS = (
    "encoder.layers.0.blocks.1.attn.qkv.weight",
    "encoder.layers.2.blocks.5.attn.rpe_mlp.0.weight",
    "encoder.layers.0.blocks.0.attn.logit_scale",
    "encoder.layers.1.blocks.1.attn.logit_scale",
    "encoder.layers.2.blocks.9.attn.logit_scale",
    "encoder.layers.3.blocks.0.attn.logit_scale",
    "decoder.decoder_depth.conv_layers.0.weight",
)


# stage 1 of swin_large runs the head-split backward: its RPE MLP and q bias
LARGE_PARITY_PARAMS = PARITY_PARAMS + (
    "encoder.layers.0.blocks.1.attn.rpe_mlp.0.weight",
    "encoder.layers.0.blocks.0.attn.q_bias")


def phase_train(backbone: str = "swin_base_v2", steps: int = 6,
                pairs: int = 2, deterministic_run: bool = True,
                tag: str = "train") -> dict:
    """The trainer on the card: `steps` steps of make_train_step at `pairs`
    frame pairs (bf16, train mode, drop path 0.3, seeded generator) on one
    synthetic batch, every kernel's launches counted per step; then, with
    `deterministic_run`, a short deterministic run whose loss must fall."""
    from mmde_tpu_torch.tools import train_steps as ts
    cfg = ts.flagship_config("bfloat16", "cuda", batch_size=pairs,
                             backbone=backbone)
    t0 = time.time()
    state, step = ts.build_trainer(cfg, device="cuda", seed=0)
    randomize_weights(state.model, seed=7)
    build_s = time.time() - t0
    batch = ts.synthetic_batch(pairs, 480, 640, seed=31, device="cuda")
    watch = {n: p.detach().clone() for n, p in state.model.named_parameters()
             if n in LARGE_PARITY_PARAMS}
    per_step = _per_forward(expected_launches(backbone, pairs, 1), 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launch_counts()
    losses, ms = [], []
    for i in range(steps):
        before = (_launches(), _launches(backward=True))
        torch.cuda.synchronize()
        t = time.time()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        aux = {k: float(v) for k, v in aux.items()}
        if not all(math.isfinite(v) for v in aux.values()):
            raise RuntimeError(f"{tag} step {i}: loss not finite: {aux}")
        losses.append(aux)
        for bwd, prev in ((False, before[0]), (True, before[1])):
            now = _launches(backward=bwd)
            got = {lay: sum(now[lay].values()) - sum(prev[lay].values())
                   for lay in now}
            if got != per_step:
                raise RuntimeError(
                    f"{tag} step {i}: {'backward' if bwd else 'forward'} "
                    f"launches by layout {got}, expected {per_step}")
    fwd_by_shape, bwd_by_shape = _launches(), _launches(backward=True)
    want = expected_launches(backbone, pairs, steps)
    if fwd_by_shape != want or bwd_by_shape != want:
        raise RuntimeError(f"{tag}: forward launches {fwd_by_shape}, "
                           f"backward {bwd_by_shape}, expected {want} each")
    peak = torch.cuda.max_memory_allocated()
    moved = {n: float((p.detach() - watch[n]).abs().max())
             for n, p in state.model.named_parameters() if n in watch}
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"{tag}: parameters did not change: {moved}")
    steady = ms[1:]
    rec = {"model": f"{backbone} + decoder_v2, bfloat16, depths 2/2/18/2, "
                    "train mode, drop path 0.3, remat none",
           "frame_pairs": pairs, "steps": steps,
           "params": sum(p.numel() for p in state.model.parameters()),
           "build_seconds": round(build_s, 2), "losses": losses,
           "first_step_ms": ms[0], "step_ms": steady,
           "step_ms_median": statistics.median(steady),
           "images_per_s": 2 * pairs / (statistics.median(steady) / 1e3),
           "launches_fwd_per_step": per_step,
           "launches_bwd_per_step": per_step,
           "launches_fwd_by_shape": {lay: {str(k): v for k, v in d.items()}
                                     for lay, d in fwd_by_shape.items()},
           "launches_bwd_by_shape": {lay: {str(k): v for k, v in d.items()}
                                     for lay, d in bwd_by_shape.items()},
           "param_max_abs_change": moved, "peak_memory_bytes": peak}
    del state, step
    torch.cuda.empty_cache()

    if deterministic_run:
        # eval-mode modules, same batch every step -> loss falls
        state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                       deterministic=True)
        randomize_weights(state.model, seed=7)
        det = []
        for _ in range(4):
            state, aux = step(state, batch)
            det.append(float(aux["loss_total"]))
        if not (all(math.isfinite(v) for v in det) and det[-1] < det[0]):
            raise RuntimeError(f"{tag} deterministic run: loss did not "
                               f"fall: {det}")
        rec["deterministic_loss_total"] = det
        del state, step
        torch.cuda.empty_cache()
    emit(tag, rec)
    rec["backbone"] = backbone
    rec["_bwd_by_shape"] = bwd_by_shape
    rec["_fwd_by_shape"] = fwd_by_shape
    return rec


def phase_train_parity(backbone: str = "swin_base_v2", pairs: int = 1,
                       params=PARITY_PARAMS, tag: str = "train_parity"
                       ) -> dict:
    """One deterministic fp32 step at full width and depth, kernel path
    against plain path from the same weights and batch: the loss and the
    gradients of a named set of parameters. cuDNN TF32 is off for this
    phase (matmul TF32 is off by default)."""
    from mmde_tpu_torch.tools import train_steps as ts
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    batch = ts.synthetic_batch(pairs, 480, 640, seed=33, device="cuda")
    got = {}
    try:
        for impl in ("cuda", "torch"):
            cfg = ts.flagship_config("float32", impl, batch_size=pairs,
                                     backbone=backbone)
            state, step = ts.build_trainer(cfg, device="cuda", seed=0,
                                           deterministic=True)
            randomize_weights(state.model, seed=7)
            state, aux = step(state, batch)
            grads = {n: p.grad.detach().double().clone()
                     for n, p in state.model.named_parameters()
                     if n in params}
            got[impl] = ({k: float(v) for k, v in aux.items()}, grads)
            del state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = old
    (la, ga), (lb, gb) = got["cuda"], got["torch"]
    if set(ga) != set(params):
        raise RuntimeError(f"parity parameters missing: "
                           f"{set(params) - set(ga)}")
    loss_rel = abs(la["loss_total"] - lb["loss_total"]) / abs(lb["loss_total"])
    grad_rel = {n: float((ga[n] - gb[n]).norm()
                         / gb[n].norm().clamp_min(1e-300)) for n in ga}
    rec = {"model": backbone, "dtype": "float32", "frame_pairs": pairs,
           "depths": [2, 2, 18, 2], "cudnn_allow_tf32": False,
           "loss_cuda": la, "loss_torch": lb, "loss_rel_diff": loss_rel,
           "grad_rel_l2": grad_rel,
           "grad_norm": {n: float(gb[n].norm()) for n in gb},
           "tolerance": TOL_TRAIN_PARITY}
    if not loss_rel <= TOL_TRAIN_PARITY["loss_rel"]:
        raise RuntimeError(f"train parity: loss differs: {json.dumps(rec)}")
    for n, v in grad_rel.items():
        if not (v <= TOL_TRAIN_PARITY["grad_rel_l2"]
                and float(gb[n].norm()) > 0):
            raise RuntimeError(f"train parity: gradient of {n} differs or is "
                               f"zero: {json.dumps(rec)}")
    if tag:
        emit(tag, rec)
    return rec


def _entry(name, shape, source, replaces, n, c, pairs=1) -> dict:
    where = (f"[{shape['model'].rsplit('_', 1)[0]} stage{shape['stage']} "
             f"B_={shape['B_']} N={shape['N']} C={shape['C']} "
             f"nH={shape['nH']} bf16{' mask' if shape['nW'] else ''}"
             f"{' train' if pairs > 1 else ''}]")
    if n == 0:
        raise RuntimeError(f"the path never launched {name}{where}")
    return {"name": name + where, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": c["max_abs_err"], "rel_l2_err": c["rel_l2_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": None}


def _find(cases, shape, pairs, **want):
    return next(c for c in cases
                if c["model"] == shape["model"]
                and c["stage"] == shape["stage"] and c["dtype"] == "bfloat16"
                and c.get("frame_pairs", 1) == pairs
                and all(c[k] == v for k, v in want.items()))


def contract_serve(k1_cases: list, hs_cases: list, serve: dict) -> list:
    """One entry per (kernel, served shape): the served model is bfloat16,
    stages 1-2 alternate unmasked and masked blocks (the masked case is
    listed), stages 3-4 are unmasked."""
    entries = []
    for shape in stage_shapes(serve["backbone"]):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        n = serve["_by_shape"][shape["layout"]].get(key, 0)
        nW = shape["nW"]
        if shape["layout"] == "packed":
            c = next(c for c in k1_cases
                     if c["model"] == shape["model"]
                     and c["stage"] == shape["stage"]
                     and c["dtype"] == "bfloat16"
                     and c["softmax"] == "maxfree" and (c["nW"] > 0) == (
                         nW > 0))
            entries.append(_entry("window_attention_fwd", shape,
                                  KERNEL_SOURCE, KERNEL_REPLACES, n, c))
        else:
            c = _find(hs_cases, shape, 1, nW=nW)["forward"]
            entries.append(_entry("window_attention_headsplit_fwd", shape,
                                  KERNEL_SOURCE, KERNEL_HS_REPLACES, n, c))
    return entries


def contract_train(k2_cases: list, hs_cases: list, train: dict) -> list:
    """Two entries per trained shape, the forward through its training entry
    point (output and log-sum-exp) and the backward: the trained model is
    bfloat16 at 2 frame pairs, stages 1-2 masked in every other block (the
    masked case is listed). Errors: the forward's output against the plain
    forward, the backward's dqkv against float64 autograd."""
    entries = []
    pairs = train["frame_pairs"]
    for shape in stage_shapes(train["backbone"], batch=pairs):
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        lay = shape["layout"]
        nf = train["_fwd_by_shape"][lay].get(key, 0)
        nb = train["_bwd_by_shape"][lay].get(key, 0)
        if lay == "packed":
            c = _find(k2_cases, shape, pairs)
            entries.append(_entry("window_attention_fwd+lse", shape,
                                  KERNEL_SOURCE, KERNEL_REPLACES, nf,
                                  c["forward"], pairs))
            e = _entry("window_attention_bwd", shape, KERNEL_BWD_SOURCE,
                       KERNEL_BWD_REPLACES, nb, c, pairs)
            e["ms_split_dbias"] = c["ms_split"]     # K3, not the default
        else:
            c = _find(hs_cases, shape, pairs, nW=shape["nW"])
            entries.append(_entry("window_attention_headsplit_fwd+lse",
                                  shape, KERNEL_SOURCE, KERNEL_HS_REPLACES,
                                  nf, c["forward_stats"], pairs))
            e = _entry("window_attention_headsplit_bwd", shape,
                       KERNEL_BWD_SOURCE, KERNEL_HS_BWD_REPLACES, nb, c,
                       pairs)
        entries.append(e)
    return entries


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="build the kernels, compare them with their plain "
                         "versions (no timing), then stop (prints no final "
                         "ok line)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also profile one served request and one train "
                         "step with torch.profiler, of the flagship and of "
                         "swin_large, and write their rows to PATH and "
                         "PATH with _large before its extension (JSON)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    t_start = time.time()
    torch.manual_seed(0)
    phase_env()
    timed = args.only is None
    k1_cases = phase_kernels(timed=timed)
    k2_cases = phase_kernels_backward(timed=timed)
    hs_cases = phase_kernels_headsplit(timed=timed)
    if args.only == "kernels":
        return 0
    serve = phase_serve()
    train = phase_train()
    serve_large = phase_serve("swin_large_v2", flip=False, tag="serve_large")
    train_large = phase_train("swin_large_v2", steps=6,
                              deterministic_run=False, tag="train_large")
    if args.profile:
        phase_profile(args.profile)
        root, ext = os.path.splitext(args.profile)
        phase_profile(f"{root}_large{ext}", "swin_large_v2", "profile_large")
    phase_parity()
    phase_train_parity()
    emit("parity_large", {
        "forward": phase_parity("swin_large_v2", ("float32",), tag=None),
        "train_step": phase_train_parity("swin_large_v2",
                                         params=LARGE_PARITY_PARAMS,
                                         tag=None)})
    print(json.dumps({"kernels":
                      contract_serve(k1_cases, hs_cases, serve)
                      + contract_train(k2_cases, hs_cases, train)
                      + contract_serve(k1_cases, hs_cases, serve_large)
                      + contract_train(k2_cases, hs_cases, train_large)}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit("total_seconds", round(time.time() - t_start, 1))
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
