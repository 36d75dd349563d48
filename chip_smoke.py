#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mmde_tpu_torch).

    python3 chip_smoke.py                 # everything, one card
    python3 chip_smoke.py --only kernels  # build + compare the kernels only
    python3 chip_smoke.py --profile p.json  # also: device time by kernel

What it does, each phase printing one JSON object on a line of its own:

  env           card name and power limit (nvidia-smi), torch / CUDA / nvcc
                versions, seconds spent building the kernels from csrc/.
  kernel_cases  the window-attention kernel against its plain PyTorch
                version at the four flagship stage shapes, float32 and
                bfloat16, with and without mask: max abs / rel-L2 error,
                kernel ms and plain ms (CUDA events, warm, median), and
                the roofline bound with its bytes and flops.
  serve         the flagship model (swin_base_v2 + decoder_v2, bfloat16,
                two 480x640 frames) built at full width from a seed,
                answering requests through mmde_tpu_torch.tools.infer.predict
                with the kernel launch counter read around them.
  parity        the whole model, attn_impl "cuda" against "torch", same
                weights and frames, float32 and bfloat16.
  kernels       per kernel of the served path: launches on that path, error,
                ms, plain ms, bound.

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

# kernel-vs-plain tolerances on the card
TOL_FP32_MAX_ABS = 5e-5     # fp32 sums in another order + expf vs exp
TOL_BF16_REL_L2 = 4e-3      # both round one fp32 result to bf16 (2^-9 ulp)

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


def flagship_stage_shapes(h: int = 480, w: int = 640, batch: int = 1):
    """(name, B_, N, C, nH, nW) the kernel sees per stage for `batch` frame
    pairs at h x w, re-derived from the flagship config."""
    embed, heads = 128, (4, 8, 16, 32)
    windows, shift = (30, 30, 30, 15), (True, True, False, False)
    depths = (2, 2, 18, 2)
    out = []
    mh, mw = h // 4, w // 4
    for i in range(4):
        ws = windows[i]
        hp, wp = -(-mh // ws) * ws, -(-mw // ws) * ws
        nw = (hp // ws) * (wp // ws)
        out.append({"stage": i + 1, "map": [mh, mw], "padded": [hp, wp],
                    "B_": 2 * batch * nw, "N": ws * ws,
                    "C": embed * 2 ** i, "nH": heads[i],
                    "nW": nw if (shift[i] and depths[i] > 1) else 0,
                    "blocks": depths[i]})
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


def kernel_bound(B_, N, C, nH, nW, dtype: torch.dtype, bias_dtype) -> dict:
    esz = torch.empty((), dtype=dtype).element_size()
    bsz = torch.empty((), dtype=bias_dtype).element_size()
    nbytes = (B_ * N * 3 * C * esz          # qkv read once
              + B_ * N * C * esz            # out written once
              + nH * N * N * bsz            # bias read once
              + nW * N * N * bsz            # mask read once
              + nH * 4)                     # logit_scale
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
        rec = {"stage": shape["stage"], "B_": shape["B_"], "N": shape["N"],
               "C": shape["C"], "nH": nH,
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


def phase_env() -> dict:
    from mmde_tpu_torch.ops import cuda_build
    from mmde_tpu_torch.ops import window_attention_packed as wap
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.time()
    rec = wap.build_kernel()
    env = {"nvidia_smi": smi, "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": cuda_build.nvcc_version(),
           "build_seconds": round(time.time() - t0, 3),
           "nvcc_seconds": round(rec["seconds"], 3),
           "library": os.path.relpath(rec["path"]),
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit("env", env)
    return env


def phase_kernels(timed: bool = True) -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    cases = []
    shapes = flagship_stage_shapes()
    for shape in shapes:
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
    emit("kernel_cases", {"shapes": shapes, "cases": cases,
                          "timing": "CUDA events, 3 warm + 20 launches, "
                                    "median; inputs stay in L2 between "
                                    "launches"})
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
                 depths=(2, 2, 18, 2)):
    from mmde_tpu_torch.config import ModelConfig, SwinConfig
    swin = SwinConfig(depths=tuple(depths), window_size=(30, 30, 30, 15),
                      pretrain_window_size=(12, 12, 12, 6),
                      use_shift=(True, True, False, False),
                      drop_path_rate=0.3)
    return ModelConfig(backbone="swin_base_v2", decoder="decoder_v2",
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


def phase_serve(requests: int = 3) -> dict:
    from mmde_tpu_torch.ops import window_attention_packed as wap
    from mmde_tpu_torch.tools import infer
    t0 = time.time()
    model = infer.build(flagship_cfg("bfloat16", "cuda"), device="cuda",
                        seed=0)
    randomize_weights(model, seed=7)
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    f1, f2 = make_frames(seed=11)
    infer.predict(model, f1, f2)                          # warm-up request
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wap.LAUNCHES = 0
    wap.LAUNCHES_BY_SHAPE.clear()
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
        shapes = check_outputs(out, f"request {i}")
    launches_plain = wap.LAUNCHES
    by_shape = {str(k): v for k, v in wap.LAUNCHES_BY_SHAPE.items()}
    by_shape_raw = dict(wap.LAUNCHES_BY_SHAPE)
    if launches_plain != 24 * requests:
        raise RuntimeError(f"{launches_plain} kernel launches for {requests} "
                           f"forwards, expected {24 * requests}")
    depth_std = float(out["pred_d1"].std())
    if depth_std <= 0.1:
        raise RuntimeError(f"depth map is near-constant (std {depth_std})")

    infer.predict(model, f1, f2, flip_tta=True)           # warm-up
    torch.cuda.synchronize()
    before_flip = wap.LAUNCHES
    t = time.time()
    out_flip = infer.predict(model, f1, f2, flip_tta=True)
    torch.cuda.synchronize()
    flip_ms = (time.time() - t) * 1e3
    check_outputs(out_flip, "flip request")
    launches_flip = wap.LAUNCHES - before_flip
    if launches_flip != 48:
        raise RuntimeError(f"{launches_flip} launches for a flip-averaged "
                           "request, expected 48")
    rec = {"model": "swin_base_v2 + decoder_v2, bfloat16, depths 2/2/18/2",
           "params": n_params, "build_seconds": round(build_s, 2),
           "input": "2 x uint8 (1, 480, 640, 3)", "request_ms": ms,
           "request_ms_cuda_events": dev_ms, "flip_request_ms": flip_ms, "outputs": shapes,
           "finite": True, "depth_std": depth_std,
           "launches": launches_plain, "launches_per_forward": 24,
           "launches_flip_request": launches_flip,
           "launches_by_shape": by_shape,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit("serve", rec)
    rec["_by_shape"] = by_shape_raw
    del model
    torch.cuda.empty_cache()
    return rec


def phase_profile(path: str) -> dict:
    """Optional (--profile PATH): device time of one served request by
    kernel, from torch.profiler, grouped coarsely. Every row goes to PATH."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mmde_tpu_torch.tools import infer
    model = infer.build(flagship_cfg("bfloat16", "cuda"), device="cuda",
                        seed=0)
    randomize_weights(model, seed=7)
    f1, f2 = make_frames(seed=11)
    for _ in range(2):
        infer.predict(model, f1, f2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        infer.predict(model, f1, f2)
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
        if "window_attention_fwd" in n:
            return "window_attention_fwd (this repo's kernel)"
        if ("fprop" in n or "implicit_gemm" in n or "conv" in n
                or "cudnn" in n or "dgrad" in n):
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
    rec = {"device_ms_total": total / 1e3,
           "device_ms_by_group": {k: v / 1e3 for k, v in sorted(
               groups.items(), key=lambda kv: -kv[1])},
           "top": rows[:12]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"rows": rows, **rec}, f, indent=1)
    emit("profile", rec)
    del model
    torch.cuda.empty_cache()
    return rec


def phase_parity() -> dict:
    """Kernel path vs plain path through the whole flagship model. fp32
    convolutions go through cuDNN in TF32 by default; for this phase TF32 is
    switched off so that both paths are true fp32 outside the attention."""
    from mmde_tpu_torch.tools import infer
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    f1, f2 = make_frames(seed=21)
    res = {"cudnn_allow_tf32": False}
    try:
        for dtype in ("float32", "bfloat16"):
            outs = {}
            for impl in ("cuda", "torch"):
                model = infer.build(flagship_cfg(dtype, impl), device="cuda",
                                    seed=0)
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
    emit("parity", res)
    return res


def contract_kernels(cases: list, serve: dict) -> list:
    """One entry per (kernel, served shape): the served model is bfloat16,
    stages 1-2 alternate unmasked and masked blocks (the masked case is
    listed), stages 3-4 are unmasked."""
    entries = []
    by_shape = serve["_by_shape"]
    for shape in flagship_stage_shapes():
        masked = shape["nW"] > 0
        case = next(c for c in cases
                    if c["stage"] == shape["stage"] and c["dtype"] == "bfloat16"
                    and c["softmax"] == "maxfree"
                    and (c["nW"] > 0) == masked)
        key = (shape["B_"], shape["N"], shape["C"], shape["nH"])
        n = by_shape.get(key, 0)
        if n == 0:
            raise RuntimeError(f"the served path never launched the kernel "
                               f"at stage {shape['stage']} {key}")
        entries.append({
            "name": f"window_attention_fwd[stage{shape['stage']} "
                    f"B_={key[0]} N={key[1]} C={key[2]} nH={key[3]} bf16"
                    f"{' mask' if masked else ''}]",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "launches": n,
            "max_abs_err": case["max_abs_err"],
            "rel_l2_err": case["rel_l2_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": None})
    return entries


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="build the kernels, compare them with their plain "
                         "versions (no timing), then stop (prints no final "
                         "ok line)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="also profile one served request with "
                         "torch.profiler and write its rows to PATH (JSON)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    t_start = time.time()
    torch.manual_seed(0)
    phase_env()
    cases = phase_kernels(timed=args.only is None)
    if args.only == "kernels":
        return 0
    serve = phase_serve()
    if args.profile:
        phase_profile(args.profile)
    phase_parity()
    print(json.dumps({"kernels": contract_kernels(cases, serve)}), flush=True)
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
