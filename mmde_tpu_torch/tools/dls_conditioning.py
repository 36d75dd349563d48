#!/usr/bin/env python
"""How ill-conditioned the head-split backward's dlogit_scale is at
swin_tiny's stage 1, and how far the fp32 tensor-core K7' and the plain
fp32 backward land from float64, head by head.

dlogit_scale of a head is sum(ds * sc) over every window, query and key:
~39 million terms at swin_tiny's stage 1 (48 windows of 900 tokens, 1
frame pair) whose rows of ds sum to zero, so the sum cancels. Its relative
error is the terms' rounding over |sum|, which the draw decides: this tool
prints, per head and seed, the float64 value, the condition number
sum|terms| / |sum|, and each body's error relative to the value and to
sum|terms| (normwise). Inputs as chip_smoke.py's kernel cases draw them:
fp32 qkv and g from a seeded generator, head 0 above the ln(100) clamp
(dlogit_scale 0), head 1 hot (scale e^4), the rest near e^2, 16*sigmoid
bias, a 0 / -100 mask over the stage's window types.

    python -m mmde_tpu_torch.tools.dls_conditioning [--seeds 0 1 2 3]
        [--windows B] [--device cuda]

On the card the kernel is K7' (fp32, three bf16 pieces); with --device cpu
its arithmetic is emulated (`testing.tc_backward_heads`, pieces 3) and
`--windows` cuts the windows. One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS, require_device
from mmde_tpu_torch.ops import window_attention_headsplit as ths


def stage_shape():
    """(B_, N, C, nH, nW) of swin_tiny's stage 1 at 480x640, 1 frame pair,
    windows of 30 (the flagship's layout; 24 window types, masked)."""
    embed, heads = SWIN_VARIANTS["tiny"]
    nw = (120 // 30) * -(-160 // 30)
    return 2 * nw, 900, embed, heads[0], nw


def draw(B_, N, C, nH, nW, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    qkv = torch.randn((B_, N, 3 * C), device=device, generator=gen)
    ls = torch.randn((nH, 1, 1), device=device, generator=gen) * 0.5 + 2.0
    ls[0], ls[1] = 5.0, 4.0
    bias = 16.0 * torch.sigmoid(torch.randn((nH, N, N), device=device,
                                            generator=gen))
    m = torch.rand((nW, N, N), device=device, generator=gen) < 0.3
    eye = torch.eye(N, device=device, dtype=torch.bool)
    mask = torch.where(m & ~eye, -100.0, 0.0)
    g = torch.randn((B_, N, C), device=device, generator=gen)
    return qkv, ls, bias, mask, g


def heads(x, nH):
    B_, N, C3 = x.shape
    parts = C3 // (nH * 32)
    return x.reshape(B_, N, parts, nH, 32).permute(2, 0, 3, 1, 4).unbind(0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--windows", type=int, default=None,
                   help="cut B_ to this many windows (CPU runs)")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device, what="dls_conditioning")
    B_, N, C, nH, nW = stage_shape()
    B_ = args.windows or B_
    for seed in args.seeds:
        qkv, ls, bias, mask, g = draw(B_, N, C, nH, nW, seed, dev)
        live = (ls.flatten() < math.log(100.0)).double().cpu()
        mk = mask[:min(nW, B_)]
        q, k, v = heads(qkv, nH)
        (gh,) = heads(g, nH)
        # float64: the value and its terms
        q64, k64, v64, g64 = (t.double() for t in (q, k, v, gh))
        _, _, _, want, _ = ths.cosine_window_attention_headsplit_backward_plain(
            q64, k64, v64, ls.double(), bias.double(), mk.double(), g64,
            compute_dtype=torch.float64)
        rq = torch.rsqrt((q64 * q64).sum(-1, keepdim=True) + 1e-12)
        rk = torch.rsqrt((k64 * k64).sum(-1, keepdim=True) + 1e-12)
        scale = torch.exp(torch.clamp(ls.double(), max=math.log(100.0)))
        sc = (q64 * rq) @ (k64 * rk).transpose(-1, -2) * scale.reshape(
            nH, 1, 1)
        s = (sc.reshape(B_ // mk.shape[0], mk.shape[0], nH, N, N)
             + bias.double()[None, None]
             + mk.double()[None, :, None]).reshape(B_, nH, N, N)
        pr = torch.softmax(s, -1)
        dp = g64 @ v64.transpose(-1, -2)
        terms = (pr * (dp - (pr * dp).sum(-1, keepdim=True)) * sc).abs()
        size = terms.sum((0, 2, 3)).cpu() * live
        del q64, k64, v64, g64, sc, s, pr, dp, terms
        plain = ths.cosine_window_attention_headsplit_backward_plain(
            q, k, v, ls, bias, mk, gh)[3]
        if dev.type == "cuda":
            leaves = [qkv.clone().requires_grad_(), ls.clone()
                      .requires_grad_(), bias.clone().requires_grad_()]
            out = ths.cosine_window_attention_headsplit(
                *heads(leaves[0], nH), leaves[1], leaves[2], mk)
            out.backward(gh)
            got, body = leaves[1].grad, "K7' (fp32 tensor cores)"
            del leaves, out
        else:
            from mmde_tpu_torch import testing
            got = testing.tc_backward_heads(q, k, v, ls, bias, mk, gh,
                                            "fp32", pieces=3)[3]
            body = "K7' emulated (testing.tc_backward_heads, pieces 3)"
        want = want.flatten().cpu()
        rec = {"seed": seed, "B_": B_, "N": N, "C": C, "nH": nH,
               "nW": mk.shape[0], "body": body,
               "float64": want.tolist(), "sum_abs_terms": size.tolist(),
               "condition": (size / want.abs().clamp_min(1e-300)).tolist()}
        for name, x in (("kernel", got), ("plain", plain)):
            err = (x.flatten().double().cpu() - want).abs() * live
            rec[f"{name}_rel_l2"] = float(err.norm() / want.norm())
            rec[f"{name}_rel"] = (err / want.abs().clamp_min(1e-300)
                                  ).tolist()
            rec[f"{name}_normwise"] = (err / size.clamp_min(1e-300)
                                       ).tolist()
        if dev.type == "cuda":
            import subprocess
            rec["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
