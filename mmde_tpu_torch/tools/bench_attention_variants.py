"""Attention-body variants on the card: the JAX package's
tools/bench_attention_variants.py (T2) for the port's forward kernel, K1.

    python -m mmde_tpu_torch.tools.bench_attention_variants [s1 s2 s3 s4]

prints the card's `nvidia-smi --query-gpu=name,power.limit` line, then per
stage and variant the median ms of one launch (CUDA events, warm) and the
max |diff| against v0. The variants of the JAX tool's body:

  v0  s = (q^ k^T) * scale + bias (+ mask)       production mxu="fp32"
  v1  s = (q^ * scale) k^T + bias (+ mask)       production mxu="fold"
  v2  v1 with one epilogue expression            the same launch as v1
  v3  v1 with bf16 operands for both products    production mxu="bf16"
  v4  v1 with bf16 operands for p v only         K1 built with
                                                 MMDE_FOLD_PV=1 (_build/,
                                                 at first use), forward
                                                 only

v0, v1 and v3 launch K1's fp32-FMA body from the production library
(`_launch_forward(..., _fma=True)`, serving: no statistics) with that mxu,
no copy of the kernel; the model's bf16 launches run the tensor-core
kernel (window_attention_fwd_tc.cu) instead, which these variants predate.
v2 is the same arithmetic as v1 on this card: K1's
epilogue already forms (c + bias) + mask in one pass over the registers,
so v2 launches v1's instantiation. Every variant takes the row maximum
(maxfree=False), as the JAX tool's body does; inputs as the JAX tool's:
bf16 qkv ~ N(0, 1), logit scale 1, bias ~ N(0, 1), 20 % of the mask -100.
Each variant is held to its plain version (`_plain`) at K1's bf16
tolerance (rel-L2 4e-3); v3 and v4, whose roundings move the output by
about that much, must also lie APART times nearer their own plain version
than v1's (a kernel that ignored its mode would not).
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import torch

from mmde_tpu_torch.ops import window_attention_packed as wap
from mmde_tpu_torch.tools.card import (PEAK_FLOPS, bound as card_bound,
                                       nvidia_smi_line, time_ms)

# (name, B_ windows, nH, N, C, nW mask windows): the JAX tool's table
STAGES = {
    "s1": ("stage1 120x180 w30", 48, 4, 900, 128, 24),
    "s2": ("stage2 60x90 w30", 24, 8, 900, 256, 6),
    "s3": ("stage3 30x60 w30", 16, 16, 900, 512, 0),
    "s4": ("stage4 15x30 w15", 16, 32, 225, 1024, 0),
}
VARIANTS = {0: "fp32", 1: "fold", 2: "fold", 3: "bf16", 4: "fold_pv_bf16"}
REPLACES = ("tools/bench_attention_variants.py:47 (_fwd_body; forward :104, "
            "pallas_call :139)")
TOL_REL_L2 = 4e-3
APART = 3.0


def library_specs() -> dict:
    """The v4 library (K1's source built with MMDE_FOLD_PV=1, which adds
    the mode "fold_pv_bf16"), which only this tool loads."""
    return {wap._LIB_NAME_PV: (wap._SOURCES, wap._DEFINES_PV)}


def make_inputs(stage: str, device="cuda", seed: int = 0) -> tuple:
    """The JAX tool's inputs at `stage`: qkv (B_, N, 3C), logit_scale
    (nH, 1, 1) = 1, bias (nH, N, N) and mask (nW, N, N) or None, bf16."""
    _, B_, nH, N, C, nW = STAGES[stage]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    qkv = torch.randn((B_, N, 3 * C), generator=gen,
                      device=device).bfloat16()
    ls = torch.ones((nH, 1, 1), device=device)
    bias = torch.randn((nH, N, N), generator=gen, device=device).bfloat16()
    mask = None
    if nW:
        m = torch.rand((nW, N, N), generator=gen, device=device) < 0.2
        mask = torch.where(m, -100.0, 0.0).bfloat16()
    return qkv, ls, bias, mask, nH


def forward(qkv, ls, bias, mask, num_heads: int, variant: int):
    """One variant's output: K1's fp32-FMA body through the wrapper's
    launch in the variant's mode (v0-v3: the production library; v4: its
    own build), the body these variants were written against (bf16 qkv on
    the model's path runs the tensor-core kernel instead); plain PyTorch on
    the CPU."""
    mxu = VARIANTS[variant]
    if not qkv.is_cuda:
        return _plain(qkv, ls, bias, mask, num_heads, variant)
    with torch.no_grad():
        return wap._launch_forward(qkv, ls, bias, mask, num_heads, False,
                                   False, mxu=mxu, _fma=True)[0]


def _plain(qkv, ls, bias, mask, num_heads: int, variant: int):
    """The variant's function in plain PyTorch (fp32 compute, bf16 out)."""
    return wap.cosine_window_attention_packed_plain(
        qkv, ls, bias, mask, num_heads=num_heads, mxu=VARIANTS[variant],
        maxfree=False)


def bound(stage: str) -> dict:
    """Least time for a variant's work on an H100 at the published rates
    (700 W): qkv read once, out written once, bias and mask once (bf16),
    against 2 N x N x 32 products per (window, head) at the fp32 FMA rate
    (v0-v2), the bf16 tensor-core rate (v3), or one at each (v4)."""
    _, B_, nH, N, C, nW = STAGES[stage]
    nbytes = 2 * (B_ * N * 4 * C + (nH + nW) * N * N) + nH * 4
    flops = 4 * B_ * nH * N * N * 32
    f32, b16 = PEAK_FLOPS["float32"], PEAK_FLOPS["bfloat16"]
    seconds = {0: flops / f32, 1: flops / f32, 2: flops / f32,
               3: flops / b16, 4: flops / 2 / f32 + flops / 2 / b16}
    return {v: card_bound(nbytes, seconds[v], flops=flops) for v in VARIANTS}


def run(stages: List[str], timed: bool = True, device="cuda") -> List[dict]:
    """Per stage and variant: max |diff| against v0, error against the
    variant's plain version, and (timed) ms, plain ms and the bound."""
    recs = []
    for stage in stages:
        qkv, ls, bias, mask, nH = make_inputs(stage, device)
        ref, bnd = None, bound(stage)
        fold = _plain(qkv, ls, bias, mask, nH, 1).float()
        for v in VARIANTS:
            out = forward(qkv, ls, bias, mask, nH, v)
            want = _plain(qkv, ls, bias, mask, nH, v)
            o, w = out.float(), want.float()
            rec = {"stage": stage, "variant": f"v{v}", "mxu": VARIANTS[v],
                   "name": STAGES[stage][0],
                   "max_abs_err": float((o - w).abs().max()),
                   "rel_l2_err": float((o - w).norm() / w.norm())}
            if ref is None:
                ref = o
            rec["max_diff_vs_v0"] = float((o - ref).abs().max())
            rec["ok"] = bool(torch.isfinite(o).all()) and (
                rec["rel_l2_err"] <= TOL_REL_L2)
            if v in (3, 4):
                rec["rel_l2_to_v1_plain"] = float((o - fold).norm()
                                                  / fold.norm())
                rec["ok"] = rec["ok"] and (rec["rel_l2_to_v1_plain"]
                                           >= APART * rec["rel_l2_err"])
            if timed:
                rec["ms"] = time_ms(
                    lambda: forward(qkv, ls, bias, mask, nH, v))
                rec["plain_ms"] = time_ms(
                    lambda: _plain(qkv, ls, bias, mask, nH, v), reps=5,
                    warm=1)
                rec.update(bnd[v])
            rec["_out"] = out
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", help=f"of {list(STAGES)} "
                    "(default: s1 s3 s4, as the JAX tool)")
    args = ap.parse_args(argv)
    stages = args.stages or ["s1", "s3", "s4"]
    unknown = set(stages) - set(STAGES)
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention_variants: no CUDA device; the "
                           "tool times the kernels on the card")
    print(nvidia_smi_line(), flush=True)
    failed = 0
    for stage in stages:
        name, B_, nH, N, C, nW = STAGES[stage]
        print(f"== {stage} {name}: B_={B_} nH={nH} N={N} C={C} "
              f"mask={'y' if nW else 'n'}", flush=True)
        for rec in run([stage]):
            failed += not rec["ok"]
            print(f"  {rec['variant']} ({rec['mxu']}): {rec['ms']:7.3f} ms  "
                  f"max|diff vs v0|={rec['max_diff_vs_v0']:.3e}  "
                  f"rel-L2 vs plain={rec['rel_l2_err']:.2e}"
                  f"{'' if rec['ok'] else '  FAIL'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
