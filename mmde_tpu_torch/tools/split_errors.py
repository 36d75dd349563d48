"""How far each way of putting fp32 operands on bf16 (or TF32) tensor cores
lands from the exact function, on the CPU: the arithmetic of the
tensor-core window-attention kernels (mmde_tpu_torch/testing.py's
emulation) on unrounded fp32 qkv and g against float64 autograd of the
plain function, at heads of scale 60 and 100 (logit_scale = ln 60, ln 100),
masked, K4's backward (`tc_backward_resident`) and K5's at W = 3
(`tc_backward`, mode fp32).

Splits: "bf16x3" - each fp32 operand as three bf16 pieces, six piece
products (the fp32-qkv kernels' choice); "bf16x2" - two pieces, three
products (what the bf16-qkv kernels do with their in-register operands);
"tf32x3" - TF32 hi + lo, three products (3xTF32). Each is held to the fp32
limits the card checks the kernels against (forward max abs 5e-5; dqkv and
dbias rel-L2 2e-5; dlogit_scale 2e-4 relative to its largest entry).

    python -m mmde_tpu_torch.tools.split_errors [--n 64] [--seed 0]

prints one JSON line per split: the largest error of each quantity over
the two scales, and whether it holds each limit.
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Optional

import numpy as np
import torch

from mmde_tpu_torch import testing
from mmde_tpu_torch.ops import window_attention_packed as wap

LIMITS = {"out": 5e-5, "dqkv": 2e-5, "dbias": 2e-5, "dlogit_scale": 2e-4}


def inputs(n: int, scale: float, seed: int, B: int = 6, nW: int = 3):
    """B windows of n tokens, nH = 4 heads all at `scale` (the clamped
    ln 100 one gets dlogit_scale 0), 16*sigmoid bias, 0 / -100 mask over
    nW windows, unrounded fp32 qkv and g."""
    rng = np.random.default_rng(seed)
    nH, C = 4, 128
    qkv = rng.standard_normal((B, n, 3 * C)).astype(np.float32)
    ls = np.full((nH, 1, 1), math.log(scale), np.float32)
    if scale >= 100.0:
        ls[0] = math.log(100.0) - 1e-3    # one head just inside the clamp
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, n, n))))
            ).astype(np.float32)
    m = (rng.random((nW, n, n)) < 0.3) & ~np.eye(n, dtype=bool)[None]
    mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    return qkv, ls, bias, mask, g, nH


def exact(qkv, ls, bias, mask, g, nH):
    """float64 autograd of the plain forward: out, dqkv, dls, dbias."""
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (qkv, ls, bias)]
    out = wap.cosine_window_attention_packed_plain(
        *leaves, torch.from_numpy(mask).double(), num_heads=nH,
        compute_dtype=torch.float64)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).double())
    return [out.detach()] + [x.detach() for x in grads]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away), as
    cvt.rna.tf32.f32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, pa, pb):
    """3xTF32: a_hi b_hi + a_hi b_lo + a_lo b_hi, hi = tf32(x), lo =
    tf32(x - hi)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate(split: str, x, windows: Optional[int]):
    """out and the three gradients of one split: `windows` None is K4 (one
    chunk per window), an int K5 at that W."""
    qkv, ls, bias, mask, g, nH = x
    pieces = {"bf16x3": 3, "bf16x2": 2, "tf32x3": 3}[split]
    saved = testing._mm
    if split == "tf32x3":
        testing._mm = _mm_tf32
    try:
        out = testing.tc_forward(qkv, ls, bias, mask, nH, "fp32",
                                 maxfree=False, pieces=pieces)
        if windows is None:
            grads = testing.tc_backward_resident(
                qkv, ls, bias, mask, g, nH, splits=qkv.shape[0],
                pieces=pieces)
        else:
            grads = testing.tc_backward(qkv, ls, bias, mask, g, nH, "fp32",
                                        windows=windows, pieces=pieces)
    finally:
        testing._mm = saved
    return [out] + list(grads)


def errors(got, want) -> dict:
    """forward max abs; dqkv / dbias rel-L2; dlogit_scale max abs relative
    to its largest entry."""
    out, dqkv, dls, dbias = (a.double().reshape(b.shape)
                             for a, b in zip(got, want))
    o, q, l, b = want
    return {"out": float((out - o).abs().max()),
            "dqkv": float((dqkv - q).norm() / q.norm()),
            "dbias": float((dbias - b).norm() / b.norm()),
            "dlogit_scale": float((dls - l).abs().max() / l.abs().max())}


def measure(n: int = 64, seed: int = 0) -> dict:
    """{split: {quantity: largest error over scales 60 / 100 and K4 / K5}}."""
    res = {s: {k: 0.0 for k in LIMITS} for s in ("bf16x3", "bf16x2",
                                                 "tf32x3")}
    for i, scale in enumerate((60.0, 100.0)):
        x = inputs(n, scale, seed + i)
        want = exact(*x)
        for split in res:
            for windows in (None, 3):
                e = errors(emulate(split, x, windows), want)
                for k, v in e.items():
                    res[split][k] = max(res[split][k], v)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    for split, e in measure(a.n, a.seed).items():
        print(json.dumps({"split": split, "device": "cpu", **e,
                          "holds": {k: e[k] <= LIMITS[k] for k in LIMITS}}))


if __name__ == "__main__":
    main()
