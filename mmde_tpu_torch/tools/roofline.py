"""Measured unit rates on the card, and the window-attention kernels' work
converted to time at those rates: the JAX package's tools/roofline.py (T3)
for the port.

    python -m mmde_tpu_torch.tools.roofline [micro|attn|fixed|all]
        [--measure] [--pairs 8]

prints the card's `nvidia-smi --query-gpu=name,power.limit` line, then:

  micro  sustained rates of csrc/roofline.cu's micro-kernels, each read off
         the difference of two in-kernel iteration counts (launch cost
         cancels), as the JAX tool's `microbench`: fp32 add and FMA chains,
         expf and __expf chains, a warp-shuffle row-sum chain over 1024-wide
         rows, the attention dot pattern at Dh = 32 as fp32 FMAs and as bf16
         mma.sync, and a 16-byte-vector copy over 256 MB. A rate above 105 %
         of a published peak (fp32 67 TFLOP/s, bf16 989 TFLOP/s, 3.35 TB/s,
         at 700 W) fails the run: the measurement would be wrong.
  attn   per flagship stage (480x640, `--pairs` frame pairs; 8 = the JAX
         tool's table), the port's K1 (forward with log-sum-exp) and K2
         (backward) work counted from their tiles in csrc/ (64-row tiles,
         padded edges included): products, exps and bytes, as FMA-, MUFU-
         and bytes-bound times at the measured rates; `--measure` adds the
         kernels' measured ms (bf16, the default mode "fold").
  fixed  the decoder tail and pose convolutions and the LayerNorm traffic
         of a train step, and K2's dbias atomics, as times at the measured
         bf16 product and copy rates.

Every micro-kernel wrapper takes a tensor on the card (the kernel) or on
the CPU (its plain version, which the CPU tests hold to the JAX kernels in
interpret mode); `LAUNCHES` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import sys
from typing import Dict

import torch

from mmde_tpu_torch.tools.card import (FP32_OPS_PER_S, HBM_BYTES_PER_S,
                                       MUFU_OPS_PER_S, PEAK_FLOPS, bound,
                                       nvidia_smi_line, time_ms)

_LIB_NAME = "roofline"
_SOURCES = ("roofline.cu",)
SOURCE = "mmde_tpu_torch/csrc/roofline.cu"
REPLACES = {
    "vpu": "tools/roofline.py:86 (_vpu_kernel; pallas_call :110)",
    "mxu": "tools/roofline.py:115 (_mxu_kernel; pallas_call :143)",
}
OPS = {"add": 0, "fma": 1, "exp": 2, "fastexp": 3}
FMA_A, FMA_B = 0.999, 1e-3     # the fma chain's x * a + b (fp32 values)
SHAPE = (512, 1024)            # the JAX tool's VPU block
DOT_BQ, DOT_NP, DOT_HEADS, DOT_DH = 304, 912, 4, 32
DOT_COPIES = 8                 # copies of the dot pattern: 600 blocks
COPY_BYTES = 256 * 1024 * 1024
# rate key -> published peak it may not exceed by more than 5 %
PEAKS = {"fma_TFLOP_s": PEAK_FLOPS["float32"] / 1e12,
         "dot_fp32_TFLOP_s": PEAK_FLOPS["float32"] / 1e12,
         "dot_bf16_TFLOP_s": PEAK_FLOPS["bfloat16"] / 1e12,
         "copy_GB_s": HBM_BYTES_PER_S / 1e9}
LAUNCHES: Dict[str, int] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int


def library_specs() -> dict:
    return {_LIB_NAME: (_SOURCES, ())}


def _library() -> ctypes.CDLL:
    from mmde_tpu_torch.ops.cuda_build import load_library
    lib = load_library(_LIB_NAME, _SOURCES)
    for name, types in (
            ("mmde_roofline_chain", [_P, _I, _I, _I, _P]),
            ("mmde_roofline_rowsum", [_P, _I, _I, _I, _P]),
            ("mmde_roofline_dot", [_P, _P, _P] + [_I] * 5 + [_P]),
            ("mmde_roofline_copy", [_P, _P, ctypes.c_longlong, _P])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _launch(kernel: str, entry: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        err = getattr(_library(), entry)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed with code {err}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


# ------------------------------------------------------- plain versions

def chain_plain(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """8 * iters dependent applications of `op` to every element (fp32):
    add x + 1.0009765625, fma x * a + b (fused: computed in fp64 and
    rounded once), exp / fastexp exp(x * 1e-4)."""
    x = x.clone()
    a = torch.tensor(FMA_A, dtype=torch.float32).double()
    b = torch.tensor(FMA_B, dtype=torch.float32).double()
    for _ in range(8 * iters):
        if op == "add":
            x = x + 1.0009765625
        elif op == "fma":
            x = (x.double() * a + b).float()
        else:
            x = torch.exp(x * 1e-4)
    return x


def rowsum_plain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """8 * iters of x += rowsum(x) * 1e-6 over the last axis."""
    for _ in range(8 * iters):
        x = x + x.sum(-1, keepdim=True) * 1e-6
    return x


def dot_plain(q: torch.Tensor, k: torch.Tensor, iters: int) -> torch.Tensor:
    """acc (bq, np) fp32 = iters times the sum over heads of
    q_h k_h^T, accumulated as the JAX kernel does."""
    qf, kf = q.float(), k.float()
    acc = torch.zeros((q.shape[0], k.shape[0]), dtype=torch.float32,
                      device=q.device)
    for _ in range(iters):
        for h in range(DOT_HEADS):
            cs = slice(h * DOT_DH, (h + 1) * DOT_DH)
            acc = acc + qf[:, cs] @ kf[:, cs].T
    return acc


# ------------------------------------------------------------ wrappers

def chain(x: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """A copy of x (fp32, size a multiple of 4) after the chain."""
    if x.dtype != torch.float32 or x.numel() % 4 or op not in OPS:
        raise ValueError(f"fp32 x of 4k elements and an op of {list(OPS)}")
    if not x.is_cuda:
        return chain_plain(x, op, iters)
    y = x.contiguous().clone()
    _launch(f"chain_{op}", "mmde_roofline_chain", y.device, y.data_ptr(),
            y.numel(), OPS[op], iters)
    return y


def rowsum(x: torch.Tensor, iters: int) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 1024:
        raise ValueError("fp32 x of 1024-wide rows")
    if not x.is_cuda:
        return rowsum_plain(x, iters)
    y = x.contiguous().clone()
    _launch("rowsum", "mmde_roofline_rowsum", y.device, y.data_ptr(),
            y.shape[0], y.shape[1], iters)
    return y


def dot(q: torch.Tensor, k: torch.Tensor, iters: int, copies: int = 1
        ) -> torch.Tensor:
    """(copies, bq, np) fp32: the dot pattern, `copies` times over."""
    if q.dtype != k.dtype or q.dtype not in (torch.float32, torch.bfloat16) \
            or q.shape[1] != DOT_HEADS * DOT_DH or k.shape[1] != q.shape[1]:
        raise ValueError("q (bq, 128), k (np, 128), both fp32 or bf16")
    if not q.is_cuda:
        return dot_plain(q, k, iters)[None].expand(copies, -1, -1)
    q, k = q.contiguous(), k.contiguous()
    acc = torch.empty((copies, q.shape[0], k.shape[0]), dtype=torch.float32,
                      device=q.device)
    bf16 = q.dtype == torch.bfloat16
    _launch("dot_bf16" if bf16 else "dot_fp32", "mmde_roofline_dot",
            q.device, q.data_ptr(), k.data_ptr(), acc.data_ptr(), q.shape[0],
            k.shape[0], iters, copies, int(bf16))
    return acc


def copy(src: torch.Tensor) -> torch.Tensor:
    if src.dtype != torch.float32 or src.numel() % 4:
        raise ValueError("fp32 src of 4k elements")
    if not src.is_cuda:
        return src.clone()
    dst = torch.empty_like(src)
    _launch("copy", "mmde_roofline_copy", src.device, src.data_ptr(),
            dst.data_ptr(), src.numel())
    return dst


# ----------------------------------------------------------- microbench

def _diff_rate(run, work_per_iter: float, target_ms: float = 4.0) -> dict:
    """Rate = work of the extra iterations / extra time, between `lo`
    iterations (sized so one launch takes ~target_ms) and 4 * lo."""
    it0 = 16
    t0 = time_ms(lambda: run(it0), reps=3, warm=1)
    lo = max(it0, int(it0 * target_ms / max(t0, 1e-3)))
    hi = 4 * lo
    t_lo = time_ms(lambda: run(lo), reps=5, warm=1)
    t_hi = time_ms(lambda: run(hi), reps=5, warm=1)
    rate = work_per_iter * (hi - lo) / ((t_hi - t_lo) / 1e3)
    return {"rate": rate, "iters": [lo, hi], "ms": [t_lo, t_hi]}


def microbench(device="cuda") -> dict:
    """Measured sustained rates on this card: {key: value}, plus "_detail"
    (iteration counts and times). Raises where a rate exceeds 105 % of its
    published peak."""
    dev = torch.device(device)
    n = SHAPE[0] * SHAPE[1]
    x = torch.ones(SHAPE, dtype=torch.float32, device=dev)
    rates, detail = {}, {}
    for op, key, scale in (("add", "add_Gop_s", 1e9),
                           ("fma", "fma_TFLOP_s", 1e12 / 2),
                           ("exp", "expf_Gel_s", 1e9),
                           ("fastexp", "fastexp_Gel_s", 1e9)):
        d = _diff_rate(lambda it, op=op: chain(x, op, it), 8 * n)
        rates[key], detail[key] = d["rate"] / scale, d
    d = _diff_rate(lambda it: rowsum(x, it), 8 * n)
    rates["rowsum_Gel_s"], detail["rowsum_Gel_s"] = d["rate"] / 1e9, d
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = torch.randn((DOT_BQ, 128), generator=gen, device=dev)
    k = torch.randn((DOT_NP, 128), generator=gen, device=dev)
    macs = DOT_BQ * DOT_NP * 128 * DOT_COPIES
    for dtype, key in ((torch.float32, "dot_fp32_TFLOP_s"),
                       (torch.bfloat16, "dot_bf16_TFLOP_s")):
        qq, kk = q.to(dtype), k.to(dtype)
        d = _diff_rate(lambda it: dot(qq, kk, it, DOT_COPIES), 2 * macs)
        rates[key], detail[key] = d["rate"] / 1e12, d
    src = torch.ones(COPY_BYTES // 4, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: copy(src), reps=10, warm=2)
    rates["copy_GB_s"] = 2 * COPY_BYTES / (ms / 1e3) / 1e9
    detail["copy_GB_s"] = {"ms": ms, "bytes": 2 * COPY_BYTES}
    over = {k: (v, PEAKS[k]) for k, v in rates.items()
            if k in PEAKS and v > 1.05 * PEAKS[k]}
    if over:
        raise RuntimeError(f"measured rates above 105 % of the published "
                           f"peak (a timing fault): {over}")
    rates["_detail"] = detail
    return rates


# ----------------------------------------------------- attention costs

def stages(pairs: int = 8) -> dict:
    """Flagship attention calls at 480x640 and `pairs` frame pairs:
    {name: (B_, nH, N, C, nW, blocks)}, nW the mask's windows (0: no
    mask); pairs = 8 is the JAX tool's STAGES (bs8, 16 images)."""
    out = {}
    for i, (nw, nH, N, C, masked, blocks) in enumerate((
            (24, 4, 900, 128, True, 2), (6, 8, 900, 256, True, 2),
            (2, 16, 900, 512, False, 18), (2, 32, 225, 1024, False, 2))):
        out[f"s{i + 1}"] = (2 * pairs * nw, nH, N, C, nw if masked else 0,
                            blocks)
    return out


def attention_cost(B_: int, nH: int, N: int, C: int, nW: int,
                   rates: dict, mxu: str = "fold") -> dict:
    """The port's K1 (+ log-sum-exp) and K2 work at one bf16 shape, from
    their tiles in csrc/ (64 x 64 tiles over padded edges): N x N x 32 tile
    products (K1: two per (query tile, key tile); K2: four in the dq pass,
    five under "bf16", whose first sweep sums delta, and four in the dk/dv
    pass), exps (one per pass and sweep), and the bytes of the function
    (each input read once, each output written once; bias and mask in
    bf16); converted to FMA-, MUFU- and bytes-bound ms at `rates` (the fp32
    dot pattern's, __expf's and the copy's)."""
    nT = -(-N // 64)
    pairs_ = B_ * nH * nT * nT                  # (query tile, key tile)
    tile = 64 * 64 * 32                         # MACs of one tile product
    esz = 2
    fwd_bytes = (B_ * N * 4 * C * esz + (nH + nW) * N * N * esz
                 + B_ * nH * N * 4)
    bwd_bytes = (B_ * N * 8 * C * esz + (2 * nH + nW) * N * N * esz
                 + B_ * nH * N * 4)
    out = {}
    for name, products, exps, nbytes in (
            ("fwd", 2, 1, fwd_bytes),
            ("bwd", 9 if mxu == "bf16" else 8, 3 if mxu == "bf16" else 2,
             bwd_bytes)):
        flops = 2 * products * tile * pairs_
        n_exp = exps * 64 * 64 * pairs_
        fma_ms = flops / (rates["dot_fp32_TFLOP_s"] * 1e12) * 1e3
        mufu_ms = n_exp / (rates["fastexp_Gel_s"] * 1e9) * 1e3
        bytes_ms = nbytes / (rates["copy_GB_s"] * 1e9) * 1e3
        out[name] = {"flops": flops, "exps": n_exp, "bytes": nbytes,
                     "fma_ms": fma_ms, "mufu_ms": mufu_ms,
                     "bytes_ms": bytes_ms, "serial_ms": fma_ms + mufu_ms,
                     "max_ms": max(fma_ms, mufu_ms, bytes_ms),
                     "fma_bound_ms_at_peak":
                         flops / PEAK_FLOPS["float32"] * 1e3}
    return out


def measure_stage(B_: int, nH: int, N: int, C: int, nW: int,
                  seed: int = 0) -> dict:
    """K1 with the log-sum-exp and K2 (bf16, the default mode) at one
    shape, their fp32-FMA bodies (the bodies the FMA-bound times model;
    the model's bf16 path runs the tensor-core kernels): median ms of one
    launch (CUDA events)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qkv = torch.randn((B_, N, 3 * C), generator=gen, device="cuda").bfloat16()
    ls = torch.full((nH, 1, 1), 2.0, device="cuda")
    bias = (16 * torch.sigmoid(torch.randn((nH, N, N), generator=gen,
                                           device="cuda"))).bfloat16()
    mask = None
    if nW:
        m = torch.rand((nW, N, N), generator=gen, device="cuda") < 0.3
        mask = torch.where(m & ~torch.eye(N, dtype=torch.bool, device="cuda"),
                           -100.0, 0.0).bfloat16()
    g = torch.randn((B_, N, C), generator=gen, device="cuda").bfloat16()
    with torch.no_grad():
        fwd = time_ms(lambda: wap._launch_forward(qkv, ls, bias, mask, nH,
                                                  True, True, _fma=True))
        lse = wap._launch_forward(qkv, ls, bias, mask, nH, True, True,
                                  _fma=True)[1]
        bwd = time_ms(lambda: wap._launch_backward(
            qkv, ls, bias, mask, lse, g, nH, "window_resident", True,
            _fma=True), reps=8, warm=2)
    return {"fwd": fwd, "bwd": bwd}


# ------------------------------------------------------- fixed buckets

def fixed_buckets(rates: dict, pairs: int = 8) -> list:
    """Byte / flop bounds of a train step's non-attention buckets at
    `pairs` frame pairs (2 * pairs images, bf16): decoder tail and pose
    convolutions (forward, input and weight gradients) at the measured bf16
    product rate and copy rate; fp32 LayerNorm traffic and K2's dbias
    atomics at the copy rate."""
    img = 2 * pairs
    convs = ((2048, 32, 30, 40, 2), (32, 32, 60, 80, 2),
             (32, 32, 120, 160, 2), (32, 256, 120, 160, 3),
             (256, 256, 480, 640, 3), (256, 1, 480, 640, 3))
    flops = nbytes = 0
    for ci, co, h, w, k in convs:
        flops += 3 * 2 * k * k * ci * co * h * w * img
        nbytes += (ci + co) * h * w * 2 * img * 3
    for h, w, c in ((120, 160, 128), (240, 320, 128)):
        nbytes += (h * w + 4 * h * w) * c * 2 * img * 2
    for h, w in ((15, 20), (8, 10), (8, 10), (4, 5), (4, 5)):
        flops += 3 * 2 * 9 * 2048 * 2048 * h * w * img
    bw = rates["copy_GB_s"] * 1e9
    out = [("decoder tail + pose", {
        "flops_T": flops / 1e12,
        "product_ms": flops / (rates["dot_bf16_TFLOP_s"] * 1e12) * 1e3,
        "bytes_ms": nbytes / bw * 1e3})]
    ln = 0
    for h, w, c, nb in ((120, 160, 128, 2), (60, 80, 256, 2),
                        (30, 40, 512, 18), (15, 20, 1024, 2)):
        t = img * h * w * c * 2
        ln += nb * 2 * (2 * t + 2.5 * 2 * t)
    out.append(("fp32 LayerNorm traffic", {"bytes_GB": ln / 1e9,
                                           "bytes_ms": ln / bw * 1e3}))
    atomics = sum(nb * B_ * nH * (-(-N // 64) * 64) ** 2
                  for B_, nH, N, C, nW, nb in stages(pairs).values())
    out.append(("K2 dbias fp32 atomics", {"atomics_G": atomics / 1e9,
                                          "bytes_ms": 8 * atomics / bw * 1e3}))
    return out


# ---------------------------------------------- kernel check and bounds

def check_cases(device="cuda", iters: int = 16) -> list:
    """Each micro-kernel at `iters` iterations against its plain version on
    the same inputs: (kernel, run kernel, run plain, rel tolerance, bound,
    library call or None). fp32 results agree to rounding (the kernels run
    the same ops in the same order, except the fma's fusion and the sums'
    order); bf16 dots are fp32 sums of bf16 products."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = SHAPE[0] * SHAPE[1]
    x = torch.rand(SHAPE, generator=gen, device=dev)
    q = torch.randn((DOT_BQ, 128), generator=gen, device=dev)
    k = torch.randn((DOT_NP, 128), generator=gen, device=dev)
    src = torch.rand(COPY_BYTES // 4, generator=gen, device=dev)
    ops = 8 * iters * n
    cases = []
    for op in ("add", "fma", "exp", "fastexp"):
        op_s = (ops * 2 / PEAK_FLOPS["float32"] if op == "fma"
                else ops / FP32_OPS_PER_S if op == "add"
                else ops / MUFU_OPS_PER_S)
        cases.append((f"chain_{op}", lambda op=op: chain(x, op, iters),
                      lambda op=op: chain_plain(x, op, iters),
                      1e-6 if op != "fastexp" else 2e-6,
                      bound(2 * n * 4, op_s, ops=ops), None))
    cases.append(("rowsum", lambda: rowsum(x, iters),
                  lambda: rowsum_plain(x, iters), 1e-6,
                  bound(2 * n * 4, 2 * ops / FP32_OPS_PER_S, ops=2 * ops),
                  None))
    macs = DOT_BQ * DOT_NP * 128 * iters
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk = q.to(dtype), k.to(dtype)
        name = "float32" if dtype == torch.float32 else "bfloat16"
        cases.append((f"dot_{'fp32' if name == 'float32' else 'bf16'}",
                      lambda qq=qq, kk=kk: dot(qq, kk, iters)[0],
                      lambda qq=qq, kk=kk: dot_plain(qq, kk, iters), 1e-5,
                      bound((DOT_BQ + DOT_NP) * 128 * qq.element_size()
                            + DOT_BQ * DOT_NP * 4,
                            2 * macs / PEAK_FLOPS[name], flops=2 * macs),
                      None))
    cases.append(("copy", lambda: copy(src), lambda: src.clone(), 0.0,
                  bound(2 * COPY_BYTES), lambda: torch.empty_like(src).copy_(
                      src)))
    return cases


def check(device="cuda", iters: int = 16, timed: bool = False) -> list:
    """Run check_cases: one record per micro-kernel with its rel-L2 error
    against the plain version ("ok" within the stated tolerance) and, with
    `timed`, ms, plain ms and library ms at that size."""
    out = []
    for name, fn, plain, tol, bnd, library in check_cases(device, iters):
        got, want = fn(), plain()
        err = float((got.double() - want.double()).norm()
                    / want.double().norm())
        rec = {"name": name, "iters": iters, "rel_l2_err": err,
               "max_abs_err": float((got - want).abs().max()),
               "tolerance_rel_l2": tol,
               "ok": err <= tol and bool(torch.isfinite(got).all())}
        rec.update(bnd)
        if timed:
            rec["ms"] = time_ms(fn)
            rec["plain_ms"] = time_ms(plain, reps=3, warm=1)
            rec["library_ms"] = None if library is None else time_ms(library)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", default="all",
                    choices=["micro", "attn", "fixed", "all"])
    ap.add_argument("--measure", action="store_true",
                    help="also time K1 and K2 at each stage")
    ap.add_argument("--pairs", type=int, default=8,
                    help="frame pairs of the attention shapes (8: the JAX "
                         "tool's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("roofline: no CUDA device; the rates are the "
                           "card's")
    print(nvidia_smi_line(), flush=True)
    bad = [r for r in check() if not r["ok"]]
    if bad:
        print(f"FAIL micro-kernels disagree with their plain versions: "
              f"{bad}", flush=True)
        return 1
    rates = microbench()
    print("\n== measured unit rates (this card) ==")
    for key, v in rates.items():
        if not key.startswith("_"):
            print(f"  {key:20s} {v:12.3f}")
    if args.what in ("attn", "all"):
        print(f"\n== attention kernels, {args.pairs} frame pairs, bf16 "
              "(ms) ==")
        print(f"  {'stage':5s} {'dir':3s} {'fma':>8s} {'mufu':>8s} "
              f"{'bytes':>8s} {'serial':>8s} {'fma@peak':>8s} {'meas':>8s}")
        for s, (B_, nH, N, C, nW, _) in stages(args.pairs).items():
            cost = attention_cost(B_, nH, N, C, nW, rates)
            meas = (measure_stage(B_, nH, N, C, nW) if args.measure
                    else {"fwd": math.nan, "bwd": math.nan})
            for d in ("fwd", "bwd"):
                c = cost[d]
                print(f"  {s:5s} {d:3s} {c['fma_ms']:8.3f} "
                      f"{c['mufu_ms']:8.3f} {c['bytes_ms']:8.3f} "
                      f"{c['serial_ms']:8.3f} "
                      f"{c['fma_bound_ms_at_peak']:8.3f} {meas[d]:8.3f}")
    if args.what in ("fixed", "all"):
        print(f"\n== fixed buckets, {args.pairs} frame pairs ==")
        for name, d in fixed_buckets(rates, args.pairs):
            parts = " ".join(f"{k}={v:.3f}" for k, v in d.items())
            print(f"  {name:28s} {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
