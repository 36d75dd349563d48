"""Layout probes on the card: the six probes of the JAX package's
tools/probe_mosaic.py, asked of an NVIDIA Hopper card.

    python -m mmde_tpu_torch.tools.probe_layouts [name ...]

prints the card's `nvidia-smi --query-gpu=name,power.limit` line, then
`PASS name` or `FAIL name: ...` per probe, and exits 1 if any failed. Each
probe runs its kernel (csrc/probes.cu, built at first use into _build/) on
the JAX probe's inputs and holds it to the plain PyTorch version beside it:
exact for the copies, sums and scalings (fp32), rtol = atol = 1e-4 for the
fp32 product (the JAX probe's own tolerance) and rel-L2 4e-3 for the bf16
tensor-core product against the plain product of the same bf16 operands.

Every kernel wrapper takes a tensor on the card (the kernel) or on the CPU
(its plain version, which the CPU tests hold to the JAX kernels in
interpret mode); `LAUNCHES` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Callable, Dict, List

import torch

from mmde_tpu_torch.tools.card import PEAK_FLOPS, bound, nvidia_smi_line

_LIB_NAME = "probes"
_SOURCES = ("probes.cu",)
SOURCE = "mmde_tpu_torch/csrc/probes.cu"

# probe -> the JAX function and pallas_call line it replaces
REPLACES = {
    "lane_carved_blockspec": "tools/probe_mosaic.py:32 "
                             "(probe_lane_carved_blockspec; pallas_call :41)",
    "inkernel_window_reshape": "tools/probe_mosaic.py:51 "
                               "(probe_inkernel_window_reshape; pallas_call "
                               ":60)",
    "inkernel_reshape_back": "tools/probe_mosaic.py:70 "
                             "(probe_inkernel_reshape_back; pallas_call :78)",
    "static_lane_slice": "tools/probe_mosaic.py:88 "
                         "(probe_static_lane_slice; pallas_call :100)",
    "dynamic_lane_slice": "tools/probe_mosaic.py:109 "
                          "(probe_dynamic_lane_slice; pallas_call :119)",
    "rank4_map_block_matmul": "tools/probe_mosaic.py:129 "
                              "(probe_rank4_map_block_matmul; pallas_call "
                              ":142)",
}
# kernel launches per kernel name (the rank-4 product has two kernels)
LAUNCHES: Dict[str, int] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int


def library_specs() -> dict:
    return {_LIB_NAME: (_SOURCES, ())}


def _library() -> ctypes.CDLL:
    from mmde_tpu_torch.ops.cuda_build import load_library
    lib = load_library(_LIB_NAME, _SOURCES)
    for name, types in (
            ("mmde_probe_lane_carved", [_P, _P, _I, _I, _P]),
            ("mmde_probe_dynamic_slice", [_P, _P, _I, _I, _P]),
            ("mmde_probe_static_slice", [_P, _P, _I, _I, _P]),
            ("mmde_probe_window_rows", [_P, _P] + [_I] * 6 + [_P]),
            ("mmde_probe_rank4_matmul", [_P, _P, _P] + [_I] * 6 + [_P])):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def _launch(kernel: str, entry: str, *args) -> None:
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(_library(), entry)(
            *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed with code {err}")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def _check(x: torch.Tensor, dtype=torch.float32, dim=None) -> None:
    if x.dtype != dtype or not x.is_contiguous() or (
            dim is not None and x.dim() != dim):
        raise ValueError(f"expected a contiguous {dtype} tensor"
                         f"{f' of rank {dim}' if dim else ''}, got "
                         f"{x.dtype} {tuple(x.shape)}")


# ------------------------------------------------------- plain versions

def lane_carved_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def window_rows_plain(xmap: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B * nW, ws*ws, C) windows, image- and row-major,
    + 1."""
    B, Hp, Wp, C = xmap.shape
    w = xmap.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4,
                                                              5)
    return w.reshape(-1, ws * ws, C) + 1.0


def window_rows_back_plain(rows: torch.Tensor, B: int, Hp: int, Wp: int,
                           ws: int) -> torch.Tensor:
    """(B * nW, ws*ws, C) -> the (B, Hp, Wp, C) map, * 3."""
    C = rows.shape[-1]
    m = rows.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4,
                                                              5)
    return m.reshape(B, Hp, Wp, C) * 3.0


def static_slice_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, 512) -> (N, 32), the 16 column slices summed in order."""
    acc = torch.zeros_like(x[:, :32])
    for h in range(x.shape[1] // 32):
        acc = acc + x[:, 32 * h:32 * h + 32]
    return acc


def dynamic_slice_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def rank4_matmul_plain(xmap: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, Hp, Wp, C) @ (C, C) in fp32 (bf16 operands taken as they are)."""
    return torch.einsum("bhwc,cd->bhwd", xmap.float(), w.float())


# ------------------------------------------------------------ wrappers

def lane_carved(x: torch.Tensor) -> torch.Tensor:
    """x * 2, block h owning columns 32h..32h+31 (16-byte loads)."""
    _check(x, dim=2)
    if not x.is_cuda:
        return lane_carved_plain(x)
    out = torch.empty_like(x)
    _launch("lane_carved_blockspec", "mmde_probe_lane_carved", x, out,
            x.shape[0], x.shape[1])
    return out


def window_rows(xmap: torch.Tensor, ws: int) -> torch.Tensor:
    _check(xmap, dim=4)
    if not xmap.is_cuda:
        return window_rows_plain(xmap, ws)
    B, Hp, Wp, C = xmap.shape
    rows = torch.empty((B * (Hp // ws) * (Wp // ws), ws * ws, C),
                       dtype=xmap.dtype, device=xmap.device)
    _launch("inkernel_window_reshape", "mmde_probe_window_rows", xmap, rows,
            B, Hp, Wp, C, ws, 0)
    return rows


def window_rows_back(rows: torch.Tensor, B: int, Hp: int, Wp: int,
                     ws: int) -> torch.Tensor:
    _check(rows, dim=3)
    if not rows.is_cuda:
        return window_rows_back_plain(rows, B, Hp, Wp, ws)
    xmap = torch.empty((B, Hp, Wp, rows.shape[-1]), dtype=rows.dtype,
                       device=rows.device)
    _launch("inkernel_reshape_back", "mmde_probe_window_rows", xmap, rows, B,
            Hp, Wp, rows.shape[-1], ws, 1)
    return xmap


def static_slice(x: torch.Tensor) -> torch.Tensor:
    _check(x, dim=2)
    if not x.is_cuda:
        return static_slice_plain(x)
    out = torch.empty((x.shape[0], 32), dtype=x.dtype, device=x.device)
    _launch("static_lane_slice", "mmde_probe_static_slice", x, out,
            x.shape[0], x.shape[1])
    return out


def dynamic_slice(x: torch.Tensor) -> torch.Tensor:
    _check(x, dim=2)
    if not x.is_cuda:
        return dynamic_slice_plain(x)
    out = torch.empty_like(x)
    _launch("dynamic_lane_slice", "mmde_probe_dynamic_slice", x, out,
            x.shape[0], x.shape[1])
    return out


def rank4_matmul(xmap: torch.Tensor, w: torch.Tensor, ws: int
                 ) -> torch.Tensor:
    """(B, Hp, Wp, 128) @ (128, 128) -> fp32, one block per ws x ws window
    (TMA boxes); both fp32 (FMAs) or both bf16 (mma.sync)."""
    _check(xmap, xmap.dtype, dim=4)
    _check(w, xmap.dtype, dim=2)
    if xmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fp32 or bf16 operands, got {xmap.dtype}")
    if not xmap.is_cuda:
        return rank4_matmul_plain(xmap, w)
    B, Hp, Wp, C = xmap.shape
    out = torch.empty((B, Hp, Wp, C), dtype=torch.float32,
                      device=xmap.device)
    bf16 = xmap.dtype == torch.bfloat16
    _launch("rank4_map_block_matmul" + ("_bf16" if bf16 else ""),
            "mmde_probe_rank4_matmul", xmap, w, out, B, Hp, Wp, C, ws,
            int(bf16))
    return out


# --------------------------------------------------------------- probes

def _bound(nbytes: int, flops: int = 0, dtype: str = "float32") -> dict:
    return bound(nbytes, flops / PEAK_FLOPS[dtype], flops=flops)


def _exact(got, want) -> dict:
    err = float((got.double() - want.double()).abs().max())
    return {"max_abs_err": err, "ok": err == 0.0, "tolerance": "exact"}


def _cases(device) -> Dict[str, Callable]:
    """probe -> () -> [(kernel name, run kernel, run plain, check(got, want),
    bound, library call or None)], on the JAX probe's inputs."""
    dev = torch.device(device)
    N, C = 256, 512
    ar = torch.arange(N * C, dtype=torch.float32, device=dev).reshape(N, C)
    ones = torch.ones((N, C), dtype=torch.float32, device=dev)
    ws = 30
    win = torch.arange(ws * ws * 128, dtype=torch.float32,
                       device=dev).reshape(1, ws, ws, 128)
    rows = win.reshape(1, ws * ws, 128).clone()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, nwh, nww = 2, 2, 3
    xm = torch.randn((B, ws * nwh, ws * nww, 128), generator=gen, device=dev)
    wm = torch.randn((128, 128), generator=gen, device=dev)
    xb, wb = xm.bfloat16(), wm.bfloat16()

    def close(got, want):
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
        return {"max_abs_err": err, "ok": ok,
                "tolerance": {"rtol": 1e-4, "atol": 1e-4}}

    def rel(got, want):
        r = float((got - want).norm() / want.norm())
        return {"max_abs_err": float((got - want).abs().max()),
                "rel_l2_err": r, "ok": r <= 4e-3,
                "tolerance": {"rel_l2": 4e-3}}

    px = B * ws * nwh * ws * nww
    return {
        "lane_carved_blockspec": lambda: [(
            "lane_carved_blockspec", lambda: lane_carved(ar),
            lambda: lane_carved_plain(ar), _exact, _bound(2 * N * C * 4),
            lambda: torch.mul(ar, 2.0))],
        "inkernel_window_reshape": lambda: [(
            "inkernel_window_reshape", lambda: window_rows(win, ws),
            lambda: window_rows_plain(win, ws), _exact,
            _bound(2 * ws * ws * 128 * 4),
            lambda: torch.add(win.view(ws * ws, 128), 1.0))],
        "inkernel_reshape_back": lambda: [(
            "inkernel_reshape_back",
            lambda: window_rows_back(rows, 1, ws, ws, ws),
            lambda: window_rows_back_plain(rows, 1, ws, ws, ws), _exact,
            _bound(2 * ws * ws * 128 * 4), lambda: torch.mul(rows, 3.0))],
        "static_lane_slice": lambda: [(
            "static_lane_slice", lambda: static_slice(ones),
            lambda: static_slice_plain(ones), _exact,
            _bound(N * C * 4 + N * 32 * 4),
            lambda: torch.sum(ones.view(N, C // 32, 32), dim=1))],
        "dynamic_lane_slice": lambda: [(
            "dynamic_lane_slice", lambda: dynamic_slice(ar),
            lambda: dynamic_slice_plain(ar), _exact, _bound(2 * N * C * 4),
            lambda: torch.mul(ar, 2.0))],
        "rank4_map_block_matmul": lambda: [
            ("rank4_map_block_matmul", lambda: rank4_matmul(xm, wm, ws),
             lambda: rank4_matmul_plain(xm, wm), close,
             _bound(2 * px * 128 * 4 + 128 * 128 * 4, 2 * px * 128 * 128),
             lambda: torch.matmul(xm.view(-1, 128), wm)),
            ("rank4_map_block_matmul_bf16", lambda: rank4_matmul(xb, wb, ws),
             lambda: rank4_matmul_plain(xb, wb), rel,
             _bound(px * 128 * 6 + 128 * 128 * 2, 2 * px * 128 * 128,
                    "bfloat16"),
             lambda: torch.matmul(xb.view(-1, 128), wb))],
    }


def run(names: List[str] = None, device="cuda", timed: bool = False,
        time_fn=None) -> List[dict]:
    """Each probe's cases: kernel (on `device`) against its plain version;
    one record per kernel, "ok" False where it disagrees or raised. With
    `timed`, time_fn(call) -> ms times the kernel, the plain version and
    the library call (the launches for timing count in LAUNCHES too: read
    the counts before)."""
    cases = _cases(device)
    out = []
    for name in names or list(REPLACES):
        for kernel, fn, plain, check, bound, library in cases[name]():
            rec = {"probe": name, "name": kernel, "replaces": REPLACES[name]}
            try:
                got = fn()
                want = plain()
                if device != "cpu":
                    torch.cuda.synchronize()
                rec.update(check(got, want))
                if not bool(torch.isfinite(got).all()):
                    rec["ok"] = False
            except Exception as e:  # noqa: BLE001 - reported as FAIL
                rec.update(ok=False, error=f"{type(e).__name__}: {e}")
            if timed and rec["ok"]:
                rec["ms"] = time_fn(fn)
                rec["plain_ms"] = time_fn(plain)
                rec["library_ms"] = time_fn(library)
            rec.update(bound)
            out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*",
                    help=f"probes to run (default: all six): {list(REPLACES)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(REPLACES)
    if unknown:
        ap.error(f"unknown probes {sorted(unknown)}")
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("probe_layouts: no CUDA device; the probes "
                               "ask the card (--device cpu runs the plain "
                               "versions only)")
        print(nvidia_smi_line(), flush=True)
    failed = 0
    for rec in run(args.names or None, args.device):
        if rec["ok"]:
            print(f"PASS {rec['name']}", flush=True)
        else:
            failed += 1
            why = rec.get("error") or f"max |err| {rec['max_abs_err']:.3e}"
            print(f"FAIL {rec['name']}: {why}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
