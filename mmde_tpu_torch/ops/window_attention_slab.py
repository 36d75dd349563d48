"""Fused cosine window attention straight off the (B, Hp, Wp, 3C) map.

Counterpart of mmde_tpu/ops/window_attention_slab.py: its forward kernel
(`_fwd_body`, K8) and its backward kernel (`_bwd_body`, K9), behind one
`torch.autograd.Function`. `cosine_window_attention_slab` takes the qkv map
the qkv Linear emits on the padded (and, in a shifted block, rolled) feature
map, the per-head log temperature, the relative-position bias as plain
(nH, N, N) and the shifted-window mask as plain (nW, N, N), and returns the
(B, Hp, Wp, C) map: the model runs no window partition before attention and
no reverse after it. The TPU package's head-group bias packing
(`pack_rpe_bias_slab`) is TPU tiling and has no counterpart here.

The CUDA kernels are the packed kernels' bodies reached through slab entry
points that address each window's token rows in the map (`MapRows`,
csrc/window_attention_common.cuh); on a GPU the map layout is only another
address per row, where the TPU kernel needed static sublane slices and
in-kernel reshapes. Every slab launch of either type runs the tensor-core
kernels (the packed module's `slab_tensor_core_body`;
csrc/window_attention_{fwd,bwd}_tc.cu, bf16 mma.sync, the entries
`mmde_window_attention_slab_{fwd,bwd}_tc`; counted as
window_attention_slab_fwd_tc[+lse] / window_attention_slab_bwd_tc): a bf16
map on its raw values, an fp32 map with every operand in three bf16 pieces,
as the packed fp32 kernels take them (`qkv_bf16` 0). The fp32-FMA bodies
(csrc/window_attention_fwd.cu, csrc/window_attention_bwd.cu;
window_attention_slab_fwd[+lse] / window_attention_slab_bwd) are reached
only through the private `_fma`, the same-card comparison's partner. As the
TPU kernel, the forward keeps a running row maximum for every head (no
max-free softmax) and takes bias and mask in float32 whatever the model's
type; the backward sums dbias over windows in fp32 (by atomics here, in the
resident output block there), gives `dlogit_scale` zero where the ln(100)
clamp binds and the mask no gradient. Under MMDE_ATTN_GRID=split and in
deterministic mode (`torch.use_deterministic_algorithms(True)`), both read
at each call (`dbias_split`), the passes run without their atomics and K3
(`bwd_dbias_tc_kernel` over `MapRows`, the entry
`mmde_window_attention_slab_dbias_tc`, counted as
window_attention_slab_dbias_tc) sums dbias window after window in one
fixed order, reading each window's rows in place off the map: the same
bits on every run, as the TPU kernel's resident block gives them.

The log-sum-exp the backward rebuilds p from is what its own forward
wrote: the bf16 tensor-core forward one fp32 number a row, (B*nW, nH, N);
the fp32 tensor-core forward and every FMA forward two, (2, B*nW, nH, N),
the row's m + log(l) formed in fp64 and kept as fp32 hi + lo (fault F3,
`stat_pair`). The statistic carries the body that wrote it (`written_by`):
a backward handed the other body's statistic - the other shape, or the
same shape from the other body - raises before any launch.

For CUDA tensors the wrapper launches the kernels or raises; for CPU tensors
it computes `cosine_window_attention_slab_plain` and, under autograd,
`cosine_window_attention_slab_backward_plain` - the window partition, the
head-split module's plain function, and the reverse - which are also what the
kernels are compared with on the card. `LAUNCHES*` count kernel launches,
and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mmde_tpu_torch.ops.window_attention_headsplit import (
    HEAD_DIM, cosine_window_attention_headsplit_backward_plain,
    cosine_window_attention_headsplit_plain)

LAUNCHES = 0            # incremented once per forward-kernel launch
LAUNCHES_BY_SHAPE: dict = {}    # the same count, keyed by (B*nW, N, C, nH)
LAUNCHES_BWD = 0        # incremented once per backward launch (both passes)
LAUNCHES_BWD_BY_SHAPE: dict = {}
# every launch above, keyed by (kernel, (B*nW, N, C, nH)); kernel names:
# window_attention_slab_fwd_tc[+lse] / window_attention_slab_bwd_tc (the
# tensor cores, either type), window_attention_slab_fwd[+lse] /
# window_attention_slab_bwd (the fp32-FMA body, `_fma` only),
# window_attention_slab_dbias_tc (K3 after the tensor-core passes, under
# `dbias_split`; outside the backward counts above)
LAUNCHES_BY_KERNEL: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
# qkv, logit_scale, bias, mask, out [, lse]; B, Hp, Wp, C, nH, ws, qkv_bf16,
# bias_bf16; stream
_FWD_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]
_FWD_STATS_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]
# qkv, logit_scale, bias, mask, lse, g, dqkv, delta, dls_part, dbias; B, Hp,
# Wp, C, nH, ws, qkv_bf16, bias_bf16, dbias_mode; stream
_BWD_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]
# the tensor-core entries: as the FMA ones, lse nullable in the forward
_FWD_TC_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]
_BWD_TC_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]
# K3: qkv, logit_scale, bias, mask, lse, g, delta, dbias; B, Hp, Wp, C, nH,
# ws, qkv_bf16, bias_bf16; stream
_DBIAS_TC_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
# their occupancy queries: qkv_bf16, masked; the blocks an SM holds (the
# forward's; the dq and dk/dv passes')
_FWD_OCC_ARGTYPES = [_I, _I, _P]
_BWD_OCC_ARGTYPES = [_I, _I, _P, _P]

# The JAX package's slab test, copied (not imported) so both packages send
# the same blocks to the slab kernel: None when C is not a multiple of 128,
# Dh does not divide 128 or the heads do not fill whole 128-lane groups, and
# when a cell's TPU VMEM estimate exceeds 100 MiB (a map wider than ~480
# tokens at window 30). That budget is the TPU's and means nothing on a GPU;
# it is kept for routing parity only.
_VMEM_CAP = 100 * 1024 * 1024


def slab_plan(ws: int, Wp: int, num_heads: int, head_dim: int,
              channels: int):
    """(HG, nG) or None when the slab layout is unusable: the JAX package's
    `slab_plan`. A block takes the slab kernels where it is not None."""
    if channels % 128 != 0 or 128 % head_dim != 0:
        return None
    hg = 128 // head_dim
    if num_heads % hg != 0:
        return None
    n = ws * ws
    cell = 2 * n * hg * n * 4 + 6 * n * n * 4 + 8 * ws * Wp * 128 * 4
    if cell > _VMEM_CAP:
        return None
    return hg, num_heads // hg


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows image-major and row-major.
    H, W must be multiples of ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int,
                   W: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


_ARGTYPES = {"mmde_window_attention_slab_fwd": _FWD_ARGTYPES,
             "mmde_window_attention_slab_fwd_stats": _FWD_STATS_ARGTYPES,
             "mmde_window_attention_slab_bwd": _BWD_ARGTYPES,
             "mmde_window_attention_slab_fwd_tc": _FWD_TC_ARGTYPES,
             "mmde_window_attention_slab_bwd_tc": _BWD_TC_ARGTYPES,
             "mmde_window_attention_slab_dbias_tc": _DBIAS_TC_ARGTYPES,
             "mmde_window_attention_slab_fwd_tc_occupancy": _FWD_OCC_ARGTYPES,
             "mmde_window_attention_slab_bwd_tc_occupancy": _BWD_OCC_ARGTYPES}


def _entry(name: str) -> ctypes._CFuncPtr:
    """A slab entry point of the libraries the packed module builds (the
    same sources hold every layout's entry points), its signature set: the
    tensor-core forward or backward library (the backward's: K3 too) for
    the `_tc` entries, the fp32-FMA ones otherwise."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    if name.endswith(("_tc", "_tc_occupancy")):
        lib = wap._library_tc("bwd" in name or "dbias" in name)
    else:
        lib = wap._library_bwd() if "bwd" in name else wap._library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(qkv_map, logit_scale, bias, mask, num_heads, window_size):
    if qkv_map.dim() != 4 or qkv_map.shape[-1] % 3:
        raise ValueError(f"qkv_map must be (B, Hp, Wp, 3C), got "
                         f"{tuple(qkv_map.shape)}")
    B, Hp, Wp, C3 = qkv_map.shape
    C, ws = C3 // 3, window_size
    if ws <= 0 or Hp % ws or Wp % ws:
        raise ValueError(f"the map ({Hp}, {Wp}) is not a whole number of "
                         f"{ws} x {ws} windows")
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise NotImplementedError(
            f"the window-attention kernel takes head_dim {HEAD_DIM} only "
            f"(C={C}, num_heads={num_heads})")
    if qkv_map.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv_map must be float32 or bfloat16, got "
                        f"{qkv_map.dtype}")
    if logit_scale.dtype != torch.float32 or logit_scale.numel() != num_heads:
        raise ValueError("logit_scale must be float32 with one entry per "
                         f"head, got {logit_scale.dtype} "
                         f"{tuple(logit_scale.shape)}")
    N, nW = ws * ws, (Hp // ws) * (Wp // ws)
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias must be ({num_heads}, {N}, {N}), got "
                         f"{tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, qkv_map.dtype):
        raise TypeError(f"bias must be float32 or qkv_map's type, got "
                        f"{bias.dtype} for {qkv_map.dtype} qkv_map")
    tensors = [("qkv_map", qkv_map), ("logit_scale", logit_scale),
               ("bias", bias)]
    if mask is not None:
        if tuple(mask.shape) != (nW, N, N):
            raise ValueError(f"mask must be ({nW}, {N}, {N}): one row per "
                             f"window of an image, got {tuple(mask.shape)}")
        if mask.dtype != bias.dtype:
            raise TypeError(f"mask ({mask.dtype}) and bias ({bias.dtype}) "
                            "must share a type")
        tensors.append(("mask", mask))
    for name, t in tensors:
        if t.device != qkv_map.device:
            raise ValueError(f"{name} is on {t.device}, qkv_map on "
                             f"{qkv_map.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _heads(win: torch.Tensor, parts: int, nH: int) -> torch.Tensor:
    """(B_, N, parts*C) windows -> (parts, B_, nH, N, Dh), a view."""
    B_, N, W = win.shape
    return win.reshape(B_, N, parts, nH, W // parts // nH).permute(
        2, 0, 3, 1, 4)


def cosine_window_attention_slab_plain(
        qkv_map: torch.Tensor, logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor] = None, *, num_heads: int,
        window_size: int, compute_dtype: torch.dtype = torch.float32
        ) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, on any device: the
    window partition of the map, the head-split plain function (in
    `compute_dtype`; float64 gives the ground truth the kernels' gradients
    are checked against), and the reverse. Output in qkv_map's type."""
    B, Hp, Wp, C3 = qkv_map.shape
    ws = window_size
    q, k, v = _heads(window_partition(qkv_map, ws), 3, num_heads)
    o = cosine_window_attention_headsplit_plain(
        q, k, v, logit_scale, bias, mask, compute_dtype=compute_dtype)
    o = o.permute(0, 2, 1, 3).reshape(-1, ws * ws, C3 // 3)
    return window_reverse(o, ws, Hp, Wp)


def cosine_window_attention_slab_backward_plain(
        qkv_map: torch.Tensor, logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *, num_heads: int,
        window_size: int, compute_dtype: torch.dtype = torch.float32
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, on any device: the
    head-split plain backward on the partitioned map and gradient, the
    result reversed into a map. g is the gradient of the output,
    (B, Hp, Wp, C). Returns dqkv (B, Hp, Wp, 3C) in qkv_map's type,
    dlogit_scale in logit_scale's shape (`compute_dtype`; zero where the
    ln(100) clamp binds) and dbias in bias's type; the mask gets no
    gradient."""
    B, Hp, Wp, C3 = qkv_map.shape
    ws = window_size
    q, k, v = _heads(window_partition(qkv_map, ws), 3, num_heads)
    gw = _heads(window_partition(g, ws), 1, num_heads)[0]
    dq, dk, dv, dls, dbias = cosine_window_attention_headsplit_backward_plain(
        q, k, v, logit_scale, bias, mask, gw, compute_dtype=compute_dtype)
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 0, 2, 4)
    dqkv = window_reverse(dqkv.reshape(-1, ws * ws, C3), ws, Hp, Wp)
    return dqkv, dls, dbias.to(bias.dtype)


def _shape_args(qkv_map, bias, num_heads, window_size):
    """The entries' ints after the pointers: the map's geometry, then the
    element types (qkv_bf16, bias_bf16)."""
    B, Hp, Wp, C3 = qkv_map.shape
    return (B, Hp, Wp, C3 // 3, num_heads, window_size,
            int(qkv_map.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16))


def _count(kernel: str, by_shape: dict, qkv_map, num_heads,
           window_size) -> None:
    B, Hp, Wp, C3 = qkv_map.shape
    ws = window_size
    key = (B * (Hp // ws) * (Wp // ws), ws * ws, C3 // 3, num_heads)
    if by_shape is not None:
        by_shape[key] = by_shape.get(key, 0) + 1
    LAUNCHES_BY_KERNEL[(kernel, key)] = LAUNCHES_BY_KERNEL.get(
        (kernel, key), 0) + 1


def launch_counts() -> dict:
    """{kernel name: launches} summed over shapes, since the counters were
    last cleared."""
    out: dict = {}
    for (kernel, _), n in LAUNCHES_BY_KERNEL.items():
        out[kernel] = out.get(kernel, 0) + n
    return dict(sorted(out.items()))


def reset_launch_counts() -> None:
    global LAUNCHES, LAUNCHES_BWD
    LAUNCHES = LAUNCHES_BWD = 0
    for d in (LAUNCHES_BY_SHAPE, LAUNCHES_BWD_BY_SHAPE, LAUNCHES_BY_KERNEL):
        d.clear()


def occupancy(dtype: torch.dtype, masked: bool) -> dict:
    """Blocks an SM holds of each tensor-core slab kernel at the slab
    entries' launch for maps of `dtype`, fp32 bias and mask (with or without
    the mask), as the CUDA occupancy calculator gives them on the current
    card: {"fwd", "dq", "dkv"}. Needs the card; launches nothing."""
    blocks = [ctypes.c_int(0) for _ in range(3)]
    bf = int(dtype == torch.bfloat16)
    errs = (_entry("mmde_window_attention_slab_fwd_tc_occupancy")(
                bf, int(masked), ctypes.byref(blocks[0])),
            _entry("mmde_window_attention_slab_bwd_tc_occupancy")(
                bf, int(masked), ctypes.byref(blocks[1]),
                ctypes.byref(blocks[2])))
    if any(errs):
        raise RuntimeError(f"slab occupancy query failed with codes {errs}")
    return dict(zip(("fwd", "dq", "dkv"), (b.value for b in blocks)))


def _tc(qkv_map, _fma: bool) -> bool:
    from mmde_tpu_torch.ops.window_attention_packed import (
        slab_tensor_core_body)
    return slab_tensor_core_body(qkv_map.dtype) and not _fma


def _launch_forward(qkv_map, logit_scale, bias, mask, num_heads, window_size,
                    want_stats, _fma=False):
    """Launch the forward kernel; returns (out map, lse or None). bf16 and
    fp32 maps run the tensor-core kernel (lse (B*nW, nH, N) for bf16, (2,
    B*nW, nH, N) hi and lo for fp32: `stat_pair`); `_fma` (private:
    chip_smoke.py's same-card comparison and tools/bench_attention.py, never
    the model) sends either type to the FMA body (lse (2, B*nW, nH, N)). The
    statistic carries the body that wrote it (`written_by`)."""
    global LAUNCHES
    from mmde_tpu_torch.ops.window_attention_packed import (
        _body_name, _stream, stat_pair)
    B, Hp, Wp, C3 = qkv_map.shape
    ws = window_size
    if qkv_map.data_ptr() % 16:
        raise ValueError("qkv_map must be 16-byte aligned for the kernel's "
                         "vector loads")
    tc = _tc(qkv_map, _fma)
    name = "mmde_window_attention_slab_fwd" + (
        "_tc" if tc else "_stats" if want_stats else "")
    fn = _entry(name)
    dev = qkv_map.device
    out = torch.empty((B, Hp, Wp, C3 // 3), dtype=qkv_map.dtype, device=dev)
    B_ = B * (Hp // ws) * (Wp // ws)
    lse = None
    if want_stats:
        stat = ((2,) if stat_pair(qkv_map.dtype, tc) else ()) + (
            B_, num_heads, ws * ws)
        lse = torch.empty(stat, dtype=torch.float32, device=dev)
        lse.written_by = _body_name(tc)   # checked by _launch_backward
    args = (qkv_map.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr())
    if tc or want_stats:    # the tensor-core entry's lse is nullable
        args += (lse.data_ptr() if want_stats else None,)
    with torch.cuda.device(dev):
        err = fn(*args, *_shape_args(qkv_map, bias, num_heads, ws),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} "
            f"(map {tuple(qkv_map.shape)}, nH={num_heads}, ws={ws}, "
            f"{qkv_map.dtype})")
    LAUNCHES += 1
    _count("window_attention_slab_fwd" + ("_tc" if tc else "")
           + ("+lse" if want_stats else ""), LAUNCHES_BY_SHAPE, qkv_map,
           num_heads, ws)
    return out, lse


def dbias_split(_fma: bool = False) -> bool:
    """Whether a slab backward sums dbias by K3's pass rather than by the
    passes' atomics: under MMDE_ATTN_GRID=split (the packed module's
    DEFAULT_GRID_MODE) and under `torch.use_deterministic_algorithms(True)`,
    both read at each call - the head-split rule (`dbias_split` there; the
    slab path has no K4 of its own). The FMA body (`_fma`, the same-card
    comparison's partner) keeps its atomics."""
    from mmde_tpu_torch.ops import window_attention_headsplit as ths
    return ths.dbias_split() and not _fma


def _launch_dbias(qkv_map, logit_scale, bias, mask, lse, g, delta,
                  num_heads, window_size):
    """Launch the tensor-core K3 over `MapRows` on the `delta` the
    tensor-core dq pass wrote and its forward's statistic; returns dbias
    (nH, N, N) fp32, every element written once, windows in one fixed order
    (type-major where masked): the same bits on every run. No fallback: a
    build or launch failure raises."""
    from mmde_tpu_torch.ops.window_attention_packed import (_stream,
                                                            check_statistic)
    B, Hp, Wp, C3 = qkv_map.shape
    ws, nH, N = window_size, num_heads, window_size * window_size
    B_ = B * (Hp // ws) * (Wp // ws)
    check_statistic(lse, qkv_map.dtype, True, (B_, nH, N))
    if tuple(delta.shape) != (B_, nH, N) or delta.dtype != torch.float32:
        raise ValueError(f"delta must be float32 {(B_, nH, N)}, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    fn = _entry("mmde_window_attention_slab_dbias_tc")
    dev = qkv_map.device
    dbias = torch.empty((nH, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(qkv_map.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 lse.data_ptr(), g.data_ptr(), delta.data_ptr(),
                 dbias.data_ptr(), *_shape_args(qkv_map, bias, nH, ws),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"window_attention_slab_dbias_tc launch failed with code {err} "
            f"(map {tuple(qkv_map.shape)}, nH={nH}, ws={ws}, "
            f"{qkv_map.dtype})")
    _count("window_attention_slab_dbias_tc", None, qkv_map, nH, ws)
    return dbias


def _backward_passes(qkv_map, logit_scale, bias, mask, lse, g, num_heads,
                     window_size, atomics, tc):
    """The two backward passes of body `tc` (the tensor cores, else the FMA
    body); returns (dqkv map, dlogit_scale, dbias or None, delta). dbias by
    the passes' fp32 atomics when `atomics`, none otherwise."""
    global LAUNCHES_BWD
    from mmde_tpu_torch.ops.window_attention_packed import BWD_TILE, _stream
    B, Hp, Wp, C3 = qkv_map.shape
    ws, nH, N = window_size, num_heads, window_size * window_size
    B_ = B * (Hp // ws) * (Wp // ws)
    name = "mmde_window_attention_slab_bwd" + ("_tc" if tc else "")
    fn = _entry(name)
    dev = qkv_map.device
    dqkv = torch.empty_like(qkv_map)
    delta = torch.empty((B_, nH, N), dtype=torch.float32, device=dev)
    # one fp64 partial of dlogit_scale per (window, 64-key tile, head): the
    # dk/dv pass's tile is BWD_TILE rows in both bodies (TC_BT = 64)
    dls_part = torch.empty((B_ * -(-N // BWD_TILE), nH), dtype=torch.float64,
                           device=dev)
    # atomics add into dbias (the packed backward's default dbias mode)
    dbias = (torch.zeros((nH, N, N), dtype=torch.float32, device=dev)
             if atomics else None)
    with torch.cuda.device(dev):
        err = fn(qkv_map.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 lse.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                 delta.data_ptr(), dls_part.data_ptr(),
                 dbias.data_ptr() if atomics else None,
                 *_shape_args(qkv_map, bias, nH, ws), int(atomics),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} "
            f"(map {tuple(qkv_map.shape)}, nH={nH}, ws={ws}, "
            f"{qkv_map.dtype})")
    LAUNCHES_BWD += 1
    _count("window_attention_slab_bwd" + ("_tc" if tc else ""),
           LAUNCHES_BWD_BY_SHAPE, qkv_map, nH, ws)
    dls = dls_part.sum(dim=0).reshape(logit_scale.shape).float()
    return dqkv, dls, dbias, delta


def _launch_backward(qkv_map, logit_scale, bias, mask, lse, g, num_heads,
                     window_size, want_dbias, _fma=False):
    """Launch the backward kernels; returns (dqkv map, dlogit_scale, dbias
    or None). bf16 and fp32 maps run the tensor-core passes (the private
    `_fma`: the FMA body), dbias by their atomics, or under
    MMDE_ATTN_GRID=split or in deterministic mode (`dbias_split`) by K3's
    pass after them (`_launch_dbias`, on the delta they wrote); `lse` must
    be what the same body's forward wrote (`check_statistic`): the other
    shape, or a statistic tagged with the other body, raises before any
    launch."""
    from mmde_tpu_torch.ops.window_attention_packed import check_statistic
    B, Hp, Wp, C3 = qkv_map.shape
    ws, nH = window_size, num_heads
    if g.dtype != qkv_map.dtype or tuple(g.shape) != (B, Hp, Wp, C3 // 3):
        raise ValueError(f"g must be {(B, Hp, Wp, C3 // 3)} {qkv_map.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    if qkv_map.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("qkv_map and g must be 16-byte aligned for the "
                         "kernel's vector loads")
    B_ = B * (Hp // ws) * (Wp // ws)
    tc = _tc(qkv_map, _fma)
    check_statistic(lse, qkv_map.dtype, tc, (B_, nH, ws * ws))
    split = want_dbias and dbias_split(_fma)
    dqkv, dls, dbias, delta = _backward_passes(
        qkv_map, logit_scale, bias, mask, lse, g, nH, ws,
        atomics=want_dbias and not split, tc=tc)
    if split:
        dbias = _launch_dbias(qkv_map, logit_scale, bias, mask, lse, g,
                              delta, nH, ws)
    return dqkv, dls, None if dbias is None else dbias.to(bias.dtype)


class _SlabWindowAttention(torch.autograd.Function):
    """K8' forward (saving each row's log-sum-exp) and K9' backward for CUDA
    tensors, on the tensor cores for either type (with the private `_fma`,
    the FMA body: chip_smoke.py's same-card comparison); the plain forward
    and the plain backward for CPU tensors."""

    @staticmethod
    def forward(ctx, qkv_map, logit_scale, bias, mask, num_heads,
                window_size, _fma=False):
        ctx.num_heads, ctx.window_size = num_heads, window_size
        # the backward takes the body its forward took: it reads that
        # body's statistic
        ctx.fma = _fma
        if qkv_map.is_cuda:
            out, lse = _launch_forward(qkv_map, logit_scale, bias, mask,
                                       num_heads, window_size,
                                       want_stats=True, _fma=_fma)
        else:
            out = cosine_window_attention_slab_plain(
                qkv_map, logit_scale, bias, mask, num_heads=num_heads,
                window_size=window_size)
            lse = None
        ctx.save_for_backward(qkv_map, logit_scale, bias, mask, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv_map, logit_scale, bias, mask, lse = ctx.saved_tensors
        need_qkv, need_ls, need_bias = ctx.needs_input_grad[:3]
        g = g.contiguous()
        if qkv_map.is_cuda:
            dqkv, dls, dbias = _launch_backward(
                qkv_map, logit_scale, bias, mask, lse, g, ctx.num_heads,
                ctx.window_size, want_dbias=need_bias, _fma=ctx.fma)
        else:
            dqkv, dls, dbias = cosine_window_attention_slab_backward_plain(
                qkv_map, logit_scale, bias, mask, g, num_heads=ctx.num_heads,
                window_size=ctx.window_size)
        # the mask is a constant of the window layout: no gradient
        return (dqkv if need_qkv else None, dls if need_ls else None,
                dbias if need_bias else None, None, None, None, None)


def cosine_window_attention_slab(qkv_map: torch.Tensor,
                                 logit_scale: torch.Tensor,
                                 bias: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 *, num_heads: int, window_size: int
                                 ) -> torch.Tensor:
    """Map-in / map-out fused cosine window attention, differentiable in
    qkv_map, logit_scale and bias.

    qkv_map: (B, Hp, Wp, 3C) float32 or bfloat16, contiguous, Hp and Wp
    multiples of window_size (pre-rolled for shifted blocks); logit_scale:
    (nH, 1, 1) float32; bias: (nH, N, N), float32 (as the model passes it)
    or qkv_map's type; mask: (nW, N, N) of bias's type or None, one row per
    window of an image in row-major window order. Returns (B, Hp, Wp, C) in
    qkv_map's type.

    CUDA tensors launch the tensor-core kernels (or raise), an fp32 map's
    operands in three bf16 pieces; CPU tensors take the plain versions.
    When a gradient is recorded the forward kernel also writes each row's
    log-sum-exp, which the backward kernel rebuilds the probabilities from;
    without one (serving) it writes the output alone.
    """
    _check(qkv_map, logit_scale, bias, mask, num_heads, window_size)
    if torch.is_grad_enabled() and (qkv_map.requires_grad
                                    or logit_scale.requires_grad
                                    or bias.requires_grad):
        return _SlabWindowAttention.apply(qkv_map, logit_scale, bias, mask,
                                          num_heads, window_size)
    if not qkv_map.is_cuda:
        return cosine_window_attention_slab_plain(
            qkv_map, logit_scale, bias, mask, num_heads=num_heads,
            window_size=window_size)
    return _launch_forward(qkv_map, logit_scale, bias, mask, num_heads,
                           window_size, want_stats=False)[0]
