"""Fused cosine window attention on qkv exactly as the Linear emits it.

Counterpart of mmde_tpu/ops/window_attention_packed.py, forward and backward.
`cosine_window_attention_packed` takes qkv (B_, N, 3C), the per-head log
temperature, the relative-position bias as plain (nH, N, N) and the
shifted-window mask as plain (nW, N, N), and returns (B_, N, C). The TPU
kernel's head-group packing, 8-row padding and -1e9 bias columns are TPU
tiling and have no counterpart here: the CUDA kernels
(csrc/window_attention_fwd.cu, csrc/window_attention_bwd.cu) mask the ragged
edge themselves.

For CUDA tensors the wrapper launches the kernels or raises; for CPU tensors
it computes `cosine_window_attention_packed_plain` and, under autograd,
`cosine_window_attention_packed_backward_plain` - the same functions in plain
PyTorch (the head-split module's, on qkv split into heads), which are also
what the kernels are compared with on the card. `LAUNCHES` / `LAUNCHES_BWD`
count kernel launches, and nothing else.

The same two libraries hold the head-split entry points that
ops/window_attention_headsplit.py binds; `packed_layout_ok` says which of
the two layouts a swin stage takes, as the JAX package's `attention_plan`
does.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from mmde_tpu_torch.ops.window_attention_headsplit import (
    HEAD_DIM, cosine_window_attention_headsplit_backward_plain,
    cosine_window_attention_headsplit_plain)

BWD_TILE = 64           # query rows per block of the backward's dq pass
LAUNCHES = 0            # incremented once per forward-kernel launch
LAUNCHES_BY_SHAPE: dict = {}    # the same count, keyed by (B_, N, C, nH)
LAUNCHES_BWD = 0        # incremented once per backward launch (all its passes)
LAUNCHES_BWD_BY_SHAPE: dict = {}

# The JAX package's three grid modes. The forward is the same function
# under each (K1 here whatever the mode); they differ in the backward, in how
# ds is summed over windows into dbias. "window_resident": fp32 atomics from
# the dk/dv pass (the TPU kernel's default grid dumps ds per window there and
# sums outside). "split": a pass of its own with windows innermost and no
# atomics (the TPU package's grid_mode="split" / its _pallas_dbias kernel):
# slower, but dbias is the same bits on every run. "bias_resident": the TPU
# package's single-pass backward (its _pallas_backward_v4 kernel, K4), not
# ported yet - a backward under it raises. As in the TPU package the model
# never passes grid_mode: MMDE_ATTN_GRID chooses it for a whole process and
# is read once, here at import.
GRID_MODES = ("window_resident", "split", "bias_resident")
DEFAULT_GRID_MODE = os.environ.get("MMDE_ATTN_GRID", "window_resident")
if DEFAULT_GRID_MODE not in GRID_MODES:
    raise ValueError(
        f"MMDE_ATTN_GRID={DEFAULT_GRID_MODE!r} is not one of {GRID_MODES}")
_DBIAS_MODE = {"window_resident": 1, "split": 2}
BACKWARD_GRID_MODES = tuple(_DBIAS_MODE)    # the modes with a backward here

_LIB_NAME = "window_attention_fwd"
_SOURCES = ("window_attention_fwd.cu",)
_LIB_NAME_BWD = "window_attention_bwd"
_SOURCES_BWD = ("window_attention_bwd.cu",)

# The JAX package's packed-layout test, copied (not imported) so both
# packages send the same stages to the same kernel: `attention_plan` is None
# when C is not a multiple of 128, Dh does not divide 128, or the heads do
# not fill whole 128-lane groups - and, for windows over 456 tokens, when no
# q tile fits its per-cell VMEM budget. That budget is the TPU's and means
# nothing on a GPU; it is kept for routing parity only.
_BQ_CANDIDATES = (456, 384, 304, 232, 152, 120, 80, 48, 40)
_VMEM_BUDGET_FWD = 16 * 1024 * 1024


def _cell_vmem_fwd(bq: int, np_: int, hg: int) -> int:
    """The JAX package's per-cell VMEM estimate of its packed forward."""
    bias = bq * hg * np_ * 4 * 2
    logits = 3 * bq * np_ * 4
    kv = 2 * np_ * 128 * 2 * 2
    mask = bq * np_ * 4 * 2
    return bias + logits + kv + mask


def packed_layout_ok(n: int, num_heads: int, head_dim: int,
                     channels: int) -> bool:
    """True where the JAX package's `attention_plan(n, num_heads, head_dim,
    channels)` is not None: the stage takes the packed kernel; otherwise it
    takes the head-split one."""
    if channels % 128 != 0 or 128 % head_dim != 0:
        return False
    hg = 128 // head_dim
    if num_heads % hg != 0:
        return False
    if n <= max(_BQ_CANDIDATES):
        return True
    return any(_cell_vmem_fwd(bq, -(-n // bq) * bq, hg) <= _VMEM_BUDGET_FWD
               for bq in _BQ_CANDIDATES)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]
_FWD_STATS_ARGTYPES = [_P] * 6 + [_I] * 8 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 8 + [_P]


def _library() -> ctypes.CDLL:
    from mmde_tpu_torch.ops.cuda_build import load_library
    lib = load_library(_LIB_NAME, _SOURCES)
    if lib.mmde_window_attention_fwd.argtypes is None:
        for fn, types in ((lib.mmde_window_attention_fwd, _FWD_ARGTYPES),
                          (lib.mmde_window_attention_fwd_stats,
                           _FWD_STATS_ARGTYPES)):
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _library_bwd() -> ctypes.CDLL:
    from mmde_tpu_torch.ops.cuda_build import load_library
    lib = load_library(_LIB_NAME_BWD, _SOURCES_BWD)
    fn = lib.mmde_window_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def build_kernels() -> dict:
    """Compile (or find) both libraries, the two nvcc runs side by side;
    returns {library name: build record}."""
    from mmde_tpu_torch.ops import cuda_build
    cuda_build.load_libraries({_LIB_NAME: _SOURCES,
                               _LIB_NAME_BWD: _SOURCES_BWD})
    _library()
    _library_bwd()
    return {n: dict(cuda_build.BUILD_LOG[n])
            for n in (_LIB_NAME, _LIB_NAME_BWD)}


def _check(qkv, logit_scale, bias, mask, num_heads):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B_, N, 3C), got {tuple(qkv.shape)}")
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads or C // num_heads != HEAD_DIM:
        raise NotImplementedError(
            f"the window-attention kernel takes head_dim {HEAD_DIM} only "
            f"(C={C}, num_heads={num_heads})")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if logit_scale.dtype != torch.float32 or logit_scale.numel() != num_heads:
        raise ValueError("logit_scale must be float32 with one entry per "
                         f"head, got {logit_scale.dtype} "
                         f"{tuple(logit_scale.shape)}")
    if tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias must be ({num_heads}, {N}, {N}), got "
                         f"{tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, qkv.dtype):
        raise TypeError(f"bias must be float32 or qkv's type, got "
                        f"{bias.dtype} for {qkv.dtype} qkv")
    tensors = [("qkv", qkv), ("logit_scale", logit_scale), ("bias", bias)]
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N):
            raise ValueError(f"mask must be (nW, {N}, {N}), got "
                             f"{tuple(mask.shape)}")
        if B_ % mask.shape[0]:
            raise ValueError(f"B_={B_} is not a multiple of the mask's "
                             f"{mask.shape[0]} windows")
        if mask.dtype != bias.dtype:
            raise TypeError(f"mask ({mask.dtype}) and bias ({bias.dtype}) "
                            "must share a type")
        tensors.append(("mask", mask))
    for name, t in tensors:
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B_, N, C


def cosine_window_attention_packed_plain(qkv: torch.Tensor,
                                         logit_scale: torch.Tensor,
                                         bias: torch.Tensor,
                                         mask: Optional[torch.Tensor] = None,
                                         *, num_heads: int,
                                         compute_dtype: torch.dtype =
                                         torch.float32) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, on any device:
    normalisation, logits, softmax and accumulation in `compute_dtype`
    (float32; float64 gives the ground truth the kernels' gradients are
    checked against); output in qkv's type."""
    B_, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads)
    o = cosine_window_attention_headsplit_plain(
        q, k, v, logit_scale, bias, mask, compute_dtype=compute_dtype)
    return o.permute(0, 2, 1, 3).reshape(B_, N, C3 // 3)


def _split_heads(x: torch.Tensor, parts: int, nH: int) -> torch.Tensor:
    """(B_, N, parts*C) -> (parts, B_, nH, N, Dh), a view."""
    B_, N, W = x.shape
    C = W // parts
    return x.reshape(B_, N, parts, nH, C // nH).permute(2, 0, 3, 1, 4)


def cosine_window_attention_packed_backward_plain(
        qkv: torch.Tensor, logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *, num_heads: int,
        compute_dtype: torch.dtype = torch.float32
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, on any device: the
    explicit formulas (no autograd) in `compute_dtype` (float32). g is the
    gradient of the output, (B_, N, C). Returns dqkv in qkv's type,
    dlogit_scale in logit_scale's shape (`compute_dtype`; zero where the
    ln(100) clamp binds) and dbias in bias's type; the mask gets no
    gradient."""
    B_, N, C3 = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads)
    dq, dk, dv, dls, dbias = cosine_window_attention_headsplit_backward_plain(
        q, k, v, logit_scale, bias, mask, _split_heads(g, 1, num_heads)[0],
        compute_dtype=compute_dtype)
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(B_, N, C3), dls, dbias.to(bias.dtype)


def _launch_forward(qkv, logit_scale, bias, mask, num_heads, maxfree,
                    want_stats):
    """Launch the forward kernel; returns (out, lse or None)."""
    global LAUNCHES
    B_, N, C3 = qkv.shape
    C = C3 // 3
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned for the kernel's "
                         "vector loads")
    lib = _library()
    out = torch.empty((B_, N, C), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((B_, num_heads, N), dtype=torch.float32,
                       device=qkv.device) if want_stats else None)
    shape_args = (B_, N, C, num_heads,
                  mask.shape[0] if mask is not None else 0,
                  int(qkv.dtype == torch.bfloat16),
                  int(bias.dtype == torch.bfloat16), int(bool(maxfree)))
    mask_ptr = mask.data_ptr() if mask is not None else None
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        if want_stats:
            err = lib.mmde_window_attention_fwd_stats(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(), lse.data_ptr(), *shape_args, stream)
        else:
            err = lib.mmde_window_attention_fwd(
                qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
                mask_ptr, out.data_ptr(), *shape_args, stream)
    if err != 0:
        raise RuntimeError(
            f"window_attention_fwd launch failed with code {err} "
            f"(B_={B_}, N={N}, C={C}, nH={num_heads}, {qkv.dtype})")
    LAUNCHES += 1
    key = (B_, N, C, num_heads)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out, lse


def _launch_backward(qkv, logit_scale, bias, mask, lse, g, num_heads,
                     grid_mode, want_dbias):
    """Launch the backward kernels; returns (dqkv, dlogit_scale, dbias or
    None)."""
    global LAUNCHES_BWD
    B_, N, C3 = qkv.shape
    C = C3 // 3
    nH = num_heads
    if g.dtype != qkv.dtype or tuple(g.shape) != (B_, N, C):
        raise ValueError(f"g must be {(B_, N, C)} {qkv.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if qkv.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("qkv and g must be 16-byte aligned for the "
                         "kernel's vector loads")
    lib = _library_bwd()
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B_, nH, N), dtype=torch.float32, device=dev)
    n_tiles = -(-N // BWD_TILE)
    dls_part = torch.empty((B_ * n_tiles, nH), dtype=torch.float64,
                           device=dev)
    mode = _DBIAS_MODE[grid_mode] if want_dbias else 0
    dbias = None
    if mode == 1:       # atomics add into it
        dbias = torch.zeros((nH, N, N), dtype=torch.float32, device=dev)
    elif mode == 2:     # every element written once
        dbias = torch.empty((nH, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mmde_window_attention_bwd(
            qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, lse.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), delta.data_ptr(),
            dls_part.data_ptr(),
            dbias.data_ptr() if dbias is not None else None,
            B_, N, C, nH, mask.shape[0] if mask is not None else 0,
            int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), mode, stream)
    if err != 0:
        raise RuntimeError(
            f"window_attention_bwd launch failed with code {err} "
            f"(B_={B_}, N={N}, C={C}, nH={nH}, {qkv.dtype}, {grid_mode})")
    LAUNCHES_BWD += 1
    key = (B_, N, C, nH)
    LAUNCHES_BWD_BY_SHAPE[key] = LAUNCHES_BWD_BY_SHAPE.get(key, 0) + 1
    # per-block partial sums of dlogit_scale, summed here as the TPU package
    # sums its ds dump outside its kernel
    dls = dls_part.sum(dim=0).reshape(logit_scale.shape).float()
    return dqkv, dls, None if dbias is None else dbias.to(bias.dtype)


class _PackedWindowAttention(torch.autograd.Function):
    """K1 forward (saving each row's log-sum-exp) and K2 backward for CUDA
    tensors; the plain forward and the plain backward for CPU tensors."""

    @staticmethod
    def forward(ctx, qkv, logit_scale, bias, mask, num_heads, maxfree,
                grid_mode):
        ctx.num_heads, ctx.grid_mode = num_heads, grid_mode
        if qkv.is_cuda:
            out, lse = _launch_forward(qkv, logit_scale, bias, mask,
                                       num_heads, maxfree, want_stats=True)
        else:
            out = cosine_window_attention_packed_plain(
                qkv, logit_scale, bias, mask, num_heads=num_heads)
            lse = None
        ctx.save_for_backward(qkv, logit_scale, bias, mask, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.grid_mode not in BACKWARD_GRID_MODES:
            raise NotImplementedError(
                f"grid_mode={ctx.grid_mode!r} (MMDE_ATTN_GRID) takes the TPU "
                "package's single-pass backward, kernel K4, which is not "
                "ported yet (ROADMAP Queue B, K4); unset MMDE_ATTN_GRID or "
                f"choose one of {BACKWARD_GRID_MODES}")
        qkv, logit_scale, bias, mask, lse = ctx.saved_tensors
        need_qkv, need_ls, need_bias = ctx.needs_input_grad[:3]
        g = g.contiguous()
        if qkv.is_cuda:
            dqkv, dls, dbias = _launch_backward(
                qkv, logit_scale, bias, mask, lse, g, ctx.num_heads,
                ctx.grid_mode, want_dbias=need_bias)
        else:
            dqkv, dls, dbias = cosine_window_attention_packed_backward_plain(
                qkv, logit_scale, bias, mask, g, num_heads=ctx.num_heads)
        # the mask is a constant of the window layout: no gradient
        return (dqkv if need_qkv else None, dls if need_ls else None,
                dbias if need_bias else None, None, None, None, None)


def cosine_window_attention_packed(qkv: torch.Tensor,
                                   logit_scale: torch.Tensor,
                                   bias: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None,
                                   *, num_heads: int,
                                   maxfree: bool = True,
                                   grid_mode: Optional[str] = None
                                   ) -> torch.Tensor:
    """Fused cosine window attention, differentiable in qkv, logit_scale and
    bias.

    qkv: (B_, N, 3C) float32 or bfloat16, as the qkv Linear (+ q/v bias)
    emits it; logit_scale: (nH, 1, 1) float32; bias: (nH, N, N), float32 or
    qkv's type; mask: (nW, N, N) of bias's type or None, window b uses row
    b % nW. Returns (B_, N, C) in qkv's type.

    maxfree=True lets the kernel replace the softmax's row maximum by the
    static shift exp(min(logit_scale, ln 100)) + 16 - for the heads whose
    temperature is low enough (<= 30) for that shift to stay inside
    float32's range; hotter heads keep a running row maximum. The shift is
    an upper bound only while bias lies in (0, 16) - the 16*sigmoid
    continuous position bias - and mask <= 0; any other bias must pass
    maxfree=False (running row maximum for every head). The result is the
    same function either way.

    grid_mode: how the backward sums ds over windows into dbias, one of
    GRID_MODES (None = DEFAULT_GRID_MODE, which the MMDE_ATTN_GRID
    environment variable sets); the values agree up to the order of an fp32
    sum. The forward is the same under every mode; a backward under
    "bias_resident" (kernel K4, not ported) raises NotImplementedError.

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions. When a gradient is recorded the forward kernel also writes
    each row's log-sum-exp, which the backward kernel rebuilds the
    probabilities from; without one (serving) it writes the output alone.
    """
    if grid_mode is None:
        grid_mode = DEFAULT_GRID_MODE
    elif grid_mode not in GRID_MODES:
        raise ValueError(f"grid_mode={grid_mode!r} not in {GRID_MODES}")
    _check(qkv, logit_scale, bias, mask, num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or logit_scale.requires_grad
                                    or bias.requires_grad):
        return _PackedWindowAttention.apply(qkv, logit_scale, bias, mask,
                                            num_heads, maxfree, grid_mode)
    if not qkv.is_cuda:
        return cosine_window_attention_packed_plain(
            qkv, logit_scale, bias, mask, num_heads=num_heads)
    return _launch_forward(qkv, logit_scale, bias, mask, num_heads, maxfree,
                           want_stats=False)[0]
