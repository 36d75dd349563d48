"""Fused cosine window attention on qkv exactly as the Linear emits it.

Counterpart of mmde_tpu/ops/window_attention_packed.py (forward only; the
backward kernel is not ported yet). `cosine_window_attention_packed` takes
qkv (B_, N, 3C), the per-head log temperature, the relative-position bias as
plain (nH, N, N) and the shifted-window mask as plain (nW, N, N), and
returns (B_, N, C). The TPU kernel's head-group packing, 8-row padding and
-1e9 bias columns are TPU tiling and have no counterpart here: the CUDA
kernel (csrc/window_attention_fwd.cu) masks the ragged edge itself.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it computes `cosine_window_attention_packed_plain`, the same function
in plain PyTorch, which is also what the kernel is compared with on the
card. `LAUNCHES` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mmde_tpu_torch.ops.window_attention import MAX_LOGIT_SCALE

HEAD_DIM = 32           # the kernel is written for Dh = 32 (all swin variants)
LAUNCHES = 0            # incremented once per kernel launch
LAUNCHES_BY_SHAPE: dict = {}    # the same count, keyed by (B_, N, C, nH)

_LIB_NAME = "window_attention_fwd"
_SOURCES = ("window_attention_fwd.cu",)


def _library() -> ctypes.CDLL:
    from mmde_tpu_torch.ops.cuda_build import load_library
    lib = load_library(_LIB_NAME, _SOURCES)
    fn = lib.mmde_window_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def build_kernel() -> dict:
    """Compile (or find) the kernel's library now; returns its build record
    {"path", "seconds", "log"}."""
    from mmde_tpu_torch.ops import cuda_build
    _library()
    return dict(cuda_build.BUILD_LOG[_LIB_NAME])


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
                                         *, num_heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: float32
    normalisation, logits, softmax and accumulation; output in qkv's type."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    nH = num_heads
    x = qkv.reshape(B_, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4).float()
    q, k, v = x[0], x[1], x[2]                          # (B_, nH, N, Dh)
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    scale = torch.exp(torch.clamp(logit_scale.float().reshape(nH, 1, 1),
                                  max=MAX_LOGIT_SCALE))
    s = torch.matmul(qn, kn.transpose(-1, -2)) * scale[None]
    s = s + bias[None].float()
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, nH, N, N)
             + mask[None, :, None].float()).reshape(B_, nH, N, N)
    o = torch.matmul(torch.softmax(s, dim=-1), v)       # (B_, nH, N, Dh)
    return o.permute(0, 2, 1, 3).reshape(B_, N, C).to(qkv.dtype)


def cosine_window_attention_packed(qkv: torch.Tensor,
                                   logit_scale: torch.Tensor,
                                   bias: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None,
                                   *, num_heads: int,
                                   maxfree: bool = True) -> torch.Tensor:
    """Fused cosine window attention.

    qkv: (B_, N, 3C) float32 or bfloat16, as the qkv Linear (+ q/v bias)
    emits it; logit_scale: (nH, 1, 1) float32; bias: (nH, N, N), float32 or
    qkv's type; mask: (nW, N, N) of bias's type or None, window b uses row
    b % nW. Returns (B_, N, C) in qkv's type.

    maxfree=True lets the kernel replace the softmax's row maximum by the
    static shift exp(min(logit_scale, ln 100)) + 16 — for the heads whose
    temperature is low enough (<= 30) for that shift to stay inside
    float32's range; hotter heads keep a running row maximum. The shift is
    an upper bound only while bias lies in (0, 16) — the 16*sigmoid
    continuous position bias — and mask <= 0; any other bias must pass
    maxfree=False (running row maximum for every head). The result is the
    same function either way.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. Recording a gradient through the kernel is not implemented.
    """
    B_, N, C = _check(qkv, logit_scale, bias, mask, num_heads)
    if not qkv.is_cuda:
        return cosine_window_attention_packed_plain(
            qkv, logit_scale, bias, mask, num_heads=num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or logit_scale.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError(
            "the window-attention backward kernel is not ported yet: run the "
            "CUDA path under torch.no_grad() / torch.inference_mode()")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned for the kernel's "
                         "vector loads")
    global LAUNCHES
    lib = _library()
    out = torch.empty((B_, N, C), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.mmde_window_attention_fwd(
            qkv.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            B_, N, C, num_heads, mask.shape[0] if mask is not None else 0,
            int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), int(bool(maxfree)), stream)
    if err != 0:
        raise RuntimeError(
            f"window_attention_fwd launch failed with code {err} "
            f"(B_={B_}, N={N}, C={C}, nH={num_heads}, {qkv.dtype})")
    LAUNCHES += 1
    key = (B_, N, C, num_heads)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out
