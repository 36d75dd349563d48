"""Fused cosine window attention on head-split q, k, v.

Counterpart of mmde_tpu/ops/window_attention_pallas.py: its forward kernel
(`_kernel`, K6) and its backward kernel (`_bwd_kernel`, K7), behind one
`torch.autograd.Function`. `cosine_window_attention_headsplit` takes q, k,
v (B_, nH, N, Dh), the per-head log temperature, the relative-position bias
(nH, N, N) and the shifted-window mask (nW, N, N), and returns
(B_, nH, N, Dh) in v's type. A swin stage takes it wherever the packed
layout is unusable (`window_attention_packed.packed_layout_ok` false: C not
a multiple of 128, as at swin_tiny stages 1-2, swin_large stage 1,
swin_huge stages 1-2), exactly where the JAX model takes the Pallas v1
kernel.

On a GPU the head-split layout is a matter of strides only. The CUDA
kernels are the packed kernels' bodies (csrc/window_attention_fwd.cu,
csrc/window_attention_bwd.cu), reached through head-split entry points that
take each operand's (window, head, token) strides: the model's permuted
views of qkv go in without a copy (rows must be unit-stride and 16-byte
aligned, as they are for every swin variant; any other layout is copied
first). The forward keeps a running row maximum for every head, as the TPU
kernel does: there is no max-free softmax here, so fault F1 cannot arise.

For CUDA tensors the wrapper launches the kernels or raises; for CPU tensors
it computes `cosine_window_attention_headsplit_plain` and, under autograd,
`cosine_window_attention_headsplit_backward_plain` - the same functions in
plain PyTorch (the packed module's plain versions are these, on split
heads), which are also what the kernels are compared with on the card.
`LAUNCHES` / `LAUNCHES_BWD` count kernel launches, and nothing else.

Where it differs from the TPU kernels:
  * dbias: the TPU backward writes each window's ds in the input type and
    sums them in XLA; here the dk/dv pass adds its ds into one fp32
    (nH, N, N) buffer with atomics (the packed backward's default). The sum
    is fp32 throughout, but not bit-reproducible from run to run.
  * Dh = 32 only (NotImplementedError otherwise). The TPU kernel takes any
    Dh; no swin variant has another.
  * No padding to the TPU's 8-row q tiles: the kernels mask the ragged
    edge themselves.
  * MMDE_PALLAS_XLA_BWD=1, the TPU package's debugging escape to an XLA
    backward, is not ported (ROADMAP M2).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mmde_tpu_torch.ops.window_attention import (MAX_LOGIT_SCALE,
                                                 cosine_window_attention)

HEAD_DIM = 32           # the kernels are written for Dh = 32 (all swin variants)
LAUNCHES = 0            # incremented once per forward-kernel launch
LAUNCHES_BY_SHAPE: dict = {}    # the same count, keyed by (B_, N, C, nH)
LAUNCHES_BWD = 0        # incremented once per backward launch (all its passes)
LAUNCHES_BWD_BY_SHAPE: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, strides, logit_scale, bias, mask, out [, lse]; B_, N, nH, nW,
# qkv_bf16, bias_bf16; stream
_FWD_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
_FWD_STATS_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]
# q, k, v, g, strides, logit_scale, bias, mask, lse, dq, dk, dv, delta,
# dls_part, dbias; B_, N, nH, nW, qkv_bf16, bias_bf16, dbias_mode; stream
_BWD_ARGTYPES = [_P] * 15 + [_I] * 7 + [_P]


def _entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A head-split entry point of the libraries the packed module builds
    (the same sources hold both layouts' entry points)."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    lib = wap._library_bwd() if "bwd" in name else wap._library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, logit_scale, bias, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (B_, nH, N, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B_, nH, N, Dh = q.shape
    if Dh != HEAD_DIM:
        raise NotImplementedError(
            f"the window-attention kernel takes head_dim {HEAD_DIM} only, "
            f"got {Dh}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if logit_scale.dtype != torch.float32 or logit_scale.numel() != nH:
        raise ValueError("logit_scale must be float32 with one entry per "
                         f"head, got {logit_scale.dtype} "
                         f"{tuple(logit_scale.shape)}")
    if tuple(bias.shape) != (nH, N, N):
        raise ValueError(f"bias must be ({nH}, {N}, {N}), got "
                         f"{tuple(bias.shape)}")
    if bias.dtype not in (torch.float32, v.dtype):
        raise TypeError(f"bias must be float32 or v's type, got {bias.dtype} "
                        f"for {v.dtype} v")
    dense = [("logit_scale", logit_scale), ("bias", bias)]
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
        dense.append(("mask", mask))
    for name, t in [("k", k), ("v", v)] + dense:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in dense:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rows_layout_ok(t: torch.Tensor) -> bool:
    """Whether the kernels read `t` (B_, nH, N, Dh) in place: unit-stride
    channels, every row 16-byte aligned (base and the three outer strides)."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * e % 16 == 0 for s in t.stride()[:3]))


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t if rows_layout_ok(t) else t.contiguous()


def _strides(*ts: torch.Tensor) -> ctypes.Array:
    """The (window, head, token) strides of each tensor, as the host array
    the entry points read."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def cosine_window_attention_headsplit_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor] = None, *,
        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, on any device:
    normalisation, logits, softmax and both products in `compute_dtype`
    (float32; float64 gives the ground truth the kernels' gradients are
    checked against), output in v's type. For float32 inputs this is
    ops.window_attention.cosine_window_attention; for bfloat16 it differs
    there only in keeping the probabilities in float32 for the second
    product, as the kernels (and the TPU kernel) do."""
    B_, nH, N, _ = q.shape
    ct = compute_dtype
    q, k, vc = q.to(ct), k.to(ct), v.to(ct)
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    scale = torch.exp(torch.clamp(logit_scale.to(ct).reshape(nH, 1, 1),
                                  max=MAX_LOGIT_SCALE))
    s = torch.matmul(qn, kn.transpose(-1, -2)) * scale[None]
    s = s + bias[None].to(ct)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, nH, N, N)
             + mask[None, :, None].to(ct)).reshape(B_, nH, N, N)
    return torch.matmul(torch.softmax(s, dim=-1), vc).to(v.dtype)


def cosine_window_attention_headsplit_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *,
        compute_dtype: torch.dtype = torch.float32
        ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch, on any device: the
    explicit formulas of the TPU's `_bwd_kernel` (no autograd) in
    `compute_dtype` (float32). g is the gradient of the output,
    (B_, nH, N, Dh). Returns dq, dk, dv in the inputs' types, dlogit_scale
    in logit_scale's shape and dbias (nH, N, N), both in `compute_dtype`;
    dlogit_scale is zero where the ln(100) clamp binds; the mask gets no
    gradient."""
    B_, nH, N, _ = q.shape
    ct = compute_dtype
    qc, kc, vc, gc = (t.to(ct) for t in (q, k, v, g))
    rq = torch.rsqrt((qc * qc).sum(-1, keepdim=True) + 1e-12)
    rk = torch.rsqrt((kc * kc).sum(-1, keepdim=True) + 1e-12)
    qn, kn = qc * rq, kc * rk
    ls = logit_scale.to(ct).reshape(nH)
    scale = torch.exp(torch.clamp(ls, max=MAX_LOGIT_SCALE)).reshape(nH, 1, 1)
    sc = torch.matmul(qn, kn.transpose(-1, -2)) * scale[None]
    s = sc + bias[None].to(ct)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, nH, N, N)
             + mask[None, :, None].to(ct)).reshape(B_, nH, N, N)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gc)
    dp = torch.matmul(gc, vc.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqn = torch.matmul(ds, kn) * scale[None]
    dq = rq * (dqn - qn * (dqn * qn).sum(-1, keepdim=True))
    dkn = torch.matmul(ds.transpose(-1, -2), qn) * scale[None]
    dk = rk * (dkn - kn * (dkn * kn).sum(-1, keepdim=True))
    dls = (ds * sc).sum(dim=(0, 2, 3)) * (ls < MAX_LOGIT_SCALE).to(ct)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dls.reshape(logit_scale.shape), ds.sum(dim=0))


def _launch_forward(q, k, v, logit_scale, bias, mask, want_stats):
    """Launch the forward kernel; returns (out, lse or None)."""
    global LAUNCHES
    B_, nH, N, Dh = q.shape
    q, k, v = _rows(q), _rows(k), _rows(v)
    name = "mmde_window_attention_headsplit_fwd" + (
        "_stats" if want_stats else "")
    fn = _entry(name, _FWD_STATS_ARGTYPES if want_stats else _FWD_ARGTYPES)
    dev = v.device
    out = torch.empty((B_, nH, N, Dh), dtype=v.dtype, device=dev)
    lse = (torch.empty((B_, nH, N), dtype=torch.float32, device=dev)
           if want_stats else None)
    strides = _strides(q, k, v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ctypes.addressof(strides), logit_scale.data_ptr(),
                 bias.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 out.data_ptr(), *([lse.data_ptr()] if want_stats else []),
                 B_, N, nH, mask.shape[0] if mask is not None else 0,
                 int(v.dtype == torch.bfloat16),
                 int(bias.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (B_={B_}, N={N}, nH={nH}, "
            f"{v.dtype})")
    LAUNCHES += 1
    key = (B_, N, nH * Dh, nH)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return out, lse


def _launch_backward(q, k, v, logit_scale, bias, mask, lse, g, want_dbias):
    """Launch the backward kernels; returns (dq, dk, dv, dlogit_scale,
    dbias or None)."""
    global LAUNCHES_BWD
    from mmde_tpu_torch.ops.window_attention_packed import BWD_TILE
    B_, nH, N, Dh = q.shape
    if g.dtype != v.dtype or g.shape != v.shape:
        raise ValueError(f"g must be {tuple(v.shape)} {v.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    fn = _entry("mmde_window_attention_headsplit_bwd", _BWD_ARGTYPES)
    dev = v.device
    dq, dk, dv = (torch.empty((B_, nH, N, Dh), dtype=v.dtype, device=dev)
                  for _ in range(3))
    delta = torch.empty((B_, nH, N), dtype=torch.float32, device=dev)
    n_tiles = -(-N // BWD_TILE)
    dls_part = torch.empty((B_ * n_tiles, nH), dtype=torch.float64,
                           device=dev)
    # atomics add into dbias (the packed backward's default dbias mode)
    dbias = (torch.zeros((nH, N, N), dtype=torch.float32, device=dev)
             if want_dbias else None)
    strides = _strides(q, k, v, g)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 ctypes.addressof(strides), logit_scale.data_ptr(),
                 bias.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), dls_part.data_ptr(),
                 dbias.data_ptr() if dbias is not None else None,
                 B_, N, nH, mask.shape[0] if mask is not None else 0,
                 int(v.dtype == torch.bfloat16),
                 int(bias.dtype == torch.bfloat16), int(want_dbias), stream)
    if err != 0:
        raise RuntimeError(
            f"mmde_window_attention_headsplit_bwd launch failed with code "
            f"{err} (B_={B_}, N={N}, nH={nH}, {v.dtype})")
    LAUNCHES_BWD += 1
    key = (B_, N, nH * Dh, nH)
    LAUNCHES_BWD_BY_SHAPE[key] = LAUNCHES_BWD_BY_SHAPE.get(key, 0) + 1
    dls = dls_part.sum(dim=0).reshape(logit_scale.shape).float()
    return dq, dk, dv, dls, dbias


class _HeadSplitWindowAttention(torch.autograd.Function):
    """K6' forward (saving each row's log-sum-exp) and K7' backward for CUDA
    tensors; the plain forward and the plain backward for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, logit_scale, bias, mask):
        if q.is_cuda:
            out, lse = _launch_forward(q, k, v, logit_scale, bias, mask,
                                       want_stats=True)
        else:
            out = cosine_window_attention_headsplit_plain(
                q, k, v, logit_scale, bias, mask)
            lse = None
        ctx.save_for_backward(q, k, v, logit_scale, bias, mask, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, logit_scale, bias, mask, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        if q.is_cuda:
            dq, dk, dv, dls, dbias = _launch_backward(
                q, k, v, logit_scale, bias, mask, lse, g,
                want_dbias=need[4])
        else:
            dq, dk, dv, dls, dbias = \
                cosine_window_attention_headsplit_backward_plain(
                    q, k, v, logit_scale, bias, mask, g)
        # the mask is a constant of the window layout: no gradient
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, dls if need[3] else None,
                dbias.to(bias.dtype) if need[4] else None, None)


def cosine_window_attention_headsplit(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      logit_scale: torch.Tensor,
                                      bias: torch.Tensor,
                                      mask: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """Fused cosine window attention on head-split operands, differentiable
    in q, k, v, logit_scale and bias.

    q, k, v: (B_, nH, N, 32), one type, float32 or bfloat16, any strides
    with unit-stride channels (the model's permuted views of qkv are read in
    place); logit_scale: (nH, 1, 1) float32; bias: (nH, N, N), float32 or
    v's type; mask: (nW, N, N) of bias's type or None, window b uses row
    b % nW. Returns (B_, nH, N, 32) in v's type.

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    versions. When a gradient is recorded the forward kernel also writes
    each row's log-sum-exp, which the backward kernel rebuilds the
    probabilities from; without one (serving) it writes the output alone.
    """
    _check(q, k, v, logit_scale, bias, mask)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, logit_scale, bias)):
        return _HeadSplitWindowAttention.apply(q, k, v, logit_scale, bias,
                                               mask)
    if not q.is_cuda:
        return cosine_window_attention_headsplit_plain(q, k, v, logit_scale,
                                                       bias, mask)
    return _launch_forward(q, k, v, logit_scale, bias, mask,
                           want_stats=False)[0]


def window_attention(q, k, v, logit_scale, bias, mask=None,
                     impl: str = "torch"):
    """Dispatch between the fused kernel ("cuda") and the plain function
    (any other impl), as the JAX package's `window_attention` dispatches
    between its Pallas kernel ("pallas") and XLA."""
    if impl == "cuda":
        return cosine_window_attention_headsplit(q, k, v, logit_scale, bias,
                                                 mask)
    return cosine_window_attention(q, k, v, logit_scale, bias, mask)
