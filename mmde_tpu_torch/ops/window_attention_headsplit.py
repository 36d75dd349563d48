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
kernels are the packed kernels' bodies, reached through head-split entry
points that take each operand's (window, head, token) strides: the model's
permuted views of qkv go in without a copy (rows must be unit-stride and
16-byte aligned, as they are for every swin variant; any other layout is
copied first). Which body runs follows q's type, nothing else (the packed
module's `headsplit_tensor_core_body`): bf16 and fp32 q, k, v run the
tensor-core kernels (csrc/window_attention_{fwd,bwd}_tc.cu, bf16 mma.sync;
fp32 operands in three bf16 pieces, the packed fp32 instantiation over the
views' strides; counted as window_attention_headsplit_fwd_tc[+lse] /
window_attention_headsplit_bwd_tc) in the TPU kernel's function, mode
"fp32" with fp32 bias and mask tiles. The fp32-FMA bodies
(csrc/window_attention_fwd.cu, csrc/window_attention_bwd.cu;
window_attention_headsplit_fwd[+lse] / window_attention_headsplit_bwd) stay
as the private same-card A/B partner (`_fma`). The forward keeps a running
row maximum for every head, as the TPU kernel does: there is no max-free
softmax here, so fault F1 cannot arise.

The log-sum-exp the backward rebuilds p from (the packed module's
`stat_pair`): the bf16 tensor-core forward hands over one fp32 number a
row, (B_, nH, N), as the packed kernels do; every other body (fp32 on the
tensor cores, either type on the FMA body) two, (2, B_, nH, N), the row's m
+ log(l) formed in fp64 and kept as fp32 hi + lo, and its backward takes p
= exp((s - hi) - lo) (`rebuild_probabilities`): one rounding of lse ~ 60
would scale a whole row of p alike, which the cancelling sum of
dlogit_scale does not average away (fault F3; the bf16 path's own rounding
is far below its tolerance). The statistic carries the body that wrote it
(`written_by`), and a backward of the other body refuses it: the tensor
cores round each sum toward zero, so their fp32 logits lie a few ulps from
the FMA body's.

For CUDA tensors the wrapper launches the kernels or raises; for CPU tensors
it computes `cosine_window_attention_headsplit_plain` and, under autograd,
`cosine_window_attention_headsplit_backward_plain` - the same functions in
plain PyTorch (the packed module's plain versions are these, on split
heads), which are also what the kernels are compared with on the card.
`LAUNCHES*` count kernel launches, and nothing else.

Where it differs from the TPU kernels:
  * dbias: the TPU backward writes each window's ds in the input type and
    sums them in XLA; here the dk/dv pass adds its ds into one fp32
    (nH, N, N) buffer with atomics (the packed backward's default), fp32
    throughout but not bit-reproducible from run to run; under
    MMDE_ATTN_GRID=split (the packed module's DEFAULT_GRID_MODE) the passes
    skip dbias and K3's windows-innermost pass sums it in one fixed order
    (`_launch_dbias`, counted as window_attention_headsplit_dbias_tc): the
    same bits on every run, as the TPU package's XLA sum gives.
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
MAXFREE_MAX_SCALE = 30.0    # the forward kernels' static-shift limit (F1)

# The products' operands under each precision mode of the packed kernels
# (window_attention_packed.MXU_MODES, and "fold_pv_bf16", a forward-only
# benchmark variant): (fold the scale into q^ before q^ k^T, round q^ * scale
# and k^ to bf16, round the other products' operands to bf16). The
# head-split kernels take "fp32" only, as the TPU kernel they replace.
_MXU_OPS = {"fp32": (False, False, False), "fold": (True, False, False),
            "bf16": (True, True, True), "fold_pv_bf16": (True, False, True)}


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest, ties to even), in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


LAUNCHES = 0            # incremented once per forward-kernel launch
LAUNCHES_BY_SHAPE: dict = {}    # the same count, keyed by (B_, N, C, nH)
LAUNCHES_BWD = 0        # incremented once per backward launch (all its passes)
LAUNCHES_BWD_BY_SHAPE: dict = {}
# every launch above, keyed by (kernel, (B_, N, C, nH)); kernel names:
# window_attention_headsplit_fwd_tc[+lse] / window_attention_headsplit_bwd_tc
# (the tensor cores), window_attention_headsplit_fwd[+lse] /
# window_attention_headsplit_bwd (the fp32-FMA body, `_fma` only);
# window_attention_headsplit_dbias_tc (K3's pass under "split"; FMA:
# window_attention_headsplit_dbias, inside the FMA backward entry), counted
# in LAUNCHES_BY_KERNEL only
LAUNCHES_BY_KERNEL: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, strides, logit_scale, bias, mask, out [, lse]; B_, N, nH, nW,
# qkv_bf16, bias_bf16; stream
_FWD_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]
_FWD_STATS_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]
# q, k, v, g, strides, logit_scale, bias, mask, lse, dq, dk, dv, delta,
# dls_part, dbias; B_, N, nH, nW, qkv_bf16, bias_bf16, dbias_mode; stream
_BWD_ARGTYPES = [_P] * 15 + [_I] * 7 + [_P]
# the tensor-core entries: the same arguments, lse nullable in the forward
_FWD_TC_ARGTYPES = [_P] * 9 + [_I] * 6 + [_P]
_BWD_TC_ARGTYPES = [_P] * 15 + [_I] * 7 + [_P]
# K3: q, k, v, g, strides, logit_scale, bias, mask, lse, delta, dbias; B_,
# N, nH, nW, qkv_bf16, bias_bf16; stream
_DBIAS_TC_ARGTYPES = [_P] * 11 + [_I] * 6 + [_P]


def _entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """A head-split entry point of the libraries the packed module builds
    (the same sources hold both layouts' entry points): the tensor-core
    forward or backward library for the `_tc` entries, the fp32-FMA ones
    otherwise."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    if name.endswith("_tc"):
        lib = wap._library_tc("bwd" in name or "dbias" in name)
    else:
        lib = wap._library_bwd() if "bwd" in name else wap._library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _count(kernel: str, by_shape: Optional[dict], key: tuple) -> None:
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


def _logits(qn, kn, scale, fold: bool, r):
    """sc = scale * q^ k^T, or under the folded modes (r(q^ * scale))
    r(k^)^T with r the operands' rounding; returns (sc, q^ operand, k^
    operand)."""
    if fold:
        qd, kd = r(qn * scale[None]), r(kn)
        return torch.matmul(qd, kd.transpose(-1, -2)), qd, kd
    return torch.matmul(qn, kn.transpose(-1, -2)) * scale[None], qn, kn


def cosine_window_attention_headsplit_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor] = None, *,
        compute_dtype: torch.dtype = torch.float32, mxu: str = "fp32",
        maxfree: bool = False) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, on any device:
    normalisation, logits, softmax and both products in `compute_dtype`
    (float32; float64 gives the ground truth the kernels' gradients are
    checked against), output in v's type. For float32 inputs this is
    ops.window_attention.cosine_window_attention; for bfloat16 it differs
    there only in keeping the probabilities in float32 for the second
    product, as the kernels (and the TPU kernel) do.

    mxu: the packed kernels' precision mode (keys of _MXU_OPS). Where p is
    rounded for its product with v ("bf16", "fold_pv_bf16") the kernels
    round exp(s - shift) before the division by the row sum, as the TPU
    kernel does, so this does too: shift = scale + 16 for the heads whose
    forward takes the static shift (`maxfree` and scale <= 30), the row
    maximum for the others."""
    B_, nH, N, _ = q.shape
    ct = compute_dtype
    fold, rqk, rpv = _MXU_OPS[mxu]
    q, k, vc = q.to(ct), k.to(ct), v.to(ct)
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    scale = torch.exp(torch.clamp(logit_scale.to(ct).reshape(nH, 1, 1),
                                  max=MAX_LOGIT_SCALE))
    s = _logits(qn, kn, scale, fold, _bf16r if rqk else _same)[0]
    s = s + bias[None].to(ct)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, nH, N, N)
             + mask[None, :, None].to(ct)).reshape(B_, nH, N, N)
    if not rpv:
        return torch.matmul(torch.softmax(s, dim=-1), vc).to(v.dtype)
    shift = s.amax(dim=-1, keepdim=True)
    if maxfree:
        shift = torch.where((scale <= MAXFREE_MAX_SCALE)[None],
                            (scale + 16.0)[None], shift)
    e = torch.exp(s - shift)
    o = torch.matmul(_bf16r(e), _bf16r(vc))
    return (o / e.sum(dim=-1, keepdim=True)).to(v.dtype)


def cosine_window_attention_headsplit_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *,
        compute_dtype: torch.dtype = torch.float32, mxu: str = "fp32"
        ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function in plain PyTorch, on any device: the
    explicit formulas of the TPU's `_bwd_kernel` (no autograd) in
    `compute_dtype` (float32). g is the gradient of the output,
    (B_, nH, N, Dh). Returns dq, dk, dv in the inputs' types, dlogit_scale
    in logit_scale's shape and dbias (nH, N, N), both in `compute_dtype`;
    dlogit_scale is zero where the ln(100) clamp binds; the mask gets no
    gradient. mxu: the packed kernels' precision mode ("fp32", "fold",
    "bf16"), the TPU body's `_bwd_body` formulas in that mode: p rebuilt
    with the forward's ops, and under "bf16" every product's operands
    rounded to bf16 (g and v for dp, p and g for dv, ds for dq and dk)."""
    B_, nH, N, _ = q.shape
    ct = compute_dtype
    fold = _MXU_OPS[mxu][0]
    r = _bf16r if mxu == "bf16" else _same
    qc, kc, vc, gc = (t.to(ct) for t in (q, k, v, g))
    rq = torch.rsqrt((qc * qc).sum(-1, keepdim=True) + 1e-12)
    rk = torch.rsqrt((kc * kc).sum(-1, keepdim=True) + 1e-12)
    qn, kn = qc * rq, kc * rk
    ls = logit_scale.to(ct).reshape(nH)
    scale = torch.exp(torch.clamp(ls, max=MAX_LOGIT_SCALE)).reshape(nH, 1, 1)
    sc, qd, kd = _logits(qn, kn, scale, fold, r)
    s = sc + bias[None].to(ct)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, nH, N, N)
             + mask[None, :, None].to(ct)).reshape(B_, nH, N, N)
    p = torch.softmax(s, dim=-1)
    gr = r(gc)
    dv = torch.matmul(r(p).transpose(-1, -2), gr)
    dp = torch.matmul(gr, r(vc).transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if fold:    # qd carries the scale: ds^T qd = scale * ds^T q^
        dqn = torch.matmul(r(ds), kd) * scale[None]
        dkn = torch.matmul(r(ds).transpose(-1, -2), qd)
    else:
        dqn = torch.matmul(ds, kn) * scale[None]
        dkn = torch.matmul(ds.transpose(-1, -2), qn) * scale[None]
    dq = rq * (dqn - qn * (dqn * qn).sum(-1, keepdim=True))
    dk = rk * (dkn - kn * (dkn * kn).sum(-1, keepdim=True))
    dls = (ds * sc).sum(dim=(0, 2, 3)) * (ls < MAX_LOGIT_SCALE).to(ct)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dls.reshape(logit_scale.shape), ds.sum(dim=0))


def cosine_window_attention_headsplit_dbias_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logit_scale: torch.Tensor, bias: torch.Tensor,
        mask: Optional[torch.Tensor], g: torch.Tensor, *,
        compute_dtype: torch.dtype = torch.float32, mxu: str = "fp32"
        ) -> torch.Tensor:
    """K3's function alone (MMDE_ATTN_GRID=split) in plain PyTorch, on any
    device: dbias (nH, N, N) in `compute_dtype`, the windows' ds summed, ds
    formed as `cosine_window_attention_headsplit_backward_plain` forms it
    (the same ops in mode `mxu`)."""
    B_, nH, N, _ = q.shape
    ct = compute_dtype
    fold = _MXU_OPS[mxu][0]
    r = _bf16r if mxu == "bf16" else _same
    qc, kc, vc, gc = (t.to(ct) for t in (q, k, v, g))
    qn = qc * torch.rsqrt((qc * qc).sum(-1, keepdim=True) + 1e-12)
    kn = kc * torch.rsqrt((kc * kc).sum(-1, keepdim=True) + 1e-12)
    scale = torch.exp(torch.clamp(logit_scale.to(ct).reshape(nH, 1, 1),
                                  max=MAX_LOGIT_SCALE))
    s = _logits(qn, kn, scale, fold, r)[0] + bias[None].to(ct)
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, nH, N, N)
             + mask[None, :, None].to(ct)).reshape(B_, nH, N, N)
    p = torch.softmax(s, dim=-1)
    dp = torch.matmul(r(gc), r(vc).transpose(-1, -2))
    return (p * (dp - (dp * p).sum(-1, keepdim=True))).sum(dim=0)


def lse_pair(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FMA forward's statistic of fp32 logits s (..., N), in plain
    PyTorch: the row maximum m and the row sum l = sum(exp(s - m)) in fp32,
    then m + log(l) in fp64, kept as fp32 (hi, lo)."""
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    x = m.double() + torch.log(l.double())
    hi = x.float()
    return hi, (x - hi.double()).float()


def rebuild_probabilities(s: torch.Tensor, hi: torch.Tensor,
                          lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """p = exp((s - hi) - lo), the FMA backward's rebuild of the softmax
    from the forward's (hi, lo), in s's type; without lo exp(s - hi), the
    one-number rebuild the bf16 tensor-core kernels take."""
    d = s - hi[..., None]
    if lo is not None:
        d = d - lo[..., None]
    return torch.exp(d)


def _launch_forward(q, k, v, logit_scale, bias, mask, want_stats,
                    _fma=False):
    """Launch the forward kernel; returns (out, lse or None). bf16 and fp32
    q, k, v run the tensor-core kernel (lse (B_, nH, N) for bf16, (2, B_,
    nH, N) hi and lo for fp32: `stat_pair`); `_fma` (private:
    chip_smoke.py's same-card comparison and tools/bench_attention.py, never
    the model) sends either type to the FMA body (lse (2, B_, nH, N)). The
    statistic carries the body that wrote it (`written_by`)."""
    global LAUNCHES
    from mmde_tpu_torch.ops.window_attention_packed import (
        _body_name, _stream, headsplit_tensor_core_body, stat_pair)
    B_, nH, N, Dh = q.shape
    q, k, v = _rows(q), _rows(k), _rows(v)
    tc = headsplit_tensor_core_body(v.dtype) and not _fma
    name = "mmde_window_attention_headsplit_fwd" + (
        "_tc" if tc else "_stats" if want_stats else "")
    fn = _entry(name, _FWD_TC_ARGTYPES if tc else _FWD_STATS_ARGTYPES
                if want_stats else _FWD_ARGTYPES)
    dev = v.device
    out = torch.empty((B_, nH, N, Dh), dtype=v.dtype, device=dev)
    lse = None
    if want_stats:
        stat = ((2,) if stat_pair(v.dtype, tc) else ()) + (B_, nH, N)
        lse = torch.empty(stat, dtype=torch.float32, device=dev)
        lse.written_by = _body_name(tc)   # checked by _launch_backward
    strides = _strides(q, k, v)
    nW = mask.shape[0] if mask is not None else 0
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ctypes.addressof(strides), logit_scale.data_ptr(), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr())
    if tc or want_stats:    # the tensor-core entry's lse is nullable
        args += (lse.data_ptr() if want_stats else None,)
    with torch.cuda.device(dev):
        err = fn(*args, B_, N, nH, nW, int(v.dtype == torch.bfloat16),
                 int(bias.dtype == torch.bfloat16), _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (B_={B_}, N={N}, nH={nH}, "
            f"{v.dtype})")
    LAUNCHES += 1
    _count("window_attention_headsplit_fwd" + ("_tc" if tc else "")
           + ("+lse" if want_stats else ""), LAUNCHES_BY_SHAPE,
           (B_, N, nH * Dh, nH))
    return out, lse


def _launch_backward(q, k, v, logit_scale, bias, mask, lse, g, want_dbias,
                     _fma=False):
    """Launch the backward kernels; returns (dq, dk, dv, dlogit_scale,
    dbias or None). bf16 and fp32 run the tensor-core passes (the private
    `_fma`: the FMA body); dbias by their atomics, or under
    MMDE_ATTN_GRID=split by K3's pass after them (`_launch_dbias`; the FMA
    body runs its own K3 inside its entry, dbias_mode 2). `lse` must be
    what the same body's forward wrote: the other shape, or a statistic
    tagged with the other body, raises before any launch."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    split = want_dbias and wap.DEFAULT_GRID_MODE == "split"
    dq, dk, dv, dls, dbias, delta = _backward_passes(
        q, k, v, logit_scale, bias, mask, lse, g, want_dbias, split, _fma)
    if split and dbias is None:     # K3 on the delta the passes wrote
        dbias = _launch_dbias(q, k, v, g, logit_scale, bias, mask, lse,
                              delta)
    return dq, dk, dv, dls, dbias


def _backward_passes(q, k, v, logit_scale, bias, mask, lse, g, want_dbias,
                     split, fma):
    """`_launch_backward`'s passes: (dq, dk, dv, dlogit_scale, dbias or
    None, delta), delta (B_, nH, N) as the dq pass wrote it (K3's input;
    chip_smoke.py times K3 alone on it). dbias: by atomics where
    `want_dbias` and not `split`; under `split` the FMA body's (`fma`) own
    K3, none from the tensor-core passes."""
    global LAUNCHES_BWD
    from mmde_tpu_torch.ops import window_attention_packed as wap
    B_, nH, N, Dh = q.shape
    if g.dtype != v.dtype or g.shape != v.shape:
        raise ValueError(f"g must be {tuple(v.shape)} {v.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    tc = wap.headsplit_tensor_core_body(v.dtype) and not fma
    wap.check_statistic(lse, v.dtype, tc, (B_, nH, N))
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    name = "mmde_window_attention_headsplit_bwd" + ("_tc" if tc else "")
    fn = _entry(name, _BWD_TC_ARGTYPES if tc else _BWD_ARGTYPES)
    dev = v.device
    dq, dk, dv = (torch.empty((B_, nH, N, Dh), dtype=v.dtype, device=dev)
                  for _ in range(3))
    delta = torch.empty((B_, nH, N), dtype=torch.float32, device=dev)
    # one fp64 partial of dlogit_scale per (window, 64-key tile, head): the
    # dk/dv pass's tile is BWD_TILE rows in both bodies (TC_BT = 64)
    n_tiles = -(-N // wap.BWD_TILE)
    dls_part = torch.empty((B_ * n_tiles, nH), dtype=torch.float64,
                           device=dev)
    # atomics add into dbias (mode 1, the packed backward's default); under
    # "split" the FMA entry writes it in its own K3 (mode 2), the tensor
    # cores' K3 runs after the passes (mode 0)
    mode = (0 if tc else 2) if split else int(want_dbias)
    dbias = (torch.zeros((nH, N, N), dtype=torch.float32, device=dev)
             if mode else None)
    strides = _strides(q, k, v, g)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 ctypes.addressof(strides), logit_scale.data_ptr(),
                 bias.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), dls_part.data_ptr(),
                 dbias.data_ptr() if dbias is not None else None,
                 B_, N, nH, mask.shape[0] if mask is not None else 0,
                 int(v.dtype == torch.bfloat16),
                 int(bias.dtype == torch.bfloat16), mode, wap._stream(dev))
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (B_={B_}, N={N}, nH={nH}, "
            f"{v.dtype})")
    LAUNCHES_BWD += 1
    key = (B_, N, nH * Dh, nH)
    _count("window_attention_headsplit_bwd" + ("_tc" if tc else ""),
           LAUNCHES_BWD_BY_SHAPE, key)
    if mode == 2:       # the FMA entry's own K3 pass
        _count("window_attention_headsplit_dbias", None, key)
    dls = dls_part.sum(dim=0).reshape(logit_scale.shape).float()
    return dq, dk, dv, dls, dbias, delta


def _launch_dbias(q, k, v, g, logit_scale, bias, mask, lse, delta):
    """Launch the tensor-core K3 ("split") on head-split operands, on the
    `delta` the tensor-core dq pass wrote and its forward's statistic;
    returns dbias (nH, N, N) fp32, every element written once, windows in
    one fixed order (type-major where masked): the same bits on every run.
    No fallback: a build or launch failure raises."""
    from mmde_tpu_torch.ops import window_attention_packed as wap
    B_, nH, N, Dh = q.shape
    wap.check_statistic(lse, v.dtype, True, (B_, nH, N))
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    fn = _entry("mmde_window_attention_headsplit_dbias_tc",
                _DBIAS_TC_ARGTYPES)
    dev = v.device
    dbias = torch.empty((nH, N, N), dtype=torch.float32, device=dev)
    strides = _strides(q, k, v, g)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 ctypes.addressof(strides), logit_scale.data_ptr(),
                 bias.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 lse.data_ptr(), delta.data_ptr(), dbias.data_ptr(), B_, N,
                 nH, mask.shape[0] if mask is not None else 0,
                 int(v.dtype == torch.bfloat16),
                 int(bias.dtype == torch.bfloat16), wap._stream(dev))
    if err != 0:
        raise RuntimeError(
            f"window_attention_headsplit_dbias_tc launch failed with code "
            f"{err} (B_={B_}, N={N}, nH={nH}, {v.dtype})")
    _count("window_attention_headsplit_dbias_tc", None, (B_, N, nH * Dh, nH))
    return dbias


class _HeadSplitWindowAttention(torch.autograd.Function):
    """K6' forward (saving each row's log-sum-exp) and K7' backward for CUDA
    tensors, on the tensor cores for bf16 and fp32; the plain forward and
    the plain backward for CPU tensors. The backward runs the body its own
    forward ran (`ctx.fma`): the tensor-core kernels, or with the private
    last argument `fma` (chip_smoke.py's same-card comparison, never the
    model) the fp32-FMA bodies, so that p is rebuilt from the statistic the
    same arithmetic wrote."""

    @staticmethod
    def forward(ctx, q, k, v, logit_scale, bias, mask, fma=False):
        ctx.fma = fma
        if q.is_cuda:
            out, lse = _launch_forward(q, k, v, logit_scale, bias, mask,
                                       want_stats=True, _fma=fma)
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
                want_dbias=need[4], _fma=ctx.fma)
        else:
            dq, dk, dv, dls, dbias = \
                cosine_window_attention_headsplit_backward_plain(
                    q, k, v, logit_scale, bias, mask, g)
        # the mask is a constant of the window layout: no gradient
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, dls if need[3] else None,
                dbias.to(bias.dtype) if need[4] else None, None, None)


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

    CUDA tensors launch the kernels (or raise): the tensor-core kernels,
    for bf16 and fp32 alike; CPU tensors take the plain versions.
    When a gradient is recorded the forward kernel also writes each row's
    log-sum-exp, which the backward kernel rebuilds the probabilities from;
    without one (serving) it writes the output alone.
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
