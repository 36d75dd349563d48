"""Helpers for parity tests and smoke runs.

`randomize_tree` fills a nested dict shaped like a flax `params` /
`batch_stats` tree from a numpy generator at scales that keep activations
O(1) through the network. Only each leaf's `.shape` is read, so the tree may
hold arrays or bare shape structs (`jax.eval_shape` of a module's `init`
gives those without compiling or running the initialisation). The packages' own initialisation (conv
std 0.001, identity BatchNorm) gives a near-constant depth map of
max_depth / 2, on which any comparison passes vacuously — a flipped
transposed convolution once hid behind exactly that.

`tc_forward_heads` / `tc_backward_heads` emulate in plain torch the
arithmetic of the tensor-core window-attention kernels
(csrc/window_attention_{fwd,bwd}_tc.cu, at one window per block or W), which
run only on the card, on head-split operands; `tc_forward` / `tc_backward`
on the packed (B_, N, 3C) qkv; `tc_backward_resident` that of the
tensor-core K4 (csrc/window_attention_bwd_resident_tc.cu); `tc_dbias` /
`tc_dbias_heads` that of the tensor-core K3, dbias alone summed window
after window in `dbias_order` (MMDE_ATTN_GRID=split). The CPU tests
hold that arithmetic to the JAX kernels. `pieces` picks the operand split:
0 (the default) the bf16-qkv kernels' - q, k, v and g exact bf16 values,
the fp32 operands formed in registers (p, ds times its factor) split into
bf16 hi + lo; 3 the fp32-qkv kernels' - every fp32 operand as three bf16
pieces, each product the six piece products whose indices sum to at most
2 (0-based); 2 the same with two pieces and three products, the split the
fp32 kernels were measured against and rejected (PERF.md).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

# Largest log temperature drawn: exp(3) ~ 20. Beyond scale ~ 30 the JAX
# package's max-free softmax underflows in float32 (its static shift assumes
# a logit near the bound in every row), which would be the reference's
# error, not the port's.
MAX_TEST_LOGIT_SCALE = 3.0


def _leaf(path: Tuple[str, ...], shape: Tuple[int, ...],
          rng: np.random.Generator) -> np.ndarray:
    name = path[-1]

    def normal(std, mean=0.0):
        return (rng.standard_normal(shape) * std + mean).astype(np.float32)

    if name == "kernel":
        if len(shape) == 4 and any(p.startswith("deconv_") for p in path):
            kh, kw, cin, _ = shape         # each output sums cin*(k/2)^2 taps
            fan_in = cin * max((kh // 2) * (kw // 2), 1)
        else:
            fan_in = int(np.prod(shape[:-1]))
        gain = np.sqrt(2.0) if len(shape) == 4 else 1.0
        return normal(gain / np.sqrt(fan_in))
    if name == "scale":
        return normal(0.1, 1.0)
    if name == "mean":
        return normal(0.2)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name == "logit_scale":
        return np.minimum(normal(0.5, 1.5), MAX_TEST_LOGIT_SCALE)
    if name in ("bias", "q_bias", "v_bias"):
        return normal(0.1)
    if name == "relative_position_bias_table":
        return normal(0.5)
    if name in ("gamma_1", "gamma_2"):          # layerscale
        return normal(0.1, 0.5)
    raise KeyError(f"randomize_tree: no rule for leaf {'/'.join(path)}")


def randomize_tree(tree: Mapping, rng: np.random.Generator,
                   _path: Tuple[str, ...] = ()) -> dict:
    """A new nested dict with every leaf redrawn (see module docstring).
    Leaves are visited in sorted key order, so one seed gives one tree."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out[k] = randomize_tree(v, rng, _path + (str(k),))
        else:
            out[k] = _leaf(_path + (str(k),), tuple(v.shape), rng)
    return out


# ----------------------------------------- the tensor-core kernels' arithmetic

_LN100 = math.log(100.0)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def bf16_pieces(x: torch.Tensor, n: int) -> list:
    """x as n bf16 values (held in fp32) summing to it: x1 = bf16(x), x2 =
    bf16(x - x1), ...; three hold every bit of an fp32 x."""
    out = []
    for _ in range(n):
        out.append(_bf(x))
        x = x - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, pa: int, pb: int) -> torch.Tensor:
    """a @ b as the tensor-core kernels take it: each operand as it is (0:
    exact bf16 values) or split into that many bf16 pieces; the piece
    products whose indices sum to at most max(pa, pb) - 1, the smallest
    first, summed in fp32."""
    xs = bf16_pieces(a, pa) if pa else [a]
    ys = bf16_pieces(b, pb) if pb else [b]
    top = max(len(xs), len(ys)) - 1
    terms = [(i, j) for i in range(len(xs)) for j in range(len(ys))
             if i + j <= top]
    out = None
    for i, j in sorted(terms, key=lambda ij: -(ij[0] + ij[1])):
        t = xs[i] @ ys[j]
        out = t if out is None else out + t
    return out


def _split_mm(a: torch.Tensor, b: torch.Tensor, pieces: int = 0
              ) -> torch.Tensor:
    """a @ b for an fp32 operand a formed in registers and a staged b: a in
    two bf16 pieces against an exact b (pieces 0), or both in `pieces`."""
    return _mm(a, b, pieces or 2, pieces)


def _logits(q, k, ls, bias, mask, mxu, pieces=0):
    """(s, sc, rq, rk, scale, operands): fp32 / fold take S = q k^T on the raw
    values (exact bf16, or in `pieces`) and normalise the accumulator, a
    rank-1 epilogue; "bf16" takes bf16((q * rq) * scale) and bf16(k * rk);
    fold in `pieces` splits the folded (q * rq) * scale, the epilogue rk."""
    nH = q.shape[1]
    rq = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    rk = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    scale = torch.exp(torch.clamp(ls.float().reshape(nH, 1, 1), max=_LN100))
    ops = None
    if mxu == "bf16":
        qd, kd = _bf(q * rq * scale), _bf(k * rk)
        sc = qd @ kd.transpose(-1, -2)
        ops = (qd, kd)
    elif mxu == "fold" and pieces:
        qs = q * rq * scale
        S = _mm(qs, k.transpose(-1, -2), pieces, pieces)
        sc = S * rk.transpose(-1, -2)
        ops = (qs, None)
    else:
        S = _mm(q, k.transpose(-1, -2), pieces, pieces)
        rkt = rk.transpose(-1, -2)
        sc = (S * (scale * rq) * rkt if mxu == "fold"
              else S * rq * rkt * scale)
    s = sc + bias.float()[None]
    if mask is not None:
        B, nW = q.shape[0], mask.shape[0]
        s = (s.reshape(B // nW, nW, nH, *s.shape[-2:])
             + mask.float()[None, :, None]).reshape(s.shape)
    return s, sc, rq, rk, scale, ops


def tc_forward_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ls: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], mxu: str,
                     maxfree: bool = True, pieces: int = 0) -> torch.Tensor:
    """The tensor-core forward's arithmetic on head-split fp32 q, k, v
    (B_, nH, N, 32) holding bf16 values (pieces 0) or fp32 ones; (B_, nH,
    N, 32) fp32. `maxfree`: whether the "bf16" mode may take the static
    shift (the head-split entry passes maxfree 0)."""
    s, _, _, _, scale, _ = _logits(q, k, ls, bias, mask, mxu, pieces)
    shift = s.amax(-1, keepdim=True)
    if mxu == "bf16":   # the static shift where the kernel takes it
        shift = torch.where((scale <= 30.0)[None] & maxfree, scale + 16.0,
                            shift)
    e = torch.exp(s - shift)
    o = (_bf(e) @ _bf(v) if mxu == "bf16" else _split_mm(e, v, pieces))
    return o / e.sum(-1, keepdim=True)


def group_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """x summed over its first axis (windows) as the kernels sum dbias:
    consecutive groups of `size` windows, each summed window after window in
    fp32, then the groups one after another (K5's W-window register sums
    before their atomics; K4's chunks, each summed in the block, then the
    chunks' partials)."""
    parts = []
    for i in range(0, x.shape[0], size):
        acc = x[i]
        for j in range(i + 1, min(i + size, x.shape[0])):
            acc = acc + x[j]
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def tc_backward_heads(q, k, v, ls, bias, mask, g, mxu,
                      windows: int = 1, pieces: int = 0) -> list:
    """The tensor-core backward's arithmetic on head-split operands: [dq,
    dk, dv, dlogit_scale (nH, 1, 1), dbias]. fp32 / fold: delta exact, then
    dqn = split(ds f_j) k, f_j = scale rk_j (the dq pass's two sweeps); dv =
    split(p)^T g; dkn = split(ds f_i)^T q, f_i = scale rq_i; dlogit_scale =
    sum(ds * sc) in fp32, every mode (k^ . dkn, K2's shortcut, would carry
    dkn's split residual into a sum that cancels). bf16: the JAX body's
    rounded operands, ds rounded. `windows`: K5's W, whose dk/dv pass sums
    ds over its W windows before dbias (`group_sum`)."""
    s, sc, rq, rk, scale, ops = _logits(q, k, ls, bias, mask, mxu, pieces)
    p = torch.softmax(s, dim=-1)
    dp = _dp(g, v, mxu, pieces)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    return _tc_grads(q, k, g, ls, sc, rq, rk, scale, ops, p, ds, mxu,
                     group_sum(ds, windows), pieces)


def _dp(g, v, mxu, pieces):
    """dP = g v^T: bf16(g) bf16(v)^T in the "bf16" mode, else the raw values
    (exact bf16, or in `pieces`)."""
    if mxu == "bf16":
        return _bf(g) @ _bf(v).transpose(-1, -2)
    return _mm(g, v.transpose(-1, -2), pieces, pieces)


def dbias_order(B: int, nW: int) -> list:
    """The windows in the order the tensor-core K3 sums them: with a mask
    (nW > 0) type-major - window type t = b % nW outer, sample s inner, b =
    s * nW + t (the JAX dbias grid's (nW, S) order) - else 0 .. B - 1."""
    if not nW:
        return list(range(B))
    return [s * nW + t for t in range(nW) for s in range(B // nW)]


def tc_dbias_heads(q, k, v, ls, bias, mask, g, mxu,
                   pieces: int = 0) -> torch.Tensor:
    """The tensor-core K3's arithmetic on head-split operands: S as the dq
    pass forms it (`_logits`: raw products and the rank-1 epilogue, or the
    "bf16" mode's rounded operands; fp32 in `pieces`), dP as `_dp`, delta
    exact in fp32, ds = p (dP - delta), summed over the windows one after
    another in `dbias_order` in fp32; (nH, N, N)."""
    s, _, _, _, _, _ = _logits(q, k, ls, bias, mask, mxu, pieces)
    p = torch.softmax(s, dim=-1)
    dp = _dp(g, v, mxu, pieces)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    B = q.shape[0]
    order = dbias_order(B, 0 if mask is None else mask.shape[0])
    return group_sum(ds[order], B)


def tc_backward_resident_heads(q, k, v, ls, bias, mask, g,
                               splits: int, pieces: int = 0) -> list:
    """The tensor-core K4's arithmetic on head-split operands, as
    tc_backward_heads returns it: always the "fp32" function; the block's
    own row statistics (m the exact row maximum, l = sum exp(s - m) and
    delta = sum(exp(s - m) dp) / l, m and l kept apart: p = exp(s - m) *
    (1 / l)); the split operands of tc_backward_heads; dbias summed window
    after window within each of `splits` chunks of ceil(B_ / splits)
    windows, then the chunks in order."""
    s, sc, rq, rk, scale, ops = _logits(q, k, ls, bias, mask, "fp32",
                                        pieces)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    il = 1.0 / e.sum(-1, keepdim=True)
    p = e * il
    dp = _dp(g, v, "fp32", pieces)
    ds = p * (dp - (e * dp).sum(-1, keepdim=True) * il)
    chunk = -(-q.shape[0] // splits)
    return _tc_grads(q, k, g, ls, sc, rq, rk, scale, ops, p, ds, "fp32",
                     group_sum(ds, chunk), pieces)


def _tc_grads(q, k, g, ls, sc, rq, rk, scale, ops, p, ds, mxu,
              dbias, pieces=0) -> list:
    """[dq, dk, dv, dlogit_scale, dbias] from p and ds, the products as the
    tensor-core kernels take them in mode `mxu` and split `pieces`."""
    nH = q.shape[1]
    if mxu == "bf16":
        qd, kd = ops
        dv = _bf(p).transpose(-1, -2) @ _bf(g)
        dqn = (_bf(ds) @ kd) * scale
        dkn = _bf(ds).transpose(-1, -2) @ qd
    else:
        dqn = _split_mm(ds * (scale * rk.transpose(-1, -2)), k, pieces)
        dv = _split_mm(p.transpose(-1, -2), g, pieces)
        if ops is not None:     # fold in pieces: the folded q^ * scale
            dkn = _split_mm(ds.transpose(-1, -2), ops[0], pieces)
        else:
            dkn = _split_mm((ds * (scale * rq)).transpose(-1, -2), q, pieces)
    qn, kn = q * rq, k * rk
    dq = rq * (dqn - qn * (dqn * qn).sum(-1, keepdim=True))
    dk = rk * (dkn - kn * (dkn * kn).sum(-1, keepdim=True))
    live = ls.float().flatten() < _LN100
    dls = ((ds * sc).sum((0, 2, 3)) * live).reshape(nH, 1, 1)
    return [dq, dk, dv, dls, dbias]


def _packed_heads(qkv: np.ndarray, nH: int):
    B, N, _ = qkv.shape
    x = torch.from_numpy(qkv).reshape(B, N, 3, nH, 32).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def tc_forward(qkv, ls, bias, mask, nH, mxu, maxfree=True,
               pieces: int = 0) -> torch.Tensor:
    """`tc_forward_heads` on the packed layout: numpy qkv (B_, N, 3C), ls,
    bias, mask; returns (B_, N, C) fp32."""
    o = tc_forward_heads(*_packed_heads(qkv, nH), _t(ls), _t(bias), _t(mask),
                         mxu, maxfree, pieces)
    B, _, N, _ = o.shape
    return o.permute(0, 2, 1, 3).reshape(B, N, nH * 32)


def tc_backward(qkv, ls, bias, mask, g, nH, mxu, windows: int = 1,
                pieces: int = 0) -> list:
    """`tc_backward_heads` on the packed layout (numpy in, g (B_, N, C)):
    [dqkv (B_, N, 3C), dlogit_scale, dbias]."""
    return _packed_grads(qkv, g, nH, lambda q, k, v, gh: tc_backward_heads(
        q, k, v, _t(ls), _t(bias), _t(mask), gh, mxu, windows, pieces))


def tc_dbias(qkv, ls, bias, mask, g, nH, mxu,
             pieces: int = 0) -> torch.Tensor:
    """`tc_dbias_heads` on the packed layout: numpy qkv (B_, N, 3C), ls,
    bias, mask, g (B_, N, C); returns dbias (nH, N, N) fp32."""
    q, k, v = _packed_heads(qkv, nH)
    B, N, _ = qkv.shape
    gh = torch.from_numpy(g).reshape(B, N, nH, 32).permute(0, 2, 1, 3)
    return tc_dbias_heads(q, k, v, _t(ls), _t(bias), _t(mask), gh, mxu,
                          pieces)


def tc_backward_resident(qkv, ls, bias, mask, g, nH, splits: int,
                         pieces: int = 0) -> list:
    """`tc_backward_resident_heads` on the packed layout, as tc_backward."""
    return _packed_grads(qkv, g, nH,
                         lambda q, k, v, gh: tc_backward_resident_heads(
                             q, k, v, _t(ls), _t(bias), _t(mask), gh, splits,
                             pieces))


def _packed_grads(qkv, g, nH, fn) -> list:
    q, k, v = _packed_heads(qkv, nH)
    B, N, _ = qkv.shape
    gh = torch.from_numpy(g).reshape(B, N, nH, 32).permute(0, 2, 1, 3)
    dq, dk, dv, dls, dbias = fn(q, k, v, gh)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(
        B, N, 3 * nH * 32)
    return [dqkv, dls, dbias]
