"""Helpers for parity tests and smoke runs.

`write_void_release`, `write_kitti_tree` and `write_nyu_tree` write small
dataset trees in the releases' layouts with the port's own PNG writer (they
run where cv2 and PIL do not, on the card machine too).

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
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

# Largest log temperature drawn: exp(3) ~ 20. Beyond scale ~ 30 the JAX
# package's max-free softmax underflows in float32 (its static shift assumes
# a logit near the bound in every row), which would be the reference's
# error, not the port's.
MAX_TEST_LOGIT_SCALE = 3.0


def set_test_threads() -> int:
    """Give torch's intra-op pool this process's share of the CPUs: the
    CPU count over the pytest-xdist workers (PYTEST_XDIST_WORKER_COUNT, 1
    when unset), at least 1. Each worker otherwise starts a pool of every
    CPU and the workers' pools fight for the same cores. Returns the count
    set."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    n = max(1, (os.cpu_count() or 1) // max(workers, 1))
    torch.set_num_threads(n)
    return n


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
    if name == "absolute_pos_embed":
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


# --------------------------------------------------------------------------
# Dataset trees in the releases' layouts, written with the port's own PNG
# writer (no cv2 or PIL), so they are made on the card machine too. Images
# are smooth random fields plus noise, depth a smooth positive field; every
# row Paeth-filtered (the writer's adaptive choice costs 4x the time).
# --------------------------------------------------------------------------


class _PngWriter:
    """PNG writes on a thread pool (zlib releases the interpreter lock);
    the arrays are drawn in order by the caller, so a tree is the same
    whatever the scheduling. Leaving the `with` block waits for every write
    and raises the first failure."""

    def __enter__(self):
        import os
        from concurrent.futures import ThreadPoolExecutor
        self.pool = ThreadPoolExecutor(max(os.cpu_count() or 1, 1))
        self.futures = []
        return self

    def __call__(self, path: str, img: np.ndarray) -> None:
        from mmde_tpu_torch.data.codec import write_png
        self.futures.append(self.pool.submit(write_png, path, img,
                                             filter_type=4))

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True)
        for f in self.futures:
            f.result()
        return False

# VOID-sized camera (D435i at 640 x 480; write_void_release scales the
# focal lengths and centre to the tree's size) and radtan coefficients
VOID_K = np.array([[514.638, 0.0, 315.267], [0.0, 518.858, 247.358],
                   [0.0, 0.0, 1.0]])
VOID_CAMERA = {"f_x": 514.638, "f_y": 518.858, "c_x": 315.267,
               "c_y": 247.358, "k_0": 0.0205, "k_1": -0.0473,
               "k_2": 0.0089, "p_x": 0.00062, "p_y": -0.00041}


def smooth_field(rng: np.random.Generator, h: int, w: int, channels: int,
                 lo: float, hi: float, cell: int = 16) -> np.ndarray:
    """float32 (h, w[, channels]) in [lo, hi]: a coarse random grid
    upsampled bilinearly."""
    from mmde_tpu_torch.data.imgproc import resize_bilinear
    shape = (h // cell + 2, w // cell + 2) + ((channels,) if channels > 1
                                              else ())
    coarse = rng.uniform(lo, hi, shape).astype(np.float32)
    return resize_bilinear(coarse, w, h)


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """uint8 RGB (h, w, 3): a smooth field plus noise of std 6."""
    img = smooth_field(rng, h, w, 3, 20.0, 235.0)
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _bag_record(header: dict, data: bytes) -> bytes:
    import struct
    hb = b""
    for k, v in header.items():
        f = k.encode() + b"=" + v
        hb += struct.pack("<I", len(f)) + f
    return (struct.pack("<I", len(hb)) + hb + struct.pack("<I", len(data))
            + data)


def write_imu_bag(path: str, stamps: np.ndarray, acc: np.ndarray,
                  gyro: np.ndarray, compression: str = "bz2") -> None:
    """A rosbag 2.0 file with one /camera/imu connection and one
    sensor_msgs/Imu message per stamp (seconds), in one chunk."""
    import bz2
    import struct
    conn = _bag_record({"op": b"\x07", "topic": b"/camera/imu",
                        "conn": struct.pack("<I", 0)}, b"")
    msgs = [conn]
    for k, ts in enumerate(stamps):
        ns = int(round(float(ts) * 1e9))
        body = struct.pack("<III", k, ns // 10**9, ns % 10**9)
        body += struct.pack("<I", 10) + b"camera_imu"
        body += struct.pack("<4d", 0.0, 0.0, 0.0, 1.0)
        body += struct.pack("<9d", *([0.0] * 9))
        body += struct.pack("<3d", *map(float, gyro[k]))
        body += struct.pack("<9d", *([0.0] * 9))
        body += struct.pack("<3d", *map(float, acc[k]))
        body += struct.pack("<9d", *([0.0] * 9))
        msgs.append(_bag_record({"op": b"\x02",
                                 "conn": struct.pack("<I", 0),
                                 "time": struct.pack("<Q", ns)}, body))
    payload = b"".join(msgs)
    if compression == "bz2":
        payload = bz2.compress(payload)
    chunk = _bag_record({"op": b"\x05",
                         "compression": compression.encode()}, payload)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n" + chunk)


def write_imu_csv(path: str, stamps: np.ndarray, acc: np.ndarray,
                  gyro: np.ndarray) -> None:
    """The rostopic-echo CSV of the same messages (data.rosbag's layout)."""
    from mmde_tpu_torch.data.rosbag import HEADER_COLS
    lines = [HEADER_COLS]
    for k, ts in enumerate(stamps):
        ns = int(round(float(ts) * 1e9))
        lines.append(f"{ns},{k},{ns},camera_imu,0.0,0.0,0.0,1.0,"
                     f"{gyro[k][0]},{gyro[k][1]},{gyro[k][2]},"
                     f"{acc[k][0]},{acc[k][1]},{acc[k][2]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_void_release(root: str, scenes: int = 2, frames: int = 24,
                       height: int = 480, width: int = 640,
                       imu_hz: float = 200.0,
                       bag_scenes: Tuple[int, ...] = (1,),
                       test_scenes: int = 1, seed: int = 0) -> dict:
    """A VOID release tree under `root`:

        void_release/void_1500/data/<scene>/{image, ground_truth,
            sparse_depth, validity_map}/<stamp>.png, absolute_pose/
            <stamp>.txt (3 x 4), K.txt
        void_raw/<scene>/raw.csv, or raw.bag (bz2 chunk) for `bag_scenes`
        meta/{train,test}_image.txt (the last `test_scenes` scenes test),
            meta/calibration.json (VOID_CAMERA, IMU biases, extrinsics)

    Frames at 15 Hz; depth in VOID's PNG convention (metres x 256, 0.3 to
    5 m, ~2 % of the pixels 0), sparse depth at ~1.5 % of the pixels; a
    smooth camera trajectory; IMU at `imu_hz` over the whole scene. Returns
    {"root", "meta", "scenes", "poses" {scene: [4x4]}, "stamps" {scene:
    [s]}, "imu" {scene: (stamps, acc, gyro)}}."""
    import json
    import os
    from mmde_tpu_torch.geometry import exp_so3
    rng = np.random.default_rng(seed)
    release = os.path.join(root, "void_release", "void_1500", "data")
    meta = os.path.join(root, "meta")
    os.makedirs(meta, exist_ok=True)
    names = [f"scene_{i:02d}" for i in range(scenes)]
    out = {"root": root, "meta": meta, "scenes": names, "poses": {},
           "stamps": {}, "imu": {}}
    lists = {"train": [], "test": []}
    t0 = 1552097915.0
    with _PngWriter() as png:
        for si, scene in enumerate(names):
            base = os.path.join(release, scene)
            for sub in ("image", "ground_truth", "sparse_depth",
                        "validity_map", "absolute_pose"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
            K = VOID_K.copy()
            K[0] *= width / 640.0
            K[1] *= height / 480.0
            np.savetxt(os.path.join(base, "K.txt"), K)
            start = t0 + 100.0 * si
            stamps = [start + i / 15.0 for i in range(frames)]
            poses = []
            for i, ts in enumerate(stamps):
                name = f"{ts:.4f}"
                png(os.path.join(base, "image", name + ".png"),
                    smooth_image(rng, height, width))
                depth = smooth_field(rng, height, width, 1, 0.3, 5.0)
                depth[rng.random((height, width)) < 0.02] = 0.0
                gt = np.rint(depth * 256.0).astype(np.uint16)
                png(os.path.join(base, "ground_truth", name + ".png"), gt)
                keep = rng.random((height, width)) < 0.015
                png(os.path.join(base, "sparse_depth", name + ".png"),
                    np.where(keep, gt, 0).astype(np.uint16))
                png(os.path.join(base, "validity_map", name + ".png"),
                    keep.astype(np.uint8))
                w = (np.array([0.02, -0.01, 0.015]) * i
                     + rng.normal(0, 0.002, 3))
                t = (np.array([0.03, 0.005, 0.02]) * i
                     + rng.normal(0, 0.002, 3))
                pose = np.eye(4)
                pose[:3, :3] = exp_so3(w)
                pose[:3, 3] = t
                poses.append(pose)
                np.savetxt(os.path.join(base, "absolute_pose", name + ".txt"),
                           pose[:3])
                split = "test" if si >= scenes - test_scenes else "train"
                lists[split].append(
                    f"void_release/void_1500/data/{scene}/image/{name}.png")
            raw = os.path.join(root, "void_raw", scene)
            os.makedirs(raw, exist_ok=True)
            n_imu = int((stamps[-1] - stamps[0] + 0.2) * imu_hz)
            imu_t = stamps[0] - 0.1 + np.arange(n_imu) / imu_hz
            acc = rng.normal(0.0, 0.3, (n_imu, 3)) + np.array([0.0, 0.0, 9.81])
            gyro = rng.normal(0.0, 0.05, (n_imu, 3))
            if si in bag_scenes:
                write_imu_bag(os.path.join(raw, "raw.bag"), imu_t, acc, gyro)
            else:
                write_imu_csv(os.path.join(raw, "raw.csv"), imu_t, acc, gyro)
            out["poses"][scene] = poses
            out["stamps"][scene] = stamps
            out["imu"][scene] = (imu_t, acc, gyro)
    for split, lines in lists.items():
        with open(os.path.join(meta, f"{split}_image.txt"), "w") as f:
            f.write("\n".join(lines))
    calib = {"alignment": {"t_camera_to_body": [0.0106, 0.0, 0.0],
                           "w_camera_to_body": [0.0021, -0.0034, 0.0012]},
             "imu": {"b_a": [0.05, -0.12, 0.08],
                     "b_g": [0.0011, -0.0007, 0.0004]},
             "camera": VOID_CAMERA}
    with open(os.path.join(meta, "calibration.json"), "w") as f:
        json.dump(calib, f)
    return out


def write_kitti_tree(root: str, n_train: int = 3, n_test: int = 2,
                     height: int = 375, width: int = 1242,
                     seed: int = 0) -> dict:
    """A KITTI Eigen-benchmark tree under `root`: kitti/<date>/<drive>/
    image_02/data/<frame>.png (RGB) and kitti/<drive>/proj_depth/
    groundtruth/image_02/<frame>.png (uint16, metres x 256, ~5 % of the
    pixels valid, as the projected LiDAR is), listed in
    filenames/eigen_benchmark/{train,test}_list.txt."""
    import os
    rng = np.random.default_rng(seed)
    date, drive = "2011_09_26", "2011_09_26_drive_0001_sync"
    lists = {}
    with _PngWriter() as png:
        for split, n in (("train", n_train), ("test", n_test)):
            lines = []
            for i in range(n):
                frame = f"{i + (0 if split == 'train' else 100):010d}.png"
                img_rel = f"/{date}/{drive}/image_02/data/{frame}"
                gt_rel = f"/{drive}/proj_depth/groundtruth/image_02/{frame}"
                for rel in (img_rel, gt_rel):
                    os.makedirs(os.path.dirname(os.path.join(root, "kitti")
                                                + rel), exist_ok=True)
                png(os.path.join(root, "kitti") + img_rel,
                    smooth_image(rng, height, width))
                depth = smooth_field(rng, height, width, 1, 2.0, 80.0)
                valid = rng.random((height, width)) < 0.05
                png(os.path.join(root, "kitti") + gt_rel,
                    np.where(valid, np.rint(depth * 256.0), 0
                             ).astype(np.uint16))
                lines.append(f"{img_rel} {gt_rel}")
            lists[split] = lines
    lst = os.path.join(root, "filenames", "eigen_benchmark")
    os.makedirs(lst, exist_ok=True)
    for split, lines in lists.items():
        with open(os.path.join(lst, f"{split}_list.txt"), "w") as f:
            f.write("\n".join(lines))
    return {"root": root, "lists": lists}


def write_nyu_tree(root: str, jpegs, frames_per_scene: int = 3,
                   train_scenes: int = 2, seed: int = 0) -> dict:
    """An NYU-Depth-V2 tree under `root`: nyu_depth_v2/<scene>/
    rgb_<i>.jpg (copies of the JPEG files `jpegs`, in turn) and
    sync_depth_<i>.png (uint16 millimetres, 480 x 640), listed in
    filenames/nyudepthv2/train_list.txt; `train_scenes` scenes of the
    training split and one of the held-out test scenes ("bathroom_0019")."""
    import os
    import shutil
    rng = np.random.default_rng(seed)
    scenes = [f"kitchen_{i + 1:04d}" for i in range(train_scenes)] + \
        ["bathroom_0019"]
    lines, k = [], 0
    with _PngWriter() as png:
        for scene in scenes:
            d = os.path.join(root, "nyu_depth_v2", scene)
            os.makedirs(d, exist_ok=True)
            for i in range(frames_per_scene):
                shutil.copyfile(jpegs[k % len(jpegs)],
                                os.path.join(d, f"rgb_{i:05d}.jpg"))
                k += 1
                depth = smooth_field(rng, 480, 640, 1, 0.5, 9.5)
                depth[rng.random((480, 640)) < 0.03] = 0.0
                png(os.path.join(d, f"sync_depth_{i:05d}.png"),
                    np.rint(depth * 1000.0).astype(np.uint16))
                lines.append(f"/{scene}/rgb_{i:05d}.jpg "
                             f"/{scene}/sync_depth_{i:05d}.png")
    lst = os.path.join(root, "filenames", "nyudepthv2")
    os.makedirs(lst, exist_ok=True)
    with open(os.path.join(lst, "train_list.txt"), "w") as f:
        f.write("\n".join(lines))
    return {"root": root, "scenes": scenes, "lines": lines}
