"""PyTorch port vs JAX package: the head-split kernels K6' / K7' on the
tensor cores, and the FMA head-split path's two-number log-sum-exp.

bf16 head-split launches (swin_large stage 1, swin_tiny / swin_huge stages
1-2) run csrc/window_attention_{fwd,bwd}_tc.cu through their head-split
entries: the packed kernels' tensor-core bodies over the strides of the
model's permuted views of qkv, in the TPU kernel's function (mode "fp32",
the running row maximum for every head, fp32 bias and mask tiles). Those
kernels run only on the card (chip_smoke.py, kernel_cases_headsplit, holds
them to the plain versions, to float64 autograd and MXU_APART times nearer
the "fp32" plain version than the "bf16"-mode one). Here, on the CPU:

  * the arithmetic they rely on, emulated in plain torch
    (`mmde_tpu_torch.testing.tc_forward_heads` / `tc_backward_heads`, the
    same emulation the packed tests use), on a permuted view of one qkv
    tensor, is held to the JAX package's `cosine_window_attention_pallas`
    (K6 / K7) in interpret mode, forward and backward;
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card;
  * the sources and signatures of the new C entries;
  * the FMA path's rebuild of p from the forward's (hi, lo) log-sum-exp
    (fault F3), against float64.

Inputs are drawn with numpy and rounded to bf16 (q, k, v through qkv, and
g) before both sides get them: the premise of the exact raw product.
"""
import contextlib
import ctypes
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops.window_attention_pallas import (
    cosine_window_attention_pallas as j_headsplit)
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.testing import tc_backward_heads, tc_forward_heads

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

LN100 = math.log(100.0)
NH, C = 3, 96           # swin_tiny's stage-1 width: C % 128 != 0


def _bf16r(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(B, N, masked, seed):
    """qkv (B, N, 3C) rounded to bf16; heads: 0 above the ln 100 clamp
    (scale 100), 1 hot (scale 60), 2 cool (scale e^2 = 7.4); 16*sigmoid
    bias and a 0/-100 mask over 2 windows (diagonal kept), both fp32; g
    (B, nH, N, 32) rounded to bf16."""
    rng = np.random.default_rng(seed)
    qkv = _bf16r(rng.standard_normal((B, N, 3 * C)).astype(np.float32))
    ls = np.array([LN100 + 0.5, math.log(60.0), 2.0],
                  np.float32).reshape(NH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((NH, N, N))))
            ).astype(np.float32)
    mask = None
    if masked:
        m = (rng.random((2, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = _bf16r(rng.standard_normal((B, NH, N, 32)).astype(np.float32))
    return qkv, ls, bias, mask, g


def _views(qkv: torch.Tensor):
    """q, k, v as WindowAttention forms them: permuted views of qkv, strides
    (N*3C, 32, 3C)."""
    B, N, C3 = qkv.shape
    return qkv.reshape(B, N, 3, NH, 32).permute(2, 0, 3, 1, 4).unbind(0)


def _jax_run(qkv, ls, bias, mask, g):
    """The Pallas v1 kernels' output and jax.vjp (dq, dk, dv,
    dlogit_scale, dbias), interpret mode, fp32 inputs."""
    B, N, _ = qkv.shape
    x = jnp.asarray(qkv).reshape(B, N, 3, NH, 32).transpose(2, 0, 3, 1, 4)
    m = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, k, v, l, b: j_headsplit(q, k, v, l, b, m),
                       x[0], x[1], x[2], jnp.asarray(ls), jnp.asarray(bias))
    return [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]


_CASES = {}


def _case(N, masked):
    """(inputs, JAX results, emulation results, bf16-mode plain results) at
    one (N, mask), computed once per process."""
    key = (N, masked)
    if key not in _CASES:
        qkv, ls, bias, mask, g = x = _inputs(2, N, masked, seed=N + masked)
        q, k, v = _views(torch.from_numpy(qkv))
        lt, bt, gt = (torch.from_numpy(a) for a in (ls, bias, g))
        mt = None if mask is None else torch.from_numpy(mask)
        emu = [tc_forward_heads(q, k, v, lt, bt, mt, "fp32", maxfree=False)]
        emu += tc_backward_heads(q, k, v, lt, bt, mt, gt, "fp32")
        rnd = [ths.cosine_window_attention_headsplit_plain(
            q, k, v, lt, bt, mt, mxu="bf16", maxfree=False)]
        rnd += list(ths.cosine_window_attention_headsplit_backward_plain(
            q, k, v, lt, bt, mt, gt, mxu="bf16"))
        _CASES[key] = (x, _jax_run(*x), [t.numpy() for t in emu],
                       [t.numpy() for t in rnd])
    return _CASES[key]


_NAMES = ("out", "dq", "dk", "dv", "dlogit_scale", "dbias")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [49, 100])
def test_emulated_body_matches_jax_headsplit_kernel(N, masked):
    """The tensor-core arithmetic on head-split views keeps K6 / K7's
    function: output and every gradient within 1e-5 of the JAX kernels'
    (max abs relative to the largest value of the JAX result, and rel-L2),
    as test_torch_port_tc.py holds the packed emulation. N = 100 leaves a
    ragged 64-row tile (100 = 64 + 36). dlogit_scale is bounded at 5e-5,
    as there: a sum of B_*N^2 signed terms that cancel, where at the hot
    head (scale 60) an fp32 ulp of a logit moves every p of its row. The
    clamped head's dlogit_scale is exactly zero on both sides."""
    _, jax_res, emu, _ = _case(N, masked)
    for name, a, b in zip(_NAMES, emu, jax_res):
        a = a.reshape(b.shape)
        bound = 5e-5 if name == "dlogit_scale" else 1e-5
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert err <= bound, (name, N, masked, err)
        assert rel_l2 <= bound, (name, N, masked, rel_l2)
        assert float(np.abs(b).max()) > 1e-3, name
    assert float(emu[4].flatten()[0]) == 0.0
    assert float(jax_res[4].flatten()[0]) == 0.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [49, 100])
def test_split_keeps_the_fp32_function(N, masked):
    """The CPU proof that the head-split kernels keep K6 / K7's fp32
    function on bf16 tensor cores: the emulation lies at least 4x nearer
    the JAX kernels' results than the port's "bf16"-mode plain version
    does (a body that rounded q^, k^, p or ds to bf16 would sit near the
    latter), for the output and every gradient."""
    _, jax_res, emu, rnd = _case(N, masked)
    for name, a, r, j in zip(_NAMES, emu, rnd, jax_res):
        a, r = a.reshape(j.shape), r.reshape(j.shape)
        to_jax = float(np.linalg.norm(a - j) / np.linalg.norm(j))
        rounded = float(np.linalg.norm(r - j) / np.linalg.norm(j))
        assert rounded >= 4.0 * to_jax, (name, N, masked, to_jax, rounded)


# --------------------------------------------------------------- routing

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrapper's CUDA branch
    runs, into the recorders below."""

    @property
    def is_cuda(self):
        return True


def _aligned(ptr, strides, esize):
    """The C entries' rows_aligned: base and the three outer strides keep
    every row 16-byte aligned."""
    return ptr % 16 == 0 and all(s * esize % 16 == 0 for s in strides)


class _Recorder:
    """Stands in for a ctypes library: every entry point records its name,
    its arguments and (read at the call) the host strides array, and returns
    0, or -1 as the C entries do where a head-split operand's row is not
    16-byte aligned (at the element size the entry's qkv_bf16 argument
    gives: third from last in a forward and in K3's entry, fourth in a
    backward)."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)

        def fn(*args):
            rec = {"entry": entry, "args": args}
            if "headsplit" in entry:
                n_ops = 4 if "bwd" in entry or "dbias" in entry else 3
                st = (ctypes.c_longlong * (3 * n_ops)).from_address(
                    args[n_ops])
                rec["strides"] = [tuple(st[3 * i:3 * i + 3])
                                  for i in range(n_ops)]
                esize = 2 if args[-4 if "bwd" in entry else -3] else 4
                if not all(_aligned(args[i], rec["strides"][i], esize)
                           for i in range(n_ops)):
                    self._calls.append(rec)
                    return -1
            self._calls.append(rec)
            return 0
        fn.argtypes = []        # bound: the wrapper leaves it as it is
        return fn


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    lib = _Recorder(calls)
    monkeypatch.setattr(twp, "_library", lambda mxu="fp32": lib)
    monkeypatch.setattr(twp, "_library_bwd", lambda: lib)
    monkeypatch.setattr(twp, "_library_tc", lambda backward: lib)
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    ths.reset_launch_counts()
    yield calls
    ths.reset_launch_counts()


def _drive(dtype, train=True, N=36):
    """The public wrapper on the model's views of one qkv tensor, forward
    (and backward under autograd), fp32 bias and mask as the stage hands
    them over; returns (qkv, g)."""
    qkv, ls, bias, mask, g = _inputs(4, N, True, seed=3)
    qt = torch.from_numpy(qkv).to(dtype).as_subclass(_OnCard)
    b, m, lt = (torch.from_numpy(a) for a in (bias, mask, ls))
    gt = torch.from_numpy(g).to(dtype)
    if not train:
        with torch.no_grad():
            ths.cosine_window_attention_headsplit(*_views(qt), lt, b, m)
        return qt, gt
    qt.requires_grad_()
    b.requires_grad_()
    out = ths.cosine_window_attention_headsplit(*_views(qt), lt, b, m)
    out.backward(gt)
    return qt, gt


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routing_follows_the_type(recorded, dtype, train):
    """bf16 and fp32 q, k, v run the head-split tensor-core entries, told
    the operand type (qkv_bf16 1 / 0), with the strides of the model's
    permuted views (N*3C, 32, 3C) - no copy - fp32 bias and mask, the
    statistic of the type (bf16 (B_, nH, N); fp32 (2, B_, nH, N), hi and
    lo) and dbias by atomics (mode 1). The counters name the kernel that
    ran."""
    _drive(dtype, train)
    B, N = 4, 36
    bf16 = int(dtype == torch.bfloat16)
    want = ["mmde_window_attention_headsplit_fwd_tc"]
    if train:
        want.append("mmde_window_attention_headsplit_bwd_tc")
    assert [c["entry"] for c in recorded] == want
    view = (N * 3 * C, 32, 3 * C)
    for c in recorded:
        assert c["strides"][:3] == [view] * 3, c["strides"]
        ints = [a for a in c["args"] if isinstance(a, int) and a < 1 << 16]
        assert ints[:4] == [B, N, NH, 2], ints      # B_, N, nH, nW
    f = recorded[0]["args"]
    assert len(f) == len(ths._FWD_TC_ARGTYPES)
    assert f[-3] == bf16                        # qkv_bf16
    assert f[-2] == 0                           # bias_bf16: fp32 tiles
    assert (f[8] is not None) == train          # lse only when training
    if train:
        b = recorded[1]["args"]
        assert b[-4] == bf16 and b[-3] == 0     # qkv_bf16, bias_bf16
        assert b[-2] == 1                       # dbias by atomics
        assert len(b) == len(ths._BWD_TC_ARGTYPES)
        assert recorded[1]["strides"][3] == (NH * N * 32, N * 32, 32)  # g
        assert b[8] == f[8]                     # the forward's statistic
    kernel = "window_attention_headsplit_fwd_tc"
    counted = {kernel + ("+lse" if train else ""): 1}
    if train:
        counted["window_attention_headsplit_bwd_tc"] = 1
    assert ths.launch_counts() == counted
    assert ths.LAUNCHES == 1 and ths.LAUNCHES_BWD == int(train)
    key = (B, N, C, NH)
    assert ths.LAUNCHES_BY_SHAPE == {key: 1}
    assert ths.LAUNCHES_BWD_BY_SHAPE == ({key: 1} if train else {})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_runs_the_tensor_core_k3_after_the_passes(recorded,
                                                        monkeypatch, dtype):
    """Under MMDE_ATTN_GRID=split (the packed module's DEFAULT_GRID_MODE)
    a head-split backward runs the tensor-core passes without dbias (mode
    0), then K3's head-split entry on the same views' strides, the
    forward's statistic and the delta the passes wrote; K3 is counted as
    window_attention_headsplit_dbias_tc, outside the per-shape backward
    counts."""
    monkeypatch.setattr(twp, "DEFAULT_GRID_MODE", "split")
    _drive(dtype)
    B, N = 4, 36
    bf16 = int(dtype == torch.bfloat16)
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_tc",
        "mmde_window_attention_headsplit_bwd_tc",
        "mmde_window_attention_headsplit_dbias_tc"]
    f, b, d = (c["args"] for c in recorded)
    assert b[-2] == 0                           # the passes: no dbias
    assert len(d) == len(ths._DBIAS_TC_ARGTYPES)
    assert recorded[2]["strides"] == recorded[1]["strides"]
    assert d[8] == f[8] == b[8]                 # the forward's statistic
    assert d[9] == b[12]                        # the dq pass's delta
    # ..., B_, N, nH, nW, qkv_bf16, bias_bf16, stream
    assert d[-7:-1] == (B, N, NH, 2, bf16, 0)
    assert ths.launch_counts() == {
        "window_attention_headsplit_fwd_tc+lse": 1,
        "window_attention_headsplit_bwd_tc": 1,
        "window_attention_headsplit_dbias_tc": 1}
    assert ths.LAUNCHES_BWD_BY_SHAPE == {(B, N, C, NH): 1}


def test_split_fma_body_runs_its_own_k3(recorded, monkeypatch):
    """`_fma` under "split": the FMA backward entry with dbias_mode 2, its
    own windows-innermost pass (counted as
    window_attention_headsplit_dbias); the tensor-core K3 refuses the FMA
    forward's statistic."""
    monkeypatch.setattr(twp, "DEFAULT_GRID_MODE", "split")
    qkv, ls, bias, mask, g = _inputs(2, 36, True, seed=8)
    lt, bt, mt = (torch.from_numpy(a) for a in (ls, bias, mask))
    q, k, v = _views(torch.from_numpy(qkv).bfloat16())
    gt = torch.from_numpy(g).bfloat16()
    _, lse = ths._launch_forward(q, k, v, lt, bt, mt, True, _fma=True)
    ths._launch_backward(q, k, v, lt, bt, mt, lse, gt, True, _fma=True)
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_stats",
        "mmde_window_attention_headsplit_bwd"]
    assert recorded[1]["args"][-2] == 2
    assert ths.launch_counts()["window_attention_headsplit_dbias"] == 1
    delta = torch.zeros((2, NH, 36))
    with pytest.raises(ValueError, match="log-sum-exp"):
        ths._launch_dbias(q, k, v, gt, lt, bt, mt, lse, delta)
    assert len(recorded) == 2


def test_model_layout_gradient_is_read_in_place(recorded):
    """The gradient reaches the backward as the model hands it back: the
    output's (B_, N, C) reshape undone by a permuted view, strides (N*C,
    32, C), which the entry reads in place - no copy in any step."""
    qkv, ls, bias, mask, _ = _inputs(4, 36, True, seed=7)
    qt = torch.from_numpy(qkv).bfloat16().as_subclass(_OnCard)
    qt.requires_grad_()
    out = ths.cosine_window_attention_headsplit(
        *_views(qt), torch.from_numpy(ls), torch.from_numpy(bias),
        torch.from_numpy(mask))
    merged = out.permute(0, 2, 1, 3).reshape(4, 36, C)   # as WindowAttention
    (merged.float() * 2.0).sum().backward()
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_tc",
        "mmde_window_attention_headsplit_bwd_tc"]
    assert recorded[1]["strides"][3] == (36 * C, 32, C)


def test_statistics_take_the_body_s_shape(recorded):
    """The forward hands the backward what its body reads: (B_, nH, N) from
    the tensor-core forward, (2, B_, nH, N) from the FMA one; a backward
    handed the other body's statistics raises before any launch."""
    qkv, ls, bias, mask, g = _inputs(2, 36, False, seed=4)
    lt, bt = torch.from_numpy(ls), torch.from_numpy(bias)
    q, k, v = _views(torch.from_numpy(qkv).bfloat16())
    gt = torch.from_numpy(g).bfloat16()
    _, lse = ths._launch_forward(q, k, v, lt, bt, None, True)
    _, lse_f = ths._launch_forward(q, k, v, lt, bt, None, True, _fma=True)
    assert tuple(lse.shape) == (2, NH, 36)
    assert tuple(lse_f.shape) == (2, 2, NH, 36)
    with pytest.raises(ValueError, match="log-sum-exp"):
        ths._launch_backward(q, k, v, lt, bt, None, lse_f, gt, True)
    with pytest.raises(ValueError, match="log-sum-exp"):
        ths._launch_backward(q, k, v, lt, bt, None, lse, gt, True, _fma=True)
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_tc",
        "mmde_window_attention_headsplit_fwd_stats"]


def test_private_fma_argument_reaches_the_fma_entries(recorded):
    """`_fma` sends a bf16 launch to the FMA entries (chip_smoke.py's
    same-card comparison, tools/bench_attention.py), with qkv_bf16 set;
    it is not reachable from the public wrapper."""
    qkv, ls, bias, mask, g = _inputs(2, 36, True, seed=5)
    lt, bt, mt = (torch.from_numpy(a) for a in (ls, bias, mask))
    q, k, v = _views(torch.from_numpy(qkv).bfloat16())
    gt = torch.from_numpy(g).bfloat16()
    _, lse = ths._launch_forward(q, k, v, lt, bt, mt, True, _fma=True)
    ths._launch_backward(q, k, v, lt, bt, mt, lse, gt, True, _fma=True)
    ths._launch_forward(q, k, v, lt, bt, mt, False, _fma=True)
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_stats",
        "mmde_window_attention_headsplit_bwd",
        "mmde_window_attention_headsplit_fwd"]
    assert recorded[0]["args"][-3] == 1         # qkv_bf16
    assert ths.launch_counts() == {"window_attention_headsplit_bwd": 1,
                                   "window_attention_headsplit_fwd": 1,
                                   "window_attention_headsplit_fwd+lse": 1}
    import inspect
    public = inspect.signature(
        ths.cosine_window_attention_headsplit).parameters
    assert not any(p.startswith("_") for p in public)
    for fn in (ths._launch_forward, ths._launch_backward):
        private = [p for p in inspect.signature(fn).parameters
                   if p.startswith("_")]
        assert private == ["_fma"]


@pytest.mark.parametrize("entry_dtype", [torch.bfloat16, torch.float32])
def test_unaligned_stride_raises(recorded, monkeypatch, entry_dtype):
    """A view whose rows are not 16-byte aligned is refused by the C
    entries (rows_aligned, -1), and the wrapper raises on it - it never
    falls back. (The public wrapper copies such a view first, `_rows`;
    here that copy is bypassed to reach the entry.)"""
    monkeypatch.setattr(ths, "_rows", lambda t: t)
    qkv, ls, bias, _, _ = _inputs(2, 36, False, seed=6)
    flat = torch.from_numpy(qkv).to(entry_dtype).reshape(-1)
    # one element off: every row starts 2 or 4 bytes past a 16-byte line
    off = flat[1:1 + qkv.size - 3 * C * 2].reshape(2, 35, 3 * C)
    q, k, v = _views(off)
    assert not ths.rows_layout_ok(q)
    with pytest.raises(RuntimeError, match="launch failed with code -1"):
        ths._launch_forward(q, k, v, torch.from_numpy(ls),
                            torch.from_numpy(bias)[:, :35, :35].contiguous(),
                            None, False)
    assert len(recorded) == 1 and ths.LAUNCHES == 0


def test_tensor_core_rule_is_the_packed_one():
    """Head-split launches take the tensor cores by the packed module's
    head-split rule (one window per block always), bf16 and fp32 alike, as
    packed launches do; the slab wrapper's own rule takes both types
    too."""
    assert twp.headsplit_tensor_core_body(torch.bfloat16)
    assert twp.headsplit_tensor_core_body(torch.float32)
    assert twp.tensor_core_body(torch.float32)
    assert twp.slab_tensor_core_body(torch.bfloat16)
    assert twp.slab_tensor_core_body(torch.float32)


# ------------------------------------------------------- sources and build

def _entries(src: str) -> dict:
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    return {m.group(1): (m.group(2), m.group(3))
            for m in re.finditer(
                r'extern "C" int (\w+)\((.*?)\)\s*{(.*?)\n}', text, re.S)}


@pytest.mark.parametrize("entry,src,argtypes", [
    ("mmde_window_attention_headsplit_fwd_tc", "window_attention_fwd_tc.cu",
     "_FWD_TC_ARGTYPES"),
    ("mmde_window_attention_headsplit_bwd_tc", "window_attention_bwd_tc.cu",
     "_BWD_TC_ARGTYPES")])
def test_tensor_core_entries_and_signatures(entry, src, argtypes):
    """No compiler here: the head-split tensor-core entries live in the
    tensor-core libraries the model's build already holds (no new library),
    take the strides array after the operands, every ctypes argument type
    matches its C parameter (pointers c_void_p, ints c_int), and the body
    runs mode MXU_FP32 with maxfree 0 (the TPU kernel's function: no
    max-free softmax, so F1 cannot arise), contiguous outputs, and the
    packed launch's own alignment check on every operand."""
    params, body = _entries(src)[entry]
    params = [p.strip() for p in params.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert kinds == getattr(ths, argtypes)
    n_ops = 4 if "bwd" in entry else 3
    assert params[n_ops] == "const void* strides"
    assert params[-4:] == (["int qkv_bf16", "int bias_bf16", "int dbias_mode",
                            "void* stream"] if "bwd" in entry else
                           ["int nW", "int qkv_bf16", "int bias_bf16",
                            "void* stream"])
    assert "MXU_FP32" in body and "MXU_FOLD" not in body
    assert "contiguous_rows" in body
    # fp32 q, k, v: the packed fp32 instantiation, fp32 bias only
    assert "if (!qkv_bf16 && bias_bf16) return -1;" in body
    assert "launch<Rows, float, float, MXU_FP32>" in body
    if "fwd" in entry:
        # launch<Rows, T, TB, MXU_FP32>(..., maxfree = 0, stream), each type
        assert len(re.findall(r"launch<Rows, (?:bf16|float), (?:bf16|float), "
                              r"MXU_FP32>\([^;]*,\s+0,\s+s\)",
                              body, re.S)) == 3
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    assert "rows_aligned(rq)" in text or "o.aligned()" in text
    # dls_part: one row per (window, 64-key tile), the wrapper's BWD_TILE
    hdr = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_tc.cuh")).read()
    assert "constexpr int TC_BT = 64;" in hdr and twp.BWD_TILE == 64
    lib = "window_attention_bwd_tc" if "bwd" in entry else \
        "window_attention_fwd_tc"
    assert twp.library_specs()[lib] == ((src,), ())


def test_fma_entries_hand_over_hi_and_lo():
    """F3's remedy in the FMA sources: the head-split, slab and (since the
    packed body's repair) packed forwards write hi and lo of each row's
    log-sum-exp (formed in fp64) into a (2, B_, nH, N) buffer, their
    backwards read the lo half and rebuild p as exp((s - hi) - lo); no
    entry passes a null lo, and no backward kernel is instantiated without
    it but K3's, behind the bf16 tensor-core passes (lse_pair 0)."""
    fwd = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_fwd.cu")).read()
    bwd = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_bwd.cu")).read()
    assert "(double)sM[tid] + log((double)sL[tid])" in fwd
    assert "(float*)lse + (size_t)B_ * nH * N" in fwd
    assert "(const float*)lse + (size_t)B_ * nH * N" in bwd
    assert "exp_<FASTEXP>(LO ? (v - lse) - lo : v - lse)" in bwd
    assert len(re.findall(r"lse, nullptr, B_", fwd)) == 0
    assert len(re.findall(r"lse,\s+lo, B_", fwd)) == 3  # packed, map, strided
    assert len(re.findall(r"launch<(?:Rows|MapRows), T, TB, FASTEXP, MXU, "
                          r"false>", bwd)) == 0
    assert len(re.findall(r"launch<Rows, T, TB, FASTEXP, MXU, true>",
                          bwd)) == 2
    assert len(re.findall(r"launch<MapRows, T, TB, FASTEXP, MXU, true>",
                          bwd)) == 1


# ------------------------------------------------------------ F3, plainly

def _scale60_rows(rows=64, n=900, seed=0):
    """fp32 logits of `rows` query rows of a head at scale 60 over n keys
    (cosines times 60 plus a 16*sigmoid bias), and their float64 softmax."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, 32))
    k = rng.standard_normal((n, 32))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    bias = 16.0 / (1.0 + np.exp(-rng.standard_normal((rows, n))))
    s = torch.from_numpy(60.0 * q @ k.T + bias).float()
    return s, torch.softmax(s.double(), dim=-1)


def test_f3_rebuild_from_hi_and_lo_matches_float64():
    """The plain rebuild the FMA head-split kernels follow: p = exp((s -
    hi) - lo) from the forward's (hi, lo) sums to 1 within 5e-7 in every
    row of a scale-60 head (row maxima 32-64), as float64 does; the
    one-number rebuild p = exp(s - lse), lse = m + log(l) in fp32, scales
    whole rows by its rounding (up to half an fp32 ulp, 1.9e-6) and misses
    that in some row by more than 1e-6 - the fault (F3) whose cancelling
    dlogit_scale sum showed it at 1.5e-4 on the card."""
    s, truth = _scale60_rows()
    hi, lo = ths.lse_pair(s)
    assert float(s.amax(dim=-1).min()) > 32.0    # an fp32 ulp: 3.8e-6
    x = hi.double() + lo.double()
    want = torch.logsumexp(s.double(), dim=-1)
    # what is left is the fp32 row sum's own rounding, below an ulp of lse
    assert float((x - want).abs().max()) <= 5e-7
    m = s.amax(dim=-1)
    one = m + torch.log(torch.exp(s - m[:, None]).sum(dim=-1))
    pair = ths.rebuild_probabilities(s, hi, lo)
    single = ths.rebuild_probabilities(s, one)
    mass_pair = (pair.double().sum(-1) - 1.0).abs()
    mass_one = (single.double().sum(-1) - 1.0).abs()
    assert float(mass_pair.max()) <= 5e-7, float(mass_pair.max())
    assert float(mass_one.max()) > 1e-6, float(mass_one.max())
    # the rows' distributions, L1 against float64
    l1_pair = (pair.double() - truth).abs().sum(-1)
    l1_one = (single.double() - truth).abs().sum(-1)
    assert float(l1_pair.median()) * 4 <= float(l1_one.median())


def test_f3_rebuild_without_lo_is_the_one_number_form():
    """Without lo the rebuild is exp(s - lse) exactly, the form of the
    bf16 tensor-core kernels (their numbers do not move)."""
    s, _ = _scale60_rows(rows=8, n=64, seed=1)
    hi, lo = ths.lse_pair(s)
    torch.testing.assert_close(ths.rebuild_probabilities(s, hi),
                               torch.exp(s - hi[:, None]), rtol=0, atol=0)
    torch.testing.assert_close(ths.rebuild_probabilities(s, hi,
                                                         torch.zeros_like(lo)),
                               torch.exp(s - hi[:, None]), rtol=0, atol=0)
