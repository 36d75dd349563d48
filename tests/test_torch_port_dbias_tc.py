"""PyTorch port vs JAX package: K3, the windows-innermost dbias pass of
MMDE_ATTN_GRID=split, on the tensor cores.

Under "split" every packed and head-split backward of the port runs its
tensor-core dq and dk/dv passes without dbias, then the tensor-core K3
(csrc/window_attention_bwd_tc.cu, `bwd_dbias_tc_kernel`): one block per
(query tile, key tile, head) sums ds = p (dP - delta) over every window in
one fixed order, type-major where masked, and writes its tile once - the
same bits on every run. That kernel runs only on the card (chip_smoke.py
holds it to the plain backward, to float64 autograd, MXU_APART times nearer
its own mode, and bitwise over two launches). Here, on the CPU:

  * its arithmetic, emulated in plain torch (`testing.tc_dbias` /
    `tc_dbias_heads`: S and dP as the tensor-core dq pass forms them, fp32
    operands in three bf16 pieces, windows summed one after another in
    `dbias_order`), is held to the JAX package's split dbias kernel
    (`_pallas_dbias`, through the VJP of `cosine_window_attention_packed(...,
    grid_mode="split")` in interpret mode) in each precision mode, bf16 and
    fp32 qkv, and to float64 autograd; on head-split views to the JAX
    head-split kernel's dbias;
  * the order helper against the kernel's source, the FMA partner's
    routing, the statistic rule, and the new C entries' signatures.
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops import window_attention_packed as jwap
from mmde_tpu.ops.window_attention_pallas import (
    cosine_window_attention_pallas as j_headsplit)
from mmde_tpu_torch import testing
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.testing import dbias_order, tc_dbias, tc_dbias_heads

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

LN100 = math.log(100.0)
# the emulation against the JAX kernel (test_torch_port_tc.py's dbias
# bounds: max abs over the largest value, rel-L2): fp32 / fold 1e-5; the
# "bf16" mode, whose rounded operands flip across a bf16 boundary where the
# two sides' fp32 norms differ by an ulp, 5e-4 / 5e-5
JAX_BOUND = {"fp32": (1e-5, 1e-5), "fold": (1e-5, 1e-5),
             "bf16": (5e-4, 5e-5)}
# against float64 autograd of the plain forward in the same mode, rel-L2:
# the card's fp32 dbias limit (chip_smoke.py TOL_BWD), and for "bf16"
# TOL_MXU_BF16_AUTOGRAD's dbias (the mode's formulas round ds)
F64_BOUND = {"fp32": 2e-5, "fold": 2e-5, "bf16": 4e-3}
MXU_APART = 4.0         # chip_smoke.py's mode rule


def _bf16r(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(kind, B, N, masked, seed, nH=4):
    """nH heads of 32: head 0 clamped at scale 100, head 1 hot (scale
    60), the rest cool; 16*sigmoid bias; a 0/-100 mask (diagonal kept) over
    2 windows or None; qkv (B, N, 3C) and g (B, N, C) rounded to bf16 for
    kind "bf16", unrounded fp32 for "fp32"."""
    rng = np.random.default_rng(seed)
    C = 32 * nH
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    if kind == "bf16":
        qkv, g = _bf16r(qkv), _bf16r(g)
    ls = np.array([LN100 + 0.5, math.log(60.0)] +
                  [1.5 + i for i in range(nH - 2)],
                  np.float32).reshape(nH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if masked:
        m = (rng.random((2, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    return qkv, ls, bias, mask, g, nH


def _jax_dbias(qkv, ls, bias, mask, g, nH, mxu):
    """dbias of the JAX op's VJP under grid_mode="split" (its dbias-only
    kernel), interpret mode, the row-maximum softmax for every head
    (SOFTMAX_MAXFREE off for the call: ROADMAP F1)."""
    N, C = qkv.shape[1], qkv.shape[2] // 3
    _, Np, _, HG, nG, _ = jwap.attention_plan(N, nH, 32, C)
    m = None if mask is None else jnp.asarray(mask)

    def f(b_hnn):
        bp = jwap.pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return jwap.cosine_window_attention_packed(
            jnp.asarray(qkv), jnp.asarray(ls), bp, m, num_heads=nH, mxu=mxu,
            grid_mode="split", interpret=True)

    maxfree = jwap.SOFTMAX_MAXFREE
    jwap.SOFTMAX_MAXFREE = False
    try:
        _, vjp = jax.vjp(f, jnp.asarray(bias))
        return np.asarray(vjp(jnp.asarray(g))[0])
    finally:
        jwap.SOFTMAX_MAXFREE = maxfree


def _float64_dbias(qkv, ls, bias, mask, g, nH, mxu):
    """dbias of float64 autograd of the plain forward in mode `mxu`."""
    b = torch.from_numpy(bias).double().requires_grad_()
    out = twp.cosine_window_attention_packed_plain(
        torch.from_numpy(qkv).double(), torch.from_numpy(ls).double(), b,
        None if mask is None else torch.from_numpy(mask).double(),
        num_heads=nH, compute_dtype=torch.float64, mxu=mxu)
    return torch.autograd.grad(out, b, torch.from_numpy(g).double())[0]


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _held(emu, ref, bound, what):
    """max abs over the reference's largest value, and rel-L2, within
    `bound`; the reference not near zero."""
    emu, ref = np.asarray(emu), np.asarray(ref)
    top = float(np.abs(ref).max())
    assert top > 1e-3, (what, top)
    assert float(np.abs(emu - ref).max()) / top <= bound[0], what
    assert _rel_l2(emu, ref) <= bound[1], (what, _rel_l2(emu, ref))


@pytest.mark.parametrize("case", [
    # (qkv type, N, B_, masked, modes)
    ("bf16", 49, 4, True, ("fp32", "fold", "bf16")),
    ("fp32", 36, 4, True, ("fp32", "fold", "bf16")),
    ("bf16", 36, 2, False, ("fold",)),
    ("fp32", 49, 2, False, ("fp32",)),
])
def test_emulated_k3_matches_jax_split_and_float64(case):
    """The tensor-core K3's arithmetic (bf16 qkv: exact bf16 operands;
    fp32 qkv: three bf16 pieces) keeps each mode's dbias: within
    JAX_BOUND of the JAX split kernel's and F64_BOUND of float64 autograd;
    masked over 2 window types of 2 samples each (the type-major order is
    not the natural one). With all three modes: MXU_APART times nearer its
    own mode's JAX result than the other's (fp32 / fold against "bf16",
    "bf16" against "fold"), as the card holds the kernel."""
    kind, N, B, masked, modes = case
    x = _inputs(kind, B, N, masked, seed=N + 10 * masked)
    pieces = 3 if kind == "fp32" else 0
    emu, ref = {}, {}
    for mxu in modes:
        emu[mxu] = tc_dbias(*x, mxu, pieces=pieces).numpy()
        ref[mxu] = _jax_dbias(*x, mxu)
        _held(emu[mxu], ref[mxu], JAX_BOUND[mxu], (case, mxu, "jax"))
        f64 = _float64_dbias(*x, mxu).numpy()
        assert float(np.abs(f64).max()) > 1e-3
        assert _rel_l2(emu[mxu], f64) <= F64_BOUND[mxu], (case, mxu)
    if len(modes) == 3:
        for mxu, other in (("fp32", "bf16"), ("fold", "bf16"),
                           ("bf16", "fold")):
            own = _rel_l2(emu[mxu], ref[mxu])
            far = _rel_l2(emu[mxu], ref[other])
            assert far >= MXU_APART * own, (case, mxu, own, far)


def _heads(qkv, nH):
    B, N, _ = qkv.shape
    return torch.from_numpy(qkv).reshape(B, N, 3, nH, 32).permute(
        2, 0, 3, 1, 4).unbind(0)


@pytest.mark.parametrize("kind,N,masked", [("bf16", 49, True),
                                           ("fp32", 36, False)])
def test_emulated_k3_on_headsplit_views(kind, N, masked):
    """Head-split views of one qkv tensor (nH 3, C 96, swin_tiny's stage-1
    width), mode fp32 as the head-split entries run: the emulation's dbias
    within 1e-5 of the JAX head-split kernel's (its per-window dump summed
    in XLA), within 2e-5 of float64 autograd, and MXU_APART times nearer the
    JAX kernel than the port's "bf16"-mode plain version is."""
    qkv, ls, bias, mask, g, nH = _inputs(kind, 4, N, masked, seed=7, nH=3)
    q, k, v = _heads(qkv, nH)
    gh = torch.from_numpy(g).reshape(4, N, nH, 32).permute(0, 2, 1, 3)
    lt, bt = torch.from_numpy(ls), torch.from_numpy(bias)
    mt = None if mask is None else torch.from_numpy(mask)
    emu = tc_dbias_heads(q, k, v, lt, bt, mt, gh, "fp32",
                         pieces=3 if kind == "fp32" else 0).numpy()
    xj = jnp.asarray(qkv).reshape(4, N, 3, nH, 32).transpose(2, 0, 3, 1, 4)
    mj = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda b: j_headsplit(xj[0], xj[1], xj[2],
                                           jnp.asarray(ls), b, mj),
                     jnp.asarray(bias))
    ref = np.asarray(vjp(jnp.asarray(gh.numpy()))[0])
    _held(emu, ref, (1e-5, 1e-5), (kind, N, masked))
    f64 = _float64_dbias(qkv, ls, bias, mask, g, nH, "fp32").numpy()
    assert _rel_l2(emu, f64) <= 2e-5
    rnd = ths.cosine_window_attention_headsplit_backward_plain(
        q, k, v, lt, bt, mt, gh, mxu="bf16")[4].numpy()
    assert _rel_l2(rnd, ref) >= MXU_APART * _rel_l2(emu, ref)


def test_windows_are_summed_type_major_in_a_fixed_order():
    """`dbias_order` is type-major where masked (window type b % nW outer,
    sample inner: the JAX dbias grid's (nW, S)) and natural otherwise; the
    emulation's dbias is bitwise that order's window-after-window sum of
    ds; the kernel walks the same order (its `window` lambda)."""
    assert dbias_order(8, 4) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert dbias_order(6, 2) == [0, 2, 4, 1, 3, 5]
    assert dbias_order(3, 3) == [0, 1, 2]
    assert dbias_order(5, 0) == [0, 1, 2, 3, 4]
    qkv, ls, bias, mask, g, nH = _inputs("bf16", 8, 36, True, seed=3)
    mask = np.concatenate([mask, mask])          # 4 types of 2 samples
    q, k, v = _heads(qkv, nH)
    gh = torch.from_numpy(g).reshape(8, 36, nH, 32).permute(0, 2, 1, 3)
    lt, bt, mt = (torch.from_numpy(a) for a in (ls, bias, mask))
    got = tc_dbias_heads(q, k, v, lt, bt, mt, gh, "fold")
    s = testing._logits(q, k, lt, bt, mt, "fold")[0]
    p = torch.softmax(s, dim=-1)
    dp = testing._dp(gh, v, "fold", 0)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    acc = ds[0]
    for b in dbias_order(8, 4)[1:]:
        acc = acc + ds[b]
    assert torch.equal(got, acc)
    assert torch.equal(got, testing.group_sum(ds[[0, 4, 1, 5, 2, 6, 3, 7]],
                                              8))
    src = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_bwd_tc.cu")).read()
    assert "masked ? (s % S) * nW + s / S : s" in src


def _kernel_body(src: str, name: str) -> str:
    start = src.index(name + "(")
    return src[start:src.index("\n}\n", start)]


def test_k3_kernel_writes_each_element_once():
    """No atomics in the tensor-core K3, one store a dbias element from the
    accumulator after the window sweep, nothing past N; its launcher takes
    one block per (query tile, key tile, head)."""
    src = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_bwd_tc.cu")).read()
    body = _kernel_body(src, "bwd_dbias_tc_kernel")
    assert "atomic" not in body
    assert "for (int step = 0; step < B_; ++step)" in body
    assert body.count("dbias_h[(size_t)row * N + col") == 2
    assert "if (col < N)" in body and "if (col + 1 < N)" in body
    assert "dim3 grid(nt, nt, nH);" in src


def test_fma_partner_and_the_statistic_rule(monkeypatch):
    """`_fma` under "split" sends K3 to the FMA entry
    (mmde_window_attention_dbias, lse_pair 1: the FMA forward's hi + lo)
    after the FMA passes without dbias; K3 handed the other body's
    statistic raises before any launch, both ways."""
    import contextlib

    calls = []

    class Lib:
        def __getattr__(self, entry):
            if entry.startswith("__"):
                raise AttributeError(entry)
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(twp, "_library_bwd", lambda: Lib())
    monkeypatch.setattr(twp, "_library_tc", lambda backward: Lib())
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    twp.reset_launch_counts()
    qkv, ls, bias, mask, g, nH = _inputs("bf16", 4, 36, True, seed=4)
    q = torch.from_numpy(qkv).bfloat16()
    lt, b, m = (torch.from_numpy(a) for a in (ls, bias, mask))
    gt = torch.from_numpy(g).bfloat16()
    pair = torch.zeros((2, 4, nH, 36))
    pair.written_by = "FMA"
    twp._launch_backward(q, lt, b, m, pair, gt, nH, "split", True, _fma=True)
    assert [e for e, _ in calls] == ["mmde_window_attention_bwd",
                                     "mmde_window_attention_dbias"]
    assert calls[0][1][-3] == 0                 # the passes: no dbias
    assert calls[1][1][-5:-2] == (1, 0, 1)      # qkv_bf16, bias_bf16, pair
    assert calls[1][1][6] == calls[0][1][7]     # the FMA dq pass's delta
    assert twp.launch_counts() == {"window_attention_bwd": 1,
                                   "window_attention_dbias": 1}
    assert twp.LAUNCHES_BWD_BY_SHAPE == {(4, 36, 128, nH): 1}
    delta = torch.zeros((4, nH, 36))
    with pytest.raises(ValueError, match="log-sum-exp"):
        twp._launch_dbias(q, lt, b, m, pair, gt, delta, nH)
    q32, g32 = q.float(), gt.float()
    with pytest.raises(ValueError, match="FMA forward wrote"):
        twp._launch_dbias(q32, lt, b, m, pair, g32, delta, nH)
    tagged = torch.zeros((2, 4, nH, 36))
    tagged.written_by = "tensor-core"
    with pytest.raises(ValueError, match="tensor-core forward wrote"):
        twp._launch_dbias(q32, lt, b, m, tagged, g32, delta, nH, _fma=True)
    assert len(calls) == 2
    twp.reset_launch_counts()


def _entries(src: str) -> dict:
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{', text,
                                 re.S)}


@pytest.mark.parametrize("entry,module,argtypes,tail", [
    ("mmde_window_attention_dbias_tc", twp, "_DBIAS_ARGTYPES",
     ["int qkv_bf16", "int bias_bf16", "int lse_pair", "int mxu"]),
    ("mmde_window_attention_headsplit_dbias_tc", ths, "_DBIAS_TC_ARGTYPES",
     ["int nW", "int qkv_bf16", "int bias_bf16"]),
])
def test_k3_entries_and_signatures(monkeypatch, entry, module, argtypes,
                                   tail):
    """No compiler here: K3's C entries live in the tensor-core backward
    library (no new library), every ctypes argument type matches its C
    parameter, the packed entry takes the statistic's layout and the mode
    (as the FMA entry does), the head-split one the strides after its four
    operands and no mode; the library binding sets those types."""
    params = _entries("window_attention_bwd_tc.cu")[entry]
    kinds = [twp._P if "*" in p else twp._I for p in params]
    assert kinds == getattr(module, argtypes)
    assert params[-1] == "void* stream"
    assert params[-1 - len(tail):-1] == tail
    if module is ths:
        assert params[4] == "const void* strides"
    assert twp.library_specs()["window_attention_bwd_tc"] == (
        ("window_attention_bwd_tc.cu",), ())

    class Fn:
        argtypes = None

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            return self.fns.setdefault(name, Fn())

    lib = Lib()
    monkeypatch.setattr(cuda_build, "load_library", lambda *a, **k: lib)
    if module is twp:
        bound = twp._library_tc(True)
        assert bound.mmde_window_attention_dbias_tc.argtypes == \
            twp._DBIAS_ARGTYPES
    else:
        fn = ths._entry(entry, ths._DBIAS_TC_ARGTYPES)
        assert fn is lib.fns[entry] and fn.argtypes == ths._DBIAS_TC_ARGTYPES


@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_plain_dbias_is_the_plain_backward_s(mxu):
    """K3's plain version (what the card holds the kernel to and times
    beside it) is the plain backward's dbias, bit for bit, in each mode,
    packed and head-split."""
    qkv, ls, bias, mask, g, nH = _inputs("fp32", 4, 36, True, seed=9)
    t = [None if a is None else torch.from_numpy(a)
         for a in (qkv, ls, bias, mask, g)]
    got = twp.cosine_window_attention_packed_dbias_plain(*t, num_heads=nH,
                                                         mxu=mxu)
    want = twp.cosine_window_attention_packed_backward_plain(
        *t, num_heads=nH, mxu=mxu)[2]
    assert got.dtype == torch.float32 and torch.equal(got, want)
    q, k, v = _heads(qkv, nH)
    gh = t[4].reshape(4, 36, nH, 32).permute(0, 2, 1, 3)
    got = ths.cosine_window_attention_headsplit_dbias_plain(
        q, k, v, t[1], t[2], t[3], gh, mxu=mxu)
    assert torch.equal(got, ths.cosine_window_attention_headsplit_backward_plain(
        q, k, v, t[1], t[2], t[3], gh, mxu=mxu)[4])
