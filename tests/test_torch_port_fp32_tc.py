"""PyTorch port vs JAX package: K4 and K5 for fp32 qkv on the tensor cores,
and the packed FMA body's two-number log-sum-exp (F3).

fp32 qkv now runs the single-pass backward K4 (MMDE_ATTN_GRID=
bias_resident) and the W-windows-per-block kernels K5 (MMDE_ATTN_W, W > 1)
on bf16 mma.sync, every fp32 operand split into three bf16 pieces (x1 =
bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2)) and each product taken
as the six piece products whose indices sum to at most 2
(csrc/window_attention_tc.cuh). Those kernels run only on the card
(chip_smoke.py's kernel_cases_resident / kernel_cases_w hold them to the
plain versions and float64 autograd). Here, on the CPU:

  * their arithmetic, emulated in plain torch (mmde_tpu_torch/testing.py,
    `pieces=3`), on unrounded fp32 inputs drawn with numpy, is held to the
    JAX op in interpret mode (grid_mode="bias_resident"; windows_per_cell
    = W in each precision mode) and to float64 autograd at heads of scale
    60 and 100; the two-piece split misses the fp32 limits, so the check
    can fail a wrong split;
  * the wrapper's routing (fp32 K4 and K5 to the tensor-core entries, fp32
    at W = 1 to the FMA body) and the statistic's layout, read off with the
    libraries replaced by recorders and a tensor that says it is on the
    card;
  * the new entries' ctypes signatures, read from the sources;
  * F3: one rounding of a row's lse at scale 60 misses float64's
    dlogit_scale, the (hi, lo) pair the packed FMA body now writes meets it.

The JAX packed op takes whole 128-lane head groups, so the smallest case
has nH = 4 heads of 32 (C = 128).
"""
import contextlib
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops import window_attention_packed as jwap
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.testing import (bf16_pieces, tc_backward,
                                    tc_backward_resident, tc_forward)
from mmde_tpu_torch.tools import split_errors

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

LN100 = math.log(100.0)
_NAMES = ("out", "dqkv", "dlogit_scale", "dbias")
# the card's fp32 limits (chip_smoke.py: TOL_FP32_MAX_ABS, TOL_BWD)
FP32_LIMITS = split_errors.LIMITS


def _inputs(B, N, nW, seed, scales=None):
    """nH = 4, unrounded fp32 qkv and g: by default head 0 clamped at scale
    100, head 1 hot (scale 60), heads 2-3 cool; `scales` sets every head's
    scale; 16*sigmoid bias; 0/-100 mask (diagonal kept) over nW windows,
    or None for nW = 0."""
    rng = np.random.default_rng(seed)
    nH, C = 4, 128
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    if scales is None:
        ls = np.array([LN100 + 0.5, math.log(60.0), 1.5, 2.5], np.float32)
    else:
        ls = np.log(np.asarray(scales, np.float32))
    ls = ls.reshape(nH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if nW:
        m = (rng.random((nW, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, ls, bias, mask, g, nH


def _jax_run(qkv, ls, bias, mask, g, nH, **kw):
    """The JAX op's output and (dqkv, dlogit_scale, dbias) in interpret mode
    (fp32 qkv, `kw` passed through), the row-maximum softmax for every head
    (SOFTMAX_MAXFREE off for the call: ROADMAP F1)."""
    N, C = qkv.shape[1], qkv.shape[2] // 3
    _, Np, _, HG, nG, _ = jwap.attention_plan(N, nH, 32, C)
    m = None if mask is None else jnp.asarray(mask)

    def f(q, l, b_hnn):
        bp = jwap.pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return jwap.cosine_window_attention_packed(
            q, l, bp, m, num_heads=nH, interpret=True, **kw)

    maxfree = jwap.SOFTMAX_MAXFREE
    jwap.SOFTMAX_MAXFREE = False
    try:
        out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(ls),
                           jnp.asarray(bias))
        return [np.asarray(out)] + [np.asarray(x)
                                    for x in vjp(jnp.asarray(g))]
    finally:
        jwap.SOFTMAX_MAXFREE = maxfree


def _held(emu, ref, bound, bound_dls, what):
    """Each result within `bound` of the reference: max abs relative to the
    reference's largest value, and rel-L2 (dlogit_scale: `bound_dls`)."""
    for name, a, b in zip(_NAMES, emu, ref):
        a = np.asarray(a).reshape(b.shape)
        lim = bound_dls if name == "dlogit_scale" else bound
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert err <= lim[0], (name, what, err)
        assert rel_l2 <= lim[1], (name, what, rel_l2)
        assert float(np.abs(b).max()) > 1e-3, name


def _float64(qkv, ls, bias, mask, g, nH):
    """out, dqkv, dlogit_scale, dbias of float64 autograd of the plain
    forward."""
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (qkv, ls, bias)]
    out = twp.cosine_window_attention_packed_plain(
        *leaves, None if mask is None else torch.from_numpy(mask).double(),
        num_heads=nH, compute_dtype=torch.float64)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).double())
    return [out.detach()] + [x.detach() for x in grads]


def _errors(got, want) -> dict:
    """forward max abs; dqkv / dbias rel-L2; dlogit_scale max abs over its
    largest entry (split_errors.errors: the card's measures)."""
    return split_errors.errors([torch.as_tensor(np.asarray(t)) for t in got],
                               want)


# ------------------------------------------------------------- the split

def test_three_pieces_hold_every_bit_of_fp32():
    """x1 + x2 + x3 is x exactly for fp32 x over a wide range of
    magnitudes, each piece a bf16 value; two pieces leave ~2^-17 of x."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    p = bf16_pieces(x, 3)
    for piece in p:
        assert torch.equal(piece, piece.bfloat16().float())
    assert torch.equal((p[2] + p[1]) + p[0], x)
    two = bf16_pieces(x, 2)
    rel = ((two[0] + two[1]) - x).abs() / x.abs()
    assert float(rel.max()) <= 2.0 ** -16
    assert float(rel.max()) > 2.0 ** -24


# ------------------------------------------------------- K4's arithmetic

@pytest.mark.parametrize("nW", [0, 2])
def test_fp32_resident_emulation_matches_jax_k4(nW):
    """The fp32 tensor-core K4's arithmetic (three pieces, 2 chunks of 2
    windows; the forward before it the plain fp32 function, which K1 is
    held to)
    against the JAX op under grid_mode="bias_resident" in
    interpret mode on the same unrounded fp32 inputs, N = 49: output and
    the three gradients within 1e-5 (max abs relative to the JAX result's
    largest value, and rel-L2), dlogit_scale within 5e-5 (its cancelling
    sum) - the bounds the bf16-valued emulation is held to."""
    x = _inputs(4, 49, nW, seed=70 + nW)
    jax_res = _jax_run(*x, grid_mode="bias_resident")
    qkv, ls, bias, mask = (None if a is None else torch.from_numpy(a)
                           for a in x[:4])
    # the forward before K4: the plain fp32 function
    out = twp.cosine_window_attention_packed_plain(qkv, ls, bias, mask,
                                                   num_heads=x[5],
                                                   maxfree=False)
    emu = [out.numpy()] + [
        t.numpy() for t in tc_backward_resident(*x, splits=2, pieces=3)]
    _held(emu, jax_res, (1e-5, 1e-5), (5e-5, 5e-5), f"fp32 K4 nW={nW}")


@pytest.mark.parametrize("scale", [60.0, 100.0])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_fp32_emulation_holds_the_fp32_limits_against_float64(kernel,
                                                              scale):
    """Every head at scale 60 (or just inside the ln 100 clamp), N = 64,
    masked: the three-piece arithmetic of K4 (one chunk a window) and of K5
    at W = 3 (mode fp32) lies within the card's fp32 limits of float64
    autograd - forward max abs 5e-5, dqkv and dbias rel-L2 2e-5,
    dlogit_scale 2e-4 of its largest entry."""
    x = split_errors.inputs(64, scale, seed=3)
    e = _errors(split_errors.emulate("bf16x3", x,
                                     None if kernel == "K4" else 3),
                split_errors.exact(*x))
    for k, lim in FP32_LIMITS.items():
        assert e[k] <= lim, (kernel, scale, k, e)


def test_two_pieces_miss_the_fp32_limits():
    """The two-piece split (three products, ~2^-17 of an operand left
    over) misses the forward limit at scale 60 / 100 and lies at least 4x
    farther from float64 than the three-piece split on every quantity, K4
    and K5 alike: the emulation can fail a wrong split."""
    res = split_errors.measure(n=64, seed=0)
    three, two = res["bf16x3"], res["bf16x2"]
    assert two["out"] > FP32_LIMITS["out"], two
    assert two["dqkv"] > FP32_LIMITS["dqkv"], two
    for k in FP32_LIMITS:
        assert three[k] <= FP32_LIMITS[k], (k, three)
        assert two[k] >= 4.0 * three[k], (k, three, two)


# ------------------------------------------------------- K5's arithmetic

_W_CASES = {}


def _w_case(nW, mxu, w=3):
    key = (nW, mxu, w)
    if key not in _W_CASES:
        x = _inputs(6 if w == 3 else 4, 49, nW, seed=80 + nW + w)
        emu = [tc_forward(*x[:4], x[5], mxu, maxfree=False, pieces=3)] + \
            tc_backward(*x, mxu, windows=w, pieces=3)
        _W_CASES[key] = (_jax_run(*x, mxu=mxu, windows_per_cell=w),
                         [t.numpy() for t in emu])
    return _W_CASES[key]


@pytest.mark.parametrize("nW", [0, 3])
@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_fp32_w_emulation_matches_jax_three_windows_per_cell(mxu, nW):
    """fp32 K5 at W = 3 (three pieces in fp32 / fold, one rounding in
    "bf16") against the JAX op with windows_per_cell=3 in interpret mode on
    unrounded fp32 inputs, B_ = 6, N = 49, 3 masks or none: fp32 / fold
    within 1e-5 (dlogit_scale 5e-5), "bf16" within max abs 5e-4 and rel-L2
    5e-5 (isolated bf16 rounding flips of a rounded operand) -
    test_torch_port_resident_tc.py's bounds."""
    jax_res, emu = _w_case(nW, mxu)
    if mxu == "bf16":
        _held(emu, jax_res, (5e-4, 5e-5), (5e-4, 5e-5), f"K5 {mxu} {nW}")
    else:
        _held(emu, jax_res, (1e-5, 1e-5), (5e-5, 5e-5), f"K5 {mxu} {nW}")


def test_fp32_w_emulation_at_two_windows_per_cell():
    """The same at W = 2, masked over 2 windows, mode fp32."""
    x = _inputs(4, 36, 2, seed=91)
    jax_res = _jax_run(*x, mxu="fp32", windows_per_cell=2)
    emu = [tc_forward(*x[:4], x[5], "fp32", maxfree=False, pieces=3)] + \
        tc_backward(*x, "fp32", windows=2, pieces=3)
    _held([t.numpy() for t in emu], jax_res, (1e-5, 1e-5), (5e-5, 5e-5),
          "K5 fp32 W=2")


def test_fp32_w_emulation_at_eight_masked_windows_per_cell():
    """fp32 K5 at W = 8 with a mask over 8 windows (MMDE_ATTN_W=8 on a
    shifted stage), mode fp32: the card's dk/dv pass holds 4 of the 8
    windows a block there (8 windows' state does not fit beside the fp32
    staging: `dkv_windows`), so the emulation sums dbias in groups of 4;
    held to the JAX op with windows_per_cell=8 within K5's W = 3 bounds."""
    x = _inputs(8, 16, 8, seed=93)
    jax_res = _jax_run(*x, mxu="fp32", windows_per_cell=8)
    emu = [tc_forward(*x[:4], x[5], "fp32", maxfree=False, pieces=3)] + \
        tc_backward(*x, "fp32", windows=4, pieces=3)
    _held([t.numpy() for t in emu], jax_res, (1e-5, 1e-5), (5e-5, 5e-5),
          "K5 fp32 W=8 masked")


def test_fp32_eight_masked_windows_go_to_the_tensor_core_entry(recorded):
    """fp32 at W = 8 with 8 masks: the tensor-core K5 entry gets W = 8 (it
    blocks its dk/dv pass itself) and dls_part a zeroed row per window and
    64-row tile, the most any blocking writes."""
    qkv, ls, bias, mask, g, nH = _inputs(8, 16, 8, seed=5)
    zeros = []
    real_zeros = torch.zeros

    def spy(*a, **k):
        t = real_zeros(*a, **k)
        zeros.append(t)
        return t
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "zeros", spy)
        twp._launch_backward(
            torch.from_numpy(qkv), torch.from_numpy(ls),
            torch.from_numpy(bias), torch.from_numpy(mask),
            torch.zeros((2, 8, nH, 16)), torch.from_numpy(g), nH,
            "window_resident", True, w=8)
    (entry, args), = recorded
    assert entry == "mmde_window_attention_bwd_tc_w"
    assert args[-7:-1] == (8, 0, 0, 1, 8, twp._MXU_CODE["fp32"]), args
    dls = [t for t in zeros if t.dtype == torch.float64]
    assert len(dls) == 1 and tuple(dls[0].shape) == (8 * 1, nH)
    assert args[8] == dls[0].data_ptr()


@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_fp32_w_modes_are_apart(mxu):
    """Each mode of the fp32 K5 arithmetic lies at least 4x nearer the JAX
    result of its own mode than the other one's (fp32 / fold against
    "bf16", "bf16" against "fold"), output and every gradient: MXU_APART's
    rule on the card."""
    own, emu = _w_case(3, mxu)
    other = _w_case(3, "fold" if mxu == "bf16" else "bf16")[0]
    for name, a, o, r in zip(_NAMES, emu, own, other):
        a = a.reshape(o.shape)
        to_own = float(np.linalg.norm(a - o) / np.linalg.norm(o))
        to_other = float(np.linalg.norm(a - r) / np.linalg.norm(r))
        assert to_other >= 4.0 * to_own, (name, mxu, to_own, to_other)


# --------------------------------------------------------------- routing

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrapper's CUDA branch
    runs, into the recorders below."""

    @property
    def is_cuda(self):
        return True


class _Recorder:
    """Stands in for a ctypes library: every entry point records its name
    and arguments and returns 0 (success)."""

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)

        def fn(*args):
            self._calls.append((entry, args))
            return 0
        return fn


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    lib = _Recorder(calls)
    monkeypatch.setattr(twp, "_library", lambda mxu="fp32": lib)
    monkeypatch.setattr(twp, "_library_bwd", lambda: lib)
    monkeypatch.setattr(twp, "_library_resident", lambda tc=False: lib)
    monkeypatch.setattr(twp, "_library_tc", lambda backward: lib)
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    twp.reset_launch_counts()
    yield calls
    twp.reset_launch_counts()


def _drive(dtype, grid, wpc, train=True, mxu=None):
    """8 windows, 4 masks, N = 36: the rule's W is 4 (K5 at W = 4)."""
    qkv, ls, bias, mask, g, nH = _inputs(8, 36, 4, seed=1)
    q = torch.from_numpy(qkv).to(dtype).as_subclass(_OnCard)
    b = torch.from_numpy(bias).to(dtype)
    m = torch.from_numpy(mask).to(dtype)
    lt = torch.from_numpy(ls)
    kw = dict(num_heads=nH, grid_mode=grid, windows_per_cell=wpc, mxu=mxu)
    if not train:
        with torch.no_grad():
            twp.cosine_window_attention_packed(q, lt, b, m, **kw)
        return
    q.requires_grad_()
    b.requires_grad_()
    out = twp.cosine_window_attention_packed(q, lt, b, m, **kw)
    out.backward(torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("case", [
    # (grid, W setting, mode, train) -> entries, counted kernels
    ("bias_resident", "1", None, True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_resident_tc"],
     {"window_attention_fwd_tc", "window_attention_bwd_resident_tc"}),
    ("bias_resident", "auto", None, True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_resident_tc"],
     {"window_attention_fwd_tc", "window_attention_bwd_resident_tc"}),
    ("window_resident", "auto", None, True,
     ["mmde_window_attention_fwd_tc_w", "mmde_window_attention_bwd_tc_w"],
     {"window_attention_fwd_tc_w4+lse", "window_attention_bwd_tc_w4"}),
    ("window_resident", "auto", "bf16", True,
     ["mmde_window_attention_fwd_tc_w", "mmde_window_attention_bwd_tc_w"],
     {"window_attention_fwd_tc_w4+lse", "window_attention_bwd_tc_w4"}),
    ("split", "auto", "fold", True,
     ["mmde_window_attention_fwd_tc_w", "mmde_window_attention_bwd_tc_w",
      "mmde_window_attention_dbias_tc"],
     {"window_attention_fwd_tc_w4+lse", "window_attention_bwd_tc_w4",
      "window_attention_dbias_tc"}),
    ("window_resident", "auto", None, False,
     ["mmde_window_attention_fwd_tc_w"], {"window_attention_fwd_tc_w4"}),
    ("window_resident", "1", None, True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_tc"],
     {"window_attention_fwd_tc+lse", "window_attention_bwd_tc"}),
    ("split", "1", None, True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_tc",
      "mmde_window_attention_dbias_tc"],
     {"window_attention_fwd_tc+lse", "window_attention_bwd_tc",
      "window_attention_dbias_tc"}),
    ("window_resident", "1", "bf16", False,
     ["mmde_window_attention_fwd_tc"], {"window_attention_fwd_tc"}),
])
def test_fp32_routes_k4_and_k5_to_the_tensor_cores(recorded, case):
    """fp32 qkv: K4 (after K1's tensor-core forward without lse), K5 at the
    rule's W and K1 / K2 at W = 1 on the tensor-core entries, each told the
    operand type (qkv_bf16 0) just before bias_bf16. Every statistic is (2,
    B_, nH, N), hi then lo (F3); the tensor-core K3 behind the tensor-core
    K2 / K5 ("split") is told so (lse_pair 1)."""
    grid, wpc, mxu, train, want, counted = case
    _drive(torch.float32, grid, wpc, train, mxu)
    assert [e for e, _ in recorded] == want, case
    assert set(twp.launch_counts()) == counted, twp.launch_counts()
    code = twp._MXU_CODE[twp.resolve_mxu(mxu, torch.float32)]
    for entry, args in recorded:
        if entry == "mmde_window_attention_fwd_tc_w":
            # ..., nW, qkv_bf16, bias_bf16, maxfree, W, mxu, stream
            assert args[-7:-1] == (4, 0, 0, args[-4], 4, code), args
            assert (args[5] is not None) == train
        if entry == "mmde_window_attention_bwd_tc_w":
            # ..., nW, qkv_bf16, bias_bf16, dbias_mode, W, mxu, stream
            assert args[-7:-4] == (4, 0, 0), args
            assert args[-3:-1] == (4, code)
        if entry == "mmde_window_attention_fwd_tc":
            # ..., nW, qkv_bf16, bias_bf16, maxfree, mxu, stream
            assert args[-6:-4] == (4, 0) and args[-4] == 0, args
            assert args[-2] == code, args
            assert (args[5] is not None) == (train and grid != "bias_resident")
        if entry == "mmde_window_attention_bwd_tc":
            # ..., nW, qkv_bf16, bias_bf16, dbias_mode, mxu, stream
            assert args[-6:-2] == (4, 0, 0, int(grid == "window_resident"))
            assert args[-2] == code, args
        if entry == "mmde_window_attention_bwd_resident_tc":
            # ..., nW, qkv_bf16, bias_bf16, splits, stream
            assert args[-5:-1] == (4, 0, 0,
                                   twp.resident_splits(36, 4, 8, True))
        if entry == "mmde_window_attention_dbias_tc":
            # ..., qkv_bf16, bias_bf16, lse_pair, mxu, stream
            assert args[-5:-1] == (0, 0, 1, code), args


def test_the_statistic_is_hi_and_lo_for_fp32_and_one_number_for_bf16(
        recorded):
    """The forward's statistic: (2, B_, nH, N) for fp32 qkv on every body
    (K1 and K5 on the tensor cores, their FMA bodies) and for the FMA body
    of any type; (B_, nH, N) for bf16 on the tensor cores (`stat_pair`)."""
    qkv, ls, bias, mask, g, nH = _inputs(8, 36, 4, seed=2)
    lt, m = torch.from_numpy(ls), torch.from_numpy(mask)
    for dtype, w, fma, pair in ((torch.float32, 1, False, True),
                                (torch.float32, 1, True, True),
                                (torch.float32, 4, False, True),
                                (torch.float32, 4, True, True),
                                (torch.bfloat16, 4, True, True),
                                (torch.bfloat16, 4, False, False),
                                (torch.bfloat16, 1, False, False)):
        q = torch.from_numpy(qkv).to(dtype)
        b = torch.from_numpy(bias).to(dtype)
        _, lse = twp._launch_forward(q, lt, b, m.to(dtype), nH, True, True,
                                     w=w, _fma=fma)
        tc = twp.tensor_core_body(dtype, w) and not fma
        assert twp.stat_pair(dtype, tc) == pair
        assert tuple(lse.shape) == ((2,) if pair else ()) + (8, nH, 36)


@pytest.mark.parametrize("dtype,w,fma", [
    (torch.float32, 1, False), (torch.float32, 4, False),
    (torch.bfloat16, 4, False), (torch.bfloat16, 1, True)])
def test_a_backward_handed_the_other_bodys_statistic_raises(recorded, dtype,
                                                            w, fma):
    """The backward reads the statistic of its own body's forward; the other
    shape (one number where hi + lo is due, or the pair where one is) raises
    before any launch."""
    qkv, ls, bias, mask, g, nH = _inputs(8, 36, 4, seed=3)
    q = torch.from_numpy(qkv).to(dtype)
    b = torch.from_numpy(bias).to(dtype)
    gt = torch.from_numpy(g).to(dtype)
    pair = twp.stat_pair(dtype, twp.tensor_core_body(dtype, w) and not fma)
    wrong = torch.zeros(((8, nH, 36) if pair else (2, 8, nH, 36)))
    with pytest.raises(ValueError, match="log-sum-exp"):
        twp._launch_backward(q, torch.from_numpy(ls), b, None, wrong, gt, nH,
                             "window_resident", True, w=w, _fma=fma)
    assert recorded == []


def test_the_autograd_function_hands_its_forwards_statistic_on(recorded):
    """Through the autograd Function an fp32 packed step (K5 at W 4) saves
    the forward's (hi, lo) pair and hands that buffer to the backward."""
    qkv, ls, bias, mask, g, nH = _inputs(8, 36, 4, seed=4)
    q = torch.from_numpy(qkv).as_subclass(_OnCard).requires_grad_()
    out = twp.cosine_window_attention_packed(
        q, torch.from_numpy(ls), torch.from_numpy(bias),
        torch.from_numpy(mask), num_heads=nH, windows_per_cell=4)
    out.backward(torch.from_numpy(g))
    fwd = [a for e, a in recorded if e == "mmde_window_attention_fwd_tc_w"]
    bwd = [a for e, a in recorded if e == "mmde_window_attention_bwd_tc_w"]
    assert len(fwd) == 1 and len(bwd) == 1
    assert fwd[0][5] == bwd[0][4]          # the same lse buffer


@pytest.mark.parametrize("variant", ["nano", "tiny", "base", "large",
                                     "huge"])
def test_the_w_rule_gives_a_blocks_forward_and_backward_w_together(variant):
    """Under MMDE_ATTN_W=auto the JAX rule gives W > 1 to a block's forward
    exactly where it gives it to its backward, at every packed stage of
    the swin variants over a range of resolutions, window sizes, batches
    and both mask kinds: an fp32 K5 backward (tensor cores) always follows
    an fp32 K5 forward, so it rebuilds p against the statistic of the same
    tensor-core arithmetic (whose sums round toward zero, a few fp32 ulps
    from the FMA body's)."""
    from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS
    embed, heads = SWIN_VARIANTS[variant]
    seen = 0
    for h, w in ((480, 640), (352, 1216), (256, 256), (384, 512)):
        for ws0 in (30, 24, 12, 8, 7):
            for i in range(4):
                C, nH = embed * 2 ** i, heads[i]
                ws = ws0 if i < 3 else max(ws0 // 2, 1)
                N = ws * ws
                if not twp.packed_layout_ok(N, nH, C // nH, C):
                    continue
                mh, mw = (h // 4) >> i, (w // 4) >> i
                nw = -(-mh // ws) * -(-mw // ws)
                for pairs in (1, 2, 4):
                    for nW in (0, nw):
                        B_ = 2 * pairs * nw
                        wf, wb = (twp.windows_per_block(B_, N, C, nH, nW, bwd,
                                                        "auto")
                                  for bwd in (False, True))
                        assert (wf > 1) == (wb > 1), (variant, h, w, ws, i,
                                                      pairs, nW, wf, wb)
                        seen += 1
    assert seen > 0 or variant == "nano"


# ------------------------------------------------- sources and signatures

def _entries(src: str) -> dict:
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{', text,
                                 re.S)}


@pytest.mark.parametrize("src,entry,argtypes,tail", [
    ("window_attention_bwd_resident_tc.cu",
     "mmde_window_attention_bwd_resident_tc", "_RESIDENT_TC_ARGTYPES",
     ["int nW", "int qkv_bf16", "int bias_bf16", "int splits"]),
    ("window_attention_fwd_tc.cu", "mmde_window_attention_fwd_tc_w",
     "_FWD_TC_W_ARGTYPES",
     ["int nW", "int qkv_bf16", "int bias_bf16", "int maxfree", "int W",
      "int mxu"]),
    ("window_attention_bwd_tc.cu", "mmde_window_attention_bwd_tc_w",
     "_BWD_TC_W_ARGTYPES",
     ["int nW", "int qkv_bf16", "int bias_bf16", "int dbias_mode", "int W",
      "int mxu"]),
    ("window_attention_bwd.cu", "mmde_window_attention_dbias",
     "_DBIAS_ARGTYPES",
     ["int qkv_bf16", "int bias_bf16", "int lse_pair", "int mxu"]),
])
def test_entries_take_the_operand_type(src, entry, argtypes, tail):
    """No compiler here: each changed C entry's parameters against its
    ctypes argument types (pointer -> c_void_p, int -> c_int), the operand
    type (K4, K5) and the statistic's layout (K3) among them, the stream
    last."""
    params = _entries(src)[entry]
    kinds = [twp._P if "*" in p else twp._I for p in params]
    assert kinds == getattr(twp, argtypes), entry
    assert params[-1] == "void* stream"
    assert params[-1 - len(tail):-1] == tail, params


def test_sources_split_fp32_operands_in_three():
    """The kernels instantiate a float operand type beside bf16, stage fp32
    tiles into three bf16 planes and take the six piece products; the fp32
    K5 forward writes hi + lo in fp64; nothing is a library call."""
    tc = open(os.path.join(cuda_build.CSRC_DIR,
                           "window_attention_tc.cuh")).read()
    assert "constexpr int terms_count(int PA, int PB)" in tc
    assert "load_tile_f32" in tc and "put_row" in tc
    fwd = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_fwd_tc.cu")).read()
    bwd = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_bwd_tc.cu")).read()
    res = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_bwd_resident_tc.cu")).read()
    assert "launch_packed_w<float, float, MXU>" in fwd
    assert "launch_packed_w<float, float, MXU>" in bwd
    assert "launch<float, float>" in res
    assert "log((double)l0)" in fwd
    for text in (fwd, bwd, res):
        assert "F32 ? 3 : 1" in text or "F32 && !RB ? 3 : 1" in text
        for lib in ("cublas", "cudnn", "torch/extension.h", "cutlass"):
            assert lib not in text.lower()


def test_piece_product_order_matches_the_emulation():
    """The kernels' product terms (term_ij in window_attention_tc.cuh, read
    as Python) are the emulation's: i + j <= max(PA, PB) - 1, six for three
    pieces, the smallest first; bf16's (2, 1) keeps hi, then lo."""
    def terms(pa, pb):
        top = max(pa, pb) - 1
        if pa == 3:
            return [(i, j) for s in range(top, -1, -1) for i in range(pa)
                    for j in range(pb) if i + j == s]
        return [(i, j) for i in range(pa) for j in range(pb)
                if i + j <= top]
    assert terms(3, 3) == [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
    assert terms(2, 1) == [(0, 0), (1, 0)]
    assert terms(1, 1) == [(0, 0)]
    tc = open(os.path.join(cuda_build.CSRC_DIR,
                           "window_attention_tc.cuh")).read()
    assert "for (int sum = (PA == 3 ? top : 0)" in tc


# ------------------------------------------------------------ F3, packed

def _packed_dls(qkv, ls, bias, g, nH, stat: str):
    """dlogit_scale as K2's FMA body forms it in fp32 (p rebuilt from the
    forward's statistic, ds = p (dp - delta), the sum of ds * sc in fp64):
    `stat` "pair" rebuilds p = exp((s - hi) - lo) from the fp64-formed
    (hi, lo) the packed FMA body now writes; "one" p = exp(s - lse) from
    lse = m + log(l) in fp32, one number, as it wrote before."""
    q, k, v = twp._split_heads(torch.from_numpy(qkv), 3, nH)
    gh = twp._split_heads(torch.from_numpy(g), 1, nH)[0]
    qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    scale = torch.from_numpy(ls).reshape(nH, 1, 1).exp()
    sc = (qn @ kn.transpose(-1, -2)) * scale
    s = sc + torch.from_numpy(bias)[None]
    if stat == "pair":
        p = ths.rebuild_probabilities(s, *ths.lse_pair(s))
    else:
        m = s.amax(-1)
        one = m + torch.log(torch.exp(s - m[..., None]).sum(-1))
        p = ths.rebuild_probabilities(s, one)
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (ds.double() * sc.double()).sum((0, 2, 3))


def test_f3_one_number_misses_the_packed_dlogit_scale_that_the_pair_meets():
    """Every head at scale 60, N = 64, 4 windows, 3 draws: dlogit_scale
    from the (hi, lo) pair lies within the card's F3 limit (2e-5 rel-L2,
    chip_smoke.py TOL_F3) of float64 autograd in every draw; from one fp32
    number (one rounding of lse ~ 60 scaling a whole row) it misses that
    limit in every draw and lies at least 4x farther."""
    for seed in range(3):
        qkv, ls, bias, _, g, nH = _inputs(4, 64, 0, seed=seed,
                                          scales=[60.0] * 4)
        want = _float64(qkv, ls, bias, None, g, nH)[2].flatten()
        err = {stat: float((_packed_dls(qkv, ls, bias, g, nH, stat) - want)
                           .norm() / want.norm())
               for stat in ("pair", "one")}
        assert err["pair"] <= 2e-5, (seed, err)
        assert err["one"] > 2e-5, (seed, err)
        assert err["one"] >= 4.0 * err["pair"], (seed, err)


def test_f3_packed_sources_write_and_read_the_pair():
    """The packed FMA forwards (K1, K5) write hi and lo formed in fp64 into
    the (2, B_, nH, N) buffer; the packed backwards (K2, K5's passes, K3)
    read lo: no packed kernel is instantiated without it but K3 behind the
    bf16 tensor-core passes (lse_pair 0)."""
    fwd = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_fwd.cu")).read()
    bwd = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_bwd.cu")).read()
    assert "lse_lo[i] = (float)(x - (double)(float)x);" in fwd   # K5
    assert "(float*)lse + (size_t)B_ * nH * N : nullptr" in fwd
    assert "exp_<FASTEXP>((v - lse) - lo)" in bwd                # K5
    assert "bwd_dbias_kernel<Rows, T, TB, FASTEXP, MXU, true>" in bwd
    assert bwd.count("MXU, false>") == 1                         # K3, bf16
    assert "if (lse_pair)" in bwd


def test_compare_ptx_sets_aside_names_and_register_numbers(monkeypatch):
    """tools/compare_ptx (which backs PERF.md's claim that the bf16
    tensor-core kernels compile to the same instructions as before their
    fp32 instantiations): two kernels that differ only in the per-file
    hash of their names, label numbers and virtual register numbers are
    the same; another instruction is not; a kernel this tree templates
    over the operand type is matched by the other tree's name."""
    from mmde_tpu_torch.tools import compare_ptx
    monkeypatch.setattr(compare_ptx, "_demangle", lambda names: names)

    def ptx(tag, extra=""):
        return (f".entry _ZN_GLOBAL__N__{tag}_kern(\n"
                f"\t.shared .b8 _ZZN59_GLOBAL__N__{tag}_sA[16];\n"
                f"\tmov.u32 %r{len(tag)}, 1;\n{extra}"
                f"$L__BB{len(tag)}_2:\n\tret;\n}}\n")
    a = compare_ptx._entries(ptx("ab12"))
    b = compare_ptx._entries(ptx("9f3c0d"))
    c = compare_ptx._entries(ptx("ab12", "\tadd.s32 %r1, %r1, 32;\n"))
    assert list(a.values()) == list(b.values())
    assert list(a.values()) != list(c.values())
    assert compare_ptx._typed_as_other(
        "bwd_resident_tc_kernel<__nv_bfloat16, float>") == \
        "bwd_resident_tc_kernel<float>"
    assert compare_ptx._typed_as_other(
        "fwd_tc_kernel<Rows, __nv_bfloat16, 0>") == \
        "fwd_tc_kernel<Rows, __nv_bfloat16, 0>"
