"""PyTorch port vs JAX package: K6' / K7' (head-split) for fp32 q, k, v on
the tensor cores, and the F3 repairs of fp32 K4 / K5.

Every fp32 head-split launch - swin_large stage 1, swin_tiny / swin_huge
stages 1-2 in the JAX package's default type - now runs the packed fp32
instantiation of csrc/window_attention_{fwd,bwd}_tc.cu (`fwd_tc_kernel`,
`bwd_dq_tc_kernel`, `bwd_dkv_tc_kernel` on float `Rows`) through the
head-split entries, over the strides of the model's permuted views: every
operand in three bf16 pieces, the statistic hi + lo formed in fp64 (F3),
the TPU kernel's function (mode "fp32", the running row maximum for every
head, fp32 bias and mask). Those kernels run only on the card
(chip_smoke.py's kernel_cases_headsplit holds them to the plain versions,
float64 autograd and the scale-60 F3 case). Here, on the CPU:

  * their arithmetic, emulated in plain torch (mmde_tpu_torch/testing.py,
    `pieces=3`, mode "fp32", the running maximum), on unrounded fp32 inputs
    drawn with numpy and passed as permuted views of one qkv tensor, is
    held to the JAX package's `cosine_window_attention_pallas` (K6 / K7) in
    interpret mode, masked and unmasked, at N 36 and 100 (a ragged 64-row
    tile);
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card: fp32 to the
    tensor-core entries with qkv_bf16 0, the views' strides read in place,
    a (2, B_, nH, N) statistic tagged with its body; `_fma` and the
    autograd Function's private `fma` to the FMA entries; a backward handed
    the other body's statistic refuses it before any launch; fp32 slab maps
    on the tensor-core slab entries too (their own file:
    test_torch_port_fp32_slab_tc.py);
  * the fp32 branches of K4 and K5 in the sources: exp(s - m) with the
    difference first, dlogit_scale as sum(ds * (sc - lse)).
"""
import contextlib
import ctypes
import math
import os
import re

import numpy as np
import pytest
import torch

from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.ops import window_attention_slab as tslab
from mmde_tpu_torch.testing import tc_backward_heads, tc_forward_heads

from test_torch_port_headsplit_tc import (C, NH, _jax_run, _OnCard,
                                          _Recorder, _views)

_NAMES = ("out", "dq", "dk", "dv", "dlogit_scale", "dbias")


def _inputs(B, N, masked, seed):
    """Unrounded fp32 qkv (B, N, 3C); heads: 0 above the ln 100 clamp, 1
    hot (scale 60), 2 cool (scale e^2); 16*sigmoid bias and a 0/-100 mask
    over 2 windows (diagonal kept), both fp32; g (B, nH, N, 32)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    ls = np.array([math.log(100.0) + 0.5, math.log(60.0), 2.0],
                  np.float32).reshape(NH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((NH, N, N))))
            ).astype(np.float32)
    mask = None
    if masked:
        m = (rng.random((2, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, NH, N, 32)).astype(np.float32)
    return qkv, ls, bias, mask, g


_CASES = {}


def _case(N, masked):
    """(JAX results, three-piece emulation results) at one (N, mask): 4
    windows at N 36, 2 at N 100; computed once per process."""
    key = (N, masked)
    if key not in _CASES:
        x = _inputs(4 if N < 64 else 2, N, masked, seed=300 + N + masked)
        qkv, ls, bias, mask, g = x
        q, k, v = _views(torch.from_numpy(qkv))
        lt, bt, gt = (torch.from_numpy(a) for a in (ls, bias, g))
        mt = None if mask is None else torch.from_numpy(mask)
        emu = [tc_forward_heads(q, k, v, lt, bt, mt, "fp32", maxfree=False,
                                pieces=3)]
        emu += tc_backward_heads(q, k, v, lt, bt, mt, gt, "fp32", pieces=3)
        _CASES[key] = (_jax_run(*x), [t.numpy() for t in emu])
    return _CASES[key]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [36, 100])
def test_fp32_headsplit_emulation_matches_jax(N, masked):
    """The fp32 tensor-core arithmetic on head-split views (three bf16
    pieces an operand, mode "fp32", the running maximum) keeps K6 / K7's
    function on unrounded fp32 inputs: the output and every gradient within
    1e-5 of the JAX kernels' (max abs relative to the JAX result's largest
    value, and rel-L2), dlogit_scale within 5e-5 - the fp32 packed cases'
    bounds (test_torch_port_fp32_w1_tc.py). The clamped head's dlogit_scale
    is exactly zero on both sides."""
    jax_res, emu = _case(N, masked)
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


def test_fp32_headsplit_emulation_is_apart_from_the_bf16_mode():
    """The check chip_smoke.py puts on the fp32 kernels (MXU_APART): the
    three-piece arithmetic lies at least 4x nearer the JAX kernels' result
    than the port's "bf16"-mode plain version does, output and every
    gradient - a body that rounded its operands once would not."""
    jax_res, emu = _case(100, True)
    # the inputs _case(100, True) drew
    qkv, ls, bias, mask, g = _inputs(2, 100, True, seed=401)
    q, k, v = _views(torch.from_numpy(qkv))
    lt, bt, mt, gt = (torch.from_numpy(a) for a in (ls, bias, mask, g))
    rnd = [ths.cosine_window_attention_headsplit_plain(
        q, k, v, lt, bt, mt, mxu="bf16")]
    rnd += list(ths.cosine_window_attention_headsplit_backward_plain(
        q, k, v, lt, bt, mt, gt, mxu="bf16"))
    for name, a, r, j in zip(_NAMES, emu, rnd, jax_res):
        a, r = a.reshape(j.shape), r.numpy().reshape(j.shape)
        to_jax = float(np.linalg.norm(a - j) / np.linalg.norm(j))
        rounded = float(np.linalg.norm(r - j) / np.linalg.norm(j))
        assert rounded >= 4.0 * to_jax, (name, to_jax, rounded)


# --------------------------------------------------------------- routing

@pytest.fixture
def recorded(monkeypatch):
    calls = []
    lib = _Recorder(calls)
    monkeypatch.setattr(twp, "_library", lambda mxu="fp32": lib)
    monkeypatch.setattr(twp, "_library_bwd", lambda: lib)
    monkeypatch.setattr(twp, "_library_tc", lambda backward: lib)
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(tslab, "_entry",
                        lambda name: getattr(lib, name))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for mod in (ths, tslab):
        mod.reset_launch_counts()
    yield calls
    for mod in (ths, tslab):
        mod.reset_launch_counts()


def _operands(seed, B=4, N=36, masked=True):
    qkv, ls, bias, mask, g = _inputs(B, N, masked, seed)
    q, k, v = _views(torch.from_numpy(qkv))
    return (q, k, v, torch.from_numpy(ls), torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(g))


@pytest.mark.parametrize("train", [False, True])
def test_fp32_reaches_the_tensor_core_entries_in_place(recorded, train):
    """fp32 through the public wrapper: the head-split tensor-core forward
    (the statistic when trained) and backward, each told qkv_bf16 0, the
    model's views read in place (strides (N*3C, 32, 3C)), g as handed back;
    counted as window_attention_headsplit_fwd_tc[+lse] / _bwd_tc, no FMA
    entry."""
    qkv, ls, bias, mask, g = (None if a is None else torch.from_numpy(a)
                              for a in _inputs(4, 36, True, seed=1))
    qt = qkv.as_subclass(_OnCard)
    if train:
        qt.requires_grad_()
    views = _views(qt)
    with contextlib.nullcontext() if train else torch.no_grad():
        out = ths.cosine_window_attention_headsplit(*views, ls, bias, mask)
        if train:
            out.backward(g)
    want = ["mmde_window_attention_headsplit_fwd_tc"] + (
        ["mmde_window_attention_headsplit_bwd_tc"] if train else [])
    assert [c["entry"] for c in recorded] == want
    view = (36 * 3 * C, 32, 3 * C)
    for c in recorded:
        assert c["strides"][:3] == [view] * 3
        fwd = "fwd" in c["entry"]
        assert c["args"][-3 if fwd else -4] == 0           # qkv_bf16
        assert c["args"][-2 if fwd else -3] == 0           # bias_bf16
    assert ths.launch_counts() == (
        {"window_attention_headsplit_fwd_tc+lse": 1,
         "window_attention_headsplit_bwd_tc": 1} if train
        else {"window_attention_headsplit_fwd_tc": 1})


@pytest.mark.parametrize("fma", [False, True])
def test_the_fp32_statistic_is_a_pair_tagged_with_its_body(recorded, fma):
    """fp32 writes (2, B_, nH, N), hi then lo, on either body, tagged with
    the body that wrote it; the other body's backward refuses it before any
    launch (the tensor cores round each sum toward zero, so their fp32
    logits lie a few ulps from the FMA body's), a statistic made elsewhere
    (untagged) is taken by its shape, and the one-number shape is refused."""
    q, k, v, ls, bias, mask, g = _operands(2)
    lse = ths._launch_forward(q, k, v, ls, bias, mask, True, _fma=fma)[1]
    assert tuple(lse.shape) == (2, 4, NH, 36)
    assert lse.written_by == ("FMA" if fma else "tensor-core")
    assert recorded[0]["entry"] == "mmde_window_attention_headsplit_fwd" + (
        "_stats" if fma else "_tc")
    recorded.clear()
    with pytest.raises(ValueError, match="forward wrote"):
        ths._launch_backward(q, k, v, ls, bias, mask, lse, g, True,
                             _fma=not fma)
    assert recorded == []
    ths._launch_backward(q, k, v, ls, bias, mask, lse.clone(), g, True,
                         _fma=not fma)
    assert len(recorded) == 1
    with pytest.raises(ValueError, match="log-sum-exp"):
        ths._launch_backward(q, k, v, ls, bias, mask, lse[0].clone(), g,
                             True, _fma=fma)


def test_the_function_hands_its_forwards_body_on(recorded):
    """The autograd Function's private last argument sends fp32 forward and
    backward to the FMA entries together; without it both run the
    tensor-core entries, and the backward reads the forward's buffer."""
    q, k, v, ls, bias, mask, g = _operands(3)
    for fma in (True, False):
        leaves = [t.detach().clone().as_subclass(_OnCard).requires_grad_()
                  for t in (q, k, v)]
        out = ths._HeadSplitWindowAttention.apply(*leaves, ls, bias, mask,
                                                  fma)
        out.backward(g)
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_stats",
        "mmde_window_attention_headsplit_bwd",
        "mmde_window_attention_headsplit_fwd_tc",
        "mmde_window_attention_headsplit_bwd_tc"]
    assert recorded[2]["args"][8] == recorded[3]["args"][8]   # one lse


def test_an_unaligned_fp32_view_is_copied_first(recorded):
    """fp32 rows 16-byte aligned by element size (128-byte rows): a view one
    element off is not read in place (`rows_layout_ok` false); the wrapper
    copies it to contiguous rows first, and the entry reads the copy."""
    qkv, ls, bias, _, _ = _inputs(2, 36, False, seed=4)
    flat = torch.from_numpy(qkv).reshape(-1)
    off = flat[1:1 + qkv.size - 3 * C * 2].reshape(2, 35, 3 * C)
    q, k, v = _views(off)
    assert not ths.rows_layout_ok(q)
    with torch.no_grad():
        ths.cosine_window_attention_headsplit(
            q.as_subclass(_OnCard), k, v, torch.from_numpy(ls),
            torch.from_numpy(bias)[:, :35, :35].contiguous(), None)
    assert [c["entry"] for c in recorded] == [
        "mmde_window_attention_headsplit_fwd_tc"]
    assert recorded[0]["strides"] == [(NH * 35 * 32, 35 * 32, 32)] * 3


def test_fp32_slab_maps_keep_their_fma_entries(recorded):
    """The slab wrapper's own rule, which now sends fp32 maps to the
    tensor cores as this module's rule sends fp32 views: an fp32 map's
    forward and backward reach the tensor-core slab entries with qkv_bf16 0
    and the (2, B*nW, nH, N) statistic between them, a bf16 map the same
    entries with qkv_bf16 1 and (B*nW, nH, N); only the private `_fma`
    reaches the FMA slab entries (the name is kept from when fp32 maps ran
    there)."""
    rng = np.random.default_rng(7)
    ls = torch.full((NH, 1, 1), 1.5)
    bias = torch.zeros((NH, 16, 16))
    for dtype, fma in ((torch.float32, False), (torch.bfloat16, False),
                       (torch.float32, True)):
        qmap = torch.from_numpy(rng.standard_normal(
            (1, 8, 8, 3 * C)).astype(np.float32)).to(dtype)
        g = torch.from_numpy(rng.standard_normal(
            (1, 8, 8, C)).astype(np.float32)).to(dtype)
        lse = tslab._launch_forward(qmap, ls, bias, None, NH, 4, True,
                                    _fma=fma)[1]
        tslab._launch_backward(qmap, ls, bias, None, lse, g, NH, 4, True,
                               _fma=fma)
        pair = fma or dtype == torch.float32
        assert tuple(lse.shape) == ((2,) if pair else ()) + (4, NH, 16)
        sfx = "" if fma else "_tc"
        assert [c["entry"] for c in recorded] == [
            "mmde_window_attention_slab_fwd" + (sfx or "_stats"),
            "mmde_window_attention_slab_bwd" + sfx], (dtype, fma)
        f, b = recorded[0]["args"], recorded[1]["args"]
        assert f[-3] == b[-4] == int(dtype == torch.bfloat16)   # qkv_bf16
        recorded.clear()


# ------------------------------------------------- sources and signatures

def _source(name: str) -> str:
    return open(os.path.join(cuda_build.CSRC_DIR, name)).read()


def _entry_body(src: str, entry: str) -> str:
    m = re.search(r'extern "C" int %s\((.*?)\)\s*{(.*?)\n}' % entry,
                  _source(src), re.S)
    return m.group(1) + m.group(2)


@pytest.mark.parametrize("src,entry,argtypes", [
    ("window_attention_fwd_tc.cu", "mmde_window_attention_headsplit_fwd_tc",
     "_FWD_TC_ARGTYPES"),
    ("window_attention_bwd_tc.cu", "mmde_window_attention_headsplit_bwd_tc",
     "_BWD_TC_ARGTYPES")])
def test_headsplit_entries_take_the_operand_type(src, entry, argtypes):
    """The head-split tensor-core entries take qkv_bf16 before bias_bf16
    (ctypes argument types matching parameter by parameter), refuse a bf16
    bias for fp32 operands, and launch the packed path's fp32
    instantiation on float Rows with contiguous fp32 outputs."""
    text = _entry_body(src, entry)
    m = re.search(r'extern "C" int %s\((.*?)\)\s*{' % entry, _source(src),
                  re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kinds == getattr(ths, argtypes)
    i = params.index("int qkv_bf16")
    assert params[i + 1] == "int bias_bf16"
    assert "if (!qkv_bf16 && bias_bf16) return -1;" in text
    assert "launch<Rows, float, float, MXU_FP32>" in text
    assert "contiguous_rows((float*)" in text
    assert "Rows<const float>" in text or "Operands<Rows, float>" in text


def test_fp32_k4_and_k5_take_both_f3_repairs():
    """F3's two rules in the fp32 branches of K5 and K4, as the W = 1
    kernels have them: exp(s - m) with the difference first (K5's forward;
    K4's two sweeps), and dlogit_scale as sum(ds * (sc - lse)) - K5's dk/dv
    pass on the statistic's hi, K4 on its own rows' m + log(l). The bf16
    branches keep the shifted form and the plain sum."""
    fwd = _source("window_attention_fwd_tc.cu")
    bwd = _source("window_attention_bwd_tc.cu")
    k4 = _source("window_attention_bwd_resident_tc.cu")
    w_fwd = fwd[fwd.index("fwd_tc_w_kernel(Rows<const T> q"):]
    # K5 forward: the fp32 branch forms the difference first
    assert "ex2((s[j][0] - m0) * TC_LOG2E)" in w_fwd
    assert "ex2(fmaf(s[j][0], TC_LOG2E, -sh0))" in w_fwd
    # both dk/dv passes (W = 1 and W) centre the fp32 sum on hi
    assert bwd.count("if constexpr (F32) dls_t = fmaf(d, sc - hi2[e], "
                     "dls_t);") == 2
    assert bwd.count("else dls_t = fmaf(d, sc, dls_t);") == 2
    assert bwd.count("dls_t = fmaf(d, sc, dls_t);") == 2
    # K4: both sweeps' exp, and the centred share on m + log(l)
    assert "e0 = ex2((s[j][0] - m0) * TC_LOG2E);" in k4
    assert "e0 = ex2(fmaf(s[j][0], TC_LOG2E, -sh0));" in k4
    assert re.search(r"p = ex2\(\(\(sc \+ \(e \? bm\.y : bm\.x\)\) - "
                     r"\(half \? m1 : m0\)\) \*\s+TC_LOG2E\) \* il;", k4)
    assert "lc0 = m0 + logf(l0);" in k4
    assert "dls_t = fmaf(ds, sc - (half ? lc1 : lc0), dls_t);" in k4
    assert "dls_t = fmaf(ds, sc, dls_t);" in k4


def test_compare_ptx_matches_a_kernel_by_its_own_name_first():
    """tools/compare_ptx pairs a kernel with the other tree's kernel of the
    same name where both trees spell it alike (this tree and its parent
    both template the kernels on the operand type), and falls back to the
    untyped spelling of an older tree; a kernel neither tree shares stays
    unmatched."""
    from mmde_tpu_torch.tools import compare_ptx
    mine = ["fwd_tc_kernel<Rows, __nv_bfloat16, float, 1>",
            "fwd_tc_kernel<Rows, float, float, 1>",
            "bwd_resident_tc_kernel<__nv_bfloat16, float>"]
    for name in mine:
        assert compare_ptx._match(name, mine) == name
    assert compare_ptx._match("fwd_tc_kernel<Rows, float, 1>", mine) == \
        mine[0]
    assert compare_ptx._match("bwd_resident_tc_kernel<float>", mine) == \
        mine[2]
    assert compare_ptx._match("fwd_tc_kernel<MapRows, float, 1>",
                              mine) is None
