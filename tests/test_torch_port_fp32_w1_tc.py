"""PyTorch port vs JAX package: K1 and K2 for fp32 qkv at one window per
block on the tensor cores.

Every packed fp32 launch at W = 1 - the fp32 flagship's default serving and
training path - now runs csrc/window_attention_{fwd,bwd}_tc.cu's
fwd_tc_kernel / bwd_dq_tc_kernel / bwd_dkv_tc_kernel instantiated on float:
every fp32 operand as three bf16 pieces, each product the six piece
products whose indices sum to at most 2, the statistic hi + lo formed in
fp64 (F3), each step's products added to the running sums by the CUDA
cores. Those kernels run only on the card (chip_smoke.py's kernel_cases,
kernel_cases_backward, kernel_cases_tc and f3_packed hold them to the plain
versions and float64 autograd). Here, on the CPU:

  * their arithmetic, emulated in plain torch (mmde_tpu_torch/testing.py,
    `pieces=3`, `windows=1`), on unrounded fp32 inputs drawn with numpy, is
    held to the JAX op in interpret mode at windows_per_cell=1 in each
    precision mode, masked and unmasked, at N 64 (one whole tile) and N 36
    (a ragged one), and to float64 autograd with every head at scale 60 /
    100;
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card: fp32 at W = 1 to
    the tensor-core entries (qkv_bf16 0), `_fma` to the FMA entries, the
    fp32 head-split and slab paths still to their FMA entries; the
    statistic's layout and its body, and the autograd Function handing its
    forward's body to its backward;
  * the entries' signatures and instantiations, read from the sources.
"""
import contextlib
import os
import re

import numpy as np
import pytest
import torch

from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.ops import window_attention_slab as tslab
from mmde_tpu_torch.testing import tc_backward, tc_forward
from mmde_tpu_torch.tools import split_errors

from test_torch_port_fp32_tc import (FP32_LIMITS, _errors, _held, _inputs,
                                     _jax_run)

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

# ------------------------------------------------ K1 / K2's arithmetic, W = 1

_CASES = {}


def _case(n, nW, mxu):
    """2 windows of n tokens, 4 heads (one clamped, one hot), the mask over
    nW windows or none: the JAX op at windows_per_cell=1 in interpret mode
    and the three-piece emulation at W = 1 (numpy)."""
    key = (n, nW, mxu)
    if key not in _CASES:
        x = _inputs(2, n, nW, seed=120 + n + nW)
        emu = [tc_forward(*x[:4], x[5], mxu, maxfree=False, pieces=3)] + \
            tc_backward(*x, mxu, windows=1, pieces=3)
        _CASES[key] = (_jax_run(*x, mxu=mxu, windows_per_cell=1),
                       [t.numpy() for t in emu])
    return _CASES[key]


@pytest.mark.parametrize("n", [64, 36])
@pytest.mark.parametrize("nW", [0, 2])
@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_fp32_w1_emulation_matches_jax(mxu, nW, n):
    """fp32 K1 / K2 at W = 1 (three pieces in fp32 / fold, one rounding in
    "bf16") against the JAX op with windows_per_cell=1 in interpret mode on
    unrounded fp32 inputs: fp32 / fold within 1e-5 (max abs relative to the
    JAX result's largest value, and rel-L2; dlogit_scale 5e-5), "bf16"
    within max abs 5e-4 and rel-L2 5e-5 - the fp32 K5 cases' bounds."""
    jax_res, emu = _case(n, nW, mxu)
    if mxu == "bf16":
        _held(emu, jax_res, (5e-4, 5e-5), (5e-4, 5e-5), f"W1 {mxu} {nW} {n}")
    else:
        _held(emu, jax_res, (1e-5, 1e-5), (5e-5, 5e-5), f"W1 {mxu} {nW} {n}")


@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_fp32_w1_modes_are_apart(mxu):
    """Each mode of the W = 1 arithmetic lies at least 4x nearer the JAX
    result of its own mode than the other one's (fp32 / fold against
    "bf16", "bf16" against "fold"), output and every gradient: MXU_APART's
    rule on the card."""
    own, emu = _case(64, 2, mxu)
    other = _case(64, 2, "fold" if mxu == "bf16" else "bf16")[0]
    for name, a, o, r in zip(("out", "dqkv", "dlogit_scale", "dbias"), emu,
                             own, other):
        a = a.reshape(o.shape)
        to_own = float(np.linalg.norm(a - o) / np.linalg.norm(o))
        to_other = float(np.linalg.norm(a - r) / np.linalg.norm(r))
        assert to_other >= 4.0 * to_own, (name, mxu, to_own, to_other)


@pytest.mark.parametrize("scale", [60.0, 100.0])
@pytest.mark.parametrize("n", [64, 36])
def test_fp32_w1_emulation_holds_the_fp32_limits_against_float64(scale, n):
    """Every head at scale 60 (or just inside the ln 100 clamp), masked:
    the three-piece arithmetic of K1 / K2 at W = 1 lies within the card's
    fp32 limits of float64 autograd - forward max abs 5e-5, dqkv and dbias
    rel-L2 2e-5, dlogit_scale 2e-4 of its largest entry - and the two-piece
    split does not (forward and dqkv): the check can fail a wrong split."""
    x = split_errors.inputs(n, scale, seed=5)
    want = split_errors.exact(*x)
    three = _errors(split_errors.emulate("bf16x3", x, 1), want)
    for k, lim in FP32_LIMITS.items():
        assert three[k] <= lim, (scale, n, k, three)
    two = _errors(split_errors.emulate("bf16x2", x, 1), want)
    assert two["out"] > FP32_LIMITS["out"] or \
        two["dqkv"] > FP32_LIMITS["dqkv"], two


# --------------------------------------------------------------- routing

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrappers' CUDA branches
    run, into the recorders below."""

    @property
    def is_cuda(self):
        return True


class _Recorder:
    """Stands in for a ctypes library or entry: every call records the
    entry's name and arguments and returns 0 (success)."""

    def __init__(self, calls, name=None):
        self._calls, self._name = calls, name

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)
        return _Recorder(self._calls, entry)

    def __call__(self, *args):
        self._calls.append((self._name, args))
        return 0


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    lib = _Recorder(calls)
    monkeypatch.setattr(twp, "_library", lambda mxu="fp32": lib)
    monkeypatch.setattr(twp, "_library_bwd", lambda: lib)
    monkeypatch.setattr(twp, "_library_resident", lambda tc=False: lib)
    monkeypatch.setattr(twp, "_library_tc", lambda backward: lib)
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(ths, "_entry",
                        lambda name, argtypes: _Recorder(calls, name))
    monkeypatch.setattr(tslab, "_entry", lambda name: _Recorder(calls, name))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for mod in (twp, ths, tslab):
        mod.reset_launch_counts()
    yield calls
    for mod in (twp, ths, tslab):
        mod.reset_launch_counts()


def _packed(seed=1, B=4, N=36, nW=2, dtype=torch.float32):
    qkv, ls, bias, mask, g, nH = _inputs(B, N, nW, seed=seed)
    return (torch.from_numpy(qkv).to(dtype), torch.from_numpy(ls),
            torch.from_numpy(bias).to(dtype),
            None if mask is None else torch.from_numpy(mask).to(dtype),
            torch.from_numpy(g).to(dtype), nH)


@pytest.mark.parametrize("mxu", [None, "fold", "bf16"])
@pytest.mark.parametrize("train", [False, True])
def test_fp32_w1_reaches_the_tensor_core_entries(recorded, mxu, train):
    """fp32 at W = 1 through the public wrapper: the tensor-core forward
    (the statistic when trained) and both tensor-core passes, each told
    qkv_bf16 0 and the mode; counted as window_attention_fwd_tc[+lse] /
    window_attention_bwd_tc; no FMA entry."""
    qkv, ls, bias, mask, g, nH = _packed()
    q = qkv.as_subclass(_OnCard)
    kw = dict(num_heads=nH, windows_per_cell=1, mxu=mxu)
    if train:
        q.requires_grad_()
        twp.cosine_window_attention_packed(q, ls, bias, mask, **kw).backward(g)
    else:
        with torch.no_grad():
            twp.cosine_window_attention_packed(q, ls, bias, mask, **kw)
    code = twp._MXU_CODE[twp.resolve_mxu(mxu, torch.float32)]
    want = ["mmde_window_attention_fwd_tc"] + (
        ["mmde_window_attention_bwd_tc"] if train else [])
    assert [e for e, _ in recorded] == want
    for entry, args in recorded:
        # ..., nW, qkv_bf16, bias_bf16, maxfree | dbias_mode, mxu, stream
        assert args[-6:-3] == (2, 0, 0), (entry, args)
        assert args[-2] == code
    assert twp.launch_counts() == (
        {"window_attention_fwd_tc+lse": 1, "window_attention_bwd_tc": 1}
        if train else {"window_attention_fwd_tc": 1})


def test_fma_reaches_the_fma_entries_forward_and_backward(recorded):
    """The private `_fma` sends an fp32 launch at W = 1 to K1's / K2's FMA
    entries, and the autograd Function's private last argument does so for
    its forward and its backward together."""
    qkv, ls, bias, mask, g, nH = _packed(seed=2)
    lse = twp._launch_forward(qkv, ls, bias, mask, nH, True, True,
                              _fma=True)[1]
    twp._launch_backward(qkv, ls, bias, mask, lse, g, nH, "window_resident",
                         True, _fma=True)
    assert [e for e, _ in recorded] == ["mmde_window_attention_fwd_stats",
                                        "mmde_window_attention_bwd"]
    recorded.clear()
    for fma in (True, False):
        q = qkv.clone().as_subclass(_OnCard).requires_grad_()
        out = twp._PackedWindowAttention.apply(q, ls, bias, mask, nH, True,
                                               "window_resident", 1, "fp32",
                                               fma)
        out.backward(g)
    assert [e for e, _ in recorded] == [
        "mmde_window_attention_fwd_stats", "mmde_window_attention_bwd",
        "mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_tc"]


def test_the_autograd_function_hands_its_forwards_body_on(recorded):
    """Through the autograd Function an fp32 step at W = 1 saves the
    tensor-core forward's (hi, lo) statistic, tagged with its body, and
    hands that buffer to the tensor-core backward."""
    qkv, ls, bias, mask, g, nH = _packed(seed=3)
    q = qkv.as_subclass(_OnCard).requires_grad_()
    out = twp.cosine_window_attention_packed(q, ls, bias, mask, num_heads=nH,
                                             windows_per_cell=1)
    out.backward(g)
    fwd = [a for e, a in recorded if e == "mmde_window_attention_fwd_tc"]
    bwd = [a for e, a in recorded if e == "mmde_window_attention_bwd_tc"]
    assert len(fwd) == 1 and len(bwd) == 1
    assert fwd[0][5] == bwd[0][4]          # the same lse buffer


@pytest.mark.parametrize("fma", [False, True])
def test_the_fp32_statistic_is_a_pair_tagged_with_its_body(recorded, fma):
    """fp32 at W = 1 writes (2, B_, nH, N), hi then lo, on either body,
    tagged with the body that wrote it; the other body's backward refuses
    it (the tensor cores round each sum toward zero, so fp32 logits there
    lie a few ulps below the FMA body's) before any launch, and a
    statistic made elsewhere (untagged) is taken by its shape."""
    qkv, ls, bias, mask, g, nH = _packed(seed=4)
    lse = twp._launch_forward(qkv, ls, bias, mask, nH, True, True,
                              _fma=fma)[1]
    assert tuple(lse.shape) == (2, 4, nH, 36)
    assert lse.written_by == ("FMA" if fma else "tensor-core")
    recorded.clear()
    with pytest.raises(ValueError, match="forward wrote"):
        twp._launch_backward(qkv, ls, bias, mask, lse, g, nH,
                             "window_resident", True, _fma=not fma)
    assert recorded == []
    twp._launch_backward(qkv, ls, bias, mask, lse.clone(), g, nH,
                         "window_resident", True, _fma=not fma)
    assert len(recorded) == 1
    with pytest.raises(ValueError, match="log-sum-exp"):
        twp._launch_backward(qkv, ls, bias, mask, lse[0].clone(), g, nH,
                             "window_resident", True, _fma=fma)


def test_fp32_headsplit_and_slab_keep_their_fma_entries(recorded):
    """The head-split and slab wrappers keep rules of their own, which now
    both take either type to the tensor cores: head-split operands and slab
    maps, bf16 or fp32 (fp32 through the packed fp32 instantiation, over
    the views' strides or the map's layout), reach the tensor-core entries
    with qkv_bf16 for their type (the name is kept from when fp32 slab maps
    ran the FMA entries)."""
    rng = np.random.default_rng(6)
    B_, nH, N = 2, 3, 16
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.from_numpy(rng.standard_normal(
            (B_, N, 3 * nH * 32)).astype(np.float32)).to(dtype)
        q, k, v = twp._split_heads(qkv, 3, nH)
        ls = torch.full((nH, 1, 1), 1.5)
        bias = torch.zeros((nH, N, N))
        ths._launch_forward(q, k, v, ls, bias, None, True)
        qmap = torch.from_numpy(rng.standard_normal(
            (1, 8, 8, 3 * nH * 32)).astype(np.float32)).to(dtype)
        tslab._launch_forward(qmap, ls, bias, None, nH, 4, True)
        assert [e for e, _ in recorded] == [
            "mmde_window_attention_headsplit_fwd_tc",
            "mmde_window_attention_slab_fwd_tc"], (dtype, recorded)
        assert recorded[1][1][-3] == int(dtype == torch.bfloat16)
        recorded.clear()


# ------------------------------------------------- sources and signatures

def _source(name: str) -> str:
    return open(os.path.join(cuda_build.CSRC_DIR, name)).read()


def _entries(src: str) -> dict:
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{',
                                 _source(src), re.S)}


@pytest.mark.parametrize("src,entry,argtypes,tail", [
    ("window_attention_fwd_tc.cu", "mmde_window_attention_fwd_tc",
     "_FWD_TC_ARGTYPES",
     ["int nW", "int qkv_bf16", "int bias_bf16", "int maxfree", "int mxu"]),
    ("window_attention_bwd_tc.cu", "mmde_window_attention_bwd_tc",
     "_BWD_TC_ARGTYPES",
     ["int nW", "int qkv_bf16", "int bias_bf16", "int dbias_mode",
      "int mxu"]),
])
def test_w1_entries_take_the_operand_type(src, entry, argtypes, tail):
    """No compiler here: the W = 1 tensor-core entries' parameters against
    their ctypes argument types (pointer -> c_void_p, int -> c_int), the
    operand type just before bias_bf16, the stream last."""
    params = _entries(src)[entry]
    kinds = [twp._P if "*" in p else twp._I for p in params]
    assert kinds == getattr(twp, argtypes), entry
    assert params[-1] == "void* stream"
    assert params[-1 - len(tail):-1] == tail, params


def test_w1_kernels_are_templates_over_the_operand_type():
    """The W = 1 kernels take the operand type as a template argument, and
    the packed, head-split and slab entries instantiate them on float
    (three bf16 pieces, the statistic hi + lo formed in fp64, the pair read
    back) as on bf16 (the slab entries through `launch_slab`, the map's
    layout)."""
    fwd = _source("window_attention_fwd_tc.cu")
    bwd = _source("window_attention_bwd_tc.cu")
    assert re.search(r"template <template <typename> class L, typename T, "
                     r"typename TB, int MXU>\n__global__ void "
                     r"__launch_bounds__\(TC_NT\)\nfwd_tc_kernel", fwd)
    for kernel in ("bwd_dq_tc_kernel", "bwd_dkv_tc_kernel"):
        assert re.search(r"template <template <typename> class L, typename "
                         r"T, typename TB, int MXU>\n__global__ void "
                         r"__launch_bounds__\(TC_NT\)\n" + kernel, bwd)
    for text in (fwd, bwd):
        assert "launch_packed<float, float, MXU>" in text
        assert "static constexpr int PS = F32 && !RB ? 3 : 1;" in text
        assert "if (!qkv_bf16 && bias_bf16) return -1;" in text
        hs = text[text.index('extern "C" int '
                             'mmde_window_attention_headsplit_'):]
        slab = hs[hs.index('extern "C" int mmde_window_attention_slab_'):]
        assert re.findall(r"launch<Rows, (\w+),", hs) == \
            ["float", "bf16", "bf16"]
        assert re.findall(r"launch_slab<(\w+),", slab) == [
            "float", "bf16", "bf16"]
        assert "launch<MapRows, T, TB, MXU_FP32>" in text
    assert "(double)m0 + log((double)l0)" in fwd
    # p = exp(s - m), the difference first; dlogit_scale centred on lse
    assert "ex2((s[j][0] - m0) * TC_LOG2E)" in fwd
    assert "if constexpr (F32) dls_t = fmaf(d, sc - hi2[e], dls_t);" in bwd
    assert bwd.count("F3: p = exp((s - hi) - lo)") >= 4
    # rule (b): each step's products in fresh registers, then the CUDA cores
    assert "this step's products in fresh registers" in fwd
    assert "the running dq += this step's" in bwd
    assert "the running dv, dk^ += this tile's" in bwd


def test_compare_ptx_matches_the_w1_kernels_by_their_old_names():
    """tools/compare_ptx matches this tree's operand-typed W = 1 kernels to
    the other tree's names: the bf16 instantiation without its operand
    type; a float one (only this tree's) keeps its name."""
    from mmde_tpu_torch.tools import compare_ptx
    assert compare_ptx._typed_as_other(
        "fwd_tc_kernel<Rows, __nv_bfloat16, float, 1>") == \
        "fwd_tc_kernel<Rows, float, 1>"
    assert compare_ptx._typed_as_other(
        "bwd_dkv_tc_kernel<MapRows, __nv_bfloat16, __nv_bfloat16, 0>") == \
        "bwd_dkv_tc_kernel<MapRows, __nv_bfloat16, 0>"
    assert compare_ptx._typed_as_other(
        "bwd_dq_tc_kernel<Rows, float, float, 2>") == \
        "bwd_dq_tc_kernel<Rows, float, float, 2>"
