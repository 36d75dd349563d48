"""PyTorch port vs JAX package: K4 and K5 on the tensor cores.

For bf16 qkv the port runs the single-pass backward K4
(MMDE_ATTN_GRID=bias_resident) through csrc/window_attention_bwd_resident_tc
.cu and the W-windows-per-block kernels K5 (MMDE_ATTN_W) through the
`_tc_w` entries of csrc/window_attention_{fwd,bwd}_tc.cu: bf16 mma.sync,
the function unchanged. Those kernels run only on the card (chip_smoke.py's
kernel_cases_resident and kernel_cases_w hold them to the plain versions and
to float64 autograd). Here, on the CPU:

  * their arithmetic, emulated in plain torch (mmde_tpu_torch/testing.py:
    `tc_backward_resident` - the block's own row statistics, m and l kept
    apart, split operands, dbias summed window after window within each
    chunk and then the chunks in order; `tc_backward(..., windows=3)` - ds
    summed over the W windows before dbias), is held to the JAX op in
    interpret mode (grid_mode="bias_resident", windows_per_cell=3, each
    precision mode) and K4's to float64 autograd;
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card;
  * the sources and the build: the new entries, their ctypes signatures.

Inputs are drawn with numpy and rounded to bf16 (qkv and g) before both
sides get them: the premise of the exact raw product.
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
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.testing import (group_sum, tc_backward,
                                    tc_backward_resident, tc_forward)

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

LN100 = math.log(100.0)
_NAMES = ("out", "dqkv", "dlogit_scale", "dbias")


def _bf16r(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(B, N, nW, seed):
    """nH = 4: head 0 clamped at scale 100, head 1 hot (scale 60), heads 2-3
    cool; 16*sigmoid bias; 0/-100 mask (diagonal kept) over nW windows, or
    None for nW = 0; qkv and g rounded to bf16."""
    rng = np.random.default_rng(seed)
    nH, C = 4, 128
    qkv = _bf16r(rng.standard_normal((B, N, 3 * C)).astype(np.float32))
    ls = np.array([LN100 + 0.5, math.log(60.0), 1.5, 2.5],
                  np.float32).reshape(nH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if nW:
        m = (rng.random((nW, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = _bf16r(rng.standard_normal((B, N, C)).astype(np.float32))
    return qkv, ls, bias, mask, g, nH


def _jax_run(qkv, ls, bias, mask, g, nH, **kw):
    """The JAX op's output and (dqkv, dlogit_scale, dbias) in interpret mode
    (fp32 qkv, `kw` passed through), with the row-maximum softmax for every
    head (SOFTMAX_MAXFREE off for the call: its static shift loses the rows
    of a head at scale 100, ROADMAP F1)."""
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


# ------------------------------------------------------- K4's arithmetic

@pytest.mark.parametrize("nW", [0, 2])
def test_resident_emulation_matches_jax_k4(nW):
    """The tensor-core K4's arithmetic (2 chunks of 2 windows) against the
    JAX op under grid_mode="bias_resident" (K1, then K4 in interpret mode),
    N = 49: output and the three gradients within 1e-5 (max abs relative to
    the JAX result's largest value, and rel-L2) - the bound the tensor-core
    K2's emulation is held to; dlogit_scale, a sum of B_ N^2 terms that
    cancel, within 5e-5 (test_torch_port_tc.py's reason)."""
    x = _inputs(4, 49, nW, seed=40 + nW)
    jax_res = _jax_run(*x, grid_mode="bias_resident")
    emu = [tc_forward(*x[:4], x[5], "fp32", maxfree=False).numpy()] + [
        t.numpy() for t in tc_backward_resident(*x, splits=2)]
    _held(emu, jax_res, (1e-5, 1e-5), (5e-5, 5e-5), f"K4 nW={nW}")


def test_resident_emulation_matches_float64_autograd():
    """The same arithmetic against float64 autograd of the plain forward on
    the same (bf16-valued) inputs, 3 chunks over 6 windows, 3 masks: dqkv
    and dbias within rel-L2 1e-5 (the plain fp32 backward's own bound in
    test_torch_port_resident.py), dlogit_scale within 5e-5 (its cancelling
    sum), and the clamped head's dlogit_scale exactly 0."""
    qkv, ls, bias, mask, g, nH = _inputs(6, 36, 3, seed=44)
    got = tc_backward_resident(qkv, ls, bias, mask, g, nH, splits=3)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (qkv, ls, bias)]
    out = twp.cosine_window_attention_packed_plain(
        *leaves, torch.from_numpy(mask).double(), num_heads=nH,
        compute_dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g).double())
    for name, a, b in zip(("dqkv", "dlogit_scale", "dbias"), got, want):
        a, b = a.double().reshape(b.shape), b.detach()
        bound = 5e-5 if name == "dlogit_scale" else 1e-5
        assert float((a - b).norm() / b.norm()) <= bound, name
    assert float(got[1].flatten()[0]) == 0.0


def test_resident_dbias_order_is_the_chunks_in_turn():
    """group_sum adds each chunk window after window and then the chunks
    one after another: the order two launches of K4 repeat bit for bit.
    Within fp32 rounding it is the plain sum; in bits it is that order."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((7, 5, 6)).astype(np.float32))
    want = ((x[0] + x[1] + x[2]) + (x[3] + x[4] + x[5])) + x[6]
    assert torch.equal(group_sum(x, 3), want)
    assert torch.allclose(group_sum(x, 3), x.sum(0), atol=1e-5)
    assert torch.equal(group_sum(x, 1), ((((((x[0] + x[1]) + x[2]) + x[3])
                                          + x[4]) + x[5]) + x[6]))


# ------------------------------------------------------- K5's arithmetic

_W_CASES = {}


def _w_case(nW, mxu):
    key = (nW, mxu)
    if key not in _W_CASES:
        x = _inputs(6, 49, nW, seed=50 + nW)
        emu = [tc_forward(*x[:4], x[5], mxu, maxfree=False)] + tc_backward(
            *x, mxu, windows=3)
        _W_CASES[key] = (_jax_run(*x, mxu=mxu, windows_per_cell=3),
                         [t.numpy() for t in emu])
    return _W_CASES[key]


@pytest.mark.parametrize("nW", [0, 3])
@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_w_emulation_matches_jax_three_windows_per_cell(mxu, nW):
    """K5 at W = 3 on the tensor cores (the same per-window arithmetic as
    at W = 1, ds summed over the 3 windows before dbias) against the JAX op
    with windows_per_cell=3 in interpret mode, B_ = 6, N = 49, 3 masks or
    none, each mode: fp32 / fold within 1e-5 (dlogit_scale 5e-5), "bf16"
    within max abs 5e-4 and rel-L2 5e-5 - test_torch_port_tc.py's bounds
    and reasons (isolated bf16 rounding flips of a rounded operand)."""
    jax_res, emu = _w_case(nW, mxu)
    if mxu == "bf16":
        _held(emu, jax_res, (5e-4, 5e-5), (5e-4, 5e-5), f"K5 {mxu} {nW}")
    else:
        _held(emu, jax_res, (1e-5, 1e-5), (5e-5, 5e-5), f"K5 {mxu} {nW}")


@pytest.mark.parametrize("mxu", ["fp32", "fold"])
def test_w_emulation_keeps_the_fold_function(mxu):
    """fp32 / fold at W = 3 lie at least 4x nearer the JAX "fold" result
    than the JAX "bf16"-mode one, output and every gradient (MXU_APART's
    rule on the card): the W-window sums round nothing to bf16."""
    _, emu = _w_case(3, mxu)
    fold, _ = _w_case(3, "fold")
    rnd, _ = _w_case(3, "bf16")
    for name, a, f, r in zip(_NAMES, emu, fold, rnd):
        a = a.reshape(f.shape)
        to_fold = float(np.linalg.norm(a - f) / np.linalg.norm(f))
        to_bf16 = float(np.linalg.norm(a - r) / np.linalg.norm(r))
        assert to_bf16 >= 4.0 * to_fold, (name, mxu, to_fold, to_bf16)


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
    # (dtype, grid, W setting, train) -> entries, counted kernels
    ("bf16", "bias_resident", "1", True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_resident_tc"],
     {"window_attention_fwd_tc", "window_attention_bwd_resident_tc"}),
    ("bf16", "bias_resident", "auto", True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_resident_tc"],
     {"window_attention_fwd_tc", "window_attention_bwd_resident_tc"}),
    ("fp32", "bias_resident", "1", True,
     ["mmde_window_attention_fwd_tc", "mmde_window_attention_bwd_resident_tc"],
     {"window_attention_fwd_tc", "window_attention_bwd_resident_tc"}),
    ("bf16", "window_resident", "auto", True,
     ["mmde_window_attention_fwd_tc_w", "mmde_window_attention_bwd_tc_w"],
     {"window_attention_fwd_tc_w4+lse", "window_attention_bwd_tc_w4"}),
    ("bf16", "split", "auto", True,
     ["mmde_window_attention_fwd_tc_w", "mmde_window_attention_bwd_tc_w",
      "mmde_window_attention_dbias_tc"],
     {"window_attention_fwd_tc_w4+lse", "window_attention_bwd_tc_w4",
      "window_attention_dbias_tc"}),
    ("bf16", "window_resident", "auto", False,
     ["mmde_window_attention_fwd_tc_w"], {"window_attention_fwd_tc_w4"}),
    ("fp32", "window_resident", "auto", True,
     ["mmde_window_attention_fwd_tc_w", "mmde_window_attention_bwd_tc_w"],
     {"window_attention_fwd_tc_w4+lse", "window_attention_bwd_tc_w4"}),
])
def test_k4_and_k5_route_by_type(recorded, case):
    """bf16 qkv takes the tensor-core K4 (after the tensor-core forward
    without lse, W = 1 whatever the setting, as in JAX) and the tensor-core
    K5 at the rule's W, whose entries receive W just before the mode and
    the stream (the forward's lse null when serving); under "split" the
    tensor-core K3's pass follows K5 as it follows K2. fp32 qkv takes them too (K4 and K5
    on the tensor cores, its forward before K4 the tensor-core K1). The
    counters name the kernel that ran, with its W."""
    dtype_name, grid, wpc, train, want, counted = case
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    _drive(dtype, grid, wpc, train)
    assert [e for e, _ in recorded] == want, case
    assert set(twp.launch_counts()) == counted, twp.launch_counts()
    code = twp._MXU_CODE[twp.resolve_mxu(None, dtype)]
    for entry, args in recorded:
        if entry.endswith("_tc_w"):
            assert args[-3:-1] == (4, code), (entry, args)
        if entry == "mmde_window_attention_fwd_tc_w":
            assert (args[5] is not None) == train
        if entry == "mmde_window_attention_bwd_tc_w":
            assert args[-4] == (1 if grid == "window_resident" else 0)
        if entry == "mmde_window_attention_bwd_resident_tc":
            # bias_bf16, then the chunks (tensor-core splits), then stream
            assert args[-3:-1] == (int(dtype == torch.bfloat16),
                                   twp.resident_splits(36, 4, 8, True))
    if grid == "bias_resident":
        assert sum(twp.LAUNCHES_RESIDENT_BY_SHAPE.values()) == 1
        assert not twp.LAUNCHES_BWD_BY_SHAPE


def test_private_switch_reaches_the_fma_k4_and_k5(recorded):
    """`_fma` (chip_smoke.py's same-card A/B, never the model) sends a bf16
    K4 / K5 launch to the FMA bodies; without it bf16 goes to the tensor
    cores. W past what a tensor-core block holds is the kernel's to refuse
    (its entry returns -1, the wrapper raises)."""
    qkv, ls, bias, mask, g, nH = _inputs(8, 36, 4, seed=2)
    q = torch.from_numpy(qkv).bfloat16()
    lt, b = torch.from_numpy(ls), torch.from_numpy(bias).bfloat16()
    m = torch.from_numpy(mask).bfloat16()
    gt = torch.from_numpy(g).bfloat16()
    lse = torch.zeros((2, 8, nH, 36))    # the FMA body's hi + lo (F3)
    twp._launch_backward_resident(q, lt, b, m, gt, nH, _fma=True)
    twp._launch_backward_resident(q, lt, b, m, gt, nH)
    twp._launch_forward(q, lt, b, m, nH, True, True, w=4, _fma=True)
    twp._launch_backward(q, lt, b, m, lse, gt, nH, "window_resident", True,
                         w=4, _fma=True)
    assert [e for e, _ in recorded] == [
        "mmde_window_attention_bwd_resident",
        "mmde_window_attention_bwd_resident_tc",
        "mmde_window_attention_fwd_w", "mmde_window_attention_bwd_w"]
    # the FMA K4 chunks its 16-row blocks, the tensor-core one its 64-row
    assert recorded[0][1][-2] == twp.resident_splits(36, nH, 8)
    assert recorded[1][1][-2] == twp.resident_splits(36, nH, 8, True)
    assert twp.launch_counts() == {
        "window_attention_bwd_resident": 1,
        "window_attention_bwd_resident_tc": 1,
        "window_attention_bwd_w4": 1, "window_attention_fwd_w4+lse": 1}
    import inspect
    private = [p for p in
               inspect.signature(twp._launch_backward_resident).parameters
               if p.startswith("_")]
    assert private == ["_fma"]


def test_a_refused_launch_raises(monkeypatch):
    """No fallback: an entry that returns an error makes the wrapper raise,
    naming the kernel, for K4 and K5 on the tensor cores alike."""
    class Failing:
        def __getattr__(self, entry):
            return lambda *args: -1
    failing = Failing()
    monkeypatch.setattr(twp, "_library_resident", lambda tc=False: failing)
    monkeypatch.setattr(twp, "_library_tc", lambda backward: failing)
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    qkv, ls, bias, mask, g, nH = _inputs(8, 36, 4, seed=3)
    q = torch.from_numpy(qkv).bfloat16()
    lt, b = torch.from_numpy(ls), torch.from_numpy(bias).bfloat16()
    gt = torch.from_numpy(g).bfloat16()
    with pytest.raises(RuntimeError, match="bwd_resident_tc"):
        twp._launch_backward_resident(q, lt, b, None, gt, nH)
    with pytest.raises(RuntimeError, match="fwd_tc_w8"):
        twp._launch_forward(q, lt, b, None, nH, True, False, w=8)
    twp.reset_launch_counts()


@pytest.mark.parametrize("N,nH,B_,want", [
    (900, 4, 96, 4), (900, 8, 24, 2), (900, 16, 8, 1), (225, 32, 8, 2),
    (900, 4, 48, 4), (49, 4, 1, 1), (900, 4, 9, 3), (36, 4, 8, 8)])
def test_tensor_core_splits_fill_one_wave_and_no_chunk_is_empty(N, nH, B_,
                                                                want):
    """The tensor-core K4's window chunks: at most RESIDENT_TC_BLOCKS
    64-row blocks (one wave at two an SM), at most one chunk per window, and
    every chunk of ceil(B_ / splits) windows holds at least one (the kernel
    refuses an empty one). The flagship's train shapes give 4 / 2 / 1 / 2."""
    got = twp.resident_splits(N, nH, B_, tc=True)
    assert got == want
    blocks = -(-N // 64) * nH
    assert got == 1 or got * blocks <= twp.RESIDENT_TC_BLOCKS
    chunk = -(-B_ // got)
    assert (got - 1) * chunk < B_


def test_tensor_core_body_takes_every_w():
    assert twp.tensor_core_body(torch.bfloat16, 4)
    assert twp.tensor_core_body(torch.bfloat16, 8)
    # fp32 qkv: K5 (W > 1), K4 and K1 / K2 at W = 1 on the tensor cores
    assert twp.tensor_core_body(torch.float32, 4)
    assert twp.tensor_core_body(torch.float32, 1, resident=True)
    assert twp.tensor_core_body(torch.float32, 1)


# ------------------------------------------------------- sources and build

def _entries(src: str) -> dict:
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{', text,
                                 re.S)}


@pytest.mark.parametrize("src,entry,argtypes,mxu", [
    ("window_attention_bwd_resident_tc.cu",
     "mmde_window_attention_bwd_resident_tc", "_RESIDENT_TC_ARGTYPES", False),
    ("window_attention_fwd_tc.cu", "mmde_window_attention_fwd_tc_w",
     "_FWD_TC_W_ARGTYPES", True),
    ("window_attention_bwd_tc.cu", "mmde_window_attention_bwd_tc_w",
     "_BWD_TC_W_ARGTYPES", True),
])
def test_new_entries_and_their_ctypes_signatures(src, entry, argtypes, mxu):
    """No compiler here: each new C entry's parameters against its ctypes
    argument types (pointer -> c_void_p, int -> c_int); the K5 entries take
    `int W`, then the mode `int mxu`, then the stream; K4's takes no mode
    (always the fp32 function). The sources include the tensor-core header,
    run their products through its mma helpers and no library."""
    params = _entries(src)[entry]
    kinds = [twp._P if "*" in p else twp._I for p in params]
    assert kinds == getattr(twp, argtypes), entry
    assert params[-1] == "void* stream"
    if mxu:
        assert params[-3:-1] == ["int W", "int mxu"]
    else:
        assert "int mxu" not in params and params[-2] == "int splits"
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    assert '#include "window_attention_tc.cuh"' in text
    assert re.search(r"\bmma(_rows|_cols2?)?\s*[<(]", text)
    for lib in ("cublas", "cudnn", "torch/extension.h", "cutlass"):
        assert lib not in text.lower()


def test_build_kernels_builds_the_resident_tensor_core_library(monkeypatch):
    """build_kernels starts the K4 tensor-core library's nvcc beside the
    others and binds its entry and the two K5 entries."""
    bound = {}

    class Fn:
        argtypes = None
        restype = None

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            if entry.startswith("__"):
                raise AttributeError(entry)
            return bound.setdefault((self.name, entry), Fn())

    started = []

    def load_libraries(specs):
        started.append(sorted(specs))
        for n in specs:
            cuda_build.BUILD_LOG[n] = {"path": n, "seconds": 0.0, "log": ""}

    monkeypatch.setattr(cuda_build, "load_libraries", load_libraries)
    monkeypatch.setattr(cuda_build, "load_library",
                        lambda name, sources, defines=(): Lib(name))
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    twp.build_kernels()
    assert "window_attention_bwd_resident_tc" in started[0]
    assert twp.library_specs()["window_attention_bwd_resident_tc"] == (
        ("window_attention_bwd_resident_tc.cu",), ())
    for lib, entry, types in (
            ("window_attention_bwd_resident_tc",
             "mmde_window_attention_bwd_resident_tc",
             twp._RESIDENT_TC_ARGTYPES),
            ("window_attention_fwd_tc", "mmde_window_attention_fwd_tc_w",
             twp._FWD_TC_W_ARGTYPES),
            ("window_attention_bwd_tc", "mmde_window_attention_bwd_tc_w",
             twp._BWD_TC_W_ARGTYPES)):
        assert bound[(lib, entry)].argtypes == types
