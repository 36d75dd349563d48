"""PyTorch port vs JAX package: the tensor-core bodies of K1 / K2.

The port runs every bf16 packed launch at one window per block through
csrc/window_attention_{fwd,bwd}_tc.cu: products on bf16 mma.sync, the
function of each precision mode unchanged. Those kernels run only on the
card (chip_smoke.py, kernel_cases_tc, holds them to the plain versions).
Here, on the CPU:

  * the arithmetic they rely on, emulated in plain torch (`tc_forward`,
    `tc_backward` of mmde_tpu_torch/testing.py: the raw bf16 q k^T with a
    rank-1 fp32 epilogue, p / ds split into bf16 hi and lo before their
    products, scale * rk_j and scale * rq_i folded into ds before the
    split, the bf16 mode's rounded operands), is held to the JAX package's
    `cosine_window_attention_packed` in interpret mode, forward and
    backward, per mode;
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card;
  * the sources and the build: the new libraries, their C entries' mode
    argument and ctypes signatures.

Inputs are drawn with numpy and rounded to bf16 (qkv and g) before both
sides get them: the premise of the exact raw product.
"""
import contextlib
import math
import os
import re

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from mmde_tpu.ops import window_attention_packed as jwap
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.testing import tc_backward, tc_forward

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

LN100 = math.log(100.0)


def _bf16r(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(B, N, masked, seed):
    """nH = 4: head 0 clamped at scale 100, head 1 hot (scale 60), heads 2-3
    cool (scale e^1.5 .. e^2.5, <= 30); 16*sigmoid bias; 0/-100 mask
    (diagonal kept) over 2 windows or None; qkv and g rounded to bf16."""
    rng = np.random.default_rng(seed)
    nH, C = 4, 128
    qkv = _bf16r(rng.standard_normal((B, N, 3 * C)).astype(np.float32))
    ls = np.array([LN100 + 0.5, math.log(60.0), 1.5, 2.5],
                  np.float32).reshape(nH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if masked:
        m = (rng.random((2, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = _bf16r(rng.standard_normal((B, N, C)).astype(np.float32))
    return qkv, ls, bias, mask, g, nH


def _jax_run(qkv, ls, bias, mask, g, nH, mxu):
    """The JAX op's output and (dqkv, dlogit_scale, dbias), interpret mode,
    fp32 qkv with the mode passed explicitly, and the row-maximum softmax
    for every head (its module flag SOFTMAX_MAXFREE off for the call, what
    MMDE_ATTN_SOFTMAX=max sets at import): its static shift scale + 16
    loses the rows of a head at scale 100 (ROADMAP F1; the port takes the
    row maximum for such heads)."""
    N, C = qkv.shape[1], qkv.shape[2] // 3
    _, Np, _, HG, nG, _ = jwap.attention_plan(N, nH, 32, C)
    m = None if mask is None else jnp.asarray(mask)

    def f(q, l, b_hnn):
        bp = jwap.pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return jwap.cosine_window_attention_packed(
            q, l, bp, m, num_heads=nH, mxu=mxu, interpret=True)

    maxfree = jwap.SOFTMAX_MAXFREE
    jwap.SOFTMAX_MAXFREE = False
    try:
        out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(ls),
                           jnp.asarray(bias))
        return [np.asarray(out)] + [np.asarray(x)
                                    for x in vjp(jnp.asarray(g))]
    finally:
        jwap.SOFTMAX_MAXFREE = maxfree


_CASES = {}


def _case(N, masked, mxu):
    """(inputs, JAX results, emulation results) at one (N, mask, mode),
    computed once per process."""
    key = (N, masked, mxu)
    if key not in _CASES:
        x = _inputs(4 if N == 49 else 2, N, masked, seed=N + masked)
        # the row maximum for every head, as the JAX side takes it
        emu = [tc_forward(*x[:4], x[5], mxu, maxfree=False)] + tc_backward(
            *x, mxu)
        _CASES[key] = (x, _jax_run(*x, mxu), [t.numpy() for t in emu])
    return _CASES[key]


_NAMES = ("out", "dqkv", "dlogit_scale", "dbias")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [49, 100])
@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_emulated_body_matches_jax_in_each_mode(mxu, N, masked):
    """The tensor-core arithmetic keeps each mode's function: output and
    the three gradients within 1e-5 of the JAX op's (max abs relative to the
    largest value of the JAX result, and rel-L2), as the port's plain
    versions are held in test_torch_port_mxu.py. The split leaves ~2^-17 of
    each fp32 operand, well inside that.

    dlogit_scale is bounded at 5e-5 in fp32 / fold: it is a sum of B_*N^2
    signed terms that cancel, and at the hot head (scale 60) an fp32 ulp of
    a logit (4e-6) moves every p of its row; the exact plain version itself
    lies 1.0e-5 from JAX there (N = 49, unmasked), the emulation 1.5e-5.

    "bf16" is bounded as that file bounds its N = 500 case: the emulation
    normalises q and k in torch's summation order and the JAX body in its
    own, and an fp32 ulp there can carry a rounded operand (q^ * scale, k^,
    p, ds) across a bf16 rounding boundary, which moves that one operand by
    2^-8 of itself; those isolated flips are allowed rel-L2 5e-5 and max abs
    5e-4."""
    _, jax_res, emu = _case(N, masked, mxu)
    for name, a, b in zip(_NAMES, emu, jax_res):
        a = a.reshape(b.shape)
        if mxu == "bf16":
            bound = (5e-4, 5e-5)
        else:
            bound = (5e-5, 5e-5) if name == "dlogit_scale" else (1e-5, 1e-5)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert err <= bound[0], (name, mxu, N, masked, err)
        assert rel_l2 <= bound[1], (name, mxu, N, masked, rel_l2)
        assert float(np.abs(b).max()) > 1e-3, name


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N", [49, 100])
@pytest.mark.parametrize("mxu", ["fp32", "fold"])
def test_split_keeps_the_fold_function(mxu, N, masked):
    """The CPU proof that feeding bf16 tensor cores keeps fold's (and
    fp32's) function: the emulation lies at least 4x nearer the JAX "fold"
    result than the JAX "bf16"-mode result, for the output and every
    gradient (a body that rounded p, q^ or ds to bf16 would sit near the
    latter)."""
    _, _, emu = _case(N, masked, mxu)
    _, fold, _ = _case(N, masked, "fold")
    _, rnd, _ = _case(N, masked, "bf16")
    for name, a, f, r in zip(_NAMES, emu, fold, rnd):
        a = a.reshape(f.shape)
        to_fold = float(np.linalg.norm(a - f) / np.linalg.norm(f))
        to_bf16 = float(np.linalg.norm(a - r) / np.linalg.norm(r))
        assert to_bf16 >= 4.0 * to_fold, (name, mxu, N, masked, to_fold,
                                          to_bf16)


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


def _drive(dtype, grid="window_resident", wpc="1", mxu=None, train=True):
    x = _inputs(8, 36, True, seed=1)
    qkv, ls, bias, mask, g, nH = x
    mask = np.concatenate([mask, mask])           # 4 windows: W = 4
    q = torch.from_numpy(qkv).to(dtype).as_subclass(_OnCard)
    b = torch.from_numpy(bias).to(dtype)
    m = torch.from_numpy(mask).to(dtype)
    lt = torch.from_numpy(ls)
    if not train:
        with torch.no_grad():
            twp.cosine_window_attention_packed(q, lt, b, m, num_heads=nH,
                                               grid_mode=grid,
                                               windows_per_cell=wpc, mxu=mxu)
        return
    q.requires_grad_()
    b.requires_grad_()
    out = twp.cosine_window_attention_packed(q, lt, b, m, num_heads=nH,
                                             grid_mode=grid,
                                             windows_per_cell=wpc, mxu=mxu)
    out.backward(torch.from_numpy(g).to(dtype))


@pytest.mark.parametrize("case", [
    # (dtype, grid, W setting, mode, train) -> entries in launch order
    ("bf16", "window_resident", "1", None, True),
    ("bf16", "split", "1", None, True),
    ("bf16", "bias_resident", "1", None, True),
    ("bf16", "window_resident", "1", "bf16", True),
    ("bf16", "window_resident", "1", "fp32", False),
    ("fp32", "window_resident", "1", None, True),
    ("fp32", "split", "1", "fold", True),
    ("bf16", "window_resident", "auto", None, True),
    ("fp32", "bias_resident", "1", None, True),
    ("fp32", "window_resident", "auto", None, True),
])
def test_routing_follows_the_type_and_w(recorded, case):
    """bf16 and fp32 qkv run the tensor-core entries in every grid, mode
    and W (split: the tensor-core passes without dbias, then the
    tensor-core K3's pass on the statistic of the type, lse_pair 0 / 1;
    bias_resident: the tensor-core forward without lse, then the
    tensor-core K4; W > 1: K5's tensor-core entries; fp32 operands in three
    bf16 pieces), each entry told the operand type (qkv_bf16). The mode
    reaches every packed entry but K4's as its code, just before the stream
    (K5's: W, then the mode); the launch counters name the kernel that ran,
    K3 after the tensor-core passes under its own name,
    window_attention_dbias_tc (and outside the per-shape backward
    counts)."""
    name, grid, wpc, mxu, train = case
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    _drive(dtype, grid, wpc, mxu, train)
    code = twp._MXU_CODE[twp.resolve_mxu(mxu, dtype)]
    entries = [e for e, _ in recorded]
    w_sfx = "_w" if wpc == "auto" and grid != "bias_resident" else ""
    if not train:
        want = ["mmde_window_attention_fwd_tc"]
    elif grid == "bias_resident":
        want = ["mmde_window_attention_fwd_tc",
                "mmde_window_attention_bwd_resident_tc"]
    else:
        want = ["mmde_window_attention_fwd_tc" + w_sfx,
                "mmde_window_attention_bwd_tc" + w_sfx]
        want += ["mmde_window_attention_dbias_tc"] if grid == "split" else []
    assert entries == want, case
    qkv_bf16 = int(dtype == torch.bfloat16)
    for entry, args in recorded:
        if entry.endswith("_w"):
            assert args[-3] == 4, (entry, case)        # W, mxu, the stream
        if not entry.startswith("mmde_window_attention_bwd_resident"):
            assert args[-2] == code, (entry, case)     # mxu, then the stream
        if entry == "mmde_window_attention_fwd_tc":
            with_lse = train and grid != "bias_resident"
            assert (args[5] is not None) == with_lse, case
            # ..., nW, qkv_bf16, bias_bf16, maxfree, mxu, stream
            assert args[-5] == qkv_bf16, case
        if entry == "mmde_window_attention_bwd_tc":
            dbias_mode = args[-3]
            assert dbias_mode == (1 if grid == "window_resident" else 0)
            # ..., nW, qkv_bf16, bias_bf16, dbias_mode, mxu, stream
            assert args[-5] == qkv_bf16, case
        if entry == "mmde_window_attention_dbias_tc":
            # ..., nW, qkv_bf16, bias_bf16, lse_pair, mxu, stream
            assert args[-5] == qkv_bf16 and args[-3] == 1 - qkv_bf16, case
            assert len(args) == len(twp._DBIAS_ARGTYPES)
    counted = twp.launch_counts()
    # either type: every packed launch on the tensor cores
    assert set(counted) <= {"window_attention_fwd_tc",
                            "window_attention_fwd_tc+lse",
                            "window_attention_bwd_tc",
                            "window_attention_fwd_tc_w4+lse",
                            "window_attention_bwd_tc_w4",
                            "window_attention_dbias_tc",
                            "window_attention_bwd_resident_tc"}, counted
    assert counted.get("window_attention_dbias_tc", 0) == (
        1 if train and grid == "split" else 0), counted
    if train and grid != "bias_resident":
        assert sum(twp.LAUNCHES_BWD_BY_SHAPE.values()) == 1


def test_private_arguments_reach_the_fma_body_and_the_sweep(recorded):
    """`_fma` sends a bf16 launch to K1's / K2's FMA entries (the card
    tools' and chip_smoke.py's comparisons) and is not reachable from the
    public wrapper; the tensor-core dq pass has one form, its two sweeps
    (delta first), and the launch helper offers no other."""
    qkv, ls, bias, mask, g, nH = _inputs(2, 36, False, seed=2)
    q = torch.from_numpy(qkv).bfloat16()
    lt, b = torch.from_numpy(ls), torch.from_numpy(bias).bfloat16()
    gt = torch.from_numpy(g).bfloat16()
    lse = torch.zeros((2, nH, 36))
    twp._launch_forward(q, lt, b, None, nH, True, True, _fma=True)
    # the FMA body's statistic is hi + lo (F3), the bf16 tensor cores' one
    twp._launch_backward(q, lt, b, None, torch.zeros((2,) + lse.shape), gt,
                         nH, "window_resident", True, _fma=True)
    twp._launch_backward(q, lt, b, None, lse, gt, nH, "window_resident",
                         True)
    assert [e for e, _ in recorded] == [
        "mmde_window_attention_fwd_stats", "mmde_window_attention_bwd",
        "mmde_window_attention_bwd_tc"]
    assert len(recorded[2][1]) == len(twp._BWD_TC_ARGTYPES)
    assert twp.launch_counts() == {"window_attention_bwd": 1,
                                   "window_attention_bwd_tc": 1,
                                   "window_attention_fwd+lse": 1}
    import inspect
    public = inspect.signature(twp.cosine_window_attention_packed).parameters
    assert not any(p.startswith("_") for p in public)
    private = [p for p in inspect.signature(twp._launch_backward).parameters
               if p.startswith("_")]
    assert private == ["_fma"]


def test_tensor_core_body_rule():
    assert twp.tensor_core_body(torch.bfloat16, 1)
    assert twp.tensor_core_body(torch.bfloat16, 4)
    # fp32 packed launches at W = 1 too, head-split and slab
    assert twp.tensor_core_body(torch.float32, 1)
    assert twp.headsplit_tensor_core_body(torch.float32)
    assert twp.slab_tensor_core_body(torch.float32)


# ------------------------------------------------------- sources and build

def _entries(src: str) -> dict:
    text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{', text,
                                 re.S)}


def test_tensor_core_sources_and_signatures():
    """No compiler here: the tensor-core libraries are part of the model's
    build, their C entries take the mode code of _MXU_CODE as `int mxu`
    just before the stream (the same header's codes), and the ctypes
    argument types match each C signature, pointers as c_void_p and ints as
    c_int. Every product of the two sources goes through the bf16 mma.sync
    helper."""
    specs = twp.library_specs()
    assert specs["window_attention_fwd_tc"] == (
        ("window_attention_fwd_tc.cu",), ())
    assert specs["window_attention_bwd_tc"] == (
        ("window_attention_bwd_tc.cu",), ())
    tables = {"mmde_window_attention_fwd_tc": twp._FWD_TC_ARGTYPES,
              "mmde_window_attention_bwd_tc": twp._BWD_TC_ARGTYPES,
              "mmde_window_attention_dbias": twp._DBIAS_ARGTYPES}
    found = {}
    for src in ("window_attention_fwd_tc.cu", "window_attention_bwd_tc.cu",
                "window_attention_bwd.cu"):
        found.update(_entries(src))
    for name, argtypes in tables.items():
        params = found[name]
        assert params[-2:] == ["int mxu", "void* stream"], name
        kinds = [twp._P if "*" in p else twp._I for p in params]
        assert kinds == argtypes, name
    hdr = open(os.path.join(cuda_build.CSRC_DIR, "hopper_ptx.cuh")).read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in hdr
    for src in ("window_attention_fwd_tc.cu", "window_attention_bwd_tc.cu"):
        text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
        assert '#include "window_attention_tc.cuh"' in text
        assert "mma(" in text and "fmaf(q" not in text


def test_build_kernels_builds_the_tensor_core_libraries(monkeypatch):
    """build_kernels starts one nvcc per library, all together, the two
    tensor-core libraries among them, and binds every entry it uses."""
    started, bound = [], {}

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

    def load_libraries(specs):
        started.append(sorted(specs))
        for n in specs:
            cuda_build.BUILD_LOG[n] = {"path": n, "seconds": 0.0, "log": ""}

    monkeypatch.setattr(cuda_build, "load_libraries", load_libraries)
    monkeypatch.setattr(cuda_build, "load_library",
                        lambda name, sources, defines=(): Lib(name))
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    recs = twp.build_kernels()
    assert started == [sorted(twp.library_specs())]
    assert {"window_attention_fwd_tc", "window_attention_bwd_tc"} <= set(recs)
    assert bound[("window_attention_fwd_tc",
                  "mmde_window_attention_fwd_tc")].argtypes == \
        twp._FWD_TC_ARGTYPES
    assert bound[("window_attention_bwd_tc",
                  "mmde_window_attention_bwd_tc")].argtypes == \
        twp._BWD_TC_ARGTYPES
