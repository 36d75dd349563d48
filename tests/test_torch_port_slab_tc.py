"""PyTorch port vs JAX package: the slab kernels K8' / K9' on the tensor
cores, and the slab FMA path's two-number log-sum-exp.

Slab launches (attn_impl "pallas_slab", read as "cuda_slab": every
flagship block's attention on the (B, Hp, Wp, 3C) map) run
csrc/window_attention_{fwd,bwd}_tc.cu through their slab entries: the
head-split tensor-core bodies on another address function (`MapRows`, each
window's token rows read and written in place in the map), in the TPU
kernel's function (mode "fp32", the running row maximum for every head, fp32
bias and mask tiles); bf16 maps here, fp32 maps (three bf16 pieces an
operand) in test_torch_port_fp32_slab_tc.py. Those kernels run only on the
card (chip_smoke.py, kernel_cases_slab, holds them to the plain versions,
to float64 autograd and MXU_APART times nearer the fp32 function than the
"bf16"-mode plain version). Here, on the CPU:

  * the arithmetic they rely on, emulated in plain torch
    (`mmde_tpu_torch.testing.tc_forward_heads` / `tc_backward_heads`) on the
    partitioned windows of the map, reversed into a map, is held to the JAX
    package's slab kernels (K8 / K9) in interpret mode, forward and
    backward, and lies 4x nearer them than the "bf16"-mode plain version;
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card: which entry each
    type reaches, the map's geometry, the statistic each body writes and
    its backward reads, a failed launch raising;
  * the sources and signatures of the new C entries;
  * a Python copy of `map_rows` / `MapRows::off` (the multiply-shift that
    stands for r / ws) against `window_partition`'s element offsets.

Inputs are drawn with numpy and rounded to bf16 (the qkv map and the output
gradient) before both sides get them: the premise of the exact raw product.
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

from mmde_tpu.ops import window_attention_slab as jslab
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.ops import window_attention_slab as tslab
from mmde_tpu_torch.testing import tc_backward_heads, tc_forward_heads

LN100 = math.log(100.0)
B, NH = 2, 4
C = NH * 32             # 128: one TPU head group, the flagship's stage 1
# window edge -> (window rows, window columns) of the map: ws 10 leaves a
# ragged 64-row tile (N = 100 = 64 + 36)
GRIDS = {6: (2, 3), 10: (1, 2)}


def _bf16r(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(ws, masked, seed):
    """qkv map (B, Hp, Wp, 3C) rounded to bf16; heads: 0 above the ln 100
    clamp (scale 100), 1 hot (scale 60), 2 and 3 cool (scale e^2, e^1);
    16*sigmoid bias and a 0/-100 mask, one row per window of an image in
    row-major window order (diagonal kept), both fp32; the output gradient
    map (B, Hp, Wp, C) rounded to bf16."""
    rng = np.random.default_rng(seed)
    nwh, nww = GRIDS[ws]
    Hp, Wp, N = nwh * ws, nww * ws, ws * ws
    qkv = _bf16r(rng.standard_normal((B, Hp, Wp, 3 * C)).astype(np.float32))
    ls = np.array([LN100 + 0.5, math.log(60.0), 2.0, 1.0],
                  np.float32).reshape(NH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((NH, N, N))))
            ).astype(np.float32)
    mask = None
    if masked:
        m = ((rng.random((nwh * nww, N, N)) < 0.3)
             & ~np.eye(N, dtype=bool)[None])
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = _bf16r(rng.standard_normal((B, Hp, Wp, C)).astype(np.float32))
    return qkv, ls, bias, mask, g


def _jax_slab(qkv, ls, bias, mask, nH, ws):
    """The JAX slab op (interpret mode) on the port's (nH, N, N) bias: packed
    into its head groups inside, so its gradient comes back (nH, N, N) -
    as tests/test_torch_port_slab.py calls it."""
    C_ = qkv.shape[-1] // 3
    hg, ng = jslab.slab_plan(ws, qkv.shape[2], nH, C_ // nH, C_)
    packed = jslab.pack_rpe_bias_slab(jnp.transpose(bias, (1, 2, 0)), ng, hg)
    return jslab.cosine_window_attention_slab(qkv, ls, packed, mask,
                                              num_heads=nH, window_size=ws)


def _jax_run(qkv, ls, bias, mask, g, ws):
    """K8's output map and K9's (dqkv, dlogit_scale, dbias), interpret mode,
    fp32 inputs, jitted (as the slab tests run them)."""
    m = None if mask is None else jnp.asarray(mask)

    def run(q, s, b, gg):
        out, vjp = jax.vjp(lambda q_, s_, b_: _jax_slab(q_, s_, b_, m, NH, ws),
                           q, s, b)
        return (out,) + vjp(gg)
    res = jax.jit(run)(jnp.asarray(qkv), jnp.asarray(ls), jnp.asarray(bias),
                       jnp.asarray(g))
    return [np.asarray(t) for t in res]


def _to_map(dq, dk, dv, ws, Hp, Wp):
    """Head-split (B_, nH, N, 32) gradients -> the (B, Hp, Wp, 3C) map, as
    the slab plain backward stacks them."""
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 0, 2, 4)
    return tslab.window_reverse(dqkv.reshape(-1, ws * ws, 3 * C), ws, Hp, Wp)


def _port_run(qkv, ls, bias, mask, g, ws, emulate: bool):
    """The tensor-core emulation (mode fp32, the row maximum for every head)
    or the "bf16"-mode plain version, on window_partition of the map,
    reversed: [out map, dqkv map, dlogit_scale, dbias]."""
    _, Hp, Wp, _ = qkv.shape
    qt = torch.from_numpy(qkv)
    lt, bt = torch.from_numpy(ls), torch.from_numpy(bias)
    mt = None if mask is None else torch.from_numpy(mask)
    q, k, v = tslab._heads(tslab.window_partition(qt, ws), 3, NH)
    gw = tslab._heads(tslab.window_partition(torch.from_numpy(g), ws), 1,
                      NH)[0]
    if emulate:
        o = tc_forward_heads(q, k, v, lt, bt, mt, "fp32", maxfree=False)
        dq, dk, dv, dls, dbias = tc_backward_heads(q, k, v, lt, bt, mt, gw,
                                                   "fp32")
    else:
        o = ths.cosine_window_attention_headsplit_plain(
            q, k, v, lt, bt, mt, mxu="bf16", maxfree=False)
        dq, dk, dv, dls, dbias = \
            ths.cosine_window_attention_headsplit_backward_plain(
                q, k, v, lt, bt, mt, gw, mxu="bf16")
    out = tslab.window_reverse(o.permute(0, 2, 1, 3).reshape(-1, ws * ws, C),
                               ws, Hp, Wp)
    return [t.numpy() for t in (out, _to_map(dq, dk, dv, ws, Hp, Wp), dls,
                                dbias)]


_CASES = {}


def _case(ws, masked):
    """(JAX results, emulation results, bf16-mode plain results) at one
    (ws, mask), computed once per process."""
    key = (ws, masked)
    if key not in _CASES:
        x = _inputs(ws, masked, seed=ws + masked)
        _CASES[key] = (_jax_run(*x, ws), _port_run(*x, ws, True),
                       _port_run(*x, ws, False))
    return _CASES[key]


_NAMES = ("out", "dqkv", "dlogit_scale", "dbias")
_PARAMS = pytest.mark.parametrize("ws,masked", [(6, False), (6, True),
                                                (10, False), (10, True)])


@_PARAMS
def test_emulated_body_matches_jax_slab_kernels(ws, masked):
    """The tensor-core arithmetic on the map's windows keeps K8 / K9's
    function: output and every gradient within 1e-5 of the JAX kernels'
    (max abs relative to the largest value of the JAX result, and rel-L2),
    as the head-split and packed emulations are held. dlogit_scale is
    bounded at 5e-5, as there: a sum of B_*N^2 signed terms that cancel,
    where at the hot head (scale 60) an fp32 ulp of a logit moves every p of
    its row. The clamped head's dlogit_scale is exactly zero on both
    sides."""
    jax_res, emu, _ = _case(ws, masked)
    for name, a, b in zip(_NAMES, emu, jax_res):
        a = a.reshape(b.shape)
        bound = 5e-5 if name == "dlogit_scale" else 1e-5
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert err <= bound, (name, ws, masked, err)
        assert rel_l2 <= bound, (name, ws, masked, rel_l2)
        assert float(np.abs(b).max()) > 1e-3, name
    assert float(emu[2].flatten()[0]) == 0.0
    assert float(jax_res[2].flatten()[0]) == 0.0


@_PARAMS
def test_split_keeps_the_fp32_function(ws, masked):
    """The CPU proof that the slab kernels keep K8 / K9's fp32 function on
    bf16 tensor cores: the emulation lies at least 4x nearer the JAX
    kernels' results than the port's "bf16"-mode plain version does (a body
    that rounded q^, k^, p or ds to bf16 would sit near the latter), for the
    output and every gradient."""
    jax_res, emu, rnd = _case(ws, masked)
    for name, a, r, j in zip(_NAMES, emu, rnd, jax_res):
        a, r = a.reshape(j.shape), r.reshape(j.shape)
        to_jax = float(np.linalg.norm(a - j) / np.linalg.norm(j))
        rounded = float(np.linalg.norm(r - j) / np.linalg.norm(j))
        assert rounded >= 4.0 * to_jax, (name, ws, masked, to_jax, rounded)


# --------------------------------------------------------------- routing

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrapper's CUDA branch
    runs, into the recorders below."""

    @property
    def is_cuda(self):
        return True


class _Recorder:
    """Stands in for a ctypes library: every entry point records its name
    and arguments and returns 0, or the code `fail` gives for its name."""

    def __init__(self, calls, fail):
        self._calls, self._fail = calls, fail

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)

        def fn(*args):
            self._calls.append({"entry": entry, "args": args})
            return self._fail.get(entry, 0)
        fn.argtypes = []        # bound: the wrapper leaves it as it is
        return fn


@pytest.fixture
def recorded(monkeypatch):
    calls, fail = [], {}
    lib = _Recorder(calls, fail)
    monkeypatch.setattr(twp, "_library", lambda mxu="fp32": lib)
    monkeypatch.setattr(twp, "_library_bwd", lambda: lib)
    monkeypatch.setattr(twp, "_library_tc", lambda backward: lib)
    monkeypatch.setattr(twp, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    tslab.reset_launch_counts()
    yield calls, fail
    tslab.reset_launch_counts()


def _map_inputs(dtype, ws=6, seed=3):
    qkv, ls, bias, mask, g = _inputs(ws, True, seed)
    qt = torch.from_numpy(qkv).to(dtype).as_subclass(_OnCard)
    lt, bt, mt = (torch.from_numpy(a) for a in (ls, bias, mask))
    return qt, lt, bt, mt, torch.from_numpy(g).to(dtype)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routing_follows_the_type(recorded, dtype, train):
    """Either type runs the slab tensor-core entries with the map's
    geometry (B, Hp, Wp, C, nH, ws), qkv_bf16 for the map's type (0: fp32
    operands in three bf16 pieces), fp32 bias and mask and, when training,
    the log-sum-exp its type's statistic gives - (B*nW, nH, N) for bf16,
    (2, B*nW, nH, N) hi and lo for fp32 - which the backward reads (the
    same buffer) with dbias by atomics (mode 1). The counters name the
    kernel that ran."""
    calls, _ = recorded
    qt, lt, bt, mt, gt = _map_inputs(dtype)
    kw = dict(num_heads=NH, window_size=6)
    if train:
        qt.requires_grad_()
        bt.requires_grad_()
        tslab.cosine_window_attention_slab(qt, lt, bt, mt, **kw).backward(gt)
    else:
        with torch.no_grad():
            tslab.cosine_window_attention_slab(qt, lt, bt, mt, **kw)
    bf = int(dtype == torch.bfloat16)
    want = ["mmde_window_attention_slab_fwd_tc"] + (
        ["mmde_window_attention_slab_bwd_tc"] if train else [])
    assert [c["entry"] for c in calls] == want
    geometry = [B, 12, 18, C, NH, 6]                # B, Hp, Wp, C, nH, ws
    f = calls[0]["args"]
    assert len(f) == len(tslab._FWD_TC_ARGTYPES)
    assert list(f[6:12]) == geometry
    assert list(f[12:14]) == [bf, 0]                # qkv_bf16, fp32 tiles
    assert (f[5] is not None) == train              # lse: training
    if train:
        b = calls[1]["args"]
        assert len(b) == len(tslab._BWD_TC_ARGTYPES)
        assert list(b[10:16]) == geometry
        assert list(b[16:19]) == [bf, 0, 1]         # dbias by atomics
        assert b[4] == f[5]                         # its forward's lse
    counted = {"window_attention_slab_fwd_tc" + ("+lse" if train else ""): 1}
    if train:
        counted["window_attention_slab_bwd_tc"] = 1
    assert tslab.launch_counts() == counted
    key = (B * 6, 36, C, NH)
    assert tslab.LAUNCHES == 1 and tslab.LAUNCHES_BWD == int(train)
    assert tslab.LAUNCHES_BY_SHAPE == {key: 1}
    assert tslab.LAUNCHES_BWD_BY_SHAPE == ({key: 1} if train else {})
    assert {k for k, _ in tslab.LAUNCHES_BY_KERNEL} == set(counted)


def test_statistics_take_the_body_s_shape(recorded):
    """The forward hands the backward what its body reads: (B*nW, nH, N)
    from the bf16 tensor-core forward, (2, B*nW, nH, N) (hi, lo: F3) from
    the FMA one and from the fp32 tensor-core one; a backward handed the
    other body's statistic raises before any launch."""
    calls, _ = recorded
    qt, lt, bt, mt, gt = _map_inputs(torch.bfloat16)
    _, lse = tslab._launch_forward(qt, lt, bt, mt, NH, 6, True)
    _, lse_f = tslab._launch_forward(qt, lt, bt, mt, NH, 6, True, _fma=True)
    assert tuple(lse.shape) == (B * 6, NH, 36)
    assert tuple(lse_f.shape) == (2, B * 6, NH, 36)
    q32 = qt.float().as_subclass(_OnCard)
    _, lse32 = tslab._launch_forward(q32, lt, bt, mt, NH, 6, True)
    assert tuple(lse32.shape) == (2, B * 6, NH, 36)     # fp32: F3's pair
    with pytest.raises(ValueError, match="log-sum-exp"):
        tslab._launch_backward(qt, lt, bt, mt, lse_f, gt, NH, 6, True)
    with pytest.raises(ValueError, match="log-sum-exp"):
        tslab._launch_backward(qt, lt, bt, mt, lse, gt, NH, 6, True,
                               _fma=True)
    assert [c["entry"] for c in calls] == [
        "mmde_window_attention_slab_fwd_tc",
        "mmde_window_attention_slab_fwd_stats",
        "mmde_window_attention_slab_fwd_tc"]


@pytest.mark.parametrize("dtype,fma", [(torch.float32, False),
                                       (torch.bfloat16, True)])
def test_fma_entries_get_the_hi_lo_pair(recorded, dtype, fma):
    """F3's pair, written by every slab forward that writes it - the fp32
    tensor-core forward (fp32, not `_fma`) and the FMA forward (`_fma`) -
    with statistics into a (2, B*nW, nH, N) float32 buffer - hi at its
    base, lo B*nW*nH*N floats on, as the C entries read it - and the same
    body's backward is handed that same buffer."""
    calls, _ = recorded
    qt, lt, bt, mt, gt = _map_inputs(dtype)
    q = qt.detach().as_subclass(_OnCard)
    _, lse = tslab._launch_forward(q, lt, bt, mt, NH, 6, True, _fma=fma)
    assert tuple(lse.shape) == (2, B * 6, NH, 36)
    assert lse.dtype == torch.float32 and lse.is_contiguous()
    tslab._launch_backward(q, lt, bt, mt, lse, gt, NH, 6, True, _fma=fma)
    sfx = "" if fma else "_tc"
    assert [c["entry"] for c in calls] == [
        "mmde_window_attention_slab_fwd" + (sfx or "_stats"),
        "mmde_window_attention_slab_bwd" + sfx]
    assert calls[0]["args"][5] == calls[1]["args"][4] == lse.data_ptr()


def test_private_fma_argument_reaches_the_fma_entries(recorded):
    """`_fma` sends a bf16 launch to the FMA entries (qkv_bf16 set), through
    the autograd Function's ctx too: its backward takes the body its forward
    took and reads the pair that forward wrote. It is not reachable from the
    public wrapper."""
    import inspect
    calls, _ = recorded
    qt, lt, bt, mt, gt = _map_inputs(torch.bfloat16)
    qt.requires_grad_()
    out = tslab._SlabWindowAttention.apply(qt, lt, bt, mt, NH, 6, True)
    out.backward(gt)
    with torch.no_grad():
        tslab._launch_forward(qt, lt, bt, mt, NH, 6, False, _fma=True)
    assert [c["entry"] for c in calls] == [
        "mmde_window_attention_slab_fwd_stats",
        "mmde_window_attention_slab_bwd",
        "mmde_window_attention_slab_fwd"]
    f, b = calls[0]["args"], calls[1]["args"]
    assert f[-3] == 1 and b[-4] == 1                # qkv_bf16
    assert b[4] == f[5]                             # the pair it wrote
    assert tslab.launch_counts() == {"window_attention_slab_bwd": 1,
                                     "window_attention_slab_fwd": 1,
                                     "window_attention_slab_fwd+lse": 1}
    public = inspect.signature(tslab.cosine_window_attention_slab).parameters
    assert not any(p.startswith("_") for p in public)
    for fn in (tslab._launch_forward, tslab._launch_backward):
        private = [p for p in inspect.signature(fn).parameters
                   if p.startswith("_")]
        assert private == ["_fma"]


@pytest.mark.parametrize("entry,dtype,counted", [
    ("mmde_window_attention_slab_fwd_tc", torch.bfloat16, {}),
    ("mmde_window_attention_slab_bwd_tc", torch.bfloat16,
     {"window_attention_slab_fwd_tc+lse": 1}),
    ("mmde_window_attention_slab_bwd_tc", torch.float32,
     {"window_attention_slab_fwd_tc+lse": 1})])
def test_failed_launch_raises(recorded, entry, dtype, counted):
    """A nonzero return (the C entries' -1 for arguments they refuse, or a
    CUDA error) raises RuntimeError naming the entry and code; nothing falls
    back to another body or to the plain version, and the failed launch is
    not counted."""
    calls, fail = recorded
    fail[entry] = -1
    qt, lt, bt, mt, gt = _map_inputs(dtype)
    qt.requires_grad_()
    with pytest.raises(RuntimeError,
                       match=f"{entry} launch failed with code -1"):
        out = tslab.cosine_window_attention_slab(qt, lt, bt, mt,
                                                 num_heads=NH, window_size=6)
        out.backward(gt)
    assert calls[-1]["entry"] == entry
    assert tslab.launch_counts() == counted


def test_tensor_core_rule_is_the_packed_one():
    """Slab launches take the tensor cores by the packed module's rule
    (`slab_tensor_core_body`): bf16 and fp32 maps, as the packed and
    head-split rules take both types; only the private `_fma` reaches the
    FMA body."""
    for dtype in (torch.bfloat16, torch.float32):
        assert tslab._tc(torch.empty(1, dtype=dtype), False)
        assert not tslab._tc(torch.empty(1, dtype=dtype), True)
        assert twp.slab_tensor_core_body(dtype)
        assert twp.slab_tensor_core_body(dtype) == \
            twp.headsplit_tensor_core_body(dtype)
    assert not twp.slab_tensor_core_body(torch.float16)


# ------------------------------------------------------- sources and build

def _src(name: str) -> str:
    return open(os.path.join(cuda_build.CSRC_DIR, name)).read()


def _entries(src: str) -> dict:
    return {m.group(1): (m.group(2), m.group(3))
            for m in re.finditer(
                r'extern "C" int (\w+)\((.*?)\)\s*{(.*?)\n}', _src(src),
                re.S)}


@pytest.mark.parametrize("entry,src,argtypes", [
    ("mmde_window_attention_slab_fwd_tc", "window_attention_fwd_tc.cu",
     "_FWD_TC_ARGTYPES"),
    ("mmde_window_attention_slab_bwd_tc", "window_attention_bwd_tc.cu",
     "_BWD_TC_ARGTYPES")])
def test_tensor_core_entries_and_signatures(entry, src, argtypes):
    """No compiler here: the slab tensor-core entries live in the
    tensor-core libraries the model's build already holds (no new library),
    every ctypes argument type matches its C parameter (pointers c_void_p,
    ints c_int), the geometry is the FMA slab entries' (B, Hp, Wp, C, nH,
    ws), then qkv_bf16 and bias_bf16 as there, with their shape checks
    (whole windows, N * ws < 2^32 for the multiply-shift, at most 65535
    windows) and a bf16 bias refused for an fp32 map; each type goes to the
    file's `launch_slab`, whose every operand is a map_rows layout and whose
    body runs mode MXU_FP32 (the forward with maxfree 0: the TPU kernel's
    function)."""
    params, body = _entries(src)[entry]
    params = [p.strip() for p in params.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert kinds == getattr(tslab, argtypes)
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[names.index("B"):names.index("ws") + 1] == [
        "B", "Hp", "Wp", "C", "nH", "ws"]
    assert names[-4 if "bwd" in entry else -3:-1] == (
        ["qkv_bf16", "bias_bf16", "dbias_mode"] if "bwd" in entry
        else ["qkv_bf16", "bias_bf16"])
    assert "Hp % ws != 0 || Wp % ws != 0" in body
    assert "N * ws >= (1ll << 32)" in body and "> 65535" in body
    assert "ws * Wp >= (1ll << 31)" in body
    assert "if (!qkv_bf16 && bias_bf16) return -1;" in body
    assert [m.group(1) for m in re.finditer(r"launch_slab<(\w+, \w+)>",
                                            body)] == [
        "float, float", "bf16, bf16", "bf16, float"]
    text = _src(src)
    helper = re.search(r"\nint launch_slab\((.*?)\n}", text, re.S).group(1)
    n_maps = 7 if "bwd" in entry else 4       # q, k, v, (g,) out / dq, dk, dv
    assert helper.count("map_rows(") == n_maps
    assert "launch<MapRows, T, TB, MXU_FP32>" in helper
    assert "MXU_FOLD" not in helper
    if "fwd" in entry:      # launch<MapRows, T, TB, MXU_FP32>(..., 0, stream)
        assert re.search(r",\s+0, stream\);", helper)
    lib = "window_attention_bwd_tc" if "bwd" in entry else \
        "window_attention_fwd_tc"
    assert twp.library_specs()[lib] == ((src,), ())


@pytest.mark.parametrize("src,kernels", [
    ("window_attention_fwd_tc.cu", ("fwd_tc_kernel",)),
    ("window_attention_bwd_tc.cu", ("bwd_dq_tc_kernel", "bwd_dkv_tc_kernel"))])
def test_kernels_are_templated_on_the_layout(src, kernels):
    """The one-window tensor-core kernels take the operands' layout (and
    their type) as template parameters (Rows for the packed and head-split
    entries, MapRows for the slab one: one body), and so does the host
    launch; K5's W kernels stay on Rows (the slab path has no W option)."""
    text = _src(src)
    for k in kernels:
        assert re.search(r"template <template <typename> class L, typename "
                         r"T, typename TB, int MXU>\n__global__ void "
                         r"__launch_bounds__\(TC_NT\)\n%s\(L<const T> q" % k,
                         text), k
    assert re.search(r"template <template <typename> class L, typename T, "
                     r"typename TB, int MXU>\nint launch\(", text)
    assert "launch<MapRows" in text and "launch<Rows" in text
    assert not re.search(r"_w_kernel\(L<", text)
    # the tile loads read the block's table (MapRows; Rows ignores it),
    # filled for the first two tiles before the first load
    assert len(re.findall(r"load_tile\(s[KVQG]\[st\], \w+, \w, sTab\[st\]",
                          text)) == 2 * len(kernels)
    assert text.count("if constexpr (TAB) fill(") == len(kernels)


# ---------------------------------------------------- the map's addressing

def _map_rows(part, C_, parts, Hp, Wp, ws, dh=32):
    """map_rows (csrc/window_attention_common.cuh), in Python: element
    strides of pixel, map row, image and head, the windows per window row
    and per image, and ceil(2^32 / ws)."""
    s = parts * C_
    rs = Wp * s
    return dict(base=part * C_, s=s, rs=rs, si=Hp * rs, sh=dh, ws=ws,
                nww=Wp // ws, nW=(Hp // ws) * (Wp // ws), wp=Wp,
                inv_ws=((1 << 32) + ws - 1) // ws)


def _head(m, b, h):
    img = b // m["nW"]
    w = b - img * m["nW"]
    wi = w // m["nww"]
    wj = w - wi * m["nww"]
    return (m["base"] + img * m["si"] + wi * m["ws"] * m["rs"]
            + wj * m["ws"] * m["s"] + h * m["sh"])


def _off(m, r):
    """MapRows::off: r / ws as a 64-bit multiply by inv_ws and a shift."""
    t = ((r * m["inv_ws"]) & ((1 << 64) - 1)) >> 32
    return t * m["rs"] + (r - t * m["ws"]) * m["s"]


def _pix(m, r):
    """MapRows::pix, the tensor-core kernels' tile tables: the pixel from
    the window's corner, off(r) = pix(r) * s."""
    t = ((r * m["inv_ws"]) & ((1 << 64) - 1)) >> 32
    return t * m["wp"] + (r - t * m["ws"])


@pytest.mark.parametrize("ws", [6, 10, 15, 30])
def test_map_rows_give_window_partition_offsets(ws):
    """Token r of head h of window b sits at MapRows::head(b, h) + off(r) of
    the map: the element window_partition puts at (b, r, part*C + h*32) -
    for q, k, v of the (B, Hp, Wp, 3C) map and the (.., C) output map, at
    the flagship's window edges (30; 15 at stage 4) and the tests' (6, 10).
    The multiply-shift is r / ws for every r < N, and a tile table's pixel
    times the operand's pixel stride is its offset."""
    hdr = _src("window_attention_common.cuh")
    assert "m.inv_ws = ((1ull << 32) + ws - 1) / ws;" in hdr
    assert hdr.count("(int)(((unsigned long long)r * inv_ws) >> 32)") == 2
    assert "return t * rs + (size_t)(r - t * ws) * s;" in hdr.replace(
        "(size_t)t * rs", "t * rs")
    assert "return t * wp + (r - t * ws);" in hdr and "m.wp = Wp;" in hdr
    assert "(size_t)tab[r] * rows.s" in _src("window_attention_tc.cuh")
    Hp, Wp, nH = 2 * ws, 3 * ws, 2
    N, C_ = ws * ws, nH * 32
    r = np.arange(N, dtype=np.int64)
    m0 = _map_rows(0, C_, 3, Hp, Wp, ws)
    assert all(((int(x) * m0["inv_ws"]) >> 32) == int(x) // ws for x in r)
    for parts in (3, 1):
        idx = torch.arange(B * Hp * Wp * parts * C_).reshape(
            B, Hp, Wp, parts * C_)
        win = tslab._heads(tslab.window_partition(idx, ws), parts, nH)
        for part in range(parts):
            m = _map_rows(part, C_, parts, Hp, Wp, ws)
            offs = np.array([_off(m, int(x)) for x in r])
            assert all(_pix(m, int(x)) * m["s"] == o for x, o in zip(r, offs))
            for b in range(win.shape[1]):
                for h in range(nH):
                    got = _head(m, b, h) + offs
                    want = win[part, b, h, :, 0].numpy()
                    np.testing.assert_array_equal(got, want)
