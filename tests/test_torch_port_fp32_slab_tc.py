"""PyTorch port vs JAX package: K8' / K9' (the slab path) for fp32 maps on
the tensor cores.

Every fp32 slab launch - attn_impl "pallas_slab" (read as "cuda_slab") in
the JAX package's default type: the flagship's 24 blocks, swin_large's
stages 2-4 - now runs the packed fp32 instantiation's arithmetic of
csrc/window_attention_{fwd,bwd}_tc.cu (`fwd_tc_kernel`, `bwd_dq_tc_kernel`,
`bwd_dkv_tc_kernel` on float `MapRows`) through the slab entries: every
operand in three bf16 pieces, the map's fp32 tiles staged through the
block's table of the tile's pixels, the statistic hi + lo formed in fp64
(F3), the TPU kernel's function (mode "fp32", the running row maximum for
every head, fp32 bias and mask). Those kernels run only on the card
(chip_smoke.py's kernel_cases_slab holds them to the plain versions, float64
autograd and the scale-60 F3 case). Here, on the CPU:

  * their arithmetic, emulated in plain torch (mmde_tpu_torch/testing.py,
    `pieces=3`, mode "fp32", the running maximum) on `window_partition` of
    unrounded fp32 maps drawn with numpy, reversed into maps, is held to
    the JAX package's slab op (K8 / K9) in interpret mode, masked and
    unmasked, at ws 6 and 10 (N 100: a ragged 64-row tile), with heads
    above the ln 100 clamp, at scale 60 and cool;
  * the wrapper's routing, read off with the libraries replaced by
    recorders and a tensor that says it is on the card: fp32 to the
    tensor-core slab entries with qkv_bf16 0, a (2, B*nW, nH, N) statistic
    tagged with its body, `_fma` (and the autograd Function's private
    argument) to the FMA entries, a backward handed the other body's
    statistic refusing it before any launch;
  * the sources: no fp32-layout assert left, both slab entries instantiate
    the float `MapRows` kernels, the fp32 tile loads read the table.

The slab layout needs C % 128 == 0 (`slab_plan`): the maps here are the
bf16 file's, nH 4, C 128, two images.
"""
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

from test_torch_port_slab_tc import (B, C, GRIDS, NH, _jax_run, _OnCard,
                                     _to_map, recorded)

LN100 = math.log(100.0)
_NAMES = ("out", "dqkv", "dlogit_scale", "dbias")
# the card's fp32 limits (chip_smoke.py: TOL_FP32_MAX_ABS, TOL_BWD)
TOL_FWD_MAX_ABS = 5e-5
TOL_REL_L2 = {"out": 2e-5, "dqkv": 2e-5, "dbias": 2e-5, "dlogit_scale": 2e-4}


def _inputs(ws, masked, seed):
    """An unrounded fp32 qkv map (B, Hp, Wp, 3C); heads: 0 above the ln 100
    clamp, 1 hot (scale 60), 2 and 3 cool (scale e^2, e^1); 16*sigmoid
    bias and a 0/-100 mask, one row per window of an image in row-major
    window order (diagonal kept), both fp32; the output gradient map
    (B, Hp, Wp, C), unrounded."""
    rng = np.random.default_rng(seed)
    nwh, nww = GRIDS[ws]
    Hp, Wp, N = nwh * ws, nww * ws, ws * ws
    qkv = rng.standard_normal((B, Hp, Wp, 3 * C)).astype(np.float32)
    ls = np.array([LN100 + 0.5, math.log(60.0), 2.0, 1.0],
                  np.float32).reshape(NH, 1, 1)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((NH, N, N))))
            ).astype(np.float32)
    mask = None
    if masked:
        m = ((rng.random((nwh * nww, N, N)) < 0.3)
             & ~np.eye(N, dtype=bool)[None])
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, Hp, Wp, C)).astype(np.float32)
    return qkv, ls, bias, mask, g


def _port_run(qkv, ls, bias, mask, g, ws, emulate: bool):
    """The three-piece tensor-core emulation (mode "fp32", the row maximum
    for every head) or the "bf16"-mode plain version, on window_partition
    of the map, reversed: [out map, dqkv map, dlogit_scale, dbias]."""
    _, Hp, Wp, _ = qkv.shape
    lt, bt = torch.from_numpy(ls), torch.from_numpy(bias)
    mt = None if mask is None else torch.from_numpy(mask)
    q, k, v = tslab._heads(tslab.window_partition(torch.from_numpy(qkv), ws),
                           3, NH)
    gw = tslab._heads(tslab.window_partition(torch.from_numpy(g), ws), 1,
                      NH)[0]
    if emulate:
        o = tc_forward_heads(q, k, v, lt, bt, mt, "fp32", maxfree=False,
                             pieces=3)
        dq, dk, dv, dls, dbias = tc_backward_heads(q, k, v, lt, bt, mt, gw,
                                                   "fp32", pieces=3)
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
    """(JAX results, three-piece emulation results, inputs) at one (ws,
    mask), computed once per process."""
    key = (ws, masked)
    if key not in _CASES:
        x = _inputs(ws, masked, seed=500 + ws + masked)
        _CASES[key] = (_jax_run(*x, ws), _port_run(*x, ws, True), x)
    return _CASES[key]


@pytest.mark.parametrize("ws,masked", [(6, False), (6, True), (10, False),
                                       (10, True)])
def test_fp32_slab_emulation_matches_jax(ws, masked):
    """The fp32 tensor-core arithmetic on the map's windows (three bf16
    pieces an operand, mode "fp32", the running maximum) keeps K8 / K9's
    function on unrounded fp32 maps, at the card's fp32 limits: the output
    within 5e-5 max abs (relative to the JAX result's largest value) and
    2e-5 rel-L2, dqkv and dbias within 2e-5 rel-L2, dlogit_scale within
    2e-4. The clamped head's dlogit_scale is exactly zero on both sides."""
    jax_res, emu, _ = _case(ws, masked)
    for name, a, b in zip(_NAMES, emu, jax_res):
        a = a.reshape(b.shape)
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert rel_l2 <= TOL_REL_L2[name], (name, ws, masked, rel_l2)
        assert float(np.abs(b).max()) > 1e-3, name
    out_err = float(np.abs(emu[0] - jax_res[0]).max()) / float(
        np.abs(jax_res[0]).max())
    assert out_err <= TOL_FWD_MAX_ABS, (ws, masked, out_err)
    assert float(emu[2].flatten()[0]) == 0.0
    assert float(jax_res[2].flatten()[0]) == 0.0


def test_fp32_slab_emulation_is_apart_from_the_bf16_mode():
    """The check chip_smoke.py puts on the fp32 slab kernels (MXU_APART):
    the three-piece arithmetic lies at least 4x nearer the JAX kernels'
    result than the "bf16"-mode plain version on the same maps, for the
    output and every gradient - a body that rounded its operands once
    would not."""
    jax_res, emu, x = _case(10, True)
    rnd = _port_run(*x, 10, False)
    for name, a, r, j in zip(_NAMES, emu, rnd, jax_res):
        a, r = a.reshape(j.shape), r.reshape(j.shape)
        to_jax = float(np.linalg.norm(a - j) / np.linalg.norm(j))
        rounded = float(np.linalg.norm(r - j) / np.linalg.norm(j))
        assert rounded >= 4.0 * to_jax, (name, to_jax, rounded)


# --------------------------------------------------------------- routing

def _map_inputs(seed=3, ws=6):
    qkv, ls, bias, mask, g = _inputs(ws, True, seed)
    qt = torch.from_numpy(qkv).as_subclass(_OnCard)
    lt, bt, mt = (torch.from_numpy(a) for a in (ls, bias, mask))
    return qt, lt, bt, mt, torch.from_numpy(g)


def test_fp32_statistic_carries_its_body(recorded):
    """Both fp32 bodies write a (2, B*nW, nH, N) statistic (hi, lo), so the
    shape no longer tells them apart: each carries the body that wrote it
    (`written_by`), the tensor-core forward through the `_tc` entry with
    qkv_bf16 0, the FMA one (`_fma`) through its `_stats` entry. A backward
    handed the other body's statistic raises before any launch; one made
    elsewhere (no tag) is taken."""
    calls, _ = recorded
    qt, lt, bt, mt, gt = _map_inputs()
    _, lse = tslab._launch_forward(qt, lt, bt, mt, NH, 6, True)
    _, lse_f = tslab._launch_forward(qt, lt, bt, mt, NH, 6, True, _fma=True)
    assert tuple(lse.shape) == tuple(lse_f.shape) == (2, B * 6, NH, 36)
    assert lse.written_by == "tensor-core" and lse_f.written_by == "FMA"
    assert [c["entry"] for c in calls] == [
        "mmde_window_attention_slab_fwd_tc",
        "mmde_window_attention_slab_fwd_stats"]
    assert calls[0]["args"][-3] == 0 and calls[1]["args"][-3] == 0
    calls.clear()
    with pytest.raises(ValueError, match="FMA forward wrote"):
        tslab._launch_backward(qt, lt, bt, mt, lse_f, gt, NH, 6, True)
    with pytest.raises(ValueError, match="tensor-core forward wrote"):
        tslab._launch_backward(qt, lt, bt, mt, lse, gt, NH, 6, True,
                               _fma=True)
    with pytest.raises(ValueError, match=r"\(2, 12, 4, 36\) log-sum-exp"):
        tslab._launch_backward(qt, lt, bt, mt, lse[0], gt, NH, 6, True)
    assert calls == []
    tslab._launch_backward(qt, lt, bt, mt, lse.clone(), gt, NH, 6, True)
    assert [c["entry"] for c in calls] == [
        "mmde_window_attention_slab_bwd_tc"]
    assert calls[0]["args"][-4] == 0                  # qkv_bf16


@pytest.mark.parametrize("fma", [False, True])
def test_autograd_function_hands_its_body_on(recorded, fma):
    """The autograd Function's backward takes the body its forward took
    (the private last argument): fp32 forward and backward on the tensor
    cores, or both on the FMA bodies, the backward reading the statistic
    its forward wrote, qkv_bf16 0 on both; the public wrapper takes the
    tensor cores."""
    calls, _ = recorded
    qt, lt, bt, mt, gt = _map_inputs()
    qt.requires_grad_()
    if fma:
        out = tslab._SlabWindowAttention.apply(qt, lt, bt, mt, NH, 6, True)
    else:
        out = tslab.cosine_window_attention_slab(qt, lt, bt, mt,
                                                 num_heads=NH, window_size=6)
    out.backward(gt)
    sfx = "" if fma else "_tc"
    assert [c["entry"] for c in calls] == [
        "mmde_window_attention_slab_fwd" + (sfx or "_stats"),
        "mmde_window_attention_slab_bwd" + sfx]
    f, b = calls[0]["args"], calls[1]["args"]
    assert f[-3] == 0 and b[-4] == 0                # fp32 maps
    assert b[4] == f[5]                             # its forward's lse
    assert tslab.launch_counts() == {
        f"window_attention_slab_bwd{sfx}": 1,
        f"window_attention_slab_fwd{sfx}+lse": 1}


def test_fp32_map_refuses_a_bf16_bias():
    """The fp32 instantiation streams fp32 bias and mask (the C entries
    refuse bias_bf16 with qkv_bf16 0): the wrapper raises before any launch
    for a bf16 bias beside an fp32 map."""
    qt, lt, bt, mt, _ = _map_inputs()
    with pytest.raises(TypeError, match="bias must be float32"):
        tslab.cosine_window_attention_slab(
            qt, lt, bt.bfloat16(), mt.bfloat16(), num_heads=NH,
            window_size=6)


def test_occupancy_asks_both_libraries(recorded):
    """`occupancy` (chip_smoke.py's env line) asks the forward and the
    backward tensor-core library for the blocks an SM holds at the slab
    entries' launch, with the map's type as qkv_bf16 and the mask flag, and
    raises on a nonzero code rather than report a count it did not get."""
    calls, fail = recorded
    got = tslab.occupancy(torch.float32, True)
    assert got == {"fwd": 0, "dq": 0, "dkv": 0}    # the recorder writes none
    assert [(c["entry"], c["args"][:2]) for c in calls] == [
        ("mmde_window_attention_slab_fwd_tc_occupancy", (0, 1)),
        ("mmde_window_attention_slab_bwd_tc_occupancy", (0, 1))]
    fail["mmde_window_attention_slab_bwd_tc_occupancy"] = 1
    with pytest.raises(RuntimeError, match="occupancy query failed"):
        tslab.occupancy(torch.bfloat16, False)
    assert calls[-1]["args"][:2] == (1, 0)


# ------------------------------------------------------- sources and build

def _src(name: str) -> str:
    return open(os.path.join(cuda_build.CSRC_DIR, name)).read()


def test_no_fp32_layout_assert_is_left():
    """The three asserts that kept fp32 operands off the map's layout
    (forward, dq pass, dk/dv pass) are gone from every source: the float
    `MapRows` instantiation compiles."""
    for name in sorted(os.listdir(cuda_build.CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            assert "static_assert(!(F32 && TAB)" not in _src(name), name


@pytest.mark.parametrize("src,entry", [
    ("window_attention_fwd_tc.cu", "mmde_window_attention_slab_fwd_tc"),
    ("window_attention_bwd_tc.cu", "mmde_window_attention_slab_bwd_tc")])
def test_slab_entries_instantiate_the_fp32_map_kernels(src, entry):
    """Each slab entry sends qkv_bf16 0 to `launch_slab<float, float>`,
    which launches `launch<MapRows, T, TB, MXU_FP32>`: the float `MapRows`
    instantiation of the kernels (fwd_tc_kernel; bwd_dq_tc_kernel and
    bwd_dkv_tc_kernel), before the bf16 branches."""
    text = _src(src)
    body = re.search(r'extern "C" int %s\((.*?)\)\s*{(.*?)\n}' % entry, text,
                     re.S).group(2)
    fp32 = re.search(r"if \(!qkv_bf16\)\n\s+return launch_slab<float, "
                     r"float>\(", body)
    assert fp32 and fp32.start() < body.index("launch_slab<bf16")
    helper = re.search(r"\nint launch_slab\((.*?)\n}", text, re.S).group(1)
    assert "launch<MapRows, T, TB, MXU_FP32>" in helper
    kernels = (("fwd_tc_kernel",) if "fwd" in src
               else ("bwd_dq_tc_kernel", "bwd_dkv_tc_kernel"))
    for k in kernels:
        assert f"{k}<L, T, TB, MXU>" in text


@pytest.mark.parametrize("src,entry,argtypes", [
    ("window_attention_fwd_tc.cu",
     "mmde_window_attention_slab_fwd_tc_occupancy", "_FWD_OCC_ARGTYPES"),
    ("window_attention_bwd_tc.cu",
     "mmde_window_attention_slab_bwd_tc_occupancy", "_BWD_OCC_ARGTYPES")])
def test_occupancy_entries_match_their_argtypes(src, entry, argtypes):
    """The occupancy queries' C parameters against their ctypes argument
    types (int -> c_int, int* -> c_void_p); each asks the CUDA occupancy
    calculator about the float and bf16 `MapRows` instantiations the slab
    entries launch, at their block size and dynamic shared memory."""
    m = re.search(r'extern "C" int %s\((.*?)\)\s*{(.*?)\n}' % entry,
                  _src(src), re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kinds == getattr(tslab, argtypes)
    body = m.group(2)
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in body
    assert "<MapRows, T, float, MXU_FP32>" in body and "TC_NT" in body
    assert "query(bf16()) : query(0.0f)" in body


def test_fp32_tiles_load_through_the_table():
    """The fp32 branches of the three one-window kernels stage their
    streamed tiles (K and V; Q and G) by `load_tile_f32` with the stage's
    table, as the bf16 branches call `load_tile`: `MapRows` reads each row
    at tab[r] * s (its own overload), `Rows` ignores the table and keeps
    its loads (the overload forwards to the table-free form). The block's
    own fp32 rows come through `load_afrag_f32`'s `MapRows` overload, one
    pixel offset a row (pix(r) * s, which equals off(r):
    test_torch_port_slab_tc.py's map test). F3's two rules stay in the
    template the float `MapRows` kernels share."""
    fwd, bwd = _src("window_attention_fwd_tc.cu"), _src(
        "window_attention_bwd_tc.cu")
    loads = r"load_tile_f32\(sStg[ +\w]*, \w_bh, \w, sTab\[st\], \w+, N, tid\)"
    assert len(re.findall(loads, fwd)) == 2
    assert len(re.findall(loads, bwd)) == 4
    hdr = _src("window_attention_tc.cuh")
    over = re.search(r"load_tile_f32\(float\* s, const float\* base,\s+"
                     r"const MapRows<T>& rows,\s+const int\* tab,(.*?)\n}",
                     hdr, re.S)
    assert over and "(size_t)tab[r] * rows.s" in over.group(1)
    generic = re.search(r"const L& rows, const int\* tab,\s+int r0, int N, "
                        r"int tid\) \{\n\s+load_tile_f32\(s, base, rows, r0, "
                        r"N, tid\);", hdr)
    assert generic
    own = re.search(r"load_afrag_f32\(float2 \(&x\)\[2\]\[4\],\s+const "
                    r"float\* base,\s+const MapRows<T>& rows,(.*?)\n}", hdr,
                    re.S)
    assert own and own.group(1).count("rows.pix(") == 2
    assert "rows.off(" not in own.group(1)
    assert "ex2((s[j][0] - m0) * TC_LOG2E)" in fwd
    assert "dls_t = fmaf(d, sc - hi2[e], dls_t)" in bwd
