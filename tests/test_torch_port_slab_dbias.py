"""PyTorch port: K3 over `MapRows`, the slab path's deterministic dbias.

Under MMDE_ATTN_GRID=split and in deterministic mode
(`torch.use_deterministic_algorithms(True)`), both read at each call, the
slab backward runs its tensor-core passes without dbias atomics and then
`bwd_dbias_tc_kernel` instantiated over `MapRows`
(`mmde_window_attention_slab_dbias_tc`): each window's rows read in place
off the (B, Hp, Wp, 3C) map, dbias summed window after window in one fixed
order, type-major where masked - the same bits on every run, as the JAX
slab kernel's resident dbias block gives them. The kernel runs only on the
card (chip_smoke.py holds it to the plain backward, float64 and bitwise
over two launches). Here, on the CPU:

  * its arithmetic (`testing.tc_dbias` on the map's windows, the order
    `dbias_order` over the map's image-major, row-major windows whose mask
    row is b % nW) against the plain slab backward's dbias and the JAX slab
    kernel's (interpret mode), bf16 and fp32 maps;
  * the routing (`dbias_split`) with the launches replaced by recorders:
    split, deterministic, the FMA partner, dbias not wanted;
  * the C entry's signature and checks, and the kernel source's table.
"""
import contextlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops import window_attention_slab as jslab
from mmde_tpu_torch import testing
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as wap
from mmde_tpu_torch.ops import window_attention_slab as was


def _inputs(dtype, seed, masked=True, ws=6, nH=4, B=2, Hw=2, Ww=3):
    rng = np.random.default_rng(seed)
    C, N = nH * 32, ws * ws
    qkv = rng.standard_normal((B, Hw * ws, Ww * ws, 3 * C)).astype(np.float32)
    g = rng.standard_normal((B, Hw * ws, Ww * ws, C)).astype(np.float32)
    if dtype == "bf16":      # the map's values as a bf16 model holds them
        qkv = torch.from_numpy(qkv).bfloat16().float().numpy()
        g = torch.from_numpy(g).bfloat16().float().numpy()
    ls = np.minimum(rng.normal(1.5, 0.5, (nH, 1, 1)),
                    testing.MAX_TEST_LOGIT_SCALE).astype(np.float32)
    bias = (16 / (1 + np.exp(-rng.standard_normal((nH, N, N))))).astype(
        np.float32)
    mask = None
    if masked:
        m = rng.random((Hw * Ww, N, N)) < 0.3
        mask = np.where(m & ~np.eye(N, dtype=bool), -100.0, 0.0).astype(
            np.float32)
    return qkv, g, ls, bias, mask, nH, ws


def _emulated(qkv, g, ls, bias, mask, nH, ws, dtype):
    """testing.tc_dbias on the map's windows, in the packed layout."""
    qw = was.window_partition(torch.from_numpy(qkv), ws).numpy()
    gw = was.window_partition(torch.from_numpy(g), ws).numpy()
    return testing.tc_dbias(qw, ls, bias, mask, gw, nH, "fp32",
                            pieces=3 if dtype == "fp32" else 0)


@pytest.mark.parametrize("dtype,masked,jax_too", [
    ("bf16", True, True), ("fp32", True, True), ("fp32", False, False)])
def test_emulated_k3_over_map_rows_matches_plain_and_jax(dtype, masked,
                                                         jax_too):
    """dbias as K3 over MapRows computes it against the plain slab
    backward's (fp32 function; the card's TOL_BWD dbias limits, rel-L2) and,
    masked, against the JAX slab kernel's resident dbias block in
    interpret mode."""
    qkv, g, ls, bias, mask, nH, ws = _inputs(dtype, seed=3, masked=masked)
    got = _emulated(qkv, g, ls, bias, mask, nH, ws, dtype)
    t = [None if a is None else torch.from_numpy(a)
         for a in (qkv, ls, bias, mask, g)]
    plain = was.cosine_window_attention_slab_backward_plain(
        t[0], t[1], t[2], t[3], t[4], num_heads=nH, window_size=ws)[2]
    tol = 2e-5 if dtype == "fp32" else 4e-3
    rel = float((got - plain).norm() / plain.norm())
    assert rel <= tol, rel
    assert float(plain.abs().max()) > 1e-3          # not a vacuous dbias
    if not jax_too:
        return

    def loss(b):     # the JAX kernel takes the head-group-packed bias
        packed = jslab.pack_rpe_bias_slab(jnp.transpose(b, (1, 2, 0)),
                                          1, nH)
        out = jslab.cosine_window_attention_slab(
            jnp.asarray(qkv), jnp.asarray(ls), packed,
            None if mask is None else jnp.asarray(mask), num_heads=nH,
            window_size=ws, interpret=True)
        return jnp.sum(out * jnp.asarray(g))
    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(bias)))
    rel_j = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert rel_j <= tol, rel_j


def test_map_windows_sum_type_major():
    """The map's windows (image-major, row-major; mask row b % nW) are
    summed type-major where masked: window type outer, image inner - the
    emulation's dbias is bitwise that order's window-after-window sum."""
    qkv, g, ls, bias, mask, nH, ws = _inputs("bf16", seed=5)
    assert testing.dbias_order(12, 6) == [0, 6, 1, 7, 2, 8, 3, 9, 4, 10, 5,
                                          11]
    qw = was.window_partition(torch.from_numpy(qkv), ws)
    assert qw.shape[0] == 12                       # 2 images x 6 windows
    got = _emulated(qkv, g, ls, bias, mask, nH, ws, "bf16")
    q, k, v = testing._packed_heads(qw.numpy(), nH)
    gw = was.window_partition(torch.from_numpy(g), ws)
    gh = gw.reshape(12, ws * ws, nH, 32).permute(0, 2, 1, 3)
    lt, bt, mt = (torch.from_numpy(a) for a in (ls, bias, mask))
    s = testing._logits(q, k, lt, bt, mt, "fp32")[0]
    p = torch.softmax(s, dim=-1)
    dp = testing._dp(gh, v, "fp32", 0)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    acc = ds[0]
    for b in testing.dbias_order(12, 6)[1:]:
        acc = acc + ds[b]
    assert torch.equal(got, acc)


def _recorders(monkeypatch):
    seen = []

    def passes(qkv, ls, bias, mask, lse, g, nH, ws, atomics, tc):
        seen.append(("passes", atomics, tc))
        B, Hp, Wp, _ = qkv.shape
        N = ws * ws
        return (torch.zeros_like(qkv), torch.zeros(nH, 1, 1),
                torch.zeros(nH, N, N) if atomics else None,
                torch.zeros(B * (Hp // ws) * (Wp // ws), nH, N))

    def dbias(*a):
        seen.append(("k3",))
        return torch.ones(a[7], a[8] ** 2, a[8] ** 2)

    monkeypatch.setattr(was, "_backward_passes", passes)
    monkeypatch.setattr(was, "_launch_dbias", dbias)
    return seen


@pytest.mark.parametrize("grid,det,fma,want_dbias,k3", [
    ("window_resident", False, False, True, False),
    ("split", False, False, True, True),
    ("window_resident", True, False, True, True),
    ("bias_resident", True, False, True, True),
    ("split", True, True, True, False),          # the FMA partner: atomics
    ("split", True, False, False, False),        # no dbias wanted
])
def test_routing_reads_grid_and_deterministic_mode_at_each_call(
        monkeypatch, grid, det, fma, want_dbias, k3):
    """`dbias_split` (the head-split rule, read at each call): K3 after
    atomics-free passes under "split" and in deterministic mode; the atomics
    otherwise, and always for the FMA partner."""
    seen = _recorders(monkeypatch)
    monkeypatch.setattr(wap, "DEFAULT_GRID_MODE", grid)
    was_on = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(det)
        assert was.dbias_split(fma) == ((grid == "split" or det) and not fma)
        assert ths.dbias_split() == (grid == "split" or det)
        nH, ws = 4, 6
        qkv = torch.zeros(1, 12, 6, 3 * nH * 32)
        lse = torch.zeros((2, 2, nH, ws * ws))     # fp32: hi + lo
        out = was._launch_backward(qkv, torch.zeros(nH, 1, 1),
                                   torch.zeros(nH, ws * ws, ws * ws), None,
                                   lse, torch.zeros(1, 12, 6, nH * 32), nH,
                                   ws, want_dbias, _fma=fma)
    finally:
        torch.use_deterministic_algorithms(was_on)
    assert seen[0] == ("passes", want_dbias and not k3, not fma)
    assert (("k3",) in seen) == k3
    if want_dbias:
        assert float(out[2].sum()) == (nH * ws ** 4 if k3 else 0.0)


def test_k3_statistic_rule_and_launch(monkeypatch):
    """`_launch_dbias` checks the statistic (the tensor-core forward's:
    bf16 one number a row, fp32 hi + lo) and delta before any launch, then
    calls the slab entry with the map's geometry and counts
    window_attention_slab_dbias_tc."""
    calls = []

    class Fn:
        argtypes = None

        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    class Lib:
        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            return Fn(name)

    libraries = []
    monkeypatch.setattr(wap, "_library_tc",
                        lambda backward: libraries.append(backward) or Lib())
    monkeypatch.setattr(wap, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    was.reset_launch_counts()
    nH, ws = 4, 6
    qkv = torch.zeros(2, 12, 18, 3 * nH * 32, dtype=torch.bfloat16)
    g = torch.zeros(2, 12, 18, nH * 32, dtype=torch.bfloat16)
    ls, bias = torch.zeros(nH, 1, 1), torch.zeros(nH, 36, 36)
    mask = torch.zeros(6, 36, 36)
    delta = torch.zeros(12, nH, 36)
    with pytest.raises(ValueError, match="log-sum-exp"):
        was._launch_dbias(qkv, ls, bias, mask, torch.zeros(2, 12, nH, 36),
                          g, delta, nH, ws)
    with pytest.raises(ValueError, match="delta"):
        was._launch_dbias(qkv, ls, bias, mask, torch.zeros(12, nH, 36), g,
                          torch.zeros(6, nH, 36), nH, ws)
    assert not calls
    was._launch_dbias(qkv, ls, bias, mask, torch.zeros(12, nH, 36), g,
                      delta, nH, ws)
    (name, args), = calls
    assert name == "mmde_window_attention_slab_dbias_tc"
    assert libraries == [True]            # the tensor-core backward library
    assert args[8:16] == (2, 12, 18, nH * 32, nH, ws, 1, 0)
    assert was.launch_counts() == {"window_attention_slab_dbias_tc": 1}
    assert was.LAUNCHES_BWD == 0          # outside the backward counts
    was.reset_launch_counts()


def _src() -> str:
    return open(os.path.join(cuda_build.CSRC_DIR,
                             "window_attention_bwd_tc.cu")).read()


def test_entry_signature_and_checks():
    """The C entry's parameters match the ctypes types; it refuses what the
    slab backward entry refuses (whole windows, N * ws < 2^32, ws * Wp <
    2^31 for MapRows::pix) and instantiates the kernel over MapRows in
    mode fp32, bf16 and fp32 maps."""
    text = _src()
    m = re.search(r'extern "C" int mmde_window_attention_slab_dbias_tc\('
                  r'(.*?)\)\s*{(.*?)\n}\n', text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [was._P if "*" in p else was._I for p in params]
    assert kinds == was._DBIAS_TC_ARGTYPES
    assert params[8:16] == ["int B", "int Hp", "int Wp", "int C", "int nH",
                            "int ws", "int qkv_bf16", "int bias_bf16"]
    body = m.group(2)
    for check in ("Hp % ws != 0", "Wp % ws != 0", "N * ws >= (1ll << 32)",
                  "(long long)ws * Wp >= (1ll << 31)",
                  "launch_dbias<MapRows, T, TB, MXU_FP32>"):
        assert check in body, check
    assert was._ARGTYPES["mmde_window_attention_slab_dbias_tc"] == \
        was._DBIAS_TC_ARGTYPES


def test_kernel_fills_the_key_tile_table_once():
    """K3's MapRows loads read the key tile's pixels from a shared table
    filled once a block (the same in every window); Rows ignores it."""
    text = _src()
    start = text.index("bwd_dbias_tc_kernel(")
    body = text[start:text.index("\n}\n", start)]
    fill = body.index("TileRows<L<const T>>::fill(sTab, k, k0, tid);")
    assert fill < body.index("issue(0);")
    assert body.count("sTab, k0, N, tid)") == 4        # K and V, each type
    assert "atomic" not in body
