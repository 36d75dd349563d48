"""PyTorch port vs JAX package: windows per block (K5) and the kernel routing.

MMDE_ATTN_W ("auto" or an int, read once at import in both packages) or
windows_per_cell= makes the packed attention run W windows per block where
the JAX rule `_choose_w` gives W > 1: the JAX package's `_fwd_body` /
`_bwd_body` with w > 1, the port's K5 kernels (bf16: the `_tc_w` entries of
csrc/window_attention_{fwd,bwd}_tc.cu; fp32: the K5 kernels of
csrc/window_attention_{fwd,bwd}.cu). On CPU tensors the port runs the plain
versions whatever W; they are held here to the JAX op with
windows_per_cell=3 (interpret mode). The port's copies of `attention_plan`
and the W rule are held to the JAX functions at every stage shape of the
flagship and of swin_large_v2, and the wrapper's choice of kernel, W and
softmax form is read off with the launch functions replaced by recorders
(a tensor that says it is on a card reaches them on the CPU). The kernels
themselves are held to the plain versions on the card by chip_smoke.py.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops import window_attention_packed as jwap
from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS
from mmde_tpu_torch.ops import window_attention_packed as twp

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(B=6, nH=8, N=49, nW=3, with_mask=True, seed=0):
    """numpy float32 qkv, logit_scale (<= 3, ROADMAP F1), 16*sigmoid bias,
    0/-100 mask, output gradient."""
    rng = np.random.default_rng(seed)
    C = nH * 32
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    ls = np.minimum(rng.standard_normal((nH, 1, 1)) * 0.5 + 1.5, 3.0
                    ).astype(np.float32)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if with_mask:
        m = (rng.random((nW, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, ls, bias, mask, g


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("with_mask", [False, True])
def test_three_windows_per_cell_match_jax(with_mask):
    """windows_per_cell=3 at B = 6, 8 heads, N = 49, 3 mask windows: the
    port's output and gradients against the JAX op's (K1 / K2 with w = 3 in
    interpret mode), 2e-4 absolute and relative (the JAX package's own
    tolerance; fp32 both sides)."""
    qkv, ls, bias, mask, g = _inputs(with_mask=with_mask, seed=31)
    C = qkv.shape[-1] // 3
    _, Np, _, HG, nG, _ = jwap.attention_plan(49, 8, 32, C)
    # the rule takes 3 here in both directions, so the JAX side runs w = 3
    assert jwap._choose_w(6, 3 if with_mask else 0, 56, Np, HG, False,
                          override=3) == 3

    def f(q, l, b_hnn):
        bp = jwap.pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return jwap.cosine_window_attention_packed(
            q, l, bp, None if mask is None else jnp.asarray(mask),
            num_heads=8, windows_per_cell=3)

    want_out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(ls),
                            jnp.asarray(bias))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    leaves = [_t(x).requires_grad_() for x in (qkv, ls, bias)]
    out = twp.cosine_window_attention_packed(*leaves, _t(mask), num_heads=8,
                                             windows_per_cell=3)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=2e-4, atol=2e-4)
    for name, a, b in zip(("dqkv", "dlogit_scale", "dbias"),
                          (t.grad.numpy() for t in leaves), want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=name)
        assert np.abs(b).max() > 1e-2, name


def _stage_shapes():
    """(B_, N, C, nH, nW) of every attention call of the flagship
    (swin_base_v2) and swin_large_v2 at 480x640, served (1 frame pair) and
    trained (2): windows 30/30/30/15, shifted stages 1-2 with and without
    their mask."""
    out = []
    for variant in ("base", "large"):
        embed, heads = SWIN_VARIANTS[variant]
        for pairs in (1, 2):
            mh, mw = 120, 160
            for i, ws in enumerate((30, 30, 30, 15)):
                nw = (-(-mh // ws)) * (-(-mw // ws))
                C = embed * 2 ** i
                for nW in ((0, nw) if i < 2 else (0,)):
                    out.append((2 * pairs * nw, ws * ws, C, heads[i], nW))
                mh, mw = (mh + 1) // 2, (mw + 1) // 2
    return out


def test_port_plan_equals_jax_plan():
    """`attention_plan` at every stage shape above and over a sweep of
    window lengths and widths (the padded, q-tiled and refused cases)."""
    shapes = {(n, c // h, c, h) for _, n, c, h, _ in _stage_shapes()}
    shapes |= {(n, 32, c, c // 32) for n in range(1, 1200, 7)
               for c in (96, 128, 256, 384, 1536)}
    shapes |= {(n, dh, 128 * k, 128 * k // dh) for n in (49, 144, 900)
               for dh in (16, 24, 32, 64) for k in (1, 3)}
    for n, dh, c, h in sorted(shapes):
        assert twp.attention_plan(n, h, dh, c) == jwap.attention_plan(
            n, h, dh, c), (n, h, dh, c)
        assert twp.packed_layout_ok(n, h, dh, c) == (
            jwap.attention_plan(n, h, dh, c) is not None)


@pytest.mark.parametrize("setting", ["auto", "1", "2", "3", "4", "5"])
def test_port_w_rule_equals_jax_rule(setting):
    """`choose_w` (and `windows_per_block`, which feeds it the plan's q
    tile of each direction) against the JAX `_choose_w`, forward and
    backward, at every stage shape of the flagship and swin_large, served
    and trained, masked and not. The flagship's `auto` values are the ones
    the JAX rule gives: serve 8/6/4/4, train forward 8/6/8/8 (stage 2
    unmasked: 8) and backward 3/3/4/8 (stages 1-2 unmasked: 4)."""
    for B_, N, C, nH, nW in _stage_shapes():
        plan = jwap.attention_plan(N, nH, C // nH, C)
        for bwd in (False, True):
            if plan is None:
                assert twp.windows_per_block(B_, N, C, nH, nW, bwd,
                                             setting) == 1
                continue
            bq = plan[5] if bwd else plan[0]
            want = jwap._choose_w(B_, nW, bq, plan[1], plan[3], bwd,
                                  override=setting)
            assert twp.choose_w(B_, nW, bq, plan[1], plan[3], bwd,
                                override=setting) == want
            assert twp.windows_per_block(B_, N, C, nH, nW, bwd,
                                         setting) == want
    if setting == "auto":
        got = {(B_, N, nW, bwd): twp.windows_per_block(B_, N, C, nH, nW, bwd,
                                                       "auto")
               for B_, N, C, nH, nW in _stage_shapes()[:12]
               for bwd in (False, True)}
        serve = {(48, 900, 0): 8, (48, 900, 24): 8, (12, 900, 0): 6,
                 (12, 900, 6): 6, (4, 900, 0): 4, (4, 225, 0): 4}
        train_fwd = {(96, 900, 0): 8, (96, 900, 24): 8, (24, 900, 0): 8,
                     (24, 900, 6): 6, (8, 900, 0): 8, (8, 225, 0): 8}
        train_bwd = {(96, 900, 0): 4, (96, 900, 24): 3, (24, 900, 0): 4,
                     (24, 900, 6): 3, (8, 900, 0): 4, (8, 225, 0): 8}
        for want, bwd in ((serve, False), (train_fwd, False),
                          (train_bwd, True)):
            assert {k: got[k + (bwd,)] for k in want} == want


def _probe(env: dict, code: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env)
    for k in ("MMDE_ATTN_W", "MMDE_ATTN_GRID", "MMDE_ATTN_SOFTMAX"):
        if k not in env or env[k] is None:
            env.pop(k, None)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


_W_PROBE = """
import os
from mmde_tpu_torch.ops import window_attention_packed as twp
os.environ["MMDE_ATTN_W"] = "7"      # too late: read once, at import
print(twp.WINDOWS_PER_CELL, twp.windows_per_block(96, 900, 128, 4, 24,
                                                  False))
"""


@pytest.mark.parametrize("value,want", [("auto", "auto 8"), ("3", "3 3"),
                                        (None, "1 1")])
def test_environment_variable_sets_windows_per_cell_at_import(value, want):
    """MMDE_ATTN_W is read once at import, as in the JAX package: "auto"
    takes the rule's W (8 at flagship stage 1, served with its mask), an int
    is taken where it divides the windows, unset is 1."""
    run = _probe({"MMDE_ATTN_W": value}, _W_PROBE)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == want.split()


def test_environment_variable_w_rejects_a_non_integer():
    """Anything but "auto" or an int raises at import, naming the variable
    (the JAX package's check)."""
    run = _probe({"MMDE_ATTN_W": "x"},
                 "import mmde_tpu_torch.ops.window_attention_packed")
    assert run.returncode != 0
    assert "MMDE_ATTN_W" in run.stderr and "ValueError" in run.stderr


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrapper's CUDA branch
    runs, into the recorders below."""

    @property
    def is_cuda(self):
        return True


def _record(monkeypatch):
    calls = []

    def fwd(qkv, ls, bias, mask, nH, maxfree, want_stats, w=1, mxu=None,
            _fma=False):
        assert not _fma      # the model path: the tensor-core body
        calls.append(("fwd", w, want_stats, maxfree))
        B_, N, C3 = qkv.shape
        return (torch.zeros(B_, N, C3 // 3),
                torch.zeros(B_, nH, N) if want_stats else None)

    def bwd(qkv, ls, bias, mask, lse, g, nH, grid_mode, want_dbias, w=1,
            mxu=None, _fma=False):
        assert lse is not None and not _fma
        calls.append(("bwd", w, grid_mode, want_dbias))
        return torch.zeros_like(qkv), torch.zeros_like(ls), \
            torch.zeros_like(bias)

    def resident(qkv, ls, bias, mask, g, nH, want_dbias=True, _fma=False):
        assert not _fma
        calls.append(("resident", want_dbias))
        return torch.zeros_like(qkv), torch.zeros_like(ls), \
            torch.zeros_like(bias)

    monkeypatch.setattr(twp, "_launch_forward", fwd)
    monkeypatch.setattr(twp, "_launch_backward", bwd)
    monkeypatch.setattr(twp, "_launch_backward_resident", resident)
    return calls


def _route(grid_mode, wpc, with_mask=True, train=True, maxfree=True):
    qkv, ls, bias, mask, g = _inputs(B=8, nH=4, N=36, nW=4,
                                     with_mask=with_mask)
    q = _t(qkv).as_subclass(_OnCard)
    b = _t(bias)
    if train:
        q.requires_grad_()
        b.requires_grad_()
        out = twp.cosine_window_attention_packed(
            q, _t(ls), b, _t(mask), num_heads=4, grid_mode=grid_mode,
            windows_per_cell=wpc, maxfree=maxfree)
        out.backward(_t(g))
    else:
        with torch.no_grad():
            twp.cosine_window_attention_packed(
                q, _t(ls), b, _t(mask), num_heads=4, grid_mode=grid_mode,
                windows_per_cell=wpc, maxfree=maxfree)


def test_routing_on_the_card_by_grid_and_w(monkeypatch):
    """Which kernel the wrapper launches for a CUDA tensor, at which W: the
    window grids run K1 / K2 at W = 1 and K5 at the rule's W (here 4 with
    the 4-window mask, 8 without), K3's mode passes on to the backward;
    "bias_resident" runs K1 without the log-sum-exp and then K4, W = 1
    whatever the setting; serving takes the forward's W, or 1 under
    "bias_resident"."""
    calls = _record(monkeypatch)
    _route("window_resident", "1")
    assert calls == [("fwd", 1, True, True),
                     ("bwd", 1, "window_resident", True)]
    calls.clear()
    _route("split", "auto")
    assert calls == [("fwd", 4, True, True), ("bwd", 4, "split", True)]
    calls.clear()
    _route("window_resident", "auto", with_mask=False)
    assert calls == [("fwd", 8, True, True),
                     ("bwd", 8, "window_resident", True)]
    calls.clear()
    _route("bias_resident", "auto")
    assert calls == [("fwd", 1, False, True), ("resident", True)]
    calls.clear()
    _route("window_resident", "auto", train=False)
    _route("bias_resident", "auto", train=False)
    _route("window_resident", 3, train=False)     # 3 divides 8? no: W = 1
    assert calls == [("fwd", 4, False, True), ("fwd", 1, False, True),
                     ("fwd", 1, False, True)]


_SOFTMAX_PROBE = """
import torch
from mmde_tpu_torch.ops import window_attention_packed as twp
seen = []
def fwd(qkv, ls, bias, mask, nH, maxfree, want_stats, w=1, mxu=None):
    seen.append(maxfree)
    return torch.zeros(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3), None
twp._launch_forward = fwd
class OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True
qkv = torch.randn(2, 36, 384).as_subclass(OnCard)
with torch.no_grad():
    twp.cosine_window_attention_packed(qkv, torch.ones(4, 1, 1),
                                       torch.rand(4, 36, 36), num_heads=4)
print(twp.SOFTMAX_MAXFREE, seen[0])
"""


@pytest.mark.parametrize("value,want", [("max", "False False"),
                                        (None, "True True")])
def test_environment_variable_softmax_max_takes_the_row_maximum(value, want):
    """MMDE_ATTN_SOFTMAX=max, read once at import as in the JAX package,
    makes every packed forward take the row maximum (maxfree=False to the
    kernel) even where the model asks for the static shift."""
    run = _probe({"MMDE_ATTN_SOFTMAX": value}, _SOFTMAX_PROBE)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == want.split()
