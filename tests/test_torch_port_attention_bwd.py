"""PyTorch port: the backward of the packed window attention, on the CPU.

For CPU tensors the autograd Function runs the plain forward and the plain
backward (the explicit formulas the CUDA backward kernel implements). They
are held here to three references: torch.autograd through the plain forward
in float64, `jax.vjp` of the JAX package's Pallas kernels in interpret mode,
and torch.autograd.gradcheck. The CUDA kernel itself is held to the same
formulas and to float64 autograd on the card by chip_smoke.py.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops.window_attention_packed import (
    attention_plan, cosine_window_attention_packed as j_packed,
    pack_rpe_bias)
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.ops.window_attention import MAX_LOGIT_SCALE

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _inputs(B=4, nH=4, N=49, nW=2, with_mask=True, seed=0, clamp_head=False,
            max_ls=3.0):
    """numpy float32 inputs: qkv, logit_scale (<= 3 for the JAX kernel, see
    mmde_tpu_torch.testing), 16*sigmoid bias, 0/-100 mask, output gradient."""
    rng = np.random.default_rng(seed)
    C = nH * 32
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    ls = np.minimum(rng.standard_normal((nH, 1, 1)) * 0.5 + 1.5, max_ls
                    ).astype(np.float32)
    if clamp_head:
        ls[0] = 5.0                              # above ln(100): clamped
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if with_mask:
        m = rng.random((nW, N, N)) < 0.3
        m &= ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, ls, bias, mask, g


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _function_grads(qkv, ls, bias, mask, g, nH, grid_mode=None):
    """Gradients through the public wrapper (the autograd Function)."""
    leaves = [_t(x).requires_grad_() for x in (qkv, ls, bias)]
    before = (twp.LAUNCHES, twp.LAUNCHES_BWD)
    out = twp.cosine_window_attention_packed(
        leaves[0], leaves[1], leaves[2], _t(mask), num_heads=nH,
        grid_mode=grid_mode)
    assert out.grad_fn is not None and "PackedWindowAttention" in type(
        out.grad_fn).__name__
    out.backward(_t(g))
    assert (twp.LAUNCHES, twp.LAUNCHES_BWD) == before   # no kernel on CPU
    return [t.grad for t in leaves]


def _float64_grads(qkv, ls, bias, mask, g, nH):
    """The independent ground truth: autograd through the plain forward."""
    leaves = [_t(x, torch.float64).requires_grad_() for x in (qkv, ls, bias)]
    out = twp.cosine_window_attention_packed_plain(
        leaves[0], leaves[1], leaves[2], _t(mask, torch.float64),
        num_heads=nH, compute_dtype=torch.float64)
    assert out.dtype == torch.float64
    return torch.autograd.grad(out, leaves, _t(g, torch.float64))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n", [49, 64])
@pytest.mark.parametrize("grid_mode", [None, "split"])
def test_function_backward_matches_float64_autograd(with_mask, n, grid_mode):
    """fp32 explicit formulas against float64 autograd: rel-L2 <= 1e-5 (the
    order of fp32 sums; one head sits at scale 100, where logits of ~1e2
    carry an fp32 ulp of 8e-6)."""
    x = _inputs(N=n, with_mask=with_mask, clamp_head=True, seed=1)
    got = _function_grads(*x, nH=4, grid_mode=grid_mode)
    want = _float64_grads(*x, nH=4)
    for name, a, b in zip(("dqkv", "dlogit_scale", "dbias"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    # the clamp binds for head 0: exactly zero, not merely small
    assert float(got[1].flatten()[0]) == 0.0
    assert float(want[1].flatten()[0]) == 0.0
    assert float(got[1].flatten()[1:].abs().min()) > 0


def test_plain_backward_is_what_the_function_runs():
    qkv, ls, bias, mask, g = _inputs(seed=2)
    got = _function_grads(qkv, ls, bias, mask, g, nH=4)
    want = twp.cosine_window_attention_packed_backward_plain(
        _t(qkv), _t(ls), _t(bias), _t(mask), _t(g), num_heads=4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_vjp(qkv, ls, bias_hnn, mask, g, nH, grid_mode=None):
    """jax.vjp of the JAX packed op (Pallas forward with want_denom and the
    Pallas backward, interpret mode); dbias taken through pack_rpe_bias back
    to the plain (nH, N, N) layout."""
    C = qkv.shape[-1] // 3
    _, Np, _, HG, nG, _ = attention_plan(qkv.shape[1], nH, C // nH, C)

    def f(q, l, b_hnn):
        bp = pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return j_packed(q, l, bp, None if mask is None else jnp.asarray(mask),
                        num_heads=nH, grid_mode=grid_mode)

    _, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(ls),
                     jnp.asarray(bias_hnn))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n", [49, 64])
def test_function_backward_matches_jax_pallas_backward(with_mask, n):
    """Against the TPU package's own backward kernel. N = 49 takes its
    padded plan (Np = 56), N = 64 the exact one. Both sides are fp32 with
    sums in another order: 2e-4 absolute and relative, the tolerance the
    JAX package's own gradient tests use."""
    qkv, ls, bias, mask, g = _inputs(N=n, with_mask=with_mask, seed=3)
    got = _function_grads(qkv, ls, bias, mask, g, nH=4)
    want = _jax_vjp(qkv, ls, bias, mask, g, nH=4)
    for name, a, b in zip(("dqkv", "dlogit_scale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
        assert np.abs(b).max() > 1e-2, name


def test_function_backward_matches_jax_split_grid():
    """The JAX package's grid_mode="split" (its dbias-only kernel) gives the
    same dbias; the port's "split" is its counterpart on the card."""
    qkv, ls, bias, mask, g = _inputs(N=49, seed=4)
    got = _function_grads(qkv, ls, bias, mask, g, nH=4, grid_mode="split")
    want = _jax_vjp(qkv, ls, bias, mask, g, nH=4, grid_mode="split")
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=2e-4, atol=2e-4)


def test_gradcheck_float64():
    """Numerical differentiation at a tiny size: the plain forward and the
    plain backward, both in float64, as the two halves of a Function."""
    qkv, ls, bias, mask, _ = _inputs(B=2, nH=1, N=5, nW=2, seed=5)
    mask64 = _t(mask, torch.float64)

    class Twin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, l, b):
            ctx.save_for_backward(q, l, b)
            return twp.cosine_window_attention_packed_plain(
                q, l, b, mask64, num_heads=1, compute_dtype=torch.float64)

        @staticmethod
        def backward(ctx, g):
            return twp.cosine_window_attention_packed_backward_plain(
                *ctx.saved_tensors, mask64, g, num_heads=1,
                compute_dtype=torch.float64)

    leaves = [_t(x, torch.float64).requires_grad_() for x in (qkv, ls, bias)]
    assert torch.autograd.gradcheck(Twin.apply, leaves, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


def test_bf16_function_backward():
    """bf16 qkv / bias / mask / g, as a bf16 model trains: gradients leave
    in the inputs' types after fp32 arithmetic and one rounding (2^-9
    relative, rel-L2 ~1e-3 against float64; held to 4e-3), dlogit_scale in
    float32 (1e-3)."""
    qkv, ls, bias, mask, g = _inputs(seed=6)
    bf = torch.bfloat16
    leaves = [_t(qkv, bf).requires_grad_(), _t(ls).requires_grad_(),
              _t(bias, bf).requires_grad_()]
    out = twp.cosine_window_attention_packed(*leaves, _t(mask, bf),
                                             num_heads=4)
    out.backward(_t(g, bf))
    got = [t.grad for t in leaves]
    assert [t.dtype for t in got] == [bf, torch.float32, bf]
    rounded = [leaves[0].detach().float().numpy(), ls,
               leaves[2].detach().float().numpy(), mask,
               _t(g, bf).float().numpy()]
    want = _float64_grads(*rounded, nH=4)
    assert _rel(got[0], want[0]) <= 4e-3
    assert _rel(got[2], want[2]) <= 4e-3
    assert _rel(got[1], want[1]) <= 1e-3


def test_needs_input_grad_is_honoured():
    """Frozen RPE parameters: no dbias is returned (on the card: not
    computed); the mask never gets a gradient."""
    qkv, ls, bias, mask, g = _inputs(seed=7)
    q = _t(qkv).requires_grad_()
    m = _t(mask).requires_grad_()          # even if a caller asks
    out = twp.cosine_window_attention_packed(q, _t(ls), _t(bias), m,
                                             num_heads=4)
    out.backward(_t(g))
    assert q.grad is not None and m.grad is None
    want = _float64_grads(qkv, ls, bias, mask, g, nH=4)[0]
    assert _rel(q.grad, want) <= 1e-5


def test_no_graph_without_grad():
    qkv, ls, bias, mask, _ = _inputs(seed=8)
    q = _t(qkv).requires_grad_()
    with torch.no_grad():
        out = twp.cosine_window_attention_packed(q, _t(ls), _t(bias),
                                                 _t(mask), num_heads=4)
    assert out.grad_fn is None and not out.requires_grad
    with pytest.raises(ValueError, match="grid_mode"):
        twp.cosine_window_attention_packed(q, _t(ls), _t(bias), _t(mask),
                                           num_heads=4, grid_mode="v4")


def test_bias_grad_flows_to_the_rpe_parameters():
    """Counterpart of test_bias_grad_flows_to_packed_construction: through
    the bf16 cast, the gather, 16*sigmoid and the RPE MLP, by plain
    autograd."""
    from mmde_tpu_torch.nn.swin_v2 import WindowAttention
    torch.manual_seed(0)
    attn = WindowAttention(128, (6, 6), 4, pretrain_window_size=4,
                           attn_impl="cuda", dtype=torch.bfloat16)
    x = torch.randn(2, 36, 128)
    (attn(x).float() ** 2).sum().backward()
    for name in ("rpe_mlp.0.weight", "rpe_mlp.0.bias", "rpe_mlp.2.weight",
                 "logit_scale", "qkv.weight", "q_bias", "v_bias"):
        grad = attn.get_parameter(name).grad
        assert grad is not None and grad.dtype == torch.float32, name
        assert bool(torch.isfinite(grad).all()) and bool((grad != 0).any())


def _c_params(src, name):
    m = re.search(r'extern "C" int %s\((.*?)\)\s*{' % name, src, re.S)
    assert m, f"C entry point {name} not found"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("entry,source,argtypes", [
    ("mmde_window_attention_bwd", "_SOURCES_BWD", "_BWD_ARGTYPES"),
    ("mmde_window_attention_fwd_stats", "_SOURCES", "_FWD_STATS_ARGTYPES"),
    ("mmde_window_attention_fwd", "_SOURCES", "_FWD_ARGTYPES"),
    ("mmde_window_attention_fwd_w", "_SOURCES", "_FWD_W_ARGTYPES"),
    ("mmde_window_attention_bwd_w", "_SOURCES_BWD", "_BWD_W_ARGTYPES"),
    ("mmde_window_attention_bwd_resident", "_SOURCES_RESIDENT",
     "_RESIDENT_ARGTYPES")])
def test_ctypes_signatures_match_the_cuda_sources(entry, source, argtypes):
    """No compiler here: hold each ctypes signature to its C entry point,
    parameter by parameter (pointer -> c_void_p, int -> c_int)."""
    import ctypes
    src = open(os.path.join(cuda_build.CSRC_DIR,
                            getattr(twp, source)[0])).read()
    params = _c_params(src, entry)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert getattr(twp, argtypes) == want
    assert "torch/extension.h" not in src


def test_backward_source_constants_match_the_wrapper():
    src = open(os.path.join(cuda_build.CSRC_DIR, twp._SOURCES_BWD[0])).read()
    assert re.search(r"constexpr int DH = (\d+);", src).group(1) == str(
        twp.HEAD_DIM)
    assert re.search(r"constexpr int BT = (\d+);", src).group(1) == str(
        twp.BWD_TILE)
    assert re.search(r"constexpr float LN100 = ([\d.]+)f;", src).group(1) \
        == repr(MAX_LOGIT_SCALE)
    assert twp.DEFAULT_GRID_MODE in twp.GRID_MODES
    assert twp._DBIAS_MODE == {"window_resident": 1, "split": 2}
    for mode, code in twp._DBIAS_MODE.items():
        assert f"dbias_mode == {code}" in src or f"dbias_mode = {code}" in src


_ENV_PROBE = """
import torch
from mmde_tpu_torch.nn.swin_v2 import WindowAttention
from mmde_tpu_torch.ops import window_attention_packed as twp
assert twp.DEFAULT_GRID_MODE == "split", twp.DEFAULT_GRID_MODE
torch.manual_seed(0)
attn = WindowAttention(128, (6, 6), 4, pretrain_window_size=4,
                       attn_impl="cuda")
out = attn(torch.randn(2, 36, 128))
todo, seen, modes = [out.grad_fn], set(), []
while todo:
    fn = todo.pop()
    if fn is None or fn in seen:
        continue
    seen.add(fn)
    if "PackedWindowAttention" in type(fn).__name__:
        modes.append(fn.grid_mode)
    todo.extend(f for f, _ in fn.next_functions)
assert modes == ["split"], modes
out.sum().backward()
assert attn.rpe_mlp[0].weight.grad is not None
print("ok")
"""


def _run_with_grid(value, code):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MMDE_ATTN_GRID=value, PYTHONPATH=root)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True)


def test_environment_variable_selects_the_grid_mode_for_the_model():
    """The model never passes grid_mode (nor does the JAX package's): a user
    takes the atomics-free dbias pass with MMDE_ATTN_GRID=split, read once at
    import, and a value neither package has raises at import."""
    run = _run_with_grid("split", _ENV_PROBE)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr
    run = _run_with_grid("typo",
                         "import mmde_tpu_torch.ops.window_attention_packed")
    assert run.returncode != 0 and "MMDE_ATTN_GRID" in run.stderr


_BIAS_RESIDENT_PROBE = """
import torch
from mmde_tpu_torch.ops import window_attention_packed as twp
assert twp.DEFAULT_GRID_MODE == "bias_resident", twp.DEFAULT_GRID_MODE
g = torch.Generator().manual_seed(0)
qkv = torch.randn(4, 36, 384, generator=g)
ls = torch.full((4, 1, 1), 1.5)
bias = torch.randn(4, 36, 36, generator=g)
mask = torch.where(torch.rand(2, 36, 36, generator=g) < 0.3, -100.0, 0.0)
with torch.no_grad():
    out = twp.cosine_window_attention_packed(qkv, ls, bias, mask,
                                             num_heads=4, maxfree=False)
want = twp.cosine_window_attention_packed_plain(qkv, ls, bias, mask,
                                                num_heads=4)
assert torch.equal(out, want)
leaves = [t.clone().requires_grad_() for t in (qkv, ls, bias)]
out = twp.cosine_window_attention_packed(*leaves, mask, num_heads=4)
assert out.grad_fn.grid_mode == "bias_resident"
gout = torch.randn(out.shape, generator=g)
out.backward(gout)
want = twp.cosine_window_attention_packed_backward_plain(
    qkv, ls, bias, mask, gout, num_heads=4)
for a, b in zip(leaves, want):
    assert torch.equal(a.grad, b)
print("computed:", twp.LAUNCHES_RESIDENT)
"""


def test_bias_resident_grid_imports_serves_and_names_k4_in_the_backward():
    """MMDE_ATTN_GRID=bias_resident is one of the JAX package's grid modes:
    the package imports under it and serves (the forward is the same
    function under every grid), and the backward, which on the card is the
    single-pass kernel K4, computes: on the CPU it is the plain backward,
    equal to it bit for bit, with no kernel counted."""
    run = _run_with_grid("bias_resident", _BIAS_RESIDENT_PROBE)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert lines == ["computed: 0"], run.stdout
