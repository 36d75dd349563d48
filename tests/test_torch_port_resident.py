"""PyTorch port vs JAX package: the bias-resident grid (K4), on the CPU.

MMDE_ATTN_GRID=bias_resident (or grid_mode="bias_resident") makes the
packed attention's backward the single-pass kernel K4 - the JAX package's
`_pallas_backward_v4`, the port's csrc/window_attention_bwd_resident.cu -
after a forward without the log-sum-exp. On CPU tensors the port's autograd
Function runs the plain forward and the plain backward whatever the grid;
they are held here to the JAX op under grid_mode="bias_resident" (its K1
forward and K4 backward in interpret mode), to float64 autograd, and, in a
process of their own, one shifted block of both packages under the
environment variables. K4 itself is held to the same plain backward and to
float64 autograd on the card by chip_smoke.py.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops.window_attention_packed import (
    attention_plan, cosine_window_attention_packed as j_packed,
    pack_rpe_bias)
from mmde_tpu_torch.ops import window_attention_packed as twp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(B=4, nH=4, N=49, nW=2, with_mask=True, seed=0):
    """numpy float32 qkv, logit_scale (<= 3: the JAX kernels' static softmax
    shift underflows for hotter heads, ROADMAP F1), 16*sigmoid bias, 0/-100
    mask, output gradient."""
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


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _port(qkv, ls, bias, mask, g, nH, **kw):
    """Output and (dqkv, dlogit_scale, dbias) through the public wrapper."""
    leaves = [_t(x).requires_grad_() for x in (qkv, ls, bias)]
    before = (twp.LAUNCHES, twp.LAUNCHES_BWD, twp.LAUNCHES_RESIDENT)
    out = twp.cosine_window_attention_packed(
        leaves[0], leaves[1], leaves[2], _t(mask), num_heads=nH, **kw)
    out.backward(_t(g))
    # CPU tensors: the plain versions, no kernel counted
    assert (twp.LAUNCHES, twp.LAUNCHES_BWD, twp.LAUNCHES_RESIDENT) == before
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax(qkv, ls, bias_hnn, mask, g, nH, **kw):
    """jax.vjp of the JAX packed op (interpret mode); dbias taken through
    pack_rpe_bias back to the plain (nH, N, N) layout."""
    C = qkv.shape[-1] // 3
    _, Np, _, HG, nG, _ = attention_plan(qkv.shape[1], nH, C // nH, C)

    def f(q, l, b_hnn):
        bp = pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return j_packed(q, l, bp, None if mask is None else jnp.asarray(mask),
                        num_heads=nH, **kw)

    out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(ls),
                       jnp.asarray(bias_hnn))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", [
    dict(B=4, nH=4, N=49, nW=2, with_mask=False),
    dict(B=4, nH=4, N=49, nW=2, with_mask=True),
    dict(B=2, nH=4, N=500, nW=2, with_mask=True),       # q-tiled, Np > N
], ids=["n49", "n49-mask", "n500-mask"])
def test_bias_resident_matches_jax_k4(case):
    """Forward and gradients against the JAX op under
    grid_mode="bias_resident" (K1, then K4 in interpret mode): 2e-4
    absolute and relative, the JAX package's own gradient tolerance (fp32
    both sides, sums in another order)."""
    nH = case["nH"]
    x = _inputs(**case, seed=11)
    got_out, got = _port(*x, nH=nH, grid_mode="bias_resident")
    want_out, want = _jax(*x, nH=nH, grid_mode="bias_resident")
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-4)
    for name, a, b in zip(("dqkv", "dlogit_scale", "dbias"), got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=name)
        assert np.abs(b).max() > 1e-2, name


def test_bias_resident_equals_the_default_grid_on_the_cpu():
    """The grid changes how the card sums ds, not the function: on the CPU
    all three modes run the same plain backward, bit for bit."""
    x = _inputs(seed=12)
    ref = _port(*x, nH=4)
    for mode in twp.GRID_MODES:
        out, grads = _port(*x, nH=4, grid_mode=mode)
        np.testing.assert_array_equal(out, ref[0])
        for a, b in zip(grads, ref[1]):
            np.testing.assert_array_equal(a, b)


def test_bias_resident_matches_float64_with_a_clamped_head():
    """Against float64 autograd of the plain forward, one head above the
    ln(100) clamp (its dlogit_scale exactly 0): rel-L2 <= 1e-5."""
    qkv, ls, bias, mask, g = _inputs(seed=13)
    ls[0] = 5.0
    _, got = _port(qkv, ls, bias, mask, g, nH=4, grid_mode="bias_resident")
    leaves = [_t(a, torch.float64).requires_grad_() for a in (qkv, ls, bias)]
    out = twp.cosine_window_attention_packed_plain(
        *leaves, _t(mask, torch.float64), num_heads=4,
        compute_dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, _t(g, torch.float64))
    for a, b in zip(got, want):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
    assert got[1].flatten()[0] == 0.0


def test_resident_splits_cut_the_window_sweep_for_four_blocks_per_sm():
    """K4's window chunks: enough blocks for ~4 per SM of the H100, never
    more chunks than windows; at the flagship train shapes 3 / 2 / 1 / 2."""
    assert [twp.resident_splits(n, h, b) for b, n, h in
            ((96, 900, 4), (24, 900, 8), (8, 900, 16), (8, 225, 32))] \
        == [3, 2, 1, 2]
    assert twp.resident_splits(900, 4, 2) == 2
    assert twp.resident_splits(49, 4, 1) == 1


_BLOCK_PROBE = r"""
import jax, jax.numpy as jnp, numpy as np, torch
from mmde_tpu.nn import swin_v2 as jsw
from mmde_tpu.ops import window_attention_packed as jwap
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.testing import randomize_tree
# both packages read the same variables, once, at import
assert jwap.DEFAULT_GRID_MODE == twp.DEFAULT_GRID_MODE == "bias_resident"
assert jwap.WINDOWS_PER_CELL == twp.WINDOWS_PER_CELL == "auto"
rng = np.random.default_rng(21)
x = rng.standard_normal((2, 12, 12, 128)).astype(np.float32)
mask = jsw.shifted_window_mask(12, 12, 6, 3)
jm = jsw.SwinBlock(dim=128, num_heads=4, window_size=6, shift_size=3,
                   pretrain_window_size=4, attn_impl="pallas")
v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(x), jnp.asarray(mask)))
params = randomize_tree(v["params"], rng)
w = rng.standard_normal(x.shape).astype(np.float32)
want_out, vjp = jax.vjp(
    jax.jit(lambda p, xx: jm.apply({"params": p}, xx, jnp.asarray(mask))),
    jax.tree.map(jnp.asarray, params), jnp.asarray(x))
gp, gx = vjp(jnp.asarray(w))
want_out = np.asarray(want_out)
tm = tsw.SwinBlock(128, 4, 6, shift_size=3, pretrain_window_size=4,
                   attn_impl="cuda").eval()
load_jax_variables(tm, params)
tx = torch.from_numpy(x).requires_grad_()
out = tm(tx, torch.from_numpy(mask))
np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-4,
                           atol=1e-4)
assert want_out.std() > 0.1
(out * torch.from_numpy(w)).sum().backward()
got = flatten_tree(to_jax_tree({n: p.grad for n, p in tm.named_parameters()},
                               params))
want = flatten_tree(jax.tree.map(np.asarray, gp))
want[("x",)], got[("x",)] = np.asarray(gx), tx.grad.numpy()
assert sorted(got) == sorted(want)
for path in want:
    scale = np.abs(want[path]).max()
    assert scale > 0, path
    np.testing.assert_allclose(got[path], want[path], rtol=0,
                               atol=5e-4 * scale, err_msg="/".join(path))
print("ok", len(want))
"""


def test_shifted_block_under_bias_resident_and_auto_w_matches_jax():
    """One shifted SwinBlock at C = 128 (4 heads, 6 x 6 windows, 8 windows
    over 2 images) in a process of its own under MMDE_ATTN_GRID=
    bias_resident MMDE_ATTN_W=auto, which both packages read at import: JAX
    "pallas" (K1, K4 in interpret mode) against the port's "cuda" (the
    autograd Function's plain halves), fp32: output 1e-4, d(sum(out * w))
    for the input and every parameter within 5e-4 of each gradient's
    largest entry."""
    env = dict(os.environ, MMDE_ATTN_GRID="bias_resident", MMDE_ATTN_W="auto",
               JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", _BLOCK_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip().startswith("ok"), run.stdout
