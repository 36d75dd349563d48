"""PyTorch port vs JAX package: the head-split window attention, on the CPU.

`cosine_window_attention_headsplit` is the counterpart of the JAX package's
`cosine_window_attention_pallas` (TPU kernels K6 forward, K7 backward). On
CPU tensors it runs its plain forward and, under autograd, its plain
backward; both are held here to the Pallas kernels in interpret mode, to
float64 autograd, and through the swin layer and backbone to the JAX
modules. The layout test that routes a stage to the packed or the head-split
kernel is held to the JAX package's `attention_plan`. The CUDA kernels are
held to the same plain versions on the card by chip_smoke.py.
"""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.nn import swin_v2 as jsw
from mmde_tpu.ops.window_attention_packed import attention_plan
from mmde_tpu.ops.window_attention_pallas import (
    cosine_window_attention_pallas as j_headsplit)
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.models.two_frame import SWIN_VARIANTS
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.ops.window_attention import cosine_window_attention
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.train import optim as topt

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _inputs(B=4, nH=3, N=36, nW=2, with_mask=True, seed=0, clamp_head=False):
    """numpy float32 q, k, v (B, nH, N, 32), logit_scale, 16*sigmoid bias,
    0/-100 mask, output gradient. The TPU kernel keeps a row maximum for
    every head, so a head above the ln(100) clamp is safe on both sides."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, nH, N, 32)).astype(np.float32)
                  for _ in range(4))
    ls = (rng.standard_normal((nH, 1, 1)) * 0.5 + 1.5).astype(np.float32)
    if clamp_head:
        ls[0] = 5.0
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    mask = None
    if with_mask:
        m = (rng.random((nW, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    return q, k, v, ls, bias, mask, g


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    if x is None:
        return None
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_grads(q, k, v, ls, bias, mask, g, dtype=torch.float32):
    """Output and gradients through the public wrapper (the autograd
    Function; its plain halves on the CPU)."""
    leaves = [_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(ls), _t(bias)]
    for t in leaves:
        t.requires_grad_()
    before = (ths.LAUNCHES, ths.LAUNCHES_BWD)
    out = ths.cosine_window_attention_headsplit(*leaves, _t(mask))
    assert "HeadSplitWindowAttention" in type(out.grad_fn).__name__
    out.backward(_t(g, dtype))
    assert (ths.LAUNCHES, ths.LAUNCHES_BWD) == before   # no kernel on CPU
    return out.detach(), [t.grad for t in leaves]


def _jax_grads(q, k, v, ls, bias, mask, g, dtype=jnp.float32):
    """Output and jax.vjp of the Pallas v1 kernel (forward `_kernel` and the
    custom-vjp backward `_bwd_kernel`, interpret mode)."""
    out, vjp = jax.vjp(
        lambda *a: j_headsplit(*a, _j(mask)),
        _j(q, dtype), _j(k, dtype), _j(v, dtype), _j(ls), _j(bias))
    return out, vjp(_j(g, dtype))


_CASES = [(n, nH, m) for n in (36, 49) for nH in (1, 3, 11)
          for m in (False, True)]
_NAMES = ("dq", "dk", "dv", "dlogit_scale", "dbias")


@pytest.mark.parametrize("n,nH,with_mask", _CASES + [(576, 1, True)])
def test_plain_forward_matches_jax_kernel(n, nH, with_mask):
    """fp32, abs 1e-5 (the same fp32 function, sums in another order).
    N = 576 > 512 takes the JAX kernel's padded q tiling (Np = 576 in two
    288-row tiles), as N = 900 does in the flagship."""
    x = _inputs(B=2 if n > 512 else 4, nH=nH, N=n, with_mask=with_mask,
                seed=n + nH)
    want = np.asarray(j_headsplit(*(_j(a) for a in x[:6])))
    got = ths.cosine_window_attention_headsplit(*(_t(a) for a in x[:6]))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want.std() > 0.1


@pytest.mark.parametrize("n,nH,with_mask", _CASES + [(576, 1, True)])
def test_plain_backward_matches_jax_kernel(n, nH, with_mask):
    """fp32, rel-L2 2e-4 per gradient (the TPU kernel's dbias sums
    per-window ds dumps in fp32 for fp32 inputs, so it is fp32 throughout
    too)."""
    x = _inputs(B=2 if n > 512 else 4, nH=nH, N=n, with_mask=with_mask,
                seed=100 + n + nH)
    _, got = _port_grads(*x)
    _, want = _jax_grads(*x)
    for name, a, b in zip(_NAMES, got, want):
        assert tuple(a.shape) == b.shape, name
        assert _rel(a.numpy(), b) <= 2e-4, (name, _rel(a.numpy(), b))


def test_bf16_matches_jax_kernel():
    """bf16 q, k, v, g with float32 bias and mask, as a bf16 head-split
    stage runs. Both sides compute in fp32 from the same bf16 inputs and
    round the output and dq / dk / dv once into bf16, so those agree as
    fp32 does, rel-L2 2e-4 (measured: output 6e-7, dq / dk / dv 3e-5,
    dlogit_scale 5e-7: a rounding flips only where sums in another order
    straddle it). dbias is 25x looser, 5e-3: the JAX backward rounds every
    window's ds to bf16 (its ds dump takes the input type, 2^-9 relative
    per term) before summing, the port sums fp32 (measured 1.7e-3)."""
    x = _inputs(nH=3, N=49, seed=7)
    out, got = _port_grads(*x, dtype=torch.bfloat16)
    jout, want = _jax_grads(*x, dtype=jnp.bfloat16)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    assert _rel(out.float().numpy(), np.asarray(jout, np.float32)) <= 2e-4
    tol = {"dq": 2e-4, "dk": 2e-4, "dv": 2e-4, "dlogit_scale": 2e-4,
           "dbias": 5e-3}
    for name, a, b in zip(_NAMES, got, want):
        r = _rel(a.float().numpy(), np.asarray(b, np.float32))
        assert r <= tol[name], (name, r)


@pytest.mark.parametrize("with_mask", [False, True])
def test_function_backward_matches_float64_autograd(with_mask):
    """The explicit formulas against autograd through the plain forward in
    float64: rel-L2 <= 1e-5; head 0 sits above the clamp and its
    dlogit_scale is exactly zero."""
    x = _inputs(nH=3, N=49, with_mask=with_mask, clamp_head=True, seed=9)
    _, got = _port_grads(*x)
    leaves = [_t(a, torch.float64).requires_grad_() for a in x[:5]]
    out = ths.cosine_window_attention_headsplit_plain(
        *leaves, _t(x[5], torch.float64), compute_dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, _t(x[6], torch.float64))
    for name, a, b in zip(_NAMES, got, want):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5, name
    assert float(got[3].flatten()[0]) == 0.0
    assert float(got[3].flatten()[1:].abs().min()) > 0


def test_plain_forward_is_the_plain_attention_in_fp32():
    """For float32 inputs the kernel's plain version is the plain
    `cosine_window_attention` the "torch" path runs."""
    x = _inputs(nH=3, N=49, seed=10)
    a = ths.cosine_window_attention_headsplit_plain(*(_t(t) for t in x[:6]))
    b = cosine_window_attention(*(_t(t) for t in x[:6]))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_wrapper_checks_and_dispatch():
    x = [_t(a) for a in _inputs(nH=2, N=16, seed=11)[:6]]
    with pytest.raises(NotImplementedError, match="head_dim"):
        ths.cosine_window_attention_headsplit(
            *(t[..., :16] for t in x[:3]), *x[3:])
    with pytest.raises(TypeError):
        ths.cosine_window_attention_headsplit(*x[:5], x[5].double())
    with pytest.raises(ValueError, match="multiple"):
        ths.cosine_window_attention_headsplit(*(t[:3] for t in x[:3]),
                                              *x[3:])
    torch.testing.assert_close(
        ths.window_attention(*x, impl="cuda"),
        ths.cosine_window_attention_headsplit(*x), rtol=0, atol=0)
    torch.testing.assert_close(ths.window_attention(*x, impl="torch"),
                               cosine_window_attention(*x), rtol=0, atol=0)
    q = x[0].requires_grad_()
    with torch.no_grad():
        out = ths.cosine_window_attention_headsplit(q, *x[1:])
    assert out.grad_fn is None


def test_needs_input_grad_is_honoured():
    """Only q asks for a gradient: k, v, the RPE and the mask get none."""
    q, k, v, ls, bias, mask, g = _inputs(seed=12)
    tq = _t(q).requires_grad_()
    tm = _t(mask).requires_grad_()
    out = ths.cosine_window_attention_headsplit(tq, _t(k), _t(v), _t(ls),
                                                _t(bias), tm)
    out.backward(_t(g))
    assert tq.grad is not None and tm.grad is None


# ------------------------------------------------------------ layout test

def _variant_stages():
    """(N, nH, Dh, C) of every stage of the five swin variants at windows
    30 and 15."""
    out = []
    for embed, heads in SWIN_VARIANTS.values():
        for i, nH in enumerate(heads):
            C = embed * 2 ** i
            for ws in (30, 15):
                out.append((ws * ws, nH, C // nH, C))
    return out


_GRID = sorted(set(_variant_stages() + [
    (n, nH, dh, nH * dh) for n in (36, 49, 456, 457, 576, 900, 4096, 8192,
                                    16384)
    for nH in (1, 2, 3, 4, 6, 8, 11, 12, 16) for dh in (16, 32, 48, 64)]))


def test_packed_layout_test_agrees_with_attention_plan():
    """The port's copy of the routing rule against the JAX package's, on
    every stage of the five variants and a grid around them (windows past
    456 tokens reach the TPU's VMEM rule: 8192 and 16384 tokens fail it at
    four heads per group)."""
    results = set()
    for n, nH, dh, C in _GRID:
        want = attention_plan(n, nH, dh, C) is not None
        assert twp.packed_layout_ok(n, nH, dh, C) == want, (n, nH, dh, C)
        results.add((want, n > 456))
    assert results == {(True, False), (False, False), (True, True),
                       (False, True)}


def test_variant_stages_take_the_expected_kernel():
    ok = {name: [twp.packed_layout_ok(900, nH, 32, embed * 2 ** i)
                 for i, nH in enumerate(heads)]
          for name, (embed, heads) in SWIN_VARIANTS.items()}
    assert ok == {"nano": [False, False, True, True],
                  "tiny": [False, False, True, True],
                  "base": [True, True, True, True],
                  "large": [False, True, True, True],
                  "huge": [False, False, True, True]}


@pytest.mark.parametrize("C", [96, 192, 352, 704])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_views_are_read_in_place(C, dtype):
    """The head-split views of qkv that WindowAttention forms meet the
    kernels' layout (unit-stride channels, 16-byte aligned rows) at every
    head-split width of the real variants: no copy. A view one element off
    does not, and is copied."""
    nH = C // 32
    qkv = torch.empty((4, 900, 3 * C), dtype=dtype)
    q, k, v = qkv.reshape(4, 900, 3, nH, 32).permute(2, 0, 3, 1, 4).unbind(0)
    for t in (q, k, v):
        assert ths.rows_layout_ok(t)
        assert ths._rows(t) is t
    off = qkv.reshape(-1)[1:1 + 4 * 900 * C].reshape(4, 900, nH, 32)
    assert not ths.rows_layout_ok(off.permute(0, 2, 1, 3))
    assert ths._rows(off.permute(0, 2, 1, 3)).is_contiguous()


# -------------------------------------------------------- swin layer, model

def _init(jmodel, *args, seed=0):
    v = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, *args))
    return randomize_tree(v["params"], np.random.default_rng(seed))


def _attn_pair(dtype=jnp.float32, seed=13):
    """JAX WindowAttention C = 96 / nH = 3 (head-split on both sides) and
    the port's, same weights; a shifted-window mask of two windows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 36, 96)).astype(np.float32)
    mask = jsw.shifted_window_mask(6, 12, 6, 3)
    jm = jsw.WindowAttention(dim=96, window_size=(6, 6), num_heads=3,
                             pretrain_window_size=4, attn_impl="pallas",
                             dtype=dtype)
    params = _init(jm, jnp.asarray(x), jnp.asarray(mask), seed=seed)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = tsw.WindowAttention(96, (6, 6), 3, pretrain_window_size=4,
                             attn_impl="cuda", dtype=tdtype).eval()
    load_jax_variables(tm, params)
    return x, mask, jm, params, tm


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_c96_matches_jax_forward_and_gradients(with_mask):
    """The layer at swin_tiny's stage-1 width, fp32: outputs 1e-4, and
    d(sum(out * w)) for the input and every parameter within 5e-4 of each
    gradient's largest entry (JAX: Pallas v1 forward and backward in
    interpret mode; port: the autograd Function's plain halves)."""
    x, mask, jm, params, tm = _attn_pair()
    m = mask if with_mask else None
    jmask = None if m is None else jnp.asarray(m)
    w = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jmask) * w)

    want_out = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jmask))
    gp, gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = _t(x).requires_grad_()
    out = tm(tx, _t(m))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-4,
                               atol=1e-4)
    assert want_out.std() > 0.1
    (out * _t(w)).sum().backward()
    got = flatten_tree(to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, params))
    want = flatten_tree(jax.tree.map(np.asarray, gp))
    want[("x",)], got[("x",)] = np.asarray(gx), tx.grad.numpy()
    assert sorted(got) == sorted(want)
    for path in want:
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=5e-4 * scale, err_msg="/".join(path))


def test_bf16_head_split_stage_keeps_float32_bias_and_mask(monkeypatch):
    """A bf16 head-split stage hands the kernel the float32 bias and mask,
    as the JAX package does there (it casts them to bf16 on its packed path
    only). The layer then agrees with the JAX layer more closely than the
    same layer streaming a bf16-rounded bias does (measured: mean abs
    difference 5.2e-4 against 4.3e-3, output std 0.44)."""
    x, mask, jm, params, tm = _attn_pair(dtype=jnp.bfloat16, seed=15)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(mask)), np.float32)
    real = tsw.cosine_window_attention_headsplit
    seen = []

    def spy(q, k, v, ls, bias, m):
        seen.append((q.dtype, bias.dtype, m.dtype))
        return real(q, k, v, ls, bias, m)

    def bf16_bias(q, k, v, ls, bias, m):
        return real(q, k, v, ls, bias.to(torch.bfloat16),
                    m.to(torch.bfloat16))

    with torch.no_grad():
        monkeypatch.setattr(tsw, "cosine_window_attention_headsplit", spy)
        got = tm(_t(x), _t(mask)).float().numpy()
        monkeypatch.setattr(tsw, "cosine_window_attention_headsplit",
                            bf16_bias)
        got_rounded = tm(_t(x), _t(mask)).float().numpy()
    assert seen == [(torch.bfloat16, torch.float32, torch.float32)]
    err = np.abs(got - want).mean()
    err_rounded = np.abs(got_rounded - want).mean()
    assert err < 0.5 * err_rounded, (err, err_rounded)


_NANO = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
             window_size=(6, 6, 6, 3), pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), out_indices=(0, 1, 2, 3))


def test_nano_model_routes_stages_1_2_to_the_head_split_kernel(monkeypatch):
    """C = 32 / 64 (stages 1-2) fail the packed-layout test and take the
    head-split function, C = 128 / 256 the packed one, two blocks each."""
    calls = []
    for name in ("cosine_window_attention_headsplit",
                 "cosine_window_attention_packed"):
        real = getattr(tsw, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name.rsplit("_", 1)[1], a[0].shape[-1] if
                          _name.endswith("packed") else a[0].shape[1]))
            return _real(*a, **kw)
        monkeypatch.setattr(tsw, name, spy)
    tm = tsw.SwinTransformerV2(**_NANO, attn_impl="cuda").eval()
    with torch.no_grad():
        tm(torch.rand(1, 48, 48, 3))
    # head-split calls carry nH, packed calls 3C
    assert calls == [("headsplit", 1)] * 2 + [("headsplit", 2)] * 2 + [
        ("packed", 384)] * 2 + [("packed", 768)] * 2


_LARGE = dict(embed_dim=192, depths=(1, 1, 1, 1), num_heads=(6, 12, 24, 48),
              window_size=(4, 4, 4, 2), pretrain_window_size=(4, 4, 4, 2),
              use_shift=(True, True, False, False), out_indices=(0, 1, 2, 3),
              drop_path_rate=0.0)


def test_swin_large_heads_load_round_trip_and_forward():
    """A shallow swin_large backbone (embed 192, heads 6/12/24/48): the JAX
    tree loads into the port and comes back unchanged, the four stage
    outputs agree with the JAX backbone ("pallas": stage 1 head-split,
    stages 2-4 packed, interpret mode) to 1e-4, and the layer-decay scales
    and weight-decay flags of every parameter match the JAX optimizer's."""
    from mmde_tpu.train import optim as jopt
    rng = np.random.default_rng(16)
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    jm = jsw.SwinTransformerV2(**_LARGE, attn_impl="pallas")
    params = _init(jm, jnp.asarray(x), seed=17)
    tm = tsw.SwinTransformerV2(**_LARGE, attn_impl="cuda").eval()
    load_jax_variables(tm, params)
    back = flatten_tree(to_jax_tree(dict(tm.named_parameters()), params))
    flat = flatten_tree(params)
    assert sorted(back) == sorted(flat)
    for path in flat:
        np.testing.assert_array_equal(back[path], flat[path])
    qkv = tm.layers[0].blocks[0].attn.qkv.weight
    assert tuple(qkv.shape) == (576, 192)
    assert tm.layers[3].blocks[0].attn.logit_scale.shape == (48, 1, 1)

    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert w.std() > 0.5
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)

    depths = _LARGE["depths"]
    jscales, _ = jopt.build_layer_scales(params, depths, 0.9)
    for ours, theirs in ((topt.build_layer_scales(tm, depths, 0.9), jscales),
                         (topt.weight_decay_mask(tm),
                          jopt.weight_decay_mask(params))):
        got_t = flatten_tree(to_jax_tree(ours, params, convert=False))
        want_t = flatten_tree(theirs)
        assert sorted(got_t) == sorted(want_t)
        for path in want_t:
            assert float(got_t[path]) == pytest.approx(float(want_t[path]),
                                                       rel=1e-12), path


# ------------------------------------------------------------- the binding

def _c_params(name):
    for src in ("window_attention_fwd.cu", "window_attention_bwd.cu"):
        text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
        m = re.search(r'extern "C" int %s\((.*?)\)\s*{' % name, text, re.S)
        if m:
            return src, [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"C entry point {name} not found")


@pytest.mark.parametrize("entry,argtypes", [
    ("mmde_window_attention_headsplit_fwd", "_FWD_ARGTYPES"),
    ("mmde_window_attention_headsplit_fwd_stats", "_FWD_STATS_ARGTYPES"),
    ("mmde_window_attention_headsplit_bwd", "_BWD_ARGTYPES")])
def test_ctypes_signatures_match_the_cuda_sources(entry, argtypes):
    """No compiler here: hold each ctypes signature to its C entry point,
    parameter by parameter, and the entry to the library the packed module
    builds it into."""
    src, params = _c_params(entry)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert getattr(ths, argtypes) == want
    lib_sources = twp._SOURCES_BWD if "bwd" in entry else twp._SOURCES
    assert lib_sources == (src,)
    assert "strides" in params[3 if "fwd" in entry else 4]


def test_library_hash_covers_the_shared_header():
    """Both sources include the shared header, which the build hashes: an
    edited header rebuilds both libraries."""
    for src in twp._SOURCES + twp._SOURCES_BWD:
        text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
        assert '#include "window_attention_common.cuh"' in text
    assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR,
                                       "window_attention_common.cuh"))
    import inspect
    assert '".cuh"' in inspect.getsource(cuda_build.load_library)
