"""PyTorch port vs JAX package: the slab (map-layout) window attention, on
the CPU.

`cosine_window_attention_slab` is the counterpart of the JAX package's
`cosine_window_attention_slab` (TPU kernels K8 forward, K9 backward): it
takes the (B, Hp, Wp, 3C) qkv map and returns the (B, Hp, Wp, C) map. On
CPU tensors it runs its plain forward and, under autograd, its plain
backward; both are held here to the Pallas slab kernels in interpret mode
(as tests/test_slab_attention.py runs them) and to float64 autograd, and
through the swin block and a two-frame model with attn_impl "pallas_slab"
to the JAX modules. The routing rule (`slab_plan`) is held to the JAX
package's. The CUDA kernels are held to the same plain versions on the card
by chip_smoke.py (phase kernel_cases_slab).
"""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.ops import window_attention_slab as jslab
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.ops import cuda_build
from mmde_tpu_torch.ops import window_attention_packed as twp
from mmde_tpu_torch.ops import window_attention_slab as tslab
from mmde_tpu_torch.testing import randomize_tree

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _inputs(B=2, nH=4, ws=6, nwh=2, nww=3, with_mask=True, seed=0,
            clamp_head=False):
    """numpy float32 qkv map (B, Hp, Wp, 3C), logit_scale, bias (nH, N, N)
    (plain normal: not bounded like the 16*sigmoid bias, which the slab
    kernels do not need), 0/-100 mask (nW, N, N) in row-major window order,
    output gradient map."""
    rng = np.random.default_rng(seed)
    C, N = nH * 32, ws * ws
    qkv = rng.standard_normal((B, ws * nwh, ws * nww, 3 * C)).astype(
        np.float32)
    ls = (rng.standard_normal((nH, 1, 1)) * 0.5 + 1.0).astype(np.float32)
    if clamp_head:
        ls[0] = 5.0
    bias = rng.standard_normal((nH, N, N)).astype(np.float32)
    mask = None
    if with_mask:
        m = rng.random((nwh * nww, N, N)) < 0.3
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, ws * nwh, ws * nww, C)).astype(np.float32)
    return qkv, ls, bias, mask, g, ws


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


def _jax_slab(qkv, ls, bias, mask, nH, ws):
    """The JAX slab op (interpret mode) on the port's (nH, N, N) bias: packed
    into its head groups inside, so jax.grad returns dbias as (nH, N, N)."""
    C = qkv.shape[-1] // 3
    hg, ng = jslab.slab_plan(ws, qkv.shape[2], nH, C // nH, C)
    packed = jslab.pack_rpe_bias_slab(jnp.transpose(bias, (1, 2, 0)), ng, hg)
    return jslab.cosine_window_attention_slab(qkv, ls, packed, mask,
                                              num_heads=nH, window_size=ws)


# ------------------------------------------------------------- the routing

def test_slab_plan_matches_jax():
    """The port's copy of `slab_plan` against the JAX package's: the
    C % 128 gate, the 128 % Dh gate, whole head groups, and the TPU VMEM
    gate (window 30: Wp 480 passes, 510 does not)."""
    seen = set()
    for ws in (3, 6, 15, 30):
        for Wp in (ws, 4 * ws, 480, 510, 1020):
            for nH, dh in ((3, 32), (4, 32), (6, 32), (8, 32), (4, 48),
                           (2, 64), (12, 32), (48, 32), (4, 24)):
                for C in (nH * dh, 96, 128):
                    want = jslab.slab_plan(ws, Wp, nH, dh, C)
                    assert tslab.slab_plan(ws, Wp, nH, dh, C) == want, (
                        ws, Wp, nH, dh, C)
                    seen.add(want is None)
    assert seen == {True, False}
    assert tslab.slab_plan(30, 480, 4, 32, 128) == (4, 1)
    assert tslab.slab_plan(30, 510, 4, 32, 128) is None     # VMEM gate
    assert tslab.slab_plan(30, 180, 6, 32, 192) is None     # C % 128
    assert tslab.slab_plan(6, 18, 4, 48, 192) is None       # 128 % Dh


def test_flagship_and_large_stages_take_the_slab():
    """At 480x640 every flagship stage passes `slab_plan` (24 blocks), and
    swin_large's stages 2-4; its stage 1 (C 192) stays head-split."""
    maps = ((120, 180, 30), (60, 90, 30), (30, 60, 30), (15, 30, 15))
    for name, (embed, heads) in ttf.SWIN_VARIANTS.items():
        ok = [tslab.slab_plan(ws, wp, nH, 32, embed * 2 ** i) is not None
              for i, ((_, wp, ws), nH) in enumerate(zip(maps, heads))]
        want = {"base": [True] * 4, "large": [False, True, True, True],
                "nano": [False, False, True, True],
                "tiny": [False, False, True, True],
                "huge": [False, False, True, True]}[name]
        assert ok == want, name


# ---------------------------------------------------------- the function

@pytest.mark.parametrize("nH,with_mask", [(4, False), (4, True), (8, True)])
def test_plain_forward_matches_jax_slab(nH, with_mask):
    """fp32 within 2e-5 (the same fp32 function, sums in another order) at
    B=2, ws=6, 2 x 3 windows; nH = 8 is two of the TPU kernel's head
    groups."""
    qkv, ls, bias, mask, _, ws = _inputs(nH=nH, with_mask=with_mask,
                                         seed=nH)
    want = np.asarray(_jax_slab(_j(qkv), _j(ls), _j(bias), _j(mask), nH,
                                ws))
    before = tslab.LAUNCHES
    got = tslab.cosine_window_attention_slab(
        _t(qkv), _t(ls), _t(bias), _t(mask), num_heads=nH, window_size=ws)
    assert tslab.LAUNCHES == before                 # no kernel on the CPU
    assert got.shape == want.shape == qkv.shape[:3] + (nH * 32,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert want.std() > 0.1


def test_plain_forward_is_the_windows_path():
    """Partition, the packed (windows) plain function, reverse: the slab
    layout changes the addressing only."""
    qkv, ls, bias, mask, _, ws = _inputs(seed=3)
    B, Hp, Wp, C3 = qkv.shape
    win = tslab.window_partition(_t(qkv), ws)
    want = tslab.window_reverse(twp.cosine_window_attention_packed_plain(
        win, _t(ls), _t(bias), _t(mask), num_heads=4), ws, Hp, Wp)
    got = tslab.cosine_window_attention_slab_plain(
        _t(qkv), _t(ls), _t(bias), _t(mask), num_heads=4, window_size=ws)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bf16_smoke_matches_jax_slab():
    """bf16 qkv, fp32 bias and mask (as the model passes them): both round
    one fp32 result to bf16."""
    qkv, ls, bias, mask, _, ws = _inputs(B=1, nwh=1, nww=2, seed=5)
    want = np.asarray(_jax_slab(_j(qkv, jnp.bfloat16), _j(ls), _j(bias),
                                _j(mask), 4, ws), np.float32)
    got = tslab.cosine_window_attention_slab(
        _t(qkv, torch.bfloat16), _t(ls), _t(bias), _t(mask), num_heads=4,
        window_size=ws)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=0.02)
    assert np.abs(got.float().numpy() - want).mean() < 1e-3


def _port_grads(qkv, ls, bias, mask, g, ws, nH=4):
    leaves = [_t(qkv).requires_grad_(), _t(ls).requires_grad_(),
              _t(bias).requires_grad_()]
    before = (tslab.LAUNCHES, tslab.LAUNCHES_BWD)
    out = tslab.cosine_window_attention_slab(*leaves, _t(mask), num_heads=nH,
                                             window_size=ws)
    assert "SlabWindowAttention" in type(out.grad_fn).__name__
    out.backward(_t(g))
    assert (tslab.LAUNCHES, tslab.LAUNCHES_BWD) == before
    return [t.grad for t in leaves]


@pytest.mark.parametrize("with_mask", [False, True])
def test_backward_matches_jax_grad(with_mask):
    """The plain backward, and autograd through the public function, against
    jax.grad of the JAX slab op (its backward kernel `_bwd_body`, interpret
    mode): dqkv, dlogit_scale, dbias within 5e-4 (fp32 sums in another
    order; dbias is summed over 8 windows on both sides)."""
    qkv, ls, bias, mask, g, ws = _inputs(nwh=2, nww=2, with_mask=with_mask,
                                         seed=7)

    def f(q, s, b):
        return jnp.sum(_jax_slab(q, s, b, _j(mask), 4, ws) * _j(g))

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(_j(qkv), _j(ls), _j(bias))
    plain = tslab.cosine_window_attention_slab_backward_plain(
        _t(qkv), _t(ls), _t(bias), _t(mask), _t(g), num_heads=4,
        window_size=ws)
    auto = _port_grads(qkv, ls, bias, mask, g, ws)
    for name, w, p, a in zip(("dqkv", "dlogit_scale", "dbias"), want, plain,
                             auto):
        w = np.asarray(w)
        assert p.shape == a.shape == w.shape, name
        np.testing.assert_allclose(p.numpy(), w, rtol=5e-4, atol=5e-4,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), w, rtol=5e-4, atol=5e-4,
                                   err_msg=name)
        assert np.abs(w).max() > 0, name


def test_backward_matches_float64_autograd_with_a_clamped_head():
    """fp32 explicit formulas against float64 autograd of the plain forward,
    rel-L2 <= 1e-5; the head above the ln(100) clamp gets exactly zero
    dlogit_scale, the mask no gradient."""
    qkv, ls, bias, mask, g, ws = _inputs(with_mask=True, seed=9,
                                         clamp_head=True)
    got = _port_grads(qkv, ls, bias, mask, g, ws)
    leaves = [_t(a).double().requires_grad_() for a in (qkv, ls, bias)]
    out = tslab.cosine_window_attention_slab_plain(
        *leaves, _t(mask).double(), num_heads=4, window_size=ws,
        compute_dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, _t(g).double())
    for name, a, b in zip(("dqkv", "dlogit_scale", "dbias"), got, want):
        rel = float((a.double() - b).norm() / b.norm())
        assert rel <= 1e-5, (name, rel)
    assert float(got[1].flatten()[0]) == 0.0
    m = _t(mask).requires_grad_()
    out = tslab.cosine_window_attention_slab(
        _t(qkv).requires_grad_(), _t(ls), _t(bias), m, num_heads=4,
        window_size=ws)
    out.sum().backward()
    assert m.grad is None


def test_needs_input_grad_and_no_graph_without_grad():
    qkv, ls, bias, mask, g, ws = _inputs(B=1, nwh=1, nww=2, seed=11)
    q = _t(qkv).requires_grad_()
    out = tslab.cosine_window_attention_slab(q, _t(ls), _t(bias), _t(mask),
                                             num_heads=4, window_size=ws)
    dq, = torch.autograd.grad(out, (q,), _t(g))
    assert dq.shape == q.shape
    with torch.no_grad():
        out = tslab.cosine_window_attention_slab(
            q, _t(ls), _t(bias), _t(mask), num_heads=4, window_size=ws)
    assert out.grad_fn is None


def test_wrapper_checks():
    qkv, ls, bias, mask, _, ws = _inputs(seed=12)
    kw = dict(num_heads=4, window_size=ws)
    q, s, b, m = _t(qkv), _t(ls), _t(bias), _t(mask)
    with pytest.raises(ValueError, match="whole number"):
        tslab.cosine_window_attention_slab(q, s, b, m, num_heads=4,
                                           window_size=5)
    with pytest.raises(ValueError, match="one row per window"):
        tslab.cosine_window_attention_slab(q, s, b, m[:3], **kw)
    with pytest.raises(ValueError, match=r"bias must be"):
        tslab.cosine_window_attention_slab(q, s, b[:2], m, **kw)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tslab.cosine_window_attention_slab(q, s[:2], b[:2], m, num_heads=2,
                                           window_size=ws)
    with pytest.raises(TypeError):
        tslab.cosine_window_attention_slab(q.double(), s, b, m, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tslab.cosine_window_attention_slab(
            q.transpose(1, 2).contiguous().transpose(1, 2), s, b, m, **kw)


# -------------------------------------------------------- block and model

def _block_spies(monkeypatch):
    calls = []
    for name in ("cosine_window_attention_slab",
                 "cosine_window_attention_headsplit",
                 "cosine_window_attention_packed"):
        real = getattr(tsw, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name.rsplit("_", 1)[1], a[0].shape[-1]))
            return _real(*a, **kw)
        monkeypatch.setattr(tsw, name, spy)
    return calls


def test_cuda_slab_routes_blocks_as_the_jax_model(monkeypatch):
    """"cuda_slab": a C = 128 block hands the map to the slab function, a
    C = 96 block (slab_plan None) the windows to the head-split one - as
    "cuda" routes it; a C = 128 map wider than the TPU VMEM rule admits at
    window 30 (Wp 510) takes the windows path, packed, as in the JAX
    model."""
    calls = _block_spies(monkeypatch)
    torch.manual_seed(0)
    with torch.no_grad():
        for dim, nH, ws, shape in ((128, 4, 6, (1, 10, 16)),
                                   (96, 3, 6, (1, 10, 16)),
                                   (128, 4, 30, (1, 30, 510))):
            blk = tsw.SwinBlock(dim, nH, ws, shift_size=ws // 2,
                                pretrain_window_size=4,
                                attn_impl="cuda_slab").eval()
            Hp, Wp = -(-shape[1] // ws) * ws, -(-shape[2] // ws) * ws
            mask = torch.from_numpy(tsw.shifted_window_mask(Hp, Wp, ws,
                                                            ws // 2))
            out = blk(torch.randn(*shape, dim), mask)
            assert out.shape == shape + (dim,)
    # slab calls carry the qkv map (3C), head-split q (Dh), packed qkv (3C)
    assert calls == [("slab", 384), ("headsplit", 32), ("packed", 384)]


def test_slab_block_matches_jax_block_forward_and_gradients():
    """A shifted SwinBlock at C = 128 on a padded map (10 x 10 -> 12 x 12),
    fp32: JAX "pallas_slab" (the slab kernels in interpret mode) against the
    port's "cuda_slab" (the autograd Function's plain halves): output 1e-4,
    d(sum(out * w)) for the input and every parameter within 5e-4 of each
    gradient's largest entry."""
    from mmde_tpu.nn import swin_v2 as jsw
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 10, 10, 128)).astype(np.float32)
    mask = jsw.shifted_window_mask(12, 12, 6, 3)
    jm = jsw.SwinBlock(dim=128, num_heads=4, window_size=6, shift_size=3,
                       pretrain_window_size=4, attn_impl="pallas_slab")
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(x), jnp.asarray(mask)))
    params = randomize_tree(v["params"], rng)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def fwd(p, xx):
        return jm.apply({"params": p}, xx, jnp.asarray(mask))

    want_out, vjp = jax.vjp(jax.jit(fwd), jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(w))
    want_out = np.asarray(want_out)
    tm = tsw.SwinBlock(128, 4, 6, shift_size=3, pretrain_window_size=4,
                       attn_impl="cuda_slab").eval()
    load_jax_variables(tm, params)
    tx = _t(x).requires_grad_()
    out = tm(tx, _t(mask))
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


_SLAB_SWIN = dict(depths=(2, 2, 2, 2), window_size=(6, 6, 6, 3),
                  pretrain_window_size=(4, 4, 4, 2),
                  use_shift=(True, True, True, False), drop_path_rate=0.1)


def test_two_frame_pallas_slab_matches_jax(monkeypatch):
    """A shallow two-frame model (swin_nano_v2 widths, depths 2/2/2/2,
    decoder_v2, fp32, 64x96 frames) with attn_impl "pallas_slab" on both
    sides: stages 1-2 (C 32 / 64) take the head-split path, stages 3-4
    (C 128 / 256) the slab kernels, stage 3 with its shifted-window mask
    (its 4 x 6 map pads to one window holding four shift regions). The JAX
    tree carries over through
    `load_jax_variables` unchanged (the slab path has the same parameters),
    and depth and pose agree within 1e-4."""
    kw = dict(backbone="swin_nano_v2", decoder="decoder_v2", model_scale=32,
              max_depth=10.0, dtype="float32", attn_impl="pallas_slab")
    jc = jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SLAB_SWIN), **kw)
    tc = tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SLAB_SWIN), **kw)
    assert ttf.resolve_attn_impl(tc) == "cuda_slab"
    rng = np.random.default_rng(31)
    f1 = rng.random((1, 64, 96, 3)).astype(np.float32)
    f2 = rng.random((1, 64, 96, 3)).astype(np.float32)
    jm = j_build_model(jc)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(f1), jnp.asarray(f2),
                                       False))
    g = np.random.default_rng(32)
    variables = {"params": randomize_tree(v["params"], g),
                 "batch_stats": randomize_tree(v["batch_stats"], g)}
    tm = ttf.build_model(tc, device="cpu").eval()
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    back = flatten_tree(to_jax_tree(dict(tm.named_parameters()),
                                    variables["params"]))
    flat = flatten_tree(variables["params"])
    assert sorted(back) == sorted(flat)
    for path in flat:
        np.testing.assert_array_equal(back[path], flat[path])

    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, False))(
        variables, jnp.asarray(f1), jnp.asarray(f2))
    assert np.asarray(want["pred_d1"]).std() > 0.1      # not near-constant
    calls = _block_spies(monkeypatch)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    # per frame batch (two frames on the batch axis): stages 1-2 head-split
    # (q carries Dh), stages 3-4 the slab kernels on the map (3C)
    assert calls == [("headsplit", 32)] * 4 + [("slab", 384)] * 2 + [
        ("slab", 768)] * 2
    for k in ("pred_d1", "pred_d2", "pred_r12", "pred_r21", "pred_t12",
              "pred_t21"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


# ------------------------------------------------------------- the binding

def _c_params(name):
    for src in ("window_attention_fwd.cu", "window_attention_bwd.cu"):
        text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
        m = re.search(r'extern "C" int %s\((.*?)\)\s*{' % name, text, re.S)
        if m:
            return src, [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"C entry point {name} not found")


@pytest.mark.parametrize("entry,argtypes", [
    ("mmde_window_attention_slab_fwd", "_FWD_ARGTYPES"),
    ("mmde_window_attention_slab_fwd_stats", "_FWD_STATS_ARGTYPES"),
    ("mmde_window_attention_slab_bwd", "_BWD_ARGTYPES")])
def test_ctypes_signatures_match_the_cuda_sources(entry, argtypes):
    """No compiler here: hold each ctypes signature to its C entry point,
    parameter by parameter, and the entry to the library the packed module
    builds it into (no new source: the build hash and build_kernels are
    unchanged)."""
    src, params = _c_params(entry)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params)
    assert getattr(tslab, argtypes) == want
    lib_sources = twp._SOURCES_BWD if "bwd" in entry else twp._SOURCES
    assert lib_sources == (src,)
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[names.index("B"):names.index("ws") + 1] == [
        "B", "Hp", "Wp", "C", "nH", "ws"]


def test_sources_template_the_layout_and_keep_the_bwd_tile():
    """The kernels take the layout as a template parameter (one body for the
    packed, head-split and map layouts); the map layout's token divide is a
    multiply by the host's reciprocal."""
    hdr = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_common.cuh")).read()
    assert "struct MapRows" in hdr and "inv_ws" in hdr
    for src in ("window_attention_fwd.cu", "window_attention_bwd.cu"):
        text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
        assert "template <template <typename> class L" in text
        assert "launch<MapRows" in text and "launch<Rows" in text
