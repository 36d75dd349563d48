"""PyTorch port vs JAX package: the packed kernels' precision modes (mxu).

The JAX package's packed attention takes `mxu` ("fp32" / "fold" / "bf16"),
by default MMDE_ATTN_MXU read at import ("auto" = "fold") for bf16 qkv and
"fp32" for fp32 qkv. The port's kernels take the same modes as a
template parameter, chosen at run time by an argument of the packed C
entry points (one library holds every mode); on CPU tensors its wrapper
runs the plain versions in the mode asked for. Here the port's forward and
gradients (qkv, logit_scale, bias) are held to the JAX op's in interpret
mode for each mode, on fp32 qkv with the mode passed explicitly, at N = 49
and at the q-tiled N = 500; the wrapper's default and the environment
variable are checked as well. The kernels themselves are held to these
plain versions on the card by chip_smoke.py (kernel_cases_mxu).
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
from mmde_tpu_torch.ops import window_attention_packed as twp

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(B, nH, N, nW, seed):
    """numpy float32 qkv, logit_scale (<= 3, ROADMAP F1), 16*sigmoid bias,
    0/-100 mask (diagonal kept), output gradient."""
    rng = np.random.default_rng(seed)
    C = nH * 32
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    ls = np.minimum(rng.standard_normal((nH, 1, 1)) * 0.5 + 2.0, 3.0
                    ).astype(np.float32)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)
    m = (rng.random((nW, N, N)) < 0.3) & ~np.eye(N, dtype=bool)[None]
    mask = np.where(m, -100.0, 0.0).astype(np.float32)
    g = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, ls, bias, mask, g


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_run(qkv, ls, bias, mask, g, nH, mxu):
    """The JAX op's output and (dqkv, dlogit_scale, dbias) in interpret
    mode, bias handed over as plain (nH, N, N)."""
    N, C = qkv.shape[1], qkv.shape[2] // 3
    _, Np, _, HG, nG, _ = jwap.attention_plan(N, nH, 32, C)

    def f(q, l, b_hnn):
        bp = jwap.pack_rpe_bias(jnp.transpose(b_hnn, (1, 2, 0)), nG, HG, Np)
        return jwap.cosine_window_attention_packed(
            q, l, bp, jnp.asarray(mask), num_heads=nH, mxu=mxu,
            interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(ls),
                       jnp.asarray(bias))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_run(qkv, ls, bias, mask, g, nH, mxu):
    leaves = [_t(x).requires_grad_() for x in (qkv, ls, bias)]
    out = twp.cosine_window_attention_packed(*leaves, _t(mask), num_heads=nH,
                                             mxu=mxu)
    out.backward(_t(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


_CASES = {}


def _case(N, mxu):
    """Both sides' results at one (N, mode), computed once per process."""
    key = (N, mxu)
    if key not in _CASES:
        B, nH, nW = (4, 4, 2) if N == 49 else (2, 4, 2)
        x = _inputs(B, nH, N, nW, seed=N)
        _CASES[key] = (_jax_run(*x, nH, mxu), _port_run(*x, nH, mxu))
    return _CASES[key]


@pytest.mark.parametrize("N", [49, 500])
@pytest.mark.parametrize("mxu", ["fp32", "fold", "bf16"])
def test_port_matches_jax_in_each_mode(N, mxu):
    """fp32 qkv, the mode passed explicitly: output and the three gradients
    within 1e-5 of the JAX op's (max abs, relative to the largest value of
    the JAX result). N = 500 takes the JAX plan's q tiles (and the row
    padding, -1e9 columns).

    One case is bounded otherwise: "bf16" at N = 500. There the JAX side's
    (48, 528) q^k^T tiles and torch's (500, 500) product sum in another
    order (measured: 24 % of the fp32 logits bit-equal, all within an ulp),
    and an ulp can carry an operand across a bf16 rounding boundary, which
    moves that one operand by 2^-8 of itself. Those isolated flips bound
    that case at rel-L2 5e-5 and max abs 5e-4 (measured 2.5e-5 / 1.9e-4;
    at N = 49 the products are bit-equal and the case is within 1e-5)."""
    (j_out, j_grads), (t_out, t_grads) = _case(N, mxu)
    flips = mxu == "bf16" and N == 500
    for name, a, b in zip(("out", "dqkv", "dlogit_scale", "dbias"),
                          [t_out] + t_grads, [j_out] + j_grads):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert err <= (5e-4 if flips else 1e-5), (name, N, mxu, err)
        assert rel_l2 <= (5e-5 if flips else 1e-5), (name, N, mxu, rel_l2)
        assert float(np.abs(b).max()) > 1e-3, name


@pytest.mark.parametrize("N", [49, 500])
def test_bf16_mode_differs_from_fp32(N):
    """The bf16 mode rounds every product's operands: its output and its
    qkv gradient differ from the exact mode's by more than 1e-4 (measured
    on the JAX side: ~2.6e-3 output rel-L2), on both sides alike; "fold"
    stays within rounding of "fp32"."""
    for side in (0, 1):
        exact = _case(N, "fp32")[side]
        fold = _case(N, "fold")[side]
        rnd = _case(N, "bf16")[side]
        for a, b, c in zip([exact[0]] + exact[1], [rnd[0]] + rnd[1],
                           [fold[0]] + fold[1]):
            scale = float(np.abs(a).max())
            assert float(np.abs(b - a).max()) / scale > 1e-4
            assert float(np.abs(c - a).max()) / scale < 1e-5


def test_default_mode_follows_the_type():
    """mxu=None: "fold" (MXU_BF16_DEFAULT) for bf16 qkv, "fp32" for fp32 qkv;
    a value the JAX body does not name computes as "fp32" (no error), as in
    JAX; the plain versions resolve the same way."""
    assert twp.MXU_BF16_DEFAULT == jwap.MXU_BF16_DEFAULT == "fold"
    assert twp.resolve_mxu(None, torch.bfloat16) == "fold"
    assert twp.resolve_mxu(None, torch.float32) == "fp32"
    assert twp.resolve_mxu("bf16", torch.float32) == "bf16"
    assert twp.resolve_mxu("nonsense", torch.bfloat16) == "fp32"
    qkv, ls, bias, mask, _ = _inputs(2, 4, 36, 2, seed=3)
    q16 = _t(qkv).bfloat16()
    b16 = _t(bias).bfloat16()
    m16 = _t(mask).bfloat16()
    got = twp.cosine_window_attention_packed(q16, _t(ls), b16, m16,
                                             num_heads=4)
    fold = twp.cosine_window_attention_packed_plain(q16, _t(ls), b16, m16,
                                                    num_heads=4, mxu="fold")
    assert torch.equal(got, fold)
    odd = twp.cosine_window_attention_packed(_t(qkv), _t(ls), _t(bias),
                                             _t(mask), num_heads=4, mxu="x")
    exact = twp.cosine_window_attention_packed(_t(qkv), _t(ls), _t(bias),
                                               _t(mask), num_heads=4)
    assert torch.equal(odd, exact)


def test_wrapper_routes_the_mode_to_the_kernels(monkeypatch):
    """On a card the wrapper hands the resolved mode to both launches
    (K1 / K2, K5 alike): the default for a bf16 model is "fold"; an explicit
    mode reaches forward and backward; K4 (bias_resident) gets no mode."""
    calls = []

    def fwd(qkv, ls, bias, mask, nH, maxfree, want_stats, w=1, mxu=None,
            _fma=False):
        assert not _fma      # the model path: the tensor-core body
        calls.append(("fwd", mxu))
        B_, N, C3 = qkv.shape
        return (torch.zeros(B_, N, C3 // 3, dtype=qkv.dtype),
                torch.zeros(B_, nH, N) if want_stats else None)

    def bwd(qkv, ls, bias, mask, lse, g, nH, grid_mode, want_dbias, w=1,
            mxu=None, _fma=False):
        assert not _fma
        calls.append(("bwd", mxu))
        return torch.zeros_like(qkv), torch.zeros_like(ls), \
            torch.zeros_like(bias)

    def resident(qkv, ls, bias, mask, g, nH, want_dbias=True, _fma=False):
        assert not _fma
        calls.append(("resident",))
        return torch.zeros_like(qkv), torch.zeros_like(ls), \
            torch.zeros_like(bias)

    monkeypatch.setattr(twp, "_launch_forward", fwd)
    monkeypatch.setattr(twp, "_launch_backward", bwd)
    monkeypatch.setattr(twp, "_launch_backward_resident", resident)

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    qkv, ls, bias, mask, g = _inputs(2, 4, 36, 2, seed=5)
    for dtype, mxu, grid, want in (
            (torch.bfloat16, None, "window_resident", "fold"),
            (torch.float32, None, "window_resident", "fp32"),
            (torch.float32, "bf16", "split", "bf16"),
            (torch.bfloat16, "bf16", "bias_resident", "bf16")):
        calls.clear()
        q = _t(qkv).to(dtype).as_subclass(OnCard).requires_grad_()
        out = twp.cosine_window_attention_packed(
            q, _t(ls), _t(bias).to(dtype), _t(mask).to(dtype), num_heads=4,
            mxu=mxu, grid_mode=grid)
        out.backward(torch.ones(out.shape, dtype=dtype))
        second = ("resident",) if grid == "bias_resident" else ("bwd", want)
        assert calls == [("fwd", want), second], (dtype, mxu, grid)


_MXU_PROBE = """
import torch
from mmde_tpu_torch.ops import window_attention_packed as twp
print(twp.MXU_BF16_DEFAULT, twp.resolve_mxu(None, torch.bfloat16),
      twp.resolve_mxu(None, torch.float32))
"""


@pytest.mark.parametrize("value,want", [("bf16", "bf16 bf16 fp32"),
                                        ("auto", "fold fold fp32"),
                                        (None, "fold fold fp32"),
                                        ("fp32", "fp32 fp32 fp32")])
def test_environment_variable_selects_the_mode_at_import(value, want):
    """MMDE_ATTN_MXU is read once at import, as in the JAX package: it
    sets the mode of bf16 calls; fp32 calls stay "fp32"."""
    env = {k: v for k, v in os.environ.items() if k != "MMDE_ATTN_MXU"}
    if value is not None:
        env["MMDE_ATTN_MXU"] = value
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", _MXU_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == want.split()


def test_mode_codes_match_the_cuda_sources():
    """No compiler here: the wrapper's mode codes are the header's, and
    every packed C entry point takes the mode as its `int mxu` argument,
    just before the stream; the head-split and slab entries take none."""
    import re
    from mmde_tpu_torch.ops import cuda_build
    hdr = open(os.path.join(cuda_build.CSRC_DIR,
                            "window_attention_common.cuh")).read()
    for name, code in (("FP32", 0), ("FOLD", 1), ("BF16", 2),
                       ("FOLD_PV", 3)):
        assert f"constexpr int MXU_{name} = {code};" in hdr
    assert twp._MXU_CODE == {"fp32": 0, "fold": 1, "bf16": 2,
                             "fold_pv_bf16": 3}
    entries = {}
    for src in ("window_attention_fwd.cu", "window_attention_bwd.cu"):
        text = open(os.path.join(cuda_build.CSRC_DIR, src)).read()
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{', text,
                             re.S):
            entries[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    packed = ("mmde_window_attention_fwd", "mmde_window_attention_fwd_stats",
              "mmde_window_attention_fwd_w", "mmde_window_attention_bwd",
              "mmde_window_attention_bwd_w", "mmde_window_attention_dbias")
    for name, params in entries.items():
        assert params[-1] == "void* stream", name
        assert (params[-2] == "int mxu") == (name in packed), name
    assert set(packed) <= set(entries)
