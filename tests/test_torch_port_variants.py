"""PyTorch port vs JAX package: the attention-body variants
(tools/bench_attention_variants.py, T2).

The JAX tool's `forward` runs its five body variants (v0 exact, v1 folded
scale, v2 one-expression epilogue, v3 bf16 operands, v4 bf16 p v only) in
one pallas_call; here it runs in interpret mode through a test-side
`pallas_call` (interpret=True) at N = 49, C = 128, 4 heads, bf16, with the
JAX tool's kind of inputs. The port's variant functions on the CPU (the
plain versions its kernels are held to on the card:
`mmde_tpu_torch.tools.bench_attention_variants._plain`, i.e. the packed
kernels' plain forward in the variant's precision mode) must give each
variant's bf16 output within one bf16 ulp. Nothing in the JAX package or
its tools changes.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mmde_tpu.ops.window_attention_packed import (attention_plan,
                                                  pack_rpe_bias)
from mmde_tpu_torch.tools import bench_attention_variants as tbv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_bench_attention_variants",
        os.path.join(ROOT, "tools", "bench_attention_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode; the calls' (inputs, output) land in
    the returned list."""
    calls = []
    real = pl.pallas_call

    def interpret_call(*args, **kwargs):
        kwargs["interpret"] = True
        fn = real(*args, **kwargs)

        @functools.wraps(fn)
        def run(*inputs):
            out = fn(*inputs)
            calls.append((inputs, out))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    return calls


def _inputs(B=4, nH=4, N=49, nW=2, seed=0):
    """The JAX tool's kind of inputs, from numpy: bf16 qkv ~ N(0, 1), logit
    scale 1, bias ~ N(0, 1) as (N, N, nH), mask 20 % -100."""
    rng = np.random.default_rng(seed)
    C = nH * 32
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    bias_nnh = rng.standard_normal((N, N, nH)).astype(np.float32)
    mask = np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0
                    ).astype(np.float32)
    return qkv, bias_nnh, mask


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance between a and b in bf16 steps (both bf16 values)."""
    ia = torch.from_numpy(np.array(a)).bfloat16().view(torch.int16).int()
    ib = torch.from_numpy(np.array(b)).bfloat16().view(torch.int16).int()
    # sign-magnitude -> a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
def test_variant_matches_the_jax_body(variant, interpret):
    qkv, bias_nnh, mask = _inputs()
    nH, N, C = 4, 49, 128
    _, Np, _, HG, nG, _ = attention_plan(N, nH, 32, C)
    jq = jnp.asarray(qkv).astype(jnp.bfloat16)
    ls = jnp.ones((nH, 1, 1), jnp.float32)
    bp = pack_rpe_bias(jnp.asarray(bias_nnh), nG, HG, Np).astype(jnp.bfloat16)
    jm = jnp.asarray(mask).astype(jnp.bfloat16)
    want = np.asarray(_jax_tool().forward(jq, ls, bp, jm, nH, variant
                                          ).astype(jnp.float32))
    assert len(interpret) == 1
    tq = torch.from_numpy(qkv).bfloat16()
    tb = torch.from_numpy(np.ascontiguousarray(
        bias_nnh.transpose(2, 0, 1))).bfloat16()
    tm = torch.from_numpy(mask).bfloat16()
    got = tbv.forward(tq, torch.ones(nH, 1, 1), tb, tm, nH, variant)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _bf16_ulps(got.float().numpy(), want) <= 1, variant


def test_variants_differ_as_the_jax_tool_measured():
    """v1 / v2 within fp32 rounding of v0, v3 and v4 a bf16 rounding away
    (the JAX tool's own readings at this size: 0 / 1.5e-8 / 1.5e-8 /
    1.6e-2 / 3.9e-3 max |diff| vs v0); v2 is v1's launch."""
    qkv, bias_nnh, mask = _inputs(seed=1)
    tq = torch.from_numpy(qkv).bfloat16()
    tb = torch.from_numpy(np.ascontiguousarray(
        bias_nnh.transpose(2, 0, 1))).bfloat16()
    tm = torch.from_numpy(mask).bfloat16()
    outs = [tbv.forward(tq, torch.ones(4, 1, 1), tb, tm, 4, v).float()
            for v in range(5)]
    diff = [float((o - outs[0]).abs().max()) for o in outs]
    assert torch.equal(outs[1], outs[2])
    assert diff[1] <= 2 ** -7 and diff[3] > diff[1] and diff[4] > 0
    assert tbv.VARIANTS == {0: "fp32", 1: "fold", 2: "fold", 3: "bf16",
                            4: "fold_pv_bf16"}


def test_run_fails_a_variant_that_ignores_its_mode(monkeypatch):
    """The tool's run (plain versions on the CPU) passes every variant at
    the JAX tool's stage s4, and fails v3 when its launch computes v1's
    mode: its output then lies nearer v1's plain version than its own."""
    recs = tbv.run(["s4"], timed=False, device="cpu")
    assert [r["variant"] for r in recs] == ["v0", "v1", "v2", "v3", "v4"]
    assert all(r["ok"] for r in recs)
    assert all(r["rel_l2_to_v1_plain"] > 0 for r in recs[3:])
    real = tbv.forward
    monkeypatch.setattr(tbv, "forward", lambda q, ls, b, m, nH, v: real(
        q, ls, b, m, nH, 1 if v == 3 else v))
    recs = tbv.run(["s4"], timed=False, device="cpu")
    assert [r["ok"] for r in recs] == [True, True, True, False, True]


def test_stage_table_is_the_jax_tools():
    assert tbv.STAGES == _jax_tool().STAGES
    src = open(os.path.join(ROOT, "tools", "bench_attention_variants.py")
               ).read().split("\n")
    assert src[46].startswith("def _fwd_body(")
    assert src[103].startswith("def forward(")
    assert "pl.pallas_call(" in src[138]
    assert ":47" in tbv.REPLACES and ":104" in tbv.REPLACES \
        and ":139" in tbv.REPLACES


def test_v4_library_is_its_own_build():
    """v4 is K1's source built with MMDE_FOLD_PV=1 into a library of its
    own, which the production path never loads; the source instantiates
    that mode only under the define."""
    (name, (sources, defines)), = tbv.library_specs().items()
    from mmde_tpu_torch.ops import window_attention_packed as wap
    assert name not in wap.library_specs()
    assert sources == wap._SOURCES and defines == ("MMDE_FOLD_PV=1",)
    assert all(d == () for _, d in wap.library_specs().values())
    hdr = open(os.path.join(ROOT, "mmde_tpu_torch", "csrc",
                            "window_attention_common.cuh")).read()
    assert "#if MMDE_FOLD_PV\n    case MXU_FOLD_PV:" in hdr
