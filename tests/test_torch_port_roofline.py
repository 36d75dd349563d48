"""PyTorch port vs JAX package: the roofline micro-kernels
(tools/roofline.py, T3) and the port's cost arithmetic.

The JAX tool's `_vpu_kernel` (add / exp / row-sum chains on a (512, 1024)
fp32 block) and `_mxu_kernel` (the 4-head (304, 32) x (912, 32)^T dot
pattern, fp32 and bf16 operands, fp32 accumulator) run here at iters = 2 in
interpret mode, through a test-side `pallas_call` (interpret=True); the
port's plain versions (mmde_tpu_torch/tools/roofline.py, what the CUDA
micro-kernels in csrc/roofline.cu are held to on the card) must give the
same results within 1e-6 relative. Nothing in the JAX package or its tools
changes.
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mmde_tpu_torch.tools import roofline as trl

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_roofline", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("op", ["add", "exp", "rowsum"])
def test_chain_plain_matches_the_jax_vpu_kernel(op, interpret):
    f, x, n = _jax_tool()._vpu_kernel(op, 2)
    want = np.asarray(f(x))
    assert len(interpret) == 1 and n == 512 * 1024 * 8
    xt = torch.from_numpy(np.array(x))
    got = (trl.rowsum_plain(xt, 2) if op == "rowsum"
           else trl.chain_plain(xt, op, 2)).numpy()
    assert _rel(got, want) <= 1e-6, op
    assert float(np.abs(want - np.asarray(x)).max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_plain_matches_the_jax_mxu_kernel(dtype, interpret):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    f, (q, k), flops = _jax_tool()._mxu_kernel(32, jdt, 2)
    want = np.asarray(f(q, k))
    assert len(interpret) == 1
    assert flops == 4 * 2 * trl.DOT_BQ * trl.DOT_NP * trl.DOT_DH
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tk = torch.from_numpy(np.array(k.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = trl.dot(tq, tk, 2).numpy()[0]
    assert got.shape == want.shape == (trl.DOT_BQ, trl.DOT_NP)
    assert _rel(got, want) <= 1e-6


def test_dot_plain_on_random_operands_is_the_head_sum():
    """Beyond the JAX tool's all-ones inputs: random operands, the plain dot
    equals iters times q k^T over the 128 summed channels."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((40, 128)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((24, 128)).astype(np.float32))
    np.testing.assert_allclose(trl.dot_plain(q, k, 3).numpy(),
                               3 * (q @ k.T).numpy(), rtol=1e-5, atol=1e-4)


def test_every_micro_kernel_runs_its_plain_version_on_the_cpu():
    """check() on the CPU: every wrapper takes its plain version (no launch
    counted), every case agrees, every bound is positive."""
    recs = trl.check(device="cpu", iters=2)
    assert [r["name"] for r in recs] == [
        "chain_add", "chain_fma", "chain_exp", "chain_fastexp", "rowsum",
        "dot_fp32", "dot_bf16", "copy"]
    assert all(r["ok"] and r["bound_ms"] > 0 for r in recs), recs
    assert trl.LAUNCHES == {}


def test_stages_are_the_jax_tools_table():
    """stages(8) is the JAX tool's STAGES (bs8: B_, nH, N, C, masked,
    blocks), with the mask's window count for its flag."""
    jst = _jax_tool().STAGES
    for name, (B_, nH, N, C, nW, nb) in trl.stages(8).items():
        assert jst[name] == (B_, nH, N, C, nW > 0, nb), name


def test_attention_cost_counts_the_ports_tiles():
    """K1: two 64 x 64 x 32 tile products and one exp per (query tile, key
    tile); K2: eight products and two exps (nine and three under "bf16");
    times are the counts over the given rates."""
    rates = {"dot_fp32_TFLOP_s": 50.0, "fastexp_Gel_s": 2000.0,
             "copy_GB_s": 3000.0}
    B_, nH, N, C, nW = 96, 4, 900, 128, 24
    c = trl.attention_cost(B_, nH, N, C, nW, rates)
    tiles = B_ * nH * 15 * 15
    assert c["fwd"]["flops"] == 2 * 2 * 64 * 64 * 32 * tiles
    assert c["bwd"]["flops"] == 2 * 8 * 64 * 64 * 32 * tiles
    assert c["fwd"]["exps"] == 64 * 64 * tiles
    assert c["bwd"]["exps"] == 2 * 64 * 64 * tiles
    assert c["fwd"]["fma_ms"] == pytest.approx(
        c["fwd"]["flops"] / 50e12 * 1e3)
    assert c["fwd"]["bytes"] == (B_ * N * 4 * C * 2 + (nH + nW) * N * N * 2
                                 + B_ * nH * N * 4)
    b = trl.attention_cost(B_, nH, N, C, nW, rates, mxu="bf16")["bwd"]
    assert b["flops"] == 2 * 9 * 64 * 64 * 32 * tiles
    assert b["exps"] == 3 * 64 * 64 * tiles
    buckets = dict(trl.fixed_buckets(dict(rates, dot_bf16_TFLOP_s=400.0), 8))
    assert set(buckets) == {"decoder tail + pose", "fp32 LayerNorm traffic",
                            "K2 dbias fp32 atomics"}


def test_replaces_names_the_jax_kernels_lines():
    src = open(os.path.join(ROOT, "tools", "roofline.py")).read().split("\n")
    assert src[85].startswith("def _vpu_kernel(")
    assert src[114].startswith("def _mxu_kernel(")
    assert "pl.pallas_call(" in src[109] and "pl.pallas_call(" in src[142]
    assert ":86" in trl.REPLACES["vpu"] and ":110" in trl.REPLACES["vpu"]
    assert ":115" in trl.REPLACES["mxu"] and ":143" in trl.REPLACES["mxu"]
