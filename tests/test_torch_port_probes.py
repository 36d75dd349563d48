"""PyTorch port vs JAX package: the layout probes (tools/probe_mosaic.py).

The JAX tool's six probes run here in interpret mode, through a test-side
`pallas_call` (interpret=True) that records each kernel's inputs and output;
the port's plain versions (mmde_tpu_torch/tools/probe_layouts.py, what its
CUDA kernels in csrc/probes.cu are held to on the card) take the recorded
inputs and must give the recorded output: exactly for the copies, sums and
scalings, within the JAX probe's rtol = atol = 1e-4 for the rank-4 product.
Nothing in the JAX package or its tools changes.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mmde_tpu_torch.tools import probe_layouts as tpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def recorded(monkeypatch):
    """Every pallas_call made while the fixture is active runs in interpret
    mode; its (inputs, output) pairs land in the returned list."""
    calls = []
    real = pl.pallas_call

    def interpret_call(*args, **kwargs):
        kwargs["interpret"] = True
        fn = real(*args, **kwargs)

        @functools.wraps(fn)
        def run(*inputs):
            out = fn(*inputs)
            calls.append(([np.asarray(x) for x in inputs], np.asarray(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    return calls


def _t(x):
    return torch.from_numpy(np.array(x))


# probe -> (port plain version on the recorded inputs, exact)
_PORT = {
    "lane_carved_blockspec": (lambda x: tpl.lane_carved_plain(_t(x)), True),
    "inkernel_window_reshape": (
        lambda x: tpl.window_rows_plain(_t(x), 30)[0], True),
    "inkernel_reshape_back": (
        lambda x: tpl.window_rows_back_plain(_t(x)[None], 1, 30, 30, 30),
        True),
    "static_lane_slice": (lambda x: tpl.static_slice_plain(_t(x)), True),
    "dynamic_lane_slice": (lambda x: tpl.dynamic_slice_plain(_t(x)), True),
    "rank4_map_block_matmul": (
        lambda x, w: tpl.rank4_matmul_plain(_t(x), _t(w)), False),
}


@pytest.mark.parametrize("name", list(_PORT))
def test_probe_plain_version_matches_the_jax_kernel(name, recorded):
    """The JAX probe passes in interpret mode (its own numpy check), and the
    port's plain version gives the JAX kernel's output on its inputs."""
    probes = _jax_tool("probe_mosaic")
    probes.PROBES[name]()
    assert len(recorded) == 1
    inputs, want = recorded[0]
    plain, exact = _PORT[name]
    got = plain(*inputs).numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_port_runs_the_same_six_probes():
    """One probe of the port per JAX probe, each naming the JAX function and
    pallas_call line it replaces; on the CPU every wrapper takes its plain
    version and every probe passes (the CLI too)."""
    probes = _jax_tool("probe_mosaic")
    assert list(tpl.REPLACES) == list(probes.PROBES)
    src = open(os.path.join(ROOT, "tools", "probe_mosaic.py")).read().split(
        "\n")
    for name, where in tpl.REPLACES.items():
        line = int(where.split(":")[1].split()[0])
        assert src[line - 1].startswith(f"def probe_{name}("), where
        call = int(where.rsplit(":", 1)[1].rstrip(")"))
        assert "pl.pallas_call(" in src[call - 1], where
    recs = tpl.run(device="cpu")
    assert [r["probe"] for r in recs] == list(tpl.REPLACES) + [
        "rank4_map_block_matmul"]
    assert all(r["ok"] for r in recs), recs
    assert tpl.LAUNCHES == {}
    assert tpl.main(["--device", "cpu"]) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        tpl.lane_carved(torch.zeros(4, 64, dtype=torch.float64))
    with pytest.raises(TypeError):
        tpl.rank4_matmul(torch.zeros(1, 30, 30, 128, dtype=torch.float16),
                         torch.zeros(128, 128, dtype=torch.float16), 30)
