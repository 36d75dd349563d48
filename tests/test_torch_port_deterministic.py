"""PyTorch port: deterministic mode honoured by the attention backward.

Under `torch.use_deterministic_algorithms(True)`, read at each call, the
packed and head-split backward sum dbias by K3's windows-innermost pass
(the same bits on every run) in place of the fp32 atomics, at any grid
setting but K4's (itself deterministic); the slab backward takes K3 over
`MapRows` the same way. The routing is read on the CPU with the kernel
launches replaced by recorders; the card run (chip_smoke.py,
`deterministic`) checks the bits.
"""
import warnings

import pytest
import torch

from mmde_tpu_torch.ops import window_attention_headsplit as ths
from mmde_tpu_torch.ops import window_attention_packed as wap
from mmde_tpu_torch.ops import window_attention_slab as was

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


@pytest.fixture
def deterministic():
    """Set torch's deterministic flag for a test; the global flag (and its
    warn_only) come back as they were in `finally`."""
    was_on = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()

    def set_(on: bool, warn_only: bool = False):
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
    try:
        yield set_
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=was_warn)


@pytest.mark.parametrize("on", [False, True])
def test_packed_helper_chooses_split_in_deterministic_mode(deterministic,
                                                           on):
    deterministic(on)
    assert wap.backward_grid_mode("window_resident") == (
        "split" if on else "window_resident")
    assert wap.backward_grid_mode("split") == "split"
    assert wap.backward_grid_mode("bias_resident") == "bias_resident"
    assert ths.dbias_split() == (on or wap.DEFAULT_GRID_MODE == "split")


def _record_packed(monkeypatch):
    seen = {}

    def passes(qkv, ls, bias, mask, lse, g, nH, atomics, w, mxu, fma):
        seen["atomics"] = atomics
        B_, N, C3 = qkv.shape
        dbias = torch.zeros(nH, N, N) if atomics else None
        return (torch.zeros_like(qkv), torch.zeros(nH, 1, 1), dbias,
                torch.zeros(B_, nH, N))

    def dbias(qkv, ls, bias, mask, lse, g, delta, nH, mxu=None, _fma=False):
        seen["k3"] = True
        return torch.ones(nH, qkv.shape[1], qkv.shape[1])

    monkeypatch.setattr(wap, "_backward_passes", passes)
    monkeypatch.setattr(wap, "_launch_dbias", dbias)
    return seen


@pytest.mark.parametrize("on,w", [(False, 1), (True, 1), (True, 4)])
def test_packed_backward_takes_k3_in_deterministic_mode(monkeypatch,
                                                        deterministic, on,
                                                        w):
    """The window-grid backward at W windows a block: atomics off and K3
    after the passes in deterministic mode, atomics otherwise."""
    deterministic(on)
    seen = _record_packed(monkeypatch)
    nH, N = 2, 16
    qkv = torch.zeros(8, N, 3 * nH * 32)
    bias = torch.zeros(nH, N, N)
    out = wap._launch_backward(qkv, torch.zeros(nH, 1, 1), bias, None,
                               None, None, nH, "window_resident",
                               want_dbias=True, w=w)
    assert seen["atomics"] is not on
    assert seen.get("k3", False) is on
    assert torch.equal(out[2], torch.ones(nH, N, N) if on
                       else torch.zeros(nH, N, N))


@pytest.mark.parametrize("on", [False, True])
def test_headsplit_backward_takes_k3_in_deterministic_mode(monkeypatch,
                                                           deterministic,
                                                           on):
    deterministic(on)
    seen = {}

    def passes(q, k, v, ls, bias, mask, lse, g, want_dbias, split, fma):
        seen["split"] = split
        B_, nH, N, _ = q.shape
        return (q, k, v, torch.zeros(nH, 1, 1),
                None if split else torch.zeros(nH, N, N),
                torch.zeros(B_, nH, N))

    def dbias(q, k, v, g, ls, bias, mask, lse, delta):
        seen["k3"] = True
        return torch.ones(q.shape[1], q.shape[2], q.shape[2])

    monkeypatch.setattr(ths, "_backward_passes", passes)
    monkeypatch.setattr(ths, "_launch_dbias", dbias)
    q = torch.zeros(4, 3, 16, 32)
    out = ths._launch_backward(q, q, q, torch.zeros(3, 1, 1),
                               torch.zeros(3, 16, 16), None, None, q,
                               want_dbias=True)
    split = on or wap.DEFAULT_GRID_MODE == "split"
    assert seen["split"] is split and seen.get("k3", False) is split
    assert float(out[4].sum()) == (3 * 16 * 16 if split else 0.0)


def _record_slab(monkeypatch):
    seen = {}

    def passes(qkv, ls, bias, mask, lse, g, nH, ws, atomics, tc):
        seen["atomics"] = atomics
        B, Hp, Wp, C3 = qkv.shape
        N = ws * ws
        dbias = torch.zeros(nH, N, N) if atomics else None
        return (torch.zeros_like(qkv), torch.zeros(nH, 1, 1), dbias,
                torch.zeros(B * (Hp // ws) * (Wp // ws), nH, N))

    def dbias(qkv, ls, bias, mask, lse, g, delta, nH, ws):
        seen["k3"] = True
        return torch.ones(nH, ws * ws, ws * ws)

    monkeypatch.setattr(was, "_backward_passes", passes)
    monkeypatch.setattr(was, "_launch_dbias", dbias)
    return seen


def test_slab_backward_raises_or_warns_in_deterministic_mode(monkeypatch,
                                                             deterministic):
    """The slab backward has K3 over MapRows now: in deterministic mode,
    strict or warn_only, it neither raises nor warns - its passes run
    without atomics and K3 sums dbias after them; without dbias wanted, or
    outside deterministic mode (grid mode not "split"), the atomics as
    before."""
    seen = _record_slab(monkeypatch)
    nH, ws = 4, 6
    qkv = torch.zeros(2, 12, 6, 3 * nH * 32)
    g = torch.zeros(2, 12, 6, nH * 32)
    lse = torch.zeros(2 * 2, nH, ws * ws)
    bias = torch.zeros(nH, ws * ws, ws * ws)
    ls = torch.zeros(nH, 1, 1)
    for on, warn_only in ((True, False), (True, True)):
        deterministic(on, warn_only)
        seen.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = was._launch_backward(qkv.bfloat16(), ls, bias, None, lse,
                                       g.bfloat16(), nH, ws, want_dbias=True)
        assert seen == {"atomics": False, "k3": True}
        assert torch.equal(out[2], torch.ones(nH, ws * ws, ws * ws))
        seen.clear()
        was._launch_backward(qkv.bfloat16(), ls, bias, None, lse,
                             g.bfloat16(), nH, ws, want_dbias=False)
        assert seen == {"atomics": False}
    deterministic(False)
    seen.clear()
    was._launch_backward(qkv.bfloat16(), ls, bias, None, lse, g.bfloat16(),
                         nH, ws, want_dbias=True)
    split = wap.DEFAULT_GRID_MODE == "split"
    assert seen == ({"atomics": False, "k3": True} if split
                    else {"atomics": True})
