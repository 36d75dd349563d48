"""PyTorch port vs JAX package: the attention functions.

Inputs come from numpy generators and go through both frameworks on the
CPU. The port's packed function runs its plain version here (the wrapper
takes it because the tensors lie on the CPU); the JAX packed function runs
its Pallas kernel in interpret mode, as tests/test_packed_attention.py does.
The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu.ops import window_attention as jwa
from mmde_tpu.ops.window_attention_packed import (
    attention_plan, cosine_window_attention_packed as j_packed,
    pack_rpe_bias)
from mmde_tpu_torch.ops import window_attention as twa
from mmde_tpu_torch.ops import window_attention_packed as twp

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _qkv_inputs(B=6, nH=8, N=49, Dh=32, nW=3, with_mask=True, seed=0):
    rng = np.random.default_rng(seed)
    C = nH * Dh
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    # log temperatures around 1: the JAX kernel's static softmax shift
    # underflows for scale >~ 30 (see mmde_tpu_torch.testing)
    ls = (rng.standard_normal((nH, 1, 1)) * 0.5 + 1.0).astype(np.float32)
    bias = (16.0 / (1.0 + np.exp(-rng.standard_normal((nH, N, N))))
            ).astype(np.float32)                     # 16*sigmoid: in (0, 16)
    mask = None
    if with_mask:
        m = rng.random((nW, N, N)) < 0.3
        m &= ~np.eye(N, dtype=bool)[None]
        mask = np.where(m, -100.0, 0.0).astype(np.float32)
    return qkv, ls, bias, mask


def _split(qkv, nH):
    B, N, C3 = qkv.shape
    Dh = C3 // 3 // nH
    x = qkv.reshape(B, N, 3, nH, Dh).transpose(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cosine_window_attention_matches_jax(with_mask):
    qkv, ls, bias, mask = _qkv_inputs(with_mask=with_mask, seed=1)
    q, k, v = _split(qkv, 8)
    want = np.asarray(jwa.cosine_window_attention(
        _j(q), _j(k), _j(v), _j(ls), _j(bias), _j(mask)))
    got = twa.cosine_window_attention(
        _t(q), _t(k), _t(v), _t(ls), _t(bias), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_scaled_window_attention_matches_jax(with_mask):
    qkv, _, bias, mask = _qkv_inputs(with_mask=with_mask, seed=2)
    q, k, v = _split(qkv, 8)
    scale = 32 ** -0.5
    want = np.asarray(jwa.scaled_window_attention(
        _j(q), _j(k), _j(v), scale, _j(bias), _j(mask)))
    got = twa.scaled_window_attention(
        _t(q), _t(k), _t(v), scale, _t(bias), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_max_logit_scale_and_clamp():
    assert twa.MAX_LOGIT_SCALE == jwa.MAX_LOGIT_SCALE
    qkv, ls, bias, _ = _qkv_inputs(B=2, nH=2, N=16, with_mask=False, seed=3)
    q, k, v = _split(qkv, 2)
    hot = np.full_like(ls, 9.0)            # far above ln(100): clamped
    at = np.full_like(ls, twa.MAX_LOGIT_SCALE)
    a = twa.cosine_window_attention(_t(q), _t(k), _t(v), _t(hot), _t(bias))
    b = twa.cosine_window_attention(_t(q), _t(k), _t(v), _t(at), _t(bias))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_pallas(qkv, ls, bias_hnn, mask, nH):
    """The JAX packed kernel in interpret mode (off-TPU default)."""
    C = qkv.shape[-1] // 3
    _, Np, _, HG, nG, _ = attention_plan(qkv.shape[1], nH, C // nH, C)
    bp = pack_rpe_bias(jnp.transpose(bias_hnn, (1, 2, 0)), nG, HG, Np)
    return j_packed(qkv, _j(ls), bp.astype(bias_hnn.dtype), mask,
                    num_heads=nH)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n", [36, 49])
def test_packed_plain_matches_jax_pallas_interpret(with_mask, n):
    qkv, ls, bias, mask = _qkv_inputs(N=n, with_mask=with_mask, seed=4)
    want = np.asarray(_jax_pallas(_j(qkv), ls, _j(bias), _j(mask), 8))
    got = twp.cosine_window_attention_packed_plain(
        _t(qkv), _t(ls), _t(bias), _t(mask), num_heads=8).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the public wrapper takes the same path for CPU tensors
    before = twp.LAUNCHES
    via = twp.cosine_window_attention_packed(
        _t(qkv), _t(ls), _t(bias), _t(mask), num_heads=8).numpy()
    np.testing.assert_array_equal(via, got)
    assert twp.LAUNCHES == before        # no kernel launch on the CPU


def test_packed_plain_matches_jax_pallas_bf16():
    """bf16 qkv / bias / mask, as a bf16 model feeds the kernel. Both sides
    accumulate in fp32 and round the output once to bf16 (2^-9 relative),
    so rel-L2 <= 1e-2."""
    qkv, ls, bias, mask = _qkv_inputs(N=49, with_mask=True, seed=5)
    jq = _j(qkv).astype(jnp.bfloat16)
    want = np.asarray(_jax_pallas(jq, ls, _j(bias).astype(jnp.bfloat16),
                                  _j(mask).astype(jnp.bfloat16), 8
                                  ).astype(jnp.float32))
    got = twp.cosine_window_attention_packed(
        _t(qkv).bfloat16(), _t(ls), _t(bias).bfloat16(),
        _t(mask).bfloat16(), num_heads=8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


def test_packed_matches_split_head_plain():
    qkv, ls, bias, mask = _qkv_inputs(B=4, nH=4, N=25, nW=2, seed=6)
    q, k, v = _split(qkv, 4)
    ref = twa.cosine_window_attention(_t(q), _t(k), _t(v), _t(ls), _t(bias),
                                      _t(mask))
    ref = ref.permute(0, 2, 1, 3).reshape(4, 25, 128)
    got = twp.cosine_window_attention_packed_plain(
        _t(qkv), _t(ls), _t(bias), _t(mask), num_heads=4)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "bias_shape",
                                 "mask_windows", "contiguous", "rank"])
def test_packed_wrapper_rejects(bad):
    qkv, ls, bias, mask = map(_t, _qkv_inputs(B=4, nH=2, N=16, nW=2, seed=7))
    nH = 2
    err = (ValueError, TypeError, NotImplementedError)
    if bad == "head_dim":
        nH = 4                                  # Dh = 16
        ls, bias = ls.repeat(2, 1, 1), bias.repeat(2, 1, 1)
    elif bad == "dtype":
        qkv = qkv.half()
    elif bad == "bias_shape":
        bias = bias[:, :15]
    elif bad == "mask_windows":
        mask = mask.repeat(2, 1, 1)[:3]          # 4 % 3 != 0
    elif bad == "contiguous":
        qkv = qkv.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "rank":
        qkv = qkv[0]
    with pytest.raises(err):
        twp.cosine_window_attention_packed(qkv, ls, bias, mask, num_heads=nH)
