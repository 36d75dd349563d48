"""PyTorch port vs JAX package: layers and decoders on the CPU.

Flax applies a ConvTranspose kernel unflipped while torch's transposed
convolution reverses the taps, and eval-mode BatchNorm with identity
statistics flattens the spatial signal that would show it — so every case
here draws its weights and running statistics with numpy at O(1) scale and
asserts that the output actually varies before comparing.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmde_tpu import geometry as jgeo
from mmde_tpu.nn import decoders as jdec
from mmde_tpu.nn import layers as jl
from mmde_tpu_torch import geometry as tgeo
from mmde_tpu_torch.ckpt.from_jax import convert_value, load_jax_variables
from mmde_tpu_torch.nn import decoders as tdec
from mmde_tpu_torch.nn import layers as tl
from mmde_tpu_torch.testing import randomize_tree

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


class _JDeconv(nn.Module):
    features: int
    k: int

    @nn.compact
    def __call__(self, x):
        return jl.torch_deconv(x, self.features, self.k, dtype=jnp.float32,
                               name="deconv_0",
                               kernel_init=nn.initializers.normal(0.1))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_torch_deconv_geometries_match_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = _JDeconv(features=4, k=k)
    params = jax.device_get(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    kernel = rng.standard_normal(params["deconv_0"]["kernel"].shape
                                 ).astype(np.float32)
    want = np.asarray(jm.apply({"params": {"deconv_0": {"kernel": kernel}}},
                               jnp.asarray(x)))
    tm = tl.torch_deconv(6, 4, k)
    w = convert_value("decoder_depth.deconv_layers.0.weight", kernel)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.ascontiguousarray(w)))
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == (2, 10, 14, 4) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the flip matters: the unflipped kernel must NOT reproduce the output
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.ascontiguousarray(
            np.transpose(kernel, (2, 3, 0, 1)))))
        wrong = _nhwc(tm(_nchw(x)))
    assert np.abs(wrong - want).max() > 0.1


def test_torch_deconv_rejects_other_kernels():
    with pytest.raises(ValueError):
        tl.torch_deconv(4, 4, 5)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_batchnorm_eval_random_stats_matches_jax(out_dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if out_dtype is torch.bfloat16 else None
    jm = jl.TorchBatchNorm(use_running_average=True, dtype=jdt)
    v = {"params": {"scale": rng.normal(1, .3, 8).astype(np.float32),
                    "bias": rng.normal(0, .3, 8).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, .5, 8).astype(np.float32),
                         "var": rng.uniform(.3, 2, 8).astype(np.float32)}}
    want = jm.apply(v, jnp.asarray(x))
    tm = tl.TorchBatchNorm(8, dtype=out_dtype).eval()
    load_jax_variables(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        got = tm(_nchw(x))
    if out_dtype is torch.bfloat16:
        # statistics in fp32, OUTPUT cast to the activation type
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(_nhwc(got.float()),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(_nhwc(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_batchnorm_train_updates_running_stats_like_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32) * 2 + 1
    jm = jl.TorchBatchNorm(use_running_average=False)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = tl.TorchBatchNorm(5).train()
    got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w", [(3, 4), (5, 7)])
def test_bilinear_x2_matches_jax_resize(h, w):
    """jax.image.resize(..., 'bilinear') x2 == F.interpolate(scale_factor=2,
    mode='bilinear', align_corners=False), edges included."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 3),
                                       method="bilinear"))
    got = _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="bilinear",
                              align_corners=False))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_normalize_rotation_matches_jax():
    rng = np.random.default_rng(3)
    r = rng.standard_normal((5, 9)).astype(np.float32)
    want = np.asarray(jgeo.normalize_rotation(jnp.asarray(r)))
    got = tgeo.normalize_rotation(torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    R = got.reshape(5, 3, 3)
    torch.testing.assert_close(R @ R.transpose(1, 2),
                               torch.eye(3).expand(5, 3, 3),
                               rtol=1e-5, atol=1e-5)
    # no determinant correction: reflections stay reflections
    assert (torch.linalg.det(R) < 0).any() or (np.linalg.det(
        want.reshape(5, 3, 3)) > 0).all()
    assert tgeo.normalize_rotation(torch.from_numpy(r).bfloat16()
                                   ).dtype == torch.bfloat16


def test_layernorm_fp32_eps_and_dtype():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 7, 16)) * 1e-2).astype(np.float32)
    jm = jl.LayerNormFP32()
    params = randomize_tree(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"],
        np.random.default_rng(5))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.LayerNormFP32(16)
    assert tm.eps == 1e-6
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        assert tm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("use_norm,fp32_out", [(False, False), (True, True)])
def test_mlp_exact_gelu_matches_jax(use_norm, fp32_out):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    jm = jl.Mlp(hidden_dim=64, use_norm=use_norm, fp32_out=fp32_out)
    params = randomize_tree(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"],
        np.random.default_rng(7))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.Mlp(16, 64, use_norm=use_norm, fp32_out=fp32_out).eval()
    load_jax_variables(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_drop_path_eval_identity_and_window_groups():
    x = torch.ones(8, 3, 2)
    dp = tl.DropPath(0.5, window_groups=4, generator=torch.Generator()
                     .manual_seed(0))
    assert dp.eval()(x) is x
    y = dp.train()(x)
    per_sample = y.reshape(2, 4, -1)
    # one draw per SAMPLE, shared by its 4 windows; kept values scaled 1/keep
    assert (per_sample == per_sample[:, :1]).all()
    assert set(y.unique().tolist()) <= {0.0, 2.0}


def test_conv_bn_relu_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    jm = jl.ConvBnRelu(features=5)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    g = np.random.default_rng(9)
    params = randomize_tree(v["params"], g)
    stats = randomize_tree(v["batch_stats"], g)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x)))
    tm = tl.ConvBnRelu(4, 5).eval()
    load_jax_variables(tm, params, stats)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _decoder_pair(version, seed):
    rng = np.random.default_rng(seed)
    c = 16
    f1 = rng.standard_normal((2, 4, 6, c)).astype(np.float32)
    f2 = rng.standard_normal((2, 4, 6, c)).astype(np.float32)
    kw = dict(max_depth=10.0, num_deconv=3, num_filters=(8, 8, 8),
              deconv_kernels=(2, 3, 4), num_upscale=2, out_channels=8)
    jm = (jdec.DecoderV2 if version == 2 else jdec.DecoderV1)(**kw)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(f1), jnp.asarray(f2)))
    g = np.random.default_rng(seed + 1)
    params = randomize_tree(v["params"], g)
    stats = randomize_tree(v["batch_stats"], g)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(f1), jnp.asarray(f2))
    tm = (tdec.DecoderV2 if version == 2 else tdec.DecoderV1)(c, **kw).eval()
    load_jax_variables(tm, params, stats)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    return want, got


@pytest.mark.parametrize("version", [1, 2])
def test_decoder_matches_jax(version):
    """Deconv kernels 2, 3 and 4 in one stack, strided pose convs with
    padding (1, 1), bilinear x4, SVD-projected rotation."""
    want, got = _decoder_pair(version, seed=10 + version)
    names = ("d1", "r12", "t12", "d2", "r21", "t21")
    for n, w, g in zip(names, want, got):
        if w is None:
            assert g is None and version == 1
            continue
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, n
        if n.startswith("d"):
            assert g.shape == (2, 4 * 8 * 4, 6 * 8 * 4, 1)
            assert w.std() > 0.1, "depth map is near-constant"
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                       err_msg=n)


def test_decoder_state_dict_uses_reference_names():
    tm = tdec.DecoderV2(16, 10.0, num_filters=(8, 8, 8), out_channels=8)
    keys = set(tm.state_dict())
    for k in ("decoder_pose.pos_layers.0.weight",
              "decoder_pose.pos_layer_down1.4.running_var",
              "decoder_pose.pos_layer_down2.3.bias",
              "decoder_pose.rotat_reg_layer.reg_layer.6.weight",
              "decoder_pose.trans_reg_layer.reg_layer.0.bias",
              "decoder_depth.deconv_layers.6.weight",
              "decoder_depth.deconv_layers.7.running_mean",
              "decoder_depth.conv_layers.1.weight",
              "decoder_depth.last_layer.2.bias"):
        assert k in keys, k
    assert "decoder_depth.deconv_layers.0.bias" not in keys
