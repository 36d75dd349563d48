"""PyTorch port vs JAX package: the GLPDepth family (models/glpdepth.py) and
the swin additions it needs (`ape`, `ResNetDLNPatchEmbed`, any input
channel count), on the CPU.

swin_nano at one block a stage (tests/test_glpdepth.py's shape of model);
weights drawn with numpy into the JAX trees and carried across by
`load_jax_variables`. The port runs its attention-kernel wrapper (the plain
version on CPU tensors), the JAX side its XLA attention. Depth atol 1e-3,
pose rtol / atol 1e-4, as the model tests.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.nn import swin_v2 as jswin
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, key_map,
                                          load_jax_variables, to_jax_tree)
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.nn import swin_v2 as tswin
from mmde_tpu_torch.testing import randomize_tree

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SWIN = dict(depths=(1, 1, 1, 1), window_size=(4, 4, 4, 2),
             pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), drop_path_rate=0.0)


def _apply(module, *args, **kw):
    """module.apply under jax.jit (eager dispatch of a swin stack costs ~10x
    its compile); keyword arguments other than arrays are static."""
    arrays = {k: v for k, v in kw.items() if hasattr(v, "shape")}
    static = {k: v for k, v in kw.items() if k not in arrays}
    train = [a for a in args if isinstance(a, bool)]
    rest = [a for a in args if not isinstance(a, bool)]
    return jax.jit(lambda r, a: module.apply(*r, *train, **a, **static))(
        rest, arrays)


def _cfgs(**kw):
    base = dict(backbone="swin_nano_v2", max_depth=10.0, decoder="decoder_v1")
    base.update(kw)
    return (jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SWIN),
                             use_pallas_attention=False, **base),
            tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SWIN),
                             use_pallas_attention=True, **base))


def _load(jm, tm, args, seed, **kw):
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    g = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], g),
                 "batch_stats": randomize_tree(v.get("batch_stats", {}), g)}
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return variables


def _depth_close(got, want, what):
    want = np.asarray(want)
    assert want.std() > 0.1, what          # not a near-constant map
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-3,
                               err_msg=what)


def test_glpdepth_single_frame_matches_jax():
    jc, tc = _cfgs(family="glpdepth", model_scale=32)
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    jm = j_build_model(jc)
    tm = ttf.build_model(tc, device="cpu").eval()
    variables = _load(jm, tm, (jnp.asarray(x), False), seed=2)
    want = _apply(jm, variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert sorted(got) == ["pred_d"] and got["pred_d"].shape == (2, 64, 64, 1)
    _depth_close(got["pred_d"], want["pred_d"], "pred_d")
    by_path = {"/".join(p): k for p, k in key_map(variables["params"]).items()}
    assert by_path["decoder/deconv_1/kernel"] == "decoder.deconv_1.weight"
    assert by_path["head_b/bias"] == "head_b.bias"


def _scale16(sparse, seed, backbone="swin_nano_v2", train=False):
    jc, tc = _cfgs(family="glpdepth_scale16", model_scale=16,
                   sparse_depth_input=sparse, backbone=backbone)
    if "swin" not in backbone:      # resnet18: hidden 256
        jc = dataclasses.replace(jc, cnn=jcfg.CnnTransformerConfig(
            cnn_model="resnet18"))
        tc = dataclasses.replace(tc, cnn=tcfg.CnnTransformerConfig(
            cnn_model="resnet18"))
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.random((2, 64, 64, 3)).astype(np.float32)
              for _ in range(2))
    kw, tkw = {}, {}
    if sparse:
        s1 = np.where(rng.random((2, 64, 64)) < 0.1,
                      rng.uniform(0.5, 9.5, (2, 64, 64)), 0.0
                      ).astype(np.float32)
        kw = {"sparse1": jnp.asarray(s1)}
        tkw = {"sparse1": torch.from_numpy(s1)}
    jm = j_build_model(jc)
    tm = ttf.build_model(tc, device="cpu").train(train)
    variables = _load(jm, tm, (jnp.asarray(f1), jnp.asarray(f2), False),
                      seed + 1, **kw)
    return jm, tm, variables, f1, f2, kw, tkw


@pytest.mark.parametrize("sparse", [False, True])
def test_scale16_matches_jax(sparse):
    jm, tm, variables, f1, f2, kw, tkw = _scale16(sparse, seed=4)
    want = _apply(jm, variables, jnp.asarray(f1), jnp.asarray(f2), False, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2), **tkw)
    assert tm.net.encoder.patch_embed.proj.in_channels == (5 if sparse else 3)
    assert got["pred_r21"] is None and got["pred_t21"] is None
    for k in ("pred_d1", "pred_d2"):
        _depth_close(got[k], want[k], k)
    for k in ("out_p", "pred_r12", "pred_t12"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    if sparse:
        # the fusion is live: other sparse maps, other depth; sparse2
        # defaults to sparse1
        s2 = torch.roll(tkw["sparse1"], 7, dims=2)
        with torch.no_grad():
            other = tm(torch.from_numpy(f1), torch.from_numpy(f2),
                       sparse1=tkw["sparse1"], sparse2=s2)
            same = tm(torch.from_numpy(f1), torch.from_numpy(f2),
                      sparse1=tkw["sparse1"], sparse2=tkw["sparse1"])
        assert (other["pred_d1"] - got["pred_d1"]).abs().max() > 1e-3
        torch.testing.assert_close(same["pred_d1"], got["pred_d1"])
        with pytest.raises(ValueError, match="sparse"):
            tm(torch.from_numpy(f1), torch.from_numpy(f2))


def test_scale16_train_mode_and_names():
    """Train mode (BatchNorm batch statistics; dropout p = 0.5 differs by
    generator, so the heads run with it off) and the new trees' names:
    `net.encoder.layers.N`, the pose convs, the depth stack."""
    jm, tm, variables, f1, f2, kw, tkw = _scale16(True, seed=6, train=True)
    for m in tm.modules():
        if type(m).__name__ == "Dropout":
            m.rate = 0.0
    want, mut = _apply(jm, variables, jnp.asarray(f1), jnp.asarray(f2), True,
                         mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
    got = tm(torch.from_numpy(f1), torch.from_numpy(f2), **tkw)
    for k in ("pred_d1", "pred_d2"):
        _depth_close(got[k], want[k], k)
    stats = flatten_tree(to_jax_tree(dict(tm.named_buffers()),
                                     variables["batch_stats"]))
    for path, v in flatten_tree(jax.tree.map(np.asarray,
                                             mut["batch_stats"])).items():
        np.testing.assert_allclose(stats[path], v, rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(path))
    names = dict(tm.named_parameters())
    for n in ("net.encoder.layers.2.blocks.0.attn.qkv.weight",
              "net.pos1a.weight", "net.bn_pos2b.bias",
              "net.rot_head.fc3.weight", "net.depth_stack.deconv_2.weight",
              "net.head_b.bias"):
        assert n in names, n


def test_scale16_over_a_resnet_encoder_matches_jax():
    """The non-swin encoder branch (resnet_only over resnet18, single
    scale), in train
    mode: BatchNorm's batch statistics keep the drawn weights' logits O(1)
    (in eval mode with drawn running statistics the depth head saturates,
    where float32 rounding decides the last digits); dropout off."""
    jm, tm, variables, f1, f2, kw, tkw = _scale16(
        False, seed=8, backbone="resnet_only_single_scale", train=True)
    assert tm.net.encoder.hidden_dim == 256
    for m in tm.modules():
        if type(m).__name__ == "Dropout":
            m.rate = 0.0
    want, _ = _apply(jm, variables, jnp.asarray(f1), jnp.asarray(f2), True,
                     mutable=["batch_stats"],
                     rngs={"dropout": jax.random.PRNGKey(0)})
    got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    for k in ("pred_d1", "pred_d2"):
        _depth_close(got[k], want[k], k)


def test_completion_config_through_build_model():
    """void_downscale16_completion.yaml's model block (glpdepth_scale16,
    sparse depth, decoder_v1, scale 16), shrunk to swin_nano at one block
    a stage, through both packages' config loaders and build_model."""
    path = os.path.join(ROOT, "configs", "void_downscale16_completion.yaml")
    j, t = jcfg.load_yaml(path).model, tcfg.load_yaml(path).model
    assert t.family == "glpdepth_scale16" and t.sparse_depth_input
    shrink = dict(backbone="swin_nano_v2", use_pallas_attention=False)
    j = dataclasses.replace(j, swin=jcfg.SwinConfig(**_SWIN), **shrink)
    t = dataclasses.replace(t, swin=tcfg.SwinConfig(**_SWIN), **shrink)
    rng = np.random.default_rng(12)
    f1, f2 = (rng.random((2, 64, 64, 3)).astype(np.float32)
              for _ in range(2))
    s1, s2 = (np.where(rng.random((2, 64, 64)) < 0.05,
                       rng.uniform(0.5, 9.5, (2, 64, 64)), 0.0
                       ).astype(np.float32) for _ in range(2))
    jm = j_build_model(j)
    tm = ttf.build_model(t, device="cpu").eval()
    kw = dict(sparse1=jnp.asarray(s1), sparse2=jnp.asarray(s2))
    variables = _load(jm, tm, (jnp.asarray(f1), jnp.asarray(f2), False), 13,
                      **kw)
    want = _apply(jm, variables, jnp.asarray(f1), jnp.asarray(f2), False, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2),
                 sparse1=torch.from_numpy(s1), sparse2=torch.from_numpy(s2))
    for k in ("pred_d1", "pred_d2"):
        _depth_close(got[k], want[k], k)
    np.testing.assert_allclose(got["out_p"].numpy(), np.asarray(want["out_p"]),
                               rtol=1e-4, atol=1e-4)
    # from_jax both ways: the port's tensors back into the JAX trees
    for tree, tensors in (("params", dict(tm.named_parameters())),
                          ("batch_stats", dict(tm.named_buffers()))):
        back = flatten_tree(to_jax_tree(tensors, variables[tree]))
        for path, v in flatten_tree(variables[tree]).items():
            np.testing.assert_array_equal(back[path], v,
                                          err_msg="/".join(path))


@pytest.mark.parametrize("n_in,n_out", [(56, 120), (30, 12), (7, 7)])
def test_bicubic_weights_are_jax_image_resize(n_in, n_out):
    """`resize_bicubic` is jax.image.resize's bicubic (Keys a = -0.5,
    renormalised edges, antialiased when shrinking), not F.interpolate's."""
    x = np.random.default_rng(0).standard_normal((1, n_in, n_in + 3, 4)
                                                  ).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (1, n_out, n_out + 5, 4), "bicubic"))
    got = tswin.resize_bicubic(torch.from_numpy(x).permute(0, 3, 1, 2),
                               n_out, n_out + 5).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if n_in < n_out:
        torch_cubic = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), (n_out, n_out + 5),
            mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
        assert np.abs(torch_cubic.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("patch,ape,size", [
    ("normal", True, 480),          # ape 56 -> 120: up
    ("normal", True, 96),           # 56 -> 24: down, antialiased
    ("resnetdln", False, 64),
    ("resnetdln", True, 64)])
def test_swin_patch_embed_and_ape_match_jax(patch, ape, size):
    """ape (pretrain_img_size 224 -> a 56 x 56 table) resized up to a 120
    map and down to 24; the ResNet-style patch embed; 5 input channels."""
    kw = dict(embed_dim=32, depths=(1, 1), num_heads=(1, 2),
              window_size=(4, 4), pretrain_window_size=(4, 4),
              use_shift=(True, False), out_indices=(1,), drop_path_rate=0.0,
              ape=ape, patch_embed_type=patch)
    jm = jswin.SwinTransformerV2(**kw)
    tm = tswin.SwinTransformerV2(in_chans=5, **kw).eval()
    w = 96 if size == 480 else size
    x = np.random.default_rng(3).random((1, size, w, 5)).astype(np.float32)
    variables = _load(jm, tm, (jnp.asarray(x),), seed=4)
    want = _apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    w0 = np.asarray(want[0])
    assert got[0].shape == w0.shape and w0.std() > 0.1
    np.testing.assert_allclose(got[0].numpy(), w0, rtol=1e-4, atol=2e-4)
    if ape:
        assert tuple(tm.absolute_pos_embed.shape) == (1, 32, 56, 56)
        back = to_jax_tree(dict(tm.named_parameters()), variables["params"])
        np.testing.assert_array_equal(back["absolute_pos_embed"],
                                      variables["params"]
                                      ["absolute_pos_embed"])
