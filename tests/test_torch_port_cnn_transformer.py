"""PyTorch port vs JAX package: the cnn_transformer / resnet_only encoders
(nn/cnn_transformer.py) and the two-frame model over them, on the CPU.

resnet18 trunks, hidden 256 (4 heads), feed-forward 512, 2 encoder layers
for the modules; weights drawn with numpy into the JAX trees and carried
across by `load_jax_variables`. 240 x 80 inputs, where the multi-scale
fusion's crop to f4's grid binds (f4 15 x 5, f5 repeated to 16 x 6). Then
`void.yaml`'s model block through `build_model`, shrunk in width only
(resnet18 trunk, hidden 256, feed-forward 512; its 6 layers kept).
Tolerances are the model tests': depth atol 1e-3, pose rtol / atol 1e-4.
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
from mmde_tpu.nn import cnn_transformer as jct
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, key_map,
                                          load_jax_variables, to_jax_tree)
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.nn import cnn_transformer as tct
from mmde_tpu_torch.testing import randomize_tree

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _apply(module, *args, **kw):
    """module.apply under jax.jit (eager dispatch of a swin stack costs ~10x
    its compile); keyword arguments other than arrays are static."""
    arrays = {k: v for k, v in kw.items() if hasattr(v, "shape")}
    static = {k: v for k, v in kw.items() if k not in arrays}
    train = [a for a in args if isinstance(a, bool)]
    rest = [a for a in args if not isinstance(a, bool)]
    return jax.jit(lambda r, a: module.apply(*r, *train, **a, **static))(
        rest, arrays)


def _load(jmod, tmod, args, seed):
    v = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args))
    g = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], g),
                 "batch_stats": randomize_tree(v["batch_stats"], g)}
    load_jax_variables(tmod, variables["params"], variables["batch_stats"])
    return variables


def test_sine_position_embedding_is_the_jax_table():
    for h, w, f in ((15, 5, 128), (30, 30, 256), (3, 4, 8)):
        np.testing.assert_array_equal(tct.sine_position_embedding(h, w, f),
                                      jct.sine_position_embedding(h, w, f))


ENCODERS = {
    "cnn_multi": (lambda: jct.CnnTransformer(
        hidden_dim=256, n_enc_layers=2, multi_scale=True,
        cnn_model="resnet18", ff_dim=512),
        lambda: tct.CnnTransformer(256, 2, True, "resnet18", 512)),
    "cnn_single": (lambda: jct.CnnTransformer(
        hidden_dim=256, n_enc_layers=2, multi_scale=False,
        cnn_model="resnet18", ff_dim=512),
        lambda: tct.CnnTransformer(256, 2, False, "resnet18", 512)),
    "resnet_only_multi": (lambda: jct.ResNetOnly(
        hidden_dim=256, multi_scale=True, cnn_model="resnet18"),
        lambda: tct.ResNetOnly(256, True, "resnet18")),
    "resnet_only_single": (lambda: jct.ResNetOnly(
        hidden_dim=256, multi_scale=False, cnn_model="resnet18"),
        lambda: tct.ResNetOnly(256, False, "resnet18")),
}


@pytest.mark.parametrize("name,train,size", [
    ("cnn_multi", False, (240, 80)), ("cnn_multi", True, (240, 80)),
    ("cnn_single", False, (64, 48)), ("cnn_single", True, (64, 48)),
    ("resnet_only_multi", True, (240, 80)),
    ("resnet_only_single", False, (64, 48))])
def test_encoder_matches_jax(name, train, size):
    """Multi-scale at 240 x 80 (the crop to f4's grid binds on both axes),
    single-scale at 64 x 48."""
    jf, tf = ENCODERS[name]
    x = np.random.default_rng(5).random((2,) + size + (3,)).astype(
        np.float32)
    jm, tm = jf(), tf()
    variables = _load(jm, tm, (jnp.asarray(x), False), seed=21)
    tm.train(train)
    if train:
        want, mut = _apply(jm, variables, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    else:
        want = _apply(jm, variables, jnp.asarray(x), False)
    got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 1
    w, g = np.asarray(want[0]), got[0].detach().numpy()
    assert g.shape == w.shape == (2, size[0] // 16, size[1] // 16, 256)
    assert w.std() > 0.1
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
    if train:
        stats = flatten_tree(to_jax_tree(dict(tm.named_buffers()),
                                         variables["batch_stats"]))
        new = flatten_tree(jax.tree.map(np.asarray, mut["batch_stats"]))
        assert stats.keys() == new.keys()
        for path in new:
            np.testing.assert_allclose(stats[path], new[path], rtol=1e-4,
                                       atol=1e-4, err_msg="/".join(path))


def test_encoder_names_and_attention_split_round_trip():
    """The encoder layers carry torch's MultiheadAttention layout under the
    reference names; the three (C, nH, Dh) kernels fill in_proj_weight's
    row blocks and come back out of it unchanged (`to_jax_tree`)."""
    jm, tm = ENCODERS["cnn_multi"][0](), ENCODERS["cnn_multi"][1]()
    x = jnp.zeros((1, 64, 64, 3))
    variables = _load(jm, tm, (x, False), seed=3)
    by_path = {"/".join(p): k for p, k in key_map(variables["params"]).items()}
    assert by_path["enc_1/self_attn/key/kernel"] == \
        "transformer_encoder.1.self_attn.in_proj_weight:1"
    assert by_path["enc_0/self_attn/out/kernel"] == \
        "transformer_encoder.0.self_attn.out_proj.weight"
    assert by_path["enc_0/ffn2/bias"] == "transformer_encoder.0.ffn2.0.bias"
    assert by_path["feature_extractor/squeeze2_b/bn/scale"] == \
        "feature_extractor.feat_squeeze2.1.bn.weight"
    assert by_path["feature_extractor/combine_b/kernel"] == \
        "feature_extractor.feat_combine.3.weight"
    assert by_path["feature_extractor/BatchNorm_0/bias"] == \
        "feature_extractor.feat_combine.1.bias"
    back = flatten_tree(to_jax_tree(dict(tm.named_parameters()),
                                    variables["params"]))
    for path, v in flatten_tree(variables["params"]).items():
        np.testing.assert_array_equal(back[path], v, err_msg="/".join(path))
    w = tm.transformer_encoder[0].self_attn.in_proj_weight
    q = variables["params"]["enc_0"]["self_attn"]["query"]["kernel"]
    np.testing.assert_array_equal(w[:256].detach().numpy(),
                                  q.reshape(256, 256).T)


def _void_cfgs():
    """void.yaml's model block, shrunk in width: resnet18, hidden 256, ff
    512 (both packages' loaders read the same file)."""
    path = os.path.join(ROOT, "configs", "void.yaml")
    j, t = jcfg.load_yaml(path).model, tcfg.load_yaml(path).model
    assert j.backbone == t.backbone == "cnn_transformer_multi_scale"
    j = dataclasses.replace(j, cnn=dataclasses.replace(
        j.cnn, cnn_model="resnet18", transformer_ff_dim=512))
    t = dataclasses.replace(t, cnn=dataclasses.replace(
        t.cnn, cnn_model="resnet18", transformer_ff_dim=512))
    return j, t


def test_void_model_through_build_model_matches_jax():
    jc, tc = _void_cfgs()
    rng = np.random.default_rng(8)
    f1 = rng.random((2, 64, 48, 3)).astype(np.float32)
    f2 = rng.random((2, 64, 48, 3)).astype(np.float32)
    jm = j_build_model(jc)
    tm = ttf.build_model(tc, device="cpu").eval()
    assert len(tm.encoder.transformer_encoder) == 6
    variables = _load(jm, tm, (jnp.asarray(f1), jnp.asarray(f2), False),
                      seed=9)
    want = _apply(jm, variables, jnp.asarray(f1), jnp.asarray(f2), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    assert want["pred_r21"] is None and got["pred_r21"] is None
    for k in ("pred_d1", "pred_d2"):
        w = np.asarray(want[k])
        assert w.shape == (2, 64, 48, 1) and w.std() > 0.1
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-3,
                                   err_msg=k)
    for k in ("pred_r12", "pred_t12"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_every_config_builds_in_the_port():
    """Every configs/*.yaml model builds through `build_model` on the CPU
    and runs a 64 x 64 pair, shrunk for the CPU: one swin block a stage,
    small windows, swin_nano widths (the decoders' pose convs are O(C^2)),
    resnet18 trunks, feed-forward 64; family, backbone type, decoder,
    scale and sparse input as configured."""
    names = sorted(n for n in os.listdir(os.path.join(ROOT, "configs"))
                   if n.endswith(".yaml"))
    assert len(names) >= 10
    families = set()
    for name in names:
        m = tcfg.load_yaml(os.path.join(ROOT, "configs", name)).model
        m = dataclasses.replace(m, swin=dataclasses.replace(
            m.swin, depths=(1, 1, 1, 1), window_size=(4, 4, 4, 2),
            pretrain_window_size=(4, 4, 4, 2)))
        m = dataclasses.replace(m, cnn=dataclasses.replace(
            m.cnn, cnn_model="resnet18", transformer_ff_dim=64))
        for v in ("tiny", "base", "large", "huge"):
            m = dataclasses.replace(m, backbone=m.backbone.replace(v, "nano"))
        model = ttf.build_model(m, device="cpu").eval()
        families.add(m.family)
        f = torch.rand(2, 64, 64, 3)
        with torch.no_grad():
            if m.family == "glpdepth":
                out = model(f)
            else:
                kw = ({"sparse1": torch.rand(2, 64, 64)}
                      if m.sparse_depth_input else {})
                out = model(f, f, **kw)
        assert out["pred_d1"].shape == (2, 64, 64, 1), name
    assert {"two_frame", "glpdepth_scale16"} <= families
