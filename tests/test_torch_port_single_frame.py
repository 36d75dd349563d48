"""PyTorch port vs JAX package: single-frame training and evaluation
(train/single_frame.py), flip TTA with sparse depth (train/step.py), and
the serving entry points for the new families (tools/infer.py), on the
CPU.

GLPDepth / GLPDepthScale16 over swin_nano at one block a stage; weights
drawn with numpy into the JAX trees and carried across by
`load_jax_variables`; the port's attention-kernel wrapper (its plain
version on CPU tensors) against the JAX side's XLA attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.losses import silog_loss as j_silog
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import optim as jopt
from mmde_tpu.train import single_frame as jsf
from mmde_tpu.train import step as jstep
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.tools import infer
from mmde_tpu_torch.train import optim as topt
from mmde_tpu_torch.train import single_frame as tsf
from mmde_tpu_torch.train import step as tstep

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

_SWIN = dict(depths=(1, 1, 1, 1), window_size=(4, 4, 4, 2),
             pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), drop_path_rate=0.0)
_OPT = dict(max_lr=1e-3, min_lr=1e-4, weight_decay=0.05, layer_decay=0.9,
            steps_per_epoch=4, epochs=2)


def _cfgs(**kw):
    base = dict(backbone="swin_nano_v2", max_depth=10.0)
    base.update(kw)
    return (jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SWIN),
                             use_pallas_attention=False, **base),
            tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SWIN),
                             use_pallas_attention=True, **base))


def _pair(jc, tc, args, seed, **kw):
    jm = j_build_model(jc)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, **kw))
    g = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], g),
                 "batch_stats": randomize_tree(v["batch_stats"], g)}
    tm = ttf.build_model(tc, device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return jm, tm, variables


@pytest.fixture(scope="module")
def glpdepth():
    jc, tc = _cfgs(family="glpdepth", model_scale=32)
    x = jnp.zeros((2, 64, 64, 3))
    jm, tm, variables = _pair(jc, tc, (x, False), seed=3)
    return jc, tc, jm, tm, variables


def _batch(seed, B=2, H=64, W=64):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((B, H, W, 3)).astype(np.float32),
            "depth": np.where(rng.random((B, H, W)) < 0.2, 0.0,
                              rng.uniform(0.5, 9.5, (B, H, W))
                              ).astype(np.float32)}


def test_single_train_step_matches_jax(glpdepth):
    """One make_single_train_step each (SiLog, train-mode BatchNorm, no
    drop path; GLPDepth has no dropout) through both packages'
    build_optimizer: the loss at 1e-4 relative, the gradient the step
    left on every parameter against jax.grad of the same loss, leaf by
    leaf, at 1e-4 relative + 1e-5 of the largest entry; the update of every
    parameter tensor within 5 % of JAX's by norm (Adam's first step moves
    an entry with a near-zero gradient by +-lr on sign noise), the running
    statistics at 1e-4."""
    jc, tc, jm, tm, variables = glpdepth
    tm = ttf.build_model(tc, device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    tx, _ = jopt.build_optimizer(variables["params"], backbone=jc.backbone,
                                 depths=jc.swin.depths, **_OPT)
    jstate = jstep.TrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax.tree.map(jnp.asarray, variables["batch_stats"]), tx,
        jax.random.PRNGKey(0))
    jtrain = jsf.make_single_train_step(jm, tx, donate=False)
    opt, _ = topt.build_optimizer(tm, backbone=tc.backbone,
                                  depths=tc.swin.depths, device="cpu", **_OPT)
    ttrain = tsf.make_single_train_step(tm, opt, device="cpu")
    tstate = tstep.TrainState.create(tm, opt, torch.Generator())
    b = _batch(5)

    def jloss(params):                  # jsf.make_single_train_step's loss
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(b["image"]), True,
                          mutable=["batch_stats"])
        return j_silog(jnp.squeeze(out["pred_d"], -1),
                       jnp.asarray(b["depth"]), 0.5)

    jgrad = flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(
        jax.tree.map(jnp.asarray, variables["params"]))))
    jstate, jaux = jtrain(jstate, jax.tree.map(jnp.asarray, b))
    tstate, taux = ttrain(tstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    assert sorted(taux) == ["loss_depth"] and tstate.step == 1
    tgrad = flatten_tree(to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, variables["params"]))
    assert tgrad.keys() == jgrad.keys()
    gscale = max(float(np.abs(v).max()) for v in jgrad.values())
    for path, v in jgrad.items():
        np.testing.assert_allclose(tgrad[path], v, rtol=1e-4,
                                   atol=1e-5 * gscale,
                                   err_msg="/".join(path))
    np.testing.assert_allclose(float(taux["loss_depth"]),
                               float(jaux["loss_depth"]), rtol=1e-4)
    start = flatten_tree(variables["params"])
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    got = flatten_tree(to_jax_tree(dict(tm.named_parameters()),
                                   variables["params"]))
    worst = 0.0
    for path in want:
        dj, dt = want[path] - start[path], got[path] - start[path]
        assert np.linalg.norm(dj) > 0, path
        if path == ("decoder", "conv", "bias"):
            # the bias of the conv that train-mode BatchNorm (conv_bn)
            # re-centres: its gradient is zero up to rounding, which
            # Adam's first step scales to +-lr in either package
            assert np.abs(dt).max() <= 1.01 * _OPT["max_lr"]
            continue
        worst = max(worst, np.linalg.norm(dt - dj) / np.linalg.norm(dj))
    assert worst <= 0.05, worst
    stats = flatten_tree(to_jax_tree(dict(tm.named_buffers()),
                                     variables["batch_stats"]))
    for path, v in flatten_tree(jax.tree.map(
            np.asarray, jstate.batch_stats)).items():
        np.testing.assert_allclose(stats[path], v, rtol=1e-4, atol=1e-4,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("flip,shift", [(True, False), (True, True)])
def test_evaluate_single_matches_jax(glpdepth, flip, shift):
    """The metric suite over a two-batch loader, flip TTA and shift-window
    TTA (64-wide crops of 96-wide images, the flip inside each window)."""
    jc, tc, jm, tm, variables = glpdepth
    tm.eval()
    cfg_j = jcfg.Config(model=jc, data=jcfg.DataConfig(
        dataset="void", crop_h=64, crop_w=96))
    cfg_t = tcfg.Config(model=tc, data=tcfg.DataConfig(
        dataset="void", crop_h=64, crop_w=96))
    loader = [_batch(s, W=96) for s in (7, 8)]
    jstate = jstep.TrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax.tree.map(jnp.asarray, variables["batch_stats"]),
        jopt.build_optimizer(variables["params"], backbone=jc.backbone,
                             depths=jc.swin.depths, **_OPT)[0],
        jax.random.PRNGKey(0))
    want = jsf.evaluate_single(jm, jstate, loader, cfg_j, flip_tta=flip,
                               shift_window_tta=shift, shift_crop=64)
    got = tsf.evaluate_single(tm, None, loader, cfg_t, flip_tta=flip,
                              shift_window_tta=shift, shift_crop=64,
                              device="cpu")
    assert sorted(got) == sorted(want)
    assert want["rmse"] > 0.1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_infer_predict_single_frame(glpdepth):
    """tools.infer.predict on family glpdepth: one frame in, pred_d out;
    flip averaging as the JAX flip_average gives it."""
    jc, tc, jm, tm, variables = glpdepth
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    got = infer.predict(tm, frame)
    flip = infer.predict(tm, frame, flip_tta=True)
    x = jnp.asarray(frame.astype(np.float32) / 255.0)
    fwd = jax.jit(lambda x: jm.apply(variables, x, False)["pred_d"])
    want = np.asarray(fwd(x))
    want_flip = 0.5 * (want + np.asarray(fwd(x[:, :, ::-1]))[:, :, ::-1])
    assert sorted(got) == ["pred_d"] and want.std() > 0.1
    np.testing.assert_allclose(got["pred_d"], want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(flip["pred_d"], want_flip, rtol=0, atol=1e-3)


def test_flip_tta_with_sparse_depth_matches_jax_eval_step():
    """make_eval_step(flip_tta=True) on the sparse-depth Scale16 model:
    the sparse maps mirrored on the width with the frames, the depth maps
    averaged, pose from the plain pass - against the JAX eval_step."""
    jc, tc = _cfgs(family="glpdepth_scale16", model_scale=16,
                   sparse_depth_input=True, decoder="decoder_v1")
    rng = np.random.default_rng(9)
    B, H, W = 2, 64, 64
    batch = {"image1": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "image2": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "depth1": rng.uniform(0.5, 9.5, (B, H, W)).astype(np.float32),
             "depth2": rng.uniform(0.5, 9.5, (B, H, W)).astype(np.float32),
             "R12": np.tile(np.eye(3, dtype=np.float32).reshape(1, 9),
                            (B, 1)),
             "T12": rng.normal(0, 0.1, (B, 3)).astype(np.float32)}
    for k in (1, 2):
        batch[f"sparse_depth{k}"] = np.where(
            rng.random((B, H, W)) < 0.1, batch[f"depth{k}"], 0.0
        ).astype(np.float32)
    f = jnp.zeros((B, H, W, 3))
    s = jnp.zeros((B, H, W))
    jm, tm, variables = _pair(jc, tc, (f, f, False), seed=4, sparse1=s,
                              sparse2=s)
    kw = dict(decoder="decoder_v1", lambda_rot=100.0, lambda_trans=100.0)
    jeval = jstep.make_eval_step(jm, flip_tta=True, **kw)
    jstate = jstep.TrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax.tree.map(jnp.asarray, variables["batch_stats"]),
        jopt.build_optimizer(variables["params"], backbone=jc.backbone,
                             depths=jc.swin.depths, **_OPT)[0],
        jax.random.PRNGKey(0))
    want, jaux = jeval(jstate, jax.tree.map(jnp.asarray, batch))
    teval = tstep.make_eval_step(tm, flip_tta=True, device="cpu", **kw)
    got, taux = teval(None, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    plain = tstep.make_eval_step(tm, device="cpu", **kw)(
        None, {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    for k in ("pred_d1", "pred_d2"):
        w = np.asarray(want[k])
        assert w.std() > 0.1
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-3,
                                   err_msg=k)
        # the flip is live: the average is not the plain pass
        assert np.abs(got[k].numpy() - plain[k].numpy()).max() > 1e-3
    for k in ("pred_r12", "pred_t12", "out_p"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
        torch.testing.assert_close(got[k], plain[k])
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    # infer.predict takes the sparse maps the same way
    out = infer.predict(tm, batch["image1"], batch["image2"],
                        sparse1=batch["sparse_depth1"],
                        sparse2=batch["sparse_depth2"], flip_tta=True)
    np.testing.assert_allclose(out["pred_d1"], got["pred_d1"].numpy(),
                               rtol=0, atol=1e-5)


def test_layer_decay_and_decay_mask_match_jax_on_the_new_trees():
    """build_layer_scales / weight_decay_mask under the new trees' names:
    Scale16's `net.encoder.layers.N` (depths of the config, as the JAX loop
    passes them), the cnn_transformer's packed attention (its q / k / v
    biases are (nH, Dh) leaves there: decayed), the resnet trunk."""
    cases = [(_cfgs(family="glpdepth_scale16", model_scale=16,
                    sparse_depth_input=True), 3),
             (_cfgs(family="glpdepth", model_scale=32), 3)]
    jc, tc = _cfgs(backbone="cnn_transformer_single_scale", model_scale=16,
                   decoder="decoder_v1")
    cnn = dataclasses.replace(jc.cnn, cnn_model="resnet18",
                              transformer_ff_dim=64)
    cases.append(((dataclasses.replace(jc, cnn=cnn),
                   dataclasses.replace(tc, cnn=dataclasses.replace(
                       tc.cnn, cnn_model="resnet18",
                       transformer_ff_dim=64))), 3))
    for (jc, tc), ch in cases:
        f = jnp.zeros((1, 64, 64, 3))
        args = (f,) if jc.family == "glpdepth" else (f, f)
        kw = ({"sparse1": jnp.zeros((1, 64, 64))}
              if jc.sparse_depth_input else {})
        jm, tm, variables = _pair(jc, tc, args + (False,), seed=1, **kw)
        params = variables["params"]
        _, jscales = jopt.build_layer_scales(params, jc.swin.depths, 0.9)
        jtree, _ = jopt.build_layer_scales(params, jc.swin.depths, 0.9)
        tscales = topt.build_layer_scales(tm, tc.swin.depths, 0.9)
        got = flatten_tree(to_jax_tree(tscales, params, convert=False))
        want = flatten_tree(jax.tree.map(np.asarray, jtree))
        for path, v in want.items():
            np.testing.assert_allclose(got[path], v, rtol=1e-6,
                                       err_msg="/".join(path))
        assert len(set(np.round(list(map(float, got.values())), 6))) > (
            1 if "swin" in jc.backbone else 0)
        jmask = flatten_tree(jax.tree.map(np.asarray,
                                          jopt.weight_decay_mask(params)))
        tmask = flatten_tree(to_jax_tree(topt.weight_decay_mask(tm), params,
                                         convert=False))
        assert {p: bool(v) for p, v in tmask.items()} == \
            {p: bool(v) for p, v in jmask.items()}, jc.backbone
