"""PyTorch port vs JAX package: shift-window test-time augmentation.

`shift_window_positions`, `shift_window_eval` and
`shift_window_eval_two_frame` against mmde_tpu/train/tta.py with the same
numpy-defined forward on both sides, then the eval steps with
`shift_window` (and flip over it) on a small two-frame model carried
across with `load_jax_variables`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import step as jstep
from mmde_tpu.train import tta as jtta
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.tools import train_steps
from mmde_tpu_torch.train import step as tstep
from mmde_tpu_torch.train import tta as ttta

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


@pytest.mark.parametrize("width", [64, 96, 97, 128, 640])
@pytest.mark.parametrize("crop,stride", [(64, 32), (64, 30), (48, 48),
                                         (64, 64)])
def test_positions_equal_the_jax_packages(width, crop, stride):
    if crop > width:
        pytest.skip("crop wider than the image")
    got = ttta.shift_window_positions(width, crop, stride)
    assert got == jtta.shift_window_positions(width, crop, stride)
    assert got[0] == 0 and got[-1] == width - crop


def test_flagship_crop_grid():
    """480 x 640 frames, crop CROP_HEIGHT 480, half a crop apart: two 480 x
    480 windows at 0 and 160, whose stage-1 map (120 x 120) holds 16
    windows of 30 and takes the packed kernels and the slab plan."""
    from mmde_tpu_torch.ops.window_attention_packed import packed_layout_ok
    from mmde_tpu_torch.ops.window_attention_slab import slab_plan
    assert ttta.shift_window_positions(640, 480, 240) == [0, 160]
    assert (480 // 4 // 30) ** 2 == 16
    assert packed_layout_ok(900, 4, 32, 128)
    assert slab_plan(30, 120, 4, 32, 128) is not None


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal((6, 12)).astype(np.float32))


def _column_term(w, crop):
    return (np.arange(crop, dtype=np.float32) / crop)[None, None, :, None]


def test_shift_window_eval_matches_jax():
    """forward: a per-pixel tanh of a channel mix plus a term that depends
    on the column inside the crop (so overlapping windows disagree and the
    averaging shows): fp32 max abs 1e-6."""
    W1, _ = _weights()
    img = np.random.default_rng(1).random((2, 48, 112, 3)).astype(np.float32)
    crop = 48
    col = _column_term(None, crop)

    def jfwd(x):
        return jnp.tanh(x @ W1)[..., :2] + col

    def tfwd(x):
        return torch.tanh(x @ torch.from_numpy(W1))[..., :2] + \
            torch.from_numpy(col)

    for stride in (None, 20):
        want = np.asarray(jtta.shift_window_eval(jfwd, jnp.asarray(img),
                                                 crop, stride))
        got = ttta.shift_window_eval(tfwd, torch.from_numpy(img), crop,
                                     stride).numpy()
        assert got.shape == (2, 48, 112, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _pose_forward(lib, W2, col):
    """A two-frame forward in `lib` (jnp or torch): depth per pixel from
    both frames, pose from the frames' mean colours (9 numbers near a
    rotation, 3 of translation)."""
    tanh = jnp.tanh if lib is jnp else torch.tanh
    cat = (lambda xs: jnp.concatenate(xs, -1)) if lib is jnp else \
        (lambda xs: torch.cat(xs, -1))
    eye = np.eye(3, dtype=np.float32).reshape(9)
    W = W2 if lib is jnp else torch.from_numpy(W2)
    c = col if lib is jnp else torch.from_numpy(col)
    e = eye if lib is jnp else torch.from_numpy(eye)

    def fwd(a, b):
        f = cat([a, b])
        d1 = tanh(f @ W)[..., :1] + 2.0 + c
        d2 = tanh(f @ W)[..., 1:2] + 2.0 - c
        m = f.mean(axis=(1, 2)) if lib is jnp else f.mean(dim=(1, 2))
        p = tanh(m @ W)
        return {"pred_d1": d1, "pred_d2": d2,
                "pred_r12": e + 0.2 * p[:, :9], "pred_t12": p[:, 9:],
                "pred_r21": e - 0.2 * p[:, 3:12], "pred_t21": p[:, :3]}
    return fwd


def test_shift_window_eval_two_frame_matches_jax():
    """Depth recomposed by coverage, rotations as the chordal mean
    re-projected onto SO(3), translations averaged: fp32 max abs 1e-6."""
    _, W2 = _weights()
    rng = np.random.default_rng(2)
    f1 = rng.random((2, 40, 100, 3)).astype(np.float32)
    f2 = rng.random((2, 40, 100, 3)).astype(np.float32)
    crop = 40
    col = _column_term(None, crop)
    want = jtta.shift_window_eval_two_frame(
        _pose_forward(jnp, W2, col), jnp.asarray(f1), jnp.asarray(f2), crop)
    got = ttta.shift_window_eval_two_frame(
        _pose_forward(torch, W2, col), torch.from_numpy(f1),
        torch.from_numpy(f2), crop)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    R = got["pred_r12"].reshape(2, 3, 3)
    torch.testing.assert_close(R @ R.transpose(1, 2),
                               torch.eye(3).expand(2, 3, 3), rtol=0,
                               atol=1e-5)


_SWIN = dict(depths=(2, 2, 1, 1), window_size=(6, 6, 6, 3),
             pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), drop_path_rate=0.3)
_LOSS = dict(decoder="decoder_v2", lambda_rot=100.0, lambda_trans=100.0)


@pytest.fixture(scope="module")
def wide_pair():
    """(JAX model, its numpy-drawn variables, port model, 64 x 96 batch)."""
    kw = dict(backbone="swin_nano_v2", decoder="decoder_v2", model_scale=32,
              max_depth=10.0)
    jm = j_build_model(jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SWIN), **kw))
    f = jnp.zeros((2, 64, 64, 3), jnp.float32)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       f, f, False))
    rng = np.random.default_rng(11)
    variables = {"params": randomize_tree(v["params"], rng),
                 "batch_stats": randomize_tree(v["batch_stats"], rng)}
    tm = ttf.build_model(tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SWIN),
                                          **kw), device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    batch = {k: v.numpy() for k, v in
             train_steps.synthetic_batch(2, 64, 96, seed=4).items()}
    return jm, variables, tm, batch


def test_eval_steps_with_shift_window_match_jax(wide_pair):
    """64 x 96 frames in 64-px crops at 0 and 32. make_eval_step:
    predictions (depth 1e-3, pose 1e-4) and the loss aux (1e-4 relative);
    make_eval_metrics_step with flip over the composition: the per-sample
    metrics (1e-3) - the tolerances of the eval-step tests without TTA."""
    jm, variables, tm, batch = wide_pair
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=None, rng=None)
    tstate = tstep.TrainState(tm, None)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = dict(shift_window=64, **_LOSS)
    jpred, jaux = jstep.make_eval_step(jm, **kw)(jstate, jb)
    tpred, taux = tstep.make_eval_step(tm, device="cpu", **kw)(tstate, tb)
    assert np.asarray(jpred["pred_d1"]).std() > 0.1
    for k in ("pred_d1", "pred_d2"):
        assert tuple(tpred[k].shape) == (2, 64, 96, 1)
        np.testing.assert_allclose(tpred[k].numpy(), np.asarray(jpred[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    for k in ("pred_r12", "pred_r21", "pred_t12", "pred_t21"):
        np.testing.assert_allclose(tpred[k].numpy(), np.asarray(jpred[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4)
    mkw = dict(dataset="void", min_depth_eval=1e-3, max_depth_eval=10.0,
               flip_tta=True, **kw)
    jmet, _ = jstep.make_eval_metrics_step(jm, **mkw)(jstate, jb)
    tmet, _ = tstep.make_eval_metrics_step(tm, device="cpu", **mkw)(
        tstate, tb)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
