"""PyTorch port vs JAX package: geometry, losses and metrics, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides. These are
small float32 reductions, so the two frameworks agree to a few ulps of the
result; each tolerance says what it covers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import geometry as jgeo
from mmde_tpu import losses as jloss
from mmde_tpu import metrics as jmet
from mmde_tpu_torch import geometry as tgeo
from mmde_tpu_torch import losses as tloss
from mmde_tpu_torch import metrics as tmet

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- geometry

def _poses(seed, n=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R = jgeo.exp_so3(rng.normal(0, 0.7, 3))
        out.append(jgeo.se3(rng.normal(0, 1, 3), R))
    return out


@pytest.mark.parametrize("w", [np.zeros(3), np.array([1e-10, 0, 0]),
                               np.array([0.3, -0.2, 0.9]),
                               np.array([2.0, 1.0, -2.0])])
def test_numpy_so3_matches_jax_package(w):
    """The numpy half is a copy: exact agreement (float64)."""
    np.testing.assert_array_equal(tgeo.skew(w), jgeo.skew(w))
    R = jgeo.exp_so3(w)
    np.testing.assert_array_equal(tgeo.exp_so3(w), R)
    np.testing.assert_array_equal(tgeo.log_so3(R), jgeo.log_so3(R))


def test_numpy_se3_and_relative_pose_match_jax_package():
    T01, T02 = _poses(0, 2)
    np.testing.assert_array_equal(tgeo.se3(T01[:3, 3], T01[:3, :3]), T01)
    np.testing.assert_array_equal(tgeo.inv_se3(T01), jgeo.inv_se3(T01))
    np.testing.assert_allclose(tgeo.inv_se3(T01) @ T01, np.eye(4),
                               atol=1e-12)
    np.testing.assert_array_equal(tgeo.relative_pose(T01, T02),
                                  jgeo.relative_pose(T01, T02))
    got = tgeo.relative_pose_parts(T01, T02)
    want = jgeo.relative_pose_parts(T01, T02)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # identical poses: zero rotation, the unnormalised-axis branch
    same = tgeo.relative_pose_parts(T01, T01)
    np.testing.assert_array_equal(same[4], jgeo.relative_pose_parts(
        T01, T01)[4])


def test_torch_so3_functions_match_jax():
    """Batched fp32 trigonometry: 1e-6 absolute (values are O(1))."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.8, (5, 3)).astype(np.float32)
    w[0] = 0.0                                      # the Taylor branch
    _close(tgeo.skew_torch(_t(w)), jgeo.skew_jax(_j(w)), 0)
    R = np.asarray(jgeo.exp_so3_jax(_j(w)))
    _close(tgeo.exp_so3_torch(_t(w)), R, 1e-6)
    _close(tgeo.log_so3_torch(_t(R)), jgeo.log_so3_jax(_j(R)), 1e-5)
    _close(tgeo.log_so3_torch(_t(R)), w, 1e-5)      # and it inverts exp
    R2 = np.asarray(jgeo.exp_so3_jax(_j(w[::-1].copy())))
    _close(tgeo.rotation_geodesic_angle(_t(R), _t(R2)),
           jgeo.rotation_geodesic_angle(_j(R), _j(R2)), 1e-5)


def test_exp_so3_torch_is_differentiable_at_zero():
    w = torch.zeros(2, 3, requires_grad=True)
    tgeo.exp_so3_torch(w).sum().backward()
    assert torch.isfinite(w.grad).all()


def test_normalize_rotation_matches_jax():
    rng = np.random.default_rng(2)
    r = rng.normal(0, 1, (4, 9)).astype(np.float32)
    _close(tgeo.normalize_rotation(_t(r)), jgeo.normalize_rotation(_j(r)),
           1e-5)


# ------------------------------------------------------------------ losses

def _depth_pair(seed, shape=(2, 24, 32), invalid=0.3):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.2, 9.0, shape).astype(np.float32)
    target = rng.uniform(0.2, 9.0, shape).astype(np.float32)
    target[rng.random(shape) < invalid] = 0.0
    return pred, target


@pytest.mark.parametrize("lambd,eps", [(0.5, 0.0), (0.85, 0.0), (0.5, 1e-3)])
def test_silog_loss_matches_jax(lambd, eps):
    pred, target = _depth_pair(3)
    want = jloss.silog_loss(_j(pred), _j(target), lambd, eps)
    got = tloss.silog_loss(_t(pred), _t(target), lambd, eps)
    _close(got, want, 1e-6)
    assert float(got) > 0.1


def test_silog_loss_all_invalid_is_finite_with_finite_gradient():
    pred, _ = _depth_pair(4)
    target = np.zeros_like(pred)
    want = jloss.silog_loss(_j(pred), _j(target))
    p = _t(pred).requires_grad_()
    got = tloss.silog_loss(p, _t(target))
    assert float(got) == float(want) == 0.0
    got.backward()
    assert torch.isfinite(p.grad).all()


@pytest.mark.parametrize("weighted", [False, True, "none_valid"])
def test_weighted_mse_loss_matches_jax(weighted):
    rng = np.random.default_rng(5)
    pred = rng.normal(0, 1, (4, 9)).astype(np.float32)
    target = rng.normal(0, 1, (4, 3, 3)).astype(np.float32)
    w = None
    if weighted is True:
        w = np.array([1, 0, 1, 1], np.float32)
    elif weighted == "none_valid":
        w = np.zeros(4, np.float32)         # max(.., 1) guard: 0, not nan
    want = jloss.weighted_mse_loss(_j(pred), _j(target), _j(w))
    got = tloss.weighted_mse_loss(_t(pred), _t(target), _t(w))
    _close(got, want, 1e-6)
    assert np.isfinite(float(got))


def _loss_inputs(seed, decoder, pose_valid):
    rng = np.random.default_rng(seed)
    B = 3
    d1p, d1 = _depth_pair(seed, (B, 16, 20))
    d2p, d2 = _depth_pair(seed + 1, (B, 16, 20))
    preds = {"pred_d1": d1p[..., None], "pred_d2": d2p[..., None],
             "pred_r12": rng.normal(0, 1, (B, 9)).astype(np.float32),
             "pred_t12": rng.normal(0, 1, (B, 3)).astype(np.float32)}
    batch = {"depth1": d1, "depth2": d2,
             "R12": rng.normal(0, 1, (B, 9)).astype(np.float32),
             "T12": rng.normal(0, 1, (B, 3)).astype(np.float32)}
    if decoder == "decoder_v2":
        preds.update(pred_r21=rng.normal(0, 1, (B, 9)).astype(np.float32),
                     pred_t21=rng.normal(0, 1, (B, 3)).astype(np.float32))
        batch.update(R21=rng.normal(0, 1, (B, 9)).astype(np.float32),
                     T21=rng.normal(0, 1, (B, 3)).astype(np.float32))
    else:
        preds.update(pred_r21=None, pred_t21=None)
    if pose_valid:
        batch["pose_valid"] = np.array([1, 0, 1], np.float32)
    return preds, batch


@pytest.mark.parametrize("decoder", ["decoder_v1", "decoder_v2"])
@pytest.mark.parametrize("pose_valid", [False, True])
def test_total_loss_matches_jax(decoder, pose_valid):
    preds, batch = _loss_inputs(6, decoder, pose_valid)
    kw = dict(decoder=decoder, lambda_rot=100.0, lambda_trans=50.0,
              silog_lambda=0.5)
    want_total, want_aux = jloss.total_loss(
        {k: _j(v) for k, v in preds.items()},
        {k: _j(v) for k, v in batch.items()}, **kw)
    got_total, got_aux = tloss.total_loss(
        {k: _t(v) for k, v in preds.items()},
        {k: _t(v) for k, v in batch.items()}, **kw)
    assert sorted(got_aux) == sorted(want_aux) == [
        "loss_depth", "loss_rotation", "loss_total", "loss_translation"]
    # sums of O(100) terms in fp32: 1e-5 relative
    _close(got_total, want_total, 1e-5)
    for k in want_aux:
        _close(got_aux[k], want_aux[k], 1e-5)
    r, t = tloss.pose_losses({k: _t(v) for k, v in preds.items()},
                             {k: _t(v) for k, v in batch.items()}, decoder)
    _close(r, want_aux["loss_rotation"], 1e-5)
    _close(t, want_aux["loss_translation"], 1e-5)


def test_total_loss_accepts_depth_without_channel_axis():
    preds, batch = _loss_inputs(7, "decoder_v2", False)
    a, _ = tloss.total_loss({k: _t(v) for k, v in preds.items()},
                            {k: _t(v) for k, v in batch.items()})
    preds["pred_d1"] = preds["pred_d1"][..., 0]
    b, _ = tloss.total_loss({k: _t(v) for k, v in preds.items()},
                            {k: _t(v) for k, v in batch.items()})
    assert float(a) == float(b)


# ----------------------------------------------------------------- metrics

def test_metric_names_match():
    assert tmet.DEPTH_METRIC_NAMES == jmet.DEPTH_METRIC_NAMES
    assert tmet.POSE_METRIC_NAMES == jmet.POSE_METRIC_NAMES
    assert tmet.ALL_METRIC_NAMES == jmet.ALL_METRIC_NAMES


def test_eval_depth_masked_matches_jax_and_numpy():
    pred, target = _depth_pair(8)
    valid = target > 0
    want = jmet.eval_depth_masked(_j(pred), _j(target), _j(valid))
    got = tmet.eval_depth_masked(_t(pred), _t(target), _t(valid))
    oracle = tmet.eval_depth_np(pred[valid], target[valid])
    assert oracle == jmet.eval_depth_np(pred[valid], target[valid])
    for k in tmet.DEPTH_METRIC_NAMES:
        _close(got[k], want[k], 1e-5)        # fp32 means over ~1000 pixels
        _close(got[k], oracle[k], 1e-4)      # float64 boolean-index oracle


def test_eval_depth_masked_per_sample_matches_jax():
    pred, target = _depth_pair(9, (3, 20, 24))
    target[1] = 0.0                           # a sample with no valid pixel
    valid = target > 0
    want = jmet.eval_depth_masked_per_sample(_j(pred), _j(target), _j(valid))
    got = tmet.eval_depth_masked_per_sample(_t(pred), _t(target), _t(valid))
    for k in tmet.DEPTH_METRIC_NAMES:
        assert tuple(got[k].shape) == (3,)
        _close(got[k], want[k], 1e-5)
        assert float(got[k][1]) == 0.0


@pytest.mark.parametrize("dataset,crop,shape", [
    ("void", None, (2, 24, 32)), ("nyudepthv2", None, (1, 480, 640)),
    ("kitti", "garg_crop", (1, 88, 304)),
    ("kitti", "eigen_crop", (1, 88, 304)), ("kitti", None, (1, 88, 304))])
def test_eval_mask_matches_jax_with_nan_and_inf(dataset, crop, shape):
    pred, gt = _depth_pair(10, shape)
    pred.flat[3] = np.nan
    pred.flat[7] = np.inf
    pred.flat[11] = -np.inf
    gt.flat[5] = 50.0                          # above max_depth_eval
    kw = dict(min_depth_eval=1e-3, max_depth_eval=10.0, kitti_crop=crop)
    jp, jg, jm = jmet.eval_mask(dataset, _j(pred), _j(gt), **kw)
    tp, tg, tm = tmet.eval_mask(dataset, _t(pred), _t(gt), **kw)
    assert torch.isfinite(tp).all()
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < int(tm.sum()) < tm.numel()
    m = tmet.eval_depth_masked(tp, tg, tm)
    assert all(np.isfinite(float(v)) for v in m.values())


def _pose_inputs(seed, both):
    rng = np.random.default_rng(seed)
    B = 3

    def rot():
        return np.stack([jgeo.exp_so3(rng.normal(0, 0.3, 3))
                         for _ in range(B)]).reshape(B, 9).astype(np.float32)

    def tr():
        return rng.normal(0, 0.2, (B, 3)).astype(np.float32)

    pred = {"R12": rot(), "T12": tr(), "R21": rot() if both else None,
            "T21": tr() if both else None}
    target = {"R12": rot(), "T12": tr(), "R21": rot() if both else None,
              "T21": tr() if both else None}
    return pred, target


@pytest.mark.parametrize("both", [True, False])
def test_eval_pose_and_per_sample_match_jax(both):
    pred, target = _pose_inputs(11, both)
    jp = {k: _j(v) for k, v in pred.items()}
    jt = {k: _j(v) for k, v in target.items()}
    tp = {k: _t(v) for k, v in pred.items()}
    tt = {k: _t(v) for k, v in target.items()}
    want, got = jmet.eval_pose(jp, jt), tmet.eval_pose(tp, tt)
    want_ps = jmet.eval_pose_per_sample(jp, jt)
    got_ps = tmet.eval_pose_per_sample(tp, tt)
    assert sorted(got) == sorted(tmet.POSE_METRIC_NAMES)
    for k in tmet.POSE_METRIC_NAMES:
        _close(got[k], want[k], 1e-6)
        assert tuple(got_ps[k].shape) == (3,)
        _close(got_ps[k], want_ps[k], 1e-6)
        _close(got_ps[k].mean(), got[k], 1e-6)
    if both:
        assert float(got["pose_mse_r_identity"]) > 0
    else:
        assert float(got["pose_mse_r21"]) == 0.0
