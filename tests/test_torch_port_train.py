"""PyTorch port vs JAX package: the training slice, on the CPU.

Backbone gradients at both attention implementations against `jax.grad`,
rematerialisation (memory, never values), BatchNorm in train mode, one model
object serving and training in turn, and whole train / eval steps against
the JAX package's. Weights and batches are drawn with numpy and handed to
both sides; the JAX step runs `deterministic=True`, because the two
frameworks' random bits differ.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.nn import layers as jlayers
from mmde_tpu.nn import swin_v2 as jsw
from mmde_tpu.train import optim as jopt
from mmde_tpu.train import step as jstep
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import (flatten_tree, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.nn import layers as tlayers
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.tools import infer, train_steps
from mmde_tpu_torch.train import optim as topt
from mmde_tpu_torch.train import step as tstep

_SWIN = dict(depths=(2, 2, 2, 2), window_size=(6, 6, 6, 3),
             pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), drop_path_rate=0.3)
_OPT = dict(max_lr=5e-4, min_lr=3e-5, weight_decay=0.05, layer_decay=0.9,
            steps_per_epoch=4, epochs=4)
_LOSS = dict(decoder="decoder_v2", lambda_rot=100.0, lambda_trans=100.0)


# ----------------------------------------------------- backbone gradients

@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda"),
                                         ("pallas_slab", "cuda_slab")])
def test_backbone_gradients_match_jax_grad(jimpl, timpl):
    """embed 128 / heads 4, 8 (Dh = 32: the packed layout, or the slab
    kernels on the map, on both sides), a shifted block and a patch
    merging. d(sum(out * w))/d(params) for every parameter; the JAX
    "pallas" / "pallas_slab" side runs its forward and backward kernels in
    interpret mode, the port's "cuda" / "cuda_slab" side the autograd
    Function on its plain halves. fp32 sums in another order through 4
    blocks: 5e-4 of each gradient's largest entry."""
    kw = dict(embed_dim=128, depths=(2, 2), num_heads=(4, 8),
              window_size=(6, 6), drop_path_rate=0.0, out_indices=(1,),
              pretrain_window_size=(4, 4))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 48, 48, 3)).astype(np.float32)
    jm = jsw.SwinTransformerV2(attn_impl=jimpl, **kw)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(x)))
    params = randomize_tree(v["params"], rng)
    out_shape = jax.eval_shape(lambda: jm.apply({"params": params},
                                                jnp.asarray(x)))[-1].shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x))[-1] * w)

    want = flatten_tree(jax.tree.map(np.asarray, jax.grad(loss)(
        jax.tree.map(jnp.asarray, params))))

    tm = tsw.SwinTransformerV2(attn_impl=timpl, **kw)
    load_jax_variables(tm, params)
    tm.train()                        # drop path 0: same function as eval
    (tm(torch.from_numpy(x))[-1] * torch.from_numpy(w)).sum().backward()
    got = flatten_tree(to_jax_tree(
        {n: p.grad for n, p in tm.named_parameters()}, params))
    assert sorted(got) == sorted(want)
    for path in want:
        scale = np.abs(want[path]).max()
        assert scale > 0, path
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=5e-4 * scale, err_msg="/".join(path))


# ------------------------------------------------------------------ remat

def _swin(remat_policy, use_checkpoint=True, seed=3):
    gen = torch.Generator()
    gen.manual_seed(seed)
    torch.manual_seed(0)
    m = tsw.SwinTransformerV2(
        embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=(6, 6),
        drop_path_rate=0.3, out_indices=(1,), pretrain_window_size=(4, 4),
        use_checkpoint=use_checkpoint, remat_policy=remat_policy,
        attn_impl="cuda", generator=gen)
    return m.train()


def _grads(m, x):
    m(x)[-1].square().sum().backward()
    return {n: p.grad.clone() for n, p in m.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "mlp_only"])
def test_remat_changes_memory_never_values(policy):
    """Train mode, drop path 0.3, one seed: gradients with and without
    rematerialisation are equal bit for bit (the recomputed block sees the
    drop-path masks of its first run)."""
    x = torch.randn(4, 48, 48, 3, generator=torch.Generator().manual_seed(1))
    base = _grads(_swin("none"), x)
    got = _grads(_swin(policy), x)
    assert sorted(got) == sorted(base)
    for n in base:
        torch.testing.assert_close(got[n], base[n], rtol=0, atol=0, msg=n)
    other = _grads(_swin("none", seed=4), x)        # the masks do matter
    assert any(not torch.equal(other[n], base[n]) for n in base)


def test_use_checkpoint_false_ignores_the_policy():
    x = torch.randn(2, 48, 48, 3, generator=torch.Generator().manual_seed(1))
    a = _grads(_swin("none"), x)
    b = _grads(_swin("attn_out", use_checkpoint=False), x)
    for n in a:
        torch.testing.assert_close(a[n], b[n], rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["attn_out", "attn_qkv"])
def test_named_residual_policies_raise_when_training(policy):
    m = _swin(policy)
    x = torch.randn(1, 48, 48, 3)
    with pytest.raises(NotImplementedError, match="remat_policy"):
        m(x)
    with torch.no_grad():                           # serving is unaffected
        assert m.eval()(x)[-1].shape == (1, 6, 6, 64)
    with pytest.raises(ValueError):
        _swin("typo")


# -------------------------------------------------------------- BatchNorm

def test_batchnorm_train_mode_matches_the_jax_package():
    """Output and updated running statistics against the JAX package's
    TorchBatchNorm (what its decoders use), and the stated difference from
    flax's own BatchNorm: both normalise with the biased batch variance,
    flax feeds that one into the running variance, torch (and the JAX
    package) the unbiased one, n / (n - 1) larger."""
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 6, 8)) * 2 + 1).astype(np.float32)  # NHWC
    n = 2 * 5 * 6
    variables = {"params": {"scale": rng.normal(1, 0.1, 8).astype(np.float32),
                            "bias": rng.normal(0, 0.1, 8).astype(np.float32)},
                 "batch_stats": {
                     "mean": rng.normal(0, 0.2, 8).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}
    jbn = jlayers.TorchBatchNorm(momentum=0.9, epsilon=1e-5)
    want, mut = jbn.apply(variables, jnp.asarray(x), False,
                          mutable=["batch_stats"])
    tbn = tlayers.TorchBatchNorm(8).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))
    got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    fwant, fmut = fbn.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(fwant),
                               rtol=1e-5, atol=1e-5)        # same output
    biased = (np.asarray(fmut["batch_stats"]["var"])
              - 0.9 * variables["batch_stats"]["var"]) / 0.1
    unbiased = (tbn.running_var.numpy()
                - 0.9 * variables["batch_stats"]["var"]) / 0.1
    np.testing.assert_allclose(unbiased, biased * n / (n - 1), rtol=1e-4)
    # bf16 output type, fp32 statistics
    y = tlayers.TorchBatchNorm(8, dtype=torch.bfloat16).train()(
        torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    assert y.dtype == torch.bfloat16


# ------------------------------------------------- the nano two-frame pair

def _model_cfgs(attn="plain", decoder="decoder_v2"):
    kw = dict(backbone="swin_nano_v2", decoder=decoder, model_scale=32,
              max_depth=10.0, use_pallas_attention=attn == "kernel")
    return (jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SWIN), **kw),
            tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SWIN), **kw))


def _batch(B=2, h=96, w=96, seed=5):
    b = train_steps.synthetic_batch(B, h, w, seed)
    return {k: v.numpy() for k, v in b.items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, port model config, numpy batch)."""
    jc, tc = _model_cfgs()
    batch = _batch()
    jm = j_build_model(jc)
    f = jnp.zeros((2, 96, 96, 3), jnp.float32)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       f, f, False))
    rng = np.random.default_rng(7)
    variables = {"params": randomize_tree(v["params"], rng),
                 "batch_stats": randomize_tree(v["batch_stats"], rng)}
    return jm, variables, tc, batch


def _port_model(tc, variables, attn_impl=None):
    if attn_impl is not None:
        tc = tcfg.replace(tc, attn_impl=attn_impl)
    tm = ttf.build_model(tc, device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    return tm


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("attn_impl", ["torch", "cuda"])
def test_three_deterministic_train_steps_match_jax(pair, attn_impl):
    """Three steps of make_train_step(deterministic=True) in fp32 from
    shared weights on one shared batch (uint8 frames, a fifth of the depth
    invalid, both pose directions), through build_optimizer of both
    packages. Losses: 1e-4 relative per step (fp32, sums in another order;
    later steps also carry the updates). Parameters after the last step: a
    norm-level tolerance - Adam's first steps divide by sqrt(v), so an entry
    whose gradient is near zero moves by +-lr on sign noise; what must
    agree is the update as a whole: |dp_port - dp_jax| <= 5 % of |dp_jax|
    per parameter tensor."""
    jm, variables, tc, batch = pair
    tx, _ = jopt.build_optimizer(variables["params"],
                                 backbone="swin_nano_v2",
                                 depths=_SWIN["depths"], **_OPT)
    jstate = jstep.TrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax.tree.map(jnp.asarray, variables["batch_stats"]), tx,
        jax.random.PRNGKey(0))
    jtrain = jstep.make_train_step(jm, tx, donate=False, deterministic=True,
                                   **_LOSS)
    tm = _port_model(tc, variables, attn_impl)
    opt, _ = topt.build_optimizer(tm, backbone="swin_nano_v2",
                                  depths=_SWIN["depths"], device="cpu",
                                  **_OPT)
    ttrain = tstep.make_train_step(tm, opt, deterministic=True, device="cpu",
                                   **_LOSS)
    tstate = tstep.TrainState.create(tm, opt, torch.Generator())
    jb, tb = _jbatch(batch), _tbatch(batch)
    for i in range(3):
        jstate, jaux = jtrain(jstate, jb)
        tstate, taux = ttrain(tstate, tb)
        assert sorted(taux) == sorted(jaux)
        for k in jaux:
            assert isinstance(taux[k], torch.Tensor)
            assert not taux[k].requires_grad
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert tstate.step == int(jstate.step) == 3 and opt.count == 3
    assert not tm.training                  # deterministic: eval-mode modules
    start = flatten_tree(variables["params"])
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    got = flatten_tree(to_jax_tree(dict(tm.named_parameters()),
                                   variables["params"]))
    worst = 0.0
    for path in want:
        dj = want[path] - start[path]
        dt = got[path] - start[path]
        assert np.linalg.norm(dj) > 0, path
        worst = max(worst, np.linalg.norm(dt - dj) / np.linalg.norm(dj))
    assert worst <= 0.05, worst
    # running statistics untouched in deterministic mode, as in JAX
    stats = flatten_tree(to_jax_tree(dict(tm.named_buffers()),
                                     variables["batch_stats"]))
    for path, v in flatten_tree(variables["batch_stats"]).items():
        np.testing.assert_array_equal(stats[path], v)


def _train_losses(tc, variables, batch, seed, steps=2):
    tm = _port_model(tc, variables)
    opt, _ = topt.build_optimizer(tm, backbone="swin_nano_v2",
                                  depths=_SWIN["depths"], device="cpu",
                                  **_OPT)
    step = tstep.make_train_step(tm, opt, device="cpu", **_LOSS)
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = tstep.TrainState.create(tm, opt, gen)
    global_rng = torch.get_rng_state()
    out = []
    for _ in range(steps):
        state, aux = step(state, _tbatch(batch))
        out.append({k: float(v) for k, v in aux.items()})
    assert tm.training
    # the steps drew nothing from torch's global generator
    assert torch.equal(torch.get_rng_state(), global_rng)
    return out, tm


def test_train_mode_draws_from_the_given_generator(pair):
    """Drop path and the pose head's dropout take their bits from the
    TrainState's generator: one seed gives one trajectory, another seed
    another; torch's global generator is left alone; BatchNorm's running
    statistics move."""
    _, variables, tc, batch = pair
    a, tm = _train_losses(tc, variables, batch, seed=1)
    b, _ = _train_losses(tc, variables, batch, seed=1)
    c, _ = _train_losses(tc, variables, batch, seed=2)
    assert a == b
    assert a[0]["loss_rotation"] != c[0]["loss_rotation"]   # dropout(0.5)
    assert all(np.isfinite(v) for rec in a for v in rec.values())
    stats0 = flatten_tree(variables["batch_stats"])
    stats1 = flatten_tree(to_jax_tree(dict(tm.named_buffers()),
                                      variables["batch_stats"]))
    assert all(not np.array_equal(stats0[p], stats1[p]) for p in stats0)


def test_serve_train_serve_on_one_model(pair):
    """One model object: serve (inference mode fills the bias and mask
    caches), train, evaluate, train again with frozen RPE parameters (the
    cached bias is saved for the backward: it must not be an inference
    tensor), serve."""
    _, variables, tc, batch = pair
    tm = _port_model(tc, variables, "cuda")
    f1, f2 = batch["image1"], batch["image2"]
    first = infer.predict(tm, f1, f2)
    opt, _ = topt.build_optimizer(tm, backbone="swin_nano_v2",
                                  depths=_SWIN["depths"], device="cpu",
                                  **_OPT)
    step = tstep.make_train_step(tm, opt, deterministic=True, device="cpu",
                                 **_LOSS)
    evaluate = tstep.make_eval_step(tm, device="cpu", **_LOSS)
    state = tstep.TrainState.create(tm, opt, torch.Generator())
    state, aux1 = step(state, _tbatch(batch))
    preds, eaux = evaluate(state, _tbatch(batch))
    assert preds["pred_d1"].is_inference()
    for n, p in tm.named_parameters():
        if ".rpe_mlp." in n:
            p.requires_grad_(False)
    attn = tm.encoder.layers[0].blocks[1].attn
    with torch.inference_mode():
        cached = attn.rpe_bias()
    assert attn._bias_cache is not None and not cached.is_inference()
    state, aux2 = step(state, _tbatch(batch))           # consults the cache
    assert attn.rpe_mlp[0].weight.grad is None or not bool(
        attn.rpe_mlp[0].weight.grad.any())
    assert attn.qkv.weight.grad is not None
    last = infer.predict(tm, f1, f2)
    assert state.step == 2
    assert np.isfinite(float(aux1["loss_total"]))
    assert np.isfinite(float(aux2["loss_total"]))
    assert np.isfinite(float(eaux["loss_total"]))
    assert np.abs(last["pred_d1"] - first["pred_d1"]).max() > 0
    assert np.isfinite(last["pred_d1"]).all()


@pytest.mark.parametrize("flip_tta", [False, True])
def test_eval_steps_match_jax(pair, flip_tta):
    """make_eval_step and make_eval_metrics_step against the JAX package's:
    predictions (depth 1e-3 on a 0-10 range, pose 1e-4, as the forward
    tests hold them), the loss aux (1e-4 relative) and the per-sample
    metric vectors (1e-3: ratios of sums over pixels whose predictions
    differ at 1e-4)."""
    jm, variables, tc, batch = pair
    tx = jopt.build_optimizer(variables["params"], backbone="swin_nano_v2",
                              depths=_SWIN["depths"], **_OPT)[0]
    jstate = jstep.TrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]),
        jax.tree.map(jnp.asarray, variables["batch_stats"]), tx,
        jax.random.PRNGKey(0))
    tm = _port_model(tc, variables)
    tstate = tstep.TrainState(tm, None)
    jpred, jaux = jstep.make_eval_step(jm, flip_tta=flip_tta, **_LOSS)(
        jstate, _jbatch(batch))
    tpred, taux = tstep.make_eval_step(tm, flip_tta=flip_tta, device="cpu",
                                       **_LOSS)(tstate, _tbatch(batch))
    assert np.asarray(jpred["pred_d1"]).std() > 0.1
    for k in ("pred_d1", "pred_d2"):
        np.testing.assert_allclose(tpred[k].numpy(), np.asarray(jpred[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    for k in ("pred_r12", "pred_r21", "pred_t12", "pred_t21"):
        np.testing.assert_allclose(tpred[k].numpy(), np.asarray(jpred[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4)
    kw = dict(dataset="void", min_depth_eval=1e-3, max_depth_eval=10.0,
              flip_tta=flip_tta, **_LOSS)
    jmet, _ = jstep.make_eval_metrics_step(jm, **kw)(jstate, _jbatch(batch))
    tmet, _ = tstep.make_eval_metrics_step(tm, device="cpu", **kw)(
        tstate, _tbatch(batch))
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        assert tuple(tmet[k].shape) == (2,)
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_shift_window_is_not_ported_and_says_where():
    """Shift-window evaluation is ported (tests/test_torch_port_tta.py);
    what stays unported with it, as in the JAX package, is its combination
    with sparse-depth inputs, and that raises and says so."""
    tm = torch.nn.Linear(2, 2)
    tstep.make_eval_step(tm, shift_window=64, device="cpu", **_LOSS)
    step = tstep.make_eval_metrics_step(
        tm, dataset="void", min_depth_eval=1e-3, max_depth_eval=10.0,
        shift_window=64, device="cpu", **_LOSS)
    frames = torch.zeros(1, 64, 96, 3)
    batch = {"image1": frames, "image2": frames,
             "sparse_depth1": torch.zeros(1, 64, 96)}
    with pytest.raises(NotImplementedError, match="sparse-depth"):
        step(None, batch)


def test_decoder_v1_train_step_runs(pair):
    """decoder_v1: forward-direction pose only, r21 / t21 absent."""
    _, tc = _model_cfgs(decoder="decoder_v1")
    tm = ttf.build_model(tc, device="cpu")
    opt, _ = topt.build_optimizer(tm, backbone="swin_nano_v2",
                                  depths=_SWIN["depths"], device="cpu",
                                  **_OPT)
    step = tstep.make_train_step(tm, opt, decoder="decoder_v1",
                                 lambda_rot=100.0, lambda_trans=100.0,
                                 device="cpu")
    state = tstep.TrainState.create(tm, opt, torch.Generator())
    state, aux = step(state, _tbatch(_batch(B=2, seed=9)))
    assert np.isfinite(float(aux["loss_total"]))


# -------------------------------------------------------- trainer entry

def test_trainer_entry_takes_steps_on_the_cpu(tmp_path, capsys):
    cfg = tmp_path / "nano.yaml"
    cfg.write_text(
        "BACKBONE: swin_nano_v2\nDECODER: decoder_v2\nMODEL_SCALE: 32\n"
        "BATCH_SIZE: 2\nSWIN:\n  DEPTHS: [2, 2, 2, 2]\n"
        "  WINDOW_SIZE: [6, 6, 6, 3]\n  PRETRAIN_WINDOW_SIZE: [4, 4, 4, 2]\n"
        "  DROP_PATH_RATE: 0.1\n")
    train_steps.main(["--steps", "2", "--config", str(cfg), "--height", "96",
                      "--width", "96", "--device", "cpu", "--seed", "3"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss_total"]) and r["ms"] > 0 for r in lines)
    assert "peak_memory_bytes" not in lines[0]      # a device metric


def test_flagship_config_is_the_flagship():
    """The trainer's default equals the model and SWIN blocks of
    configs/flagship_synth.yaml."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = tcfg.load_yaml(os.path.join(root, "configs", "flagship_synth.yaml"))
    got = train_steps.flagship_config(batch_size=want.train.batch_size)
    for f in ("backbone", "decoder", "model_scale", "dtype", "max_depth"):
        assert getattr(got.model, f) == getattr(want.model, f), f
    for f in ("depths", "window_size", "pretrain_window_size", "use_shift",
              "drop_path_rate", "use_checkpoint", "remat_policy"):
        assert getattr(got.model.swin, f) == getattr(want.model.swin, f), f
    assert ttf.resolve_attn_impl(got.model) == "cuda"


def test_synthetic_batch_is_consistent():
    b = train_steps.synthetic_batch(2, 32, 40, seed=0)
    assert b["image1"].dtype == torch.uint8 and b["depth1"].shape == (2, 32, 40)
    frac = float((b["depth1"] == 0).float().mean())
    assert 0.1 < frac < 0.3 and float(b["depth1"].max()) < 10.0
    R12 = b["R12"].reshape(2, 3, 3)
    R21 = b["R21"].reshape(2, 3, 3)
    eye = torch.eye(3).expand(2, 3, 3)
    torch.testing.assert_close(R12 @ R21, eye, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        b["T12"] + (R12 @ b["T21"][..., None])[..., 0], torch.zeros(2, 3),
        rtol=0, atol=1e-6)
    again = train_steps.synthetic_batch(2, 32, 40, seed=0)
    assert all(torch.equal(b[k], again[k]) for k in b)
