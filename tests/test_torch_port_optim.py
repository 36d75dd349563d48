"""PyTorch port vs JAX package: LR schedule, layer ids, LR scales,
weight-decay and frozen flags of every parameter, and the AdamW update.

Per-parameter tables are compared through `ckpt.from_jax.key_map` /
`to_jax_tree`: the port works on dotted module names, the JAX package on
flax tree paths.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import optim as jopt
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import (convert_value, flatten_tree,
                                          key_map, load_jax_variables,
                                          to_jax_tree)
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.train import optim as topt

_SWIN = dict(depths=(2, 2, 2, 2), window_size=(6, 6, 6, 3),
             pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), drop_path_rate=0.1)


@pytest.mark.parametrize("epochs,spe", [(25, 40), (4, 10), (3, 7)])
def test_poly_lr_schedule_matches_jax_over_a_whole_run(epochs, spe):
    """Warm-up, the switch at half the epochs, decay and the min_lr floor.
    The JAX schedule computes in float32 (its power alone is good to ~2e-6
    relative), the port in Python floats: 5e-6 relative."""
    js = jopt.poly_lr_schedule(5e-4, 3e-5, spe, epochs)
    ts = topt.poly_lr_schedule(5e-4, 3e-5, spe, epochs)
    counts = np.arange(0, epochs * spe + 5)
    want = np.asarray(jax.vmap(js)(jnp.asarray(counts)))
    got = np.array([ts(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)
    half = spe * (epochs // 2)
    assert got[half - 2] < got[half - 1]            # still warming up
    assert got[half - 1] == pytest.approx(5e-4, rel=1e-3)   # the switch
    assert got[-1] >= 3e-5 and np.all(np.isfinite(got))


def test_poly_lr_schedule_of_one_epoch_is_min_lr_as_in_jax():
    """One epoch: no warm-up half (0 steps); the JAX schedule's float
    division by zero decays from +inf and floors at min_lr, the port's
    too (it used to raise ZeroDivisionError)."""
    js = jopt.poly_lr_schedule(5e-4, 3e-5, 4, 1)
    ts = topt.poly_lr_schedule(5e-4, 3e-5, 4, 1)
    want = np.asarray(jax.vmap(js)(jnp.arange(6)))
    got = np.array([ts(c) for c in range(6)])
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)
    assert np.all(got == 3e-5)


@pytest.fixture(scope="module")
def nano():
    """The nano two-frame model in both packages with shared weights."""
    kw = dict(backbone="swin_nano_v2", decoder="decoder_v2", model_scale=32,
              use_pallas_attention=False)
    jm = j_build_model(jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SWIN), **kw))
    f = jnp.zeros((1, 48, 48, 3), jnp.float32)
    v = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                       f, f, False))
    rng = np.random.default_rng(0)
    params = randomize_tree(v["params"], rng)
    stats = randomize_tree(v["batch_stats"], rng)
    tm = ttf.build_model(tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SWIN),
                                          **kw), device="cpu")
    load_jax_variables(tm, params, stats)
    return params, tm


def test_key_map_is_a_bijection_onto_the_parameters(nano):
    params, tm = nano
    km = key_map(params)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(km.values()) == sorted(names)
    assert len(set(km.values())) == len(km)


def test_to_jax_tree_round_trips_every_layout(nano):
    """Parameters carried back to the JAX layout equal what was loaded: the
    Linear transposes, OIHW and the transposed-conv flip are undone."""
    params, tm = nano
    back = flatten_tree(to_jax_tree(dict(tm.named_parameters()), params))
    want = flatten_tree(params)
    assert sorted(back) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(back[path], want[path],
                                      err_msg="/".join(path))
    assert any("deconv_0" in p for p in want)


@pytest.mark.parametrize("frozen_stages", [-1, 0, 2, 3])
def test_every_parameters_scale_decay_and_frozen_flag_match_jax(
        nano, frozen_stages):
    params, tm = nano
    depths = _SWIN["depths"]
    jscales, _ = jopt.build_layer_scales(params, depths, 0.9)
    jdecay = jopt.weight_decay_mask(params)
    jfrozen = jopt.frozen_stage_scales(params, frozen_stages)
    tables = {
        "scale": (topt.build_layer_scales(tm, depths, 0.9), jscales),
        "decay": (topt.weight_decay_mask(tm), jdecay),
        "frozen": (topt.frozen_stage_scales(tm, frozen_stages), jfrozen),
    }
    for what, (ours, theirs) in tables.items():
        got = flatten_tree(to_jax_tree(ours, params, convert=False))
        want = flatten_tree(theirs)
        assert sorted(got) == sorted(want)
        for path in want:
            assert float(got[path]) == pytest.approx(float(want[path]),
                                                     rel=1e-12), (what, path)
    ours = topt.weight_decay_mask(tm)
    # the RPE MLP is rpe_mlp.0 / rpe_mlp.2 here, rpe_fc1 / rpe_fc2 there
    rpe = [n for n in ours if ".rpe_mlp." in n and n.endswith("weight")]
    assert rpe and not any(ours[n] for n in rpe)
    assert ours["encoder.layers.0.blocks.0.attn.qkv.weight"]
    assert not ours["encoder.layers.0.blocks.0.attn.logit_scale"]
    scales = topt.build_layer_scales(tm, depths, 0.9)
    assert len(set(scales.values())) == sum(depths) + 3 + 2


def test_layer_ids_on_port_names():
    lps, n = [3, 3, 19, 2], 29
    cases = {
        "encoder.patch_embed.proj.weight": 0,
        "encoder.layers.0.blocks.0.attn.qkv.weight": 1,
        "encoder.layers.0.blocks.1.mlp.fc1.weight": 2,
        "encoder.layers.0.downsample.reduction.weight": 3,
        "encoder.layers.2.blocks.17.attn.proj.weight": 24,
        "encoder.layers.3.blocks.1.norm1.weight": 27,
        "encoder.norm3.weight": 28,
        "decoder.decoder_depth.deconv_layers.0.weight": 28,
        "decoder.decoder_pose.pos_layers.0.weight": 28,
    }
    for name, want in cases.items():
        assert topt.swin_layer_id(name, lps, n) == want, name


def _shared_grads(params, step, seed=1):
    rng = np.random.default_rng(seed + step)
    flat = flatten_tree(params)
    out = {}
    for path in sorted(flat):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        g = rng.standard_normal(flat[path].shape).astype(np.float32)
        node[path[-1]] = g * np.float32(10.0 ** rng.integers(-4, 1))
    return out


@pytest.mark.parametrize("frozen_stages", [-1, 2])
def test_adamw_updates_match_jax_on_shared_gradients(nano, frozen_stages):
    """Five updates from the same numpy gradients through
    build_optimizer(...) of both packages, float32. The one expression per
    parameter is evaluated in another order of roundings (Python-float
    bias corrections and lr here, float32 there): <= 1e-6 relative to each
    parameter's scale, plus 1e-7 absolute for parameters near zero."""
    params, tm0 = nano
    tm = copy.deepcopy(tm0)
    kw = dict(backbone="swin_nano_v2", depths=_SWIN["depths"], max_lr=5e-4,
              min_lr=3e-5, weight_decay=0.05, layer_decay=0.9,
              steps_per_epoch=3, epochs=2, frozen_stages=frozen_stages)
    tx, _ = jopt.build_optimizer(params, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    opt, _ = topt.build_optimizer(tm, device="cpu", **kw)
    km = key_map(params)
    named = dict(tm.named_parameters())
    for step in range(5):                # crosses the warm-up/decay switch
        grads = _shared_grads(params, step)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat_g = flatten_tree(grads)
        for path, key in km.items():
            from mmde_tpu_torch.ckpt.from_jax import convert_value
            g = np.ascontiguousarray(convert_value(key, flat_g[path]))
            named[key].grad = torch.from_numpy(g.copy())
        opt.step()
    assert opt.count == 5
    got = flatten_tree(to_jax_tree(named, params))
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    start = flatten_tree(params)
    moved = 0
    for path in want:
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-6 * scale + 1e-7,
                                   err_msg="/".join(path))
        moved += int(np.any(want[path] != start[path]))
    frozen = [p for p in want if np.array_equal(want[p], start[p])]
    if frozen_stages < 0:
        assert not frozen
    else:       # patch_embed and stage 0 stay put, in both packages
        assert frozen and all(
            p[1].startswith("patch_embed") or p[1] == "layers_0"
            for p in frozen)
        for p in frozen:
            np.testing.assert_array_equal(got[p], start[p])
    assert moved > 100


def test_parameter_without_gradient_still_decays():
    """A missing gradient counts as zero (weight decay still applies), as
    in the JAX update."""
    lin = torch.nn.Linear(3, 2)
    w0 = lin.weight.detach().clone()
    opt = topt.LayerDecayAdamW(lin, lambda c: 0.1, weight_decay=0.5)
    lin.bias.grad = torch.ones(2)
    opt.step()
    torch.testing.assert_close(lin.weight.detach(), w0 * (1 - 0.1 * 0.5))
    sd = opt.state_dict()
    opt2 = topt.LayerDecayAdamW(lin, lambda c: 0.1, weight_decay=0.5)
    opt2.load_state_dict(sd)
    assert opt2.count == 1


def test_build_optimizer_wants_the_models_device():
    lin = torch.nn.Linear(3, 2)
    kw = dict(backbone="x", depths=(1,), max_lr=1e-3, min_lr=1e-4,
              weight_decay=0.1, layer_decay=1.0, steps_per_epoch=2, epochs=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            topt.build_optimizer(lin, **kw)
    opt, sched = topt.build_optimizer(lin, device="cpu", **kw)
    assert len(opt.param_groups) == 2 and sched(0) > 0   # weight / bias
