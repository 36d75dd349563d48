"""PyTorch port vs JAX package: pretrained backbone loading
(ckpt/pretrained.py, ckpt/torch_convert.py).

Synthetic checkpoints only, written with torch.save: a SimMIM-style SwinV2
state dict (`module.encoder.` prefixes, the static buffers, keys no model
has, one tensor left out, one of another shape), the same with a discrete
relative-position table at another window (resampled), a torchvision
ResNet-18 with its running statistics, and a whole reference
cnn_transformer encoder. Each goes through the JAX `load_pretrained` (or
its converter) and then `load_jax_variables` into a port model, and
through the port's own loader into a port model from the same starting
weights: the two state dicts must be equal bit for bit, and the reports
(missing / unexpected keys, notes) the same, the JAX flax paths read as
the port's keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.ckpt import pretrained as jpre
from mmde_tpu.ckpt import torch_convert as jtc
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.nn import swin_v2 as jsw
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt import pretrained as tpre
from mmde_tpu_torch.ckpt import torch_convert as ttc
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables, torch_key
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.nn import swin_v2 as tsw
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.train import loop as tloop

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

_SWIN = dict(depths=(1, 1, 1, 1), window_size=(4, 4, 4, 2),
             pretrain_window_size=(4, 4, 4, 2),
             use_shift=(True, True, False, False), drop_path_rate=0.0)


def _cfgs(**kw):
    base = dict(backbone="swin_nano_v2", decoder="decoder_v2",
                model_scale=32)
    base.update(kw)
    return (jcfg.ModelConfig(swin=jcfg.SwinConfig(**_SWIN),
                             use_pallas_attention=False, **base),
            tcfg.ModelConfig(swin=tcfg.SwinConfig(**_SWIN), **base))


def _variables(jm, seed, *args):
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)
    return (randomize_tree(v["params"], rng),
            randomize_tree(v.get("batch_stats", {}), rng))


def _drawn(state: dict, seed: int) -> dict:
    """A tensor of every float entry of `state`, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in state.items() if v.is_floating_point()}


def _assert_same(want: dict, got: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _port_keys(entries, prefix=(), single_scale=False):
    """JAX report entries ("a/b/c" or "a/b/c (shape ...)") -> {port key:
    whether a shape mismatch}."""
    out = {}
    for e in entries:
        path, _, shape = e.partition(" (shape ")
        out[torch_key(prefix + tuple(path.split("/")), single_scale)] = \
            bool(shape)
    return out


def _port_entries(entries):
    return {e.partition(" (shape ")[0]: " (shape " in e for e in entries}


# ------------------------------------------------------------------ swin


def _swin_file(tmp_path, encoder_state, seed, extra=None, drop=(),
               reshape=()):
    sd = _drawn(encoder_state, seed)
    for k in drop:
        del sd[k]
    for k in reshape:
        sd[k] = torch.zeros((3,) + tuple(sd[k].shape[1:]))
    sd.update(extra or {})
    wrapped = {f"module.encoder.{k}": v for k, v in sd.items()}
    # the static buffers of a SimMIM checkpoint, skipped by both loaders;
    # keys of the pretraining head, reported as unmapped
    wrapped["module.encoder.layers.0.blocks.0.attn.relative_position_index"] \
        = torch.zeros(16, 16, dtype=torch.long)
    wrapped["module.encoder.layers.0.blocks.0.attn.relative_coords_table"] \
        = torch.zeros(1, 7, 7, 2)
    wrapped["module.encoder.mask_token"] = torch.zeros(1, 1, 32)
    wrapped["module.decoder.0.weight"] = torch.zeros(8, 4, 1, 1)
    path = tmp_path / "simmim.pth"
    torch.save({"model": wrapped, "epoch": 99}, str(path))
    return str(path), {k[len("module.encoder."):]: v
                       for k, v in wrapped.items()}


def test_swin_checkpoint_loads_as_the_jax_loader(tmp_path, capsys):
    jc, tc = _cfgs()
    jm = j_build_model(jc)
    f = jnp.zeros((1, 64, 64, 3))
    params, stats = _variables(jm, 1, f, f, False)
    got = ttf.build_model(tc, device="cpu")
    load_jax_variables(got, params, stats)
    extra = {"layers.0.blocks.7.norm1.weight": torch.ones(32)}
    path, sd = _swin_file(
        tmp_path, got.encoder.state_dict(), 2, extra=extra,
        drop=("layers.1.blocks.0.mlp.fc2.bias",),
        reshape=("layers.0.downsample.reduction.weight",))

    jparams, jstats = jpre.load_pretrained(
        jax.tree.map(lambda x: x, params), dict(stats), jc, path)
    jout = capsys.readouterr().out
    report = tpre.load_pretrained(got, tc, path)
    tout = capsys.readouterr().out
    want = ttf.build_model(tc, device="cpu")
    load_jax_variables(want, jparams, jstats)
    _assert_same(want.state_dict(), got.state_dict())
    # the file's tensors, bitwise, wherever the model took them
    state = got.encoder.state_dict()
    for k, v in sd.items():
        if k in state and state[k].shape == v.shape:
            assert torch.equal(state[k], v), k

    # the report: the JAX function's lists, in the port's keys
    np_sd = jtc.load_torch_state_dict(path)
    converted, notes = jtc.convert_swin(
        np_sd, dst_windows=dict(enumerate(jc.swin.window_size)))
    _, missing, unexpected = jtc.apply_pretrained(params["encoder"],
                                                  converted)
    t_missing, t_unexpected, t_notes = report
    assert _port_entries(t_missing) == _port_keys(missing) == {
        "layers.1.blocks.0.mlp.fc2.bias": False,
        "layers.0.downsample.reduction.weight": True}
    assert _port_entries(t_unexpected) == _port_keys(unexpected) == {
        "layers.0.blocks.7.norm1.weight": False}
    assert t_notes == notes == ["unmapped: mask_token",
                                "unmapped: decoder.0.weight"]
    first = [ln for ln in jout.splitlines() if ln.startswith("[pretrained]")]
    assert first == [ln for ln in tout.splitlines()
                     if ln.startswith("[pretrained]")]
    assert "2 missing, 1 unexpected" in first[0]


@pytest.mark.parametrize("mode", ["geo", "bicubic"])
def test_interpolate_rpe_table_is_the_jax_function(mode):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((7 * 7, 3)).astype(np.float32)
    for src, dst in ((4, 6), (4, 3), (12, 30)):
        t = (rng.standard_normal(((2 * src - 1) ** 2, 3)).astype(np.float32)
             if src != 4 else table)
        got = ttc.interpolate_rpe_table(t, src, dst, mode)
        want = jtc.interpolate_rpe_table(t, src, dst, mode)
        assert got.shape == want.shape == ((2 * dst - 1) ** 2, 3)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _DiscreteSwin(torch.nn.Module):
    """An encoder with the discrete relative-position table
    (rpe_table_type="none"), under `encoder` as the models hold theirs."""

    def __init__(self):
        super().__init__()
        self.encoder = tsw.SwinTransformerV2(
            embed_dim=32, depths=(1, 1), num_heads=(1, 2), window_size=(4, 4),
            pretrain_window_size=(4, 4), out_indices=(1,),
            rpe_table_type="none", drop_path_rate=0.0)


@pytest.mark.parametrize("mode", ["geo", "bicubic"])
def test_discrete_table_resampled_as_the_jax_loader(tmp_path, mode):
    """Tables pretrained at window 3 (5 x 5 offsets) loaded into a window-4
    encoder (7 x 7): resampled by `interpolate_rpe_table` in both loaders,
    bitwise equal after the load; every other tensor is the file's."""
    jenc = jsw.SwinTransformerV2(
        embed_dim=32, depths=(1, 1), num_heads=(1, 2), window_size=(4, 4),
        pretrain_window_size=(4, 4), out_indices=(1,),
        rpe_table_type="none", drop_path_rate=0.0)
    v = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 32, 32, 3))))
    params = {"encoder": randomize_tree(v["params"],
                                        np.random.default_rng(6))}
    tm = _DiscreteSwin()
    state = tm.encoder.state_dict()
    tables = [k for k in state if k.endswith("relative_position_bias_table")]
    assert len(tables) == 2
    rng = np.random.default_rng(7)
    small = {k: torch.from_numpy(rng.standard_normal(
        (25, state[k].shape[1])).astype(np.float32)) for k in tables}
    path, sd = _swin_file(tmp_path, {k: v for k, v in state.items()
                                     if k not in tables}, 8, extra=small)
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, swin=dataclasses.replace(
        tc.swin, window_size=(4, 4)))
    jc, _ = _cfgs()
    jparams, _ = jpre.load_pretrained(params, {}, jc, path, mode,
                                      verbose=False)
    want = _DiscreteSwin()
    load_jax_variables(want.encoder, jparams["encoder"])
    got = _DiscreteSwin()
    load_jax_variables(got.encoder, params["encoder"])
    missing, unexpected, _ = tpre.load_pretrained(got, tc, path, mode,
                                                  verbose=False)
    assert missing == [] and unexpected == []
    _assert_same(want.state_dict(), got.state_dict())
    for k in tables:
        table = got.encoder.state_dict()[k]
        assert table.shape == (49, small[k].shape[1])
        f64 = ttc.interpolate_rpe_table(small[k].numpy().astype(np.float64),
                                        3, 4, mode)
        np.testing.assert_array_equal(table.numpy(), f64.astype(np.float32))


# ---------------------------------------------------------------- resnet

def _cnn_cfgs(backbone="cnn_transformer_multi_scale"):
    kw = dict(backbone=backbone, decoder="decoder_v2", model_scale=32)
    return (jcfg.ModelConfig(cnn=jcfg.CnnTransformerConfig(
                cnn_model="resnet18", transformer_ff_dim=64), **kw),
            tcfg.ModelConfig(cnn=tcfg.CnnTransformerConfig(
                cnn_model="resnet18", transformer_ff_dim=64), **kw))


@pytest.mark.parametrize("backbone", ["cnn_transformer_multi_scale",
                                      "resnet_only"])
def test_torchvision_resnet_loads_as_the_jax_loader(tmp_path, backbone):
    """A torchvision ResNet-18 (stem, four layers, the classifier, the
    BatchNorms' counters) into the encoder's trunk, running statistics
    included; the single-scale trunk stops at layer3, so layer4 comes back
    unexpected in both loaders."""
    from mmde_tpu_torch.nn.resnet import ResNetFeatures
    jc, tc = _cnn_cfgs(backbone)
    jm = j_build_model(jc)
    f = jnp.zeros((1, 64, 64, 3))
    params, stats = _variables(jm, 9, f, f, False)
    tv = ResNetFeatures("resnet18").state_dict()
    sd = _drawn(tv, 10)
    for k, v in tv.items():
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
        elif k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    path = tmp_path / "resnet18.pth"
    torch.save(sd, str(path))

    jparams, jstats = jpre.load_pretrained(
        jax.tree.map(lambda x: x, params), jax.tree.map(lambda x: x, stats),
        jc, str(path), verbose=False)
    want = ttf.build_model(tc, device="cpu")
    load_jax_variables(want, jparams, jstats)
    got = ttf.build_model(tc, device="cpu")
    load_jax_variables(got, params, stats)
    missing, unexpected, notes = tpre.load_pretrained(got, tc, str(path),
                                                      verbose=False)
    _assert_same(want.state_dict(), got.state_dict())
    single = backbone == "resnet_only"
    trunk = got.encoder.feature_extractor.backbone.state_dict()
    stat = "feature.1.running_var" if single else "feature3.1.running_var"
    assert torch.equal(trunk[stat], sd["bn1.running_var"])

    np_sd = jtc.load_torch_state_dict(str(path))
    converted, _, jnotes = jtc.convert_resnet(np_sd)
    _, jmissing, junexpected = jtc.apply_pretrained(
        params["encoder"]["feature_extractor"]["backbone"]["trunk"],
        converted)
    assert _port_entries(missing) == _port_keys(jmissing, ("trunk",), single)
    assert _port_entries(unexpected) == _port_keys(junexpected, ("trunk",),
                                                   single)
    assert notes == jnotes == []
    assert missing == []
    assert (len(unexpected) > 0) == single


def test_whole_cnn_transformer_checkpoint_as_the_jax_converter():
    """A reference cnn_transformer encoder's whole state dict (under
    `module.`): trunk, squeeze convolutions and fusion, the transformer
    layers' packed in_proj (split per head by the JAX converter)."""
    jc, tc = _cnn_cfgs()
    jm = j_build_model(jc)
    f = jnp.zeros((1, 64, 64, 3))
    params, stats = _variables(jm, 11, f, f, False)
    tm = ttf.build_model(tc, device="cpu")
    state = tm.encoder.state_dict()
    sd = _drawn(state, 12)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
    sd = {f"module.{k}": v for k, v in sd.items()}

    np_sd = {k: v.numpy() for k, v in sd.items()}
    heads = tm.encoder.transformer_encoder[0].self_attn.num_heads
    jp, js, jnotes = jtc.convert_cnn_transformer(np_sd, multi_scale=True,
                                                 num_heads=heads)
    enc, jmissing, junexpected = jtc.apply_pretrained(params["encoder"], jp)
    enc_stats, _, _ = jtc.apply_pretrained(stats["encoder"], js)
    want = ttf.build_model(tc, device="cpu")
    load_jax_variables(want, {**params, "encoder": enc},
                       {**stats, "encoder": enc_stats})
    got = ttf.build_model(tc, device="cpu")
    load_jax_variables(got, params, stats)
    converted, notes = ttc.convert_cnn_transformer(sd, multi_scale=True)
    missing, unexpected = ttc.apply_pretrained(got.encoder, converted)
    _assert_same(want.state_dict(), got.state_dict())
    assert missing == [] and unexpected == [] and notes == []
    assert jmissing == [] and junexpected == [] and jnotes == []
    for k, v in got.encoder.state_dict().items():
        if v.is_floating_point():
            assert torch.equal(v, sd[f"module.{k}"]), k


# --------------------------------------------------------- entry points

def test_missing_file_is_a_no_op(capsys):
    _, tc = _cfgs()
    tm = ttf.build_model(tc, device="cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    assert tpre.load_pretrained(tm, tc, "/nonexistent/ckpt.pth") == \
        ([], [], [])
    out = capsys.readouterr().out
    jpre.load_pretrained({"encoder": {}}, {}, _cfgs()[0],
                         "/nonexistent/ckpt.pth")
    assert out == capsys.readouterr().out == (
        "[pretrained] checkpoint not found: /nonexistent/ckpt.pth "
        "(skipping)\n")
    _assert_same(before, tm.state_dict())


@pytest.mark.parametrize("config", ["nyu_swin_decoder_v1.yaml",
                                    "mixed_bf16_dp.yaml"])
def test_build_state_loads_the_configs_pretrained_backbone(tmp_path, capsys,
                                                           config):
    """The two shipped configs that set PRETRAINED_SWIN build their train
    state (their model cut to swin_nano at one block a stage): a missing
    file is skipped with the JAX loop's message, a present one is loaded
    into the encoder."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = tcfg.load_yaml(os.path.join(root, "configs", config))
    assert cfg.model.swin.pretrained
    small = tcfg.replace(cfg.model, backbone="swin_nano_v2",
                         swin=tcfg.replace(cfg.model.swin, **_SWIN))
    cfg = tcfg.replace(cfg, model=small)
    tloop.build_state(cfg, 2, device="cpu")
    assert "checkpoint not found" in capsys.readouterr().out
    model = ttf.build_model(small, device="cpu")
    path, sd = _swin_file(tmp_path, model.encoder.state_dict(), 13)
    cfg = tcfg.replace(cfg, model=tcfg.replace(small, swin=tcfg.replace(
        small.swin, pretrained=path)))
    state, _ = tloop.build_state(cfg, 2, device="cpu")
    assert "0 missing, 0 unexpected" in capsys.readouterr().out
    got = state.model.encoder.state_dict()
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
