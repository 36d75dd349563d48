"""PyTorch port vs JAX package: the completion model
(void_downscale16_completion.yaml's family, glpdepth_scale16 with
SPARSE_DEPTH_INPUT) on batches without sparse depth, which is what VOID
gives: both loops read VOID without its sparse maps. The JAX package
initialises the model from such a batch, so its stem takes 3 channels and
the forward skips the fusion; the port builds it the same way
(`build_model(..., sparse_depth=False)`, what `loop.build_state` is given
from the training set's first sample).

swin_nano at one block a stage, as tests/test_torch_port_glpdepth.py;
depth atol 1e-3, pose 1e-4, losses 1e-4 relative, as there and in
tests/test_torch_port_void.py.
"""
import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import loop as jloop
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables
from mmde_tpu_torch.models import two_frame as ttf
from mmde_tpu_torch.testing import randomize_tree, write_void_release
from mmde_tpu_torch.train import loop as tloop

from test_torch_port_glpdepth import _apply, _cfgs, _depth_close, _load

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


def test_rgb_build_matches_the_jax_model_initialised_without_sparse_depth():
    jc, tc = _cfgs(family="glpdepth_scale16", model_scale=16,
                   sparse_depth_input=True)
    rng = np.random.default_rng(21)
    f1, f2 = (rng.random((2, 64, 64, 3)).astype(np.float32)
              for _ in range(2))
    jm = j_build_model(jc)
    tm = ttf.build_model(tc, device="cpu", sparse_depth=False).eval()
    assert tm.net.encoder.patch_embed.proj.in_channels == 3
    variables = _load(jm, tm, (jnp.asarray(f1), jnp.asarray(f2), False), 22)
    net = variables["params"].get("net", variables["params"])
    assert net["encoder"]["patch_embed"]["proj"]["kernel"].shape[2] == 3
    want = _apply(jm, variables, jnp.asarray(f1), jnp.asarray(f2), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(f1), torch.from_numpy(f2))
    for k in ("pred_d1", "pred_d2"):
        _depth_close(got[k], want[k], k)
    np.testing.assert_allclose(got["out_p"].numpy(), np.asarray(want["out_p"]),
                               rtol=1e-4, atol=1e-4)
    sparse = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="without sparse depth"):
        tm(torch.from_numpy(f1), torch.from_numpy(f2), sparse1=sparse)
    # built for sparse depth (the default), the model still wants it
    fused = ttf.build_model(tc, device="cpu")
    assert fused.net.encoder.patch_embed.proj.in_channels == 5
    with pytest.raises(ValueError, match="sparse1"):
        fused(torch.from_numpy(f1), torch.from_numpy(f2))


_YAML = """DATASET_NAME: "void"
DATA_PATH: "{root}"
CROP_HEIGHT: 96
CROP_WIDTH: 128
IMAGE_INTERVAL_RANGE: [2, 2]
IMU_MAX_LEN: 32
BATCH_SIZE: 2
WORKERS: 2
EPOCH: 1
VALIDATION_FREQUENCY: 2
PRINT_FREQUENCY: 1
SAVE_MODEL: False
MAX_DEPTH: 10.0
MODEL_SCALE: 16
FAMILY: "glpdepth_scale16"
SPARSE_DEPTH_INPUT: True
BACKBONE: "swin_nano_v2"
DECODER: "decoder_v1"
SWIN:
  DEPTHS: [1, 1, 1, 1]
  WINDOW_SIZE: [4, 4, 4, 2]
  PRETRAIN_WINDOW_SIZE: [4, 4, 4, 2]
  USE_SHIFT: [True, True, False, False]
  DROP_PATH_RATE: 0.0
"""


def test_completion_config_trains_on_void_as_the_jax_loop(tmp_path,
                                                          monkeypatch):
    """One step of 2 VOID pairs (no sparse maps in the batches) through
    both loops from the same weights: the port builds the RGB model (3
    input channels, the JAX loop's init from its sample batch) and logs
    the JAX loop's losses within 1e-4."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    tree = write_void_release(str(tmp_path / "void"), scenes=2, frames=6,
                              height=96, width=128, bag_scenes=())
    path = tmp_path / "completion.yaml"
    path.write_text(_YAML.format(root=tree["root"]))
    jc, tc = jcfg.load_yaml(str(path)), tcfg.load_yaml(str(path))
    assert tc.model.sparse_depth_input
    train_ds, _ = tloop.build_datasets(tc)
    assert not tloop.carries_sparse_depth(train_ds)
    jm = j_build_model(jc.model)
    f = jnp.zeros((2, 96, 128, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, f, f, False))
    rng = np.random.default_rng(3)
    params = randomize_tree(shapes["params"], rng)
    stats = randomize_tree(shapes["batch_stats"], rng)
    built = []

    def j_init(model, key, sample, train=False):
        assert "sparse_depth1" not in sample
        return (jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, stats))

    def t_build(cfg, **kw):
        m = build(cfg, **kw)
        load_jax_variables(m, params, stats)
        built.append(m)
        return m

    build = tloop.build_model
    monkeypatch.setattr(jloop, "init_model", j_init)
    monkeypatch.setattr(jloop, "make_train_step", functools.partial(
        jloop.make_train_step, deterministic=True, donate=False))
    monkeypatch.setattr(tloop, "build_model", t_build)
    monkeypatch.setattr(tloop, "make_train_step", functools.partial(
        tloop.make_train_step, deterministic=True))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jloop.train(jc, log_dir=jdir, max_steps_per_epoch=1, use_mesh=False)
    tloop.train(tc, log_dir=tdir, max_steps_per_epoch=1, device="cpu")
    assert built[0].net.encoder.patch_embed.proj.in_channels == 3

    def logged(d):
        lines = open(os.path.join(d, "logs.txt")).read().splitlines()
        return [[float(x) for x in re.findall(r"\d+\.\d+(?:e-?\d+)?",
                                              ln.split(" lr ")[0])]
                for ln in lines if ln.startswith("Epoch [1/1] step")]

    jl, tl = logged(jdir), logged(tdir)
    assert len(tl) == len(jl) == 1 and len(jl[0]) == 4
    assert jl[0][0] > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
