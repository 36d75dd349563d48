"""PyTorch port vs JAX package: the training and evaluation entry points.

The slice as a whole: `train.loop.train` of both packages from the same
numpy-drawn weights (each package's model init replaced), on the same
synthetic data in the same batch order, one epoch of two steps and a
validation pass; the logged train losses and the validation metrics agree.
Both train steps run `deterministic=True` (the two frameworks' random bits
differ). Then the port's CLIs end to end on the CPU: train, train again in
the same log directory with RESUME_FROM "auto", evaluate the best
checkpoint with flip and shift-window TTA, infer from it; and the entry
points that raise.
"""
import functools
import json
import os
import re
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmde_tpu import config as jcfg
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import loop as jloop
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt import io
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables
from mmde_tpu_torch.testing import randomize_tree
from mmde_tpu_torch.tools import convergence_gate, infer
from mmde_tpu_torch.tools import eval as teval
from mmde_tpu_torch.tools import train as ttrain
from mmde_tpu_torch.train import loop as tloop

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# swin_nano widths (embed 32, heads 1/2/4/8; the pose decoder's convolutions
# over 2 x 256 channels keep a checkpoint at ~175 MB), few blocks, 64 x 64
# frames; drop path 0
_YAML = """DATASET_NAME: "synthetic"
CROP_HEIGHT: {h}
CROP_WIDTH: {w}
BATCH_SIZE: 2
WORKERS: 2
EPOCH: 1
VALIDATION_FREQUENCY: 1
SAVE_FREQUENCY: 1
PRINT_FREQUENCY: 1
RESUME_FROM: "{resume}"
SAVE_MODEL: {save}
MODEL_SCALE: 32
BACKBONE: "swin_nano_v2"
DECODER: "decoder_v2"
USE_PALLAS_ATTENTION: {pallas}
SWIN:
  DEPTHS: [2, 2, 1, 1]
  WINDOW_SIZE: [4, 4, 4, 2]
  PRETRAIN_WINDOW_SIZE: [4, 4, 4, 2]
  USE_SHIFT: [True, True, False, False]
  DROP_PATH_RATE: 0.0
"""


def _yaml(tmp_path, name="cfg.yaml", h=64, w=64, resume="", save=False,
          pallas=False):
    p = tmp_path / name
    p.write_text(_YAML.format(h=h, w=w, resume=resume, save=save,
                              pallas=pallas))
    return str(p)


def _scalars(log_dir):
    out = {}
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[(r["tag"], r["step"])] = r["value"]
    return out


def test_one_epoch_and_validation_match_the_jax_loop(tmp_path, monkeypatch):
    """1 epoch x 2 steps + validation on the 8 held-out samples. Train
    losses (epoch means of the logged per-step values): 1e-4 relative, as
    the train-step parity tests; validation metrics: 1e-3 relative (1e-5
    absolute), as the eval-step tests; the loss aux of validation 1e-4."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)   # JSONL scalars
    path = _yaml(tmp_path)
    jc, tc = jcfg.load_yaml(path), tcfg.load_yaml(path)
    jm = j_build_model(jc.model)
    f = jnp.zeros((2, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, f, f, False))
    rng = np.random.default_rng(3)
    params = randomize_tree(shapes["params"], rng)
    stats = randomize_tree(shapes["batch_stats"], rng)

    def j_init(model, key, sample, train=False):
        return (jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, stats))

    def t_build(cfg, **kw):
        m = ttf_build(cfg, **kw)
        load_jax_variables(m, params, stats)
        return m

    ttf_build = tloop.build_model
    monkeypatch.setattr(jloop, "init_model", j_init)
    monkeypatch.setattr(jloop, "make_train_step", functools.partial(
        jloop.make_train_step, deterministic=True, donate=False))
    monkeypatch.setattr(tloop, "build_model", t_build)
    monkeypatch.setattr(tloop, "make_train_step", functools.partial(
        tloop.make_train_step, deterministic=True))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jloop.train(jc, log_dir=jdir, max_steps_per_epoch=2,
                       use_mesh=False)
    got = tloop.train(tc, log_dir=tdir, max_steps_per_epoch=2, device="cpu")
    assert sorted(got) == sorted(want) and want["rmse"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    js, ts = _scalars(jdir), _scalars(tdir)
    assert sorted(ts) == sorted(js)
    for key, v in js.items():
        tol = 1e-4 if key[0].split("/")[1].startswith("loss") else 1e-3
        np.testing.assert_allclose(ts[key], v, rtol=tol, atol=1e-5,
                                   err_msg=str(key))
    def logged(d):
        lines = open(os.path.join(d, "logs.txt")).read().splitlines()
        return [[float(x) for x in re.findall(r"\d+\.\d+(?:e-?\d+)?",
                                              ln.split(" lr ")[0])]
                for ln in lines if ln.startswith("Epoch [1/1] step")]
    jl, tl = logged(jdir), logged(tdir)
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def _first_run(tmp_path):
    """Two epochs of two steps through the train CLI at 64 x 96, saving
    every epoch: (config path, log directory, its ckpt/ directory)."""
    cfg = _yaml(tmp_path, h=64, w=96, resume="auto", save=True)
    log = str(tmp_path / "run")
    first = ttrain.main(_train_args(cfg, log) + ["--epochs", "2"])
    assert np.isfinite(first["rmse"])
    ckpt = os.path.join(log, "ckpt")
    assert io.latest_epoch(ckpt) == 2
    return cfg, log, ckpt


def _train_args(cfg, log):
    return ["--config", cfg, "--synthetic", "--max-steps", "2", "--log-dir",
            log, "--device", "cpu"]


@pytest.mark.parametrize("stage", ["train_resume", "evaluate", "infer"])
def test_clis_train_resume_evaluate_and_infer_on_the_cpu(tmp_path, capsys,
                                                         stage):
    """The CLIs at the tiny size with --device cpu, each stage a case that
    starts from its own first run (two epochs of two steps): a second run
    in the same log directory to three epochs (RESUME_FROM "auto": it
    starts at epoch 3 with the schedule's count at 4); eval of the best
    checkpoint with flip and shift-window TTA (64 x 96 frames, 64-px
    crops); one folder-inference request from it."""
    cfg, log, ckpt = _first_run(tmp_path)
    best = sorted(os.listdir(os.path.join(ckpt, "best")))
    assert len(best) == 1
    capsys.readouterr()
    if stage == "train_resume":
        again = ttrain.main(_train_args(cfg, log) + ["--epochs", "3"])
        out = capsys.readouterr().out
        assert "auto-resumed from epoch 2" in out
        assert "Epoch [1/3]" not in out and "Epoch [3/3] step 1" in out
        assert np.isfinite(again["rmse"])
        assert io.latest_epoch(ckpt) == 3
        saved = torch.load(os.path.join(ckpt, "epoch_3.pt"),
                           weights_only=True)
        assert saved["epoch"] == 3 and saved["step"] == 6
        assert saved["optimizer"]["param_groups"][0]["count"] == 6
        assert len(os.listdir(os.path.join(ckpt, "best"))) == 1
    elif stage == "evaluate":
        res = teval.main(["--config", cfg, "--ckpt", ckpt, "--flip-tta",
                          "--shift-window-tta", "--max-batches", "2",
                          "--device", "cpu"])
        out = capsys.readouterr().out
        assert res["restored"] == {"epoch": int(best[0][6:-3]),
                                   "kind": "best"}
        assert "shift-window over 64-px crops" in out
        assert np.isfinite(res["metrics"]["rmse"])
        table = convergence_gate.parse_metric_table(out)
        assert table["rmse"] == pytest.approx(res["metrics"]["rmse"],
                                              abs=1e-6)
    else:
        images = tmp_path / "images"
        images.mkdir()
        cv2.imwrite(str(images / "a.png"),
                    np.random.default_rng(0).integers(0, 256, (64, 96, 3),
                                                      dtype=np.uint8))
        infer.main(["--images", str(images), "--out",
                    str(tmp_path / "depth"), "--config", cfg, "--ckpt", ckpt,
                    "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"restored best checkpoint (epoch {best[0][6:-3]})" in out
        depth = cv2.imread(str(tmp_path / "depth" / "a.png"),
                           cv2.IMREAD_UNCHANGED)
        assert depth.shape == (64, 96) and depth.dtype == np.uint16


def test_what_is_not_ported_raises_and_says_where(tmp_path, capsys):
    """The dataset readers are ported (M5): a data root without the
    dataset's files raises FileNotFoundError (the mix: no root found).
    Pretrained weights are ported (M7): a PRETRAINED_SWIN that does not
    exist is skipped with the JAX loop's message, and the eval CLI's PNG /
    visualisation exports (M9) run (tests/test_torch_port_pretrained.py,
    tests/test_torch_port_viz.py). The single-frame family still raises in
    the two-frame loop and eval, as in the JAX package."""
    cfg = tcfg.load_yaml(_yaml(tmp_path))
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for name in ("void", "nyudepthv2", "kitti", "mixed"):
        c = tcfg.replace(cfg, data=tcfg.replace(cfg.data, dataset=name,
                                                data_path=empty))
        with pytest.raises(FileNotFoundError):
            tloop.build_datasets(c)
    c = tcfg.replace(cfg, data=tcfg.replace(cfg.data, dataset="typo"))
    with pytest.raises(ValueError):
        tloop.build_datasets(c)
    c = tcfg.replace(cfg, model=tcfg.replace(
        cfg.model, swin=tcfg.replace(cfg.model.swin, pretrained="w.pth")))
    capsys.readouterr()
    tloop.build_state(c, 2, device="cpu")
    assert capsys.readouterr().out == (
        "[pretrained] checkpoint not found: w.pth (skipping)\n")
    res = teval.main(["--config", _yaml(tmp_path), "--synthetic",
                      "--max-batches", "1", "--save-pngs", str(tmp_path / "p"),
                      "--device", "cpu"])
    assert len(res["written"]) == 3
    # the single-frame family trains through train.single_frame, not the
    # two-frame loop (as in the JAX package)
    c = tcfg.replace(cfg, model=tcfg.replace(cfg.model, family="glpdepth"))
    with pytest.raises(ValueError, match="single_frame"):
        tloop.train(c, synthetic=True, log_dir=str(tmp_path / "g"),
                    device="cpu")
    single = tmp_path / "single.yaml"
    single.write_text(open(_yaml(tmp_path)).read() + 'FAMILY: "glpdepth"\n')
    with pytest.raises(ValueError, match="single_frame"):
        teval.main(["--config", str(single), "--device", "cpu"])


def test_gate_holds_the_jax_tools_thresholds():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_gate", os.path.join(ROOT, "tools", "convergence_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    assert convergence_gate.VARIANTS == jgate.VARIANTS
    assert convergence_gate.VARIANTS["swin"]["d1_min"] == 0.35
    assert convergence_gate.VARIANTS["swin"]["rmse_max"] == 2.0


def test_entry_points_want_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--synthetic", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["--synthetic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.train(tcfg.Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        convergence_gate.main([])
