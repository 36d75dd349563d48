"""PyTorch port vs JAX package: utils/viz.py (colour maps, panels, pose txt,
16-bit depth PNGs) with no cv2 in the port, the eval CLI's --save-pngs /
--save-viz and the infer CLI's --colormap, utils/profiling.py and the
kernel groups of tools/profile_step.py, the release gate's script.

The JAX writers use cv2 (imported here, by the tests only); every file the
port writes decodes, through cv2, to the JAX writer's pixels, and the pose
files are equal byte for byte.
"""
import os
import subprocess

import cv2
import numpy as np
import pytest
import torch

from mmde_tpu.utils import profiling as jprof
from mmde_tpu.utils import viz as jviz
from mmde_tpu_torch.tools import eval as teval
from mmde_tpu_torch.tools import infer, profile_step
from mmde_tpu_torch.train.step import TrainState, make_eval_step
from mmde_tpu_torch.utils import profiling as tprof
from mmde_tpu_torch.utils import viz as tviz

from test_torch_port_loop import _yaml

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _depths(seed, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 9.5, shape).astype(np.float32)
    d[rng.random(shape) < 0.1] = 0.0
    return d


@pytest.mark.parametrize("name,cv", [("rainbow", cv2.COLORMAP_RAINBOW),
                                     ("winter", cv2.COLORMAP_WINTER)])
def test_colormap_tables_are_cv2s(name, cv):
    every = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(tviz.colormap_table(name),
                                  cv2.applyColorMap(every, cv)[:, 0])


def test_colorize_depth_and_error_map_are_the_jax_functions():
    gt, pred = _depths(1), _depths(2)
    for max_val in (None, 4.0, 20.0):
        np.testing.assert_array_equal(tviz.colorize_depth(pred, max_val),
                                      jviz.colorize_depth(pred, max_val))
        np.testing.assert_array_equal(tviz.error_map(gt, pred, max_val),
                                      jviz.error_map(gt, pred, max_val))


def test_files_decode_to_the_jax_writers_pixels(tmp_path):
    rng = np.random.default_rng(3)
    im1, im2 = (rng.random((37, 53, 3)).astype(np.float32) for _ in range(2))
    gt1, gt2, p1, p2 = (_depths(s) for s in (4, 5, 6, 7))
    t, j = tmp_path / "torch", tmp_path / "jax"
    tp = tviz.save_comparison_panel(str(t), "a_b", im1, im2, gt1, gt2, p1,
                                    p2)
    jp = jviz.save_comparison_panel(str(j), "a_b", im1, im2, gt1, gt2, p1,
                                    p2)
    panel = cv2.imread(tp, cv2.IMREAD_UNCHANGED)
    assert panel.shape == (4 * 37 + 3 * 4, 2 * 53, 3)
    np.testing.assert_array_equal(panel,
                                  cv2.imread(jp, cv2.IMREAD_UNCHANGED))
    for dataset in ("kitti", "nyudepthv2"):
        tviz.save_depth_png16(str(tmp_path / "t.png"), p1 * 3, dataset)
        jviz.save_depth_png16(str(tmp_path / "j.png"), p1 * 3, dataset)
        got = cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(
            got, cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
    R = rng.standard_normal(9).astype(np.float32)
    T = rng.standard_normal(3).astype(np.float32)
    a = tviz.save_pose_txt(str(t), "pose_00000", R, R * 2, T, T / 3)
    b = jviz.save_pose_txt(str(j), "pose_00000", R, R * 2, T, T / 3)
    assert open(a, "rb").read() == open(b, "rb").read()


def _drawn_build(monkeypatch):
    """infer.build with every parameter moved by a seeded draw: the fresh
    initialisation gives a constant depth map (5 m), on which a pixel check
    passes vacuously."""
    build = infer.build

    def drawn(*a, **kw):
        model = build(*a, **kw)
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
        return model

    monkeypatch.setattr(infer, "build", drawn)


def test_eval_cli_saves_pngs_and_panels(tmp_path, monkeypatch):
    """2 held-out samples, 64 x 96, no checkpoint (drawn weights): each
    16-bit PNG is the eval step's depth x 1000 truncated, each panel four
    rows of two frames with three 4-pixel bars, a pose file per sample in
    each directory."""
    _drawn_build(monkeypatch)
    cfg = _yaml(tmp_path, h=64, w=96)
    pngs, panels = tmp_path / "pngs", tmp_path / "viz"
    res = teval.main(["--config", cfg, "--synthetic", "--max-batches", "2",
                      "--save-pngs", str(pngs), "--save-viz", str(panels),
                      "--device", "cpu"])
    assert sorted(os.listdir(pngs)) == [
        "00000_d1.png", "00000_d2.png", "00001_d1.png", "00001_d2.png",
        "pose_00000.txt", "pose_00001.txt"]
    assert len(res["written"]) == 10
    shown = sorted(f for f in os.listdir(panels) if f.endswith(".png"))
    assert len(shown) == 2
    for f in shown:
        assert cv2.imread(str(panels / f)).shape == (4 * 64 + 12, 2 * 96, 3)

    from mmde_tpu_torch.config import load_yaml
    from mmde_tpu_torch.data.loader import DataLoader
    from mmde_tpu_torch.train.loop import batch_tensors, build_datasets
    c = load_yaml(cfg)
    model = infer.build(c, device="cpu", seed=0)
    step = make_eval_step(model, decoder=c.model.decoder, lambda_rot=100.0,
                          lambda_trans=100.0, device="cpu")
    _, val = build_datasets(c, synthetic=True)
    for n, batch in zip(range(2), DataLoader(val, 1, shuffle=False)):
        preds, _ = step(TrainState(model, None), batch_tensors(batch, "cpu"))
        for k in ("d1", "d2"):
            d = preds[f"pred_{k}"][0, ..., 0].numpy()
            assert d.std() > 0.01
            got = cv2.imread(str(pngs / f"{n:05d}_{k}.png"),
                             cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(got, (d * 1000).astype(np.uint16))
        pose = open(pngs / f"pose_{n:05d}.txt").read()
        assert pose == open(panels / f"pose_{n:05d}.txt").read()
        assert pose.startswith("# ground truth [R|T]\n")


def test_infer_cli_colormap(tmp_path, monkeypatch):
    """--colormap writes `<name>_color.png` beside the depth PNG: the
    rainbow map of the predicted depth, as the JAX CLI's cv2 write."""
    _drawn_build(monkeypatch)
    cfg = _yaml(tmp_path, h=64, w=96)
    images = tmp_path / "images"
    images.mkdir()
    rgb = np.random.default_rng(0).integers(0, 256, (64, 96, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(images / "a.png"), rgb)
    out = tmp_path / "depth"
    infer.main(["--images", str(images), "--out", str(out), "--config", cfg,
                "--colormap", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["a.png", "a_color.png"]
    model = infer.build(cfg, device="cpu", seed=0)
    d = infer.predict(model, rgb[None, ..., ::-1].copy(),
                      rgb[None, ..., ::-1].copy())["pred_d1"][0, ..., 0]
    assert d.std() > 0.01
    np.testing.assert_array_equal(
        cv2.imread(str(out / "a.png"), cv2.IMREAD_UNCHANGED),
        (d * 1000).astype(np.uint16))
    np.testing.assert_array_equal(cv2.imread(str(out / "a_color.png")),
                                  jviz.colorize_depth(d))


def test_profiling_trace_annotate_and_step_metrics(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("my_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "my_span" for e in prof.key_averages())
    assert "my_span" in open(tmp_path / "trace.json").read()
    with pytest.raises(RuntimeError, match="no device time"):
        profile_step.device_time(prof)
    a, b = tprof.StepMetrics(), jprof.StepMetrics()
    for m in (a, b):
        m.durations = [0.1, 0.3, 0.2, 0.25]
    assert a.summary(4) == b.summary(4)
    assert tprof.StepMetrics().summary() == {}


def test_kernel_groups():
    g = profile_step.group
    assert g("void fwd_tc_kernel<Rows, __nv_bfloat16>(...)").startswith(
        "window_attention_fwd")
    assert g("bwd_dkv_tc_kernel<MapRows, float, float, 0>").startswith(
        "window_attention_bwd")
    assert g("bwd_dbias_tc_kernel<Rows>").startswith("window_attention_dbias")
    assert g("multi_tensor_apply_kernel").startswith("optimizer")
    assert g("sm90_xmma_fprop_implicit_gemm").startswith("convolutions")
    assert g("nvjet_tst_128x256").startswith("matrix products")
    assert g("vectorized_layer_norm_kernel") == "layer norm"
    assert g("elementwise_kernel<add>") == "elementwise, other"
    # the card's smoke run groups through this function
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "def group(" not in src and "profile_step import" in src


def test_release_check_script():
    path = os.path.join(ROOT, "mmde_tpu_torch", "tools", "release_check.sh")
    assert os.access(path, os.X_OK)
    subprocess.run(["bash", "-n", path], check=True)
    src = open(path).read()
    for step in ("pytest tests/test_torch_port_", "python3 chip_smoke.py",
                 "convergence_gate\n", "convergence_gate --variant resnet",
                 "--skip-gpu"):
        assert step in src, step


def test_source_scan_covers_this_slice():
    """The port's source walk (tests/test_torch_port_config.py: no module
    imports JAX, mmde_tpu, cv2 or PIL) reaches the pretrained loader, the
    visualisation and profiling modules and the profiling tool."""
    from test_torch_port_config import _module_names
    names = set(_module_names())
    for mod in ("ckpt.pretrained", "ckpt.torch_convert", "utils.viz",
                "utils.profiling", "tools.profile_step"):
        assert f"mmde_tpu_torch.{mod}" in names, mod


def test_profile_step_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_step.main([])
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_step.main(["--device", "cpu"])
