"""PyTorch port vs JAX package: the VOID readers, the IMU bag converter,
the list tool, and one training step on a VOID tree.

Two identical small VOID trees are written from one seed by the port's
`testing.write_void_release` (one scene's IMU in raw.bag only): the JAX
package reads one, the port the other (either reader converts raw.bag to
raw.csv in its tree on first use). VoidV3 samples (train and test, with
sparse depth), the v2 pickles of `generate_pickles` read by each package's
VoidPickle whichever package wrote them, and VoidPickleV1 samples agree
key by key: file names, poses and IMU bitwise, images within 1 LSB and
depth within 1e-3 relative (measured: bitwise). The bag's CSV
is the JAX converter's byte for byte, through the library and the CLI.
Then `train.loop.train` of both packages from the same numpy-drawn weights
on a 96 x 128 VOID tree, one step of 2 pairs with `deterministic=True`:
the logged losses agree within the loop tests' 1e-4.
"""
import functools
import os
import pickle
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmde_tpu import config as jcfg
from mmde_tpu.data import rosbag as jrosbag
from mmde_tpu.data import void_pickle as jvp
from mmde_tpu.data import void_v3 as jv3
from mmde_tpu.models import build_model as j_build_model
from mmde_tpu.train import loop as jloop
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt.from_jax import load_jax_variables
from mmde_tpu_torch.data import rosbag as trosbag
from mmde_tpu_torch.data import void_pickle as tvp
from mmde_tpu_torch.data import void_v3 as tv3
from mmde_tpu_torch.testing import randomize_tree, write_void_release
from mmde_tpu_torch.tools import make_void_lists, rosbag_imu_to_csv
from mmde_tpu_torch.train import loop as tloop

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(scenes=2, frames=9, height=48, width=64, bag_scenes=(1,))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("void")
    return {k: write_void_release(str(base / k), **KW)
            for k in ("jax", "torch")}


def _equal(a: dict, b: dict, what: str):
    """Same keys, dtypes and shapes; poses, IMU and metadata bitwise;
    images within 1 LSB of 8 bits (1/255 for float frames) and depth within
    1e-3 relative, the undistortion's limits (measured: bitwise)."""
    assert sorted(a) == sorted(b), what
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, str):
            assert va == vb, (what, k)
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.dtype == vb.dtype and va.shape == vb.shape, (what, k)
        msg = f"{what}: {k}"
        if k.startswith("image"):
            lsb = 1 if va.dtype == np.uint8 else 1.0 / 255 + 1e-6
            np.testing.assert_allclose(vb.astype(np.float64), va, rtol=0,
                                       atol=lsb, err_msg=msg)
        elif "depth" in k:
            np.testing.assert_allclose(vb, va, rtol=1e-3, atol=0,
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(vb, va, err_msg=msg)


def _voids(trees, is_train, **kw):
    out = []
    for pkg, mod in (("jax", jv3), ("torch", tv3)):
        meta = trees[pkg]["meta"]
        lst = os.path.join(meta, ("train" if is_train else "test")
                           + "_image.txt")
        out.append(mod.VoidV3(trees[pkg]["root"], lst,
                              os.path.join(meta, "calibration.json"),
                              is_train=is_train, crop_size=(40, 56),
                              image_interval_range=(2, 4), imu_max_len=48,
                              **kw))
    return out


@pytest.mark.parametrize("is_train,sparse", [(True, True), (False, False)])
def test_void_v3_samples_equal_the_jax_readers(trees, is_train, sparse):
    j, t = _voids(trees, is_train, load_sparse_depth=sparse)
    assert len(j) == len(t) == KW["frames"] - 4
    for i in range(len(j)):
        _equal(j[i], t[i], f"sample {i}")
    s = t[0]
    assert s["imu_len"] > 0 and ("sparse_depth1" in s) == sparse
    info = trees["torch"]
    scene = info["scenes"][0 if is_train else 1]
    stamps = info["stamps"][scene]
    assert float(s["timestamp1"]) == float(f"{stamps[0]:.4f}")


def test_bag_conversion_and_its_csv_are_the_jax_packages(trees, tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """The test scene has raw.bag only: each reader converted it (above, or
    here on first use); the CSVs are equal bytes; the CLIs write the same
    bytes; a scene without IMU warns."""
    for pkg, mod in (("jax", jv3), ("torch", tv3)):
        info = trees[pkg]
        scene = info["scenes"][1]
        csv = os.path.join(info["root"], "void_raw", scene, "raw.csv")
        if not os.path.isfile(csv):
            mod._SceneCache(
                os.path.join(info["root"], "void_release/void_1500/data"),
                os.path.join(info["root"], "void_raw"), scene,
                mod.load_calibration(os.path.join(info["meta"],
                                                  "calibration.json")))
    csvs = [open(os.path.join(trees[p]["root"], "void_raw",
                              trees[p]["scenes"][1], "raw.csv"), "rb").read()
            for p in ("jax", "torch")]
    assert csvs[0] == csvs[1] and csvs[0].count(b"\n") > 100
    bag = os.path.join(trees["torch"]["root"], "void_raw",
                       trees["torch"]["scenes"][1], "raw.bag")
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert jrosbag.convert_bag_to_csv(bag, a) == \
        trosbag.convert_bag_to_csv(bag, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    c = str(tmp_path / "c.csv")
    assert rosbag_imu_to_csv.main([bag, c]) == 0
    monkeypatch.setattr(sys, "argv", ["x", bag, str(tmp_path / "d.csv")])
    runpy.run_path(os.path.join(ROOT, "tools", "rosbag_imu_to_csv.py"),
                   run_name="__main__")
    assert open(c, "rb").read() == open(tmp_path / "d.csv", "rb").read() \
        == csvs[0]
    capsys.readouterr()
    info = trees["torch"]
    release = os.path.join(info["root"], "void_release/void_1500/data")
    calib = tv3.load_calibration(os.path.join(info["meta"],
                                              "calibration.json"))
    with pytest.warns(UserWarning, match="no IMU source"):
        sc = tv3._SceneCache(release, str(tmp_path / "no_raw"),
                             info["scenes"][0], calib)
    assert sc.imu is None


def test_make_void_lists_writes_the_jax_tools_lists(trees, tmp_path,
                                                    monkeypatch, capsys):
    root = trees["torch"]["root"]
    assert make_void_lists.main([root, "--out", str(tmp_path / "t"),
                                 "--test-scenes", "1"]) == 0
    monkeypatch.setattr(sys, "argv", ["x", root, "--out",
                                      str(tmp_path / "j"), "--test-scenes",
                                      "1"])
    runpy.run_path(os.path.join(ROOT, "tools", "make_void_lists.py"),
                   run_name="__main__")
    for name in ("train_image.txt", "test_image.txt"):
        got = open(tmp_path / "t" / name).read()
        assert got == open(tmp_path / "j" / name).read()
        assert got == open(os.path.join(trees["torch"]["meta"], name)).read()
    capsys.readouterr()


def test_pickles_of_either_package_load_in_the_other(trees, tmp_path):
    """generate_pickles of both packages (equal pickles: numpy arrays and
    floats only), then VoidPickle of each on each, eval and train mode."""
    written = {}
    for pkg, mod in (("jax", jvp), ("torch", tvp)):
        info = trees[pkg]
        written[pkg] = mod.generate_pickles(
            info["root"], os.path.join(info["meta"], "calibration.json"),
            str(tmp_path / pkg), offset_range=(2, 3), seed=5)
    assert len(written["jax"]) == len(written["torch"]) > 4
    for a, b in zip(written["jax"], written["torch"]):
        pa, pb = (pickle.load(open(p, "rb")) for p in (a, b))
        _equal(pa, pb, os.path.basename(a))
        for v in pb.values():
            assert isinstance(v, (np.ndarray, float)), type(v)
    lists = {}
    for pkg in ("jax", "torch"):
        lists[pkg] = str(tmp_path / f"{pkg}.txt")
        jvp.write_split_lists(str(tmp_path / pkg), lists[pkg],
                              str(tmp_path / f"{pkg}_test.txt"),
                              test_fraction=0.0)
    for src in ("jax", "torch"):
        for is_train in (False, True):
            kw = dict(is_train=is_train, crop_size=(32, 48), imu_max_len=32)
            j = jvp.VoidPickle(lists[src], **kw)
            t = tvp.VoidPickle(lists[src], **kw)
            for i in range(len(j)):
                _equal(j[i], t[i], f"{src} pickle {i}")


def test_void_pickle_v1_matches_with_cv2s_undistortion(trees, tmp_path):
    """v1 pickles (distorted frames): IMU noise from the per-sample
    generator and cv2.undistort of the frames, bitwise."""
    rng = np.random.default_rng(5)
    files = []
    for i in range(3):
        d = {"raw_image1": rng.integers(0, 256, (48, 64, 3), np.uint8),
             "raw_image2": rng.integers(0, 256, (48, 64, 3), np.uint8),
             "depth_image1": rng.uniform(300, 5000, (48, 64)),
             "depth_image2": rng.uniform(300, 5000, (48, 64)),
             "rel_pose": rng.standard_normal(6), "dt": 0.1 * i,
             "imu_data": rng.standard_normal((20, 7)),
             "Rodrigues": rng.standard_normal(3)}
        path = str(tmp_path / f"{i}.pickle")
        with open(path, "wb") as f:
            pickle.dump([d], f)
        files.append(path)
    lst = tmp_path / "v1.txt"
    lst.write_text("\n".join(files))
    calib = os.path.join(trees["torch"]["meta"], "calibration.json")
    for transform in (True, False):
        j = jvp.VoidPickleV1(str(lst), calib, transform=transform)
        t = tvp.VoidPickleV1(str(lst), calib, transform=transform)
        for i in range(3):
            _equal(j[i], t[i], f"v1 {i} transform={transform}")


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
MODEL_SCALE: 32
BACKBONE: "swin_nano_v2"
DECODER: "decoder_v2"
SWIN:
  DEPTHS: [1, 1, 1, 1]
  WINDOW_SIZE: [4, 4, 4, 2]
  PRETRAIN_WINDOW_SIZE: [4, 4, 4, 2]
  USE_SHIFT: [True, True, False, False]
  DROP_PATH_RATE: 0.0
"""


def test_one_void_training_step_matches_the_jax_loop(tmp_path, monkeypatch):
    """One step of 2 VOID pairs (96 x 128, the tree's own size: the centre
    crop keeps it whole) from the same weights: the logged total, depth,
    rotation and translation losses within 1e-4."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    tree = write_void_release(str(tmp_path / "void"), scenes=2, frames=6,
                              height=96, width=128, bag_scenes=())
    path = tmp_path / "void.yaml"
    path.write_text(_YAML.format(root=tree["root"]))
    jc, tc = jcfg.load_yaml(str(path)), tcfg.load_yaml(str(path))
    jm = j_build_model(jc.model)
    f = jnp.zeros((2, 96, 128, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, f, f, False))
    rng = np.random.default_rng(3)
    params = randomize_tree(shapes["params"], rng)
    stats = randomize_tree(shapes["batch_stats"], rng)

    def j_init(model, key, sample, train=False):
        return (jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, stats))

    def t_build(cfg, **kw):
        m = build(cfg, **kw)
        load_jax_variables(m, params, stats)
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

    def logged(d):
        lines = open(os.path.join(d, "logs.txt")).read().splitlines()
        return [[float(x) for x in re.findall(r"\d+\.\d+(?:e-?\d+)?",
                                              ln.split(" lr ")[0])]
                for ln in lines if ln.startswith("Epoch [1/1] step")]

    jl, tl = logged(jdir), logged(tdir)
    assert len(tl) == len(jl) == 1 and len(jl[0]) == 4
    assert jl[0][0] > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
