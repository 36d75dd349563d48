"""PyTorch port vs JAX package: the NYU, KITTI, image-folder and mixed
readers and `build_datasets` of every dataset kind.

One data root holds a VOID tree (48 x 64), a KITTI tree at KITTI's size
(375 x 1242, KB crop to 352 x 1216) and an NYU tree whose frames are the
committed 480 x 640 JPEGs of tests/fixtures/jpeg (the JAX package reads
them with cv2, the port with its own decoder), all written by the port's
`testing` writers. Sample by sample the port's readers give the JAX
package's keys, dtypes and shapes; file names and poses bitwise, images
within 1 LSB of 8 bits (the JPEG decode, measured bitwise) and depth within
1e-3 relative (cv2's float resize, measured ~1e-7). `build_datasets` of
both packages for "void", "nyudepthv2", "kitti" and "mixed" (every root
present joins) gives the same first train and validation batch.
"""
import glob
import os
import shutil

import numpy as np
import pytest

from mmde_tpu import config as jcfg
from mmde_tpu.data import datasets as jds
from mmde_tpu.data import loader as jloader
from mmde_tpu.data import mixed as jmixed
from mmde_tpu.train import loop as jloop
from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.data import datasets as tds
from mmde_tpu_torch.data import loader as tloader
from mmde_tpu_torch.data import mixed as tmixed
from mmde_tpu_torch.data.codec import write_png
from mmde_tpu_torch.testing import (smooth_image, write_kitti_tree,
                                    write_nyu_tree, write_void_release)
from mmde_tpu_torch.train import loop as tloop

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "jpeg",
                                      "frame*_480x640.jpg")))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_void_release(root, scenes=2, frames=7, height=48, width=64,
                       bag_scenes=())
    write_kitti_tree(root, n_train=2, n_test=1)
    write_nyu_tree(root, JPEGS, frames_per_scene=2, train_scenes=2)
    return root


def _equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, (str, list)):
            assert va == vb, (what, k)
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.dtype == vb.dtype and va.shape == vb.shape, (what, k)
        msg = f"{what}: {k}"
        if k.startswith("image"):
            lsb = 1 if va.dtype == np.uint8 else 1.0 / 255 + 1e-6
            np.testing.assert_allclose(vb.astype(np.float64), va, rtol=0,
                                       atol=lsb, err_msg=msg)
        elif k.startswith("depth"):
            np.testing.assert_allclose(vb, va, rtol=1e-3, atol=1e-6,
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(vb, va, err_msg=msg)


def _pairs(make_j, make_t, what):
    j, t = make_j(), make_t()
    assert len(j) == len(t) > 0, what
    for i in range(len(j)):
        _equal(j[i], t[i], f"{what} {i}")
    return j, t


def test_nyu_readers_equal_the_jax_ones(data_root):
    fn = os.path.join(data_root, "filenames")
    for t in (True, False):
        _pairs(lambda: jds.NYUDepthV2Pairs(data_root, fn, t, (64, 96)),
               lambda: tds.NYUDepthV2Pairs(data_root, fn, t, (64, 96)),
               f"NYUDepthV2Pairs train={t}")
    for scale in (None, (320, 240)):
        _pairs(lambda: jds.NYUDepthV2(data_root, fn, True, (64, 96), scale),
               lambda: tds.NYUDepthV2(data_root, fn, True, (64, 96), scale),
               f"NYUDepthV2 scale={scale}")


def test_kitti_reader_equals_the_jax_one(data_root):
    fn = os.path.join(data_root, "filenames")
    for is_train in (True, False):
        for scale in (None, (608, 176)):
            _pairs(
                lambda: jds.KITTIEigen(data_root, fn, is_train, (64, 96),
                                       scale),
                lambda: tds.KITTIEigen(data_root, fn, is_train, (64, 96),
                                       scale),
                f"KITTIEigen train={is_train} scale={scale}")
    s = tds.KITTIEigen(data_root, fn, False, (64, 96))[0]
    assert s["image"].shape == (352, 1216, 3)       # KB crop, eval mode


def test_image_folder_reads_png_and_jpeg_as_the_jax_one(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    write_png(str(d / "a.png"), smooth_image(np.random.default_rng(0),
                                             100, 130))
    shutil.copyfile(JPEGS[0], d / "b.jpg")
    _pairs(lambda: jds.ImageFolder(str(d)), lambda: tds.ImageFolder(str(d)),
           "ImageFolder")


def test_unified_and_mixed_equal_the_jax_ones(data_root):
    fn = os.path.join(data_root, "filenames")
    crop = (320, 448)           # NYU centre-cropped, KITTI's 64 x 96 grown
    srcs = {}
    for pkg, ds, mx in (("jax", jds, jmixed), ("torch", tds, tmixed)):
        srcs[pkg] = [
            mx.UnifiedTwoFrame(ds.NYUDepthV2Pairs(data_root, fn, True,
                                                  (352, 480)),
                               "two_frame", crop, 0),
            mx.UnifiedTwoFrame(ds.KITTIEigen(data_root, fn, True, (64, 96)),
                               "single_frame", crop, 1)]
    for sj, st in zip(srcs["jax"], srcs["torch"]):
        _pairs(lambda: sj, lambda: st, f"UnifiedTwoFrame {sj.kind}")
    j = jmixed.MixedDataset(srcs["jax"], weights=[1, 2], epoch_size=7,
                            seed=4)
    t = tmixed.MixedDataset(srcs["torch"], weights=[1, 2], epoch_size=7,
                            seed=4)
    assert t.plan == j.plan
    _pairs(lambda: j, lambda: t, "MixedDataset")


_YAML = """DATASET_NAME: "{name}"
DATA_PATH: "{root}"
CROP_HEIGHT: 40
CROP_WIDTH: 56
IMAGE_INTERVAL_RANGE: [2, 3]
IMU_MAX_LEN: 32
BATCH_SIZE: 2
"""


@pytest.mark.parametrize("name", ["void", "nyudepthv2", "kitti", "mixed"])
def test_build_datasets_gives_the_jax_packages_first_batches(data_root,
                                                             tmp_path, name):
    path = tmp_path / "cfg.yaml"
    path.write_text(_YAML.format(name=name, root=data_root))
    jc, tc = jcfg.load_yaml(str(path)), tcfg.load_yaml(str(path))
    jtrain, jval = jloop.build_datasets(jc)
    ttrain, tval = tloop.build_datasets(tc)
    assert type(ttrain).__name__ == type(jtrain).__name__
    if name == "mixed":
        assert len(ttrain.sources) == 3 and ttrain.plan == jtrain.plan
    for jd, td, shuffle in ((jtrain, ttrain, True), (jval, tval, False)):
        jb = next(iter(jloader.DataLoader(jd, 2, shuffle=shuffle,
                                          num_workers=0, drop_last=False,
                                          seed=0)))
        tb = next(iter(tloader.DataLoader(td, 2, shuffle=shuffle,
                                          num_workers=2, drop_last=False,
                                          seed=0)))
        _equal(jb, tb, f"{name} first batch")
    tloop.ship_uint8((ttrain, tval))
    if name in ("void", "nyudepthv2"):          # the readers with a policy
        assert ttrain[0]["image1"].dtype == np.uint8
