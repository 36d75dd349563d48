"""PyTorch port vs JAX package: synthetic data, loader order, prefetch.

The port's SyntheticTwoFrameDataset draws sample i from the same generator
in the same order as mmde_tpu's, so the arrays are equal bit for bit; the
depth-cue variant upsamples with the port's numpy bilinear resize where the
JAX package calls cv2.resize (INTER_LINEAR), within 1e-5. The DataLoader's
shuffle is the same numpy generator, so both packages give the same batch
order for one seed; device_prefetch on the CPU hands back the arrays as
tensors.
"""
import threading

import cv2
import numpy as np
import pytest
import torch

from mmde_tpu.data import loader as jloader
from mmde_tpu.data import synthetic as jsyn
from mmde_tpu_torch.data import loader as tloader
from mmde_tpu_torch.data import synthetic as tsyn

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


@pytest.mark.parametrize("kw", [{}, {"uint8_images": True},
                                {"sparse_depth": True}],
                         ids=["plain", "uint8", "sparse_depth"])
def test_synthetic_samples_equal_the_jax_packages_bitwise(kw):
    args = dict(num_samples=8, height=64, width=96, seed=3, **kw)
    j, t = jsyn.SyntheticTwoFrameDataset(**args), \
        tsyn.SyntheticTwoFrameDataset(**args)
    assert len(j) == len(t) == 8
    for i in (0, 5):
        a, b = j[i], t[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    ja = next(j.batches(3, 1))
    ta = next(t.batches(3, 1))
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_depth_cue_variant_matches_within_1e_5():
    """The convergence gate's data (96 x 128, depth cued in red): the depth
    maps and the cued channel within 1e-5 max abs; all else bitwise."""
    args = dict(num_samples=4, height=96, width=128, seed=1, depth_cue=True)
    j, t = jsyn.SyntheticTwoFrameDataset(**args), \
        tsyn.SyntheticTwoFrameDataset(**args)
    for i in range(2):
        a, b = j[i], t[i]
        for k in a:
            if k in ("depth1", "depth2", "image1", "image2"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert (b["depth1"] > 0).mean() > 0.85


@pytest.mark.parametrize("src,dst", [((13, 17), (96, 128)),
                                     ((61, 81), (480, 640)),
                                     ((9, 13), (64, 96)),
                                     ((7, 5), (100, 33)),
                                     ((5, 7), (2, 3))])
def test_resize_bilinear_is_cv2s_inter_linear(src, dst):
    """Half-pixel centres, border clamp, weights from float64 positions:
    within 1e-5 of cv2 on values in (0.5, 9) (measured <= 2 ulps)."""
    img = np.random.default_rng(0).uniform(0.5, 9.0, src).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = tsyn.resize_bilinear(img, dst[1], dst[0])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _index_order(loader_cls, seed, epochs=3):
    ds = list(range(10))
    loader = loader_cls(ds, 3, shuffle=True, num_workers=0, seed=seed)
    return [[list(map(int, b)) for b in loader._index_batches()]
            for _ in range(epochs)]


@pytest.mark.parametrize("seed", [0, 7])
def test_loader_gives_the_jax_packages_batch_order(seed):
    got = _index_order(tloader.DataLoader, seed)
    want = _index_order(jloader.DataLoader, seed)
    assert got == want
    assert got[0] != got[1]                 # reshuffled every epoch
    assert all(len(e) == 3 for e in got)    # drop_last


def test_loader_batches_equal_the_jax_loaders_with_threads():
    """Two epochs of collated batches, 2 decode threads on both sides, the
    tail kept (drop_last False)."""
    ds = tsyn.SyntheticTwoFrameDataset(num_samples=5, height=32, width=48,
                                       seed=2)
    kw = dict(shuffle=True, num_workers=2, drop_last=False, seed=4)
    t = tloader.DataLoader(ds, 2, **kw)
    j = jloader.DataLoader(ds, 2, **kw)
    assert len(t) == len(j) == 3
    for _ in range(2):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == 3 and tb[-1]["image1"].shape[0] == 1
        for a, b in zip(tb, jb):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    items = [{"a": np.ones(2, np.uint8), "name": "x"},
             {"a": np.zeros(2, np.uint8), "name": "y"}]
    out = tloader.collate(items)
    assert out["name"] == ["x", "y"] and out["a"].shape == (2, 2)


def test_device_prefetch_on_the_cpu_yields_the_same_arrays():
    """uint8 stays uint8, float32 stays float32, list fields pass through;
    a consumer that stops early ends the producer thread."""
    ds = tsyn.SyntheticTwoFrameDataset(num_samples=6, height=16, width=24,
                                       uint8_images=True)
    batches = list(tloader.DataLoader(ds, 2, shuffle=False, num_workers=0))
    for b in batches:
        b["names"] = ["a", "b"]
    got = list(tloader.device_prefetch(iter(batches), device="cpu"))
    assert len(got) == 3
    for g, b in zip(got, batches):
        assert g["names"] == ["a", "b"]
        assert g["image1"].dtype == torch.uint8
        assert g["depth1"].dtype == torch.float32
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k].numpy(), v)
    before = threading.active_count()
    endless = iter(lambda: batches[0], None)
    gen = tloader.device_prefetch(endless, device="cpu", size=1)
    next(gen)
    gen.close()
    assert threading.active_count() <= before


def test_device_prefetch_re_raises_the_producers_error():
    def broken():
        yield {"x": np.zeros(2, np.float32)}
        raise OSError("disk gone")
    gen = tloader.device_prefetch(broken(), device="cpu")
    assert next(gen)["x"].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(gen)


def test_device_prefetch_wants_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tloader.device_prefetch(iter([]), device="cuda"))
