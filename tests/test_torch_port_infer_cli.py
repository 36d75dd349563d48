"""PyTorch port vs JAX package: the folder inference CLI's input pipeline.

`python -m mmde_tpu_torch.tools.infer --images DIR --out DIR` reads each
image as the JAX package's `mmde_tpu.data.datasets.ImageFolder` does: RGB,
each side cut down to a multiple of 32 by `cv2.resize`, and an unreadable
file raises FileNotFoundError. Here a 100 x 130 PNG goes through the CLI on
the CPU with a small model; a spy on `predict` sees the frame.
"""
import os

import cv2
import numpy as np
import pytest

from mmde_tpu.data.datasets import ImageFolder
from mmde_tpu_torch.tools import infer

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

_NANO = ("BACKBONE: swin_nano_v2\nDECODER: decoder_v2\nMODEL_SCALE: 32\n"
         "SWIN:\n  DEPTHS: [2, 2, 2, 2]\n  WINDOW_SIZE: [6, 6, 6, 3]\n"
         "  PRETRAIN_WINDOW_SIZE: [4, 4, 4, 2]\n")


def _folder(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (100, 130, 3), dtype=np.uint8)
    assert cv2.imwrite(str(images / "frame.png"), bgr)
    cfg = tmp_path / "nano.yaml"
    cfg.write_text(_NANO)
    return images, cfg


def test_cli_writes_the_jax_clis_shape_from_the_same_pixels(tmp_path,
                                                            monkeypatch):
    """100 x 130 in, 96 x 128 uint16 depth PNG out; the frames handed to
    `predict` are ImageFolder's pixels (uint8 here, /255 there)."""
    images, cfg = _folder(tmp_path)
    seen = []
    real = infer.predict

    def spy(model, frame1, frame2, **kw):
        seen.append((frame1.copy(), frame2.copy()))
        return real(model, frame1, frame2, **kw)

    monkeypatch.setattr(infer, "predict", spy)
    out = tmp_path / "out"
    infer.main(["--images", str(images), "--out", str(out), "--config",
                str(cfg), "--device", "cpu"])
    depth = cv2.imread(str(out / "frame.png"), cv2.IMREAD_UNCHANGED)
    assert depth is not None and depth.shape == (96, 128)
    assert depth.dtype == np.uint16
    want = ImageFolder(str(images))[0]["image"]
    assert len(seen) == 1
    f1, f2 = seen[0]
    assert f1.shape == (1, 96, 128, 3) and f1.dtype == np.uint8
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(f1[0].astype(np.float32) / 255.0, want)


def test_cli_raises_on_an_unreadable_image(tmp_path):
    """A file with an image's name that cv2 cannot read raises
    FileNotFoundError naming it, as ImageFolder's reader does."""
    images, cfg = _folder(tmp_path)
    (images / "broken.jpg").write_bytes(b"not an image")
    with pytest.raises(FileNotFoundError, match="broken.jpg"):
        infer.main(["--images", str(images), "--out", str(tmp_path / "o"),
                    "--config", str(cfg), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="broken.jpg"):
        ImageFolder(str(images))[0]
