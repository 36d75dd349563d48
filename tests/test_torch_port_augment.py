"""PyTorch port vs JAX package: the augmentation policies (data.augment).

`AugmentPolicy` in "v1", "v2" and "eval", float32 and uint8 output, on the
same uint8 frames and float depth with generators of the same seed: the
outputs are bitwise the JAX package's (its HSV jitter runs through cv2 here,
the port's through imgproc's bitwise copies of cv2's conversions) and both
generators end in the same state (the same number of draws).
"""
import dataclasses

import numpy as np
import pytest

from mmde_tpu.data import augment as jaug
from mmde_tpu_torch.data import augment as taug

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("mode", ["v1", "v2", "eval"])
def test_policy_is_the_jax_packages_bitwise(mode, output_dtype):
    rng = np.random.default_rng(0)
    jpol = jaug.AugmentPolicy(40, 56, mode=mode, output_dtype=output_dtype)
    tpol = taug.AugmentPolicy(**dataclasses.asdict(jpol))
    hits = 0
    for idx in range(24):
        image = rng.integers(0, 256, (48, 64, 3), np.uint8)
        depth = rng.uniform(0.0, 300.0, (48, 64)).astype(np.float32)
        jr = np.random.default_rng((5, idx))
        tr = np.random.default_rng((5, idx))
        ji, jd = jpol(image, depth, jr, idx)
        ti, td = tpol(image, depth, tr, idx)
        assert ti.dtype == ji.dtype and td.dtype == jd.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        assert jr.bit_generator.state == tr.bit_generator.state
        hits += not np.array_equal(ti[..., 0] if ti.dtype == np.uint8 else
                                   np.round(ti[..., 0] * 255),
                                   image[:ti.shape[0], :ti.shape[1], 0])
    if mode != "eval":
        assert hits > 12        # the photometric draws changed most frames


def test_hsv_jitter_always_runs_and_matches():
    """Over 64 seeds the jitter fires about half the time (p = 0.5), with
    the JAX package's draws and its cv2 pixels."""
    img = np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8)
    fired = 0
    for seed in range(64):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        a, b = jaug.hsv_jitter(img, jr), taug.hsv_jitter(img, tr)
        np.testing.assert_array_equal(b, a)
        assert jr.bit_generator.state == tr.bit_generator.state
        fired += not np.array_equal(b, img)
    assert 16 < fired < 48
    with pytest.raises(ValueError, match="uint8"):
        taug.hsv_jitter(img.astype(np.float32), np.random.default_rng(2),
                        p=1.0)
