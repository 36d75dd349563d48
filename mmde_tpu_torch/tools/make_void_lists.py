#!/usr/bin/env python
"""Generate VOID train/test image lists from the release layout.

    python -m mmde_tpu_torch.tools.make_void_lists DATA_PATH \\
        [--out DATA_PATH/meta] [--test-scenes 8]

Counterpart of tools/make_void_lists.py: scans
DATA_PATH/void_release/void_1500/data/<scene>/image/ and holds the last N
scenes (sorted by name) out for the test list, VOID's scene-level split
convention, for when the release's own 48248 / 800-line lists are not at
hand. Host-only: it touches no device, so it takes no --device.
"""
from __future__ import annotations

import argparse
import os


def write_lists(data_path: str, out: str, test_scenes: int = 8):
    """Write out/{train,test}_image.txt; returns (train lines, test
    lines)."""
    release = os.path.join(data_path, "void_release/void_1500/data")
    os.makedirs(out, exist_ok=True)
    scenes = sorted(os.listdir(release))
    test_set = set(scenes[-test_scenes:]) if test_scenes else set()
    train_lines, test_lines = [], []
    for scene in scenes:
        img_dir = os.path.join(release, scene, "image")
        if not os.path.isdir(img_dir):
            continue
        for name in sorted(os.listdir(img_dir)):
            line = f"void_release/void_1500/data/{scene}/image/{name}"
            (test_lines if scene in test_set else train_lines).append(line)
    with open(os.path.join(out, "train_image.txt"), "w") as f:
        f.write("\n".join(train_lines))
    with open(os.path.join(out, "test_image.txt"), "w") as f:
        f.write("\n".join(test_lines))
    return train_lines, test_lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("data_path")
    p.add_argument("--out", default=None)
    p.add_argument("--test-scenes", type=int, default=8)
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.data_path, "meta")
    train, test = write_lists(args.data_path, out, args.test_scenes)
    print(f"wrote {len(train)} train / {len(test)} test lines to {out}")
    calib = os.path.join(out, "calibration.json")
    if not os.path.exists(calib):
        print(f"NOTE: place the camera/IMU calibration at {calib} "
              "(the VOID release's calibration.json)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
