#!/usr/bin/env python
"""Extract the /camera/imu topic of a VOID raw.bag into the rostopic-echo
CSV layout the VOID reader consumes.

    python -m mmde_tpu_torch.tools.rosbag_imu_to_csv path/to/raw.bag [out.csv]

Counterpart of tools/rosbag_imu_to_csv.py (the same CSV, byte for byte,
from data.rosbag; no ROS install). Host-only: it touches no device, so it
takes no --device.
"""
from __future__ import annotations

import argparse
import os

from mmde_tpu_torch.data.rosbag import convert_bag_to_csv


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("bag", help="rosbag 2.0 file")
    p.add_argument("out", nargs="?", default=None,
                   help="CSV to write (default: the bag's name, .csv)")
    args = p.parse_args(argv)
    out = args.out or os.path.splitext(args.bag)[0] + ".csv"
    n = convert_bag_to_csv(args.bag, out)
    print(f"wrote {n} IMU rows to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
