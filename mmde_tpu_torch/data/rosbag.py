"""Native rosbag 2.0 parser for VOID raw IMU extraction (no ROS install).

Counterpart of mmde_tpu/data/rosbag.py (standard library only: bz2 and
struct); the CSV it writes is the JAX package's byte for byte. Capability
parity with the reference's shell-out
`rostopic echo -b raw.bag -p /camera/imu > raw.csv`
(dataset/void_dataset_v3.py:52-58, invoked on cache miss at :89-105):
parses record headers, chunk decompression (none/bz2), and
sensor_msgs/Imu message bodies, writing the rostopic-echo CSV layout the
loaders consume. Used by data.void_v3._SceneCache for automatic
bag->csv conversion and by mmde_tpu_torch.tools.rosbag_imu_to_csv as a
CLI.
"""
from __future__ import annotations

import bz2
import os
import struct

HEADER_COLS = ("time,field.header.seq,field.header.stamp,"
               "field.header.frame_id,field.orientation.x,"
               "field.orientation.y,field.orientation.z,field.orientation.w,"
               "field.angular_velocity.x,field.angular_velocity.y,"
               "field.angular_velocity.z,field.linear_acceleration.x,"
               "field.linear_acceleration.y,field.linear_acceleration.z")


def read_records(buf, offset, end):
    while offset < end:
        (hlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        header = {}
        hend = offset + hlen
        while offset < hend:
            (flen,) = struct.unpack_from("<I", buf, offset)
            offset += 4
            field = buf[offset:offset + flen]
            offset += flen
            k, _, v = field.partition(b"=")
            header[k.decode()] = v
        (dlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        data = buf[offset:offset + dlen]
        offset += dlen
        yield header, data


def parse_imu(data):
    """sensor_msgs/Imu body -> (seq, stamp_ns, orientation4, gyro3, acc3)."""
    off = 0
    seq, secs, nsecs = struct.unpack_from("<III", data, off)
    off += 12
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4 + slen                       # frame_id string
    ori = struct.unpack_from("<4d", data, off)
    off += 32 + 72                        # orientation + covariance
    gyro = struct.unpack_from("<3d", data, off)
    off += 24 + 72
    acc = struct.unpack_from("<3d", data, off)
    stamp = secs * 10**9 + nsecs
    return seq, stamp, ori, gyro, acc


def convert_bag_to_csv(bag_path: str, out_path: str | None = None,
                       topic: str = "/camera/imu") -> int:
    """Extract `topic` from a rosbag 2.0 file into rostopic-echo CSV.
    Returns the number of IMU rows written."""
    out_path = out_path or os.path.splitext(bag_path)[0] + ".csv"

    with open(bag_path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"{bag_path}: not a rosbag 2.0 file")
        buf = f.read()

    imu_conns = set()
    rows = []
    for header, data in read_records(buf, 0, len(buf)):
        op = header.get("op", b"")
        if op == b"\x07":                 # connection
            if header.get("topic", b"").decode() == topic:
                (conn,) = struct.unpack("<I", header["conn"])
                imu_conns.add(conn)
        elif op == b"\x05":               # chunk
            comp = header.get("compression", b"none")
            payload = bz2.decompress(data) if comp == b"bz2" else data
            for h2, d2 in read_records(payload, 0, len(payload)):
                if h2.get("op") == b"\x07":
                    if h2.get("topic", b"").decode() == topic:
                        (conn,) = struct.unpack("<I", h2["conn"])
                        imu_conns.add(conn)
                elif h2.get("op") == b"\x02":   # message data
                    (conn,) = struct.unpack("<I", h2["conn"])
                    if conn in imu_conns:
                        (t,) = struct.unpack("<Q", h2["time"])
                        rows.append((t, d2))

    with open(out_path, "w") as f:
        f.write(HEADER_COLS + "\n")
        for t, d in rows:
            seq, stamp, ori, gyro, acc = parse_imu(d)
            f.write(f"{t},{seq},{stamp},camera_imu,"
                    f"{ori[0]},{ori[1]},{ori[2]},{ori[3]},"
                    f"{gyro[0]},{gyro[1]},{gyro[2]},"
                    f"{acc[0]},{acc[1]},{acc[2]}\n")
    return len(rows)
