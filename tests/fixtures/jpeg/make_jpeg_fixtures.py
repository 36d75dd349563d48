#!/usr/bin/env python
"""Remake the JPEG fixtures of this folder (needs cv2; run from anywhere):

    python tests/fixtures/jpeg/make_jpeg_fixtures.py

Small files in each sampling mode cv2's encoder offers up to 2 x 2 (4:4:4,
4:2:2, 4:2:0, 4:4:0) and grey, at qualities 75 and 95, at odd sizes, one
with restart markers every 2 MCUs, each beside cv2's decode
(`<name>.npy`, RGB, or grey for grey files); and two 480 x 640 frames
(4:2:0, quality 90) for the NYU tree and the infer CLI of the card smoke
run, which has no JPEG encoder, with cv2's decode of each at every 13th row
and column (`frames_cv2_stride13.npz`, keys `frame0` / `frame1`: 13 is
prime to the 8- and 16-pixel blocks, so the samples cover every position
in a block). The images are smooth random fields plus noise, drawn from a
fixed seed, so the files come out the same on every run of the same cv2.
"""
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
         "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
         "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def smooth_bgr(rng, h, w):
    coarse = rng.uniform(20, 235, (h // 16 + 2, w // 16 + 2, 3))
    img = cv2.resize(coarse.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_LINEAR)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write(name, bgr, params):
    ok, buf = cv2.imencode(".jpg", bgr, params)
    assert ok
    path = os.path.join(HERE, name + ".jpg")
    buf.tofile(path)
    return path


def main():
    rng = np.random.default_rng(2024)
    small = [("444_q95_37x53", "444", 95, (37, 53), 0),
             ("422_q75_37x53", "422", 75, (37, 53), 0),
             ("420_q75_45x61", "420", 75, (45, 61), 0),
             ("420_q95_rst_45x61", "420", 95, (45, 61), 2),
             ("440_q75_29x35", "440", 75, (29, 35), 0)]
    for name, mode, q, (h, w), rst in small:
        bgr = smooth_bgr(rng, h, w)
        path = write(name, bgr, [cv2.IMWRITE_JPEG_QUALITY, q,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                 MODES[mode],
                                 cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.save(os.path.join(HERE, name + ".npy"), rgb)
    grey = cv2.cvtColor(smooth_bgr(rng, 33, 47), cv2.COLOR_BGR2GRAY)
    path = write("grey_q75_33x47", grey, [cv2.IMWRITE_JPEG_QUALITY, 75])
    np.save(os.path.join(HERE, "grey_q75_33x47.npy"),
            cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    frames = {}
    for i in range(2):
        path = write(f"frame{i}_420_q90_480x640", smooth_bgr(rng, 480, 640),
                     [cv2.IMWRITE_JPEG_QUALITY, 90])
        rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        frames[f"frame{i}"] = rgb[::13, ::13]
    np.savez(os.path.join(HERE, "frames_cv2_stride13.npz"), **frames)


if __name__ == "__main__":
    main()
