"""Render a realistic on-disk dataset for end-to-end loader validation.

Port of ``apps/make_realistic_dataset.py``, built on the port's own
:mod:`xslam_tpu_torch.io.synthetic` and :mod:`xslam_tpu_torch.io.png` (no
PIL, no JAX). Same arguments, same files, the same pixels and the same pose
text as the JAX package's generator:

ICL format (``--format icl``, default):
* 640x480 16-bit depth PNGs at ``depth/<i>.png``, values = mm * 5 (the ICL
  format factor the loader divides back out, ``Dataset.cpp:84``),
* ``livingRoom1n.gt.sim`` ground-truth poses as 4-line blocks (3 matrix rows
  + separator, ``Dataset.cpp:90-118``).

7-Scenes format (``--format 7scenes``):
* ``seq-01/frame-XXXXXX.depth.png`` 16-bit mm depth (factor 1) +
  ``frame-XXXXXX.pose.txt`` 4x4 camera-to-world blocks (``Dataset.cpp:
  13-39``), Kinect intrinsics (fx = fy = 585),
* ``info.txt`` multi-sequence info file: three whitespace rows — start
  frames, end frames, sequence numbers (``Dataset.cpp:41-67``).

Both use a handheld trajectory with sensor-realistic dynamics through the
cluttered room scene, plus Kinect axial noise (sigma = frac * z^2) on top of
mm quantization.

Usage: python -m xslam_tpu_torch.apps.make_realistic_dataset <out_dir> [n_frames] [noise]
           [--format icl|7scenes] [--revisit] [--blackout A B]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..geometry.intrinsics import ICL_INTRINSICS, SEVEN_SCENES_INTRINSICS
from ..io.png import write_png16
from ..io.synthetic import apply_sensor_model, cluttered_scene, handheld_trajectory, render_depth


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="dataset/ICL_realistic")
    ap.add_argument("n_frames", nargs="?", type=int, default=301)
    ap.add_argument("noise", nargs="?", type=float, default=0.0015)
    ap.add_argument("--format", choices=("icl", "7scenes"), default="icl")
    ap.add_argument("--revisit", action="store_true",
                    help="second half of the trajectory RETRACES the first half backwards, so the camera revisits "
                    "every earlier pose — the loop-closure-detection validation sequence")
    ap.add_argument("--blackout", nargs=2, type=int, metavar=("A", "B"),
                    help="zero out the depth of frames [A, B) — sensor blackout for the realistic recovery exercise")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    out_dir, n_frames, noise = args.out_dir, args.n_frames, args.noise
    icl = args.format == "icl"
    intr = ICL_INTRINSICS if icl else SEVEN_SCENES_INTRINSICS
    png_factor = 5 if icl else 1

    scene = cluttered_scene()
    if args.revisit:
        half = handheld_trajectory(n_frames // 2 + 1, seed=11)
        poses = (half + half[-2::-1])[:n_frames]
    else:
        poses = handheld_trajectory(n_frames, seed=11)
    frame_dir = os.path.join(out_dir, "depth" if icl else "seq-01")
    os.makedirs(frame_dir, exist_ok=True)

    for i, c2w in enumerate(poses):
        d_mm = render_depth(scene, c2w, intr)
        if args.blackout and args.blackout[0] <= i < args.blackout[1]:
            d_mm = np.zeros_like(d_mm)
        if noise > 0:
            rng = np.random.default_rng(np.random.SeedSequence([99, i]))
            d_mm = apply_sensor_model(d_mm, rng, noise)
        png = np.clip(d_mm.astype(np.uint32) * png_factor, 0, 65535).astype(np.uint16)
        write_png16(os.path.join(frame_dir, f"{i}.png" if icl else f"frame-{i:06d}.depth.png"), png)
        if not icl:
            np.savetxt(os.path.join(frame_dir, f"frame-{i:06d}.pose.txt"), c2w, fmt="%.9f")
        if i % 50 == 0:
            print(f"rendered {i}/{n_frames}")

    if icl:
        # .gt.sim: per frame, rows 0-2 of the 3x4 [R|t] block then a blank line
        with open(os.path.join(out_dir, "livingRoom1n.gt.sim"), "w") as f:
            for c2w in poses:
                for r in range(3):
                    f.write(" ".join(f"{x:.9f}" for x in c2w[r, :4]) + "\n")
                f.write("\n")
    else:
        # info file: start frames / end frames / sequence numbers
        with open(os.path.join(out_dir, "info.txt"), "w") as f:
            f.write(f"0\n{n_frames - 1}\n01\n")
    print(f"wrote {n_frames} {args.format} frames to {out_dir}")


if __name__ == "__main__":
    main()
