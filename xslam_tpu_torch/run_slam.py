"""End-to-end SLAM driver of the PyTorch port on the synthetic dataset.

Counterpart of ``apps/run_slam.py`` for the dense reference configuration:
YAML config in, per-frame estimated/ground-truth pose files
(``<output_dir>/slam/frame-XXXXXX.pose.txt``, ``<output_dir>/gt/...``), the
mean frame time and the ATE RMSE printed at the end.

Usage:
    python -m xslam_tpu_torch.run_slam configs/synthetic.yaml [--frames N] [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .io.config import load_config
from .io.synthetic import SyntheticDataset
from .models.kinfu import XSlamEngine
from .utils.evaluation import ate_rmse, normalize_to_first


def save_pose(output_dir: str, frame_id: int, pose: np.ndarray):
    os.makedirs(output_dir, exist_ok=True)
    np.savetxt(os.path.join(output_dir, f"frame-{frame_id:06d}.pose.txt"), pose, fmt="%.7f")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--frames", type=int, default=None, help="override end_frame")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    config = load_config(args.config)
    if args.frames is not None:
        config.end_frame = args.frames
    if config.dataset_format != "synthetic":
        raise NotImplementedError(f"dataset_format {config.dataset_format!r} is not ported yet")
    dataset = SyntheticDataset(n_frames=config.end_frame - config.start_frame + 1, intr=config.intrinsics)
    step = max(1, config.frame_step)
    frame_ids = list(range(config.start_frame, min(len(dataset) + config.start_frame, config.end_frame), step))
    print(f"frame num: {len(frame_ids)}")

    print("initialize engine......")
    engine = XSlamEngine(config, device=args.device)
    state = engine.init_state()
    out_dir = config.output_dir
    total_ms, timed = 0.0, 0
    print("start slam!")
    for i, fid in enumerate(frame_ids):
        depth = dataset.get_depth(fid)
        gt_pose = dataset.get_pose(fid) if config.use_gt_pose else None
        t0 = time.perf_counter()
        state, res = engine.process_frame(state, depth, gt_pose=gt_pose)
        engine.log_pose(res)  # reads the pose back: the frame's work is done
        dt = (time.perf_counter() - t0) * 1e3
        if i > 0:  # the first frame pays one-time set-up
            total_ms += dt
            timed += 1
        if config.log_slam_pose:
            save_pose(os.path.join(out_dir, "slam"), fid, engine.pose_log[-1])
        if config.log_gt_pose:
            gt = np.linalg.inv(dataset.get_pose(frame_ids[0])) @ dataset.get_pose(fid)
            save_pose(os.path.join(out_dir, "gt"), fid, gt)
        if not bool(res.align_ok):
            print(f"frame {i}: align failed! (inliers={int(res.inlier_count)})")

    if timed:
        device = engine.device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"mean frame time = {total_ms / timed:.3f} ms ({name})")
    gt_poses = [dataset.get_pose(fid) for fid in frame_ids]
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(gt_poses))
    print(f"ATE RMSE = {ate:.5f} m")
    return ate


if __name__ == "__main__":
    main()
