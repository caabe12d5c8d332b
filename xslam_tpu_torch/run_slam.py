"""End-to-end SLAM driver of the PyTorch port.

Counterpart of ``apps/run_slam.py``: YAML config in (the options of
:mod:`xslam_tpu_torch.io.options` set over the file's, e.g. bench.py's
configuration with ``--fixed-assoc --model-map-level 1 --fusion-mode brick
--fusion-brick-cap 2816 --fusion-overflow dense --volume-layout brick
--raycast-march temporal --raycast-refine reuse --raycast-normals screen``),
the frames of any ``dataset_format`` (``synthetic``, ``ICL``, ``7scenes``:
:func:`xslam_tpu_torch.io.dataset.make_dataset`), per-frame estimated and
ground-truth pose files (``<output_dir>/slam/frame-XXXXXX.pose.txt``,
``<output_dir>/gt/...``), the point cloud ``<output_dir>/pcd.ply`` where the
config sets ``draw_pcd`` (kernel B13 on the card), the mesh
``<output_dir>/mesh.ply`` with ``--mesh {tetra,mc}``, the mean frame time
and the ATE RMSE printed at the end.

Usage:
    python -m xslam_tpu_torch.run_slam configs/ICL_realistic.yaml [--frames N] [--mesh tetra] [--device cpu] [options]

Runs on the CUDA card unless ``--device`` names another device. The
recovery wrapper (``reloc_after_failures > 0``) is not ported and raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .io.config import load_config
from .io.dataset import make_dataset
from .io.options import add_options, set_options
from .io.ply import export_ply, export_ply_mesh
from .models.kinfu import SlamState, XSlamEngine
from .ops.extract import extract_mesh, extract_mesh_mc, extract_points
from .utils.evaluation import ate_rmse, normalize_to_first

POINT_CAPACITY = 1_000_000
MESH_CAPACITY = 2_000_000


class Run(NamedTuple):
    """What a run leaves: its ATE, the engine (its pose log) and the final state."""

    ate: float
    engine: XSlamEngine
    state: SlamState


def save_pose(output_dir: str, frame_id: int, pose: np.ndarray):
    """A pose file as the JAX package's native writer makes it
    (``runtime/src/xslam_native.cpp::xs_write_pose``): the pose cast to
    float32, each row ``%.7f`` four times."""
    os.makedirs(output_dir, exist_ok=True)
    np.savetxt(os.path.join(output_dir, f"frame-{frame_id:06d}.pose.txt"), np.asarray(pose, np.float32), fmt="%.7f")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--frames", type=int, default=None, help="override end_frame")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--mesh", choices=("tetra", "mc"), default=None,
                    help="export the final isosurface mesh (<output_dir>/mesh.ply): 'tetra' = marching "
                    "tetrahedra, 'mc' = full 256-case marching cubes (ops/extract.py)")
    add_options(ap)
    args = ap.parse_args(argv)

    config = load_config(args.config)
    set_options(config, args)
    if args.frames is not None:
        config.end_frame = args.frames
    if config.reloc_after_failures > 0:
        raise NotImplementedError(
            f"reloc_after_failures={config.reloc_after_failures}: the recovery wrapper (RecoveringEngine) "
            "is not ported yet")
    dataset = make_dataset(config)
    step = max(1, config.frame_step)
    frame_ids = list(range(config.start_frame, min(len(dataset) + config.start_frame, config.end_frame), step))
    print(f"frame num: {len(frame_ids)}")

    print("initialize engine......")
    engine = XSlamEngine(config, device=args.device)
    state = engine.init_state()
    out_dir = config.output_dir
    # only brick fusion that flags an overflow can leave a frame's map update partial: dense frames read nothing
    may_overflow = config.fusion_mode == "brick" and config.fusion_overflow == "flag"
    total_ms, timed = 0.0, 0
    print("start slam!")
    for i, fid in enumerate(frame_ids):
        depth = dataset.get_depth(fid)  # read and decoded outside the timed window
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
        if may_overflow and bool(res.fusion_overflow):
            print(f"frame {i}: fusion brick-cap overflow (map update partial)")

    if config.draw_pcd:
        pc = extract_points(engine.dense_volume(state), engine.vol_cfg, capacity=POINT_CAPACITY)
        n = int(pc.count)
        os.makedirs(out_dir, exist_ok=True)
        export_ply(os.path.join(out_dir, "pcd.ply"), pc.points[:n].cpu().numpy(), pc.normals[:n].cpu().numpy())
        print(f"exported {n} points")

    if args.mesh:
        mesher = extract_mesh_mc if args.mesh == "mc" else extract_mesh
        t0 = time.perf_counter()
        mesh = mesher(engine.dense_volume(state), engine.vol_cfg, capacity=MESH_CAPACITY)
        k = int(mesh.count)  # reads the count back: the mesh is done
        seconds = time.perf_counter() - t0
        os.makedirs(out_dir, exist_ok=True)
        export_ply_mesh(os.path.join(out_dir, "mesh.ply"), mesh.vertices[:k].cpu().numpy())
        print(f"exported {k} {args.mesh} triangles ({seconds:.3f} s)")

    if timed:
        device = engine.device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"mean frame time = {total_ms / timed:.3f} ms ({name})")
    gt_poses = [dataset.get_pose(fid) for fid in frame_ids]
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(gt_poses))
    print(f"ATE RMSE = {ate:.5f} m")
    return Run(ate, engine, state)


if __name__ == "__main__":
    main()
