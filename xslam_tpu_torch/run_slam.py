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

``--scan K`` feeds the frames in chunks of K to
:meth:`~xslam_tpu_torch.models.kinfu.XSlamEngine.process_frames` (the first
chunk left out of the mean frame time); it writes the per-frame loop's pose
files bit for bit. With ``reloc_after_failures > 0`` it prints the JAX CLI's
note and runs the per-frame loop.

``--sharded`` runs :class:`~xslam_tpu_torch.parallel.engine.ShardedXSlamEngine`
(``apps/run_slam.py:44,77-79``): as a single process a group of one rank
(NCCL on the card, gloo with ``--device cpu``), under ``torchrun`` one rank a
process. It takes both volume layouts (bench.py's configuration too, the
brick layout with the options above) and, with ``reloc_after_failures > 0``,
the recovering engine below over it (``apps/run_slam.py:85-93``). Under
``torchrun`` every rank writes the pose files, the refined ones too, with the
same contents.

With ``reloc_after_failures > 0`` (the backend configs
``ICL_realistic_backend.yaml``, ``ICL_blackout.yaml``,
``ICL_loop_backend.yaml``) the engine is wrapped in
:class:`~xslam_tpu_torch.models.recovery.RecoveringEngine`: relocalization
after that many consecutive align failures, keyframes and, with
``loop_detect``, verified loop closures. After the ATE line, with at least
two keyframes, ``refine_trajectory()`` (pose graph, then depth-anchored
Schur-CG bundle adjustment) gives the refined trajectory: its pose files in
``<output_dir>/slam_refined/`` where ``log_slam_pose`` is set, and the line
``refined ATE RMSE = ... m (K keyframes, L loop closures)``. A backend
failure prints ``backend refinement FAILED (...)`` and leaves the odometry's
result standing, as in ``apps/run_slam.py``.

Usage:
    python -m xslam_tpu_torch.run_slam configs/ICL_realistic.yaml [--frames N] [--mesh tetra] [--scan K] [--device cpu]
        [--sharded] [options]

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .io.config import load_config
from .io.dataset import make_dataset
from .io.options import add_options, set_options
from .io.ply import export_ply, export_ply_mesh
from .models.kinfu import SlamState, XSlamEngine
from .models.recovery import RecoveringEngine
from .ops.extract import extract_mesh, extract_mesh_mc, extract_points
from .utils.evaluation import ate_rmse, normalize_to_first

POINT_CAPACITY = 1_000_000
MESH_CAPACITY = 2_000_000


class Run(NamedTuple):
    """What a run leaves: its ATE, the engine (its pose log; a
    ``RecoveringEngine`` with ``reloc_after_failures > 0``), the final state
    and the refined trajectory's ATE (None without a backend refinement)."""

    ate: float
    engine: XSlamEngine
    state: SlamState
    refined_ate: Optional[float] = None


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
    ap.add_argument("--sharded", action="store_true", help="use the sharded engine (X-slabs over torch.distributed)")
    ap.add_argument("--mesh", choices=("tetra", "mc"), default=None,
                    help="export the final isosurface mesh (<output_dir>/mesh.ply): 'tetra' = marching "
                    "tetrahedra, 'mc' = full 256-case marching cubes (ops/extract.py)")
    ap.add_argument("--scan", type=int, default=0, metavar="K",
                    help="process the frames in chunks of K through process_frames (the per-frame loop's results; "
                    "with reloc_after_failures > 0 a note, then the per-frame loop)")
    add_options(ap)
    args = ap.parse_args(argv)

    config = load_config(args.config)
    set_options(config, args)
    if args.frames is not None:
        config.end_frame = args.frames
    dataset = make_dataset(config)
    step = max(1, config.frame_step)
    frame_ids = list(range(config.start_frame, min(len(dataset) + config.start_frame, config.end_frame), step))
    print(f"frame num: {len(frame_ids)}")

    print("initialize engine......")
    if args.sharded:
        from .parallel.engine import ShardedXSlamEngine

        engine = ShardedXSlamEngine(config, device=args.device)
    else:
        engine = XSlamEngine(config, device=args.device)
    # relocalize-on-tracking-loss, keyframes and loop detection (apps/run_slam.py:85-93); the wrapper logs
    # the poses itself
    engine_logs_poses = config.reloc_after_failures > 0
    if engine_logs_poses:
        engine = RecoveringEngine(config, engine=engine)
        if args.scan > 1:
            print("note: --scan is incompatible with recovery (per-frame host inspection); using the per-frame loop")
    state = engine.init_state()
    out_dir = config.output_dir
    # only brick fusion that flags an overflow can leave a frame's map update partial: dense frames read nothing
    may_overflow = config.fusion_mode == "brick" and config.fusion_overflow == "flag"
    total_ms, timed = 0.0, 0
    print("start slam!")

    def log_frame(i, fid, align_ok, inliers, overflow):
        if config.log_slam_pose:
            save_pose(os.path.join(out_dir, "slam"), fid, engine.pose_log[-1])
        if config.log_gt_pose:
            gt = np.linalg.inv(dataset.get_pose(frame_ids[0])) @ dataset.get_pose(fid)
            save_pose(os.path.join(out_dir, "gt"), fid, gt)
        if not bool(align_ok):
            print(f"frame {i}: align failed! (inliers={int(inliers)})")
        if may_overflow and bool(overflow):
            print(f"frame {i}: fusion brick-cap overflow (map update partial)")

    if args.scan > 1 and not engine_logs_poses:
        # chunks of K frames through process_frames (apps/run_slam.py:121-146)
        for pos in range(0, len(frame_ids), args.scan):
            ids = frame_ids[pos:pos + args.scan]
            depths = np.stack([dataset.get_depth(f) for f in ids])  # read and decoded outside the timed window
            gts = np.stack([dataset.get_pose(f) for f in ids]).astype(np.float32) if config.use_gt_pose else None
            t0 = time.perf_counter()
            state, res = engine.process_frames(state, depths, gt_poses=gts)
            poses = res.camera2world.v.cpu().numpy()  # reads the poses back: the chunk's work is done
            dt = (time.perf_counter() - t0) * 1e3
            if pos > 0:  # the first chunk pays one-time set-up
                total_ms += dt
                timed += len(ids)
            for j, fid in enumerate(ids):
                engine.pose_log.append(poses[j])
                log_frame(pos + j, fid, res.align_ok[j], res.inlier_count[j], res.fusion_overflow[j])
    else:
        for i, fid in enumerate(frame_ids):
            depth = dataset.get_depth(fid)  # read and decoded outside the timed window
            gt_pose = dataset.get_pose(fid) if config.use_gt_pose else None
            t0 = time.perf_counter()
            state, res = engine.process_frame(state, depth, gt_pose=gt_pose)
            if not engine_logs_poses:
                engine.log_pose(res)  # reads the pose back: the frame's work is done
            dt = (time.perf_counter() - t0) * 1e3
            if i > 0:  # the first frame pays one-time set-up
                total_ms += dt
                timed += 1
            log_frame(i, fid, res.align_ok, res.inlier_count, res.fusion_overflow)

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

    # backend refinement: pose graph (+ recorded loop closures) + depth-anchored Schur-CG BA over the keyframe
    # log, propagated to the whole trajectory and exported beside the odometry (apps/run_slam.py:210-230)
    refined_ate = None
    if engine_logs_poses and len(engine.keyframes) >= 2:
        try:
            refined = engine.refine_trajectory()
        except Exception as e:  # noqa: BLE001 — the odometry's result above stands
            print(f"backend refinement FAILED ({type(e).__name__}): {e}")
            return Run(ate, engine, state)
        if config.log_slam_pose:
            for i, fid in enumerate(frame_ids[: len(refined)]):
                save_pose(os.path.join(out_dir, "slam_refined"), fid, refined[i])
        refined_ate = ate_rmse(normalize_to_first(list(refined)), normalize_to_first(gt_poses))
        print(f"refined ATE RMSE = {refined_ate:.5f} m ({len(engine.keyframes)} keyframes, "
              f"{len(engine.loop_edges)} loop closures)")
    return Run(ate, engine, state, refined_ate)


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():  # --sharded: end the ranks' group before the process exits
        torch.distributed.destroy_process_group()
