"""One rank of the port's sharded engine over frames given in files: the
process that ``tests/test_torch_sharded.py`` and
``tests/test_torch_sharded_bricks.py`` start once a rank. It imports only
torch and the port, so a rank does not load JAX through a test module.

Usage (from the repo's root, with it on ``PYTHONPATH``):
    python tests/sharded_rank.py CONFIG.pkl DEPTHS.npy OUT_PREFIX --rank R --world-size N
        --init-method file:///... [--device cpu] [--backend gloo] [--gt GT.npy]

``CONFIG.pkl``: a pickled :class:`xslam_tpu_torch.io.config.SlamConfig`, or
a list of jobs run one after another in this one process (start-up and
imports paid once): ``{"name": ..., "config": SlamConfig}`` runs the
engine over the frames (the first ``"frames"`` of them where the job
says), ``{"name": ..., "stage": "refresh"}`` the per-rank
refresh of the brick raycast on the state the job before it left
(:func:`refresh_stage`), ``{"name": ..., "ba": {...}}`` the
observation-sharded ``schur_ba`` and ``schur_ba_cg`` on this rank's block of
a problem (:func:`ba_job`), ``{"name": ..., "config": SlamConfig, "recover":
True}`` the recovering engine over the sharded one (:func:`recover_job`). ``DEPTHS.npy``: a (K, H, W) uint16 stack;
``GT.npy``: (K, 4, 4) camera-to-world poses, given to the engine where a
config sets ``use_gt_pose``. Rank r writes ``OUT_PREFIX.r.npz``: each
frame's pose (value and derivative lanes), ``align_ok``, inlier count,
overflow flag, ACTIVE bricks summed over the ranks (``active``) and this
rank's own (``local_active``, ``local_overflow``: brick fusion on the brick
layout), the frame's milliseconds, the last ``t_prev``, level 0's model
maps, the slab, and the kernels' launches over the frames (``launches.K``);
on rank 0 the whole volume (the ranks' slabs gathered). A job's keys are
prefixed with ``NAME.``. ``--backend gloo`` on the card starts the default
group over gloo's CUDA collectives before the engine takes it, so several
ranks run on one card (NCCL refuses two ranks a card).
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from xslam_tpu_torch.geometry import se3
from xslam_tpu_torch.models import ba
from xslam_tpu_torch.models.recovery import RecoveringEngine
from xslam_tpu_torch.ops import fusion, kernels, raycast_bricks
from xslam_tpu_torch.parallel import sharded
from xslam_tpu_torch.parallel.engine import ShardedXSlamEngine
from xslam_tpu_torch.parallel.mesh import destroy_space_group, init_space_group

FRAME_KEYS = ("pose_v", "pose_g", "align_ok", "inliers", "overflow", "active", "local_active", "local_overflow",
              "frame_ms")


class _Spy:
    """Calls ``fn`` and keeps what ``record`` takes of each call."""

    def __init__(self, fn, record):
        self.fn, self.record, self.calls = fn, record, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append(self.record(args, kwargs, out))
        return out


def run_frames(engine, depths: np.ndarray, gt: np.ndarray = None) -> tuple:
    """The engine over ``depths``: (state, the per-frame outputs)."""
    fused = _Spy(fusion.integrate_rows, lambda a, k, out: (bool(out[0]), int(out[1])))
    fusion.integrate_rows = fused  # sharded.py calls it through the module
    try:
        state = engine.init_state()
        out = {k: [] for k in FRAME_KEYS}
        cuda = engine.device.type == "cuda"
        kernels.reset_launch_counts()
        for i, depth in enumerate(depths):
            t0 = time.perf_counter()
            state, res = engine.process_frame(state, depth, None if gt is None else gt[i])
            if cuda:
                torch.cuda.synchronize()
            out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
            local = fused.calls.pop() if fused.calls else (False, -1)
            out["pose_v"].append(res.camera2world.v.cpu().numpy())
            out["pose_g"].append(res.camera2world.g.cpu().numpy())
            out["align_ok"].append(bool(res.align_ok))
            out["inliers"].append(int(res.inlier_count))
            out["overflow"].append(bool(res.fusion_overflow))
            out["active"].append(-1 if res.fusion_active is None else int(res.fusion_active))
            out["local_overflow"].append(local[0])
            out["local_active"].append(local[1])
    finally:
        fusion.integrate_rows = fused.fn
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update({f"launches.{k}": np.asarray(n) for k, n in kernels.launch_counts.items()})
    volume = engine.dense_volume(state)  # a collective: every rank takes part
    if engine.group.rank == 0:
        out.update(value=volume.value.cpu().numpy(), weight=volume.weight.cpu().numpy())
    out.update(vmap=state.vmaps_prev[0].v.cpu().numpy(), nmap=state.nmaps_prev[0].v.cpu().numpy(),
               t_prev=state.t_prev.cpu().numpy(), slab=np.asarray(engine.slab))
    return state, out


def refresh_stage(engine, state) -> dict:
    """The brick raycast's per-rank refresh: ``sharded_raycast_bricks`` with
    the temporal march at ``temporal_min_coverage=0.5`` over the state's
    slabs, at the pose the state holds, with ``state.t_prev`` as anchors but
    no finite anchor in rank 0's block of columns. Returns this rank's
    decision (``refresh``), the assembled maps (``vmap_v``, ``vmap_g``,
    ``t_found``), and on rank 0 what a one-rank call needs: the packed pose,
    the anchors and the whole volume's rows."""
    config, group = engine.config, engine.group
    intr = engine.intr.level(config.model_map_level)
    c2v = se3.matmul(engine.world2volume, se3.inverse(state.world2camera))
    pose = kernels.pack_ray_pose(se3.rotation(c2v), se3.translation(c2v), se3.rotation(engine.volume2world),
                                 se3.translation(engine.volume2world))
    t_anchor = state.t_prev.clone()
    t_anchor[:, : intr.width // group.world_size] = torch.inf
    spy = _Spy(raycast_bricks.raycast_bricks, lambda a, k, out: bool(k["refresh"]))
    sharded.raycast_bricks.raycast_bricks = spy
    try:
        vmap, _, t_found = sharded.sharded_raycast_bricks(
            state.volume, *kernels.unpack_ray_pose(pose), intr, engine.vol_cfg, group, march_mode="temporal",
            refine_mode=config.raycast_refine, normals_mode=config.raycast_normals,
            t_anchor=t_anchor, temporal_window=config.raycast_temporal_window, temporal_min_coverage=0.5,
        )
    finally:
        sharded.raycast_bricks.raycast_bricks = spy.fn
    out = dict(refresh=np.asarray(spy.calls), vmap_v=vmap.v.cpu().numpy(), vmap_g=vmap.g.cpu().numpy(),
               t_found=t_found.cpu().numpy())
    rows = sharded.gather_rows(list(state.volume), group)
    if group.rank == 0:
        out.update(pose=pose.cpu().numpy(), t_anchor=t_anchor.cpu().numpy(),
                   **{f"rows_{k}": r.cpu().numpy() for k, r in zip(("value", "grad", "weight"), rows)})
    return out


def ba_job(spec: dict, group) -> dict:
    """``schur_ba`` and ``schur_ba_cg`` with ``group`` on this rank's block
    (:func:`xslam_tpu_torch.models.ba.observation_block`) of the problem of
    ``spec`` (numpy ``frame_idx``, ``anchor_idx``, ``meas_cam``, the start
    ``poses`` and ``anchors``, ``iters``): each solver's poses, anchors and
    residual history, and the rank's rows."""
    dev = group.device
    problem = ba.BAProblem(*(torch.as_tensor(spec[k], device=dev) for k in ("frame_idx", "anchor_idx", "meas_cam")))
    block = ba.observation_block(problem, group)
    poses, anchors = (torch.as_tensor(spec[k], device=dev) for k in ("poses", "anchors"))
    out = dict(rows=np.asarray(block.frame_idx.shape[0]))
    for name, fn in (("dense", ba.schur_ba), ("cg", ba.schur_ba_cg)):
        res = fn(poses, anchors, block, iters=spec["iters"], group=group)
        out.update({f"{name}_poses": res.poses.cpu().numpy(), f"{name}_anchors": res.anchors.cpu().numpy(),
                    f"{name}_hist": res.residual_history.cpu().numpy()})
    return out


def recover_job(config, depths: np.ndarray, group) -> dict:
    """``RecoveringEngine`` over ``ShardedXSlamEngine`` on ``depths``, then
    ``refine_trajectory()``: the pose log, each frame's ``align_ok``, the
    recovery events (frame, accepted, the losses before and after, the pose
    jump), the keyframes' frames, the loop edges' keyframe pairs and the
    refined trajectory."""
    engine = RecoveringEngine(config, engine=ShardedXSlamEngine(config, group=group))
    state, oks = engine.init_state(), []
    for depth in depths:
        state, res = engine.process_frame(state, depth)
        oks.append(bool(res.align_ok))
    return dict(pose_log=np.stack(engine.pose_log), align_ok=np.asarray(oks),
                events=np.asarray([tuple(e) for e in engine.recovery_events], np.float64).reshape(-1, 5),
                keyframes=np.asarray([k.frame_index for k in engine.keyframes]),
                loop_edges=np.asarray([(i, j) for i, j, _ in engine.loop_edges]).reshape(-1, 2),
                refined=engine.refine_trajectory())


def run(config, depths: np.ndarray, rank: int, world_size: int, init_method: str, device=None,
        gt: np.ndarray = None, backend=None) -> dict:
    """This rank's run over ``depths``: what :func:`main` writes."""
    if backend == "gloo" and device is None:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size)
    group = init_space_group(device, init_method=init_method, rank=rank, world_size=world_size)
    try:
        if not isinstance(config, list):
            return run_frames(ShardedXSlamEngine(config, group=group), depths, gt)[1]
        out, last = {}, None
        for job in config:
            if "stage" in job:
                result = refresh_stage(*last)
            elif "ba" in job:
                result = ba_job(job["ba"], group)
            elif job.get("recover"):
                result = recover_job(job["config"], depths[:job.get("frames", len(depths))], group)
            else:
                engine = ShardedXSlamEngine(job["config"], group=group)
                k = job.get("frames", len(depths))
                state, result = run_frames(engine, depths[:k], gt[:k] if job["config"].use_gt_pose else None)
                last = (engine, state)
            out.update({f"{job['name']}.{k}": v for k, v in result.items()})
        return out
    finally:
        destroy_space_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("depths")
    ap.add_argument("out_prefix")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: cuda, NCCL); cpu: gloo")
    ap.add_argument("--backend", default=None, choices=("gloo",), help="gloo on the card (several ranks a card)")
    ap.add_argument("--gt", default=None, help="(K, 4, 4) camera-to-world poses, for configs with use_gt_pose")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.config, "rb") as f:
        config = pickle.load(f)
    gt = None if args.gt is None else np.load(args.gt)
    out = run(config, np.load(args.depths), args.rank, args.world_size, args.init_method, args.device, gt,
              args.backend)
    np.savez(f"{args.out_prefix}.{args.rank}.npz", **out)


if __name__ == "__main__":
    main()
