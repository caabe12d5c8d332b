"""The sharded SLAM engine: the port of ``xslam_tpu/parallel/engine.py``.

:class:`ShardedXSlamEngine` runs the frame of
:class:`~xslam_tpu_torch.models.kinfu.XSlamEngine` over the ranks of a
:class:`~xslam_tpu_torch.parallel.mesh.SpaceGroup`: each rank holds one
X-slab of the volume; the depth, the poses and the model maps are
replicated. The preprocess runs on every rank (K1, K7, K8), the ICP over
column blocks with the systems summed, fusion into each slab, and the
model-map pyramid on every rank (K6, with the screen normals B4n):
:mod:`xslam_tpu_torch.parallel.sharded`. On the dense layout the raycast runs
over the slabs with a halo exchange; on the brick layout
(``volume_layout="brick"``) the ranks gather the rows and each marches and
refines a block of the model maps' columns with the brick layout's marches
(:data:`xslam_tpu_torch.models.kinfu.BRICK_MARCHES`). On one rank it gives
:class:`XSlamEngine`'s poses, volume and maps bit for bit. The frame reads
back to the host once, as the single engine's does: whether to integrate
and, on the temporal march, whether this rank's block of anchors is covered.

Behaviours that follow the JAX engine, whatever they part from the single
engine in:

- on the dense layout the raycast is always the fixed march with the
  ``secant2`` refine, whatever ``raycast_march`` says
  (``xslam_tpu/parallel/engine.py:378``, ``sharded.py:125``);
- with ``fusion_mode="brick"`` a slab's cap is ``max(256, fusion_brick_cap //
  n)`` for n ranks on the dense layout (``engine.py:322``), and ``min(its
  bricks, max(256, fusion_brick_cap // n))`` on the brick layout
  (``engine.py:285-286``);
- on the dense layout brick fusion never reruns densely: ``fusion_overflow``
  is not read, and the summed flag is reported (``engine.py:315-325``); on
  the brick layout ``"dense"`` fuses an overflowing slab exactly and
  reports no overflow, and ``"flag"`` reports the flags summed over the
  ranks (``engine.py:296-312``);
- on the brick layout each rank marches its own block of columns: the
  ``skip`` march gives the single engine's events pixel by pixel, while the
  hierarchical and temporal marches differ at block edges (their coarse
  neighbourhood is clipped there, ``sharded.py:286-295``), and the temporal
  refresh is decided per rank from its block's anchors;
- the brick layout asks that the X-slabs align with the 8-voxel bricks and
  that the model maps' width divide by the ranks (``ValueError``,
  ``engine.py:61-66``).

:class:`xslam_tpu_torch.models.recovery.RecoveringEngine` wraps this engine
as it wraps the single one (relocalization, keyframes, loop closures and the
end-of-run refinement, on every rank).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..csfd.single import CSFD, lift
from ..geometry import se3
from ..io.config import SlamConfig
from ..models.kinfu import BRICK_MARCHES, FrameResult, SlamState, _check_config, model_map_pyramid, stack_results
from ..ops import bricks, fusion, kernels, raycast_bricks
from .mesh import SpaceGroup, init_space_group
from .sharded import (
    GatheredRows, column_block, gather_rows, sharded_integrate, sharded_integrate_rows, sharded_pose_estimate,
    sharded_raycast, sharded_raycast_bricks,
)

MIN_SLAB_CAP = 256  # a slab's least brick cap (xslam_tpu/parallel/engine.py:285-286, :322)


class ShardedXSlamEngine:
    """The host side of the sharded step, with :class:`XSlamEngine`'s
    methods. ``group``: the ranks (:func:`init_space_group` of ``device`` when
    None: NCCL on the card, gloo with ``device="cpu"``)."""

    def __init__(self, config: SlamConfig, group: Optional[SpaceGroup] = None, device=None):
        _check_config(config)
        self.config = config
        self.group = init_space_group(device) if group is None else group
        self.device = self.group.device
        self.intr = config.intrinsics
        n = self.group.world_size
        assert config.tsdf_size[0] % n == 0, "volume X must divide the mesh"
        self.vol_cfg = fusion.VolumeConfig(
            resolution=tuple(config.tsdf_size), voxel_size=config.voxel_size, trunc_dist=config.trunc_dist,
            max_weight=config.max_integration_weight,
        )
        X, Y, Z = self.vol_cfg.resolution
        self.local_cfg = dataclasses.replace(self.vol_cfg, resolution=(X // n, Y, Z))
        self.slab = self.group.slab(X)
        self.brick = config.volume_layout == "brick"
        self.brick_cap = max(MIN_SLAB_CAP, config.fusion_brick_cap // n)
        if self.brick:
            if (X // n) % bricks.BRICK:
                raise ValueError(f"the brick layout needs X-slabs aligned to 8-voxel bricks: {X} voxels over {n} "
                                 f"ranks are slabs of {X // n}")
            if (self.intr.width >> config.model_map_level) % n:
                raise ValueError(f"the model maps' width {self.intr.width >> config.model_map_level} does not divide "
                                 f"over {n} ranks (the raycast takes a block of columns a rank)")
            nbx, nby, nbz = bricks.brick_grid(self.local_cfg.resolution)
            self.brick_cap = min(nbx * nby * nbz, self.brick_cap)
        self._gathered = GatheredRows()  # the brick layout's gathered rows, kept across frames
        self.world2volume = lift(torch.as_tensor(np.asarray(config.world2volume, np.float32), device=self.device))
        self.volume2world = se3.inverse(self.world2volume)
        self._placed = torch.empty(0, device=self.device).device
        self.pose_log: List[np.ndarray] = []

    def init_state(self) -> SlamState:
        """The state with this rank's slab of a zero volume; the maps and the
        pose replicated."""
        H, W = self.intr.height, self.intr.width
        dev = self.device

        def nan_map(h, w):
            return CSFD(torch.full((3, h, w), torch.nan, dtype=torch.float32, device=dev),
                        torch.zeros((3, h, w), dtype=torch.float32, device=dev))

        levels, L = self.config.num_levels, self.config.model_map_level
        return SlamState(
            volume=(bricks.create if self.brick else fusion.create_volume)(self.local_cfg, dev),
            world2camera=lift(torch.eye(4, dtype=torch.float32, device=dev)),
            vmaps_prev=tuple(nan_map(H >> (i + L), W >> (i + L)) for i in range(levels)),
            nmaps_prev=tuple(nan_map(H >> (i + L), W >> (i + L)) for i in range(levels)),
            frame_idx=0,
            last_align_ok=torch.ones((), dtype=torch.bool, device=dev),
            t_prev=torch.full((H >> L, W >> L), torch.inf, dtype=torch.float32, device=dev),
        )

    def process_frame(self, state: SlamState, depth_u16, gt_pose: Optional[np.ndarray] = None
                      ) -> Tuple[SlamState, FrameResult]:
        """Track and fuse one frame on every rank, as
        :meth:`XSlamEngine.process_frame` takes it (a host array, or a uint16
        tensor on this rank's device); this rank's slab is updated in place."""
        if isinstance(depth_u16, torch.Tensor):
            if depth_u16.dtype != torch.uint16 or depth_u16.device != self._placed:
                raise ValueError(f"depth: expected a uint16 tensor on {self._placed}, got {depth_u16.dtype} on "
                                 f"{depth_u16.device}")
            depth = depth_u16
        else:
            depth = torch.as_tensor(np.asarray(depth_u16, np.uint16)).to(self.device)
        gt = np.eye(4, dtype=np.float32) if gt_pose is None else np.asarray(gt_pose, np.float32)
        return process_frame_sharded(state, depth, gt, engine=self)

    def process_frames(self, state: SlamState, depths_u16, gt_poses: Optional[np.ndarray] = None
                       ) -> Tuple[SlamState, FrameResult]:
        """A (K, H, W) stack of frames, a loop of :meth:`process_frame`
        (``xslam_tpu/parallel/engine.py::process_frames``' ``lax.scan``):
        the final state and a :class:`FrameResult` with a leading K axis."""
        results = []
        for k in range(len(depths_u16)):
            state, res = self.process_frame(state, depths_u16[k], None if gt_poses is None else gt_poses[k])
            results.append(res)
        return state, stack_results(results)

    def dense_volume(self, state: SlamState) -> fusion.VolumeState:
        """The whole (X, Y, Z) volume on every rank: the ranks' slabs gathered
        (one ``all_gather`` a plane; new tensors), on the brick layout its
        rows gathered, then laid out densely."""
        planes = gather_rows(list(state.volume), self.group)
        if self.brick:
            return bricks.to_dense(bricks.BrickVolume(*planes), self.vol_cfg.resolution)
        return fusion.VolumeState(*planes)

    def log_pose(self, result: FrameResult):
        self.pose_log.append(result.camera2world.v.cpu().numpy())


def process_frame_sharded(state: SlamState, depth_u16: torch.Tensor, gt_pose_c2w: np.ndarray, *,
                          engine: ShardedXSlamEngine) -> Tuple[SlamState, FrameResult]:
    """One frame of the sharded engine (``xslam_tpu/parallel/engine.py::
    _process_frame_sharded``) on this rank: the stages of
    :func:`xslam_tpu_torch.models.kinfu.process_frame` with the ICP, the
    fusion and the raycast of :mod:`.sharded`. The profiler ranges are the
    single engine's."""
    config, intr, group = engine.config, engine.intr, engine.group
    levels = config.num_levels
    dev = depth_u16.device

    with record_function("preprocess"):
        depths = kernels.depth_pyramid(kernels.bilateral_filter(depth_u16), levels)
        vmaps_curr, nmaps_curr = kernels.vertex_normal_pyramid([intr.level(i) for i in range(levels)], depths)

    is_first = state.frame_idx == 0
    L = config.model_map_level
    temporal = engine.brick and config.raycast_march == "temporal"
    if temporal:
        # the anchors on every rank (the current depth's surface distance, else the last raycast's assembled
        # hits); this rank's block of them picks its anchored march or its refresh
        t_anchor = raycast_bricks.anchor_map(vmaps_curr[L], state.t_prev)
        coverage = raycast_bricks.anchor_coverage(column_block(t_anchor, group))
        covered = coverage >= config.raycast_temporal_min_coverage
    if config.use_gt_pose:
        c2w = lift(torch.as_tensor(gt_pose_c2w, device=dev))
        align_ok = torch.ones((), dtype=torch.bool, device=dev)
        inliers = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        with record_function("icp"):
            c2w_est, align_ok, inliers = sharded_pose_estimate(state, vmaps_curr, nmaps_curr, config, intr, group)
        c2w_prev = se3.inverse(state.world2camera)
        if config.min_inlier_fraction > 0:
            # the association-support gate on the count summed over the ranks, against the whole model map
            npix = (intr.height >> L) * (intr.width >> L)
            align_ok = align_ok & (inliers >= int(config.min_inlier_fraction * npix))
        if config.max_translation_per_frame > 0:
            delta = torch.linalg.norm(c2w_est.v[:3, 3] - c2w_prev.v[:3, 3])
            align_ok = align_ok & (delta <= config.max_translation_per_frame)
        if is_first:
            c2w = c2w_prev
            align_ok = torch.ones_like(align_ok)
        else:
            c2w = CSFD(torch.where(align_ok, c2w_est.v, c2w_prev.v), torch.where(align_ok, c2w_est.g, c2w_prev.g))

    w2c = se3.inverse(c2w)
    c2v = se3.matmul(engine.world2volume, c2w)
    v2c = se3.inverse(c2v)
    # the frame's one host read, one copy: whether to integrate (the same summed flag on every rank) and on the
    # temporal march whether this rank's anchors cover its block
    flags = ([] if is_first else [align_ok]) + ([covered] if temporal else [])
    flags = (torch.stack(flags) if len(flags) > 1 else flags[0].reshape(1)).tolist() if flags else []
    integrate = is_first or bool(flags[0])
    refresh = temporal and not flags[-1]
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    n_active = None
    if integrate:
        with record_function("fusion"):
            depth_m = fusion.scale_depth(depth_u16)
            r_v2c, t_v2c = se3.rotation(v2c), se3.translation(v2c)
            fuse = dict(classify_fine=config.fusion_classify_fine, classify_split=config.fusion_classify_split,
                        subcell_cap=config.fusion_subcell_cap)
            if engine.brick:
                overflow, n_active = sharded_integrate_rows(
                    state.volume, depth_m, r_v2c, t_v2c, intr, engine.local_cfg, config.bi_interpolate_threshold,
                    group, engine.brick_cap, overflow=config.fusion_overflow, **fuse,
                )
            else:
                overflow, n_active = sharded_integrate(
                    state.volume, depth_m, r_v2c, t_v2c, intr, engine.local_cfg, config.bi_interpolate_threshold,
                    group, fusion_mode=config.fusion_mode, brick_cap=engine.brick_cap, **fuse,
                )

    with record_function("raycast"):
        poses = (se3.rotation(c2v), se3.translation(c2v), se3.rotation(engine.volume2world),
                 se3.translation(engine.volume2world))
        t_prev = state.t_prev  # the dense layout carries the anchors untouched
        if engine.brick:
            # every brick march stores its assembled hits as the next frame's fallback anchors
            vmap0, nmap0, t_prev = sharded_raycast_bricks(
                state.volume, *poses, intr.level(L), engine.vol_cfg, group,
                march_mode=BRICK_MARCHES[config.raycast_march], refine_mode=config.raycast_refine,
                normals_mode=config.raycast_normals, hier_window=config.raycast_hier_window,
                t_anchor=t_anchor if temporal else None, temporal_window=config.raycast_temporal_window,
                refresh=refresh, temporal_phase1=config.raycast_temporal_phase1,
                skip_gran=config.raycast_skip_gran, packed_taps=config.raycast_packed_taps,
                compact=config.raycast_compact, gathered=engine._gathered,
            )
        else:
            # the fixed march and the secant2 refine, whatever raycast_march says (the JAX engine's dense branch)
            vmap0, nmap0 = sharded_raycast(state.volume, *poses, intr.level(L), engine.vol_cfg, group,
                                           normals_mode=config.raycast_normals)
        vmaps_prev, nmaps_prev = model_map_pyramid(vmap0, nmap0, levels)

    new_state = SlamState(
        volume=state.volume, world2camera=w2c, vmaps_prev=vmaps_prev, nmaps_prev=nmaps_prev,
        frame_idx=state.frame_idx + config.frame_step, last_align_ok=align_ok, t_prev=t_prev,
    )
    return new_state, FrameResult(camera2world=c2w, align_ok=align_ok, inlier_count=inliers, fusion_overflow=overflow,
                                  fusion_active=n_active, anchor_coverage=coverage if temporal else None)
