"""Frame-to-frame ICP odometry (no map).

Port of ``xslam_tpu/models/odometry.py``: a lightweight tracking baseline
that aligns each frame against the *previous frame's* measured maps instead
of the raycast model maps (the standard ablation that quantifies the value of
the fused model, and a cheap dual-capable odometry for seeding relocalization
or BA).

Each frame runs the engine's preprocess (kernels K1, K7 and K8: the
bilateral filter, the depth pyramid in one launch, the vertex and normal maps
of every level in one launch), then coarse-to-fine ICP against the previous
frame's maps carried into the world through the previous pose (dual, plain
PyTorch, once a level), one launch of kernel K4 with its tail an iteration
(``icp.IcpLoop``: the iteration of ``xslam_tpu/models/kinfu.py:281-298``,
which ``odometry.py:107-112`` repeats). On CPU tensors every wrapper runs its
plain version, and each iteration is ``icp.icp_step``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..csfd.single import CSFD, lift
from ..geometry import se3
from ..geometry.intrinsics import Intrinsics
from ..io.config import SlamConfig
from ..ops import icp, kernels
from .kinfu import _device


class OdometryState(NamedTuple):
    world2camera: CSFD  # (4, 4) dual
    vmaps_prev: Tuple[torch.Tensor, ...]  # real camera-space pyramids
    nmaps_prev: Tuple[torch.Tensor, ...]
    prev_c2w: CSFD
    frame_idx: int  # host counter: no device read to test for frame 0


class OdometryResult(NamedTuple):
    camera2world: CSFD
    align_ok: torch.Tensor
    inlier_count: torch.Tensor


class OdometryEngine:
    """Host driver of the frame-to-frame odometry; runs on the CUDA card
    unless ``device`` names another device (the tests pass ``"cpu"``)."""

    def __init__(self, config: SlamConfig, device=None):
        self.config = config
        self.device = _device(device, "OdometryEngine")
        self._placed = torch.empty(0, device=self.device).device
        self.intr = config.intrinsics
        self.pose_log: List[np.ndarray] = []

    def init_state(self) -> OdometryState:
        H, W = self.intr.height, self.intr.width
        levels = self.config.num_levels

        def nan_map(h, w):
            return torch.full((3, h, w), torch.nan, dtype=torch.float32, device=self.device)

        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        return OdometryState(
            world2camera=lift(eye),
            vmaps_prev=tuple(nan_map(H >> i, W >> i) for i in range(levels)),
            nmaps_prev=tuple(nan_map(H >> i, W >> i) for i in range(levels)),
            prev_c2w=lift(eye.clone()),
            frame_idx=0,
        )

    def process_frame(self, state: OdometryState, depth_u16) -> Tuple[OdometryState, OdometryResult]:
        """Track one frame. ``depth_u16`` (H, W) in mm: a host array, uploaded
        here, or a uint16 tensor already on the engine's device."""
        if isinstance(depth_u16, torch.Tensor):
            if depth_u16.dtype != torch.uint16 or depth_u16.device != self._placed:
                raise ValueError(f"depth: expected a uint16 tensor on {self._placed}, got {depth_u16.dtype} on "
                                 f"{depth_u16.device}")
            depth = depth_u16
        else:
            depth = torch.as_tensor(np.asarray(depth_u16, np.uint16)).to(self.device)
        return _process_frame(state, depth, config=self.config, intr=self.intr)

    def log_pose(self, result: OdometryResult):
        self.pose_log.append(result.camera2world.v.cpu().numpy())


def _world_maps(prev_c2w: CSFD, vmap: torch.Tensor, nmap: torch.Tensor):
    """The previous frame's camera-space maps in world coordinates, dual,
    chained through the previous pose estimate (odometry.py:97-100)."""
    prev_R, prev_t = se3.rotation(prev_c2w), se3.translation(prev_c2w)
    vprev_w = se3.matvec(prev_R, lift(vmap)) + CSFD(prev_t.v[:, None, None], prev_t.g[:, None, None])
    nprev_w = se3.matvec(prev_R, lift(nmap))
    return vprev_w, nprev_w


def _process_frame(state: OdometryState, depth_u16: torch.Tensor, *, config: SlamConfig, intr: Intrinsics):
    levels = config.num_levels
    depths = kernels.depth_pyramid(kernels.bilateral_filter(depth_u16), levels)
    vmaps, nmaps = kernels.vertex_normal_pyramid([intr.level(i) for i in range(levels)], depths)

    is_first = state.frame_idx == 0
    c2w_prev = se3.inverse(state.world2camera)
    r_prev = se3.rotation(c2w_prev)
    t_prev = se3.translation(c2w_prev)
    r_prev_inv = se3.rotation(state.world2camera)
    prev = {level: _world_maps(state.prev_c2w, state.vmaps_prev[level], state.nmaps_prev[level])
            for level in range(levels)}
    order = list(reversed(range(levels)))

    if kernels.on_cpu(depth_u16):
        r_curr, t_curr = r_prev, t_prev
        ok = torch.ones((), dtype=torch.bool)
        inliers = torch.zeros((), dtype=torch.int32)
        for level in order:
            for _ in range(config.icp_iterations[level]):
                step = icp.icp_step(
                    r_curr, t_curr, vmaps[level], nmaps[level], r_prev_inv, t_prev, intr.level(level),
                    *prev[level], config.dist_thres, config.angle_thres_sine, config.icp_damping,
                )
                r_curr, t_curr = step.r_curr, step.t_curr
                ok = ok & step.ok
                inliers = step.system.inlier_count
    else:
        rows = {level: icp.pack_model_rows(*prev[level]) for level in order}
        loop = icp.IcpLoop(icp.pack_pose(r_prev, t_prev, r_prev_inv, t_prev))
        for level in order:
            for _ in range(config.icp_iterations[level]):
                loop.iterate(vmaps[level], nmaps[level], rows[level], state.vmaps_prev[level].shape[-2:],
                             intr.level(level), config.dist_thres, config.angle_thres_sine, config.icp_damping)
        step = loop.result()
        r_curr, t_curr, ok, inliers = step.r_curr, step.t_curr, step.ok, step.system.inlier_count

    c2w_est = se3.from_rotation_translation(r_curr, t_curr)
    if is_first:
        c2w = c2w_prev
    else:
        c2w = CSFD(torch.where(ok, c2w_est.v, c2w_prev.v), torch.where(ok, c2w_est.g, c2w_prev.g))
    new_state = OdometryState(
        world2camera=se3.inverse(c2w),
        vmaps_prev=tuple(vmaps),
        nmaps_prev=tuple(nmaps),
        prev_c2w=c2w,
        frame_idx=state.frame_idx + 1,
    )
    align_ok = torch.ones_like(ok) if is_first else ok
    return new_state, OdometryResult(camera2world=c2w, align_ok=align_ok, inlier_count=inliers)
