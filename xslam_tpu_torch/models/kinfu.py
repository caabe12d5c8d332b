"""The KinectFusion-style differentiable SLAM engine, dense reference path.

Port of ``xslam_tpu/models/kinfu.py`` for the configuration that
``SlamConfig()``'s defaults select (dense volume, dense fusion, fixed march,
``secant2`` refine, TSDF normals, full-resolution model maps, association
every ICP iteration, nearest-depth fusion). Each frame runs:

1. bilateral filter (kernel K1), two ``pyr_down``s, vertex/normal maps;
2. coarse-to-fine ICP, levels 2 -> 1 -> 0 with {5, 4, 3} iterations, as a
   Python loop whose ``ok`` flags stay on the device;
3. TSDF fusion (kernel K2, in place) when the frame aligned;
4. raycast of the model maps (march kernel K3, plain refine) and their
   pyramid.

The four stages are profiler ranges (``preprocess``, ``icp``, ``fusion``,
``raycast``), which :mod:`xslam_tpu_torch.profile_step` reads.

The frame reads one value back to the host: whether to integrate (the JAX
engine's ``lax.cond``), so a rejected frame skips the fusion pass instead of
selecting between two copies of the 201 MB volume.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..csfd import vec3
from ..csfd.single import CSFD, lift
from ..geometry import se3
from ..geometry.intrinsics import Intrinsics
from ..io.config import SlamConfig
from ..ops import fusion, icp, kernels, preprocess, raycast


class SlamState(NamedTuple):
    """Engine state. The volume is updated in place by fusion."""

    volume: fusion.VolumeState
    world2camera: CSFD  # (4, 4) dual
    # model-map pyramid from raycasting (dual, world coords)
    vmaps_prev: Tuple[CSFD, ...]
    nmaps_prev: Tuple[CSFD, ...]
    frame_idx: int  # host counter: no device read to test for frame 0
    last_align_ok: torch.Tensor  # bool scalar
    # anchors of the brick layout's temporal march: carried untouched here
    t_prev: torch.Tensor


class FrameResult(NamedTuple):
    camera2world: CSFD  # (4, 4) dual pose estimate of this frame
    align_ok: torch.Tensor
    inlier_count: torch.Tensor
    fusion_overflow: torch.Tensor  # always False: dense fusion has no cap


# options whose other values select paths this port does not have yet
_SLICE = {
    "volume_layout": "dense",
    "fusion_mode": "dense",
    "raycast_march": "fixed",
    "raycast_refine": "secant2",
    "raycast_normals": "tsdf",
    "raycast_packed_taps": False,
    "model_map_level": 0,
    "icp_fixed_assoc": False,
}


def _device(device) -> torch.device:
    """``None`` means the card; CUDA must exist then — no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("XSlamEngine: CUDA is not available (pass device='cpu' to run on the CPU)")
    return dev


class XSlamEngine:
    """Host driver: owns the config and the per-frame step, mirrors the public
    API of ``KinectFusionReconstruction`` (SetYamlParameters/ProcessFrame)."""

    def __init__(self, config: SlamConfig, device=None):
        for key, want in _SLICE.items():
            if getattr(config, key) != want:
                raise NotImplementedError(f"{key}={getattr(config, key)!r} is not ported yet (only {want!r})")
        if config.bi_interpolate_threshold > 0:
            raise NotImplementedError("bilinear depth sampling (biInterpolate_threshold > 0) is not ported yet")
        self.config = config
        self.device = _device(device)
        self.intr = config.intrinsics
        self.vol_cfg = fusion.VolumeConfig(
            resolution=tuple(config.tsdf_size),
            voxel_size=config.voxel_size,
            trunc_dist=config.trunc_dist,
            max_weight=config.max_integration_weight,
        )
        self.world2volume = lift(torch.as_tensor(np.asarray(config.world2volume, np.float32), device=self.device))
        self.pose_log: List[np.ndarray] = []

    def init_state(self) -> SlamState:
        H, W = self.intr.height, self.intr.width
        dev = self.device

        def nan_map(h, w):
            return CSFD(
                torch.full((3, h, w), torch.nan, dtype=torch.float32, device=dev),
                torch.zeros((3, h, w), dtype=torch.float32, device=dev),
            )

        levels = self.config.num_levels
        return SlamState(
            volume=fusion.create_volume(self.vol_cfg, dev),
            world2camera=lift(torch.eye(4, dtype=torch.float32, device=dev)),
            vmaps_prev=tuple(nan_map(H >> i, W >> i) for i in range(levels)),
            nmaps_prev=tuple(nan_map(H >> i, W >> i) for i in range(levels)),
            frame_idx=0,
            last_align_ok=torch.ones((), dtype=torch.bool, device=dev),
            t_prev=torch.full((H, W), torch.inf, dtype=torch.float32, device=dev),
        )

    def process_frame(
        self, state: SlamState, depth_u16, gt_pose: Optional[np.ndarray] = None
    ) -> Tuple[SlamState, FrameResult]:
        """Track + fuse one frame (``ProcessFrame``,
        KinectFusionReconstruction.cpp:147-159). ``gt_pose`` (c2w) is used
        when the config sets ``use_gt_pose``. The volume of ``state`` is
        updated in place and shared with the returned state."""
        depth = torch.as_tensor(np.asarray(depth_u16, np.uint16)).to(self.device)
        gt = np.eye(4, dtype=np.float32) if gt_pose is None else np.asarray(gt_pose, np.float32)
        return process_frame(
            state, depth, gt, config=self.config, intr=self.intr, vol_cfg=self.vol_cfg,
            world2volume=self.world2volume,
        )

    def log_pose(self, result: FrameResult):
        self.pose_log.append(result.camera2world.v.cpu().numpy())


# --------------------------------------------------------------------------
def _pose_estimate(state: SlamState, vmaps_curr, nmaps_curr, config: SlamConfig, intr: Intrinsics):
    """Coarse-to-fine ICP (``PoseEstimate``,
    KinectFusionReconstruction.cpp:177-235). Returns (c2w_new, ok, inliers)."""
    c2w_prev = se3.inverse(state.world2camera)
    r_prev = se3.rotation(c2w_prev)
    t_prev = se3.translation(c2w_prev)
    r_prev_inv = se3.rotation(state.world2camera)  # R^-1 = R of world2camera

    r_curr, t_curr = r_prev, t_prev
    ok = torch.ones((), dtype=torch.bool, device=state.world2camera.v.device)
    inliers = None
    for level in reversed(range(config.num_levels)):
        for _ in range(config.icp_iterations[level]):
            system = icp.build_system(
                r_curr, t_curr,
                vmaps_curr[level], nmaps_curr[level],
                r_prev_inv, t_prev, intr.level(level),
                state.vmaps_prev[level], state.nmaps_prev[level],
                config.dist_thres, config.angle_thres_sine,
            )
            x, step_ok = icp.solve_increment(system, damping=config.icp_damping)
            inc = se3.euler_xyz_increment(*(CSFD(x.v[i], x.g[i]) for i in range(6)))
            r_inc = se3.rotation(inc)
            t_inc = se3.translation(inc)
            # left-multiplied incremental update
            # (KinectFusionReconstruction.cpp:219-221); frozen on failure
            t_new = se3.matvec(r_inc, t_curr) + t_inc
            r_new = se3.matmul(r_inc, r_curr)
            t_curr = CSFD(torch.where(step_ok, t_new.v, t_curr.v), torch.where(step_ok, t_new.g, t_curr.g))
            r_curr = CSFD(torch.where(step_ok, r_new.v, r_curr.v), torch.where(step_ok, r_new.g, r_curr.g))
            ok = ok & step_ok
            inliers = system.inlier_count

    one = lift(torch.ones((), dtype=torch.float32, device=ok.device))
    zero = lift(torch.zeros((), dtype=torch.float32, device=ok.device))
    rows = [
        [se3.elem(r_curr, i, 0), se3.elem(r_curr, i, 1), se3.elem(r_curr, i, 2), CSFD(t_curr.v[i], t_curr.g[i])]
        for i in range(3)
    ]
    rows.append([zero, zero, zero, one])
    return se3._stack(rows), ok, inliers


def process_frame(
    state: SlamState,
    depth_u16: torch.Tensor,
    gt_pose_c2w: np.ndarray,
    *,
    config: SlamConfig,
    intr: Intrinsics,
    vol_cfg: fusion.VolumeConfig,
    world2volume: CSFD,
) -> Tuple[SlamState, FrameResult]:
    levels = config.num_levels
    dev = depth_u16.device

    # --- SurfaceMeasure (KinectFusionReconstruction.cpp:280-299) ----------
    with record_function("preprocess"):
        depths = [kernels.bilateral_filter(depth_u16)]
        for _ in range(1, levels):
            depths.append(preprocess.pyr_down(depths[-1]))
        vmaps_curr = [preprocess.create_vmap(intr.level(i), depths[i]) for i in range(levels)]
        nmaps_curr = [preprocess.create_nmap(v) for v in vmaps_curr]

    is_first = state.frame_idx == 0

    # --- AlignDepthToReconstruction --------------------------------------
    if config.use_gt_pose:
        c2w = lift(torch.as_tensor(gt_pose_c2w, device=dev))
        align_ok = torch.ones((), dtype=torch.bool, device=dev)
        inliers = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        with record_function("icp"):
            c2w_est, align_ok, inliers = _pose_estimate(state, vmaps_curr, nmaps_curr, config, intr)
        # frame 0 keeps the identity pose; a failed alignment keeps the
        # previous pose and skips integration (ProcessFrame:150-154)
        c2w_prev = se3.inverse(state.world2camera)
        if config.min_inlier_fraction > 0:
            npix = intr.height * intr.width
            align_ok = align_ok & (inliers >= int(config.min_inlier_fraction * npix))
        if config.max_translation_per_frame > 0:
            delta = torch.linalg.norm(c2w_est.v[:3, 3] - c2w_prev.v[:3, 3])
            align_ok = align_ok & (delta <= config.max_translation_per_frame)
        if is_first:
            c2w = c2w_prev
            align_ok = torch.ones_like(align_ok)
        else:
            c2w = CSFD(
                torch.where(align_ok, c2w_est.v, c2w_prev.v),
                torch.where(align_ok, c2w_est.g, c2w_prev.g),
            )

    w2c = se3.inverse(c2w)

    # --- IntegrateFrame (KinectFusionReconstruction.cpp:237-278) ----------
    c2v = se3.matmul(world2volume, c2w)
    v2c = se3.inverse(c2v)
    # the frame's one host read: JAX's lax.cond on the same flag
    if is_first or bool(align_ok):
        with record_function("fusion"):
            fusion.integrate(
                state.volume, fusion.scale_depth(depth_u16), se3.rotation(v2c), se3.translation(v2c),
                intr, vol_cfg, bi_threshold=config.bi_interpolate_threshold,
            )
    volume = state.volume

    # --- model maps for the next frame's ICP ------------------------------
    with record_function("raycast"):
        v2w = se3.inverse(world2volume)
        vmap0, nmap0 = raycast.raycast(
            volume, se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w),
            intr, vol_cfg, normals_mode=config.raycast_normals, march_mode=config.raycast_march,
            packed_taps=config.raycast_packed_taps,
        )
        vmaps_prev = [vmap0]
        nmaps_prev = [nmap0]
        for _ in range(1, levels):
            vmaps_prev.append(
                CSFD(preprocess.resize_vmap(vmaps_prev[-1].v), preprocess.resize_vmap(vmaps_prev[-1].g))
            )
            nmaps_prev.append(_resize_nmap_dual(nmaps_prev[-1]))

    new_state = SlamState(
        volume=volume,
        world2camera=w2c,
        vmaps_prev=tuple(vmaps_prev),
        nmaps_prev=tuple(nmaps_prev),
        frame_idx=state.frame_idx + config.frame_step,
        last_align_ok=align_ok,
        t_prev=state.t_prev,
    )
    return new_state, FrameResult(
        camera2world=c2w, align_ok=align_ok, inlier_count=inliers,
        fusion_overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def _resize_nmap_dual(n: CSFD) -> CSFD:
    """Dual-aware normal-map downsample: average then renormalize, chaining
    the derivative through the normalization (resizeMapKernel<true>)."""
    H, W = n.v.shape[-2:]
    oh, ow = H // 2, W // 2
    q_v = n.v[:, : oh * 2, : ow * 2].reshape(3, oh, 2, ow, 2)
    q_g = n.g[:, : oh * 2, : ow * 2].reshape(3, oh, 2, ow, 2)
    avg = CSFD(torch.mean(q_v, dim=(2, 4)), torch.mean(q_g, dim=(2, 4)))
    any_nan = torch.any(torch.any(torch.isnan(q_v[0]), dim=3), dim=1)[None]
    safe = CSFD(torch.where(any_nan, 1.0, avg.v), torch.where(any_nan, 0.0, avg.g))
    normed = vec3.normalized(safe)
    return CSFD(torch.where(any_nan, torch.nan, normed.v), torch.where(any_nan, 0.0, normed.g))
