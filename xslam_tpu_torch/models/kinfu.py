"""The KinectFusion-style differentiable SLAM engine.

Port of ``xslam_tpu/models/kinfu.py`` in two configurations. The dense volume
(every march of ``raycast.MARCH_MODES``: ``fixed``, ``skip``, ``hier``,
``hier_skip``, ``hier2``; the ``secant2`` refine; TSDF or screen normals),
with dense or brick fusion (``fusion_mode``; ``fusion_overflow`` ``"flag"``
or ``"dense"``; the coarse brick classifier, or the opt-in
``fusion_classify_split``, ``fusion_classify_fine`` and
``fusion_subcell_cap > 0``, alone or combined: B15). And the brick-major volume
(``volume_layout="brick"``, :mod:`xslam_tpu_torch.ops.bricks`) with brick
fusion and every raycast of the JAX engine's brick layout
(:mod:`xslam_tpu_torch.ops.raycast_bricks`): the marches as
:data:`BRICK_MARCHES` maps them (``skip``, ``hier_skip``, ``hier2_skip``, and
``temporal`` with its ``hier2`` refresh and, with
``raycast_temporal_phase1 > 0``, its first-event march), the ``secant2`` or
(temporal) ``reuse`` refine, TSDF or screen normals; ``bench.py``'s is the
temporal march with ``reuse`` and screen normals. Both
take the model maps at any ``model_map_level``, nearest or bilinear depth
sampling in fusion (``bi_interpolate_threshold``), and the ICP association
computed every iteration or once per level (``icp_fixed_assoc``).
:meth:`XSlamEngine.process_frames` runs a stack of frames, a loop of
:meth:`XSlamEngine.process_frame`. Each frame runs:

1. bilateral filter (kernel K1), the depth pyramid (K7, one launch for its
   coarser levels), vertex and normal maps of every level (K8, one launch);
2. coarse-to-fine ICP, levels 2 -> 1 -> 0 with {5, 4, 3} iterations, as a
   Python loop whose pose and ``ok`` flag stay on the device; each iteration
   (normal equations, 6x6 dual solve, pose update) is one launch of kernel
   K4, with no other device work between the launches;
3. TSDF fusion when the frame aligned, in place: kernel K2, or with
   ``fusion_mode="brick"`` the mip table (B3a), the bricks' classes (B3b; the
   split classifier B15s, the fine one B15f), with ``fusion_subcell_cap > 0``
   the subcells' classes and lists (B15c), and the brick pass (B3c, or its
   MIXED or subcell variant), which give K2's volume bit for bit with the
   nearest depth (on the brick layout in its rows, B3c's row variant); with
   ``bi_interpolate_threshold > 0`` K2 and B3c take the bilinear branch, B11;
4. raycast of the model maps (the poses packed once; the march: K3, or the
   dense layout's B14 kernels, :func:`xslam_tpu_torch.ops.raycast.raycast`;
   refine kernel K5; on the brick layout the anchored window march with the
   refine B4 (B16 with ``raycast_temporal_phase1 > 0``), or on a refresh
   frame the skip field B5a, the skip march B5b and B4 twice; the other
   brick marches B5a, B5b and B4, then the ``secant2`` refine K5r) and their
   pyramid (K6, one launch for all coarser levels;
   with screen normals the same launch computes level 0's normals, B4n).

On CPU tensors every wrapper runs its plain PyTorch version instead.

The four stages are profiler ranges (``preprocess``, ``icp``, ``fusion``,
``raycast``), which :mod:`xslam_tpu_torch.profile_step` reads.

The frame reads back to the host once, in one copy: whether to integrate (the
JAX engine's ``lax.cond``), so a rejected frame skips the fusion pass instead
of selecting between two copies of the 201 MB volume, and on the temporal
march whether the anchors cover enough of the image (the reference's other
``lax.cond``). The anchors depend only on the preprocessed frame and the last
raycast, so their coverage is computed before ICP.
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
from ..io.ply import export_ply
from ..ops import bricks, fusion, icp, kernels, preprocess, raycast, raycast_bricks


class SlamState(NamedTuple):
    """Engine state. The volume is updated in place by fusion."""

    volume: fusion.VolumeState  # or a bricks.BrickVolume with volume_layout="brick"
    world2camera: CSFD  # (4, 4) dual
    # model-map pyramid from raycasting (dual, world coords)
    vmaps_prev: Tuple[CSFD, ...]
    nmaps_prev: Tuple[CSFD, ...]
    frame_idx: int  # host counter: no device read to test for frame 0
    last_align_ok: torch.Tensor  # bool scalar
    # model-resolution hit distances of the last raycast, the temporal march's fallback anchors: 1e9
    # (finite) where a ray found nothing; carried untouched by the dense layout
    t_prev: torch.Tensor


class FrameResult(NamedTuple):
    camera2world: CSFD  # (4, 4) dual pose estimate of this frame
    align_ok: torch.Tensor
    inlier_count: torch.Tensor
    # brick fusion's ACTIVE list (or with fusion_subcell_cap > 0 a subcell list)
    # overflowed this frame (always False for dense fusion and for
    # fusion_overflow="dense", which fuses such a frame exactly)
    fusion_overflow: torch.Tensor
    # brick fusion's ACTIVE bricks this frame (int32; None for dense fusion
    # and for a frame that was not fused)
    fusion_active: Optional[torch.Tensor] = None
    # the temporal march's share of finite anchors this frame (float32; None off the temporal march): below
    # raycast_temporal_min_coverage the frame took the hier2 refresh
    anchor_coverage: Optional[torch.Tensor] = None


# the values of each option that select paths this port has; the others raise. Not listed: the fusion classifiers
# and the subcell stage (fusion_classify_fine, fusion_classify_split, fusion_subcell_cap), ported whole; and, as
# they change no result, raycast_pair_taps, raycast_packed_taps and raycast_quad_taps (the port's taps give their bits:
# ops/raycast_bricks.py::raycast_bricks_rays, ops/raycast.py::raycast), raycast_skip_gran (4 or 8: the same
# events), raycast_compact (the same events) and raycast_temporal_cap_frac (read with raycast_temporal_phase1 > 0,
# a schedule of the JAX march that changes no event)
_SLICE = {
    "volume_layout": ("dense", "brick"),
    "fusion_mode": ("dense", "brick"),
    "fusion_overflow": fusion.OVERFLOW_MODES,
}
# the brick layout's marches as the JAX engine maps them (xslam_tpu/models/kinfu.py:470-476): fixed and skip are
# event-identical, the hier modes take the skip-anchored hierarchical marches
BRICK_MARCHES = {"fixed": "skip", "skip": "skip", "hier": "hier_skip", "hier_skip": "hier_skip",
                 "hier2": "hier2_skip", "hier2_skip": "hier2_skip", "temporal": "temporal"}
# the raycasts of each volume layout: (marches, refines, normals); the JAX engine accepts these
_RAYCAST = {"dense": (raycast.MARCH_MODES, ("secant2",), ("tsdf", "screen")),
            "brick": (tuple(BRICK_MARCHES), raycast_bricks.REFINE_MODES, ("tsdf", "screen"))}


def _check_config(config: SlamConfig) -> None:
    """The JAX engine's checks (ValueError), then the port's slice
    (NotImplementedError for a combination the port has no path for)."""
    if config.volume_layout == "brick" and config.fusion_mode != "brick":
        raise ValueError("volume_layout='brick' requires fusion_mode='brick'")
    if config.raycast_march == "temporal" and config.volume_layout != "brick":
        raise ValueError("raycast_march='temporal' requires volume_layout='brick'")
    if config.raycast_refine == "reuse" and (config.raycast_march != "temporal" or config.raycast_normals != "screen"):
        raise ValueError("raycast_refine='reuse' requires raycast_march='temporal' and raycast_normals='screen'")
    for key, allowed in _SLICE.items():
        if getattr(config, key) not in allowed:
            raise NotImplementedError(f"{key}={getattr(config, key)!r} is not ported yet (only {allowed!r})")
    if config.raycast_march not in _RAYCAST[config.volume_layout][0]:
        raise ValueError(f"unknown raycast march_mode {config.raycast_march!r}; expected one of "
                         f"{_RAYCAST[config.volume_layout][0]}")  # the JAX raycasts' own checks
    if config.volume_layout == "brick" and config.raycast_skip_gran not in (4, 8):
        raise ValueError(f"skip_gran must be 4 or 8, got {config.raycast_skip_gran}")
    chosen = (config.raycast_march, config.raycast_refine, config.raycast_normals)
    if not all(c in allowed for c, allowed in zip(chosen, _RAYCAST[config.volume_layout])):
        raise NotImplementedError(f"the {config.volume_layout} layout's raycast is ported as (marches, refines, "
                                  f"normals) = {_RAYCAST[config.volume_layout]}, not {chosen}")


def _device(device, owner: str = "XSlamEngine") -> torch.device:
    """``None`` means the card; CUDA must exist then — no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}: CUDA is not available (pass device='cpu' to run on the CPU)")
    return dev


class XSlamEngine:
    """Host driver: owns the config and the per-frame step, mirrors the public
    API of ``KinectFusionReconstruction`` (SetYamlParameters/ProcessFrame)."""

    def __init__(self, config: SlamConfig, device=None):
        _check_config(config)
        self.config = config
        self.device = _device(device)
        # the device a tensor made on self.device reports (cuda:N for "cuda")
        self._placed = torch.empty(0, device=self.device).device
        self.intr = config.intrinsics
        self.vol_cfg = fusion.VolumeConfig(
            resolution=tuple(config.tsdf_size),
            voxel_size=config.voxel_size,
            trunc_dist=config.trunc_dist,
            max_weight=config.max_integration_weight,
        )
        self.world2volume = lift(torch.as_tensor(np.asarray(config.world2volume, np.float32), device=self.device))
        self.volume2world = se3.inverse(self.world2volume)  # constant: inverted once, not every frame
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
        L = self.config.model_map_level
        brick = self.config.volume_layout == "brick"
        return SlamState(
            volume=bricks.create(self.vol_cfg, dev) if brick else fusion.create_volume(self.vol_cfg, dev),
            world2camera=lift(torch.eye(4, dtype=torch.float32, device=dev)),
            vmaps_prev=tuple(nan_map(H >> (i + L), W >> (i + L)) for i in range(levels)),
            nmaps_prev=tuple(nan_map(H >> (i + L), W >> (i + L)) for i in range(levels)),
            frame_idx=0,
            last_align_ok=torch.ones((), dtype=torch.bool, device=dev),
            t_prev=torch.full((H >> L, W >> L), torch.inf, dtype=torch.float32, device=dev),
        )

    def process_frame(
        self, state: SlamState, depth_u16, gt_pose: Optional[np.ndarray] = None
    ) -> Tuple[SlamState, FrameResult]:
        """Track + fuse one frame (``ProcessFrame``,
        KinectFusionReconstruction.cpp:147-159). ``gt_pose`` (c2w) is used
        when the config sets ``use_gt_pose``. The volume of ``state`` is
        updated in place and shared with the returned state.

        ``depth_u16`` (H, W) in mm: a host array, uploaded here, or a uint16
        tensor already on the engine's device, taken as it is (no host round
        trip); a tensor of another type or on another device raises."""
        gt = np.eye(4, dtype=np.float32) if gt_pose is None else np.asarray(gt_pose, np.float32)
        return process_frame(
            state, self._depth(depth_u16), gt, config=self.config, intr=self.intr, vol_cfg=self.vol_cfg,
            world2volume=self.world2volume, volume2world=self.volume2world,
        )

    def _depth(self, depth_u16) -> torch.Tensor:
        """A frame's depth on the engine's device: a host array uploaded, or a
        uint16 tensor already there taken as it is; any other tensor raises."""
        if isinstance(depth_u16, torch.Tensor):
            if depth_u16.dtype != torch.uint16 or depth_u16.device != self._placed:
                raise ValueError(f"depth: expected a uint16 tensor on {self._placed}, got {depth_u16.dtype} on "
                                 f"{depth_u16.device}")
            return depth_u16
        return torch.as_tensor(np.asarray(depth_u16, np.uint16)).to(self.device)

    def process_frames(self, state: SlamState, depths_u16, gt_poses: Optional[np.ndarray] = None,
                       unroll: bool = False) -> Tuple[SlamState, FrameResult]:
        """Track and fuse a (K, H, W) stack of frames (``xslam_tpu/models/
        kinfu.py::process_frames``): the per-frame step over the stack with
        the state carried, here a loop of :meth:`process_frame`, so its
        results are K calls' bit for bit. ``depths_u16`` as
        :meth:`process_frame` takes a frame: a host array, or a uint16 tensor
        on the engine's device; ``gt_poses`` (K, 4, 4) c2w where the config
        sets ``use_gt_pose``. ``unroll`` is the JAX signature's (its
        ``lax.scan`` unrolled) and changes nothing here: PyTorch runs eagerly,
        so the loop is the same either way. Returns the final state and a
        :class:`FrameResult` with a leading K axis (:func:`stack_results`).
        The volume of ``state`` is updated in place."""
        del unroll
        results = []
        for k in range(len(depths_u16)):
            state, res = self.process_frame(state, depths_u16[k], None if gt_poses is None else gt_poses[k])
            results.append(res)
        return state, stack_results(results)

    def log_pose(self, result: FrameResult):
        self.pose_log.append(result.camera2world.v.cpu().numpy())

    def dense_volume(self, state: SlamState) -> fusion.VolumeState:
        """The volume in the dense (X, Y, Z) layout whatever the engine's
        storage layout (new tensors for the brick layout)."""
        if self.config.volume_layout == "brick":
            return bricks.to_dense(state.volume, self.vol_cfg.resolution)
        return state.volume

    def export_model_maps_ply(self, state: SlamState, path: str, level: int = 0) -> None:
        """Dump the raycast model maps of ``level`` as a point cloud, the
        pixels where neither map is NaN (the debugging helper
        ``generatePrevPC``, KinectFusionReconstruction.cpp:480-508)."""
        _export_maps(path, state.vmaps_prev[level].v, state.nmaps_prev[level].v)

    def export_current_maps_ply(self, depth_u16, path: str, level: int = 0) -> None:
        """The current frame's camera-space maps of ``level`` as a point cloud
        (``generateCurrPC``, KinectFusionReconstruction.cpp:449-478): the
        bilateral filter (K1), ``level`` halvings (K7) and the vertex and
        normal maps at ``intr.level(level)`` (K8), as the JAX engine computes
        them. ``depth_u16`` (H, W) in mm as :meth:`process_frame` takes it: a
        host array or a uint16 tensor on the engine's device."""
        depth = self._depth(depth_u16)
        depths = kernels.depth_pyramid(kernels.bilateral_filter(depth), level + 1)
        vmaps, nmaps = kernels.vertex_normal_pyramid([self.intr.level(level)], [depths[level]])
        _export_maps(path, vmaps[0], nmaps[0])


def _export_maps(path: str, vmap: torch.Tensor, nmap: torch.Tensor) -> None:
    """A (3, H, W) vertex map and its normal map as a point cloud: the pixels
    where neither map's x is NaN, in row-major order."""
    v, n = vmap.cpu().numpy(), nmap.cpu().numpy()
    ok = ~np.isnan(v[0]) & ~np.isnan(n[0])
    export_ply(path, v[:, ok].T, n[:, ok].T)


def stack_results(results) -> FrameResult:
    """K frames' :class:`FrameResult` as one with a leading K axis: the pose
    (K, 4, 4) dual, the flags and counts (K,). ``fusion_active``: None where
    no frame has one (dense fusion), else (K,) int32 with -1 at the frames
    that were not fused; ``anchor_coverage``: None off the temporal march,
    else (K,)."""
    def stacked(name):
        return torch.stack([getattr(r, name) for r in results])

    active = [r.fusion_active for r in results]
    if all(a is None for a in active):
        fusion_active = None
    else:
        dev = results[0].align_ok.device
        fusion_active = torch.stack([torch.full((), -1, dtype=torch.int32, device=dev) if a is None
                                     else a.to(torch.int32) for a in active])
    return FrameResult(
        camera2world=CSFD(torch.stack([r.camera2world.v for r in results]),
                          torch.stack([r.camera2world.g for r in results])),
        align_ok=stacked("align_ok"), inlier_count=stacked("inlier_count"), fusion_overflow=stacked("fusion_overflow"),
        fusion_active=fusion_active,
        anchor_coverage=None if results[0].anchor_coverage is None else stacked("anchor_coverage"),
    )


# --------------------------------------------------------------------------
def _pose_estimate(state: SlamState, vmaps_curr, nmaps_curr, config: SlamConfig, intr: Intrinsics):
    """Coarse-to-fine ICP (``PoseEstimate``,
    KinectFusionReconstruction.cpp:177-235). Returns (c2w_new, ok, inliers).

    On the card the loop is :class:`icp.IcpLoop`: the pose and the model's
    rows are packed once, then every iteration is one launch of kernel K4,
    with nothing between them (with the cached association a level's first
    launch writes the index map as well); the pose, the flag and the inlier
    count are unpacked after the loop. On the CPU each iteration is K4's
    plain version, ``build_system_plain`` and ``icp_step_plain``, and the
    cached association is ``icp.associate_index``'s plain version."""
    c2w_prev = se3.inverse(state.world2camera)
    r_prev = se3.rotation(c2w_prev)
    t_prev = se3.translation(c2w_prev)
    r_prev_inv = se3.rotation(state.world2camera)  # R^-1 = R of world2camera
    # the model maps may be rendered model_map_level pyramid levels coarser
    # than the depth: the association then targets the model map's intrinsics
    L = config.model_map_level
    levels = [
        (level, intr.level(level + L), state.vmaps_prev[level].v.shape[-2:])
        for level in reversed(range(config.num_levels))
    ]

    if kernels.on_cpu(state.world2camera.v, *vmaps_curr):
        r_curr, t_curr = r_prev, t_prev
        ok = torch.ones((), dtype=torch.bool)
        inliers = None
        for level, model_intr, prev_shape in levels:
            level_assoc = None
            if config.icp_fixed_assoc:
                level_assoc = icp.associate_index(
                    r_curr, t_curr, vmaps_curr[level], r_prev_inv, t_prev, model_intr, prev_shape
                )
            for _ in range(config.icp_iterations[level]):
                step = icp.icp_step(
                    r_curr, t_curr, vmaps_curr[level], nmaps_curr[level], r_prev_inv, t_prev,
                    model_intr, state.vmaps_prev[level], state.nmaps_prev[level],
                    config.dist_thres, config.angle_thres_sine, config.icp_damping, assoc=level_assoc,
                )
                r_curr, t_curr = step.r_curr, step.t_curr
                ok = ok & step.ok
                inliers = step.system.inlier_count
    else:
        rows = {
            level: icp.pack_model_rows(state.vmaps_prev[level], state.nmaps_prev[level]) for level, _, _ in levels
        }
        loop = icp.IcpLoop(icp.pack_pose(r_prev, t_prev, r_prev_inv, t_prev))
        for level, model_intr, prev_shape in levels:
            level_assoc = None
            for i in range(config.icp_iterations[level]):
                # the cached association: the level's first launch starts from the pose it is made at, so it
                # writes the index map as it projects, and the later launches read it
                assoc_out = None
                if config.icp_fixed_assoc and i == 0:
                    assoc_out = torch.empty(vmaps_curr[level].shape[1:], dtype=torch.int32, device=r_prev.v.device)
                loop.iterate(
                    vmaps_curr[level], nmaps_curr[level], rows[level], prev_shape, model_intr,
                    config.dist_thres, config.angle_thres_sine, config.icp_damping, assoc=level_assoc,
                    assoc_out=assoc_out,
                )
                if assoc_out is not None:
                    level_assoc = assoc_out
        step = loop.result()
        r_curr, t_curr, ok, inliers = step.r_curr, step.t_curr, step.ok, step.system.inlier_count
    return se3.from_rotation_translation(r_curr, t_curr), ok, inliers


def process_frame(
    state: SlamState,
    depth_u16: torch.Tensor,
    gt_pose_c2w: np.ndarray,
    *,
    config: SlamConfig,
    intr: Intrinsics,
    vol_cfg: fusion.VolumeConfig,
    world2volume: CSFD,
    volume2world: CSFD,
) -> Tuple[SlamState, FrameResult]:
    """One frame of the engine (:meth:`XSlamEngine.process_frame` with its
    constants passed in): preprocess, ICP, fusion, raycast and the model-map
    pyramid. Where it tracks (not ``use_gt_pose``), on frame 0 and on every
    rejected frame ``c2w`` is ``se3.inverse(state.world2camera)``, whose
    homogeneous corner carries a derivative of 1 (:func:`se3.inverse`), so
    ``c2v = world2volume @ c2w`` then has ``world2volume``'s translation as
    its translation derivative, as in the JAX package."""
    levels = config.num_levels
    dev = depth_u16.device

    # --- SurfaceMeasure (KinectFusionReconstruction.cpp:280-299) ----------
    with record_function("preprocess"):
        depths = kernels.depth_pyramid(kernels.bilateral_filter(depth_u16), levels)
        vmaps_curr, nmaps_curr = kernels.vertex_normal_pyramid([intr.level(i) for i in range(levels)], depths)

    is_first = state.frame_idx == 0
    L = config.model_map_level
    brick = config.volume_layout == "brick"
    temporal = config.raycast_march == "temporal"
    if temporal:
        # anchors: the current depth's surface distance, else the last raycast's hits; their coverage picks
        # the anchored march or the refresh (read with the alignment flag below)
        t_anchor = raycast_bricks.anchor_map(vmaps_curr[L], state.t_prev)
        coverage = raycast_bricks.anchor_coverage(t_anchor)
        covered = coverage >= config.raycast_temporal_min_coverage

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
            npix = (intr.height >> L) * (intr.width >> L)
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
    # the frame's one host read, one copy: JAX's two lax.conds (integrate; anchored march or refresh)
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
            if config.fusion_mode == "brick":
                fuse = fusion.integrate_rows if config.volume_layout == "brick" else fusion.integrate_brick
                flag, n_active = fuse(
                    state.volume, depth_m, r_v2c, t_v2c, intr, vol_cfg, cap=config.fusion_brick_cap,
                    overflow=config.fusion_overflow, bi_threshold=config.bi_interpolate_threshold,
                    classify_fine=config.fusion_classify_fine, classify_split=config.fusion_classify_split,
                    subcell_cap=config.fusion_subcell_cap,
                )
                if config.fusion_overflow == "flag":
                    overflow = flag
            else:
                fusion.integrate(state.volume, depth_m, r_v2c, t_v2c, intr, vol_cfg,
                                 bi_threshold=config.bi_interpolate_threshold)
    volume = state.volume

    # --- model maps for the next frame's ICP ------------------------------
    with record_function("raycast"):
        poses = (se3.rotation(c2v), se3.translation(c2v), se3.rotation(volume2world), se3.translation(volume2world))
        t_prev = state.t_prev  # the dense path carries the anchors untouched
        if brick:
            # every brick march stores its hits as the next frame's fallback anchors, as the JAX engine does
            vmap0, nmap0, t_prev = raycast_bricks.raycast_bricks(
                volume, *poses, intr.level(L), vol_cfg, t_anchor if temporal else None, refresh=refresh,
                normals_mode=config.raycast_normals, march_mode=BRICK_MARCHES[config.raycast_march],
                refine_mode=config.raycast_refine, temporal_window=config.raycast_temporal_window,
                hier_window=config.raycast_hier_window, temporal_phase1=config.raycast_temporal_phase1,
            )
        else:
            # with screen normals nmap0 is None: the pyramid's launch computes them (B4n)
            vmap0, nmap0 = raycast.raycast(
                volume, *poses, intr.level(L), vol_cfg, normals_mode=config.raycast_normals,
                march_mode=config.raycast_march, hier_window=config.raycast_hier_window,
                packed_taps=config.raycast_packed_taps, compact=config.raycast_compact,
            )
        vmaps_prev, nmaps_prev = model_map_pyramid(vmap0, nmap0, levels)

    new_state = SlamState(
        volume=volume,
        world2camera=w2c,
        vmaps_prev=vmaps_prev,
        nmaps_prev=nmaps_prev,
        frame_idx=state.frame_idx + config.frame_step,
        last_align_ok=align_ok,
        t_prev=t_prev,
    )
    return new_state, FrameResult(
        camera2world=c2w, align_ok=align_ok, inlier_count=inliers, fusion_overflow=overflow, fusion_active=n_active,
        anchor_coverage=coverage if temporal else None,
    )


def model_map_pyramid(vmap0: CSFD, nmap0: Optional[CSFD], levels: int) -> Tuple[Tuple[CSFD, ...], Tuple[CSFD, ...]]:
    """Kernel K6 (``csrc/maps.cu``): the model-map pyramid of ``levels``
    levels over level 0's dual (3, H, W) maps ``vmap0``, ``nmap0``, each
    coarser level the 2x2 mean of the one before: ``(vmaps, nmaps)``, one
    dual map a level, level 0 the maps given. With ``nmap0`` None, level 0's
    normals are the screen normals of ``vmap0`` (B4n,
    :func:`raycast.screen_normals_plain`), as the brick layout's raycast
    leaves them. On CPU tensors its plain version: those normals, then
    :func:`resize_model_maps` level after level. On the card, ONE launch for
    every coarser level (and, with ``nmap0`` None, level 0's normals, fed
    from registers into the means), up to ``kernels.MAX_MAP_LEVELS`` levels;
    past them K6 is launched again from the last level made, two more levels
    a launch (each level the mean of the one before, so the first three keep
    their bits); the coarser levels' maps of a launch are views of one buffer
    (``kernels.map_pyramid_views`` with four maps a level: v.v, v.g, n.v,
    n.g), and level 0's given maps stay the tensors given. Both layouts' screen normals
    (``raycast_normals="screen"``) come this way."""
    if levels < 1:
        raise ValueError(f"levels: expected at least 1, got {levels}")
    maps = (vmap0.v, vmap0.g) + (() if nmap0 is None else (nmap0.v, nmap0.g))
    if kernels.on_cpu(*maps):
        if nmap0 is None:
            nmap0 = raycast.screen_normals_plain(vmap0)
        vmaps, nmaps = [vmap0], [nmap0]
        for _ in range(1, levels):
            vmap, nmap = resize_model_maps(vmaps[-1], nmaps[-1])
            vmaps.append(vmap)
            nmaps.append(nmap)
        return tuple(vmaps), tuple(nmaps)
    if levels > kernels.MAX_MAP_LEVELS:
        top = kernels.MAX_MAP_LEVELS
        vmaps, nmaps = model_map_pyramid(vmap0, nmap0, top)
        more_v, more_n = model_map_pyramid(vmaps[-1], nmaps[-1], levels - top + 1)
        return vmaps + more_v[1:], nmaps + more_n[1:]
    if vmap0.v.dim() != 3 or vmap0.v.shape[0] != 3:
        raise ValueError(f"vmap: expected (3, H, W), got {tuple(vmap0.v.shape)}")
    for t, name in zip(maps, ("vmap.v", "vmap.g", "nmap.v", "nmap.g")):
        kernels.check_tensor(t, name, torch.float32, vmap0.v.shape)
    if levels == 1 and nmap0 is not None:
        return (vmap0,), (nmap0,)
    H, W = vmap0.v.shape[-2:]
    shapes = [(H >> level, W >> level) for level in range(1, levels)]
    if shapes and min(min(shape) for shape in shapes) < 1:
        raise ValueError(f"maps of {H}x{W} have no level {levels - 1}")
    offsets, size = kernels.map_pyramid_layout(shapes, 4)
    dev = vmap0.v.device
    buffer = torch.empty(size, dtype=torch.float32, device=dev)
    offsets = [o for level in offsets for o in level]
    if nmap0 is None:
        nmap0 = CSFD(torch.empty_like(vmap0.v), torch.empty_like(vmap0.g))
        kernels.launch("model_map_normals", dev, vmap0.v, vmap0.g, nmap0.v, nmap0.g, buffer, offsets, levels)
        kernels.launch_counts["model_map_normals"] += 1
    else:
        kernels.launch("model_map_pyramid", dev, *maps, buffer, offsets, levels)
        kernels.launch_counts["resize_model_maps"] += 1
    vv, vg, nv, ng = kernels.map_pyramid_views(buffer, shapes, 4)
    return (vmap0,) + tuple(map(CSFD, vv, vg)), (nmap0,) + tuple(map(CSFD, nv, ng))


def resize_model_maps(vmap: CSFD, nmap: CSFD) -> Tuple[CSFD, CSFD]:
    """One level of K6's plain version, on any device: the next coarser
    level of both maps, ``preprocess.resize_vmap`` of the vertex map's value
    and derivative and :func:`_resize_nmap_dual` of the normal map."""
    return CSFD(preprocess.resize_vmap(vmap.v), preprocess.resize_vmap(vmap.g)), _resize_nmap_dual(nmap)


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
