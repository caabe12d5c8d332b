"""YAML run configuration.

Mirrors the key set consumed by ``KinectFusionReconstruction::SetYamlParameters``
(``KinectFusionReconstruction.cpp:9-73``) and the L5 driver
(``Experiments/test_xkinect_fusion/main.cpp:26-33``); canonical values in
``Experiments/test_xkinect_fusion/configs/ICL_traj2.yaml``.

Own copy of ``xslam_tpu/io/config.py``: the port imports nothing of
``xslam_tpu``, whose package imports load JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass
class SlamConfig:
    # dataset (ICL_traj2.yaml:1-9)
    dataset_format: str = "synthetic"
    dataset_dir: str = ""
    output_dir: str = "output/"
    start_frame: int = 0
    end_frame: int = 300
    frame_step: int = 1
    factor: int = 1
    is_flip: bool = False

    # output toggles (ICL_traj2.yaml:11-14)
    log_slam_pose: bool = True
    log_gt_pose: bool = True
    draw_pcd: bool = False

    # fusion knobs (ICL_traj2.yaml:16-18)
    bi_interpolate_threshold: float = 0.0
    trunc_logistic_k: float = 0.0
    use_gt_pose: bool = False

    # TSDF volume (ICL_traj2.yaml:21-27)
    tsdf_size: Tuple[int, int, int] = (256, 256, 256)
    voxel_size: float = 0.03
    max_integration_weight: int = 100
    thres_range: float = 3.0

    # world->volume placement (ICL_traj2.yaml:28-34)
    init_xyz: Tuple[float, float, float] = (3.2, 3.2, 3.2)
    init_rpy_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # camera (ICL_traj2.yaml:35-41)
    depth_width: int = 640
    depth_height: int = 480
    fx: float = 481.20
    fy: float = -480.00
    cx: float = 319.50
    cy: float = 239.50

    # model-map normal source: "tsdf" = trilinear TSDF central differences
    # (reference behaviour, RayCaster.cu:272-297); "screen" = vertex-map
    # cross products (gather-free TPU fast path, same formula as Map.cu's
    # current-frame normals)
    raycast_normals: str = "tsdf"

    # ray-march strategy: "fixed" = fixed-trip lockstep (reference
    # semantics, RayCaster.cu:236); "skip" = brick-distance-field
    # empty-space skipping with dynamic trip count (identical events,
    # fewer volume reads); "hier" = half-res anchor march + windowed
    # full-res repair (approximate, see ops/raycast.py::march_hier);
    # "hier_skip" = hier with a skip-march coarse pass (identical anchors
    # to "hier", fewer coarse reads); "hier2" = two-level hierarchy
    # (quarter-res march -> half-res repair -> windowed full-res repair);
    # "temporal" (brick layout only) = window repair anchored at the
    # PREVIOUS frame's hit map — no coarse march at all; an on-device cond
    # falls back to the full hier2_skip march whenever anchor coverage
    # drops below raycast_temporal_min_coverage (bootstrap frame,
    # post-relocalization jump), so the mode is self-healing
    raycast_march: str = "fixed"
    # repair-window length (march steps) for the hier modes (the finest
    # level in "hier2"; its mid level uses march_hier's default of 12)
    raycast_hier_window: int = 12
    # temporal-march knobs: window length (march steps) around the
    # depth/prev-hit anchor, and the finite-anchor fraction below which the
    # frame refreshes with a full hier2_skip march instead. Window 8 is
    # -2.6 ms/frame at identical ATE on the clean bench but FAILS the
    # realistic 300-frame run's noisy tail (10.2 mm, 6 rejected frames vs
    # 7.25 mm / 0 at window 12 — BASELINE.md round 4): during frozen-pose
    # stretches the depth anchors track the TRUE camera while the rays use
    # the frozen pose, and the widening mismatch needs the window-12
    # margin to keep the model maps alive until ICP re-acquires. 12 is the
    # validated default; 8 is a clean-sequence speed opt-in.
    raycast_temporal_window: int = 12
    raycast_temporal_min_coverage: float = 0.5
    # two-phase temporal repair (ops/raycast.py::march_temporal_compact):
    # phase1 > 0 runs that many lockstep steps for every ray, compacts the
    # not-done survivors (capacity raycast_temporal_cap_frac * rays) for
    # the remaining window, and finishes stragglers with an exact
    # full-width sweep — EVENT-OUTCOME-IDENTICAL to the plain window
    # repair for every scene (the march_skip_compact discipline) at ~half
    # the march gathers: 99.94% of bench events land in the first 4 steps
    # (round-5 measurement). 0 = plain single-phase repair.
    raycast_temporal_phase1: int = 0
    raycast_temporal_cap_frac: float = 0.16
    # skip-field cell edge (voxels) for the brick-layout skip march: 8 =
    # per-brick distances; 4 = 4^3 sub-brick distances — the fine-step band
    # around surfaces halves with IDENTICAL events (ops/bricks.py, event-
    # exactness argument above skip_rows4; equivalence-tested)
    raycast_skip_gran: int = 8
    # survivor-compacted skip march (ops/raycast.py::march_skip_compact):
    # identical events, gathers only for not-yet-finished rays in later
    # phases instead of lockstep-to-the-slowest-ray; equivalence-tested
    raycast_compact: bool = False
    # fetch refinement trilinear taps from a pack_vg_z9 row table (4 row
    # gathers per dual trilinear instead of 16 scalar gathers,
    # bit-identical). Measured NET LOSS on TPU v5e at 256^3 (BASELINE.md):
    # the (NB*64, 18) table's narrow minor dim is lane-padded to 128, making
    # the per-frame build ~13.5 ms, and an 18-float row gather costs ~32 ns
    # vs 9.4 ns scalar, so 4 rows barely beat 16 scalars. Off by default;
    # kept as a verified opt-in for topologies with cheap row gathers.
    raycast_packed_taps: bool = False
    # fetch each refinement trilinear tap's (value, grad) as ONE 2-wide row
    # gather from an interleave_vg pair table (8 gather issues per dual
    # trilinear instead of 16; bit-identical; table build is one lane
    # interleave, ~1 ms at 256^3). Narrow row gathers cost the same as
    # scalar gathers on v5e (apps/probe_gather_chain.py: 2/4/8-wide all
    # ~6.7-7.2 ns). Takes precedence over raycast_packed_taps. Measured
    # win on the canonical bench (TPU v5e, BASELINE.md round 3): 92.2 ->
    # 88.3 ms/frame, identical ATE class -> default ON (brick layout only;
    # bit-identical, tests/test_bricks.py::
    # test_raycast_bricks_pair_taps_bit_identical).
    raycast_pair_taps: bool = True
    # refinement strategy after the march finds a bracketing crossing:
    # "secant2" = two exact dual trilinears (ft, ftdt) + dual secant
    # (reference semantics, RayCaster.cu:245-261, bit-faithful
    # derivatives); "reuse" = secant on the march's OWN bracketing samples
    # + ONE exact dual trilinear as a Newton polish (half the refinement
    # gathers; first-order-consistent derivative slope — see
    # ops/raycast.py::refine_from_samples). "reuse" requires
    # raycast_march='temporal' + raycast_normals='screen'; approximation
    # class, validated like the hier/temporal marches.
    raycast_refine: str = "secant2"
    # fetch each refinement trilinear cell's (z, z+1) tap pair of BOTH
    # planes as ONE 4-wide row gather from an interleave_vg4 quad table
    # (4 gather issues per dual trilinear — half of pair taps' 8;
    # bit-identical, tests/test_bricks.py). The z+1 lane pairing exploits
    # the bz-fastest brick-row order (ops/raycast_bricks.py::
    # interleave_vg4), so the build is roll+concat+interleave, no
    # neighbour stitching. Takes precedence over raycast_pair_taps.
    raycast_quad_taps: bool = False

    # volume storage layout: "dense" = (X, Y, Z) arrays (reference
    # semantics, TsdfVolume.cpp:17-20); "brick" = persistent (NB, 512)
    # brick-major rows (bit-equivalent storage; kills the per-frame
    # dense<->brick transposes and the packed-tap rebuild — ~85 ms/frame
    # measured on v5e, apps/probe_layout.py). "brick" requires
    # fusion_mode="brick" and a brick-capable raycast_march.
    volume_layout: str = "dense"

    # resolution of the raycast model maps: model maps are rendered at
    # pyramid level N (0 = full depth resolution, the reference behaviour;
    # 1 = half). ICP level l then associates against model level l at the
    # shifted intrinsics — 4x fewer raycast/refine gathers at N=1, within
    # the tracking-accuracy envelope (tests/test_bricks.py)
    model_map_level: int = 0

    # fusion strategy: "dense" = per-voxel depth sampling (reference
    # semantics); "brick" = conservative brick culling (bit-equivalent,
    # depth gathers bounded by fusion_brick_cap * 512)
    fusion_mode: str = "dense"
    fusion_brick_cap: int = 8192
    # classify fusion bricks from 4^3-subcell interval tests (tighter
    # ACTIVE set, ~8x the classification arithmetic — see
    # ops/fusion_brick.py::classify_bricks_fine). Off: per-brick tests.
    fusion_classify_fine: bool = False
    # footprint-SPLIT classification (ops/fusion_brick.py::
    # classify_bricks_full): run the far/none interval tests per
    # 2x2-window cell so depth/lambda intervals decouple across
    # discontinuities, and emit the MIXED class (4) whose rows take the
    # elementwise far update under a per-voxel window-cell bit mask —
    # strictly conservative, bit-equality-tested against dense fusion,
    # pure VPU cost. Shrinks the ACTIVE set (= the depth-gather bill,
    # cap*512) beyond the round-4 classifier. classify_fine takes
    # precedence when both are set.
    fusion_classify_split: bool = False
    # two-stage SUBCELL fusion (ops/fusion_brick.py::_integrate_rows_core):
    # > 0 re-classifies the compacted ACTIVE candidates at 4^3-subcell
    # granularity and issues depth gathers ONLY for ACTIVE subcells
    # (8 per-subcell-id compacted lists of this capacity each; far/none
    # subcells resolve elementwise on the gathered rows). Depth-gather
    # bill: 8*cap*64 + classification fetches instead of
    # fusion_brick_cap*512. Bit-equality-tested; list overflow folds into
    # the fusion_overflow flag (the dense rerun disables subcell). 0 = off.
    fusion_subcell_cap: int = 0
    # what to do when a frame's ACTIVE bricks exceed fusion_brick_cap:
    # "flag" = report it in FrameResult.fusion_overflow (callers decide);
    # "dense" = automatically re-integrate the frame with the exact dense
    # path inside the same jit (no update is ever lost, costs compile size)
    fusion_overflow: str = "flag"

    # ICP (ICL_traj2.yaml:43-46; iterations {5,4,3} hard-coded in
    # KinectFusionReconstruction.cpp:54)
    num_levels: int = 3
    icp_iterations: Tuple[int, ...] = (5, 4, 3)
    # re-run the projective association every iteration (reference
    # behaviour) or once per pyramid level (fixed-correspondence GN inner
    # steps — gather-free iterations, ~3x fewer ICP gathers)
    icp_fixed_assoc: bool = False
    # Levenberg-style diagonal damping for the 6x6 ICP solves (0 = pure
    # Gauss-Newton, the reference's actual behaviour; its use_LM flag is
    # accepted but ignored, KinectFusionReconstruction.cpp:161-175)
    icp_damping: float = 0.0
    dist_thres: float = 0.10
    angle_thres_deg: float = 15.0
    # pose-delta sanity gate: reject a frame's alignment (keep previous
    # pose, skip integration — same semantics as the det/NaN guard,
    # KinectFusionReconstruction.cpp:203-210) when the estimated per-frame
    # motion exceeds this translation (m). 0 disables (reference parity:
    # the reference has no such guard and will integrate a wild solve).
    # Rationale: on the realistic 300-frame run ONE unrejected bad solve
    # (286 mm apparent motion in 33 ms — 8.6 m/s, physically implausible
    # for a handheld sensor) doubled the trajectory ATE; a generous cap
    # turns such solves into ordinary rejected frames the next frame
    # recovers from.
    max_translation_per_frame: float = 0.0
    # minimum fraction of model-map pixels that must survive the projective
    # association gates (distThres/angleThres) in the final ICP iteration
    # for the frame to count as aligned. 0 disables (reference parity: the
    # reference accepts any well-conditioned solve regardless of support,
    # KinectFusionReconstruction.cpp:203-210). Catches degenerate spins on
    # near-empty associations — the failure mode sensor blackouts induce.
    min_inlier_fraction: float = 0.0

    # tracking-loss recovery (models/recovery.py::RecoveringEngine): after
    # this many consecutive align failures, relocalize with the DCSFD
    # Newton optimizer from the frozen pose and re-enter the frame at the
    # recovered pose. 0 disables (plain-engine behaviour: the reference
    # only freezes the pose, ProcessFrame, KinectFusionReconstruction.cpp:
    # 150-154 — its relocalization kernels exist but are never driven,
    # .cpp:374-436)
    reloc_after_failures: int = 0
    reloc_iters: int = 8
    # minimum valid-voxel support for accepting a relocalization (rejects
    # dropout/garbage frames whose loss is trivially small)
    reloc_min_count: float = 500.0
    # keyframe selection gates (m / degrees) for the keyframe log that
    # feeds pose-graph refinement (models/recovery.py, models/ba.py)
    keyframe_dist: float = 0.15
    keyframe_angle_deg: float = 10.0
    # loop-closure DETECTION (models/recovery.py::_detect_loops): on every
    # new keyframe, earlier keyframes >= loop_min_gap back whose pose lies
    # within loop_proximity (m) / loop_max_angle_deg are revisit
    # candidates; each is verified by a host-side depth-overlap
    # point-to-plane ICP check and accepted as a loop edge when the final
    # inlier fraction / plane-residual RMS pass. Off by default (the
    # reference has no backend at all); enabled by the backend configs.
    loop_detect: bool = False
    loop_min_gap: int = 8
    loop_proximity: float = 0.45
    loop_max_angle_deg: float = 40.0
    loop_min_inlier_frac: float = 0.45
    loop_max_rms: float = 0.05

    @property
    def trunc_dist(self) -> float:
        # TsdfVolume.cpp:35-38: max(thres_range * voxel, 2.1 * voxel)
        return max(self.thres_range * self.voxel_size, 2.1 * self.voxel_size)

    @property
    def angle_thres_sine(self) -> float:
        # stored as sin(angle) (KinectFusionReconstruction.cpp:58)
        return math.sin(math.radians(self.angle_thres_deg))

    @property
    def intrinsics(self):
        from ..geometry.intrinsics import Intrinsics

        return Intrinsics(self.fx, self.fy, self.cx, self.cy, self.depth_width, self.depth_height)

    @property
    def world2volume(self):
        """World->volume transform from init offsets/rotation
        (KinectFusionReconstruction.cpp:26-38)."""
        import numpy as np

        rx, ry, rz = (math.radians(a) for a in self.init_rpy_deg)

        def rot(axis, th):
            c, s = math.cos(th), math.sin(th)
            m = np.eye(3)
            if axis == 0:
                m[1:, 1:] = [[c, -s], [s, c]]
            elif axis == 1:
                m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
            else:
                m[:2, :2] = [[c, -s], [s, c]]
            return m

        T = np.eye(4)
        T[:3, :3] = rot(0, rx) @ rot(1, ry) @ rot(2, rz)
        T[:3, 3] = self.init_xyz
        return T


_KEY_MAP = {
    "tsdf_size_x": ("tsdf_size", 0),
    "tsdf_size_y": ("tsdf_size", 1),
    "tsdf_size_z": ("tsdf_size", 2),
    "tsdf_voxel_size": "voxel_size",
    "init_x": ("init_xyz", 0),
    "init_y": ("init_xyz", 1),
    "init_z": ("init_xyz", 2),
    "r_x": ("init_rpy_deg", 0),
    "r_y": ("init_rpy_deg", 1),
    "r_z": ("init_rpy_deg", 2),
    "distThres": "dist_thres",
    "angleThres": "angle_thres_deg",
    "biInterpolate_threshold": "bi_interpolate_threshold",
    "flag_use_gtPose": "use_gt_pose",
}


def load_config(path: str) -> SlamConfig:
    """Load a reference-style YAML config (same keys as ICL_traj2.yaml)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = SlamConfig()
    tuples: dict[str, list] = {}
    for key, val in raw.items():
        tgt = _KEY_MAP.get(key, key)
        if isinstance(tgt, tuple):
            name, idx = tgt
            tuples.setdefault(name, list(getattr(cfg, name)))[idx] = val
        elif hasattr(cfg, tgt):
            setattr(cfg, tgt, type(getattr(cfg, tgt))(val))
    for name, vals in tuples.items():
        setattr(cfg, name, tuple(vals))
    cfg.icp_iterations = tuple((5, 4, 3)[: cfg.num_levels])
    return cfg
