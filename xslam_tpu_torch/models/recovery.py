"""Tracking-loss recovery, keyframing and loop detection on top of the SLAM
engine.

Port of ``xslam_tpu/models/recovery.py``. The reference ships complete DCSFD
relocalization kernels (``ComputeLocalTsdfHessianKernel``,
TsdfFusion.cu:204-331) whose host entry points are commented out
(``KinectFusionReconstruction.cpp:374-436``): its only failure handling is
"freeze the pose and skip integration" (``ProcessFrame``,
KinectFusionReconstruction.cpp:150-154). This module drives the relocalizer
(:mod:`xslam_tpu_torch.models.relocalize`, kernel B12 on the card) from that
failure signal: after ``reloc_after_failures`` consecutive align failures,
a constant-velocity extrapolation and the frozen pose seed a damped-Newton
relocalization against the current TSDF map, and an accepted solution
re-enters the same frame through the normal tracked step.

Keyframes (distance/angle-gated) carry their raw depth. New keyframes are
checked for loops against earlier ones near them in pose, verified by a
host-side projective point-to-plane ICP (:func:`_depth_icp`). At the end
:meth:`RecoveringEngine.refine_trajectory` refines the keyframes with the
pose graph (:func:`~xslam_tpu_torch.models.ba.pose_graph_cg`) and
depth-anchored Schur-CG bundle adjustment (``build_ba_problem`` on the host,
``schur_ba_cg`` on the engine's device), and propagates the refinement to
every frame.

Everything here is host-side orchestration around the engine's step; the
numpy helpers are the JAX package's own code.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..csfd.single import lift
from ..geometry import se3
from ..io.config import SlamConfig
from ..ops import fusion
from .ba import build_ba_problem, pad_problem, pose_graph_cg, schur_ba_cg
from .kinfu import FrameResult, SlamState, XSlamEngine
from .relocalize import relocalize


def _host_depth(depth_u16):
    if depth_u16 is None:
        return None
    if isinstance(depth_u16, torch.Tensor):
        return depth_u16.cpu().numpy()
    return np.asarray(depth_u16)


def _depth_maps(depth_u16, intr, z_range=(0.2, 5.0)):
    """(vertex map, normal map) in camera coords from a u16 depth frame —
    the numpy twin of preprocess.create_vmap/create_nmap (the same
    construction models/ba.py::build_ba_problem uses)."""
    d = np.asarray(depth_u16, np.float32) / 1000.0
    d[(d < z_range[0]) | (d > z_range[1])] = 0.0
    H, W = d.shape
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    vm = np.stack(
        [d * (uu - intr.cx) / intr.fx, d * (vv - intr.cy) / intr.fy, d], axis=-1
    )
    vm[d == 0] = np.nan
    a = np.full_like(vm, np.nan)
    b = np.full_like(vm, np.nan)
    a[:, :-1] = vm[:, 1:] - vm[:, :-1]
    b[:-1, :] = vm[1:, :] - vm[:-1, :]
    n = np.cross(a, b)
    with np.errstate(invalid="ignore"):
        n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return vm, n


def _depth_icp(
    depth_a, depth_b, T0, intr, stride=6, iters=8, match_dist=0.3,
):
    """Host-side projective point-to-plane ICP between two keyframe depth
    frames: refine the relative pose ``T`` (camera b -> camera a, i.e.
    ``c2w_a^-1 c2w_b``) from seed ``T0``. The association/residual scheme
    is the front end's (gated projective association + point-to-plane GN,
    ``ICP.cu:196-259`` semantics) run once per candidate pair on
    subsampled points — the loop-closure VERIFIER, cheap enough to run on
    every revisit candidate. Returns ``(T, inlier_fraction, rms)``; rms is
    the point-to-plane RMS over the final inlier set."""
    vm_a, nm_a = _depth_maps(depth_a, intr)
    vm_b, _ = _depth_maps(depth_b, intr)
    H, W = vm_a.shape[:2]
    pts_b = vm_b[stride // 2::stride, stride // 2::stride].reshape(-1, 3)
    pts_b = pts_b[np.isfinite(pts_b).all(axis=1)]
    if pts_b.shape[0] < 100:
        return T0, 0.0, np.inf
    T = np.asarray(T0, np.float64).copy()
    inlier_frac, rms = 0.0, np.inf
    for _ in range(iters):
        pa = pts_b @ T[:3, :3].T + T[:3, 3]  # b's points in a's camera
        z = pa[:, 2]
        ok = z > 0.2
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.round(pa[:, 0] * intr.fx / z + intr.cx).astype(np.int64)
            v = np.round(pa[:, 1] * intr.fy / z + intr.cy).astype(np.int64)
        ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
        u, v = np.clip(u, 0, W - 1), np.clip(v, 0, H - 1)
        q = vm_a[v, u]
        n = nm_a[v, u]
        ok &= np.isfinite(q).all(axis=1) & np.isfinite(n).all(axis=1)
        d = pa - q
        ok &= np.linalg.norm(d, axis=1) < match_dist
        if ok.sum() < 100:
            return T.astype(np.float32), 0.0, np.inf
        r = np.sum(n[ok] * d[ok], axis=1)  # point-to-plane residual
        p, nn = pa[ok], n[ok]
        J = np.concatenate([np.cross(p, nn), nn], axis=1)  # (M, 6) [w, t]
        Hm = J.T @ J + 1e-8 * np.eye(6)
        g = J.T @ r
        try:
            x = -np.linalg.solve(Hm, g)
        except np.linalg.LinAlgError:
            return T.astype(np.float32), 0.0, np.inf
        w, t = x[:3], x[3:]
        th = np.linalg.norm(w)
        if th > 1e-12:
            k = w / th
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
        else:
            R = np.eye(3)
        Tinc = np.eye(4)
        Tinc[:3, :3] = R
        Tinc[:3, 3] = t
        T = Tinc @ T
        inlier_frac = float(ok.mean())
        rms = float(np.sqrt(np.mean(r * r)))
    return T.astype(np.float32), inlier_frac, rms


class Keyframe(NamedTuple):
    frame_index: int
    camera2world: np.ndarray  # (4, 4)
    # raw sensor depth at the keyframe (u16, engine units) — the live data
    # the depth-anchored BA backend builds its observations from
    # (models/ba.py::build_ba_problem); None for callers that don't keep it
    depth_u16: Optional[np.ndarray] = None


class RecoveryEvent(NamedTuple):
    frame_index: int
    accepted: bool
    mean_loss_before: float
    mean_loss_after: float
    pose_jump_m: float


class RecoveringEngine:
    """Engine wrapper adding keyframe logging, loop detection and
    relocalize-on-tracking-loss.

    Drop-in for the wrapped engine's ``init_state``/``process_frame``
    surface; ``pose_log``/``keyframes``/``recovery_events``/``loop_edges``
    record what happened. Builds ``XSlamEngine(config, device=device)`` when
    no engine is given, so it needs CUDA unless ``device="cpu"``. The
    backend's device work runs on the engine's device.

    Engine-agnostic, as the JAX wrapper is: any engine with ``init_state``,
    ``process_frame`` and ``dense_volume`` works, the sharded
    :class:`~xslam_tpu_torch.parallel.engine.ShardedXSlamEngine` too. There
    every rank runs this host logic on the same values: ``align_ok`` is the
    same on every rank (the ICP systems are summed), ``_recover`` gathers
    the whole volume on every rank at the same frames (``dense_volume``, a
    collective), and ``relocalize`` and ``_depth_icp`` give every rank the
    same decision (B12 sums in a fixed order, with no float atomic), so the
    ranks reach each collective together. ``refine_trajectory`` runs on each
    rank, with the single-device BA.
    """

    def __init__(self, config: SlamConfig, engine=None, device=None):
        self.config = config
        self.engine = engine if engine is not None else XSlamEngine(config, device=device)
        self.device = self.engine.device
        self.intr = self.engine.intr
        self.vol_cfg = self.engine.vol_cfg
        self.pose_log: List[np.ndarray] = []
        self.keyframes: List[Keyframe] = []
        self.recovery_events: List[RecoveryEvent] = []
        # loop-closure factors over keyframe-list indices, fed to
        # refine_keyframes: (i, j, T_i^-1 T_j). An accepted relocalization
        # is an absolute map-frame measurement, recorded as an edge to
        # keyframe 0 (the gauge anchor)
        self.loop_edges: List[Tuple[int, int, np.ndarray]] = []
        self._fail_streak = 0
        self._frame_index = 0
        # constant-velocity motion model: last good (frame_index, c2w) and
        # the last good one-frame relative motion — the relocalization seed
        # for blackout-length outages (the frozen pose alone is beyond the
        # TSDF-loss basin after ~10 frames of sustained handheld motion)
        self._last_good = None
        self._vel = None
        # set by an accepted far-from-frozen relocalization; consumed by the
        # next aligned frame, which closes the loop
        self._pending_loop = False

    def _relocalize(self, value_dense, depth_m, xi0):
        return relocalize(value_dense, depth_m, xi0, self.intr, self.vol_cfg, iters=self.config.reloc_iters)

    # -- keyframing ---------------------------------------------------------
    def _maybe_keyframe(self, c2w: np.ndarray, depth_u16=None):
        if not self.keyframes:
            self.keyframes.append(Keyframe(self._frame_index, c2w, _host_depth(depth_u16)))
            return
        last = self.keyframes[-1].camera2world
        dt = float(np.linalg.norm(c2w[:3, 3] - last[:3, 3]))
        cos = (np.trace(last[:3, :3].T @ c2w[:3, :3]) - 1.0) * 0.5
        ang = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        if dt > self.config.keyframe_dist or ang > self.config.keyframe_angle_deg:
            self.keyframes.append(Keyframe(self._frame_index, c2w, _host_depth(depth_u16)))
            if self.config.loop_detect:
                self._detect_loops()

    # -- loop-closure detection --------------------------------------------
    def _detect_loops(self):
        """Propose revisit candidates by pose-space proximity against the
        newest keyframe and verify each with a depth-overlap projective ICP
        check; verified relative poses are appended to ``self.loop_edges``
        and consumed by :meth:`refine_keyframes` / the Schur-CG backend."""
        k = len(self.keyframes) - 1
        kf = self.keyframes[k]
        if kf.depth_u16 is None:
            return
        cfg = self.config
        ck = kf.camera2world
        cands = []
        for j in range(0, k - cfg.loop_min_gap + 1):
            other = self.keyframes[j]
            if other.depth_u16 is None:
                continue
            dt = float(np.linalg.norm(ck[:3, 3] - other.camera2world[:3, 3]))
            if dt > cfg.loop_proximity:
                continue
            cos = (np.trace(other.camera2world[:3, :3].T @ ck[:3, :3]) - 1.0) * 0.5
            ang = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
            if ang > cfg.loop_max_angle_deg:
                continue
            cands.append((dt, j))
        for _, j in sorted(cands)[:2]:  # closest two candidates
            other = self.keyframes[j]
            T0 = np.linalg.inv(other.camera2world) @ ck
            T, inlier_frac, rms = _depth_icp(
                other.depth_u16, kf.depth_u16, T0, self.intr
            )
            if inlier_frac >= cfg.loop_min_inlier_frac and rms <= cfg.loop_max_rms:
                self.loop_edges.append((j, k, T.astype(np.float32)))

    # -- the drop-in step ---------------------------------------------------
    def init_state(self) -> SlamState:
        return self.engine.init_state()

    def dense_volume(self, state: SlamState):
        return self.engine.dense_volume(state)

    def process_frame(
        self, state: SlamState, depth_u16, gt_pose: Optional[np.ndarray] = None
    ) -> Tuple[SlamState, FrameResult]:
        state, result = self.engine.process_frame(state, depth_u16, gt_pose)
        align_ok = bool(result.align_ok)
        if align_ok:
            self._fail_streak = 0
            c2w_now = result.camera2world.v.cpu().numpy()
            if self._last_good is not None and \
                    self._frame_index - self._last_good[0] == 1:
                self._vel = np.linalg.inv(self._last_good[1]) @ c2w_now
            self._last_good = (self._frame_index, c2w_now)
        else:
            self._fail_streak += 1
            if (
                self.config.reloc_after_failures > 0
                and self._fail_streak >= self.config.reloc_after_failures
            ):
                state, result = self._recover(state, depth_u16, result)

        c2w = result.camera2world.v.cpu().numpy()
        self.pose_log.append(c2w)
        if bool(result.align_ok):
            if self._pending_loop and self.keyframes:
                # first re-acquired tracked pose after an accepted
                # far-from-frozen relocalization: a loop-closure-grade
                # measurement against the map frame — force a keyframe and
                # record the factor against keyframe 0 (the gauge anchor)
                self.keyframes.append(
                    Keyframe(self._frame_index, c2w, _host_depth(depth_u16))
                )
                T0 = self.keyframes[0].camera2world
                self.loop_edges.append(
                    (0, len(self.keyframes) - 1, np.linalg.inv(T0) @ c2w)
                )
                self._pending_loop = False
            else:
                self._maybe_keyframe(c2w, depth_u16)
        self._frame_index += 1
        return state, result

    def _depth_on_device(self, depth_u16) -> torch.Tensor:
        if isinstance(depth_u16, torch.Tensor):
            return depth_u16.to(self.device)
        return torch.as_tensor(np.asarray(depth_u16, np.uint16)).to(self.device)

    def _recover(
        self, state: SlamState, depth_u16, failed: FrameResult
    ) -> Tuple[SlamState, FrameResult]:
        """Relocalize from the seeds, then re-enter the SAME frame through
        the normal tracked step with the relocalized pose as the ICP seed.
        The DCSFD TSDF loss pulls from up to ~trunc_dist/2 of pose error
        (beyond the projective-ICP association gates) down to a few cm / a
        few degrees, and ICP polishes from there. If the re-tracked step
        still fails, the seed itself carries forward, so recovery iterates
        ACROSS frames.

        The failed step left ``state`` untouched apart from the frame
        counter (no integration, pose kept), so re-processing the same depth
        is sound. The re-entry rolls ``frame_idx`` back by one
        ``frame_step`` so one logical frame advances the counter once."""
        w2v = np.asarray(self.config.world2volume, np.float32)
        frozen_c2w = failed.camera2world.v.cpu().numpy()

        # seed candidates: constant-velocity extrapolation from the last
        # good pose, then the frozen pose itself
        seeds = []
        if self._vel is not None and self._last_good is not None:
            k = min(self._frame_index - self._last_good[0], 15)
            cv = self._last_good[1].copy()
            for _ in range(max(k, 0)):
                cv = cv @ self._vel
            seeds.append(cv.astype(np.float32))
        seeds.append(frozen_c2w)

        value_dense = self.engine.dense_volume(state).value
        depth_m = fusion.scale_depth(self._depth_on_device(depth_u16))
        out, best_loss = None, np.inf
        for seed_c2w in seeds:
            xi0 = se3.log_real(w2v @ seed_c2w)
            cand = self._relocalize(value_dense, depth_m, torch.as_tensor(xi0, device=self.device))
            m = cand.loss_history.cpu().numpy()
            ok_cand = (
                np.isfinite(m[-1])
                and float(cand.count) >= self.config.reloc_min_count
            )
            # best FINAL loss among valid candidates wins (a paused camera
            # makes the CV extrapolation overshoot — the frozen seed must
            # be able to beat it, and vice versa for sustained motion)
            if out is None or (ok_cand and m[-1] < best_loss):
                out = cand
                best_loss = m[-1] if ok_cand else best_loss
        means = out.loss_history.cpu().numpy()
        count = float(out.count)
        before, after = float(means[0]), float(means[-1])
        # candidate gate: the Newton iteration must have actually descended
        # on a non-trivial support; a dropout frame (count ~ 0) or a
        # non-converging solve is rejected and the pose stays frozen
        candidate = (
            np.isfinite(after)
            and count >= self.config.reloc_min_count
            and after <= before * 0.97
        )
        c2w_rec = np.linalg.inv(w2v) @ se3.exp_real(out.xi).cpu().numpy()
        jump = float(np.linalg.norm(c2w_rec[:3, 3] - frozen_c2w[:3, 3]))
        if not candidate:
            self.recovery_events.append(
                RecoveryEvent(self._frame_index, False, before, after, jump)
            )
            return state, failed

        # seed the tracked step at the relocalized pose (derivative lane
        # reset) and re-run the frame: integration + model-map raycast
        # happen iff the seeded ICP converges
        w2c = se3.inverse_real(torch.as_tensor(c2w_rec, dtype=torch.float32))
        seeded = state._replace(
            world2camera=lift(w2c.to(self.device)),
            frame_idx=state.frame_idx - self.config.frame_step,
            # the temporal-march anchors were rendered at the frozen pose:
            # invalidate the fallback anchors
            t_prev=torch.full_like(state.t_prev, torch.inf),
        )
        state, result = self.engine.process_frame(seeded, depth_u16)
        ok = bool(result.align_ok)
        self.recovery_events.append(
            RecoveryEvent(self._frame_index, ok, before, after, jump)
        )
        if ok:
            self._fail_streak = 0
        if jump > self.config.keyframe_dist:
            # the relocalized pose is an absolute map-frame measurement:
            # flag a pending loop closure that the next aligned frame — this
            # one if the retrack just succeeded — records against keyframe 0
            self._pending_loop = True
        return state, result

    # -- pose-graph refinement over the keyframe log ------------------------
    def refine_keyframes(
        self,
        loop_edges: Optional[List[Tuple[int, int, np.ndarray]]] = None,
        iters: int = 10,
    ):
        """Pose-graph refinement over the keyframe log.

        Sequential odometry edges ``(k, k+1)`` are measured from the
        engine's own estimates; the recorded loop closures
        (``self.loop_edges``) are always included; ``loop_edges`` are
        optional extra ``(i, j, T_i^-1 T_j)`` constraints (keyframe-list
        indices). Returns the refined (K, 4, 4) camera2world poses
        (keyframe 0 gauge-fixed), solved by the matrix-free
        :func:`~xslam_tpu_torch.models.ba.pose_graph_cg` on the engine's
        device.
        """
        K = len(self.keyframes)
        if K < 2:
            return np.stack([k.camera2world for k in self.keyframes]) if K else np.zeros((0, 4, 4))
        poses = [k.camera2world for k in self.keyframes]
        xi = np.stack([se3.log_real(p) for p in poses]).astype(np.float32)
        edges = [(k, k + 1) for k in range(K - 1)]
        rel = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(K - 1)]
        for (i, j, T) in list(self.loop_edges) + list(loop_edges or []):
            edges.append((i, j))
            rel.append(np.asarray(T, np.float32))
        dev = self.device
        out = pose_graph_cg(
            torch.as_tensor(xi, device=dev),
            torch.as_tensor(np.asarray(edges, np.int32), device=dev),
            torch.as_tensor(np.stack(rel).astype(np.float32), device=dev),
            iters=iters,
        )
        return _exp_poses(out.poses)

    # -- depth-anchored BA over the keyframe log ----------------------------
    def refine_keyframes_ba(
        self,
        stride: int = 8,
        match_dist: float = 0.15,
        iters: int = 4,
        cg_iters: int = 30,
        rounds: int = 2,
        max_obs: int = 200_000,
    ):
        """Depth-anchored Schur-complement BA over the keyframes' OWN sensor
        data: anchors are back-projected keyframe depth points, observations
        are the measured depths where other keyframes re-see an anchor, and
        :func:`~xslam_tpu_torch.models.ba.schur_ba_cg` jointly refines
        keyframe poses + anchors. Seeds from the pose-graph result. Falls
        back to the pose-graph poses when the problem is too small (needs
        >= 2 keyframes with recorded depth and multi-view anchors). Returns
        refined (K, 4, 4) camera2world poses."""
        seeded = self.refine_keyframes(iters=10)
        K = len(self.keyframes)
        if K < 2 or any(k.depth_u16 is None for k in self.keyframes):
            return seeded
        depths = [k.depth_u16 for k in self.keyframes]
        poses = [np.asarray(p) for p in seeded]
        residuals = []
        dev = self.device
        # outer re-association rounds: each round rebuilds anchors +
        # correspondences at the refined poses
        bucket = bucket_l = None
        # memory guard: a strongly-revisiting trajectory multiplies the
        # multi-view observation count — coarsen the anchor stride until the
        # problem fits the ``max_obs`` observation budget (sticky across
        # rounds, as are the buckets below)
        for _ in range(rounds):
            problem = None
            while True:
                problem, anchors0 = build_ba_problem(
                    poses, depths, self.intr, stride=stride,
                    match_dist=match_dist, device=dev,
                )
                if problem is None or int(problem.frame_idx.shape[0]) <= max_obs:
                    break
                stride *= 2
            if problem is None:
                break
            # shape-stable rounds: the observation count padded to a bucket
            # (1.25x the first round's N, rounded up to 4096), the anchors to
            # one of 1.25x the first round's L (rounded up to 1024); padded
            # anchors receive no observations, so their (damped) Hll blocks
            # are inert and their updates zero
            N = int(problem.frame_idx.shape[0])
            if bucket is None:
                bucket = -(-int(N * 1.25) // 4096) * 4096
            if N > bucket:
                bucket = -(-N // 4096) * 4096
            problem = pad_problem(problem, bucket)
            L = anchors0.shape[0]
            if bucket_l is None or L > bucket_l:
                bucket_l = -(-int(L * 1.25) // 1024) * 1024
            anchors_pad = np.zeros((bucket_l, 3), np.float32)
            anchors_pad[:L] = anchors0
            xi = np.stack([se3.log_real(p) for p in poses]).astype(np.float32)
            out = schur_ba_cg(
                torch.as_tensor(xi, device=dev), torch.as_tensor(anchors_pad, device=dev), problem,
                iters=iters, cg_iters=cg_iters,
            )
            poses = list(_exp_poses(out.poses))
            residuals.append(out.residual_history.cpu().numpy())
        if residuals:
            self.last_ba_residuals = np.concatenate(residuals)
        return np.stack(poses)

    def refine_trajectory(self, use_ba: bool = True) -> np.ndarray:
        """The FULL refined trajectory: keyframe refinement (pose graph +
        recorded loop closures, optionally depth-anchored BA) propagated to
        every logged frame by rigidly attaching each frame to its nearest
        preceding keyframe — ``c2w_i' = T_k^ref (T_k)^-1 c2w_i``. What
        ``run_slam`` exports beside the raw odometry."""
        if not self.pose_log:
            return np.zeros((0, 4, 4), np.float32)
        raw = np.stack(self.pose_log)
        if len(self.keyframes) < 2:
            return raw
        refined_kf = (
            self.refine_keyframes_ba() if use_ba else self.refine_keyframes()
        )
        kf_frames = np.asarray([k.frame_index for k in self.keyframes])
        out = raw.copy()
        for i in range(raw.shape[0]):
            k = int(np.searchsorted(kf_frames, i, side="right")) - 1
            if k < 0:
                continue
            correction = refined_kf[k] @ np.linalg.inv(self.keyframes[k].camera2world)
            out[i] = correction @ raw[i]
        return out


def _exp_poses(xi: torch.Tensor) -> np.ndarray:
    """(K, 4, 4) float32 poses of (K, 6) se(3) vectors, each by ``exp_real``
    on the host, as the JAX package maps them."""
    return np.stack([se3.exp_real(x).numpy() for x in xi.cpu().numpy()])
