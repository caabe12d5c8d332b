"""TSDF raycasting: render the model vertex/normal maps from a camera pose.

Port of the dense fixed-march path of ``xslam_tpu/ops/raycast.py``
(reference ``RayCaster.cu``): the camera rays and the march are kernel K3
(:func:`xslam_tpu_torch.ops.kernels.march_fixed`, plain version
:func:`~xslam_tpu_torch.ops.kernels.camera_rays` then
:func:`~xslam_tpu_torch.ops.kernels.march_fixed_plain`); the dual secant
refinement, the TSDF central-difference normals and the maps' NaN sentinels
are kernel K5 (:func:`raycast_refine`, ``csrc/refine.cu``; plain version
:func:`refine` then :func:`finalize_maps`). March parameters mirror the reference: step = 0.8 * trunc_dist, range
[0.2, 5.0] m, secant ``Ts = t - step * Ft/(Ftdt - Ft)``, normals at +-half
a voxel.

The brick layout's marches and refine (:mod:`xslam_tpu_torch.ops.raycast_bricks`)
compose the plain ports kept here, each read through a voxel reader:
:func:`march_skip_plain` (the empty-space-skipping march), :func:`_window_repair`
and :func:`march_temporal` (the anchored window marches),
:func:`refine_from_samples` (the ``reuse`` refine) and
:func:`screen_normals_plain`, B4n's plain version (the kernel computes the
normals in K6's launch: :func:`xslam_tpu_torch.models.kinfu.model_map_pyramid`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..csfd import vec3
from ..csfd.single import CSFD, lift
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .fusion import VolumeConfig, VolumeState
from .kernels import INF_T, RAY_MAX_M, RAY_MIN_M
from .bricks import BRICK, JUMP_BASE
from .preprocess import _shift2d
from .sampling import gather3d, to_index

MARCH_MODES = ("fixed",)


class RaycastHit(NamedTuple):
    """Per-pixel march outcome before refinement."""

    t_found: torch.Tensor  # (H, W) first-crossing march time, INF_T if none
    t_dead: torch.Tensor  # (H, W) first death (neg->pos or volume exit) time


def trilinear_tsdf_shard(
    value: torch.Tensor, grad: torch.Tensor, px: CSFD, py: CSFD, pz: CSFD, voxel_size: float
) -> CSFD:
    """Dual trilinear TSDF interpolation at metric points of a whole volume
    (the reference's single-shard case). Out-of-bounds -> NaN value.

    Cell selection shifts the base cell when the point is below the voxel
    centre (RayCaster.cu:117-122); taps carry ``readTsdf``'s +1e-5 bias
    (RayCaster.cu:77)."""
    X, Y, Z = value.shape
    inv_vs = 1.0 / voxel_size

    gx = to_index(torch.floor(px.v * inv_vs))
    gy = to_index(torch.floor(py.v * inv_vs))
    gz = to_index(torch.floor(pz.v * inv_vs))
    ok = (gx > 0) & (gx < X - 1) & (gy > 0) & (gy < Y - 1) & (gz > 0) & (gz < Z - 1)

    gx = gx - (px.v < (gx.to(torch.float32) + 0.5) * voxel_size).to(gx.dtype)
    gy = gy - (py.v < (gy.to(torch.float32) + 0.5) * voxel_size).to(gy.dtype)
    gz = gz - (pz.v < (gz.to(torch.float32) + 0.5) * voxel_size).to(gz.dtype)

    a0 = px * inv_vs - (gx.to(torch.float32) + 0.5)
    b0 = py * inv_vs - (gy.to(torch.float32) + 0.5)
    c0 = pz * inv_vs - (gz.to(torch.float32) + 0.5)
    one = lift(1.0)
    a1, b1, c1 = one - a0, one - b0, one - c0

    def tap(dx, dy, dz) -> CSFD:
        ix, iy, iz = gx + dx, gy + dy, gz + dz
        return CSFD(gather3d(value, ix, iy, iz) + 1e-5, gather3d(grad, ix, iy, iz))

    res = (
        tap(0, 0, 0) * (a1 * b1 * c1)
        + tap(0, 0, 1) * (a1 * b1 * c0)
        + tap(0, 1, 0) * (a1 * b0 * c1)
        + tap(0, 1, 1) * (a1 * b0 * c0)
        + tap(1, 0, 0) * (a0 * b1 * c1)
        + tap(1, 0, 1) * (a0 * b1 * c0)
        + tap(1, 1, 0) * (a0 * b0 * c1)
        + tap(1, 1, 1) * (a0 * b0 * c0)
    )
    return CSFD(torch.where(ok, res.v, torch.nan), torch.where(ok, res.g, 0.0))


def refine(
    vol: VolumeState,
    ray_start: CSFD,
    ray_dir: CSFD,
    hit_t: torch.Tensor,
    accept: torch.Tensor,
    r_v2w: CSFD,
    t_v2w: CSFD,
    cfg: VolumeConfig,
) -> Tuple[CSFD, CSFD, torch.Tensor, torch.Tensor]:
    """Dual secant refinement + TSDF central-difference normals at ``hit_t``
    for pixels where ``accept`` (the reference's ``secant2`` refine with
    ``normals_mode="tsdf"``). Returns (vmap_w, nmap_w, v_ok, n_ok) with zeros
    outside the masks."""
    voxel = cfg.voxel_size
    step = cfg.trunc_dist * 0.8
    X, Y, Z = vol.value.shape

    def point_at(t: CSFD) -> CSFD:
        return vec3.vec3(
            vec3.comp(ray_start, 0) + vec3.comp(ray_dir, 0) * t,
            vec3.comp(ray_start, 1) + vec3.comp(ray_dir, 1) * t,
            vec3.comp(ray_start, 2) + vec3.comp(ray_dir, 2) * t,
        )

    def trilin_at(p: CSFD) -> CSFD:
        return trilinear_tsdf_shard(
            vol.value, vol.grad, vec3.comp(p, 0), vec3.comp(p, 1), vec3.comp(p, 2), voxel
        )

    t_dual = lift(torch.where(accept, hit_t, RAY_MIN_M))
    ft = trilin_at(point_at(t_dual))
    ftdt = trilin_at(point_at(t_dual + step))
    ok = (
        accept
        & ~torch.isnan(ft.v)
        & ~torch.isnan(ftdt.v)
        & (ft.v >= 0.0)
        & (ftdt.v <= 0.0)
        & (ftdt.v != ft.v)
    )
    diff = ftdt - ft
    denom = CSFD(torch.where(ok, diff.v, 1.0), torch.where(ok, diff.g, 0.0))
    ts = t_dual - (ft / denom) * step

    vertex = point_at(ts)  # volume coords, dual
    vertex_w = vec3.matvec(r_v2w, vertex) + CSFD(t_v2w.v[:, None, None], t_v2w.g[:, None, None])
    vmap = CSFD(
        torch.where(ok[None], torch.nan_to_num(vertex_w.v), 0.0),
        torch.where(ok[None], torch.nan_to_num(vertex_w.g), 0.0),
    )

    # central-difference normals with the reference's interior margin
    # (RayCaster.cu:270-271)
    gv = to_index(torch.floor(vertex.v / voxel))
    n_ok = ok & (
        (gv[0] > 1) & (gv[0] < X - 2)
        & (gv[1] > 1) & (gv[1] < Y - 2)
        & (gv[2] > 1) & (gv[2] < Z - 2)
    )
    half = voxel * 0.5

    def shifted(axis, sign):
        comps = [vec3.comp(vertex, i) for i in range(3)]
        comps[axis] = comps[axis] + sign * half
        return trilin_at(vec3.vec3(*comps))

    n = vec3.vec3(
        shifted(0, +1) - shifted(0, -1),
        shifted(1, +1) - shifted(1, -1),
        shifted(2, +1) - shifted(2, -1),
    )
    nsq = vec3.squarednorm(n)
    n_ok = n_ok & (nsq.v > 0.0) & ~torch.isnan(nsq.v)
    safe_n = CSFD(torch.where(n_ok[None], n.v, 1.0), torch.where(n_ok[None], n.g, 0.0))
    n_g = vec3.matvec(r_v2w, vec3.normalized(safe_n))
    nmap = CSFD(
        torch.where(n_ok[None], torch.nan_to_num(n_g.v), 0.0),
        torch.where(n_ok[None], torch.nan_to_num(n_g.g), 0.0),
    )
    return vmap, nmap, ok, n_ok


def finalize_maps(vmap: CSFD, nmap: CSFD, v_ok, n_ok) -> Tuple[CSFD, CSFD]:
    """Install the NaN sentinels the downstream consumers check."""
    vm = CSFD(torch.where(v_ok[None], vmap.v, torch.nan), torch.where(v_ok[None], vmap.g, 0.0))
    nm = CSFD(torch.where(n_ok[None], nmap.v, torch.nan), torch.where(n_ok[None], nmap.g, 0.0))
    return vm, nm


def raycast_refine(
    vol: VolumeState, pose: torch.Tensor, t_found: torch.Tensor, t_dead: torch.Tensor, intr: Intrinsics,
    cfg: VolumeConfig, direct: Optional[torch.Tensor] = None,
) -> Tuple[CSFD, CSFD]:
    """Kernel K5: the model vertex and normal maps (dual, world coordinates,
    (3, H, W), NaN value and zero derivative where invalid) from the march's
    ``t_found``/``t_dead`` at the packed pose
    (:func:`xslam_tpu_torch.ops.kernels.pack_ray_pose`). On CPU tensors its
    plain version: the rays, :func:`refine`, :func:`finalize_maps`.

    ``direct``, an int32 (1,) tensor on the card, gets added the number of
    normal samples the kernel read outside the block of voxels it shares
    between a pixel's six (``csrc/refine.cu``); unused on the CPU."""
    if kernels.on_cpu(vol.value, vol.grad, pose, t_found, t_dead, *(() if direct is None else (direct,))):
        r_c2v, t_c2v, r_v2w, t_v2w = kernels.unpack_ray_pose(pose)
        ray_dir, ray_start = kernels.camera_rays(r_c2v, t_c2v, intr)
        accept = t_found < torch.clamp(t_dead, max=INF_T)
        return finalize_maps(*refine(vol, ray_start, ray_dir, t_found, accept, r_v2w, t_v2w, cfg))
    X, Y, Z = vol.value.shape
    H, W = intr.height, intr.width
    for t, name in ((vol.value, "value"), (vol.grad, "grad")):
        kernels.check_tensor(t, name, torch.float32, (X, Y, Z))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    for t, name in ((t_found, "t_found"), (t_dead, "t_dead")):
        kernels.check_tensor(t, name, torch.float32, (H, W))
    if vol.value.numel() >= 1 << 31:
        raise ValueError(f"value: K5 indexes the volume with 32 bits, got {vol.value.numel()} voxels")
    if direct is not None:
        kernels.check_tensor(direct, "direct", torch.int32, (1,))
    out = [torch.empty((3, H, W), dtype=torch.float32, device=pose.device) for _ in range(4)]
    f32 = kernels.f32
    kernels.launch(
        "raycast_refine", pose.device, vol.value, vol.grad, pose, t_found, t_dead, *out, direct,
        f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(cfg.voxel_size * 0.5),
        f32(cfg.trunc_dist * 0.8), *kernels.camera_args(intr),
    )
    kernels.launch_counts["raycast_refine"] += 1
    return CSFD(out[0], out[1]), CSFD(out[2], out[3])


def raycast(
    vol: VolumeState,
    r_c2v: CSFD,
    t_c2v: CSFD,
    r_v2w: CSFD,
    t_v2w: CSFD,
    intr: Intrinsics,
    cfg: VolumeConfig,
    normals_mode: str = "tsdf",
    march_mode: str = "fixed",
    packed_taps: bool = False,
) -> Tuple[CSFD, CSFD]:
    """Single-volume raycast: the poses packed once, the fixed march (K3),
    the secant refine with normals and NaN sentinels (K5).

    Only the reference semantics are ported: ``march_mode="fixed"``,
    ``normals_mode="tsdf"``, scalar trilinear taps."""
    if march_mode not in MARCH_MODES:
        raise NotImplementedError(f"raycast march_mode {march_mode!r} is not ported yet")
    if normals_mode != "tsdf" or packed_taps:
        raise NotImplementedError("only TSDF normals with scalar taps are ported")
    pose = kernels.pack_ray_pose(r_c2v, t_c2v, r_v2w, t_v2w)
    t_found, t_dead = kernels.march_fixed(vol.value, pose, intr, cfg.voxel_size, cfg.trunc_dist)
    return raycast_refine(vol, pose, t_found, t_dead, intr, cfg)


# ------------------------------------------------- the brick layout's marches
def _in_volume(g, shape):
    X, Y, Z = shape
    return (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)


def _clamped(g, shape):
    return torch.stack([g[i].clamp(0, shape[i] - 1) for i in range(3)])


def march_skip_plain(ray_start: CSFD, dirs_v: torch.Tensor, cfg: VolumeConfig, packed_read, shape,
                     stats: Optional[dict] = None) -> RaycastHit:
    """Empty-space-skipping march: the port of ``xslam_tpu/ops/raycast.py::
    march_skip`` over a jump-packed reader ``packed_read`` (g -> biased
    values: ``JUMP_BASE + dist`` where a cell at distance >= 2 may be jumped,
    the value elsewhere). Its events are the fixed march's: skipped samples
    lie in cells without an observed negative voxel, and a positive ``prev``
    sentinel keeps the event tests exact. An integer step counter keeps
    every sample on the fixed march's grid ``0.2 + k * step``; a jump from
    distance ``d`` is ``max(1, floor((d - 1) * steps_per_cell))`` steps. Each
    ray marches until its own events or the range end (a loop with a break).
    ``stats``, where given, gets ``"samples"``: the reads that takes, the
    first one included; ``"ray_samples"``: each ray's; and ``"ray_rounds"``:
    the rounds of ``stats["lanes"]`` (default 1) steps each ray's loop takes
    where every round starts at a step the loop visits and covers the
    visited steps below its start + lanes (B5b's rounds, ``csrc/skip.cu``)."""
    voxel = cfg.voxel_size
    step = cfg.trunc_dist * 0.8
    steps_per_cell = BRICK * voxel / step
    n_steps = int((RAY_MAX_M - RAY_MIN_M) / step) + 1
    start_v = ray_start.v[:, None, None]
    H, W = dirs_v.shape[-2:]

    g0 = to_index(torch.floor((start_v + dirs_v * RAY_MIN_M) / voxel))
    prev = torch.clamp(packed_read(_clamped(g0, shape)), max=1.0)  # packed cells read as free space
    t_found = torch.full((H, W), INF_T, dtype=torch.float32, device=dirs_v.device)
    t_dead = torch.full_like(t_found, INF_T)
    k = torch.zeros((H, W), dtype=torch.int64, device=dirs_v.device)
    done = torch.zeros((H, W), dtype=torch.bool, device=dirs_v.device)
    ray_samples = torch.ones((H, W), dtype=torch.int64, device=dirs_v.device)
    ray_rounds = torch.ones_like(ray_samples)
    round_start = torch.zeros_like(ray_samples)
    lanes = stats.get("lanes", 1) if stats is not None else 1
    while not bool(done.all()):
        if stats is not None:
            ray_samples += ~done
            new_round = ~done & (k >= round_start + lanes)
            ray_rounds += new_round
            round_start = torch.where(new_round, k, round_start)
        kf = k.to(torch.float32)
        p = start_v + dirs_v * (RAY_MIN_M + (kf + 1.0) * step)
        g = to_index(torch.floor(p / voxel))
        inside = _in_volume(g, shape)
        c = packed_read(g)
        can_jump = inside & (c >= JUMP_BASE - 0.5) & ~done
        fine = ~done & ~can_jump
        death = fine & (~inside | ((prev < 0.0) & (c > 0.0) & inside))
        crossing = fine & inside & (prev > 0.0) & (c < 0.0)
        t_curr = RAY_MIN_M + kf * step
        t_found = torch.where(crossing, t_curr, t_found)
        t_dead = torch.where(death, t_curr, t_dead)
        done = done | crossing | death | (k + 1 >= n_steps)
        n_jump = torch.clamp(to_index(torch.floor((c - JUMP_BASE - 1.0) * steps_per_cell)), min=1)
        k = torch.where(can_jump, k + n_jump, k + 1)
        prev = torch.where(can_jump, 1.0, c)
    if stats is not None:
        stats.update(samples=int(ray_samples.sum()), ray_samples=ray_samples, ray_rounds=ray_rounds)
    return RaycastHit(t_found, t_dead)


def window_anchor(coarse: RaycastHit, H: int, W: int) -> torch.Tensor:
    """Each pixel's anchor for :func:`_window_repair` at (H, W): the
    earliest event (``min(t_found, t_dead)``) of the 2x2 neighbourhood of
    its coarse pixel ``(y // 2, x // 2)``, ``INF_T`` past the coarse grid."""
    t_event = torch.minimum(coarse.t_found, coarse.t_dead)
    pads = F.pad(t_event, (0, 1, 0, 1), value=INF_T)
    t0_coarse = torch.minimum(torch.minimum(pads[:-1, :-1], pads[1:, :-1]), torch.minimum(pads[:-1, 1:], pads[1:, 1:]))
    return t0_coarse.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :W]


def pooled_anchors(t_prev: torch.Tensor, H: int, W: int) -> RaycastHit:
    """:func:`march_temporal`'s coarse hits from its (H, W) anchor map: the
    2x2 minimum, non-finite entries counting as ``INF_T`` (no anchor), and no
    death."""
    tp = torch.where(torch.isfinite(t_prev), t_prev, INF_T)
    tp_half = tp[: (H // 2) * 2, : (W // 2) * 2].reshape(H // 2, 2, W // 2, 2).amin(dim=(1, 3))
    return RaycastHit(tp_half, torch.full_like(tp_half, INF_T))


def _window_repair(ray_start: CSFD, dirs_v: torch.Tensor, coarse: RaycastHit, window: int, cfg: VolumeConfig,
                   read_fn, shape, return_samples: bool = False, stats: Optional[dict] = None):
    """March each pixel of ``dirs_v`` (3, H, W) only inside a ``window``-step
    interval anchored at its 2x2 coarse neighbourhood's earliest event
    (``coarse``: the hit map one level above, 2x subsampled), snapped to the
    global march grid: the port of ``xslam_tpu/ops/raycast.py::_window_repair``
    over the voxel reader ``read_fn`` (g -> biased values). With
    ``return_samples`` also the two samples bracketing each recorded crossing,
    ``(f0, f1)``; (1, -1) where none. ``stats``, where given, gets
    ``"samples"``: the reads a march that stops once both events are known
    (or past 5 m) takes, the first one included."""
    voxel = cfg.voxel_size
    step = cfg.trunc_dist * 0.8
    H, W = dirs_v.shape[-2:]
    dev = dirs_v.device

    t0_full = window_anchor(coarse, H, W)
    has_anchor = t0_full < INF_T
    # the anchor on the global march grid, so window samples are the full march's
    k0 = torch.floor((torch.where(has_anchor, t0_full, RAY_MIN_M) - RAY_MIN_M) / step) - 1.0
    t_begin = RAY_MIN_M + torch.clamp(k0, min=0.0) * step
    start_v = ray_start.v[:, None, None]

    prev = read_fn(_clamped(to_index(torch.floor((start_v + dirs_v * t_begin) / voxel)), shape))
    t_found = torch.full((H, W), INF_T, dtype=torch.float32, device=dev)
    t_dead = torch.full_like(t_found, INF_T)
    f0 = torch.ones((H, W), dtype=torch.float32, device=dev)
    f1 = -torch.ones((H, W), dtype=torch.float32, device=dev)
    samples = int(has_anchor.sum()) if stats is not None else 0
    for k in range(window):
        # t_begin + float32(k) * step, in float32 as the reference's loop computes it
        t_curr = t_begin + kernels.f32(np.float32(k) * np.float32(step))
        g = to_index(torch.floor((start_v + dirs_v * (t_curr + step)) / voxel))
        # the reference's loop condition is on t_curr (RayCaster.cu:236)
        live = has_anchor & (t_curr < RAY_MAX_M)
        if stats is not None:
            samples += int((live & ~((t_found < INF_T) & (t_dead < INF_T))).sum())
        in_vol = _in_volume(g, shape)
        inside = in_vol & live
        tsdf = read_fn(g)
        death = live & (~in_vol | (inside & (prev < 0.0) & (tsdf > 0.0)))
        crossing = inside & (prev > 0.0) & (tsdf < 0.0)
        record = crossing & (t_curr < t_found)
        t_found = torch.where(record, t_curr, t_found)
        f0 = torch.where(record, prev, f0)
        f1 = torch.where(record, tsdf, f1)
        t_dead = torch.where(death & (t_curr < t_dead), t_curr, t_dead)
        prev = tsdf
    if stats is not None:
        stats["samples"] = samples
    hit = RaycastHit(t_found, t_dead)
    return (hit, f0, f1) if return_samples else hit


def march_temporal(t_prev: torch.Tensor, ray_start: CSFD, ray_dir: CSFD, cfg: VolumeConfig, window: int = 12,
                   read_fn=None, shape=None, return_samples: bool = False, stats: Optional[dict] = None):
    """Anchored march: :func:`_window_repair` of every pixel around the
    anchor map ``t_prev`` (H, W), min-pooled 2x2 (non-finite entries count
    as no anchor), with no coarse march: the port of
    ``xslam_tpu/ops/raycast.py::march_temporal``. Pixels without a finite
    anchor in their neighbourhood find no event."""
    H, W = ray_dir.v.shape[-2:]
    return _window_repair(ray_start, ray_dir.v, pooled_anchors(t_prev, H, W), window, cfg, read_fn, shape,
                          return_samples, stats)


def refine_from_samples(trilin_at, ray_start: CSFD, ray_dir: CSFD, hit_t, f0, f1, accept, r_v2w: CSFD, t_v2w: CSFD,
                        cfg: VolumeConfig) -> Tuple[CSFD, CSFD, torch.Tensor, torch.Tensor]:
    """The ``reuse`` refine: the secant of the march's two bracketing samples,
    then ONE dual trilinear ``F`` as a Newton polish with the samples' slope
    ``(f1 - f0) / step``; a pixel whose correction exceeds a step
    (``|F| > -slope * step``) is rejected. Port of
    ``xslam_tpu/ops/raycast.py::refine_from_samples``; the derivative
    ``ts.g = -F.g / slope`` keeps the reference's finite-difference slope.
    Returns (vmap_w, zero normals, v_ok, all-False n_ok)."""
    step = cfg.trunc_dist * 0.8

    def point_at(t: CSFD) -> CSFD:
        return vec3.vec3(
            vec3.comp(ray_start, 0) + vec3.comp(ray_dir, 0) * t,
            vec3.comp(ray_start, 1) + vec3.comp(ray_dir, 1) * t,
            vec3.comp(ray_start, 2) + vec3.comp(ray_dir, 2) * t,
        )

    ok0 = accept & (f1 < f0)
    slope = torch.where(ok0, (f1 - f0) / step, -1.0)  # < 0 on crossings
    t0 = torch.where(accept, hit_t, RAY_MIN_M)
    ts0 = t0 - f0 / slope
    Fs = trilin_at(point_at(lift(torch.where(ok0, ts0, RAY_MIN_M))))
    ok = ok0 & ~torch.isnan(Fs.v) & (torch.abs(Fs.v) <= -slope * step)
    ts = CSFD(torch.where(ok, ts0 - Fs.v / slope, t0), torch.where(ok, -Fs.g / slope, 0.0))

    vertex = point_at(ts)
    vertex_w = vec3.matvec(r_v2w, vertex) + CSFD(t_v2w.v[:, None, None], t_v2w.g[:, None, None])
    vmap = CSFD(
        torch.where(ok[None], torch.nan_to_num(vertex_w.v), 0.0),
        torch.where(ok[None], torch.nan_to_num(vertex_w.g), 0.0),
    )
    zeros = CSFD(torch.zeros_like(vmap.v), torch.zeros_like(vmap.g))
    return vmap, zeros, ok, torch.zeros_like(ok)


def screen_normals_plain(vmap: CSFD) -> CSFD:
    """Dual world-space normals from the central differences of the vertex
    map, ``(v[x+1] - v[x-1]) x (v[y+1] - v[y-1])`` normalized (NaN value,
    zero derivative where a neighbour or the product fails): the port of
    ``xslam_tpu/ops/raycast.py::screen_normals`` with ``central=True``. B4n's
    plain version."""

    def shift(m: CSFD, dy, dx) -> CSFD:
        return CSFD(_shift2d(m.v, dy, dx, fill=torch.nan), _shift2d(m.g, dy, dx))

    xp, xm = shift(vmap, 0, 1), shift(vmap, 0, -1)
    yp, ym = shift(vmap, 1, 0), shift(vmap, -1, 0)
    ok = (~torch.isnan(vmap.v[0]) & ~torch.isnan(xp.v[0]) & ~torch.isnan(xm.v[0])
          & ~torch.isnan(yp.v[0]) & ~torch.isnan(ym.v[0]))
    n = vec3.cross(xp - xm, yp - ym)
    nsq = vec3.squarednorm(n)
    ok = ok & (nsq.v > 0.0) & ~torch.isnan(nsq.v)
    out = vec3.normalized(CSFD(torch.where(ok[None], n.v, 1.0), torch.where(ok[None], n.g, 0.0)))
    return CSFD(torch.where(ok[None], out.v, torch.nan), torch.where(ok[None], out.g, 0.0))
