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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..csfd import vec3
from ..csfd.single import CSFD, lift
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .fusion import VolumeConfig, VolumeState
from .kernels import INF_T, RAY_MIN_M
from .sampling import gather3d, to_index

MARCH_MODES = ("fixed",)


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
