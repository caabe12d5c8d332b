"""TSDF raycasting: render the model vertex/normal maps from a camera pose.

Port of the dense fixed-march path of ``xslam_tpu/ops/raycast.py``
(reference ``RayCaster.cu``): the march is kernel K3
(:func:`xslam_tpu_torch.ops.kernels.march_fixed`, plain version
:func:`~xslam_tpu_torch.ops.kernels.march_fixed_plain`); the dual secant
refinement and the TSDF central-difference normals stay plain PyTorch.
March parameters mirror the reference: step = 0.8 * trunc_dist, range
[0.2, 5.0] m, secant ``Ts = t - step * Ft/(Ftdt - Ft)``, normals at +-half
a voxel.
"""

from __future__ import annotations

from typing import Tuple

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


def _camera_rays(r_c2v: CSFD, t_c2v: CSFD, intr: Intrinsics) -> Tuple[CSFD, CSFD]:
    H, W = intr.height, intr.width
    dev = r_c2v.v.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    rx = ((u - intr.cx) / intr.fx).expand(H, W)
    ry = ((v - intr.cy) / intr.fy).expand(H, W)
    ones = torch.ones((H, W), dtype=torch.float32, device=dev)
    ray_next_cam = vec3.vec3(lift(rx), lift(ry), lift(ones))
    ray_dir = vec3.normalized(vec3.matvec(r_c2v, ray_next_cam))
    dir_v = torch.where(ray_dir.v == 0.0, 1e-15, ray_dir.v)  # RayCaster.cu:211-213
    return CSFD(dir_v, ray_dir.g), t_c2v


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
    """Single-volume raycast: fixed march (K3) + secant refine + NaN sentinels.

    Only the reference semantics are ported: ``march_mode="fixed"``,
    ``normals_mode="tsdf"``, scalar trilinear taps."""
    if march_mode not in MARCH_MODES:
        raise NotImplementedError(f"raycast march_mode {march_mode!r} is not ported yet")
    if normals_mode != "tsdf" or packed_taps:
        raise NotImplementedError("only TSDF normals with scalar taps are ported")
    ray_dir, ray_start = _camera_rays(r_c2v, t_c2v, intr)
    t_found, t_dead = kernels.march_fixed(vol.value, ray_start, ray_dir, cfg.voxel_size, cfg.trunc_dist)
    accept = t_found < torch.clamp(t_dead, max=INF_T)
    vmap, nmap, v_ok, n_ok = refine(vol, ray_start, ray_dir, t_found, accept, r_v2w, t_v2w, cfg)
    return finalize_maps(vmap, nmap, v_ok, n_ok)
