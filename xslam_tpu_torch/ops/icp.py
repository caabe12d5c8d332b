"""Projective point-to-plane ICP: correspondence search + normal equations.

Port of ``associate``, ``build_system`` and ``solve_increment`` of
``xslam_tpu/ops/icp.py`` (reference ``ICP.cu``). Per pixel the dual row
``[cross(s,n), n | n·(d−s)]`` is built, and ``A = JᵀJ``, ``b = Jᵀr`` are
reduced in 4096-row blocks and then summed over the blocks, which bounds the
float32 accumulation error (the reference reduces in double). The matmuls
run in full float32: the package pins TF32 off at import. Nothing here reads
a value back to the host, so the ICP loop queues on the device without a
sync; the per-step ``ok`` flags stay device booleans.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..csfd import vec3
from ..csfd.single import CSFD, lift, solve
from ..geometry.intrinsics import Intrinsics
from .sampling import to_index


class IcpSystem(NamedTuple):
    A: CSFD  # (6, 6) dual normal matrix
    b: CSFD  # (6,) dual rhs
    inlier_count: torch.Tensor  # scalar


class Association(NamedTuple):
    """Projective correspondences: the gathered previous-model vertices and
    normals, and the projection validity mask."""

    nprev_g: CSFD
    vprev_g: CSFD
    in_img: torch.Tensor


def _gather_prev_rows(vmap_g_prev: CSFD, nmap_g_prev: CSFD, iy, ix):
    """Fetch the previous model's 12 floats per pixel; out-of-image pixels
    get NaN values and zero derivatives."""
    H, W = vmap_g_prev.v.shape[-2:]
    ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(-1)
    table = torch.cat([vmap_g_prev.v, vmap_g_prev.g, nmap_g_prev.v, nmap_g_prev.g]).reshape(12, -1)
    r = table[:, flat].reshape(12, *iy.shape)
    vprev = CSFD(torch.where(ok, r[0:3], torch.nan), torch.where(ok, r[3:6], 0.0))
    nprev = CSFD(torch.where(ok, r[6:9], torch.nan), torch.where(ok, r[9:12], 0.0))
    return vprev, nprev


def associate(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
) -> Association:
    """Projective data association (ICP.cu:196-231): transform current
    vertices into the previous camera, project (rounding half to even, as
    the reference's ``jnp.round``) and gather the model maps."""
    H, W = vmap_g_prev.v.shape[-2:]
    vcurr = lift(vmap_curr)
    vcurr_g = vec3.matvec(r_curr, vcurr) + CSFD(t_curr.v[:, None, None], t_curr.g[:, None, None])
    diff = vcurr_g - CSFD(t_prev.v[:, None, None], t_prev.g[:, None, None])
    vcurr_cp = vec3.matvec(r_prev_inv, diff)  # prev camera space

    # projection on the value lane (ICP.cu:214-217)
    px = vcurr_cp.v[0] * intr.fx / vcurr_cp.v[2] + intr.cx
    py = vcurr_cp.v[1] * intr.fy / vcurr_cp.v[2] + intr.cy
    ux = to_index(torch.round(px))
    uy = to_index(torch.round(py))
    in_img = (ux >= 0) & (uy >= 0) & (ux < W) & (uy < H) & (vcurr_cp.v[2] >= 0)

    vprev_g, nprev_g = _gather_prev_rows(vmap_g_prev, nmap_g_prev, uy, ux)
    return Association(nprev_g=nprev_g, vprev_g=vprev_g, in_img=in_img)


def build_system(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    nmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
    dist_thres: float,
    angle_thres: float,
) -> IcpSystem:
    """One ICP iteration's normal equations (``search_newton`` +
    ``combinedKernel``, ICP.cu:196-281).

    ``vmap_curr``/``nmap_curr`` are real (3, H, W) camera-space maps of the
    current frame; the previous-model maps are dual world-space maps from
    raycasting."""
    assoc = associate(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev)
    nprev_g, vprev_g, in_img = assoc.nprev_g, assoc.vprev_g, assoc.in_img

    ncurr = lift(nmap_curr)
    vcurr = lift(vmap_curr)
    vcurr_g = vec3.matvec(r_curr, vcurr) + CSFD(t_curr.v[:, None, None], t_curr.g[:, None, None])

    dist = vec3.norm(vprev_g - vcurr_g)
    ncurr_g = vec3.matvec(r_curr, ncurr)
    sine = vec3.norm(vec3.cross(ncurr_g, nprev_g))

    valid = (
        ~torch.isnan(nmap_curr[0])
        & in_img
        & ~torch.isnan(nprev_g.v[0])
        & (dist.v <= dist_thres)
        & (sine.v < angle_thres)
    )

    n = nprev_g
    d = vprev_g
    s = vcurr_g
    row_rot = vec3.cross(s, n)  # (3, H, W) dual
    rhs = vec3.dot(n, d - s)  # (H, W) dual

    # mask invalid rows to zero (ICP.cu:260-261)
    def mask(x: CSFD, m) -> CSFD:
        return CSFD(
            torch.where(m, torch.nan_to_num(x.v), 0.0),
            torch.where(m, torch.nan_to_num(x.g), 0.0),
        )

    row_rot = mask(row_rot, valid[None])
    row_n = mask(n, valid[None])
    rhs = mask(rhs, valid)

    # J: (N, 6), r: (N, 1)
    J = CSFD(
        torch.cat([row_rot.v, row_n.v]).reshape(6, -1).T,
        torch.cat([row_rot.g, row_n.g]).reshape(6, -1).T,
    )
    r = CSFD(rhs.v.reshape(-1, 1), rhs.g.reshape(-1, 1))

    # block-pairwise accumulation: per-block JᵀJ partials, then a sum over
    # blocks, bounding the float32 accumulation error
    N = J.v.shape[0]
    n_blocks = max(1, N // 4096)
    while N % n_blocks:
        n_blocks -= 1
    Jb = CSFD(J.v.reshape(n_blocks, -1, 6), J.g.reshape(n_blocks, -1, 6))
    rb = CSFD(r.v.reshape(n_blocks, -1, 1), r.g.reshape(n_blocks, -1, 1))

    def bmm(a: CSFD, b: CSFD) -> CSFD:
        f = lambda x, y: torch.bmm(x.transpose(1, 2), y)  # noqa: E731
        return CSFD(f(a.v, b.v), f(a.g, b.v) + f(a.v, b.g))

    A = _block_sum(bmm(Jb, Jb))
    b = _block_sum(bmm(Jb, rb))
    b = CSFD(b.v[:, 0], b.g[:, 0])
    return IcpSystem(A=A, b=b, inlier_count=valid.sum())


def _block_sum(x: CSFD) -> CSFD:
    return CSFD(torch.sum(x.v, dim=0), torch.sum(x.g, dim=0))


def solve_increment(system: IcpSystem, damping: float = 0.0) -> Tuple[CSFD, torch.Tensor]:
    """Solve the 6x6 dual system with the reference's degeneracy guard
    (|det| < 1e-15 or NaN -> fail, KinectFusionReconstruction.cpp:203-210).

    ``damping`` > 0 applies Levenberg-style scaled-diagonal damping
    ``A + damping * diag(A)``. Returns (x = [alpha beta gamma tx ty tz]
    dual, ok flag as a device boolean)."""
    if damping > 0.0:
        diag = torch.diagonal(system.A.v)
        system = IcpSystem(
            A=CSFD(system.A.v + damping * torch.diag(diag), system.A.g),
            b=system.b,
            inlier_count=system.inlier_count,
        )
    det = torch.linalg.det(system.A.v)
    ok = (torch.abs(det) >= 1e-15) & ~torch.isnan(det)
    eye = torch.eye(6, dtype=torch.float32, device=det.device)
    safe_A = CSFD(torch.where(ok, system.A.v, eye), torch.where(ok, system.A.g, 0.0))
    safe_b = CSFD(torch.where(ok, system.b.v, 0.0), torch.where(ok, system.b.g, 0.0))
    x = solve(safe_A, safe_b)
    x_ok = ~torch.any(torch.isnan(x.v))
    return CSFD(torch.nan_to_num(x.v), torch.nan_to_num(x.g)), ok & x_ok
