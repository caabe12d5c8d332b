"""Depth preprocessing: bilateral filter, pyramid downsample, vertex/normal
maps, map resizing.

Port of ``xslam_tpu/ops/preprocess.py`` (the reference's ``Map.cu``). Maps
are real float32 ``(3, H, W)`` tensors with NaN at invalid pixels.

:func:`bilateral_filter`, :func:`pyr_down` (level after level) and
:func:`create_vmap` with :func:`create_nmap` here are the plain versions of
kernels K1, K7 and K8; the pipeline calls their wrappers in
:mod:`xslam_tpu_torch.ops.kernels` (``bilateral_filter``, ``depth_pyramid``,
``vertex_normal_pyramid``), which launch
on a CUDA tensor. :func:`resize_vmap` is part of K6's plain version
(:func:`xslam_tpu_torch.models.kinfu.resize_model_maps`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.intrinsics import Intrinsics

# Map.cu:4-5
SIGMA_COLOR = 30.0  # mm
SIGMA_SPACE = 4.5  # px
BILATERAL_R = 6  # Map.cu:169
DEPTH_MIN_MM = 200.0  # valid sensor range (Map.cu:194, TsdfFusion.cu:77)
DEPTH_MAX_MM = 5000.0


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """x shifted so ``out[y, x] = x[y+dy, x+dx]``, padded with ``fill``."""
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)), value=fill)
    y0, x0 = max(dy, 0), max(dx, 0)
    return xp[..., y0:y0 + H, x0:x0 + W]


def bilateral_filter(depth_u16: torch.Tensor) -> torch.Tensor:
    """Edge-preserving smoothing of a uint16 depth map (mm) -> f32 (mm).

    Mirrors ``bilateralKernel`` (Map.cu:155-199): 13x13 window,
    sigma_color=30 mm, sigma_space=4.5 px, result rounded half to even and
    zeroed outside [200, 5000] mm. A neighbour participates iff its
    coordinate is within [0, size-2] (the reference never reads the last
    row/column)."""
    depth = depth_u16.to(torch.float32)
    H, W = depth.shape
    inv_sig_space = 0.5 / (SIGMA_SPACE * SIGMA_SPACE)
    inv_sig_color = 0.5 / (SIGMA_COLOR * SIGMA_COLOR)

    ys = torch.arange(H, dtype=torch.int32, device=depth.device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=depth.device)[None, :]

    sum1 = torch.zeros_like(depth)
    sum2 = torch.zeros_like(depth)
    for dy in range(-BILATERAL_R, BILATERAL_R + 1):
        for dx in range(-BILATERAL_R, BILATERAL_R + 1):
            nbr = _shift2d(depth, dy, dx)
            valid = (ys + dy >= 0) & (ys + dy <= H - 2) & (xs + dx >= 0) & (xs + dx <= W - 2)
            # the reference multiplies a float32 space2 by the constant in float32
            space_term = float(np.float32(dy * dy + dx * dx) * np.float32(inv_sig_space))
            color2 = (depth - nbr) * (depth - nbr)
            w = torch.exp(-(space_term + color2 * inv_sig_color))
            w = torch.where(valid, w, 0.0)
            sum1 = sum1 + nbr * w
            sum2 = sum2 + w
    res = torch.round(sum1 / sum2)
    res = torch.where((res > DEPTH_MAX_MM) | (res < DEPTH_MIN_MM), 0.0, res)
    return torch.clamp(res, 0.0, 32767.0)


def pyr_down(depth: torch.Tensor) -> torch.Tensor:
    """Half-resolution depth with 3-sigma colour rejection
    (``pyrDownKernel``, Map.cu:202-230). Input/output f32 mm; the result is
    floored, as the reference's integer division is."""
    H, W = depth.shape
    oh, ow = H // 2, W // 2
    planes = torch.round(depth[: oh * 2, : ow * 2].reshape(oh, 2, ow, 2))
    center = planes[:, 0, :, 0]

    ys = (2 * torch.arange(oh, dtype=torch.int32, device=depth.device))[:, None]
    xs = (2 * torch.arange(ow, dtype=torch.int32, device=depth.device))[None, :]

    ssum = torch.zeros((oh, ow), dtype=torch.float32, device=depth.device)
    cnt = torch.zeros((oh, ow), dtype=torch.float32, device=depth.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            a, b = dy & 1, dx & 1
            nbr = _shift2d(planes[:, a, :, b], (dy - a) // 2, (dx - b) // 2)
            valid = (
                (ys + dy >= 0)
                & (ys + dy <= H - 2)
                & (xs + dx >= 0)
                & (xs + dx <= W - 2)
                & (torch.abs(nbr - center) < 3 * SIGMA_COLOR)
            )
            ssum = ssum + torch.where(valid, nbr, 0.0)
            cnt = cnt + valid
    return torch.floor(ssum / torch.clamp(cnt, min=1.0))


def create_vmap(intr: Intrinsics, depth_mm: torch.Tensor) -> torch.Tensor:
    """Back-project depth (mm) to a camera-space vertex map (3, H, W) in
    metres; invalid pixels are NaN (``computeVmapKernel``, Map.cu:8-29)."""
    H, W = depth_mm.shape
    z = depth_mm / 1000.0
    u = torch.arange(W, dtype=torch.float32, device=depth_mm.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth_mm.device)[:, None]
    vx = z * (u - intr.cx) / intr.fx
    vy = z * (v - intr.cy) / intr.fy
    vmap = torch.stack([vx, vy, z])
    return torch.where(z[None] != 0.0, vmap, torch.nan)


def create_nmap(vmap: torch.Tensor) -> torch.Tensor:
    """Cross-product normals from right/down neighbours
    (``computeNmapKernel``, Map.cu:32-70); NaN at invalid or border pixels."""
    v00 = vmap
    v01 = _shift2d(vmap, 0, 1, fill=torch.nan)  # (u+1, v)
    v10 = _shift2d(vmap, 1, 0, fill=torch.nan)  # (u, v+1)
    a = v01 - v00
    b = v10 - v00
    n = torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )
    norm = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    n = n / norm
    ok = ~(torch.isnan(v00[0]) | torch.isnan(v01[0]) | torch.isnan(v10[0]) | (norm[0] == 0.0))
    return torch.where(ok[None], n, torch.nan)


def _resize_map(m: torch.Tensor, normalize: bool) -> torch.Tensor:
    """2x2 average downsample of a (3, H, W) map; NaN-propagating
    (``resizeMapKernel``, Map.cu:105-152)."""
    H, W = m.shape[-2], m.shape[-1]
    oh, ow = H // 2, W // 2
    q = m[:, : oh * 2, : ow * 2].reshape(3, oh, 2, ow, 2)
    avg = torch.mean(q, dim=(2, 4))
    any_nan = torch.any(torch.any(torch.isnan(q[0]), dim=3), dim=1)
    if normalize:
        norm = torch.sqrt(torch.sum(avg * avg, dim=0, keepdim=True))
        avg = avg / norm
    return torch.where(any_nan[None], torch.nan, avg)


def resize_vmap(v: torch.Tensor) -> torch.Tensor:
    return _resize_map(v, normalize=False)


def resize_nmap(n: torch.Tensor) -> torch.Tensor:
    return _resize_map(n, normalize=True)
