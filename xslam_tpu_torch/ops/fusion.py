"""TSDF volume state and differentiable fusion.

Port of ``xslam_tpu/ops/fusion.py`` (reference ``TsdfFusion.cu``,
``TsdfVolume.cpp``): three dense ``(X, Y, Z)`` float32 tensors, value (Re
tsdf), grad (Im tsdf) and weight. The per-voxel update is kernel K2
(:func:`xslam_tpu_torch.ops.kernels.fuse_volume`), which rewrites the
volume in place; its plain version is
:func:`xslam_tpu_torch.ops.kernels.fuse_volume_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..csfd.single import CSFD
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .preprocess import DEPTH_MAX_MM, DEPTH_MIN_MM


@dataclass(frozen=True)
class VolumeConfig:
    resolution: Tuple[int, int, int] = (256, 256, 256)
    voxel_size: float = 0.03
    trunc_dist: float = 0.09  # max(thres_range*voxel, 2.1*voxel), TsdfVolume.cpp:35-38
    max_weight: int = 100


class VolumeState(NamedTuple):
    """The TSDF map: value (Re tsdf), grad (Im tsdf), weight."""

    value: torch.Tensor
    grad: torch.Tensor
    weight: torch.Tensor


def create_volume(cfg: VolumeConfig, device) -> VolumeState:
    """Zero-initialized volume (``initializeVolume``, TsdfFusion.cu:4-43)."""
    shape = cfg.resolution
    return VolumeState(*(torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)))


def scale_depth(depth_u16: torch.Tensor) -> torch.Tensor:
    """uint16 mm -> f32 metres with sensor-range gating
    (``scaleDepthKernal``, TsdfFusion.cu:68-82)."""
    d = depth_u16.to(torch.float32)
    valid = (d >= DEPTH_MIN_MM) & (d <= DEPTH_MAX_MM)
    return torch.where(valid, d / 1000.0, 0.0)


def integrate(
    vol: VolumeState,
    depth_m: torch.Tensor,
    r_v2c: CSFD,
    t_v2c: CSFD,
    intr: Intrinsics,
    cfg: VolumeConfig,
    bi_threshold: float = 0.0,
) -> VolumeState:
    """Fuse one scaled depth frame into the volume IN PLACE
    (``tsdfFusionKernal``, TsdfFusion.cu:85-171) and return it.

    ``r_v2c``/``t_v2c`` are the dual volume->camera rotation ((3,3)) and
    translation ((3,)). Only the nearest-depth branch is ported
    (``bi_threshold <= 0``, the canonical configuration)."""
    if bi_threshold > 0.0:
        raise NotImplementedError("bilinear depth sampling (bi_threshold > 0) is not ported yet")
    if tuple(vol.value.shape) != tuple(cfg.resolution):
        raise ValueError(f"volume shape {tuple(vol.value.shape)} != config {cfg.resolution}")
    kernels.fuse_volume(
        vol.value, vol.grad, vol.weight, depth_m, r_v2c, t_v2c, intr,
        cfg.voxel_size, cfg.trunc_dist, cfg.max_weight,
    )
    return vol
