"""TSDF volume state and differentiable fusion.

Port of ``xslam_tpu/ops/fusion.py`` (reference ``TsdfFusion.cu``,
``TsdfVolume.cpp``): three dense ``(X, Y, Z)`` float32 tensors, value (Re
tsdf), grad (Im tsdf) and weight. The per-voxel update is kernel K2
(:func:`xslam_tpu_torch.ops.kernels.fuse_volume`), which rewrites the
volume in place; its plain version is
:func:`xslam_tpu_torch.ops.kernels.fuse_volume_plain`. ``bi_threshold > 0``
takes the reference's bilinear depth sample
(:func:`xslam_tpu_torch.ops.sampling.bilinear_depth_sample`; B11 in K2 and
in the brick pass), whose dual weights give the volume's derivative lane a
term through the depth. The kernel skips the
tiles of the volume that the camera cannot see; :func:`tile_keep_mask` is
that test's plain twin, which the tests hold against the plain update.

:func:`integrate_brick` fuses the same frame brick by brick
(:mod:`xslam_tpu_torch.ops.fusion_brick`, kernels B3a-c, and B15's opt-in
classifiers and subcell stage): the same volume, bit for bit, with the depth
read only where a brick (or a subcell) is ACTIVE.
:func:`integrate_rows` does so on the brick-major layout
(:mod:`xslam_tpu_torch.ops.bricks`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from ..csfd.single import CSFD
from ..geometry.intrinsics import Intrinsics
from . import fusion_brick, kernels
from .preprocess import DEPTH_MAX_MM, DEPTH_MIN_MM


# csrc/fusion.cu: the tile of voxels (x, y, z) one block owns, the relative
# margin of its test against the camera, and the lower pixel bound it asks for
FUSE_TILE = (4, 8, 64)
FUSE_CULL_MARGIN = 4e-6
FUSE_CULL_LO = 1.0


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
    x_offset=None,
) -> VolumeState:
    """Fuse one scaled depth frame into the volume IN PLACE
    (``tsdfFusionKernal``, TsdfFusion.cu:85-171) and return it.

    ``r_v2c``/``t_v2c`` are the dual volume->camera rotation ((3,3)) and
    translation ((3,)). ``bi_threshold <= 0`` (the canonical configuration)
    samples the nearest depth, above 0 the bilinear one. ``x_offset`` (an
    int, B19a): ``vol`` is a slab whose local x 0 is global x ``x_offset``
    (``cfg.resolution`` its own extent), fused at the whole volume's voxel
    positions as ``xslam_tpu/ops/fusion.py::integrate(x_offset=)`` places
    them."""
    if tuple(vol.value.shape) != tuple(cfg.resolution):
        raise ValueError(f"volume shape {tuple(vol.value.shape)} != config {cfg.resolution}")
    kernels.fuse_volume(
        vol.value, vol.grad, vol.weight, depth_m, r_v2c, t_v2c, intr,
        cfg.voxel_size, cfg.trunc_dist, cfg.max_weight, bi_threshold, x_offset,
    )
    return vol


OVERFLOW_MODES = ("flag", "dense")


def integrate_brick(
    vol: VolumeState,
    depth_m: torch.Tensor,
    r_v2c: CSFD,
    t_v2c: CSFD,
    intr: Intrinsics,
    cfg: VolumeConfig,
    cap: int,
    overflow: str = "flag",
    bi_threshold: float = 0.0,
    classify_fine: bool = False,
    classify_split: bool = False,
    subcell_cap: int = 0,
    x_offset=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one scaled depth frame into the volume IN PLACE, brick by brick
    (port of ``xslam_tpu/ops/fusion_brick.py::integrate_brick``;
    ``bi_threshold`` as :func:`integrate`'s, read by the exact update of the
    ACTIVE bricks alone, as there): the mip table (B3a), the bricks' classes
    and lists (B3b; ``classify_split`` B15s, the MIXED class; ``classify_fine``
    B15f, by 4^3 subcells, which wins over ``classify_split``), with
    ``subcell_cap > 0`` the subcells of the first ``cap`` ACTIVE bricks
    (B15c), the fusion pass (B3c). Returns ``(overflowed, n_active)``,
    device tensors: whether the frame had more than ``cap`` ACTIVE bricks or
    a subcell list more than ``subcell_cap`` ACTIVE subcells, and how many
    ACTIVE bricks it had.

    ``overflow="flag"``: the ACTIVE bricks past the first ``cap`` in flat
    order, and the ACTIVE subcells past a list's ``subcell_cap``, stay
    unfused this frame. ``"dense"``: such a frame is fused exactly
    everywhere instead, from the pre-frame volume (on the card the fusion
    kernel reads the flag; no host read), as the JAX engine reruns dense
    fusion.

    ``x_offset`` (an int, B19a): ``vol`` is a slab whose local x 0 is global
    x ``x_offset`` (``cfg.resolution`` its own extent), as
    ``xslam_tpu/ops/fusion_brick.py::integrate_brick(x_offset=)`` takes it."""
    if tuple(vol.value.shape) != tuple(cfg.resolution):
        raise ValueError(f"volume shape {tuple(vol.value.shape)} != config {cfg.resolution}")
    return _fuse_by_bricks(vol, depth_m, r_v2c, t_v2c, intr, cfg, cap, overflow, bi_threshold, classify_fine,
                           classify_split, subcell_cap, x_offset)


def integrate_rows(
    bvol,
    depth_m: torch.Tensor,
    r_v2c: CSFD,
    t_v2c: CSFD,
    intr: Intrinsics,
    cfg: VolumeConfig,
    cap: int,
    overflow: str = "flag",
    bi_threshold: float = 0.0,
    classify_fine: bool = False,
    classify_split: bool = False,
    subcell_cap: int = 0,
    x_offset=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`integrate_brick` on a brick-major volume
    (:class:`xslam_tpu_torch.ops.bricks.BrickVolume`, ``(NB, 512)`` rows), IN
    PLACE: the port of ``xslam_tpu/ops/fusion_brick.py::integrate_rows``.
    B3a, B3b (or B15s, B15f) and B15c as there; B3c's row variant.
    ``overflow="dense"`` fuses an overflowing frame exactly at every voxel,
    from the pre-frame volume, as the JAX engine's rerun with ``cap`` =
    every brick (and no subcell stage) does. The rows are the dense fusion's
    volume in brick order, bit for bit.

    ``x_offset`` (an int): ``bvol`` is the rows of an X-slab whose local x 0
    is global x ``x_offset`` (``cfg.resolution`` its own extent, whole bx
    planes of bricks), as ``xslam_tpu/ops/fusion_brick.py::integrate_rows(
    x_offset=)`` takes it for the sharded engine's brick layout."""
    nbx, nby, nbz = fusion_brick._check_resolution(cfg.resolution)
    if tuple(bvol.value.shape) != (nbx * nby * nbz, fusion_brick.BRICK ** 3):
        raise ValueError(f"brick rows {tuple(bvol.value.shape)} do not hold a {cfg.resolution} volume")
    return _fuse_by_bricks(bvol, depth_m, r_v2c, t_v2c, intr, cfg, cap, overflow, bi_threshold, classify_fine,
                           classify_split, subcell_cap, x_offset)


def _fuse_by_bricks(vol, depth_m, r_v2c, t_v2c, intr, cfg, cap, overflow, bi_threshold, classify_fine, classify_split,
                    subcell_cap, x_offset=None):
    if overflow not in OVERFLOW_MODES:
        raise ValueError(f"overflow: expected one of {OVERFLOW_MODES}, got {overflow!r}")
    if subcell_cap < 0:
        raise ValueError(f"subcell_cap must be >= 0, got {subcell_cap}")
    pose = kernels.fusion_pose(r_v2c, t_v2c)
    table = fusion_brick.depth_mips(depth_m)
    classes = fusion_brick.classify_bricks(table, pose, intr, cfg, cap, split=classify_split, fine=classify_fine,
                                           x_offset=x_offset)
    subcells = None
    if subcell_cap > 0:  # ORs its lists' overflow into the flag
        subcells = fusion_brick.classify_subcells(table, pose, intr, cfg, classes, cap, subcell_cap, x_offset or 0)
    fusion_brick.fuse_bricks(*vol, depth_m, pose, intr, cfg, classes, cap, overflow == "dense", bi_threshold, subcells,
                             subcell_cap, x_offset)
    return classes.overflow, classes.totals[0]


def tile_keep_mask(r_v2c: CSFD, t_v2c: CSFD, intr: Intrinsics, resolution, voxel_size: float,
                   x_offset: int = 0) -> torch.Tensor:
    """Plain twin of K2's tile test: a bool ``(ceil(X/4), ceil(Y/8),
    ceil(Z/64))`` tensor, False where the kernel's block returns before it
    looks at a voxel.

    A voxel is updated only if it lies in front of the camera (``z > 0``) and
    its pixel passes the gate, which needs ``2.5 <= img < size - 0.5``. With
    ``z > 0`` each side of the gate is a linear function of the camera
    coordinates (``img_x >= 1`` is ``x * fx - (1 - cx) * z >= 0``, whatever
    the sign of ``fx`` or ``fy``), and the camera coordinates are affine in
    the voxel index, so a function that is below zero at the tile's eight
    corner voxels is below zero at all of them. The tile is dropped where
    one of the five functions is below zero at every corner by a margin of
    ``FUSE_CULL_MARGIN`` times the operands' size, which covers the float32
    rounding of both this test and the voxels' own arithmetic. ``x_offset``:
    a slab's first x, its corners moved as the kernel moves them (B19a)."""
    X, Y, Z = resolution
    dev = r_v2c.v.device
    R, t = r_v2c.v.to(torch.float32), t_v2c.v.to(torch.float32)

    def corners(n, tile):
        first = torch.arange(0, n, tile, device=dev)
        last = torch.clamp(first + tile, max=n) - 1
        return (torch.stack([first, last], dim=-1).to(torch.float32) + 0.5) * voxel_size  # (tiles, 2)

    gx = (corners(X, FUSE_TILE[0]) + kernels.slab_shift_m(x_offset, voxel_size))[:, None, None, :, None, None]
    gy = corners(Y, FUSE_TILE[1])[None, :, None, None, :, None]
    gz = corners(Z, FUSE_TILE[2])[None, None, :, None, None, :]
    c = [((R[i, 0] * gx + R[i, 1] * gy) + R[i, 2] * gz) + t[i] for i in range(3)]  # (tx, ty, tz, 2, 2, 2)
    cmax = torch.stack([x.abs() for x in c]).amax(dim=(0, 4, 5, 6), keepdim=True)[0]
    scale = FUSE_CULL_MARGIN * (cmax + 1.0)
    eps_x = scale * ((abs(intr.fx) + abs(intr.cx)) + intr.width)
    eps_y = scale * ((abs(intr.fy) + abs(intr.cy)) + intr.height)
    ax, ay = c[0] * intr.fx, c[1] * intr.fy
    outside = (
        c[2] < -scale,
        ax - (FUSE_CULL_LO - intr.cx) * c[2] < -eps_x,
        (intr.width - intr.cx) * c[2] - ax < -eps_x,
        ay - (FUSE_CULL_LO - intr.cy) * c[2] < -eps_y,
        (intr.height - intr.cy) * c[2] - ay < -eps_y,
    )
    dropped = torch.zeros(cmax.shape[:3], dtype=torch.bool, device=dev)
    for o in outside:
        dropped |= o.all(dim=(3, 4, 5))
    return ~dropped
