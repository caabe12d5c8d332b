"""The brick-major TSDF volume layout and its empty-space skip field.

Port of ``xslam_tpu/ops/bricks.py`` (its 8^3 parts; the 4^3 sub-brick variants
and ``pack_vg_z9`` are not ported). Value, grad and weight live as ``(NB,
512)`` rows of 8^3 bricks instead of dense ``(X, Y, Z)`` planes: row ``b =
(bx * nby + by) * nbz + bz``, lane ``(x & 7) << 6 | (y & 7) << 3 | (z & 7)``,
as :func:`xslam_tpu_torch.ops.fusion_brick.to_bricks` orders them. It is a
storage layout only: every consumer gives the dense layout's results.

The skip field is kernel B5a, :func:`skip_field` (``csrc/skip.cu``): each
brick's L-inf distance, capped at :data:`DIST_CAP`, to the once-dilated mask
of bricks that hold an observed negative voxel. Its plain version is
:func:`brick_distance_rows`. :func:`skip_rows` packs the distance into the
value rows for the plain skip march; the kernel of that march (B5b) reads the
value rows and the distance instead. The sharded engine launches B5a's two
kernels apart (B19e): :func:`event_mask` over a rank's slab of rows, then,
over the masks the ranks gather, :func:`skip_distance`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import kernels
from .fusion import VolumeConfig, VolumeState
from .fusion_brick import from_bricks, to_bricks

BRICK = 8
DIST_CAP = 5  # brick-distance saturation
JUMP_BASE = 1000.0  # sentinel offset of jump-packed skip rows


class BrickVolume(NamedTuple):
    """TSDF map in brick-major rows: value (Re), grad (Im), weight."""

    value: torch.Tensor  # (NB, 512) float32
    grad: torch.Tensor
    weight: torch.Tensor


def brick_grid(res) -> Tuple[int, int, int]:
    X, Y, Z = res
    if X % BRICK or Y % BRICK or Z % BRICK:
        raise ValueError(f"the brick layout needs extents that are multiples of {BRICK}, got {tuple(res)}")
    return X // BRICK, Y // BRICK, Z // BRICK


def create(cfg: VolumeConfig, device) -> BrickVolume:
    """Zero-initialized brick volume."""
    nbx, nby, nbz = brick_grid(cfg.resolution)
    n = nbx * nby * nbz
    return BrickVolume(*(torch.zeros((n, BRICK ** 3), dtype=torch.float32, device=device) for _ in range(3)))


def from_dense(value, grad, weight) -> BrickVolume:
    return BrickVolume(*(to_bricks(x).contiguous() for x in (value, grad, weight)))


def to_dense(bvol: BrickVolume, res) -> VolumeState:
    return VolumeState(*(from_bricks(x, res).contiguous() for x in bvol))


def flat_index(res, ix, iy, iz):
    """Flat element index of voxel (ix, iy, iz) in a brick-major plane."""
    _, nby, nbz = brick_grid(res)
    b = ((ix >> 3) * nby + (iy >> 3)) * nbz + (iz >> 3)
    lane = ((ix & 7) << 6) | ((iy & 7) << 3) | (iz & 7)
    return b * BRICK ** 3 + lane


def gather(plane: torch.Tensor, res, ix, iy, iz, fill=0.0) -> torch.Tensor:
    """Voxel gather from a brick-major plane, out of bounds -> ``fill``: the
    brick-layout twin of :func:`xslam_tpu_torch.ops.sampling.gather3d`."""
    X, Y, Z = res
    ok = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    idx = flat_index(res, ix.clamp(0, X - 1), iy.clamp(0, Y - 1), iz.clamp(0, Z - 1))
    return torch.where(ok, torch.take(plane, idx), fill)


def event_brick_mask(bvol: BrickVolume) -> torch.Tensor:
    """(NB,) bool: the bricks holding an observed negative voxel, which can
    host a march event (a crossing or a sign death)."""
    return torch.any((bvol.value < 0.0) & (bvol.weight > 0.0), dim=1)


def _dilate(a: torch.Tensor) -> torch.Tensor:
    # torch.roll wraps across the grid's faces, as jnp.roll does
    for ax in range(3):
        a = a | torch.roll(a, 1, ax) | torch.roll(a, -1, ax)
    return a


def distance_grid(mask: torch.Tensor) -> torch.Tensor:
    """Capped L-inf cell distance to the once-dilated mask on a 3-D grid
    (int32): the dilation puts an event's previous march sample, under one
    cell away, in the zero-distance zone."""
    m = _dilate(mask)
    dist = torch.where(m, 0, DIST_CAP).to(torch.int32)
    cur = m
    for k in range(1, DIST_CAP):
        cur = _dilate(cur)
        dist = torch.minimum(dist, torch.where(cur, k, DIST_CAP).to(torch.int32))
    return dist


def distance_from_event_mask(mask: torch.Tensor, res) -> torch.Tensor:
    """(NB,) int32 brick distance given the (NB,) event mask."""
    return distance_grid(mask.reshape(brick_grid(res))).reshape(-1)


def brick_distance_rows(bvol: BrickVolume, res) -> torch.Tensor:
    """(NB,) brick distance from this volume's own event mask: B5a's plain
    version."""
    return distance_from_event_mask(event_brick_mask(bvol), res)


def pack_rows(value: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Jump-pack value rows given the (NB,) brick distance."""
    d = dist.to(torch.float32)[:, None]
    return torch.where(d >= 2.0, JUMP_BASE + d, value)


def skip_rows(bvol: BrickVolume, res) -> torch.Tensor:
    """Jump-packed value rows: the bricks at distance >= 2 hold ``JUMP_BASE +
    dist`` in every lane (a correct march never reads their values), the
    others their values; one read serves both the skip decision and the
    sample."""
    return pack_rows(bvol.value, brick_distance_rows(bvol, res))


def skip_field(bvol: BrickVolume, res) -> torch.Tensor:
    """Kernel B5a (``csrc/skip.cu``): :func:`brick_distance_rows`, the (NB,)
    int32 capped distance of each brick to the once-dilated event mask, with
    the wrap across the volume's faces. On CPU tensors its plain version. On
    the card one launch of two kernels: the event mask (a warp a brick), then
    the distances (a thread a brick, over the mask staged in shared memory)."""
    if kernels.on_cpu(bvol.value, bvol.weight):
        return brick_distance_rows(bvol, res)
    nbx, nby, nbz = brick_grid(res)
    n = nbx * nby * nbz
    for t, name in ((bvol.value, "value"), (bvol.weight, "weight")):
        kernels.check_tensor(t, name, torch.float32, (n, BRICK ** 3))
    mask = torch.empty(n, dtype=torch.uint8, device=bvol.value.device)
    dist = torch.empty(n, dtype=torch.int32, device=bvol.value.device)
    kernels.launch("skip_field", bvol.value.device, bvol.value, bvol.weight, mask, dist, nbx, nby, nbz)
    kernels.launch_counts["skip_field"] += 1
    return dist


def event_mask(bvol: BrickVolume, local_res) -> torch.Tensor:
    """Kernel B19e's first half (``csrc/skip.cu``, B5a's mask kernel alone):
    the (NB_local,) uint8 event mask of a slab's brick rows, ``local_res``
    its own extent (``xslam_tpu/parallel/sharded.py:314-316``,
    ``event_brick_mask`` over a rank's rows). The sharded engine gathers the
    slabs' masks into the whole volume's, since a slab is whole bx planes of
    bricks. On CPU tensors its plain version, :func:`event_brick_mask`."""
    nbx, nby, nbz = brick_grid(local_res)
    n = nbx * nby * nbz
    if kernels.on_cpu(bvol.value, bvol.weight):
        if tuple(bvol.value.shape) != (n, BRICK ** 3):
            raise ValueError(f"value: expected shape {(n, BRICK ** 3)}, got {tuple(bvol.value.shape)}")
        return event_brick_mask(bvol).to(torch.uint8)
    for t, name in ((bvol.value, "value"), (bvol.weight, "weight")):
        kernels.check_tensor(t, name, torch.float32, (n, BRICK ** 3))
    mask = torch.empty(n, dtype=torch.uint8, device=bvol.value.device)
    kernels.launch("event_mask", bvol.value.device, bvol.value, bvol.weight, mask)
    kernels.launch_counts["event_mask"] += 1
    return mask


def skip_distance(mask: torch.Tensor, res) -> torch.Tensor:
    """Kernel B19e's second half (``csrc/skip.cu``, B5a's distance kernel
    alone): the (NB,) int32 capped distance of each brick to the once-dilated
    event mask ``mask`` ((NB,) uint8, the whole grid's, gathered from the
    slabs), wrapped across the volume's faces
    (``xslam_tpu/parallel/sharded.py:317``). With :func:`event_mask` over the
    whole rows, :func:`skip_field`'s distances. On CPU tensors its plain
    version, :func:`distance_from_event_mask`."""
    nbx, nby, nbz = brick_grid(res)
    n = nbx * nby * nbz
    if kernels.on_cpu(mask):
        if tuple(mask.shape) != (n,):
            raise ValueError(f"mask: expected shape {(n,)}, got {tuple(mask.shape)}")
        return distance_from_event_mask(mask.to(torch.bool), res)
    kernels.check_tensor(mask, "mask", torch.uint8, (n,))
    dist = torch.empty(n, dtype=torch.int32, device=mask.device)
    kernels.launch("skip_distance", mask.device, mask, dist, nbx, nby, nbz)
    kernels.launch_counts["skip_distance"] += 1
    return dist
