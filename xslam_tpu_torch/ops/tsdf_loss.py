"""Camera-relocalization TSDF loss with first and second derivatives (DCSFD).

Port of ``xslam_tpu/ops/tsdf_loss.py`` (reference
``ComputeLocalTsdfHessianKernel`` / ``ComputeLocalTsdfLossKernel``,
``TsdfFusion.cu:204-447``): given a ground-truth TSDF value plane and a
hyper-dual volume->camera pose, recompute each voxel's TSDF error against
the depth frame and reduce loss, directional gradient, directional second
derivative and inlier count to scalars. Masks mirror the reference: skip
voxels with ``gt == 0`` or ``|gt| > 0.95``, behind the camera, at the image
border, with depth out of [0.2, 5] m, or with ``|error| > 1``.

:func:`tsdf_loss_hessian` and :func:`tsdf_loss` keep the JAX package's
contract; :func:`tsdf_loss_pairs` evaluates P packed poses (the seed pairs of
``models/relocalize.py``) at once. They are the wrappers of kernel B12
(``csrc/tsdf_loss.cu``): on CUDA tensors they launch it, on CPU tensors they
run the plain versions (:func:`tsdf_loss_hessian_plain`, :func:`_field_plain`),
never one in place of the other. The plain versions take X-slabs of the
volume, gather the voxels that pass ``gt``'s test (the others are masked
whatever the pose), loop over the pairs, so that they fit on the card at
256^3, and sum each masked float32 term in float64 with one rounding to
float32 at the end;
the kernel adds the same terms in double in an order fixed by the volume's
size (:func:`loss_blocks`), so the sums agree within a float32 ulp and the
count exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..csfd import double as dc
from ..csfd.double import DCSFD
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .fusion import VolumeConfig
from .sampling import gather2d, to_index

# csrc/tsdf_loss.cu: threads a block, most blocks a launch (four for each of the 132 SMs), most seed pairs of
# a launch, floats of a packed pose, groups of blocks the last block adds side by side
LOSS_BLOCK = 128
LOSS_MAX_BLOCKS = 528
MAX_PAIRS = 21
POSE_FLOATS = 48
LOSS_GROUPS = 4
MODES = {"reduce": 0, "value": 1, "field": 2}
SLAB_VOXELS = 1 << 21  # the plain version's X-slab: at most this many voxels at a time


class TsdfLossResult(NamedTuple):
    loss: torch.Tensor
    grad: torch.Tensor
    hessian: torch.Tensor
    count: torch.Tensor


def loss_blocks(n_voxels: int) -> int:
    """The grid of a B12 launch over ``n_voxels`` voxels. It depends on the
    volume's size alone, and with it the order of every sum."""
    return max(1, min(LOSS_MAX_BLOCKS, -(-n_voxels // LOSS_BLOCK)))


def n_sums(P: int, mode: str) -> int:
    """The sums a launch writes: loss, min(P, 6) gradient entries and P
    Hessian entries in REDUCE; the loss alone in VALUE."""
    return 1 + min(P, 6) + P if mode == "reduce" else 1


def pack_pose(r_v2c: DCSFD, t_v2c: DCSFD) -> torch.Tensor:
    """The (P, 48) float32 poses B12 reads: R (3x3, row-major) and t (3) of
    the v lane, then of e1, e2 and e12. ``r_v2c`` is (3, 3[, P]), ``t_v2c``
    (3[, P]); a pose without the pair axis packs as P = 1."""
    lanes = []
    for r, t in zip(r_v2c, t_v2c):
        if r.dim() == 2:
            r, t = r[..., None], t[..., None]
        lanes += [r.reshape(9, -1), t.reshape(3, -1)]
    return torch.cat(lanes).t().to(torch.float32).contiguous()


def _unpack_pose(pose_row: torch.Tensor):
    """``(R, t)`` as DCSFDs of one packed pose's 48 floats (views)."""
    lanes = pose_row.view(4, 12)
    return DCSFD(*(lane[:9].view(3, 3) for lane in lanes)), DCSFD(*(lane[9:] for lane in lanes))


# ------------------------------------------------------------------- plain
def _bilinear_depth_dcsfd(depth, image_x: DCSFD, image_y: DCSFD):
    """Hyper-dual bilinear depth sample (TsdfFusion.cu:238-259): interpolate
    when all 4 corners are valid, else the nearest tap (no coordinate
    derivative)."""
    H, W = depth.shape
    cx = to_index(torch.floor(image_x.v - 0.5))
    cy = to_index(torch.floor(image_y.v - 0.5))
    in_bounds = (cx > 1) & (cy > 1) & (cx < W - 1) & (cy < H - 1)

    d00 = gather2d(depth, cy, cx)
    d10 = gather2d(depth, cy, cx + 1)
    d01 = gather2d(depth, cy + 1, cx)
    d11 = gather2d(depth, cy + 1, cx + 1)
    d_near = gather2d(depth, to_index(torch.round(image_y.v)), to_index(torch.round(image_x.v)))
    all_valid = (d00 != 0.0) & (d01 != 0.0) & (d10 != 0.0) & (d11 != 0.0)

    a = image_x - (cx.to(torch.float32) + 0.5)
    b = image_y - (cy.to(torch.float32) + 0.5)
    one = dc.lift(1.0, like=a)
    interp = (
        dc.lift(d00) * (one - a) * (one - b)
        + dc.lift(d10) * a * (one - b)
        + dc.lift(d01) * (one - a) * b
        + dc.lift(d11) * a * b
    )
    dp = dc.where(all_valid, interp, dc.lift(d_near))
    return dp, in_bounds


def _compact(gt_value, cfg: VolumeConfig, x_offset: int = 0):
    """The voxels of ``gt_value`` that pass ``gt``'s test (``gt != 0`` and
    ``|gt| <= 0.95``, pose-independent; the reference skips the others
    first): their flat indices, values and centres ``(gx, gy, gz)``, each the
    JAX package's ``(arange + 0.5 + x_offset) * vs`` of its index."""
    gt_ok = (gt_value != 0.0) & (torch.abs(gt_value) <= 0.95)
    flat = torch.nonzero(gt_ok.reshape(-1)).reshape(-1)
    X, Y, Z = gt_value.shape
    ix, iy, iz = flat // (Y * Z), (flat // Z) % Y, flat % Z
    vs = cfg.voxel_size
    gx = (ix.to(torch.float32) + 0.5 + x_offset) * vs
    gy = (iy.to(torch.float32) + 0.5) * vs
    gz = (iz.to(torch.float32) + 0.5) * vs
    return flat, gt_value.reshape(-1)[flat], (gx, gy, gz)


def _voxel_loss(gt, centres, depth_m, pose_row, intr: Intrinsics, cfg: VolumeConfig):
    """One packed pose's loss (a DCSFD) and mask at voxels that passed gt's
    test (``xslam_tpu/ops/tsdf_loss.py:83-118`` past ``gt_ok``), operation for
    operation."""
    r_v2c, t_v2c = _unpack_pose(pose_row)
    gx, gy, gz = centres

    def R(i, j):
        return DCSFD(*(lane[i, j] for lane in r_v2c))

    def t(i):
        return DCSFD(*(lane[i] for lane in t_v2c))

    def cam(i):
        return R(i, 0) * dc.lift(gx) + R(i, 1) * dc.lift(gy) + R(i, 2) * dc.lift(gz) + t(i)

    vcx, vcy, vcz = cam(0), cam(1), cam(2)
    inv_z = dc.lift(1.0) / vcz
    front = inv_z.v >= 0.0

    image_x = vcx * inv_z * intr.fx + intr.cx
    image_y = vcy * inv_z * intr.fy + intr.cy

    dp, in_bounds = _bilinear_depth_dcsfd(depth_m, image_x, image_y)
    range_ok = (dp.v >= 0.2) & (dp.v <= 5.0)

    xl = (image_x - intr.cx) / intr.fx
    yl = (image_y - intr.cy) / intr.fy
    lam2 = xl * xl + yl * yl + dc.lift(1.0)
    distance = dp * dc.sqrt(lam2) - dc.sqrt(vcx * vcx + vcy * vcy + vcz * vcz)

    gt_distance = gt * cfg.trunc_dist
    error = (distance - dc.lift(gt_distance)) * (1.0 / cfg.trunc_dist)
    err_ok = torch.abs(error.v) <= 1.0

    return error * error, front & in_bounds & range_ok & err_ok


def _field_plain(gt_value, depth_m, pose_row, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0):
    """One packed pose's per-voxel loss (a DCSFD of (X, Y, Z) lanes) and mask
    (``return_field``), as B12's FIELD mode writes them: zero lanes and a
    false mask where ``gt`` fails its test."""
    flat, gt, centres = _compact(gt_value, cfg, x_offset)
    loss, mask = _voxel_loss(gt, centres, depth_m, pose_row, intr, cfg)

    def scatter(x, fill):
        out = torch.full((gt_value.numel(),), fill, dtype=x.dtype, device=x.device)
        out[flat] = x
        return out.view(gt_value.shape)

    return DCSFD(*(scatter(lane, 0.0) for lane in loss)), scatter(mask, False)


def _slabs(gt_value):
    """X-slabs of the volume of at most :data:`SLAB_VOXELS` voxels: (x0, x1)."""
    X, Y, Z = gt_value.shape
    step = max(1, SLAB_VOXELS // max(1, Y * Z))
    return [(x0, min(X, x0 + step)) for x0 in range(0, X, step)]


def tsdf_loss_hessian_plain(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                            mode: str = "reduce"):
    """B12's plain version for ``poses`` (P, 48) (:func:`pack_pose`):
    ``(sums, count)``, the sums laid out as the kernel writes them
    (:func:`n_sums`): in ``"reduce"`` mode pair 0's masked sum of ``loss.v``,
    the first ``min(P, 6)`` pairs' sums of ``loss.e1``, every pair's sum of
    ``loss.e12``; in ``"value"`` mode pair 0's loss sum alone. Slab after
    slab, the voxels that pass gt's test, pair after pair; each float32 term
    is added in float64 and each sum rounded once to float32; the count is
    pair 0's."""
    if mode not in ("reduce", "value"):
        raise ValueError(f"mode: expected 'reduce' or 'value', got {mode!r}")
    P = poses.shape[0] if mode == "reduce" else 1
    G = min(P, 6)
    sums = torch.zeros(n_sums(P, mode), dtype=torch.float64, device=gt_value.device)
    count = torch.zeros((), dtype=torch.int64, device=gt_value.device)
    for x0, x1 in _slabs(gt_value):
        _, gt, centres = _compact(gt_value[x0:x1], cfg, x_offset + x0)
        for p in range(P):
            loss, mask = _voxel_loss(gt, centres, depth_m, poses[p], intr, cfg)

            def msum(a):
                return torch.where(mask, a, 0.0).to(torch.float64).sum()

            if p == 0:
                sums[0] += msum(loss.v)
                count += mask.sum()
            if mode == "reduce":
                if p < G:
                    sums[1 + p] += msum(loss.e1)
                sums[1 + G + p] += msum(loss.e12)
    return sums.to(torch.float32), count.to(torch.int32)


# ------------------------------------------------------------------- kernel
class _Scratch:
    """B12's scratch on one device and stream (launches on one stream run in
    order): the blocks' partial sums and the ticket counter, which the kernel
    leaves zeroed."""

    def __init__(self, device: torch.device):
        n = LOSS_MAX_BLOCKS * (n_sums(MAX_PAIRS, "reduce") + 1)
        self.partials = torch.empty(n, dtype=torch.float64, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)


_scratch: dict = {}  # (device, stream) -> _Scratch


def _loss_scratch(device: torch.device) -> _Scratch:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _scratch:
        _scratch[key] = _Scratch(device)
    return _scratch[key]


def _check(gt_value, depth_m, poses):
    if gt_value.dim() != 3:
        raise ValueError(f"gt_value: expected (X, Y, Z), got {tuple(gt_value.shape)}")
    if depth_m.dim() != 2:
        raise ValueError(f"depth_m: expected (H, W), got {tuple(depth_m.shape)}")
    if poses.dim() != 2 or poses.shape[1] != POSE_FLOATS or not 1 <= poses.shape[0] <= MAX_PAIRS:
        raise ValueError(f"poses: expected (P, {POSE_FLOATS}) with 1 <= P <= {MAX_PAIRS}, got {tuple(poses.shape)}")
    kernels.check_tensor(gt_value, "gt_value", torch.float32)
    kernels.check_tensor(depth_m, "depth_m", torch.float32)
    kernels.check_tensor(poses, "poses", torch.float32)
    if gt_value.numel() >= 1 << 31:
        raise ValueError("B12 takes fewer than 2^31 voxels")


def _launch(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int, mode: str,
            field_pair: int = 0, sums=None, count=None, field=None, field_mask=None) -> None:
    dev = gt_value.device
    scratch = _loss_scratch(dev) if mode != "field" else None
    kernels.launch(
        "tsdf_loss", dev, gt_value, depth_m, poses, MODES[mode], int(field_pair),
        None if scratch is None else scratch.partials, None if scratch is None else scratch.ticket,
        loss_blocks(gt_value.numel()), sums, count, field, field_mask, int(x_offset),
        kernels.f32(cfg.voxel_size), kernels.f32(intr.fx), kernels.f32(intr.fy), kernels.f32(intr.cx),
        kernels.f32(intr.cy), kernels.f32(cfg.trunc_dist), kernels.reciprocal_f32(cfg.trunc_dist),
    )
    kernels.launch_counts["tsdf_loss"] += 1


def tsdf_loss_pairs(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                    mode: str = "reduce"):
    """``(sums, count)`` of :func:`tsdf_loss_hessian_plain` for ``poses``
    (P, 48): one launch of kernel B12 on CUDA tensors, the plain version on
    CPU tensors. ``"value"`` mode evaluates the v lane of pair 0 alone."""
    if kernels.on_cpu(gt_value, depth_m, poses):
        return tsdf_loss_hessian_plain(gt_value, depth_m, poses, intr, cfg, x_offset, mode)
    if mode not in ("reduce", "value"):
        raise ValueError(f"mode: expected 'reduce' or 'value', got {mode!r}")
    _check(gt_value, depth_m, poses)
    P = poses.shape[0]
    sums = torch.empty(n_sums(P, mode), dtype=torch.float32, device=gt_value.device)
    count = torch.empty((), dtype=torch.int32, device=gt_value.device)
    _launch(gt_value, depth_m, poses, intr, cfg, x_offset, mode, sums=sums, count=count)
    return sums, count


def tsdf_loss_field(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                    pair: int = 0):
    """Pair ``pair``'s per-voxel loss (a DCSFD of (X, Y, Z) lanes) and mask:
    B12's FIELD mode on CUDA tensors (zero lanes where ``gt`` fails its test),
    :func:`_field_plain` on CPU tensors."""
    if kernels.on_cpu(gt_value, depth_m, poses):
        return _field_plain(gt_value, depth_m, poses[pair], intr, cfg, x_offset)
    _check(gt_value, depth_m, poses)
    if not 0 <= pair < poses.shape[0]:
        raise ValueError(f"pair {pair} of {poses.shape[0]}")
    field = torch.empty((4,) + tuple(gt_value.shape), dtype=torch.float32, device=gt_value.device)
    mask = torch.empty(gt_value.shape, dtype=torch.bool, device=gt_value.device)
    _launch(gt_value, depth_m, poses, intr, cfg, x_offset, "field", field_pair=pair, field=field, field_mask=mask)
    return DCSFD(*field.unbind(0)), mask


# ------------------------------------------------------------------- JAX API
def tsdf_loss_hessian(
    gt_value: torch.Tensor,
    depth_m: torch.Tensor,
    r_v2c: DCSFD,
    t_v2c: DCSFD,
    intr: Intrinsics,
    cfg: VolumeConfig,
    x_offset: int = 0,
    return_field: bool = False,
):
    """Per-voxel relocalization loss, reduced to (loss, grad, hess, count).

    ``r_v2c`` (3, 3) / ``t_v2c`` (3,): the hyper-dual volume->camera pose;
    the seed directions in its e1/e2 lanes select which directional
    derivative and Hessian entry the sums carry. With ``return_field`` the
    per-voxel loss and mask instead. One B12 launch on CUDA tensors."""
    poses = pack_pose(r_v2c, t_v2c)
    if return_field:
        return tsdf_loss_field(gt_value, depth_m, poses, intr, cfg, x_offset)
    sums, count = tsdf_loss_pairs(gt_value, depth_m, poses, intr, cfg, x_offset)
    return TsdfLossResult(loss=sums[0], grad=sums[1], hessian=sums[2], count=count)


def tsdf_loss(
    gt_value: torch.Tensor,
    depth_m: torch.Tensor,
    r_v2c: torch.Tensor,
    t_v2c: torch.Tensor,
    intr: Intrinsics,
    cfg: VolumeConfig,
) -> TsdfLossResult:
    """Real-valued path (``ComputeLocalTsdfLossKernel``,
    TsdfFusion.cu:335-410): the loss and count at a real pose, gradient and
    Hessian zero. B12's VALUE mode on CUDA tensors; on CPU tensors the plain
    version with zero derivative lanes, as the JAX package computes it."""
    z, zt = torch.zeros_like(r_v2c), torch.zeros_like(t_v2c)
    poses = pack_pose(DCSFD(r_v2c, z, z, z), DCSFD(t_v2c, zt, zt, zt))
    if kernels.on_cpu(gt_value, depth_m, poses):
        return tsdf_loss_hessian(gt_value, depth_m, DCSFD(r_v2c, z, z, z), DCSFD(t_v2c, zt, zt, zt), intr, cfg)
    sums, count = tsdf_loss_pairs(gt_value, depth_m, poses, intr, cfg, mode="value")
    zero = torch.zeros((), dtype=torch.float32, device=gt_value.device)
    return TsdfLossResult(loss=sums[0], grad=zero, hessian=zero.clone(), count=count)
