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
contract; :func:`tsdf_loss_pairs` evaluates packed poses (the 21 seed pairs
of ``models/relocalize.py``, or one pose) at once. They are the wrappers of
kernel B12 (``csrc/tsdf_loss.cu``): on CUDA tensors they launch it, on CPU
tensors they run the plain versions (:func:`tsdf_loss_hessian_plain`,
:func:`_field_plain`), never one in place of the other.

The voxels that pass ``gt``'s test (the others are masked whatever the
pose) are the band: :func:`make_band` lists them once (flat indices in C
order and their count, on the device; :func:`band_plain` on the CPU), and
the REDUCE and VALUE launches walk the band, not the volume. A caller that
evaluates many poses on one map (``models/relocalize.py::newton``) makes
the band once and passes it to every call; the wrappers make their own
otherwise. The kernel computes a voxel's value lane and its six
first-derivative lanes once and each seed pair's second-derivative lane
from them (:func:`_shared_lanes_plain` is that arithmetic in plain
PyTorch). The plain versions list the voxels that pass ``gt``'s test
themselves (:func:`band_plain`'s order; never a band they are given), take
them in chunks and loop over the pairs, so that they fit on the card at
256^3, and sum each masked float32 term in float64 with one rounding to
float32 at the end; the kernel adds the same
terms in double in an order fixed by the band's length (its grid is fixed,
:data:`LOSS_BLOCKS`), so the sums agree within a float32 ulp and the count
exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..csfd import double as dc
from ..csfd.double import DCSFD
from ..csfd.single import _reciprocal
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .fusion import VolumeConfig
from .sampling import gather2d, to_index

# csrc/tsdf_loss.cu: threads (band voxels) a block, blocks of a REDUCE or VALUE launch, groups of blocks the last
# block adds side by side, most seed pairs, floats of a packed pose, voxels a warp of the band pass counts and
# lists, warps of its blocks
LOSS_THREADS = 128
LOSS_BLOCKS = 264
LOSS_GROUPS = 4
MAX_PAIRS = 21
POSE_FLOATS = 48
BAND_SEGMENT = 1024
BAND_WARPS = 8
BAND_TILE = BAND_WARPS * BAND_SEGMENT
MODES = {"reduce": 0, "value": 1}
CHUNK_VOXELS = 1 << 21  # the plain version's chunk of the band: at most this many voxels at a time


def _seed_pairs():
    """The 21 seed pairs' directions ``(j, k)`` in ``models/relocalize.py``'s
    order: (d, d) for d < 6, then (j, k), j < k, row by row."""
    pairs = [(d, d) for d in range(6)] + [(j, k) for j in range(6) for k in range(j + 1, 6)]
    return np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])


SEED_J, SEED_K = _seed_pairs()


class TsdfLossResult(NamedTuple):
    loss: torch.Tensor
    grad: torch.Tensor
    hessian: torch.Tensor
    count: torch.Tensor


class Band(NamedTuple):
    """The voxels of a value plane that pass ``gt``'s test: ``index`` holds
    their flat int32 indices in C order, then unused room (its length is the
    volume's voxels), and ``count`` (a 0-d int32 tensor) how many there are."""

    index: torch.Tensor
    count: torch.Tensor


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
def _bilinear_depth_dcsfd(depth, image_x, image_y, num=dc):
    """Hyper-dual bilinear depth sample (TsdfFusion.cu:238-259): interpolate
    when all 4 corners are valid, else the nearest tap (no coordinate
    derivative). ``num``: the lanes' module (:mod:`..csfd.double`, or
    :data:`_shared` for the shared lanes)."""
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
    one = num.lift(1.0, like=a)
    interp = (
        num.lift(d00) * (one - a) * (one - b)
        + num.lift(d10) * a * (one - b)
        + num.lift(d01) * (one - a) * b
        + num.lift(d11) * a * b
    )
    dp = num.where(all_valid, interp, num.lift(d_near))
    return dp, in_bounds


def _in_band(gt_value):
    """gt's test: ``gt != 0`` and ``|gt| <= 0.95`` (NaN fails it)."""
    return (gt_value != 0.0) & (torch.abs(gt_value) <= 0.95)


def _centres(flat, shape, cfg: VolumeConfig, x_offset: int = 0):
    """The centres ``(gx, gy, gz)`` of flat indices into an (X, Y, Z) volume:
    the JAX package's ``(arange + 0.5 + x_offset) * vs``."""
    _, Y, Z = shape
    ix, iy, iz = flat // (Y * Z), (flat // Z) % Y, flat % Z
    vs = cfg.voxel_size
    gx = (ix.to(torch.float32) + 0.5 + x_offset) * vs
    gy = (iy.to(torch.float32) + 0.5) * vs
    gz = (iz.to(torch.float32) + 0.5) * vs
    return gx, gy, gz


def _band_flat(gt_value):
    """The flat indices (int64, C order) of the voxels of ``gt_value`` that
    pass ``gt``'s test (pose-independent; the reference skips the others
    first)."""
    return torch.nonzero(_in_band(gt_value).reshape(-1)).reshape(-1)


def _loss_chain(num, gt, centres, R, t, depth_m, intr: Intrinsics, cfg: VolumeConfig):
    """The loss and mask at voxels that passed gt's test
    (``xslam_tpu/ops/tsdf_loss.py:83-118`` past ``gt_ok``), operation for
    operation, in the lanes of ``num`` (:mod:`..csfd.double`, or
    :data:`_shared`); ``R(i, j)``, ``t(i)``: the pose's entries as such lanes."""
    gx, gy, gz = centres

    def cam(i):
        return R(i, 0) * num.lift(gx) + R(i, 1) * num.lift(gy) + R(i, 2) * num.lift(gz) + t(i)

    vcx, vcy, vcz = cam(0), cam(1), cam(2)
    inv_z = num.lift(1.0) / vcz
    front = inv_z.v >= 0.0

    image_x = vcx * inv_z * intr.fx + intr.cx
    image_y = vcy * inv_z * intr.fy + intr.cy

    dp, in_bounds = _bilinear_depth_dcsfd(depth_m, image_x, image_y, num)
    range_ok = (dp.v >= 0.2) & (dp.v <= 5.0)

    xl = (image_x - intr.cx) / intr.fx
    yl = (image_y - intr.cy) / intr.fy
    lam2 = xl * xl + yl * yl + num.lift(1.0)
    distance = dp * num.sqrt(lam2) - num.sqrt(vcx * vcx + vcy * vcy + vcz * vcz)

    gt_distance = gt * cfg.trunc_dist
    error = (distance - num.lift(gt_distance)) * (1.0 / cfg.trunc_dist)
    err_ok = torch.abs(error.v) <= 1.0

    return error * error, front & in_bounds & range_ok & err_ok


def _voxel_loss(gt, centres, depth_m, pose_row, intr: Intrinsics, cfg: VolumeConfig):
    """One packed pose's loss (a DCSFD) and mask at voxels that passed gt's
    test: its four lanes."""
    r_v2c, t_v2c = _unpack_pose(pose_row)
    return _loss_chain(dc, gt, centres, lambda i, j: DCSFD(*(lane[i, j] for lane in r_v2c)),
                       lambda i: DCSFD(*(lane[i] for lane in t_v2c)), depth_m, intr, cfg)


def _field_plain(gt_value, depth_m, pose_row, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0):
    """One packed pose's per-voxel loss (a DCSFD of (X, Y, Z) lanes) and mask
    (``return_field``), as B12's FIELD mode writes them: zero lanes and a
    false mask where ``gt`` fails its test."""
    flat = _band_flat(gt_value)
    loss, mask = _voxel_loss(gt_value.reshape(-1)[flat], _centres(flat, gt_value.shape, cfg, x_offset), depth_m,
                             pose_row, intr, cfg)

    def scatter(x, fill):
        out = torch.full((gt_value.numel(),), fill, dtype=x.dtype, device=x.device)
        out[flat] = x
        return out.view(gt_value.shape)

    return DCSFD(*(scatter(lane, 0.0) for lane in loss)), scatter(mask, False)


class _Lanes:
    """Shared hyper-dual lanes (``csrc/tsdf_loss.cu::Lanes``): the value lane
    ``v``, one first-derivative lane a direction ``f`` (D, N) and one
    second-derivative lane a pair ``s`` (P, N); pair p's e1 and e2 lanes are
    ``f[j[p]]`` and ``f[k[p]]``. Every formula is :class:`DCSFD`'s, lane for
    lane, so pair p's lanes are the bits of the four-lane arithmetic with
    those e1 and e2 lanes. A lifted constant's derivative lanes are Python
    zeros (``x * 0.0`` is the float32 product ``x * 0`` of a zero tensor)."""

    __slots__ = ("v", "f", "s", "jk")

    def __init__(self, v, f, s, jk=None):
        self.v, self.f, self.s, self.jk = v, f, s, jk

    def _pairs(self, o):
        return self.jk if self.jk is not None else o.jk

    def __add__(self, o):
        o = _shared.lift(o)
        return _Lanes(self.v + o.v, self.f + o.f, self.s + o.s, self._pairs(o))

    def __sub__(self, o):
        o = _shared.lift(o)
        return _Lanes(self.v - o.v, self.f - o.f, self.s - o.s, self._pairs(o))

    def __mul__(self, o):
        o = _shared.lift(o)
        jk = self._pairs(o)
        e1, e2 = _pick(self.f, jk, 0), _pick(self.f, jk, 1)
        s = self.s * o.v + e1 * _pick(o.f, jk, 1) + e2 * _pick(o.f, jk, 0) + self.v * o.s
        return _Lanes(self.v * o.v, self.f * o.v + self.v * o.f, s, jk)

    def __truediv__(self, o):
        o = _shared.lift(o)
        jk = self._pairs(o)
        q = _reciprocal(o.v)
        v = self.v * q
        f = (self.f - v * o.f) * q
        s = (self.s - _pick(f, jk, 0) * _pick(o.f, jk, 1) - _pick(f, jk, 1) * _pick(o.f, jk, 0) - v * o.s) * q
        return _Lanes(v, f, s, jk)


def _pick(f, jk, which: int):
    """Each pair's e1 (``which`` 0) or e2 (1) lane out of the direction lanes
    ``f``; a lifted constant's zero as it is."""
    return f if isinstance(f, float) else f[jk[which]]


class _shared:
    """:mod:`..csfd.double`'s ``lift``, ``sqrt`` and ``where`` for
    :class:`_Lanes`."""

    @staticmethod
    def lift(x, like=None):
        if isinstance(x, _Lanes):
            return x
        return _Lanes(x if isinstance(x, torch.Tensor) else float(x), 0.0, 0.0)

    @staticmethod
    def sqrt(x):
        fv = torch.sqrt(x.v)
        d1 = 0.5 / fv
        d2 = -0.25 / (fv * x.v)
        return _Lanes(fv, d1 * x.f, d1 * x.s + d2 * _pick(x.f, x.jk, 0) * _pick(x.f, x.jk, 1), x.jk)

    @staticmethod
    def where(pred, a, b):
        a, b = _shared.lift(a), _shared.lift(b)
        return _Lanes(*(torch.where(pred, x, y) for x, y in ((a.v, b.v), (a.f, b.f), (a.s, b.s))), a._pairs(b))


def _layout(P: int, device):
    """A packed pose set's directions: the 21 seed pairs (direction d: pose
    d's e1 lanes) or one pose (its e1 and e2 lanes); ``(rows, offsets, jk)``
    of the direction lanes and each pair's ``(j, k)``."""
    if P == MAX_PAIRS:
        rows, offsets, j, k = list(range(6)), [12] * 6, SEED_J, SEED_K
    elif P == 1:
        rows, offsets, j, k = [0, 0], [12, 24], np.array([0]), np.array([1])
    else:
        raise ValueError(f"the shared lanes take the {MAX_PAIRS} seed pairs or one pose, got {P}")
    return rows, offsets, tuple(torch.as_tensor(a, device=device) for a in (j, k))


def _shared_lanes_plain(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                        band: Band = None):
    """B12's shared-lane arithmetic in plain PyTorch at the band's voxels
    (:func:`band_plain` where ``band`` is None): ``(loss, mask)``, ``loss`` a
    :class:`_Lanes` with ``v`` (N,), ``f`` (D, N) the first-derivative lanes
    of the loss and ``s`` (P, N) the pairs' second-derivative lanes, for the
    21 seed pairs (whose lanes :func:`..models.relocalize.seeded_poses` makes
    shared) or one pose. Pair p's lanes ``(v, f[j], f[k], s[p])`` are
    :func:`_field_plain`'s bit for bit."""
    band = band_plain(gt_value) if band is None else band
    flat = band.index[: int(band.count)].long()
    rows, offsets, jk = _layout(poses.shape[0], poses.device)

    def entry(e):
        f = torch.stack([poses[r, o + e] for r, o in zip(rows, offsets)])[:, None]
        return _Lanes(poses[0, e], f, poses[:, 36 + e][:, None], jk)

    loss, mask = _loss_chain(_shared, gt_value.reshape(-1)[flat], _centres(flat, gt_value.shape, cfg, x_offset),
                             lambda i, j: entry(3 * i + j), lambda i: entry(9 + i), depth_m, intr, cfg)
    return loss, mask


def _chunks(gt_value, cfg: VolumeConfig, x_offset: int):
    """The voxels that pass gt's test, listed here in flat order, at most
    :data:`CHUNK_VOXELS` at a time: ``(gt, centres)`` of each chunk."""
    flat = _band_flat(gt_value)
    for i in range(0, flat.numel(), CHUNK_VOXELS):
        part = flat[i:i + CHUNK_VOXELS]
        yield gt_value.reshape(-1)[part], _centres(part, gt_value.shape, cfg, x_offset)


def tsdf_loss_hessian_plain(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                            mode: str = "reduce"):
    """B12's plain version for ``poses`` (P, 48) (:func:`pack_pose`):
    ``(sums, count)``, the sums laid out as the kernel writes them
    (:func:`n_sums`): in ``"reduce"`` mode pair 0's masked sum of ``loss.v``,
    the first ``min(P, 6)`` pairs' sums of ``loss.e1``, every pair's sum of
    ``loss.e12``; in ``"value"`` mode pair 0's loss sum alone. Chunk after
    chunk of the voxels that pass gt's test (listed here, never taken from
    :func:`make_band`), pair after pair, each with its own four lanes; each float32 term is added
    in float64 and each sum rounded once to float32; the count is pair 0's."""
    if mode not in MODES:
        raise ValueError(f"mode: expected 'reduce' or 'value', got {mode!r}")
    P = poses.shape[0] if mode == "reduce" else 1
    G = min(P, 6)
    sums = torch.zeros(n_sums(P, mode), dtype=torch.float64, device=gt_value.device)
    count = torch.zeros((), dtype=torch.int64, device=gt_value.device)
    for gt, centres in _chunks(gt_value, cfg, x_offset):
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


def band_plain(gt_value) -> Band:
    """:func:`make_band`'s plain version: ``torch.nonzero`` of gt's test."""
    flat = _band_flat(gt_value)
    index = torch.zeros(gt_value.numel(), dtype=torch.int32, device=gt_value.device)
    index[: flat.numel()] = flat.to(torch.int32)
    return Band(index, torch.tensor(flat.numel(), dtype=torch.int32, device=gt_value.device))


# ------------------------------------------------------------------- kernel
class _Scratch:
    """B12's scratch on one device and stream (launches on one stream run in
    order): the blocks' partial sums and the ticket counter, which the kernel
    leaves zeroed."""

    def __init__(self, device: torch.device):
        self.partials = torch.empty(LOSS_BLOCKS * (n_sums(MAX_PAIRS, "reduce") + 1), dtype=torch.float64,
                                    device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)


_scratch: dict = {}  # (device, stream) -> _Scratch
_bands: dict = {}  # (device, stream, voxels) -> (the wrappers' own Band, the band pass's counts)


def _stream_key(device: torch.device):
    return device, torch.cuda.current_stream(device).cuda_stream


def _loss_scratch(device: torch.device) -> _Scratch:
    key = _stream_key(device)
    if key not in _scratch:
        _scratch[key] = _Scratch(device)
    return _scratch[key]


def _band_counts(device: torch.device, n: int) -> torch.Tensor:
    """The band pass's scratch: a count a tile of :data:`BAND_TILE` voxels,
    a count a warp's segment, then the segments' ballots (a bit a voxel)."""
    tiles = -(-n // BAND_TILE)
    return torch.empty(tiles * (1 + BAND_WARPS + BAND_TILE // 32), dtype=torch.int32, device=device)


def _list_band(gt_value, band: Band, counts: torch.Tensor) -> Band:
    kernels.launch("tsdf_band", gt_value.device, gt_value, counts, band.index, band.count)
    kernels.launch_counts["tsdf_band"] += 1
    return band


def _check_volume(gt_value):
    if gt_value.dim() != 3:
        raise ValueError(f"gt_value: expected (X, Y, Z), got {tuple(gt_value.shape)}")
    kernels.check_tensor(gt_value, "gt_value", torch.float32)
    if not 1 <= gt_value.numel() < 1 << 31:
        raise ValueError("B12 takes 1 to 2^31 - 1 voxels")


def make_band(gt_value) -> Band:
    """The band of ``gt_value``: one launch of B12's band pass on a CUDA
    tensor (into a new :class:`Band`; the caller passes it to every B12 call
    on this value plane), :func:`band_plain` on a CPU tensor."""
    if kernels.on_cpu(gt_value):
        return band_plain(gt_value)
    _check_volume(gt_value)
    n, dev = gt_value.numel(), gt_value.device
    band = Band(torch.empty(n, dtype=torch.int32, device=dev), torch.empty((), dtype=torch.int32, device=dev))
    return _list_band(gt_value, band, _band_counts(dev, n))


def _own_band(gt_value) -> Band:
    """The wrappers' band of ``gt_value``, listed into buffers kept for the
    device, the stream and the volume's size."""
    n, dev = gt_value.numel(), gt_value.device
    key = _stream_key(dev) + (n,)
    if key not in _bands:
        _bands[key] = (Band(torch.empty(n, dtype=torch.int32, device=dev),
                            torch.empty((), dtype=torch.int32, device=dev)), _band_counts(dev, n))
    return _list_band(gt_value, *_bands[key])


def _check(gt_value, depth_m, poses, shared: bool):
    _check_volume(gt_value)
    if depth_m.dim() != 2:
        raise ValueError(f"depth_m: expected (H, W), got {tuple(depth_m.shape)}")
    if poses.dim() != 2 or poses.shape[1] != POSE_FLOATS or not 1 <= poses.shape[0] <= MAX_PAIRS:
        raise ValueError(f"poses: expected (P, {POSE_FLOATS}) with 1 <= P <= {MAX_PAIRS}, got {tuple(poses.shape)}")
    if shared and poses.shape[0] not in (1, MAX_PAIRS):
        raise ValueError(f"B12's shared lanes take the {MAX_PAIRS} seed pairs or one pose, got {poses.shape[0]}")
    kernels.check_tensor(depth_m, "depth_m", torch.float32)
    kernels.check_tensor(poses, "poses", torch.float32)


def _geometry(intr: Intrinsics, cfg: VolumeConfig, x_offset: int):
    return (int(x_offset), kernels.f32(cfg.voxel_size), kernels.f32(intr.fx), kernels.f32(intr.fy),
            kernels.f32(intr.cx), kernels.f32(intr.cy), kernels.f32(cfg.trunc_dist),
            kernels.reciprocal_f32(cfg.trunc_dist))


def tsdf_loss_pairs(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                    mode: str = "reduce", band: Band = None):
    """``(sums, count)`` of :func:`tsdf_loss_hessian_plain` for ``poses``
    (P, 48; in ``"reduce"`` mode on the card the 21 seed pairs of
    ``models/relocalize.py::seeded_poses`` or one pose): one launch of kernel
    B12 over ``band`` (:func:`make_band` of ``gt_value``; listed here where
    None) on CUDA tensors, the plain version on CPU tensors (which lists the
    same band itself). ``"value"`` mode evaluates the v lane of pose 0
    alone."""
    if band is not None and (band.index.shape != (gt_value.numel(),) or band.index.dtype != torch.int32 or
                             band.index.device != gt_value.device or band.count.shape != ()):
        raise ValueError("band: expected make_band of this value plane")
    if kernels.on_cpu(gt_value, depth_m, poses):
        return tsdf_loss_hessian_plain(gt_value, depth_m, poses, intr, cfg, x_offset, mode)
    if mode not in MODES:
        raise ValueError(f"mode: expected 'reduce' or 'value', got {mode!r}")
    _check(gt_value, depth_m, poses, shared=mode == "reduce")
    if band is None:
        band = _own_band(gt_value)
    dev = gt_value.device
    scratch = _loss_scratch(dev)
    sums = torch.empty(n_sums(poses.shape[0], mode), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    kernels.launch("tsdf_loss", dev, gt_value, depth_m, poses, MODES[mode], band.index, band.count,
                   scratch.partials, scratch.ticket, sums, count, *_geometry(intr, cfg, x_offset))
    kernels.launch_counts["tsdf_loss"] += 1
    return sums, count


def tsdf_loss_field(gt_value, depth_m, poses, intr: Intrinsics, cfg: VolumeConfig, x_offset: int = 0,
                    pair: int = 0):
    """Pair ``pair``'s per-voxel loss (a DCSFD of (X, Y, Z) lanes) and mask:
    B12's FIELD mode on CUDA tensors (the shared lanes; the 21 seed pairs or
    one pose; zero lanes where ``gt`` fails its test; NaN lanes and a false
    mask everywhere where the 21 poses' lanes are not shared, as REDUCE
    refuses them), :func:`_field_plain` on CPU tensors. Its launch counts
    under ``"tsdf_loss"``: B12's count stands for its two device kernels,
    ``tsdf_loss_kernel`` and ``tsdf_field_kernel`` (FIELD runs on no path)."""
    if kernels.on_cpu(gt_value, depth_m, poses):
        return _field_plain(gt_value, depth_m, poses[pair], intr, cfg, x_offset)
    _check(gt_value, depth_m, poses, shared=True)
    if not 0 <= pair < poses.shape[0]:
        raise ValueError(f"pair {pair} of {poses.shape[0]}")
    field = torch.empty((4,) + tuple(gt_value.shape), dtype=torch.float32, device=gt_value.device)
    mask = torch.empty(gt_value.shape, dtype=torch.bool, device=gt_value.device)
    kernels.launch("tsdf_field", gt_value.device, gt_value, depth_m, poses, int(pair), field, mask,
                   *_geometry(intr, cfg, x_offset))
    kernels.launch_counts["tsdf_loss"] += 1
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
    per-voxel loss and mask instead. On CUDA tensors the band pass, then one
    B12 launch."""
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
    Hessian zero. The band pass and B12's VALUE mode on CUDA tensors; on CPU
    tensors the plain version with zero derivative lanes, as the JAX package
    computes it."""
    z, zt = torch.zeros_like(r_v2c), torch.zeros_like(t_v2c)
    poses = pack_pose(DCSFD(r_v2c, z, z, z), DCSFD(t_v2c, zt, zt, zt))
    if kernels.on_cpu(gt_value, depth_m, poses):
        return tsdf_loss_hessian(gt_value, depth_m, DCSFD(r_v2c, z, z, z), DCSFD(t_v2c, zt, zt, zt), intr, cfg)
    sums, count = tsdf_loss_pairs(gt_value, depth_m, poses, intr, cfg, mode="value")
    zero = torch.zeros((), dtype=torch.float32, device=gt_value.device)
    return TsdfLossResult(loss=sums[0], grad=zero, hessian=zero.clone(), count=count)
