"""Brick fusion on the dense volume: conservative culling of the voxels whose
depth is read.

Port of ``xslam_tpu/ops/fusion_brick.py::integrate_brick`` with the coarse
classifier (``classify_fine`` and ``classify_split`` off) and no subcell
stage. The volume's 8^3 bricks are classified against the frame with
interval arithmetic over min/max depth mips: NONE (provably no voxel
updates), FAR and FAR_PARTIAL (every voxel that passes its pixel gate
provably takes the saturated "beyond" sample, so the update needs no depth
read), ACTIVE (the exact per-voxel update). Every test errs toward ACTIVE,
so the volume equals dense fusion's bit for bit. ``cap`` bounds the ACTIVE
bricks that are fused; past it the frame overflows: with ``"flag"`` the
bricks of rank ``>= cap`` (flat brick order) stay unfused and the flag is
raised, with ``"dense"`` the frame is fused exactly everywhere instead, from
the pre-frame volume.

Three kernels (``csrc/bricks.cu``), each wrapped here beside its plain
version; a wrapper runs the plain version on CPU tensors and launches its
kernel on CUDA tensors, never falling back:

- B3a :func:`depth_mips` (plain :func:`depth_mips_plain`, the port of
  ``_depth_mips`` with ``_footprint_bounds``' table): per tile (min, max over
  valid depths, all valid) at every ``MIP_LEVELS`` tile size, in one
  ``(rows, 3)`` table laid out by :func:`mip_layout`;
- B3b :func:`classify_bricks` (plain :func:`classify_bricks_plain` and
  :func:`rank_bricks_plain`, the ports of ``_classify_boxes`` with
  ``split=False`` and of the compaction in ``_integrate_rows_core``): the
  classes, the ACTIVE list and the work list in flat brick order, the
  counts and the overflow flag, all on the device, in one launch;
- B3c :func:`fuse_bricks` (plain :func:`fuse_bricks_plain`, the port of
  ``_integrate_rows_core`` with ``subcell_cap=0`` over ``to_bricks`` rows):
  the FAR pass and the exact update of the ACTIVE bricks, in place; with
  ``bi_threshold > 0`` the exact update samples the depth bilinearly (B11,
  count ``fuse_bricks_bilinear``), as ``_integrate_rows_core`` passes its
  ``bi_threshold`` to ``_voxel_update``. The classes and the FAR pass are the
  nearest branch's there as here: the classifier's proofs allow the nearest
  sample's half pixel, not the bilinear block's, so under bilinear sampling
  the result may part from :func:`xslam_tpu_torch.ops.fusion.integrate`'s
  where the JAX package's parts.

On the card the classifier follows PyTorch's CUDA division by a host number
(a multiply by the reciprocal taken in double) and so equals its plain
version there; on the CPU that version divides truly, as the JAX package
does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..csfd.single import CSFD
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .sampling import to_index

BRICK = 8
# footprint-window tile sizes in pixels (xslam_tpu/ops/fusion_brick.py:50-53): a ~1.15x ladder
MIP_LEVELS = (
    8, 9, 10, 11, 12, 14, 16, 18, 20, 23, 26, 30, 34, 39, 45, 52, 60, 69,
    80, 92, 106, 128,
)
NONE, FAR, ACTIVE, FAR_PARTIAL = 0, 1, 2, 3
CLASSIFY_TILE = 128  # bricks a tile (a block) of csrc/bricks.cu's classifier scan
CLASSIFY_STATUS_STRIDE = 16  # 8-byte words of the classifier's scratch a tile: its status word, one a 128 B line


class MipLayout(NamedTuple):
    """Where each level's tiles lie in the mip table."""

    sizes: Tuple[int, ...]  # tile edge in pixels, one a level
    shapes: Tuple[Tuple[int, int], ...]  # tiles down and across
    offsets: Tuple[int, ...]  # first row of the level
    rows: int


class BrickClasses(NamedTuple):
    """What the classifier leaves on the device for the fusion pass."""

    cls: torch.Tensor  # (nbx, nby, nbz) int32: NONE, FAR, ACTIVE, FAR_PARTIAL
    rank: torch.Tensor  # (NB,) int32: an ACTIVE brick's place in flat order, -1 elsewhere
    active_ids: torch.Tensor  # (NB,) int32: the ACTIVE bricks in flat order (the first n_active)
    work_ids: torch.Tensor  # (NB,) int32: the non-NONE bricks in flat order (the first n_work)
    totals: torch.Tensor  # (2,) int32: n_active, n_work
    overflow: torch.Tensor  # () bool: n_active > cap


def mip_sizes(H: int, W: int):
    return [ts for ts in MIP_LEVELS if H // ts >= 1 and W // ts >= 1]


def mip_layout(H: int, W: int) -> MipLayout:
    sizes = mip_sizes(H, W)
    shapes = tuple((-(-H // ts), -(-W // ts)) for ts in sizes)
    offsets, at = [], 0
    for h, w in shapes:
        offsets.append(at)
        at += h * w
    return MipLayout(tuple(sizes), shapes, tuple(offsets), at)


def _layout_ints(layout: MipLayout) -> list:
    """Four ints a level, as the kernels take the layout."""
    return [n for ts, (h, w), off in zip(layout.sizes, layout.shapes, layout.offsets) for n in (ts, h, w, off)]


def _check_resolution(resolution) -> Tuple[int, int, int]:
    X, Y, Z = resolution
    if X % BRICK or Y % BRICK or Z % BRICK:
        raise ValueError(f"brick fusion needs extents that are multiples of {BRICK}, got {tuple(resolution)}")
    return X // BRICK, Y // BRICK, Z // BRICK


def to_bricks(v: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) -> (NB, 512) brick-major rows, bricks in flat (x, y, z) order."""
    X, Y, Z = v.shape
    return (v.reshape(X // BRICK, BRICK, Y // BRICK, BRICK, Z // BRICK, BRICK)
            .permute(0, 2, 4, 1, 3, 5).reshape(-1, BRICK ** 3))


def from_bricks(b: torch.Tensor, res) -> torch.Tensor:
    X, Y, Z = res
    return (b.reshape(X // BRICK, Y // BRICK, Z // BRICK, BRICK, BRICK, BRICK)
            .permute(0, 3, 1, 4, 2, 5).reshape(X, Y, Z))


# ------------------------------------------------------------------ B3a mips
def depth_mips_plain(depth_m: torch.Tensor) -> torch.Tensor:
    """Plain version of B3a: the ``(rows, 3)`` table of (min over valid, max
    over valid, all valid as 0/1) per tile, level after level; edge tiles
    are padded with +inf / -inf / valid."""
    H, W = depth_m.shape
    layout = mip_layout(H, W)
    valid = depth_m > 0.0
    mn_src = torch.where(valid, depth_m, torch.inf)
    mx_src = torch.where(valid, depth_m, -torch.inf)
    rows = []
    for ts, (h, w) in zip(layout.sizes, layout.shapes):
        def padded(x, fill, ts=ts, h=h, w=w):
            out = torch.full((h * ts, w * ts), fill, dtype=x.dtype, device=x.device)
            out[:H, :W] = x
            return out.reshape(h, ts, w, ts)

        mn = torch.amin(padded(mn_src, torch.inf), dim=(1, 3))
        mx = torch.amax(padded(mx_src, -torch.inf), dim=(1, 3))
        av = torch.all(torch.all(padded(valid, True), dim=3), dim=1)
        rows.append(torch.stack([mn.reshape(-1), mx.reshape(-1), av.reshape(-1).to(torch.float32)], dim=1))
    return torch.cat(rows)


def depth_mips(depth_m: torch.Tensor) -> torch.Tensor:
    """B3a: the mip table of a depth image in metres (:func:`depth_mips_plain`'s
    contract); one launch on the card."""
    if depth_m.dim() != 2:
        raise ValueError(f"depth_m: expected (H, W), got {tuple(depth_m.shape)}")
    if kernels.on_cpu(depth_m):
        return depth_mips_plain(depth_m)
    kernels.check_tensor(depth_m, "depth_m", torch.float32)
    H, W = depth_m.shape
    layout = mip_layout(H, W)
    if not layout.sizes:
        raise ValueError(f"a {H}x{W} depth is smaller than the smallest mip tile")
    table = torch.empty((layout.rows, 3), dtype=torch.float32, device=depth_m.device)
    kernels.launch("depth_mips", depth_m.device, depth_m, table, _layout_ints(layout))
    kernels.launch_counts["depth_mips"] += 1
    return table


# ------------------------------------------------------------ B3b classifier
def classify_bricks_plain(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg) -> torch.Tensor:
    """Plain version of B3b's classes: the port of ``_classify_boxes`` with
    ``split=False`` on the brick grid (``classify_bricks_full``), reading the
    mip table of :func:`depth_mips_plain`. ``pose``: :func:`kernels.
    fusion_pose` of the volume->camera pose (value lanes read). Returns the
    ``(nbx, nby, nbz)`` int32 classes."""
    H, W = intr.height, intr.width
    layout = mip_layout(H, W)
    nb = _check_resolution(cfg.resolution)
    dev = table.device
    r_v2c, t_v2c = kernels.unpack_fusion_pose(pose)
    R, t = r_v2c.v, t_v2c.v
    bm = BRICK * cfg.voxel_size
    bx0 = torch.arange(nb[0], dtype=torch.float32, device=dev)[:, None, None] * bm
    by0 = torch.arange(nb[1], dtype=torch.float32, device=dev)[None, :, None] * bm
    bz0 = torch.arange(nb[2], dtype=torch.float32, device=dev)[None, None, :] * bm

    # the eight corners: image-space bbox, camera z, and the maxima of the four gate planes (a voxel updates
    # only where z > 0 and 2.5 <= img < size - 0.5; for z > 0 each bound is a half-space in camera coordinates)
    planes = (
        (intr.fx, 0.0, intr.cx - 2.5),
        (-intr.fx, 0.0, (W - 0.5) - intr.cx),
        (0.0, intr.fy, intr.cy - 2.5),
        (0.0, -intr.fy, (H - 0.5) - intr.cy),
    )
    us, vs_, zs = [], [], []
    plane_max = [None] * 4
    for dx in (0.0, bm):
        for dy in (0.0, bm):
            for dz in (0.0, bm):
                px, py, pz = bx0 + dx, by0 + dy, bz0 + dz
                cx_ = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
                cy_ = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
                cz_ = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
                zs.append(cz_)
                zc = torch.clamp(cz_, min=1e-6)
                us.append(intr.fx * cx_ / zc + intr.cx)
                vs_.append(intr.fy * cy_ / zc + intr.cy)
                for pi, (a, b, c) in enumerate(planes):
                    val = a * cx_ + b * cy_ + c * cz_
                    plane_max[pi] = val if plane_max[pi] is None else torch.maximum(plane_max[pi], val)
    frustum_out = (plane_max[0] < 0.0) | (plane_max[1] < 0.0) | (plane_max[2] < 0.0) | (plane_max[3] < 0.0)
    zmin, zmax = zs[0], zs[0]
    for z in zs[1:]:
        zmin, zmax = torch.minimum(zmin, z), torch.maximum(zmax, z)

    # the camera's exact distance interval to the solid brick (camera origin in volume coordinates: -R^T t)
    ox = -(R[0, 0] * t[0] + R[1, 0] * t[1] + R[2, 0] * t[2])
    oy = -(R[0, 1] * t[0] + R[1, 1] * t[1] + R[2, 1] * t[2])
    oz = -(R[0, 2] * t[0] + R[1, 2] * t[1] + R[2, 2] * t[2])

    def axis_interval(b0, o):
        lo = torch.abs(o - torch.minimum(torch.maximum(o, b0), b0 + bm))
        hi = torch.maximum(torch.abs(b0 - o), torch.abs(b0 + bm - o))
        return lo, hi

    dxl, dxh = axis_interval(bx0, ox)
    dyl, dyh = axis_interval(by0, oy)
    dzl, dzh = axis_interval(bz0, oz)
    dist_min = torch.clamp(torch.sqrt(dxl * dxl + dyl * dyl + dzl * dzl), min=1e-3)
    dist_max = torch.sqrt(dxh * dxh + dyh * dyh + dzh * dzh)

    umin, umax, vmin, vmax = us[0], us[0], vs_[0], vs_[0]
    for u_ in us[1:]:
        umin, umax = torch.minimum(umin, u_), torch.maximum(umax, u_)
    for v_ in vs_[1:]:
        vmin, vmax = torch.minimum(vmin, v_), torch.maximum(vmax, v_)
    # convexity margin: voxel centres lie inside the corners' hull
    umin, umax = umin - 1.0, umax + 1.0
    vmin, vmax = vmin - 1.0, vmax + 1.0

    fully_behind = zmax < 0.0
    z_safe = zmin > 1e-3
    # conservative against the per-voxel gate img in [2.5, size - 0.5)
    fully_outside = z_safe & ((umax < 2.5) | (umin > W - 0.5) | (vmax < 2.5) | (vmin > H - 0.5))
    fully_inside = z_safe & (umin >= 2.5) & (umax <= W - 1.5) & (vmin >= 2.5) & (vmax <= H - 1.5)
    pr = torch.where(z_safe, 0.5 * torch.maximum(umax - umin, vmax - vmin), torch.inf)
    u = 0.5 * (umin + umax)
    v = 0.5 * (vmin + vmax)

    # the smallest level from searchsorted's whose ALIGNED 2x2 window covers the clipped footprint bbox
    # (the window-coverage fix of the JAX package: a wide enough window can be misaligned)
    n = len(layout.sizes)
    sizes_f = torch.tensor(layout.sizes, dtype=torch.float32, device=dev)
    base_level = torch.searchsorted(sizes_f, pr.reshape(-1).contiguous()).reshape(pr.shape)
    cu = torch.clamp(to_index(u - pr), 0, W - 1)
    cv = torch.clamp(to_index(v - pr), 0, H - 1)
    ucl = torch.clamp(umax, 0.0, W - 1.0)
    vcl = torch.clamp(vmax, 0.0, H - 1.0)
    level = torch.full(base_level.shape, n, dtype=base_level.dtype, device=dev)
    for li in reversed(range(n)):
        ts_l = layout.sizes[li]
        cover = (ucl < ((cu // ts_l) + 2) * ts_l) & (vcl < ((cv // ts_l) + 2) * ts_l)
        level = torch.where(cover & (base_level <= li), li, level)
    level_ok = level < n
    level = torch.clamp(level, 0, n - 1)
    dmin, dmax, all_valid = _footprint_bounds(table, layout, level, cu, cv)

    # lambda = |pixel ray direction| over the footprint bbox clipped to the image
    def coord_interval(c0, c1, centre, f):
        a0, a1 = torch.abs(c0 - centre), torch.abs(c1 - centre)
        inside = (c0 <= centre) & (centre <= c1)
        lo = torch.where(inside, 0.0, torch.minimum(a0, a1)) / abs(f)
        hi = torch.maximum(a0, a1) / abs(f)
        return lo, hi

    xl_lo, xl_hi = coord_interval(torch.clamp(umin, 0.0, W - 1.0), torch.clamp(umax, 0.0, W - 1.0), intr.cx, intr.fx)
    yl_lo, yl_hi = coord_interval(torch.clamp(vmin, 0.0, H - 1.0), torch.clamp(vmax, 0.0, H - 1.0), intr.cy, intr.fy)
    lam_min = torch.sqrt(xl_lo * xl_lo + yl_lo * yl_lo + 1.0)
    lam_max = torch.sqrt(xl_hi * xl_hi + yl_hi * yl_hi + 1.0)

    proj_ok = z_safe & level_ok
    # NONE: entirely beyond the band behind the surface; FAR: every voxel's sample valid and provably past +trunc
    none_by_band = proj_ok & (dmax * lam_max - dist_min < -cfg.trunc_dist)
    provably_far = proj_ok & all_valid & (dmin * lam_min - dist_max > cfg.trunc_dist)
    far = provably_far & fully_inside
    far_partial = provably_far & ~fully_inside
    none = fully_behind | fully_outside | frustum_out | none_by_band
    cls = torch.where(none, NONE, ACTIVE)
    cls = torch.where(far & ~none, FAR, cls)
    cls = torch.where(far_partial & ~none, FAR_PARTIAL, cls)
    return cls.to(torch.int32)


def _footprint_bounds(table, layout: MipLayout, level, cu, cv):
    """(min, max, all valid) over the 2x2 cells of the selected level's
    window at the cell of (cu, cv): four row reads of the table."""
    dev = table.device
    ts = torch.tensor(layout.sizes, device=dev)[level]
    mh = torch.tensor([h for h, _ in layout.shapes], device=dev)[level]
    mw = torch.tensor([w for _, w in layout.shapes], device=dev)[level]
    base = torch.tensor(layout.offsets, device=dev)[level]
    cu0 = torch.minimum(torch.clamp(cu // ts, min=0), mw - 1)
    cv0 = torch.minimum(torch.clamp(cv // ts, min=0), mh - 1)

    def cell(dy, dx):
        y = torch.minimum(torch.clamp(cv0 + dy, min=0), mh - 1)
        x = torch.minimum(torch.clamp(cu0 + dx, min=0), mw - 1)
        return table[base + y * mw + x]

    c = [cell(0, 0), cell(0, 1), cell(1, 0), cell(1, 1)]
    mn = torch.minimum(torch.minimum(c[0][..., 0], c[1][..., 0]), torch.minimum(c[2][..., 0], c[3][..., 0]))
    mx = torch.maximum(torch.maximum(c[0][..., 1], c[1][..., 1]), torch.maximum(c[2][..., 1], c[3][..., 1]))
    av = (c[0][..., 2] * c[1][..., 2] * c[2][..., 2] * c[3][..., 2]) > 0.5
    return mn, mx, av


def rank_bricks_plain(cls: torch.Tensor, cap: int) -> BrickClasses:
    """Plain version of B3b's ranking: the ACTIVE and work lists in flat brick
    order (entries past their counts hold NB), the ranks, the counts and the
    overflow flag, as ``_integrate_rows_core``'s compaction makes them."""
    flat = cls.reshape(-1)
    n = flat.numel()
    ids = torch.arange(n, dtype=torch.int32, device=flat.device)

    def listed(pred):
        pos = torch.cumsum(pred.to(torch.int64), 0) - 1
        out = torch.full((n,), n, dtype=torch.int32, device=flat.device)
        out[pos[pred]] = ids[pred]
        return pos, out

    active, work = flat == ACTIVE, flat != NONE
    pos, active_ids = listed(active)
    _, work_ids = listed(work)
    totals = torch.stack([active.sum(), work.sum()]).to(torch.int32)
    rank = torch.where(active, pos, -1).to(torch.int32)
    return BrickClasses(cls, rank, active_ids, work_ids, totals, totals[0] > cap)


class ClassifyScratch:
    """B3b's scratch on one device and stream, since launches on one stream
    run in order: word 0 the ticket counter, which runs on from launch to
    launch, then a status word a tile of :data:`CLASSIFY_TILE` bricks every
    :data:`CLASSIFY_STATUS_STRIDE` words, tagged with the launch's epoch.
    Zeroed once when made; the host counts the tickets taken and the
    launches made, so no launch clears anything."""

    def __init__(self, device: torch.device, words: int):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.tickets = 0
        self.launches = 0

    def next_launch(self) -> Tuple[int, int]:
        """(ticket base, epoch) of the next launch on the scratch."""
        if self.launches + 1 >= 2 ** 42:
            raise RuntimeError("the classifier's scratch has run out of epochs")
        return self.tickets % 2 ** 32, self.launches + 1

    def launched(self, tiles: int) -> None:
        """Count a launch of ``tiles`` blocks that the card accepted; a
        refused one took no tickets."""
        self.tickets += tiles
        self.launches += 1


_classify_scratch: dict = {}  # (device, stream) -> ClassifyScratch


def classify_scratch(device: torch.device, n_bricks: int) -> ClassifyScratch:
    """B3b's :class:`ClassifyScratch` on ``device``'s current stream, made
    anew where a larger volume needs more tiles."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    words = 1 + classify_tiles(n_bricks) * CLASSIFY_STATUS_STRIDE
    if key not in _classify_scratch or _classify_scratch[key].words.numel() < words:
        _classify_scratch[key] = ClassifyScratch(device, words)
    return _classify_scratch[key]


def classify_tiles(n_bricks: int) -> int:
    """Blocks of a B3b launch: tiles of :data:`CLASSIFY_TILE` bricks."""
    return -(-n_bricks // CLASSIFY_TILE)


def classify_bricks(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg, cap: int) -> BrickClasses:
    """B3b: the bricks' classes against the frame whose mip table is ``table``
    at the volume->camera ``pose`` (:func:`kernels.fusion_pose`), with the
    ACTIVE and work lists in flat brick order, the counts and the overflow
    flag (:func:`classify_bricks_plain` then :func:`rank_bricks_plain`). On
    the card one launch (the classes, then the ranks by a single-pass scan),
    no host read; entries of a list past its count are left unwritten."""
    if kernels.on_cpu(table, pose):
        return rank_bricks_plain(classify_bricks_plain(table, pose, intr, cfg), cap)
    nb = _check_resolution(cfg.resolution)
    H, W = intr.height, intr.width
    layout = mip_layout(H, W)
    kernels.check_tensor(table, "table", torch.float32, (layout.rows, 3))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.FUSION_POSE_FLOATS,))
    n = nb[0] * nb[1] * nb[2]
    dev = table.device
    cls = torch.empty(nb, dtype=torch.int32, device=dev)
    rank, active_ids, work_ids = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
    totals = torch.empty(2, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch = classify_scratch(dev, n)
    kernels.launch("classify_bricks", dev, table, pose, cls, scratch.words, *scratch.next_launch(), rank,
                   active_ids, work_ids, totals, overflow, H, W, _layout_ints(layout), classify_consts(intr, cfg),
                   int(cap))
    scratch.launched(classify_tiles(n))
    kernels.launch_counts["classify_bricks"] += 1
    return BrickClasses(cls, rank, active_ids, work_ids, totals, overflow)


def classify_consts(intr: Intrinsics, cfg) -> list:
    """The classifier kernel's float32 constants, rounded as PyTorch rounds the
    plain version's host numbers: brick edge, fx, fy, cx, cy, the four gate
    planes' constant terms, 1/|fx| and 1/|fy| (the reciprocal in double, as
    the card divides by a host number), trunc, -trunc."""
    f32, W, H = kernels.f32, intr.width, intr.height
    return [
        f32(BRICK * cfg.voxel_size), f32(intr.fx), f32(intr.fy), f32(intr.cx), f32(intr.cy),
        f32(intr.cx - 2.5), f32((W - 0.5) - intr.cx), f32(intr.cy - 2.5), f32((H - 0.5) - intr.cy),
        kernels.reciprocal_f32(abs(intr.fx)), kernels.reciprocal_f32(abs(intr.fy)),
        f32(cfg.trunc_dist), f32(-cfg.trunc_dist),
    ]


# -------------------------------------------------------------- B3c fusion
def _is_rows(value: torch.Tensor) -> bool:
    """Whether the planes are brick-major ``(NB, 512)`` rows (else dense ``(X, Y, Z)``)."""
    return value.dim() == 2


def fuse_bricks_plain(value, grad, weight, depth_m, pose, intr: Intrinsics, cfg, classes: BrickClasses, cap: int,
                      dense_on_overflow: bool, bi_threshold: float = 0.0) -> None:
    """Plain version of B3c, IN PLACE: the port of ``_integrate_rows_core``
    with ``subcell_cap=0`` over brick rows, the planes' own when they are
    ``(NB, 512)`` rows (the brick layout), else :func:`to_bricks` of the
    dense planes. FAR and FAR_PARTIAL bricks take the "beyond" update under
    the exact per-voxel gate; the ACTIVE bricks of rank < ``cap`` take the
    exact update (:func:`kernels.voxel_update_plain`); with
    ``dense_on_overflow`` an overflowing frame takes the exact update at every
    voxel instead, from the pre-frame volume (the JAX engine's rerun with
    every brick in the cap). ``bi_threshold`` as the exact update's."""
    r_v2c, t_v2c = kernels.unpack_fusion_pose(pose)
    rows = _is_rows(value)
    res = tuple(cfg.resolution)
    if dense_on_overflow and bool(classes.overflow) and not rows:
        kernels.fuse_volume_plain(value, grad, weight, depth_m, r_v2c, t_v2c, intr, cfg.voxel_size, cfg.trunc_dist,
                                  cfg.max_weight, bi_threshold)
        return
    nbx, nby, nbz = _check_resolution(res)
    vs = cfg.voxel_size
    dev = value.device
    cls = classes.cls.reshape(-1)
    vb, gb, wb = (value, grad, weight) if rows else (to_bricks(value), to_bricks(grad), to_bricks(weight))
    lane = torch.arange(BRICK ** 3, device=dev)
    lx = (lane // (BRICK * BRICK)).to(torch.float32)
    ly = ((lane // BRICK) % BRICK).to(torch.float32)
    lz = (lane % BRICK).to(torch.float32)

    def coords(ids):
        bx, by, bz = ids // (nby * nbz), (ids // nbz) % nby, ids % nbz
        return (((bx * BRICK).to(torch.float32)[:, None] + lx[None, :] + 0.5) * vs,
                ((by * BRICK).to(torch.float32)[:, None] + ly[None, :] + 0.5) * vs,
                ((bz * BRICK).to(torch.float32)[:, None] + lz[None, :] + 0.5) * vs)

    every = torch.arange(vb.shape[0], device=dev)
    if dense_on_overflow and bool(classes.overflow):  # brick rows: the exact update everywhere
        new = kernels.voxel_update_plain(*coords(every), vb, gb, wb, depth_m, r_v2c, t_v2c, intr, cfg.trunc_dist,
                                         cfg.max_weight, bi_threshold)
        for plane, updated in zip((value, grad, weight), new):
            plane.copy_(updated)
        return

    # FAR pass: no depth read; the gate of the exact update, recomputed from the voxel's position
    H, W = depth_m.shape
    fx_, fy_, fz_ = coords(every)
    Rv, tv = r_v2c.v, t_v2c.v
    ccx = Rv[0, 0] * fx_ + Rv[0, 1] * fy_ + Rv[0, 2] * fz_ + tv[0]
    ccy = Rv[1, 0] * fx_ + Rv[1, 1] * fy_ + Rv[1, 2] * fz_ + tv[1]
    ccz = Rv[2, 0] * fx_ + Rv[2, 1] * fy_ + Rv[2, 2] * fz_ + tv[2]
    inv_z = 1.0 / ccz
    iu = torch.floor(ccx * intr.fx * inv_z + intr.cx - 0.5)
    iv = torch.floor(ccy * intr.fy * inv_z + intr.cy - 0.5)
    far_rows = ((cls == FAR) | (cls == FAR_PARTIAL))[:, None]
    far_mask = far_rows & (inv_z >= 0) & (iu > 1) & (iu < W - 1) & (iv > 1) & (iv < H - 1)
    # the exact update's running average with the sample 1 + 0i, in its arithmetic
    far = (CSFD(vb, gb) * wb + 1.0) / (wb + 1.0)
    w_far = torch.clamp(wb + 1.0, max=float(cfg.max_weight))
    vb = torch.where(far_mask, far.v, vb)
    gb = torch.where(far_mask, far.g, gb)
    wb = torch.where(far_mask, w_far, wb)

    # ACTIVE pass: the first cap ACTIVE bricks in flat order, gathered, updated exactly, scattered back
    ids = torch.nonzero((cls == ACTIVE) & (classes.rank < cap)).reshape(-1)
    if ids.numel():
        gx, gy, gz = coords(ids)
        new = kernels.voxel_update_plain(gx, gy, gz, vb[ids], gb[ids], wb[ids], depth_m, r_v2c, t_v2c, intr,
                                         cfg.trunc_dist, cfg.max_weight, bi_threshold)
        for plane_rows, updated in zip((vb, gb, wb), new):
            plane_rows[ids] = updated
    for plane, plane_rows in zip((value, grad, weight), (vb, gb, wb)):
        plane.copy_(plane_rows if rows else from_bricks(plane_rows, res))


def fuse_bricks(value, grad, weight, depth_m, pose, intr: Intrinsics, cfg, classes: BrickClasses, cap: int,
                dense_on_overflow: bool, bi_threshold: float = 0.0) -> None:
    """B3c: fuse the frame into the planes IN PLACE, brick by brick as
    ``classes`` says (:func:`fuse_bricks_plain`'s contract): dense ``(X, Y,
    Z)`` planes or brick-major ``(NB, 512)`` rows, the kernel's row variant,
    which differs only in where a brick's column lies (``b * 512 + c * 8``).
    On the card one launch; with ``dense_on_overflow`` the kernel reads the
    overflow flag on the device and, where it is set, updates every brick
    exactly."""
    if kernels.on_cpu(value, grad, weight, depth_m, pose, classes.cls):
        fuse_bricks_plain(value, grad, weight, depth_m, pose, intr, cfg, classes, cap, dense_on_overflow,
                          bi_threshold)
        return
    nbx, nby, nbz = _check_resolution(cfg.resolution)
    rows = _is_rows(value)
    shape = (nbx * nby * nbz, BRICK ** 3) if rows else cfg.resolution
    if rows and value.numel() >= 1 << 31:
        raise ValueError("the brick rows are addressed in 32 bits: at most 2^31 voxels")
    for t, name in ((value, "value"), (grad, "grad"), (weight, "weight")):
        kernels.check_tensor(t, name, torch.float32, shape)
    kernels.check_tensor(depth_m, "depth_m", torch.float32, (intr.height, intr.width))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.FUSION_POSE_FLOATS,))
    n = classes.rank.numel()
    kernels.check_tensor(classes.cls, "cls", torch.int32, tuple(s // BRICK for s in cfg.resolution))
    for t, name in ((classes.rank, "rank"), (classes.work_ids, "work_ids")):
        kernels.check_tensor(t, name, torch.int32, (n,))
    kernels.launch(
        "fuse_bricks", value.device, value, grad, weight, depth_m, pose, classes.cls, classes.rank, classes.work_ids,
        classes.totals, classes.overflow, *kernels.fusion_args(intr, cfg.voxel_size, cfg.trunc_dist, cfg.max_weight),
        int(cap), bool(dense_on_overflow), list(cfg.resolution), rows, kernels.bilinear_arg(bi_threshold),
    )
    kernels.launch_counts["fuse_bricks_bilinear" if bi_threshold > 0 else "fuse_bricks"] += 1
