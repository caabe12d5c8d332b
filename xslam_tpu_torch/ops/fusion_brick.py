"""Brick fusion on the dense volume: conservative culling of the voxels whose
depth is read.

Port of ``xslam_tpu/ops/fusion_brick.py::integrate_brick``. The volume's
8^3 bricks are classified against the frame with interval arithmetic over
min/max depth mips: NONE (provably no voxel updates), FAR and FAR_PARTIAL
(every voxel that passes its pixel gate provably takes the saturated
"beyond" sample, so the update needs no depth read), ACTIVE (the exact
per-voxel update). Every test errs toward ACTIVE, so the volume equals dense
fusion's bit for bit. ``cap`` bounds the ACTIVE bricks that are fused; past
it the frame overflows: with ``"flag"`` the bricks of rank ``>= cap`` (flat
brick order) stay unfused and the flag is raised, with ``"dense"`` the frame
is fused exactly everywhere instead, from the pre-frame volume.

The kernels (``csrc/bricks.cu``), each wrapped here beside its plain
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
  counts and the overflow flag, all on the device, in one launch. Its opt-in
  variants, the same one launch: B15s (``split=True``, plain
  :func:`classify_bricks_full_plain` with ``split``) adds the per-cell
  tests of the footprint's 2x2 window and the MIXED class, whose far cells
  and window (:func:`pack_aux`) the fusion pass reads; B15f (``fine=True``,
  plain :func:`classify_bricks_fine_plain`) folds the classes of each
  brick's 4^3 subcells (``classify_bricks_fine``) and wins over ``split``;
- B15c :func:`classify_subcells` (plain :func:`classify_subcells_plain`,
  the subcell stage of ``_integrate_rows_core`` with ``subcell_cap > 0``):
  the classes of the 8 subcells of the first ``cap`` ACTIVE bricks and each
  subcell id's list in rank order, its overflow ORed into the brick flag;
- B3c :func:`fuse_bricks` (plain :func:`fuse_bricks_plain`, the port of
  ``_integrate_rows_core`` over ``to_bricks`` rows): the FAR pass and the
  exact update of the ACTIVE bricks, in place; with ``bi_threshold > 0`` the
  exact update samples the depth bilinearly (B11, count
  ``fuse_bricks_bilinear``), as ``_integrate_rows_core`` passes its
  ``bi_threshold`` to ``_voxel_update``. The classes and the FAR pass are the
  nearest branch's there as here: the classifier's proofs allow the nearest
  sample's half pixel, not the bilinear block's, so under bilinear sampling
  the result may part from :func:`xslam_tpu_torch.ops.fusion.integrate`'s
  where the JAX package's parts. Its variants (counts ``fuse_bricks_mixed``,
  ``fuse_bricks_subcell``): a MIXED brick's voxels take the far update where
  their nearest pixel lies in a far cell of its window; an ACTIVE brick's
  voxels the update of their subcell (far, exact within the list's
  capacity, or none).

Every classifier and B3c take ``x_offset`` (B19a): the planes are a slab of
a larger volume whose local x 0 is global x ``x_offset`` (the sharded
engine's, :mod:`xslam_tpu_torch.parallel.sharded`), the boxes and voxels at
their global positions in the JAX package's own roundings; B3b and B3c are
then counted as ``classify_bricks_slab`` and ``fuse_bricks_slab``.

On the card the classifiers follow PyTorch's CUDA division by a host number
(a multiply by the reciprocal taken in double) and so equal their plain
versions there; on the CPU those divide truly, as the JAX package does
(eagerly: under ``jax.jit`` XLA may move a bound by an ulp).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
NONE, FAR, ACTIVE, FAR_PARTIAL, MIXED = 0, 1, 2, 3, 4
SUBCELL = 4  # voxels along a subcell's edge: a brick holds 2^3 of them
AUX_INTS = 3  # a window's ints in pack_aux: far cells | cell edge << 4, the origin across and down in pixels
CLASSIFY_TILE = 128  # bricks a tile (a block) of csrc/bricks.cu's classifier scan
# B15f's lanes a subcell, lanes a brick (its groups classify the 8 subcells, a share each, in turn) and threads a block
FINE_BOX_LANES, FINE_LANES, FINE_THREADS = 1, 4, 1024
FINE_TILE = FINE_THREADS // FINE_LANES  # bricks a tile of B15f's scan
CLASSIFY_STATUS_STRIDE = 16  # 8-byte words of the classifier's scratch a tile: its status word, one a 128 B line
# B15c's lanes a subcell box, threads a block and candidate rows a tile of its scan (csrc/bricks.cu)
SUBCELL_BOX_LANES, SUBCELL_THREADS, SUBCELL_TILE = 1, 256, 32
SUBCELL_ROWS = SUBCELL_THREADS // (8 * SUBCELL_BOX_LANES)  # candidate rows a block (8 subcells a row)
SUBCELL_EPOCH_BITS = 40  # a B15c status word's epoch: the rest holds four ids' counts of a tile


class MipLayout(NamedTuple):
    """Where each level's tiles lie in the mip table."""

    sizes: Tuple[int, ...]  # tile edge in pixels, one a level
    shapes: Tuple[Tuple[int, int], ...]  # tiles down and across
    offsets: Tuple[int, ...]  # first row of the level
    rows: int


class BrickAux(NamedTuple):
    """The classes of ``_classify_boxes`` with the window a MIXED box's
    voxels are tested against (``xslam_tpu/ops/fusion_brick.py::BrickAux``)."""

    cls: torch.Tensor  # int32: NONE, FAR, ACTIVE, FAR_PARTIAL, MIXED (the split classifier's)
    farbits: torch.Tensor  # int32: the window's provably far cells, cell (dy, dx) at bit 2 dy + dx
    win_u0: torch.Tensor  # int32: the window's origin in pixels
    win_v0: torch.Tensor
    win_ts: torch.Tensor  # int32: its cell edge in pixels


class BrickClasses(NamedTuple):
    """What the classifier leaves on the device for the fusion pass."""

    cls: torch.Tensor  # (nbx, nby, nbz) int32: NONE, FAR, ACTIVE, FAR_PARTIAL, MIXED
    rank: torch.Tensor  # (NB,) int32: an ACTIVE brick's place in flat order, -1 elsewhere
    active_ids: torch.Tensor  # (NB,) int32: the ACTIVE bricks in flat order (the first n_active)
    work_ids: torch.Tensor  # (NB,) int32: the non-NONE bricks in flat order (the first n_work)
    totals: torch.Tensor  # (2,) int32: n_active, n_work
    overflow: torch.Tensor  # () bool: n_active > cap; the subcell stage ORs its own into it
    aux: Optional[torch.Tensor] = None  # (NB,) int32: the split classifier's pack_aux words, else None


class Subcells(NamedTuple):
    """The subcell stage's classes and lists (B15c) for the first ``cap``
    ACTIVE bricks, row r for the brick of rank r; subcell s of a brick at
    voxel offset 4 (s >> 2, (s >> 1) & 1, s & 1)."""

    cls: torch.Tensor  # (cap, 8) int32: NONE, FAR, ACTIVE, FAR_PARTIAL; NONE on rows past n_active
    rank: torch.Tensor  # (cap, 8) int32: an ACTIVE subcell's place in its id's list (row order), -1 elsewhere
    counts: torch.Tensor  # (8,) int32: the ACTIVE subcells of each id
    overflow: torch.Tensor  # () bool: a list holds more than subcell_cap


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
def classify_boxes_plain(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg, bx0, by0, bz0, bm: float,
                         split: bool = False) -> BrickAux:
    """The port of ``_classify_boxes``: the classes of axis-aligned boxes of
    edge ``bm`` metres at the origins ``bx0``, ``by0``, ``bz0`` (float32
    tensors of any broadcastable shapes: the brick grid, the 4^3-subcell grid,
    a candidate's subcells), against the frame whose mip table is ``table``
    (:func:`depth_mips_plain`) at the volume->camera ``pose``
    (:func:`kernels.fusion_pose`, value lanes read). ``split`` adds the
    per-cell far / none tests of the footprint's 2x2 window and the MIXED
    class. Returns the classes with the window that ``fuse_bricks`` reads
    for a MIXED box: its far cells, origin and cell edge."""
    H, W = intr.height, intr.width
    layout = mip_layout(H, W)
    dev = table.device
    r_v2c, t_v2c = kernels.unpack_fusion_pose(pose)
    R, t = r_v2c.v, t_v2c.v

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

    # the camera's exact distance interval to the solid box (camera origin in volume coordinates: -R^T t)
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
    dmin, dmax, all_valid, cells, cu0, cv0, ts_sel = _footprint_bounds(table, layout, level, cu, cv)

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
    farbits = torch.zeros(none_by_band.shape, dtype=torch.int32, device=dev)
    mixed = torch.zeros_like(none_by_band)
    if split:
        # each window cell's own depth bounds with a lambda interval over the cell's rect (widened by the half
        # pixel a voxel's nearest sample rounds by) met with the footprint bbox: the pixels a voxel can sample
        # inside the cell lie in both
        ts_f = ts_sel.to(torch.float32)
        ub_lo, ub_hi = torch.clamp(umin, 0.0, W - 0.5), torch.clamp(umax, 0.0, W - 0.5)
        vb_lo, vb_hi = torch.clamp(vmin, 0.0, H - 0.5), torch.clamp(vmax, 0.0, H - 0.5)
        far_cells, none_cells = [], []
        for ci, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            x0 = ((cu0 + dx) * ts_sel).to(torch.float32) - 0.5
            y0 = ((cv0 + dy) * ts_sel).to(torch.float32) - 0.5
            ux0 = torch.maximum(torch.clamp(x0, 0.0, W - 0.5), ub_lo)
            ux1 = torch.minimum(torch.clamp(x0 + ts_f, 0.0, W - 0.5), ub_hi)
            uy0 = torch.maximum(torch.clamp(y0, 0.0, H - 0.5), vb_lo)
            uy1 = torch.minimum(torch.clamp(y0 + ts_f, 0.0, H - 0.5), vb_hi)
            xi_lo, xi_hi = coord_interval(ux0, torch.maximum(ux1, ux0), intr.cx, intr.fx)
            yi_lo, yi_hi = coord_interval(uy0, torch.maximum(uy1, uy0), intr.cy, intr.fy)
            lam_lo = torch.sqrt(xi_lo * xi_lo + yi_lo * yi_lo + 1.0)
            lam_hi = torch.sqrt(xi_hi * xi_hi + yi_hi * yi_hi + 1.0)
            mn_i, mx_i, av_i = cells[ci][..., 0], cells[ci][..., 1], cells[ci][..., 2] > 0.5
            # a cell outside the bbox has no pixel a voxel samples: it proves something only where it holds no
            # valid depth at all (min +inf, max -inf)
            empty = (ux1 < ux0) | (uy1 < uy0)
            far_cells.append(av_i & (torch.isposinf(mn_i) | (~empty & (mn_i * lam_lo - dist_max > cfg.trunc_dist))))
            none_cells.append(torch.isneginf(mx_i) | (~empty & (mx_i * lam_hi - dist_min < -cfg.trunc_dist)))
        far4 = proj_ok & far_cells[0] & far_cells[1] & far_cells[2] & far_cells[3]
        none4 = proj_ok & none_cells[0] & none_cells[1] & none_cells[2] & none_cells[3]
        mixed = proj_ok
        for f_i, n_i in zip(far_cells, none_cells):
            mixed = mixed & (f_i | n_i)
        for bit, f_i in enumerate(far_cells):
            farbits = farbits + (f_i.to(torch.int32) << bit)
        none_by_band = none_by_band | none4
        provably_far = provably_far | far4
        mixed = mixed & ~none_by_band & ~provably_far
    far = provably_far & fully_inside
    far_partial = provably_far & ~fully_inside
    none = fully_behind | fully_outside | frustum_out | none_by_band
    cls = torch.where(none, NONE, ACTIVE)
    cls = torch.where(far & ~none, FAR, cls)
    cls = torch.where(far_partial & ~none, FAR_PARTIAL, cls)
    cls = torch.where(mixed & ~none, MIXED, cls)
    # FAR and FAR_PARTIAL take the far update under every cell
    farbits = torch.where((cls == FAR) | (cls == FAR_PARTIAL), 15, farbits)
    i32 = torch.int32
    return BrickAux(cls.to(i32), farbits.to(i32), (cu0 * ts_sel).to(i32), (cv0 * ts_sel).to(i32), ts_sel.to(i32))


def classify_bricks_full_plain(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg, split: bool = False,
                               cell: int = BRICK, x_offset: int = 0) -> BrickAux:
    """The port of ``classify_bricks_full``: :func:`classify_boxes_plain` on
    the grid of ``cell``-voxel boxes (the bricks, or with ``cell=4`` their
    4^3 subcells), origins ``i * (cell * voxel_size)``, x moved by a slab's
    :func:`kernels.slab_shift_m` (``x_offset``, B19a). Each field is a
    ``(X / cell, Y / cell, Z / cell)`` int32 tensor."""
    _check_resolution(cfg.resolution)
    nb = tuple(s // cell for s in cfg.resolution)
    bm = cell * cfg.voxel_size
    dev = table.device
    bx0 = torch.arange(nb[0], dtype=torch.float32, device=dev)[:, None, None] * bm
    if x_offset:
        bx0 = bx0 + kernels.slab_shift_m(x_offset, cfg.voxel_size)
    by0 = torch.arange(nb[1], dtype=torch.float32, device=dev)[None, :, None] * bm
    bz0 = torch.arange(nb[2], dtype=torch.float32, device=dev)[None, None, :] * bm
    return classify_boxes_plain(table, pose, intr, cfg, bx0, by0, bz0, bm, split)


def classify_bricks_plain(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg,
                          x_offset: int = 0) -> torch.Tensor:
    """Plain version of B3b's classes: the port of ``_classify_boxes`` with
    ``split=False`` on the brick grid (``classify_bricks_full``), reading the
    mip table of :func:`depth_mips_plain`. ``pose``: :func:`kernels.
    fusion_pose` of the volume->camera pose (value lanes read). Returns the
    ``(nbx, nby, nbz)`` int32 classes (``x_offset``: a slab's, B19a)."""
    return classify_bricks_full_plain(table, pose, intr, cfg, x_offset=x_offset).cls


def classify_bricks_fine_plain(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg,
                               x_offset: int = 0) -> torch.Tensor:
    """Plain version of B15f: the port of ``classify_bricks_fine``. The
    4^3-subcell grid's classes folded by brick: NONE where its 8 subcells
    are NONE, FAR where all are FAR, FAR_PARTIAL where all are FAR or
    FAR_PARTIAL, else ACTIVE. Returns the ``(nbx, nby, nbz)`` int32 classes."""
    nbx, nby, nbz = _check_resolution(cfg.resolution)
    sub = classify_bricks_full_plain(table, pose, intr, cfg, cell=SUBCELL, x_offset=x_offset).cls
    s = sub.reshape(nbx, 2, nby, 2, nbz, 2).permute(0, 2, 4, 1, 3, 5).reshape(nbx, nby, nbz, 8)
    all_none = (s == NONE).all(-1)
    all_far = (s == FAR).all(-1)
    all_farish = ((s == FAR) | (s == FAR_PARTIAL)).all(-1)
    cls = torch.where(all_none, NONE, torch.where(all_far, FAR, torch.where(all_farish, FAR_PARTIAL, ACTIVE)))
    return cls.to(torch.int32)


def pack_aux(aux: BrickAux) -> torch.Tensor:
    """The split classifier's window of each box as the :data:`AUX_INTS`
    int32 B15s writes and B3c reads (a last axis of 3): the far cells (bits
    0-3, cell (dy, dx) at bit 2 dy + dx) with the cell edge (bits 4-11), the
    window's origin across and down in pixels, whole, as the JAX package's
    ``BrickAux`` keeps it: any image size."""
    return torch.stack([aux.farbits | (aux.win_ts << 4), aux.win_u0, aux.win_v0], dim=-1)


def unpack_aux(words: torch.Tensor) -> BrickAux:
    """The ``(farbits, win_u0, win_v0, win_ts)`` of :func:`pack_aux`'s ints
    (``cls`` left None)."""
    word = words[..., 0]
    return BrickAux(None, word & 15, words[..., 1], words[..., 2], (word >> 4) & 255)


def _footprint_bounds(table, layout: MipLayout, level, cu, cv):
    """(min, max, all valid) over the 2x2 cells of the selected level's
    window at the cell of (cu, cv): four row reads of the table; then the
    four cells' rows (cell (dy, dx) at 2 dy + dx), the window's first cell
    across and down, and its cell edge."""
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
    return mn, mx, av, c, cu0, cv0, ts


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


def classify_subcells_plain(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg, classes: BrickClasses,
                            cap: int, subcell_cap: int, x_offset: int = 0) -> Subcells:
    """Plain version of B15c: the subcell stage of ``_integrate_rows_core``
    up to its lists. The 8 subcells of each of the first ``min(n_active,
    cap)`` ACTIVE bricks are classified by :func:`classify_boxes_plain` (box
    origins ``(8 b + 4 s) * voxel_size``, edge ``4 * voxel_size``: the JAX
    stage's roundings), and each subcell id's ACTIVE subcells are listed in
    the bricks' rank order; a list longer than ``subcell_cap`` overflows.
    ORs that overflow into ``classes.overflow`` IN PLACE, as the kernel does
    on the card, so the fusion pass and the caller read both. ``x_offset``: a
    slab's first x (B19a; the boxes at ``(8 b + 4 s + x_offset) * voxel_size``)."""
    _, nby, nbz = _check_resolution(cfg.resolution)
    dev = table.device
    n_valid = min(int(classes.totals[0]), cap)
    ids = classes.active_ids[:n_valid].to(torch.int64)
    s = torch.arange(8, device=dev)
    corner = [((s >> 2) * SUBCELL).to(torch.float32), (((s >> 1) & 1) * SUBCELL).to(torch.float32),
              ((s & 1) * SUBCELL).to(torch.float32)]
    brick = [ids // (nby * nbz), (ids // nbz) % nby, ids % nbz]
    corner[0] = corner[0] + x_offset
    box = [((b * BRICK).to(torch.float32)[:, None] + c[None, :]) * cfg.voxel_size for b, c in zip(brick, corner)]
    cls = torch.zeros((cap, 8), dtype=torch.int32, device=dev)
    if n_valid:
        cls[:n_valid] = classify_boxes_plain(table, pose, intr, cfg, *box, SUBCELL * cfg.voxel_size).cls
    active = cls == ACTIVE
    rank = torch.where(active, torch.cumsum(active.to(torch.int32), 0) - 1, -1).to(torch.int32)
    counts = active.sum(0).to(torch.int32)
    overflow = (counts > subcell_cap).any()
    classes.overflow.logical_or_(overflow)
    return Subcells(cls, rank, counts, overflow)


def classify_subcells(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg, classes: BrickClasses, cap: int,
                      subcell_cap: int, x_offset: int = 0) -> Subcells:
    """B15c: the subcell stage's classes and lists (:func:`classify_subcells_plain`'s
    contract), its overflow ORed into ``classes.overflow`` in place. On the
    card one launch after B3b's: a subcell a lane, the rows read from
    ``classes`` on the device (no host read), each id's ACTIVE subcells ranked
    in row order in the same launch by a single-pass scan over tiles of
    :data:`SUBCELL_TILE` rows (a block a run of :data:`SUBCELL_ROWS` rows,
    taken by an atomic ticket)."""
    if cap < 1 or subcell_cap < 1:
        raise ValueError(f"the subcell stage needs cap and subcell_cap >= 1, got {cap}, {subcell_cap}")
    if kernels.on_cpu(table, pose, classes.cls):
        return classify_subcells_plain(table, pose, intr, cfg, classes, cap, subcell_cap, x_offset)
    nb = _check_resolution(cfg.resolution)
    H, W = intr.height, intr.width
    layout = mip_layout(H, W)
    kernels.check_tensor(table, "table", torch.float32, (layout.rows, 3))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.FUSION_POSE_FLOATS,))
    n = nb[0] * nb[1] * nb[2]
    kernels.check_tensor(classes.active_ids, "active_ids", torch.int32, (n,))
    dev = table.device
    cls, rank = (torch.empty((cap, 8), dtype=torch.int32, device=dev) for _ in range(2))
    counts = torch.empty(8, dtype=torch.int32, device=dev)
    sub_overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch = subcell_scratch(dev, cap)
    kernels.launch("classify_subcells", dev, table, pose, classes.active_ids, classes.totals, classes.overflow,
                   scratch.words, *scratch.next_launch(), cls, rank, counts, sub_overflow, *nb, H, W,
                   _layout_ints(layout), classify_consts(intr, cfg, x_offset), subcell_consts(cfg), int(cap),
                   int(subcell_cap), int(x_offset))
    scratch.launched(subcell_blocks(cap))
    kernels.launch_counts["classify_subcells"] += 1
    return Subcells(cls, rank, counts, sub_overflow)


def subcell_blocks(cap: int) -> int:
    """Blocks of a B15c launch: :data:`SUBCELL_ROWS` candidate rows each."""
    return -(-cap // SUBCELL_ROWS)


def subcell_tiles(cap: int) -> int:
    """Tiles of a B15c launch's scan: its blocks' runs of rows cut into
    tiles of :data:`SUBCELL_TILE`."""
    return subcell_blocks(cap) * (SUBCELL_ROWS // SUBCELL_TILE)


def subcell_consts(cfg) -> list:
    """The subcell boxes' float32 constants, as PyTorch rounds the plain
    version's host numbers: the voxel size (the subcell stage's origins are
    ``(8 b + 4 s) * voxel_size``) and the subcell edge ``4 * voxel_size``
    (also the 4^3 grid's step, ``i * (4 * voxel_size)``)."""
    return [kernels.f32(cfg.voxel_size), kernels.f32(SUBCELL * cfg.voxel_size)]


class ClassifyScratch:
    """The classifiers' scratch on one device and stream, since launches on
    one stream run in order: word 0 the ticket counter, which runs on from
    launch to launch, then a status word a tile of the launch
    (:func:`classify_tiles`; B15c's :func:`subcell_tiles`, a pair of words)
    every :data:`CLASSIFY_STATUS_STRIDE` words, tagged with the launch's
    epoch. Zeroed once when made; the host counts the tickets taken and the
    launches made, so no launch clears anything."""

    def __init__(self, device: torch.device, words: int, epoch_bits: int = 42):
        self.words = torch.zeros(words, dtype=torch.int64, device=device)
        self.tickets = 0
        self.launches = 0
        self.epoch_bits = epoch_bits  # the status words' room for the epoch: 42 for B3b's, 40 for B15c's

    def next_launch(self) -> Tuple[int, int]:
        """(ticket base, epoch) of the next launch on the scratch."""
        if self.launches + 1 >= 2 ** self.epoch_bits:
            raise RuntimeError("the classifier's scratch has run out of epochs")
        return self.tickets % 2 ** 32, self.launches + 1

    def launched(self, tiles: int) -> None:
        """Count a launch of ``tiles`` blocks that the card accepted; a
        refused one took no tickets."""
        self.tickets += tiles
        self.launches += 1


_classify_scratch: dict = {}  # (device, stream) -> ClassifyScratch
_subcell_scratch: dict = {}  # (device, stream) -> B15c's ClassifyScratch


def classify_scratch(device: torch.device, n_bricks: int) -> ClassifyScratch:
    """The classifiers' :class:`ClassifyScratch` on ``device``'s current
    stream, room for either tiling, made anew where a larger volume needs
    more tiles."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    words = 1 + max(classify_tiles(n_bricks), classify_tiles(n_bricks, fine=True)) * CLASSIFY_STATUS_STRIDE
    if key not in _classify_scratch or _classify_scratch[key].words.numel() < words:
        _classify_scratch[key] = ClassifyScratch(device, words)
    return _classify_scratch[key]


def subcell_scratch(device: torch.device, cap: int) -> ClassifyScratch:
    """B15c's :class:`ClassifyScratch` on ``device``'s current stream (a
    pair of status words a tile, :data:`SUBCELL_EPOCH_BITS` of epoch), made
    anew where a larger cap needs more tiles."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    words = 1 + subcell_tiles(cap) * CLASSIFY_STATUS_STRIDE
    if key not in _subcell_scratch or _subcell_scratch[key].words.numel() < words:
        _subcell_scratch[key] = ClassifyScratch(device, words, SUBCELL_EPOCH_BITS)
    return _subcell_scratch[key]


def classify_tiles(n_bricks: int, fine: bool = False) -> int:
    """Blocks of a B3b or B15s launch: tiles of :data:`CLASSIFY_TILE` bricks;
    of a B15f launch (``fine``): tiles of :data:`FINE_TILE`."""
    return -(-n_bricks // (FINE_TILE if fine else CLASSIFY_TILE))


def classify_bricks(table: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg, cap: int, split: bool = False,
                    fine: bool = False, x_offset=None) -> BrickClasses:
    """B3b: the bricks' classes against the frame whose mip table is ``table``
    at the volume->camera ``pose`` (:func:`kernels.fusion_pose`), with the
    ACTIVE and work lists in flat brick order, the counts and the overflow
    flag (:func:`classify_bricks_plain` then :func:`rank_bricks_plain`). On
    the card one launch (the classes, then the ranks by a single-pass scan),
    no host read; entries of a list past its count are left unwritten.

    ``split`` (B15s, :func:`classify_bricks_full_plain` with ``split``)
    adds the MIXED class, listed as work, and the windows (``aux``,
    :func:`pack_aux`); ``fine`` (B15f, :func:`classify_bricks_fine_plain`)
    classifies each brick by its 4^3 subcells and wins over ``split``, as
    in the JAX engine. Each is the same one launch with other classes.

    ``x_offset`` (an int, B19a): the classes of a slab whose local x 0 is
    global x ``x_offset`` (B3b counted as ``classify_bricks_slab``); None:
    the whole volume."""
    split = split and not fine
    H, W = intr.height, intr.width
    off = x_offset or 0
    if kernels.on_cpu(table, pose):
        if fine:
            return rank_bricks_plain(classify_bricks_fine_plain(table, pose, intr, cfg, off), cap)
        full = classify_bricks_full_plain(table, pose, intr, cfg, split=split, x_offset=off)
        return rank_bricks_plain(full.cls, cap)._replace(aux=pack_aux(full).reshape(-1, AUX_INTS) if split else None)
    nb = _check_resolution(cfg.resolution)
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
    args = (table, pose, cls, scratch.words, *scratch.next_launch(), rank, active_ids, work_ids, totals, overflow)
    consts = (H, W, _layout_ints(layout), classify_consts(intr, cfg, off))
    aux = None
    if fine:
        kernel = "classify_bricks_fine"
        kernels.launch(kernel, dev, *args, *consts, subcell_consts(cfg)[1], int(cap))
    elif split:
        kernel, aux = "classify_bricks_split", torch.empty((n, AUX_INTS), dtype=torch.int32, device=dev)
        kernels.launch(kernel, dev, *args, aux, *consts, int(cap))
    else:
        kernel = "classify_bricks" if x_offset is None else "classify_bricks_slab"
        kernels.launch("classify_bricks", dev, *args, *consts, int(cap))
    scratch.launched(classify_tiles(n, fine))
    kernels.launch_counts[kernel] += 1
    return BrickClasses(cls, rank, active_ids, work_ids, totals, overflow, aux)


def classify_consts(intr: Intrinsics, cfg, x_offset: int = 0) -> list:
    """The classifier kernel's float32 constants, rounded as PyTorch rounds the
    plain version's host numbers: brick edge, fx, fy, cx, cy, the four gate
    planes' constant terms, 1/|fx| and 1/|fy| (the reciprocal in double, as
    the card divides by a host number), trunc, -trunc, and a slab's x origin
    shift (:func:`kernels.slab_shift_m`, B19a)."""
    f32, W, H = kernels.f32, intr.width, intr.height
    return [
        f32(BRICK * cfg.voxel_size), f32(intr.fx), f32(intr.fy), f32(intr.cx), f32(intr.cy),
        f32(intr.cx - 2.5), f32((W - 0.5) - intr.cx), f32(intr.cy - 2.5), f32((H - 0.5) - intr.cy),
        kernels.reciprocal_f32(abs(intr.fx)), kernels.reciprocal_f32(abs(intr.fy)),
        f32(cfg.trunc_dist), f32(-cfg.trunc_dist), kernels.slab_shift_m(x_offset, cfg.voxel_size),
    ]


# -------------------------------------------------------------- B3c fusion
def _is_rows(value: torch.Tensor) -> bool:
    """Whether the planes are brick-major ``(NB, 512)`` rows (else dense ``(X, Y, Z)``)."""
    return value.dim() == 2


def fuse_bricks_plain(value, grad, weight, depth_m, pose, intr: Intrinsics, cfg, classes: BrickClasses, cap: int,
                      dense_on_overflow: bool, bi_threshold: float = 0.0, subcells: Optional[Subcells] = None,
                      subcell_cap: int = 0, x_offset: int = 0) -> None:
    """Plain version of B3c, IN PLACE: the port of ``_integrate_rows_core``
    over brick rows, the planes' own when they are ``(NB, 512)`` rows (the
    brick layout), else :func:`to_bricks` of the dense planes. FAR and
    FAR_PARTIAL bricks take the "beyond" update under the exact per-voxel
    gate; with the split classifier's ``classes.aux`` every far-ish brick
    also tests the cell of the window its voxel's nearest pixel lies in, and
    a MIXED brick's voxels take that update where the cell is far. The ACTIVE
    bricks of rank < ``cap`` take the exact update
    (:func:`kernels.voxel_update_plain`), or with ``subcells``
    (:func:`classify_subcells_plain`) their subcells' own: the "beyond"
    update in a FAR or FAR_PARTIAL subcell, the exact one in an ACTIVE
    subcell of list rank < ``subcell_cap``, none elsewhere. With
    ``dense_on_overflow`` a frame whose flag is set (the brick or the
    subcell lists' overflow) takes the exact update at every voxel instead,
    from the pre-frame volume (the JAX engine's rerun). ``bi_threshold`` as
    the exact update's. ``x_offset``: a slab's first x (B19a), each voxel at
    ``((x + x_offset) + 0.5) * voxel_size`` (``_integrate_rows_core``'s
    rounding, also for the dense rerun)."""
    r_v2c, t_v2c = kernels.unpack_fusion_pose(pose)
    rows = _is_rows(value)
    res = tuple(cfg.resolution)
    if dense_on_overflow and bool(classes.overflow) and not rows and not x_offset:
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
        return (((bx * BRICK).to(torch.float32)[:, None] + lx[None, :] + 0.5 + x_offset) * vs,
                ((by * BRICK).to(torch.float32)[:, None] + ly[None, :] + 0.5) * vs,
                ((bz * BRICK).to(torch.float32)[:, None] + lz[None, :] + 0.5) * vs)

    every = torch.arange(vb.shape[0], device=dev)
    if dense_on_overflow and bool(classes.overflow):  # brick rows or a slab: the exact update everywhere
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
    img_u = ccx * intr.fx * inv_z + intr.cx
    img_v = ccy * intr.fy * inv_z + intr.cy
    iu = torch.floor(img_u - 0.5)
    iv = torch.floor(img_v - 0.5)
    gate = (inv_z >= 0) & (iu > 1) & (iu < W - 1) & (iv > 1) & (iv < H - 1)
    far_rows = (cls == FAR) | (cls == FAR_PARTIAL)
    far_mask = gate & far_rows[:, None]
    if classes.aux is not None:
        # MIXED: far where the voxel's nearest pixel, round(img), lies in a far cell of the window
        aux = unpack_aux(classes.aux.reshape(-1, AUX_INTS))
        far_mask = gate & (far_rows | (cls == MIXED))[:, None]

        def cell(img, origin):
            p = torch.where(gate, torch.round(img), 0.0).to(torch.int64)
            return torch.clamp(torch.div(p - origin[:, None], aux.win_ts[:, None], rounding_mode="floor"), 0, 1)

        bit = (aux.farbits[:, None] >> (cell(img_v, aux.win_v0) * 2 + cell(img_u, aux.win_u0))) & 1
        far_mask = far_mask & (bit > 0)
    # the exact update's running average with the sample 1 + 0i, in its arithmetic
    far = (CSFD(vb, gb) * wb + 1.0) / (wb + 1.0)
    w_far = torch.clamp(wb + 1.0, max=float(cfg.max_weight))
    updated = [torch.where(far_mask, far.v, vb), torch.where(far_mask, far.g, gb), torch.where(far_mask, w_far, wb)]

    # ACTIVE pass: the first cap ACTIVE bricks in flat order, gathered, updated exactly, scattered back
    ids = torch.nonzero((cls == ACTIVE) & (classes.rank < cap)).reshape(-1)
    if ids.numel():
        gx, gy, gz = coords(ids)
        new = kernels.voxel_update_plain(gx, gy, gz, vb[ids], gb[ids], wb[ids], depth_m, r_v2c, t_v2c, intr,
                                         cfg.trunc_dist, cfg.max_weight, bi_threshold)
        if subcells is not None:
            # each voxel as its subcell says: subcell s = 4 (x >> 2) + 2 (y >> 2) + (z >> 2) in the brick
            sub = (((lane // (BRICK * BRICK)) >> 2) * 4 + (((lane // BRICK) % BRICK) >> 2) * 2 + ((lane % BRICK) >> 2))
            row = classes.rank[ids].to(torch.int64)
            scls = subcells.cls[row][:, sub]
            exact = (scls == ACTIVE) & (subcells.rank[row][:, sub] < subcell_cap)
            far_v = ((scls == FAR) | (scls == FAR_PARTIAL)) & gate[ids]
            old = (vb[ids], gb[ids], wb[ids])
            near = (far.v[ids], far.g[ids], w_far[ids])
            new = [torch.where(exact, n, torch.where(far_v, f, o)) for n, f, o in zip(new, near, old)]
        for plane_rows, update in zip(updated, new):
            plane_rows[ids] = update
    for plane, plane_rows in zip((value, grad, weight), updated):
        plane.copy_(plane_rows if rows else from_bricks(plane_rows, res))


def fuse_bricks(value, grad, weight, depth_m, pose, intr: Intrinsics, cfg, classes: BrickClasses, cap: int,
                dense_on_overflow: bool, bi_threshold: float = 0.0, subcells: Optional[Subcells] = None,
                subcell_cap: int = 0, x_offset=None) -> None:
    """B3c: fuse the frame into the planes IN PLACE, brick by brick as
    ``classes`` (and ``subcells``) say (:func:`fuse_bricks_plain`'s
    contract): dense ``(X, Y, Z)`` planes or brick-major ``(NB, 512)`` rows,
    the kernel's row variant, which differs only in where a brick's column
    lies (``b * 512 + c * 8``). On the card one launch; with
    ``dense_on_overflow`` the kernel reads the overflow flag on the device
    and, where it is set, updates every brick exactly. With the split
    classifier's windows (``classes.aux``) the launch is B3c's MIXED variant,
    with ``subcells`` its subcell variant (counted as ``fuse_bricks_mixed``
    and ``fuse_bricks_subcell``, in either branch of the depth sample).
    ``x_offset`` (an int, B19a): the planes are a slab whose local x 0 is
    global x ``x_offset`` (B3c counted as ``fuse_bricks_slab``); None: the
    whole volume."""
    if subcells is not None and subcell_cap < 1:
        raise ValueError(f"subcells need subcell_cap >= 1, got {subcell_cap}")
    off = x_offset or 0
    if kernels.on_cpu(value, grad, weight, depth_m, pose, classes.cls):
        fuse_bricks_plain(value, grad, weight, depth_m, pose, intr, cfg, classes, cap, dense_on_overflow,
                          bi_threshold, subcells, subcell_cap, off)
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
    args = (value, grad, weight, depth_m, pose, classes.cls, classes.rank, classes.work_ids, classes.totals,
            classes.overflow)
    tail = (*kernels.fusion_args(intr, cfg.voxel_size, cfg.trunc_dist, cfg.max_weight), int(cap),
            bool(dense_on_overflow), list(cfg.resolution), rows, kernels.bilinear_arg(bi_threshold), int(off))
    if classes.aux is not None:
        kernels.check_tensor(classes.aux, "aux", torch.int32, (n, AUX_INTS))
    if subcells is not None:
        for t, name in ((subcells.cls, "subcell cls"), (subcells.rank, "subcell rank")):
            kernels.check_tensor(t, name, torch.int32, (cap, 8))
        aux = classes.aux if classes.aux is not None else torch.empty(0, dtype=torch.int32, device=value.device)
        kernel = "fuse_bricks_subcell"
        kernels.launch(kernel, value.device, *args, aux, subcells.cls, subcells.rank, int(subcell_cap), *tail)
    elif classes.aux is not None:
        kernel = "fuse_bricks_mixed"
        kernels.launch(kernel, value.device, *args, classes.aux, *tail)
    else:
        kernel = "fuse_bricks_bilinear" if bi_threshold > 0 else "fuse_bricks"
        kernel = kernel if x_offset is None else "fuse_bricks_slab"
        kernels.launch("fuse_bricks", value.device, *args, *tail)
    kernels.launch_counts[kernel] += 1
