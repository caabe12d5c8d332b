"""The sharded engine's stages over X-slabs: the port of
``xslam_tpu/parallel/sharded.py``.

- TSDF volume: rank r holds X-slab r. Fusion is local to the slab: each rank
  fuses its planes at the whole volume's voxel positions (``x_offset``,
  B19a, in K2 or the brick kernels) from the replicated depth; the brick
  fusion's overflow flags are summed (:func:`sharded_integrate`).
- Raycast: each rank gets a halo of its neighbours' boundary rows over a ring
  (:func:`exchange_halo`, wrapping as ``lax.ppermute``'s ring wraps), marches
  its slab under a :class:`~xslam_tpu_torch.ops.raycast.ShardSpec` (K3, B19b),
  the ranks take the minimum of the first-crossing and first-death times, the
  one rank whose core rows hold a pixel's crossing refines it (K5's shard
  mode, B19c), and the maps are summed and finalized (K5's finalize)
  (:func:`sharded_raycast`).
- ICP: each rank takes a block of the current maps' columns, the model maps
  stay whole; the ranks' systems are summed before the solve (K4 writes its
  double totals, an ``all_reduce`` sums them, K4's tail solves, B19d; on the
  CPU the float32 systems are summed, as the JAX stage psums them)
  (:func:`sharded_pose_estimate`).

The halo covers the march step (0.8 trunc) and the refine's taps: 3 voxels
more than a step (``xslam_tpu/parallel/sharded.py:39``).

The brick layout (``volume_layout="brick"``, the JAX package's "gather"
strategy, ``sharded.py:211-364``) shards the rows for fusion and the image
columns for the raycast:

- fusion: rank r holds the brick rows of X-slab r, a contiguous block of the
  bx-major rows, and fuses them at the slab's ``x_offset`` (B3a-c, B15 with
  B19a's offset; :func:`sharded_integrate_rows`);
- raycast: the ranks gather the value and grad rows and the slabs' event
  masks (B19e's first half; :func:`gather_rows`, into buffers kept across
  frames, :class:`GatheredRows`), each rank takes the skip distances over
  the gathered mask (B19e's second half) where a skip march runs, marches
  and refines its own block of ``W / n`` image columns (B4, B16, B5b, K5r
  with :func:`xslam_tpu_torch.ops.raycast_bricks.column_intrinsics`, B19f),
  deciding the temporal march's refresh from its own block's anchors, and
  one ``all_gather`` assembles the blocks' maps and hit distances on every
  rank (:func:`sharded_raycast_bricks`). The screen normals come from the
  assembled vertex map, in the model-map pyramid's launch (B4n).

At one rank the brick stages are the single engine's calls: no gather, no
block, one B5a launch where a skip march runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..csfd.single import CSFD
from ..geometry import se3
from ..geometry.intrinsics import Intrinsics
from ..ops import bricks, fusion, icp, kernels, raycast, raycast_bricks
from ..ops.bricks import BrickVolume
from ..ops.fusion import VolumeConfig, VolumeState
from .mesh import SpaceGroup


def halo_width(cfg: VolumeConfig, local_x: int) -> int:
    """The rows a slab takes from each neighbour: a march step's voxels, rounded
    up, and 3 more for the refine's taps, at most the slab
    (``xslam_tpu/parallel/sharded.py::_halo_width``)."""
    step_vox = int(np.ceil(0.8 * cfg.trunc_dist / cfg.voxel_size))
    return min(step_vox + 3, local_x)


def exchange_halo(planes: Sequence[torch.Tensor], h: int, group: SpaceGroup) -> List[torch.Tensor]:
    """Each (local_x, Y, Z) plane with ``h`` rows of its left neighbour
    before it and ``h`` of its right one after it, over the ranks' ring
    (``xslam_tpu/parallel/sharded.py::_exchange_halo``): rank 0's left rows
    are rank n-1's last, rank n-1's right rows rank 0's first, as the JAX
    ring wraps. One batch of sends and receives for all planes; on one rank
    the rows are its own, with no send."""
    n, r = group.world_size, group.rank
    if n == 1:
        return [torch.cat([p[-h:], p, p[:h]]) for p in planes]
    nxt, prv = (r + 1) % n, (r - 1) % n
    ops, lefts, rights = [], [], []
    for k, p in enumerate(planes):
        left, right = torch.empty_like(p[:h]), torch.empty_like(p[:h])
        # in one order on every rank (NCCL matches a pair's sends and receives by order, gloo by tag): my last
        # rows are the next rank's left halo, my first rows the previous rank's right halo
        ops += [dist.P2POp(dist.isend, p[-h:].contiguous(), nxt, group.group, tag=2 * k),
                dist.P2POp(dist.isend, p[:h].contiguous(), prv, group.group, tag=2 * k + 1),
                dist.P2POp(dist.irecv, left, prv, group.group, tag=2 * k),
                dist.P2POp(dist.irecv, right, nxt, group.group, tag=2 * k + 1)]
        lefts.append(left)
        rights.append(right)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [torch.cat([left, p, right]) for left, p, right in zip(lefts, planes, rights)]


def sharded_integrate(vol: VolumeState, depth_m: torch.Tensor, r_v2c: CSFD, t_v2c: CSFD, intr: Intrinsics,
                      local_cfg: VolumeConfig, bi_threshold: float, group: SpaceGroup, fusion_mode: str = "dense",
                      brick_cap: int = 2048, classify_fine: bool = False, classify_split: bool = False,
                      subcell_cap: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fuse the frame into this rank's slab IN PLACE
    (``xslam_tpu/parallel/sharded.py::sharded_integrate``): dense (K2) or, with
    ``fusion_mode="brick"``, brick fusion with ``brick_cap`` ACTIVE bricks a
    slab, at ``x_offset`` = the slab's first x. ``local_cfg``: the slab's
    volume config. Brick fusion never reruns densely: its overflow flags are
    summed over the ranks and returned. Returns ``(overflowed, n_active)``:
    device tensors, the ACTIVE bricks summed over the ranks (None for dense
    fusion)."""
    x0 = group.rank * local_cfg.resolution[0]
    if fusion_mode != "brick":
        fusion.integrate(vol, depth_m, r_v2c, t_v2c, intr, local_cfg, bi_threshold=bi_threshold, x_offset=x0)
        return torch.zeros((), dtype=torch.bool, device=depth_m.device), None
    flag, n_active = fusion.integrate_brick(
        vol, depth_m, r_v2c, t_v2c, intr, local_cfg, cap=brick_cap, overflow="flag", bi_threshold=bi_threshold,
        classify_fine=classify_fine, classify_split=classify_split, subcell_cap=subcell_cap, x_offset=x0,
    )
    return _summed(flag, n_active, group)


def _summed(flag: torch.Tensor, n_active: torch.Tensor, group: SpaceGroup) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ranks' overflow flags and ACTIVE counts summed in one ``all_reduce``:
    ``(any rank overflowed, the ACTIVE bricks of all ranks)``."""
    both = torch.stack([flag.to(torch.int32), n_active.to(torch.int32)])
    dist.all_reduce(both, group=group.group)
    return both[0] > 0, both[1]


def sharded_integrate_rows(bvol: BrickVolume, depth_m: torch.Tensor, r_v2c: CSFD, t_v2c: CSFD, intr: Intrinsics,
                           local_cfg: VolumeConfig, bi_threshold: float, group: SpaceGroup, brick_cap: int,
                           overflow: str = "flag", classify_fine: bool = False, classify_split: bool = False,
                           subcell_cap: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brick fusion of the frame into this rank's slab of brick rows IN PLACE
    (``xslam_tpu/parallel/sharded.py::sharded_integrate_rows`` and the brick
    branch of ``engine.py``'s fusion): :func:`fusion.integrate_rows` at the
    slab's ``x_offset`` with ``brick_cap`` ACTIVE bricks a slab.
    ``local_cfg``: the slab's volume config.

    ``overflow="flag"``: a slab past its cap leaves its ACTIVE bricks past the
    cap unfused, and the flags summed over the ranks are reported on every
    rank. ``"dense"``: a slab past its cap fuses the frame exactly (B3c reads
    its own flag on the device), and no overflow is reported. The JAX engine
    reruns every slab with the cap of all its bricks and no subcell stage
    where any slab overflowed; a slab whose list fits gets its first pass's
    bits from that rerun (the same ACTIVE bricks, and subcell fusion gives
    brick fusion's bits), so each rank acting on its own flag gives the same
    volume with no collective between the classes and the fusion pass.
    Returns ``(overflowed, n_active)``: device tensors, the ACTIVE bricks
    summed over the ranks."""
    flag, n_active = fusion.integrate_rows(
        bvol, depth_m, r_v2c, t_v2c, intr, local_cfg, cap=brick_cap, overflow=overflow, bi_threshold=bi_threshold,
        classify_fine=classify_fine, classify_split=classify_split, subcell_cap=subcell_cap,
        x_offset=group.rank * local_cfg.resolution[0],
    )
    flag, n_active = _summed(flag, n_active, group)
    return (flag if overflow == "flag" else torch.zeros_like(flag)), n_active


def gather_rows(planes: Sequence[torch.Tensor], group: SpaceGroup,
                out: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Each rank's slab of each plane (its (NB_local, ...) rows) gathered in
    rank order into the whole volume's (NB, ...) on every rank
    (``jax.lax.all_gather(..., tiled=True)``, ``xslam_tpu/parallel/
    sharded.py:308-316``): one ``all_gather`` a plane, into ``out``'s tensors
    where given. On one rank the planes themselves."""
    n = group.world_size
    if n == 1:
        return list(planes)
    if out is None:
        out = [p.new_empty((n * p.shape[0],) + tuple(p.shape[1:])) for p in planes]
    for o, p in zip(out, planes):
        dist.all_gather_into_tensor(o, p.contiguous(), group=group.group)
    return list(out)


class GatheredRows:
    """The whole volume's value and grad rows and event mask, gathered from
    the ranks' slabs into buffers made at the first gather and kept across
    frames (about 134 MB of rows at 256^3)."""

    def __init__(self):
        self._out: Optional[List[torch.Tensor]] = None

    def __call__(self, planes: Sequence[torch.Tensor], group: SpaceGroup) -> List[torch.Tensor]:
        self._out = gather_rows(planes, group, self._out)
        return self._out


def sharded_raycast_bricks(vol: BrickVolume, r_c2v: CSFD, t_c2v: CSFD, r_v2w: CSFD, t_v2w: CSFD, intr: Intrinsics,
                           cfg: VolumeConfig, group: SpaceGroup, march_mode: str = "skip",
                           refine_mode: str = "secant2", normals_mode: str = "screen", hier_window: int = 12,
                           t_anchor: Optional[torch.Tensor] = None, temporal_window: int = 12,
                           temporal_min_coverage: float = 0.5, refresh: Optional[bool] = None,
                           temporal_phase1: int = 0, skip_gran: int = 8, packed_taps: bool = True,
                           compact: bool = False, gathered: Optional[GatheredRows] = None
                           ) -> Tuple[CSFD, Optional[CSFD], torch.Tensor]:
    """The model maps from the ranks' slabs of brick rows
    (``xslam_tpu/parallel/sharded.py::sharded_raycast_bricks``): the value and
    grad rows and the slabs' event masks gathered (B19e's mask over this
    rank's slab; ``gathered`` keeps the buffers), this rank's block of ``W /
    n`` columns of the model maps (``intr``) marched and refined through
    :func:`raycast_bricks.raycast_bricks` at
    :func:`raycast_bricks.column_intrinsics`, with the skip distances over the
    gathered mask (B19e's second half) where a skip march runs, and the
    blocks' maps and hit distances assembled on every rank (one
    ``all_gather``). ``cfg``: the whole volume's config. The marches and
    refines are :func:`raycast_bricks.raycast_bricks`'s.

    The temporal march takes the block of the whole ``t_anchor`` map, and
    takes the ``hier2`` refresh where ``refresh`` says, or (None) where the
    block's share of finite anchors is below ``temporal_min_coverage`` (a
    host read): each rank decides for its own block, outside every
    collective. ``skip_gran`` 4 or 8 give the same events and the port keeps
    the 8-voxel cells; ``packed_taps`` and ``compact`` change no result
    (:func:`raycast_bricks.raycast_bricks_rays`).

    Returns ``(vmap, nmap, t_found)`` on every rank: the dual world maps
    (3, H, W) with NaN sentinels (``nmap`` None with screen normals, which
    the model-map pyramid's launch takes from the assembled vertex map, B4n)
    and the march's hit distances. At one rank the single engine's call,
    with no gather and no block."""
    del packed_taps, compact
    if skip_gran not in (4, 8):
        raise ValueError(f"skip_gran must be 4 or 8, got {skip_gran}")
    temporal = march_mode == "temporal"
    if temporal and t_anchor is None:
        raise ValueError("march_mode='temporal' requires t_anchor")
    n, res = group.world_size, tuple(cfg.resolution)
    anchor = column_block(t_anchor, group) if temporal else None
    if temporal and refresh is None:
        refresh = float(raycast_bricks.anchor_coverage(anchor)) < temporal_min_coverage
    modes = dict(refresh=bool(refresh), normals_mode=normals_mode, march_mode=march_mode, refine_mode=refine_mode,
                 temporal_window=temporal_window, hier_window=hier_window, temporal_phase1=temporal_phase1)
    if n == 1:
        return raycast_bricks.raycast_bricks(vol, r_c2v, t_c2v, r_v2w, t_v2w, intr, cfg, anchor, **modes)
    X, Y, Z = res
    mask = bricks.event_mask(vol, (X // n, Y, Z))
    value, grad, mask = (gathered or GatheredRows())([vol.value, vol.grad, mask], group)
    dist_field = bricks.skip_distance(mask, res) if not temporal or refresh else None
    w = intr.width // n
    vmap, nmap, t_found = raycast_bricks.raycast_bricks(
        BrickVolume(value, grad, None), r_c2v, t_c2v, r_v2w, t_v2w,
        raycast_bricks.column_intrinsics(intr, group.rank * w, w), cfg, anchor, dist=dist_field, **modes,
    )
    planes = [vmap.v, vmap.g] + ([] if nmap is None else [nmap.v, nmap.g]) + [t_found[None]]
    block = torch.cat(planes)  # (k, H, w)
    k, H = block.shape[:2]
    blocks = block.new_empty((n * k, H, w))  # the blocks one after another, as every backend gathers them
    dist.all_gather_into_tensor(blocks, block, group=group.group)
    whole = blocks.view(n, k, H, w).permute(1, 2, 0, 3).reshape(k, H, n * w)
    vmap = CSFD(whole[0:3], whole[3:6])
    nmap = None if nmap is None else CSFD(whole[6:9], whole[9:12])
    return vmap, nmap, whole[-1]


def sharded_raycast(vol: VolumeState, r_c2v: CSFD, t_c2v: CSFD, r_v2w: CSFD, t_v2w: CSFD, intr: Intrinsics,
                    cfg: VolumeConfig, group: SpaceGroup, normals_mode: str = "tsdf") -> Tuple[CSFD, Optional[CSFD]]:
    """The model maps from the ranks' slabs (``xslam_tpu/parallel/sharded.py::
    sharded_raycast``): the halo exchange (none on one rank), the fixed
    march over the slab (K3 with a
    :class:`~xslam_tpu_torch.ops.raycast.ShardSpec`), the minima of
    ``t_found`` and ``t_dead`` (one ``all_reduce``), the owning rank's secant
    refine with TSDF normals (K5's shard mode), the sum of the maps and the
    masks (one ``all_reduce``) and the NaN sentinels (K5's finalize).
    ``cfg``: the whole volume's config. Returns ``(vmap, nmap)`` on every rank;
    with ``normals_mode="screen"`` ``(vmap, None)``: the model-map pyramid's
    launch computes the screen normals of the assembled vertex map (B4n), as
    the single engine's does."""
    X = cfg.resolution[0]
    x0, x1 = group.slab(X)
    if group.world_size == 1:
        # the ring's rows would wrap to global rows -h..-1 and X..X+h-1, outside x_total: no sample reads them
        h, value_ext, grad_ext = 0, vol.value, vol.grad
    else:
        h = halo_width(cfg, x1 - x0)
        value_ext, grad_ext = exchange_halo([vol.value, vol.grad], h, group)
    spec = raycast.ShardSpec(x_base=x0 - h, x_total=X, core_start=x0, core_end=x1)
    pose = kernels.pack_ray_pose(r_c2v, t_c2v, r_v2w, t_v2w)
    t_found, t_dead = kernels.march_fixed(value_ext, pose, intr, cfg.voxel_size, cfg.trunc_dist, spec=spec)
    mins = torch.stack([t_found, t_dead])
    dist.all_reduce(mins, op=dist.ReduceOp.MIN, group=group.group)
    maps = raycast.raycast_refine_shard(VolumeState(value_ext, grad_ext, vol.weight), pose, t_found, mins[0],
                                        mins[1], intr, cfg, spec)
    dist.all_reduce(maps, group=group.group)
    vmap, nmap = raycast.raycast_finalize(maps)
    return (vmap, None) if normals_mode == "screen" else (vmap, nmap)


def column_block(m: torch.Tensor, group: SpaceGroup) -> torch.Tensor:
    """This rank's block of the last axis of ``m`` (the maps' image columns,
    every pyramid width a multiple of the world size): the map itself on one
    rank, else a contiguous copy of the block."""
    n = group.world_size
    if n == 1:
        return m
    W = m.shape[-1]
    if W % n:
        raise ValueError(f"a map {W} pixels wide does not divide over {n} ranks")
    w = W // n
    return m[..., group.rank * w:(group.rank + 1) * w].contiguous()


def sharded_associate(r_curr: CSFD, t_curr: CSFD, vmap_curr: torch.Tensor, r_prev_inv: CSFD, t_prev: CSFD,
                      intr: Intrinsics, prev_shape, group: SpaceGroup) -> torch.Tensor:
    """The cached association of this rank's column block
    (``xslam_tpu/parallel/sharded.py::sharded_associate``): the int32 index
    map of :func:`icp.associate_index` over the block of ``vmap_curr``. The
    engine's loop on the card folds it into each level's first K4 launch
    instead (``assoc_out``)."""
    return icp.associate_index(r_curr, t_curr, column_block(vmap_curr, group), r_prev_inv, t_prev, intr, prev_shape)


def sharded_icp_system(r_curr: CSFD, t_curr: CSFD, vmap_curr: torch.Tensor, nmap_curr: torch.Tensor,
                       r_prev_inv: CSFD, t_prev: CSFD, intr: Intrinsics, vmap_g_prev: CSFD, nmap_g_prev: CSFD,
                       dist_thres: float, angle_thres: float, group: SpaceGroup, assoc=None) -> icp.IcpSystem:
    """The ICP system summed over the ranks (``xslam_tpu/parallel/sharded.py::
    sharded_icp_system``), on CPU tensors: each rank's float32 system of its
    column block of the current maps (``assoc``, where given, the block's
    cached index map) against the whole model maps, summed as the JAX stage
    psums it. On the card the engine's loop sums K4's double totals instead
    (:class:`icp.IcpLoop` with ``reduce``)."""
    vb, nb = column_block(vmap_curr, group), column_block(nmap_curr, group)
    if not kernels.on_cpu(vb, nb, r_curr.v, vmap_g_prev.v):
        raise ValueError("sharded_icp_system takes CPU tensors: on the card the system is IcpLoop(reduce=)'s")
    return _summed_system(icp.build_system_plain(r_curr, t_curr, vb, nb, r_prev_inv, t_prev, intr, vmap_g_prev,
                                                 nmap_g_prev, dist_thres, angle_thres, assoc=assoc), group)


def sharded_pose_estimate(state, vmaps_curr, nmaps_curr, config, intr: Intrinsics, group: SpaceGroup):
    """Coarse-to-fine ICP over the ranks (``xslam_tpu/parallel/engine.py::
    _pose_estimate_sharded``): each rank builds the system of its column
    block of the current maps against the whole model maps, and the ranks'
    systems are summed before each solve, so every rank takes the same
    steps. With ``icp_fixed_assoc`` a level's association is its block's
    (``sharded_associate``). Returns ``(c2w, ok, inliers)``, the inlier count
    over all ranks.

    On the card an iteration is K4 on the block writing its double totals,
    one ``all_reduce`` of them and K4's tail (:class:`icp.IcpLoop` with
    ``reduce``; with the cached association the level's first launch writes
    the block's index map). On the CPU it is :func:`sharded_icp_system`
    (with :func:`sharded_associate` once a level) and ``icp_step_plain``."""
    c2w_prev = se3.inverse(state.world2camera)
    r_prev, t_prev = se3.rotation(c2w_prev), se3.translation(c2w_prev)
    r_prev_inv = se3.rotation(state.world2camera)
    L = config.model_map_level
    levels = [(level, intr.level(level + L), state.vmaps_prev[level].v.shape[-2:])
              for level in reversed(range(config.num_levels))]
    vb = {level: column_block(vmaps_curr[level], group) for level, _, _ in levels}
    nb = {level: column_block(nmaps_curr[level], group) for level, _, _ in levels}

    if kernels.on_cpu(state.world2camera.v, *vmaps_curr):
        r_curr, t_curr = r_prev, t_prev
        ok = torch.ones((), dtype=torch.bool)
        inliers = None
        for level, model_intr, prev_shape in levels:
            level_assoc = None
            if config.icp_fixed_assoc:
                level_assoc = sharded_associate(r_curr, t_curr, vmaps_curr[level], r_prev_inv, t_prev, model_intr,
                                                prev_shape, group)
            for _ in range(config.icp_iterations[level]):
                system = sharded_icp_system(
                    r_curr, t_curr, vmaps_curr[level], nmaps_curr[level], r_prev_inv, t_prev, model_intr,
                    state.vmaps_prev[level], state.nmaps_prev[level], config.dist_thres, config.angle_thres_sine,
                    group, assoc=level_assoc,
                )
                step = icp.icp_step_plain(system, r_curr, t_curr, config.icp_damping)
                r_curr, t_curr = step.r_curr, step.t_curr
                ok = ok & step.ok
                inliers = system.inlier_count
    else:
        rows = {level: icp.pack_model_rows(state.vmaps_prev[level], state.nmaps_prev[level]) for level, _, _ in levels}
        loop = icp.IcpLoop(icp.pack_pose(r_prev, t_prev, r_prev_inv, t_prev),
                           reduce=lambda totals: dist.all_reduce(totals, group=group.group))
        for level, model_intr, prev_shape in levels:
            level_assoc = None
            for i in range(config.icp_iterations[level]):
                assoc_out = None
                if config.icp_fixed_assoc and i == 0:
                    assoc_out = torch.empty(vb[level].shape[1:], dtype=torch.int32, device=r_prev.v.device)
                loop.iterate(vb[level], nb[level], rows[level], prev_shape, model_intr, config.dist_thres,
                             config.angle_thres_sine, config.icp_damping, assoc=level_assoc, assoc_out=assoc_out)
                if assoc_out is not None:
                    level_assoc = assoc_out
        step = loop.result()
        r_curr, t_curr, ok, inliers = step.r_curr, step.t_curr, step.ok, step.system.inlier_count
    return se3.from_rotation_translation(r_curr, t_curr), ok, inliers


def _summed_system(local: icp.IcpSystem, group: SpaceGroup) -> icp.IcpSystem:
    """A rank's float32 system summed over the ranks (two ``all_reduce``: the
    84 floats of A and b, the inlier count), as the JAX stage psums it."""
    packed = torch.cat([local.A.v.reshape(-1), local.A.g.reshape(-1), local.b.v, local.b.g])
    count = local.inlier_count.clone()
    dist.all_reduce(packed, group=group.group)
    dist.all_reduce(count, group=group.group)
    return icp.IcpSystem(A=CSFD(packed[0:36].view(6, 6), packed[36:72].view(6, 6)),
                         b=CSFD(packed[72:78], packed[78:84]), inlier_count=count)
