"""The sharded engine's stages over X-slabs: the port of the dense half of
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
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..csfd.single import CSFD
from ..geometry import se3
from ..geometry.intrinsics import Intrinsics
from ..ops import fusion, icp, kernels, raycast
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
    both = torch.stack([flag.to(torch.int32), n_active.to(torch.int32)])
    dist.all_reduce(both, group=group.group)
    return both[0] > 0, both[1]


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
    """This rank's block of the last axis of ``m`` (the current maps' image
    columns, every pyramid width a multiple of the world size): the map
    itself on one rank, else a contiguous copy of the block."""
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
