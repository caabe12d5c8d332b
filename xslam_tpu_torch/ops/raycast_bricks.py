"""Raycasting straight from the brick-major volume: the temporal march with
the ``reuse`` refine and screen normals, and its ``hier2`` skip refresh.

Port of ``xslam_tpu/ops/raycast_bricks.py`` for ``march_mode="temporal"``
(with its ``hier2_hit`` refresh, the ``hier2_skip`` march), pair
taps (``trilinear_pair_bricks``, bit-identical to the scalar taps) and
``refine_mode="reuse"``; the engine raises for the other march modes,
compaction and the packed or quad taps. March parameters are the reference's (step 0.8 trunc over
[0.2, 5.0] m, reads of the nearest voxel + 1e-5).

:func:`raycast_bricks_rays` is the plain composition over explicit rays, as
the JAX function takes them. :func:`raycast_bricks`, the engine's entry,
composes three kernels, each a wrapper here or in :mod:`.bricks` that runs
its plain version on CPU tensors:

- B4 :func:`window_march` (``csrc/window.cu``): the anchored window march,
  with the ``reuse`` refine fused after it (the world vertex map) or without
  it (the hits, for the refresh's half level);
- B5a :func:`xslam_tpu_torch.ops.bricks.skip_field` (``csrc/skip.cu``);
- B5b :func:`march_skip` (``csrc/skip.cu``): the skip march at a quarter of
  the model maps' resolution.

The screen normals (B4n, plain version
:func:`xslam_tpu_torch.ops.raycast.screen_normals_plain`) are left to the
model-map pyramid, whose launch computes them
(:func:`xslam_tpu_torch.models.kinfu.model_map_pyramid` with no normals
given).

A frame takes the temporal branch (B4 with the refine) when at least
``min_coverage`` of its anchors are finite, else the refresh (B5a, B5b, B4
without and with the refine). The engine's anchors fall back to the last
raycast's ``t_found``, which is 1e9 (finite) where a ray found nothing, so
after frame 0 the coverage reads 1.0 and the refresh cannot run; it is kept
and computed as the reference computes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..csfd import vec3
from ..csfd.single import CSFD, lift
from ..geometry.intrinsics import Intrinsics
from . import bricks, kernels
from .bricks import BrickVolume
from .fusion import VolumeConfig
from .kernels import INF_T
from .raycast import (
    RaycastHit, _window_repair, finalize_maps, march_skip_plain, march_temporal, refine_from_samples,
    screen_normals_plain,
)
from .sampling import to_index

MID_WINDOW = 12  # the refresh's half-resolution window (xslam_tpu/ops/raycast_bricks.py::hier2_hit)
SKIP_STRIDE = 4  # the refresh's skip march takes every 4th ray of the model maps in each axis


def _value_reader(plane: torch.Tensor, res):
    def read(g):
        return bricks.gather(plane, res, g[0], g[1], g[2]) + 1e-5

    return read


def interleave_vg(bvol: BrickVolume) -> torch.Tensor:
    """(NB*512, 2) table: row ``flat_index(res, x, y, z)`` holds that voxel's
    ``[value, grad]``."""
    return torch.stack([bvol.value, bvol.grad], dim=-1).reshape(-1, 2)


def trilinear_pair_bricks(vg: torch.Tensor, res, px: CSFD, py: CSFD, pz: CSFD, voxel_size: float) -> CSFD:
    """Dual trilinear TSDF interpolation, each tap's (value, grad) one row of
    an :func:`interleave_vg` table: the bits of
    :func:`xslam_tpu_torch.ops.raycast.trilinear_tsdf_shard` on the dense
    twin of the volume (the base cell shifted below the voxel centre, the
    +1e-5 bias, the bounds fills, the summation order)."""
    X, Y, Z = res
    inv_vs = 1.0 / voxel_size

    gx = to_index(torch.floor(px.v * inv_vs))
    gy = to_index(torch.floor(py.v * inv_vs))
    gz = to_index(torch.floor(pz.v * inv_vs))
    ok = (gx > 0) & (gx < X - 1) & (gy > 0) & (gy < Y - 1) & (gz > 0) & (gz < Z - 1)

    gx = gx - (px.v < (gx.to(torch.float32) + 0.5) * voxel_size).to(gx.dtype)
    gy = gy - (py.v < (gy.to(torch.float32) + 0.5) * voxel_size).to(gy.dtype)
    gz = gz - (pz.v < (gz.to(torch.float32) + 0.5) * voxel_size).to(gz.dtype)

    a0 = px * inv_vs - (gx.to(torch.float32) + 0.5)
    b0 = py * inv_vs - (gy.to(torch.float32) + 0.5)
    c0 = pz * inv_vs - (gz.to(torch.float32) + 0.5)
    one = lift(1.0)
    a1, b1, c1 = one - a0, one - b0, one - c0

    def tap(dx, dy, dz) -> CSFD:
        ix, iy, iz = gx + dx, gy + dy, gz + dz
        okt = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
        idx = bricks.flat_index(res, ix.clamp(0, X - 1), iy.clamp(0, Y - 1), iz.clamp(0, Z - 1))
        r = vg[idx.reshape(-1)].reshape(*ix.shape, 2)
        return CSFD(torch.where(okt, r[..., 0], 0.0) + 1e-5, torch.where(okt, r[..., 1], 0.0))

    out = (
        tap(0, 0, 0) * (a1 * b1 * c1)
        + tap(0, 0, 1) * (a1 * b1 * c0)
        + tap(0, 1, 0) * (a1 * b0 * c1)
        + tap(0, 1, 1) * (a1 * b0 * c0)
        + tap(1, 0, 0) * (a0 * b1 * c1)
        + tap(1, 0, 1) * (a0 * b1 * c0)
        + tap(1, 1, 0) * (a0 * b0 * c1)
        + tap(1, 1, 1) * (a0 * b0 * c0)
    )
    return CSFD(torch.where(ok, out.v, torch.nan), torch.where(ok, out.g, 0.0))


def _pair_trilinear(bvol: BrickVolume, cfg: VolumeConfig):
    vg = interleave_vg(bvol)

    def trilin_at(p: CSFD) -> CSFD:
        return trilinear_pair_bricks(vg, cfg.resolution, vec3.comp(p, 0), vec3.comp(p, 1), vec3.comp(p, 2),
                                     cfg.voxel_size)

    return trilin_at


def _reuse_maps(bvol, ray_start, ray_dir, out, r_v2w, t_v2w, cfg) -> Tuple[CSFD, RaycastHit]:
    """The ``reuse`` refine of a window march's ``(hit, f0, f1)``: the world
    vertex map with its NaN sentinels, and the hit."""
    hit, f0, f1 = out
    accept = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    vmap, nmap, v_ok, n_ok = refine_from_samples(_pair_trilinear(bvol, cfg), ray_start, ray_dir, hit.t_found, f0,
                                                 f1, accept, r_v2w, t_v2w, cfg)
    return finalize_maps(vmap, nmap, v_ok, n_ok)[0], hit


# ---------------------------------------------------------------- plain path
def raycast_bricks_rays(
    bvol: BrickVolume, ray_start: CSFD, ray_dir: CSFD, r_v2w: CSFD, t_v2w: CSFD, cfg: VolumeConfig,
    t_anchor: torch.Tensor, temporal_window: int = 12, temporal_min_coverage: float = 0.5, hier_window: int = 12,
    return_hit: bool = False,
):
    """March + refine + screen normals for an explicit ray bundle (dual
    ``ray_dir`` (3, H, W), ``ray_start`` (3,)), in plain PyTorch: the port of
    ``xslam_tpu/ops/raycast_bricks.py::raycast_bricks_rays`` with
    ``march_mode="temporal"``, pair taps, ``refine_mode="reuse"`` and screen
    normals. It marches around ``t_anchor`` when the finite share of its
    entries reaches ``temporal_min_coverage`` (a host read here), else takes
    the ``hier2_hit`` refresh: the skip march at a quarter of the
    resolution, a 12-step repair at half, a ``hier_window``-step repair at
    full. Returns ``(vmap, nmap)`` and, with ``return_hit``, the march's
    ``t_found``."""
    res = cfg.resolution
    value_read = _value_reader(bvol.value, res)
    if float(anchor_coverage(t_anchor)) >= temporal_min_coverage:
        out = march_temporal(t_anchor, ray_start, ray_dir, cfg, window=temporal_window, read_fn=value_read,
                             shape=res, return_samples=True)
    else:
        packed_read = _value_reader(bricks.skip_rows(bvol, res), res)
        q = SKIP_STRIDE
        coarse = march_skip_plain(ray_start, ray_dir.v[:, ::q, ::q], cfg, packed_read, res)
        mid = _window_repair(ray_start, ray_dir.v[:, ::2, ::2], coarse, MID_WINDOW, cfg, value_read, res)
        out = _window_repair(ray_start, ray_dir.v, mid, hier_window, cfg, value_read, res, return_samples=True)
    vmap, hit = _reuse_maps(bvol, ray_start, ray_dir, out, r_v2w, t_v2w, cfg)
    nmap = screen_normals_plain(vmap)
    return (vmap, nmap, hit.t_found) if return_hit else (vmap, nmap)


def anchor_map(vmap_curr: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    """The temporal march's anchors: each ray's distance to the current depth
    frame's surface, ``|vertex|`` of the camera-space vertex map (3, H, W)
    at the model maps' level, falling back to the last raycast's hit
    distance ``t_prev`` where the depth is invalid (xslam_tpu/models/
    kinfu.py:491-492). The norm adds the squares left to right."""
    depth_t = torch.sqrt(torch.sum(vmap_curr * vmap_curr, dim=0))
    return torch.where(torch.isfinite(depth_t), depth_t, t_prev)


def anchor_coverage(t_anchor: torch.Tensor) -> torch.Tensor:
    """The share of finite anchors, a float32 device scalar."""
    return torch.isfinite(t_anchor).to(torch.float32).mean()


# ------------------------------------------------------------- the kernels
def _rays(pose: torch.Tensor, intr: Intrinsics):
    r_c2v, t_c2v, r_v2w, t_v2w = kernels.unpack_ray_pose(pose)
    ray_dir, ray_start = kernels.camera_rays(r_c2v, t_c2v, intr)
    return ray_start, ray_dir, r_v2w, t_v2w


def _strided(n: int, stride: int) -> int:
    return (n + stride - 1) // stride


def window_march(bvol: BrickVolume, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig, anchor: torch.Tensor,
                 window: int, anchor_dead: Optional[torch.Tensor] = None, stride: int = 1, refine: bool = False):
    """Kernel B4 (``csrc/window.cu``): the anchored window march over the
    brick rows along the rays of every ``stride``-th pixel of ``intr``
    (in each axis) at the packed pose (:func:`kernels.pack_ray_pose`).

    Anchors: with ``anchor_dead`` None, ``anchor`` is an anchor map at the
    march's own resolution, min-pooled 2x2 (:func:`march_temporal`); else
    ``(anchor, anchor_dead)`` are the hits of the level above
    (:func:`_window_repair`'s ``coarse``). Returns the :class:`RaycastHit`;
    with ``refine`` (``stride`` 1) instead ``(vmap, t_found)``: the ``reuse``
    refine of the bracketing samples through the pair taps, the dual world
    vertex map (3, H, W) with NaN value and zero derivative where rejected,
    and the march's ``t_found``. On CPU tensors its plain version."""
    res = cfg.resolution
    H, W = _strided(intr.height, stride), _strided(intr.width, stride)
    if refine and stride != 1:
        raise ValueError("the refine runs at the full resolution (stride 1)")
    anchors = (anchor,) if anchor_dead is None else (anchor, anchor_dead)
    if kernels.on_cpu(bvol.value, bvol.grad, pose, *anchors):
        ray_start, ray_dir, r_v2w, t_v2w = _rays(pose, intr)
        dirs = CSFD(ray_dir.v[:, ::stride, ::stride], ray_dir.g[:, ::stride, ::stride])
        read = _value_reader(bvol.value, res)
        if anchor_dead is None:
            out = march_temporal(anchor, ray_start, dirs, cfg, window=window, read_fn=read, shape=res,
                                 return_samples=refine)
        else:
            out = _window_repair(ray_start, dirs.v, RaycastHit(anchor, anchor_dead), window, cfg, read, res,
                                 return_samples=refine)
        if not refine:
            return out
        vmap, hit = _reuse_maps(bvol, ray_start, ray_dir, out, r_v2w, t_v2w, cfg)
        return vmap, hit.t_found
    nbx, nby, nbz = bricks.brick_grid(res)
    n = nbx * nby * nbz
    for t, name in ((bvol.value, "value"), (bvol.grad, "grad")):
        kernels.check_tensor(t, name, torch.float32, (n, bricks.BRICK ** 3))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    if anchor_dead is None:
        if H % 2 or W % 2:
            raise ValueError(f"a pooled anchor map needs an even size, got {H}x{W}")
        kernels.check_tensor(anchor, "anchor", torch.float32, (H, W))
        ch, cw = H // 2, W // 2
    else:
        ch, cw = anchor.shape
        if 2 * ch < H or 2 * cw < W:
            raise ValueError(f"coarse hits of {ch}x{cw} do not cover {H}x{W}")
        for t, name in ((anchor, "anchor"), (anchor_dead, "anchor_dead")):
            kernels.check_tensor(t, name, torch.float32, (ch, cw))
    dev = pose.device
    t_found = torch.empty((H, W), dtype=torch.float32, device=dev)
    if refine:
        outs = (torch.empty((3, H, W), dtype=torch.float32, device=dev),
                torch.empty((3, H, W), dtype=torch.float32, device=dev), t_found, None)
    else:
        outs = (None, None, t_found, torch.empty((H, W), dtype=torch.float32, device=dev))
    f32 = kernels.f32
    step = cfg.trunc_dist * 0.8
    kernels.launch(
        "window_march", dev, bvol.value, bvol.grad, pose, anchor, anchor_dead, *outs, nbx, nby, nbz, H, W, ch, cw,
        stride, int(window), f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(step),
        kernels.reciprocal_f32(step), *kernels.camera_args(intr),
    )
    kernels.launch_counts["window_march"] += 1
    if refine:
        return CSFD(outs[0], outs[1]), t_found
    return RaycastHit(t_found, outs[3])


def march_skip(bvol: BrickVolume, dist: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig,
               stride: int = SKIP_STRIDE) -> RaycastHit:
    """Kernel B5b (``csrc/skip.cu``): the skip march along the rays of every
    ``stride``-th pixel of ``intr`` at the packed pose, over the value rows
    and B5a's per-brick distance ``dist`` (NB,) int32: a brick at distance
    >= 2 reads as ``JUMP_BASE + dist``, as :func:`bricks.skip_rows` packs
    it, without the packed copy. On CPU tensors its plain version,
    :func:`march_skip_plain` over :func:`bricks.pack_rows`. The events are
    the fixed march's on these rays."""
    res = cfg.resolution
    if kernels.on_cpu(bvol.value, dist, pose):
        ray_start, ray_dir, _, _ = _rays(pose, intr)
        packed_read = _value_reader(bricks.pack_rows(bvol.value, dist), res)
        return march_skip_plain(ray_start, ray_dir.v[:, ::stride, ::stride], cfg, packed_read, res)
    nbx, nby, nbz = bricks.brick_grid(res)
    n = nbx * nby * nbz
    kernels.check_tensor(bvol.value, "value", torch.float32, (n, bricks.BRICK ** 3))
    kernels.check_tensor(dist, "dist", torch.int32, (n,))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    H, W = _strided(intr.height, stride), _strided(intr.width, stride)
    t_found = torch.empty((H, W), dtype=torch.float32, device=pose.device)
    t_dead = torch.empty_like(t_found)
    step = cfg.trunc_dist * 0.8
    steps_per_cell = bricks.BRICK * cfg.voxel_size / step
    f32 = kernels.f32
    kernels.launch(
        "march_skip", pose.device, bvol.value, dist, pose, t_found, t_dead, nbx, nby, nbz, stride,
        kernels.march_steps(cfg.trunc_dist), f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(step),
        f32(steps_per_cell), *kernels.camera_args(intr),
    )
    kernels.launch_counts["march_skip"] += 1
    return RaycastHit(t_found, t_dead)


def raycast_bricks(
    bvol: BrickVolume, r_c2v: CSFD, t_c2v: CSFD, r_v2w: CSFD, t_v2w: CSFD, intr: Intrinsics, cfg: VolumeConfig,
    t_anchor: torch.Tensor, refresh: bool, temporal_window: int = 12, hier_window: int = 12,
) -> Tuple[CSFD, torch.Tensor]:
    """The temporal raycast of the model vertex map at ``intr``'s resolution
    from a brick-major volume, through the kernels: ``(vmap, t_found)``, the
    dual world vertex map (3, H, W) with NaN sentinels and the march's hit
    distances (the next frame's fallback anchors; 1e9 where none); its
    screen normals are left to
    :func:`xslam_tpu_torch.models.kinfu.model_map_pyramid`. ``refresh``:
    take the ``hier2`` refresh (B5a, B5b, B4 twice) instead of the anchored
    march (B4); the engine decides it from :func:`anchor_coverage`. On CPU
    tensors every kernel runs its plain version, so the result is
    :func:`raycast_bricks_rays`'s with the rays of
    :func:`kernels.camera_rays`."""
    pose = kernels.pack_ray_pose(r_c2v, t_c2v, r_v2w, t_v2w)
    if refresh:
        dist = bricks.skip_field(bvol, cfg.resolution)
        coarse = march_skip(bvol, dist, pose, intr, cfg)
        mid = window_march(bvol, pose, intr, cfg, coarse.t_found, MID_WINDOW, anchor_dead=coarse.t_dead, stride=2)
        return window_march(bvol, pose, intr, cfg, mid.t_found, hier_window, anchor_dead=mid.t_dead, refine=True)
    return window_march(bvol, pose, intr, cfg, t_anchor, temporal_window, refine=True)
