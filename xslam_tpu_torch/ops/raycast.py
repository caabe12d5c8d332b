"""TSDF raycasting: render the model vertex/normal maps from a camera pose.

Port of the dense volume's raycast of ``xslam_tpu/ops/raycast.py``
(reference ``RayCaster.cu``), every march of its ``MARCH_MODES``, the
``secant2`` refine with TSDF or screen normals. The camera rays and the
fixed march are kernel K3 (:func:`xslam_tpu_torch.ops.kernels.march_fixed`,
plain version :func:`~xslam_tpu_torch.ops.kernels.camera_rays` then
:func:`~xslam_tpu_torch.ops.kernels.march_fixed_plain`; with a stride, the
hierarchical marches' coarse passes); the dual secant refinement, the TSDF
central-difference normals and the maps' NaN sentinels are kernel K5
(:func:`raycast_refine`, ``csrc/refine.cu``; plain version :func:`refine`
then :func:`finalize_maps`). The dense layout's empty-space skipping and
window repair are the B14 kernels, the brick layout's B5a, B5b and B4 with
dense addressing: B14a :func:`skip_field_dense` (plain
:func:`brick_distance_field`), B14b :func:`march_skip_dense` (plain
:func:`march_skip_plain` over :func:`skip_volume`), B14c
:func:`window_march_dense` (plain :func:`_window_repair` over the dense
reader); :func:`march_hier` and :func:`march_hier2` compose them with K3.
Screen normals (``normals_mode="screen"``) are left to the model-map
pyramid, whose launch computes them (B4n,
:func:`xslam_tpu_torch.models.kinfu.model_map_pyramid` with no normals
given), as on the brick layout. March parameters mirror the reference: step
= 0.8 * trunc_dist, range [0.2, 5.0] m, secant ``Ts = t - step *
Ft/(Ftdt - Ft)``, normals at +-half a voxel.

The brick layout's marches and refine (:mod:`xslam_tpu_torch.ops.raycast_bricks`)
compose the plain ports kept here, each read through a voxel reader:
:func:`march_skip_plain` (the empty-space-skipping march), :func:`_window_repair`
and :func:`march_temporal` (the anchored window marches),
:func:`refine_from_samples` (the ``reuse`` refine) and
:func:`screen_normals_plain`, B4n's plain version (the kernel computes the
normals in K6's launch: :func:`xslam_tpu_torch.models.kinfu.model_map_pyramid`).

The sharded engine's raycast over X-slabs (B19b, B19c;
:mod:`xslam_tpu_torch.parallel.sharded`) places a slab with a
:class:`ShardSpec`: K3 ``kernels.march_fixed(spec=)``, then K5's shard mode
:func:`raycast_refine_shard` (plain :func:`refine` with ``spec``), whose
ranks' sums :func:`raycast_finalize` (K5's finalize; plain
:func:`finalize_maps`) turns into the model maps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..csfd import vec3
from ..csfd.single import CSFD, lift
from ..geometry.intrinsics import Intrinsics
from . import bricks, kernels
from .fusion import VolumeConfig, VolumeState
from .kernels import INF_T, RAY_MAX_M, RAY_MIN_M
from .bricks import BRICK, JUMP_BASE
from .preprocess import _shift2d
from .sampling import gather3d, to_index

MARCH_MODES = ("fixed", "skip", "hier", "hier_skip", "hier2")
# the hier2 march's half-resolution repair window, dense and brick layout (xslam_tpu/ops/raycast.py:561,
# xslam_tpu/ops/raycast_bricks.py::hier2_hit)
HIER2_MID_WINDOW = 12
# the rays from which the skip march (B5b, B14b) launches its ray form, a thread a ray, instead of a warp a ray: on
# an NVIDIA H100 80GB HBM3 at 700 W the warp a ray took 0.0077 / 0.0189 / 0.0619 ms at 4,800 / 19,200 / 76,800 rays
# of the brick rows and the ray form 0.026 at each (its longest ray's chain of dependent reads), so they cross near
# 29,000 rays (chip_smoke.py's "skip march forms")
SKIP_RAY_FORM_MIN_RAYS = 32768


def skip_ray_form(H: int, W: int) -> bool:
    """Whether the skip march over ``H x W`` rays launches its ray form."""
    return H * W >= SKIP_RAY_FORM_MIN_RAYS


@dataclass(frozen=True)
class ShardSpec:
    """Global placement of a local X-slab (``xslam_tpu/ops/raycast.py::
    ShardSpec``): rows ``[x_base, x_base + local_x)`` of a volume with
    ``x_total`` rows; the slab owns the core rows ``[core_start, core_end)``
    (global indices)."""

    x_base: int = 0
    x_total: Optional[int] = None  # None: the local extent is the whole volume
    core_start: int = 0
    core_end: Optional[int] = None


def _resolve(spec: ShardSpec, local_shape) -> Tuple[int, int, int, int]:
    """``(x_base, x_total, core_start, core_end)`` of ``spec`` for a slab of
    ``local_shape``."""
    return kernels.resolve_spec(spec, local_shape[0])


# the maps of K5's shard mode, one (H, W) plane each: vmap.v (3), vmap.g (3), nmap.v (3), nmap.g (3), then the v and
# n masks (1 or 0): the planes the ranks sum
SHARD_PLANES = 14


class RaycastHit(NamedTuple):
    """Per-pixel march outcome before refinement."""

    t_found: torch.Tensor  # (H, W) first-crossing march time, INF_T if none
    t_dead: torch.Tensor  # (H, W) first death (neg->pos or volume exit) time


def trilinear_tsdf_shard(
    value: torch.Tensor, grad: torch.Tensor, px: CSFD, py: CSFD, pz: CSFD, voxel_size: float,
    spec: ShardSpec = ShardSpec(),
) -> CSFD:
    """Dual trilinear TSDF interpolation at metric points (global
    coordinates) of the volume, read from a local slab placed by ``spec``
    (the whole volume by default). Out-of-(global)-bounds -> NaN value; a
    tap outside the slab reads 0 (B19b).

    Cell selection shifts the base cell when the point is below the voxel
    centre (RayCaster.cu:117-122); taps carry ``readTsdf``'s +1e-5 bias
    (RayCaster.cu:77)."""
    _, Y, Z = value.shape
    x_base, X, _, _ = _resolve(spec, value.shape)
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

    lx = gx - x_base

    def tap(dx, dy, dz) -> CSFD:
        ix, iy, iz = lx + dx, gy + dy, gz + dz
        return CSFD(gather3d(value, ix, iy, iz) + 1e-5, gather3d(grad, ix, iy, iz))

    res = (
        tap(0, 0, 0) * (a1 * b1 * c1)
        + tap(0, 0, 1) * (a1 * b1 * c0)
        + tap(0, 1, 0) * (a1 * b0 * c1)
        + tap(0, 1, 1) * (a1 * b0 * c0)
        + tap(1, 0, 0) * (a0 * b1 * c1)
        + tap(1, 0, 1) * (a0 * b1 * c0)
        + tap(1, 1, 0) * (a0 * b0 * c1)
        + tap(1, 1, 1) * (a0 * b0 * c0)
    )
    return CSFD(torch.where(ok, res.v, torch.nan), torch.where(ok, res.g, 0.0))


def refine(
    vol: Optional[VolumeState],
    ray_start: CSFD,
    ray_dir: CSFD,
    hit_t: torch.Tensor,
    accept: torch.Tensor,
    r_v2w: CSFD,
    t_v2w: CSFD,
    cfg: VolumeConfig,
    trilin_fn=None,
    shape=None,
    spec: ShardSpec = ShardSpec(),
) -> Tuple[CSFD, CSFD, torch.Tensor, torch.Tensor]:
    """Dual secant refinement + TSDF central-difference normals at ``hit_t``
    for pixels where ``accept`` (the reference's ``secant2`` refine with
    ``normals_mode="tsdf"``). Returns (vmap_w, nmap_w, v_ok, n_ok) with zeros
    outside the masks. ``trilin_fn`` (dual point -> dual TSDF) and ``shape``
    (the volume's (X, Y, Z), the normals' margin) read another layout, as
    the JAX signature's ``trilin_fn`` and its shape-only volume do (the brick
    rows: :func:`xslam_tpu_torch.ops.raycast_bricks.trilinear_pair_bricks`,
    then ``vol`` may be None); by default :func:`trilinear_tsdf_shard` of
    ``vol``, a slab placed by ``spec`` (B19c: the taps read its local rows,
    the bounds and the normals' margin take the ``x_total``-row volume;
    ``xslam_tpu/ops/raycast.py::refine(spec=)``)."""
    voxel = cfg.voxel_size
    step = cfg.trunc_dist * 0.8
    X, Y, Z = vol.value.shape if shape is None else shape
    if shape is None:
        X = _resolve(spec, vol.value.shape)[1]

    def point_at(t: CSFD) -> CSFD:
        return vec3.vec3(
            vec3.comp(ray_start, 0) + vec3.comp(ray_dir, 0) * t,
            vec3.comp(ray_start, 1) + vec3.comp(ray_dir, 1) * t,
            vec3.comp(ray_start, 2) + vec3.comp(ray_dir, 2) * t,
        )

    def trilin_at(p: CSFD) -> CSFD:
        if trilin_fn is not None:
            return trilin_fn(p)
        return trilinear_tsdf_shard(
            vol.value, vol.grad, vec3.comp(p, 0), vec3.comp(p, 1), vec3.comp(p, 2), voxel, spec
        )

    t_dual = lift(torch.where(accept, hit_t, RAY_MIN_M))
    ft = trilin_at(point_at(t_dual))
    ftdt = trilin_at(point_at(t_dual + step))
    ok = (
        accept
        & ~torch.isnan(ft.v)
        & ~torch.isnan(ftdt.v)
        & (ft.v >= 0.0)
        & (ftdt.v <= 0.0)
        & (ftdt.v != ft.v)
    )
    diff = ftdt - ft
    denom = CSFD(torch.where(ok, diff.v, 1.0), torch.where(ok, diff.g, 0.0))
    ts = t_dual - (ft / denom) * step

    vertex = point_at(ts)  # volume coords, dual
    vertex_w = vec3.matvec(r_v2w, vertex) + CSFD(t_v2w.v[:, None, None], t_v2w.g[:, None, None])
    vmap = CSFD(
        torch.where(ok[None], torch.nan_to_num(vertex_w.v), 0.0),
        torch.where(ok[None], torch.nan_to_num(vertex_w.g), 0.0),
    )

    # central-difference normals with the reference's interior margin
    # (RayCaster.cu:270-271)
    gv = to_index(torch.floor(vertex.v / voxel))
    n_ok = ok & (
        (gv[0] > 1) & (gv[0] < X - 2)
        & (gv[1] > 1) & (gv[1] < Y - 2)
        & (gv[2] > 1) & (gv[2] < Z - 2)
    )
    half = voxel * 0.5

    def shifted(axis, sign):
        comps = [vec3.comp(vertex, i) for i in range(3)]
        comps[axis] = comps[axis] + sign * half
        return trilin_at(vec3.vec3(*comps))

    n = vec3.vec3(
        shifted(0, +1) - shifted(0, -1),
        shifted(1, +1) - shifted(1, -1),
        shifted(2, +1) - shifted(2, -1),
    )
    nsq = vec3.squarednorm(n)
    n_ok = n_ok & (nsq.v > 0.0) & ~torch.isnan(nsq.v)
    safe_n = CSFD(torch.where(n_ok[None], n.v, 1.0), torch.where(n_ok[None], n.g, 0.0))
    n_g = vec3.matvec(r_v2w, vec3.normalized(safe_n))
    nmap = CSFD(
        torch.where(n_ok[None], torch.nan_to_num(n_g.v), 0.0),
        torch.where(n_ok[None], torch.nan_to_num(n_g.g), 0.0),
    )
    return vmap, nmap, ok, n_ok


def finalize_maps(vmap: CSFD, nmap: CSFD, v_ok, n_ok) -> Tuple[CSFD, CSFD]:
    """Install the NaN sentinels the downstream consumers check."""
    vm = CSFD(torch.where(v_ok[None], vmap.v, torch.nan), torch.where(v_ok[None], vmap.g, 0.0))
    nm = CSFD(torch.where(n_ok[None], nmap.v, torch.nan), torch.where(n_ok[None], nmap.g, 0.0))
    return vm, nm


def raycast_refine(
    vol: VolumeState, pose: torch.Tensor, t_found: torch.Tensor, t_dead: torch.Tensor, intr: Intrinsics,
    cfg: VolumeConfig, direct: Optional[torch.Tensor] = None,
) -> Tuple[CSFD, CSFD]:
    """Kernel K5: the model vertex and normal maps (dual, world coordinates,
    (3, H, W), NaN value and zero derivative where invalid) from the march's
    ``t_found``/``t_dead`` at the packed pose
    (:func:`xslam_tpu_torch.ops.kernels.pack_ray_pose`). On CPU tensors its
    plain version: the rays, :func:`refine`, :func:`finalize_maps`.

    ``direct``, an int32 (1,) tensor on the card, gets added the number of
    normal samples the kernel read outside the block of voxels it shares
    between a pixel's six (``csrc/refine.cu``); unused on the CPU."""
    if kernels.on_cpu(vol.value, vol.grad, pose, t_found, t_dead, *(() if direct is None else (direct,))):
        r_c2v, t_c2v, r_v2w, t_v2w = kernels.unpack_ray_pose(pose)
        ray_dir, ray_start = kernels.camera_rays(r_c2v, t_c2v, intr)
        accept = t_found < torch.clamp(t_dead, max=INF_T)
        return finalize_maps(*refine(vol, ray_start, ray_dir, t_found, accept, r_v2w, t_v2w, cfg))
    X, Y, Z = vol.value.shape
    H, W = intr.height, intr.width
    for t, name in ((vol.value, "value"), (vol.grad, "grad")):
        kernels.check_tensor(t, name, torch.float32, (X, Y, Z))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    for t, name in ((t_found, "t_found"), (t_dead, "t_dead")):
        kernels.check_tensor(t, name, torch.float32, (H, W))
    if vol.value.numel() >= 1 << 31:
        raise ValueError(f"value: K5 indexes the volume with 32 bits, got {vol.value.numel()} voxels")
    if direct is not None:
        kernels.check_tensor(direct, "direct", torch.int32, (1,))
    out = [torch.empty((3, H, W), dtype=torch.float32, device=pose.device) for _ in range(4)]
    f32 = kernels.f32
    kernels.launch(
        "raycast_refine", pose.device, vol.value, vol.grad, pose, t_found, t_dead, *out, direct,
        f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(cfg.voxel_size * 0.5),
        f32(cfg.trunc_dist * 0.8), *kernels.camera_args(intr),
    )
    kernels.launch_counts["raycast_refine"] += 1
    return CSFD(out[0], out[1]), CSFD(out[2], out[3])


def raycast_refine_shard(vol: VolumeState, pose: torch.Tensor, t_found: torch.Tensor, t_found_min: torch.Tensor,
                         t_dead_min: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig, spec: ShardSpec) -> torch.Tensor:
    """K5's shard mode (B19c, ``csrc/refine.cu``): the refine of a slab
    with its halo (``vol``, placed by ``spec``) from its own march hits
    ``t_found`` and the ranks' minima ``t_found_min``, ``t_dead_min``, as
    ``xslam_tpu/parallel/sharded.py:129-139`` calls ``refine``: a pixel is
    refined at ``t_found_min`` where that is accepted (below ``t_dead_min``
    and 1e9) and this slab owns it (``t_found == t_found_min``). Returns the
    (:data:`SHARD_PLANES`, H, W) float32 planes the ranks sum: the maps with
    zeros where not valid, then the two masks (1 or 0). On CPU tensors its
    plain version, :func:`raycast_refine_shard_plain`."""
    H, W = intr.height, intr.width
    if kernels.on_cpu(vol.value, vol.grad, pose, t_found, t_found_min, t_dead_min):
        return raycast_refine_shard_plain(vol, pose, t_found, t_found_min, t_dead_min, intr, cfg, spec)
    Xl, Y, Z = vol.value.shape
    x_base, x_total, _, _ = _resolve(spec, vol.value.shape)
    for t, name in ((vol.value, "value"), (vol.grad, "grad")):
        kernels.check_tensor(t, name, torch.float32, (Xl, Y, Z))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    for t, name in ((t_found, "t_found"), (t_found_min, "t_found_min"), (t_dead_min, "t_dead_min")):
        kernels.check_tensor(t, name, torch.float32, (H, W))
    if vol.value.numel() >= 1 << 31:
        raise ValueError(f"value: K5 indexes the slab with 32 bits, got {vol.value.numel()} voxels")
    maps = torch.empty((SHARD_PLANES, H, W), dtype=torch.float32, device=pose.device)
    f32 = kernels.f32
    kernels.launch(
        "raycast_refine_shard", pose.device, vol.value, vol.grad, pose, t_found, t_found_min, t_dead_min, maps,
        x_base, x_total, f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(cfg.voxel_size * 0.5),
        f32(cfg.trunc_dist * 0.8), *kernels.camera_args(intr),
    )
    kernels.launch_counts["raycast_refine_shard"] += 1
    return maps


def raycast_refine_shard_plain(vol: VolumeState, pose: torch.Tensor, t_found: torch.Tensor,
                               t_found_min: torch.Tensor, t_dead_min: torch.Tensor, intr: Intrinsics,
                               cfg: VolumeConfig, spec: ShardSpec) -> torch.Tensor:
    """Plain version of K5's shard mode, on any device: the rays, the owner
    (the minimum accepted and this slab's ``t_found`` equal to it),
    :func:`refine` with ``spec``, the planes stacked."""
    r_c2v, t_c2v, r_v2w, t_v2w = kernels.unpack_ray_pose(pose)
    ray_dir, ray_start = kernels.camera_rays(r_c2v, t_c2v, intr)
    accept = (t_found_min < INF_T) & (t_found_min < t_dead_min)
    owner = accept & (t_found == t_found_min)
    vmap, nmap, v_ok, n_ok = refine(vol, ray_start, ray_dir, t_found_min, owner, r_v2w, t_v2w, cfg, spec=spec)
    return torch.cat([vmap.v, vmap.g, nmap.v, nmap.g, v_ok[None].to(torch.float32), n_ok[None].to(torch.float32)])


def raycast_finalize(maps: torch.Tensor) -> Tuple[CSFD, CSFD]:
    """K5's finalize (B19c): the model maps ``(vmap, nmap)``, (3, H, W)
    dual each, from the ranks' sum of :func:`raycast_refine_shard`'s planes:
    NaN value and zero derivative where a mask sums to 0. On the card one
    launch, in place: the maps are views of ``maps``. On CPU tensors its
    plain version, :func:`finalize_maps`."""
    if maps.dim() != 3 or maps.shape[0] != SHARD_PLANES:
        raise ValueError(f"maps: expected ({SHARD_PLANES}, H, W), got {tuple(maps.shape)}")
    if kernels.on_cpu(maps):
        return finalize_maps(CSFD(maps[0:3], maps[3:6]), CSFD(maps[6:9], maps[9:12]), maps[12] > 0, maps[13] > 0)
    kernels.check_tensor(maps, "maps", torch.float32)
    kernels.launch("raycast_finalize", maps.device, maps)
    kernels.launch_counts["raycast_finalize"] += 1
    return CSFD(maps[0:3], maps[3:6]), CSFD(maps[6:9], maps[9:12])


def raycast(
    vol: VolumeState,
    r_c2v: CSFD,
    t_c2v: CSFD,
    r_v2w: CSFD,
    t_v2w: CSFD,
    intr: Intrinsics,
    cfg: VolumeConfig,
    normals_mode: str = "tsdf",
    march_mode: str = "fixed",
    hier_window: int = 12,
    packed_taps: bool = False,
    compact: bool = False,
) -> Tuple[CSFD, Optional[CSFD]]:
    """Single-volume raycast, the port of ``xslam_tpu/ops/raycast.py::raycast``:
    the poses packed once, the march of ``march_mode`` (``fixed``: K3;
    ``skip``: B14a, B14b; ``hier``: K3 at stride 2, then B14c; ``hier_skip``:
    B14a, B14b at stride 2, then B14c; ``hier2``: K3 at stride 4, B14c at
    stride 2 with a 12-step window, B14c at stride 1), then the secant refine
    with the NaN sentinels (K5). ``hier_window`` is the last repair's window.
    Returns ``(vmap, nmap)``; with ``normals_mode="screen"`` ``(vmap, None)``:
    the vertex map is the TSDF-normal refine's (JAX's ``refine`` returns the
    same vertices and no normals), and the screen normals are the model-map
    pyramid's (B4n in K6's launch).

    ``packed_taps`` and ``compact`` are the JAX signature's and choose the
    same kernels: JAX's packed taps (``pack_vg_yz``) only change how the
    refine gathers its taps, bit for bit the scalar taps'
    (``tests/test_packed_gathers.py::test_refine_packed_taps_equal``), and
    its compacted skip march (``march_skip_compact``) only
    changes how the lockstep march is scheduled, with the skip march's
    events (``tests/test_bricks.py::test_march_skip_compact_bit_identical``);
    B14b marches each ray alone."""
    if march_mode not in MARCH_MODES:
        raise ValueError(f"unknown raycast march_mode {march_mode!r}; expected one of {MARCH_MODES}")
    if normals_mode not in ("tsdf", "screen"):
        raise ValueError(f"unknown raycast normals_mode {normals_mode!r}")
    del packed_taps, compact
    pose = kernels.pack_ray_pose(r_c2v, t_c2v, r_v2w, t_v2w)
    if march_mode == "skip":
        hit = march_skip_dense(vol, skip_field_dense(vol, cfg.resolution), pose, intr, cfg)
    elif march_mode in ("hier", "hier_skip"):
        hit = march_hier(vol, pose, intr, cfg, hier_window, skip=march_mode == "hier_skip")
    elif march_mode == "hier2":
        hit = march_hier2(vol, pose, intr, cfg, hier_window)
    else:
        hit = RaycastHit(*kernels.march_fixed(vol.value, pose, intr, cfg.voxel_size, cfg.trunc_dist))
    vmap, nmap = raycast_refine(vol, pose, hit.t_found, hit.t_dead, intr, cfg)
    return (vmap, None) if normals_mode == "screen" else (vmap, nmap)


# ------------------------------------------------------ the dense layout's B14
def _dense_reader(plane: torch.Tensor):
    def read(g):
        return gather3d(plane, g[0], g[1], g[2]) + 1e-5

    return read


def dense_event_mask(value: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(nbx, nby, nbz) bool: the 8^3 bricks of the dense planes that hold an
    observed negative voxel (``value < 0``, ``weight > 0``)."""
    X, Y, Z = value.shape
    nbx, nby, nbz = bricks.brick_grid((X, Y, Z))
    neg = (value < 0.0) & (weight > 0.0)
    return neg.reshape(nbx, BRICK, nby, BRICK, nbz, BRICK).any(dim=5).any(dim=3).any(dim=1)


def brick_distance_field(value: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(nbx, nby, nbz) int32: each brick's L-inf distance, capped at
    ``DIST_CAP``, to the once-dilated mask of event bricks, wrapping across
    the volume's faces as ``jnp.roll`` does: the port of
    ``xslam_tpu/ops/raycast.py::brick_distance_field``
    (:func:`xslam_tpu_torch.ops.bricks.distance_grid` of
    :func:`dense_event_mask`). B14a's plain version."""
    return bricks.distance_grid(dense_event_mask(value, weight))


def pack_dense(value: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """The jump-packed copy of the value plane given the brick distance
    ``dist`` ((NB,) or (nbx, nby, nbz)): ``JUMP_BASE + dist`` in every voxel
    of a brick at distance >= 2, the value elsewhere."""
    X, Y, Z = value.shape
    d = dist.reshape(bricks.brick_grid((X, Y, Z))).to(torch.float32)
    d = d.repeat_interleave(BRICK, 0).repeat_interleave(BRICK, 1).repeat_interleave(BRICK, 2)
    return torch.where(d >= 2.0, JUMP_BASE + d, value)


def skip_volume(value: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The port of ``xslam_tpu/ops/raycast.py::skip_volume``: the value plane
    with its bricks at distance >= 2 holding ``JUMP_BASE + dist``."""
    return pack_dense(value, brick_distance_field(value, weight))


def skip_field_dense(vol: VolumeState, res) -> torch.Tensor:
    """Kernel B14a (``csrc/skip.cu``, ``event_mask_kernel<true>`` and the
    distance kernel): :func:`brick_distance_field` of the dense planes as
    (NB,) int32 in brick order ``(bx * nby + by) * nbz + bz``, the same
    distance that :func:`xslam_tpu_torch.ops.bricks.skip_field` gives on the
    brick rows. On CPU tensors its plain version."""
    if kernels.on_cpu(vol.value, vol.weight):
        return brick_distance_field(vol.value, vol.weight).reshape(-1)
    nbx, nby, nbz = bricks.brick_grid(res)
    n = nbx * nby * nbz
    for t, name in ((vol.value, "value"), (vol.weight, "weight")):
        kernels.check_tensor(t, name, torch.float32, tuple(res))
    mask = torch.empty(n, dtype=torch.uint8, device=vol.value.device)
    dist = torch.empty(n, dtype=torch.int32, device=vol.value.device)
    kernels.launch("skip_field_dense", vol.value.device, vol.value, vol.weight, mask, dist, nbx, nby, nbz)
    kernels.launch_counts["skip_field_dense"] += 1
    return dist


def _strided_rays(pose: torch.Tensor, intr: Intrinsics, stride: int):
    r_c2v, t_c2v = kernels.unpack_ray_pose(pose)[:2]
    ray_dir, ray_start = kernels.camera_rays(r_c2v, t_c2v, intr)
    return ray_start, ray_dir.v[:, ::stride, ::stride]


def march_skip_dense(vol: VolumeState, dist: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig,
                     stride: int = 1) -> RaycastHit:
    """Kernel B14b (``csrc/skip.cu``, ``march_skip_ray_kernel<true>`` from
    :data:`SKIP_RAY_FORM_MIN_RAYS` rays, ``march_skip_kernel<true>`` below):
    the dense volume's skip march (``xslam_tpu/ops/raycast.py::march_skip``)
    along the rays of every ``stride``-th pixel of ``intr`` at the packed
    pose, over the value plane and B14a's distance: a cell at distance >= 2
    reads as ``JUMP_BASE + dist``, as :func:`skip_volume` packs it, without
    the packed copy. On CPU tensors its plain version, :func:`march_skip_plain`
    over :func:`pack_dense`. The events are the fixed march's on these rays.
    Counted as ``march_skip_dense`` in either form: every dense path's skip
    march has enough rays for the ray form (``kernels.launch_counts``)."""
    res = tuple(cfg.resolution)
    if kernels.on_cpu(vol.value, dist, pose):
        ray_start, dirs = _strided_rays(pose, intr, stride)
        return march_skip_plain(ray_start, dirs, cfg, _dense_reader(pack_dense(vol.value, dist)), res)
    nbx, nby, nbz = bricks.brick_grid(res)
    kernels.check_tensor(vol.value, "value", torch.float32, res)
    kernels.check_tensor(dist, "dist", torch.int32, (nbx * nby * nbz,))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    H, W = kernels.strided(intr.height, stride), kernels.strided(intr.width, stride)
    t_found = torch.empty((H, W), dtype=torch.float32, device=pose.device)
    t_dead = torch.empty_like(t_found)
    step = cfg.trunc_dist * 0.8
    f32 = kernels.f32
    kernels.launch(
        "march_skip_dense", pose.device, vol.value, dist, pose, t_found, t_dead, nbx, nby, nbz, stride,
        kernels.march_steps(cfg.trunc_dist), f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(step),
        f32(BRICK * cfg.voxel_size / step), *kernels.camera_args(intr), int(skip_ray_form(H, W)),
    )
    kernels.launch_counts["march_skip_dense"] += 1
    return RaycastHit(t_found, t_dead)


def window_march_dense(vol: VolumeState, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig,
                       coarse: RaycastHit, window: int, stride: int = 1) -> RaycastHit:
    """Kernel B14c (``csrc/window.cu``, ``window_dense_kernel``): the
    dense volume's window repair
    (``xslam_tpu/ops/raycast.py::_window_repair``) along the rays of every
    ``stride``-th pixel of ``intr``, each marched ``window`` steps around the
    earliest event of its 2x2 neighbourhood in ``coarse``, the hits one level
    up (2x subsampled; ``INF_T`` past their grid). On CPU tensors its plain
    version, :func:`_window_repair` over the value plane."""
    res = tuple(cfg.resolution)
    if kernels.on_cpu(vol.value, pose, coarse.t_found, coarse.t_dead):
        ray_start, dirs = _strided_rays(pose, intr, stride)
        return _window_repair(ray_start, dirs, coarse, window, cfg, _dense_reader(vol.value), res)
    nbx, nby, nbz = bricks.brick_grid(res)
    for t, name in ((vol.value, "value"), (vol.grad, "grad")):
        kernels.check_tensor(t, name, torch.float32, res)
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    H, W = kernels.strided(intr.height, stride), kernels.strided(intr.width, stride)
    ch, cw = coarse.t_found.shape
    if 2 * ch < H or 2 * cw < W:
        raise ValueError(f"coarse hits of {ch}x{cw} do not cover {H}x{W}")
    for t, name in ((coarse.t_found, "coarse.t_found"), (coarse.t_dead, "coarse.t_dead")):
        kernels.check_tensor(t, name, torch.float32, (ch, cw))
    t_found = torch.empty((H, W), dtype=torch.float32, device=pose.device)
    t_dead = torch.empty_like(t_found)
    step = cfg.trunc_dist * 0.8
    f32 = kernels.f32
    kernels.launch(
        "window_march_dense", pose.device, vol.value, vol.grad, pose, coarse.t_found, coarse.t_dead, None, None,
        t_found, t_dead, nbx, nby, nbz, H, W, ch, cw, stride, int(window), f32(cfg.voxel_size),
        kernels.reciprocal_f32(cfg.voxel_size), f32(step), kernels.reciprocal_f32(step), *kernels.camera_args(intr),
    )
    kernels.launch_counts["window_march_dense"] += 1
    return RaycastHit(t_found, t_dead)


def march_hier(vol: VolumeState, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig, window: int = 12,
               skip: bool = False) -> RaycastHit:
    """The hierarchical march (``xslam_tpu/ops/raycast.py::march_hier``): the
    rays of every 2nd pixel marched at full length (K3 at stride 2, or with
    ``skip`` the skip march, B14a and B14b at stride 2: the JAX function with
    ``weight``, the same anchors), then every pixel repaired in a
    ``window``-step interval about its 2x2 coarse neighbourhood's earliest
    event (B14c)."""
    if skip:
        coarse = march_skip_dense(vol, skip_field_dense(vol, cfg.resolution), pose, intr, cfg, stride=2)
    else:
        coarse = RaycastHit(*kernels.march_fixed(vol.value, pose, intr, cfg.voxel_size, cfg.trunc_dist, stride=2))
    return window_march_dense(vol, pose, intr, cfg, coarse, window)


def march_hier2(vol: VolumeState, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig, window: int = 8,
                window_mid: int = HIER2_MID_WINDOW) -> RaycastHit:
    """The two-level hierarchical march (``xslam_tpu/ops/raycast.py::
    march_hier2``): K3 at stride 4 (a quarter of the resolution), B14c at
    stride 2 with a ``window_mid``-step window, then B14c at full resolution
    with a ``window``-step one."""
    coarse = RaycastHit(*kernels.march_fixed(vol.value, pose, intr, cfg.voxel_size, cfg.trunc_dist, stride=4))
    mid = window_march_dense(vol, pose, intr, cfg, coarse, window_mid, stride=2)
    return window_march_dense(vol, pose, intr, cfg, mid, window)


# ------------------------------------------------- the brick layout's marches
def _in_volume(g, shape):
    X, Y, Z = shape
    return (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)


def _clamped(g, shape):
    return torch.stack([g[i].clamp(0, shape[i] - 1) for i in range(3)])


def march_skip_plain(ray_start: CSFD, dirs_v: torch.Tensor, cfg: VolumeConfig, packed_read, shape,
                     stats: Optional[dict] = None) -> RaycastHit:
    """Empty-space-skipping march: the port of ``xslam_tpu/ops/raycast.py::
    march_skip`` over a jump-packed reader ``packed_read`` (g -> biased
    values: ``JUMP_BASE + dist`` where a cell at distance >= 2 may be jumped,
    the value elsewhere). Its events are the fixed march's: skipped samples
    lie in cells without an observed negative voxel, and a positive ``prev``
    sentinel keeps the event tests exact. An integer step counter keeps
    every sample on the fixed march's grid ``0.2 + k * step``; a jump from
    distance ``d`` is ``max(1, floor((d - 1) * steps_per_cell))`` steps. Each
    ray marches until its own events or the range end (a loop with a break).
    ``stats``, where given, gets ``"samples"``: the reads that takes, the
    first one included; ``"ray_samples"``: each ray's; and ``"ray_rounds"``:
    the rounds of ``stats["lanes"]`` (default 1) steps each ray's loop takes
    where every round starts at a step the loop visits and covers the
    visited steps below its start + lanes (B5b's rounds, ``csrc/skip.cu``)."""
    voxel = cfg.voxel_size
    step = cfg.trunc_dist * 0.8
    steps_per_cell = BRICK * voxel / step
    n_steps = int((RAY_MAX_M - RAY_MIN_M) / step) + 1
    start_v = ray_start.v[:, None, None]
    H, W = dirs_v.shape[-2:]

    g0 = to_index(torch.floor((start_v + dirs_v * RAY_MIN_M) / voxel))
    prev = torch.clamp(packed_read(_clamped(g0, shape)), max=1.0)  # packed cells read as free space
    t_found = torch.full((H, W), INF_T, dtype=torch.float32, device=dirs_v.device)
    t_dead = torch.full_like(t_found, INF_T)
    k = torch.zeros((H, W), dtype=torch.int64, device=dirs_v.device)
    done = torch.zeros((H, W), dtype=torch.bool, device=dirs_v.device)
    ray_samples = torch.ones((H, W), dtype=torch.int64, device=dirs_v.device)
    ray_rounds = torch.ones_like(ray_samples)
    round_start = torch.zeros_like(ray_samples)
    lanes = stats.get("lanes", 1) if stats is not None else 1
    while not bool(done.all()):
        if stats is not None:
            ray_samples += ~done
            new_round = ~done & (k >= round_start + lanes)
            ray_rounds += new_round
            round_start = torch.where(new_round, k, round_start)
        kf = k.to(torch.float32)
        p = start_v + dirs_v * (RAY_MIN_M + (kf + 1.0) * step)
        g = to_index(torch.floor(p / voxel))
        inside = _in_volume(g, shape)
        c = packed_read(g)
        can_jump = inside & (c >= JUMP_BASE - 0.5) & ~done
        fine = ~done & ~can_jump
        death = fine & (~inside | ((prev < 0.0) & (c > 0.0) & inside))
        crossing = fine & inside & (prev > 0.0) & (c < 0.0)
        t_curr = RAY_MIN_M + kf * step
        t_found = torch.where(crossing, t_curr, t_found)
        t_dead = torch.where(death, t_curr, t_dead)
        done = done | crossing | death | (k + 1 >= n_steps)
        n_jump = torch.clamp(to_index(torch.floor((c - JUMP_BASE - 1.0) * steps_per_cell)), min=1)
        k = torch.where(can_jump, k + n_jump, k + 1)
        prev = torch.where(can_jump, 1.0, c)
    if stats is not None:
        stats.update(samples=int(ray_samples.sum()), ray_samples=ray_samples, ray_rounds=ray_rounds)
    return RaycastHit(t_found, t_dead)


def window_anchor(coarse: RaycastHit, H: int, W: int) -> torch.Tensor:
    """Each pixel's anchor for :func:`_window_repair` at (H, W): the
    earliest event (``min(t_found, t_dead)``) of the 2x2 neighbourhood of
    its coarse pixel ``(y // 2, x // 2)``, ``INF_T`` past the coarse grid."""
    t_event = torch.minimum(coarse.t_found, coarse.t_dead)
    pads = F.pad(t_event, (0, 1, 0, 1), value=INF_T)
    t0_coarse = torch.minimum(torch.minimum(pads[:-1, :-1], pads[1:, :-1]), torch.minimum(pads[:-1, 1:], pads[1:, 1:]))
    return t0_coarse.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :W]


def pooled_anchors(t_prev: torch.Tensor, H: int, W: int) -> RaycastHit:
    """:func:`march_temporal`'s coarse hits from its (H, W) anchor map: the
    2x2 minimum, non-finite entries counting as ``INF_T`` (no anchor), and no
    death."""
    tp = torch.where(torch.isfinite(t_prev), t_prev, INF_T)
    tp_half = tp[: (H // 2) * 2, : (W // 2) * 2].reshape(H // 2, 2, W // 2, 2).amin(dim=(1, 3))
    return RaycastHit(tp_half, torch.full_like(tp_half, INF_T))


def _window_repair(ray_start: CSFD, dirs_v: torch.Tensor, coarse: RaycastHit, window: int, cfg: VolumeConfig,
                   read_fn, shape, return_samples: bool = False, stats: Optional[dict] = None,
                   first_event: bool = False):
    """March each pixel of ``dirs_v`` (3, H, W) only inside a ``window``-step
    interval anchored at its 2x2 coarse neighbourhood's earliest event
    (``coarse``: the hit map one level above, 2x subsampled), snapped to the
    global march grid: the port of ``xslam_tpu/ops/raycast.py::_window_repair``
    over the voxel reader ``read_fn`` (g -> biased values). With
    ``return_samples`` also the two samples bracketing each recorded crossing,
    ``(f0, f1)``; (1, -1) where none. ``stats``, where given, gets
    ``"samples"``: the reads a march that stops once both events are known
    (or past 5 m) takes, the first one included, and ``"voxels"``: the
    distinct voxels inside the volume those reads touch. ``first_event``: a ray
    stops at its first event, a crossing or a death, so it records one of
    the two (:func:`march_temporal_compact`'s rule; ``stats`` then counts the
    reads up to that event)."""
    voxel = cfg.voxel_size
    step = cfg.trunc_dist * 0.8
    H, W = dirs_v.shape[-2:]
    dev = dirs_v.device

    t0_full = window_anchor(coarse, H, W)
    has_anchor = t0_full < INF_T
    # the anchor on the global march grid, so window samples are the full march's
    k0 = torch.floor((torch.where(has_anchor, t0_full, RAY_MIN_M) - RAY_MIN_M) / step) - 1.0
    t_begin = RAY_MIN_M + torch.clamp(k0, min=0.0) * step
    start_v = ray_start.v[:, None, None]

    g_first = _clamped(to_index(torch.floor((start_v + dirs_v * t_begin) / voxel)), shape)
    prev = read_fn(g_first)
    read_at = []  # with stats: the flat voxel of every read inside the volume

    def flat(g, mask):
        return ((g[0] * shape[1] + g[1]) * shape[2] + g[2])[mask]

    if stats is not None:
        read_at.append(flat(g_first, has_anchor))
    t_found = torch.full((H, W), INF_T, dtype=torch.float32, device=dev)
    t_dead = torch.full_like(t_found, INF_T)
    f0 = torch.ones((H, W), dtype=torch.float32, device=dev)
    f1 = -torch.ones((H, W), dtype=torch.float32, device=dev)
    samples = int(has_anchor.sum()) if stats is not None else 0
    done = torch.zeros_like(has_anchor)
    for k in range(window):
        # t_begin + float32(k) * step, in float32 as the reference's loop computes it
        t_curr = t_begin + kernels.f32(np.float32(k) * np.float32(step))
        g = to_index(torch.floor((start_v + dirs_v * (t_curr + step)) / voxel))
        # the reference's loop condition is on t_curr (RayCaster.cu:236)
        live = has_anchor & (t_curr < RAY_MAX_M) & ~done
        in_vol = _in_volume(g, shape)
        if stats is not None:
            reads = live & ~((t_found < INF_T) & (t_dead < INF_T))
            samples += int(reads.sum())
            read_at.append(flat(g, reads & in_vol))
        inside = in_vol & live
        tsdf = read_fn(g)
        death = live & (~in_vol | (inside & (prev < 0.0) & (tsdf > 0.0)))
        crossing = inside & (prev > 0.0) & (tsdf < 0.0)
        record = crossing & (t_curr < t_found)
        t_found = torch.where(record, t_curr, t_found)
        f0 = torch.where(record, prev, f0)
        f1 = torch.where(record, tsdf, f1)
        t_dead = torch.where(death & (t_curr < t_dead), t_curr, t_dead)
        prev = tsdf
        if first_event:
            done = done | crossing | death
    if stats is not None:
        stats["samples"] = samples
        stats["voxels"] = int(torch.unique(torch.cat(read_at)).numel())
    hit = RaycastHit(t_found, t_dead)
    return (hit, f0, f1) if return_samples else hit


def march_temporal(t_prev: torch.Tensor, ray_start: CSFD, ray_dir: CSFD, cfg: VolumeConfig, window: int = 12,
                   read_fn=None, shape=None, return_samples: bool = False, stats: Optional[dict] = None):
    """Anchored march: :func:`_window_repair` of every pixel around the
    anchor map ``t_prev`` (H, W), min-pooled 2x2 (non-finite entries count
    as no anchor), with no coarse march: the port of
    ``xslam_tpu/ops/raycast.py::march_temporal``. Pixels without a finite
    anchor in their neighbourhood find no event."""
    H, W = ray_dir.v.shape[-2:]
    return _window_repair(ray_start, ray_dir.v, pooled_anchors(t_prev, H, W), window, cfg, read_fn, shape,
                          return_samples, stats)


def march_temporal_compact(t_prev: torch.Tensor, ray_start: CSFD, ray_dir: CSFD, cfg: VolumeConfig, window: int = 12,
                           phase1: int = 4, cap_frac: float = 0.16, read_fn=None, shape=None,
                           return_samples: bool = False, stats: Optional[dict] = None):
    """The port of ``xslam_tpu/ops/raycast.py::march_temporal_compact``, the
    anchored march with ``raycast_temporal_phase1 > 0``: :func:`march_temporal`'s
    anchors and samples, each ray stopping at its first event (a crossing or
    a death; at ``k + 1 >= window``; at ``t_curr >= 5 m``), so it returns
    that event: the crossing with its two samples (``return_samples``), or
    the death. The JAX function marches ``phase1`` steps with every ray, then
    the survivors in a buffer of ``cap_frac`` of the rays, then an exact
    sweep of what the buffer missed: a schedule for the TPU's lockstep, which
    its docstring shows changes no ray's events (each ray's state is its
    own). Here each ray walks alone, so ``phase1`` and ``cap_frac`` change
    nothing. Accepted rays get :func:`march_temporal`'s events; a rejected
    ray may not (its later crossing after a death is not recorded). B16's
    plain version."""
    del phase1, cap_frac
    H, W = ray_dir.v.shape[-2:]
    return _window_repair(ray_start, ray_dir.v, pooled_anchors(t_prev, H, W), window, cfg, read_fn, shape,
                          return_samples, stats, first_event=True)


def refine_from_samples(trilin_at, ray_start: CSFD, ray_dir: CSFD, hit_t, f0, f1, accept, r_v2w: CSFD, t_v2w: CSFD,
                        cfg: VolumeConfig) -> Tuple[CSFD, CSFD, torch.Tensor, torch.Tensor]:
    """The ``reuse`` refine: the secant of the march's two bracketing samples,
    then ONE dual trilinear ``F`` as a Newton polish with the samples' slope
    ``(f1 - f0) / step``; a pixel whose correction exceeds a step
    (``|F| > -slope * step``) is rejected. Port of
    ``xslam_tpu/ops/raycast.py::refine_from_samples``; the derivative
    ``ts.g = -F.g / slope`` keeps the reference's finite-difference slope.
    Returns (vmap_w, zero normals, v_ok, all-False n_ok)."""
    step = cfg.trunc_dist * 0.8

    def point_at(t: CSFD) -> CSFD:
        return vec3.vec3(
            vec3.comp(ray_start, 0) + vec3.comp(ray_dir, 0) * t,
            vec3.comp(ray_start, 1) + vec3.comp(ray_dir, 1) * t,
            vec3.comp(ray_start, 2) + vec3.comp(ray_dir, 2) * t,
        )

    ok0 = accept & (f1 < f0)
    slope = torch.where(ok0, (f1 - f0) / step, -1.0)  # < 0 on crossings
    t0 = torch.where(accept, hit_t, RAY_MIN_M)
    ts0 = t0 - f0 / slope
    Fs = trilin_at(point_at(lift(torch.where(ok0, ts0, RAY_MIN_M))))
    ok = ok0 & ~torch.isnan(Fs.v) & (torch.abs(Fs.v) <= -slope * step)
    ts = CSFD(torch.where(ok, ts0 - Fs.v / slope, t0), torch.where(ok, -Fs.g / slope, 0.0))

    vertex = point_at(ts)
    vertex_w = vec3.matvec(r_v2w, vertex) + CSFD(t_v2w.v[:, None, None], t_v2w.g[:, None, None])
    vmap = CSFD(
        torch.where(ok[None], torch.nan_to_num(vertex_w.v), 0.0),
        torch.where(ok[None], torch.nan_to_num(vertex_w.g), 0.0),
    )
    zeros = CSFD(torch.zeros_like(vmap.v), torch.zeros_like(vmap.g))
    return vmap, zeros, ok, torch.zeros_like(ok)


def screen_normals_plain(vmap: CSFD) -> CSFD:
    """Dual world-space normals from the central differences of the vertex
    map, ``(v[x+1] - v[x-1]) x (v[y+1] - v[y-1])`` normalized (NaN value,
    zero derivative where a neighbour or the product fails): the port of
    ``xslam_tpu/ops/raycast.py::screen_normals`` with ``central=True``. B4n's
    plain version."""

    def shift(m: CSFD, dy, dx) -> CSFD:
        return CSFD(_shift2d(m.v, dy, dx, fill=torch.nan), _shift2d(m.g, dy, dx))

    xp, xm = shift(vmap, 0, 1), shift(vmap, 0, -1)
    yp, ym = shift(vmap, 1, 0), shift(vmap, -1, 0)
    ok = (~torch.isnan(vmap.v[0]) & ~torch.isnan(xp.v[0]) & ~torch.isnan(xm.v[0])
          & ~torch.isnan(yp.v[0]) & ~torch.isnan(ym.v[0]))
    n = vec3.cross(xp - xm, yp - ym)
    nsq = vec3.squarednorm(n)
    ok = ok & (nsq.v > 0.0) & ~torch.isnan(nsq.v)
    out = vec3.normalized(CSFD(torch.where(ok[None], n.v, 1.0), torch.where(ok[None], n.g, 0.0)))
    return CSFD(torch.where(ok[None], out.v, torch.nan), torch.where(ok[None], out.g, 0.0))
