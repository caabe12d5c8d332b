"""Raycasting straight from the brick-major volume: every march of the JAX
package's brick layout, with the ``secant2`` or ``reuse`` refine and TSDF or
screen normals.

Port of ``xslam_tpu/ops/raycast_bricks.py``: the marches ``skip``,
``hier_skip``, ``hier2_skip`` and ``temporal`` (with its ``hier2_skip``
refresh, and with ``temporal_phase1 > 0`` its first-event march), pair taps
(``trilinear_pair_bricks``, bit-identical to the scalar taps; the JAX
package's quad and packed taps and its 4-voxel skip cells and compacted
march give the same results, :func:`raycast_bricks_rays`), the ``secant2``
refine (``refine`` through the pair taps) and the ``reuse`` refine. March
parameters are the reference's (step 0.8 trunc over [0.2, 5.0] m, reads of
the nearest voxel + 1e-5).

:func:`raycast_bricks_rays` is the plain composition over explicit rays, as
the JAX function takes them. :func:`raycast_bricks`, the engine's entry,
composes the kernels, each a wrapper here or in :mod:`.bricks` that runs its
plain version on CPU tensors:

- B4 :func:`window_march` (``csrc/window.cu``): the anchored window march,
  with the ``reuse`` refine fused after it (the world vertex map) or without
  it (the hits); B16, its first-event variant (``first_event``);
- B5a :func:`xslam_tpu_torch.ops.bricks.skip_field` (``csrc/skip.cu``);
- B5b :func:`march_skip` (``csrc/skip.cu``): the skip march at full, half or
  a quarter of the model maps' resolution;
- K5r :func:`raycast_refine_bricks` (``csrc/refine.cu``): the ``secant2``
  refine with TSDF normals over the brick rows.

The screen normals (B4n, plain version
:func:`xslam_tpu_torch.ops.raycast.screen_normals_plain`) are left to the
model-map pyramid, whose launch computes them
(:func:`xslam_tpu_torch.models.kinfu.model_map_pyramid` with no normals
given).

The sharded engine's brick layout (B19f) runs :func:`raycast_bricks` over a
block of the model maps' columns, at :func:`column_intrinsics` (the kernels
make the block's rays, the whole image's at its columns, with no argument of
their own), with the skip distance of the gathered rows given (``dist``).

On the temporal march a frame takes the anchored march when at least
``min_coverage`` of its anchors are finite, else the refresh (B5a, B5b, B4
twice). The engine's anchors fall back to the last raycast's ``t_found``,
which is 1e9 (finite) where a ray found nothing, so after frame 0 the
coverage reads 1.0 and the refresh cannot run; it is kept and computed as
the reference computes it.
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
    HIER2_MID_WINDOW, RaycastHit, _window_repair, finalize_maps, march_skip_plain, march_temporal,
    march_temporal_compact, refine, refine_from_samples, screen_normals_plain, skip_ray_form,
)
from .sampling import to_index

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
BRICK_MARCH_MODES = ("skip", "hier_skip", "hier2_skip", "temporal")
REFINE_MODES = ("secant2", "reuse")


def _check_modes(march_mode: str, refine_mode: str, normals_mode: str) -> bool:
    """The JAX function's checks; whether the ``reuse`` refine runs (only
    with the temporal march: elsewhere JAX refines with ``secant2``)."""
    if march_mode not in BRICK_MARCH_MODES:
        raise ValueError(f"unknown brick march_mode {march_mode!r}; expected one of {BRICK_MARCH_MODES}")
    if refine_mode not in REFINE_MODES:
        raise ValueError(f"unknown refine_mode {refine_mode!r}")
    if normals_mode not in ("tsdf", "screen"):
        raise ValueError(f"unknown raycast normals_mode {normals_mode!r}")
    reuse = refine_mode == "reuse" and march_mode == "temporal"
    if reuse and normals_mode != "screen":
        raise ValueError("refine_mode='reuse' computes no TSDF normals — use raycast_normals='screen'")
    return reuse


def _secant_maps(bvol, ray_start, ray_dir, hit: RaycastHit, r_v2w, t_v2w, cfg) -> Tuple[CSFD, CSFD]:
    """The ``secant2`` refine of a march's hits through the pair taps, with
    TSDF normals and the NaN sentinels (K5r's plain version)."""
    accept = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    return finalize_maps(*refine(None, ray_start, ray_dir, hit.t_found, accept, r_v2w, t_v2w, cfg,
                                 trilin_fn=_pair_trilinear(bvol, cfg), shape=tuple(cfg.resolution)))


def raycast_bricks_rays(
    bvol: BrickVolume, ray_start: CSFD, ray_dir: CSFD, r_v2w: CSFD, t_v2w: CSFD, cfg: VolumeConfig,
    normals_mode: str = "screen", march_mode: str = "skip", hier_window: int = 12,
    packed: Optional[torch.Tensor] = None, apply_screen: bool = True, packed_taps: bool = True, skip_gran: int = 8, compact: bool = False, pair_taps: bool = False, quad_taps: bool = False,
    t_anchor: Optional[torch.Tensor] = None, temporal_window: int = 12, temporal_min_coverage: float = 0.5,
    return_hit: bool = False, refine_mode: str = "secant2", temporal_phase1: int = 0,
    temporal_cap_frac: float = 0.16,
):
    """March + refine + normals for an explicit ray bundle (dual ``ray_dir``
    (3, H, W), ``ray_start`` (3,)), in plain PyTorch: the port of
    ``xslam_tpu/ops/raycast_bricks.py::raycast_bricks_rays`` with its
    signature and defaults. ``ray_dir`` may be any block of a camera's rays.
    ``packed``: jump-packed value rows given from outside
    (:func:`bricks.pack_rows` of the value rows and a distance the sharded
    engine gathers), for the skip marches; None packs this volume's own, which
    reads its weight. ``apply_screen=False`` leaves the screen normals to the
    caller (``nmap`` None; the sharded engine takes them from the assembled
    vertex map, whose block-edge pixels need their neighbours).

    ``march_mode``: ``skip``, the skip march at full resolution (the fixed
    march's events); ``hier_skip``, the skip march at half resolution, then a
    ``hier_window``-step repair at full; ``hier2_skip``, the skip march at a
    quarter, a 12-step repair at half, a ``hier_window``-step repair at full;
    ``temporal``, the window march around ``t_anchor`` when the finite share
    of its entries reaches ``temporal_min_coverage`` (a host read here), else
    ``hier2_skip``; with ``temporal_phase1 > 0`` the anchored march stops each
    ray at its first event (:func:`march_temporal_compact`). ``refine_mode``:
    ``secant2`` (:func:`refine` through the pair taps) or, with the temporal
    march only, ``reuse`` (:func:`refine_from_samples`; elsewhere ``secant2``,
    as JAX falls back). ``normals_mode``: ``tsdf``, the refine's, or
    ``screen``, :func:`screen_normals_plain` of the vertex map.

    The taps are always the pair taps and the skip field always 8-voxel
    cells: the options that choose others give the same results in the JAX
    package, which its tests show: the quad taps (``quad_taps``,
    ``tests/test_bricks.py::test_raycast_bricks_quad_taps_bit_identical``) and
    the packed taps (``packed_taps``, ``::test_raycast_bricks_packed_taps_bit_identical``;
    with TSDF normals within 1e-6, ``::test_raycast_bricks_equals_dense_raycast``)
    bit for bit the pair and scalar taps; the 4-voxel skip cells
    (``skip_gran=4``, ``::test_skip_gran4_events_identical``) and the compacted
    skip march (``compact``, ``::test_march_skip_compact_bit_identical``) the
    8-voxel skip march's events. ``temporal_cap_frac`` changes no event
    (``tests/test_march_skip.py::test_march_temporal_compact_event_identical``).
    Returns ``(vmap, nmap)`` and, with ``return_hit``, the march's
    ``t_found``."""
    del packed_taps, pair_taps, quad_taps, compact
    if skip_gran not in (4, 8):
        raise ValueError(f"skip_gran must be 4 or 8, got {skip_gran}")
    reuse = _check_modes(march_mode, refine_mode, normals_mode)
    res = cfg.resolution
    value_read = _value_reader(bvol.value, res)

    def skip_hit(stride):
        packed_read = _value_reader(bricks.skip_rows(bvol, res) if packed is None else packed, res)
        return march_skip_plain(ray_start, ray_dir.v[:, ::stride, ::stride], cfg, packed_read, res)

    def hier2_hit():
        mid = _window_repair(ray_start, ray_dir.v[:, ::2, ::2], skip_hit(SKIP_STRIDE), HIER2_MID_WINDOW, cfg,
                             value_read, res)
        return _window_repair(ray_start, ray_dir.v, mid, hier_window, cfg, value_read, res, return_samples=reuse)

    if march_mode == "skip":
        out = skip_hit(1)
    elif march_mode == "hier_skip":
        out = _window_repair(ray_start, ray_dir.v, skip_hit(2), hier_window, cfg, value_read, res)
    elif march_mode == "hier2_skip":
        out = hier2_hit()
    else:
        if t_anchor is None:
            raise ValueError("march_mode='temporal' requires t_anchor")
        if float(anchor_coverage(t_anchor)) < temporal_min_coverage:
            out = hier2_hit()
        elif temporal_phase1 > 0:
            out = march_temporal_compact(t_anchor, ray_start, ray_dir, cfg, temporal_window, temporal_phase1,
                                         temporal_cap_frac, value_read, res, return_samples=reuse)
        else:
            out = march_temporal(t_anchor, ray_start, ray_dir, cfg, window=temporal_window, read_fn=value_read,
                                 shape=res, return_samples=reuse)
    if reuse:
        vmap, hit = _reuse_maps(bvol, ray_start, ray_dir, out, r_v2w, t_v2w, cfg)
        nmap = None
    else:
        hit = out
        vmap, nmap = _secant_maps(bvol, ray_start, ray_dir, hit, r_v2w, t_v2w, cfg)
    if normals_mode == "screen":
        nmap = screen_normals_plain(vmap) if apply_screen else None
    return (vmap, nmap, hit.t_found) if return_hit else (vmap, nmap)


def column_intrinsics(intr: Intrinsics, col0: int, width: int) -> Intrinsics:
    """The intrinsics of the block of ``width`` image columns from column
    ``col0``: ``cx`` the float32 the kernels take (:func:`kernels.camera_args`)
    less ``col0``, exact in float32 (else ``ValueError``). A kernel makes a
    pixel's ray from ``u - cx`` (``csrc/rays.cuh``); at the block's integer
    column ``u`` that is the real difference of the whole image's ``u + col0
    - cx``, rounded once, so a block's rays are the whole image's at its
    columns: the sharded engine's blocks (``xslam_tpu/parallel/sharded.py:
    328-331``, a column slice of the image's rays) take no kernel argument of
    their own."""
    if col0 < 0 or width < 1 or col0 + width > intr.width:
        raise ValueError(f"columns [{col0}, {col0 + width}) are not a block of an image {intr.width} wide")
    cx = kernels.f32(intr.cx) - col0
    if kernels.f32(cx) != cx:
        raise ValueError(f"cx {intr.cx} less column {col0} is not a float32: the block's rays would round otherwise")
    return intr._replace(cx=cx, width=width)


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


def window_march(bvol: BrickVolume, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig, anchor: torch.Tensor,
                 window: int, anchor_dead: Optional[torch.Tensor] = None, stride: int = 1, refine: bool = False,
                 first_event: bool = False):
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
    and the march's ``t_found``. On CPU tensors its plain version.

    ``first_event`` (an anchor map only) selects kernel B16, the same
    kernel's first-event variant: each ray stops at its first crossing or
    death, the rule of ``raycast_temporal_phase1 > 0``; plain version
    :func:`march_temporal_compact`."""
    res = cfg.resolution
    H, W = kernels.strided(intr.height, stride), kernels.strided(intr.width, stride)
    if refine and stride != 1:
        raise ValueError("the refine runs at the full resolution (stride 1)")
    if first_event and anchor_dead is not None:
        raise ValueError("the first-event march takes an anchor map, not coarse hits")
    anchors = (anchor,) if anchor_dead is None else (anchor, anchor_dead)
    if kernels.on_cpu(bvol.value, bvol.grad, pose, *anchors):
        ray_start, ray_dir, r_v2w, t_v2w = _rays(pose, intr)
        dirs = CSFD(ray_dir.v[:, ::stride, ::stride], ray_dir.g[:, ::stride, ::stride])
        read = _value_reader(bvol.value, res)
        if first_event:
            out = march_temporal_compact(anchor, ray_start, dirs, cfg, window=window, read_fn=read, shape=res,
                                         return_samples=refine)
        elif anchor_dead is None:
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
    name = "window_march_first_event" if first_event else "window_march"
    kernels.launch(
        name, dev, bvol.value, bvol.grad, pose, anchor, anchor_dead, *outs, nbx, nby, nbz, H, W, ch, cw,
        stride, int(window), f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(step),
        kernels.reciprocal_f32(step), *kernels.camera_args(intr),
    )
    kernels.launch_counts[name] += 1
    if refine:
        return CSFD(outs[0], outs[1]), t_found
    return RaycastHit(t_found, outs[3])


def raycast_refine_bricks(bvol: BrickVolume, pose: torch.Tensor, t_found: torch.Tensor, t_dead: torch.Tensor,
                          intr: Intrinsics, cfg: VolumeConfig, direct: Optional[torch.Tensor] = None
                          ) -> Tuple[CSFD, CSFD]:
    """Kernel K5r (``csrc/refine.cu``, ``refine_rows_kernel``): K5, the
    ``secant2`` refine with TSDF normals and the maps' NaN sentinels
    (:func:`xslam_tpu_torch.ops.raycast.raycast_refine`), over the brick
    rows: ``(vmap, nmap)``, dual, world coordinates, (3, H, W), from the
    march's ``t_found``/``t_dead`` at the packed pose. The bits of K5 on the
    volume's dense twin. On CPU tensors its plain version: the rays,
    :func:`refine` through :func:`trilinear_pair_bricks`,
    :func:`finalize_maps`. ``direct`` as K5's."""
    res = tuple(cfg.resolution)
    if kernels.on_cpu(bvol.value, bvol.grad, pose, t_found, t_dead, *(() if direct is None else (direct,))):
        ray_start, ray_dir, r_v2w, t_v2w = _rays(pose, intr)
        return _secant_maps(bvol, ray_start, ray_dir, RaycastHit(t_found, t_dead), r_v2w, t_v2w, cfg)
    nbx, nby, nbz = bricks.brick_grid(res)
    n = nbx * nby * nbz
    H, W = intr.height, intr.width
    for t, name in ((bvol.value, "value"), (bvol.grad, "grad")):
        kernels.check_tensor(t, name, torch.float32, (n, bricks.BRICK ** 3))
    kernels.check_tensor(pose, "pose", torch.float32, (kernels.RAY_POSE_FLOATS,))
    for t, name in ((t_found, "t_found"), (t_dead, "t_dead")):
        kernels.check_tensor(t, name, torch.float32, (H, W))
    if bvol.value.numel() >= 1 << 31:
        raise ValueError(f"value: K5r indexes the volume with 32 bits, got {bvol.value.numel()} voxels")
    if direct is not None:
        kernels.check_tensor(direct, "direct", torch.int32, (1,))
    out = [torch.empty((3, H, W), dtype=torch.float32, device=pose.device) for _ in range(4)]
    f32 = kernels.f32
    kernels.launch(
        "raycast_refine_bricks", pose.device, bvol.value, bvol.grad, pose, t_found, t_dead, *out, direct,
        nbx, nby, nbz, f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(cfg.voxel_size * 0.5),
        f32(cfg.trunc_dist * 0.8), *kernels.camera_args(intr),
    )
    kernels.launch_counts["raycast_refine_bricks"] += 1
    return CSFD(out[0], out[1]), CSFD(out[2], out[3])


def march_skip(bvol: BrickVolume, dist: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, cfg: VolumeConfig,
               stride: int = SKIP_STRIDE) -> RaycastHit:
    """Kernel B5b (``csrc/skip.cu``): the skip march along the rays of every
    ``stride``-th pixel of ``intr`` at the packed pose, over the value rows
    and B5a's per-brick distance ``dist`` (NB,) int32: a brick at distance
    >= 2 reads as ``JUMP_BASE + dist``, as :func:`bricks.skip_rows` packs
    it, without the packed copy. On CPU tensors its plain version,
    :func:`march_skip_plain` over :func:`bricks.pack_rows`. The events are
    the fixed march's on these rays. Counted as ``march_skip`` (a warp a
    ray) or, from :data:`~xslam_tpu_torch.ops.raycast.SKIP_RAY_FORM_MIN_RAYS`
    rays, ``march_skip_rays`` (a thread a ray)."""
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
    H, W = kernels.strided(intr.height, stride), kernels.strided(intr.width, stride)
    t_found = torch.empty((H, W), dtype=torch.float32, device=pose.device)
    t_dead = torch.empty_like(t_found)
    step = cfg.trunc_dist * 0.8
    steps_per_cell = bricks.BRICK * cfg.voxel_size / step
    ray_form = skip_ray_form(H, W)
    f32 = kernels.f32
    kernels.launch(
        "march_skip", pose.device, bvol.value, dist, pose, t_found, t_dead, nbx, nby, nbz, stride,
        kernels.march_steps(cfg.trunc_dist), f32(cfg.voxel_size), kernels.reciprocal_f32(cfg.voxel_size), f32(step),
        f32(steps_per_cell), *kernels.camera_args(intr), int(ray_form),
    )
    kernels.launch_counts["march_skip_rays" if ray_form else "march_skip"] += 1
    return RaycastHit(t_found, t_dead)


def raycast_bricks(
    bvol: BrickVolume, r_c2v: CSFD, t_c2v: CSFD, r_v2w: CSFD, t_v2w: CSFD, intr: Intrinsics, cfg: VolumeConfig,
    t_anchor: Optional[torch.Tensor] = None, refresh: bool = False, normals_mode: str = "screen",
    march_mode: str = "temporal", refine_mode: str = "reuse", temporal_window: int = 12, hier_window: int = 12,
    temporal_phase1: int = 0, dist: Optional[torch.Tensor] = None,
) -> Tuple[CSFD, Optional[CSFD], torch.Tensor]:
    """The brick layout's raycast of the model maps at ``intr``'s resolution,
    through the kernels: ``(vmap, nmap, t_found)``, the dual world maps
    (3, H, W) with NaN sentinels and the march's hit distances (the next
    frame's fallback anchors; 1e9 where none). ``nmap`` is None with screen
    normals: :func:`xslam_tpu_torch.models.kinfu.model_map_pyramid`'s launch
    computes them (B4n).

    The marches (the modes of :func:`raycast_bricks_rays`): ``skip`` B5a,
    B5b; ``hier_skip`` B5a, B5b at stride 2, B4 without its refine;
    ``hier2_skip`` B5a, B5b at stride 4, B4 at stride 2, B4; ``temporal`` B4
    around ``t_anchor`` (with ``temporal_phase1 > 0`` its first-event variant
    B16), or with ``refresh`` (the engine decides it from
    :func:`anchor_coverage`) ``hier2_skip``. The refine: ``reuse`` (temporal
    only) fused into the march's last launch, else K5r
    (:func:`raycast_refine_bricks`), which computes the TSDF normals, dropped
    with screen normals (as K5 on the dense layout). On CPU tensors every
    kernel runs its plain version, so the result is
    :func:`raycast_bricks_rays`'s with the rays of :func:`kernels.camera_rays`.

    ``dist``: the skip marches' (NB,) int32 brick distance given from outside
    (the sharded engine's, B19e over the gathered masks), so that neither B5a
    nor the weight rows are read (``bvol.weight`` may be None); None: B5a's
    where a skip march runs. ``intr`` may be a block of the model maps'
    columns (:func:`column_intrinsics`)."""
    reuse = _check_modes(march_mode, refine_mode, normals_mode)
    pose = kernels.pack_ray_pose(r_c2v, t_c2v, r_v2w, t_v2w)
    res = cfg.resolution

    def skip_dist():
        return bricks.skip_field(bvol, res) if dist is None else dist

    def hier2(last_refine):
        coarse = march_skip(bvol, skip_dist(), pose, intr, cfg)
        mid = window_march(bvol, pose, intr, cfg, coarse.t_found, HIER2_MID_WINDOW, anchor_dead=coarse.t_dead,
                           stride=2)
        return window_march(bvol, pose, intr, cfg, mid.t_found, hier_window, anchor_dead=mid.t_dead,
                            refine=last_refine)

    if march_mode == "skip":
        out = march_skip(bvol, skip_dist(), pose, intr, cfg, stride=1)
    elif march_mode == "hier_skip":
        coarse = march_skip(bvol, skip_dist(), pose, intr, cfg, stride=2)
        out = window_march(bvol, pose, intr, cfg, coarse.t_found, hier_window, anchor_dead=coarse.t_dead)
    elif march_mode == "hier2_skip" or refresh:
        out = hier2(reuse)
    else:
        if t_anchor is None:
            raise ValueError("march_mode='temporal' requires t_anchor")
        out = window_march(bvol, pose, intr, cfg, t_anchor, temporal_window, refine=reuse,
                           first_event=temporal_phase1 > 0)
    if reuse:
        vmap, t_found = out
        return vmap, None, t_found
    vmap, nmap = raycast_refine_bricks(bvol, pose, out.t_found, out.t_dead, intr, cfg)
    return vmap, (None if normals_mode == "screen" else nmap), out.t_found
