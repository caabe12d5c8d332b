"""Hand-written CUDA kernels of the dense SLAM step, their wrappers and their
plain PyTorch versions.

Counterpart of ``xslam_tpu/ops/pallas_kernels.py``. This module builds and
launches every kernel of the package and holds the wrappers of five:

- K1 :func:`bilateral_filter` (``csrc/bilateral.cu``) replaces
  ``xslam_tpu/ops/pallas_kernels.py::bilateral_filter_pallas``; its plain
  version is :func:`xslam_tpu_torch.ops.preprocess.bilateral_filter`.
- K2 :func:`fuse_volume` (``csrc/fusion.cu``) replaces the XLA code of
  ``xslam_tpu/ops/fusion.py::_voxel_update`` (nearest-depth branch); plain
  version :func:`fuse_volume_plain`.
- K3 :func:`march_fixed` (``csrc/march.cu``) replaces the XLA code of
  ``xslam_tpu/ops/raycast.py::_camera_rays`` and ``::march``; plain version
  :func:`camera_rays` then :func:`march_fixed_plain`.
- K7 :func:`depth_pyramid` and K8 :func:`vertex_normal_pyramid`
  (``csrc/maps.cu``) replace the XLA code of
  ``xslam_tpu/ops/preprocess.py::pyr_down`` applied level after level and of
  ``::create_vmap`` + ``::create_nmap``, each in one launch for every level;
  their plain versions are the functions of those names in
  :mod:`xslam_tpu_torch.ops.preprocess`.

More sources are built here and wrapped where their plain versions live: K4
(``csrc/icp.cu``) in :mod:`xslam_tpu_torch.ops.icp`, K5 (``csrc/refine.cu``)
in :mod:`xslam_tpu_torch.ops.raycast`, K6 (``csrc/maps.cu``) in
:mod:`xslam_tpu_torch.models.kinfu`, the three brick-fusion kernels B3a-c
(``csrc/bricks.cu``) in :mod:`xslam_tpu_torch.ops.fusion_brick`, the brick
layout's window march B4 (``csrc/window.cu``) and skip march B5b
(``csrc/skip.cu``) in :mod:`xslam_tpu_torch.ops.raycast_bricks`, its screen
normals B4n (computed in K6's launch, ``csrc/maps.cu``) in
:mod:`xslam_tpu_torch.models.kinfu`, its skip field B5a (``csrc/skip.cu``)
in :mod:`xslam_tpu_torch.ops.bricks`, and
the five gather probes
(``csrc/gather_probes.cu``) in :mod:`xslam_tpu_torch.apps.probe_gather`.

A wrapper runs the plain version when its tensors lie on the CPU (the tests)
and launches its kernel when they lie on a CUDA device; any other device
raises. It never falls back from the kernel to the plain version.

The sources are compiled on first use by ``torch.utils.cpp_extension.load``,
all in one call, into ``build/torch_kernels/`` at the repository root: the
``.cu`` files have a plain C interface, and ``csrc/binding.cpp``, the
only source that includes PyTorch's headers, binds them. ``load`` rebuilds
when a source or flag changes. ``-fmad=false`` keeps ``a*b+c`` as two
roundings, as the reference computes it, so a kernel agrees with its plain
version except where an intrinsic (``expf``) or PyTorch's own division by a
scalar rounds otherwise. That division, ``x / c`` with ``c`` a Python number,
is ``x * (1 / c)`` on a CUDA tensor (the reciprocal taken in double and
rounded once to float32; measured on torch 2.11) and a true division on a CPU
tensor; K3's rays, K5 and K8 multiply by the
reciprocal (:func:`reciprocal_f32`), so they have the bits of their plain
versions on the card and lie within an ulp of them on the CPU.

Each wrapper adds one to :data:`launch_counts` where it launches its kernel,
and nowhere else.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..csfd import vec3
from ..csfd.single import CSFD, lift, sqrt
from ..geometry.intrinsics import Intrinsics
from . import preprocess
from .sampling import gather2d, gather3d, to_index

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = (
    "binding.cpp", "bilateral.cu", "fusion.cu", "bricks.cu", "march.cu", "refine.cu", "maps.cu", "icp.cu",
    "window.cu", "skip.cu", "gather_probes.cu",
)
HEADERS = ("dual.cuh", "rays.cuh", "fusion.cuh", "rows.cuh")  # included by the sources above
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false")

RAY_MIN_M = 0.2
RAY_MAX_M = 5.0
INF_T = 1e9
RAY_POSE_FLOATS = 48
FUSION_POSE_FLOATS = 24
BILATERAL_TABLE_FLOATS = 27 * 448  # K1's weight table (csrc/bilateral.cu)
MAX_MAP_LEVELS = 3  # K6's and K8's levels in one launch (csrc/maps.cu); the ICP runs at most 3

launch_counts = {
    "bilateral_filter": 0, "fuse_volume": 0, "march_fixed": 0, "icp_system": 0, "icp_associate": 0,
    "raycast_refine": 0, "resize_model_maps": 0, "depth_pyramid": 0, "vertex_normal_maps": 0,
    "depth_mips": 0, "classify_bricks": 0, "fuse_bricks": 0,
    "model_map_normals": 0, "window_march": 0, "skip_field": 0, "march_skip": 0,
    "probe_a": 0, "probe_b": 0, "probe_c": 0, "probe_d": 0, "probe_e": 0,
}
_ext = None  # the built extension module
_bilateral_weights: dict = {}  # device -> K1's weight table, made at the first launch there


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def build_kernels():
    """Compile (where not yet built) and load the kernels' extension module."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _ext = load(
            name="xslam_tpu_torch_kernels", sources=[str(CSRC_DIR / src) for src in SOURCES],
            build_directory=str(BUILD_DIR), extra_cuda_cflags=list(NVCC_FLAGS), verbose=False,
        )
    return _ext


def launch(kernel: str, device: torch.device, *args) -> None:
    """Launch on ``device``'s current PyTorch stream; raise if refused."""
    fn = getattr(build_kernels(), kernel)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless all lie on one
    CUDA device otherwise."""
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel inputs must share one CPU or CUDA device, got {devices}")
    return False


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def reciprocal_f32(x) -> float:
    """``1 / x`` taken in double and rounded once to float32: the factor by
    which PyTorch's CUDA operators divide a tensor by the Python number ``x``."""
    return float(np.float32(1.0 / float(x)))


def camera_args(intr: Intrinsics):
    """``(cx, cy, 1/fx, 1/fy)`` as the kernels take them, each a float32."""
    return f32(intr.cx), f32(intr.cy), reciprocal_f32(intr.fx), reciprocal_f32(intr.fy)


# ----------------------------------------------------------------- K1 bilateral
def bilateral_weights(device: torch.device) -> torch.Tensor:
    """K1's table of tap weights on ``device``: constants of the filter, so
    made once (one small launch of its own) and kept."""
    device = torch.device(device)
    key = (device.type, torch.cuda.current_device() if device.index is None else device.index)
    if key not in _bilateral_weights:
        table = torch.empty(BILATERAL_TABLE_FLOATS, dtype=torch.float32, device=device)
        launch("bilateral_weights", device, table)
        _bilateral_weights[key] = table
    return _bilateral_weights[key]


def bilateral_filter(depth_u16: torch.Tensor) -> torch.Tensor:
    """13x13 bilateral filter of a uint16 depth map (mm) -> float32 (mm).

    Same contract as :func:`xslam_tpu_torch.ops.preprocess.bilateral_filter`
    (its plain version)."""
    if on_cpu(depth_u16):
        return preprocess.bilateral_filter(depth_u16)
    if depth_u16.dim() != 2:
        raise ValueError(f"depth: expected (H, W), got {tuple(depth_u16.shape)}")
    check_tensor(depth_u16, "depth", torch.uint16)
    H, W = depth_u16.shape
    out = torch.empty((H, W), dtype=torch.float32, device=depth_u16.device)
    launch("bilateral_filter", depth_u16.device, depth_u16, bilateral_weights(depth_u16.device), out)
    launch_counts["bilateral_filter"] += 1
    return out


# ---------------------------------------------------- K7, K8 pyramid and maps
def depth_pyramid(depth: torch.Tensor, levels: int) -> list:
    """The depth pyramid of ``levels`` levels (f32 mm): ``[depth, half, quarter,
    ...]``, each the next coarser level of the one before. On CPU tensors its
    plain version, :func:`~xslam_tpu_torch.ops.preprocess.pyr_down` level
    after level. On the card, levels 1 and 2 in ONE launch of K7 (at most
    :data:`MAX_MAP_LEVELS` levels)."""
    if levels < 1:
        raise ValueError(f"levels: expected at least 1, got {levels}")
    if depth.dim() != 2:
        raise ValueError(f"depth: expected (H, W), got {tuple(depth.shape)}")
    if on_cpu(depth):
        out = [depth]
        for _ in range(1, levels):
            out.append(preprocess.pyr_down(out[-1]))
        return out
    if levels > MAX_MAP_LEVELS:
        raise ValueError(f"K7 takes at most {MAX_MAP_LEVELS} levels, got {levels}")
    check_tensor(depth, "depth", torch.float32)
    if levels == 1:
        return [depth]
    H, W = depth.shape
    if min(H, W) >> (levels - 1) < 1:
        raise ValueError(f"a {H}x{W} depth has no level {levels - 1}")
    out = [depth] + [torch.empty((H >> level, W >> level), dtype=torch.float32, device=depth.device)
                     for level in range(1, levels)]
    launch("depth_pyramid", depth.device, depth, out[1], out[2] if levels > 2 else None, levels)
    launch_counts["depth_pyramid"] += 1
    return out


def map_pyramid_layout(shapes, maps: int = 2) -> Tuple[list, int]:
    """Where a kernel writes each level's maps in its one buffer: ``([(offset
    of map 0, ..., offset of map maps - 1), ...], size)`` in float32
    elements, for levels of ``shapes`` ``[(H, W), ...]``: level by level, the
    ``maps`` maps one after the other, each (3, H, W) contiguous. K8 writes
    two a level (vertex, normal), K6 four (:func:`~xslam_tpu_torch.models.
    kinfu.model_map_pyramid`: v.v, v.g, n.v, n.g)."""
    offsets, at = [], 0
    for H, W in shapes:
        n = 3 * H * W
        offsets.append(tuple(at + m * n for m in range(maps)))
        at += maps * n
    return offsets, at


def map_pyramid_views(buffer: torch.Tensor, shapes, maps: int = 2):
    """The (3, H, W) maps of each level as views of ``buffer``, at
    :func:`map_pyramid_layout`'s offsets: ``maps`` tuples, the i-th holding
    map i of every level."""
    offsets, size = map_pyramid_layout(shapes, maps)
    if buffer.numel() != size:
        raise ValueError(f"buffer: expected {size} elements, got {buffer.numel()}")
    return tuple(
        tuple(buffer[level[m]:level[m] + 3 * H * W].view(3, H, W) for level, (H, W) in zip(offsets, shapes))
        for m in range(maps)
    )


def vertex_normal_pyramid(intr_levels, depths):
    """Camera-space vertex and normal maps of every pyramid level, each
    (3, H, W) float32 with NaN at invalid pixels, of the depth maps (mm)
    ``depths[l]`` with intrinsics ``intr_levels[l]``: ``(vmaps, nmaps)``,
    tuples of one map a level. Same contract as
    :func:`~xslam_tpu_torch.ops.preprocess.create_vmap` followed by
    :func:`~xslam_tpu_torch.ops.preprocess.create_nmap` on each level (its
    plain version). On the card, one launch of K8 for all levels; the maps are
    views of one buffer (:func:`map_pyramid_views`)."""
    intr_levels, depths = list(intr_levels), list(depths)
    if len(intr_levels) != len(depths) or not depths:
        raise ValueError(f"expected one depth a level, got {len(depths)} for {len(intr_levels)} levels")
    if on_cpu(*depths):
        vmaps = tuple(preprocess.create_vmap(intr, d) for intr, d in zip(intr_levels, depths))
        return vmaps, tuple(preprocess.create_nmap(v) for v in vmaps)
    if len(depths) > MAX_MAP_LEVELS:
        raise ValueError(f"K8 takes at most {MAX_MAP_LEVELS} levels, got {len(depths)}")
    shapes = [(intr.height, intr.width) for intr in intr_levels]
    for level, (d, shape) in enumerate(zip(depths, shapes)):
        check_tensor(d, f"depths[{level}]", torch.float32, shape)
    offsets, size = map_pyramid_layout(shapes)
    buffer = torch.empty(size, dtype=torch.float32, device=depths[0].device)
    cams = [c for intr in intr_levels for c in camera_args(intr)]
    launch("vertex_normal_maps", depths[0].device, depths, buffer, [o for pair in offsets for o in pair], cams)
    launch_counts["vertex_normal_maps"] += 1
    return map_pyramid_views(buffer, shapes)


# -------------------------------------------------------------------- K2 fusion
def fuse_volume(
    value: torch.Tensor,
    grad: torch.Tensor,
    weight: torch.Tensor,
    depth_m: torch.Tensor,
    r_v2c: CSFD,
    t_v2c: CSFD,
    intr: Intrinsics,
    voxel_size: float,
    trunc_dist: float,
    max_weight: float,
) -> None:
    """Fuse one scaled depth frame (metres) into the dual TSDF volume, IN
    PLACE: ``value``, ``grad`` and ``weight`` ((X, Y, Z) float32) are
    overwritten at every voxel the frame updates.

    ``r_v2c``/``t_v2c``: dual volume->camera rotation (3, 3) and translation
    (3,). Nearest-depth branch of the reference (``bi_threshold <= 0``)."""
    pose = fusion_pose(r_v2c, t_v2c)
    if on_cpu(value, grad, weight, depth_m, pose):
        fuse_volume_plain(value, grad, weight, depth_m, r_v2c, t_v2c, intr, voxel_size, trunc_dist, max_weight)
        return
    X, Y, Z = value.shape
    for t, n in ((value, "value"), (grad, "grad"), (weight, "weight")):
        check_tensor(t, n, torch.float32, (X, Y, Z))
    check_tensor(depth_m, "depth_m", torch.float32, (intr.height, intr.width))
    check_tensor(pose, "pose", torch.float32, (FUSION_POSE_FLOATS,))
    launch("fuse_volume", value.device, value, grad, weight, depth_m, pose,
           *fusion_args(intr, voxel_size, trunc_dist, max_weight))
    launch_counts["fuse_volume"] += 1


def fusion_pose(r_v2c: CSFD, t_v2c: CSFD) -> torch.Tensor:
    """The 24 pose floats K2 and the brick kernels read, as one device tensor
    (no host read): volume->camera R.v (row-major), R.g, t.v, t.g."""
    parts = (r_v2c.v, r_v2c.g, t_v2c.v, t_v2c.g)
    return torch.cat([p.reshape(-1) for p in parts]).to(torch.float32).contiguous()


def unpack_fusion_pose(pose: torch.Tensor) -> Tuple[CSFD, CSFD]:
    """``(r_v2c, t_v2c)`` of a :func:`fusion_pose`, as views of it."""
    return CSFD(pose[:9].view(3, 3), pose[9:18].view(3, 3)), CSFD(pose[18:21], pose[21:24])


def fusion_args(intr: Intrinsics, voxel_size: float, trunc_dist: float, max_weight: float) -> tuple:
    """The scalars of a fusion launch, each a float32: voxel size, fx, fy, cx,
    cy, 1/fx and 1/fy (taken in float32, as the plain version's dual division
    by a host number), trunc, 1/trunc, the weight clamp."""
    inv_fx = f32(np.float32(1.0) / np.float32(intr.fx))
    inv_fy = f32(np.float32(1.0) / np.float32(intr.fy))
    return (f32(voxel_size), f32(intr.fx), f32(intr.fy), f32(intr.cx), f32(intr.cy), inv_fx, inv_fy,
            f32(trunc_dist), f32(1.0 / trunc_dist), f32(max_weight))


def fuse_volume_plain(value, grad, weight, depth_m, r_v2c, t_v2c, intr, voxel_size, trunc_dist, max_weight):
    """Plain version of K2: the port of ``xslam_tpu/ops/fusion.py::integrate``
    with ``_voxel_update``'s nearest-depth branch (TsdfFusion.cu:85-171),
    written back in place like the kernel."""
    X, Y, Z = value.shape
    dev = value.device
    gx = ((torch.arange(X, dtype=torch.float32, device=dev) + 0.5)[:, None, None] * voxel_size)
    gy = ((torch.arange(Y, dtype=torch.float32, device=dev) + 0.5)[None, :, None] * voxel_size)
    gz = ((torch.arange(Z, dtype=torch.float32, device=dev) + 0.5)[None, None, :] * voxel_size)
    new = voxel_update_plain(gx, gy, gz, value, grad, weight, depth_m, r_v2c, t_v2c, intr, trunc_dist, max_weight)
    for plane, updated in zip((value, grad, weight), new):
        plane.copy_(updated)


def voxel_update_plain(gx, gy, gz, value, grad, weight, depth_m, r_v2c, t_v2c, intr, trunc_dist, max_weight):
    """The port of ``xslam_tpu/ops/fusion.py::_voxel_update``, nearest-depth
    branch: voxel metric coordinates (any broadcastable shapes) and the
    matching planes in, the updated ``(value, grad, weight)`` out (new
    tensors). K2's and the brick pass's per-voxel arithmetic."""

    def R(i, j):
        return CSFD(r_v2c.v[i, j], r_v2c.g[i, j])

    def t(i):
        return CSFD(t_v2c.v[i], t_v2c.g[i])

    # v_c = R_v2c * v_g + t_v2c
    def cam_coord(i):
        return R(i, 0) * lift(gx) + R(i, 1) * lift(gy) + R(i, 2) * lift(gz) + t(i)

    vcx, vcy, vcz = cam_coord(0), cam_coord(1), cam_coord(2)

    inv_z = 1.0 / vcz
    in_front = inv_z.v >= 0  # TsdfFusion.cu:116-117

    image_x = vcx * intr.fx * inv_z + intr.cx
    image_y = vcy * intr.fy * inv_z + intr.cy

    # pixel gate at floor(img - 0.5), nearest fetch at round(img): the
    # reference's pair, kept (TsdfFusion.cu:120-143)
    H, W = depth_m.shape
    cxf = torch.floor(image_x.v - 0.5)
    cyf = torch.floor(image_y.v - 0.5)
    in_bounds = (cxf > 1) & (cyf > 1) & (cxf < W - 1) & (cyf < H - 1)
    d_near = gather2d(depth_m, to_index(torch.round(image_y.v)), to_index(torch.round(image_x.v)))
    dp = CSFD(d_near, torch.zeros_like(d_near))

    # back-project the sampled pixel ray point and take the norm difference
    # (TsdfFusion.cu:144-149)
    xl = (image_x - intr.cx) / intr.fx
    yl = (image_y - intr.cy) / intr.fy
    lam2 = xl * xl + yl * yl + 1.0
    sdf = dp * sqrt(lam2) - sqrt(vcx * vcx + vcy * vcy + vcz * vcz)

    update = in_front & in_bounds & (dp.v > 0) & (sdf.v >= -trunc_dist)

    tsdf = sdf * (1.0 / trunc_dist)
    beyond = sdf.v > trunc_dist  # constant 1 + 0i past +trunc (TsdfFusion.cu:154-155)
    tsdf = CSFD(torch.where(beyond, 1.0, tsdf.v), torch.where(beyond, 0.0, tsdf.g))

    # running weighted average with weight clamp (TsdfFusion.cu:160-167)
    w_new = torch.clamp(weight + 1.0, max=float(max_weight))
    fused = (CSFD(value, grad) * weight + tsdf) / (weight + 1.0)
    return (torch.where(update, fused.v, value), torch.where(update, fused.g, grad),
            torch.where(update, w_new, weight))


# --------------------------------------------------------------------- K3 march
def march_steps(trunc_dist: float) -> int:
    """Trip count of the fixed march over [0.2, 5.0] m at 0.8 trunc steps."""
    return int((RAY_MAX_M - RAY_MIN_M) / (trunc_dist * 0.8)) + 1


def pack_ray_pose(r_c2v: CSFD, t_c2v: CSFD, r_v2w: CSFD, t_v2w: CSFD) -> torch.Tensor:
    """The 48 pose floats K3 and K5 read, as one device tensor (no host
    read): camera->volume R.v, R.g, t.v, t.g, then volume->world R.v, R.g,
    t.v, t.g."""
    parts = (r_c2v.v, r_c2v.g, t_c2v.v, t_c2v.g, r_v2w.v, r_v2w.g, t_v2w.v, t_v2w.g)
    return torch.cat([p.reshape(-1) for p in parts]).to(torch.float32).contiguous()


def unpack_ray_pose(pose: torch.Tensor):
    """``(r_c2v, t_c2v, r_v2w, t_v2w)`` of a packed pose, as views of it."""
    def block(at):
        return (CSFD(pose[at:at + 9].view(3, 3), pose[at + 9:at + 18].view(3, 3)),
                CSFD(pose[at + 18:at + 21], pose[at + 21:at + 24]))

    return block(0) + block(24)


def camera_rays(r_c2v: CSFD, t_c2v: CSFD, intr: Intrinsics) -> Tuple[CSFD, CSFD]:
    """Dual unit ray directions (3, H, W) in volume coordinates and the dual
    ray origin (3,) (RayCaster.cu:200-213). K3 and K5 compute the same ray in
    the kernel; this is their plain version."""
    H, W = intr.height, intr.width
    dev = r_c2v.v.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    rx = ((u - intr.cx) / intr.fx).expand(H, W)
    ry = ((v - intr.cy) / intr.fy).expand(H, W)
    ones = torch.ones((H, W), dtype=torch.float32, device=dev)
    ray_next_cam = vec3.vec3(lift(rx), lift(ry), lift(ones))
    ray_dir = vec3.normalized(vec3.matvec(r_c2v, ray_next_cam))
    dir_v = torch.where(ray_dir.v == 0.0, 1e-15, ray_dir.v)  # RayCaster.cu:211-213
    return CSFD(dir_v, ray_dir.g), t_c2v


def march_fixed(value: torch.Tensor, pose: torch.Tensor, intr: Intrinsics, voxel_size: float, trunc_dist: float):
    """Lockstep fixed-trip ray march over the value plane (RayCaster.cu:226-247)
    along the camera rays of ``intr`` at the packed pose (:func:`pack_ray_pose`;
    its camera->volume half is read, value lanes only).

    Returns ``(t_found, t_dead)``, each (H, W) float32: the march time of the
    first +->- crossing and of the first death (volume exit or -->+ step),
    ``INF_T`` where none."""
    if on_cpu(value, pose):
        r_c2v, t_c2v = unpack_ray_pose(pose)[:2]
        ray_dir, ray_start = camera_rays(r_c2v, t_c2v, intr)
        return march_fixed_plain(value, ray_start, ray_dir, voxel_size, trunc_dist)
    if value.dim() != 3:
        raise ValueError(f"value: expected (X, Y, Z), got {tuple(value.shape)}")
    check_tensor(value, "value", torch.float32)
    if value.numel() >= 1 << 31:
        raise ValueError(f"value: K3 indexes the volume with 32 bits, got {value.numel()} voxels")
    check_tensor(pose, "pose", torch.float32, (RAY_POSE_FLOATS,))
    t_found = torch.empty((intr.height, intr.width), dtype=torch.float32, device=value.device)
    t_dead = torch.empty_like(t_found)
    launch(
        "march_fixed", value.device, value, pose, t_found, t_dead, march_steps(trunc_dist), f32(voxel_size),
        f32(trunc_dist * 0.8), *camera_args(intr),
    )
    launch_counts["march_fixed"] += 1
    return t_found, t_dead


def march_fixed_plain(value, ray_start: CSFD, ray_dir: CSFD, voxel_size: float, trunc_dist: float):
    """Plain version of K3: the port of ``xslam_tpu/ops/raycast.py::march``
    (single volume, no shard). Each step reads the nearest voxel + 1e-5."""
    X, Y, Z = value.shape
    step = trunc_dist * 0.8
    start_v = ray_start.v[:, None, None]
    dirs_v = ray_dir.v
    H, W = dirs_v.shape[-2:]

    def voxel_of(p):
        return to_index(torch.floor(p / voxel_size))

    def read(g):
        return gather3d(value, g[0], g[1], g[2]) + 1e-5

    def inside(g):
        return (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)

    g0 = voxel_of(start_v + dirs_v * RAY_MIN_M)
    g0c = torch.stack([g0[0].clamp(0, X - 1), g0[1].clamp(0, Y - 1), g0[2].clamp(0, Z - 1)])
    prev = read(g0c)
    t_found = torch.full((H, W), INF_T, dtype=torch.float32, device=value.device)
    t_dead = torch.full_like(t_found, INF_T)
    for k in range(march_steps(trunc_dist)):
        # march times in float32 arithmetic, as the reference's loop computes them
        t_next = f32(np.float32(RAY_MIN_M) + np.float32(k + 1) * np.float32(step))
        t_curr = f32(np.float32(RAY_MIN_M) + np.float32(k) * np.float32(step))
        g = voxel_of(start_v + dirs_v * t_next)
        ins = inside(g)
        tsdf = read(g)
        death = (~ins) | (ins & (prev < 0.0) & (tsdf > 0.0))
        crossing = ins & (prev > 0.0) & (tsdf < 0.0)
        t_found = torch.where(crossing & (t_curr < t_found), t_curr, t_found)
        t_dead = torch.where(death & (t_curr < t_dead), t_curr, t_dead)
        prev = tsdf
    return t_found, t_dead
