"""Hand-written CUDA kernels of the dense SLAM step, their wrappers and their
plain PyTorch versions.

Counterpart of ``xslam_tpu/ops/pallas_kernels.py``. Three kernels carry the
frame's heavy passes:

- K1 :func:`bilateral_filter` (``csrc/bilateral.cu``) replaces
  ``xslam_tpu/ops/pallas_kernels.py::bilateral_filter_pallas``; its plain
  version is :func:`xslam_tpu_torch.ops.preprocess.bilateral_filter`.
- K2 :func:`fuse_volume` (``csrc/fusion.cu``) replaces the XLA code of
  ``xslam_tpu/ops/fusion.py::_voxel_update`` (nearest-depth branch); plain
  version :func:`fuse_volume_plain`.
- K3 :func:`march_fixed` (``csrc/march.cu``) replaces the XLA code of
  ``xslam_tpu/ops/raycast.py::march``; plain version :func:`march_fixed_plain`.

A wrapper runs the plain version when its tensors lie on the CPU (the tests)
and launches its kernel when they lie on a CUDA device; any other device
raises. It never falls back from the kernel to the plain version.

The sources are compiled on first use by ``torch.utils.cpp_extension.load``,
all in one call, into ``build/torch_kernels/`` at the repository root: the
three ``.cu`` files have a plain C interface, and ``csrc/binding.cpp``, the
only source that includes PyTorch's headers, binds them. ``load`` rebuilds
when a source or flag changes. ``-fmad=false`` keeps ``a*b+c`` as two
roundings, as the reference computes it, so a kernel agrees with its plain
version except where an intrinsic (``expf``) or PyTorch's own division by a
scalar rounds otherwise.

Each wrapper adds one to :data:`launch_counts` where it launches its kernel,
and nowhere else.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..csfd.single import CSFD, lift, sqrt
from ..geometry.intrinsics import Intrinsics
from . import preprocess
from .sampling import gather2d, gather3d, to_index

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("binding.cpp", "bilateral.cu", "fusion.cu", "march.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false")

RAY_MIN_M = 0.2
RAY_MAX_M = 5.0
INF_T = 1e9

launch_counts = {"bilateral_filter": 0, "fuse_volume": 0, "march_fixed": 0}
_ext = None  # the built extension module


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


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Launch on ``device``'s current PyTorch stream; raise if refused."""
    fn = getattr(build_kernels(), kernel)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless all lie on one
    CUDA device otherwise."""
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel inputs must share one CPU or CUDA device, got {devices}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


# ----------------------------------------------------------------- K1 bilateral
def bilateral_filter(depth_u16: torch.Tensor) -> torch.Tensor:
    """13x13 bilateral filter of a uint16 depth map (mm) -> float32 (mm).

    Same contract as :func:`xslam_tpu_torch.ops.preprocess.bilateral_filter`
    (its plain version)."""
    if _on_cpu(depth_u16):
        return preprocess.bilateral_filter(depth_u16)
    if depth_u16.dim() != 2:
        raise ValueError(f"depth: expected (H, W), got {tuple(depth_u16.shape)}")
    _check(depth_u16, "depth", torch.uint16)
    H, W = depth_u16.shape
    out = torch.empty((H, W), dtype=torch.float32, device=depth_u16.device)
    _launch("bilateral_filter", depth_u16.device, depth_u16, out)
    launch_counts["bilateral_filter"] += 1
    return out


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
    pose = torch.cat([r_v2c.v.reshape(-1), r_v2c.g.reshape(-1), t_v2c.v.reshape(-1), t_v2c.g.reshape(-1)])
    if _on_cpu(value, grad, weight, depth_m, pose):
        fuse_volume_plain(value, grad, weight, depth_m, r_v2c, t_v2c, intr, voxel_size, trunc_dist, max_weight)
        return
    X, Y, Z = value.shape
    for t, n in ((value, "value"), (grad, "grad"), (weight, "weight")):
        _check(t, n, torch.float32, (X, Y, Z))
    _check(depth_m, "depth_m", torch.float32, (intr.height, intr.width))
    pose = pose.to(torch.float32).contiguous()
    _check(pose, "pose", torch.float32, (24,))
    inv_fx = _f32(np.float32(1.0) / np.float32(intr.fx))
    inv_fy = _f32(np.float32(1.0) / np.float32(intr.fy))
    _launch(
        "fuse_volume", value.device, value, grad, weight, depth_m, pose,
        _f32(voxel_size), _f32(intr.fx), _f32(intr.fy), _f32(intr.cx), _f32(intr.cy),
        inv_fx, inv_fy, _f32(trunc_dist), _f32(1.0 / trunc_dist), _f32(max_weight),
    )
    launch_counts["fuse_volume"] += 1


def fuse_volume_plain(value, grad, weight, depth_m, r_v2c, t_v2c, intr, voxel_size, trunc_dist, max_weight):
    """Plain version of K2: the port of ``xslam_tpu/ops/fusion.py::integrate``
    with ``_voxel_update``'s nearest-depth branch (TsdfFusion.cu:85-171),
    written back in place like the kernel."""
    X, Y, Z = value.shape
    dev = value.device
    gx = ((torch.arange(X, dtype=torch.float32, device=dev) + 0.5)[:, None, None] * voxel_size)
    gy = ((torch.arange(Y, dtype=torch.float32, device=dev) + 0.5)[None, :, None] * voxel_size)
    gz = ((torch.arange(Z, dtype=torch.float32, device=dev) + 0.5)[None, None, :] * voxel_size)

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
    w_prev = weight
    w_new = torch.clamp(w_prev + 1.0, max=float(max_weight))
    fused = (CSFD(value, grad) * w_prev + tsdf) / (w_prev + 1.0)

    new_value = torch.where(update, fused.v, value)
    new_grad = torch.where(update, fused.g, grad)
    new_weight = torch.where(update, w_new, weight)
    value.copy_(new_value)
    grad.copy_(new_grad)
    weight.copy_(new_weight)


# --------------------------------------------------------------------- K3 march
def march_steps(trunc_dist: float) -> int:
    """Trip count of the fixed march over [0.2, 5.0] m at 0.8 trunc steps."""
    return int((RAY_MAX_M - RAY_MIN_M) / (trunc_dist * 0.8)) + 1


def march_fixed(value: torch.Tensor, ray_start: CSFD, ray_dir: CSFD, voxel_size: float, trunc_dist: float):
    """Lockstep fixed-trip ray march over the value plane (RayCaster.cu:226-247).

    ``ray_start``: dual (3,) volume-space origin; ``ray_dir``: dual (3, H, W)
    unit directions (value lanes used). Returns ``(t_found, t_dead)``, each
    (H, W) float32: the march time of the first +->- crossing and of the
    first death (volume exit or -->+ step), ``INF_T`` where none."""
    start, dirs = ray_start.v, ray_dir.v
    if _on_cpu(value, start, dirs):
        return march_fixed_plain(value, ray_start, ray_dir, voxel_size, trunc_dist)
    if value.dim() != 3:
        raise ValueError(f"value: expected (X, Y, Z), got {tuple(value.shape)}")
    H, W = dirs.shape[-2:]
    _check(value, "value", torch.float32)
    start = start.to(torch.float32).contiguous()
    _check(start, "ray_start", torch.float32, (3,))
    _check(dirs, "ray_dir", torch.float32, (3, H, W))
    t_found = torch.empty((H, W), dtype=torch.float32, device=value.device)
    t_dead = torch.empty_like(t_found)
    _launch(
        "march_fixed", value.device, value, start, dirs, t_found, t_dead,
        march_steps(trunc_dist), _f32(voxel_size), _f32(trunc_dist * 0.8),
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
        t_next = _f32(np.float32(RAY_MIN_M) + np.float32(k + 1) * np.float32(step))
        t_curr = _f32(np.float32(RAY_MIN_M) + np.float32(k) * np.float32(step))
        g = voxel_of(start_v + dirs_v * t_next)
        ins = inside(g)
        tsdf = read(g)
        death = (~ins) | (ins & (prev < 0.0) & (tsdf > 0.0))
        crossing = ins & (prev > 0.0) & (tsdf < 0.0)
        t_found = torch.where(crossing & (t_curr < t_found), t_curr, t_found)
        t_dead = torch.where(death & (t_curr < t_dead), t_curr, t_dead)
        prev = tsdf
    return t_found, t_dead
