"""Smoke run of the PyTorch/CUDA port (``xslam_tpu_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card, ``nvcc`` and PyTorch built for CUDA. Imports nothing of JAX or
of ``xslam_tpu``.

Phases, in order:

1. the card's name and power limit (``nvidia-smi``), the float32 precision
   pins, and how this PyTorch rounds ``x / c``, a 2x2 mean and a sum of three
   on the card (``xslam_tpu_torch.apps.torch_rounding``): K3, K5, K6 and K8
   repeat those roundings to equal their plain versions bit for bit, so the
   run fails here, and says why, where they are no longer PyTorch's;
2. build the CUDA kernels from ``xslam_tpu_torch/csrc`` (one
   ``torch.utils.cpp_extension.load`` of all sources) and print the build
   seconds;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (one JSON line each): K1 on a 480x640 rendered frame
   (and its weight table against ``torch.exp`` of the tap's expression), K2 on the 256^3 volume after 3 fused frames (bit-equal, at
   the orbit's next pose, at a pose that looks along the volume from a
   corner and at the pose of the JAX package's window-coverage regression
   test), K3 on that volume (also bit-equal to its earlier design, timed
   beside it, on these rays and on rays with a NaN or an infinity), K5 (the secant refine
   with normals) on that volume at the shapes of ``model_map_level`` 0 and
   1, K6 (the model-map pyramid, every coarser level in one launch, on K5's
   maps of both configurations and at two shapes with odd halvings), K7
   (both coarser depth levels in one launch, at 480x640 and on crops of
   478x638 and 477x637) and K8 (vertex and normal maps) at every level
   shape of both configurations, the brick fusion kernels B3a (depth mips),
   B3b (classes and lists) and B3c (the brick pass) each against its plain
   version, B3c's volume also against K2's bit for bit at K2's three poses
   and with cap 64 in both overflow modes, and B3c's row variant (the brick
   layout) against K2 on the dense twin, bit for bit; the brick layout's
   raycast kernels on the brick rows of that volume at the bench path's
   shapes (240x320 model maps): B4 (the anchored window march) with its
   ``reuse`` refine on frame 3's depth anchors and without it at the
   refresh's half level, B4n (screen normals, computed in K6's launch) on
   B4's map with the pyramid's levels and with one, and on a 239x319 crop,
   B5a (the skip field) on every brick, B5b (the skip march, a warp a ray) at
   60x80 and on 7x9 rays against its plain version on every ray and at 60x80
   against the plain fixed march as the reference holds it, each bit for
   bit, timed warm and cold (B5b also with its rays' samples and rounds, and
   its latency floor from probe E's time a step); B13 (point extraction:
   count, points, normals and the zero rows past the count) on that volume
   and on the dense twin of its brick rows, at run_slam's capacity of
   1,000,000 and at half the count, bit for bit, timed warm and cold; K4
   (the ICP system, its tail, the association that
   a level's first launch writes, and the association kernel it is held
   against) on model maps raycast from that volume and the next frame's
   depth pyramid, at the three level shapes of both main-path
   configurations, and the five gather probes;
4. the probe path: ``xslam_tpu_torch.apps.probe_gather.run`` on the card;
5. the main path, five times: ``XSlamEngine(load_config("configs/synthetic.yaml"))``
   runs 10 frames of the 640x480 synthetic orbit on the card, then 6 frames
   with ``icp_fixed_assoc=True, model_map_level=1``, then 10 frames with
   bench.py's fusion (``fusion_mode="brick"``, cap 2816,
   ``fusion_overflow="dense"``), then 10 frames in bench.py:78-95's whole
   configuration (the brick layout, the temporal march, the ``reuse``
   refine, screen normals), then 4 frames of it with
   ``raycast_temporal_min_coverage=2``, so that every frame takes the
   ``hier2`` refresh (B5a, B5b); in each run every frame must align, the ATE
   must stay under 0.02 m, the model maps must be finite where valid, every
   kernel must have launched as often as the run's frames and ICP
   iterations say, and a profiled frame must show nothing on the device
   between its ICP launches and make the frame's launches; the brick run
   must never overflow its cap and must give the first run's ATE to every
   digit (its volume is dense fusion's, bit for bit); the two bench runs
   print each frame's anchor coverage and must give the same ATE digits in a
   second run; in the bench run's second run frame 3's depth is a uint16
   tensor already on the card, and its pose must equal the first run's
   (host depth) bit for bit. The profiler's record of a frame is trusted
   only where its device events are as many as the host's launch calls;
   where they differ,
   up to two more frames are profiled, and the run fails if none gives a
   consistent record;
6. the realistic paths, through the CLI's entry point ``run_slam.main`` on
   data the port's generator renders into a temporary directory (its own PNG
   writer; the loaders read them with its own PNG reader): 30 frames of
   configs/ICL_realistic.yaml's dataset (cut from 301) with ``--mesh
   tetra``: every pose file, ATE < 0.02 m, B13 launched once (``draw_pcd``),
   ``pcd.ply`` read back with B13's count, B13 on the final volume equal to
   the plain extraction, ``mesh.ply`` with triangles (the mesher timed again
   with its peak memory), and a checkpoint after 15 frames loaded into a new
   engine and run to the end giving the run's poses bit for bit; then 10
   frames of configs/7scenes_realistic.yaml's (``SevenScenesDataset``),
   ATE < 0.02 m.

The launch counts are set to 0 just before each path is driven and read just
after it.

The second-to-last line is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Any failed phase exits 1 without it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
HOLD_CYCLES = 30_000_000  # about 20 ms of device spinning at the card's clock
L2_FLUSH_BYTES = 128 << 20  # written before each cold launch: more than the H100's 50 MB of L2
N_FRAMES = 10
N_FRAMES_FIXED_ASSOC = 6
WARM_FRAMES = 2
N_FRAMES_BRICK = 10
N_FRAMES_BENCH = 10
N_FRAMES_REFRESH = 4
PROFILE_RETAKES = 2  # frames profiled again where the profiler's record of one disagrees with the host's calls
BRICK_CAP = 2816  # bench.py's fusion_brick_cap
# bench.py:78-95's configuration over configs/synthetic.yaml
BENCH_OPTIONS = dict(volume_layout="brick", fusion_mode="brick", fusion_brick_cap=BRICK_CAP, fusion_overflow="dense",
                     raycast_normals="screen", raycast_march="temporal", model_map_level=1, icp_fixed_assoc=True,
                     raycast_refine="reuse")
REFRESH_COVERAGE = 2.0  # raycast_temporal_min_coverage above 1: every frame takes the hier2 refresh
WINDOW = 12  # bench.py's raycast_temporal_window and raycast_hier_window
DEVICE_DEPTH_FRAME = 3  # the bench run's second run feeds this frame's depth as a tensor already on the card
# launches of a frame (the host's launch, copy and fill calls, each one device event; profile_step.py's count):
# as configs/synthetic.yaml says, with the cached association at half-resolution model maps (each level's
# first ICP launch writes it: no launch of its own), with brick fusion (B3a, B3b and B3c where K2 was, one
# launch each), and in bench.py's configuration (the brick layout, the temporal march: B4 where K3 and K5
# were, the anchors and their coverage, one copy for both flags; the screen normals B4n computed in K6's
# launch, so no launch of their own: 675, where B4n's own launch made it 676 before; on a refresh frame B5a,
# B5b and B4 once more); 3 of them in `preprocess` (K1, K7 once for both coarser levels, K8 once for all levels)
FRAME_LAUNCHES = {"main path": 658, "main path, fixed association": 658, "main path, brick fusion": 660,
                  "main path, bench": 675, "main path, bench refresh": 679}
PROBE_E_STEPS = 64  # probe E's dependent steps a ray (phase_probes): B5b's latency floor takes its time a step
PREPROCESS_LAUNCHES = 3
PROBES_SRC = "xslam_tpu_torch/csrc/gather_probes.cu"
POINT_CAPACITY = 1_000_000  # run_slam's draw_pcd capacity
# the realistic paths: configs/ICL_realistic.yaml's dataset cut from 301 frames to 30 (ATE < 0.02 m, a checkpoint
# after 15 frames resumed to the end), configs/7scenes_realistic.yaml's to 10, both rendered by the port's generator
N_FRAMES_ICL = 30
CHECKPOINT_AT = 15
N_FRAMES_7SCENES = 10

# kernel: (source, the TPU/XLA code it replaces, the path whose launches are reported); the association
# kernel runs on no path: each level's first icp_system launch writes the association, and the kernel is the
# reference that index is held against, so it is listed with its main-path count, 0
FOLDED = {"icp_associate": "icp_system"}
# the device kernels that one launch count of a wrapper stands for, listed where the wrapper's work is more
# than a kernel's name says: B3b's classes and ranks are one kernel
DEVICE_KERNELS = {"classify_bricks": ("classify_bricks_kernel",),
                  "skip_field": ("event_mask_kernel", "skip_distance_kernel"),
                  "extract_points": ("extract_count_kernel", "extract_points_kernel", "extract_normals_kernel")}
KERNELS = {
    "bilateral_filter": ("xslam_tpu_torch/csrc/bilateral.cu", "xslam_tpu/ops/pallas_kernels.py:99", "main path"),
    "fuse_volume": ("xslam_tpu_torch/csrc/fusion.cu", "xslam_tpu/ops/fusion.py:108", "main path"),
    "march_fixed": ("xslam_tpu_torch/csrc/march.cu", "xslam_tpu/ops/raycast.py:136", "main path"),
    "raycast_refine": ("xslam_tpu_torch/csrc/refine.cu", "xslam_tpu/ops/raycast.py:901", "main path"),
    "resize_model_maps": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/models/kinfu.py:527-529,546", "main path"),
    "depth_pyramid": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/ops/preprocess.py:78", "main path"),
    "depth_mips": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:60", "main path, brick fusion"),
    "classify_bricks": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:219",
                        "main path, brick fusion"),
    "fuse_bricks": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:636", "main path, brick fusion"),
    "vertex_normal_maps": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/ops/preprocess.py:115", "main path"),
    "icp_system": ("xslam_tpu_torch/csrc/icp.cu", "xslam_tpu/ops/icp.py:107", "main path"),
    "icp_associate": ("xslam_tpu_torch/csrc/icp.cu", "xslam_tpu/ops/icp.py:72", "main path, fixed association"),
    "window_march": ("xslam_tpu_torch/csrc/window.cu", "xslam_tpu/ops/raycast.py:579,787,1018", "main path, bench"),
    "model_map_normals": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/ops/raycast.py:1087", "main path, bench"),
    "skip_field": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/bricks.py:139,151", "main path, bench refresh"),
    "march_skip": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/raycast.py:254", "main path, bench refresh"),
    "extract_points": ("xslam_tpu_torch/csrc/extract.cu", "xslam_tpu/ops/extract.py:59", "main path, ICL realistic"),
    "probe_a": (PROBES_SRC, "apps/probe_pallas_gather.py:56", "probe path"),
    "probe_b": (PROBES_SRC, "apps/probe_pallas_gather.py:77", "probe path"),
    "probe_c": (PROBES_SRC, "apps/probe_pallas_gather.py:98", "probe path"),
    "probe_d": (PROBES_SRC, "apps/probe_pallas_gather.py:121", "probe path"),
    "probe_e": (PROBES_SRC, "apps/probe_pallas_gather.py:142", "probe path"),
}


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events. The
    stream is first held busy for some 20 ms, so that the host queues the
    calls ahead of the device and a kernel shorter than the host's launch
    pace is timed at its own length, not the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` as a caller finds it after other work: the
    L2 cache is flushed by writing a scratch buffer larger than it before
    each call, and only the call itself is timed, by CUDA events around it,
    on a stream held busy as in :func:`time_ms`."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(HOLD_CYCLES)
    for i, (start, end) in enumerate(events):
        scratch.fill_(float(i))
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def frac_equal(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of equal entries (NaN equal to NaN), counted exactly: a float32
    mean on the card multiplies by a rounded reciprocal (0.99999994 for 13,983
    equal entries)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int(same.sum()) / same.numel()


def max_abs(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 steps between ``a`` and ``b`` where both
    are numbers (0: equal everywhere they are)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    both = ~torch.isnan(a) & ~torch.isnan(b)
    d = (ordered(a) - ordered(b)).abs()[both]
    return int(d.max()) if d.numel() else 0


def same_nans(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b)))


def csrc_constant(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source under ``xslam_tpu_torch/csrc``."""
    with open(os.path.join(ROOT, "xslam_tpu_torch", "csrc", source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    check(m is not None, f"{source} has no constexpr int {name}")
    return int(m.group(1))


def emit(tag: str, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------------
def phase_rounding(ctx):
    from xslam_tpu_torch.apps import torch_rounding

    report = torch_rounding.measure(ctx["device"])
    emit("PyTorch's rounding on the card", **report)
    off = torch_rounding.not_followed(report)
    check(not off, f"torch {torch.__version__} no longer rounds as the kernels K3, K5, K6 and K8 repeat it "
                   f"(csrc/rays.cuh, refine.cu, maps.cu follow torch 2.11): {off}")


def _bilateral_table_ulp(table: torch.Tensor) -> int:
    """K1's weight table against ``torch.exp`` of the tap's expression as the
    plain version writes it, in float32 steps; its last column must be 0."""
    from xslam_tpu_torch.ops import preprocess

    r = preprocess.BILATERAL_R
    inv_ss = 0.5 / (preprocess.SIGMA_SPACE * preprocess.SIGMA_SPACE)
    inv_sc = 0.5 / (preprocess.SIGMA_COLOR * preprocess.SIGMA_COLOR)
    space2 = sorted({dy * dy + dx * dx for dy in range(r + 1) for dx in range(r + 1)})
    diff = torch.arange(table.numel() // len(space2), dtype=torch.float32, device=table.device)
    rows = [torch.exp(-(float(np.float32(s2) * np.float32(inv_ss)) + (diff * diff) * inv_sc)) for s2 in space2]
    table = table.view(len(space2), -1)
    check(bool((table[:, -1] == 0).all()), "K1's weight table does not end in a zero column")
    return max_ulp(table, torch.stack(rows))


def phase_bilateral(ctx):
    from xslam_tpu_torch.ops import kernels, preprocess

    depth = torch.as_tensor(ctx["depths"][0], device=ctx["device"])
    out = kernels.bilateral_filter(depth)
    ref = preprocess.bilateral_filter(depth)
    torch.cuda.synchronize()
    err, eq = max_abs(out, ref), frac_equal(out, ref)
    ms = time_ms(lambda: kernels.bilateral_filter(depth), 50)
    plain = time_ms(lambda: preprocess.bilateral_filter(depth), 3)
    H, W = depth.shape
    bms, by = bound_ms(H * W * (2 + 4), H * W * 169 * 8)

    table_ulp = _bilateral_table_ulp(kernels.bilateral_weights(depth.device))
    emit("K1 bilateral_filter", shape=[H, W], max_abs_err=err, frac_equal=eq, ms=ms, plain_ms=plain,
         bound_ms=bms, bound_by=by, library_ms=None, library_note="no single PyTorch call computes it",
         weight_table_max_ulp=table_ulp)
    check(err <= 1.0 and eq > 0.999, f"K1 disagrees with its plain version: max {err}, equal {eq}")
    check(table_ulp <= 1, f"K1's weight table is {table_ulp} float32 steps from torch.exp of the tap's expression")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def _seeded_c2v(ctx, c2v: np.ndarray, rng):
    """The dual camera->volume pose ``c2v`` with a seeded derivative lane, so
    the kernels' grad lane carries real values."""
    from xslam_tpu_torch.csfd.single import CSFD

    g = torch.as_tensor((1e-2 * rng.standard_normal((4, 4))).astype(np.float32), device=ctx["device"])
    g[3] = 0.0
    return CSFD(torch.as_tensor(np.asarray(c2v, np.float32), device=ctx["device"]), g)


def _v2c(ctx, pose_c2w: np.ndarray, rng):
    """Dual volume->camera and camera->volume poses of a ground-truth camera
    (:func:`_seeded_c2v`)."""
    from xslam_tpu_torch.geometry import se3

    w2v = np.asarray(ctx["config"].world2volume, np.float32)
    c2v = _seeded_c2v(ctx, (w2v @ pose_c2w).astype(np.float32), rng)
    return se3.inverse(c2v), c2v


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-volume pose of a camera at ``eye`` looking at ``target``."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    return c2v


def _regression_pose() -> np.ndarray:
    """The camera-to-world pose on which the JAX package's brick fusion once
    left dense fusion by 22 voxels (its window-coverage regression test):
    Rx Ry Rz of the angles, then the translation, carried here as numbers."""
    ang = np.array([-0.13110635, -0.27977643, -0.03972851])
    c, s = np.cos(ang), np.sin(ang)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = rx @ ry @ rz
    c2w[:3, 3] = [0.29632427, -0.26935779, -0.4479787]
    return c2w


def phase_fusion(ctx):
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.io.synthetic import default_scene, render_depth
    from xslam_tpu_torch.ops import fusion, kernels

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    rng = np.random.default_rng(0)
    vol = fusion.create_volume(eng, dev)
    poses = [np.linalg.inv(ctx["gt"][0]) @ p for p in ctx["gt"]]
    for i in range(3):
        v2c, _ = _v2c(ctx, poses[i], rng)
        depth_m = fusion.scale_depth(torch.as_tensor(ctx["depths"][i], device=dev))
        fusion.integrate(vol, depth_m, se3.rotation(v2c), se3.translation(v2c), intr, eng)
    ctx["volume"] = vol
    orbit_v2c, _ = _v2c(ctx, poses[3], rng)

    def dual_v2c(c2v: np.ndarray) -> CSFD:
        return se3.inverse(_seeded_c2v(ctx, c2v, rng))

    # (name, volume->camera pose, depth in metres): the orbit's next frame; a camera in a corner of
    # the volume that looks at its middle, on a seeded depth; the regression pose, on the scene it sees
    w2v = np.asarray(cfg.world2volume, np.float64)
    extent = np.asarray(eng.resolution, np.float64) * eng.voxel_size
    seeded = rng.uniform(300.0, 6000.0, (intr.height, intr.width))
    seeded[rng.random(seeded.shape) < 0.1] = 0.0
    regression = _regression_pose()
    cases = [
        ("orbit frame 3", orbit_v2c, ctx["depths"][3]),
        ("volume corner", dual_v2c(_look_at(np.full(3, 0.2), extent / 2)), seeded.astype(np.uint16)),
        ("window-coverage regression pose", dual_v2c(w2v @ regression),
         render_depth(default_scene(), regression, intr)),
    ]
    ctx["fusion_cases"] = cases
    table = None
    for name, v2c, depth_u16 in cases:
        r, t = se3.rotation(v2c), se3.translation(v2c)
        depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
        args = (depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
        a = [x.clone() for x in vol]
        b = [x.clone() for x in vol]
        kernels.fuse_volume(*a, *args)
        kernels.fuse_volume_plain(*b, *args)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
        err_v, err_g = max_abs(a[0], b[0]), max_abs(a[1], b[1])
        updated = int((b[2] != vol.weight).sum())
        keep = fusion.tile_keep_mask(r, t, intr, eng.resolution, eng.voxel_size)
        kept_voxels = int(keep.sum()) * int(np.prod(fusion.FUSE_TILE))
        ms = time_ms(lambda: kernels.fuse_volume(*a, *args), 20)
        plain = time_ms(lambda: kernels.fuse_volume_plain(*b, *args), 2)
        # What the kernel needs: every voxel projects (69 operations up to the
        # pixel gate); an updated voxel does 60 more and reads and writes its
        # three planes (24 B). Voxels that pass the pixel gate and then fail the
        # depth or truncation test are not counted, so this is a lower bound.
        n_bytes = depth_m.numel() * 4 + 24 * 4 + updated * 24
        bms, by = bound_ms(n_bytes, a[0].numel() * 69 + updated * 60)
        bound_note = "every voxel to its pixel gate"
        if ms < bms:  # the tile test spared more than that: count the voxels of the tiles it kept
            bms, by = bound_ms(n_bytes, kept_voxels * 69 + updated * 60)
            bound_note = "the voxels of the kept tiles to their pixel gate"
        del a, b
        emit("K2 fuse_volume", case=name, shape=list(vol.value.shape), planes_bit_equal=equal,
             max_abs_err_value=err_v, max_abs_err_grad=err_g, voxels_updated=updated,
             tiles_kept_fraction=float(keep.float().mean()), ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
             bound_counts=bound_note, library_ms=None, library_note="no single PyTorch call computes it")
        check(all(equal), f"K2 is not bit-equal to its plain version at {name}: value, grad, weight {equal}")
        check(updated > 100_000, f"K2's case {name} updates only {updated} voxels")
        if table is None:
            table = dict(max_abs_err=max(err_v, err_g), ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
            ctx["fuse_volume_ms"] = ms
    return table


def _bricks_equal(a, b) -> bool:
    """Two BrickClasses hold the same classes, ranks, counts, flag and lists
    (each list up to its count: the kernel leaves the rest unwritten)."""
    n_active, n_work = (int(x) for x in b.totals)
    return (bool(torch.equal(a.cls, b.cls)) and bool(torch.equal(a.rank, b.rank))
            and bool(torch.equal(a.totals, b.totals)) and bool(a.overflow) == bool(b.overflow)
            and bool(torch.equal(a.active_ids[:n_active], b.active_ids[:n_active]))
            and bool(torch.equal(a.work_ids[:n_work], b.work_ids[:n_work])))


def phase_bricks(ctx):
    """B3a, B3b and B3c against their plain versions, and B3c's volume
    against K2's, on the volume of three fused frames at K2's three poses:
    the mip table and the classes and lists equal; the fused planes equal
    K2's with ``==`` and equal NaN masks, bit for bit (the sign of zero
    counted apart); with cap 64, ``"flag"`` equals the plain version and
    ``"dense"`` equals K2. B3b runs twice back to back, the second time on
    the next pose's table, and both results equal the plain version's: the
    status words the first launch leaves carry its epoch and count for
    nothing in the second. Each
    kernel timed from prepared arguments beside K2 on the same frame, warm
    and cold (L2 flushed before each launch, as the frame finds its inputs);
    B3a beside ``torch.amax`` over its 8 px tiles and B3b beside
    ``torch.cumsum`` over its ACTIVE flags, yardsticks. The classes are taken
    with a cap of every brick (the volume corner's seeded depth makes some
    5,700 bricks ACTIVE, past bench.py's 2816), so B3c fuses every ACTIVE
    brick exactly at each pose."""
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import bricks, fusion, kernels
    from xslam_tpu_torch.ops import fusion_brick as fb

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    vol = ctx["volume"]
    res = list(eng.resolution)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    H, W = intr.height, intr.width
    layout = fb.mip_layout(H, W)
    fargs = kernels.fusion_args(intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
    cap = int(np.prod(eng.resolution)) // fb.BRICK ** 3
    rows = {}
    cases = ctx["fusion_cases"]
    frames = []  # (depth in metres, fusion pose, B3a's table) of each case
    for _, v2c, depth_u16 in cases:
        depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
        frames.append((depth_m, kernels.fusion_pose(se3.rotation(v2c), se3.translation(v2c)), fb.depth_mips(depth_m)))
    for i, (name, v2c, _) in enumerate(cases):
        r, t = se3.rotation(v2c), se3.translation(v2c)
        depth_m, pose, table = frames[i]
        table_plain = fb.depth_mips_plain(depth_m)
        # B3b twice back to back, the second time on the next case's table and pose
        classes = fb.classify_bricks(table, pose, intr, eng, cap)
        _, pose_next, table_next = frames[(i + 1) % len(frames)]
        second = fb.classify_bricks(table_next, pose_next, intr, eng, cap)
        classes_plain = fb.rank_bricks_plain(fb.classify_bricks_plain(table_plain, pose, intr, eng), cap)
        second_plain = fb.rank_bricks_plain(fb.classify_bricks_plain(table_next, pose_next, intr, eng), cap)
        k2 = [x.clone() for x in vol]
        brick = [x.clone() for x in vol]
        plain = [x.clone() for x in vol]
        kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
        fb.fuse_bricks(*brick, depth_m, pose, intr, eng, classes, cap, True)
        fb.fuse_bricks_plain(*plain, depth_m, pose, intr, eng, classes_plain, cap, True)
        # the row variant (the brick layout) on the brick rows of the same pre-frame volume
        rows_b = bricks.from_dense(*vol)
        fb.fuse_bricks(*rows_b, depth_m, pose, intr, eng, classes, cap, True)
        torch.cuda.synchronize()
        rows_k2 = bricks.from_dense(*k2)
        bits_rows = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(rows_b, rows_k2)]
        del rows_k2
        table_equal = bool(torch.equal(table, table_plain))
        classes_equal = _bricks_equal(classes, classes_plain)
        second_equal = _bricks_equal(second, second_plain)
        second_differs = not bool(torch.equal(classes_plain.cls, second_plain.cls))
        eq_k2 = [bool(torch.equal(a, b)) and same_nans(a, b) for a, b in zip(brick, k2)]
        bits_k2 = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(brick, k2)]
        zero_sign = sum(int(((a == b) & (a.view(torch.int32) != b.view(torch.int32))).sum()) for a, b in zip(brick, k2))
        eq_plain = [bool(torch.equal(a, b)) for a, b in zip(brick, plain)]
        n_active, n_work = (int(x) for x in classes.totals)
        counts = torch.bincount(classes.cls.reshape(-1), minlength=4).tolist()
        updated = int((k2[2] != vol.weight).sum())

        # cap 64: the frame overflows; "flag" leaves the bricks past the cap unfused, "dense" fuses it exactly
        small = fb.classify_bricks(table, pose, intr, eng, 64)
        flag_k, flag_p, dense_k = ([x.clone() for x in vol] for _ in range(3))
        fb.fuse_bricks(*flag_k, depth_m, pose, intr, eng, small, 64, False)
        fb.fuse_bricks_plain(*flag_p, depth_m, pose, intr, eng, small, 64, False)
        fb.fuse_bricks(*dense_k, depth_m, pose, intr, eng, small, 64, True)
        torch.cuda.synchronize()
        flag_equal = all(bool(torch.equal(a, b)) for a, b in zip(flag_k, flag_p))
        flag_unfused = not all(bool(torch.equal(a, b)) for a, b in zip(flag_k, k2))
        dense_equal = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(dense_k, k2))
        del flag_k, flag_p, dense_k, plain

        # each kernel from prepared arguments, the plain versions and K2 beside them
        out_table = torch.empty_like(table)
        scratch = fb.classify_bricks(table, pose, intr, eng, cap)
        b_scratch = fb.classify_scratch(dev, classes.rank.numel())
        b_tiles = fb.classify_tiles(classes.rank.numel())
        lv, consts = fb._layout_ints(layout), fb.classify_consts(intr, eng)
        active_flags = (classes.cls.reshape(-1) == fb.ACTIVE).to(torch.int32)

        def run(kernel, *args):
            err_code = getattr(ext, kernel)(*args, stream)
            check(err_code == 0, f"{kernel} launch failed: cudaError {err_code}")

        def run_b():  # each launch with its own epoch, as the wrapper gives them
            run("classify_bricks", table, pose, scratch.cls, b_scratch.words, *b_scratch.next_launch(),
                scratch.rank, scratch.active_ids, scratch.work_ids, scratch.totals, scratch.overflow, H, W, lv,
                consts, cap)
            b_scratch.launched(b_tiles)

        ms_a = time_ms(lambda: run("depth_mips", depth_m, out_table, lv), 100)
        ms_b = time_ms(run_b, 100)
        # as the frame finds them: the depth image, the table and the lists out of L2
        cold_a = time_cold_ms(lambda: run("depth_mips", depth_m, out_table, lv), 50)
        cold_b = time_cold_ms(run_b, 50)
        ms_c = time_ms(lambda: run("fuse_bricks", *brick, depth_m, pose, classes.cls, classes.rank, classes.work_ids,
                                   classes.totals, classes.overflow, *fargs, cap, True, res, False), 20)
        ms_rows = time_ms(lambda: run("fuse_bricks", *rows_b, depth_m, pose, classes.cls, classes.rank,
                                      classes.work_ids, classes.totals, classes.overflow, *fargs, cap, True, res, True),
                          20)
        ms_k2 = time_ms(lambda: kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist,
                                                    eng.max_weight), 20)
        # as the frame finds them: the planes out of L2 (B3c's work bricks, ~19 MB at the orbit, fit in it)
        cold_c = time_cold_ms(lambda: run("fuse_bricks", *brick, depth_m, pose, classes.cls, classes.rank,
                                          classes.work_ids, classes.totals, classes.overflow, *fargs, cap, True, res,
                                          False), 20)
        cold_rows = time_cold_ms(lambda: run("fuse_bricks", *rows_b, depth_m, pose, classes.cls, classes.rank,
                                             classes.work_ids, classes.totals, classes.overflow, *fargs, cap, True, res,
                                             True), 20)
        cold_k2 = time_cold_ms(lambda: kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist,
                                                           eng.max_weight), 20)
        # a yardstick for B3a, not a library call for it: one of its 22 levels and one of its three statistics
        lib_a = time_ms(lambda: torch.amax(depth_m[:H - H % 8, :W - W % 8].reshape(H // 8, 8, W // 8, 8), dim=(1, 3)),
                        100)
        # a yardstick for B3b: the prefix of its ACTIVE flags, one of its two lists' ranks, without the classes
        lib_b = time_ms(lambda: torch.cumsum(active_flags, 0, dtype=torch.int32), 100)
        check(bool(torch.equal(torch.cumsum(active_flags, 0, dtype=torch.int32)[active_flags.bool()] - 1,
                               classes.rank.reshape(-1)[active_flags.bool()])),
              f"B3b's ranks differ from torch.cumsum over its ACTIVE flags at {name}")
        plain_a = time_ms(lambda: fb.depth_mips_plain(depth_m), 3)
        plain_b = time_ms(lambda: fb.rank_bricks_plain(fb.classify_bricks_plain(table, pose, intr, eng), cap), 3)
        plain_c = time_ms(lambda: fb.fuse_bricks_plain(*brick, depth_m, pose, intr, eng, classes, cap, True), 2)
        # bounds: B3a the image once and the table; 22 x 3 operations a pixel. B3b the table once, the pose,
        # a class and a rank out a brick, the listed ids, the counts and the flag; ~600 operations a brick
        # (eight corners' projections and planes, the intervals, the level scan). B3c the depth image and 24 B
        # a voxel it updates; 69 operations a voxel of the work list to its gate, 60 more an exact update
        n_bricks = classes.rank.numel()
        b_a = bound_ms(depth_m.numel() * 4 + table.numel() * 4, depth_m.numel() * 3 * len(layout.sizes))
        b_b = bound_ms(table.numel() * 4 + pose.numel() * 4 + n_bricks * 8 + (n_active + n_work) * 4 + 9,
                       n_bricks * 600)
        b_c = bound_ms(depth_m.numel() * 4 + updated * 24, n_work * 512 * 69 + n_active * 512 * 60)
        emit("B3 brick fusion", case=name, classes=dict(zip(("none", "far", "active", "far_partial"), counts)),
             n_active=n_active, n_work=n_work, cap=cap, table_rows=layout.rows, table_equal=table_equal,
             classes_and_lists_equal=classes_equal, back_to_back_equal=second_equal,
             back_to_back_classes_differ=second_differs, equal_to_k2=eq_k2, bit_equal_to_k2=bits_k2,
             sign_of_zero_differences=zero_sign, equal_to_plain=eq_plain, voxels_updated=updated,
             rows_bit_equal_to_k2=bits_rows,
             cap64=dict(n_active=int(small.totals[0]), overflow=bool(small.overflow), flag_equal_to_plain=flag_equal,
                        flag_leaves_bricks_unfused=flag_unfused, dense_bit_equal_to_k2=dense_equal),
             ms=dict(depth_mips=ms_a, classify_bricks=ms_b, fuse_bricks=ms_c, sum=ms_a + ms_b + ms_c,
                     fuse_volume=ms_k2, fuse_bricks_rows=ms_rows),
             cold_ms=dict(depth_mips=cold_a, classify_bricks=cold_b, fuse_bricks=cold_c, fuse_volume=cold_k2,
                          fuse_bricks_rows=cold_rows),
             plain_ms=dict(depth_mips=plain_a, classify_bricks=plain_b, fuse_bricks=plain_c),
             bound_ms=dict(depth_mips=b_a, classify_bricks=b_b, fuse_bricks=b_c),
             library_ms=dict(depth_mips=lib_a, classify_bricks=lib_b, fuse_bricks=None),
             library_note="yardsticks, no single PyTorch call computes any of the three: depth_mips torch.amax "
                          "over the 8 px tiles (one of 22 levels, the max alone); classify_bricks torch.cumsum "
                          "over the cls == ACTIVE flags (one of its two lists' ranks, without the classes)")
        check(table_equal, f"B3a's table differs from its plain version at {name}")
        check(classes_equal, f"B3b's classes or lists differ from its plain version at {name}")
        check(second_equal and second_differs,
              f"B3b's second launch, back to back on the next pose's table, at {name}: equal to plain "
              f"{second_equal}, other classes than the first {second_differs}")
        check(all(eq_k2) and all(bits_k2), f"B3c's volume is not K2's bit for bit at {name}: == {eq_k2}, bits {bits_k2}")
        check(all(eq_plain), f"B3c's volume differs from its plain version at {name}: {eq_plain}")
        check(all(bits_rows), f"B3c's row variant is not K2's volume bit for bit at {name}: {bits_rows}")
        check(bool(small.overflow) and flag_equal and flag_unfused and dense_equal,
              f"cap 64 at {name}: overflow {bool(small.overflow)}, flag == plain {flag_equal}, flag leaves bricks "
              f"unfused {flag_unfused}, dense == K2 {dense_equal}")
        check(not bool(classes.overflow) and updated > 100_000,
              f"{name}: overflow, or too few updates ({n_active} ACTIVE bricks, {updated} voxels)")
        if not rows:
            rows = {
                "depth_mips": dict(max_abs_err=0.0, ms=ms_a, cold_ms=cold_a, plain_ms=plain_a, bound_ms=b_a[0],
                                   bound_by=b_a[1], library_ms=lib_a),
                "classify_bricks": dict(max_abs_err=0.0, ms=ms_b, cold_ms=cold_b, plain_ms=plain_b, bound_ms=b_b[0],
                                        bound_by=b_b[1], library_ms=lib_b),
                "fuse_bricks": dict(max_abs_err=0.0, ms=ms_c, cold_ms=cold_c, rows_ms=ms_rows, rows_cold_ms=cold_rows,
                                    plain_ms=plain_c, bound_ms=b_c[0], bound_by=b_c[1]),
            }
        del k2, brick, rows_b
    return rows


def _march_bytes_ops(vol_value, start, dirs, t_found, t_dead, eng):
    """What this run's march must read: the distinct voxels its rays sample
    up to the step where both events are known, plus rays in and times out."""
    from xslam_tpu_torch.ops.kernels import INF_T, RAY_MIN_M, march_steps

    X, Y, Z = vol_value.shape
    step = np.float32(eng.trunc_dist * 0.8)
    n = march_steps(eng.trunc_dist)

    def k_of(t):
        return torch.round((t - RAY_MIN_M) / float(step)).long()

    both = (t_found < INF_T) & (t_dead < INF_T)
    k_stop = torch.where(both, torch.maximum(k_of(t_found), k_of(t_dead)), n - 1).reshape(-1)
    d = dirs.reshape(3, -1)
    ks = torch.arange(-1, n, device=d.device, dtype=torch.float32)
    t = RAY_MIN_M + (ks + 1)[:, None] * float(step)  # sample times, the first at 0.2 m
    p = start[:, None, None] + d[:, None, :] * t[None]
    g = torch.floor(p / eng.voxel_size).long()
    g[:, 0] = torch.stack([g[0, 0].clamp(0, X - 1), g[1, 0].clamp(0, Y - 1), g[2, 0].clamp(0, Z - 1)])
    live = (ks[:, None] <= k_stop[None].float())
    inside = (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)
    idx = (g[0] * Y + g[1]) * Z + g[2]
    distinct = int(torch.unique(idx[live & inside]).numel())
    samples = int(live.sum())
    rays = d.shape[1]
    # the pose in, two times out a ray; some 60 operations to make a ray, 20 a sample
    return distinct * 4 + rays * 8 + 96, rays * 60 + samples * 20, samples


def _ray_pose(ctx, seed: int, c2v_np=None):
    """The packed pose of K3 and K5 at the orbit's frame 3, or at the
    camera->volume pose ``c2v_np``, with a seeded derivative lane, and its
    parts."""
    from xslam_tpu_torch.csfd.single import lift
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    if c2v_np is None:
        _, c2v = _v2c(ctx, np.linalg.inv(ctx["gt"][0]) @ ctx["gt"][3], rng)
    else:
        c2v = _seeded_c2v(ctx, c2v_np, rng)
    w2v = lift(torch.as_tensor(np.asarray(ctx["config"].world2volume, np.float32), device=ctx["device"]))
    v2w = se3.inverse(w2v)
    parts = (se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w))
    return kernels.pack_ray_pose(*parts), parts


def phase_march(ctx):
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng = ctx["config"], ctx["engine_cfg"]
    vol, intr = ctx["volume"], cfg.intrinsics
    pose, parts = _ray_pose(ctx, 1)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    tf, td = kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist)
    pf, pd = kernels.march_fixed_plain(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist)
    torch.cuda.synchronize()
    eq_f, eq_d = frac_equal(tf, pf), frac_equal(td, pd)
    both = (tf < INF_T) & (pf < INF_T)
    err = max_abs(tf, pf, both)
    hits = float((tf < torch.clamp(td, max=INF_T)).float().mean())
    ms = time_ms(lambda: kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist), 50)
    plain = time_ms(
        lambda: kernels.march_fixed_plain(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist), 3)
    n_bytes, n_ops, samples = _march_bytes_ops(vol.value, ray_start.v, ray_dir.v, tf, td, eng)
    bms, by = bound_ms(n_bytes, n_ops)

    # the earlier design (direction planes from memory, one load in flight) on the same rays: equal bits asked
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(ctx["device"]).cuda_stream
    n_steps, vs, step = kernels.march_steps(eng.trunc_dist), kernels.f32(eng.voxel_size), kernels.f32(eng.trunc_dist * 0.8)
    start, dirs = ray_start.v.contiguous(), ray_dir.v.contiguous()
    cf, cd = torch.empty_like(tf), torch.empty_like(td)

    def chain():
        check(ext.march_fixed_chain(vol.value, start, dirs, cf, cd, n_steps, vs, step, stream) == 0,
              "march_fixed_chain launch failed")

    chain_ms = time_ms(chain, 50)
    chain_equal = bool(torch.equal(tf, cf)) and bool(torch.equal(td, cd))
    # rays with a NaN or an infinity never enter the new kernel's loop: the same outputs asked
    # as from the earlier design, which marches them (every sample lies outside)
    odd_equal = True
    for at, bad in ((4, float("nan")), (4, float("inf")), (18, float("inf"))):  # rotation, rotation, origin
        odd_pose = pose.clone()
        odd_pose[at] = bad  # every ray is hit
        odd_dir, odd_start = kernels.camera_rays(*kernels.unpack_ray_pose(odd_pose)[:2], intr)
        of, od = kernels.march_fixed(vol.value, odd_pose, intr, eng.voxel_size, eng.trunc_dist)
        check(ext.march_fixed_chain(vol.value, odd_start.v.contiguous(), odd_dir.v.contiguous(), cf, cd, n_steps, vs,
                                    step, stream) == 0, "march_fixed_chain launch failed")
        odd_equal = odd_equal and bool(torch.equal(of, cf)) and bool(torch.equal(od, cd))
    chain()  # cf, cd back to the real rays' outputs
    emit("K3 march_fixed", shape=list(tf.shape), nan_and_inf_rays_equal_to_earlier_design=odd_equal,
         t_found_frac_equal=eq_f, t_dead_frac_equal=eq_d,
         max_abs_err_t_found=err, hit_fraction=hits, samples=samples, bytes_needed=n_bytes, ms=ms,
         plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
         library_note="no single PyTorch call computes it",
         earlier_design_ms=chain_ms, bit_equal_to_earlier_design=chain_equal,
         rays_differing_from_earlier_design=int(((tf != cf) | (td != cd)).sum()))
    check(eq_f >= 0.999 and eq_d >= 0.999, f"K3 disagrees with its plain version: {eq_f}, {eq_d}")
    check(hits > 0.5, f"K3 found surfaces on only {hits:.3f} of the rays")
    check(chain_equal and odd_equal,
          f"K3 is not bit-equal to its earlier design: {chain_equal}, NaN and inf rays {odd_equal}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def _refine_bytes_ops(vol, ray_start, ray_dir, t_found, accept, eng):
    """What this run's refine must move and do: the distinct voxels that the
    accepted pixels' eight trilinears tap (both planes, 8 B each), two times
    in and four (3,) float32 vectors out a pixel, the pose; some 8 x 16 x 6
    operations an accepted pixel."""
    from xslam_tpu_torch.ops import raycast

    X, Y, Z = vol.value.shape
    voxel, step = eng.voxel_size, eng.trunc_dist * 0.8
    t = t_found[accept]
    d = ray_dir.v[:, accept]
    s = ray_start.v[:, None]

    def tsdf_at(p):
        from xslam_tpu_torch.csfd.single import lift
        return raycast.trilinear_tsdf_shard(vol.value, vol.grad, lift(p[0]), lift(p[1]), lift(p[2]), voxel).v

    p0, p1 = s + d * t, s + d * (t + step)
    ft, ftdt = tsdf_at(p0), tsdf_at(p1)
    vertex = s + d * (t - step * ft / (ftdt - ft))
    points = [p0, p1]
    for axis in range(3):
        for sign in (1.0, -1.0):
            q = vertex.clone()
            q[axis] += sign * voxel * 0.5
            points.append(q)
    cells = []
    for p in points:
        g = torch.floor(torch.nan_to_num(p) / voxel)
        g = g - (torch.nan_to_num(p) < (g + 0.5) * voxel).float()
        g = g.long()
        ok = ((g >= 0) & (g < torch.tensor([X - 1, Y - 1, Z - 1], device=g.device)[:, None])).all(dim=0)
        g = g[:, ok]
        base = (g[0] * Y + g[1]) * Z + g[2]
        cells.append(torch.cat([base + dx * Y * Z + dy * Z + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    distinct = int(torch.unique(torch.cat(cells)).numel())
    n_pix, n_acc = accept.numel(), int(accept.sum())
    return distinct * 8 + n_pix * (8 + 48) + 192, n_acc * 8 * 16 * 6 + n_pix * 4, distinct


def _planar_volume(ctx, offset: float):
    """A volume whose TSDF is the plane z = (Z / 2 + offset) voxels, linear
    over 0.5 m on either side (so the secant is exact to rounding), with the
    taps' +1e-5 bias taken out of its place: the refined vertices lie within a
    few ulps of a plane of voxel centres (offset 3.5) or of cell edges (3),
    where the rounding of v / voxel and of v +- half a voxel decides the cells
    (not at Z / 2 = 128 voxels: there, at a power of two, the roundings all
    agree and no sample leaves the rule). Its derivative plane is seeded; and
    the camera->volume pose of a camera 2.5 m in front of it, looking along
    +z."""
    from xslam_tpu_torch.ops import fusion

    eng, dev = ctx["engine_cfg"], ctx["device"]
    X, Y, Z = eng.resolution
    vs = eng.voxel_size
    z_plane = (Z // 2 + offset) * vs - 1e-5 * 0.5
    zc = (torch.arange(Z, dtype=torch.float32, device=dev) + 0.5) * vs
    value = ((z_plane - zc) / 0.5).clamp(-1.0, 1.0).expand(X, Y, Z).contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    grad = 1e-2 * torch.randn((X, Y, Z), generator=gen, device=dev)
    c2v = np.eye(4)
    c2v[:3, 3] = [X * vs / 2 + 0.013, Y * vs / 2 - 0.021, z_plane - 2.5]
    return fusion.VolumeState(value, grad, torch.ones_like(value)), c2v


def phase_refine(ctx):
    """K5 against ``refine`` + ``finalize_maps``, bit for bit (every lane
    equal, NaN masks equal): on the fused volume at the orbit's frame 3 at the
    image shapes of ``model_map_level`` 0 and 1 (timed; its outputs also feed
    K6's phase), and on two planar volumes whose vertices lie within a few
    ulps of voxel centres and of cell edges; on the second, some 2.7% of the
    normal samples leave the rule of the shared block and read their own taps
    (the count is printed; the orbit has a few in a million)."""
    from xslam_tpu_torch.ops import kernels, raycast
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    planes = {name: _planar_volume(ctx, offset) for name, offset in (("plane on voxel centres", 3.5),
                                                                     ("plane on cell edges", 3.0))}
    cases = [("orbit frame 3", 0, ctx["volume"], None), ("orbit frame 3", 1, ctx["volume"], None)]
    cases += [(name, 0, vol, c2v) for name, (vol, c2v) in planes.items()]
    table, ctx["model_maps"] = None, {}
    direct = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, L, vol, c2v in cases:
        pose, parts = _ray_pose(ctx, 3, c2v)
        intr = cfg.intrinsics.level(L)
        t_found, t_dead = kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist)
        ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
        accept = t_found < torch.clamp(t_dead, max=INF_T)

        def plain_fn():
            return raycast.finalize_maps(*raycast.refine(vol, ray_start, ray_dir, t_found, accept, parts[2], parts[3], eng))

        direct.zero_()
        out = raycast.raycast_refine(vol, pose, t_found, t_dead, intr, eng, direct=direct)
        ref = plain_fn()
        torch.cuda.synchronize()
        lanes = {"vmap.v": (out[0].v, ref[0].v), "vmap.g": (out[0].g, ref[0].g),
                 "nmap.v": (out[1].v, ref[1].v), "nmap.g": (out[1].g, ref[1].g)}
        eq = {k: frac_equal(a, b) for k, (a, b) in lanes.items()}
        ulp = {k: max_ulp(a, b) for k, (a, b) in lanes.items()}
        nans = all(same_nans(a, b) for a, b in lanes.values())
        err = max(max_abs(a, b) for a, b in lanes.values())
        valid = float((~torch.isnan(out[1].v[0])).float().mean())
        n_direct = int(direct.item())
        row = dict(case=name, model_map_level=L, shape=[intr.height, intr.width], frac_equal=eq, max_ulp=ulp,
                   nan_masks_equal=nans, max_abs_err=err, accepted_fraction=float(accept.float().mean()),
                   normal_valid_fraction=valid, direct_samples=n_direct,
                   direct_fraction_of_normal_samples=n_direct / max(1, 6 * int((~torch.isnan(out[1].v[0])).sum())))
        if name == "orbit frame 3":
            ms = time_ms(lambda: raycast.raycast_refine(vol, pose, t_found, t_dead, intr, eng), 50)
            plain = time_ms(plain_fn, 3)
            n_bytes, n_ops, distinct = _refine_bytes_ops(vol, ray_start, ray_dir, t_found, accept, eng)
            bms, by = bound_ms(n_bytes, n_ops)
            row.update(distinct_voxels=distinct, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                       library_note="no single PyTorch call computes it")
            ctx["model_maps"][L] = out
            if L == 0:
                table = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        emit("K5 raycast_refine", **row)
        check(nans and min(eq.values()) == 1.0 and max(ulp.values()) == 0,
              f"K5 is not bit-equal to its plain version ({name}, L={L}): equal {eq}, ulp {ulp}, NaN masks {nans}")
        check(valid > 0.5, f"K5: normals on only {valid:.3f} of the pixels ({name}, L={L})")
        check(name != "plane on cell edges" or n_direct > 0,
              "K5: no normal sample on the plane of cell edges read its own taps: the exact path went untested")
    return table


def _bench_inputs(ctx):
    """The path-shaped inputs of the brick layout's raycast kernels: the
    brick rows of the fused volume, the packed pose at the orbit's frame 3
    (seeded derivative lane) and its parts, the model maps' intrinsics
    (level 1, 240x320), and frame 3's depth anchors (its level-1 vertex
    distances, no fallback), as the engine makes them."""
    from xslam_tpu_torch.ops import bricks, kernels, raycast_bricks

    if "bench_inputs" not in ctx:
        cfg, dev = ctx["config"], ctx["device"]
        rows = bricks.from_dense(*ctx["volume"])
        pose, parts = _ray_pose(ctx, 7)
        intr = cfg.intrinsics.level(1)
        depths = kernels.depth_pyramid(kernels.bilateral_filter(torch.as_tensor(ctx["depths"][3], device=dev)), 2)
        vmaps, _ = kernels.vertex_normal_pyramid([cfg.intrinsics, intr], depths)
        none = torch.full((intr.height, intr.width), float("inf"), dtype=torch.float32, device=dev)
        ctx["bench_inputs"] = (rows, pose, parts, intr, raycast_bricks.anchor_map(vmaps[1], none))
    return ctx["bench_inputs"]


def _lanes_equal(tag: str, lanes: dict) -> dict:
    eq = {k: frac_equal(a, b) for k, (a, b) in lanes.items()}
    ulp = {k: max_ulp(a, b) for k, (a, b) in lanes.items()}
    nans = all(same_nans(a, b) for a, b in lanes.values())
    err = max(max_abs(a, b) for a, b in lanes.values())
    check(nans and min(eq.values()) == 1.0 and max(ulp.values()) == 0,
          f"{tag} is not bit-equal to its plain version: equal {eq}, ulp {ulp}, NaN masks {nans}")
    return dict(frac_equal=eq, max_ulp=ulp, nan_masks_equal=nans, max_abs_err=err)


def phase_window(ctx):
    """B4 against its plain versions, bit for bit, at the bench
    path's shapes: B4 with the refine, the temporal frame's march (240x320
    rays anchored at frame 3's depth) against ``march_temporal`` and the
    ``reuse`` refine through the pair taps; B4 without it, the refresh's half
    level (120x160 rays anchored at the plain skip march's quarter-level
    hits) against ``_window_repair``. Each timed from prepared arguments,
    warm and cold (L2 flushed before each launch)."""
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb

    eng, dev = ctx["engine_cfg"], ctx["device"]
    res = eng.resolution
    rows, pose, parts, intr, t_anchor = _bench_inputs(ctx)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    read = rb._value_reader(rows.value, res)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(res)
    H, W = intr.height, intr.width
    f32, step = kernels.f32, eng.trunc_dist * 0.8
    consts = (f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size), f32(step), kernels.reciprocal_f32(step),
              *kernels.camera_args(intr))

    # with the refine: the temporal frame
    vmap, t_found = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW, refine=True)
    stats = {}

    def plain_refine():
        out = raycast.march_temporal(t_anchor, ray_start, ray_dir, eng, WINDOW, read, res, True, stats)
        return rb._reuse_maps(rows, ray_start, ray_dir, out, parts[2], parts[3], eng)

    vp, hp = plain_refine()
    torch.cuda.synchronize()
    refine_eq = _lanes_equal("B4 (with the refine)", {"vmap.v": (vmap.v, vp.v), "vmap.g": (vmap.g, vp.g),
                                                      "t_found": (t_found, hp.t_found)})
    valid = float(torch.isfinite(vmap.v[0]).float().mean())
    accepted = int(torch.isfinite(vmap.v[0]).sum())
    vv, vg, tf = torch.empty_like(vmap.v), torch.empty_like(vmap.g), torch.empty_like(t_found)

    def run_refine():
        check(ext.window_march(rows.value, rows.grad, pose, t_anchor, None, vv, vg, tf, None, *nb, H, W, H // 2,
                               W // 2, 1, WINDOW, *consts, stream) == 0, "window_march launch failed")

    ms = time_ms(run_refine, 50)
    cold = time_cold_ms(run_refine, 30)
    plain = time_ms(plain_refine, 3)
    # bytes: the anchors in, t_found and the dual vertex map out, the pose; operations: ~60 to make a ray, ~20
    # a sample (this run's: a ray stops once both events are known), ~250 a refined pixel (the secant, one dual
    # trilinear, the vertex)
    refine_bound = bound_ms(H * W * (4 + 4 + 24) + 192, H * W * 60 + stats["samples"] * 20 + accepted * 250)
    check(valid > 0.5, f"B4: vertices at only {valid:.3f} of the pixels")

    # without: the refresh's half level, from the plain skip march's hits at a quarter
    dist = bricks.brick_distance_rows(rows, res)
    q = rb.SKIP_STRIDE
    coarse = raycast.march_skip_plain(ray_start, ray_dir.v[:, ::q, ::q], eng,
                                      rb._value_reader(bricks.pack_rows(rows.value, dist), res), res)
    mid = rb.window_march(rows, pose, intr, eng, coarse.t_found, WINDOW, anchor_dead=coarse.t_dead, stride=2)
    mstats = {}
    mp = raycast._window_repair(ray_start, ray_dir.v[:, ::2, ::2], coarse, WINDOW, eng, read, res, stats=mstats)
    torch.cuda.synchronize()
    half_eq = _lanes_equal("B4 (without the refine)", {"t_found": (mid.t_found, mp.t_found),
                                                       "t_dead": (mid.t_dead, mp.t_dead)})
    Hm, Wm = mid.t_found.shape
    ch, cw = coarse.t_found.shape
    mf, md = torch.empty_like(mid.t_found), torch.empty_like(mid.t_dead)

    def run_half():
        check(ext.window_march(rows.value, rows.grad, pose, coarse.t_found, coarse.t_dead, None, None, mf, md, *nb,
                               Hm, Wm, ch, cw, 2, WINDOW, *consts, stream) == 0, "window_march launch failed")

    half_ms = time_ms(run_half, 50)
    half_cold = time_cold_ms(run_half, 30)
    half_bound = bound_ms(ch * cw * 8 + Hm * Wm * 8 + 192, Hm * Wm * 60 + mstats["samples"] * 20)

    ctx["bench_vmap"] = vmap  # B4n's input in the normals phase

    emit("B4 window_march", case="orbit frame 3, depth anchors", shape=[H, W], window=WINDOW, **refine_eq,
         vertex_valid_fraction=valid, samples=stats["samples"], ms=ms, cold_ms=cold, plain_ms=plain,
         bound_ms=refine_bound[0], bound_by=refine_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it",
         half_level=dict(shape=[Hm, Wm], coarse_shape=[ch, cw], samples=mstats["samples"], ms=half_ms,
                         cold_ms=half_cold, bound_ms=half_bound[0], bound_by=half_bound[1], **half_eq))
    return {
        "window_march": dict(max_abs_err=refine_eq["max_abs_err"], ms=ms, cold_ms=cold, plain_ms=plain,
                             bound_ms=refine_bound[0], bound_by=refine_bound[1], half_level_ms=half_ms,
                             half_level_cold_ms=half_cold, half_level_bound_ms=half_bound[0]),
    }


def phase_normals(ctx):
    """B4n in K6's launch (``model_map_pyramid`` with no normals given)
    against its plain chain, ``screen_normals_plain`` then
    ``resize_model_maps`` level after level, bit for bit at every level: on
    B4's 240x320 vertex map of the bench frame with the pyramid's levels and
    with one level (no coarser level, the normals still due), and on a
    239x319 crop of it (an odd last row and column, which no level-1 pixel
    owns). Timed from prepared arguments, warm and cold, beside K6 alone on
    the same map with the plain normals given."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.models.kinfu import model_map_pyramid, resize_model_maps
    from xslam_tpu_torch.ops import kernels, raycast

    dev, levels = ctx["device"], ctx["config"].num_levels
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    vmap = ctx.pop("bench_vmap")
    crop = CSFD(vmap.v[:, :239, :319].contiguous(), vmap.g[:, :239, :319].contiguous())
    worst = 0.0
    for case, vm, n_levels in (("bench frame", vmap, levels), ("bench frame, one level", vmap, 1),
                               ("crop 239x319", crop, levels)):
        vmaps, nmaps = model_map_pyramid(vm, None, n_levels)
        plain_v, plain_n = [vm], [raycast.screen_normals_plain(vm)]
        for _ in range(1, n_levels):
            v, n = resize_model_maps(plain_v[-1], plain_n[-1])
            plain_v.append(v)
            plain_n.append(n)
        torch.cuda.synchronize()
        check(len(vmaps) == len(nmaps) == n_levels and vmaps[0] is vm, f"B4n in K6 ({case}): {len(vmaps)} levels")
        for level in range(n_levels):
            pairs = [(nmaps[level].v, plain_n[level].v), (nmaps[level].g, plain_n[level].g)]
            if level:
                pairs += [(vmaps[level].v, plain_v[level].v), (vmaps[level].g, plain_v[level].g)]
            nans, eq, ulp, err = _compare("B4n in K6's launch", pairs, case=case, level=level,
                                          shape=list(nmaps[level].v.shape[1:]),
                                          normal_valid_fraction=float(torch.isfinite(nmaps[level].v[0]).float().mean()))
            check(nans and ulp == 0 and eq == 1.0,
                  f"B4n in K6 is not bit-equal to its plain chain ({case}, level {level}): equal {eq}, ulp {ulp}")
            worst = max(worst, err)
    valid = float(torch.isfinite(nmaps[0].v[0]).float().mean())
    check(valid > 0.5, f"B4n: normals at only {valid:.3f} of the pixels")

    # the launch from prepared arguments, warm and cold, beside K6 alone on the plain normals
    H, W = vmap.v.shape[-2:]
    shapes = [(H >> level, W >> level) for level in range(1, levels)]
    offsets, size = kernels.map_pyramid_layout(shapes, 4)
    offsets = [o for level in offsets for o in level]
    out, out6 = (torch.empty(size, dtype=torch.float32, device=dev) for _ in range(2))
    nv, ng = torch.empty_like(vmap.v), torch.empty_like(vmap.g)
    n0 = raycast.screen_normals_plain(vmap)

    def run_fused():
        check(ext.model_map_normals(vmap.v, vmap.g, nv, ng, out, offsets, levels, stream) == 0,
              "model_map_normals launch failed")

    def run_k6():
        check(ext.model_map_pyramid(vmap.v, vmap.g, n0.v, n0.g, out6, offsets, levels, stream) == 0,
              "model_map_pyramid launch failed")

    def plain_chain():
        v, n = vmap, raycast.screen_normals_plain(vmap)
        for _ in range(1, levels):
            v, n = resize_model_maps(v, n)

    ms, k6_ms = time_ms(run_fused, 100), time_ms(run_k6, 100)
    cold, k6_cold = time_cold_ms(run_fused, 30), time_cold_ms(run_k6, 30)
    plain = time_ms(plain_chain, 3)
    out_px = sum(h * w for h, w in shapes)
    # the vertex map in and its normals out (both lanes, 48 B a pixel), the coarser levels' four maps out; ~150
    # operations a normal, ~120 an output pixel
    bms, by = bound_ms(H * W * 48 + out_px * 48, H * W * 150 + out_px * 120)
    emit("B4n in K6's launch", shape=[H, W], levels=levels, ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
         bound_by=by, library_ms=None, library_note="no single PyTorch call computes it", k6_alone_ms=k6_ms,
         k6_alone_cold_ms=k6_cold, normal_valid_fraction=valid)
    return {"model_map_normals": dict(max_abs_err=worst, ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
                                      bound_by=by, k6_alone_ms=k6_ms, k6_alone_cold_ms=k6_cold)}


def phase_skip(ctx):
    """B5a and B5b against their plain versions at the bench path's shapes:
    B5a's distance equal to ``brick_distance_rows`` on every brick; B5b (the
    refresh's 60x80 rays, a quarter of the model maps' in each axis) equal to
    ``march_skip_plain`` over ``pack_rows`` on every ray, both events, and to
    the plain fixed march over the dense twin on the same rays as the
    reference holds them (``tests/test_march_skip.py``): the same accepted
    rays, and the same ``t_found`` on each. The skip march stops at its first
    event, so a ray that crosses keeps no death, and a ray that leaves the
    volume through empty space dies where its jump lands past the face: those
    rays' other event differs from the fixed march's, and is counted. Each timed from prepared arguments, warm and cold."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry.intrinsics import Intrinsics
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb
    from xslam_tpu_torch.ops.kernels import INF_T, RAY_MIN_M

    eng, dev = ctx["engine_cfg"], ctx["device"]
    res = eng.resolution
    rows, pose, parts, intr, _ = _bench_inputs(ctx)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(res)
    n = nb[0] * nb[1] * nb[2]

    dist = bricks.skip_field(rows, res)
    dist_plain = bricks.brick_distance_rows(rows, res)
    torch.cuda.synchronize()
    dist_equal = bool(torch.equal(dist, dist_plain))
    histogram = torch.bincount(dist_plain, minlength=bricks.DIST_CAP + 1).tolist()
    mask, dk = torch.empty(n, dtype=torch.uint8, device=dev), torch.empty_like(dist)

    def run_field():
        check(ext.skip_field(rows.value, rows.weight, mask, dk, *nb, stream) == 0, "skip_field launch failed")

    f_ms = time_ms(run_field, 50)
    f_cold = time_cold_ms(run_field, 30)
    f_plain = time_ms(lambda: bricks.brick_distance_rows(rows, res), 3)
    # the value and weight rows once, a distance out a brick; ~3 operations a voxel, ~1 a cube cell a brick
    f_bound = bound_ms(2 * rows.value.numel() * 4 + n * 4, rows.value.numel() * 3 + n * 11 ** 3)

    q = rb.SKIP_STRIDE
    lanes = csrc_constant("skip.cu", "LANES")
    packed_read = rb._value_reader(bricks.pack_rows(rows.value, dist_plain), res)

    def plain_skip(case_intr, stats=None):
        ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], case_intr)
        dirs = CSFD(ray_dir.v[:, ::q, ::q], ray_dir.g[:, ::q, ::q])
        return raycast.march_skip_plain(ray_start, dirs.v, eng, packed_read, res, stats=stats), ray_start, dirs

    hit = rb.march_skip(rows, dist, pose, intr, eng)
    stats = {"lanes": lanes}
    plain, ray_start, dirs = plain_skip(intr, stats)
    ff, fd = kernels.march_fixed_plain(ctx["volume"].value, ray_start, dirs, eng.voxel_size, eng.trunc_dist)
    # one odd, few-ray shape: 7 x 9 rays, a 25 x 33 window about the image's centre (fewer rays than a block)
    few = Intrinsics(intr.fx, intr.fy, 16.0, 12.0, 33, 25)
    few_hit, (few_plain, _, _) = rb.march_skip(rows, dist, pose, few, eng), plain_skip(few)
    torch.cuda.synchronize()
    skip_eq = _lanes_equal("B5b", {"t_found": (hit.t_found, plain.t_found), "t_dead": (hit.t_dead, plain.t_dead)})
    few_eq = _lanes_equal("B5b (7x9 rays)", {"t_found": (few_hit.t_found, few_plain.t_found),
                                             "t_dead": (few_hit.t_dead, few_plain.t_dead)})
    check(tuple(few_hit.t_found.shape) == (7, 9), f"B5b's few rays: {tuple(few_hit.t_found.shape)}")
    ray_samples, ray_rounds = stats["ray_samples"], stats["ray_rounds"]
    found_equal_fixed = bool(torch.equal(hit.t_found, ff))
    accept_k = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    accept_f = ff < torch.clamp(fd, max=INF_T)
    accept_equal_fixed = bool(torch.equal(accept_k, accept_f))
    found_equal_accepted = bool(torch.equal(hit.t_found[accept_k], ff[accept_f])) and accept_equal_fixed
    # where an event differs from the fixed march's: the skip march stopped at its crossing (no death kept), or
    # at its death (the fixed march's later crossing is not accepted), or found no surface and its death is an
    # exit past the volume's face, later than the fixed march's
    step = kernels.f32(eng.trunc_dist * 0.8)
    k_dead = torch.round((hit.t_dead - RAY_MIN_M) / step)
    at = ray_start.v[:, None, None] + dirs.v * (RAY_MIN_M + (k_dead + 1.0) * step)
    g = torch.floor(at / eng.voxel_size)
    lim = torch.tensor(res, dtype=torch.float32, device=dev)[:, None, None]
    exits = ((g < 0) | (g >= lim)).any(dim=0)
    differ = (hit.t_dead != fd) | (hit.t_found != ff)
    stopped_at_crossing = (hit.t_found < INF_T) & (hit.t_dead >= INF_T) & (hit.t_found == ff)
    stopped_at_death = (hit.t_dead < INF_T) & (hit.t_dead == fd) & (hit.t_found >= INF_T) & (ff > fd)
    late_exit = (hit.t_found >= INF_T) & (ff >= INF_T) & exits & (hit.t_dead > fd)
    differs_as_explained = bool((~differ | stopped_at_crossing | stopped_at_death | late_exit).all())
    Hq, Wq = hit.t_found.shape
    tf, td = torch.empty_like(hit.t_found), torch.empty_like(hit.t_dead)
    f32 = kernels.f32
    margs = (*nb, q, kernels.march_steps(eng.trunc_dist), f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size),
             step, f32(bricks.BRICK * eng.voxel_size / (eng.trunc_dist * 0.8)), *kernels.camera_args(intr))

    def run_march():
        check(ext.march_skip(rows.value, dist, pose, tf, td, *margs, stream) == 0, "march_skip launch failed")

    m_ms = time_ms(run_march, 50)
    m_cold = time_cold_ms(run_march, 30)
    m_plain = time_ms(lambda: raycast.march_skip_plain(ray_start, dirs.v, eng, packed_read, res), 3)
    # two times out a ray, the pose; ~60 operations to make a ray, ~25 a sample (this run's samples)
    m_bound = bound_ms(Hq * Wq * 8 + 192, Hq * Wq * 60 + stats["samples"] * 25)
    emit("B5a skip_field", bricks=n, distance_equal_on_every_brick=dist_equal, distance_histogram=histogram,
         ms=f_ms, cold_ms=f_cold, plain_ms=f_plain, bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it")
    emit("B5b march_skip", shape=[Hq, Wq], **skip_eq, odd_shape=dict(shape=[7, 9], **few_eq), lanes=lanes,
         longest_ray_samples=int(ray_samples.max()), mean_ray_samples=float(ray_samples.double().mean()),
         longest_ray_rounds=int(ray_rounds.max()), mean_ray_rounds=float(ray_rounds.double().mean()),
         accepted_rays_equal_to_fixed_march=accept_equal_fixed,
         t_found_equal_to_fixed_march_on_accepted_rays=found_equal_accepted,
         t_found_equal_to_fixed_march_everywhere=found_equal_fixed,
         rays_with_an_event_differing_from_fixed_march=int(differ.sum()),
         of_which_stopped_at_crossing=int((differ & stopped_at_crossing).sum()),
         of_which_stopped_at_death=int((differ & stopped_at_death).sum()),
         of_which_exit_past_the_face=int((differ & late_exit).sum()), differences_explained=differs_as_explained,
         hit_fraction=float(accept_k.float().mean()), samples=stats["samples"],
         samples_fixed_march=Hq * Wq * (kernels.march_steps(eng.trunc_dist) + 1), ms=m_ms, cold_ms=m_cold,
         plain_ms=m_plain, bound_ms=m_bound[0], bound_by=m_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it")
    check(dist_equal, "B5a's distances differ from brick_distance_rows")
    check(accept_equal_fixed and found_equal_accepted and differs_as_explained,
          f"B5b against the plain fixed march: accepted rays equal {accept_equal_fixed}, t_found equal on them "
          f"{found_equal_accepted}, other differences explained {differs_as_explained}")
    check(float(accept_k.float().mean()) > 0.5, "B5b: surfaces on fewer than half of the rays")
    return {
        "skip_field": dict(max_abs_err=0.0, ms=f_ms, cold_ms=f_cold, plain_ms=f_plain, bound_ms=f_bound[0],
                           bound_by=f_bound[1]),
        "march_skip": dict(max_abs_err=max(skip_eq["max_abs_err"], few_eq["max_abs_err"]), ms=m_ms, cold_ms=m_cold,
                           plain_ms=m_plain, bound_ms=m_bound[0], bound_by=m_bound[1],
                           longest_ray_rounds=int(ray_rounds.max())),
    }


def _compare(tag, pairs, **fields):
    """Emit and return (all NaN masks equal, worst equal fraction, worst ulp, max abs error)."""
    eq = min(frac_equal(a, b) for a, b in pairs)
    ulp = max(max_ulp(a, b) for a, b in pairs)
    nans = all(same_nans(a, b) for a, b in pairs)
    err = max(max_abs(a, b) for a, b in pairs)
    emit(tag, frac_equal=eq, max_ulp=ulp, nan_masks_equal=nans, max_abs_err=err, **fields)
    return nans, eq, ulp, err


def phase_maps(ctx):
    """K6, K7 and K8 against their plain versions at every level shape of
    both main-path configurations, each held level by level and bit-equal
    (each one launch for the whole pyramid; K6 and K7 also at two shapes
    whose halvings are odd, K6 with one coarser level only). The table rows
    carry the times at the largest shape, of the whole pyramid."""
    import torch.nn.functional as F

    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.models.kinfu import model_map_pyramid, resize_model_maps
    from xslam_tpu_torch.ops import kernels, preprocess

    cfg, dev = ctx["config"], ctx["device"]
    rows = {}

    # K7 on frame 4's bilateral output (and on two crops whose halvings are odd), both coarser levels in one
    # launch against the plain chain; then K8 on every level of the 480x640 pyramid in one launch
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    frame = kernels.bilateral_filter(torch.as_tensor(ctx["depths"][4], device=dev))
    levels = cfg.num_levels
    for H, W in ((480, 640), (478, 638), (477, 637)):
        src = frame[:H, :W].contiguous()
        pyramid = kernels.depth_pyramid(src, levels)
        plain = [src]
        for _ in range(1, levels):
            plain.append(preprocess.pyr_down(plain[-1]))
        torch.cuda.synchronize()
        equal = [bool(torch.equal(a, b)) for a, b in zip(pyramid[1:], plain[1:])]
        # the kernel timed from prepared arguments (the wrapper beside it)
        outs = [torch.empty((H >> level, W >> level), dtype=torch.float32, device=dev) for level in (1, 2)]

        def launch_k7(src=src, outs=outs):
            err_code = ext.depth_pyramid(src, outs[0], outs[1], levels, stream)
            check(err_code == 0, f"depth_pyramid launch failed: cudaError {err_code}")

        ms = time_ms(launch_k7, 100)
        wrapper_ms = time_ms(lambda src=src: kernels.depth_pyramid(src, levels), 100)
        plain_ms = time_ms(lambda src=src: preprocess.pyr_down(preprocess.pyr_down(src)), 5)
        out_px = sum(p.numel() for p in plain[1:])
        bms, by = bound_ms(H * W * 4 + out_px * 4, out_px * 25 * 5)
        _compare("K7 depth_pyramid, both coarser levels in one launch", list(zip(pyramid[1:], plain[1:])),
                 shape=[H, W], bit_equal=equal, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by, library_ms=None)
        check(all(equal), f"K7 is not bit-equal to its plain chain at {H}x{W}: levels 1, 2 {equal}")
        rows.setdefault("depth_pyramid", dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        if (H, W) == (480, 640):
            depths = pyramid
    intrs = [cfg.intrinsics.level(level) for level in range(cfg.num_levels)]
    vmaps, nmaps = kernels.vertex_normal_pyramid(intrs, depths)
    plain_maps = [preprocess.create_vmap(intr, d) for intr, d in zip(intrs, depths)]
    plain_maps = [(v, preprocess.create_nmap(v)) for v in plain_maps]
    torch.cuda.synchronize()
    # the kernel timed from prepared arguments: on a slow host the wrapper's own work (six views, the checks)
    # outlasted the held stream and its calls were timed at the host's pace; the wrapper is timed beside it
    offsets, size = kernels.map_pyramid_layout([tuple(d.shape) for d in depths])
    prepared = (depths, torch.empty(size, dtype=torch.float32, device=dev), [o for pair in offsets for o in pair],
                [c for intr in intrs for c in kernels.camera_args(intr)])
    ms = time_ms(lambda: kernels.launch("vertex_normal_maps", dev, *prepared), 100)
    wrapper_ms = time_ms(lambda: kernels.vertex_normal_pyramid(intrs, depths), 100)
    plain = time_ms(lambda: [preprocess.create_nmap(preprocess.create_vmap(i, d)) for i, d in zip(intrs, depths)], 5)
    pixels = sum(d.numel() for d in depths)
    bms, by = bound_ms(pixels * (4 + 24), pixels * 60)  # a depth in, two (3,) float32 entries out; ~60 operations
    worst_err = 0.0
    for level, (vmap, nmap, (pv, pn)) in enumerate(zip(vmaps, nmaps, plain_maps)):
        nans, eq, ulp, err = _compare("K8 vertex_normal_maps", [(vmap, pv), (nmap, pn)], level=level,
                                      shape=list(depths[level].shape),
                                      normal_valid_fraction=float((~torch.isnan(nmap[0])).float().mean()))
        check(nans and ulp == 0 and eq == 1.0, f"K8 is not bit-equal to its plain versions at level {level}")
        worst_err = max(worst_err, err)
    emit("K8 vertex_normal_maps, all levels in one launch", levels=len(depths), pixels=pixels, ms=ms,
         wrapper_ms=wrapper_ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)
    rows["vertex_normal_maps"] = dict(max_abs_err=worst_err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)

    # K6 on the model maps K5 rendered (both configurations), and on two crops of them whose halvings are odd
    # (478 x 638: the paired loads; 477 x 637: the single loads), every coarser level in one launch
    cases = [(f"model_map_level {L}", vmap, nmap) for L, (vmap, nmap) in ctx.pop("model_maps").items()]
    v0, n0 = cases[0][1], cases[0][2]
    for H, W in ((478, 638), (477, 637)):
        def crop(m, H=H, W=W):
            return CSFD(m.v[:, :H, :W].contiguous(), m.g[:, :H, :W].contiguous())
        cases.append((f"crop {H}x{W}", crop(v0), crop(n0)))
    levels = cfg.num_levels
    for name, vmap, nmap in cases:
        H, W = vmap.v.shape[-2:]
        vmaps, nmaps = model_map_pyramid(vmap, nmap, levels)
        plain_v, plain_n = [vmap], [nmap]
        for _ in range(1, levels):
            v, n = resize_model_maps(plain_v[-1], plain_n[-1])
            plain_v.append(v)
            plain_n.append(n)
        one_level = model_map_pyramid(vmap, nmap, 2) if name.startswith("model_map_level 0") else None
        torch.cuda.synchronize()
        # the kernel timed from prepared arguments (K8's lesson: a wrapper's host work can outlast the held
        # stream), the wrapper beside it
        shapes = [(H >> level, W >> level) for level in range(1, levels)]
        offsets, size = kernels.map_pyramid_layout(shapes, 4)
        prepared = (vmap.v, vmap.g, nmap.v, nmap.g, torch.empty(size, dtype=torch.float32, device=dev),
                    [o for level in offsets for o in level], levels, stream)

        def launch(prepared=prepared):
            err_code = ext.model_map_pyramid(*prepared)
            check(err_code == 0, f"model_map_pyramid launch failed: cudaError {err_code}")

        ms = time_ms(launch, 100)
        wrapper_ms = time_ms(lambda: model_map_pyramid(vmap, nmap, levels), 100)
        plain = time_ms(lambda: [resize_model_maps(*pair) for pair in zip(plain_v[:-1], plain_n[:-1])], 5)
        lib = time_ms(lambda: F.avg_pool2d(vmap.v, 2), 100)  # a yardstick: one of the twelve planes' means
        out_px = sum(h * w for h, w in shapes)
        bms, by = bound_ms(12 * H * W * 4 + 12 * out_px * 4, out_px * 120)
        worst = []
        for level in range(1, levels):
            pairs = [(vmaps[level].v, plain_v[level].v), (vmaps[level].g, plain_v[level].g),
                     (nmaps[level].v, plain_n[level].v), (nmaps[level].g, plain_n[level].g)]
            if one_level is not None and level == 1:
                pairs += [(one_level[0][1].v, plain_v[1].v), (one_level[0][1].g, plain_v[1].g),
                          (one_level[1][1].v, plain_n[1].v), (one_level[1][1].g, plain_n[1].g)]
            nans, eq, ulp, err = _compare("K6 resize_model_maps", pairs, case=name, level=level, shape=[H, W],
                                          out_shape=list(shapes[level - 1]))
            check(nans and ulp == 0 and eq == 1.0,
                  f"K6 is not bit-equal to its plain versions ({name}, level {level}): equal {eq}, ulp {ulp}")
            worst.append(err)
        emit("K6 resize_model_maps, all coarser levels in one launch", case=name, shape=[H, W], levels=levels,
             ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
             library_note="torch.nn.functional.avg_pool2d of the vertex map's value lane alone, level 1 only")
        rows.setdefault("resize_model_maps", dict(max_abs_err=max(worst), ms=ms, plain_ms=plain, bound_ms=bms,
                                                  bound_by=by, library_ms=lib))
    return rows


def _icp_inputs(ctx, L: int):
    """Inputs of K4 as the main path gives them at ``model_map_level=L``:
    model maps raycast from the fused volume at frame 3's pose (seeded
    derivative lane) with their pyramid, frame 4's current maps, and the
    ICP's starting pose (the previous frame's)."""
    from xslam_tpu_torch.csfd.single import lift
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.models.kinfu import model_map_pyramid
    from xslam_tpu_torch.ops import kernels, raycast

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    _, c2v = _v2c(ctx, np.linalg.inv(ctx["gt"][0]) @ ctx["gt"][3], np.random.default_rng(2))
    v2w = se3.inverse(lift(torch.as_tensor(np.asarray(cfg.world2volume, np.float32), device=dev)))
    c2w = se3.matmul(v2w, c2v)
    w2c = se3.inverse(c2w)
    vmap0, nmap0 = raycast.raycast(
        ctx["volume"], se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w),
        intr.level(L), eng, normals_mode=cfg.raycast_normals, march_mode=cfg.raycast_march,
        packed_taps=cfg.raycast_packed_taps,
    )
    vprev, nprev = model_map_pyramid(vmap0, nmap0, cfg.num_levels)
    depths = kernels.depth_pyramid(kernels.bilateral_filter(torch.as_tensor(ctx["depths"][4], device=dev)),
                                   cfg.num_levels)
    vcurr, ncurr = kernels.vertex_normal_pyramid([intr.level(i) for i in range(cfg.num_levels)], depths)
    pose = dict(r_curr=se3.rotation(c2w), t_curr=se3.translation(c2w), r_prev_inv=se3.rotation(w2c),
                t_prev=se3.translation(c2w))
    return vprev, nprev, vcurr, ncurr, pose


def _system_err(a, b) -> float:
    """Largest |kernel - plain| over A and b, both lanes, relative to the
    lane's largest entry."""
    worst = 0.0
    for name in ("A", "b"):
        for lane in ("v", "g"):
            x, y = getattr(getattr(a, name), lane), getattr(getattr(b, name), lane)
            worst = max(worst, float((x - y).abs().max() / y.abs().max()))
    return worst


class _K4Launch:
    """``icp_system`` launched from prepared arguments, as the engine's loop
    does it: no packing, no allocation. ``blocks`` overrides the grid."""

    def __init__(self, ctx, lintr, vcurr, ncurr, vprev, nprev, pose, assoc):
        from xslam_tpu_torch.ops import icp, kernels

        cfg, dev = ctx["config"], ctx["device"]
        self.ext = kernels.build_kernels()
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.maps = (vcurr, ncurr, icp.pack_model_rows(vprev, nprev), assoc)
        self.pose = icp.pack_pose(pose["r_curr"], pose["t_curr"], pose["r_prev_inv"], pose["t_prev"])
        self.partials = torch.empty((4 * icp.ICP_MAX_BLOCKS, icp.ICP_SUMS), dtype=torch.float64, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.out = torch.empty(84, dtype=torch.float32, device=dev)
        self.count = torch.empty((), dtype=torch.int32, device=dev)
        self.tail = (torch.empty(icp.POSE_FLOATS, dtype=torch.float32, device=dev),
                     torch.empty(12, dtype=torch.float32, device=dev), torch.zeros(2, dtype=torch.int32, device=dev))
        self.blocks = icp.icp_blocks(vcurr[0].numel())
        self.consts = [int(n) for n in vprev.v.shape[-2:]] + [
            kernels.f32(x) for x in (lintr.fx, lintr.fy, lintr.cx, lintr.cy, cfg.dist_thres, cfg.angle_thres_sine)]

    def __call__(self, tail: bool = False, blocks=None, maps=None, assoc_out=None):
        err_code = self.ext.icp_system(
            *(maps or self.maps), assoc_out, self.pose, self.partials, self.ticket, blocks or self.blocks, self.out,
            self.count, *(self.tail if tail else (None, None, None)), 0.0, True, *self.consts, self.stream)
        check(err_code == 0, f"icp_system launch failed: cudaError {err_code}")


def _residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """Relative residual of a solve, ``|A x - b| / (|A| |x| + |b|)``, in double."""
    A, x, b = A.double(), x.double(), b.double()
    return float(torch.linalg.norm(A @ x - b) / (torch.linalg.norm(A) * torch.linalg.norm(x) + torch.linalg.norm(b)))


def _check_tail(step, ref, tag: str) -> dict:
    """K4's tail against ``icp_step_plain`` fed the kernel's own ``A``, ``b``.

    Tolerances: the kernel's LU and the library's pivot alike but round in
    another order, and the ICP matrix is ill-conditioned (rotations against
    translations), so ``x`` is held within rtol 1e-3 (atol 1e-6; the
    derivative lane within 1e-3 of its largest entry), as the CPU tests hold
    the JAX solve against PyTorch's, and the kernel's relative residual
    within 4 times the plain one's (plus 1e-6). The pose follows ``x``
    (|x| ~ 1e-2): value lane within 2e-5, derivative lane within 1e-3 of its
    largest entry. The flags must be equal."""
    A, b = step.system.A, step.system.b
    res_k, res_p = _residual(A.v, step.x.v, b.v), _residual(A.v, ref.x.v, b.v)
    rhs = b.g - A.g @ ref.x.v
    res_kg, res_pg = _residual(A.v, step.x.g, b.g - A.g @ step.x.v), _residual(A.v, ref.x.g, rhs)
    x_err = float((step.x.v - ref.x.v).abs().max())
    g_scale = float(ref.x.g.abs().max())
    xg_err = float((step.x.g - ref.x.g).abs().max()) / max(g_scale, 1e-30)
    pose_err = max(max_abs(step.r_curr.v, ref.r_curr.v), max_abs(step.t_curr.v, ref.t_curr.v))
    pg_scale = max(1.0, float(ref.r_curr.g.abs().max()), float(ref.t_curr.g.abs().max()))
    pose_g_err = max(max_abs(step.r_curr.g, ref.r_curr.g), max_abs(step.t_curr.g, ref.t_curr.g)) / pg_scale
    check(bool(step.ok) == bool(ref.ok), f"K4's tail flag {bool(step.ok)} against plain {bool(ref.ok)} ({tag})")
    check(bool(torch.allclose(step.x.v, ref.x.v, rtol=1e-3, atol=1e-6)), f"K4's tail x.v off by {x_err} ({tag})")
    check(bool(torch.allclose(step.x.g, ref.x.g, rtol=1e-3, atol=1e-3 * g_scale)),
          f"K4's tail x.g off by {xg_err} of its largest entry ({tag})")
    check(res_k <= 4 * res_p + 1e-6 and res_kg <= 4 * res_pg + 1e-6,
          f"K4's tail residuals {res_k}, {res_kg} against plain {res_p}, {res_pg} ({tag})")
    check(pose_err <= 2e-5 and pose_g_err <= 1e-3, f"K4's tail pose off by {pose_err}, {pose_g_err} ({tag})")
    return dict(tail_ok=bool(step.ok), tail_x_abs_err=x_err, tail_xg_rel_err=xg_err, tail_pose_abs_err=pose_err,
                tail_pose_g_rel_err=pose_g_err, tail_residual=res_k, plain_residual=res_p,
                tail_residual_g=res_kg, plain_residual_g=res_pg)


def _same_step(a, b) -> bool:
    pairs = ((a.r_curr, b.r_curr), (a.t_curr, b.t_curr), (a.x, b.x), (a.system.A, b.system.A), (a.system.b, b.system.b))
    return all(bool(torch.equal(x.v, y.v)) and bool(torch.equal(x.g, y.g)) for x, y in pairs) \
        and bool(a.ok) == bool(b.ok)


def _check_fold(ctx, lintr, vcurr, ncurr, vprev, nprev, pose, index, where: str) -> dict:
    """The association folded into a level's first ``icp_system`` launch: the
    index map it writes equals ``icp_associate``'s ``index`` at every pixel
    with a current normal and is -1 elsewhere, and the launch's A, b, inlier
    count, pose, x and flags equal those of the launch that reads ``index``
    instead, bit for bit. Returns the three first-iteration times (with the
    tail): projecting, projecting and storing the index, reading it."""
    project = _K4Launch(ctx, lintr, vcurr, ncurr, vprev, nprev, pose, None)
    cached = _K4Launch(ctx, lintr, vcurr, ncurr, vprev, nprev, pose, index)
    folded = torch.full_like(index, -7)
    project(tail=True, assoc_out=folded)
    cached(tail=True)
    torch.cuda.synchronize()
    has_normal = ~torch.isnan(ncurr[0])
    index_equal = bool(torch.equal(folded[has_normal], index[has_normal]))
    elsewhere = bool((folded[~has_normal] == -1).all())
    outputs = [(project.out, cached.out), (project.count, cached.count)] + list(zip(project.tail, cached.tail))
    same = all(bool(torch.equal(a, b)) for a, b in outputs)
    check(index_equal and elsewhere, f"the folded association differs from icp_associate's ({where}): equal where "
                                     f"the normal is a number {index_equal}, -1 elsewhere {elsewhere}")
    check(same, f"the folded first launch's system, pose or flags differ from the cached-index launch's ({where})")
    return dict(folded_index_equal=index_equal, folded_minus_one_without_normal=elsewhere, folded_system_equal=same,
                first_iteration_ms=time_ms(lambda: project(tail=True), 200),
                first_iteration_folded_ms=time_ms(lambda: project(tail=True, assoc_out=folded), 200),
                cached_iteration_ms=time_ms(lambda: cached(tail=True), 200))


def phase_icp(ctx):
    """K4 against its plain versions at the three level shapes of both
    main-path configurations, with and without the cached association (made
    at the starting pose, used there and at a moved pose): without the tail
    against ``build_system_plain``, with it against ``icp_step_plain`` on the
    kernel's own system, each twice for equal bits; a damped step; a
    degenerate step (NaN model maps) that must freeze the pose. Times, a
    sweep of the grid and runs with parts of the work switched off by their
    inputs, at ``model_map_level=0``."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.ops import icp, kernels

    cfg, dev = ctx["config"], ctx["device"]
    intr = cfg.intrinsics
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    worst_err, worst_inl, worst_idx, abs_err, fold_ms = 0.0, 0.0, 1.0, 0.0, 0.0
    table, assoc_row = [], None
    for L in (0, 1):
        vprev, nprev, vcurr, ncurr, pose = _icp_inputs(ctx, L)
        moved = dict(pose, t_curr=CSFD(pose["t_curr"].v + torch.tensor([2e-3, -1e-3, 1.5e-3], device=dev),
                                       pose["t_curr"].g))
        for level in reversed(range(cfg.num_levels)):
            lintr = intr.level(level + L)
            prev_shape = tuple(vprev[level].v.shape[-2:])

            def args(p, level=level, lintr=lintr):
                return (p["r_curr"], p["t_curr"], vcurr[level], ncurr[level], p["r_prev_inv"], p["t_prev"], lintr,
                        vprev[level], nprev[level], cfg.dist_thres, cfg.angle_thres_sine)

            index = icp.associate_index(pose["r_curr"], pose["t_curr"], vcurr[level], pose["r_prev_inv"],
                                        pose["t_prev"], lintr, prev_shape)
            index_plain = icp.associate_index_plain(pose["r_curr"], pose["t_curr"], vcurr[level],
                                                    pose["r_prev_inv"], pose["t_prev"], lintr, prev_shape)
            idx_eq = float((index == index_plain).float().mean())
            worst_idx = min(worst_idx, idx_eq)
            fold = _check_fold(ctx, lintr, vcurr[level], ncurr[level], vprev[level], nprev[level], pose, index,
                               f"L={L}, level {level}")
            emit("K4 icp_system, association folded into the first launch", model_map_level=L, level=level,
                 curr_shape=list(vcurr[level].shape[1:]), prev_shape=list(prev_shape), **fold,
                 index_store_ms=fold["first_iteration_folded_ms"] - fold["first_iteration_ms"])
            if L == 1:  # the fixed setting's levels: what the fold adds to a frame there
                fold_ms += fold["first_iteration_folded_ms"] - fold["first_iteration_ms"]
            cases = (("projected", pose, None, None), ("cached", pose, index, index_plain),
                     ("cached, moved pose", moved, index, index_plain))
            for tag, p, a_k, a_p in cases:
                where = f"L={L}, level {level}, {tag}"
                k = icp.build_system(*args(p), assoc=a_k)
                k2 = icp.build_system(*args(p), assoc=a_k)
                ref = icp.build_system_plain(*args(p), assoc=a_p)
                torch.cuda.synchronize()
                same_bits = all(bool(torch.equal(x, y)) for x, y in
                                ((k.A.v, k2.A.v), (k.A.g, k2.A.g), (k.b.v, k2.b.v), (k.b.g, k2.b.g)))
                check(same_bits, f"K4 gave other bits on a second run ({where})")
                for i in range(6):
                    check(bool(torch.equal(k.A.v[i], k.A.v[:, i])), "K4's A is not symmetric")
                err = _system_err(k, ref)
                n_k, n_p = int(k.inlier_count), int(ref.inlier_count)
                inl = abs(n_k - n_p) / max(1, n_p)
                worst_err, worst_inl = max(worst_err, err), max(worst_inl, inl)
                row = dict(model_map_level=L, level=level, case=tag, curr_shape=list(vcurr[level].shape[1:]),
                           prev_shape=list(prev_shape), inliers=n_k, inliers_plain=n_p, rel_err=err,
                           index_frac_equal=idx_eq)

                # the whole iteration: the same system, then the tail against the plain step on it
                step = icp.icp_step(*args(p), damping=cfg.icp_damping, assoc=a_k)
                step2 = icp.icp_step(*args(p), damping=cfg.icp_damping, assoc=a_k)
                torch.cuda.synchronize()
                check(_same_step(step, step2), f"K4 with its tail gave other bits on a second run ({where})")
                check(bool(torch.equal(step.system.A.v, k.A.v)) and bool(torch.equal(step.system.b.g, k.b.g))
                      and int(step.system.inlier_count) == n_k, f"K4's system differs with and without the tail ({where})")
                plain_step = icp.icp_step_plain(step.system, p["r_curr"], p["t_curr"], cfg.icp_damping)
                check(bool(step.ok), f"K4's tail rejected a good step ({where})")
                row.update(_check_tail(step, plain_step, where))

                if L == 0 and tag != "cached, moved pose":
                    # the kernel alone, from prepared arguments, without and with its tail; the
                    # wrapper, which also packs the pose and the model's rows and allocates
                    launch = _K4Launch(ctx, lintr, vcurr[level], ncurr[level], vprev[level], nprev[level], p, a_k)
                    ms = time_ms(launch, 200)
                    check(bool(torch.equal(launch.out[:36].view(6, 6), k.A.v)), "K4 timed launch differs from the wrapper's")
                    tail_ms = time_ms(lambda: launch(tail=True), 200)
                    wrapper_ms = time_ms(lambda: icp.build_system(*args(p), assoc=a_k), 50)
                    plain = time_ms(lambda: icp.build_system_plain(*args(p), assoc=a_p), 3)
                    plain_step_ms = time_ms(lambda: icp.icp_step_plain(step.system, p["r_curr"], p["t_curr"], 0.0), 3)
                    # What the kernel needs (csrc/icp.cu's header): 72 B per pixel, 4 B
                    # more where the index is cached, the pose in, 85 numbers out; 36
                    # operations per pixel with a normal to move the vertex and 31 to
                    # project it (not where cached), 10 for the distance gate of a pixel
                    # with a target, 270 for an inlier's angle gate, row and sums.
                    # Pixels that pass the distance gate and fail the angle gate are
                    # not counted, so this is a lower bound.
                    n = vcurr[level][0].numel()
                    has_normal = ~torch.isnan(ncurr[level][0])
                    n_normal = int(has_normal.sum())
                    target = index_plain.long().clamp(min=0)
                    n_target = int((has_normal & (index_plain >= 0)
                                    & ~torch.isnan(nprev[level].v[0].reshape(-1)[target])).sum())
                    n_bytes = n * (72 + (4 if a_k is not None else 0)) + 36 * 4 + 85 * 4
                    n_ops = n_normal * (36 + (31 if a_k is None else 0)) + n_target * 10 + n_k * 270
                    bms, by = bound_ms(n_bytes, n_ops)
                    row.update(ms=ms, tail_ms=tail_ms, wrapper_ms=wrapper_ms, plain_ms=plain,
                               plain_step_ms=plain_step_ms, bound_ms=bms, bound_by=by, blocks=launch.blocks)
                    if tag == "projected":
                        # where the time goes: other grids; no current normal (every pixel leaves at
                        # its first gate: the launch, the reductions and the tail are left); no model
                        # (every pixel moves, projects and fetches a row, none is added)
                        sweep = {}
                        for blocks in (16, 33, 66, 132, 198, 264, 396, 528, 1056):
                            if blocks * 32 < 2 * n:  # a grid with pixels for most of its blocks
                                sweep[blocks] = [time_ms(lambda: launch(blocks=blocks), 200),
                                                 time_ms(lambda: launch(tail=True, blocks=blocks), 200)]
                        no_normal = (launch.maps[0], torch.full_like(ncurr[level], torch.nan)) + launch.maps[2:]
                        no_model = launch.maps[:2] + (torch.full_like(launch.maps[2], torch.nan), launch.maps[3])
                        row.update(grid_sweep_ms_without_and_with_tail=sweep,
                                   no_normal_ms=[time_ms(lambda: launch(maps=no_normal), 200),
                                                 time_ms(lambda: launch(tail=True, maps=no_normal), 200)],
                                   no_model_ms=time_ms(lambda: launch(maps=no_model), 200))
                        launch()
                        check(bool(torch.equal(launch.out[:36].view(6, 6), k.A.v)), "K4's grid sweep left its scratch changed")
                    if level == 0 and tag == "projected":
                        abs_err = max(float((k.A.v - ref.A.v).abs().max()), float((k.b.v - ref.b.v).abs().max()))
                        table = dict(max_abs_err=abs_err, ms=ms, tail_ms=tail_ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by)
                emit("K4 icp_system", **row)
            if L == 0:
                args_a = (pose["r_curr"], pose["t_curr"], vcurr[level], pose["r_prev_inv"], pose["t_prev"], lintr,
                          prev_shape)
                packed = icp.pack_pose(pose["r_curr"], pose["t_curr"], pose["r_prev_inv"], pose["t_prev"])
                out_idx = torch.empty_like(index)
                consts = [kernels.f32(x) for x in (lintr.fx, lintr.fy, lintr.cx, lintr.cy)]

                def launch_a():
                    err_code = ext.icp_associate(vcurr[level], packed, out_idx, *prev_shape, *consts, stream)
                    check(err_code == 0, f"icp_associate launch failed: cudaError {err_code}")

                ms = time_ms(launch_a, 200)
                plain = time_ms(lambda: icp.associate_index_plain(*args_a), 3)
                n = index.numel()
                bms, by = bound_ms(n * (12 + 4) + 36 * 4, n * 67)
                emit("K4 icp_associate", level=level, shape=list(index.shape), index_frac_equal=idx_eq, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by)
                if level == 0:
                    assoc_row = dict(max_abs_err=float((index - index_plain).abs().max()), ms=ms, plain_ms=plain,
                                     bound_ms=bms, bound_by=by)
        if L == 0:
            # a damped step, and a step with nothing to align to (frame 0 tracks against NaN maps)
            damped = icp.icp_step(*args(pose, 0, intr.level(0)), damping=1e-3)
            row = _check_tail(damped, icp.icp_step_plain(damped.system, pose["r_curr"], pose["t_curr"], 1e-3),
                              "damped")
            undamped = icp.icp_step(*args(pose, 0, intr.level(0)))
            check(not bool(torch.equal(damped.x.v, undamped.x.v)), "K4's tail ignored the damping")
            emit("K4 tail, damped", damping=1e-3, **row)
            nan_map = CSFD(torch.full_like(vprev[0].v, torch.nan), torch.zeros_like(vprev[0].g))
            frozen = icp.icp_step(pose["r_curr"], pose["t_curr"], vcurr[0], ncurr[0], pose["r_prev_inv"],
                                  pose["t_prev"], intr.level(0), nan_map, nan_map, cfg.dist_thres, cfg.angle_thres_sine)
            torch.cuda.synchronize()
            kept = all(bool(torch.equal(x, y)) for x, y in
                       ((frozen.r_curr.v, pose["r_curr"].v), (frozen.r_curr.g, pose["r_curr"].g),
                        (frozen.t_curr.v, pose["t_curr"].v), (frozen.t_curr.g, pose["t_curr"].g)))
            emit("K4 tail, degenerate", ok=bool(frozen.ok), pose_kept=kept, inliers=int(frozen.system.inlier_count),
                 x_abs_max=float(frozen.x.v.abs().max()))
            check(not bool(frozen.ok) and kept and int(frozen.system.inlier_count) == 0
                  and float(frozen.x.v.abs().max()) == 0.0 and float(frozen.x.g.abs().max()) == 0.0,
                  "K4's tail did not freeze the pose on a system without correspondences")
    emit("K4 summary", worst_rel_err=worst_err, worst_inlier_rel_diff=worst_inl, worst_index_frac_equal=worst_idx,
         library_ms=None, library_note="no single PyTorch call computes it")
    check(worst_err <= 1e-4, f"K4 disagrees with its plain version: A/b {worst_err} of a lane's largest entry")
    check(worst_inl <= 1e-3, f"K4's inlier count differs from the plain version's by {worst_inl}")
    check(worst_idx >= 0.9999, f"K4's association differs from the plain version's: equal on {worst_idx}")
    assoc_row.update(folded_into="icp_system", fold_ms_per_frame_fixed_setting=fold_ms)
    ctx["icp_associate"] = assoc_row
    return table


def phase_probes(ctx):
    """The five gather probes, bit-equal to their plain versions, and the
    probe path itself: the entry point's ``run`` on the card."""
    from xslam_tpu_torch.apps import probe_gather as pg
    from xslam_tpu_torch.ops import kernels

    dev = ctx["device"]
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ta, ia = pg.inputs_a(dev)
    tb, ib = pg.inputs_b(dev)
    (tc,), (td,) = pg.inputs_c(dev), pg.inputs_d(dev)
    te, ie = pg.inputs_e(dev)
    n_e = ie.numel()
    # name: (wrapper call, plain call, prepared launch, bytes needed, operations, library call)
    f32 = dict(dtype=torch.float32, device=dev)
    oa, ob, oc, od = (torch.empty(s, **f32) for s in ((8, 128), (8, 128), (1, 1), (8, 128)))
    oe = torch.empty_like(ie)
    ia64, ib64 = ia.long(), ib.long()
    probes = {
        "probe_a": (lambda: pg.probe_a(ta, ia), lambda: pg.probe_a_plain(ta, ia),
                    lambda: ext.probe_a(ta, ia, oa, stream), 1024 * 12, 1024 * 2,
                    lambda: torch.take_along_dim(ta, ia64, 0)),
        "probe_b": (lambda: pg.probe_b(tb, ib), lambda: pg.probe_b_plain(tb, ib),
                    lambda: ext.probe_b(tb, ib, ob, stream), 1024 * 12, 1024 * 2,
                    lambda: torch.take_along_dim(tb, ib64, 1)),
        "probe_c": (lambda: pg.probe_c(tc), lambda: pg.probe_c_plain(tc),
                    lambda: ext.probe_c(tc, oc, stream), 17 * 4, 16 * 3, None),
        "probe_d": (lambda: pg.probe_d(td), lambda: pg.probe_d_plain(td),
                    lambda: ext.probe_d(td, od, stream), 1024 * 4 * 9, 1024 * 8 * 3, None),
        # PROBE_E_STEPS steps: each ray reads one 4-byte element per step, then its start and result
        "probe_e": (lambda: pg.probe_e(te, ie, PROBE_E_STEPS), lambda: pg.probe_e_plain(te, ie, PROBE_E_STEPS),
                    lambda: ext.probe_e(te, ie, oe, PROBE_E_STEPS, stream), n_e * (PROBE_E_STEPS * 4 + 8),
                    n_e * PROBE_E_STEPS * 5, None),
    }
    rows = {}
    for name, (wrapper, plain_fn, prepared, n_bytes, n_ops, library) in probes.items():
        out, ref = wrapper(), plain_fn()
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))

        def launch(prepared=prepared, name=name):
            err_code = prepared()
            check(err_code == 0, f"{name} launch failed: cudaError {err_code}")

        ms = time_ms(launch, 200)
        plain = time_ms(plain_fn, 5)
        lib = time_ms(library, 50) if library is not None else None
        if library is not None:
            check(bool(torch.equal(library(), out)), f"{name} differs from torch.take_along_dim")
        bms, by = bound_ms(n_bytes, n_ops)
        err = float((out.double() - ref.double()).abs().max())
        emit(name, shape=list(out.shape), bit_equal=equal, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
             bound_by=by, library_ms=lib,
             library_note="torch.take_along_dim" if library is not None else "no single PyTorch call computes it")
        check(equal, f"{name} is not bit-equal to its plain version")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)

    # the probe path, through its entry point
    kernels.reset_launch_counts()
    results = pg.run(dev)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    emit("probe path", kernels=counts, E=results["E_bench"], canary=results["canary"])
    check(results["canary"]["ok"] and "skipped" not in results["canary"], f"canary: {results['canary']}")
    check(results["E_bench"]["timed_on"] == "cuda" and results["E_bench"]["t64_ms"] > 0, f"E: {results['E_bench']}")
    for name in probes:
        check(counts[name] >= 1, f"the probe path never launched {name}: {counts}")
    check(counts["bilateral_filter"] >= 1, f"the canary never launched the bilateral kernel: {counts}")
    ctx["probe_counts"] = counts
    return rows


def _frame_record(prof) -> dict:
    """What a profiled frame ran: its device events in time order (the
    stages' own ranges aside), the positions of the ICP launches among them,
    the host's launch, copy and fill calls (each makes one device event, so
    the two counts agree unless the profiler lost events), and the launches
    of each stage."""
    from torch.autograd import DeviceType

    from xslam_tpu_torch.profile_step import HOST_LAUNCH_CALLS, STAGES, stage_launches

    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in STAGES),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in device]
    host_calls = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name.startswith(HOST_LAUNCH_CALLS))
    return dict(names=names, icp_at=[j for j, name in enumerate(names) if "icp_system_kernel" in name],
                host_calls=host_calls, stages=stage_launches(prof.events(), 1))


def _profiled(engine, state, depth):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, res = engine.process_frame(state, depth)
        engine.log_pose(res)  # as profile_step.py profiles a frame
        torch.cuda.synchronize()
    return state, res, prof


def _engine_run(cfg, ctx, n_frames: int, device_depth_at=None):
    """A second run of ``n_frames``, unprofiled: its ATE and its poses. Frame
    ``device_depth_at``, where given, is fed as a uint16 tensor uploaded to
    the card before the frame, not as a host array."""
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    engine = XSlamEngine(cfg, device=ctx["device"])
    state = engine.init_state()
    for i in range(n_frames):
        depth = ctx["depths"][i]
        if i == device_depth_at:
            depth = torch.as_tensor(np.asarray(depth, np.uint16)).to(ctx["device"])
            torch.cuda.synchronize()
        state, res = engine.process_frame(state, depth)
        engine.log_pose(res)
    return ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:n_frames])), engine.pose_log


def phase_main_path(ctx, tag: str = "main path"):
    """Drive the engine over the synthetic orbit: as ``configs/synthetic.yaml``
    says (association every ICP iteration, full-resolution model maps, dense
    fusion), with ``icp_fixed_assoc=True, model_map_level=1`` on fewer
    frames, with bench.py's fusion (brick, cap 2816, dense on overflow), or
    in bench.py's whole configuration (the brick layout, the temporal march,
    the ``reuse`` refine, screen normals), also with every frame taking the
    ``hier2`` refresh.

    The last frame runs under the profiler and is held to the frame's
    launches. The profiler sometimes loses device events, so its record is
    trusted only where its device events are as many as the host's launch
    calls; where they differ, one more frame is profiled, at most
    ``PROFILE_RETAKES`` times, and the run fails if no profiled frame gives a
    consistent record. Every attempt's two counts are printed."""
    import dataclasses

    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    cfg, n_frames = ctx["config"], N_FRAMES
    if tag == "main path, fixed association":
        cfg = dataclasses.replace(cfg, icp_fixed_assoc=True, model_map_level=1, end_frame=N_FRAMES_FIXED_ASSOC)
        n_frames = N_FRAMES_FIXED_ASSOC
    elif tag == "main path, brick fusion":
        cfg = dataclasses.replace(cfg, fusion_mode="brick", fusion_brick_cap=BRICK_CAP, fusion_overflow="dense",
                                  end_frame=N_FRAMES_BRICK)
        n_frames = N_FRAMES_BRICK
    elif tag == "main path, bench":
        n_frames = N_FRAMES_BENCH
        cfg = dataclasses.replace(cfg, **BENCH_OPTIONS, end_frame=n_frames)
    elif tag == "main path, bench refresh":
        n_frames = N_FRAMES_REFRESH
        cfg = dataclasses.replace(cfg, **BENCH_OPTIONS, raycast_temporal_min_coverage=REFRESH_COVERAGE,
                                  end_frame=n_frames)
    brick = cfg.fusion_mode == "brick"
    bench = cfg.volume_layout == "brick"
    refresh = bench and cfg.raycast_temporal_min_coverage > 1.0
    L = cfg.model_map_level
    engine = XSlamEngine(cfg, device=ctx["device"])
    state = engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, aligned, integrated, active, coverage = [], [], 0, [], []
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n_frames - 1:  # the last frame runs under the profiler and is left out of the times
            state, res, prof = _profiled(engine, state, ctx["depths"][i])
        else:
            state, res = engine.process_frame(state, ctx["depths"][i])
            engine.log_pose(res)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ok = bool(res.align_ok)
        aligned.append(ok)
        integrated += ok
        active.append(None if res.fusion_active is None else int(res.fusion_active))
        coverage.append(None if res.anchor_coverage is None else float(res.anchor_coverage))
    times = times[:-1]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:n_frames]))
    vmap, nmap = state.vmaps_prev[0], state.nmaps_prev[0]
    valid = ~torch.isnan(vmap.v[0]) & ~torch.isnan(nmap.v[0])
    valid_frac = float(valid.float().mean())
    finite = all(bool(torch.isfinite(x[:, valid]).all()) for x in (vmap.v, vmap.g, nmap.v, nmap.g))

    # the profiled frame's record, retaken on the next frames where the profiler lost events
    retakes = iter(range(n_frames, n_frames + PROFILE_RETAKES))

    def retake():
        nonlocal state
        state, _, retaken = _profiled(engine, state, ctx["depths"][next(retakes)])
        return _frame_record(retaken)

    rec, attempts = consistent_record(_frame_record(prof), retake)
    names, icp_at, host_calls, stages = rec["names"], rec["icp_at"], rec["host_calls"], rec["stages"]
    between = icp_interlopers(names, icp_at)
    # the bench run's second run takes one frame's depth already on the card: the same pose, bit for bit
    depth_at = DEVICE_DEPTH_FRAME if tag == "main path, bench" else None
    second_ate, second_poses = _engine_run(cfg, ctx, n_frames, depth_at) if bench else (None, None)
    device_depth_same = None if depth_at is None else (
        second_poses[depth_at].tobytes() == np.asarray(engine.pose_log[depth_at]).tobytes())

    steady = np.asarray(times[WARM_FRAMES:])
    emit(tag, config="configs/synthetic.yaml", icp_fixed_assoc=cfg.icp_fixed_assoc, model_map_level=L,
         frames=n_frames, depth=[cfg.depth_height, cfg.depth_width],
         volume=list(cfg.tsdf_size), mean_frame_ms=float(steady.mean()), p50_frame_ms=float(np.median(steady)),
         frame_ms=times, ate_m=ate, all_aligned=all(aligned), peak_mem_bytes=peak,
         model_map_valid_fraction=valid_frac, kernels=counts, device_launches_in_profiled_frame=len(names),
         host_launch_calls_in_profiled_frame=host_calls, profiled_frame_attempts=attempts,
         stage_launches_in_profiled_frame=stages,
         icp_launches_in_profiled_frame=len(icp_at), other_device_work_inside_icp_loop=between[:8],
         **(dict(fusion_mode="brick", cap=cfg.fusion_brick_cap, fusion_overflow=cfg.fusion_overflow,
                 active_bricks=active, max_active_bricks=max(active)) if brick else {}),
         **(dict(volume_layout="brick", raycast_march=cfg.raycast_march, raycast_refine=cfg.raycast_refine,
                 raycast_normals=cfg.raycast_normals, temporal_min_coverage=cfg.raycast_temporal_min_coverage,
                 anchor_coverage=coverage, refresh_frames=sum(c < cfg.raycast_temporal_min_coverage for c in coverage),
                 second_run_ate_m=second_ate) if bench else {}),
         **(dict(device_depth_frame=depth_at, device_depth_pose_equal=device_depth_same) if depth_at is not None
            else {}))
    check(all(aligned), f"frames failed to align: {aligned}")
    check(ate < 0.02, f"ATE {ate} m >= 0.02 m")
    check(tuple(vmap.v.shape) == (3, cfg.depth_height >> L, cfg.depth_width >> L) and finite and valid_frac > 0.5,
          f"model maps: shape {tuple(vmap.v.shape)}, finite {finite}, valid fraction {valid_frac}")
    # every frame tracks, frame 0 too (its estimate is then set aside), so
    # K4 runs once per ICP iteration of every frame; the association is
    # written by each level's first K4 launch and never launched on its own;
    # K6 makes every coarser level of the model maps in one launch a frame;
    # the dense layout raycasts with K3 and K5, the brick layout with B4 (and
    # on a refresh frame B5a, B5b and B4 once more), its screen normals B4n
    # in K6's launch (model_map_normals in place of resize_model_maps)
    iterations = sum(cfg.icp_iterations[: cfg.num_levels])
    want = {k: n_frames for k in ("bilateral_filter", "depth_pyramid", "vertex_normal_maps")}
    want.update(icp_system=iterations * n_frames, icp_associate=0, fuse_volume=0 if brick else integrated)
    want.update({k: integrated if brick else 0 for k in ("depth_mips", "classify_bricks", "fuse_bricks")})
    want.update({k: 0 if bench else n_frames for k in ("march_fixed", "raycast_refine")})
    want.update(window_march=(2 if refresh else 1) * n_frames if bench else 0,
                model_map_normals=n_frames if bench else 0, resize_model_maps=0 if bench else n_frames)
    want.update({k: n_frames if refresh else 0 for k in ("skip_field", "march_skip")})
    check(all(counts[k] == n for k, n in want.items()), f"launch counts {counts}, expected {want}")
    if brick:
        # the ACTIVE list never overflowed; with the dense layout the volume is dense fusion's bit for bit, so
        # the run is the first main path's to every digit
        check(all(a is not None and a <= cfg.fusion_brick_cap for a in active),
              f"brick fusion overflowed its cap {cfg.fusion_brick_cap}: ACTIVE bricks {active}")
    if bench:
        check(second_ate == ate, f"two runs of {tag} gave the ATEs {ate!r} and {second_ate!r} m")
        check(depth_at is None or device_depth_same,
              f"{tag}: frame {depth_at}'s pose from a depth on the card differs from the host depth's")
        check(all(c >= cfg.raycast_temporal_min_coverage for c in coverage) != refresh,
              f"{tag}: anchor coverage {coverage} against {cfg.raycast_temporal_min_coverage}")
    elif brick:
        check(ate == ctx["ate"], f"brick fusion's ATE {ate!r} m differs from dense fusion's {ctx['ate']!r} m")
    elif tag == "main path":
        ctx["ate"] = ate
    check_frame_record(rec, attempts, iterations, FRAME_LAUNCHES[tag])
    return counts


def consistent_record(record: dict, retake, retakes: int = PROFILE_RETAKES):
    """The first of ``record`` and up to ``retakes`` more (``retake()``
    profiles the next frame) whose device events are as many as the host's
    launch calls, else the last; and each attempt's two counts."""
    records = [record]
    while len(records[-1]["names"]) != records[-1]["host_calls"] and len(records) <= retakes:
        records.append(retake())
    attempts = [dict(device_launches=len(r["names"]), host_launch_calls=r["host_calls"]) for r in records]
    return records[-1], attempts


def icp_interlopers(names, icp_at) -> list:
    """The device work between a frame's first and last ICP launch."""
    loop = names[icp_at[0]: icp_at[-1] + 1] if icp_at else []
    return [name for name in loop if "icp_system_kernel" not in name]


def check_frame_record(rec: dict, attempts, iterations: int, want: int) -> None:
    """The profiled frame's checks: a consistent record (the profiler's
    device events trusted only where they are as many as the host's launch
    calls), one ICP launch an iteration with nothing else on the device
    between them, ``want`` launches in the frame, 3 in ``preprocess``."""
    names, icp_at, host_calls, stages = rec["names"], rec["icp_at"], rec["host_calls"], rec["stages"]
    check(len(names) == host_calls,
          f"no profiled frame gave a consistent record (device events, host launch calls): {attempts}")
    check(len(icp_at) > 0, f"the profiled frame shows no icp_system launch among {len(names)} device events")
    between = icp_interlopers(names, icp_at)
    # the loop on the card: one launch per iteration and nothing else on the device between them
    check(len(icp_at) == iterations and not between,
          f"the profiled frame ran {len(icp_at)} icp_system launches for {iterations} iterations, with other "
          f"device work between them: {between[:8]}")
    check(host_calls == want and stages.get("preprocess") == PREPROCESS_LAUNCHES,
          f"the profiled frame made {host_calls} launches ({want} expected; attempts {attempts}), "
          f"preprocess {stages.get('preprocess')} ({PREPROCESS_LAUNCHES} expected)")


def phase_main_path_fixed_assoc(ctx):
    return phase_main_path(ctx, "main path, fixed association")


def phase_main_path_brick(ctx):
    return phase_main_path(ctx, "main path, brick fusion")


def phase_main_path_bench(ctx):
    return phase_main_path(ctx, "main path, bench")


def phase_main_path_bench_refresh(ctx):
    return phase_main_path(ctx, "main path, bench refresh")


# ----------------------------------------------------------------------------
def _extract_bytes_ops(n_voxels: int, capacity: int, count: int):
    """B13's least work: both planes read once (8 B a voxel), the two buffers
    written once (24 B a row) and the count; ~10 operations an edge test
    (three a voxel) and ~300 a point's normal (six trilinears)."""
    return n_voxels * 8 + capacity * 24 + 4, n_voxels * 3 * 10 + count * 300


def _same_cloud(a, b) -> bool:
    return (int(a.count) == int(b.count) and bool(torch.equal(a.points, b.points))
            and bool(torch.equal(a.normals, b.normals)))


def phase_extract(ctx):
    """B13 against its plain version, bit for bit (count, points, normals,
    the zero rows past the count): on the smoke's fused 256^3 volume and on
    the dense twin of its brick rows (the layout's ``to_dense``, as
    ``engine.dense_volume`` makes it) and on a 201x203x205 crop of it (a
    ragged last tile; rows shorter than a round of B13's threads), at
    run_slam's capacity and at half the count (the overflow rows). Timed from
    prepared arguments, warm and cold."""
    from xslam_tpu_torch.ops import bricks, kernels
    from xslam_tpu_torch.ops.extract import extract_points, extract_points_plain, extract_scratch_ints
    from xslam_tpu_torch.ops.fusion import VolumeState

    eng, dev = ctx["engine_cfg"], ctx["device"]
    vol = ctx["volume"]
    twin = bricks.to_dense(bricks.from_dense(*vol), eng.resolution)
    crop = VolumeState(*(x[:201, :203, :205].contiguous() for x in vol))
    worst = 0.0
    for case, v in (("fused volume", vol), ("brick rows' dense twin", twin), ("crop 201x203x205", crop)):
        full = extract_points(v, eng, POINT_CAPACITY)
        n = int(full.count)
        for capacity in (POINT_CAPACITY, n // 2):
            k = full if capacity == POINT_CAPACITY else extract_points(v, eng, capacity)
            p = extract_points_plain(v, eng, capacity)
            torch.cuda.synchronize()
            equal = _same_cloud(k, p)
            err = max(max_abs(k.points, p.points), max_abs(k.normals, p.normals))
            worst = max(worst, err)
            zero_tail = not bool(k.points[int(k.count):].any()) and not bool(k.normals[int(k.count):].any())
            unit = float((torch.linalg.norm(k.normals[:int(k.count)], dim=1) - 1).abs().lt(1e-3).float().mean())
            emit("B13 extract_points", case=case, capacity=capacity, count=int(k.count), bit_equal=equal,
                 max_abs_err=err, zero_rows_past_count=zero_tail, unit_normal_fraction=unit)
            check(equal and zero_tail, f"B13 is not bit-equal to its plain version ({case}, capacity {capacity})")
            check(int(k.count) == min(n, capacity) and n > 1_000, f"B13 ({case}): count {int(k.count)} of {n}")
        check(_same_cloud(extract_points(v, eng, POINT_CAPACITY), full), f"B13 ({case}): a second launch differs")
    # the launch from prepared arguments, warm and cold, on the fused volume at run_slam's capacity
    X, Y, Z = vol.value.shape
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    points = torch.empty((POINT_CAPACITY, 3), dtype=torch.float32, device=dev)
    normals, count = torch.empty_like(points), torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(extract_scratch_ints(X * Y * Z), dtype=torch.int32, device=dev)
    args = (vol.value, vol.weight, scratch, points, normals, count, kernels.f32(eng.voxel_size),
            kernels.reciprocal_f32(eng.voxel_size), kernels.f32(0.5 * eng.voxel_size), stream)

    def launch():
        check(ext.extract_points(*args) == 0, "extract_points launch failed")

    ms, cold = time_ms(launch, 50), time_cold_ms(launch, 20)
    plain = time_ms(lambda: extract_points_plain(VolumeState(*vol), eng, POINT_CAPACITY), 3)
    n = int(count)
    bms, by = bound_ms(*_extract_bytes_ops(X * Y * Z, POINT_CAPACITY, n))
    # each of the launch's three kernels, by the profiler's device record over 20 launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
    split = {name: sum(e.device_time_total for e in prof.key_averages() if name in e.key) / 20 / 1e3
             for name in DEVICE_KERNELS["extract_points"]}
    emit("B13 extract_points timing", shape=[X, Y, Z], capacity=POINT_CAPACITY, count=n, ms=ms, cold_ms=cold,
         plain_ms=plain, bound_ms=bms, bound_by=by, bound_counts="planes once, buffers once, the edge tests and "
         "the normals' trilinears", kernel_ms=split, library_ms=None,
         library_note="no single PyTorch call computes it")
    return {"extract_points": dict(max_abs_err=worst, ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
                                   bound_by=by, kernel_ms=split, count=n, capacity=POINT_CAPACITY)}


def _realistic_run(tmp: str, config: str, fmt: str, n_frames: int, extra=()):
    """Render ``n_frames`` of the realistic dataset with the port's generator,
    then run ``run_slam.main`` on a copy of ``config`` that reads it, with the
    launch counts set to 0 just before: the run, its stdout, its counts."""
    import contextlib
    import io

    import yaml

    from xslam_tpu_torch import run_slam
    from xslam_tpu_torch.apps import make_realistic_dataset
    from xslam_tpu_torch.ops import kernels

    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_realistic_dataset.main([data, str(n_frames), "--format", fmt])
    render_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, config)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(dataset_dir=data, output_dir=out + "/", end_frame=n_frames)
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    stdout = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        run = run_slam.main([path, *extra])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    text = stdout.getvalue()
    slam = sorted(os.listdir(os.path.join(out, "slam")))
    gt = sorted(os.listdir(os.path.join(out, "gt")))
    info = dict(config=config, frames=n_frames, render_s=render_s, run_s=run_s, ate_m=run.ate,
                mean_frame_ms=float(text.split("mean frame time = ")[1].split(" ms")[0]),
                align_failed=text.count("align failed"), peak_mem_bytes=torch.cuda.max_memory_allocated(),
                pose_files=[len(slam), len(gt)], kernels=counts)
    check(slam == gt == [f"frame-{i:06d}.pose.txt" for i in range(n_frames)],
          f"{config}: pose files {len(slam)} / {len(gt)} for {n_frames} frames")
    check(run.ate < 0.02, f"{config}: ATE {run.ate} m >= 0.02 m")
    return run, text, counts, out, info


def phase_main_path_icl(ctx):
    """``run_slam.main`` on configs/ICL_realistic.yaml's configuration over 30
    frames the port's generator renders (PNGs through the port's own codec
    and ``ICLDataset``), with ``--mesh tetra``: every pose file, ATE < 0.02 m,
    B13 launched exactly once for ``draw_pcd``, ``pcd.ply`` read back with
    B13's count, the plain extraction of the final volume equal to B13's,
    ``mesh.ply`` with triangles (the mesher timed again with its peak
    memory), and a checkpoint after 15 frames, loaded and run to the end,
    giving the run's poses bit for bit."""
    import tempfile

    from xslam_tpu_torch.io.dataset import ICLDataset
    from xslam_tpu_torch.io.ply import read_ply
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops.extract import extract_mesh, extract_points, extract_points_plain
    from xslam_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        run, text, counts, out, info = _realistic_run(tmp, "configs/ICL_realistic.yaml", "icl", N_FRAMES_ICL,
                                                      ("--mesh", "tetra"))
        engine, state = run.engine, run.state
        n = int(text.split("exported ")[1].split(" points")[0])
        k = int(text.split(" tetra triangles")[0].split("exported ")[-1])
        mesh_s = float(text.split(" tetra triangles (")[1].split(" s)")[0])
        points, normals = read_ply(os.path.join(out, "pcd.ply"))
        with open(os.path.join(out, "mesh.ply")) as f:
            mesh_head = f.read(400)
        check(counts["extract_points"] == 1, f"the ICL run launched B13 {counts['extract_points']} times")
        check(len(points) == n > 5_000 and f"element face {k}\n" in mesh_head and k > 0,
              f"pcd.ply holds {len(points)} points for B13's {n}; mesh.ply's head {mesh_head[:200]!r} for {k}")
        iterations = sum(engine.config.icp_iterations[: engine.config.num_levels])
        for name, want in (("bilateral_filter", N_FRAMES_ICL), ("icp_system", iterations * N_FRAMES_ICL),
                           ("model_map_normals", N_FRAMES_ICL), ("window_march", N_FRAMES_ICL),
                           ("fuse_bricks", 1)):
            check(counts[name] >= want, f"the ICL run launched {name} {counts[name]} times ({want} at least)")

        # the final volume: B13 (a comparison launch, not counted) against the plain extraction
        dense = engine.dense_volume(state)
        kernel, plain = extract_points(dense, engine.vol_cfg, POINT_CAPACITY), extract_points_plain(
            dense, engine.vol_cfg, POINT_CAPACITY)
        same = _same_cloud(kernel, plain) and int(kernel.count) == n
        check(same, f"B13 on the run's final volume differs from the plain extraction (count {int(kernel.count)})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        mesh = extract_mesh(dense, engine.vol_cfg, capacity=2_000_000)
        again = int(mesh.count)
        mesh_again_s = time.perf_counter() - t0
        mesh_peak = torch.cuda.max_memory_allocated() - base
        check(again == k, f"the tetra mesh of the final volume has {again} triangles, run_slam wrote {k}")
        del mesh, kernel, plain

        # a checkpoint after CHECKPOINT_AT frames, loaded into a new engine and run to the end
        ds = ICLDataset(os.path.join(tmp, "data"), 0, N_FRAMES_ICL)
        first = XSlamEngine(engine.config, device=ctx["device"])
        s = first.init_state()
        for i in range(CHECKPOINT_AT):
            s, r = first.process_frame(s, ds.get_depth(i))
            first.log_pose(r)
        path = os.path.join(tmp, "checkpoint.npz")
        checkpoint.save_state(path, s, first.pose_log)
        resumed = XSlamEngine(engine.config, device=ctx["device"])
        s, resumed.pose_log = checkpoint.load_state(path, device=ctx["device"])
        for i in range(CHECKPOINT_AT, N_FRAMES_ICL):
            s, r = resumed.process_frame(s, ds.get_depth(i))
            resumed.log_pose(r)
        resume_same = len(resumed.pose_log) == N_FRAMES_ICL and all(
            a.tobytes() == b.tobytes() for a, b in zip(resumed.pose_log, engine.pose_log))
    emit("main path, ICL realistic", **info, points=n, unit_normal_fraction=float(
        (np.abs(np.linalg.norm(normals, axis=1) - 1) < 1e-3).mean()), b13_equals_plain_on_final_volume=same,
         mesh_triangles=k, mesh_s_in_run=mesh_s, mesh_s=mesh_again_s, mesh_peak_mem_bytes=mesh_peak,
         checkpoint_after_frames=CHECKPOINT_AT, resumed_poses_bit_equal=resume_same)
    check(resume_same, f"the run resumed from a checkpoint after {CHECKPOINT_AT} frames differs from the "
                       "uninterrupted run's poses")
    return counts


def phase_main_path_7scenes(ctx):
    """``run_slam.main`` on configs/7scenes_realistic.yaml's configuration over
    10 frames the port's generator renders (``SevenScenesDataset`` through
    its info file): every pose file and ATE < 0.02 m."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, _, counts, _, info = _realistic_run(tmp, "configs/7scenes_realistic.yaml", "7scenes", N_FRAMES_7SCENES)
    emit("main path, 7-Scenes realistic", **info)
    check(counts["bilateral_filter"] == N_FRAMES_7SCENES and counts["extract_points"] == 0,
          f"the 7-Scenes run's launches: {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import xslam_tpu_torch  # noqa: F401  (sets the float32 precision pins)
    from xslam_tpu_torch.io.config import load_config
    from xslam_tpu_torch.io.synthetic import SyntheticDataset
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(f"card: {card}", flush=True)
    print(f"pins: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    kernels.build_kernels()
    emit("build", seconds=time.perf_counter() - t0)

    config = load_config(os.path.join(ROOT, "configs", "synthetic.yaml"))
    config.end_frame = N_FRAMES
    n_depths = N_FRAMES + PROFILE_RETAKES  # a main path's frames and the frames a retaken profile takes
    ds = SyntheticDataset(n_frames=n_depths, intr=config.intrinsics)
    ctx = {
        "device": torch.device("cuda"),
        "config": config,
        "engine_cfg": XSlamEngine(config).vol_cfg,
        "depths": [ds.get_depth(i) for i in range(n_depths)],
        "gt": [ds.get_pose(i) for i in range(n_depths)],
    }

    results, failed = {}, []
    for name, phase in (("rounding", phase_rounding), ("bilateral_filter", phase_bilateral), ("fuse_volume", phase_fusion),
                        ("bricks", phase_bricks), ("march_fixed", phase_march), ("raycast_refine", phase_refine),
                        ("window", phase_window), ("normals", phase_normals), ("skip", phase_skip),
                        ("extract", phase_extract),
                        ("maps", phase_maps), ("icp_system", phase_icp), ("probes", phase_probes),
                        ("main path", phase_main_path),
                        ("main path, fixed association", phase_main_path_fixed_assoc),
                        ("main path, brick fusion", phase_main_path_brick),
                        ("main path, bench", phase_main_path_bench),
                        ("main path, bench refresh", phase_main_path_bench_refresh),
                        ("main path, ICL realistic", phase_main_path_icl),
                        ("main path, 7-Scenes realistic", phase_main_path_7scenes)):
        if name == "probes":
            ctx.pop("volume", None)  # a main path's peak memory counts its own volume only
            ctx.pop("bench_inputs", None)
        try:
            results[name] = phase(ctx)
        except Exception:  # noqa: BLE001 — report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        torch.cuda.synchronize()

    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    results.pop("rounding")
    results["icp_associate"] = ctx["icp_associate"]
    results.update(results.pop("probes"))
    results.update(results.pop("maps"))
    results.update(results.pop("bricks"))
    results.update(results.pop("window"))
    results.update(results.pop("normals"))
    results.update(results.pop("skip"))
    results.update(results.pop("extract"))
    # B5b's latency floor: its longest ray's rounds, each at least one dependent gather of probe E
    skip = results["march_skip"]
    skip["latency_floor_ms"] = skip["longest_ray_rounds"] * results["probe_e"]["ms"] / PROBE_E_STEPS
    counts = {path: results[path] for path in ("main path", "main path, fixed association", "main path, brick fusion",
                                               "main path, bench", "main path, bench refresh",
                                               "main path, ICL realistic")}
    counts["probe path"] = ctx["probe_counts"]
    table = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "path": path, "launches": counts[path][k],
         **({"folded_into": FOLDED[k]} if k in FOLDED else {}),
         **({"device_kernels_per_launch": list(DEVICE_KERNELS[k])} if k in DEVICE_KERNELS else {}),
         **{"library_ms": None, **results[k]}}
        for k, (src, rep, path) in KERNELS.items()
    ]
    never = [row["name"] for row in table if row["launches"] < 1 and row["name"] not in FOLDED]
    if never:
        print(f"chip_smoke: kernels never launched on their path: {never}", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
