"""Where a frame's time goes on the card: a ``torch.profiler`` trace of the
port's SLAM step.

Usage:
    python -m xslam_tpu_torch.profile_step configs/synthetic.yaml [--warm 3] [--frames 5] [--trace PATH]
        [--fixed-assoc] [--model-map-level L] [--fusion-mode brick] [--fusion-brick-cap N]
        [--fusion-overflow dense] [--volume-layout brick] [--raycast-march temporal] [--raycast-refine reuse]
        [--raycast-normals screen] [--bi-interpolate-threshold T]

Runs ``--warm`` frames, then profiles ``--frames`` more of the synthetic
orbit on the CUDA card, and prints one JSON object: the card's name and
power limit, the wall time per frame, the device's busy time per frame (sum
of the kernels' and copies' device time) and idle share, each stage's host
and device time and launches per frame (the engine's profiler ranges
``preprocess``, ``icp``, ``fusion``, ``raycast``; a stage's device time
leaves out the hand kernels, which are reported apart), the launches per
frame, and the kernels
that take the most device time. ``--trace`` also writes the Chrome trace;
the other options (:mod:`xslam_tpu_torch.io.options`) set the configuration
over the file's values (bench.py's configuration:
:data:`~xslam_tpu_torch.io.options.BENCH_ARGS`; the dense ``hier2`` march with
screen normals and bilinear fusion: :data:`~xslam_tpu_torch.io.options.HIER2_ARGS`).
The hand kernels' variants are reported apart where their device names
differ: K2's and B3c's bilinear branch (``fuse_volume_bilinear``,
``fuse_bricks_bilinear``), the dense layout's B14a-c (``skip_field_dense``,
``march_skip_dense``, ``window_march_dense``), the brick layout's K5r
(``raycast_refine_bricks``) and B16 (``window_march_first_event``); K3 at a
stride is the same device kernel as at stride 1 (``march_fixed``).
The profiler's own host cost inflates the wall time: take frame times from
``chip_smoke.py`` or ``run_slam``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .io.config import load_config
from .io.options import add_options, set_options
from .io.synthetic import SyntheticDataset
from .models.kinfu import XSlamEngine

STAGES = ("preprocess", "icp", "fusion", "raycast")
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")  # the CUDA runtime's calls
# the hand kernels' device names (csrc/*.cu), reported apart from the stages (B5a, B12's band pass: two kernels;
# B12 and its band pass run in a frame only where the recovering engine relocalizes): each a
# pattern that a device event's demangled name holds after "::" and before "(" or "<" (so march_kernel is not
# window_march_kernel); K6's launch with the screen normals (B4n) is its kernel's <PAIRS, true> instantiation, the
# bilinear branch (B11) K2's and B3c's <..., true>, the dense layout's B14a-b the brick layout's kernels' <true>
# (B14c: window_dense_kernel, its own), K5r over the brick rows refine_rows_kernel (K5's body under its own
# launch bound), B16 (the first-event march) B4's
# <false, true>; the skip march's ray form (march_skip_ray_kernel) is B14b's launch on the dense layout and
# march_skip_rays on the rows;
# K3 at a stride launches march_group_kernel<G> (G lanes a ray; march_kernel where the wrapper picks one lane)
HAND_KERNELS = {
    "bilateral_filter": "bilateral_kernel", "fuse_volume": "fuse_kernel<false>",
    "fuse_volume_bilinear": "fuse_kernel<true>", "march_fixed": "march_kernel",
    "march_fixed_strided": r"march_group_kernel<\d+>",
    "icp_system": "icp_system_kernel", "icp_associate": "icp_associate_kernel",
    "raycast_refine": "refine_kernel", "raycast_refine_bricks": "refine_rows_kernel",
    "resize_model_maps": r"model_map_pyramid_kernel<\w+, false>",
    "model_map_normals": r"model_map_pyramid_kernel<\w+, true>",
    "depth_pyramid": "depth_pyramid_kernel", "vertex_normal_maps": "vertex_normal_maps_kernel",
    "depth_mips": "depth_mips_kernel", "classify_bricks": "classify_bricks_kernel",
    "fuse_bricks": r"fuse_bricks_kernel<\w+, false>", "fuse_bricks_bilinear": r"fuse_bricks_kernel<\w+, true>",
    "classify_bricks_split": "classify_bricks_split_kernel", "classify_bricks_fine": "classify_bricks_fine_kernel",
    "classify_subcells": "classify_subcells_kernel", "fuse_bricks_mixed": r"fuse_bricks_mixed_kernel<\w+, \w+>",
    "fuse_bricks_subcell": r"fuse_bricks_subcell_kernel<\w+, \w+>",
    "window_march": "window_march_kernel<false, false>", "window_march_dense": "window_dense_kernel",
    "window_march_first_event": "window_march_kernel<false, true>",
    "skip_field": ("event_mask_kernel<false>", "skip_distance_kernel<false>"),
    "skip_field_dense": ("event_mask_kernel<true>", "skip_distance_kernel<true>"),
    "march_skip": "march_skip_kernel<false>", "march_skip_rays": "march_skip_ray_kernel<false>",
    "march_skip_dense": ("march_skip_kernel<true>", "march_skip_ray_kernel<true>"),
    "tsdf_loss": "tsdf_loss_kernel", "tsdf_band": ("tsdf_band_count_kernel", "tsdf_band_list_kernel"),
    # B19, the sharded engine's own launches (its slab fusion runs K2's and the brick kernels above)
    "march_fixed_shard": "march_shard_kernel<true>", "raycast_refine_shard": "refine_shard_kernel",
    "raycast_finalize": "refine_finalize_kernel", "icp_tail": "icp_tail_kernel",
    # B18, bundle adjustment's Schur-complement product (models/ba.py), off the frame
    "schur_cg_anchors": r"schur_cg_kernel<\d, false>", "schur_cg_keyframes": r"schur_cg_kernel<\d, true>",
    # B17, the meshers (ops/extract.py), after a run; their scan kernel is shared
    "mesh_tetra": ("mesh_count_kernel<false>", "mesh_scan_kernel", "mesh_rows_kernel<false>"),
    "mesh_mc": ("mesh_count_kernel<true>", "mesh_scan_kernel", "mesh_rows_kernel<true>"),
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def stage_launches(events, n_frames: int) -> dict:
    """Launches per frame of each stage: the host's launch, copy and fill
    calls that start inside the stage's profiler range, over ``n_frames``."""
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.name in STAGES and e.device_type == DeviceType.CPU)
    starts = [r[0] for r in ranges]
    out = {name: 0.0 for _, _, name in ranges}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(HOST_LAUNCH_CALLS):
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= ranges[i][1]:
                out[ranges[i][2]] += 1.0 / n_frames
    return out


def hand_kernel_ms(by_name: dict) -> dict:
    """Device ms of each hand kernel (:data:`HAND_KERNELS`) out of
    ``{device event name: [ms, calls]}``."""
    def matches(name: str, kernel: str) -> bool:
        return re.search(f"::{kernel}[(<]", name) is not None

    return {k: sum(v[0] for name, v in by_name.items()
                   if any(matches(name, kernel) for kernel in ((pat,) if isinstance(pat, str) else pat)))
            for k, pat in HAND_KERNELS.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    add_options(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step measures the CUDA card; none is available")

    config = load_config(args.config)
    n = args.warm + args.frames
    config.end_frame = n
    set_options(config, args)
    ds = SyntheticDataset(n_frames=n, intr=config.intrinsics)
    depths = [ds.get_depth(i) for i in range(n)]
    engine = XSlamEngine(config)
    state = engine.init_state()
    for i in range(args.warm):
        state, res = engine.process_frame(state, depths[i])
        engine.log_pose(res)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.warm, n):
            state, res = engine.process_frame(state, depths[i])
            engine.log_pose(res)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    f = args.frames
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in STAGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    by_name: dict[str, list] = {}
    for e in device_events:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    hand = {k: ms / f for k, ms in hand_kernel_ms(by_name).items()}
    launches = stage_launches(prof.events(), f)
    stages = {}
    for e in prof.key_averages():
        if e.key in STAGES and e.device_type == DeviceType.CPU:
            stages[e.key] = {"host_ms": e.cpu_time_total / 1e3 / f, "device_ms": e.device_time_total / 1e3 / f,
                             "launches": launches.get(e.key, 0.0)}
    print(json.dumps({
        "card": card(),
        "device": torch.cuda.get_device_name(0),
        "config": args.config,
        "icp_fixed_assoc": config.icp_fixed_assoc,
        "model_map_level": config.model_map_level,
        "fusion_mode": config.fusion_mode,
        **({"fusion_brick_cap": config.fusion_brick_cap, "fusion_overflow": config.fusion_overflow}
           if config.fusion_mode == "brick" else {}),
        "volume_layout": config.volume_layout,
        "raycast_march": config.raycast_march,
        "raycast_refine": config.raycast_refine,
        "raycast_normals": config.raycast_normals,
        "raycast_hier_window": config.raycast_hier_window,
        "bi_interpolate_threshold": config.bi_interpolate_threshold,
        "frames_profiled": f,
        "wall_ms_per_frame": wall_ms / f,
        "device_busy_ms_per_frame": busy_ms / f,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_frame": len(device_events) / f,
        "stages": stages,
        "hand_kernels_ms_per_frame": hand,
        "top_device_ops": [{"name": k[:120], "ms_per_frame": v[0] / f, "calls_per_frame": v[1] / f} for k, v in top],
    }))


if __name__ == "__main__":
    main()
