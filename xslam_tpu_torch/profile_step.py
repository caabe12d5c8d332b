"""Where a frame's time goes on the card: a ``torch.profiler`` trace of the
port's SLAM step.

Usage:
    python -m xslam_tpu_torch.profile_step configs/synthetic.yaml [--warm 3] [--frames 5] [--trace PATH]

Runs ``--warm`` frames, then profiles ``--frames`` more of the synthetic
orbit on the CUDA card, and prints one JSON object: the card's name and
power limit, the wall time per frame, the device's busy time per frame (sum
of the kernels' and copies' device time) and idle share, each stage's host
and device time per frame (the engine's profiler ranges ``preprocess``,
``icp``, ``fusion``, ``raycast``; a stage's device time leaves out the hand
kernels, which are reported apart), the launches per frame, and the kernels
that take the most device time. ``--trace`` also writes the Chrome trace.
The profiler's own host cost inflates the wall time: take frame times from
``chip_smoke.py`` or ``run_slam``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .io.config import load_config
from .io.synthetic import SyntheticDataset
from .models.kinfu import XSlamEngine

STAGES = ("preprocess", "icp", "fusion", "raycast")
# the hand kernels' device names (csrc/*.cu), reported apart from the stages
HAND_KERNELS = {"bilateral_filter": "bilateral_kernel", "fuse_volume": "fuse_kernel", "march_fixed": "march_kernel"}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step measures the CUDA card; none is available")

    config = load_config(args.config)
    n = args.warm + args.frames
    config.end_frame = n
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
    hand = {
        k: sum(v[0] for name, v in by_name.items() if pat in name) / f for k, pat in HAND_KERNELS.items()
    }
    stages = {}
    for e in prof.key_averages():
        if e.key in STAGES and e.device_type == DeviceType.CPU:
            stages[e.key] = {"host_ms": e.cpu_time_total / 1e3 / f, "device_ms": e.device_time_total / 1e3 / f}
    print(json.dumps({
        "card": card(),
        "device": torch.cuda.get_device_name(0),
        "config": args.config,
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
