"""Frame times of two revisions of the port on one card, in many turns.

Usage, from the repository root, with the two checkouts made as for
:mod:`.compare_trees`:

    python -m xslam_tpu_torch.apps.frame_turns --parent build/trees/parent \\
        --change build/trees/change --pairs 10 [--frames 10] [--warm 2] [--out DIR]

A turn is one process in one tree: it drives the engine over the first
``--frames`` frames of the synthetic orbit of ``configs/synthetic.yaml`` on
the CUDA card, with a synchronised host clock around each frame as
``chip_smoke.py``'s main path has it, and takes the mean and the median of
the frames after ``--warm``. The turns go parent, change, change, parent,
... for ``--pairs`` pairs, after one untimed turn in each tree (its build).
This file runs itself in each tree with that tree on ``PYTHONPATH``, so it
needs only the engine's API of the tree, not this module. Prints one JSON
line per turn, then one with each tree's median, quartiles and range of the
turns' means and the change's median over the parent's; the card's name and
power limit come first. Exits 1 if a turn failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CONFIG = "configs/synthetic.yaml"


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return smi.stdout.strip() or "unknown"


def one_turn(frames: int, warm: int) -> dict:
    """In the tree on ``sys.path``: the frame times of one run."""
    import numpy as np
    import torch

    import xslam_tpu_torch  # noqa: F401  (sets the float32 precision pins)
    from xslam_tpu_torch.io.config import load_config
    from xslam_tpu_torch.io.synthetic import SyntheticDataset
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    if not torch.cuda.is_available():
        raise RuntimeError("frame_turns times the CUDA card; none is available")
    config = load_config(CONFIG)
    config.end_frame = frames
    ds = SyntheticDataset(n_frames=frames, intr=config.intrinsics)
    depths = [ds.get_depth(i) for i in range(frames)]
    engine = XSlamEngine(config, device=torch.device("cuda"))
    state = engine.init_state()
    times = []
    for depth in depths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, res = engine.process_frame(state, depth)
        engine.log_pose(res)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    steady = np.asarray(times[warm:])
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first([ds.get_pose(i) for i in range(frames)]))
    return dict(mean_frame_ms=float(steady.mean()), p50_frame_ms=float(np.median(steady)), frame_ms=times,
                ate_m=float(ate))


def run_turn(tree: Path, label: str, frames: int, warm: int, out: Path | None, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one", "--frames", str(frames), "--warm", str(warm)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True, timeout=timeout)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired:
        rc, stdout, stderr = 124, "", "timed out"
    if out is not None:
        (out / f"{label}.txt").write_text(stdout)
        (out / f"{label}.err").write_text(stderr)
    row = dict(tree=label, rc=rc, seconds=time.perf_counter() - t0)
    lines = [line for line in stdout.splitlines() if line.startswith("{")]
    if rc == 0 and lines:
        row.update(json.loads(lines[-1]))
    print(json.dumps(row), flush=True)
    return row


def turn_order(pairs: int) -> list:
    """Parent, change, change, parent, ...: ``pairs`` turns of each tree."""
    return [("parent", "change", "change", "parent")[n % 4] for n in range(2 * pairs)]


def summary(means: list) -> dict:
    import numpy as np

    q1, q2, q3 = np.percentile(means, [25, 50, 75])
    return dict(turns=len(means), median_ms=float(q2), q1_ms=float(q1), q3_ms=float(q3), min_ms=float(min(means)),
                max_ms=float(max(means)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of the earlier revision")
    ap.add_argument("--change", help="checkout of the later revision")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--out", default=None, help="directory for each turn's output")
    ap.add_argument("--timeout", type=int, default=600, help="seconds, for each turn")
    ap.add_argument("--one", action="store_true", help="time one run in the tree on PYTHONPATH")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_turn(args.frames, args.warm)), flush=True)
        return 0
    if not (args.parent and args.change):
        ap.error("--parent and --change are required")
    trees = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    out = None
    if args.out:
        out = Path(args.out).resolve()
        out.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)

    rows = [run_turn(trees[name], f"{name}_build", args.frames, args.warm, out, args.timeout)
            for name in ("parent", "change")]
    means = {"parent": [], "change": []}
    for n, name in enumerate(turn_order(args.pairs)):
        row = run_turn(trees[name], f"{name}{n}", args.frames, args.warm, out, args.timeout)
        rows.append(row)
        if row["rc"] == 0:
            means[name].append(row["mean_frame_ms"])
    if all(means.values()):
        result = {name: summary(m) for name, m in means.items()}
        result["change_over_parent"] = result["change"]["median_ms"] / result["parent"]["median_ms"]
        print(json.dumps(result), flush=True)
    return 1 if any(r["rc"] != 0 for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
