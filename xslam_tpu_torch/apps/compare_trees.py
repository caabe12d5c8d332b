"""Two revisions of the port on one card, in one call: the smoke run, the
per-stage profile in four settings, and the kernels' registers.

Usage, from the repository root (frame times spread between calls and with
the card's power limit, so two revisions are compared only within one call):

    mkdir -p build/trees/parent build/trees/change
    git archive <parent commit> | tar -x -C build/trees/parent
    git add -A && git archive $(git write-tree) | tar -x -C build/trees/change
    python -m xslam_tpu_torch.apps.compare_trees --parent build/trees/parent \
        --change build/trees/change --out DIR

Each tree is a checkout that holds only committed files; it builds its own
kernels under its own ``build/torch_kernels/``. The order is parent, change,
change, parent for ``chip_smoke.py`` (the first run of a tree includes its
build), then ``xslam_tpu_torch.profile_step`` on ``configs/synthetic.yaml`` as
the file says, with ``--fixed-assoc --model-map-level 1``, with bench.py's
brick fusion, in bench.py's whole configuration
(``io.options.BENCH_ARGS``) and in it with every frame taking the refresh on
each tree, then ``xslam_tpu_torch.apps.kernel_resources`` on each. Every
command's output goes to ``<out>/<tree><n>_<what>.txt`` (and ``.err``); the
card's name and power limit to ``<out>/card.txt``. Prints one
JSON line per command (tree, what, exit code, seconds) and, from each smoke
run, the kernel times and the main-path lines. Exits 1 if a command failed;
a tree that predates an option fails that command, and the rest still run.
Frame times of two trees in many turns: :mod:`.frame_turns`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from ..io.options import BENCH_ARGS

PROFILE = ["-m", "xslam_tpu_torch.profile_step", "configs/synthetic.yaml"]
# profile_step in bench.py's configuration with every frame taking the hier2 refresh
# (raycast_temporal_min_coverage=2, set over the options), written so that it runs on trees whose profile_step
# has no option for it
REFRESH = ("import sys; from xslam_tpu_torch import profile_step as p; o = p.set_options; "
           "p.set_options = lambda c, a: (o(c, a), setattr(c, 'raycast_temporal_min_coverage', 2.0)); "
           "p.main(sys.argv[1:])")
COMMANDS = {
    "smoke": ["chip_smoke.py"],
    "profile_default": PROFILE,
    "profile_fixed": PROFILE + ["--fixed-assoc", "--model-map-level", "1"],
    "profile_brick": PROFILE + ["--fusion-mode", "brick", "--fusion-brick-cap", "2816", "--fusion-overflow", "dense"],
    "profile_bench": PROFILE + list(BENCH_ARGS),
    "profile_refresh": ["-c", REFRESH, "configs/synthetic.yaml", *BENCH_ARGS],
    "resources": ["-m", "xslam_tpu_torch.apps.kernel_resources"],
}


def run(tree: Path, label: str, what: str, out: Path, timeout: int) -> dict:
    t0 = time.perf_counter()
    with open(out / f"{label}_{what}.txt", "w") as so, open(out / f"{label}_{what}.err", "w") as se:
        try:
            rc = subprocess.run([sys.executable, *COMMANDS[what]], cwd=tree, stdout=so, stderr=se,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    row = dict(tree=label, what=what, rc=rc, seconds=time.perf_counter() - t0)
    print(json.dumps(row), flush=True)
    return row


def smoke_summary(path: Path) -> dict:
    """Kernel ms and the main-path lines out of a smoke run's output."""
    out = {}
    for line in path.read_text().splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if "kernels" in d and isinstance(d["kernels"], list):
            out["kernel_ms"] = {k["name"]: k["ms"] for k in d["kernels"]}
        elif str(d.get("phase", "")).startswith("main path"):
            out[d["phase"]] = {k: d[k] for k in ("mean_frame_ms", "p50_frame_ms", "ate_m", "peak_mem_bytes",
                                                 "device_launches_in_profiled_frame") if k in d}
        elif d.get("phase") == "build":
            out["build_seconds"] = d["seconds"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the earlier revision")
    ap.add_argument("--change", required=True, help="checkout of the later revision")
    ap.add_argument("--out", required=True, help="directory for every command's output")
    ap.add_argument("--timeout", type=int, default=1200, help="seconds, for each command")
    args = ap.parse_args(argv)
    trees = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    (out / "card.txt").write_text(smi.stdout)
    print(f"card: {smi.stdout.strip()}", flush=True)

    rows = []
    for n, name in enumerate(("parent", "change", "change", "parent")):
        label = f"{name}{1 + n // 2}"
        rows.append(run(trees[name], label, "smoke", out, args.timeout))
        print(json.dumps({"tree": label, **smoke_summary(out / f"{label}_smoke.txt")}), flush=True)
    for what in ("profile_default", "profile_fixed", "profile_brick", "profile_bench", "profile_refresh", "resources"):
        for name in ("parent", "change"):
            rows.append(run(trees[name], name, what, out, args.timeout))
    return 1 if any(r["rc"] != 0 for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
