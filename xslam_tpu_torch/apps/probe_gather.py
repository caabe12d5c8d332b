"""Probe: which gather forms work inside a hand-written kernel on this card,
and what a chained dependent gather costs per element.

Counterpart of ``apps/probe_pallas_gather.py``, which asks the same of the
TPU's Mosaic compiler. Five small kernels (``csrc/gather_probes.cu``), each
beside a plain PyTorch version, at the original's shapes and input formulas:

  A. ``out[r, c] = table[idx[r, c], c]``  — row gather, f32 (4096, 128) table
  B. ``out[r, c] = table[r, idx[r, c]]``  — lane gather within (8, 128)
  C. sum of 16 scalar reads ``table[7 + k, k]``, in order of k
  D. sum of 8 eight-row slices starting at row ``(24 k) % 248``, in order of k
  E. ``n_steps`` times ``idx = (idx + table[idx, lane] + 1) % n_rows`` — the
     march's access pattern (each step depends on the last), timed at 4 and
     64 steps for the cost of one gathered element.

All five are exact (copies, short ordered float sums, integers), so a kernel
must equal its plain version bit for bit. The canary holds kernel K1 (the
bilateral filter) against its plain version on a 480x640 frame, on the card.

Run:  python -m xslam_tpu_torch.apps.probe_gather [--device cpu]

The card is the default and is required unless ``--device cpu``; on the CPU
each probe runs its plain version and E's times are the host's, named so. A
kernel that fails to build or launch is a fault here, not a finding: it
raises and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..ops import kernels, preprocess

LANES = 128
E_ROWS = 16384  # 16k x 128 x 4 B = 8 MB table
E_RAYS_SUB = 64  # 64 x 128 = 8192 rays
E_STEPS = (4, 64)


# ------------------------------------------------------------------ the inputs
def inputs_a(device, n_rows: int = 4096):
    table = torch.arange(n_rows * LANES, dtype=torch.float32, device=device).reshape(n_rows, LANES)
    idx = (torch.arange(8 * LANES, dtype=torch.int32, device=device).reshape(8, LANES) * 37) % n_rows
    return table, idx


def inputs_b(device):
    table = torch.arange(8 * LANES, dtype=torch.float32, device=device).reshape(8, LANES)
    idx = (torch.arange(8 * LANES, dtype=torch.int32, device=device).reshape(8, LANES) * 17) % LANES
    return table, idx


def inputs_c(device):
    return (torch.arange(64 * LANES, dtype=torch.float32, device=device).reshape(64, LANES),)


def inputs_d(device):
    return (torch.arange(256 * LANES, dtype=torch.float32, device=device).reshape(256, LANES),)


def inputs_e(device, n_rows: int = E_ROWS, rays_sub: int = E_RAYS_SUB):
    table = (torch.arange(n_rows * LANES, dtype=torch.int32, device=device) % 3).reshape(n_rows, LANES)
    idx0 = (torch.arange(rays_sub * LANES, dtype=torch.int32, device=device).reshape(rays_sub, LANES) * 97) % n_rows
    return table, idx0


# ---------------------------------------------------------- the plain versions
def _lanes(t: torch.Tensor) -> torch.Tensor:
    return torch.arange(t.shape[1], device=t.device)[None, :]


def probe_a_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long(), _lanes(idx)]


def probe_b_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[torch.arange(idx.shape[0], device=idx.device)[:, None], idx.long()]


def probe_c_plain(table: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=table.device)
    for k in range(16):
        acc = acc + table[7 + k, k]
    return acc.reshape(1, 1)


def probe_d_plain(table: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((8, table.shape[1]), dtype=torch.float32, device=table.device)
    for k in range(8):
        start = (k * 24) % 248
        out = out + table[start:start + 8]
    return out


def probe_e_plain(table: torch.Tensor, idx0: torch.Tensor, n_steps: int) -> torch.Tensor:
    n_rows = table.shape[0]
    idx = idx0.long()
    lanes = _lanes(idx0)
    for _ in range(n_steps):
        idx = (idx + table[idx, lanes] + 1) % n_rows
    return idx.to(torch.int32)


# ----------------------------------------------------------------- the wrappers
def _checked(tensors, specs) -> None:
    for t, (name, dtype, shape) in zip(tensors, specs):
        kernels.check_tensor(t, name, dtype, shape)


def probe_a(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(table, idx):
        return probe_a_plain(table, idx)
    _checked((table, idx), (("table", torch.float32, (table.shape[0], LANES)), ("idx", torch.int32, (idx.shape[0], LANES))))
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    kernels.launch("probe_a", table.device, table, idx, out)
    kernels.launch_counts["probe_a"] += 1
    return out


def probe_b(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(table, idx):
        return probe_b_plain(table, idx)
    _checked((table, idx), (("table", torch.float32, (idx.shape[0], LANES)), ("idx", torch.int32, (idx.shape[0], LANES))))
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    kernels.launch("probe_b", table.device, table, idx, out)
    kernels.launch_counts["probe_b"] += 1
    return out


def probe_c(table: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(table):
        return probe_c_plain(table)
    _checked((table,), (("table", torch.float32, (64, LANES)),))
    out = torch.empty((1, 1), dtype=torch.float32, device=table.device)
    kernels.launch("probe_c", table.device, table, out)
    kernels.launch_counts["probe_c"] += 1
    return out


def probe_d(table: torch.Tensor) -> torch.Tensor:
    if kernels.on_cpu(table):
        return probe_d_plain(table)
    _checked((table,), (("table", torch.float32, (256, LANES)),))
    out = torch.empty((8, LANES), dtype=torch.float32, device=table.device)
    kernels.launch("probe_d", table.device, table, out)
    kernels.launch_counts["probe_d"] += 1
    return out


def probe_e(table: torch.Tensor, idx0: torch.Tensor, n_steps: int) -> torch.Tensor:
    if kernels.on_cpu(table, idx0):
        return probe_e_plain(table, idx0, n_steps)
    _checked((table, idx0), (("table", torch.int32, (table.shape[0], LANES)), ("idx0", torch.int32, (idx0.shape[0], LANES))))
    out = torch.empty(idx0.shape, dtype=torch.int32, device=table.device)
    kernels.launch("probe_e", table.device, table, idx0, out, int(n_steps))
    kernels.launch_counts["probe_e"] += 1
    return out


# ------------------------------------------------------------------ the script
def _timed_ms(fn, device: torch.device, reps: int = 100) -> float:
    """Mean time of ``fn``: on the card by CUDA events, with the stream held
    busy for some 20 ms first so that the host queues every call ahead of the
    device (a kernel of a few microseconds is shorter than the host's launch
    pace); on the CPU by the host clock."""
    fn()  # build, warm
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_e(device: torch.device) -> dict:
    table, idx0 = inputs_e(device)
    times = {n: _timed_ms(lambda n=n: probe_e(table, idx0, n), device) for n in E_STEPS}
    rays = idx0.numel()
    ns_per_gather = (times[64] - times[4]) * 1e6 / (60 * rays)
    return {
        "probe": "E_chained_row_gather",
        "timed_on": device.type,
        "t4_ms": round(times[4], 5),
        "t64_ms": round(times[64], 5),
        "ns_per_gathered_elem": round(ns_per_gather, 5),
        "rays": rays,
    }


def probe_canary(device: torch.device) -> dict:
    """Kernel K1 against the plain bilateral filter on a 480x640 frame. On
    the CPU the wrapper would run the plain version against itself, so the
    canary is left out there and says so."""
    if device.type != "cuda":
        return {"canary": "bilateral_filter kernel against its plain version", "ok": True, "skipped": "no card"}
    depth = np.random.default_rng(0).uniform(600, 4000, (480, 640)).astype(np.uint16)
    d = torch.as_tensor(depth, device=device)
    out, ref = kernels.bilateral_filter(d), preprocess.bilateral_filter(d)
    err = float(torch.where(torch.isnan(out) & torch.isnan(ref), 0.0, (out - ref).abs()).max())
    return {"canary": "bilateral_filter kernel against its plain version", "ok": err < 1e-3, "max_err": err}


def card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu (plain versions; no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def run(device: torch.device) -> dict:
    """Run the canary and the five probes on ``device`` and print the
    original's lines. Returns the outputs as numpy arrays, E's JSON record
    and the canary's under their names."""
    results = {}

    def report(name, out):
        out = out.cpu().numpy()
        print(f"[{name}] OK: shape={out.shape} sum={float(out.sum(dtype=np.float64)):.3f}")
        return out

    print(f"device: {card(device)}")
    results["canary"] = probe_canary(device)
    print(json.dumps(results["canary"]))
    if not results["canary"]["ok"]:
        raise RuntimeError(f"the bilateral kernel disagrees with its plain version: {results['canary']}")
    results["A"] = report("A_row_gather", probe_a(*inputs_a(device)))
    expected = np.take_along_axis(
        np.arange(4096 * LANES, dtype=np.float32).reshape(4096, LANES),
        (np.arange(8 * LANES, dtype=np.int32).reshape(8, LANES) * 37) % 4096,
        axis=0,
    )
    a_correct = bool(np.array_equal(results["A"], expected))
    print("A correct:", a_correct)
    if not a_correct:
        raise RuntimeError("probe A disagrees with take_along_axis")
    results["B"] = report("B_lane_gather", probe_b(*inputs_b(device)))
    results["C"] = report("C_scalar_read", probe_c(*inputs_c(device)))
    results["D"] = report("D_dyn_row_slice", probe_d(*inputs_d(device)))
    table, idx0 = inputs_e(device)
    results["E"] = report("E_chained_gather_4_steps", probe_e(table, idx0, 4))
    print(f"card: {card(device)}")
    results["E_bench"] = bench_e(device)
    print(json.dumps(results["E_bench"]))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default, required) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_gather: CUDA is not available (pass --device cpu for the plain versions)")
    run(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
