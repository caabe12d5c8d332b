"""Smoke run of the PyTorch/CUDA port (``xslam_tpu_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card, ``nvcc`` and PyTorch built for CUDA. Imports nothing of JAX or
of ``xslam_tpu``.

Phases, in order:

1. the card's name and power limit (``nvidia-smi``) and the float32
   precision pins;
2. build the CUDA kernels from ``xslam_tpu_torch/csrc`` (one
   ``torch.utils.cpp_extension.load`` of all sources) and print the build
   seconds;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (one JSON line each): K1 on a 480x640 rendered frame,
   K2 on the 256^3 volume after 3 fused frames, K3 on that volume;
4. the main path: ``XSlamEngine(load_config("configs/synthetic.yaml"))``
   runs 10 frames of the 640x480 synthetic orbit on the card; every frame
   must align, the ATE must stay under 0.02 m, the model maps must be
   finite where valid, and every kernel must have launched.

The second-to-last line is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``, printed only when every phase
passed. Any failed phase exits 1 without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
N_FRAMES = 10
WARM_FRAMES = 2

# (kernel, source, the TPU/XLA code it replaces)
KERNELS = {
    "bilateral_filter": ("xslam_tpu_torch/csrc/bilateral.cu", "xslam_tpu/ops/pallas_kernels.py:99"),
    "fuse_volume": ("xslam_tpu_torch/csrc/fusion.cu", "xslam_tpu/ops/fusion.py:108"),
    "march_fixed": ("xslam_tpu_torch/csrc/march.cu", "xslam_tpu/ops/raycast.py:136"),
}


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def frac_equal(a: torch.Tensor, b: torch.Tensor) -> float:
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(same.float().mean())


def max_abs(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def emit(tag: str, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------------
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
    emit("K1 bilateral_filter", shape=[H, W], max_abs_err=err, frac_equal=eq, ms=ms, plain_ms=plain,
         bound_ms=bms, bound_by=by, library_ms=None, library_note="no single PyTorch call computes it")
    check(err <= 1.0 and eq > 0.999, f"K1 disagrees with its plain version: max {err}, equal {eq}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def _v2c(ctx, pose_c2w: np.ndarray, rng):
    """Dual volume->camera pose of a ground-truth camera, with a seeded
    derivative lane so the kernels' grad lane carries real values."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry import se3

    w2v = np.asarray(ctx["config"].world2volume, np.float32)
    c2v = torch.as_tensor((w2v @ pose_c2w).astype(np.float32), device=ctx["device"])
    g = torch.as_tensor((1e-2 * rng.standard_normal((4, 4))).astype(np.float32), device=ctx["device"])
    g[3] = 0.0
    return se3.inverse(CSFD(c2v, g)), CSFD(c2v, g)


def phase_fusion(ctx):
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import fusion, kernels

    cfg, eng = ctx["config"], ctx["engine_cfg"]
    intr = cfg.intrinsics
    rng = np.random.default_rng(0)
    vol = fusion.create_volume(eng, ctx["device"])
    poses = [np.linalg.inv(ctx["gt"][0]) @ p for p in ctx["gt"]]
    for i in range(3):
        v2c, _ = _v2c(ctx, poses[i], rng)
        depth_m = fusion.scale_depth(torch.as_tensor(ctx["depths"][i], device=ctx["device"]))
        fusion.integrate(vol, depth_m, se3.rotation(v2c), se3.translation(v2c), intr, eng)
    ctx["volume"] = vol
    v2c, _ = _v2c(ctx, poses[3], rng)
    r, t = se3.rotation(v2c), se3.translation(v2c)
    depth_m = fusion.scale_depth(torch.as_tensor(ctx["depths"][3], device=ctx["device"]))
    args = (depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
    a = [x.clone() for x in vol]
    b = [x.clone() for x in vol]
    kernels.fuse_volume(*a, *args)
    kernels.fuse_volume_plain(*b, *args)
    torch.cuda.synchronize()
    w_eq = frac_equal(a[2], b[2])
    same_w = a[2] == b[2]
    err_v, err_g = max_abs(a[0], b[0], same_w), max_abs(a[1], b[1], same_w)
    updated = int((a[2] != vol.weight).sum())
    ms = time_ms(lambda: kernels.fuse_volume(*a, *args), 20)
    plain = time_ms(lambda: kernels.fuse_volume_plain(*b, *args), 2)
    # What the kernel needs: every voxel projects (69 operations up to the
    # pixel gate); an updated voxel does 60 more and reads and writes its
    # three planes (24 B). Voxels that pass the pixel gate and then fail the
    # depth or truncation test are not counted, so this is a lower bound.
    bms, by = bound_ms(depth_m.numel() * 4 + 24 * 4 + updated * 24, a[0].numel() * 69 + updated * 60)
    del a, b
    emit("K2 fuse_volume", shape=list(vol.value.shape), weight_frac_equal=w_eq, max_abs_err_value=err_v,
         max_abs_err_grad=err_g, voxels_updated=updated, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
         library_ms=None, library_note="no single PyTorch call computes it")
    check(w_eq >= 0.9999 and err_v <= 1e-5 and err_g <= 1e-5,
          f"K2 disagrees with its plain version: weight equal {w_eq}, value {err_v}, grad {err_g}")
    return dict(max_abs_err=max(err_v, err_g), ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


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
    return distinct * 4 + rays * (12 + 8) + 12, samples * 20, samples


def phase_march(ctx):
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import kernels, raycast
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng = ctx["config"], ctx["engine_cfg"]
    vol = ctx["volume"]
    _, c2v = _v2c(ctx, np.linalg.inv(ctx["gt"][0]) @ ctx["gt"][3], np.random.default_rng(1))
    ray_dir, ray_start = raycast._camera_rays(se3.rotation(c2v), se3.translation(c2v), cfg.intrinsics)
    tf, td = kernels.march_fixed(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist)
    pf, pd = kernels.march_fixed_plain(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist)
    torch.cuda.synchronize()
    eq_f, eq_d = frac_equal(tf, pf), frac_equal(td, pd)
    both = (tf < INF_T) & (pf < INF_T)
    err = max_abs(tf, pf, both)
    hits = float((tf < torch.clamp(td, max=INF_T)).float().mean())
    ms = time_ms(lambda: kernels.march_fixed(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist), 50)
    plain = time_ms(
        lambda: kernels.march_fixed_plain(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist), 3)
    n_bytes, n_ops, samples = _march_bytes_ops(vol.value, ray_start.v, ray_dir.v, tf, td, eng)
    bms, by = bound_ms(n_bytes, n_ops)
    emit("K3 march_fixed", shape=list(tf.shape), t_found_frac_equal=eq_f, t_dead_frac_equal=eq_d,
         max_abs_err_t_found=err, hit_fraction=hits, samples=samples, bytes_needed=n_bytes, ms=ms,
         plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
         library_note="no single PyTorch call computes it")
    del ctx["volume"]  # the main path's peak memory counts its own volume only
    check(eq_f >= 0.999 and eq_d >= 0.999, f"K3 disagrees with its plain version: {eq_f}, {eq_d}")
    check(hits > 0.5, f"K3 found surfaces on only {hits:.3f} of the rays")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def phase_main_path(ctx):
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    cfg = ctx["config"]
    engine = XSlamEngine(cfg, device=ctx["device"])
    state = engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, aligned, integrated = [], [], 0
    for i in range(N_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, res = engine.process_frame(state, ctx["depths"][i])
        engine.log_pose(res)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ok = bool(res.align_ok)
        aligned.append(ok)
        integrated += ok
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:N_FRAMES]))
    vmap, nmap = state.vmaps_prev[0], state.nmaps_prev[0]
    valid = ~torch.isnan(vmap.v[0]) & ~torch.isnan(nmap.v[0])
    valid_frac = float(valid.float().mean())
    finite = all(bool(torch.isfinite(x[:, valid]).all()) for x in (vmap.v, vmap.g, nmap.v, nmap.g))
    steady = np.asarray(times[WARM_FRAMES:])
    emit("main path", config="configs/synthetic.yaml", frames=N_FRAMES, depth=[cfg.depth_height, cfg.depth_width],
         volume=list(cfg.tsdf_size), mean_frame_ms=float(steady.mean()), p50_frame_ms=float(np.median(steady)),
         frame_ms=times, ate_m=ate, all_aligned=all(aligned), peak_mem_bytes=peak,
         model_map_valid_fraction=valid_frac, kernels=counts)
    check(all(aligned), f"frames failed to align: {aligned}")
    check(ate < 0.02, f"ATE {ate} m >= 0.02 m")
    check(tuple(vmap.v.shape) == (3, cfg.depth_height, cfg.depth_width) and finite and valid_frac > 0.5,
          f"model maps: shape {tuple(vmap.v.shape)}, finite {finite}, valid fraction {valid_frac}")
    check(counts["bilateral_filter"] == N_FRAMES and counts["march_fixed"] == N_FRAMES
          and counts["fuse_volume"] == integrated, f"launch counts {counts}")
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
    ds = SyntheticDataset(n_frames=N_FRAMES, intr=config.intrinsics)
    ctx = {
        "device": torch.device("cuda"),
        "config": config,
        "engine_cfg": XSlamEngine(config).vol_cfg,
        "depths": [ds.get_depth(i) for i in range(N_FRAMES)],
        "gt": [ds.get_pose(i) for i in range(N_FRAMES)],
    }

    results, failed = {}, []
    for name, phase in (("bilateral_filter", phase_bilateral), ("fuse_volume", phase_fusion),
                        ("march_fixed", phase_march), ("main path", phase_main_path)):
        try:
            results[name] = phase(ctx)
        except Exception:  # noqa: BLE001 — report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        torch.cuda.synchronize()

    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    counts = results["main path"]
    table = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": counts[k], **results[k],
         "library_ms": None}
        for k, (src, rep) in KERNELS.items()
    ]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
