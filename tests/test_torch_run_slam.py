"""The port's CLI driver (``python -m xslam_tpu_torch.run_slam``) on the CPU:
a tiny synthetic workload in a subprocess as a user runs it; then, in this
process, the on-disk datasets (ICL and 7-Scenes trees the test writes at
160x120), the point cloud and mesh exports, the recovery option (the
recovering engine and the refined trajectory), and the pose files' digits."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.io.options import BENCH_ARGS
from xslam_tpu_torch.io.ply import read_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one PyTorch thread: the suite's other workers hold the cores
_ENV = dict(os.environ, OMP_NUM_THREADS="1")

_SMALL = dict(
    end_frame=4,
    tsdf_size_x=64, tsdf_size_y=64, tsdf_size_z=64,
    tsdf_voxel_size=0.12,
    depth_width=160, depth_height=120,
    fx=120.3, fy=-120.0, cx=79.5, cy=59.5,
)


# as the file says, and in bench.py:78-95's configuration (two pyramid levels at 160x120)
@pytest.mark.parametrize("options", [[], list(BENCH_ARGS)], ids=["yaml", "bench"])
def test_run_slam_cli(tmp_path, options):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/synthetic.yaml")))
    cfg.update(_SMALL, output_dir=str(tmp_path / "out") + "/", num_levels=2 if options else 3)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    res = subprocess.run(
        [sys.executable, "-m", "xslam_tpu_torch.run_slam", str(path), "--device", "cpu", *options],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_ENV,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "mean frame time" in res.stdout and "(cpu)" in res.stdout
    ate = float(res.stdout.split("ATE RMSE =")[1].split("m")[0])
    assert ate < 0.05
    out = tmp_path / "out"
    assert (out / "slam" / "frame-000000.pose.txt").exists()
    assert (out / "gt" / "frame-000003.pose.txt").exists()


def test_run_slam_reports_brick_cap_overflow(tmp_path):
    """Brick fusion with ``--fusion-overflow flag`` and a cap below a frame's
    ACTIVE bricks: the CLI prints the reference's overflow line
    (apps/run_slam.py) for the frames whose map update was partial."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/synthetic.yaml")))
    cfg.update(_SMALL, end_frame=2, output_dir=str(tmp_path / "out") + "/")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    res = subprocess.run(
        [sys.executable, "-m", "xslam_tpu_torch.run_slam", str(path), "--device", "cpu", "--fusion-mode", "brick",
         "--fusion-brick-cap", "8", "--fusion-overflow", "flag"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_ENV,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "frame 0: fusion brick-cap overflow (map update partial)" in res.stdout, res.stdout[-2000:]


def test_run_slam_needs_cuda_by_default(tmp_path):
    """Without ``--device`` the driver runs on the card, and says so where
    there is none instead of falling back to the CPU."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import torch, sys\n"
         "if torch.cuda.is_available(): sys.exit(0)\n"
         "from xslam_tpu_torch.run_slam import main\n"
         "main(['configs/synthetic.yaml', '--frames', '1'])"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_ENV,
    )
    assert res.returncode == 0 or "CUDA is not available" in res.stderr, res.stderr[-2000:]


# ---------------------------------------------------------------- on-disk datasets, extraction, repairs
def _main(argv):
    """``run_slam.main`` in this process (one PyTorch thread): its stdout and
    its run."""
    import contextlib
    import io

    from xslam_tpu_torch import run_slam

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            run = run_slam.main(argv)
    finally:
        torch.set_num_threads(threads)
    return out.getvalue(), run


def _run_main(argv):
    """``run_slam.main`` in this process (one PyTorch thread), its stdout."""
    return _main(argv)[0]


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    """4 frames of configs/synthetic.yaml (``draw_pcd: true``) at the small size."""
    tmp = tmp_path_factory.mktemp("synthetic")
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/synthetic.yaml")))
    cfg.update(_SMALL, output_dir=str(tmp / "out") + "/")
    path = tmp / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    return tmp / "out", _run_main([str(path), "--device", "cpu"])


def test_draw_pcd_writes_the_point_cloud(synthetic_run):
    """``draw_pcd: true`` writes <output_dir>/pcd.ply, as apps/run_slam.py does
    (it was ignored before)."""
    out, stdout = synthetic_run
    n = int(stdout.split("exported ")[1].split(" points")[0])
    points, normals = read_ply(str(out / "pcd.ply"))
    assert n > 100 and points.shape == normals.shape == (n, 3)
    assert np.isfinite(points).all() and (np.abs(np.linalg.norm(normals, axis=1) - 1) < 1e-3).mean() > 0.9


def test_gt_pose_files_carry_float32_digits(synthetic_run):
    """Pose files are the JAX package's ``xs_write_pose``'s: the pose cast to
    float32, then ``%.7f``; the ground truth is float64 arithmetic, whose own
    digits differ from the cast's in an entry of frame 3."""
    from xslam_tpu_torch.io.synthetic import SyntheticDataset

    out, _ = synthetic_run
    ds = SyntheticDataset(n_frames=5, intr=Intrinsics(120.3, -120.0, 79.5, 59.5, 160, 120))
    differs = False
    for i in range(4):
        gt = np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(i)
        want = "".join(" ".join(f"{x:.7f}" for x in row) + "\n" for row in gt.astype(np.float32))
        assert (out / "gt" / f"frame-{i:06d}.pose.txt").read_text() == want
        differs |= want != "".join(" ".join(f"{x:.7f}" for x in row) + "\n" for row in gt)
    assert differs


def test_recovery_option_raises(tmp_path):
    """``reloc_after_failures > 0`` once raised (the recovery wrapper was not
    ported); it now wraps the engine in ``RecoveringEngine``, as
    apps/run_slam.py:85-93 does: the wrapper logs the poses, and after the ATE
    line ``refine_trajectory()`` writes <output_dir>/slam_refined/ and prints
    the refined line (every frame a keyframe here, so the backend runs)."""
    from xslam_tpu_torch.models.recovery import RecoveringEngine

    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/synthetic.yaml")))
    cfg.update(_SMALL, reloc_after_failures=3, keyframe_dist=0.0, keyframe_angle_deg=0.0, loop_detect=True,
               output_dir=str(tmp_path / "out") + "/")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    stdout, run = _main([str(path), "--device", "cpu"])
    assert isinstance(run.engine, RecoveringEngine) and len(run.engine.pose_log) == 4
    assert len(run.engine.keyframes) >= 2 and "backend refinement FAILED" not in stdout
    line = stdout.split("refined ATE RMSE = ")[1].splitlines()[0]
    assert float(line.split(" m")[0]) == pytest.approx(run.refined_ate, abs=5e-6) and run.refined_ate < 0.05
    assert line.endswith(f"({len(run.engine.keyframes)} keyframes, {len(run.engine.loop_edges)} loop closures)")
    assert sorted(p.name for p in (tmp_path / "out" / "slam_refined").iterdir()) == \
        [f"frame-{i:06d}.pose.txt" for i in range(4)]


def _write_tree(root, fmt, intr, n):
    """A tiny on-disk dataset in ``fmt``'s layout, rendered at ``intr`` along the
    realistic generator's trajectory (ICL: depth x 5, .gt.sim blocks; 7-Scenes:
    mm, pose files, info.txt)."""
    from xslam_tpu_torch.io.png import write_png16
    from xslam_tpu_torch.io.synthetic import cluttered_scene, handheld_trajectory, render_depth

    poses = handheld_trajectory(n + 1, seed=11)[:n]
    frames = root / ("depth" if fmt == "icl" else "seq-01")
    frames.mkdir(parents=True)
    for i, c2w in enumerate(poses):
        d = render_depth(cluttered_scene(), c2w, intr).astype(np.uint32) * (5 if fmt == "icl" else 1)
        name = f"{i}.png" if fmt == "icl" else f"frame-{i:06d}.depth.png"
        write_png16(str(frames / name), np.clip(d, 0, 65535).astype(np.uint16))
        if fmt == "7scenes":
            np.savetxt(str(frames / f"frame-{i:06d}.pose.txt"), c2w, fmt="%.9f")
    if fmt == "icl":
        (root / "livingRoom1n.gt.sim").write_text("".join(
            "".join(" ".join(f"{x:.9f}" for x in c2w[r]) + "\n" for r in range(3)) + "\n" for c2w in poses))
    else:
        (root / "info.txt").write_text(f"0\n{n - 1}\n01\n")


@pytest.mark.parametrize("fmt, config, mesh", [("icl", "configs/ICL_realistic.yaml", "tetra"),
                                               ("7scenes", "configs/7scenes_realistic.yaml", "mc")])
def test_run_slam_on_disk_tree(tmp_path, fmt, config, mesh):
    """The realistic configs (bench.py's brick configuration, the loaders,
    ``draw_pcd`` as each file says) on a 3-frame 160x120 tree the test
    writes: pose files, the ATE, pcd.ply where the file asks for it (ICL) and
    mesh.ply with ``--mesh``."""
    cfg = yaml.safe_load(open(os.path.join(REPO, config)))
    small = dict(_SMALL, end_frame=3, num_levels=2, dataset_dir=str(tmp_path / "data"),
                 output_dir=str(tmp_path / "out") + "/")
    if fmt == "7scenes":
        small.update(fx=146.25, fy=146.25, cx=80.0, cy=60.0)  # the Kinect's, at a quarter of 640x480
    cfg.update(small)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    _write_tree(tmp_path / "data", fmt, Intrinsics(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], 160, 120), 3)
    stdout = _run_main([str(path), "--device", "cpu", "--mesh", mesh])
    assert float(stdout.split("ATE RMSE =")[1].split("m")[0]) < 0.05, stdout
    out = tmp_path / "out"
    assert sorted(p.name for p in (out / "slam").iterdir()) == [f"frame-{i:06d}.pose.txt" for i in range(3)]
    assert (out / "pcd.ply").exists() == (fmt == "icl")
    if fmt == "icl":
        assert len(read_ply(str(out / "pcd.ply"))[0]) == int(stdout.split("exported ")[1].split(" points")[0]) > 0
    n = int(stdout.split(f" {mesh} triangles")[0].split("exported ")[-1])
    assert n > 0 and f"element face {n}\n" in (out / "mesh.ply").read_text()[:400]
