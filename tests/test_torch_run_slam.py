"""The port's CLI driver (``python -m xslam_tpu_torch.run_slam``) on a tiny
synthetic workload on the CPU, in a subprocess as a user runs it."""

import os
import subprocess
import sys

import yaml

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


def test_run_slam_cli(tmp_path):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/synthetic.yaml")))
    cfg.update(_SMALL, output_dir=str(tmp_path / "out") + "/")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    res = subprocess.run(
        [sys.executable, "-m", "xslam_tpu_torch.run_slam", str(path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_ENV,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "mean frame time" in res.stdout and "(cpu)" in res.stdout
    ate = float(res.stdout.split("ATE RMSE =")[1].split("m")[0])
    assert ate < 0.05
    out = tmp_path / "out"
    assert (out / "slam" / "frame-000000.pose.txt").exists()
    assert (out / "gt" / "frame-000003.pose.txt").exists()


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
