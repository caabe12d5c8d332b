"""The port's relocalization demo (``xslam_tpu_torch.apps.relocalize_demo``)
against the JAX package's (``apps/relocalize_demo.py``) on the CPU, on a small
copy of configs/synthetic.yaml (a 64^3 volume at 0.12 m, 160x120 frames):
5 map frames, 2 holdouts, 4 Newton iterations, the default perturbation.

Both print the same lines; the numbers are compared, not the text: the
initial errors to the printed digit (the same ``default_rng(0)``
perturbations through the same exponential), the final errors within 0.3 cm
and the mean losses within 2e-4 (the two maps are fused by different float32
code, and a voxel at a mask threshold may fall on either side:
tests/test_torch_relocalize.py), the inlier counts within 0.5%; and each
demo's losses descend.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from xslam_tpu_torch.apps import relocalize_demo

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--frames", "5", "--holdout", "2", "--iters", "4"]
LINE = re.compile(r"frame (\d+): init err ([\d.]+) cm -> ([\d.]+) cm; mean loss ([\d.]+) -> ([\d.]+); inliers (\d+)")


@pytest.fixture(scope="module")
def small_yaml(tmp_path_factory):
    cfg = yaml.safe_load(open(ROOT / "configs" / "synthetic.yaml"))
    cfg.update(tsdf_size_x=64, tsdf_size_y=64, tsdf_size_z=64, tsdf_voxel_size=0.12, depth_width=160,
               depth_height=120, fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
    path = tmp_path_factory.mktemp("reloc") / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _lines(text):
    return [tuple(float(x) for x in m.groups()) for m in LINE.finditer(text)]


def test_demo_matches_jax(small_yaml, capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_relocalize_demo", ROOT / "apps" / "relocalize_demo.py")
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    monkeypatch.setattr(sys, "argv", ["relocalize_demo.py", small_yaml, *ARGS])
    jax_demo.main()
    j_lines = _lines(capsys.readouterr().out)

    out = relocalize_demo.main([small_yaml, *ARGS, "--device", "cpu"])
    text = capsys.readouterr().out
    t_lines = _lines(text)
    print(text)
    assert text.startswith("building map from 5 frames...")
    assert len(j_lines) == len(t_lines) == 2 == len(out)
    for j, t, holdout in zip(j_lines, t_lines, out):
        assert t[:2] == j[:2], (t, j)  # frame id and initial error
        assert abs(t[2] - j[2]) <= 0.3, (t, j)
        np.testing.assert_allclose(t[3:5], j[3:5], rtol=0, atol=2e-4)
        assert abs(t[5] - j[5]) <= 0.005 * j[5], (t, j)
        losses = holdout.result.loss_history.numpy()
        assert losses.shape == (5,) and np.all(np.diff(losses) < 1e-5), losses
        assert holdout.err < holdout.init_err


def test_demo_needs_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        relocalize_demo.main(["configs/synthetic.yaml"])
