"""The port's on-disk datasets against the JAX package's, on the CPU.

- ``io/png.py``: files whose rows use each of the five PNG row filters, and
  a file PIL wrote (its encoder picks a filter a row), read by the port
  equal PIL's and the JAX loader's ``_read_depth_png``; PIL reads the
  port's writer; other colour types and bit depths raise with the file's
  name.
- ``io/dataset.py``: ``ICLDataset`` (with the ``.gt.sim`` file's blank
  separator lines counted, and with ``is_flip``) and ``SevenScenesDataset``
  (through its info file) give the JAX loaders' depths and poses on the same
  tree; ``get_depth`` is C-contiguous uint16 either way.
- ``apps/make_realistic_dataset.py``: 2 frames of each format, both
  generators run as a user runs them: the same pixels, pose files and text.
- ``utils/evaluation.py::rpe_rmse`` equals JAX's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from xslam_tpu.io import dataset as jdataset
from xslam_tpu.io.config import SlamConfig as JaxSlamConfig
from xslam_tpu.utils.evaluation import rpe_rmse as jax_rpe
from xslam_tpu_torch.io import dataset as tdataset
from xslam_tpu_torch.io.config import SlamConfig
from xslam_tpu_torch.io.png import encode_png16, read_png16, write_png16
from xslam_tpu_torch.utils.evaluation import rpe_rmse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pil(path):
    return np.asarray(Image.open(path), dtype=np.uint16)


def _depth(rng, shape=(23, 37)):
    """Depth-like pixels: smooth ramps with holes and the full 16-bit range."""
    H, W = shape
    d = (rng.integers(500, 20000) + np.add.outer(np.arange(H) * 37, np.arange(W) * 11)).astype(np.uint16)
    d[rng.random(shape) < 0.1] = 0
    d[0, :3] = (65535, 1, 256)
    return d


@pytest.mark.parametrize("filters", ["cycle", "each"], ids=["rows_cycle_0_to_4", "one_filter_a_file"])
def test_png_filters_against_pil_and_jax(tmp_path, filters):
    rng = np.random.default_rng(0)
    d = _depth(rng)
    H = d.shape[0]
    kinds = [[y % 5 for y in range(H)]] if filters == "cycle" else [[k] * H for k in range(5)]
    for i, rows in enumerate(kinds):
        path = str(tmp_path / f"f{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png16(d, rows))
        got = read_png16(path)
        assert got.dtype == np.uint16 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, d)
        np.testing.assert_array_equal(_pil(path), d)
        np.testing.assert_array_equal(jdataset._read_depth_png(path), d)


def test_png_written_by_pil_and_read_by_pil(tmp_path):
    rng = np.random.default_rng(1)
    d = _depth(rng, (48, 64))
    path = str(tmp_path / "pil.png")
    Image.fromarray(d).save(path)  # PIL's encoder chooses each row's filter
    np.testing.assert_array_equal(read_png16(path), d)
    path = str(tmp_path / "port.png")
    write_png16(path, d)
    np.testing.assert_array_equal(_pil(path), d)
    np.testing.assert_array_equal(jdataset._read_depth_png(path), d)


def test_png_refuses_other_formats(tmp_path):
    path = str(tmp_path / "grey8.png")
    Image.fromarray(np.zeros((4, 5), np.uint8)).save(path)
    with pytest.raises(ValueError, match="grey8.png.*bit depth 8"):
        read_png16(path)
    path = str(tmp_path / "rgb.png")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="rgb.png.*colour type 2"):
        read_png16(path)
    with pytest.raises(TypeError, match="uint16"):
        write_png16(str(tmp_path / "f.png"), np.zeros((4, 5), np.int32))


def _icl_tree(root, n, rng):
    (root / "depth").mkdir(parents=True)
    with open(root / "livingRoom1n.gt.sim", "w") as f:
        for i in range(n):
            write_png16(str(root / "depth" / f"{i}.png"), _depth(rng, (24, 32)))
            pose = np.eye(4)
            pose[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            pose[:3, 3] = rng.standard_normal(3)
            for r in range(3):
                f.write(" ".join(f"{x:.9f}" for x in pose[r]) + "\n")
            f.write("\n")  # the blank 4th line of each block counts as a line


@pytest.mark.parametrize("flip", [False, True])
def test_icl_loader_against_jax(tmp_path, flip):
    rng = np.random.default_rng(2)
    _icl_tree(tmp_path, 4, rng)
    j = jdataset.ICLDataset(str(tmp_path), 1, 3, is_flip=flip)
    t = tdataset.ICLDataset(str(tmp_path), 1, 3, is_flip=flip)
    assert len(t) == len(j) == 3
    for i in range(3):
        d = t.get_depth(i)
        assert d.dtype == np.uint16 and d.flags.c_contiguous
        torch.as_tensor(d)  # a negative-stride view would be refused here
        np.testing.assert_array_equal(d, np.asarray(j.get_depth(i)))
        np.testing.assert_array_equal(t.get_pose(i), j.get_pose(i))
    raw = _pil(str(tmp_path / "depth" / "1.png")) // 5
    np.testing.assert_array_equal(t.get_depth(0), raw[:, ::-1] if flip else raw)


def test_seven_scenes_loader_against_jax(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "seq-01").mkdir()
    for i in range(3):
        write_png16(str(tmp_path / "seq-01" / f"frame-{i:06d}.depth.png"), _depth(rng, (24, 32)))
        pose = np.eye(4)
        pose[:3, 3] = rng.standard_normal(3)
        np.savetxt(str(tmp_path / "seq-01" / f"frame-{i:06d}.pose.txt"), pose, fmt="%.9f")
    (tmp_path / "info.txt").write_text("0\n2\n01\n")
    cfg = dict(dataset_format="7scenes", dataset_dir=str(tmp_path))
    j = jdataset.make_dataset(JaxSlamConfig(**cfg))
    t = tdataset.make_dataset(SlamConfig(**cfg))
    assert isinstance(t, tdataset.SevenScenesDataset) and len(t) == len(j) == 3
    for i in range(3):
        np.testing.assert_array_equal(t.get_depth(i), np.asarray(j.get_depth(i)))
        np.testing.assert_array_equal(t.get_pose(i), j.get_pose(i))


def test_make_dataset_formats():
    assert len(tdataset.make_dataset(SlamConfig(dataset_format="synthetic", end_frame=2))) == 3
    with pytest.raises(ValueError, match="unknown dataset format"):
        tdataset.make_dataset(SlamConfig(dataset_format="tum"))


def _generate(cmd, out, fmt):
    res = subprocess.run([sys.executable, *cmd, str(out), "2", "0.0015", "--format", fmt], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("fmt", ["icl", "7scenes"])
def test_generator_against_jax(tmp_path, fmt):
    """Both generators, 2 frames of 640x480 with sensor noise: the same
    files, the same pixels (PNG bytes differ: PIL picks its own filters),
    the same text byte for byte."""
    _generate(["apps/make_realistic_dataset.py"], tmp_path / "jax", fmt)
    _generate(["-m", "xslam_tpu_torch.apps.make_realistic_dataset"], tmp_path / "port", fmt)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == (3 if fmt == "icl" else 5)
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix == ".png":
            d = read_png16(str(b))
            assert d.shape == (480, 640) and (d > 0).mean() > 0.5
            np.testing.assert_array_equal(d, _pil(str(a)))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_rpe_against_jax():
    rng = np.random.default_rng(4)

    def traj():
        out = []
        for _ in range(6):
            p = np.eye(4)
            p[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            p[:3, 3] = rng.standard_normal(3)
            out.append(p)
        return out

    est, gt = traj(), traj()
    for delta in (1, 2):
        assert rpe_rmse(est, gt, delta) == jax_rpe(est, gt, delta)
