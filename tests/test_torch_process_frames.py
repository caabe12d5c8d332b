"""The engine on the dense layout's new settings, ``process_frames`` and the
CLI's ``--scan``, in the port against the JAX package on the small synthetic
sweep (6 frames, 1 degree a frame).

(a) The path's own setting, ``raycast_march="hier2"``, screen normals and
    ``bi_interpolate_threshold=0.1`` (with ``raycast_hier_window=8``, as
    ``tests/test_march_skip.py::test_hier2_e2e_tracking``): every frame
    aligns on both engines, the first tracked frame's pose within 5e-4 of
    JAX's, both ATEs under 0.06 m (tests/test_e2e_slam.py's bound) and within
    5e-3 m of each other (trajectories part from 1-ulp differences, so runs
    are compared by ATE class).
(b) ``process_frames``: a loop of ``process_frame``, so chunks of 3 give the
    6 single calls' poses, flags and volume bit for bit; against JAX's
    ``process_frames`` (one ``lax.scan``) in the ATE class of (a); its stacked
    ``FrameResult`` crosses with ``utils/convert.py::frame_result_to_numpy``
    in JAX's shapes.
(c) ``run_slam --scan 3``: the per-frame loop's pose files, byte for byte,
    and with ``reloc_after_failures > 0`` JAX's note, then the per-frame
    loop.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import torch_config
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.utils.convert import frame_result_to_numpy

N_FRAMES = 6
CHUNK = 3
HIER2 = dict(raycast_march="hier2", raycast_normals="screen", bi_interpolate_threshold=0.1, raycast_hier_window=8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs():
    cfg = small_config(end_frame=N_FRAMES, **HIER2)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    depths = [ds.get_depth(i) for i in range(N_FRAMES)]
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])

    jeng = JaxEngine(cfg)
    jstate, jposes, jok = jeng.init_state(), [], []
    for d in depths:
        jstate, res = jeng.process_frame(jstate, d)
        jposes.append(np.array(res.camera2world.v))
        jok.append(bool(res.align_ok))
    jstate, jstack = jeng.process_frames(jeng.init_state(), np.stack(depths))
    jstack = frame_result_to_numpy(jstack)

    teng = TorchEngine(torch_config(cfg), device="cpu")
    tstate, tres = teng.init_state(), []
    for d in depths:
        tstate, res = teng.process_frame(tstate, d)
        tres.append(res)
    chunked, state = [], teng.init_state()
    for at in range(0, N_FRAMES, CHUNK):
        state, res = teng.process_frames(state, np.stack(depths[at:at + CHUNK]))
        chunked.append(res)
    return dict(gt=gt, jposes=jposes, jok=jok, jstack=jstack, tres=tres, tstate=tstate, chunked=chunked,
                chunked_state=state)


def test_hier2_screen_bilinear_path_matches_jax(runs):
    tposes = [r.camera2world.v.numpy() for r in runs["tres"]]
    assert all(runs["jok"]) and all(bool(r.align_ok) for r in runs["tres"])
    np.testing.assert_allclose(tposes[1], runs["jposes"][1], atol=5e-4)  # the first tracked frame
    ate_j = ate_rmse(normalize_to_first(runs["jposes"]), runs["gt"])
    ate_t = ate_rmse(normalize_to_first(tposes), runs["gt"])
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_process_frames_equals_the_frame_loop(runs):
    loop = [frame_result_to_numpy(r) for r in runs["tres"]]
    stacked = [frame_result_to_numpy(r) for r in runs["chunked"]]
    for key in loop[0]:
        whole = np.concatenate([s[key] for s in stacked])
        np.testing.assert_array_equal(whole, np.stack([f[key] for f in loop]))
    for a, b in zip(runs["chunked_state"].volume, runs["tstate"].volume):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(runs["chunked_state"].vmaps_prev + runs["chunked_state"].nmaps_prev,
                    runs["tstate"].vmaps_prev + runs["tstate"].nmaps_prev):
        assert torch.equal(a.v.view(torch.int32), b.v.view(torch.int32))
    assert runs["chunked_state"].frame_idx == runs["tstate"].frame_idx == N_FRAMES


def test_process_frames_in_jax_process_frames_class(runs):
    jstack = runs["jstack"]
    tstack = {k: np.concatenate([frame_result_to_numpy(r)[k] for r in runs["chunked"]]) for k in jstack}
    for key, value in jstack.items():
        assert tstack[key].shape == value.shape, key
    assert tstack["align_ok"].all() and jstack["align_ok"].all()
    ate_j = ate_rmse(normalize_to_first(list(jstack["camera2world_v"])), runs["gt"])
    ate_t = ate_rmse(normalize_to_first(list(tstack["camera2world_v"])), runs["gt"])
    assert ate_j < 0.06 and ate_t < 0.06 and abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_process_frames_launches_nothing_on_cpu(runs):
    assert all(n == 0 for n in kernels.launch_counts.values()), kernels.launch_counts


def test_process_frames_stacks_the_optional_fields():
    """bench.py's configuration (brick fusion, the temporal march): the
    ACTIVE counts and anchor coverages stack as (K,); ``unroll`` changes
    nothing."""
    cfg = small_config(end_frame=2, volume_layout="brick", fusion_mode="brick", fusion_brick_cap=4096,
                       fusion_overflow="dense", raycast_normals="screen", raycast_march="temporal", model_map_level=1,
                       icp_fixed_assoc=True, raycast_refine="reuse", num_levels=2)
    ds = small_dataset(2, degrees_per_frame=1.0)
    depths = np.stack([ds.get_depth(i) for i in range(2)])
    eng = TorchEngine(torch_config(cfg), device="cpu")
    _, a = eng.process_frames(eng.init_state(), depths)
    _, b = eng.process_frames(eng.init_state(), depths, unroll=True)
    a, b = frame_result_to_numpy(a), frame_result_to_numpy(b)
    assert a["fusion_active"].shape == (2,) and (a["fusion_active"] > 0).all()
    assert a["anchor_coverage"].shape == (2,) and a["camera2world_v"].shape == (2, 4, 4)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------- the CLI
_SMALL = dict(end_frame=4, tsdf_size_x=64, tsdf_size_y=64, tsdf_size_z=64, tsdf_voxel_size=0.12, depth_width=160,
              depth_height=120, fx=120.3, fy=-120.0, cx=79.5, cy=59.5)


def _cli(tmp_path, name, extra_cfg=None, args=()):
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/synthetic.yaml")))
    cfg.update(_SMALL, output_dir=str(tmp_path / name) + "/", **(extra_cfg or {}))
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.dump(cfg))
    res = subprocess.run([sys.executable, "-m", "xslam_tpu_torch.run_slam", str(path), "--device", "cpu", *args],
                         capture_output=True, text=True, timeout=300, cwd=REPO, env=_ENV)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout, tmp_path / name


def _pose_files(out):
    return {p.name: p.read_bytes() for p in sorted((out / "slam").iterdir())}


def test_run_slam_scan_writes_the_frame_loop_pose_files(tmp_path):
    options = ["--raycast-march", "hier2", "--raycast-normals", "screen", "--bi-interpolate-threshold", "0.1"]
    loop_out, loop_dir = _cli(tmp_path, "loop", args=options)
    scan_out, scan_dir = _cli(tmp_path, "scan", args=options + ["--scan", "3"])
    loop_files, scan_files = _pose_files(loop_dir), _pose_files(scan_dir)
    assert len(loop_files) == 4 and loop_files == scan_files
    assert loop_out.split("ATE RMSE =")[1] == scan_out.split("ATE RMSE =")[1]
    assert "mean frame time" in scan_out


def test_run_slam_scan_with_recovery_takes_the_frame_loop(tmp_path):
    out, out_dir = _cli(tmp_path, "reloc", extra_cfg=dict(end_frame=3, reloc_after_failures=3), args=["--scan", "3"])
    assert "note: --scan is incompatible with recovery" in out
    assert len(_pose_files(out_dir)) == 3
